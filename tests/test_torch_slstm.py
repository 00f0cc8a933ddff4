"""Parity of the port's sLSTM recurrence (`repro_torch.kernels.slstm`)
with the reference's, on the CPU: the plain version (what the wrapper runs
for a CPU tensor) against

- the Pallas kernel in interpret mode and its lax.scan oracle, with f32
  weights, at the reference kernel test's shapes plus one at hd 64: atol
  2e-5, as there (measured ≤ 1.2e-7; the two frameworks' tanh, exp and
  log1p differ in the last bit);
- the model's final state, `repro.nn.xlstm.slstm_forward(...,
  return_state=True)`, on the same pre-activations, with f32 and with bf16
  weights;
- the model cell (`_slstm_cell` scanned over time) with bf16 weights.

The bf16 CUDA kernel's decomposition (one thread-block cluster a head,
block rank r owning hidden units r·J .. r·J + J − 1, the product
D = Rᵀ hᵀ in k-steps of 16 summed in four chains, then the cell, h
reassembled from the blocks) is emulated here in PyTorch
(`_emulate_tc_kernel` below; it is not on the package's path) at the
launch plan `ops.tc_plan` gives, and held against the Pallas kernel in
interpret mode with f32 weights (atol 2e-5) and against the model cell
with bf16 weights (2**-7 of scale), at hd 64 (one block a head), 256
(clusters of 4) and 512 (clusters of 16, B 9: two n8 tiles).

With bf16 weights h is rounded to bf16 before each product and the product
is rounded to bf16, on both sides. Each step's product agrees bitwise, but
a last-bit f32 difference in tanh or exp can flip the bf16 rounding of one
h, which moves the next steps: over 64 steps h stays within one bf16 step
(2**-7) of its scale, as do the states c, n and m (measured ≤ 4.1e-4 of
scale). The CUDA kernel is held against the plain version on the card
(`tests/test_torch_cuda.py`, `chip_smoke.py`). A kernel launch takes at
most 16 batch rows; above that the wrapper launches once a slice
(`ops.batch_slices`, `ops.run_sliced`), emulated here over the plain
version at B 17 and 33."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.slstm import ref as j_ref
from repro.kernels.slstm import slstm as j_kernel
from repro.nn import layers as jlayers
from repro.nn import xlstm as jx
from repro_torch.kernels.slstm import ops, ref

F32_ATOL = 2e-5
BF16_REL = 2.0 ** -7


def _t(a, dtype="float32"):
    return torch.from_numpy(np.array(np.asarray(a).astype(np.float32))).to(getattr(torch, dtype))


def _inputs(B, T, NH, hd, seed, *, x_scale=0.5, r_scale=None):
    rng = np.random.RandomState(seed)
    xp = (rng.standard_normal((B, T, NH * 4 * hd)) * x_scale).astype(np.float32)
    r_scale = 1.0 / np.sqrt(hd) if r_scale is None else r_scale
    r = (rng.standard_normal((NH, hd, 4 * hd)) * r_scale).astype(np.float32)
    return xp, r


def _close_to_scale(got, want, rel):
    got, want = np.asarray(got, np.float32), np.asarray(want, np.float32)
    err, scale = np.abs(got - want).max(), np.abs(want).max()
    assert err <= rel * scale, (err, scale)


@pytest.mark.parametrize("B,T,NH,hd", [(1, 8, 2, 8), (2, 16, 4, 16), (3, 12, 1, 32),
                                       (2, 24, 4, 64)])
def test_plain_matches_pallas_kernel_and_oracle(B, T, NH, hd):
    xp, r = _inputs(B, T, NH, hd, B * T + hd, r_scale=0.2)
    h, st = ref.slstm_scan(_t(xp).reshape(B, T, NH, 4 * hd), _t(r))
    assert h.dtype == torch.float32 and h.shape == (B, T, NH, hd)
    assert all(s.shape == (B, NH, hd) and s.dtype == torch.float32 for s in st)
    want_k = j_kernel.slstm_scan(jnp.asarray(xp), jnp.asarray(r), nh=NH, interpret=True)
    want_o = j_ref.slstm_scan(jnp.asarray(xp).reshape(B, T, NH, 4 * hd), jnp.asarray(r))
    np.testing.assert_allclose(h.reshape(B, T, NH * hd).numpy(), np.asarray(want_k),
                               atol=F32_ATOL, rtol=0)
    np.testing.assert_allclose(h.numpy(), np.asarray(want_o), atol=F32_ATOL, rtol=0)
    # the final h is the last step's
    assert torch.equal(st[0], h[:, -1])


def _j_slstm_params(NH, hd, dtype, seed):
    d = NH * hd
    p = jx.slstm_init(jax.random.PRNGKey(seed), jx.slstm_dims(d, NH), dtype=jnp.float32)
    p["r"] = p["r"] * 2.0   # a livelier recurrence than init's
    return jax.tree.map(lambda a: a.astype(dtype), p)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_final_state_matches_model_forward(dtype):
    B, T, NH, hd = 2, 32, 4, 64
    d = NH * hd
    params = _j_slstm_params(NH, hd, dtype, 3)
    x = jnp.asarray(np.random.RandomState(4).standard_normal((B, T, d)).astype(np.float32)
                    ).astype(dtype)
    _, jst = jx.slstm_forward(params, x, jx.slstm_dims(d, NH), return_state=True)
    x_pre = jlayers.dense(params["w_in"], x)          # the model's own pre-activations
    h, st = ref.slstm_scan(_t(x_pre, dtype).reshape(B, T, NH, 4 * hd), _t(params["r"], dtype))
    for got, want in zip(st, jst):
        if dtype == "float32":
            np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=F32_ATOL, rtol=1e-5)
        else:
            _close_to_scale(got.numpy(), want, BF16_REL)


def test_bf16_matches_model_cell():
    B, T, NH, hd = 2, 64, 4, 64
    xp, r = _inputs(B, T, NH, hd, 5)
    jxp, jr = jnp.asarray(xp).astype(jnp.bfloat16), jnp.asarray(r).astype(jnp.bfloat16)
    sd = jx.slstm_dims(NH * hd, NH)

    def step(st, xt):
        h, new = jx._slstm_cell({"r": jr}, xt, st, sd)
        return new, h

    jst, jh = jax.lax.scan(step, jx.init_slstm_state(B, sd), jxp.swapaxes(0, 1))
    h, st = ops.slstm_scan(_t(jxp, "bfloat16").reshape(B, T, NH, 4 * hd), _t(jr, "bfloat16"))
    assert h.dtype == torch.bfloat16     # the wrapper returns x_pre's dtype
    _close_to_scale(h.float().reshape(B, T, NH * hd).numpy(),
                    np.asarray(jh.swapaxes(0, 1).astype(jnp.bfloat16).astype(jnp.float32)),
                    BF16_REL)
    for got, want in zip(st, jst):
        _close_to_scale(got.numpy(), want, BF16_REL)


def test_state_carries_across_calls():
    """Two calls, the second from the first's final state, equal one call."""
    B, T, NH, hd = 2, 20, 2, 16
    xp, r = _inputs(B, T, NH, hd, 6)
    x = _t(xp).reshape(B, T, NH, 4 * hd)
    h, st = ops.slstm_scan(x, _t(r))
    h1, st1 = ops.slstm_scan(x[:, :7], _t(r))
    h2, st2 = ops.slstm_scan(x[:, 7:], _t(r), st1)
    assert torch.equal(torch.cat([h1, h2], 1), h)
    assert all(torch.equal(a, b) for a, b in zip(st2, st))


def test_large_input_gates_stay_finite():
    """Input-gate pre-activations far above exp's range: m keeps the
    exponentials finite, and the state stays finite."""
    B, T, NH, hd = 2, 12, 2, 16
    xp, r = _inputs(B, T, NH, hd, 7)
    xp = xp.reshape(B, T, NH, 4, hd)
    xp[:, :, :, 1] += 120.0
    h, st = ref.slstm_scan(_t(xp).reshape(B, T, NH, 4 * hd), _t(r))
    want = j_ref.slstm_scan(jnp.asarray(xp).reshape(B, T, NH, 4 * hd), jnp.asarray(r))
    assert torch.isfinite(h).all() and all(torch.isfinite(s).all() for s in st)
    np.testing.assert_allclose(h.numpy(), np.asarray(want), atol=F32_ATOL, rtol=0)


@pytest.mark.parametrize("B,want", [(1, [(0, 1)]), (16, [(0, 16)]), (17, [(0, 16), (16, 17)]),
                                    (32, [(0, 16), (16, 32)]),
                                    (33, [(0, 16), (16, 32), (32, 33)])])
def test_batch_slices(B, want):
    """A launch takes at most 16 batch rows: ⌈B/16⌉ slices, in order."""
    assert [(sl.start, sl.stop) for sl in ops.batch_slices(B)] == want


@pytest.mark.parametrize("B", [4, 17])
def test_state_of_another_batch_is_refused(B):
    """The card's input check refuses a state whose batch is not x_pre's
    before any slice is cut from it."""
    x = torch.zeros(B, 3, 2, 4 * 16)
    r = torch.zeros(2, 16, 4 * 16)
    ops._check_inputs(x, r, ref.init_state(B, 2, 16, "cpu"))
    with pytest.raises(ValueError, match="state leaves"):
        ops._check_inputs(x, r, ref.init_state(20, 2, 16, "cpu"))


@pytest.mark.parametrize("B", [17, 33])
def test_b17_matches_pallas_kernel_and_sliced_launches(B):
    """Above 16 rows: the wrapper's CPU path (the plain version) and the
    launches the card would make, one a slice of `batch_slices` with the
    state sliced the same way (`run_sliced` over the plain version, in two
    calls, the second from the first's state), against the Pallas kernel
    in interpret mode; atol 2e-5 as above."""
    T, NH, hd = 10, 2, 16
    xp, r = _inputs(B, T, NH, hd, B, r_scale=0.2)
    x = _t(xp).reshape(B, T, NH, 4 * hd)
    want = np.asarray(j_kernel.slstm_scan(jnp.asarray(xp), jnp.asarray(r), nh=NH,
                                          interpret=True))
    h, st = ops.slstm_scan(x, _t(r))
    np.testing.assert_allclose(h.reshape(B, T, NH * hd).numpy(), want, atol=F32_ATOL, rtol=0)
    rows = []

    def launch(x_pre, rr, state):
        rows.append(x_pre.shape[0])
        return ref.slstm_scan(x_pre, rr, state)

    h1, st1 = ops.run_sliced(launch, x[:, :4], _t(r), None)
    h2, st2 = ops.run_sliced(launch, x[:, 4:], _t(r), st1)
    assert rows == [sl.stop - sl.start for sl in ops.batch_slices(B)] * 2
    hs = torch.cat([h1, h2], 1)
    np.testing.assert_allclose(hs.reshape(B, T, NH * hd).numpy(), want, atol=F32_ATOL, rtol=0)
    for a, b in zip(st2, st):
        assert a.shape == (B, NH, hd)
        np.testing.assert_allclose(a.numpy(), b.numpy(), atol=F32_ATOL, rtol=1e-5)


@pytest.mark.parametrize("B,NH,hd,J", [(4, 4, 512, 16), (1, 4, 512, 16), (4, 4, 64, 2),
                                       (16, 4, 512, 16), (3, 1, 32, 2)])
def test_block_split(B, NH, hd, J):
    """xlstm-1.3b (hd 512) and its reduced config (hd 64) on an H100's 132
    SMs: 128 blocks, one per SM; at hd 32 the 64 threads of a column
    (J = 1) would not split hd evenly."""
    assert ops.pick_units(B, NH, hd, 132) == J


def test_block_split_raises_when_no_grid_fits():
    with pytest.raises(ValueError, match="fits"):
        ops.pick_units(16, 4, 4096, 132)


# ------------------------------------------- the bf16 cluster kernel's plan

@pytest.mark.parametrize("B", [1, 4, 9, 16])
@pytest.mark.parametrize("hd,CL,J", [(32, 1, 32), (64, 1, 64), (128, 1, 128), (256, 4, 64),
                                     (512, 16, 32)])
def test_tc_plan(B, hd, CL, J):
    """One block a head up to hd 128; R^T's share a warp (ceil(J/32)
    m-tiles x hd/16 k-steps) stays within 32 fragments, 128 registers a
    thread: hd 256 takes clusters of 4, hd 512 of 16 (xlstm-1.3b)."""
    assert ops.tc_plan(B, hd) == (CL, J)
    frags = -(-J // 32) * (hd // 16)
    assert CL * J == hd and J % 8 == 0 and frags <= ops.TC_MAX_FRAGS


@pytest.mark.parametrize("B,hd,match", [(4, 1024, "multiples of 16"),
                                        (4, 40, "multiples of 16"),
                                        (4, 176, "keeps R in registers"),
                                        (17, 512, "batch"), (0, 64, "batch")])
def test_tc_plan_raises_where_nothing_fits(B, hd, match):
    with pytest.raises(ValueError, match=match):
        ops.tc_plan(B, hd)


def _emulate_tc_kernel(x_pre, r, chains=4):
    """The bf16 cluster kernel's arithmetic in PyTorch, block by block:
    x_pre (B, T, NH, 4hd) and r (NH, hd, 4hd) of one dtype; returns h
    (B, T, NH, hd) in x_pre's dtype and the final state, f32."""
    B, T, NH, hd4 = x_pre.shape
    hd = hd4 // 4
    CL, J = ops.tc_plan(B, hd)
    mpw = -(-J // 32)                         # m-tiles a warp
    ch = 1 if mpw >= 4 else chains // mpw     # accumulator chains a tile
    rdt = r.dtype
    h, c, n, m = ref.init_state(B, NH, hd, "cpu")
    out = torch.empty((B, T, NH, hd), dtype=x_pre.dtype)
    for t in range(T):
        hb = h.to(rdt).float()                # h_{t-1} in the blocks' buffers
        new = [torch.empty((B, NH, hd)) for _ in range(4)]
        for head in range(NH):
            for rank in range(CL):
                units = torch.arange(rank * J, (rank + 1) * J)
                cols = torch.cat([g * hd + units for g in range(4)])   # rows of D
                a = r[head][:, cols].float()                           # R^T's rows, (hd, 4J)
                acc = [torch.zeros((B, 4 * J)) for _ in range(ch)]
                for s in range(hd // 16):
                    k = slice(16 * s, 16 * s + 16)
                    acc[s % ch] = acc[s % ch] + hb[:, head, k] @ a[k]
                d = acc[0]
                for extra in acc[1:]:
                    d = d + extra
                pre = x_pre[:, t, head, cols].float() + d.to(rdt).float()
                zp, ip, fp, op = pre.split(J, dim=-1)
                mu = m[:, head, units]
                logf = torch.nn.functional.logsigmoid(fp)
                m_new = torch.maximum(logf + mu, ip)
                fw, iw = torch.exp(logf + mu - m_new), torch.exp(ip - m_new)
                cu = fw * c[:, head, units] + iw * torch.tanh(zp)
                nu = fw * n[:, head, units] + iw
                hu = torch.sigmoid(op) * cu / nu.clamp_min(1e-6)
                for leaf, v in zip(new, (hu, cu, nu, m_new)):
                    leaf[:, head, units] = v
        h, c, n, m = new                      # h reassembled from the blocks
        out[:, t] = h.to(x_pre.dtype)
    return out, (h, c, n, m)


@pytest.mark.parametrize("B,T,NH,hd", [(2, 8, 2, 64), (3, 6, 1, 256), (9, 5, 1, 512)])
def test_tc_emulation_matches_pallas_kernel_f32(B, T, NH, hd):
    xp, r = _inputs(B, T, NH, hd, B + T + hd, r_scale=0.2 * 8 / np.sqrt(hd))
    h, st = _emulate_tc_kernel(_t(xp).reshape(B, T, NH, 4 * hd), _t(r))
    want = j_kernel.slstm_scan(jnp.asarray(xp), jnp.asarray(r), nh=NH, interpret=True)
    np.testing.assert_allclose(h.reshape(B, T, NH * hd).numpy(), np.asarray(want),
                               atol=F32_ATOL, rtol=0)
    assert torch.equal(st[0], h[:, -1])


@pytest.mark.parametrize("B,T,NH,hd", [(2, 32, 4, 64), (3, 16, 2, 256), (9, 8, 1, 512)])
def test_tc_emulation_matches_model_cell_bf16(B, T, NH, hd):
    xp, r = _inputs(B, T, NH, hd, 11 + hd)
    jxp, jr = jnp.asarray(xp).astype(jnp.bfloat16), jnp.asarray(r).astype(jnp.bfloat16)
    sd = jx.slstm_dims(NH * hd, NH)

    def step(st, xt):
        h, new = jx._slstm_cell({"r": jr}, xt, st, sd)
        return new, h

    jst, jh = jax.lax.scan(step, jx.init_slstm_state(B, sd), jxp.swapaxes(0, 1))
    h, st = _emulate_tc_kernel(_t(jxp, "bfloat16").reshape(B, T, NH, 4 * hd),
                               _t(jr, "bfloat16"))
    assert h.dtype == torch.bfloat16
    _close_to_scale(h.float().reshape(B, T, NH * hd).numpy(),
                    np.asarray(jh.swapaxes(0, 1).astype(jnp.bfloat16).astype(jnp.float32)),
                    BF16_REL)
    for got, want in zip(st, jst):
        _close_to_scale(got.numpy(), want, BF16_REL)
