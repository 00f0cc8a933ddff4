"""Parity of the port's streaming-telemetry reducers
(`repro_torch.core.metrics`) with the reference's (`repro.core.metrics`),
on the CPU.

The same (R, ...) traces, drawn from a numpy seed, are folded round by
round through both packages' `init_telemetry / update_telemetry /
finalize_telemetry`. The reference is run two ways: op by op, and as its
engine runs it, inside a compiled `lax.scan`.

Tolerances:
- integer-valued outputs (count, max and last of integers and booleans,
  ring buffers and their counts), histogram counts and quantile values:
  bitwise against both;
- sum, mean and std: bitwise against the op-by-op reference (the port
  computes the same f32 ops in the same order). Against the compiled
  one, sum and mean are bitwise too; std within 4 ulp, because XLA
  contracts the Welford update's `m2 + d * (x - mean)` into a fused
  multiply-add there (2 ulp measured at 12 rounds).

The histogram's bin index follows the compiled reference, which folds
`(x - lo) / (hi - lo) * bins` into one f32 product and converts to int32
saturating: NaN, ±inf and values beyond int32 are held against it.
"""
import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import metrics as JM
from repro_torch.core import metrics as M

R, S = 12, 37
SPEC_FIELDS = ("metric", "reducer", "every", "cap", "bins", "lo", "hi")


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """Many small ops: one intra-op thread runs them as fast as many, and
    keeps the parallel test workers from oversubscribing the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _specs(*kws):
    return (tuple(JM.MetricSpec("x", **kw) for kw in kws),
            tuple(M.MetricSpec("x", **kw) for kw in kws))


def ref_fold(specs, trace, compiled=False):
    """The reference's fold of a numpy (R, ...) trace under metric "x"."""
    cfg = JM.TelemetryCfg(mode="streaming", specs=specs)
    vals = jnp.asarray(trace)
    carry = JM.init_telemetry(cfg, {"x": jax.ShapeDtypeStruct(vals.shape[1:],
                                                              vals.dtype)})
    rounds = jnp.arange(vals.shape[0], dtype=jnp.int32)
    if compiled:
        def step(c, xr):
            return JM.update_telemetry(cfg, c, {"x": xr[0]}, xr[1]), None

        carry, _ = jax.jit(lambda c, v: jax.lax.scan(step, c, (v, rounds)))(carry, vals)
    else:
        for r in range(vals.shape[0]):
            carry = JM.update_telemetry(cfg, carry, {"x": vals[r]}, rounds[r])
    return carry, {k: np.asarray(v) for k, v in JM.finalize_telemetry(cfg, carry).items()}


def port_fold(specs, trace):
    cfg = M.TelemetryCfg(mode="streaming", specs=specs)
    vals = torch.from_numpy(np.ascontiguousarray(trace))
    carry = M.init_telemetry(cfg, {"x": vals[0]})
    for r in range(vals.shape[0]):
        carry = M.update_telemetry(cfg, carry, {"x": vals[r]}, r)
    return carry, {k: v.numpy() for k, v in M.finalize_telemetry(cfg, carry).items()}


def ulps(a, b) -> int:
    a, b = np.asarray(a, np.float32), np.asarray(b, np.float32)
    ia = a.view(np.int32).astype(np.int64)
    ib = b.view(np.int32).astype(np.int64)
    return int(np.abs(ia - ib).max()) if a.size else 0


def _trace(kind, shape=(R, S), seed=0):
    rng = np.random.default_rng(seed)
    if kind == "f32":
        return (rng.normal(size=shape) * 5.0).astype(np.float32)
    if kind == "i32":
        return rng.integers(-50, 50, size=shape).astype(np.int32)
    if kind == "bool":
        return rng.random(shape) < 0.3
    if kind == "u01":
        return rng.uniform(0.0, 1.0, size=shape).astype(np.float32)
    if kind == "wide":       # half the samples outside [0, 1)
        return rng.uniform(-1.0, 2.0, size=shape).astype(np.float32)
    if kind == "staleness":  # integer rounds since participation, as i32
        return rng.integers(0, 9, size=shape).astype(np.int32)
    if kind == "ramp":       # value = round, one device
        return np.arange(shape[0], dtype=np.float32)[:, None]
    raise ValueError(kind)


# (id, trace kind, spec kwargs): every reducer over the dtypes it takes
CASES = [
    ("last-f32", "f32", [dict(reducer="last")]),
    ("last-i32", "i32", [dict(reducer="last")]),
    ("last-bool", "bool", [dict(reducer="last")]),
    ("sum-f32", "f32", [dict(reducer="sum")]),
    ("sum-i32", "i32", [dict(reducer="sum")]),
    ("sum-bool", "bool", [dict(reducer="sum")]),
    ("mean-std-f32", "f32", [dict(reducer="mean"), dict(reducer="std")]),
    ("mean-std-i32", "i32", [dict(reducer="mean"), dict(reducer="std")]),
    ("max-f32", "f32", [dict(reducer="max")]),
    ("max-i32", "i32", [dict(reducer="max")]),
    ("max-bool", "bool", [dict(reducer="max")]),
    ("count-bool", "bool", [dict(reducer="count")]),
    ("count-f32", "f32", [dict(reducer="count")]),
    ("ring-every1", "i32", [dict(reducer="ring", every=1, cap=R)]),
    ("ring-strided-wrap", "ramp", [dict(reducer="ring", every=3, cap=2)]),
    ("ring-strided-nowrap", "ramp", [dict(reducer="ring", every=5, cap=4)]),
    ("ring-bool", "bool", [dict(reducer="ring", every=2, cap=3)]),
    ("quantiles-in-range", "u01", [dict(reducer="p50", bins=64),
                                   dict(reducer="p95", bins=64)]),
    ("quantiles-out-of-range", "wide", [dict(reducer="p50", bins=16),
                                        dict(reducer="p95", bins=16)]),
    ("quantiles-odd-range", "f32", [dict(reducer="p50", bins=50, lo=-3.3, hi=7.0),
                                    dict(reducer="p95", bins=50, lo=-3.3, hi=7.0)]),
    ("quantiles-staleness", "staleness", [dict(reducer="p50", bins=64, hi=6.0),
                                          dict(reducer="p95", bins=64, hi=6.0)]),
]


@pytest.mark.parametrize("kind,kws", [c[1:] for c in CASES], ids=[c[0] for c in CASES])
def test_reducer_matches_reference_op_by_op(kind, kws):
    """Every output bitwise, in the reference's dtype, against the
    reference's fold run op by op."""
    jspecs, specs = _specs(*kws)
    trace = _trace(kind)
    _, want = ref_fold(jspecs, trace)
    _, got = port_fold(specs, trace)
    assert set(got) == set(want)
    for k, w in want.items():
        assert got[k].dtype == w.dtype, k
        np.testing.assert_array_equal(got[k], w, err_msg=k)


@pytest.mark.parametrize("kind,kws", [c[1:] for c in CASES], ids=[c[0] for c in CASES])
def test_reducer_matches_compiled_reference(kind, kws):
    """Against the reference's fold inside a compiled scan, as its engine
    runs it: bitwise, but std within 4 ulp (XLA's fused multiply-add in
    the Welford update)."""
    jspecs, specs = _specs(*kws)
    trace = _trace(kind, seed=1)
    _, want = ref_fold(jspecs, trace, compiled=True)
    _, got = port_fold(specs, trace)
    for k, w in want.items():
        if k.endswith("/std"):
            assert ulps(got[k], w) <= 4, k
        else:
            np.testing.assert_array_equal(got[k], w, err_msg=k)


def test_shared_states_have_the_reference_keys_and_values():
    """mean/std share one Welford state and p50/p95 of one range one
    histogram; the carries hold the reference's keys, and their states
    the reference's values (the histogram counts bitwise)."""
    kws = [dict(reducer="mean"), dict(reducer="std"), dict(reducer="max"),
           dict(reducer="p50", bins=16, hi=8.0), dict(reducer="p95", bins=16, hi=8.0),
           dict(reducer="ring", every=2, cap=3)]
    jspecs, specs = _specs(*kws)
    trace = np.abs(_trace("f32", seed=2))
    jc, _ = ref_fold(jspecs, trace)
    c, _ = port_fold(specs, trace)
    assert list(c.reducers) == list(jc.reducers) == [
        "x/welford", "x/max", "x/hist16@0.0:8.0", "x/ring2x3"]
    # another range is another histogram
    assert (M.MetricSpec("x", "p95", bins=16, hi=4.0).state_key
            == JM.MetricSpec("x", "p95", bins=16, hi=4.0).state_key == "x/hist16@0.0:4.0")
    for k, st in c.reducers.items():
        jst = jc.reducers[k]
        for a, b in zip(jax.tree_util.tree_leaves(jst),
                        st if isinstance(st, tuple) else (st,)):
            np.testing.assert_array_equal(b.numpy(), np.asarray(a), err_msg=k)


# values whose float-to-int conversion differs between XLA, x86 and CUDA
SPECIAL = np.array([np.nan, -np.nan, np.inf, -np.inf, 3e9, -3e9, 2.0 ** 31,
                    -2.0 ** 31, 1e38, -1e38, 0.0, -0.0, 0.999999, 1.0, -1e-30],
                   np.float32)


@pytest.mark.parametrize("lo,hi,bins", [(0.0, 1.0, 64), (0.5, 3.3, 50), (-2.0, 2.0, 7)])
def test_quantile_bins_of_nan_inf_and_huge_values(lo, hi, bins):
    """NaN lands in the first bin, +inf and values beyond int32 in the
    last, -inf in the first: the compiled reference's saturating
    conversion (PyTorch on the CPU would give INT_MIN for all of them;
    the port clamps in float first). Counts bitwise against the
    reference run both ways."""
    rng = np.random.default_rng(3)
    trace = np.stack([SPECIAL, rng.uniform(lo - 1, hi + 1, SPECIAL.size).astype(np.float32)])
    kws = [dict(reducer="p50", bins=bins, lo=lo, hi=hi),
           dict(reducer="p95", bins=bins, lo=lo, hi=hi)]
    jspecs, specs = _specs(*kws)
    key = specs[0].state_key
    c, got = port_fold(specs, trace)
    counts = c.reducers[key].counts.numpy()
    assert counts.sum() == trace.size
    for compiled in (False, True):
        jc, want = ref_fold(jspecs, trace, compiled=compiled)
        np.testing.assert_array_equal(counts, np.asarray(jc.reducers[key].counts))
        for k in want:
            np.testing.assert_array_equal(got[k], want[k], err_msg=k)


@pytest.mark.parametrize("lo,hi,bins", [(0.0, 6.0, 64), (0.0, 7.0, 50), (0.5, 3.3, 64),
                                        (-1.0, 2.0, 10), (0.0, 69000.0, 64)])
def test_quantile_bin_scale_is_the_compiled_reference_constant(lo, hi, bins):
    """The one f32 factor XLA folds `/ (hi - lo) * bins` into, read from
    the compiled reference's HLO."""
    txt = jax.jit(lambda a: ((a - lo) / (hi - lo) * bins).astype(jnp.int32)).lower(
        jnp.zeros(3, jnp.float32)).compile().as_text()
    consts = {np.float32(float(c)) for c in
              re.findall(r"f32\[\] constant\(([-0-9.e+]+)\)", txt)}
    assert np.float32(M._bin_scale(M.MetricSpec("x", "p50", bins=bins, lo=lo, hi=hi))) in consts


def test_quantile_empty_histogram_reports_lo():
    jspecs, specs = _specs(dict(reducer="p95", bins=8, lo=2.0, hi=10.0))
    cfg = M.TelemetryCfg(mode="streaming", specs=specs)
    out = M.finalize_telemetry(cfg, M.init_telemetry(cfg, {"x": torch.zeros(2)}))
    jcfg = JM.TelemetryCfg(mode="streaming", specs=jspecs)
    want = JM.finalize_telemetry(jcfg, JM.init_telemetry(
        jcfg, {"x": jax.ShapeDtypeStruct((2,), jnp.float32)}))
    np.testing.assert_array_equal(out["tel/x/p95"].numpy(), np.asarray(want["tel/x/p95"]))
    assert float(out["tel/x/p95"]) == 2.0


def test_quantile_finalize_is_batch_polymorphic():
    """Finalize over a (B, bins) carry, as batched campaign grids will
    hand it: each cell equals its own fold, and the reference's vmapped
    finalize."""
    jspecs, specs = _specs(dict(reducer="p50", bins=32), dict(reducer="p95", bins=32))
    traces = np.random.default_rng(4).uniform(0.0, 1.0, (3, R, 5)).astype(np.float32)
    cfg, jcfg = (M.TelemetryCfg(mode="streaming", specs=specs),
                 JM.TelemetryCfg(mode="streaming", specs=jspecs))
    carries = [port_fold(specs, t)[0] for t in traces]
    key = specs[0].state_key
    batched = M.TelemetryCarry(reducers={key: M.Hist(
        counts=torch.stack([c.reducers[key].counts for c in carries]))})
    out = M.finalize_telemetry(cfg, batched)
    jcarries = [ref_fold(jspecs, t)[0] for t in traces]
    jbatched = jax.tree_util.tree_map(lambda *xs: jnp.stack(xs), *jcarries)
    want = jax.vmap(lambda c: JM.finalize_telemetry(jcfg, c))(jbatched)
    for k in ("tel/x/p50", "tel/x/p95"):
        assert out[k].shape == (3,)
        np.testing.assert_array_equal(out[k].numpy(), np.asarray(want[k]), err_msg=k)
        for b in range(3):
            assert out[k][b] == port_fold(specs, traces[b])[1][k]


@pytest.mark.parametrize("make,err", [
    (lambda m: m.MetricSpec("x", "median"), "unknown reducer"),
    (lambda m: m.MetricSpec("x", "ring", every=0), "ring needs"),
    (lambda m: m.MetricSpec("x", "ring", cap=0), "ring needs"),
    (lambda m: m.MetricSpec("x", "p50", bins=0), "bins"),
    (lambda m: m.MetricSpec("x", "p95", lo=1.0, hi=1.0), "hi > lo"),
    (lambda m: m.TelemetryCfg(mode="sparse"), "telemetry mode"),
    (lambda m: m.TelemetryCfg(specs=(m.MetricSpec("x", "max"), m.MetricSpec("x", "max"))),
     "duplicate"),
], ids=["reducer", "ring-every", "ring-cap", "bins", "range", "mode", "duplicate"])
def test_spec_validation_matches_reference(make, err):
    with pytest.raises(ValueError, match=err) as want:
        make(JM)
    with pytest.raises(ValueError, match=err) as got:
        make(M)
    assert str(got.value) == str(want.value)


def test_init_raises_on_a_metric_the_round_does_not_emit():
    cfg = M.TelemetryCfg(mode="streaming", specs=(M.MetricSpec("nope", "max"),))
    with pytest.raises(KeyError, match="not in the round metrics"):
        M.init_telemetry(cfg, {"x": torch.zeros(2)})


def test_spec_sets_and_constants_match_reference():
    assert M.PER_DEVICE_METRICS == JM.PER_DEVICE_METRICS
    assert M.DENSE_PER_DEVICE == JM.DENSE_PER_DEVICE
    assert M.REDUCERS == JM.REDUCERS and M.QUANTILE_Q == JM.QUANTILE_Q
    for name in ("DEFAULT_SPECS", "ASYNC_SPECS", "FAULT_SPECS"):
        got, want = getattr(M, name), getattr(JM, name)
        assert [tuple(getattr(s, f) for f in SPEC_FIELDS) for s in got] == \
               [tuple(getattr(s, f) for f in SPEC_FIELDS) for s in want], name
        assert [s.state_key for s in got] == [s.state_key for s in want]
        assert [s.out_key for s in got] == [s.out_key for s in want]


def test_states_go_on_each_metrics_device():
    """The states are allocated on the device of the metric they fold
    (the meta device here, where the shapes come from without data), in
    the reference's dtypes."""
    cfg = M.TelemetryCfg(mode="streaming", specs=M.DEFAULT_SPECS)
    shapes = {k: torch.empty(5, dtype=dt, device="meta") for k, dt in
              (("selected", torch.bool), ("H", torch.int32),
               ("residual_energy", torch.float32), ("staleness", torch.int32))}
    meta = M.init_telemetry(cfg, shapes)
    assert all(x.device.type == "meta" for st in meta.reducers.values()
               for x in (st if isinstance(st, tuple) else (st,)))
    cpu = M.init_telemetry(cfg, {k: torch.zeros(5, dtype=v.dtype) for k, v in shapes.items()})
    assert cpu.reducers["residual_energy/max"].dtype == torch.float32
    assert cpu.reducers["staleness/max"].dtype == torch.int32
    assert int(cpu.reducers["staleness/max"][0]) == torch.iinfo(torch.int32).min
    assert cpu.reducers["selected/count"].dtype == torch.int32


def test_update_makes_no_host_sync(monkeypatch):
    """A round's fold reads nothing back to the host and copies nothing
    to the device: `.item()`, `.cpu()`, `.numpy()`, `.tolist()`, a tensor
    used as a Python bool and `torch.tensor` all raise while it runs."""
    specs = M.ASYNC_SPECS + M.FAULT_SPECS + (
        M.MetricSpec("staleness", "p50", hi=8.0), M.MetricSpec("staleness", "p95", hi=8.0),
        M.MetricSpec("H", "ring", every=2, cap=3), M.MetricSpec("n_lost", "max"))
    cfg = M.TelemetryCfg(mode="streaming", specs=specs)
    rng = np.random.default_rng(5)
    m = {"selected": torch.from_numpy(rng.random(S) < 0.3),
         "H": torch.from_numpy(rng.integers(1, 9, S).astype(np.int32)),
         "residual_energy": torch.from_numpy(rng.uniform(0, 9, S).astype(np.float32)),
         "staleness": torch.from_numpy(rng.integers(0, 9, S).astype(np.int32)),
         "update_staleness": torch.from_numpy(rng.integers(0, 9, S).astype(np.int32)),
         "wall_clock": torch.tensor(3.5)}
    m |= {k: torch.tensor(2) for k in ("n_aborted", "n_lost", "n_corrupted", "n_straggler")}
    carry = M.init_telemetry(cfg, m)

    def refuse(*a, **k):
        raise AssertionError("host sync in update_telemetry")

    for name in ("item", "cpu", "numpy", "tolist", "__bool__"):
        monkeypatch.setattr(torch.Tensor, name, refuse)
    monkeypatch.setattr(torch, "tensor", refuse)
    for r in range(4):
        carry = M.update_telemetry(cfg, carry, m, r)
    monkeypatch.undo()
    out = M.finalize_telemetry(cfg, carry)
    assert int(out["tel/H/ring/n"]) == 2 and float(out["tel/n_lost/sum"]) == 8.0
