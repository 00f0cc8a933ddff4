"""Exact checkpoint and resume in the port (`repro_torch.training.
checkpoint`, `launch.engine.run_rounds(checkpoint_every=, checkpoint_dir=,
resume=)`), on the CPU.

The reference's `tests/test_checkpoint_resume.py` against the port's
engine at its size (N 10, K 4, 6 rounds, a checkpoint every 2): a run
stopped at a chunk boundary and resumed from its checkpoint is bitwise
the uninterrupted run (params, FleetState, EnvState, AsyncState, the
streaming reducers and the rows after the resume point) in the four
engine cells {sync, async} x {dense, streaming} and under flaky-fleet's
faults; the sidecar, corruption and fall-back mechanics.

Then the two packages side by side: `tree_digest` equal on the same
trees, each package reading the other's files (bf16 leaves included),
and the port stopped at round 2 and resumed on the reference's draws
(`tests/test_torch_round.py::jax_noise_fn`) against the reference's
uninterrupted run: masks bitwise, floats within the engine tests' rtol
1e-4.
"""
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import METHODS as JMETHODS
from repro.launch import engine as jengine
from repro.launch.fl_run import build_task as j_build_task
from repro.launch.fl_run import quick_cfg as j_quick_cfg
from repro.models.fl_models import make_fl_model as j_make_model
from repro.sim.devices import build_fleet as j_build_fleet
from repro.training import checkpoint as jckpt
from repro_torch.core.async_agg import AsyncCfg
from repro_torch.core.methods import METHODS
from repro_torch.core.metrics import TelemetryCfg
from repro_torch.core.policy import PolicyCfg
from repro_torch.core.round import FLConfig
from repro_torch.launch.engine import run_rounds
from repro_torch.launch.fl_run import build_task, quick_cfg
from repro_torch.models.fl_models import make_fl_model, params_from_jax
from repro_torch.sim.devices import build_fleet
from repro_torch.sim.dynamics import SCENARIOS
from repro_torch.training import checkpoint as ckpt
from tests.test_torch_round import jax_noise_fn

N, K = 10, 4
ROUNDS, EVERY = 6, 2


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """Many small CPU ops: one intra-op thread runs them as fast, and
    keeps the parallel test workers from oversubscribing the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def setup():
    model = make_fl_model("cnn@mnist", small=True)
    fleet = build_fleet(N, seed=0, init_energy_mean=0.3, device="cpu")
    cx, cy, _ = build_task("cnn@mnist", N, 0.8, per_client=16, n_test=32, device="cpu")
    cfg = FLConfig(n_select=K, batch_size=4, probe_size=4, lr=0.05,
                   uplink_bits=16e6, policy=PolicyCfg(H0=2, H_max=6))
    return model, fleet, cx, cy, cfg


CELLS = [
    pytest.param(None, "dense", id="sync-dense"),
    pytest.param(None, "streaming", id="sync-streaming"),
    pytest.param(AsyncCfg(buffer_m=2), "dense", id="async-dense"),
    pytest.param(AsyncCfg(buffer_m=2), "streaming", id="async-streaming"),
]


def _run(setup, *, rounds=ROUNDS, async_cfg=None, mode="dense", scenario=None, **kw):
    model, fleet, cx, cy, cfg = setup
    return run_rounds(
        model, fleet, cx, cy, cfg, METHODS["rewafl"], rounds=rounds, seed=7,
        params=model.init(torch.Generator().manual_seed(0)), scenario=scenario,
        chunk_size=EVERY, async_cfg=async_cfg, telemetry=TelemetryCfg(mode=mode),
        device="cpu", **kw)


def _carry_digest(res) -> str:
    tree = {"params": res.params, "state": res.state, "env": res.env}
    if res.async_state is not None:
        tree["astate"] = res.async_state
    return ckpt.tree_digest(tree)


def _corrupt(path) -> None:
    raw = bytearray(open(path, "rb").read())
    raw[len(raw) // 2] ^= 0xFF
    open(path, "wb").write(bytes(raw))


# ------------------------------------------------- bitwise resume (4 cells)

@pytest.mark.parametrize("async_cfg,mode", CELLS)
def test_resume_is_bitwise_equivalent(setup, tmp_path, async_cfg, mode):
    full = _run(setup, async_cfg=async_cfg, mode=mode)
    # interrupted run: a checkpoint every EVERY rounds, stopped at round 4
    _run(setup, rounds=4, async_cfg=async_cfg, mode=mode,
         checkpoint_every=EVERY, checkpoint_dir=str(tmp_path))
    assert os.path.exists(tmp_path / f"ckpt_r{4:08d}.npz")
    resumed = _run(setup, async_cfg=async_cfg, mode=mode, resume=str(tmp_path))
    assert resumed.start_round == 4 and resumed.rounds_run == ROUNDS
    assert _carry_digest(resumed) == _carry_digest(full)
    # the streaming reducers are part of the carry: bitwise too
    if mode == "streaming":
        assert set(resumed.telemetry) == set(full.telemetry)
        for k, v in full.telemetry.items():
            np.testing.assert_array_equal(resumed.telemetry[k], v, err_msg=k)
    assert set(resumed.history) == set(full.history)
    for k, v in full.history.items():
        # the resumed run ran rounds 4..6; the rows before are zeros
        np.testing.assert_array_equal(v[4:], resumed.history[k][4:], err_msg=k)
        assert resumed.history[k].shape == v.shape, k
        assert not np.any(np.asarray(resumed.history[k][:4], np.float64)), k


def test_resume_under_chaos_scenario(setup, tmp_path):
    """Resume is bitwise with fault injection and the screen: the fault
    draws come from the round-noise generator, whose state is carried."""
    sc = SCENARIOS["flaky-fleet"]
    full = _run(setup, scenario=sc)
    _run(setup, rounds=2, scenario=sc, checkpoint_every=EVERY,
         checkpoint_dir=str(tmp_path))
    resumed = _run(setup, scenario=sc, resume=str(tmp_path))
    assert resumed.start_round == 2
    assert _carry_digest(resumed) == _carry_digest(full)
    np.testing.assert_array_equal(full.history["n_rejected"][2:],
                                  resumed.history["n_rejected"][2:])


def test_resume_beyond_rounds_rejected(setup, tmp_path):
    _run(setup, rounds=4, checkpoint_every=EVERY, checkpoint_dir=str(tmp_path))
    with pytest.raises(ValueError, match="beyond the requested 2 rounds"):
        _run(setup, rounds=2, resume=str(tmp_path))


def test_checkpoint_cfg_validation(setup, tmp_path):
    with pytest.raises(ValueError, match="checkpoint_every must be >= 1"):
        _run(setup, checkpoint_every=0, checkpoint_dir=str(tmp_path))
    with pytest.raises(ValueError, match="needs checkpoint_dir"):
        _run(setup, checkpoint_every=2)


# ---------------------------------------------------- durability mechanics

def _payload():
    return {"a": torch.arange(6, dtype=torch.float32).reshape(2, 3),
            "b": {"c": torch.tensor([1, 2], dtype=torch.int32)},
            "round": torch.tensor(4, dtype=torch.int32)}


def test_save_load_roundtrip_and_digest(tmp_path):
    tree = _payload()
    p = ckpt.save_checkpoint(str(tmp_path / "ckpt_r00000004.npz"), tree)
    assert os.path.exists(p + ".sha256")
    loaded = ckpt.load_checkpoint(p, tree)
    assert ckpt.tree_digest(loaded) == ckpt.tree_digest(tree)
    for (ka, a), (kb, b) in zip(ckpt._leaves(loaded), ckpt._leaves(tree)):
        assert ka == kb and a.dtype == b.dtype
        assert torch.equal(a, b)
        assert a.data_ptr() != b.data_ptr()   # fresh tensors


def test_corrupted_checkpoint_raises(tmp_path):
    tree = _payload()
    p = ckpt.save_checkpoint(str(tmp_path / "ckpt_r00000002.npz"), tree)
    _corrupt(p)
    with pytest.raises(ckpt.CheckpointError, match="sha256"):
        ckpt.load_checkpoint(p, tree)


def test_missing_sidecar_raises(tmp_path):
    tree = _payload()
    p = ckpt.save_checkpoint(str(tmp_path / "ckpt_r00000002.npz"), tree)
    os.remove(p + ".sha256")
    with pytest.raises(ckpt.CheckpointError, match="sidecar"):
        ckpt.load_checkpoint(p, tree)


def test_checkpoint_paths_ordering(tmp_path):
    tree = _payload()
    for r in (4, 2, 10):
        ckpt.save_checkpoint(str(tmp_path / f"ckpt_r{r:08d}.npz"), tree)
    paths = ckpt.checkpoint_paths(str(tmp_path))
    rounds = [int(os.path.basename(p)[6:-4]) for p in paths]
    assert rounds == [2, 4, 10]
    assert ckpt.latest_checkpoint(str(tmp_path)).endswith("ckpt_r00000010.npz")


def test_load_latest_falls_back_past_corruption(tmp_path):
    tree = dict(_payload(), round=torch.tensor(2, dtype=torch.int32))
    p2 = ckpt.save_checkpoint(str(tmp_path / "ckpt_r00000002.npz"), tree)
    newer = dict(tree, round=torch.tensor(6, dtype=torch.int32))
    p6 = ckpt.save_checkpoint(str(tmp_path / "ckpt_r00000006.npz"), newer)
    _corrupt(p6)
    loaded, used = ckpt.load_latest(str(tmp_path), tree)
    assert used == p2
    assert int(loaded["round"]) == 2
    # every checkpoint corrupt -> CheckpointError
    _corrupt(p2)
    with pytest.raises(ckpt.CheckpointError, match="no usable checkpoint"):
        ckpt.load_latest(str(tmp_path), tree)


def test_engine_resume_falls_back_past_corruption(setup, tmp_path):
    """The engine resumes from the newest intact checkpoint when the
    newest one is damaged."""
    _run(setup, rounds=4, checkpoint_every=EVERY, checkpoint_dir=str(tmp_path))
    _corrupt(str(tmp_path / f"ckpt_r{4:08d}.npz"))
    resumed = _run(setup, resume=str(tmp_path))
    assert resumed.start_round == 2
    full = _run(setup)
    assert _carry_digest(resumed) == _carry_digest(full)


def test_tree_digest_sensitivity():
    tree = _payload()
    assert ckpt.tree_digest(tree) == ckpt.tree_digest(_payload())
    bumped = dict(tree, a=tree["a"].clone())
    bumped["a"][0, 0] += 1.0
    assert ckpt.tree_digest(bumped) != ckpt.tree_digest(tree)


# ------------------------------------------------- the two packages' files

def _np_tree():
    rng = np.random.default_rng(0)
    return {"w": rng.standard_normal((3, 5)).astype(np.float32),
            "state": {"H": rng.integers(1, 30, 7).astype(np.int32),
                      "dropped": rng.random(7) < 0.5,
                      "inner": {"t": np.float32(2.5)}},
            "round": np.asarray(4, np.int32)}


def _torch_tree(tree):
    return {k: _torch_tree(v) if isinstance(v, dict) else torch.from_numpy(np.array(v))
            for k, v in tree.items()}


def test_tree_digest_matches_reference():
    """The port's digest of a tree equals the reference's of the same
    arrays (f32, int32, bool, 0-d, nested dicts; bf16)."""
    tree = _np_tree()
    assert ckpt.tree_digest(_torch_tree(tree)) == jckpt.tree_digest(tree)
    assert ckpt.tree_digest(tree) == jckpt.tree_digest(tree)
    bf = np.random.default_rng(1).standard_normal((4, 3)).astype(np.float32)
    assert (ckpt.tree_digest({"x": torch.from_numpy(bf).to(torch.bfloat16)})
            == jckpt.tree_digest({"x": jnp.asarray(bf, jnp.bfloat16)}))


def test_reference_file_loads_in_the_port(tmp_path):
    """A checkpoint the reference writes (its sidecar included) loads
    through the port's `load_checkpoint`, bf16 leaves included."""
    tree = _np_tree()
    bf = np.random.default_rng(2).standard_normal(6).astype(np.float32)
    p = jckpt.save_checkpoint(str(tmp_path / "ckpt_r00000004.npz"),
                              dict(tree, bf=jnp.asarray(bf, jnp.bfloat16)))
    like = dict(_torch_tree(tree), bf=torch.zeros(6, dtype=torch.bfloat16))
    got = ckpt.load_checkpoint(p, like)
    for (k, a), (_, b) in zip(ckpt._leaves(got), ckpt._leaves(_torch_tree(tree))):
        assert a.dtype == b.dtype and torch.equal(a, b), k
    np.testing.assert_array_equal(got["bf"].float().numpy(),
                                  torch.from_numpy(bf).to(torch.bfloat16).float().numpy())


def test_port_file_loads_in_the_reference(tmp_path):
    """A checkpoint the port writes loads through the reference's
    `load_checkpoint` (sidecar verified), bf16 leaves included."""
    tree = _np_tree()
    bf = np.random.default_rng(3).standard_normal(6).astype(np.float32)
    p = ckpt.save_checkpoint(str(tmp_path / "ckpt_r00000004.npz"),
                             dict(_torch_tree(tree), bf=torch.from_numpy(bf).to(torch.bfloat16)))
    like = jax.tree.map(jnp.zeros_like, dict(tree, bf=jnp.zeros(6, jnp.bfloat16)))
    got = jckpt.load_checkpoint(p, like)
    jax.tree.map(lambda a, b: np.testing.assert_array_equal(np.asarray(a), b),
                 {k: got[k] for k in tree}, tree)
    assert got["bf"].dtype == jnp.bfloat16
    np.testing.assert_array_equal(np.asarray(got["bf"], np.float32),
                                  torch.from_numpy(bf).to(torch.bfloat16).float().numpy())
    assert jckpt.tree_digest(got) == ckpt.tree_digest(ckpt.load(p, dict(
        _torch_tree(tree), bf=torch.zeros(6, dtype=torch.bfloat16))))


def test_resumed_run_matches_reference(tmp_path):
    """The port stopped at round 2 and resumed to 4 on the reference's
    draws against the reference's uninterrupted 4-round run: rounds 2-3's
    masks bitwise, their history and the final FleetState as the engine
    tests hold them."""
    S, n_per, n_test, rounds = 10, 64, 512, 4
    jmodel, model = j_make_model("cnn@mnist", small=True), make_fl_model("cnn@mnist", small=True)
    jfleet, fleet = j_build_fleet(S, seed=0), build_fleet(S, seed=0, device="cpu")
    jcx, jcy, _ = j_build_task("cnn@mnist", S, 0.8, per_client=n_per, n_test=n_test)
    cx, cy, _ = build_task("cnn@mnist", S, 0.8, per_client=n_per, n_test=n_test, device="cpu")
    jcfg, cfg = j_quick_cfg(K), quick_cfg(K)
    jparams, key = jmodel.init(jax.random.PRNGKey(2)), jax.random.PRNGKey(1)
    want = jengine.run_rounds(jmodel, jfleet, jcx, jcy, jcfg, JMETHODS["rewafl"],
                              rounds=rounds, key=key, params=jparams,
                              ecfg=jengine.EngineCfg(chunk_size=2))

    def port(r, **kw):
        return run_rounds(model, fleet, cx, cy, cfg, METHODS["rewafl"], rounds=r,
                          params=params_from_jax(jparams, device="cpu"), chunk_size=2,
                          noise_fn=jax_noise_fn(key, S, K, cfg.policy.H_max, cfg.batch_size,
                                                n_per), device="cpu", **kw)

    port(2, checkpoint_every=2, checkpoint_dir=str(tmp_path))
    got = port(rounds, resume=str(tmp_path))
    assert got.start_round == 2 and got.rounds_run == want.rounds_run == rounds
    assert set(got.history) == set(want.history)
    np.testing.assert_array_equal(got.history["selected"][2:], want.history["selected"][2:])
    for k, v in want.history.items():
        np.testing.assert_allclose(np.asarray(got.history[k][2:], np.float64),
                                   np.asarray(v[2:], np.float64), rtol=1e-4, atol=1e-6,
                                   err_msg=k)
    for name in got.state._fields:
        np.testing.assert_allclose(np.asarray(getattr(got.state, name).numpy(), np.float64),
                                   np.asarray(getattr(want.state, name), np.float64),
                                   rtol=1e-4, atol=1e-6, err_msg=name)
