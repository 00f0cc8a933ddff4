"""Parity of the port's campaign engine (`repro_torch.launch.engine`:
`run_campaign_batch`, `run_campaign_grid`, `run_loop`) and its parts
(`core.methods.MethodParams`, the traced ε-greedy selection, the
traced-method round body) with the reference's, on the CPU at small
size: the width-reduced CNN, S = 10, K = 4, 3 rounds in chunks of 2,
seeds 0 and 1.

Every case runs the live reference (`kernel_backend="xla"`) and hands
the port the reference's draws: each cell's round noise from its key
chain `PRNGKey(seed + 1)` (`tests.test_torch_round.jax_noise_fn`), its
initial params from `PRNGKey(seed + 2)` and, on a dynamic scenario, its
initial environment from `PRNGKey(seed + 3)`, through the engine's
`noise_fn=`, `params=` and `env=`.

Selection masks must match bitwise in every cell and round. Floats:
the histories within rtol 1e-4 plus atol 1e-6 and accuracy within one
test sample, as the chunked-engine tests hold them
(tests/test_torch_engine.py): the two frameworks' convolutions and sums
run in different orders, and three rounds of SGD grow that last-bit
drift. One round body: within atol 1e-5 plus rtol 1e-5, as the round
tests (tests/test_torch_round.py). The reference's own mixed sync ×
async grid differs from its per-method batch by an ulp in
`round_energy` under jax 0.9, so that grid is held to the reference
within the same tolerance, not to exact equality.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import METHODS as JMETHODS
from repro.core import init_fleet_state as j_init_state
from repro.core import methods as jmethods
from repro.core import selection as jsel
from repro.core.policy import PolicyCfg as JPolicyCfg
from repro.core.round import FLConfig as JFLConfig
from repro.core.round import make_eval_fn as j_make_eval_fn
from repro.core.round import make_round_body_mp as j_make_round_body_mp
from repro.launch import engine as jengine
from repro.launch import fl_run as j_fl_run
from repro.launch.fl_run import build_task_batch as j_build_task_batch
from repro.models.fl_models import make_fl_model as j_make_model
from repro.sim.devices import build_fleet as j_build_fleet
from repro.sim.devices import build_fleet_batch as j_build_fleet_batch
from repro.sim.dynamics import get_scenario as j_get_scenario
from repro.sim.dynamics import init_env_state as j_init_env_state
from repro.sim.faults import FaultCfg as JFaultCfg
from repro_torch.common import tree_stack
from repro_torch.core import selection as sel
from repro_torch.core.methods import (METHODS, MethodParams, async_variant,
                                      batchable, method_params,
                                      method_params_batch)
from repro_torch.core.policy import PolicyCfg
from repro_torch.core.round import (FLConfig, make_batch_eval_fn,
                                    make_round_body, make_round_body_mp)
from repro_torch.core.state import init_fleet_state, replicate_state
from repro_torch.core.metrics import DEFAULT_SPECS, MetricSpec, TelemetryCfg
from repro_torch.launch import engine, fl_run
from repro_torch.launch.fl_run import build_task_batch, run_fl
from repro_torch.models.fl_models import make_fl_model, params_from_jax
from repro_torch.sim.devices import build_fleet, build_fleet_batch
from repro_torch.sim.dynamics import get_scenario, init_env_state
from repro_torch.sim.faults import FaultCfg, FaultParams
from tests.test_torch_engine import (assert_run_fl_match, env_from_jax,
                                     FLEET, N_TEST)
from tests.test_torch_round import assert_close, jax_noise_fn, round_noise_from_key

S, K, N_PER, ROUNDS, CHUNK = 10, 4, 16, 3, 2
GRID_ROUNDS = 2   # one chunk: the grids compile the reference once
SEEDS = (0, 1)
RTOL, ATOL = 1e-4, 1e-6    # histories (the engine tests' tolerance)


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """Many small ops: one intra-op thread runs them as fast as many and
    keeps the parallel test workers from oversubscribing the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _cfgs():
    pol = dict(H0=2, H_max=6)
    kw = dict(n_select=K, batch_size=4, probe_size=4, lr=0.05, uplink_bits=16e6)
    return (JFLConfig(policy=JPolicyCfg(**pol), kernel_backend="xla", **kw),
            FLConfig(policy=PolicyCfg(**pol), **kw))


class Setup:
    """Both packages' model, fleets and data at the test size: per-seed
    (B, ...) fleets and data, and seed 0's as the shared ones."""

    def __init__(self):
        self.jcfg, self.cfg = _cfgs()
        self.jmodel = j_make_model("cnn@mnist", small=True)
        self.model = make_fl_model("cnn@mnist", small=True)
        self.jfleet_b = j_build_fleet_batch(SEEDS, S, **FLEET)
        self.fleet_b = build_fleet_batch(SEEDS, S, device="cpu", **FLEET)
        self.jcx_b, self.jcy_b, self.jtest_b = j_build_task_batch(
            "cnn@mnist", SEEDS, S, 0.8, per_client=N_PER, n_test=N_TEST)
        self.cx_b, self.cy_b, self.test_b = build_task_batch(
            "cnn@mnist", SEEDS, S, 0.8, per_client=N_PER, n_test=N_TEST,
            device="cpu")
        self.jfleet = j_build_fleet(S, seed=0, **FLEET)
        self.fleet = build_fleet(S, seed=0, device="cpu", **FLEET)

    def data(self, per_seed):
        """(jfleet, jcx, jcy, fleet, cx, cy) for a per-seed or shared run."""
        if per_seed:
            return (self.jfleet_b, self.jcx_b, self.jcy_b, self.fleet_b,
                    self.cx_b, self.cy_b)
        return (self.jfleet, self.jcx_b[0], self.jcy_b[0], self.fleet,
                self.cx_b[0], self.cy_b[0])

    def eval_fns(self, per_seed):
        """Batch eval functions of both packages: (B,) accuracies."""
        if per_seed:
            jf = jax.vmap(lambda p, x, y: self.jmodel.accuracy(p, {"x": x, "y": y}))
            return (lambda p: jf(p, self.jtest_b["x"], self.jtest_b["y"]),
                    make_batch_eval_fn(self.model, self.test_b["x"],
                                       self.test_b["y"], per_seed=True))
        jf = jax.vmap(j_make_eval_fn(self.jmodel, self.jtest_b["x"][0],
                                     self.jtest_b["y"][0]))
        return jf, make_batch_eval_fn(self.model, self.test_b["x"][0],
                                      self.test_b["y"][0])


@pytest.fixture(scope="module")
def setup():
    return Setup()


def _ref_init(st: Setup, scenario, per_seed):
    """The reference's initial params (`PRNGKey(seed + 2)`) and, on a
    dynamic scenario, environment (`PRNGKey(seed + 3)`), stacked over
    the seeds for the port's `params=` / `env=`."""
    params = tree_stack([params_from_jax(st.jmodel.init(jax.random.PRNGKey(s + 2)),
                                         device="cpu") for s in SEEDS])
    jsc = j_get_scenario(scenario)
    if not jsc.dynamic:
        return params, None
    envs = []
    for b, s in enumerate(SEEDS):
        jf = jax.tree.map(lambda x: x[b], st.jfleet_b) if per_seed else st.jfleet
        envs.append(env_from_jax(j_init_env_state(jf, jsc, key=jax.random.PRNGKey(s + 3))))
    return params, tree_stack(envs)


def _noise_fn(cfg, seeds, n_methods, scenario, jitter=False):
    """The reference's per-cell draws: cell i·B + j from PRNGKey(seeds[j] + 1)."""
    sc = get_scenario(scenario)
    fns = [jax_noise_fn(jax.random.PRNGKey(s + 1), S, K, cfg.policy.H_max,
                        cfg.batch_size, N_PER, sc.dynamic, sc.faults.enabled,
                        jitter)
           for _ in range(n_methods) for s in seeds]
    return lambda c, r: fns[c](r)


def assert_hist_match(got, want, err=""):
    """Same keys; masks and counters bitwise; floats within RTOL/ATOL;
    accuracy within one test sample."""
    assert set(got) == set(want), set(got) ^ set(want)
    for k, v in want.items():
        if k in ("chunk_wall_s", "compile_s"):
            continue
        g, w = np.asarray(got[k]), np.asarray(v)
        assert g.shape == w.shape, (k, g.shape, w.shape)
        if k == "acc_curve":
            np.testing.assert_allclose(g, w, atol=1 / N_TEST + 1e-9, err_msg=err + k)
        elif w.dtype.kind in "biu":
            np.testing.assert_array_equal(g, w, err_msg=err + k)
        else:
            np.testing.assert_allclose(g.astype(np.float64), w.astype(np.float64),
                                       rtol=RTOL, atol=ATOL, err_msg=err + k)


def _run_port_grid(st, methods, *, per_seed=True, scenario="static-paper",
                   rounds=GRID_ROUNDS, evaluate=False, **kw):
    """The port's `run_campaign_grid` on the reference's draws."""
    _, _, _, fleet, cx, cy = st.data(per_seed)
    params, env = _ref_init(st, scenario, per_seed)
    return engine.run_campaign_grid(
        st.model, fleet, cx, cy, st.cfg, methods, scenario=get_scenario(scenario),
        eval_fn=st.eval_fns(per_seed)[1] if evaluate else None, seeds=SEEDS,
        rounds=rounds, chunk_size=CHUNK, per_seed_fleets=per_seed,
        target_acc=0.15 if evaluate else None, device="cpu",
        noise_fn=_noise_fn(st.cfg, SEEDS, len(methods), scenario), params=params,
        env=env, **kw)


def _run_both_grid(st, methods, *, per_seed=True, scenario="static-paper",
                   rounds=GRID_ROUNDS, evaluate=True, **kw):
    """`run_campaign_grid` of both packages on the same draws; each of
    `kw` is a (reference's, port's) pair."""
    jfleet, jcx, jcy, fleet, cx, cy = st.data(per_seed)
    jev, ev = st.eval_fns(per_seed) if evaluate else (None, None)
    params, env = _ref_init(st, scenario, per_seed)
    jmethods_ = {n: (dataclasses.replace(JMETHODS[s.name.removesuffix("_async")],
                                         name=s.name, aggregation=s.aggregation,
                                         buffer_m=s.buffer_m)
                     if s.name.removesuffix("_async") in JMETHODS else s)
                 for n, s in methods.items()}
    common = dict(seeds=SEEDS, rounds=rounds, chunk_size=CHUNK,
                  per_seed_fleets=per_seed, target_acc=0.15 if evaluate else None)
    want = jengine.run_campaign_grid(
        st.jmodel, jfleet, jcx, jcy, st.jcfg, jmethods_,
        scenario=j_get_scenario(scenario), eval_fn=jev, **common,
        **{k: v[0] for k, v in kw.items()})
    got = engine.run_campaign_grid(
        st.model, fleet, cx, cy, st.cfg, methods, scenario=get_scenario(scenario),
        eval_fn=ev, device="cpu", **common, params=params, env=env,
        noise_fn=_noise_fn(st.cfg, SEEDS, len(methods), scenario),
        **{k: v[1] for k, v in kw.items()})
    return got, want


# ------------------------------------------------------------ methods


FAULTS = dict(abort_rate=0.1, loss_rate=0.2, corrupt_rate=0.05,
              straggler_rate=0.3, straggler_mult=4.0)


@pytest.mark.parametrize("name", sorted(METHODS) + ["rewafl_async"])
@pytest.mark.parametrize("faulted", [False, True])
def test_method_params_match_reference(name, faulted):
    """`method_params` leaf by leaf, with the effective ε (random 1, rea
    0), the async trigger (0 for sync) and the scenario's fault rates."""
    if name == "rewafl_async":
        spec = async_variant(METHODS["rewafl"], 7)
        jspec = jmethods.async_variant(JMETHODS["rewafl"], 7)
    else:
        spec, jspec = METHODS[name], JMETHODS[name]
    kw = dict(alpha=0.5, beta=2.0, autofl_eta=1.5, autofl_ema=0.25)
    got = method_params(spec, fault_cfg=FaultCfg(**FAULTS) if faulted else None, **kw)
    want = jmethods.method_params(jspec, fault_cfg=JFaultCfg(**FAULTS) if faulted
                                  else None, **kw)
    assert isinstance(got, MethodParams) and isinstance(got.faults, FaultParams)
    for g, w in zip(jax.tree.leaves(tuple(got)), jax.tree.leaves(tuple(want))):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))
        assert g.numpy().dtype == np.asarray(w).dtype


def test_method_params_batch_and_batchable():
    """`method_params_batch` stacks every leaf over the methods, as the
    reference's; `batchable` accepts the registry and refuses a selector
    or a policy without a traced branch, as the reference's does."""
    specs = list(METHODS.values())
    got = method_params_batch(specs, fault_cfg=FaultCfg(**FAULTS))
    want = jmethods.method_params_batch([JMETHODS[s.name] for s in specs],
                                        fault_cfg=JFaultCfg(**FAULTS))
    for g, w in zip(jax.tree.leaves(tuple(got)), jax.tree.leaves(tuple(want))):
        assert g.shape == (len(specs),)
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))
    odd = [dataclasses.replace(METHODS["oort"], selector="fedcs"),
           dataclasses.replace(METHODS["rewafl"], policy="greedy")]
    assert batchable(specs) and jmethods.batchable(list(JMETHODS.values()))
    for o in odd:
        jo = jmethods.MethodSpec(o.name, o.selector, o.policy, o.exploration)
        assert batchable(specs + [o]) is jmethods.batchable(
            list(JMETHODS.values()) + [jo]) is False
        with pytest.raises(ValueError, match="traced branch"):
            method_params(o)


# ------------------------------------------------------------ selection


def _sel_inputs(seed, n_avail):
    """(S,) f32 utilities with ties (values on a coarse grid, ±0) and an
    availability mask with `n_avail` devices."""
    rng = np.random.RandomState(seed)
    utils = np.round(rng.randn(S), 1).astype(np.float32)
    utils[:3] = [0.0, -0.0, 0.0]
    avail = np.zeros(S, bool)
    avail[rng.permutation(S)[:n_avail]] = True
    return utils, avail


@pytest.mark.parametrize("eps", [0.0, 0.1, 0.5, 1.0])
@pytest.mark.parametrize("n_avail", [S, 6, 2])
@pytest.mark.parametrize("fused", [False, True])
def test_traced_epsilon_greedy_matches_reference(eps, n_avail, fused):
    """The traced ε-greedy (plain and fused) against the reference's at
    the same key, bitwise, with ties, ±0 and fewer than K available; and
    against the port's static `epsilon_greedy` at the same ε. The port
    ranks in the IEEE total order (+0 above -0), as the reference's
    `lax.top_k` and its fused traced form do; the reference's plain
    traced form sorts the negated floats, which tie ±0, so it is held to
    the port only on utilities without a -0."""
    key = jax.random.PRNGKey(int(eps * 10) + n_avail)
    utils, avail = _sel_inputs(n_avail, n_avail)
    u = torch.from_numpy(np.array(jax.random.uniform(key, (S,))))
    k = 5
    fn = sel.epsilon_greedy_traced_fused if fused else sel.epsilon_greedy_traced
    teps = torch.tensor(eps, dtype=torch.float32)
    want = np.asarray(jsel.epsilon_greedy_traced_fused(
        key, jnp.asarray(utils), k, jnp.asarray(avail), jnp.float32(eps)))
    got = fn(u, torch.from_numpy(utils), k, torch.from_numpy(avail), teps)
    np.testing.assert_array_equal(got.numpy(), want)
    pos = np.abs(utils)
    want_plain = np.asarray(jsel.epsilon_greedy_traced(
        key, jnp.asarray(pos), k, jnp.asarray(avail), jnp.float32(eps)))
    np.testing.assert_array_equal(
        fn(u, torch.from_numpy(pos), k, torch.from_numpy(avail), teps).numpy(),
        want_plain)
    static = sel.epsilon_greedy(u, torch.from_numpy(utils), k,
                                torch.from_numpy(avail), eps)
    np.testing.assert_array_equal(got.numpy(), static.numpy())
    assert got.sum() == min(k, n_avail)


# ------------------------------------------------------------ round body


@pytest.mark.parametrize("method", sorted(METHODS))
def test_mp_round_body_matches_reference(setup, method):
    """One round of the traced-method body of each method from identical
    inputs against the reference's `make_round_body_mp`: masks bitwise,
    state, params and metrics within the round tests' 1e-5; and the
    port's own static body on the same draws, bitwise."""
    st = setup
    jfleet, jcx, jcy, fleet, cx, cy = st.data(False)
    jparams = st.jmodel.init(jax.random.PRNGKey(2))
    params = params_from_jax(jparams, device="cpu")
    jstate, state = j_init_state(jfleet, H0=2), init_fleet_state(fleet, H0=2)
    jenv, env = j_init_env_state(jfleet), init_env_state(fleet)
    kr = jax.random.split(jax.random.PRNGKey(5))[1]
    jbody = jax.jit(j_make_round_body_mp(st.jmodel, st.jcfg))
    jp, js, _, jm = jbody(jmethods.method_params(JMETHODS[method]), jparams, jstate,
                          jenv, jfleet, jcx, jcy, kr, jnp.asarray(0, jnp.int32))
    noise = round_noise_from_key(kr, S, K, st.cfg.policy.H_max, 4, N_PER)
    p, s, _, m = make_round_body_mp(st.model, st.cfg)(
        method_params(METHODS[method]), params, state, env, fleet, cx, cy, noise, 0)
    np.testing.assert_array_equal(m["selected"].numpy(), np.asarray(jm["selected"]))
    for name in s._fields:
        assert_close(getattr(s, name).numpy(), np.asarray(getattr(js, name)))
    for layer, leaves in jp.items():
        for leaf, want in leaves.items():
            assert_close(p[f"{layer}.{leaf}"].numpy(), want)
    assert set(m) == set(jm)
    for k in jm:
        assert_close(m[k].numpy(), np.asarray(jm[k]))
    H = st.cfg.policy.H0 if METHODS[method].policy == "fixed" else st.cfg.policy.H_max
    static = make_round_body(st.model, st.cfg, METHODS[method])(
        params, state, env, fleet, cx, cy,
        noise._replace(batch_idx=noise.batch_idx[:, :H]), 0)
    for k in m:
        assert torch.equal(m[k], static[3][k]), k


# ------------------------------------------------------------ campaigns


@pytest.mark.parametrize("method,per_seed", [("rewafl", True), ("rewafl", False),
                                             ("oort", True)])
def test_campaign_batch_matches_reference(setup, method, per_seed):
    """`run_campaign_batch` of one method over two seeds, with per-seed
    and shared fleets, against the reference's, with the chunk-boundary
    evaluation and `reached_round`; a rea method's selections go through
    the batched selection op. Seed j with per-seed fleets is `run_fl`'s
    campaign for seed j (its history and final energies equal the
    batch's row)."""
    st = setup
    jfleet, jcx, jcy, fleet, cx, cy = st.data(per_seed)
    jev, ev = st.eval_fns(per_seed)
    params, _ = _ref_init(st, "static-paper", per_seed)
    common = dict(seeds=SEEDS, rounds=ROUNDS, chunk_size=CHUNK,
                  per_seed_fleets=per_seed, target_acc=0.15, collect_per_device=True)
    want = jengine.run_campaign_batch(st.jmodel, jfleet, jcx, jcy, st.jcfg,
                                      JMETHODS[method], eval_fn=jev, **common)
    got = engine.run_campaign_batch(
        st.model, fleet, cx, cy, st.cfg, METHODS[method], eval_fn=ev,
        noise_fn=_noise_fn(st.cfg, SEEDS, 1, "static-paper"), params=params,
        device="cpu", **common)
    assert_hist_match(got, want)
    assert got["selected"].shape == (len(SEEDS), ROUNDS, S)


def test_campaign_batch_seed_is_run_fl():
    """Without injected draws, seed j of a per-seed batch is the port's
    `run_fl(seed=j)`: its own seeds for the fleet, data, model, noise.
    Masks and counts bitwise, floats within RTOL/ATOL."""
    seeds = (3,)
    cfg = fl_run.quick_cfg(K)
    model = make_fl_model("cnn@mnist", small=True)
    fleet = build_fleet_batch(seeds, S, device="cpu", **FLEET)
    cx, cy, _ = build_task_batch("cnn@mnist", seeds, S, 0.8, per_client=N_PER,
                                 device="cpu")
    got = engine.run_campaign_batch(model, fleet, cx, cy, cfg, METHODS["rewafl"],
                                    seeds=seeds, rounds=2, per_seed_fleets=True,
                                    collect_per_device=True, device="cpu")
    want = run_fl("cnn@mnist", "rewafl", rounds=2, n_clients=S, n_select=K,
                  seed=3, per_client=N_PER, fleet_kwargs=FLEET, device="cpu")
    np.testing.assert_array_equal(got["selected"][0].sum(0), want.history["sel_count"])
    np.testing.assert_array_equal(got["n_dropped"][0], want.history["n_dropped"])
    # the vmapped convolutions may sum in another order: an ulp apart
    for k in ("round_energy", "global_loss"):
        np.testing.assert_allclose(got[k][0], want.history[k], rtol=RTOL, atol=ATOL)
    np.testing.assert_allclose(got["final_residual_energy"][0],
                               want.history["residual_energy"], rtol=RTOL, atol=ATOL)


def test_grid_matches_reference_and_per_method(setup):
    """The six methods × two seeds grid on per-seed fleets, against the
    reference's batched grid (every method's history, every cell and
    round's mask bitwise), and each cell i·B+j against the port's own
    per-method path (`method_batched=False`): masks bitwise, the rest
    equal."""
    methods = dict(METHODS)
    got, want = _run_both_grid(setup, methods, collect_per_device=(True, True))
    per = _run_port_grid(setup, methods, evaluate=True,
                         collect_per_device=True, method_batched=False)
    assert list(got) == list(want) == list(methods)
    for name in methods:
        assert_hist_match(got[name], want[name], err=name + ": ")
        for k, v in per[name].items():
            if k not in ("chunk_wall_s", "compile_s"):
                np.testing.assert_array_equal(got[name][k], v, err_msg=f"{name}: {k}")


def test_grid_zero_rounds_keys(setup):
    """rounds = 0: the reference's keys with a zero-length round axis,
    from the round on the meta device; no kernel and no round runs."""
    got, want = _run_both_grid(setup, dict(METHODS), rounds=0,
                               evaluate=False, collect_per_device=(True, True))
    for name in METHODS:
        assert set(got[name]) == set(want[name])
        for k, v in want[name].items():
            assert np.shape(got[name][k]) == np.shape(v), k


def test_grid_streaming_matches_dense_and_reference(setup):
    """A streaming grid's reducers against the reference's streaming grid,
    and its count reducer against the dense grid's summed masks."""
    specs = DEFAULT_SPECS + (MetricSpec("H", "ring", every=1, cap=GRID_ROUNDS),
                             MetricSpec("residual_energy", "p50", bins=64, lo=0.0,
                                        hi=2e4))
    from repro.core.metrics import MetricSpec as JMetricSpec
    from repro.core.metrics import TelemetryCfg as JTelemetryCfg
    jspecs = tuple(JMetricSpec(**dataclasses.asdict(s)) for s in specs)
    methods = {n: METHODS[n] for n in ("oort", "rewafl", "reafl_lupa")}
    got, want = _run_both_grid(
        setup, methods, evaluate=False,
        telemetry=(JTelemetryCfg(mode="streaming", specs=jspecs),
                   TelemetryCfg(mode="streaming", specs=specs)))
    dense = _run_port_grid(setup, methods, collect_per_device=True)
    for name in methods:
        assert_hist_match(got[name], want[name], err=name + ": ")
        np.testing.assert_array_equal(got[name]["tel/selected/count"],
                                      dense[name]["selected"].sum(1))
        np.testing.assert_array_equal(got[name]["tel/H/ring"], dense[name]["H"])


@pytest.mark.parametrize("scenario", ["flaky-fleet", "commuter-diurnal"])
def test_grid_scenario_matches_reference(setup, scenario):
    """A faulted grid (each cell reads its fault rates from MethodParams)
    and a dynamic one (each cell steps its own environment), against the
    reference's."""
    methods = {n: METHODS[n] for n in ("random", "autofl", "rewafl")}
    got, want = _run_both_grid(setup, methods, scenario=scenario,
                               evaluate=False)
    for name in methods:
        assert_hist_match(got[name], want[name], err=name + ": ")
    if scenario == "flaky-fleet":
        assert sum(got[n]["n_straggler"].sum() for n in methods) > 0


def test_mixed_sync_async_grid_matches_reference(setup):
    """Sync and async methods in one grid: every cell runs the async
    round, the sync ones with the full-cohort sentinel; the buffer fits
    the largest trigger and the lands drain the smallest. Against the
    reference's mixed grid, and the sync cells' masks against the sync
    grid's."""
    methods = {"rewafl": METHODS["rewafl"], "oort": METHODS["oort"],
               "rewafl_async": async_variant(METHODS["rewafl"], 2)}
    got, want = _run_both_grid(setup, methods, evaluate=False,
                               collect_per_device=(True, True))
    sync = _run_port_grid(setup,
                          {n: methods[n] for n in ("rewafl", "oort")},
                          collect_per_device=True)
    for name in methods:
        assert_hist_match(got[name], want[name], err=name + ": ")
        assert "final_wall_clock" in got[name]
    for name in ("rewafl", "oort"):
        np.testing.assert_array_equal(got[name]["selected"], sync[name]["selected"])


# ------------------------------------------------------------ run_fl loop


def test_run_fl_loop_matches_reference(monkeypatch):
    """`run_fl(engine="loop")` against the reference's loop on its draws:
    evaluated at round % eval_every == 0 and at the last round; the
    port's wrapped `run_loop` gets the reference's round draws and
    initial params after checking the seeds `run_fl` handed it."""
    real = fl_run.run_loop

    def wrapped(model, fleet, cx, cy, cfg, spec, *, seed, params, env, **kw):
        assert seed == 1
        jparams = j_make_model("cnn@mnist", small=True).init(jax.random.PRNGKey(2))
        H = cfg.policy.H0 if spec.policy == "fixed" else cfg.policy.H_max
        return real(model, fleet, cx, cy, cfg, spec, seed=seed, env=env,
                    params=params_from_jax(jparams, device="cpu"),
                    noise_fn=jax_noise_fn(jax.random.PRNGKey(1), S, K, H,
                                          cfg.batch_size, cx.shape[1]), **kw)

    monkeypatch.setattr(fl_run, "run_loop", wrapped)
    args = dict(rounds=5, n_clients=S, n_select=K, eval_every=2, seed=0,
                engine="loop", fleet_kwargs=FLEET)
    got = run_fl("cnn@mnist", "rewafl", device="cpu", **args)
    want = j_fl_run.run_fl("cnn@mnist", "rewafl", **args)
    assert_run_fl_match(got, want)
    assert len(got.acc_curve) == 3 and got.chunk_wall_s is None
    assert set(got.history) - {"n_selected"} == set(want.history)
    assert got.overall_energy_j == pytest.approx(want.overall_energy_j, rel=1e-5)


def test_run_fl_loop_stops_at_target():
    """The loop stops at the first evaluated round at or above target and
    accounts latency, energy and dropouts up to there."""
    res = run_fl(rounds=6, n_clients=S, n_select=K, eval_every=2, target_acc=0.0,
                 engine="loop", device="cpu")
    assert res.rounds_run == 1 and res.reached_round == 0
    assert res.overall_latency_s == pytest.approx(float(res.history["round_latency"][0]))


@pytest.mark.parametrize("kw,match", [
    (dict(aggregation="async"), "buffer carry"),
    (dict(health=engine.HealthCfg()), "chunk boundaries"),
    (dict(checkpoint_every=2), "serialized at chunk"),
    (dict(telemetry="streaming"), "on-device reducers")])
def test_run_fl_loop_refuses_scan_only_options(kw, match):
    """The reference's ValueErrors for the loop with options only the
    chunked engine has."""
    with pytest.raises(ValueError, match=match):
        run_fl(rounds=1, n_clients=4, n_select=2, engine="loop", device="cpu", **kw)


def test_replicate_state_copies():
    """`replicate_state` stacks independent copies of every leaf."""
    fleet = build_fleet(4, device="cpu")
    st = replicate_state(init_fleet_state(fleet), 3)
    assert st.residual_energy.shape == (3, 4)
    st.residual_energy[0].zero_()
    assert st.residual_energy[1].abs().sum() > 0
