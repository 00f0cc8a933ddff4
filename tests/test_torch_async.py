"""Parity of the port's async buffered aggregation (`repro_torch.core.
async_agg`, the async round, `run_rounds` and `run_fl` with
`aggregation="async"`) with the reference's, on the CPU.

The reference's functions run live (eagerly for the buffer ops, jitted
for the round, `kernel_backend="xla"`), never against goldens. Buffers
move between the two as numpy leaves (`models.fl_models.
async_state_from_jax`), so a test can start the port from any reference
buffer. Tolerances are the round tests' (`tests/test_torch_round.py`):
masks, integer leaves and counters, and the clock bitwise where the ops
are the same; floats within atol 1e-5 + rtol 1e-5.

γ = (1 + staleness)^(−a) is not bitwise between the two: PyTorch takes
x^(−0.5) as a reciprocal square root, XLA computes the power; 597 of the
staleness values 0..1999 differ in the last bit at a = 0.5, none by more
than 2 ulp (`test_gamma_within_two_ulp`). Aggregated parameters are
therefore held within the float tolerance.

Two slots of one device can land in one step (a device dispatched in
consecutive rounds while its first update is still in flight); the
reference's XLA scatter on the CPU keeps the highest slot's staleness,
and the port keeps it by rule (`test_land_once_duplicate_device_*`).
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from hypothesis import given, settings
from hypothesis import strategies as st

from repro.core import FLConfig as JFLConfig
from repro.core import METHODS as JMETHODS
from repro.core import async_agg as jagg
from repro.core import init_fleet_state as j_init_state
from repro.core.methods import async_variant as j_async_variant
from repro.core.policy import PolicyCfg as JPolicyCfg
from repro.core.round import make_async_round_body as j_make_async_round_body
from repro.core.round import make_round_body as j_make_round_body
from repro.core.state import init_async_state as j_init_async_state
from repro.launch import engine as jengine
from repro.launch.fl_run import build_task as j_build_task
from repro.models.fl_models import make_fl_model as j_make_model
from repro.sim.devices import build_fleet as j_build_fleet
from repro.sim.dynamics import scenarios as jscenarios
from repro.sim.dynamics import init_env_state as j_init_env_state
from repro_torch.core import async_agg
from repro_torch.core.methods import METHODS, MethodSpec, async_variant
from repro_torch.core.policy import PolicyCfg
from repro_torch.core.round import (FLConfig, draw_noise, make_async_round_body,
                                    make_round_body)
from repro_torch.core.state import AsyncState, init_async_state, init_fleet_state
from repro_torch.launch import fl_run
from repro_torch.launch.engine import run_rounds
from repro_torch.launch.fl_run import ASYNC_HIST_KEYS, build_task, quick_cfg, run_fl
from repro_torch.models.fl_models import (ParamLayout, async_state_from_jax,
                                          make_fl_model, params_from_jax)
from repro_torch.sim.devices import build_fleet
from repro_torch.sim.dynamics import SCENARIOS, Scenario, init_env_state
from tests.test_torch_dynamics import _init_both
from tests.test_torch_engine import (FLEET, assert_run_fl_match,
                                     run_fl_with_reference_draws)
from tests.test_torch_round import ATOL, RTOL, assert_close, round_noise_from_key

S, K, N_PER = 10, 4, 16
W = 5                                  # the unit tests' one-leaf model width
LAYOUT = ParamLayout(("w",), ((W,),))
HIGH = dict(init_energy_mean=0.3)


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """The port's CPU rounds here are many small ops: one intra-op thread
    runs them as fast as many, and keeps the parallel test workers from
    oversubscribing the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def from_ref(ast) -> AsyncState:
    return async_state_from_jax(ast, LAYOUT, device="cpu")


def assert_states_match(got: AsyncState, want: AsyncState, exact=True):
    """Integer and boolean leaves bitwise; float leaves bitwise with
    `exact`, else within ATOL/RTOL."""
    for name in AsyncState._fields:
        g, w = getattr(got, name), getattr(want, name)
        assert g.dtype == w.dtype and g.shape == w.shape, name
        if exact or not g.is_floating_point():
            np.testing.assert_array_equal(g.numpy(), w.numpy(), err_msg=name)
        else:
            assert_close(g.numpy(), w.numpy())


def ref_state(seed, P_slots, n_live, *, devices=None, S_=S):
    """A reference buffer with `n_live` live slots at random places,
    arrivals after its clock, versions at most 3 behind, and the
    conservation n_dispatched = n_landed + n_expired + live."""
    rng = np.random.RandomState(seed)
    live = np.zeros(P_slots, bool)
    live[rng.choice(P_slots, n_live, replace=False)] = True
    t_now = np.float32(rng.uniform(0, 5))
    version = 5
    ast = j_init_async_state({"w": jnp.zeros(W)}, S_, P_slots)
    return ast._replace(
        t_now=jnp.float32(t_now), server_version=jnp.int32(version),
        slot_live=jnp.asarray(live),
        slot_device=jnp.asarray(devices if devices is not None
                                else rng.randint(0, S_, P_slots), jnp.int32),
        slot_arrival=jnp.asarray(t_now + rng.uniform(0, 10, P_slots), jnp.float32),
        slot_version=jnp.asarray(version - rng.randint(0, 4, P_slots), jnp.int32),
        slot_weight=jnp.asarray(rng.uniform(0.5, 5, P_slots), jnp.float32),
        slot_delta={"w": jnp.asarray(rng.normal(0, 1, (P_slots, W)), jnp.float32)},
        slot_retry=jnp.asarray(rng.randint(0, 3, P_slots), jnp.int32),
        n_dispatched=jnp.int32(20 + n_live), n_landed=jnp.int32(17),
        n_expired=jnp.int32(3),
        update_staleness=jnp.asarray(rng.randint(0, 4, S_), jnp.int32))


# ------------------------------------------------------------ AsyncCfg

BAD_CFGS = [dict(buffer_m=0), dict(delay="poisson"), dict(delay_jitter=-0.1),
            dict(staleness_power=-1.0), dict(ttl=0.0), dict(max_retries=-1),
            dict(retry_backoff=1.0), dict(retry_backoff=0.0)]


@pytest.mark.parametrize("kw", BAD_CFGS)
def test_async_cfg_validation_matches_reference(kw):
    with pytest.raises(ValueError):
        jagg.AsyncCfg(**kw)
    with pytest.raises(ValueError):
        async_agg.AsyncCfg(**kw)


def test_async_cfg_slots_and_lands_match_reference():
    for m in (1, 2, 3, 4, 7, 20):
        for k in (1, 4, 20):
            for cap in (None, max(m, k), m + k + 3):
                for n_lands in (None, 0, 3):
                    j = jagg.AsyncCfg(buffer_m=m, capacity=cap, n_lands=n_lands)
                    t = async_agg.AsyncCfg(buffer_m=m, capacity=cap, n_lands=n_lands)
                    assert (t.slots(k), t.lands(k)) == (j.slots(k), j.lands(k))
            with pytest.raises(ValueError):
                jagg.AsyncCfg(buffer_m=m, capacity=max(m, k) - 1).slots(k)
            with pytest.raises(ValueError):
                async_agg.AsyncCfg(buffer_m=m, capacity=max(m, k) - 1).slots(k)


def test_method_spec_async_matches_reference():
    from repro.core.methods import MethodSpec as JMethodSpec
    for name, spec in METHODS.items():
        got = async_variant(spec, 3)
        want = j_async_variant(JMETHODS[name], 3)
        assert dataclasses.asdict(got) == dataclasses.asdict(want)
    for kw in (dict(aggregation="fedbuff"), dict(aggregation="async"),
               dict(aggregation="async", buffer_m=0)):
        with pytest.raises(ValueError):
            JMethodSpec("x", "rea", "rewa", **kw)
        with pytest.raises(ValueError):
            MethodSpec("x", "rea", "rewa", **kw)


# ------------------------------------------------------- buffer ops

def test_init_async_state_matches_reference():
    jmodel, model = j_make_model("cnn@har", small=True), make_fl_model("cnn@har", small=True)
    jp = jmodel.init(jax.random.PRNGKey(0))
    flat = model.layout.flatten(params_from_jax(jp, device="cpu"))
    got = init_async_state(flat, S, 7)
    want = async_state_from_jax(j_init_async_state(jp, S, 7), model.layout, device="cpu")
    assert_states_match(got, want)
    assert got.slot_delta.shape == (7, model.layout.size) and got.slot_delta.is_contiguous()


def test_async_state_from_jax_flattens_each_slot():
    """A buffer of the HAR model (its 1-D conv weights transposed between
    the layouts): row i of the port's buffer is slot i's parameters."""
    jmodel, model = j_make_model("cnn@har", small=True), make_fl_model("cnn@har", small=True)
    jp = jmodel.init(jax.random.PRNGKey(1))
    ast = j_init_async_state(jp, S, 3)
    deltas = jax.tree.map(lambda x: jnp.stack([x * (i + 1) for i in range(3)]), jp)
    got = async_state_from_jax(ast._replace(slot_delta=deltas), model.layout, device="cpu")
    for i in range(3):
        want = model.layout.flatten(params_from_jax(jax.tree.map(lambda x: x[i], deltas),
                                                    device="cpu"))
        assert torch.equal(got.slot_delta[i], want)


# (P_slots, k, live slots in the buffer, cohort liveness)
PUSH_CASES = {
    "empty, all live": (8, 4, 0, [1, 1, 1, 1]),
    "dead cohort slots": (8, 4, 3, [1, 0, 1, 0]),
    "nearly full": (8, 4, 6, [1, 1, 1, 1]),
    "nearly full, dead first": (8, 4, 6, [0, 1, 1, 1]),
    "full": (6, 4, 6, [1, 1, 1, 1]),
    "k above capacity": (3, 5, 1, [1, 1, 0, 1, 1]),
}


@pytest.mark.parametrize("case", list(PUSH_CASES))
def test_push_cohort_matches_reference(case):
    """Cohort slot i goes to the i-th free buffer slot whether or not it
    is live, so a dead cohort slot still uses up its free-slot index;
    pushes beyond capacity drop. The whole buffer bitwise."""
    P_slots, k, n_live, live = PUSH_CASES[case]
    ast = ref_state(len(case), P_slots, n_live)
    rng = np.random.RandomState(k + n_live)
    deltas = rng.normal(0, 1, (k, W)).astype(np.float32)
    idx = rng.permutation(S)[:k].astype(np.int32)
    live = np.asarray(live, bool)
    weights = rng.uniform(0, 5, k).astype(np.float32)
    delays = rng.uniform(0.1, 10, k).astype(np.float32)
    want, wn = jagg.push_cohort(ast, {"w": jnp.asarray(deltas)}, jnp.asarray(idx),
                                jnp.asarray(live), jnp.asarray(weights),
                                jnp.asarray(delays))
    got, n = async_agg.push_cohort(from_ref(ast), torch.from_numpy(deltas),
                                   torch.from_numpy(idx), torch.from_numpy(live),
                                   torch.from_numpy(weights), torch.from_numpy(delays))
    assert int(n) == int(wn)
    assert_states_match(got, from_ref(want))
    if case == "dead cohort slots":
        # the free slots are the 5 not live; cohort slot 1 (dead) uses up
        # the second, so cohort slot 2 lands in the third
        free = np.flatnonzero(~np.asarray(ast.slot_live))
        assert got.slot_live[free[2]] and not got.slot_live[free[1]]


@pytest.mark.parametrize("ttl,max_retries", [(2.0, 2), (5.0, 0), (0.5, 1), (100.0, 2)])
def test_expire_and_retry_matches_reference(ttl, max_retries):
    ast = ref_state(int(ttl * 10), 8, 6)
    kw = dict(ttl=ttl, max_retries=max_retries, retry_backoff=0.5)
    want, winfo = jagg.expire_and_retry(ast, **kw)
    got, info = async_agg.expire_and_retry(from_ref(ast), **kw)
    assert_states_match(got, from_ref(want))
    for k in ("n_retried", "n_expired"):
        assert int(info[k]) == int(winfo[k])
    occ = int(got.slot_live.sum())
    assert int(got.n_dispatched) == int(got.n_landed) + int(got.n_expired) + occ


def _land_both(ast, m_eff, power, sync=None):
    """land_once of both on the same buffer and params; `sync` (aggregate,
    predicate) arms the fast path with a predicate that is constant."""
    params = np.random.RandomState(3).normal(0, 1, W).astype(np.float32)
    jkw, tkw = {}, {}
    if sync is not None:
        agg, pred = sync
        jkw = dict(sync_aggregate={"w": jnp.asarray(agg)},
                   sync_pred=lambda n: jnp.asarray(pred) & (n >= 0))
        tkw = dict(sync_aggregate=torch.from_numpy(agg),
                   sync_pred=lambda n: torch.tensor(pred) & (n >= 0))
    jp, jst, jinfo = jagg.land_once({"w": jnp.asarray(params)}, ast, m_eff,
                                    staleness_power=power, backend="xla", **jkw)
    p, st_, info = async_agg.land_once(torch.from_numpy(params), from_ref(ast),
                                       m_eff if isinstance(m_eff, int)
                                       else torch.tensor(int(m_eff), dtype=torch.int32),
                                       staleness_power=power, **tkw)
    assert_states_match(st_, from_ref(jst))
    for k in ("did_aggregate", "n_landed", "stale_sum", "landed"):
        np.testing.assert_array_equal(info[k].numpy(), np.asarray(jinfo[k]), err_msg=k)
    return p, np.asarray(jp["w"]), info


@pytest.mark.parametrize("power", [0.0, 0.5])
@pytest.mark.parametrize("m_eff,n_live", [(5, 4), (4, 4), (2, 6), (1, 1), (3, 7)])
def test_land_once_matches_reference(m_eff, n_live, power):
    """Below the trigger (m_eff 5 with 4 pending) nothing lands; at and
    above it the m_eff-th arrival sets the clock. The state bitwise, the
    parameters within ATOL/RTOL (γ differs in the last bit)."""
    ast = ref_state(m_eff * 10 + n_live, 8, n_live)
    p, want, info = _land_both(ast, m_eff, power)
    assert_close(p.numpy(), want)
    assert int(info["did_aggregate"]) == int(n_live >= m_eff)


def test_land_once_traced_trigger_matches_reference():
    """m_eff as a 0-d tensor (the round's relaxed trigger) gathers the
    sorted arrivals at m_eff − 1 on the device."""
    ast = ref_state(11, 8, 5)
    for m in (1, 3, 5, 6):
        p, want, _ = _land_both(ast, jnp.asarray(m, jnp.int32), 0.5)
        assert_close(p.numpy(), want)


@pytest.mark.parametrize("versions,want_stale", [((2, 4), 1), ((4, 2), 3)])
def test_land_once_duplicate_device_keeps_the_highest_slot(versions, want_stale):
    """Device 3 holds slots 1 and 4, both landing in one step (server
    version 5): the reference keeps slot 4's staleness whether it is the
    smaller or the larger, and so does the port."""
    devices = np.array([0, 3, 1, 2, 3, 5, 6, 7])
    ast = ref_state(5, 8, 8, devices=devices)
    ver = np.asarray(ast.slot_version).copy()
    ver[[1, 4]] = versions
    ast = ast._replace(slot_version=jnp.asarray(ver),
                       slot_arrival=jnp.full((8,), 1.0, jnp.float32) + ast.t_now)
    p, want, info = _land_both(ast, 2, 0.5)
    assert bool(info["landed"][1]) and bool(info["landed"][4])
    assert int(np.asarray(jagg.land_once({"w": jnp.zeros(W)}, ast, 2, staleness_power=0.5,
                                         backend="xla")[1].update_staleness)[3]) == want_stale
    assert_close(p.numpy(), want)


def test_land_once_sync_fast_path_matches_reference():
    """With the predicate true the result is the sync aggregate handed in,
    bitwise; with it false, the delta-form aggregate."""
    ast = ref_state(9, 8, 4)
    sync = np.random.RandomState(1).normal(0, 1, W).astype(np.float32)
    for pred in (True, False):
        p, want, _ = _land_both(ast, 4, 0.5, sync=(sync, pred))
        if pred:
            assert torch.equal(p, torch.from_numpy(sync))
        assert_close(p.numpy(), want)


def test_land_once_nan_in_a_dead_slot_poisons_both():
    """A NaN row left in a dead slot reaches the aggregation at weight 0,
    and 0 · NaN = NaN in the reference and in the port's plain fedavg."""
    ast = ref_state(4, 6, 3)
    live = np.asarray(ast.slot_live)
    dead = int(np.flatnonzero(~live)[0])
    d = np.asarray(ast.slot_delta["w"]).copy()
    d[dead, 1] = np.nan
    ast = ast._replace(slot_delta={"w": jnp.asarray(d)})
    p, want, info = _land_both(ast, 2, 0.5)
    assert int(info["did_aggregate"]) == 1
    np.testing.assert_array_equal(np.isnan(p.numpy()), np.isnan(want))
    assert np.isnan(want[1]) and np.isfinite(np.delete(want, 1)).all()


def test_gamma_within_two_ulp():
    """γ = (1 + staleness)^(−a) of the two libraries differ in the last
    bit for some staleness values (not bitwise), never by more than 2 ulp."""
    stale = np.arange(2000, dtype=np.int32)
    for a in (0.5, 0.25, 1.0, 1.5):
        want = np.asarray(jax.jit(lambda s: (1.0 + s.astype(jnp.float32)) ** (-a))(stale))
        got = ((1.0 + torch.from_numpy(stale).float()) ** (-a)).numpy()
        assert np.abs(got.view(np.int32) - want.view(np.int32)).max() <= 2, a


# -------------------------------------------- random schedules (property)

DELAY = st.floats(min_value=0.1, max_value=10.0, allow_nan=False, allow_infinity=False)
WEIGHT = st.floats(min_value=0.0, max_value=5.0, allow_nan=False, allow_infinity=False)


@settings(max_examples=20, deadline=None)
@given(k=st.integers(1, 5), steps=st.integers(1, 4), power=st.sampled_from([0.0, 0.5]),
       ttl=st.sampled_from([None, 3.0]), data=st.data())
def test_random_schedules_match_reference(k, steps, power, ttl, data):
    """Push a random cohort, maybe expire, then ceil(K/M) lands, for a few
    steps: every buffer leaf bitwise after every op, and the buffer's
    invariants (occupancy below M after a step, conservation, a clock
    and a version that never go back)."""
    m = data.draw(st.integers(1, k), label="buffer_m")
    cap = m + k
    jst = j_init_async_state({"w": jnp.zeros(W)}, S, cap)
    tst = from_ref(jst)
    jp, tp = {"w": jnp.zeros(W)}, torch.zeros(W)
    for step in range(steps):
        perm = data.draw(st.permutations(tuple(range(S))), label=f"dev{step}")
        idx = np.asarray(perm[:k], np.int32)
        live = np.asarray(data.draw(st.lists(st.booleans(), min_size=k, max_size=k)))
        delays = np.asarray(data.draw(st.lists(DELAY, min_size=k, max_size=k)), np.float32)
        weights = np.asarray(data.draw(st.lists(WEIGHT, min_size=k, max_size=k)), np.float32)
        deltas = (np.arange(k * W, dtype=np.float32).reshape(k, W) + step) / 10
        jst, _ = jagg.push_cohort(jst, {"w": jnp.asarray(deltas)}, jnp.asarray(idx),
                                  jnp.asarray(live), jnp.asarray(weights),
                                  jnp.asarray(delays))
        tst, _ = async_agg.push_cohort(tst, torch.from_numpy(deltas), torch.from_numpy(idx),
                                       torch.from_numpy(live), torch.from_numpy(weights),
                                       torch.from_numpy(delays))
        assert_states_match(tst, from_ref(jst))
        if ttl is not None:
            kw = dict(ttl=ttl, max_retries=1, retry_backoff=0.5)
            jst, _ = jagg.expire_and_retry(jst, **kw)
            tst, _ = async_agg.expire_and_retry(tst, **kw)
            assert_states_match(tst, from_ref(jst))
        for _ in range(-(-k // m)):
            t_before, v_before = float(tst.t_now), int(tst.server_version)
            jp, jst, _ = jagg.land_once(jp, jst, m, staleness_power=power, backend="xla")
            tp, tst, _ = async_agg.land_once(tp, tst, m, staleness_power=power)
            assert_states_match(tst, from_ref(jst))
            assert_close(tp.numpy(), np.asarray(jp["w"]))
            assert float(tst.t_now) >= t_before and int(tst.server_version) >= v_before
        occ = int(tst.slot_live.sum())
        assert occ < m
        assert int(tst.n_dispatched) == int(tst.n_landed) + int(tst.n_expired) + occ


# ------------------------------------------------------------ the round

JCFG = JFLConfig(n_select=K, batch_size=4, probe_size=4, lr=0.05, uplink_bits=16e6,
                 policy=JPolicyCfg(H0=2, H_max=6), kernel_backend="xla")
CFG = FLConfig(n_select=K, batch_size=4, probe_size=4, lr=0.05, uplink_bits=16e6,
               policy=PolicyCfg(H0=2, H_max=6))


def port_scenario(jsc):
    """The port's Scenario with the reference scenario's fields."""
    from repro_torch.sim.faults import FaultCfg
    kw = dataclasses.asdict(jsc)
    kw["faults"] = FaultCfg(**kw["faults"])
    return Scenario(**kw)


def assert_metrics_match(m, jm):
    """The same metric keys; integer and boolean ones bitwise, floats
    within ATOL/RTOL."""
    assert set(m) == set(jm), set(m) ^ set(jm)
    for k, w in jm.items():
        w = np.asarray(w)
        if w.dtype.kind in "biu":
            np.testing.assert_array_equal(m[k].numpy(), w, err_msg=k)
        else:
            np.testing.assert_allclose(np.asarray(m[k].numpy(), np.float64),
                                       np.asarray(w, np.float64), rtol=RTOL, atol=ATOL,
                                       err_msg=k)


def assert_fleet_match(state, jstate, params, jparams, sizes):
    """FleetState (integer leaves bitwise; last_stat per sample, as the
    round tests hold it) and the global parameters within ATOL/RTOL."""
    for name in state._fields:
        got, want = getattr(state, name).numpy(), np.asarray(getattr(jstate, name))
        if want.dtype.kind in "biu":
            np.testing.assert_array_equal(got, want, err_msg=name)
        elif name == "last_stat":
            assert_close(got / sizes, want / sizes)
        else:
            assert_close(got, want)
    for layer, leaves in jparams.items():
        for leaf, want in leaves.items():
            got = params[f"{layer}.{leaf}"].numpy()
            if want.ndim == 3:   # a 1-D conv weight, (k, c_in, c_out) there
                want = np.transpose(want, (2, 1, 0))
            assert_close(got, want)


def run_round_pair(method="rewafl", *, jsc=None, acfg=None, resilience=None, rounds=3,
                   key_seed=7, fleet_kw=HIGH, task="cnn@mnist", n_dropped=0,
                   astate0=None, later=None):
    """`rounds` rounds of the reference's round body (jitted, async when
    `acfg` is a dict of AsyncCfg fields) and the port's, from the same
    fleet, data, params, buffer and draws (`jsc`: the reference's
    scenario; None is static-paper). `astate0(jparams)` builds a starting
    reference buffer; `later`, a reference scenario the rounds after the
    first run under (the environment stays the first's). Asserts every
    round's selections, fleet state, params, metrics and buffer; returns
    the per-round port metrics."""
    from repro.core.async_agg import AsyncCfg as JAsyncCfg
    from repro.core.resilience import ResilienceCfg as JResilienceCfg
    from repro_torch.core.resilience import ResilienceCfg
    jcfg, cfg = JCFG, CFG
    if resilience is not None:
        jcfg = dataclasses.replace(jcfg, resilience=JResilienceCfg(**resilience))
        cfg = dataclasses.replace(cfg, resilience=ResilienceCfg(**resilience))
    jsc = jsc or jscenarios.SCENARIOS["static-paper"]
    sc = port_scenario(jsc)
    jmodel, model = j_make_model(task, small=True), make_fl_model(task, small=True)
    jfleet = j_build_fleet(S, seed=0, **fleet_kw)
    fleet = build_fleet(S, seed=0, device="cpu", **fleet_kw)
    jcx, jcy, _ = j_build_task(task, S, 0.8, per_client=N_PER, n_test=32)
    cx, cy, _ = build_task(task, S, 0.8, per_client=N_PER, n_test=32, device="cpu")
    jparams = jmodel.init(jax.random.PRNGKey(2))
    params = params_from_jax(jparams, device="cpu")
    jstate, state = j_init_state(jfleet, H0=2), init_fleet_state(fleet, H0=2)
    if n_dropped:
        jstate = jstate._replace(dropped=jnp.arange(S) < n_dropped)
        state = state._replace(dropped=torch.arange(S) < n_dropped)
    if sc.dynamic:
        env, jenv = _init_both(jsc.name, jax.random.PRNGKey(key_seed + 100), jfleet, fleet)
    else:
        jenv, env = j_init_env_state(jfleet), init_env_state(fleet)
    spec = METHODS[method]
    if acfg is not None:
        jacfg, tacfg = JAsyncCfg(**acfg), async_agg.AsyncCfg(**acfg)
        jast = (astate0(jparams) if astate0 is not None
                else j_init_async_state(jparams, S, jacfg.slots(K)))
        ast = async_state_from_jax(jast, model.layout, device="cpu")

    def bodies(jsc_):
        sc_ = port_scenario(jsc_)
        if acfg is None:
            return (jax.jit(j_make_round_body(jmodel, jcfg, JMETHODS[method], jsc_)),
                    make_round_body(model, cfg, spec, sc_), sc_)
        return (jax.jit(j_make_async_round_body(jmodel, jcfg, JMETHODS[method], jsc_,
                                                jacfg)),
                make_async_round_body(model, cfg, spec, sc_, tacfg), sc_)

    jbody, body, _ = first = bodies(jsc)
    rest = bodies(later) if later is not None else first
    H_max = cfg.policy.H0 if spec.policy == "fixed" else cfg.policy.H_max
    jitter = acfg is not None and acfg.get("delay_jitter", 0.0) > 0
    sizes = fleet.data_size.numpy()
    key = jax.random.PRNGKey(key_seed)
    ms = []
    for r in range(rounds):
        jbody, body, sc_r = first if r == 0 else rest
        key, kr = jax.random.split(key)
        noise = round_noise_from_key(kr, S, K, H_max, 4, N_PER, sc.dynamic,
                                     sc_r.faults.enabled, jitter)
        ri = jnp.asarray(r, jnp.int32)
        if acfg is None:
            jparams, jstate, jenv, jm = jbody(jparams, jstate, jenv, jfleet, jcx, jcy, kr, ri)
            params, state, env, m = body(params, state, env, fleet, cx, cy, noise, r)
        else:
            jparams, jstate, jast, jenv, jm = jbody(jparams, jstate, jast, jenv, jfleet,
                                                    jcx, jcy, kr, ri)
            params, state, ast, env, m = body(params, state, ast, env, fleet, cx, cy,
                                              noise, r)
            assert_states_match(ast, async_state_from_jax(jast, model.layout, "cpu"),
                                exact=False)
        np.testing.assert_array_equal(m["selected"].numpy(), np.asarray(jm["selected"]))
        assert_fleet_match(state, jstate, params, jparams, sizes)
        assert_metrics_match(m, jm)
        for g, w in zip(env, jenv):
            np.testing.assert_array_equal(g.numpy(), np.asarray(w))
        ms.append(m)
    return ms


# (buffer_m, delay, jitter, staleness_power, rounds)
ASYNC_ROUNDS = {
    "M < K": (2, "wall", 0.0, 0.5, 4),
    "M = K": (4, "wall", 0.0, 0.5, 3),
    "M > K": (6, "wall", 0.0, 0.5, 4),
    "M = K unit": (4, "unit", 0.0, 0.5, 3),
    "M < K jitter, no damping": (2, "wall", 0.3, 0.0, 3),
    "M = 1 unit jitter": (1, "unit", 0.5, 1.0, 3),
}


@pytest.mark.parametrize("case", list(ASYNC_ROUNDS))
def test_async_round_matches_reference(case):
    m, delay, jitter, power, rounds = ASYNC_ROUNDS[case]
    ms = run_round_pair(acfg=dict(buffer_m=m, delay=delay, delay_jitter=jitter,
                                  staleness_power=power), rounds=rounds)
    assert sum(int(x["n_landed"]) for x in ms) > 0
    if case == "M > K":   # the first round parks its cohort below the trigger
        assert int(ms[0]["n_landed"]) == 0 and int(ms[0]["n_pending"]) > 0


def test_async_round_under_k_on_churn_matches_reference():
    """churn-heavy with half the fleet dropped: fewer than K available,
    so at M = K the under-K cohort lands at once (the fresh-under trigger)."""
    ms = run_round_pair("random", jsc=jscenarios.SCENARIOS["churn-heavy"],
                        acfg=dict(buffer_m=K), n_dropped=5, rounds=3, key_seed=19)
    assert any(int(x["n_available"]) < K for x in ms)
    assert all(int(x["n_pending"]) == 0 for x in ms)


def test_async_round_from_a_full_buffer_matches_reference():
    """Start from a buffer with updates in flight (random small deltas of
    the model's shape, device 0 holding two slots): the first round's
    lands take old and new updates together, stale ones down-weighted."""
    def astate0(jparams):
        P_slots = 2 + K
        rng = np.random.RandomState(0)
        ast = j_init_async_state(jparams, S, P_slots)
        live = np.array([1, 0, 1, 0, 0, 0], bool)
        return ast._replace(
            server_version=jnp.int32(3), slot_live=jnp.asarray(live),
            slot_device=jnp.asarray([0, 4, 0, 5, 6, 7], jnp.int32),
            slot_arrival=jnp.asarray([1.0, 2.0, 3.0, 9.0, 9.0, 9.0], jnp.float32),
            slot_version=jnp.asarray([1, 3, 2, 3, 3, 3], jnp.int32),
            slot_weight=jnp.asarray([30.0, 1.0, 40.0, 1.0, 1.0, 1.0], jnp.float32),
            slot_delta=jax.tree.map(lambda x: jnp.asarray(
                rng.normal(0, 1e-3, (P_slots,) + x.shape), jnp.float32), jparams),
            n_dispatched=jnp.int32(2))
    ms = run_round_pair(acfg=dict(buffer_m=2), astate0=astate0, rounds=2)
    assert int(ms[0]["n_landed"]) >= 2 and float(ms[0]["mean_update_staleness"]) > 0


def test_async_mk_unit_equals_the_ports_sync_run_bitwise():
    """M = K, unit delays, no jitter, server_lr 1: eight rounds of the
    async run reproduce the port's own sync run bitwise (the first land's
    fast path returns the literal sync FedAvg)."""
    model = make_fl_model("cnn@mnist", small=True)
    fleet = build_fleet(S, seed=0, device="cpu", **FLEET)
    cx, cy, _ = build_task("cnn@mnist", S, 0.8, per_client=N_PER, n_test=32, device="cpu")
    cfg = CFG
    gen = torch.Generator().manual_seed(5)
    noise = [draw_noise(gen, S, K, cfg.policy.H_max, cfg.batch_size, N_PER)
             for _ in range(8)]
    params = model.init(torch.Generator().manual_seed(2))
    kw = dict(rounds=8, params=params, chunk_size=4, noise_fn=lambda r: noise[r],
              device="cpu")
    sync = run_rounds(model, fleet, cx, cy, cfg, METHODS["rewafl"], **kw)
    asy = run_rounds(model, fleet, cx, cy, cfg, METHODS["rewafl"],
                     async_cfg=async_agg.AsyncCfg(buffer_m=K, delay="unit"), **kw)
    for name in params:
        assert torch.equal(sync.params[name], asy.params[name]), name
    for name in sync.state._fields:
        assert torch.equal(getattr(sync.state, name), getattr(asy.state, name)), name
    for k, v in sync.history.items():
        np.testing.assert_array_equal(asy.history[k], v, err_msg=k)
    assert np.all(asy.history["n_pending"] == 0)
    assert asy.history["server_version"].tolist() == list(range(1, 9))
    assert asy.history["wall_clock"].tolist() == [float(r) for r in range(1, 9)]


# ------------------------------------------------- run_rounds and run_fl

def _run_rounds_both(acfg: dict, rounds=4, chunk=2, scenario="static-paper", seed=0):
    """Both engines' async runs on the same fleet, data, params and draws."""
    from repro.core.async_agg import AsyncCfg as JAsyncCfg
    from repro.core.round import make_eval_fn as j_make_eval_fn
    from repro.launch.fl_run import quick_cfg as j_quick_cfg
    from repro_torch.core.round import make_eval_fn
    from tests.test_torch_engine import env_from_jax
    from tests.test_torch_round import jax_noise_fn
    jmodel, model = j_make_model("cnn@mnist", small=True), make_fl_model("cnn@mnist", small=True)
    jfleet = j_build_fleet(S, seed=seed, **FLEET)
    fleet = build_fleet(S, seed=seed, device="cpu", **FLEET)
    jcx, jcy, jtest = j_build_task("cnn@mnist", S, 0.8, per_client=N_PER, n_test=64)
    cx, cy, test = build_task("cnn@mnist", S, 0.8, per_client=N_PER, n_test=64, device="cpu")
    jparams = jmodel.init(jax.random.PRNGKey(seed + 2))
    key = jax.random.PRNGKey(seed + 1)
    jsc = jscenarios.SCENARIOS[scenario]
    sc = SCENARIOS[scenario]
    want = jengine.run_rounds(
        jmodel, jfleet, jcx, jcy, j_quick_cfg(K), JMETHODS["rewafl"], rounds=rounds,
        key=key, params=jparams,
        ecfg=jengine.EngineCfg(chunk_size=chunk, async_cfg=JAsyncCfg(**acfg)),
        eval_fn=j_make_eval_fn(jmodel, jtest["x"], jtest["y"]), scenario=jsc)
    env = None
    if sc.dynamic:
        env = env_from_jax(j_init_env_state(jfleet, jsc, key=jax.random.fold_in(key, 0x0d1f)))
    cfg = quick_cfg(K)
    got = run_rounds(
        model, fleet, cx, cy, cfg, METHODS["rewafl"], rounds=rounds,
        params=params_from_jax(jparams, device="cpu"), chunk_size=chunk,
        eval_fn=make_eval_fn(model, test["x"], test["y"]),
        noise_fn=jax_noise_fn(key, S, K, cfg.policy.H_max, cfg.batch_size, N_PER,
                              sc.dynamic, sc.faults.enabled,
                              acfg.get("delay_jitter", 0.0) > 0),
        scenario=sc, env=env, async_cfg=async_agg.AsyncCfg(**acfg), device="cpu")
    return got, want, model


def assert_engine_runs_match(got, want, model):
    """History keys equal; integer histories bitwise, float ones within
    rtol 1e-4 (several rounds of SGD); the final buffer's integer leaves
    bitwise."""
    assert got.rounds_run == want.rounds_run
    assert set(got.history) == set(want.history)
    for k, v in want.history.items():
        v = np.asarray(v)
        if v.dtype.kind in "biu":
            np.testing.assert_array_equal(got.history[k], v, err_msg=k)
        else:
            np.testing.assert_allclose(np.asarray(got.history[k], np.float64),
                                       np.asarray(v, np.float64), rtol=1e-4, atol=1e-6,
                                       err_msg=k)
    ref_ast = async_state_from_jax(want.async_state, model.layout, device="cpu")
    for name in AsyncState._fields:
        g, w = getattr(got.async_state, name), getattr(ref_ast, name)
        if not g.is_floating_point():
            assert torch.equal(g, w), name
        else:
            np.testing.assert_allclose(g.numpy(), w.numpy(), rtol=1e-4, atol=1e-6,
                                       err_msg=name)
    occ = int(got.async_state.slot_live.sum())
    ast = got.async_state
    assert int(ast.n_dispatched) == int(ast.n_landed) + int(ast.n_expired) + occ


@pytest.mark.parametrize("acfg", [dict(buffer_m=2), dict(buffer_m=4, delay="unit"),
                                  dict(buffer_m=3, delay_jitter=0.3)])
def test_run_rounds_async_matches_reference(acfg):
    """4 rounds in chunks of 2; the buffer is carried across chunks."""
    got, want, model = _run_rounds_both(acfg)
    assert_engine_runs_match(got, want, model)
    assert "update_staleness" not in got.history
    assert set(ASYNC_HIST_KEYS) <= set(got.history)


def test_run_fl_async_matches_reference(monkeypatch):
    """`run_fl(aggregation="async")` with the default buffer
    (n_select // 2) and `delay_jitter`: the port's run on the reference's
    draws matches the reference's run, the async history and the final
    virtual time included."""
    got, want, cfg = run_fl_with_reference_draws(monkeypatch, rounds=4,
                                                 aggregation="async", delay_jitter=0.2)
    assert_run_fl_match(got, want)
    for k in ASYNC_HIST_KEYS:
        np.testing.assert_allclose(got.history[k], np.asarray(want.history[k], np.float64),
                                   rtol=1e-5, atol=1e-6, err_msg=k)
    assert got.wall_clock_s == pytest.approx(want.wall_clock_s, rel=1e-6)
    assert np.all(np.diff(got.history["wall_clock"]) >= 0)


def test_cli_async(capsys, monkeypatch):
    real, seen = fl_run.run_rounds, {}

    def wrapped(*a, **kw):
        seen["acfg"] = kw["async_cfg"]
        return real(*a, **kw)

    monkeypatch.setattr(fl_run, "run_rounds", wrapped)
    fl_run.main(["--device", "cpu", "--aggregation", "async", "--buffer-m", "3",
                 "--staleness-power", "1.0", "--delay-jitter", "0.1", "--async-delay",
                 "unit", "--rounds", "2", "--clients", "6", "--select", "2",
                 "--chunk-size", "2", "--quiet"])
    import json
    out = json.loads(capsys.readouterr().out)
    assert out["aggregation"] == "async" and out["wall_clock_s"] > 0
    assert seen["acfg"] == async_agg.AsyncCfg(buffer_m=3, delay="unit", delay_jitter=0.1,
                                              staleness_power=1.0)
    assert run_fl is fl_run.run_fl
