"""Parity of the port's chaos layer (`repro_torch.sim.faults`,
`repro_torch.core.resilience` and the round's fault, deadline and screen
branches) with the reference's, on the CPU.

The reference runs live (`kernel_backend="xla"`), never against goldens:
its `tests/test_resilience.py::test_fault_counters_and_finite_loss_under_
corruption` expects rejections to equal corruptions at its seed, which no
longer holds under jax 0.9, and shows the screen's documented limit (a
blown-up update passes when most of a small cohort is corrupted). The
port reproduces the live reference, that limit included
(`test_screen_majority_limit_matches_reference`).

A round's fault draws are the reference's (6, S) uniforms from
`fold_in(round key, FAULT_SALT)`, handed to the port as
`RoundNoise.fault_u`. Masks and counters bitwise, floats within the round
tests' atol 1e-5 + rtol 1e-5; delta norms within rtol 1e-5 (the
reference sums each leaf, then the leaves; the port one flat row).
"""
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import resilience as jres
from repro.models.fl_models import make_fl_model as j_make_model
from repro.sim import faults as jflt
from repro.sim.dynamics import scenarios as jscenarios
from repro_torch.core import resilience as res
from repro_torch.launch import fl_run
from repro_torch.launch.fl_run import FAULT_HIST_KEYS
from repro_torch.models.fl_models import make_fl_model, params_from_jax
from repro_torch.sim import faults as flt
from tests.test_torch_async import run_round_pair
from tests.test_torch_engine import assert_run_fl_match, run_fl_with_reference_draws
from tests.test_torch_round import assert_close

K = 4
FAULT_COUNTS = ("n_aborted", "n_lost", "n_corrupted", "n_straggler")


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """The port's CPU rounds here are many small ops: one intra-op thread
    runs them as fast as many, and keeps the parallel test workers from
    oversubscribing the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def static_faults(**kw):
    """A static-paper twin with fault injection on (the reference's
    `tests/test_resilience.py` isolates the chaos layer so)."""
    return jscenarios.Scenario(name="test-faults", static=True,
                               faults=jflt.FaultCfg(**kw))


# ------------------------------------------------------------ configs

@pytest.mark.parametrize("kw", [dict(abort_rate=1.5), dict(loss_rate=-0.1),
                                dict(corrupt_nan_frac=2.0),
                                dict(straggler_rate=0.1, straggler_mult=0.5),
                                dict(corrupt_scale=0.0)])
def test_fault_cfg_validation_matches_reference(kw):
    with pytest.raises(ValueError):
        jflt.FaultCfg(**kw)
    with pytest.raises(ValueError):
        flt.FaultCfg(**kw)


def test_fault_cfg_enabled_matches_reference():
    for kw in ({}, dict(abort_rate=0.01), dict(loss_rate=0.2), dict(corrupt_rate=0.1),
               dict(straggler_rate=0.01), dict(straggler_mult=3.0)):
        assert flt.FaultCfg(**kw).enabled == jflt.FaultCfg(**kw).enabled
    for name in ("lossy-uplink", "flaky-fleet"):
        assert jscenarios.SCENARIOS[name].faults.enabled


@pytest.mark.parametrize("kw", [dict(deadline_s=0.0), dict(deadline_s=-1.0),
                                dict(screen="sometimes"), dict(norm_mult=1.0)])
def test_resilience_cfg_validation_matches_reference(kw):
    with pytest.raises(ValueError):
        jres.ResilienceCfg(**kw)
    with pytest.raises(ValueError):
        res.ResilienceCfg(**kw)


def test_resilience_screen_on_matches_reference():
    for screen in ("auto", "on", "off"):
        for faults in (False, True):
            assert (res.ResilienceCfg(screen=screen).screen_on(faults)
                    == jres.ResilienceCfg(screen=screen).screen_on(faults))


def test_fault_draws_rows_match_reference():
    """The port's six fields of the (6, S) uniforms are the reference's
    `fault_draws(key, S)`, in its order."""
    key = jax.random.PRNGKey(11)
    want = jflt.fault_draws(key, 30)
    u = jax.random.uniform(jax.random.fold_in(key, jflt.FAULT_SALT), (6, 30))
    got = flt.fault_draws(torch.from_numpy(np.array(u)))
    assert got._fields == want._fields
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))


# ------------------------------------------------ corruption and screen

def _cohort(seed, k=6):
    """The small CNN's global params and k client models near them, as the
    reference's trees and the port's flat (P,) and (K, P)."""
    jmodel, model = j_make_model("cnn@mnist", small=True), make_fl_model("cnn@mnist", small=True)
    g = jmodel.init(jax.random.PRNGKey(seed))
    rng = np.random.RandomState(seed)
    c = jax.tree.map(lambda x: x[None] + jnp.asarray(
        rng.normal(0, 1e-2, (k,) + x.shape), jnp.float32), g)
    flat = model.layout.flatten(params_from_jax(g, device="cpu"))
    return g, c, flat, _flat_tree(c, model, k), model


def _flat_tree(tree, model, k):
    """A reference tree of (k, ...) leaves as the port's (k, P) rows."""
    return torch.stack([model.layout.flatten(params_from_jax(
        jax.tree.map(lambda x: x[i], tree), device="cpu")) for i in range(k)])


@pytest.mark.parametrize("nan_frac", [0.0, 0.5, 1.0])
def test_corrupt_cohort_matches_reference(nan_frac):
    g, c, flat, client, model = _cohort(1)
    mask = np.array([1, 0, 1, 1, 0, 1], bool)
    u = np.array([0.1, 0.9, 0.7, 0.3, 0.2, 0.6], np.float32)
    want = jflt.corrupt_cohort(c, g, jnp.asarray(mask), jnp.asarray(u), scale=1e8,
                               nan_frac=nan_frac)
    got = flt.corrupt_cohort(client, flat, torch.from_numpy(mask), torch.from_numpy(u),
                             scale=1e8, nan_frac=nan_frac)
    w = _flat_tree(want, model, 6).numpy()
    np.testing.assert_array_equal(np.isnan(got.numpy()), np.isnan(w))
    assert_close(got.numpy(), w)
    assert torch.equal(got[~torch.from_numpy(mask)], client[~torch.from_numpy(mask)])


def test_delta_norms_match_reference():
    g, c, flat, client, _ = _cohort(2)
    want = np.asarray(jres.delta_norms(g, c))
    got = res.delta_norms(flat, client).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-5)


@pytest.mark.parametrize("values,mask", [
    ([3.0, 1.0, 2.0, 9.0], [1, 1, 1, 0]),
    ([3.0, 1.0, 2.0, 9.0], [1, 1, 1, 1]),
    ([5.0, np.inf, 2.0, 0.5, 7.0], [1, 0, 1, 1, 1]),
    ([4.0, 2.0], [0, 0]),
    ([4.0], [1]),
])
def test_masked_median_matches_reference(values, mask):
    v, m = np.asarray(values, np.float32), np.asarray(mask, bool)
    want = np.asarray(jres.masked_median(jnp.asarray(v), jnp.asarray(m)))
    got = res.masked_median(torch.from_numpy(v), torch.from_numpy(m))
    assert got.dtype == torch.float32 and got.shape == ()
    np.testing.assert_array_equal(got.numpy(), want)


# (corruption of each slot: None, "nan" or a scale; weight 0 marks a
# slot that is no candidate)
SCREEN_CASES = {
    "clean": ([None] * 6, [1, 2, 3, 4, 5, 6]),
    "nan and blow-up": (["nan", None, 1e8, None, None, None], [1, 2, 3, 4, 5, 6]),
    "zero-weight corrupted": (["nan", None, 1e8, None, None, None], [0, 2, 0, 4, 5, 6]),
    "norm outlier x20": ([None, 20.0, None, None, None, None], [1, 1, 1, 1, 1, 1]),
    "nothing left": (["nan", "nan", None, None, None, None], [1, 1, 0, 0, 0, 0]),
}


def _factors(kinds):
    """Each slot's delta factor: 1 (clean), NaN, or the scale."""
    return np.asarray([1.0 if k is None else (np.nan if k == "nan" else k)
                       for k in kinds], np.float32)


@pytest.mark.parametrize("case", list(SCREEN_CASES))
def test_screen_updates_matches_reference(case):
    """Reject masks bitwise, weights bitwise, the clean cohort (rejected
    rows replaced by θ) within the tolerance."""
    kinds, weights = SCREEN_CASES[case]
    g, c, flat, client, model = _cohort(3)
    f = _factors(kinds)
    c = jax.tree.map(lambda x, gg: gg[None] + (x - gg[None])
                     * jnp.asarray(f).reshape((-1,) + (1,) * gg.ndim), c, g)
    client = flat + (client - flat) * torch.from_numpy(f)[:, None]
    w = np.asarray(weights, np.float32)
    jclean, jw, jrej = jres.screen_updates(g, c, jnp.asarray(w), norm_mult=10.0)
    clean, tw, rej = res.screen_updates(flat, client, torch.from_numpy(w), norm_mult=10.0)
    np.testing.assert_array_equal(rej.numpy(), np.asarray(jrej))
    np.testing.assert_array_equal(tw.numpy(), np.asarray(jw))
    assert_close(clean.numpy(), _flat_tree(jclean, model, 6).numpy())
    assert torch.isfinite(clean[tw > 0]).all()
    if case == "clean":
        assert not rej.any()


def test_screen_majority_limit_matches_reference():
    """Three of four candidates blown up by 1e8 (finite): the median is a
    blown-up norm, so no blow-up is an outlier and all pass — in the
    reference and in the port (`core/resilience.py`'s known limit)."""
    g, c, flat, client, model = _cohort(4, k=4)
    f = np.array([1e8, 1e8, 1.0, 1e8], np.float32)
    c = jax.tree.map(lambda x, gg: gg[None] + (x - gg[None])
                     * jnp.asarray(f).reshape((-1,) + (1,) * gg.ndim), c, g)
    client = flat + (client - flat) * torch.from_numpy(f)[:, None]
    w = np.ones(4, np.float32)
    _, _, jrej = jres.screen_updates(g, c, jnp.asarray(w), norm_mult=10.0)
    _, _, rej = res.screen_updates(flat, client, torch.from_numpy(w), norm_mult=10.0)
    np.testing.assert_array_equal(rej.numpy(), np.asarray(jrej))
    assert not rej[0] and torch.isfinite(res.delta_norms(flat, client)).all()


# ------------------------------------------------------------ the round

def _totals(ms, keys):
    return {k: sum(int(m[k]) for m in ms) for k in keys}


# A ×1e8 blow-up that passes the screen (most of a cohort of 4 corrupted:
# the screen's known limit) multiplies the last-bit difference of θ_k − θ
# between the frameworks by 1e8, past any float tolerance on the landed
# parameters. The static-twin rounds below therefore corrupt with NaN
# (always rejected, or poisoning both with the screen off); the blow-up
# path is held by the screen's unit tests above and the flaky-fleet
# rounds, whose blow-ups the screen rejects.
NAN_ONLY = dict(corrupt_nan_frac=1.0)


@pytest.mark.parametrize("method", ["rewafl", "random"])
def test_static_faults_round_matches_reference(method):
    """Aborts (their partial energy), corruption and the screen, and
    stragglers (the inflated latency) on the static fleet; the upload
    loss is inert there (the channel is always good)."""
    jsc = static_faults(abort_rate=0.3, corrupt_rate=0.5, straggler_rate=0.4, **NAN_ONLY)
    ms = run_round_pair(method, jsc=jsc, rounds=3, key_seed=5)
    tot = _totals(ms, FAULT_COUNTS + ("n_rejected",))
    assert tot["n_lost"] == 0
    assert tot["n_aborted"] > 0 and tot["n_corrupted"] > 0 and tot["n_straggler"] > 0


@pytest.mark.parametrize("scenario,method,key_seed", [
    ("lossy-uplink", "rewafl", 3), ("lossy-uplink", "random", 5),
    ("flaky-fleet", "rewafl", 7), ("flaky-fleet", "random", 9)])
def test_fault_scenario_round_matches_reference(scenario, method, key_seed):
    ms = run_round_pair(method, jsc=jscenarios.SCENARIOS[scenario], rounds=3,
                        key_seed=key_seed)
    assert set(FAULT_COUNTS + ("n_rejected",)) <= set(ms[0])


def test_flaky_fleet_async_round_matches_reference():
    """Under chaos only the delivered, screened updates are pushed, and
    the wall delays are the straggler-inflated round times."""
    ms = run_round_pair("rewafl", jsc=jscenarios.SCENARIOS["flaky-fleet"],
                        acfg=dict(buffer_m=2), rounds=3, key_seed=9)
    assert sum(int(m["n_landed"]) for m in ms) > 0


@pytest.mark.parametrize("acfg", [None, dict(buffer_m=2)])
def test_deadline_round_matches_reference(acfg):
    """A deadline between the fleet's round times cuts the slow
    participants (energy spent, no update) and caps the latency."""
    ms = run_round_pair("rewafl", resilience=dict(deadline_s=20.0), acfg=acfg, rounds=3)
    assert sum(int(m["n_deadline_cut"]) for m in ms) > 0
    assert all(float(m["round_latency"]) <= 20.0 for m in ms)


@pytest.mark.parametrize("screen,jsc", [
    ("on", None), ("off", static_faults(corrupt_rate=0.5, **NAN_ONLY)),
    ("auto", static_faults(corrupt_rate=0.5, **NAN_ONLY)), ("auto", None)])
def test_screen_modes_round_matches_reference(screen, jsc):
    """Forced on over a fault-free round (inert: nothing rejected), off
    under corruption (the NaN reaches the aggregate in both, and the next
    round ranks the devices whose utility it made NaN first, as the
    reference's `lax.top_k` does), and auto."""
    ms = run_round_pair("rewafl", jsc=jsc, resilience=dict(screen=screen), rounds=3,
                        key_seed=11)
    on = res.ResilienceCfg(screen=screen).screen_on(jsc is not None)
    assert ("n_rejected" in ms[0]) == on
    if screen == "on":
        assert _totals(ms, ["n_rejected"])["n_rejected"] == 0
    if screen == "off":   # a NaN update was delivered: θ is NaN in both
        assert int(ms[0]["n_corrupted"]) > 0


def test_async_ttl_round_matches_reference():
    """The slot TTL with stragglers 50 × slower: overdue slots retry once,
    then expire (`tests/test_resilience.py:330`'s configuration)."""
    ms = run_round_pair("rewafl", jsc=static_faults(straggler_rate=0.5, straggler_mult=50.0),
                        acfg=dict(buffer_m=2, ttl=200.0, max_retries=1), rounds=4)
    tot = _totals(ms, ["n_retried", "n_expired"])
    assert tot["n_retried"] + tot["n_expired"] > 0


def test_async_stuck_residue_lands_as_in_reference():
    """Round 0 parks a residue below a trigger no cohort reaches (M = 2K);
    round 1 aborts every participant, so nothing is pushed, and the
    relaxed trigger lands the residue (`tests/test_resilience.py:348`)."""
    ms = run_round_pair("rewafl", jsc=jscenarios.Scenario(name="nofault", static=True),
                        later=static_faults(abort_rate=1.0), acfg=dict(buffer_m=2 * K),
                        rounds=2)
    residue = int(ms[0]["n_pending"])
    assert 0 < residue < 2 * K and int(ms[0]["n_landed"]) == 0
    assert int(ms[1]["n_landed"]) == residue and int(ms[1]["n_pending"]) == 0


# ------------------------------------------------- run_fl and the CLI

@pytest.mark.parametrize("scenario,kw", [("lossy-uplink", {}), ("flaky-fleet", {}),
                                         ("flaky-fleet", dict(aggregation="async"))])
def test_run_fl_fault_scenario_matches_reference(monkeypatch, scenario, kw):
    """`run_fl` on each fault scenario (and flaky-fleet async) with the
    reference's draws, over 4 rounds: the fault counters' history bitwise.
    As the 8-round dynamic runs (`tests/test_torch_dynamics.py`), these
    hold what no trained model reaches: under the `random` selector the
    masks, counts, costs and energies (rewafl's 16 local steps at seed 0
    part the two frameworks' SGD by round 3, 3.4e-4 apart in global
    loss, with every fault counter still equal; the round tests hold the
    trained leaves)."""
    got, want, _ = run_fl_with_reference_draws(monkeypatch, method="random", rounds=4,
                                               scenario=scenario, **kw)
    assert_run_fl_match(got, want, training=False)
    keys = [k for k in FAULT_HIST_KEYS if k in want.history]
    assert keys == [k for k in FAULT_HIST_KEYS if k in got.history]
    assert set(keys) == set(FAULT_COUNTS + ("n_rejected",))
    for k in keys:
        np.testing.assert_array_equal(got.history[k], np.asarray(want.history[k], np.float64),
                                      err_msg=k)
    s = fl_run.summary(got, scenario=scenario, telemetry="dense",
                       aggregation=kw.get("aggregation", "sync"), wall_s=0.0)
    assert s["fault_totals"] == {k: float(np.sum(want.history[k])) for k in keys}


def test_cli_fault_scenario(capsys):
    fl_run.main(["--device", "cpu", "--scenario", "flaky-fleet", "--rounds", "2",
                 "--clients", "6", "--select", "2", "--chunk-size", "2", "--quiet"])
    out = json.loads(capsys.readouterr().out)
    assert out["scenario"] == "flaky-fleet"
    assert set(out["fault_totals"]) == set(FAULT_COUNTS + ("n_rejected",))
