"""The slice end to end: `run_fl` with streaming telemetry, the
fleet-health monitors and the trace, the port's against the reference's.

Both packages' `run_fl` at S = 10, K = 4, 8 rounds in chunks of 4, the
port fed the reference's draws and initial params
(`tests.test_torch_engine.run_fl_with_reference_draws`):

- streaming, sync and async: `RunResult.telemetry` against the
  reference's, integer outputs (selection counts, maxima and last values
  of integer metrics) bitwise, float outputs within the dense tests'
  rtol 1e-4 / atol 1e-6, the p50/p95 quantiles within one bin width (a
  sample within the two frameworks' last-bit difference of a bin edge
  may fall on the other side); the history has the reference's keys
  and no per-device trace;
- health on the reference's drain-heavy scenario (the flat-battery
  alarm trips) and on overnight-charging (it stays silent): the chunk
  samples, warnings and verdict equal, the report's metrics within the
  same tolerances;
- a traced run is bitwise the untraced one, and its trace holds the
  engine's phase spans; a streaming run's per-round scalars are bitwise
  the dense run's.
"""
import dataclasses
import json

import numpy as np
import pytest
import torch

from repro_torch.core import metrics as M
from repro_torch.core.round import make_eval_fn
from repro_torch.core.methods import METHODS
from repro_torch.launch.engine import run_rounds
from repro_torch.launch.fl_run import build_task, quick_cfg, run_fl
from repro_torch.models.fl_models import make_fl_model
from repro_torch.obs.health import HealthCfg
from repro_torch.sim.devices import build_fleet
from repro_torch.sim.dynamics import get_scenario
from tests.test_torch_engine import (FLEET, K, S, drain_heavy,  # noqa: F401
                                     run_fl_with_reference_draws)

RTOL, ATOL = 1e-4, 1e-6


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _bin_width(key, specs):
    for s in specs:
        if s.out_key == key:
            return (s.hi - s.lo) / s.bins
    raise KeyError(key)


def assert_telemetry_match(got, want, specs):
    assert set(got) == set(want)
    for k, w in want.items():
        g, w = np.asarray(got[k]), np.asarray(w)
        assert g.shape == w.shape, k
        if k.endswith(("/p50", "/p95")):
            np.testing.assert_allclose(g, w, rtol=0, atol=_bin_width(k, specs) + 1e-6,
                                       err_msg=k)
        elif w.dtype.kind in "biu":
            np.testing.assert_array_equal(g, w, err_msg=k)
        else:
            np.testing.assert_allclose(g.astype(np.float64), w.astype(np.float64),
                                       rtol=RTOL, atol=ATOL, err_msg=k)


def assert_streaming_history_match(got, want):
    assert set(got.history) == set(want.history)
    assert "H_trace" not in got.history and "n_selected" not in got.history
    for k, w in want.history.items():
        w = np.asarray(w)
        if k == "sel_count" or k.startswith("n_"):
            np.testing.assert_array_equal(got.history[k], w.astype(got.history[k].dtype),
                                          err_msg=k)
        else:
            np.testing.assert_allclose(got.history[k], np.asarray(w, np.float64),
                                       rtol=RTOL, atol=ATOL, err_msg=k)


@pytest.mark.parametrize("kw", [dict(), dict(health=HealthCfg(max_near_frac=None))],
                         ids=["default-specs", "with-health-quantiles"])
def test_streaming_run_fl_matches_reference(monkeypatch, kw):
    """Static rewafl, streaming: DEFAULT_SPECS, and with the health
    monitors' quantile reducers added before the carry is built."""
    got, want, _ = run_fl_with_reference_draws(monkeypatch, telemetry="streaming", **kw)
    assert got.rounds_run == want.rounds_run == 8
    specs = M.DEFAULT_SPECS
    if "health" in kw:
        specs = specs + kw["health"].quantile_specs(8, float(want.history["init_energy"].max()))
    assert sorted(got.telemetry) == sorted(s.out_key for s in specs)
    assert_telemetry_match(got.telemetry, want.telemetry, specs)
    assert_streaming_history_match(got, want)
    np.testing.assert_array_equal(got.telemetry["tel/H/last"], got.final_state.H.numpy())
    if "health" in kw:
        assert got.health.samples == want.health.samples
        assert got.health.warnings == want.health.warnings and got.health.ok == want.health.ok
        for k in ("staleness_p50", "staleness_p95", "residual_energy_p50",
                  "residual_energy_p95"):
            assert got.health.metrics[k] == float(got.telemetry[f"tel/{k[:-4]}/{k[-3:]}"])


def test_streaming_async_run_fl_matches_reference(monkeypatch):
    """Async (M = K / 2, wall delays), streaming: ASYNC_SPECS, the last
    virtual clock equal to the history's."""
    got, want, _ = run_fl_with_reference_draws(monkeypatch, telemetry="streaming",
                                               aggregation="async")
    assert sorted(got.telemetry) == sorted(s.out_key for s in M.ASYNC_SPECS)
    assert_telemetry_match(got.telemetry, want.telemetry, M.ASYNC_SPECS)
    assert_streaming_history_match(got, want)
    assert float(got.telemetry["tel/wall_clock/last"]) == got.history["wall_clock"][-1]


def _assert_reports_match(got, want):
    assert got.samples == want.samples
    assert got.warnings == want.warnings and got.ok == want.ok
    assert set(got.metrics) == set(want.metrics)
    for k, w in want.metrics.items():
        np.testing.assert_allclose(got.metrics[k], w, rtol=RTOL, atol=ATOL, err_msg=k)


def test_health_alarm_trips_on_drain_heavy_like_reference(monkeypatch, drain_heavy):
    got, want, _ = run_fl_with_reference_draws(monkeypatch, "cnn@mnist", "random",
                                               scenario=drain_heavy, health=HealthCfg())
    _assert_reports_match(got.health, want.health)
    assert not got.health.ok
    assert any("flat-battery alarm" in w for w in got.health.warnings)
    assert [s["round"] for s in got.health.samples] == [3, 7]


def test_health_silent_on_overnight_charging_like_reference(monkeypatch):
    cfg = HealthCfg(max_near_frac=None, max_gini=None)
    got, want, _ = run_fl_with_reference_draws(monkeypatch, "cnn@mnist", "random",
                                               scenario="overnight-charging", health=cfg)
    _assert_reports_match(got.health, want.health)
    assert got.health.ok and got.health.metrics["flat_battery"] == 0


def test_health_streaming_fault_totals_like_reference(monkeypatch):
    """flaky-fleet, streaming with health: the report totals the chaos
    counters of the scalar history, as the reference's."""
    got, want, _ = run_fl_with_reference_draws(
        monkeypatch, "cnn@mnist", "random", scenario="flaky-fleet", rounds=4,
        telemetry="streaming", health=HealthCfg(max_near_frac=None))
    _assert_reports_match(got.health, want.health)
    assert got.health.metrics["n_aborted_total"] == float(got.history["n_aborted"].sum())


def _small_run(**kw):
    return run_fl(rounds=4, n_clients=S, n_select=K, eval_every=2, fleet_kwargs=FLEET,
                  device="cpu", **kw)


def _assert_runs_bitwise(a, b):
    assert set(a.history) == set(b.history)
    for k, v in a.history.items():
        np.testing.assert_array_equal(v, b.history[k], err_msg=k)
    for k, v in a.final_params.items():
        assert torch.equal(v, b.final_params[k]), k
    for x, y in zip(a.final_state, b.final_state):
        assert torch.equal(x, y)
    np.testing.assert_array_equal(a.acc_curve, b.acc_curve)


@pytest.mark.parametrize("kw", [dict(), dict(telemetry="streaming",
                                             health=HealthCfg(max_near_frac=None))],
                         ids=["dense", "streaming-health"])
def test_traced_run_is_bitwise_the_untraced_run(tmp_path, kw):
    path = tmp_path / "run.trace.json"
    plain = _small_run(**kw)
    traced = _small_run(trace=str(path), **kw)
    _assert_runs_bitwise(plain, traced)
    if plain.telemetry is not None:
        for k, v in plain.telemetry.items():
            np.testing.assert_array_equal(v, traced.telemetry[k], err_msg=k)
        assert plain.health.to_json() == traced.health.to_json()
    assert plain.spans is None
    events = json.loads(path.read_text())["traceEvents"]
    count = {}
    for e in events:
        count[e["name"]] = count.get(e["name"], 0) + 1
    want = {"run_fl": 1, "chunk": 2, "dispatch": 2, "history_drain": 2, "eval": 2,
            "transfer": 1} | ({"health": 2} if "health" in kw else {})
    assert count == want
    assert {k: v["count"] for k, v in traced.spans.items()} == want
    chunks = sorted((e for e in events if e["name"] == "chunk"), key=lambda e: e["ts"])
    assert [e["args"] for e in chunks] == [{"index": 0, "rounds": 2, "start": 0},
                                           {"index": 1, "rounds": 2, "start": 2}]


@pytest.mark.parametrize("aggregation", ["sync", "async"])
def test_streaming_scalars_are_bitwise_the_dense_runs(aggregation):
    """Streaming changes what is kept, not what is computed: the
    per-round scalars, the final state and `sel_count` are the dense
    run's, bitwise; `tel/H/last` is the final H and the ring of every
    round is the dense `selected` trace."""
    dense = _small_run(aggregation=aggregation)
    stream = _small_run(aggregation=aggregation, telemetry="streaming")
    for k, v in stream.history.items():
        np.testing.assert_array_equal(v, dense.history[k], err_msg=k)
    for x, y in zip(dense.final_state, stream.final_state):
        assert torch.equal(x, y)
    np.testing.assert_array_equal(stream.telemetry["tel/H/last"], dense.history["H_trace"][-1])

    model = make_fl_model("cnn@mnist", small=True)
    fleet = build_fleet(S, seed=0, device="cpu", **FLEET)
    cx, cy, test = build_task("cnn@mnist", S, 0.8, per_client=16, n_test=32, device="cpu")
    tcfg = M.TelemetryCfg(mode="streaming", specs=(M.MetricSpec("selected", "ring", cap=4),))
    kw = dict(rounds=4, seed=3, chunk_size=2, eval_fn=make_eval_fn(model, test["x"], test["y"]),
              scenario=get_scenario("static-paper"), device="cpu")
    a = run_rounds(model, fleet, cx, cy, quick_cfg(K), METHODS["rewafl"], **kw)
    b = run_rounds(model, fleet, cx, cy, quick_cfg(K), METHODS["rewafl"], telemetry=tcfg, **kw)
    np.testing.assert_array_equal(b.telemetry["tel/selected/ring"], a.history["selected"])
    assert "selected" not in b.history and "H" not in b.history


def test_streaming_run_rounds_with_fault_specs():
    """FAULT_SPECS appended through `run_rounds` on flaky-fleet: the sums
    are the totals of the history's counters."""
    model = make_fl_model("cnn@mnist", small=True)
    fleet = build_fleet(S, seed=0, device="cpu", **FLEET)
    cx, cy, _ = build_task("cnn@mnist", S, 0.8, per_client=16, n_test=32, device="cpu")
    sc = get_scenario("flaky-fleet")
    from repro_torch.sim.dynamics import init_env_state
    tcfg = M.TelemetryCfg(mode="streaming", specs=M.DEFAULT_SPECS + M.FAULT_SPECS)
    res = run_rounds(model, fleet, cx, cy, quick_cfg(K), METHODS["random"], rounds=4, seed=1,
                     chunk_size=2, scenario=sc,
                     env=init_env_state(fleet, sc, torch.rand(4, S, generator=torch.Generator()
                                                              .manual_seed(3))),
                     telemetry=tcfg, device="cpu")
    for s in M.FAULT_SPECS:
        assert float(res.telemetry[s.out_key]) == float(res.history[s.metric].sum()), s.metric
    # a spec of a metric the round does not emit raises, naming it
    bad = dataclasses.replace(tcfg, specs=(M.MetricSpec("n_nope", "sum"),))
    with pytest.raises(KeyError, match="n_nope"):
        run_rounds(model, fleet, cx, cy, quick_cfg(K), METHODS["random"], rounds=1, seed=1,
                   telemetry=bad, device="cpu")
