"""Parity of the port's observability layer (`repro_torch.obs`) with the
reference's (`repro.obs`), on the CPU.

- health: `gini`, `chunk_sample`, `finalize_report` (the dense fallback,
  streaming quantiles, the Gini and staleness alarms, fault totals),
  `format_health_table`, `HealthCfg.quantile_specs` and
  `with_health_specs`, fed the same values — torch tensors to the port,
  numpy arrays to the reference, drawn from a numpy seed. Samples,
  metrics, warning strings and tables must be equal (the monitors are
  float64 numpy on the host in both packages, so equal means bitwise).
- trace: span nesting, arguments, the Chrome JSON round trip, the
  per-name summary and its table (the reference's format on the same
  summary), the tracing context, the shared no-op span and its cost, and
  `Tracer(profiler=True)`'s spans in a torch.profiler capture.
- log: severity routing under the `repro_torch` logger.
"""
import dataclasses
import io
import json
import logging
import sys
import threading
import time

import numpy as np
import pytest
import torch

from repro.core.metrics import MetricSpec as JMetricSpec
from repro.core.metrics import TelemetryCfg as JTelemetryCfg
from repro.obs import health as jhealth
from repro.obs import trace as jtrace
from repro_torch.core.metrics import TelemetryCfg
from repro_torch.obs import health, log, trace
from repro_torch.obs.health import HealthCfg, HealthReport
from repro_torch.obs.trace import (NullTracer, Tracer, format_span_table, get_tracer,
                                   set_tracer, span, tracing)

SPEC_FIELDS = ("metric", "reducer", "every", "cap", "bins", "lo", "hi")


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


class _Obj:
    def __init__(self, **kw):
        self.__dict__.update(kw)


def _pair(**arrays):
    """The same leaves as tensors (the port's state) and as numpy arrays
    (the reference's)."""
    return (_Obj(**{k: torch.from_numpy(np.asarray(v)) for k, v in arrays.items()}),
            _Obj(**{k: np.asarray(v) for k, v in arrays.items()}))


def _jcfg(cfg: HealthCfg):
    return jhealth.HealthCfg(**dataclasses.asdict(cfg))


# ------------------------------------------------------------- health

@pytest.mark.parametrize("counts", [[], [0, 0, 0], [5, 5, 5, 5], [0] * 9 + [90],
                                    [3, 4, 5, 4], "random"])
def test_gini_matches_reference(counts):
    if counts == "random":
        counts = np.random.default_rng(0).integers(0, 40, 100).astype(np.int32)
    want = jhealth.gini(np.asarray(counts))
    assert health.gini(torch.as_tensor(np.asarray(counts))) == want
    assert health.gini(counts) == want


# (reserve, energy) fleets: the unit test's, and a random one with every
# band occupied
def _fleet(kind):
    if kind == "unit":
        return np.full(5, 10.0, np.float32), np.array([5, 10, 12, 20, 14], np.float32), \
            np.array([True, True, False, False, False])
    rng = np.random.default_rng(1)
    reserve = rng.uniform(500, 900, 60).astype(np.float32)
    energy = (reserve * rng.uniform(0.5, 2.5, 60)).astype(np.float32)
    return reserve, energy, rng.random(60) < 0.2


@pytest.mark.parametrize("kind", ["unit", "random"])
@pytest.mark.parametrize("cfg", [HealthCfg(max_flat_frac=0.5, max_near_frac=0.5),
                                 HealthCfg(max_flat_frac=0.1, max_near_frac=0.1),
                                 HealthCfg(max_flat_frac=None, max_near_frac=None),
                                 HealthCfg(near_margin=0.25)],
                         ids=["loose", "tight", "off", "margin"])
def test_chunk_sample_matches_reference(kind, cfg):
    reserve, energy, dropped = _fleet(kind)
    state, jstate = _pair(residual_energy=energy, dropped=dropped)
    fleet, jfleet = _pair(e0_reserve=reserve)
    got = health.chunk_sample(cfg, state, fleet, round_idx=7)
    want = jhealth.chunk_sample(_jcfg(cfg), jstate, jfleet, round_idx=7)
    assert got == want


def _report_inputs(n=50):
    rng = np.random.default_rng(2)
    state, jstate = _pair(residual_energy=np.linspace(1.0, 100.0, n).astype(np.float32),
                          u=rng.integers(0, 12, n).astype(np.int32),
                          n_selected=rng.integers(0, 6, n).astype(np.int32))
    fleet, jfleet = _pair(e0_reserve=np.full(n, 1.0, np.float32))
    samples = [{"round": 9, "flat_battery": 0, "flat_frac": 0.0,
                "near_depletion": 1, "near_frac": 0.02, "n_dropped": 0}]
    tel = {"tel/staleness/p50": np.float32(4.0), "tel/staleness/p95": np.float32(9.5),
           "tel/residual_energy/p50": np.float32(42.0),
           "tel/residual_energy/p95": np.float32(97.0)}
    hist = {"n_lost": np.array([1, 0, 2], np.int64), "n_rejected": np.array([0.0, 3.0, 1.0]),
            "global_loss": np.array([1.0, 0.9, 0.8])}
    return state, jstate, fleet, jfleet, samples, tel, hist


REPORT_CASES = {
    "streaming": dict(telemetry=True),
    "dense-fallback": dict(),
    "staleness-alarm": dict(telemetry=True, cfg=HealthCfg(max_staleness_p95=5.0)),
    "carried-warning": dict(telemetry=True, warnings=["health[r=3]: boom"]),
    "fault-totals": dict(history=True),
    "gini-alarm": dict(cfg=HealthCfg(max_gini=0.2)),
    "no-rounds": dict(rounds_run=0, samples=False),
}


@pytest.mark.parametrize("case", list(REPORT_CASES))
def test_finalize_report_matches_reference(case):
    c = REPORT_CASES[case]
    state, jstate, fleet, jfleet, samples, tel, hist = _report_inputs()
    cfg = c.get("cfg", HealthCfg())
    kw = dict(telemetry=tel if c.get("telemetry") else None,
              rounds_run=c.get("rounds_run", 10),
              history=hist if c.get("history") else None)
    samples = samples if c.get("samples", True) else []
    warns = c.get("warnings", [])
    got = health.finalize_report(cfg, list(samples), list(warns), state=state, fleet=fleet,
                                 **kw)
    want = jhealth.finalize_report(_jcfg(cfg), list(samples), list(warns), state=jstate,
                                   fleet=jfleet, **kw)
    assert got.to_json() == want.to_json()
    assert health.format_health_table(got) == jhealth.format_health_table(want)
    if case == "gini-alarm":
        assert not got.ok and "Gini" in got.warnings[0]
    if case == "fault-totals":
        assert got.metrics["n_lost_total"] == 3.0 and "global_loss_total" not in got.metrics


def test_health_table_of_an_alarm_matches_reference():
    rep = HealthReport(ok=False, warnings=["health[final]: x"],
                       metrics={"sel_gini": 0.91, "flat_battery": 3, "flat_frac": 0.3,
                                "staleness_p95": 7.0},
                       samples=[])
    jrep = jhealth.HealthReport(**dataclasses.asdict(rep))
    assert health.format_health_table(rep) == jhealth.format_health_table(jrep)
    assert health.format_health_table(rep).startswith("fleet health: ALARM")


def _fields(specs):
    return [tuple(getattr(s, f) for f in SPEC_FIELDS) for s in specs]


def test_quantile_specs_and_with_health_specs_match_reference():
    cfg = HealthCfg(quantile_bins=32)
    specs = cfg.quantile_specs(rounds=20, energy_hi=1e5)
    assert _fields(specs) == _fields(_jcfg(cfg).quantile_specs(rounds=20, energy_hi=1e5))
    init = np.array([1.2e4, 6.9e4, 3.1e4], np.float32)
    fleet, jfleet = _pair(init_energy=init)
    got = health.with_health_specs(TelemetryCfg(mode="streaming", specs=specs[:1]), cfg, 20,
                                   fleet)
    want = jhealth.with_health_specs(
        JTelemetryCfg(mode="streaming", specs=(JMetricSpec(*_fields(specs[:1])[0]),)),
        _jcfg(cfg), 20, jfleet)
    assert _fields(got.specs) == _fields(want.specs) and len(got.specs) == 4
    assert health.with_health_specs(got, cfg, 20, fleet) is got
    assert health.FAULT_COUNTERS == jhealth.FAULT_COUNTERS


# ------------------------------------------------------------- tracer

def test_span_nesting_containment():
    t = Tracer()
    with t.span("outer", 0):
        with t.span("inner", 0):
            time.sleep(0.002)
    evs = {e["name"]: e for e in t.events}
    assert set(evs) == {"outer", "inner"}
    o, i = evs["outer"], evs["inner"]
    assert o["ph"] == i["ph"] == "X"
    assert o["tid"] == i["tid"] == threading.get_ident()
    assert o["ts"] <= i["ts"] and i["ts"] + i["dur"] <= o["ts"] + o["dur"] + 1e-6
    assert i["dur"] >= 2000.0   # slept 2 ms, recorded in µs


def test_span_args_and_index_serialized():
    t = Tracer()
    with t.span("chunk", 3, rounds=5, start=15):
        pass
    (ev,) = t.events
    assert ev["args"] == {"index": 3, "rounds": 5, "start": 15}


def test_chrome_json_round_trip(tmp_path):
    t = Tracer()
    with t.span("a", 0):
        with t.span("b"):
            pass
    t.instant("marker", note="hi")
    path = tmp_path / "out.trace.json"
    t.write(str(path))
    d = json.loads(path.read_text())
    assert d == t.to_chrome() and d["displayTimeUnit"] == "ms"
    evs = d["traceEvents"]
    assert {e["name"] for e in evs} == {"a", "b", "marker"}
    assert all("ts" in e and "pid" in e and "tid" in e for e in evs)
    assert [e["ph"] for e in evs if e["name"] == "marker"] == ["i"]
    assert set(d) == set(jtrace.Tracer().to_chrome())


def test_summary_and_table_match_reference():
    t = Tracer()
    for _ in range(3):
        with t.span("work"):
            time.sleep(0.001)
    with t.span("other"):
        pass
    s = t.summary()
    assert s["work"]["count"] == 3 and s["work"]["total_s"] >= 0.003
    assert s["work"]["mean_s"] == pytest.approx(s["work"]["total_s"] / 3)
    # the reference's summary of the same events, and its table
    jt = jtrace.Tracer()
    jt._events = t.events
    assert jt.summary() == s
    assert format_span_table(s) == jtrace.format_span_table(s)
    assert format_span_table({}) == jtrace.format_span_table({}) == "(no spans recorded)"


def test_tracing_context_installs_and_restores():
    prev = get_tracer()
    t = Tracer()
    with tracing(t) as active:
        assert active is t and get_tracer() is t
        with span("via_module", 1):
            pass
    assert get_tracer() is prev
    assert [e["name"] for e in t.events] == ["via_module"]


def test_null_tracer_is_shared_singleton():
    nt = NullTracer()
    assert nt.span("a") is nt.span("b") is trace._NULL_SPAN
    assert not nt.enabled and Tracer().enabled
    assert nt.events == [] and nt.summary() == {}
    nt.instant("x")


def test_noop_span_overhead_is_negligible():
    """The module-level span() the engine calls with tracing off: budget
    5 µs a call, as the reference's test."""
    prev = set_tracer(NullTracer())
    try:
        n = 100_000
        t0 = time.perf_counter()
        for _ in range(n):
            with span("chunk", 0):
                pass
        per_call = (time.perf_counter() - t0) / n
    finally:
        set_tracer(prev)
    assert per_call < 5e-6


def test_profiler_tracer_marks_spans_in_a_torch_profile():
    """`Tracer(profiler=True)` enters a record_function per span: a
    torch.profiler capture around the run shows the phases by name."""
    from torch.profiler import ProfilerActivity, profile
    t = Tracer(profiler=True)
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        with t.span("dispatch", 0):
            torch.ones(4).sum()
    assert "dispatch" in {e.key for e in prof.key_averages()}
    assert [e["name"] for e in t.events] == ["dispatch"]


# ------------------------------------------------------------- logging

def test_logger_severity_routing():
    buf = io.StringIO()
    log.configure_logging(stream=buf)
    lg = log.get_logger("obs_test")
    assert lg.name == "repro_torch.obs_test"
    assert log.get_logger("repro_torch.launch.fl_run").name == "repro_torch.launch.fl_run"
    lg.info("plain chatter")
    lg.warning("alarm fired")
    lg.debug("hidden detail")
    out = buf.getvalue()
    assert "plain chatter\n" in out and "WARNING: alarm fired" in out
    assert "hidden detail" not in out
    quiet = io.StringIO()
    log.configure_logging(quiet=True, stream=quiet)
    lg.info("suppressed")
    lg.warning("still visible")
    assert "suppressed" not in quiet.getvalue()
    assert "WARNING: still visible" in quiet.getvalue()
    verbose = io.StringIO()
    log.configure_logging(verbosity=1, stream=verbose)
    lg.debug("now shown")
    assert "now shown" in verbose.getvalue()
    assert len(logging.getLogger("repro_torch").handlers) == 1
    log.configure_logging()


def test_default_handler_follows_sys_stderr(monkeypatch):
    """Without a stream the handler writes to the `sys.stderr` of the
    moment a record is emitted, not of the moment it was configured."""
    log.configure_logging()
    first, second = io.StringIO(), io.StringIO()
    monkeypatch.setattr(sys, "stderr", first)
    log.get_logger("obs_test").warning("one")
    monkeypatch.setattr(sys, "stderr", second)
    log.get_logger("obs_test").warning("two")
    assert first.getvalue() == "WARNING: one\n" and second.getvalue() == "WARNING: two\n"
