"""Host-side span tracer writing Chrome trace-event JSON.

The port of `repro.obs.trace`. `launch.engine.run_rounds` opens nestable
host spans around its phases — the chunk, the dispatch of its rounds,
the history drain, the eval, the health sample, the final transfer — and
`run_fl(trace=...)` writes them as Chrome trace events, loadable in
Perfetto (https://ui.perfetto.dev) or chrome://tracing:

    from repro_torch.obs.trace import Tracer, span, tracing

    with tracing(Tracer()) as tracer:
        with span("chunk", 0):
            with span("dispatch", 0):
                ...
    tracer.write("out.trace.json")

  * No cost when off. The process-global tracer slot holds a
    `NullTracer` unless a run opted in; its `span()` returns one shared
    do-nothing context manager: no allocation, no clock read, no lock.
  * Thread-safe: events append under a lock and carry their thread id,
    so per-thread nesting renders in Perfetto.
  * Alignable with a torch.profiler trace: `Tracer(profiler=True)` also
    enters a `torch.profiler.record_function` per span, so the host
    phases appear by name in a profile taken around the run
    (`chip_smoke.py --profile`).

Spans are host time: the card runs behind the host, so a span that ends
without a sync (`dispatch`) measures issue, and the first span that
waits on the device (`history_drain`) absorbs the rest.
"""
from __future__ import annotations

import json
import os
import threading
import time
from typing import Any, Dict, List, Optional


class _NullSpan:
    """Shared do-nothing context manager (the no-op tracer's span)."""
    __slots__ = ()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False


_NULL_SPAN = _NullSpan()


class NullTracer:
    """Tracing off: every span is the shared no-op context."""
    enabled = False

    def span(self, name: str, index: Optional[int] = None, **args):
        return _NULL_SPAN

    def instant(self, name: str, **args) -> None:
        pass

    @property
    def events(self) -> List[Dict[str, Any]]:
        return []

    def summary(self) -> Dict[str, Dict[str, float]]:
        return {}


class _Span:
    """One live span: records a Chrome 'X' (complete) event on exit."""
    __slots__ = ("_tracer", "_name", "_args", "_t0", "_ann")

    def __init__(self, tracer: "Tracer", name: str, args: Dict[str, Any]):
        self._tracer = tracer
        self._name = name
        self._args = args
        self._ann = None

    def __enter__(self):
        if self._tracer._annotation is not None:
            self._ann = self._tracer._annotation(self._name)
            self._ann.__enter__()
        self._t0 = time.perf_counter()
        return self

    def __exit__(self, *exc):
        t1 = time.perf_counter()
        if self._ann is not None:
            self._ann.__exit__(*exc)
        self._tracer._record(self._name, self._t0, t1 - self._t0,
                             self._args)
        return False


class Tracer:
    """Collects host spans; serializes to Chrome trace-event JSON.

    `span(name, index)` is a context manager; spans nest freely (the
    trace format rebuilds the stack from ts/dur containment per thread).
    `profiler=True` mirrors every span into a
    `torch.profiler.record_function`, so a concurrent torch.profiler
    capture shows the same phase boundaries."""
    enabled = True

    def __init__(self, *, profiler: bool = False):
        self._events: List[Dict[str, Any]] = []
        self._lock = threading.Lock()
        self._epoch = time.perf_counter()
        self._annotation = None
        if profiler:
            import torch.profiler
            self._annotation = torch.profiler.record_function

    def span(self, name: str, index: Optional[int] = None, **args):
        if index is not None:
            args["index"] = index
        return _Span(self, name, args)

    def instant(self, name: str, **args) -> None:
        """Zero-duration marker event (Chrome 'i' instant)."""
        ts = (time.perf_counter() - self._epoch) * 1e6
        ev = {"name": name, "ph": "i", "ts": ts, "s": "t",
              "pid": os.getpid(), "tid": threading.get_ident()}
        if args:
            ev["args"] = args
        with self._lock:
            self._events.append(ev)

    def _record(self, name: str, t0: float, dur_s: float,
                args: Dict[str, Any]) -> None:
        ev = {"name": name, "ph": "X",
              "ts": (t0 - self._epoch) * 1e6, "dur": dur_s * 1e6,
              "pid": os.getpid(), "tid": threading.get_ident()}
        if args:
            ev["args"] = args
        with self._lock:
            self._events.append(ev)

    @property
    def events(self) -> List[Dict[str, Any]]:
        with self._lock:
            return list(self._events)

    def summary(self) -> Dict[str, Dict[str, float]]:
        """Per-span-name aggregates: {name: {count, total_s, mean_s,
        max_s}}, the phase table `run_fl(trace=...)` reports."""
        out: Dict[str, Dict[str, float]] = {}
        for ev in self.events:
            if ev["ph"] != "X":
                continue
            s = out.setdefault(ev["name"],
                               {"count": 0, "total_s": 0.0, "max_s": 0.0})
            dur = ev["dur"] / 1e6
            s["count"] += 1
            s["total_s"] += dur
            s["max_s"] = max(s["max_s"], dur)
        for s in out.values():
            s["mean_s"] = s["total_s"] / max(s["count"], 1)
        return out

    def to_chrome(self) -> Dict[str, Any]:
        """The Chrome trace-event JSON object (Perfetto-loadable)."""
        return {"traceEvents": self.events, "displayTimeUnit": "ms"}

    def write(self, path: str) -> None:
        with open(path, "w") as f:
            json.dump(self.to_chrome(), f)


# Process-global tracer slot. Default: tracing off (NullTracer).
_TRACER = NullTracer()


def get_tracer():
    return _TRACER


def set_tracer(tracer) -> Any:
    """Install `tracer` globally; returns the previous tracer so callers
    can restore it (`tracing(...)` does)."""
    global _TRACER
    prev = _TRACER
    _TRACER = tracer
    return prev


def span(name: str, index: Optional[int] = None, **args):
    """Open a span on the current global tracer (no-op by default)."""
    return _TRACER.span(name, index, **args)


class tracing:
    """Context manager installing a tracer for a scoped region:

        with tracing(Tracer()) as t:
            run_fl(...)
        t.write("out.trace.json")
    """

    def __init__(self, tracer):
        self._tracer = tracer
        self._prev = None

    def __enter__(self):
        self._prev = set_tracer(self._tracer)
        return self._tracer

    def __exit__(self, *exc):
        set_tracer(self._prev)
        return False


def format_span_table(summary: Dict[str, Dict[str, float]]) -> str:
    """Fixed-width terminal table of a `Tracer.summary()` dict, widest
    total first."""
    if not summary:
        return "(no spans recorded)"
    rows = sorted(summary.items(), key=lambda kv: -kv[1]["total_s"])
    w = max(len("span"), *(len(k) for k in summary))
    lines = [f"{'span':<{w}}  {'count':>5}  {'total_s':>9}  "
             f"{'mean_s':>9}  {'max_s':>9}"]
    for name, s in rows:
        lines.append(f"{name:<{w}}  {s['count']:>5d}  {s['total_s']:>9.3f}"
                     f"  {s['mean_s']:>9.4f}  {s['max_s']:>9.4f}")
    return "\n".join(lines)
