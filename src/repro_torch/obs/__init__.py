"""Observability: engine tracing and fleet-health monitoring.

The port of `repro.obs`:

  trace.py  — host-side span tracer writing Chrome trace-event JSON
              (Perfetto), a process-global tracer slot with a no-op
              default, spans around `launch.engine.run_rounds`'s phases
              and `run_fl(trace=...)`.
  health.py — fleet-health monitors over the FleetState and the
              streaming-telemetry reducers: flat-battery counter,
              near-depletion watermark, selection-count Gini, staleness /
              residual-energy quantiles, checked against `HealthCfg`
              (`run_fl --health-strict` exits 3 on a violation).
  log.py    — stdlib logging for the runner's chatter, so health
              WARNINGs stand apart from progress lines (`--quiet`, `-v`).
"""
from repro_torch.obs.log import configure_logging, get_logger  # noqa: F401
from repro_torch.obs.trace import (NullTracer, Tracer,  # noqa: F401
                                   format_span_table, get_tracer, set_tracer,
                                   span, tracing)
from repro_torch.obs.health import (HealthCfg, HealthReport,  # noqa: F401
                                    chunk_sample, finalize_report,
                                    format_health_table, gini,
                                    with_health_specs)
