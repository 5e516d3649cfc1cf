"""Unified telemetry (port of `repro.obs`): metrics, trace spans, flight
recorder, structured logger and search calibration.

Torch-free, as the reference is jax-free: spawn farm workers import from
here. Each module is a copy of the reference's with its imports repointed:

  * `repro_torch.obs.metrics` — counters, gauges and histograms on one fixed
    log-spaced bucket grid; `metrics.current()` is the process registry (or
    the innermost one pushed, e.g. a running campaign's).
  * `repro_torch.obs.trace` — `span("tune.round", ...)` context managers
    emitting Chrome-trace/Perfetto events, `(trace_id, span_id)` contexts
    that ride farm pipe messages, and `validate_events`.
  * `repro_torch.obs.recorder` — `FlightRecorder`: a campaign's
    `events.jsonl` + `campaign.trace.json`, and `summarize_trace`'s
    wall-time attribution.
  * `repro_torch.obs.calibration` — `CalibrationTracker`: predicted-vs-
    measured residuals, rank accuracy, top-k regret and draft acceptance.
  * `get_logger` (obs.logging): the `[name] msg key=value` status logger
    whose warning+ lines a running recorder captures.

The always-on monitoring layer of a serving farm:

  * `repro_torch.obs.timeseries` — `TimeSeriesSampler` snapshots a
    registry at a fixed interval into a bounded ring; windowed rate and
    percentile queries are reset-safe deltas between ring entries.
  * `repro_torch.obs.slo` — declarative `SLOSpec`s evaluated over fast and
    slow windows with hysteresis (`SLOEvaluator`), whose alert
    transitions go to the logger (and thus any running recorder).
"""
from repro_torch.obs import metrics, trace
from repro_torch.obs.calibration import CalibrationTracker
from repro_torch.obs.logging import get_logger
from repro_torch.obs.metrics import (Counter, Gauge, Histogram, LatencyWindow,
                                     MetricsRegistry, current, pop_registry,
                                     push_registry)
from repro_torch.obs.recorder import FlightRecorder, summarize_trace
from repro_torch.obs.slo import (SLOEvaluator, SLOSpec, SLOStatus,
                                 default_serving_slos)
from repro_torch.obs.timeseries import (TimeSeriesSampler, WindowDelta,
                                        reset_safe_delta)
from repro_torch.obs.trace import (SpanContext, Tracer, current_context,
                                   remote_event, span, to_chrome_trace,
                                   validate_events)

__all__ = [
    "CalibrationTracker",
    "Counter", "Gauge", "Histogram", "LatencyWindow", "MetricsRegistry",
    "current", "pop_registry", "push_registry",
    "FlightRecorder", "summarize_trace", "SpanContext", "Tracer",
    "current_context", "remote_event", "span", "to_chrome_trace",
    "validate_events", "get_logger", "metrics", "trace",
    "TimeSeriesSampler", "WindowDelta", "reset_safe_delta",
    "SLOEvaluator", "SLOSpec", "SLOStatus", "default_serving_slos",
]
