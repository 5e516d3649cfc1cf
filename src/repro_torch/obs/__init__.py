"""Telemetry (port of `repro.obs`): for now only the metrics registry.

`repro_torch.obs.metrics` is a verbatim copy of the jax-free
`repro/obs/metrics.py`: counters, gauges and histograms on one fixed
log-spaced bucket grid, and `metrics.current()`, the process registry (or
the innermost one pushed). The serving engine and the kernel probes record
into it. Trace spans, the flight recorder, time series and SLOs wait.
"""
from repro_torch.obs import metrics
from repro_torch.obs.metrics import (MetricsRegistry, current, pop_registry,
                                     push_registry)

__all__ = ["MetricsRegistry", "current", "metrics", "pop_registry",
           "push_registry"]
