"""Declarative SLOs over sampled time series, with burn-rate alerting (a
copy of `repro.obs.slo`, imports repointed).

An `SLOSpec` names a windowed objective over the metrics a
`TimeSeriesSampler` is recording; the `SLOEvaluator` re-evaluates every
spec against TWO windows (the multi-window burn-rate idiom: the fast
window catches a real regression quickly, the slow window keeps a
transient blip from paging) and applies hysteresis so the alert state
cannot flap across the threshold:

  * **fire** only when BOTH windows violate the objective;
  * **clear** only when BOTH windows are back inside the threshold with a
    `clear_ratio` margin;
  * a window with no data is *unknown*: it can neither fire nor clear a
    spec, so short gaps hold the previous state instead of flapping.

Alert events are emitted only on state *transitions* (firing <-> ok) —
through the structured logger at warning level, which any active
`FlightRecorder` mirrors into `events.jsonl` via the existing sink path —
and counted in a registry (`slo.transitions{slo=...,state=...}`).

Spec kinds (threshold semantics):
  latency_p   p-th percentile of a histogram  <= threshold seconds
  rate_floor  windowed rate of a counter      >= threshold per second
  ratio       numerator / denominator counters <= threshold
  events      windowed counter delta          <= threshold
  gauge_max   max matching gauge value        <= threshold

Torch-free, like everything in `repro_torch.obs`.
"""
from __future__ import annotations

import dataclasses
import math
import threading
from typing import Dict, List, Optional

from repro_torch.obs import get_logger
from repro_torch.obs import metrics as obs_metrics
from repro_torch.obs.timeseries import TimeSeriesSampler, WindowDelta

KINDS = ("latency_p", "rate_floor", "ratio", "events", "gauge_max")


@dataclasses.dataclass(frozen=True)
class SLOSpec:
    """One declarative objective over a metric key (label-blind prefix or
    one exact `name{label=value}` key)."""
    name: str
    kind: str
    key: str
    threshold: float
    p: float = 99.0                       # latency_p percentile
    denominator: Optional[str] = None     # ratio denominator counter
    fast_window_s: float = 30.0
    slow_window_s: float = 120.0
    description: str = ""

    def __post_init__(self):
        if self.kind not in KINDS:
            raise ValueError(f"unknown SLO kind {self.kind!r}; "
                             f"expected one of {KINDS}")
        if self.kind == "ratio" and not self.denominator:
            raise ValueError(f"SLO {self.name!r}: ratio needs denominator=")


@dataclasses.dataclass
class SLOStatus:
    """One spec's state after an evaluation pass."""
    name: str
    kind: str
    key: str
    state: str            # ok | firing | no_data
    value_fast: float
    value_slow: float
    threshold: float

    def to_dict(self) -> Dict[str, object]:
        d = dataclasses.asdict(self)
        for k in ("value_fast", "value_slow"):     # NaN is not JSON
            if isinstance(d[k], float) and math.isnan(d[k]):
                d[k] = None
        return d


def default_serving_slos(p99_ceiling_s: float = 0.5,
                         qps_floor: float = 0.0,
                         error_budget: float = 0.5,
                         respawn_budget: float = 0.0,
                         drift_ceiling: float = 0.05,
                         fast_window_s: float = 30.0,
                         slow_window_s: float = 120.0) -> List[SLOSpec]:
    """The serving stack's stock objectives. The QPS floor defaults to 0
    (disabled) so an idle server is not permanently firing; deployments
    with steady load raise it."""
    w = {"fast_window_s": fast_window_s, "slow_window_s": slow_window_s}
    return [
        SLOSpec("serve-p99", "latency_p", "serve.latency_seconds",
                p99_ceiling_s, p=99.0,
                description="serving p99 under the ceiling", **w),
        SLOSpec("serve-qps", "rate_floor", "serve.requests", qps_floor,
                description="aggregate served QPS above the floor", **w),
        SLOSpec("tune-errors", "ratio", "serve.errors", error_budget,
                denominator="serve.requests",
                description="request error fraction inside the budget", **w),
        SLOSpec("reader-respawns", "events", "serve.reader_respawns",
                respawn_budget,
                description="reader kill/respawn budget", **w),
        SLOSpec("drift", "gauge_max", "continual.fingerprint_shift",
                drift_ceiling,
                description="device fingerprint drift under threshold", **w),
    ]


class SLOEvaluator:
    """Evaluate specs against a sampler's fast/slow windows; emit
    de-flapped transition events."""

    MAX_ALERTS = 200

    def __init__(self, specs: List[SLOSpec], sampler: TimeSeriesSampler,
                 clear_ratio: float = 0.9, logger=None,
                 registry: Optional[obs_metrics.MetricsRegistry] = None):
        self.specs = list(specs)
        self.sampler = sampler
        self.clear_ratio = float(clear_ratio)
        self._log = logger if logger is not None else get_logger("slo")
        self._registry = registry
        self._firing: Dict[str, bool] = {}
        self._lock = threading.Lock()
        self.alerts: List[Dict[str, object]] = []   # transition events
        self.statuses: List[SLOStatus] = []         # last evaluation

    # --- per-kind value + predicates --------------------------------------
    def _value(self, spec: SLOSpec, w: Optional[WindowDelta]) -> float:
        if w is None:
            return float("nan")
        if spec.kind == "latency_p":
            return w.percentile(spec.key, spec.p)
        if spec.kind == "rate_floor":
            return w.rate(spec.key)
        if spec.kind == "events":
            return w.counter_sum(spec.key)
        if spec.kind == "gauge_max":
            return w.gauge(spec.key)
        # ratio: error fraction; no denominator traffic means no verdict
        num = w.counter_sum(spec.key)
        den = w.counter_sum(spec.denominator or "")
        if den <= 0:
            return float("nan") if num <= 0 else 1.0
        return num / den

    def _violated(self, spec: SLOSpec, v: float) -> Optional[bool]:
        if math.isnan(v):
            return None                    # unknown: cannot fire or clear
        if spec.kind == "rate_floor":
            return v < spec.threshold
        return v > spec.threshold

    def _clear_ok(self, spec: SLOSpec, v: float) -> Optional[bool]:
        """Back inside the objective WITH margin (the hysteresis band)."""
        if math.isnan(v):
            return None
        if spec.kind == "rate_floor":
            return v >= spec.threshold / max(self.clear_ratio, 1e-9)
        return v <= spec.threshold * self.clear_ratio

    # --- evaluation -------------------------------------------------------
    def _transition(self, spec: SLOSpec, state: str, vf: float,
                    vs: float, now: Optional[float]) -> None:
        event = {"kind": "slo", "slo": spec.name, "state": state,
                 "slo_kind": spec.kind, "key": spec.key,
                 "threshold": spec.threshold,
                 "value_fast": None if math.isnan(vf) else vf,
                 "value_slow": None if math.isnan(vs) else vs}
        if now is not None:
            event["at"] = now
        self.alerts.append(event)
        del self.alerts[:-self.MAX_ALERTS]
        if self._registry is not None:
            self._registry.counter("slo.transitions", slo=spec.name,
                                   state=state).inc()
        emit = self._log.warning if state == "firing" else self._log.info
        emit(f"SLO {spec.name} {state}", slo=spec.name, kind=spec.kind,
             key=spec.key, threshold=spec.threshold,
             value_fast=round(vf, 6) if not math.isnan(vf) else "nan",
             value_slow=round(vs, 6) if not math.isnan(vs) else "nan")

    def evaluate(self, now: Optional[float] = None) -> List[SLOStatus]:
        """One pass over every spec. Thread-safe; call after each sample
        (the serving monitor does) or on demand."""
        with self._lock:
            out: List[SLOStatus] = []
            for spec in self.specs:
                wf = self.sampler.window(spec.fast_window_s, now=now)
                ws = self.sampler.window(spec.slow_window_s, now=now)
                vf, vs = self._value(spec, wf), self._value(spec, ws)
                firing = self._firing.get(spec.name, False)
                if not firing:
                    if (self._violated(spec, vf) is True
                            and self._violated(spec, vs) is True):
                        firing = True
                        self._transition(spec, "firing", vf, vs, now)
                else:
                    if (self._clear_ok(spec, vf) is True
                            and self._clear_ok(spec, vs) is True):
                        firing = False
                        self._transition(spec, "ok", vf, vs, now)
                self._firing[spec.name] = firing
                state = ("firing" if firing
                         else "no_data" if math.isnan(vf) and math.isnan(vs)
                         else "ok")
                out.append(SLOStatus(name=spec.name, kind=spec.kind,
                                     key=spec.key, state=state,
                                     value_fast=vf, value_slow=vs,
                                     threshold=spec.threshold))
            self.statuses = out
            return out

    def firing(self) -> List[str]:
        with self._lock:
            return sorted(n for n, f in self._firing.items() if f)
