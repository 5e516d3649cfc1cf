"""Always-on time-series sampling over a `MetricsRegistry` (a copy of
`repro.obs.timeseries`, imports repointed).

The campaign-scoped FlightRecorder answers "what did this run spend";
a *serving* deployment needs the orthogonal question — "what is the
system doing right now" — answered continuously. `TimeSeriesSampler`
snapshots a registry (or any snapshot-producing callable) at a fixed
interval into a bounded ring, and windowed queries are computed as
*deltas between ring entries*:

  * rates are exact counter deltas divided by the sampled elapsed time;
  * percentiles are exact while the per-delta sample window covers the
    delta (the registry's mergeable histogram contract), bucket-resolution
    otherwise;
  * deltas are **reset-safe**: a respawned reader/worker restarts its
    counters at zero, which makes a merged absolute snapshot dip — every
    counter and histogram-bucket delta is clamped at zero so a windowed
    rate can never go negative.

Torch-free and dependency-free, like the rest of `repro_torch.obs`: the serving
parent samples merged reader snapshots with this, and tests drive it with
a manual clock (`clock=`) and `sample_now()` instead of the thread.
"""
from __future__ import annotations

import dataclasses
import math
import threading
import time
from collections import deque
from typing import Callable, Dict, List, Optional, Tuple, Union

from repro_torch.obs import metrics as obs_metrics
from repro_torch.obs.metrics import MetricsRegistry, hist_percentile

Snapshot = Dict[str, Dict]
Source = Union[None, MetricsRegistry, Callable[[], Snapshot]]


def _key_matches(key: str, prefix: str) -> bool:
    """`prefix` names an instrument (label-blind) or one exact label set."""
    return key == prefix or key.startswith(prefix + "{")


def _empty_hist_state() -> Dict[str, object]:
    return {"counts": [0] * obs_metrics.N_BUCKETS, "count": 0,
            "total": 0.0, "min": None, "max": None, "window": []}


def merge_hist_states(states: List[Dict[str, object]]) -> Dict[str, object]:
    """Fold several histogram `state()` dicts into one (exact bucket
    addition; windows concatenate, exact while they cover the count)."""
    out = _empty_hist_state()
    for st in states:
        for i, c in enumerate(st["counts"]):
            out["counts"][i] += c
        out["count"] += st["count"]
        out["total"] += st["total"]
        for bound, pick in (("min", min), ("max", max)):
            if st.get(bound) is not None:
                out[bound] = st[bound] if out[bound] is None \
                    else pick(out[bound], st[bound])
        out["window"] = list(out["window"]) + list(st.get("window", []))
    return out


def reset_safe_delta(before: Snapshot, after: Snapshot) -> Snapshot:
    """Like `metrics.delta`, but safe across process respawns: a counter
    (or histogram bucket) that went *backwards* — the respawned process
    restarted it at zero, dipping the merged absolute value — contributes
    zero, never a negative delta. Gauges report the `after` value."""
    out: Snapshot = {"counters": {}, "gauges": {}, "histograms": {}}
    b_c = before.get("counters", {})
    for key, v in after.get("counters", {}).items():
        d = max(0.0, v - b_c.get(key, 0.0))
        if d:
            out["counters"][key] = d
    out["gauges"] = dict(after.get("gauges", {}))
    b_h = before.get("histograms", {})
    for key, st in after.get("histograms", {}).items():
        prev = b_h.get(key)
        if prev is None:
            if st["count"] > 0:
                out["histograms"][key] = st
            continue
        counts = [max(0, a - b)
                  for a, b in zip(st["counts"], prev["counts"])]
        n = sum(counts)
        if n <= 0:
            continue
        out["histograms"][key] = {
            "counts": counts, "count": n,
            "total": max(0.0, st["total"] - prev["total"]),
            "min": st["min"], "max": st["max"],
            # the delta's own samples are the window's newest n entries
            "window": list(st.get("window", []))[-n:],
        }
    return out


@dataclasses.dataclass
class WindowDelta:
    """One windowed view: the reset-safe delta between two ring samples."""
    t0: float
    t1: float
    counters: Dict[str, float]
    gauges: Dict[str, float]
    histograms: Dict[str, Dict[str, object]]

    @property
    def elapsed(self) -> float:
        return self.t1 - self.t0

    def counter_sum(self, prefix: str) -> float:
        """Summed counter delta across every matching label set."""
        return sum(v for k, v in self.counters.items()
                   if _key_matches(k, prefix))

    def hist_state(self, prefix: str) -> Optional[Dict[str, object]]:
        """Merged histogram delta across every matching label set."""
        states = [st for k, st in self.histograms.items()
                  if _key_matches(k, prefix)]
        if not states:
            return None
        return states[0] if len(states) == 1 else merge_hist_states(states)

    def count(self, prefix: str) -> float:
        """Events in the window: counter delta, else histogram count."""
        n = self.counter_sum(prefix)
        if n:
            return n
        st = self.hist_state(prefix)
        return float(st["count"]) if st else 0.0

    def rate(self, prefix: str) -> float:
        """Events per second over the window (0.0 when nothing moved)."""
        if self.elapsed <= 0:
            return float("nan")
        return self.count(prefix) / self.elapsed

    def percentile(self, prefix: str, p: float) -> float:
        st = self.hist_state(prefix)
        if st is None or st["count"] == 0:
            return float("nan")
        return hist_percentile(st, p)

    def gauge(self, prefix: str) -> float:
        """Max across matching gauges (NaN when absent) — labelled gauges
        like per-device drift collapse to their worst value."""
        vals = [v for k, v in self.gauges.items() if _key_matches(k, prefix)]
        return max(vals) if vals else float("nan")


class TimeSeriesSampler:
    """Background sampler: snapshot `source` every `interval_s` into a
    bounded ring; windowed queries delta the ring (reset-safe).

    `source` is a `MetricsRegistry`, a zero-arg callable returning a
    snapshot dict (the serving parent passes its merge-the-readers
    scraper), or None for `metrics.current()` resolved per sample.
    `start()`/`stop()` manage the daemon thread; tests call
    `sample_now()` with an injected `clock` instead."""

    def __init__(self, source: Source = None, interval_s: float = 1.0,
                 capacity: int = 600,
                 clock: Callable[[], float] = time.monotonic,
                 on_sample: Optional[Callable[[float, Snapshot],
                                              None]] = None):
        if interval_s <= 0:
            raise ValueError(f"interval_s must be > 0, got {interval_s}")
        self._source = source
        self.interval_s = float(interval_s)
        self._clock = clock
        self._on_sample = on_sample
        self._samples: deque = deque(maxlen=int(capacity))
        self._lock = threading.Lock()
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None

    # --- sampling ---------------------------------------------------------
    def _snapshot(self) -> Snapshot:
        src = self._source
        if src is None:
            return obs_metrics.current().snapshot()
        if isinstance(src, MetricsRegistry):
            return src.snapshot()
        return src()

    def sample_now(self) -> Tuple[float, Snapshot]:
        """Take one sample synchronously (the thread's body; also the
        manual-clock test path)."""
        t = self._clock()
        snap = self._snapshot()
        with self._lock:
            self._samples.append((t, snap))
        if self._on_sample is not None:
            self._on_sample(t, snap)
        return t, snap

    def _run(self) -> None:
        while not self._stop.wait(self.interval_s):
            try:
                self.sample_now()
            except Exception:   # noqa: BLE001 — a bad scrape must not kill
                pass            # the sampler; the next tick retries

    def start(self) -> "TimeSeriesSampler":
        if self._thread is None:
            self._stop.clear()
            self._thread = threading.Thread(target=self._run,
                                            name="obs-sampler", daemon=True)
            self._thread.start()
        return self

    def stop(self, timeout: float = 5.0) -> None:
        """Idempotent; joins the thread so shutdown leaves nothing
        dangling."""
        self._stop.set()
        t, self._thread = self._thread, None
        if t is not None:
            t.join(timeout)

    @property
    def running(self) -> bool:
        return self._thread is not None and self._thread.is_alive()

    def __enter__(self) -> "TimeSeriesSampler":
        return self.start()

    def __exit__(self, *exc) -> None:
        self.stop()

    def __len__(self) -> int:
        with self._lock:
            return len(self._samples)

    # --- windowed queries -------------------------------------------------
    def window(self, seconds: float,
               now: Optional[float] = None) -> Optional[WindowDelta]:
        """The delta covering (roughly) the trailing `seconds`: from the
        newest ring entry at least that old — or the oldest entry when the
        ring is younger — to the newest. None with fewer than two samples
        (an empty window has no delta)."""
        with self._lock:
            samples = list(self._samples)
        if len(samples) < 2:
            return None
        t1, after = samples[-1]
        cutoff = (now if now is not None else t1) - seconds
        t0, before = samples[0]
        for t, snap in reversed(samples[:-1]):
            if t <= cutoff:
                t0, before = t, snap
                break
        if t1 <= t0:
            return None
        d = reset_safe_delta(before, after)
        return WindowDelta(t0=t0, t1=t1, counters=d["counters"],
                           gauges=d["gauges"], histograms=d["histograms"])

    def rate(self, prefix: str, seconds: float,
             now: Optional[float] = None) -> float:
        w = self.window(seconds, now=now)
        return float("nan") if w is None else w.rate(prefix)

    def percentile(self, prefix: str, p: float, seconds: float,
                   now: Optional[float] = None) -> float:
        w = self.window(seconds, now=now)
        return float("nan") if w is None else w.percentile(prefix, p)

    def gauge(self, prefix: str, seconds: float = math.inf,
              now: Optional[float] = None) -> float:
        w = self.window(seconds, now=now)
        return float("nan") if w is None else w.gauge(prefix)

    def latest(self) -> Optional[Snapshot]:
        with self._lock:
            return self._samples[-1][1] if self._samples else None
