"""Process-local metrics registry: counters, gauges, histograms.

The telemetry substrate for the whole runtime stack (scheduler, executor
farm, hub, serving readers). Three design constraints drive the shape:

  * **merge-exact histograms** — every histogram shares ONE fixed
    log-spaced bucket grid (8 buckets per decade, 1e-7s .. 1e4s), so
    merging two snapshots is elementwise integer addition: cross-process
    aggregation (farm workers, serving readers) loses nothing beyond the
    grid resolution, and merging in any order gives identical results;
  * **exact recent percentiles** — each histogram also keeps a bounded
    ring of its most recent raw samples (the old `LatencyWindow`
    contract): process-local percentile readout is exact nearest-rank
    over the window, and only a *merged* histogram (whose ring no longer
    covers its count) falls back to bucket-resolution percentiles;
  * **zero dependencies** — no jax, no third-party clients: serving
    reader processes must be able to import this. Exposition is plain
    text (one instrument per line) and JSON.

Snapshots are plain dicts of str/int/float/list — picklable, JSON-able,
deterministic (sorted keys) — so they can ride a farm pipe message or a
serving RPC frame verbatim.

A module-level registry stack backs `current()`: instruments created
through `current()` land in the default process registry unless a
`FlightRecorder` (obs/recorder.py) has pushed a campaign-scoped registry.
"""
from __future__ import annotations

import bisect
import json
import math
import threading
from collections import deque
from typing import Dict, Iterable, List, Optional, Tuple

# The one fixed bucket grid: log-spaced, 8 buckets per decade, spanning
# 1e-7s (a cache hit) .. 1e4s (a full campaign). Fixed and global so any
# two histograms merge exactly; values outside clamp into the edge buckets.
BUCKET_BOUNDS: Tuple[float, ...] = tuple(
    10.0 ** (-7.0 + i / 8.0) for i in range(89))
N_BUCKETS = len(BUCKET_BOUNDS) + 1          # + overflow

LabelItems = Tuple[Tuple[str, str], ...]


def _label_key(labels: Dict[str, object]) -> LabelItems:
    return tuple(sorted((k, str(v)) for k, v in labels.items()))


def format_key(name: str, labels: LabelItems) -> str:
    """`name{k=v,k2=v2}` — the exposition/snapshot identity of an
    instrument. Deterministic: labels are sorted."""
    if not labels:
        return name
    return name + "{" + ",".join(f"{k}={v}" for k, v in labels) + "}"


class Counter:
    """Monotonically increasing count. `inc()` is the only mutator."""
    __slots__ = ("_lock", "_value")

    def __init__(self):
        self._lock = threading.Lock()
        self._value = 0.0

    def inc(self, n: float = 1.0) -> None:
        with self._lock:
            self._value += n

    @property
    def value(self) -> float:
        with self._lock:
            return self._value


class Gauge:
    """Last-write-wins scalar (queue depth, pool size, ...)."""
    __slots__ = ("_lock", "_value")

    def __init__(self):
        self._lock = threading.Lock()
        self._value = 0.0

    def set(self, v: float) -> None:
        with self._lock:
            self._value = float(v)

    def add(self, n: float = 1.0) -> None:
        with self._lock:
            self._value += n

    @property
    def value(self) -> float:
        with self._lock:
            return self._value


class Histogram:
    """Fixed-grid histogram + bounded ring of recent raw samples.

    `observe()` lands the value in its log-spaced bucket AND the ring;
    `percentile()` is exact nearest-rank over the ring while it covers
    every observation, and bucket-resolution (the bucket's upper bound,
    clamped to [min, max]) once the histogram has been merged or the ring
    has wrapped. `merge()` is elementwise bucket addition — exact, order
    independent."""

    __slots__ = ("_lock", "counts", "count", "total", "min", "max",
                 "_window")

    def __init__(self, window: int = 2048):
        self._lock = threading.Lock()
        self.counts = [0] * N_BUCKETS
        self.count = 0
        self.total = 0.0
        self.min = math.inf
        self.max = -math.inf
        self._window: deque = deque(maxlen=window)

    def observe(self, v: float) -> None:
        v = float(v)
        with self._lock:
            self.counts[bisect.bisect_left(BUCKET_BOUNDS, v)] += 1
            self.count += 1
            self.total += v
            self.min = min(self.min, v)
            self.max = max(self.max, v)
            self._window.append(v)

    # LatencyWindow-compatible alias
    record = observe

    def percentile(self, p: float) -> float:
        """p-th percentile (0..100), NaN when empty. Nearest-rank over the
        raw-sample ring (exact) when the ring still holds every
        observation; bucket upper bounds otherwise."""
        with self._lock:
            if self.count == 0:
                return float("nan")
            if self._window and len(self._window) == min(
                    self.count, self._window.maxlen):
                xs = sorted(self._window)
                rank = max(0, min(len(xs) - 1,
                                  math.ceil(p / 100.0 * len(xs)) - 1))
                return xs[rank]
            # merged / restored: walk the buckets
            rank = max(1, math.ceil(p / 100.0 * self.count))
            seen = 0
            for i, c in enumerate(self.counts):
                seen += c
                if seen >= rank:
                    bound = (BUCKET_BOUNDS[i] if i < len(BUCKET_BOUNDS)
                             else self.max)
                    return max(self.min, min(self.max, bound))
            return self.max

    @property
    def mean(self) -> float:
        with self._lock:
            return self.total / self.count if self.count else float("nan")

    def summary(self) -> Dict[str, float]:
        return {"n": self.count,
                "p50_ms": self.percentile(50) * 1e3,
                "p99_ms": self.percentile(99) * 1e3}

    def __len__(self) -> int:
        with self._lock:
            return len(self._window)

    def state(self) -> Dict[str, object]:
        """Plain-dict snapshot (picklable, JSON-able, deterministic)."""
        with self._lock:
            return {"counts": list(self.counts), "count": self.count,
                    "total": self.total,
                    "min": None if math.isinf(self.min) else self.min,
                    "max": None if math.isinf(self.max) else self.max,
                    "window": [float(x) for x in self._window]}

    def merge_state(self, st: Dict[str, object]) -> None:
        """Fold another histogram's `state()` in. Buckets add exactly;
        the ring concatenates (ours first) and keeps the newest maxlen."""
        with self._lock:
            for i, c in enumerate(st["counts"]):
                self.counts[i] += c
            self.count += st["count"]
            self.total += st["total"]
            if st["min"] is not None:
                self.min = min(self.min, st["min"])
            if st["max"] is not None:
                self.max = max(self.max, st["max"])
            for x in st.get("window", []):
                self._window.append(x)
            # the ring no longer covers every observation unless counts
            # still fit; percentile() detects that via the len==count test


class LatencyWindow:
    """Fixed-size ring of recent latency samples with exact percentiles.

    Since the telemetry unification this is a thin view over an obs
    `Histogram`: `--stats` percentile columns and the registry exposition
    read the SAME samples (regression-tested), instead of two bookkeeping
    paths drifting apart. Pass `histogram=` to view one registered in a
    `MetricsRegistry`; the default constructor keeps the old standalone
    behavior (a private, unregistered histogram)."""

    def __init__(self, capacity: int = 2048,
                 histogram: Optional[Histogram] = None):
        self.hist = histogram if histogram is not None \
            else Histogram(window=capacity)

    def record(self, seconds: float) -> None:
        self.hist.observe(seconds)

    def percentile(self, p: float) -> float:
        return self.hist.percentile(p)

    def summary(self) -> Dict[str, float]:
        return self.hist.summary()

    @property
    def count(self) -> int:
        return self.hist.count

    def __len__(self) -> int:
        return len(self.hist)


class Scope:
    """Named-scope instrument factory: prefixes every name and attaches
    fixed labels. `registry.scope("exec", backend="process").counter(
    "respawns")` == `registry.counter("exec.respawns",
    backend="process")`."""

    def __init__(self, registry: "MetricsRegistry", prefix: str,
                 labels: Dict[str, object]):
        self._registry = registry
        self._prefix = prefix
        self._labels = dict(labels)

    def _merge(self, labels: Dict[str, object]) -> Dict[str, object]:
        out = dict(self._labels)
        out.update(labels)
        return out

    def counter(self, name: str, **labels) -> Counter:
        return self._registry.counter(f"{self._prefix}.{name}",
                                      **self._merge(labels))

    def gauge(self, name: str, **labels) -> Gauge:
        return self._registry.gauge(f"{self._prefix}.{name}",
                                    **self._merge(labels))

    def histogram(self, name: str, window: int = 2048,
                  **labels) -> Histogram:
        return self._registry.histogram(f"{self._prefix}.{name}",
                                        window=window,
                                        **self._merge(labels))


class MetricsRegistry:
    """All instruments of one process/campaign, keyed (name, labels).

    `counter`/`gauge`/`histogram` are get-or-create (idempotent), so any
    layer can grab its instrument on the hot path without wiring a handle
    through constructors. `snapshot()` is a plain nested dict (picklable,
    deterministic); `merge()` folds a snapshot in exactly (counters and
    histogram buckets add; gauges last-write-wins to the merged value)."""

    def __init__(self):
        self._lock = threading.Lock()
        self._counters: Dict[Tuple[str, LabelItems], Counter] = {}
        self._gauges: Dict[Tuple[str, LabelItems], Gauge] = {}
        self._histograms: Dict[Tuple[str, LabelItems], Histogram] = {}

    # --- instrument access ------------------------------------------------
    def counter(self, name: str, **labels) -> Counter:
        key = (name, _label_key(labels))
        with self._lock:
            inst = self._counters.get(key)
            if inst is None:
                inst = self._counters[key] = Counter()
            return inst

    def gauge(self, name: str, **labels) -> Gauge:
        key = (name, _label_key(labels))
        with self._lock:
            inst = self._gauges.get(key)
            if inst is None:
                inst = self._gauges[key] = Gauge()
            return inst

    def histogram(self, name: str, window: int = 2048,
                  **labels) -> Histogram:
        key = (name, _label_key(labels))
        with self._lock:
            inst = self._histograms.get(key)
            if inst is None:
                inst = self._histograms[key] = Histogram(window=window)
            return inst

    def scope(self, prefix: str, **labels) -> Scope:
        return Scope(self, prefix, labels)

    # --- snapshot / merge -------------------------------------------------
    def snapshot(self) -> Dict[str, Dict]:
        with self._lock:
            counters = {format_key(n, lk): c.value
                        for (n, lk), c in sorted(self._counters.items())}
            gauges = {format_key(n, lk): g.value
                      for (n, lk), g in sorted(self._gauges.items())}
            hists = {format_key(n, lk): h.state()
                     for (n, lk), h in sorted(self._histograms.items())}
        return {"counters": counters, "gauges": gauges,
                "histograms": hists}

    def merge(self, snap: Dict[str, Dict]) -> None:
        """Fold a `snapshot()` in. Keys parse back into (name, labels)."""
        for key, v in snap.get("counters", {}).items():
            name, labels = parse_key(key)
            self.counter(name, **dict(labels)).inc(v)
        for key, v in snap.get("gauges", {}).items():
            name, labels = parse_key(key)
            self.gauge(name, **dict(labels)).set(v)
        for key, st in snap.get("histograms", {}).items():
            name, labels = parse_key(key)
            self.histogram(name, **dict(labels)).merge_state(st)

    def clear(self) -> None:
        with self._lock:
            self._counters.clear()
            self._gauges.clear()
            self._histograms.clear()

    # --- exposition -------------------------------------------------------
    def to_json(self) -> Dict[str, Dict]:
        """JSON exposition: scalars verbatim, histograms summarized (count,
        sum, min, max, mean, p50, p99) — the machine-readable `--obs`
        surface. Percentiles here go through the SAME `percentile()` the
        `--stats` columns use."""
        out: Dict[str, Dict] = {"counters": {}, "gauges": {},
                                "histograms": {}}
        with self._lock:
            counters = sorted(self._counters.items())
            gauges = sorted(self._gauges.items())
            hists = sorted(self._histograms.items())
        for (n, lk), c in counters:
            out["counters"][format_key(n, lk)] = c.value
        for (n, lk), g in gauges:
            out["gauges"][format_key(n, lk)] = g.value
        for (n, lk), h in hists:
            out["histograms"][format_key(n, lk)] = {
                "count": h.count, "sum": h.total,
                "min": None if math.isinf(h.min) else h.min,
                "max": None if math.isinf(h.max) else h.max,
                "mean": None if h.count == 0 else h.total / h.count,
                "p50": None if h.count == 0 else h.percentile(50),
                "p99": None if h.count == 0 else h.percentile(99),
            }
        return out

    def to_text(self) -> str:
        """Text exposition, one instrument per line."""
        j = self.to_json()
        lines: List[str] = []
        for key, v in j["counters"].items():
            lines.append(f"{key} {v:g}")
        for key, v in j["gauges"].items():
            lines.append(f"{key} {v:g}")
        for key, h in j["histograms"].items():
            if h["count"] == 0:
                lines.append(f"{key} count=0")
                continue
            lines.append(
                f"{key} count={h['count']} sum={h['sum']:.6g} "
                f"min={h['min']:.6g} max={h['max']:.6g} "
                f"p50={h['p50']:.6g} p99={h['p99']:.6g}")
        return "\n".join(lines)


def parse_key(key: str) -> Tuple[str, LabelItems]:
    """Inverse of `format_key`."""
    if "{" not in key:
        return key, ()
    name, rest = key.split("{", 1)
    items = []
    for part in rest.rstrip("}").split(","):
        if part:
            k, _, v = part.partition("=")
            items.append((k, v))
    return name, tuple(items)


def delta(before: Dict[str, Dict], after: Dict[str, Dict],
          prefixes: Optional[Iterable[str]] = None) -> Dict[str, Dict]:
    """Counter/histogram deltas between two `snapshot()`s of one registry
    (benchmarks bracket a suite with snapshots and report what IT spent).
    Gauges report the `after` value. Returns a snapshot-shaped dict."""

    def keep(key: str) -> bool:
        return prefixes is None or any(key.startswith(p) for p in prefixes)

    out: Dict[str, Dict] = {"counters": {}, "gauges": {}, "histograms": {}}
    b_c = before.get("counters", {})
    for key, v in after.get("counters", {}).items():
        if keep(key):
            d = v - b_c.get(key, 0.0)
            if d:
                out["counters"][key] = d
    for key, v in after.get("gauges", {}).items():
        if keep(key):
            out["gauges"][key] = v
    b_h = before.get("histograms", {})
    for key, st in after.get("histograms", {}).items():
        if not keep(key):
            continue
        prev = b_h.get(key)
        if prev is None:
            if st["count"]:
                out["histograms"][key] = st
            continue
        counts = [a - b for a, b in zip(st["counts"], prev["counts"])]
        n = st["count"] - prev["count"]
        if n <= 0:
            continue
        out["histograms"][key] = {
            "counts": counts, "count": n,
            "total": st["total"] - prev["total"],
            "min": st["min"], "max": st["max"],
            # the delta's own samples are the window's newest n entries
            "window": st.get("window", [])[-n:],
        }
    return out


def hist_percentile(state: Dict[str, object], p: float) -> float:
    """Percentile straight off a histogram `state()` dict (snapshot
    deltas in benchmarks) — same semantics as `Histogram.percentile`."""
    h = Histogram()
    h.merge_state(state)
    # prefer the delta's exact window when it covers the whole delta
    win = state.get("window", [])
    if win and len(win) == state["count"]:
        xs = sorted(win)
        rank = max(0, min(len(xs) - 1, math.ceil(p / 100.0 * len(xs)) - 1))
        return xs[rank]
    return h.percentile(p)


# --- the process registry stack -------------------------------------------
_default_registry = MetricsRegistry()
_stack: List[MetricsRegistry] = []
_stack_lock = threading.Lock()


def current() -> MetricsRegistry:
    """The active registry: the innermost pushed one (a running
    FlightRecorder's), else the process default."""
    with _stack_lock:
        return _stack[-1] if _stack else _default_registry


def default_registry() -> MetricsRegistry:
    return _default_registry


def push_registry(reg: MetricsRegistry) -> None:
    with _stack_lock:
        _stack.append(reg)


def pop_registry(reg: MetricsRegistry) -> None:
    with _stack_lock:
        if reg in _stack:
            _stack.remove(reg)


def dumps_json(reg: MetricsRegistry) -> str:
    return json.dumps(reg.to_json(), indent=1, sort_keys=True)
