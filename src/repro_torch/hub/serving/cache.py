"""Tuned-config LRU cache + latency windows: the zero-I/O serving hot path
(a copy of `repro.hub.serving.cache`).

A registry lookup is already cheap (a dict under a lock), but it still
deserializes knobs into a fresh `ProgramConfig` per call and — in the
multi-process readers — sits behind an mtime staleness check against the
registry file. The `TunedConfigCache` keeps the last N served
(device, workload-key) winners as ready-to-return `ProgramConfig`s, so the
hit path touches no file, no JSON, and no shared hub state: one ordered-dict
move under the cache's own lock.

Staleness is handled by EXPLICIT invalidation, not TTLs: the only events
that change a served winner are a tuning job landing in the registry and a
continual-learning refresh retiring a model — both call
`invalidate(device)`. A cache miss always falls through to the registry, so
an invalidated (or evicted) key simply repopulates on its next hit.

`LatencyWindow` is the serving-latency instrument behind `--stats` and the
serve bench. Since the telemetry unification it lives in
`repro_torch.obs.metrics` (re-exported here for its long-standing import path):
the same fixed-size ring with exact nearest-rank percentiles, now backed by
an obs `Histogram` so the `--stats` p50/p99 columns and the registry
exposition read the SAME samples.
"""
from __future__ import annotations

import threading
from collections import OrderedDict
from typing import Dict, Optional, Tuple

from repro_torch.autotune.space import ProgramConfig
from repro_torch.obs.metrics import LatencyWindow

__all__ = ["CacheEntry", "LatencyWindow", "TunedConfigCache"]

# (served config, the registry's recorded winner throughput — None when the
# entry came from a store fallback that recorded no winner)
CacheEntry = Tuple[ProgramConfig, Optional[float]]


class TunedConfigCache:
    """Thread-safe LRU of served (device, workload-key) -> config winners."""

    def __init__(self, capacity: int = 4096):
        if capacity < 1:
            raise ValueError(f"capacity must be >= 1, got {capacity}")
        self.capacity = capacity
        self._lock = threading.Lock()
        self._entries: "OrderedDict[Tuple[str, str], CacheEntry]" = \
            OrderedDict()
        self.hits = 0
        self.misses = 0
        self.evictions = 0
        self.invalidations = 0

    def get(self, device: str, task_key: str) -> Optional[CacheEntry]:
        with self._lock:
            entry = self._entries.get((device, task_key))
            if entry is None:
                self.misses += 1
                return None
            self._entries.move_to_end((device, task_key))
            self.hits += 1
            return entry

    def put(self, device: str, task_key: str, config: ProgramConfig,
            throughput: Optional[float]) -> None:
        with self._lock:
            key = (device, task_key)
            self._entries[key] = (config, throughput)
            self._entries.move_to_end(key)
            while len(self._entries) > self.capacity:
                self._entries.popitem(last=False)
                self.evictions += 1

    def invalidate(self, device: str, task_key: Optional[str] = None) -> int:
        """Drop one key, or every key for `device`; returns entries dropped.
        The hook registry writes and lifecycle refreshes call."""
        with self._lock:
            if task_key is not None:
                dropped = 1 if self._entries.pop((device, task_key),
                                                 None) is not None else 0
            else:
                stale = [k for k in self._entries if k[0] == device]
                for k in stale:
                    del self._entries[k]
                dropped = len(stale)
            self.invalidations += dropped
            return dropped

    def clear(self) -> None:
        with self._lock:
            self.invalidations += len(self._entries)
            self._entries.clear()

    def __len__(self) -> int:
        with self._lock:
            return len(self._entries)

    @property
    def hit_rate(self) -> float:
        with self._lock:
            n = self.hits + self.misses
            return self.hits / n if n else float("nan")

    def counters(self) -> Dict[str, float]:
        with self._lock:
            n = self.hits + self.misses
            return {"size": len(self._entries), "hits": self.hits,
                    "misses": self.misses, "evictions": self.evictions,
                    "invalidations": self.invalidations,
                    "hit_rate": self.hits / n if n else float("nan")}
