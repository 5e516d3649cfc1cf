"""Tuned-config registry: best (workload -> config) per device.

The bridge between Moses and the real kernels: a `TuneSession` persists its
winners here and kernels/ops.py consults the registry to pick the CUDA
kernel's tile sizes.
"""
from __future__ import annotations

import json
import os
import threading
from typing import Dict, Optional

from repro_torch.autotune.space import ProgramConfig, Workload, default_config

# the port's own default file, so the two packages never overwrite each
# other's registry; the JSON format is the reference's, so either reads both
_DEFAULT_PATH = os.environ.get("REPRO_TORCH_TUNING_REGISTRY",
                               os.path.join(os.path.dirname(__file__),
                                            "..", "..", "..",
                                            "tuned_configs_torch.json"))
_LOCK = threading.Lock()


class Registry:
    def __init__(self, path: Optional[str] = None):
        self.path = path or _DEFAULT_PATH
        self._data: Dict[str, Dict[str, dict]] = {}
        self._mtime_ns: Optional[int] = None
        self.reload()

    def _stat_ns(self) -> Optional[int]:
        try:
            return os.stat(self.path).st_mtime_ns
        except OSError:
            return None

    def reload(self) -> None:
        """Re-read the registry file, replacing in-memory state. A missing
        file is an empty registry, not an error."""
        with _LOCK:
            mtime = self._stat_ns()
            data: Dict[str, Dict[str, dict]] = {}
            if mtime is not None:
                with open(self.path) as f:
                    data = json.load(f)
            self._data = data
            self._mtime_ns = mtime

    def maybe_reload(self) -> bool:
        """Reload iff the file changed on disk since we last read or wrote
        it. This is how serving reader processes observe the writer hub's
        `save()`s: an mtime check per cache miss, a re-parse only when the
        file really moved. Returns True when a reload happened."""
        if self._stat_ns() == self._mtime_ns:
            return False
        self.reload()
        return True

    def _put_unlocked(self, device: str, wl: Workload, cfg: ProgramConfig,
                      throughput: float):
        dev = self._data.setdefault(device, {})
        dev[wl.key()] = {"knobs": dict(cfg.knobs),
                         "throughput_gflops": throughput}

    def put(self, device: str, wl: Workload, cfg: ProgramConfig,
            throughput: float):
        with _LOCK:
            self._put_unlocked(device, wl, cfg, throughput)

    def lookup(self, device: str, wl: Workload) -> Optional[dict]:
        """The raw registry entry for (device, workload), or None on a miss
        (unlike `get`, which silently falls back to the vendor default —
        servers like the TuningHub need to distinguish the two)."""
        with _LOCK:
            entry = self._data.get(device, {}).get(wl.key())
            return dict(entry) if entry is not None else None

    def entry(self, device: str, task_key: str) -> Optional[dict]:
        """`lookup` by raw workload-key string — the introspection read path
        (`explain`) has keys from provenance records, not Workloads."""
        with _LOCK:
            entry = self._data.get(device, {}).get(task_key)
            return dict(entry) if entry is not None else None

    def task_keys(self, device: str) -> list:
        """All served workload keys for a device (sorted)."""
        with _LOCK:
            return sorted(self._data.get(device, {}))

    def get(self, device: str, wl: Workload) -> ProgramConfig:
        entry = self.lookup(device, wl)
        if entry is None:
            return default_config(wl)
        return ProgramConfig(tuple(sorted(
            (k, int(v)) for k, v in entry["knobs"].items())))

    def save(self):
        """Atomic persist: serialize to a temp file, then `os.replace` — a
        writer crashing mid-save can never truncate or corrupt an existing
        registry file (regression-tested in test_hub.py)."""
        with _LOCK:
            os.makedirs(os.path.dirname(os.path.abspath(self.path)),
                        exist_ok=True)
            tmp = self.path + ".tmp"
            with open(tmp, "w") as f:
                json.dump(self._data, f, indent=1, sort_keys=True)
            os.replace(tmp, self.path)
            self._mtime_ns = self._stat_ns()

    def ingest(self, result) -> None:
        """Ingest a TuneResult, keeping the better config on key collisions
        (a TuneSession may tune the same workload under several strategies).
        The compare-and-put is atomic under the registry lock."""
        for t in result.tasks:
            with _LOCK:
                prev = self._data.get(result.device, {}).get(t.workload.key())
                if (prev is not None
                        and prev["throughput_gflops"] >= t.best_throughput):
                    continue
                self._put_unlocked(result.device, t.workload, t.best_config,
                                   t.best_throughput)

    def ingest_many(self, results, save: bool = False) -> None:
        """Ingest several TuneResults (e.g. `TuneSession.results`)."""
        for r in results:
            self.ingest(r)
        if save:
            self.save()
