"""Append-only on-disk record store: the hub's persistent measurement corpus
(port of `repro.hub.store`). The on-disk format is the reference's, so
either package reads and writes the other's stores; cost-model params load
as tensors on the `torch_device` the caller names (the card by default).

Every on-device measurement (simulated `Perf()` trial) the system ever makes
is worth keeping — TCL and TLP both show that a growing cross-device corpus
is what makes new cost models cheap to stand up. The seed pipeline threw its
record pools away per run; this store accumulates them instead:

  <root>/records/<device>/<task-shard>.jsonl    one JSON record per line
  <root>/fingerprints.json                      device -> probe vector
  <root>/params/<device>.npz                    pretrained cost-model params
  <root>/provenance/<device>.jsonl              TransferProvenance per winner

Shards are keyed by (device, task): a tuning job touches one device and a
handful of tasks, so writes stay local and a reader can load exactly the
devices/tasks it needs. Writes are atomic (full-shard rewrite to a temp file
+ `os.replace`), so a crash mid-flush never corrupts an existing shard.
Records are deduplicated on (task, config knobs, trial) — re-measuring the
same point is a no-op. Every record carries `schema`; loading a record with
an unknown schema version raises `StoreSchemaError` rather than silently
misinterpreting it, while any version in `COMPAT_SCHEMA_VERSIONS` still
loads (v1 stores predate transfer provenance but read, index, and compact
exactly as before — writes always stamp the current version).
"""
from __future__ import annotations

import json
import os
import re
import threading
from typing import (TYPE_CHECKING, Any, Dict, Iterable, List, Optional,
                    Sequence, Tuple)

import numpy as np

from repro_torch.autotune.space import ProgramConfig, Workload
from repro_torch.hub.serving import index as shard_index_mod

if TYPE_CHECKING:       # the featurized-Records type only; the cost-model
    from repro_torch.core.cost_model import Records     # module itself (and
    # torch) loads lazily so read-only serving processes boot without it
    from repro_torch.core.placement import TorchDevice

# v2 added transfer-provenance records (provenance/<device>.jsonl); the
# record/fingerprint/lineage shapes are unchanged, so v1 stores stay
# readable — bump COMPAT only when a version truly cannot be interpreted
SCHEMA_VERSION = 2
COMPAT_SCHEMA_VERSIONS = (1, 2)


class StoreSchemaError(ValueError):
    """A shard holds records written under an incompatible schema version."""


def _shard_name(task_key: str) -> str:
    """Filesystem-safe shard file name for a task key."""
    return re.sub(r"[^A-Za-z0-9_.-]", "_", task_key) + ".jsonl"


def workload_from_record(rec: Dict[str, Any]) -> Workload:
    t = rec["task"]
    return Workload(t["kind"], tuple(int(d) for d in t["dims"]),
                    name=t.get("name", ""), count=int(t.get("count", 1)),
                    dtype_bytes=int(t.get("dtype_bytes", 2)))


def _record_dict(device: str, wl: Workload, cfg: ProgramConfig,
                 throughput: Optional[float], trial: int,
                 error: Optional[str] = None) -> Dict[str, Any]:
    rec = {
        "schema": SCHEMA_VERSION,
        "device": device,
        "task": {"kind": wl.kind, "dims": list(wl.dims), "name": wl.name,
                 "count": wl.count, "dtype_bytes": wl.dtype_bytes},
        "knobs": {k: int(v) for k, v in cfg.knobs},
        "throughput_gflops": (None if throughput is None
                              else float(throughput)),
        "trial": int(trial),
    }
    if error is not None:
        # poisoned measurement (crash / timeout / quarantine): the config is
        # hostile on this device — worth remembering, never worth training on
        rec["error"] = str(error)
    return rec


def _dedup_key(rec: Dict[str, Any]) -> Tuple:
    # an error record and a later successful re-measurement of the same
    # (knobs, trial) are DIFFERENT facts — both kept
    return (tuple(sorted((k, int(v)) for k, v in rec["knobs"].items())),
            int(rec.get("trial", 0)), bool(rec.get("error")))


def _load_shard_file(path: str) -> List[Dict[str, Any]]:
    """Parse one JSONL shard, validating the schema of every record. A torn
    trailing line (a writer killed mid-append under older layouts) is
    dropped; torn interior lines and unknown schemas are hard errors."""
    if not os.path.exists(path):
        return []
    with open(path) as f:
        lines = f.read().splitlines()
    out: List[Dict[str, Any]] = []
    for i, line in enumerate(lines):
        if not line.strip():
            continue
        try:
            rec = json.loads(line)
        except json.JSONDecodeError:
            if i == len(lines) - 1:
                continue
            raise StoreSchemaError(f"corrupt record in {path}:{i + 1}")
        if rec.get("schema") not in COMPAT_SCHEMA_VERSIONS:
            raise StoreSchemaError(
                f"{path}:{i + 1} has schema {rec.get('schema')!r}; this "
                f"build reads schemas {COMPAT_SCHEMA_VERSIONS}")
        out.append(rec)
    return out


class RecordStore:
    """Append-only measurement store with buffered, atomic, deduped writes.

    `put()` buffers; `flush()` persists every dirty shard atomically. Reads
    (`iter_device`, `records`) see buffered + persisted records. One store
    instance is safe to share across threads (a single internal lock guards
    buffer and index state; flush rewrites shards under it).
    """

    def __init__(self, root: str):
        self.root = root
        self._lock = threading.RLock()
        # (device, task_key) -> buffered (not yet flushed) records
        self._buffer: Dict[Tuple[str, str], List[Dict[str, Any]]] = {}
        # (device, task_key) -> dedup keys already present (lazy)
        self._index: Dict[Tuple[str, str], set] = {}
        # path -> ((mtime_ns, size), parsed records): repeated reads of a
        # growing corpus (count + records per select_sources query) parse
        # each shard once until it changes on disk
        self._shard_cache: Dict[str, Tuple[Tuple[int, int],
                                           List[Dict[str, Any]]]] = {}
        # path -> ShardIndex (stamp-checked like _shard_cache): the serving
        # read path (count / task_keys / best_record / tail_rows) answers
        # from sidecar indexes without re-parsing shard records
        self._idx_cache: Dict[str, "shard_index_mod.ShardIndex"] = {}

    # --- paths ------------------------------------------------------------
    def _records_dir(self, device: str) -> str:
        return os.path.join(self.root, "records", device)

    def _shard_path(self, device: str, task_key: str) -> str:
        return os.path.join(self._records_dir(device), _shard_name(task_key))

    def _load_shard_cached(self, path: str) -> List[Dict[str, Any]]:
        try:
            st = os.stat(path)
        except OSError:
            return []
        stamp = (st.st_mtime_ns, st.st_size)
        with self._lock:
            hit = self._shard_cache.get(path)
            if hit is not None and hit[0] == stamp:
                return hit[1]
        recs = _load_shard_file(path)
        with self._lock:
            self._shard_cache[path] = (stamp, recs)
        return recs

    # --- byte-offset shard indexes ----------------------------------------
    def _shard_index(self, path: str):
        """The (memory-cached, sidecar-persisted) index for one shard file;
        None when the shard does not exist. A stale or schema-mismatched
        sidecar is rebuilt from the shard and rewritten — sidecars are
        derived data and always self-invalidate via the shard stamp."""
        try:
            st = os.stat(path)
        except OSError:
            return None
        stamp = (st.st_mtime_ns, st.st_size)
        with self._lock:
            hit = self._idx_cache.get(path)
            if hit is not None and hit.stamp == stamp:
                return hit
        idx = shard_index_mod.load_index(path, stamp)
        if idx is None:
            idx = shard_index_mod.build_index(path)
            if idx is None:
                return None
            try:
                shard_index_mod.write_index(path, idx)
            except OSError:
                pass        # read-only corpus: serve from memory only
        with self._lock:
            self._idx_cache[path] = idx
        return idx

    def shard_index(self, device: str, task_key: str):
        """Public index handle for one (device, task) shard, or None."""
        return self._shard_index(self._shard_path(device, task_key))

    def _buffered(self, device: str,
                  task_key: Optional[str] = None) -> List[Dict[str, Any]]:
        with self._lock:
            return [r for (d, k), recs in sorted(self._buffer.items())
                    if d == device and (task_key is None or k == task_key)
                    for r in recs]

    def best_record(self, device: str,
                    task_key: str) -> Optional[Dict[str, Any]]:
        """The highest-throughput good record for (device, task) — persisted
        winner straight from the sidecar index (no shard parse), merged with
        any still-buffered records. The serving fallback when the registry
        has no tuned winner yet."""
        idx = self.shard_index(device, task_key)
        best = idx.best(task_key) if idx is not None else None
        for rec in self._buffered(device, task_key):
            if rec.get("error") or rec.get("throughput_gflops") is None:
                continue
            if shard_index_mod._better(best, rec):
                best = rec
        return best

    def tail_rows(self, device: str, task_key: str,
                  n: int) -> List[Dict[str, Any]]:
        """The newest `n` persisted records of one shard, seek-read via the
        byte-offset index — O(n) bytes touched, not O(shard)."""
        path = self._shard_path(device, task_key)
        idx = self._shard_index(path)
        if idx is None or n <= 0:
            return []
        return shard_index_mod.read_rows(path, idx,
                                         max(0, len(idx.rows) - n))

    # --- writes -----------------------------------------------------------
    def _ensure_index(self, device: str, task_key: str) -> set:
        key = (device, task_key)
        if key not in self._index:
            self._index[key] = {
                _dedup_key(r) for r in self._load_shard_cached(
                    self._shard_path(device, task_key))}
        return self._index[key]

    def put(self, device: str, wl: Workload, cfg: ProgramConfig,
            throughput: Optional[float], trial: int = 0,
            error: Optional[str] = None) -> bool:
        """Buffer one measured record; returns False on a dedup hit. Pass
        `error=` (and `throughput=None`) for a poisoned measurement — error
        records persist alongside good ones but are excluded from training
        reads (`iter_device` / `records`) unless asked for."""
        rec = _record_dict(device, wl, cfg, throughput, trial, error=error)
        with self._lock:
            idx = self._ensure_index(device, wl.key())
            dk = _dedup_key(rec)
            if dk in idx:
                return False
            idx.add(dk)
            self._buffer.setdefault((device, wl.key()), []).append(rec)
            return True

    def put_many(self, device: str,
                 rows: Iterable[Tuple[Workload, ProgramConfig, float]],
                 trial: int = 0) -> int:
        return sum(self.put(device, wl, cfg, thr, trial=trial)
                   for wl, cfg, thr in rows)

    def put_result(self, result) -> int:
        """Persist every measurement a `TuneResult` carries, under its real
        trial index (results produced before the `measured` field existed
        contribute nothing). Poisoned configs (`TaskResult.poisoned`) are
        written as error records; the return counts good records only."""
        n = 0
        for t in result.tasks:
            for cfg, thr, trial in (t.measured or []):
                n += self.put(result.device, t.workload, cfg, thr,
                              trial=trial)
            for cfg, trial, err in (getattr(t, "poisoned", None) or []):
                self.put(result.device, t.workload, cfg, None,
                         trial=trial, error=err)
        return n

    def flush(self) -> int:
        """Atomically persist all buffered records; returns records written.

        Each dirty shard is rewritten in full to `<shard>.tmp` and moved into
        place with `os.replace`, so readers (and crashes) only ever observe a
        complete shard.
        """
        with self._lock:
            written = 0
            for (device, task_key), pending in sorted(self._buffer.items()):
                if not pending:
                    continue
                path = self._shard_path(device, task_key)
                existing = self._load_shard_cached(path)
                os.makedirs(os.path.dirname(path), exist_ok=True)
                self._rewrite_shard(path, existing + pending)
                written += len(pending)
            self._buffer.clear()
            return written

    def _rewrite_shard(self, path: str,
                       records: List[Dict[str, Any]]) -> None:
        """Write `records` as the shard's new full contents (temp file +
        `os.replace`), then refresh its sidecar index and in-memory caches.
        The sidecar lands AFTER the shard: a reader between the two replaces
        sees a stamp mismatch and rebuilds — never a torn index. Lock held
        by the caller."""
        tmp = path + ".tmp"
        rows: List[Tuple[int, int]] = []
        with open(tmp, "wb") as f:
            for rec in records:
                line = json.dumps(rec, sort_keys=True).encode()
                rows.append((f.tell(), len(line)))
                f.write(line + b"\n")
        os.replace(tmp, path)
        st = os.stat(path)
        stamp = (st.st_mtime_ns, st.st_size)
        idx = shard_index_mod.index_records(records, stamp, rows)
        try:
            shard_index_mod.write_index(path, idx)
        except OSError:
            self._idx_cache.pop(path, None)
        else:
            self._idx_cache[path] = idx
        self._shard_cache[path] = (stamp, records)

    # --- reads ------------------------------------------------------------
    def devices(self) -> List[str]:
        with self._lock:
            devs = {d for (d, _), recs in self._buffer.items() if recs}
        rec_root = os.path.join(self.root, "records")
        if os.path.isdir(rec_root):
            devs.update(d for d in os.listdir(rec_root)
                        if os.path.isdir(os.path.join(rec_root, d)))
        return sorted(devs)

    def _shard_files(self, device: str,
                     task_keys: Optional[Sequence[str]] = None) -> List[str]:
        """Shard paths for a device, optionally narrowed to the files that
        can hold `task_keys` (shards are keyed by task, so a task filter is
        a filename filter — readers skip unrelated shards entirely)."""
        d = self._records_dir(device)
        if not os.path.isdir(d):
            return []
        names = [n for n in sorted(os.listdir(d)) if n.endswith(".jsonl")]
        if task_keys is not None:
            wanted = {_shard_name(k) for k in task_keys}
            names = [n for n in names if n in wanted]
        return [os.path.join(d, n) for n in names]

    def _iter_persisted(self, device: str,
                        task_keys: Optional[Sequence[str]] = None):
        for path in self._shard_files(device, task_keys):
            yield from self._load_shard_cached(path)

    def iter_device(self, device: str, include_errors: bool = False):
        """All records for a device: persisted shards, then buffered.
        Error (poisoned-measurement) records are skipped by default so
        every training/featurization reader sees only real throughputs."""
        yield from self._iter_records(device, None,
                                      include_errors=include_errors)

    def _iter_records(self, device: str,
                      task_keys: Optional[Sequence[str]] = None,
                      include_errors: bool = False):
        for rec in self._iter_persisted(device, task_keys):
            if include_errors or not rec.get("error"):
                yield rec
        with self._lock:
            keys = set(task_keys) if task_keys is not None else None
            pending = [r for (d, k), recs in sorted(self._buffer.items())
                       if d == device and (keys is None or k in keys)
                       for r in recs]
        for rec in pending:
            if include_errors or not rec.get("error"):
                yield rec

    def count(self, device: str, include_errors: bool = False) -> int:
        """Record count for a device, answered from the sidecar indexes
        (plus the in-memory buffer) — no shard re-parse on the hot path.
        Schema errors surface exactly as they would from `iter_device`."""
        n = 0
        for path in self._shard_files(device):
            idx = self._shard_index(path)
            if idx is not None:
                n += idx.n_records if include_errors else idx.n_good
        return n + sum(1 for r in self._buffered(device)
                       if include_errors or not r.get("error"))

    def error_records(self, device: str) -> List[Dict[str, Any]]:
        """Just the poisoned measurements for a device (diagnostics)."""
        return [r for r in self.iter_device(device, include_errors=True)
                if r.get("error")]

    def task_keys(self, device: str) -> List[str]:
        keys = set()
        for path in self._shard_files(device):
            idx = self._shard_index(path)
            if idx is not None:
                keys.update(idx.task_keys())
        keys.update(workload_from_record(r).key()
                    for r in self._buffered(device) if not r.get("error"))
        return sorted(keys)

    def records(self, device: str,
                task_keys: Optional[Sequence[str]] = None) -> "Records":
        """Materialize a device's corpus as a featurized `Records` set.

        Group ids index task keys within this device (per-task label
        normalization is per device here; cross-device pools must offset
        group ids — see `transfer.select_sources`). With `task_keys`, only
        the matching shard files are parsed at all (shards are keyed by
        task); the in-record key filter stays as the correctness backstop
        for externally merged shards.
        """
        from repro_torch.core.cost_model import Records, normalize_per_task
        from repro_torch.core.features import FEATURE_DIM, extract_features
        wanted = set(task_keys) if task_keys is not None else None
        feats, raw, gids = [], [], []
        gid_of: Dict[str, int] = {}
        for rec in self._iter_records(device, task_keys):
            wl = workload_from_record(rec)
            key = wl.key()
            if wanted is not None and key not in wanted:
                continue
            cfg = ProgramConfig(tuple(sorted(
                (k, int(v)) for k, v in rec["knobs"].items())))
            gid = gid_of.setdefault(key, len(gid_of))
            feats.append(extract_features(wl, cfg))
            raw.append(float(rec["throughput_gflops"]))
            gids.append(gid)
        if not feats:
            return Records(x=np.zeros((0, FEATURE_DIM), np.float32),
                           y=np.zeros((0,), np.float32),
                           g=np.zeros((0,), np.int32),
                           raw_throughput=np.zeros((0,), np.float32))
        raw_arr = np.asarray(raw, np.float32)
        g = np.asarray(gids, np.int32)
        return Records(x=np.stack(feats), y=normalize_per_task(raw_arr, g),
                       g=g, raw_throughput=raw_arr)

    # --- fingerprints -----------------------------------------------------
    def _fingerprint_path(self) -> str:
        return os.path.join(self.root, "fingerprints.json")

    def fingerprints(self) -> Dict[str, np.ndarray]:
        """Persisted fingerprints. A file written under a different probe
        suite (`PROBE_VERSION`) is treated as absent — callers re-probe and
        overwrite — while an unknown store schema is a hard error."""
        from repro_torch.hub.fingerprint import PROBE_VERSION
        path = self._fingerprint_path()
        if not os.path.exists(path):
            return {}
        with open(path) as f:
            data = json.load(f)
        if data.get("schema") not in COMPAT_SCHEMA_VERSIONS:
            raise StoreSchemaError(f"{path} has schema {data.get('schema')!r}")
        if data.get("probe_version") != PROBE_VERSION:
            return {}
        return {d: np.asarray(v, np.float32)
                for d, v in data.get("devices", {}).items()}

    def put_fingerprint(self, device: str, vec: np.ndarray) -> None:
        from repro_torch.hub.fingerprint import PROBE_VERSION
        with self._lock:
            fps = self.fingerprints()
            fps[device] = np.asarray(vec, np.float32)
            os.makedirs(self.root, exist_ok=True)
            tmp = self._fingerprint_path() + ".tmp"
            with open(tmp, "w") as f:
                json.dump({"schema": SCHEMA_VERSION,
                           "probe_version": PROBE_VERSION,
                           "devices": {d: [float(x) for x in v]
                                       for d, v in sorted(fps.items())}},
                          f, indent=1, sort_keys=True)
            os.replace(tmp, self._fingerprint_path())

    def get_fingerprint(self, device: str) -> Optional[np.ndarray]:
        return self.fingerprints().get(device)

    # --- transfer provenance ----------------------------------------------
    # One JSONL file per device under provenance/; append-only, newest
    # record per task wins on read. Added in schema v2 — a v1 store simply
    # has no provenance/ directory, which reads as "no provenance".
    def _provenance_path(self, device: str) -> str:
        return os.path.join(self.root, "provenance", _shard_name(device))

    def put_provenance(self, device: str, prov: Dict[str, Any]) -> None:
        """Append one winner's `TransferProvenance` dict (see
        hub/provenance.py). The record is stamped with the store schema;
        `prov["task"]` is the workload key the read side groups by."""
        rec = dict(prov)
        rec["schema"] = SCHEMA_VERSION
        rec.setdefault("device", device)
        path = self._provenance_path(device)
        with self._lock:
            os.makedirs(os.path.dirname(path), exist_ok=True)
            with open(path, "a") as f:
                f.write(json.dumps(rec, sort_keys=True) + "\n")

    def get_provenance(self, device: str, task_key: Optional[str] = None):
        """Provenance for `device`: a {task_key: record} dict (newest record
        per task wins), or the single newest record for `task_key` (None if
        that task has no provenance). Tolerates a torn trailing line, like
        the shard reader; unknown schemas are hard errors."""
        path = self._provenance_path(device)
        if not os.path.exists(path):
            return None if task_key is not None else {}
        with open(path) as f:
            lines = f.read().splitlines()
        by_task: Dict[str, Dict[str, Any]] = {}
        for i, line in enumerate(lines):
            if not line.strip():
                continue
            try:
                rec = json.loads(line)
            except json.JSONDecodeError:
                if i == len(lines) - 1:
                    continue
                raise StoreSchemaError(f"corrupt record in {path}:{i + 1}")
            if rec.get("schema") not in COMPAT_SCHEMA_VERSIONS:
                raise StoreSchemaError(
                    f"{path}:{i + 1} has schema {rec.get('schema')!r}; this "
                    f"build reads schemas {COMPAT_SCHEMA_VERSIONS}")
            if rec.get("task"):
                by_task[rec["task"]] = rec
        if task_key is not None:
            return by_task.get(task_key)
        return by_task

    def provenance_devices(self) -> List[str]:
        """Devices that have at least one provenance record on disk."""
        pdir = os.path.join(self.root, "provenance")
        if not os.path.isdir(pdir):
            return []
        return sorted(f[:-len(".jsonl")] for f in os.listdir(pdir)
                      if f.endswith(".jsonl"))

    # --- maintenance ------------------------------------------------------
    def compact(self, device: Optional[str] = None) -> int:
        """Rewrite persisted shards dropping duplicate (task, knobs, trial)
        rows (first occurrence wins) and any torn trailing line; returns the
        number of rows dropped.

        `put()` dedups within one store instance, but two processes
        appending to the same root, or shards merged with `cat`, can land
        duplicates on disk. Buffered records flush first so the rewrite
        sees everything; each rewritten shard goes through the same
        temp-file + `os.replace` discipline as `flush()` — and
        `_rewrite_shard` refreshes the byte-offset sidecar with the shard,
        so a crash mid-compact never corrupts a shard and a concurrent
        reader only ever sees a stamp-consistent (shard, index) pair
        (torn-line-survives and compact-under-reader are both
        regression-tested)."""
        with self._lock:
            self.flush()
            dropped = 0
            devices = [device] if device is not None else self.devices()
            for dev in devices:
                for path in self._shard_files(dev):
                    with open(path) as f:
                        n_lines = sum(1 for ln in f if ln.strip())
                    recs = _load_shard_file(path)
                    seen, kept = set(), []
                    for rec in recs:
                        dk = _dedup_key(rec)
                        if dk in seen:
                            continue
                        seen.add(dk)
                        kept.append(rec)
                    if len(kept) == n_lines:
                        # nothing to drop, but make sure the sidecar exists
                        # and is fresh for the serving read path
                        self._shard_index(path)
                        continue
                    self._rewrite_shard(path, kept)
                    dropped += n_lines - len(kept)
                    # the dedup index keyed on (device, task) is stale too
                    task_key = next((k for (dv, k) in self._index
                                     if dv == dev and
                                     self._shard_path(dv, k) == path), None)
                    if task_key is not None:
                        self._index.pop((dev, task_key), None)
            return dropped

    # --- versioned cost-model params + lineage ----------------------------
    # Layout:
    #   params/<device>.npz            legacy single-slot file (read-only
    #                                  fallback; pre-lifecycle stores)
    #   params/<device>/v0001.npz      one file per saved version
    #   params/<device>/lineage.json   ordered lineage records
    #
    # Every save appends a lineage entry: version, parent version,
    # records-seen watermark, what triggered the save, and status
    # ("active" | "retired"). Loads walk the lineage newest-first and skip
    # retired or family-mismatched versions, so "the serving model" is
    # always the newest non-retired version of the right family.

    def _params_path(self, device: str) -> str:
        return os.path.join(self.root, "params", f"{device}.npz")

    def _params_dir(self, device: str) -> str:
        return os.path.join(self.root, "params", device)

    def _lineage_path(self, device: str) -> str:
        return os.path.join(self._params_dir(device), "lineage.json")

    def model_lineage(self, device: str) -> List[Dict[str, Any]]:
        """The device's ordered lineage records (oldest first); [] when no
        versioned params exist. A legacy flat-file save appears as a
        synthetic version-0 entry so callers see one consistent history."""
        path = self._lineage_path(device)
        entries: List[Dict[str, Any]] = []
        if os.path.exists(path):
            with open(path) as f:
                data = json.load(f)
            if data.get("schema") not in COMPAT_SCHEMA_VERSIONS:
                raise StoreSchemaError(
                    f"{path} has schema {data.get('schema')!r}")
            entries = list(data.get("versions", []))
        elif os.path.exists(self._params_path(device)):
            from repro_torch.core.cost_model import load_params
            # only the metadata is read: the tensors stay on the host
            _, meta = load_params(self._params_path(device), "cpu")
            entries = [{"version": 0, "parent": None,
                        "model": meta.get("model"), "trigger": "legacy",
                        "status": "active", "records_seen": None}]
        return entries

    def _write_lineage(self, device: str,
                       entries: List[Dict[str, Any]]) -> None:
        os.makedirs(self._params_dir(device), exist_ok=True)
        path = self._lineage_path(device)
        tmp = path + ".tmp"
        with open(tmp, "w") as f:
            json.dump({"schema": SCHEMA_VERSION, "versions": entries}, f,
                      indent=1, sort_keys=True)
        os.replace(tmp, path)

    def latest_model_version(self, device: str,
                             model_name: Optional[str] = None
                             ) -> Optional[int]:
        """Newest non-retired version number (of `model_name` if given)."""
        for e in reversed(self.model_lineage(device)):
            if e.get("status") == "retired":
                continue
            if model_name is not None and e.get("model") not in (
                    None, model_name):
                continue
            return int(e["version"])
        return None

    def save_model_params(self, device: str, params, model_name: str,
                          lineage: Optional[Dict[str, Any]] = None) -> str:
        """Persist cost-model params as a NEW version in the device's
        lineage, tagged with the model family so a loader can refuse a
        mismatch. `lineage` merges extra metadata into the entry (the
        lifecycle manager records records-seen watermark, drift trigger,
        rank-accuracy and parameter distance here). Returns the .npz path.
        """
        from repro_torch.core.cost_model import save_params
        with self._lock:
            entries = self.model_lineage(device)
            version = (max(int(e["version"]) for e in entries) + 1
                       if entries else 1)
            # the parent is the version this one supersedes — necessarily
            # of the same family (a different architecture's params are not
            # an ancestor, they are a sibling lineage)
            parent = self.latest_model_version(device,
                                               model_name=model_name)
            fname = f"v{version:04d}.npz"
            path = os.path.join(self._params_dir(device), fname)
            os.makedirs(self._params_dir(device), exist_ok=True)
            save_params(path, params,
                        meta={"model": model_name, "schema": SCHEMA_VERSION,
                              "version": version})
            entry = {"version": version, "parent": parent,
                     "model": model_name, "path": fname,
                     "trigger": "save", "status": "active",
                     "records_seen": None}
            entry.update(lineage or {})
            entries.append(entry)
            self._write_lineage(device, entries)
            return path

    def load_model_params(self, device: str,
                          model_name: Optional[str] = None,
                          version: Optional[int] = None,
                          torch_device: "TorchDevice" = "cuda"):
        """Load the newest non-retired persisted params for `device` as
        tensors on `torch_device` (raises without a card unless "cpu" is
        asked for), or None. When `model_name` is given, versions saved for
        a different model family are skipped (architectures differ; loading
        them would crash downstream). `version` pins an exact lineage
        version (even a retired one — post-mortems need to load what *was*
        serving)."""
        from repro_torch.core.placement import resolve_torch_device
        torch_device = resolve_torch_device(torch_device)
        entries = self.model_lineage(device)
        for e in reversed(entries):
            if version is not None and int(e["version"]) != version:
                continue
            if version is None and e.get("status") == "retired":
                continue
            if model_name is not None and e.get("model") not in (
                    None, model_name):
                if version is not None:
                    return None
                continue
            if int(e["version"]) == 0 or "path" not in e:
                path = self._params_path(device)   # legacy flat file
            else:
                path = os.path.join(self._params_dir(device), e["path"])
            if not os.path.exists(path):
                continue
            from repro_torch.core.cost_model import load_params
            params, _meta = load_params(path, torch_device)
            return params
        return None

    def retire_model(self, device: str,
                     version: Optional[int] = None) -> bool:
        """Mark a lineage version (newest active by default) retired so
        loads skip it; returns False when there was nothing to retire."""
        with self._lock:
            entries = self.model_lineage(device)
            target = (version if version is not None
                      else self.latest_model_version(device))
            if target is None:
                return False
            hit = False
            for e in entries:
                if int(e["version"]) == int(target):
                    e["status"] = "retired"
                    hit = True
            if hit:
                self._write_lineage(device, entries)
            return hit
