"""Byte-offset shard indexes: read the record corpus without re-parsing it
(a copy of `repro.hub.serving.index`; either package reads the other's
sidecars).

Every JSONL shard gets a persisted sidecar (`<shard>.jsonl.idx`) holding the
byte offset + length of every valid record line, per-task record counts, and
the best (highest-throughput) good record per task key. The sidecar is
stamped with the `(mtime_ns, size)` of the shard it indexes and carries both
the store schema version and its own `INDEX_VERSION`:

  * a stamp mismatch (the shard was rewritten by `flush()`/`compact()`, or
    appended to by a foreign process) makes the sidecar self-invalidating —
    loaders fall back to a full parse and rewrite it;
  * a schema/index-version mismatch is the same, REBUILD not error: sidecars
    are derived data, the shard itself stays the source of truth.

What this buys the serving path: `count`, `task_keys`, and
`best_record` — the queries `select_sources` and `get_config` fan out per
device — become sidecar reads (or in-memory cache hits) instead of
JSON-parsing every record of every shard, and `tail_rows` seek-reads just
the newest lines.
"""
from __future__ import annotations

import dataclasses
import json
import os
from typing import Any, Dict, List, Optional, Tuple

INDEX_VERSION = 1
INDEX_SUFFIX = ".idx"


def index_path(shard_path: str) -> str:
    return shard_path + INDEX_SUFFIX


def _better(a: Optional[Dict[str, Any]], b: Dict[str, Any]) -> bool:
    """Is record `b` a strictly better winner than `a`? First-wins on ties
    keeps the winner deterministic under record reordering."""
    return (a is None
            or float(b["throughput_gflops"]) > float(a["throughput_gflops"]))


@dataclasses.dataclass
class ShardIndex:
    """Parsed sidecar for one shard file."""
    stamp: Tuple[int, int]                  # (mtime_ns, size) of the shard
    rows: List[Tuple[int, int]]             # (byte offset, length) per record
    n_records: int                          # all records, errors included
    n_good: int                             # records with a real throughput
    # task_key -> {"n_good": int, "best": best good record dict | None}
    tasks: Dict[str, Dict[str, Any]]

    def task_keys(self) -> List[str]:
        return sorted(k for k, t in self.tasks.items() if t["n_good"] > 0)

    def best(self, task_key: str) -> Optional[Dict[str, Any]]:
        entry = self.tasks.get(task_key)
        return entry["best"] if entry else None


def index_records(records, stamp: Tuple[int, int],
                  rows: List[Tuple[int, int]]) -> ShardIndex:
    """Build a ShardIndex from already-parsed records + their byte rows
    (the writer path: `flush()`/`compact()` know both at rewrite time)."""
    from repro_torch.hub.store import workload_from_record
    tasks: Dict[str, Dict[str, Any]] = {}
    n_good = 0
    for rec in records:
        key = workload_from_record(rec).key()
        entry = tasks.setdefault(key, {"n_good": 0, "best": None})
        if rec.get("error") or rec.get("throughput_gflops") is None:
            continue
        n_good += 1
        entry["n_good"] += 1
        if _better(entry["best"], rec):
            entry["best"] = rec
    return ShardIndex(stamp=stamp, rows=rows, n_records=len(records),
                      n_good=n_good, tasks=tasks)


def build_index(shard_path: str) -> Optional[ShardIndex]:
    """Parse a shard and build its index. Same tolerance contract as
    `store._load_shard_file`: a torn trailing line is dropped, torn interior
    lines and unknown record schemas raise `StoreSchemaError`. None when the
    shard does not exist."""
    from repro_torch.hub.store import COMPAT_SCHEMA_VERSIONS, StoreSchemaError
    try:
        with open(shard_path, "rb") as f:
            data = f.read()
            st = os.fstat(f.fileno())
    except OSError:
        return None
    stamp = (st.st_mtime_ns, st.st_size)
    records, rows = [], []
    pos = 0
    lines = data.split(b"\n")
    for i, raw in enumerate(lines):
        start, length = pos, len(raw)
        pos += length + 1
        if not raw.strip():
            continue
        try:
            rec = json.loads(raw)
        except json.JSONDecodeError:
            if i == len(lines) - 1 or (i == len(lines) - 2
                                       and not lines[-1].strip()):
                continue        # torn trailing line: a writer died mid-append
            raise StoreSchemaError(
                f"corrupt record in {shard_path}:{i + 1}")
        if rec.get("schema") not in COMPAT_SCHEMA_VERSIONS:
            raise StoreSchemaError(
                f"{shard_path}:{i + 1} has schema {rec.get('schema')!r}; "
                f"this build reads schemas {COMPAT_SCHEMA_VERSIONS}")
        records.append(rec)
        rows.append((start, length))
    return index_records(records, stamp, rows)


def write_index(shard_path: str, idx: ShardIndex) -> None:
    """Atomically persist the sidecar (temp file + `os.replace`, like every
    other store write). Best-effort callers should catch OSError — a
    read-only corpus can still be served, just without persisted indexes."""
    from repro_torch.hub.store import SCHEMA_VERSION
    payload = {
        "schema": SCHEMA_VERSION,
        "index_version": INDEX_VERSION,
        "stamp": list(idx.stamp),
        "rows": [[int(o), int(n)] for o, n in idx.rows],
        "n_records": idx.n_records,
        "n_good": idx.n_good,
        "tasks": idx.tasks,
    }
    path = index_path(shard_path)
    tmp = path + ".tmp"
    with open(tmp, "w") as f:
        json.dump(payload, f, sort_keys=True)
    os.replace(tmp, path)


def load_index(shard_path: str,
               stamp: Tuple[int, int]) -> Optional[ShardIndex]:
    """Load the sidecar for `shard_path` if it matches `stamp` (the caller's
    fresh `os.stat` of the shard). Any mismatch — missing sidecar, stale
    stamp, foreign schema or index version, or a corrupt sidecar — returns
    None: the caller rebuilds from the shard."""
    try:
        with open(index_path(shard_path)) as f:
            payload = json.load(f)
    except (OSError, json.JSONDecodeError):
        return None
    from repro_torch.hub.store import SCHEMA_VERSION
    if (payload.get("schema") != SCHEMA_VERSION
            or payload.get("index_version") != INDEX_VERSION
            or tuple(payload.get("stamp", ())) != tuple(stamp)):
        return None
    try:
        return ShardIndex(stamp=tuple(payload["stamp"]),
                          rows=[(int(o), int(n))
                                for o, n in payload["rows"]],
                          n_records=int(payload["n_records"]),
                          n_good=int(payload["n_good"]),
                          tasks=dict(payload["tasks"]))
    except (KeyError, TypeError, ValueError):
        return None


def read_rows(shard_path: str, idx: ShardIndex, start: int,
              stop: Optional[int] = None) -> List[Dict[str, Any]]:
    """Seek-read records [start:stop] of an indexed shard without parsing
    the rest of the file. The caller's stamp discipline guarantees the
    offsets still describe the bytes on disk."""
    rows = idx.rows[start:stop]
    out: List[Dict[str, Any]] = []
    if not rows:
        return out
    with open(shard_path, "rb") as f:
        for offset, length in rows:
            f.seek(offset)
            out.append(json.loads(f.read(length)))
    return out
