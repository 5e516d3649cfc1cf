"""Class-balanced replay sampling over the hub record store (TCL-style; a
copy of `repro.continual.replay`, numpy throughout).

A continual refresh must not catastrophically forget the regimes the corpus
already covers: a device's newest records come from whatever workloads are
hot *now*, and training only on them skews the cost model toward that tail.
The replay buffer draws a deterministic, class-balanced sample from the
store — one reservoir per (device, task) shard (Vitter's Algorithm R, with
a per-group RNG derived from (seed, device, task key)) — and mixes it with
the fresh slice at a configurable ratio.

Determinism is operational, not cosmetic: two hub processes refreshing the
same store must train on identical batches (same seed + same store =>
bit-identical replay sets, pinned cross-process in tests the same way the
fingerprint suite is). That is why group RNGs key on content (seed, device,
task) rather than iteration order, and why sampling walks shards in sorted
task-key order.
"""
from __future__ import annotations

import dataclasses
import hashlib
from typing import Dict, List, Optional, Tuple

import numpy as np

from repro_torch.autotune.space import ProgramConfig
from repro_torch.core.cost_model import Records, normalize_per_task
from repro_torch.core.features import FEATURE_DIM, extract_features


@dataclasses.dataclass(frozen=True)
class ReplayConfig:
    """Knobs of the replay sampler.

    per_task: reservoir capacity per (device, task) shard — every task
      contributes at most this many replay rows, which is what makes the
      sample class-balanced regardless of how lopsided the shard sizes are.
    fresh_ratio: target fraction of *fresh* rows in the mixed training set
      (TCL's replay/new mixing knob). 0.5 means one replay row per fresh
      row; 1.0 disables replay entirely.
    seed: base seed every per-group reservoir RNG derives from.
    """
    per_task: int = 64
    fresh_ratio: float = 0.5
    seed: int = 0


def _group_seed(seed: int, device: str, task_key: str) -> int:
    """Content-derived per-(device, task) RNG seed (md5, like
    `session.derive_job_seed`): independent of shard iteration order and
    stable across processes."""
    ident = f"replay|{seed}|{device}|{task_key}"
    return int(hashlib.md5(ident.encode()).hexdigest()[:8], 16) % (2**31 - 1)


def device_rows(store, device: str) -> Dict[str, List[dict]]:
    """The device's raw record dicts grouped by task key, preserving
    append order within each task (shards are append-only, so within-task
    order IS chronological order). Keys come out sorted for determinism."""
    from repro_torch.hub.store import workload_from_record
    by_task: Dict[str, List[dict]] = {}
    for rec in store.iter_device(device):
        by_task.setdefault(workload_from_record(rec).key(), []).append(rec)
    return {k: by_task[k] for k in sorted(by_task)}


def split_tail(rows_by_task: Dict[str, List[dict]], per_task: int
               ) -> Tuple[Dict[str, List[dict]], Dict[str, List[dict]]]:
    """Split each task's rows into (history, newest tail of `per_task`
    rows). The tail is the refresh's "fresh" slice; history feeds replay."""
    head: Dict[str, List[dict]] = {}
    tail: Dict[str, List[dict]] = {}
    for key, rows in rows_by_task.items():
        cut = max(len(rows) - per_task, 0)
        head[key] = rows[:cut]
        tail[key] = rows[cut:]
    return head, tail


def build_records(rows_by_task: Dict[str, List[dict]]) -> Records:
    """Featurize raw record dicts into a `Records` set. Group ids index the
    sorted task keys; labels re-normalize per group over exactly these rows
    (a subset's max differs from the full shard's)."""
    from repro_torch.hub.store import workload_from_record
    feats, raw, gids = [], [], []
    for gid, key in enumerate(sorted(rows_by_task)):
        for rec in rows_by_task[key]:
            wl = workload_from_record(rec)
            cfg = ProgramConfig(tuple(sorted(
                (k, int(v)) for k, v in rec["knobs"].items())))
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


def _reservoir(rows: List[dict], k: int, rng: np.random.RandomState
               ) -> List[dict]:
    """Vitter's Algorithm R over `rows` in order: a uniform k-sample using
    one RNG draw per row past the first k — deterministic given (rows, rng
    state), independent of the total length known in advance."""
    res: List[dict] = []
    for i, rec in enumerate(rows):
        if i < k:
            res.append(rec)
        else:
            j = int(rng.randint(0, i + 1))
            if j < k:
                res[j] = rec
    return res


class ReplayBuffer:
    """Deterministic class-balanced replay sample of a device's corpus.

    `exclude_tail` drops the newest N rows of every task shard from the
    replay candidates — the refresh passes its fresh-slice window here so
    replay and fresh rows never double count the same measurements.
    `rows_by_task` supplies pre-fetched candidate rows (e.g. the head of
    an already-computed `split_tail`) so a caller that has walked the
    corpus once does not pay a second full store read; `exclude_tail`
    still applies to whatever rows are used.
    """

    def __init__(self, store, device: str,
                 cfg: Optional[ReplayConfig] = None, exclude_tail: int = 0,
                 rows_by_task: Optional[Dict[str, List[dict]]] = None):
        self.store = store
        self.device = device
        self.cfg = cfg if cfg is not None else ReplayConfig()
        self.exclude_tail = exclude_tail
        self._rows_by_task = rows_by_task

    def sample_rows(self) -> Dict[str, List[dict]]:
        """Per-task reservoir samples (sorted task keys, raw record dicts)."""
        rows_by_task = (self._rows_by_task
                        if self._rows_by_task is not None
                        else device_rows(self.store, self.device))
        if self.exclude_tail > 0:
            rows_by_task, _ = split_tail(rows_by_task, self.exclude_tail)
        out: Dict[str, List[dict]] = {}
        for key, rows in rows_by_task.items():
            if not rows:
                continue
            rng = np.random.RandomState(
                _group_seed(self.cfg.seed, self.device, key))
            out[key] = _reservoir(rows, self.cfg.per_task, rng)
        return out

    def sample(self) -> Records:
        """The balanced replay sample as a featurized `Records` set."""
        return build_records(self.sample_rows())

    def mix(self, fresh: Records) -> Records:
        """Replay + fresh at the configured ratio, disjoint group ids.

        The fresh rows are always kept whole (they are the drift signal);
        the replay contribution is sized so fresh makes up ~`fresh_ratio`
        of the mix, subsampled deterministically when the reservoirs hold
        more than that. Labels re-normalize per group over the mixed set.
        """
        r = min(max(self.cfg.fresh_ratio, 1e-6), 1.0)
        replay = self.sample()
        n_replay_target = int(round(len(fresh) * (1.0 - r) / r))
        if n_replay_target <= 0 or len(replay) == 0:
            return fresh
        if len(replay) > n_replay_target:
            rng = np.random.RandomState(
                _group_seed(self.cfg.seed, self.device, "__mix__"))
            idx = np.sort(rng.choice(len(replay), size=n_replay_target,
                                     replace=False))
            replay = Records(x=replay.x[idx], y=replay.y[idx],
                             g=replay.g[idx],
                             raw_throughput=replay.raw_throughput[idx])
        gid_base = (int(replay.g.max()) + 1) if len(replay) else 0
        g = np.concatenate([replay.g, fresh.g + gid_base])
        raw = np.concatenate([replay.raw_throughput, fresh.raw_throughput])
        return Records(x=np.concatenate([replay.x, fresh.x]),
                       y=normalize_per_task(raw, g), g=g, raw_throughput=raw)
