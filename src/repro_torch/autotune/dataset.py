"""Tenset-like offline dataset generation (paper §3.6 Step 1 + §4.1).

Randomly samples (task, config) pairs on a device and records measured
throughput — the pre-training corpus for the source-device cost model, and
the "comprehensive tensor program dataset for two embedded devices" the paper
contributes (we generate it for every simulated device; see
benchmarks/dataset_stats). PyTorch port of `repro.autotune.dataset`.
"""
from __future__ import annotations

import os
from typing import Dict, List, Sequence

import numpy as np

from repro_torch.autotune.devices import measure
from repro_torch.autotune.space import Workload, random_config
from repro_torch.autotune.tasks import (PAPER_DNN_NAMES, arch_tasks,
                                        paper_dnn_tasks)
from repro_torch.core.cost_model import Records, normalize_per_task
from repro_torch.core.features import extract_features


def training_task_pool(seed: int = 0, include_archs: bool = True
                       ) -> List[Workload]:
    """A broad pool of tasks for pre-training (paper: "randomly generated
    tensor programs for widely [used] deep learning models")."""
    tasks: List[Workload] = []
    for name in PAPER_DNN_NAMES:
        tasks.extend(paper_dnn_tasks(name))
    if include_archs:
        from repro_torch.configs import ARCH_IDS, get_config
        for a in ARCH_IDS:
            tasks.extend(arch_tasks(get_config(a)))
    # dedup by key
    uniq: Dict[str, Workload] = {}
    for t in tasks:
        uniq.setdefault(t.key(), t)
    rng = np.random.RandomState(seed)
    # plus random synthetic GEMMs for coverage
    for _ in range(40):
        M = int(2 ** rng.uniform(5, 14))
        N = int(2 ** rng.uniform(5, 14))
        K = int(2 ** rng.uniform(5, 12))
        w = Workload("matmul", (M, N, K), name=f"rand_{M}x{N}x{K}")
        uniq.setdefault(w.key(), w)
    return list(uniq.values())


def generate_records(tasks: Sequence[Workload], device: str,
                     programs_per_task: int = 64, seed: int = 0,
                     noisy: bool = True, store=None) -> Records:
    """Sample + measure a record pool on `device`. Records are numpy;
    training moves them to the cost model's device batch by batch. With
    `store` set (a duck-typed `repro_torch.hub.store.RecordStore`), every
    measurement is also appended to the persistent cross-device corpus
    (caller flushes)."""
    rng = np.random.RandomState(seed)
    feats, raw, gids = [], [], []
    for gid, wl in enumerate(tasks):
        seen = set()
        for _ in range(programs_per_task):
            cfg = random_config(wl, rng)
            if cfg.knobs in seen:
                continue
            seen.add(cfg.knobs)
            thr = measure(wl, cfg, device, trial=0, noisy=noisy)
            feats.append(extract_features(wl, cfg))
            raw.append(thr)
            gids.append(gid)
            if store is not None:
                store.put(device, wl, cfg, thr)
    x = np.stack(feats)
    raw = np.asarray(raw, np.float32)
    g = np.asarray(gids, np.int32)
    y = normalize_per_task(raw, g)
    return Records(x=x, y=y, g=g, raw_throughput=raw)


def save_records(records: Records, path: str):
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    np.savez_compressed(path, x=records.x, y=records.y, g=records.g,
                        raw=records.raw_throughput
                        if records.raw_throughput is not None else
                        np.zeros(0))


def load_records(path: str) -> Records:
    z = np.load(path)
    raw = z["raw"] if z["raw"].size else None
    return Records(x=z["x"], y=z["y"], g=z["g"], raw_throughput=raw)
