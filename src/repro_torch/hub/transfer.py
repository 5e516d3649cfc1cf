"""Source-selection policy: which device(s) should a new target learn from?
(Port of `repro.hub.transfer`: the ranking, the weights and the pool are
numpy as in the reference; only the pretrained params are tensors.)

The paper fixes one source (K80 -> 2060/TX2); the hub generalizes it. Given
a target device's fingerprint and a store of measured corpora, rank every
known device by fingerprint similarity, pick the top-k, and assemble a
similarity-weighted mixed source pool plus pretrained cost-model params —
the warm start `MosesAdapter` adapts from. An *unseen* device therefore
boots from its nearest measured neighbors instead of a hard-coded source.

Group-id discipline: labels normalize per (device, task) — the same task has
different absolute throughput on different sources, so each source's task
groups get a disjoint id range in the mixed pool.
"""
from __future__ import annotations

import dataclasses
from typing import List, Optional, Sequence, Tuple

import numpy as np

from repro_torch.core.cost_model import Params, Records, normalize_per_task
from repro_torch.core.placement import TorchDevice
from repro_torch.hub.fingerprint import device_fingerprint, rank_by_similarity
from repro_torch.hub.store import RecordStore


@dataclasses.dataclass
class SourceSelection:
    """What `select_sources` hands the tuning stack for one target device."""
    target: str
    ranked: List[Tuple[str, float]]        # every known source, best first
    sources: List[Tuple[str, float]]       # chosen (device, mixing weight)
    pool: Optional[Records]                # mixed weighted source records
    pretrained_params: Optional[Params]    # nearest source's saved params
    params_device: Optional[str] = None    # which device's params those are

    @property
    def best_source(self) -> Optional[str]:
        return self.sources[0][0] if self.sources else None


def _known_fingerprints(store: RecordStore, devices: Sequence[str]):
    """Fingerprints for `devices`, reading the store's cache and filling +
    persisting any that are missing (probing is cheap but not free)."""
    cached = store.fingerprints()
    out = {}
    for d in devices:
        if d not in cached:
            fp = device_fingerprint(d)
            store.put_fingerprint(d, fp)
            cached[d] = fp
        out[d] = cached[d]
    return out


_MIX_TEMPERATURE = 0.1


def _mixing_weights(ranked: List[Tuple[str, float]]) -> List[float]:
    """Similarity -> mixing weights: softmax over (sim - best)/T, normalized
    to sum 1. The temperature makes the nearest source dominate (a 0.2
    similarity gap is ~8x the weight) while dissimilar sources keep a small
    share — a little domain spread helps the adversarial term."""
    sims = np.array([s for _, s in ranked], np.float64)
    w = np.exp((sims - sims.max()) / _MIX_TEMPERATURE)
    return [float(x) for x in w / w.sum()]


def select_sources(store: RecordStore, target: str, top_k: int = 2,
                   pool_cap: int = 4096, model_name: str = "mlp",
                   target_fingerprint: Optional[np.ndarray] = None,
                   seed: int = 0, torch_device: TorchDevice = "cuda"
                   ) -> SourceSelection:
    """Rank the store's devices against `target` and assemble the transfer
    inputs.

    The target itself never appears as its own source. `pool_cap` bounds the
    mixed pool; each chosen source contributes records proportional to its
    mixing weight (subsampled deterministically from `seed`). Pretrained
    params come from the nearest chosen source that has any persisted
    (`params_device` says which), as tensors on `torch_device`; None means
    the caller must pretrain on the pool.
    """
    known_devices = [d for d in store.devices()
                     if d != target and store.count(d) > 0]
    target_fp = (target_fingerprint if target_fingerprint is not None
                 else device_fingerprint(target))
    if not known_devices:
        return SourceSelection(target, [], [], None, None)
    ranked = rank_by_similarity(target_fp,
                                _known_fingerprints(store, known_devices))
    chosen = ranked[:max(top_k, 1)]
    weights = _mixing_weights(chosen)
    sources = [(d, w) for (d, _), w in zip(chosen, weights)]

    rng = np.random.RandomState(seed)
    xs, gs, raws = [], [], []
    gid_base = 0
    for dev, w in sources:
        recs = store.records(dev)
        if not len(recs):
            continue
        n_take = min(len(recs), max(int(round(pool_cap * w)), 64))
        idx = (np.arange(len(recs)) if n_take >= len(recs)
               else rng.choice(len(recs), size=n_take, replace=False))
        xs.append(recs.x[idx])
        raws.append(recs.raw_throughput[idx])
        gs.append(recs.g[idx] + gid_base)
        gid_base += int(recs.g.max()) + 1
    pool = None
    if xs:
        g = np.concatenate(gs)
        raw = np.concatenate(raws)
        pool = Records(x=np.concatenate(xs), y=normalize_per_task(raw, g),
                       g=g, raw_throughput=raw)

    params, params_device = None, None
    for dev, _ in sources:
        loaded = store.load_model_params(dev, model_name=model_name,
                                         torch_device=torch_device)
        if loaded is not None:
            params, params_device = loaded, dev
            break
    return SourceSelection(target, ranked, sources, pool, params,
                           params_device)


def bootstrap_store(store: RecordStore, devices: Sequence[str],
                    tasks: Sequence, programs_per_task: int = 16,
                    seed: int = 0) -> int:
    """Seed an empty (or partial) store with measured corpora for `devices`.

    Skips devices that already have records — re-running a bootstrap (the CI
    smoke leg restores a cached store) is a cheap no-op. Returns the number
    of records newly persisted.
    """
    from repro_torch.autotune.dataset import generate_records
    new = 0
    for dev in devices:
        if store.count(dev) > 0:
            continue
        generate_records(tasks, dev, programs_per_task=programs_per_task,
                         seed=seed, store=store)
        new += store.flush()
    return new
