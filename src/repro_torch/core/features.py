"""164-dimensional program feature extraction (Ansor-style; paper §2.2:
"we adopt the 164-d features in Ansor to depict the program").

Layout (zero-padded to exactly 164):
  [0:8)    log2 workload dims (padded)
  [8:24)   log2 knob values + one-hot knob categories
  [24:40)  grid / loop-structure features (extents, trip counts, order flags)
  [40:72)  memory-touch features per level (HBM reads/writes, VMEM working
           set, reuse counts, burst sizes) in log-bytes
  [72:96)  arithmetic-intensity & FLOP features
  [96:128) alignment / padding-waste features (MXU 128/256 alignment
           fractions, pow2 flags, waste ratios)
  [128:152) parallelism & pipelining features (parallel extent, unroll,
           stages, sequential chain length)
  [152:164) workload-kind one-hot + bias

All features are functions of (workload, config) only — hardware-independent
*representations* whose hardware-dependent *cost* the model must learn
(paper Eq. 3 decomposition).
"""
from __future__ import annotations

import math
from typing import TYPE_CHECKING, Dict

import numpy as np

if TYPE_CHECKING:  # runtime import is deferred, as in the reference, so
    # the import order of `autotune` and `core` never matters
    from repro_torch.autotune.space import ProgramConfig, Workload

FEATURE_DIM = 164


def _log2(x: float) -> float:
    return math.log2(max(float(x), 1.0))


def _put(vec: np.ndarray, idx: int, vals) -> int:
    for v in np.atleast_1d(vals):
        if idx < len(vec):
            vec[idx] = v
        idx += 1
    return idx


def extract_features(wl: Workload, cfg: ProgramConfig) -> np.ndarray:
    from repro_torch.autotune.space import vmem_working_set
    v = np.zeros(FEATURE_DIM, np.float32)
    d = cfg.as_dict()
    b = wl.dtype_bytes

    # --- [0:8) workload dims
    i = 0
    i = _put(v, i, [_log2(x) for x in wl.dims])
    i = 8

    # --- [8:24) knobs
    knob_order = ["block_m", "block_n", "block_k", "k_inner", "unroll",
                  "out_bf16", "block_q", "block_kv", "stages", "chunk",
                  "block_w"]
    for j, k in enumerate(knob_order):
        if k in d:
            v[8 + j] = _log2(d[k]) if d[k] > 1 else float(d[k])
    i = 24

    # --- [24:40) grid / loop structure
    if wl.kind == "matmul":
        M, N, K = wl.dims
        gm = math.ceil(M / d["block_m"])
        gn = math.ceil(N / d["block_n"])
        gk = math.ceil(K / d["block_k"])
        i = _put(v, 24, [_log2(gm), _log2(gn), _log2(gk), _log2(gm * gn * gk),
                         float(d["k_inner"]), _log2(d["unroll"]),
                         _log2(min(M, d["block_m"])),
                         _log2(min(N, d["block_n"])),
                         _log2(min(K, d["block_k"]))])
    elif wl.kind == "attention":
        S, D = wl.dims
        gq = math.ceil(S / d["block_q"])
        gkv = math.ceil(S / d["block_kv"])
        i = _put(v, 24, [_log2(gq), _log2(gkv), _log2(gq * (gkv + 1) / 2),
                         float(d["stages"]), _log2(d["unroll"]), _log2(D)])
    else:
        S, W = wl.dims
        gc = math.ceil(S / d["chunk"])
        gw = math.ceil(W / d["block_w"])
        i = _put(v, 24, [_log2(gc), _log2(gw), _log2(gc * gw),
                         _log2(d["unroll"])])

    # --- [40:72) memory-touch features
    ws = vmem_working_set(wl, cfg)
    min_bytes = wl.min_hbm_bytes
    if wl.kind == "matmul":
        M, N, K = wl.dims
        gm = math.ceil(M / d["block_m"])
        gn = math.ceil(N / d["block_n"])
        gk = math.ceil(K / d["block_k"])
        a_reads = b * M * K * gn
        b_reads = b * K * N * gm
        out_b = (2 if d["out_bf16"] else 4)
        c_traffic = out_b * M * N * (1 if d["k_inner"] else 2 * gk - 1)
        total = a_reads + b_reads + c_traffic
        i = _put(v, 40, [_log2(a_reads), _log2(b_reads), _log2(c_traffic),
                         _log2(total), _log2(ws), _log2(min_bytes),
                         total / max(min_bytes, 1.0),        # traffic blowup
                         _log2(b * d["block_k"]),            # burst size
                         _log2(gn),                          # A reuse
                         _log2(gm),                          # B reuse
                         float(out_b == 2)])
    elif wl.kind == "attention":
        S, D = wl.dims
        gq = math.ceil(S / d["block_q"])
        total = b * (4 * S * D) + b * S * D * max(0, gq - 1) * 0.5
        i = _put(v, 40, [_log2(total), _log2(ws), _log2(min_bytes),
                         total / max(min_bytes, 1.0),
                         _log2(b * d["block_kv"] * D)])
    else:
        S, W = wl.dims
        total = min_bytes
        i = _put(v, 40, [_log2(total), _log2(ws), _log2(min_bytes), 1.0,
                         _log2(b * d["block_w"])])

    # --- [72:96) arithmetic intensity / FLOPs
    flops = wl.flops
    i = _put(v, 72, [_log2(flops), flops / max(min_bytes, 1.0) / 1e3,
                     _log2(max(flops / max(min_bytes, 1.0), 1.0)),
                     _log2(wl.count)])

    # --- [96:128) alignment / padding waste
    def align_feats(idx, val, quanta=(8, 64, 128, 256)):
        feats = []
        for q in quanta:
            feats.append(float(val % q == 0))
            feats.append(val / (math.ceil(val / q) * q))
        return _put(v, idx, feats)

    if wl.kind == "matmul":
        M, N, K = wl.dims
        idx = align_feats(96, d["block_m"])
        idx = align_feats(idx, d["block_n"])
        idx = align_feats(idx, d["block_k"], quanta=(128, 512))
        waste = (math.ceil(M / d["block_m"]) * d["block_m"] / M) * \
                (math.ceil(N / d["block_n"]) * d["block_n"] / N) * \
                (math.ceil(K / d["block_k"]) * d["block_k"] / K)
        _put(v, idx, [waste - 1.0])
    elif wl.kind == "attention":
        idx = align_feats(96, d["block_q"])
        idx = align_feats(idx, d["block_kv"])
    else:
        idx = align_feats(96, d["block_w"])
        idx = align_feats(idx, d["chunk"], quanta=(16, 64, 256))

    # --- [128:152) parallelism / pipelining
    if wl.kind == "matmul":
        M, N, K = wl.dims
        par = math.ceil(M / d["block_m"]) * math.ceil(N / d["block_n"])
        seq = math.ceil(K / d["block_k"])
    elif wl.kind == "attention":
        S, D = wl.dims
        par = math.ceil(S / d["block_q"])
        seq = math.ceil(S / d["block_kv"])
    else:
        S, W = wl.dims
        par = math.ceil(W / d["block_w"])
        seq = math.ceil(S / d["chunk"])
    _put(v, 128, [_log2(par), _log2(seq), par / max(par + seq, 1),
                  _log2(d.get("unroll", 1)),
                  float(d.get("stages", 1) == 2),
                  min(par / 8.0, 1.0)])

    # --- [152:164) kind one-hot + bias
    kind_idx = {"matmul": 0, "attention": 1, "scan": 2}[wl.kind]
    v[152 + kind_idx] = 1.0
    v[163] = 1.0
    return v


def batch_features(wls, cfgs) -> np.ndarray:
    return np.stack([extract_features(w, c) for w, c in zip(wls, cfgs)])


class FeatureCache:
    """Memoizes `extract_features` across the tuning loop.

    The tuner evaluates the same configs many times per task — evolutionary
    scoring revisits survivors every round, measured configs are re-featurized
    for every online model update, and the AC prediction-only phase re-scores
    the same frontier. The cache keys on ``(workload.key(), config.knobs)``
    (both hashable and exact), so each distinct (task, config) pair is
    extracted exactly once no matter how many scoring or training passes touch
    it.

    ``hits`` / ``misses`` are plain counters for tests and diagnostics;
    ``misses`` equals the number of real `extract_features` calls made through
    the cache.

    Thread-compatibility: plain dict operations only — safe under CPython for
    the single-threaded tuning loop; create one cache per `tune()` call (or
    per `TuneSession` job) rather than sharing across threads.
    """

    def __init__(self, extractor=None):
        # resolved at call time when None, so a monkeypatched
        # `repro_torch.core.features.extract_features` is honored
        self._extractor = extractor
        self._store: Dict[tuple, np.ndarray] = {}
        self.hits = 0
        self.misses = 0

    def __len__(self) -> int:
        return len(self._store)

    def features(self, wl: Workload, cfg: ProgramConfig) -> np.ndarray:
        """Features for one (workload, config); extracts at most once."""
        key = (wl.key(), cfg.knobs)
        f = self._store.get(key)
        if f is None:
            self.misses += 1
            fn = self._extractor if self._extractor is not None \
                else extract_features
            f = fn(wl, cfg)
            self._store[key] = f
        else:
            self.hits += 1
        return f

    def features_batch(self, wl: Workload, cfgs) -> np.ndarray:
        """Stacked [N, FEATURE_DIM] features for configs of one workload."""
        if not len(cfgs):
            return np.zeros((0, FEATURE_DIM), np.float32)
        return np.stack([self.features(wl, c) for c in cfgs])

    def clear(self):
        self._store.clear()
        self.hits = 0
        self.misses = 0
