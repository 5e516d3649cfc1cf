"""Tensor-program configuration space (TPU-native).

The paper's tensor programs are TVM CUDA schedules; ours are Pallas TPU kernel
configurations. A `Workload` is the mathematical op (the paper's "subgraph" /
"task" granularity); a `ProgramConfig` assigns values to its knobs (the
paper's psi in Psi). See DESIGN.md §2 for the hardware-adaptation mapping.

Knobs per workload kind:
  matmul   : block_m/n/k (MXU tiling), k_inner (accumulate-in-VMEM vs output
             revisits), unroll, out_bf16
  attention: block_q, block_kv, stages
  scan     : chunk, block_w   (recurrent kernels: RG-LRU / mLSTM chunkwise)
"""
from __future__ import annotations

import dataclasses
import hashlib
import itertools
import math
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

POW2 = [8, 16, 32, 64, 128, 256, 512, 1024, 2048]


@dataclasses.dataclass(frozen=True)
class Workload:
    kind: str                  # matmul | attention | scan
    dims: Tuple[int, ...]      # matmul: (M,N,K); attention: (S,D); scan: (S,W)
    name: str = ""
    count: int = 1             # occurrences in the parent model (weighting)
    dtype_bytes: int = 2       # bf16 operands

    @property
    def flops(self) -> float:
        if self.kind == "matmul":
            M, N, K = self.dims
            return 2.0 * M * N * K
        if self.kind == "attention":
            S, D = self.dims
            return 2.0 * 2.0 * S * S * D * 0.5  # causal: half the square
        if self.kind == "scan":
            S, W = self.dims
            return 10.0 * S * W
        raise ValueError(self.kind)

    @property
    def min_hbm_bytes(self) -> float:
        b = self.dtype_bytes
        if self.kind == "matmul":
            M, N, K = self.dims
            return b * (M * K + K * N + M * N)
        if self.kind == "attention":
            S, D = self.dims
            return b * (3 * S * D + S * D)
        if self.kind == "scan":
            S, W = self.dims
            return b * (2 * S * W)
        raise ValueError(self.kind)

    def key(self) -> str:
        return f"{self.kind}:{'x'.join(map(str, self.dims))}"


@dataclasses.dataclass(frozen=True)
class ProgramConfig:
    knobs: Tuple[Tuple[str, int], ...]  # sorted name->value pairs (hashable)

    def get(self, k: str) -> int:
        return dict(self.knobs)[k]

    def as_dict(self) -> Dict[str, int]:
        return dict(self.knobs)

    @staticmethod
    def make(**kw) -> "ProgramConfig":
        return ProgramConfig(tuple(sorted(kw.items())))


def knob_space(wl: Workload) -> Dict[str, List[int]]:
    if wl.kind == "matmul":
        M, N, K = wl.dims
        return {
            "block_m": [v for v in POW2 if v <= max(8, 2 * M)][:8],
            "block_n": [v for v in POW2 if v <= max(8, 2 * N)][:8],
            "block_k": [v for v in POW2 if v <= max(8, 2 * K)][:9],
            "k_inner": [0, 1],
            "unroll": [1, 2, 4, 8],
            "out_bf16": [0, 1],
        }
    if wl.kind == "attention":
        return {
            "block_q": [64, 128, 256, 512, 1024],
            "block_kv": [64, 128, 256, 512, 1024],
            "stages": [1, 2],
            "unroll": [1, 2, 4],
        }
    if wl.kind == "scan":
        return {
            "chunk": [16, 32, 64, 128, 256, 512, 1024],
            "block_w": [128, 256, 512, 1024],
            "unroll": [1, 2, 4],
        }
    raise ValueError(wl.kind)


def vmem_working_set(wl: Workload, cfg: ProgramConfig) -> int:
    """Bytes of VMEM the config claims (the HBM->VMEM->VREG constraint)."""
    b = wl.dtype_bytes
    d = cfg.as_dict()
    if wl.kind == "matmul":
        bm, bn, bk = d["block_m"], d["block_n"], d["block_k"]
        acc = 4  # fp32 accumulator tile
        return b * (bm * bk + bk * bn) * max(1, d["unroll"] // 2) + acc * bm * bn
    if wl.kind == "attention":
        S, D = wl.dims
        bq, bkv = d["block_q"], d["block_kv"]
        return b * (bq * D + 2 * bkv * D) + 4 * (bq * bkv + 2 * bq * D)
    if wl.kind == "scan":
        ck, bw = d["chunk"], d["block_w"]
        return b * (2 * ck * bw) + 4 * bw * 2
    raise ValueError(wl.kind)


def config_valid(wl: Workload, cfg: ProgramConfig,
                 vmem_limit: Optional[int] = None) -> bool:
    d = cfg.as_dict()
    ks = knob_space(wl)
    for k, v in d.items():
        if k not in ks or v not in ks[k]:
            return False
    if vmem_limit is not None and vmem_working_set(wl, cfg) > vmem_limit:
        return False
    return True


def default_config(wl: Workload) -> ProgramConfig:
    """The 'Raw' baseline: vendor-library-like heuristic default."""
    if wl.kind == "matmul":
        return ProgramConfig.make(block_m=128, block_n=128, block_k=128,
                                  k_inner=1, unroll=1, out_bf16=1)
    if wl.kind == "attention":
        return ProgramConfig.make(block_q=128, block_kv=128, stages=1, unroll=1)
    return ProgramConfig.make(chunk=256, block_w=256, unroll=1)


def random_config(wl: Workload, rng: np.random.RandomState) -> ProgramConfig:
    ks = knob_space(wl)
    return ProgramConfig(tuple(sorted(
        (k, int(vs[rng.randint(len(vs))])) for k, vs in ks.items())))


def mutate_config(wl: Workload, cfg: ProgramConfig,
                  rng: np.random.RandomState, n_mut: int = 1) -> ProgramConfig:
    ks = knob_space(wl)
    d = cfg.as_dict()
    keys = list(ks)
    for _ in range(n_mut):
        k = keys[rng.randint(len(keys))]
        vs = ks[k]
        cur = vs.index(d[k]) if d[k] in vs else 0
        # local move in the ordered knob list (Ansor-style neighborhood)
        step = rng.choice([-1, 1])
        d[k] = int(vs[int(np.clip(cur + step, 0, len(vs) - 1))])
    return ProgramConfig(tuple(sorted(d.items())))


def crossover(cfg_a: ProgramConfig, cfg_b: ProgramConfig,
              rng: np.random.RandomState) -> ProgramConfig:
    da, db = cfg_a.as_dict(), cfg_b.as_dict()
    out = {k: (da[k] if rng.rand() < 0.5 else db[k]) for k in da}
    return ProgramConfig(tuple(sorted(out.items())))


def enumerate_space_size(wl: Workload) -> int:
    return int(np.prod([len(v) for v in knob_space(wl).values()]))


def config_hash(wl: Workload, cfg: ProgramConfig) -> int:
    h = hashlib.md5(f"{wl.key()}|{cfg.knobs}".encode()).hexdigest()
    return int(h[:8], 16)


def clip_config_to_space(wl: Workload, cfg: ProgramConfig) -> Optional[ProgramConfig]:
    """Translate a config from a SIMILAR task into this task's knob space
    (cross-task transfer): keep shared knobs, snap values to the nearest
    allowed one, drop if the knob sets don't overlap."""
    ks = knob_space(wl)
    src = cfg.as_dict()
    out = {}
    for k, vs in ks.items():
        if k in src:
            out[k] = int(min(vs, key=lambda v: abs(v - src[k])))
        else:
            return None
    return ProgramConfig(tuple(sorted(out.items())))


def workload_descriptor(wl: Workload) -> "np.ndarray":
    """Small vector for task-similarity (cross-task transfer): kind one-hot +
    log dims (padded)."""
    v = np.zeros(7, np.float32)
    v[{"matmul": 0, "attention": 1, "scan": 2}[wl.kind]] = 1.0
    for i, d in enumerate(wl.dims[:4]):
        v[3 + i] = math.log2(max(d, 1))
    return v
