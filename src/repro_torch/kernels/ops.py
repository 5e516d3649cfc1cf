"""Kernel wrappers wired to the Moses tuning registry (port of
`repro.kernels.ops`).

tuned_matmul / tuned_flash_attention / tuned_rg_lru look up the best config
for their workload on the target device (autotune.registry) and launch the
CUDA kernel with it — the end of the Moses pipeline: adapted cost model ->
tuned config -> kernel launch. `unroll` and `stages` are tuned but read by
no kernel, as in the reference. The profiling hook waits for the port of
`repro.obs`.
"""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch.autotune.registry import Registry
from repro_torch.autotune.space import Workload
from repro_torch.kernels import flash_attention as fa_mod
from repro_torch.kernels import matmul as mm_mod
from repro_torch.kernels import rg_lru as lru_mod

_registry: Optional[Registry] = None


def get_registry() -> Registry:
    global _registry
    if _registry is None:
        _registry = Registry()
    return _registry


def set_registry(r: Registry):
    global _registry
    _registry = r


def tuned_matmul(a: torch.Tensor, b: torch.Tensor,
                 device: str = "tpu_v5e") -> torch.Tensor:
    """A @ B with the config tuned for `device` (the simulated tuning
    target whose registry entries to use; the tensors' own device decides
    where it runs)."""
    M, K = a.shape
    N = b.shape[1]
    cfg = get_registry().get(device, Workload("matmul", (M, N, K))).as_dict()
    return mm_mod.matmul(
        a, b, block_m=cfg["block_m"], block_n=cfg["block_n"],
        block_k=cfg["block_k"], k_inner=bool(cfg["k_inner"]),
        out_bf16=bool(cfg["out_bf16"]))


def tuned_flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                          causal: bool = True, window: int = 0,
                          device: str = "tpu_v5e") -> torch.Tensor:
    """Flash attention over q, k, v [B, S, D] with the blocks tuned for
    `device`'s attention workload (S, D)."""
    B, S, D = q.shape
    cfg = get_registry().get(device, Workload("attention", (S, D))).as_dict()
    return fa_mod.flash_attention(q, k, v, causal=causal, window=window,
                                  block_q=cfg["block_q"],
                                  block_kv=cfg["block_kv"])


def tuned_rg_lru(a: torch.Tensor, x: torch.Tensor,
                 device: str = "tpu_v5e") -> torch.Tensor:
    """The RG-LRU scan over a, x [B, S, W] with the (chunk, block_w) tuned
    for `device`'s scan workload (S, W)."""
    B, S, W = a.shape
    cfg = get_registry().get(device, Workload("scan", (S, W))).as_dict()
    return lru_mod.rg_lru(a, x, chunk=cfg["chunk"], block_w=cfg["block_w"])
