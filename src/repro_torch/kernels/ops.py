"""Kernel wrappers wired to the Moses tuning registry (port of
`repro.kernels.ops`).

tuned_matmul / tuned_flash_attention / tuned_rg_lru look up the best config
for their workload on the target device (autotune.registry) and launch the
CUDA kernel with it — the end of the Moses pipeline: adapted cost model ->
tuned config -> kernel launch. `unroll` and `stages` are tuned but read by
no kernel, as in the reference.

Profiling hook: with `REPRO_KERNEL_PROFILE=1` (or `enable_profiling()`)
every tuned dispatch is timed to completion (a `torch.cuda.synchronize()`
for CUDA tensors, which is why it is opt-in) and recorded into the active
registry's `kernel.seconds{kernel=,device=,config=tuned}` histogram, the
same instrument `kernels.profile.profile_kernels` fills for the
tuned-vs-default comparison.
"""
from __future__ import annotations

import os
import time
from typing import Optional

import torch

from repro_torch.autotune.registry import Registry
from repro_torch.autotune.space import Workload
from repro_torch.kernels import flash_attention as fa_mod
from repro_torch.kernels import matmul as mm_mod
from repro_torch.kernels import rg_lru as lru_mod
from repro_torch.kernels.profile import wait_for
from repro_torch.obs import metrics as obs_metrics

_registry: Optional[Registry] = None
_profile_override: Optional[bool] = None


def get_registry() -> Registry:
    global _registry
    if _registry is None:
        _registry = Registry()
    return _registry


def set_registry(r: Registry):
    global _registry
    _registry = r


def enable_profiling(on: bool = True) -> None:
    """Force per-dispatch kernel timing on/off; `reset_profiling()` falls
    back to the REPRO_KERNEL_PROFILE env var."""
    global _profile_override
    _profile_override = bool(on)


def reset_profiling() -> None:
    global _profile_override
    _profile_override = None


def profiling_enabled() -> bool:
    if _profile_override is not None:
        return _profile_override
    return os.environ.get("REPRO_KERNEL_PROFILE", "").strip().lower() in (
        "1", "true", "yes")


def _timed(kernel: str, device: str, out: torch.Tensor, t0: float):
    """Close one profiled dispatch: wait for the result, then record the
    wall time."""
    wait_for(out)
    obs_metrics.current().histogram(
        "kernel.seconds", kernel=kernel, device=device,
        config="tuned").observe(time.perf_counter() - t0)
    return out


def tuned_matmul(a: torch.Tensor, b: torch.Tensor,
                 device: str = "tpu_v5e") -> torch.Tensor:
    """A @ B with the config tuned for `device` (the simulated tuning
    target whose registry entries to use; the tensors' own device decides
    where it runs)."""
    M, K = a.shape
    N = b.shape[1]
    cfg = get_registry().get(device, Workload("matmul", (M, N, K))).as_dict()
    profile = profiling_enabled()
    t0 = time.perf_counter()
    out = mm_mod.matmul(
        a, b, block_m=cfg["block_m"], block_n=cfg["block_n"],
        block_k=cfg["block_k"], k_inner=bool(cfg["k_inner"]),
        out_bf16=bool(cfg["out_bf16"]))
    return _timed("matmul", device, out, t0) if profile else out


def tuned_flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                          causal: bool = True, window: int = 0,
                          device: str = "tpu_v5e") -> torch.Tensor:
    """Flash attention over q, k, v [B, S, D] with the blocks tuned for
    `device`'s attention workload (S, D)."""
    B, S, D = q.shape
    cfg = get_registry().get(device, Workload("attention", (S, D))).as_dict()
    profile = profiling_enabled()
    t0 = time.perf_counter()
    out = fa_mod.flash_attention(q, k, v, causal=causal, window=window,
                                 block_q=cfg["block_q"],
                                 block_kv=cfg["block_kv"])
    return _timed("attention", device, out, t0) if profile else out


def tuned_rg_lru(a: torch.Tensor, x: torch.Tensor,
                 device: str = "tpu_v5e") -> torch.Tensor:
    """The RG-LRU scan over a, x [B, S, W] with the (chunk, block_w) tuned
    for `device`'s scan workload (S, W)."""
    B, S, W = a.shape
    cfg = get_registry().get(device, Workload("scan", (S, W))).as_dict()
    profile = profiling_enabled()
    t0 = time.perf_counter()
    out = lru_mod.rg_lru(a, x, chunk=cfg["chunk"], block_w=cfg["block_w"])
    return _timed("scan", device, out, t0) if profile else out
