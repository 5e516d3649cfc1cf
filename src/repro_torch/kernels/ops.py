"""Kernel wrappers wired to the Moses tuning registry (port of
`repro.kernels.ops`).

`tuned_matmul` looks up the best config for its workload on the target
device (autotune.registry) and launches the matmul kernel with that tile —
the end of the Moses pipeline: adapted cost model -> tuned config -> kernel
launch. `unroll` is tuned but read by no kernel, as in the reference.
`tuned_flash_attention` and `tuned_rg_lru` wait for their kernels, and the
profiling hook waits for the port of `repro.obs`.
"""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch.autotune.registry import Registry
from repro_torch.autotune.space import Workload
from repro_torch.kernels import matmul as mm_mod

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
