"""Per-kernel timing probes: tuned-vs-default wall time as histograms (port
of `repro.kernels.profile`).

Runs each of the three kernels (matmul, flash attention, rg_lru) under both
the registry's tuned config and the default config, and records the wall
time per call into

    kernel.seconds{kernel=<k>,device=<dev>,config=tuned|default}

in the active metrics registry (`repro_torch.obs.metrics.current()`). The
serving `Engine(profile_kernels=True)` runs the probe once, on its own
first `generate()`; `kernels/ops.py` additionally times every `tuned_*`
dispatch when `REPRO_KERNEL_PROFILE=1` (or `ops.enable_profiling()`).

The probe tensors' device decides what runs, as in `ops.tuned_*`: on a
card the hand-written kernels (each call timed to a
`torch.cuda.synchronize()`), on the CPU their plain versions. The inputs
are float32, drawn with the reference's `RandomState` draws, so on the card
the matmul and attention take their `simt` variants.

Probe shapes default to small workloads; pass `workloads=` or derive them
from a model config with `model_workloads(cfg)`.
"""
from __future__ import annotations

import time
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from repro_torch.autotune.space import Workload, default_config
from repro_torch.core.placement import TorchDevice, resolve_torch_device
from repro_torch.obs import metrics as obs_metrics

KERNELS: Tuple[str, ...] = ("matmul", "attention", "scan")


def default_workloads(seq: int = 64, width: int = 64,
                      head_dim: int = 32) -> Dict[str, Workload]:
    """One tiny representative workload per kernel (CI-sized)."""
    return {
        "matmul": Workload("matmul", (seq, width, width), name="probe"),
        "attention": Workload("attention", (seq, head_dim), name="probe"),
        "scan": Workload("scan", (seq, width), name="probe"),
    }


def model_workloads(model_cfg, seq: int = 64,
                    cap: int = 128) -> Dict[str, Workload]:
    """Probe workloads shaped like a model's layers, capped so the probe
    stays cheap (the reference caps them for its CPU interpret mode)."""
    d = min(cap, int(getattr(model_cfg, "d_model", cap)) or cap)
    heads = int(getattr(model_cfg, "num_heads", 0)) or 1
    head_dim = int(getattr(model_cfg, "head_dim", 0)) or max(1, d // heads)
    lru = int(getattr(model_cfg, "lru_width", 0)) or d
    return {
        "matmul": Workload("matmul", (seq, d, d), name="probe"),
        "attention": Workload("attention", (seq, min(cap, head_dim)),
                              name="probe"),
        "scan": Workload("scan", (seq, min(cap, lru)), name="probe"),
    }


def _probe_args(kernel: str, wl: Workload, rng: np.random.RandomState,
                dev: torch.device):
    def t(x):
        return torch.tensor(x.astype(np.float32), device=dev)

    if kernel == "matmul":
        M, N, K = wl.dims
        return t(rng.randn(M, K)), t(rng.randn(K, N))
    if kernel == "attention":
        S, D = wl.dims
        return tuple(t(rng.randn(1, S, D)) for _ in range(3))
    S, W = wl.dims
    a = 1.0 / (1.0 + np.exp(-rng.randn(1, S, W))) * 0.98
    return t(a), t(rng.randn(1, S, W))


def _run_kernel(kernel: str, args, cfg: Dict[str, int]) -> torch.Tensor:
    from repro_torch.kernels import flash_attention as fa_mod
    from repro_torch.kernels import matmul as mm_mod
    from repro_torch.kernels import rg_lru as lru_mod
    if kernel == "matmul":
        return mm_mod.matmul(
            args[0], args[1], block_m=cfg["block_m"],
            block_n=cfg["block_n"], block_k=cfg["block_k"],
            k_inner=bool(cfg["k_inner"]), out_bf16=bool(cfg["out_bf16"]))
    if kernel == "attention":
        return fa_mod.flash_attention(
            args[0], args[1], args[2], causal=True,
            block_q=cfg["block_q"], block_kv=cfg["block_kv"])
    return lru_mod.rg_lru(args[0], args[1], chunk=cfg["chunk"],
                          block_w=cfg["block_w"])


def wait_for(out: torch.Tensor) -> torch.Tensor:
    """Return `out` once the card has computed it (the reference's
    `block_until_ready`); a CPU tensor is ready already."""
    if out.is_cuda:
        torch.cuda.synchronize(out.device)
    return out


def profile_kernels(device: str = "tpu_v5e",
                    workloads: Optional[Dict[str, Workload]] = None,
                    registry=None,
                    metrics_registry=None,
                    repeats: int = 1,
                    seed: int = 0,
                    torch_device: TorchDevice = "cuda"
                    ) -> Dict[str, Dict[str, float]]:
    """Time every kernel under its tuned AND default config on
    `torch_device`; record each call into `kernel.seconds{kernel=,device=,
    config=}` histograms.

    Returns `{kernel: {"tuned": mean_s, "default": mean_s}}`. The tuned
    config comes from the kernels' dispatch registry (`kernels.ops`); on a
    device/workload the registry has never seen, tuned == default."""
    from repro_torch.kernels import ops
    dev = resolve_torch_device(torch_device)
    wls = workloads if workloads is not None else default_workloads()
    reg = registry if registry is not None else ops.get_registry()
    mreg = (metrics_registry if metrics_registry is not None
            else obs_metrics.current())
    rng = np.random.RandomState(seed)
    results: Dict[str, Dict[str, float]] = {}
    for kernel in KERNELS:
        wl = wls[kernel]
        args = _probe_args(kernel, wl, rng, dev)
        results[kernel] = {}
        for source in ("default", "tuned"):
            cfg = (default_config(wl) if source == "default"
                   else reg.get(device, wl)).as_dict()
            hist = mreg.histogram("kernel.seconds", kernel=kernel,
                                  device=device, config=source)
            times: List[float] = []
            for _ in range(max(1, int(repeats))):
                t0 = time.perf_counter()
                wait_for(_run_kernel(kernel, args, cfg))
                dt = time.perf_counter() - t0
                hist.observe(dt)
                times.append(dt)
            results[kernel][source] = sum(times) / len(times)
    return results
