"""Device fingerprinting: a micro-probe suite over `autotune/devices.py`
(a copy of `repro.hub.fingerprint`: numpy on the simulated devices, so both
packages give the same vector bit for bit).

A new device walks in with no tuning history. Before transferring anything
we need to know *which* known device it behaves like — Eq. 3's
hardware-dependent response is exactly what differs between devices, so we
probe it directly: a fixed suite of ~16 canonical (workload, config) pairs,
each chosen to excite one response axis of the simulator family (MXU
alignment, VMEM spill, launch overhead, burst size, f32-store cost,
accumulation preference, scan chunking). The probe *measurements* go through
the same `measure()` oracle tuning uses, so on real hardware this is ~16
kernel launches — seconds, not the hours a fresh dataset would cost.

The fingerprint is the vector of log-throughputs, centered and L2-normalized:
absolute speed is divided out (a 2x-faster clone of a chip IS that chip for
transfer purposes), leaving the *shape* of the response surface. Similarity
is the cosine of two fingerprints. Probes are deterministic — fixed
workloads, fixed configs, fixed trial seed — so any process computing a
fingerprint for a device gets bit-identical output (`PROBE_VERSION` guards
the suite definition; bump it when probes change so persisted fingerprints
are invalidated together with the store schema).
"""
from __future__ import annotations

from typing import Dict, List, Tuple

import numpy as np

from repro_torch.autotune.devices import measure
from repro_torch.autotune.space import ProgramConfig, Workload

PROBE_VERSION = 1

# fixed trial seed for probe measurements (devices.measure is deterministic
# given (workload, config, device, trial))
_PROBE_TRIAL = 0


def probe_suite() -> List[Tuple[Workload, ProgramConfig]]:
    """The canonical probe set: ~16 (workload, config) pairs spanning the
    simulator's hardware-dependent response axes."""
    mm_big = Workload("matmul", (2048, 2048, 1024), name="probe_mm_big")
    mm_mid = Workload("matmul", (512, 512, 512), name="probe_mm_mid")
    mm_skinny = Workload("matmul", (4096, 128, 256), name="probe_mm_skinny")
    mm_small = Workload("matmul", (128, 128, 128), name="probe_mm_small")
    attn = Workload("attention", (1024, 64), name="probe_attn")
    scan = Workload("scan", (4096, 512), name="probe_scan")

    def mm(bm, bn, bk, k_inner=1, unroll=1, out_bf16=1):
        return ProgramConfig.make(block_m=bm, block_n=bn, block_k=bk,
                                  k_inner=k_inner, unroll=unroll,
                                  out_bf16=out_bf16)

    return [
        # tile-size sweet spot + pipelining (sweet_block, block_sigma)
        (mm_big, mm(512, 512, 256)),
        (mm_big, mm(128, 128, 256)),
        (mm_big, mm(64, 64, 64)),
        # VMEM capacity / spill response (spill_slope, vmem_bytes)
        (mm_big, mm(1024, 1024, 1024, unroll=4)),
        # MXU alignment response (mxu, align_sensitivity)
        (mm_mid, mm(256, 256, 128)),
        (mm_mid, mm(32, 32, 128)),
        # accumulate-in-VMEM vs output-revisit preference (prefer_k_inner)
        (mm_mid, mm(128, 128, 64, k_inner=1)),
        (mm_mid, mm(128, 128, 64, k_inner=0)),
        # f32-store cost (f32_out_penalty)
        (mm_mid, mm(128, 128, 128, out_bf16=0)),
        # burst-size sensitivity (min_burst): tiny k blocks
        (mm_skinny, mm(256, 128, 8)),
        # launch/grid overhead on small work (launch_overhead, grid_overhead)
        (mm_small, mm(32, 32, 32)),
        (mm_small, mm(128, 128, 128)),
        # unroll preference (unroll_sweet)
        (mm_mid, mm(128, 128, 128, unroll=8)),
        # attention pipelining (stages response)
        (attn, ProgramConfig.make(block_q=128, block_kv=128, stages=2,
                                  unroll=1)),
        # recurrent-scan chunk sweet spot (sweet_chunk)
        (scan, ProgramConfig.make(chunk=32, block_w=256, unroll=1)),
        (scan, ProgramConfig.make(chunk=512, block_w=256, unroll=1)),
    ]


def device_fingerprint(device: str, noisy: bool = True) -> np.ndarray:
    """Measure the probe suite on `device` -> normalized fingerprint vector.

    Log-throughputs, centered, L2-normalized: scale-free, so a uniformly
    faster chip with the same response shape fingerprints identically.
    Deterministic across processes (fixed probes, fixed trial seed — the
    simulator's noise is itself seeded by (config, device, trial)).
    """
    thr = np.array([measure(wl, cfg, device, trial=_PROBE_TRIAL, noisy=noisy)
                    for wl, cfg in probe_suite()], np.float64)
    v = np.log2(np.maximum(thr, 1e-12))
    v = v - v.mean()
    n = np.linalg.norm(v)
    return (v / n if n > 0 else v).astype(np.float32)


def fingerprint_similarity(a: np.ndarray, b: np.ndarray) -> float:
    """Cosine similarity of two fingerprints (vectors are unit-norm, but
    renormalize defensively so persisted float32 vectors compare cleanly)."""
    a = np.asarray(a, np.float64)
    b = np.asarray(b, np.float64)
    na, nb = np.linalg.norm(a), np.linalg.norm(b)
    if na == 0 or nb == 0:
        return 0.0
    return float(np.dot(a / na, b / nb))


def rank_by_similarity(target_fp: np.ndarray,
                       known: Dict[str, np.ndarray]
                       ) -> List[Tuple[str, float]]:
    """Known devices ranked by similarity to the target, best first (ties
    break by name for determinism)."""
    return sorted(((d, fingerprint_similarity(target_fp, fp))
                   for d, fp in known.items()),
                  key=lambda t: (-t[1], t[0]))
