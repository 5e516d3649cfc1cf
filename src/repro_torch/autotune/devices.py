"""Simulated device zoo — the Perf() oracle.

This container is CPU-only, so on-device measurement is an analytic TPU
performance model (DESIGN.md §2, assumption #1). Each device computes

    time = max(compute_time, memory_time) + overhead,        then noise

with device-specific non-linear responses (MXU alignment, VMEM spills, launch
overheads, burst sizes). Crucially the simulator family decomposes exactly as
the paper's Eq. 3 assumes:

  hardware-INDEPENDENT structure: arithmetic intensity, reuse, padding waste —
    identical formulas for all devices (the transferable knowledge);
  hardware-DEPENDENT response: mxu size, vmem capacity, bandwidth, overhead
    constants, alignment-penalty shapes — differ per device (what must adapt).

Device roles (paper mapping): tpu_v5p = K80 (source, big dataset);
tpu_v5e = RTX 2060 (same-class target); tpu_edge = Jetson TX2 (embedded-class
target, very different response surface). Beyond the paper, the zoo carries
extra parts (tpu_v5e_pro near-clone, bandwidth-starved tpu_lite, embedded
tpu_edge2) so the transfer hub's fingerprint-based source selection
(src/repro/hub/) has a meaningful neighborhood structure to discover.

A verbatim copy of `repro.autotune.devices` (imports repointed), including
`FaultInjector`, the measurement farm's picklable fault-injection harness.
"""
from __future__ import annotations

import dataclasses
import math
import multiprocessing as mp
import os
import time
from typing import Dict, Optional

import numpy as np

from repro_torch.autotune.space import ProgramConfig, Workload, config_hash, \
    vmem_working_set


@dataclasses.dataclass(frozen=True)
class DeviceModel:
    name: str
    peak_flops: float          # FLOP/s (bf16)
    hbm_bw: float              # bytes/s
    vmem_bytes: int
    mxu: int                   # systolic array dim (128 / 256 / 64)
    launch_overhead: float     # seconds per kernel
    grid_overhead: float       # seconds per grid iteration
    min_burst: int             # bytes; smaller reads waste bandwidth
    spill_slope: float         # memory-time multiplier per x of VMEM overflow
    align_sensitivity: float   # how hard misalignment hurts (0..1)
    unroll_sweet: int          # device-preferred unroll factor
    noise_sigma: float         # lognormal measurement noise
    chip_seed: int = 0
    # hardware-DEPENDENT response shape (what makes transfer non-trivial):
    sweet_block: int = 256     # pipelining/latency-hiding sweet spot (log-gauss)
    block_sigma: float = 2.0   # width of the sweet spot (in octaves)
    prefer_k_inner: int = 1    # accumulate-in-VMEM vs output-revisit preference
    k_inner_penalty: float = 1.2
    f32_out_penalty: float = 1.0  # extra cost of fp32 output writes
    sweet_chunk: int = 256     # recurrent-scan chunk sweet spot


DEVICES: Dict[str, DeviceModel] = {
    # source (plays K80): large, forgiving, big VMEM, likes big tiles
    "tpu_v5p": DeviceModel("tpu_v5p", 459e12, 2765e9, 32 * 2**20, 256,
                           5e-6, 1.5e-7, 512, 1.5, 0.35, 4, 0.03, 11,
                           sweet_block=512, block_sigma=2.2, prefer_k_inner=1,
                           k_inner_penalty=1.15, f32_out_penalty=1.0,
                           sweet_chunk=512),
    # same-generation smaller part (plays RTX 2060): close to the source's
    # response surface -> vanilla fine-tuning mostly works (paper §1)
    "tpu_v5e": DeviceModel("tpu_v5e", 197e12, 819e9, 16 * 2**20, 128,
                           6e-6, 2.0e-7, 256, 2.0, 0.55, 2, 0.04, 23,
                           sweet_block=256, block_sigma=2.0, prefer_k_inner=1,
                           k_inner_penalty=1.2, f32_out_penalty=1.05,
                           sweet_chunk=256),
    "tpu_v4": DeviceModel("tpu_v4", 275e12, 1228e9, 32 * 2**20, 128,
                          6e-6, 2.0e-7, 512, 1.8, 0.45, 4, 0.035, 37,
                          sweet_block=256, block_sigma=2.2, prefer_k_inner=1,
                          k_inner_penalty=1.15, sweet_chunk=256),
    "tpu_v6e": DeviceModel("tpu_v6e", 918e12, 1640e9, 32 * 2**20, 256,
                           5e-6, 1.2e-7, 512, 1.6, 0.40, 8, 0.03, 53,
                           sweet_block=512, block_sigma=2.4, prefer_k_inner=1,
                           k_inner_penalty=1.1, sweet_chunk=512),
    # embedded-class (plays Jetson TX2): tiny VMEM, harsh alignment response,
    # large overheads, and a QUALITATIVELY different optimum structure (small
    # tiles, no in-VMEM accumulation, bf16 stores) -> vanilla fine-tuning
    # from the source misranks candidates (the paper's failure mode)
    "tpu_edge": DeviceModel("tpu_edge", 8e12, 68e9, 2 * 2**20, 64,
                            60e-6, 8e-7, 128, 4.0, 0.9, 1, 0.06, 71,
                            sweet_block=64, block_sigma=1.1, prefer_k_inner=0,
                            k_inner_penalty=1.5, f32_out_penalty=1.35,
                            sweet_chunk=32),
    # --- transfer-hub zoo extensions: devices whose fingerprints make
    # nearest-source selection non-trivial (hub/fingerprint.py) -------------
    # speed-binned near-clone of tpu_v5e: ~8% faster clocks/bandwidth but
    # the SAME response surface (sweet spots, alignment, penalties). The
    # fingerprint is scale-free, so this must rank as tpu_v5e's nearest
    # neighbor — the case where warm-starting is essentially free.
    "tpu_v5e_pro": DeviceModel("tpu_v5e_pro", 213e12, 885e9, 16 * 2**20, 128,
                               6e-6, 2.0e-7, 256, 2.0, 0.55, 2, 0.04, 97,
                               sweet_block=256, block_sigma=2.0,
                               prefer_k_inner=1, k_inner_penalty=1.2,
                               f32_out_penalty=1.05, sweet_chunk=256),
    # bandwidth-starved inference part: a respectable MXU behind an anemic
    # memory system (LPDDR-class bandwidth, small VMEM, harsh burst floor).
    # Almost every workload is memory-bound, so its response surface sits
    # between the edge chips and the datacenter parts — small k blocks,
    # bf16 stores, no in-VMEM accumulation win here.
    "tpu_lite": DeviceModel("tpu_lite", 45e12, 102e9, 4 * 2**20, 128,
                            20e-6, 5e-7, 512, 3.0, 0.7, 2, 0.05, 113,
                            sweet_block=128, block_sigma=1.5,
                            prefer_k_inner=0, k_inner_penalty=1.35,
                            f32_out_penalty=1.25, sweet_chunk=64),
    # second-generation embedded chip: same qualitative regime as tpu_edge
    # (tiny VMEM, huge launch overheads, small-tile optima) with modestly
    # better alignment handling — tpu_edge's natural nearest neighbor, and
    # the canary that embedded targets select embedded sources rather than
    # the big forgiving datacenter corpus.
    "tpu_edge2": DeviceModel("tpu_edge2", 13e12, 102e9, 2 * 2**20, 64,
                             45e-6, 7e-7, 128, 3.8, 0.85, 1, 0.055, 127,
                             sweet_block=64, block_sigma=1.2,
                             prefer_k_inner=0, k_inner_penalty=1.45,
                             f32_out_penalty=1.3, sweet_chunk=32),
}


def _sweet_eff(block: int, dev: DeviceModel) -> float:
    """Device-preferred tile size (latency-hiding / register-file shape):
    log-gaussian efficiency peaking at dev.sweet_block."""
    d = (math.log2(max(block, 1)) - math.log2(dev.sweet_block)) / dev.block_sigma
    return 0.35 + 0.65 * math.exp(-0.5 * d * d)


def _align_eff(block: int, mxu: int, sensitivity: float) -> float:
    """Efficiency of mapping a tile dim onto the systolic array."""
    if block >= mxu:
        frac = block / (math.ceil(block / mxu) * mxu)
    else:
        frac = block / mxu  # under-utilized rows/cols
    return (1 - sensitivity) + sensitivity * frac


def _grid(total: int, block: int) -> int:
    return max(1, math.ceil(total / block))


def execution_time(wl: Workload, cfg: ProgramConfig, dev: DeviceModel,
                   noisy: bool = True, trial: int = 0) -> float:
    """Simulated wall-clock seconds for one kernel execution."""
    d = cfg.as_dict()
    b = wl.dtype_bytes

    if wl.kind == "matmul":
        M, N, K = wl.dims
        bm, bn, bk = d["block_m"], d["block_n"], d["block_k"]
        gm, gn, gk = _grid(M, bm), _grid(N, bn), _grid(K, bk)
        # padding waste: padded dims do useless MXU work
        waste = (gm * bm / M) * (gn * bn / N) * (gk * bk / K)
        eff = (_align_eff(bm, dev.mxu, dev.align_sensitivity)
               * _align_eff(bn, dev.mxu, dev.align_sensitivity)
               * _align_eff(bk, 128, dev.align_sensitivity * 0.5)
               * _sweet_eff(bm, dev) * _sweet_eff(bn, dev))
        # pipeline efficiency: deep grids + device-preferred unroll hide latency
        ur = d["unroll"]
        ur_eff = 1.0 - 0.15 * abs(math.log2(ur) - math.log2(dev.unroll_sweet)) \
            / 3.0
        pipe_eff = min(1.0, (gm * gn * gk) / 8.0) * ur_eff
        compute = wl.flops * waste / (dev.peak_flops * eff * max(pipe_eff, .05))
        if d["k_inner"] != dev.prefer_k_inner:
            compute *= dev.k_inner_penalty

        # memory traffic: A streamed gn times unless k_inner revisits instead
        if d["k_inner"]:
            a_reads = M * K * gn
            b_reads = K * N * gm
            c_traffic = M * N * (2 if False else 1)
        else:
            a_reads = M * K * gn
            b_reads = K * N * gm
            c_traffic = M * N * (2 * gk - 1)  # output revisited per k block
        out_b = 2 if d["out_bf16"] else 4
        bytes_hbm = b * (a_reads + b_reads) + out_b * c_traffic
        burst_pen = 1.0 + max(0.0, dev.min_burst / (bk * b) - 1.0) * 0.5
        if not d["out_bf16"]:
            burst_pen *= dev.f32_out_penalty
        memory = bytes_hbm * burst_pen / dev.hbm_bw

        ws = vmem_working_set(wl, cfg)
        if ws > dev.vmem_bytes:
            memory *= 1.0 + dev.spill_slope * (ws / dev.vmem_bytes - 1.0)
        grid_iters = gm * gn * gk
    elif wl.kind == "attention":
        S, D = wl.dims
        bq, bkv = d["block_q"], d["block_kv"]
        gq, gkv = _grid(S, bq), _grid(S, bkv)
        pairs = gq * (gkv + 1) / 2  # causal
        eff = (_align_eff(min(bq, 512), dev.mxu, dev.align_sensitivity)
               * _align_eff(D, dev.mxu, dev.align_sensitivity * 0.5))
        stages = d["stages"]
        pipe = min(1.0, pairs / 4.0) * (1.0 if stages == 2 else 0.8)
        compute = wl.flops / (dev.peak_flops * eff * max(pipe, .05))
        bytes_hbm = b * (S * D * 3 + S * D) + b * (S * D) * max(0, gq - 1) * 0.5
        memory = bytes_hbm / dev.hbm_bw
        ws = vmem_working_set(wl, cfg)
        if ws > dev.vmem_bytes:
            memory *= 1.0 + dev.spill_slope * (ws / dev.vmem_bytes - 1.0)
        grid_iters = pairs
    elif wl.kind == "scan":
        S, W = wl.dims
        ck, bw = d["chunk"], d["block_w"]
        gc, gw = _grid(S, ck), _grid(W, bw)
        # sequential across chunks; parallel across width blocks
        eff = _align_eff(bw, 128, dev.align_sensitivity)
        dch = (math.log2(max(ck, 1)) - math.log2(dev.sweet_chunk))
        eff *= 0.4 + 0.6 * math.exp(-0.5 * (dch / dev.block_sigma) ** 2)
        compute = wl.flops / (dev.peak_flops * 0.05 * eff)  # VPU-bound
        seq_pen = 1.0 + 0.3 * math.log2(max(gc, 1)) / 10.0 * (
            dev.launch_overhead / 5e-6)
        compute *= seq_pen
        bytes_hbm = wl.min_hbm_bytes
        memory = bytes_hbm / dev.hbm_bw
        ws = vmem_working_set(wl, cfg)
        if ws > dev.vmem_bytes:
            memory *= 1.0 + dev.spill_slope * (ws / dev.vmem_bytes - 1.0)
        grid_iters = gc * gw
    else:
        raise ValueError(wl.kind)

    t = max(compute, memory) + dev.launch_overhead + dev.grid_overhead * grid_iters
    if noisy:
        seed = (config_hash(wl, cfg) ^ dev.chip_seed ^ (trial * 2654435761)) \
            % (2**31)
        rng = np.random.RandomState(seed)
        t *= float(np.exp(rng.randn() * dev.noise_sigma))
    return t


def measure(wl: Workload, cfg: ProgramConfig, device: str,
            trial: int = 0, noisy: bool = True) -> float:
    """The paper's Perf(): returns throughput in GFLOP/s."""
    dev = DEVICES[device]
    t = execution_time(wl, cfg, dev, noisy=noisy, trial=trial)
    return wl.flops / t / 1e9


class InjectedCrash(RuntimeError):
    """A FaultInjector-simulated hard fault (the in-process stand-in for a
    segfault when the measurement runs on the thread backend)."""


@dataclasses.dataclass
class FaultInjector:
    """Deterministic fault injection wrapped around `measure`.

    The measurement-farm test harness: a drop-in ``measure_fn`` that makes
    a seed-keyed subset of (workload, config, trial) identities hostile —
    the failure modes real boards exhibit — while every healthy identity
    returns exactly what the plain simulator would. Which fault (if any)
    hits an identity is a pure function of ``(config_hash, trial, seed)``,
    never of call order, thread, or process: a test can pre-compute the
    fault map with `fault_for` in the parent, and a replay under spawn
    workers injects the identical faults.

    Fault kinds, drawn disjointly by cumulative probability:

      crash  — worker death. In a farm worker (``kill_process=True`` and
               actually inside a child process) the worker hard-exits,
               simulating a segfault; otherwise raises `InjectedCrash`.
      hang   — sleeps ``hang_s`` (longer than any test timeout) before
               answering: the wedged-board case the watchdog must kill.
      flaky  — raises OSError on the FIRST attempt per worker, succeeds on
               retry: the transient the executor's backoff must absorb.
      slow   — sleeps ``slow_s`` then answers correctly: degraded but
               healthy (must NOT be quarantined by a generous timeout).

    Instances are picklable (the process backend ships them to spawn
    workers); `_flaky_seen` is per-process state, which is exactly right —
    a respawned worker retries afresh, like a power-cycled board.
    """

    crash: float = 0.0
    hang: float = 0.0
    flaky: float = 0.0
    slow: float = 0.0
    seed: int = 0
    hang_s: float = 60.0
    slow_s: float = 0.25
    kill_process: bool = False
    _flaky_seen: set = dataclasses.field(default_factory=set, repr=False)

    def fault_for(self, wl: Workload, cfg: ProgramConfig,
                  trial: int = 0) -> Optional[str]:
        """The fault this identity draws: 'crash'|'hang'|'flaky'|'slow'|None.
        Deterministic and process-independent (md5-backed config_hash)."""
        h = (config_hash(wl, cfg) ^ (trial * 2654435761)
             ^ (self.seed * 40503)) % (2 ** 31)
        u = float(np.random.RandomState(h).rand())
        for kind, p in (("crash", self.crash), ("hang", self.hang),
                        ("flaky", self.flaky), ("slow", self.slow)):
            if u < p:
                return kind
            u -= p
        return None

    def __call__(self, wl: Workload, cfg: ProgramConfig, device: str,
                 trial: int = 0) -> float:
        kind = self.fault_for(wl, cfg, trial)
        if kind == "crash":
            if self.kill_process and mp.parent_process() is not None:
                # in a farm worker: die the way a segfault would — no
                # exception, no cleanup, no result message
                os._exit(139)
            raise InjectedCrash(
                f"injected crash for {wl.key()} trial {trial}")
        if kind == "hang":
            time.sleep(self.hang_s)
        elif kind == "flaky":
            key = (config_hash(wl, cfg), trial)
            if key not in self._flaky_seen:
                self._flaky_seen.add(key)
                raise OSError(
                    f"injected transient fault for {wl.key()} trial {trial}")
        elif kind == "slow":
            time.sleep(self.slow_s)
        return measure(wl, cfg, device, trial=trial)


def measurement_seconds(wl: Workload, cfg: ProgramConfig, device: str,
                        n_repeats: int = 3) -> float:
    """Wall-clock cost of one on-device measurement trial (drives the paper's
    search-time accounting: compile + transfer + n_repeats executions)."""
    dev = DEVICES[device]
    t = execution_time(wl, cfg, dev, noisy=False)
    # embedded parts pay a much larger compile + transfer toll per trial
    compile_and_xfer = 1.2 if device in ("tpu_edge", "tpu_edge2") else 0.3
    return compile_and_xfer + n_repeats * t
