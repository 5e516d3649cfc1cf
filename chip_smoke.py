#!/usr/bin/env python3
"""Chip smoke test of the PyTorch port on one NVIDIA card.

    python3 chip_smoke.py

Builds the port's CUDA kernels (matmul and flash attention in two variants
each, wgmma and simt; RG-LRU scan) from the five sources in this checkout,
one nvcc each, all started together; holds each kernel against its plain
PyTorch version on the card over its knob corners, each matmul and
attention case naming the variant it ran; then drives three paths through
the port's entry points at full width, each with the launch counts set to 0
just before it and read just after, and asserts that every GEMM of the
first two paths, and their attention, ran the wgmma variant:

  ResNet-18 (the Moses main path)
    1. pre-train the paper's cost model (164 -> 512 -> 512 -> 1) on
       simulated tpu_v5p records, as examples/quickstart.py does;
    2. tune all 12 ResNet-18 GEMMs for tpu_v5e under `moses` into a
       temporary registry;
    3. launch the matmul kernel with each tuned tile at the GEMM's real
       shape on bf16 operands, and check and time it.
  RecurrentGemma-2B (the LM-architecture autotune path)
    1. `repro_torch.launch.train.maybe_autotune` pre-trains the cost model
       and tunes the model's 9 tasks (7 GEMMs, local attention, RG-LRU scan)
       for tpu_v5e under `moses`, 48 trials each;
    2. `ops.tuned_matmul` / `tuned_flash_attention` / `tuned_rg_lru` launch
       each task's kernel with its tuned config at the model's real shapes
       on bf16 operands, and each is checked and timed.

A third path serves the full RecurrentGemma-2B config (26 layers, d_model
2560, vocab 256000; float32 params from seed 0, bf16 activations) with
`serve.Engine(batch_slots=4, profile_kernels=True)`: 8 greedy requests of
512 prompt tokens and 32 new tokens, in two waves, with the launch counts
set to 0 before the engine is made and read after `generate`. The engine's
kernel probe launches each kernel once per config (float32 probe inputs:
matmul and attention `simt`, the scan `tma`); each is then held against
its plain version at the probe's shapes. The `serve_path` line gives the
prefill and step seconds, tokens/s, peak memory and the data-sheet bounds;
`serve_consistency` holds decode's logits to `forward`'s at float32
activations for prompts of 512 and 2048 (= local_window, so the ring
wraps).

Kernel times come two ways: `ms`, CUDA events around calls launched back
to back (where a kernel is faster than its wrapper's host work, that is the
host's time), and `device_ms`, the same calls captured into one CUDA graph
and replayed, which the host cannot pace. The library call gets both too.

Every phase prints one JSON line. The line before the last is the card's
name and power limit as nvidia-smi prints them; the last line is
{"ok": true, "device": {...}}. Exits non-zero, and prints no result, without
a CUDA card or outside a checkout of the repository. Imports nothing of JAX.
"""
import collections
import dataclasses
import json
import os
import statistics
import subprocess
import sys
import tempfile
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
TPU_KERNEL = "src/repro/kernels/matmul.py"

# H100 SXM (NVIDIA's data sheet, dense): the bound of a kernel is the larger
# of its operations over the input type's peak and its bytes over HBM rate
PEAK_FLOPS = {"bfloat16": 989e12, "float32": 67e12}
HBM_BYTES_PER_S = 3.35e12
TOLERANCE = ("float32 out: |err| <= 1e-5 * max|plain| + 1e-5 * |plain|; "
             "bf16 out: |err| <= one bf16 ulp at max|plain|")
# the reference's own attention and scan tolerances (tests/test_kernels.py):
# float32 differs from the plain version in summation order and exp's last
# bits; with bf16 inputs P is rounded to bf16, and a p that lands on the
# other side of a rounding boundary moves the output by up to a bf16 ulp of
# p times |v|
ATTN_TOL = {"float32": 1e-4, "bfloat16": 3e-2}
ATTN_TOLERANCE = ("|err| <= tol + tol * |plain|, tol = 1e-4 for float32 "
                  "and 3e-2 for bf16 inputs")
# the scan multiplies then adds, each rounded, in both versions
SCAN_TOLERANCE = "|err| <= 1e-5 + 1e-4 * |plain|"
SOURCES = ("matmul", "matmul_wgmma", "flash_attention",
           "flash_attention_wgmma", "rg_lru")


def emit(phase: str, **kw) -> None:
    print(json.dumps({"phase": phase, **kw}), flush=True)


def nvidia_smi() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip()


def bf16_ulp(x: float) -> float:
    import math
    return 2.0 ** (math.floor(math.log2(max(x, 1e-30))) - 7)


def check_close(got, want, out_bf16: bool, what: str) -> float:
    """Kernel vs plain version within TOLERANCE: float32 outputs differ
    only in summation order; bf16 outputs round at the same points, so
    they differ by at most one ulp where a float32 value falls on the other
    side of a rounding boundary. Returns the max abs error; raises on a
    mismatch."""
    import torch
    got, want = got.float(), want.float()
    assert got.shape == want.shape, (what, got.shape, want.shape)
    assert bool(torch.isfinite(got).all()), f"{what}: non-finite output"
    top = float(want.abs().max())
    err = (got - want).abs()
    if out_bf16:
        ok = bool((err <= bf16_ulp(top)).all())
    else:
        ok = bool((err <= 1e-5 * top + 1e-5 * want.abs()).all())
    max_err = float(err.max())
    assert ok, f"{what}: kernel disagrees with plain (max abs err {max_err})"
    return max_err


def check_allclose(got, want, rtol: float, atol: float, what: str) -> float:
    """|got - want| <= atol + rtol * |want| everywhere; returns the max abs
    error, raises on a mismatch."""
    import torch
    got, want = got.float(), want.float()
    assert got.shape == want.shape, (what, got.shape, want.shape)
    assert bool(torch.isfinite(got).all()), f"{what}: non-finite output"
    err = (got - want).abs()
    max_err = float(err.max())
    assert bool((err <= atol + rtol * want.abs()).all()), \
        f"{what}: kernel disagrees with plain (max abs err {max_err})"
    return max_err


def time_ms(fn, reps: int, inner: int) -> float:
    """Median over `reps` of the CUDA-event time of `inner` back-to-back
    calls, divided by `inner`. Inputs stay warm in L2 between calls."""
    import torch
    fn()
    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(inner):
            fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end) / inner)
    return statistics.median(times)


def device_ms(fn, reps: int, inner: int) -> float:
    """Median over `reps` of the CUDA-event time of one replay of a CUDA
    graph that holds `inner` calls of `fn`, divided by `inner`: the
    device's time per call, which the host's launch work cannot pace.
    Inputs stay warm in L2 between calls. `fn` must be capturable: no
    synchronisation, no host read of device memory."""
    import torch
    fn()
    torch.cuda.synchronize()
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):  # warm up off the default stream
        fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(inner):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        graph.replay()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end) / inner)
    graph.reset()
    return statistics.median(times)


def host_us(fn, calls: int) -> float:
    """The host's time per call of `fn`, without a synchronisation: what
    the wrapper costs the host. Where a kernel's device time is below it,
    the host paces the back-to-back reading."""
    import torch
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(calls):
        fn()
    us = (time.perf_counter() - t0) / calls * 1e6
    torch.cuda.synchronize()
    return us


def plan_fields(mm, M: int, N: int, K: int, knobs: dict) -> dict:
    """The matmul launch plan of one GEMM, as its line reports it."""
    import torch
    p = mm.plan(M, N, K, torch.bfloat16, knobs["block_m"], knobs["block_n"],
                knobs["block_k"], bool(knobs["k_inner"]),
                bool(knobs["out_bf16"]))
    return {"variant": p.variant, "cta_tile": [p.cta_m, p.cta_n],
            "raster_group": [p.group_m, p.group_n], "splits": p.splits,
            "ctas": p.ctas, "pad_bytes": p.pad_bytes}


def matmul_floor_ms(M: int, N: int, K: int, in_dtype: str, out_bf16: bool):
    """(bytes_ms, ops_ms) for one GEMM on an H100 SXM: each input read once
    and the output written once over the HBM rate, and 2MNK over the input
    type's peak. The bound is the larger of the two."""
    in_b = 2 if in_dtype == "bfloat16" else 4
    moved = (M * K + K * N) * in_b + M * N * (2 if out_bf16 else 4)
    return (moved / HBM_BYTES_PER_S * 1e3,
            2.0 * M * N * K / PEAK_FLOPS[in_dtype] * 1e3)


def attention_floor_ms(B: int, S: int, D: int, in_dtype: str,
                       causal: bool):
    """(bytes_ms, ops_ms) for flash attention on an H100 SXM: q, k, v read
    once and the float32 output written once over the HBM rate, and
    4 * B * S^2 * D FLOPs (halved when causal) over the input type's
    peak."""
    in_b = 2 if in_dtype == "bfloat16" else 4
    moved = 3 * B * S * D * in_b + B * S * D * 4
    flops = 4.0 * B * S * S * D * (0.5 if causal else 1.0)
    return (moved / HBM_BYTES_PER_S * 1e3,
            flops / PEAK_FLOPS[in_dtype] * 1e3)


def scan_floor_ms(B: int, S: int, W: int, in_dtype: str):
    """(bytes_ms, ops_ms) for the RG-LRU scan on an H100 SXM: a and x read
    once and the float32 output written once, and 2 FLOPs per element at
    the float32 rate (the carry is float32)."""
    in_b = 2 if in_dtype == "bfloat16" else 4
    moved = 2 * B * S * W * in_b + B * S * W * 4
    return (moved / HBM_BYTES_PER_S * 1e3,
            2.0 * B * S * W / PEAK_FLOPS["float32"] * 1e3)


def bound_of(bytes_ms: float, ops_ms: float):
    """(bound_ms, bound_by)."""
    return max(bytes_ms, ops_ms), ("bytes" if bytes_ms >= ops_ms
                                   else "operations")


def expected_variant(dtype: str, K: int, knobs: dict) -> str:
    """The matmul variant the stated rule gives: simt for float32 inputs
    and for k_inner=0 with a bf16 output whose rounding unit bk splits a
    16-deep wgmma step (bk % 16 != 0 and bk < K); wgmma otherwise."""
    bk = min(knobs["block_k"], K)
    rounds = not knobs["k_inner"] and knobs["out_bf16"]
    if dtype == "float32" or (rounds and bk % 16 != 0 and bk < K):
        return "simt"
    return "wgmma"


def ran_variant(counts: dict, call):
    """(result, the variant whose count in `counts`, a wrapper's
    `launches_by_variant`, `call` raised)."""
    before = dict(counts)
    out = call()
    moved = [v for v, n in counts.items() if n != before[v]]
    assert len(moved) == 1, (before, counts)
    return out, moved[0]


def expected_attention_variant(dtype: str, D: int) -> str:
    """The flash attention variant the stated rule gives: wgmma for bf16
    inputs with D % 8 == 0 (TMA's 16-byte rows), simt otherwise."""
    return "wgmma" if dtype == "bfloat16" and D % 8 == 0 else "simt"


def kernel_check(mm, torch_device: str) -> dict:
    """Every case: CUDA matmul vs matmul_plain on the card, and the variant
    it ran against the stated rule (`expected_variant`)."""
    import torch
    gen = torch.Generator(device=torch_device).manual_seed(0)
    cases = []
    for shape in [(64, 64, 64), (128, 96, 32), (100, 60, 36), (33, 17, 9),
                  (256, 128, 64)]:
        cases.append((shape, (32, 32, 16)))
    cases.append(((70, 50, 100), (64, 16, 24)))        # odd block_k
    cases.append(((1100, 1030, 2100), (1024, 1024, 2048)))  # largest knobs
    cases.append(((200, 136, 72), (8, 8, 8)))          # smallest knobs
    cases.append(((1, 1000, 512), (8, 8, 8)))          # M = 1 (fc)
    cases.append(((1, 1000, 512), (1024, 1024, 1024)))
    # the wgmma variant's edges: K = 147 (padding), M = 49 with split-K,
    # rounding boundaries inside a 64-deep stage
    cases.append(((12544, 64, 147), (128, 64, 256)))   # ResNet-18 stem
    cases.append(((49, 512, 4608), (64, 128, 128)))    # split-K
    for bk in (16, 32, 48):
        cases.append(((128, 256, 192), (64, 64, bk)))
    n, worst, ran = 0, 0.0, []
    for (M, N, K), (bm, bn, bk) in cases:
        for dtype in (torch.float32, torch.bfloat16):
            a = torch.randn((M, K), generator=gen, device=torch_device).to(
                dtype)
            b = torch.randn((K, N), generator=gen, device=torch_device).to(
                dtype)
            name = str(dtype).split(".")[1]
            for k_inner in (True, False):
                for out_bf16 in (False, True):
                    knobs = dict(block_m=bm, block_n=bn, block_k=bk,
                                 k_inner=k_inner, out_bf16=out_bf16)
                    got, variant = ran_variant(
                        mm.matmul.launches_by_variant,
                        lambda: mm.matmul(a, b, **knobs))
                    want = mm.matmul_plain(a, b, **knobs)
                    what = f"{(M, N, K)} {name} {knobs}"
                    worst = max(worst, check_close(got, want, out_bf16, what))
                    assert variant == expected_variant(name, K, knobs), \
                        (what, variant)
                    out = "bf16" if out_bf16 else "f32"
                    ran.append(f"{M}x{N}x{K}/{bm}x{bn}x{bk}/{name}/"
                               f"k{int(k_inner)}/o{out}:{variant}")
                    n += 1
    torch.cuda.synchronize()
    by_variant = {v: sum(r.endswith(v) for r in ran) for v in ("wgmma", "simt")}
    return {"cases": n, "by_variant": by_variant, "max_abs_err": worst,
            "ran": ran, "timed": kouter_timing(mm)}


def kouter_timing(mm) -> list:
    """Both accumulation orders timed at one stated shape, RecurrentGemma-
    2B's out_proj (512 x 2560 x 2560), tile 128 x 128 x 128, bf16 operands
    and output, back to back and from a CUDA graph, beside the plain
    version and torch.matmul."""
    import torch
    M, N, K = 512, 2560, 2560
    gen = torch.Generator(device="cuda").manual_seed(2)
    a = torch.randn((M, K), generator=gen, device="cuda").to(torch.bfloat16)
    b = torch.randn((K, N), generator=gen, device="cuda").to(torch.bfloat16)
    bound_ms, bound_by = bound_of(*matmul_floor_ms(M, N, K, "bfloat16", True))
    rows = []
    for k_inner in (False, True):
        knobs = dict(block_m=128, block_n=128, block_k=128, k_inner=k_inner,
                     out_bf16=True)
        _, variant = ran_variant(mm.matmul.launches_by_variant,
                                 lambda: mm.matmul(a, b, **knobs))
        rows.append({
            "dims": [M, N, K], "knobs": knobs, "variant": variant,
            "ms": time_ms(lambda: mm.matmul(a, b, **knobs), reps=7, inner=5),
            "device_ms": device_ms(lambda: mm.matmul(a, b, **knobs), reps=7,
                                   inner=5),
            "plain_ms": time_ms(lambda: mm.matmul_plain(a, b, **knobs),
                                reps=3, inner=1),
            "library_ms": time_ms(lambda: torch.matmul(a, b), reps=7,
                                  inner=10),
            "library_device_ms": device_ms(lambda: torch.matmul(a, b),
                                           reps=7, inner=10),
            "bound_ms": bound_ms, "bound_by": bound_by})
    return rows


def attention_check(fa, torch_device: str) -> dict:
    """Every case: CUDA flash attention vs flash_attention_plain on the
    card. Cases are (B, S, D, causal, window, block_q, block_kv, scale),
    each in float32 and bf16."""
    import torch
    gen = torch.Generator(device=torch_device).manual_seed(3)
    cases = []
    for S in (64, 100, 128):  # the CPU tests' sweep
        for causal, window in ((True, 0), (True, 16), (False, 0),
                               (False, 16)):
            cases.append((2, S, 32, causal, window, 32, 32, None))
    for D in (80, 120, 192, 256):
        cases.append((2, 64, D, True, 0, 32, 32, None))
    cases.append((2, 100, 32, True, 0, 64, 32, None))    # uneven blocks
    cases.append((2, 100, 32, True, 16, 32, 32, 0.3))    # explicit scale
    for window in (0, 300):                              # the knob corners
        cases.append((2, 2048, 256, True, window, 1024, 1024, None))
    cases.append((2, 2048, 256, True, 0, 64, 1024, None))
    cases.append((3, 1, 64, True, 0, 64, 64, None))      # S = 1
    for D in (64, 80, 120, 128, 192, 256):               # the LM zoo's D
        cases.append((2, 512, D, True, 0, 128, 256, None))
    cases.append((12, 128, 64, False, 0, 64, 128, None))  # BERT-base
    # the wgmma variant's 128-row q tile (B * ceil(S / 128) >= 132): two
    # consumer warpgroups, D padded (80), a window, no causal mask
    cases.append((40, 512, 256, True, 0, 256, 512, None))
    cases.append((36, 512, 64, True, 100, 128, 128, None))
    cases.append((33, 512, 80, False, 0, 128, 128, None))
    # the same with ragged S (300 = 2 x 128 + 44), causal or windowed
    cases.append((45, 300, 128, True, 0, 128, 128, None))
    cases.append((45, 300, 120, False, 50, 128, 128, None))
    cases.append((2, 100, 36, True, 16, 32, 32, None))   # D % 8 != 0: simt
    worst, ran = {"float32": 0.0, "bfloat16": 0.0}, []
    by_variant = collections.Counter(wgmma=0, simt=0)
    for B, S, D, causal, window, bq, bkv, scale in cases:
        for dtype in (torch.float32, torch.bfloat16):
            q, k, v = (torch.randn((B, S, D), generator=gen,
                                   device=torch_device).to(dtype)
                       for _ in range(3))
            kw = dict(causal=causal, window=window, block_q=bq,
                      block_kv=bkv, scale=scale)
            got, variant = ran_variant(
                fa.flash_attention.launches_by_variant,
                lambda: fa.flash_attention(q, k, v, **kw))
            want = fa.flash_attention_plain(q, k, v, **kw)
            name = str(dtype).split(".")[1]
            tol = ATTN_TOL[name]
            what = f"attention {(B, S, D)} {name} {kw}"
            worst[name] = max(worst[name], check_allclose(
                got, want, tol, tol, what))
            assert variant == expected_attention_variant(name, D), \
                (what, variant)
            by_variant[variant] += 1
            p = fa.plan(B, S, D, dtype, bq, bkv, causal, window)
            ran.append(f"{B}x{S}x{D}/c{int(causal)}w{window}/{bq}x{bkv}/"
                       f"{name}:{variant}/q{p.q_tile}")
    torch.cuda.synchronize()
    return {"cases": len(ran), "by_variant": by_variant,
            "max_abs_err": worst, "ran": ran}


def scan_inputs(B: int, S: int, W: int, dtype, gen, torch_device: str):
    """Decays in (0, 0.98) and standard normal inputs, as the tests draw
    them."""
    import torch
    a = torch.sigmoid(torch.randn((B, S, W), generator=gen,
                                  device=torch_device)) * 0.98
    x = torch.randn((B, S, W), generator=gen, device=torch_device)
    return a.to(dtype), x.to(dtype)


def scan_check(lru, torch_device: str) -> dict:
    """Every case: CUDA RG-LRU scan vs rg_lru_plain on the card. Cases are
    ((B, S, W), chunk, block_w, dtype)."""
    import torch
    gen = torch.Generator(device=torch_device).manual_seed(4)
    f32, bf16 = torch.float32, torch.bfloat16
    cases = [(shape, ck, bw, f32)  # the CPU tests' sweep
             for shape in ((2, 64, 64), (1, 50, 100), (3, 33, 17))
             for ck, bw in ((16, 32), (64, 64), (8, 128))]
    cases += [((1, 2048, 2560), 1024, 1024, f32),   # the knob corner
              ((2, 100, 17), 16, 128, f32),         # W = 17
              ((4, 1, 300), 16, 128, f32),          # S = 1
              ((2, 100, 300), 32, 128, bf16),       # bf16 inputs
              ((1, 2048, 2560), 1024, 1024, bf16),
              ((1, 12544, 32), 256, 128, f32)]      # MobileNet dw3x3_32_112
    worst, ran = 0.0, []
    by_route = collections.Counter(tma=0, ldg=0)
    for (B, S, W), ck, bw, dtype in cases:
        a, x = scan_inputs(B, S, W, dtype, gen, torch_device)
        got = lru.rg_lru(a, x, chunk=ck, block_w=bw)
        want = lru.rg_lru_plain(a, x, chunk=ck, block_w=bw)
        worst = max(worst, check_allclose(
            got, want, 1e-4, 1e-5, f"scan {(B, S, W)} {dtype} {(ck, bw)}"))
        p = lru.plan(B, S, W, dtype, ck, bw)
        by_route[p.route] += 1
        ran.append(f"{B}x{S}x{W}/{str(dtype).split('.')[1]}:{p.route}/"
                   f"l{p.lanes}/c{p.ctas}")
    torch.cuda.synchronize()
    return {"cases": len(cases), "by_route": by_route, "max_abs_err": worst,
            "ran": ran}


def drive_main_path(torch_device: str, moses_cfg, programs_per_task: int,
                    epochs: int, trials: int, registry_path: str, tasks):
    """Pre-train, tune `tasks` under moses, launch each tuned GEMM once.
    Returns (summary, tuned registry, TuneResult,
    [(workload, a, b, tuned output)])."""
    import torch

    from repro_torch.autotune.dataset import (generate_records,
                                              training_task_pool)
    from repro_torch.autotune.registry import Registry
    from repro_torch.autotune.session import TuneSession
    from repro_torch.core.cost_model import (rank_correlation,
                                             resolve_cost_model)
    from repro_torch.kernels import ops

    t0 = time.perf_counter()
    pool = training_task_pool(include_archs=False)
    source = generate_records(pool, moses_cfg.source_device,
                              programs_per_task=programs_per_task, seed=0)
    model = resolve_cost_model("mlp", moses_cfg.cost_model, torch_device)
    params = model.init(0)
    params, losses = model.train(params, source, epochs=epochs)
    pretrain_s = time.perf_counter() - t0
    assert losses[-1] < losses[0], f"pre-training did not learn: {losses}"

    registry = Registry(registry_path)
    session = TuneSession(moses_cfg=moses_cfg, pretrained_params=params,
                          source_pool=source, seed=1, trials_per_task=trials,
                          cost_model=model, registry=registry,
                          torch_device=torch_device)
    t0 = time.perf_counter()
    result = session.run(tasks, "tpu_v5e", "moses")
    tune_s = time.perf_counter() - t0
    registry.save()
    ops.set_registry(registry)

    gen = torch.Generator(device=torch_device).manual_seed(1)
    gemms = []
    for wl in tasks:
        M, N, K = wl.dims
        a = torch.randn((M, K), generator=gen, device=torch_device).to(
            torch.bfloat16)
        b = torch.randn((K, N), generator=gen, device=torch_device).to(
            torch.bfloat16)
        gemms.append((wl, a, b, ops.tuned_matmul(a, b, device="tpu_v5e")))
    if torch_device != "cpu":
        torch.cuda.synchronize()
    summary = {
        "records": len(source), "pretrain_seconds": pretrain_s,
        "pretrain_loss_first": losses[0], "pretrain_loss_last": losses[-1],
        "source_rank_corr": rank_correlation(params, source, model.predict),
        "tune_seconds": tune_s, "tasks": len(result.tasks),
        "measurements": result.total_measurements,
        "model_latency_s": result.model_latency,
        "search_seconds_simulated": result.total_search_seconds,
    }
    return summary, registry, result, gemms


def reset_launches(kernels) -> None:
    for k in kernels:
        k.launches = 0
        for v in getattr(k, "launches_by_variant", {}):
            k.launches_by_variant[v] = 0


def drive_lm_path(torch_device: str, arch: str, trials: int):
    """The LM-architecture autotune path: `maybe_autotune` at full width
    (MOSES_CFG defaults, 24 programs per pool task, 10 epochs), then each
    tuned task's kernel once at the model's real shape on bf16 operands
    (attention as num_heads batch-heads at batch 1 with K/V expanded from
    the KV heads, causal, window = local_window; the scan at batch 1;
    GEMMs at M = seq). Returns (cfg, AutotuneRun, [(workload, kind,
    inputs, tuned output)])."""
    import torch

    from repro_torch.configs import get_config
    from repro_torch.kernels import ops
    from repro_torch.launch.train import maybe_autotune

    cfg = get_config(arch)
    run = maybe_autotune("tpu_v5e", cfg, trials=trials,
                         torch_device=torch_device)
    ops.set_registry(run.registry)
    gen = torch.Generator(device=torch_device).manual_seed(5)

    def randn(*shape):
        return torch.randn(shape, generator=gen, device=torch_device).to(
            torch.bfloat16)

    calls = []
    for t in run.result.tasks:
        wl = t.workload
        if wl.kind == "matmul":
            M, N, K = wl.dims
            args = {"a": randn(M, K), "b": randn(K, N)}
            out = ops.tuned_matmul(args["a"], args["b"], device="tpu_v5e")
        elif wl.kind == "attention":
            S, D = wl.dims
            H, G = cfg.num_heads, cfg.num_kv_heads
            args = {"q": randn(H, S, D),
                    "k": randn(G, S, D).repeat_interleave(H // G, 0),
                    "v": randn(G, S, D).repeat_interleave(H // G, 0),
                    "causal": True, "window": cfg.local_window}
            out = ops.tuned_flash_attention(device="tpu_v5e", **args)
        else:
            S, W = wl.dims
            a, x = scan_inputs(1, S, W, torch.bfloat16, gen, torch_device)
            args = {"a": a, "x": x}
            out = ops.tuned_rg_lru(a, x, device="tpu_v5e")
        calls.append((wl, args, out))
    if torch_device != "cpu":
        torch.cuda.synchronize()
    return cfg, run, calls


def lm_task_line(wl, args, out, knobs: dict, modules) -> dict:
    """Check one LM task's tuned output against the plain version and time
    the kernel, the plain version and, where one exists, the one PyTorch
    call that computes the same function, back to back (`ms`) and, except
    the plain version, replayed from a CUDA graph (`device_ms`). lm_head
    gets fewer repeats."""
    import torch
    import torch.nn.functional as F
    mm, fa, lru = modules
    big = wl.name == "lm_head"
    reps = {"kernel": (2, 1) if big else (7, 10),
            "plain": (1, 1) if big else (3, 1),
            "library": (3, 3) if big else (7, 10)}
    line = {"name": wl.name, "kind": wl.kind, "dims": list(wl.dims),
            "count": wl.count, "knobs": knobs, "repeats": reps}
    if wl.kind == "matmul":
        a, b = args["a"], args["b"]
        kw = dict(block_m=knobs["block_m"], block_n=knobs["block_n"],
                  block_k=knobs["block_k"], k_inner=bool(knobs["k_inner"]),
                  out_bf16=bool(knobs["out_bf16"]))
        err = check_close(out, mm.matmul_plain(a, b, **kw), kw["out_bf16"],
                          wl.name)
        kernel = lambda: mm.matmul(a, b, **kw)  # noqa: E731
        plain = lambda: mm.matmul_plain(a, b, **kw)  # noqa: E731
        library = lambda: torch.matmul(a, b)  # noqa: E731
        M, N, K = wl.dims
        floor = matmul_floor_ms(M, N, K, "bfloat16", kw["out_bf16"])
        line.update(plan_fields(mm, M, N, K, kw))
        line["host_us"] = host_us(kernel, 5 if big else 20)
    elif wl.kind == "attention":
        q, k, v = args["q"], args["k"], args["v"]
        kw = dict(causal=args["causal"], window=args["window"],
                  block_q=knobs["block_q"], block_kv=knobs["block_kv"])
        tol = ATTN_TOL["bfloat16"]
        err = check_allclose(out, fa.flash_attention_plain(q, k, v, **kw),
                             tol, tol, wl.name)
        kernel = lambda: fa.flash_attention(q, k, v, **kw)  # noqa: E731
        plain = lambda: fa.flash_attention_plain(q, k, v, **kw)  # noqa: E731
        B, S, D = q.shape
        if kw["window"] == 0 or kw["window"] >= S:
            # the window cuts nothing, so causal SDPA computes the same
            library = lambda: F.scaled_dot_product_attention(  # noqa: E731
                q[None], k[None], v[None], is_causal=True)
        else:
            pos = torch.arange(S, device=q.device)
            band = ((pos[None, :] <= pos[:, None])
                    & (pos[None, :] > pos[:, None] - kw["window"]))
            library = lambda: F.scaled_dot_product_attention(  # noqa: E731
                q[None], k[None], v[None], attn_mask=band)
        floor = attention_floor_ms(B, S, D, "bfloat16", True)
        line.update(dataclasses.asdict(fa.plan(
            B, S, D, q.dtype, kw["block_q"], kw["block_kv"], kw["causal"],
            kw["window"])))
        line["host_us"] = host_us(kernel, 20)
    else:
        a, x = args["a"], args["x"]
        kw = dict(chunk=knobs["chunk"], block_w=knobs["block_w"])
        err = check_allclose(out, lru.rg_lru_plain(a, x, **kw), 1e-4, 1e-5,
                             wl.name)
        kernel = lambda: lru.rg_lru(a, x, **kw)  # noqa: E731
        plain = lambda: lru.rg_lru_plain(a, x, **kw)  # noqa: E731
        library = None
        line["library_note"] = ("no one PyTorch call computes a linear "
                                "recurrence")
        B, S, W = a.shape
        floor = scan_floor_ms(B, S, W, "bfloat16")
        line.update(dataclasses.asdict(lru.plan(B, S, W, a.dtype, **kw)))
        line["host_us"] = host_us(kernel, 20)
    line["ms"] = time_ms(kernel, *reps["kernel"])
    line["device_ms"] = device_ms(kernel, *reps["kernel"])
    line["plain_ms"] = time_ms(plain, *reps["plain"])
    line["library_ms"] = (None if library is None
                          else time_ms(library, *reps["library"]))
    line["library_device_ms"] = (None if library is None
                                 else device_ms(library, *reps["library"]))
    line["bound_ms"], line["bound_by"] = bound_of(*floor)
    line["bound_share"] = line["bound_ms"] / line["ms"]
    line["bytes_ms"], line["ops_ms"] = floor
    line["max_abs_err"] = err
    return line


def tree_numel_bytes(tree) -> tuple:
    from repro_torch.models.common import tree_leaves
    leaves = tree_leaves(tree)
    return (sum(t.numel() for t in leaves),
            sum(t.numel() * t.element_size() for t in leaves))


def serve_bounds(cfg, n_params: int, n_embed: int, batch: int,
                 prompt: int, max_len: int) -> dict:
    """Data-sheet bounds of the serve path on an H100 SXM (bf16 weights):
    prefill of one wave, 2 FLOPs per non-embedding weight per token, the
    causal local attention (QK^T and PV over the kept pairs) and the tied
    logits of the last position, over the bf16 peak, or every weight read
    once; one decode step, every weight read once in bf16 (the tied
    embedding serves the gather and the logits) and the caches read once
    (bf16 KV, float32 RG-LRU carry, bf16 conv taps) over the HBM rate, or
    its 2 * params * batch FLOPs over the peak; each the larger."""
    from repro_torch.models import cache_length
    from repro_torch.models.transformer import layer_kinds
    kinds = layer_kinds(cfg)
    n_attn, n_rec = kinds.count("attention"), kinds.count("recurrent")
    w = min(prompt, cfg.local_window)
    kept = sum(min(t + 1, w) for t in range(prompt))  # (q, k) pairs a row
    attn_flops = (4.0 * batch * kept * cfg.num_heads * cfg.resolved_head_dim
                  * n_attn)
    prefill_flops = (2.0 * (n_params - n_embed) * batch * prompt + attn_flops
                     + 2.0 * batch * cfg.d_model * cfg.padded_vocab_size)
    prefill = bound_of(n_params * 2 / HBM_BYTES_PER_S * 1e3,
                       prefill_flops / PEAK_FLOPS["bfloat16"] * 1e3)
    lru = cfg.lru_width or cfg.d_model
    cache_bytes = batch * (
        n_attn * cache_length(cfg, max_len) * cfg.num_kv_heads
        * cfg.resolved_head_dim * 2 * 2
        + n_rec * lru * (4 + (cfg.conv_width - 1) * 2))
    step_bytes = n_params * 2 + cache_bytes
    step = bound_of(step_bytes / HBM_BYTES_PER_S * 1e3,
                    2.0 * n_params * batch / PEAK_FLOPS["bfloat16"] * 1e3)
    return {"prefill_tflop": prefill_flops / 1e12,
            "prefill_bound_ms": prefill[0], "prefill_bound_by": prefill[1],
            "step_gbytes": step_bytes / 1e9, "step_bound_ms": step[0],
            "step_bound_by": step[1]}


def scan_choice(torch_device: str, B: int, S: int, W: int) -> dict:
    """The model's log-step scan (`models.recurrent.linear_scan`) against a
    sequential float32 loop (`kernels.ref.rg_lru_ref`) at the serve
    prefill's shape: times and agreement."""
    import torch

    from repro_torch.kernels.ref import rg_lru_ref
    from repro_torch.models.recurrent import linear_scan
    gen = torch.Generator(device=torch_device).manual_seed(7)
    a, x = scan_inputs(B, S, W, torch.float32, gen, torch_device)
    err = check_allclose(linear_scan(a, x)[1], rg_lru_ref(a, x), 1e-4, 1e-5,
                         "log-step scan vs sequential")
    return {"shape": [B, S, W], "max_abs_err": err,
            "log_step_ms": time_ms(lambda: linear_scan(a, x), 5, 3),
            "sequential_ms": time_ms(lambda: rg_lru_ref(a, x), 3, 1)}


def serve_probe_check(cfg, torch_device: str) -> dict:
    """Each kernel of the engine's probe, on the probe's own inputs and the
    registry's config, against its plain version: the shapes the serve
    path gave the kernels. Each entry names the variant (or the scan's load
    route) that `plan` gives those inputs."""
    import numpy as np
    import torch

    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import matmul as mm
    from repro_torch.kernels import ops
    from repro_torch.kernels import rg_lru as lru
    from repro_torch.kernels.profile import (KERNELS, _probe_args,
                                             _run_kernel, model_workloads)
    wls = model_workloads(cfg)
    rng = np.random.RandomState(0)
    f32 = torch.float32
    out = {}
    for kernel in KERNELS:
        args = _probe_args(kernel, wls[kernel], rng, torch.device(
            torch_device))
        knobs = ops.get_registry().get("tpu_v5e", wls[kernel]).as_dict()
        got = _run_kernel(kernel, args, knobs)
        if kernel == "matmul":
            kw = dict(block_m=knobs["block_m"], block_n=knobs["block_n"],
                      block_k=knobs["block_k"],
                      k_inner=bool(knobs["k_inner"]),
                      out_bf16=bool(knobs["out_bf16"]))
            err = check_close(got, mm.matmul_plain(*args, **kw),
                              kw["out_bf16"], "serve probe matmul")
            ran = mm.plan(*wls[kernel].dims, f32, **kw).variant
        elif kernel == "attention":
            kw = dict(block_q=knobs["block_q"], block_kv=knobs["block_kv"])
            want = fa.flash_attention_plain(*args, causal=True, **kw)
            tol = ATTN_TOL["float32"]
            err = check_allclose(got, want, tol, tol, "serve probe attention")
            ran = fa.plan(*args[0].shape, f32, kw["block_q"],
                          kw["block_kv"], True, 0).variant
        else:
            kw = dict(chunk=knobs["chunk"], block_w=knobs["block_w"])
            want = lru.rg_lru_plain(*args, **kw)
            err = check_allclose(got, want, 1e-4, 1e-5, "serve probe scan")
            ran = lru.plan(*args[0].shape, f32, **kw).route
        out[kernel] = {"dims": list(wls[kernel].dims), "knobs": knobs,
                       "ran": ran, "max_abs_err": err}
    return out


def drive_serve_path(torch_device: str, cfg, modules, requests: int = 8,
                     prompt: int = 512, new: int = 32, slots: int = 4):
    """The serving path at `cfg`'s width: `build_model` and `init` from
    seed 0 on the card, then `serve.Engine(profile_kernels=True)` on
    `requests` greedy requests of `prompt` random tokens and `new` new
    tokens each, in waves of `slots`; the launch counts are set to 0 just
    before the engine is made and read just after `generate`. Returns
    (summary, model, params)."""
    import numpy as np
    import torch

    from repro_torch.models import build_model
    from repro_torch.obs import metrics as obs_metrics
    from repro_torch.serve import Engine, Request
    mm, fa, lru = modules
    on_card = torch_device != "cpu"
    model = build_model(cfg)
    if on_card:
        torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    params = model.init(0, torch_device=torch_device)
    init_peak = 0.0
    if on_card:
        torch.cuda.synchronize()
        init_peak = torch.cuda.max_memory_allocated() / 1e9
        torch.cuda.reset_peak_memory_stats()
    init_s = time.perf_counter() - t0
    n_params, param_bytes = tree_numel_bytes(params)
    rng = np.random.RandomState(0)
    reqs = [Request(prompt=rng.randint(0, cfg.vocab_size, size=prompt).astype(
        np.int32), max_new_tokens=new) for _ in range(requests)]
    reg = obs_metrics.MetricsRegistry()
    obs_metrics.push_registry(reg)
    try:
        reset_launches((mm.matmul, fa.flash_attention, lru.rg_lru))
        engine = Engine(model, params, max_len=prompt + new + 8,
                        batch_slots=slots, profile_kernels=True,
                        device="tpu_v5e")
        t0 = time.perf_counter()
        engine.generate(reqs)
        if on_card:
            torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches = {"matmul": mm.matmul.launches,
                    "flash_attention": fa.flash_attention.launches,
                    "rg_lru": lru.rg_lru.launches}
        by_variant = {"matmul": dict(mm.matmul.launches_by_variant),
                      "flash_attention": dict(
                          fa.flash_attention.launches_by_variant)}
    finally:
        obs_metrics.pop_registry(reg)
    snap = reg.snapshot()
    hists = snap["histograms"]
    pre = reg.histogram("serve.engine.prefill_seconds")
    step = reg.histogram("serve.engine.step_seconds")
    kernel_seconds = {
        k: {c: hists[f"kernel.seconds{{config={c},device=tpu_v5e,"
                     f"kernel={k}}}"]["count"] for c in ("tuned", "default")}
        for k in ("matmul", "attention", "scan")}
    tokens = sum(len(r.out_tokens) for r in reqs)
    embed = params["embed"].numel()
    summary = {
        "arch": cfg.name, "layers": cfg.num_layers, "d_model": cfg.d_model,
        "vocab": cfg.vocab_size, "param_dtype": cfg.param_dtype,
        "activation_dtype": cfg.activation_dtype, "params": n_params,
        "param_bytes": param_bytes,
        "cast_param_bytes": tree_numel_bytes(engine.params)[1],
        "init_seconds": init_s, "requests": len(reqs),
        "prompt_tokens": prompt, "new_tokens": new, "batch_slots": slots,
        "tokens": tokens,
        "tokens_per_request": sorted({len(r.out_tokens) for r in reqs}),
        "generate_seconds": wall, "tokens_per_s": tokens / wall,
        "prefills": len(pre), "prefill_s_p50": pre.percentile(50),
        "prefill_s": pre.state()["window"],
        "steps": len(step), "step_s_p50": step.percentile(50),
        "step_s_p90": step.percentile(90),
        "decode_tokens_per_s": slots / step.percentile(50),
        "tokens_counter": snap["counters"]["serve.engine.tokens"],
        "kernel_seconds_counts": kernel_seconds,
        "launches": launches, "launches_by_variant": by_variant,
        **serve_bounds(cfg, n_params, embed, slots, prompt,
                       prompt + new + 8)}
    if on_card:  # init's peak (group trees stacked), then serving's
        summary["init_max_memory_allocated_gb"] = init_peak
        summary["max_memory_allocated_gb"] = \
            torch.cuda.max_memory_allocated() / 1e9
    summary["prefill_bound_share"] = (summary["prefill_bound_ms"] / 1e3
                                      / summary["prefill_s_p50"])
    summary["step_bound_share"] = (summary["step_bound_ms"] / 1e3
                                   / summary["step_s_p50"])
    summary["decode_split"] = decode_split(model, engine.params,
                                           torch_device, slots, prompt)
    del engine
    return summary, model, params


def decode_split(model, params, torch_device: str, batch: int = 4,
                 prompt: int = 512, steps: int = 10) -> dict:
    """Where a decode step's time goes, on the engine's own (cast) params
    after a prefill of `batch` x `prompt` random tokens: the host's time to
    enqueue one `decode_step` (no synchronisation) beside the step's wall
    time to a `torch.cuda.synchronize()`, and, from a `torch.profiler`
    trace of 3 more steps, the device's kernel time and kernel count per
    step and the kernels that take most of it. Enqueue close to wall, and
    kernel time far below it, mean the host paces the step."""
    import numpy as np
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    on_card = torch_device != "cpu"

    def sync():
        if on_card:
            torch.cuda.synchronize()

    rng = np.random.RandomState(2)
    toks = torch.as_tensor(rng.randint(0, model.cfg.vocab_size, size=(
        batch, prompt)).astype(np.int32), device=torch_device)
    with torch.inference_mode():
        state, _ = model.prefill(params, {"tokens": toks},
                                 max_len=prompt + steps + 8)
        nxt = toks[:, -1]
        state, _ = model.decode_step(params, state, nxt)  # warm
        sync()
        enqueue, wall = [], []
        for _ in range(steps - 4):
            t0 = time.perf_counter()
            state, _ = model.decode_step(params, state, nxt)
            t1 = time.perf_counter()
            sync()
            enqueue.append(t1 - t0)
            wall.append(time.perf_counter() - t0)
        acts = [ProfilerActivity.CPU] + (
            [ProfilerActivity.CUDA] if on_card else [])
        with profile(activities=acts) as prof:
            for _ in range(3):
                state, _ = model.decode_step(params, state, nxt)
            sync()
    # the kernels' own events: a CPU op's self device time repeats its
    # kernels' time
    avgs = [e for e in prof.key_averages()
            if e.device_type == DeviceType.CUDA]
    kernel_us = sum(e.self_device_time_total for e in avgs)
    kernels = sum(e.count for e in avgs)
    top = sorted(avgs, key=lambda e: -e.self_device_time_total)[:8]
    wall_s = statistics.median(wall)
    return {"steps_timed": len(wall), "enqueue_s": statistics.median(enqueue),
            "wall_s": wall_s,
            "enqueue_share": statistics.median(enqueue) / wall_s,
            "profiled_steps": 3,
            "device_kernel_ms_per_step": kernel_us / 3 / 1e3,
            "device_busy_share": kernel_us / 3 / 1e6 / wall_s,
            "kernels_per_step": kernels / 3,
            "top_kernels": [{"name": e.key[:80], "per_step": e.count / 3,
                             "ms_per_step": e.self_device_time_total / 3e3}
                            for e in top]}


def serve_consistency(cfg, params, torch_device: str, prompts, steps: int = 8
                      ) -> dict:
    """Decode against forward at float32 activations (TF32 off), batch 1:
    for each prompt length S, prefill S random tokens and decode `steps`
    more; the prefill's logits and each decode step's must equal
    `forward`'s at that position within |err| <= 1e-4 * max|fwd| + 1e-4 *
    |fwd|, the CPU parity tests' float32 tolerance (the paths differ only
    in summation order: blocked vs single-row attention, log-step vs
    step-by-step scan, GEMMs of other shapes). S = local_window fills the
    ring exactly, so decode wraps it: each new token overwrites the one
    that just left the window."""
    import numpy as np
    import torch

    from repro_torch.models import build_model, cache_length
    model = build_model(cfg.replace(activation_dtype="float32"))
    rng = np.random.RandomState(1)
    cases = []
    with torch.inference_mode():
        for S in prompts:
            toks = torch.as_tensor(rng.randint(
                0, cfg.vocab_size, size=(1, S + steps)).astype(np.int32),
                device=torch_device)
            fwd, _ = model.forward(params, {"tokens": toks})
            state, lg = model.prefill(params, {"tokens": toks[:, :S]},
                                      max_len=S + steps)
            sc = cache_length(cfg, S + steps)
            errs = [check_allclose(lg, fwd[:, S - 1], 1e-4,
                                   1e-4 * float(fwd[:, S - 1].abs().max()),
                                   f"prefill S={S}")]
            for s in range(S, S + steps):
                state, lg = model.decode_step(params, state, toks[:, s])
                ref = fwd[:, s]
                errs.append(check_allclose(
                    lg, ref, 1e-4, 1e-4 * float(ref.abs().max()),
                    f"decode S={S} at {s}"))
            cases.append({"prompt": S, "steps": steps, "cache_slots": sc,
                          "wraps": S + steps > sc,
                          "max_abs_err": max(errs),
                          "max_abs_logit": float(fwd[0, S - 1:].abs().max())})
            del fwd, state
    return {"tolerance": "|err| <= 1e-4 * max|fwd| + 1e-4 * |fwd| "
                         "(the CPU parity tests' float32 tolerance)",
            "cases": cases,
            "not_checked": "S > Sc with S % Sc != 0: decode writes position "
                           "S at slot S % Sc, over a token still in the "
                           "window, so decode departs from forward; a "
                           "reference property the port reproduces "
                           "(ROADMAP Queue 3, tests/test_torch_models.py)"}


def cost_model_parity(torch_device: str, moses_cfg) -> float:
    """The full-width cost model scores the same on the card as on the CPU
    (TF32 off): returns the max relative difference, raises above 1e-4."""
    import numpy as np

    from repro_torch.core.cost_model import resolve_cost_model
    x = np.random.RandomState(0).rand(64, moses_cfg.cost_model.feature_dim)
    cpu = resolve_cost_model("mlp", moses_cfg.cost_model, "cpu")
    card = resolve_cost_model("mlp", moses_cfg.cost_model, torch_device)
    params = cpu.init(0)
    want = cpu.predict(params, x)
    got = card.predict(card.clone_params(params), x)
    rel = float(np.max(np.abs(got - want)) / np.max(np.abs(want)))
    assert rel < 1e-4, f"cost model on the card differs from the CPU: {rel}"
    return rel


def build_all(build) -> dict:
    """One nvcc per kernel source, all started together."""
    from concurrent.futures import ThreadPoolExecutor

    def one(name):
        t0 = time.perf_counter()
        lib = build.build(name)
        ptxas = [ln.strip() for ln in
                 lib.with_suffix(".so.log").read_text().splitlines()
                 if "registers" in ln or "spill" in ln
                 or "Compiling entry" in ln]
        return name, {"seconds": time.perf_counter() - t0,
                      "library": str(lib.relative_to(ROOT)), "ptxas": ptxas}

    with ThreadPoolExecutor(len(SOURCES)) as ex:
        return dict(ex.map(one, SOURCES))


def main() -> int:
    if not (ROOT / "src" / "repro_torch").is_dir():
        print("chip_smoke.py: src/repro_torch not found; run it from a "
              "checkout of the repository", file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT / "src"))
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke.py: torch.cuda.is_available() is false; this "
              "smoke test needs an NVIDIA card", file=sys.stderr)
        return 2
    with tempfile.TemporaryDirectory() as tmp:
        # the port's default registry, read when the port is imported
        os.environ["REPRO_TORCH_TUNING_REGISTRY"] = str(
            Path(tmp) / "tuned_configs_torch.json")
        return run_phases(torch, tmp)


def run_phases(torch, tmp: str) -> int:
    from repro_torch.autotune.space import config_valid
    from repro_torch.autotune.tasks import resnet18_tasks
    from repro_torch.configs import get_config
    from repro_torch.configs.moses import MosesConfig
    from repro_torch.kernels import build
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import matmul as mm
    from repro_torch.kernels import rg_lru as lru

    smi = nvidia_smi()
    emit("env", nvidia_smi=smi, device=torch.cuda.get_device_name(0),
         count=torch.cuda.device_count(), torch=torch.__version__,
         cuda=torch.version.cuda, python=sys.version.split()[0])

    t0 = time.perf_counter()
    built = build_all(build)
    emit("build", seconds=time.perf_counter() - t0, kernels=built)

    # plain versions and the cost model in full float32 (no TF32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    emit("kernel_check", kernel="matmul", tolerance=TOLERANCE,
         **kernel_check(mm, "cuda"))
    emit("attention_check", kernel="flash_attention",
         tolerance=ATTN_TOLERANCE, **attention_check(fa, "cuda"))
    emit("scan_check", kernel="rg_lru", tolerance=SCAN_TOLERANCE,
         **scan_check(lru, "cuda"))

    moses_cfg = MosesConfig()
    emit("cost_model_parity", max_rel_diff=cost_model_parity("cuda",
                                                             moses_cfg))

    # path 1: ResNet-18 GEMMs
    tasks = resnet18_tasks()
    reset_launches((mm.matmul, fa.flash_attention, lru.rg_lru))
    summary, registry, result, gemms = drive_main_path(
        "cuda", moses_cfg, programs_per_task=24, epochs=10, trials=32,
        registry_path=str(Path(tmp) / "resnet18.json"), tasks=tasks)
    launches = {"matmul": mm.matmul.launches,
                "by_variant": dict(mm.matmul.launches_by_variant),
                "flash_attention": fa.flash_attention.launches,
                "rg_lru": lru.rg_lru.launches}
    emit("main_path", launches=launches["matmul"],
         launches_by_variant=launches["by_variant"], **summary)
    assert launches["matmul"] >= len(tasks) == 12, \
        f"matmul launched {launches['matmul']} times"
    # every ResNet-18 GEMM ran the tensor-core variant
    assert launches["by_variant"]["simt"] == 0 and \
        launches["by_variant"]["wgmma"] == launches["matmul"], launches
    for t in result.tasks:
        assert config_valid(t.workload, t.best_config), t

    totals = {"ms": 0.0, "plain_ms": 0.0, "bound_ms": 0.0,
              "library_ms": 0.0, "device_ms": 0.0, "library_device_ms": 0.0,
              "bytes_ms": 0.0, "ops_ms": 0.0}
    worst = 0.0
    for wl, a, b, out in gemms:
        M, N, K = wl.dims
        entry = registry.lookup("tpu_v5e", wl)
        assert entry is not None, f"{wl.name} was not tuned"
        cfg = registry.get("tpu_v5e", wl).as_dict()
        knobs = dict(block_m=cfg["block_m"], block_n=cfg["block_n"],
                     block_k=cfg["block_k"], k_inner=bool(cfg["k_inner"]),
                     out_bf16=bool(cfg["out_bf16"]))
        want = mm.matmul_plain(a, b, **knobs)
        err = check_close(out, want, knobs["out_bf16"], wl.name)
        worst = max(worst, err)
        ms = time_ms(lambda: mm.matmul(a, b, **knobs), reps=7, inner=10)
        plain_ms = time_ms(lambda: mm.matmul_plain(a, b, **knobs), reps=3,
                           inner=1)
        library_ms = time_ms(lambda: torch.matmul(a, b), reps=7, inner=10)
        dev_ms = device_ms(lambda: mm.matmul(a, b, **knobs), reps=7,
                           inner=10)
        library_dev_ms = device_ms(lambda: torch.matmul(a, b), reps=7,
                                   inner=10)
        bytes_ms, ops_ms = matmul_floor_ms(M, N, K, "bfloat16",
                                           knobs["out_bf16"])
        bound_ms, bound_by = bound_of(bytes_ms, ops_ms)
        emit("gemm", name=wl.name, dims=[M, N, K], count=wl.count,
             knobs=cfg, **plan_fields(mm, M, N, K, knobs), ms=ms,
             device_ms=dev_ms,
             host_us=host_us(lambda: mm.matmul(a, b, **knobs), 20),
             plain_ms=plain_ms, library_ms=library_ms,
             library_device_ms=library_dev_ms, bound_ms=bound_ms,
             bound_by=bound_by, bound_share=bound_ms / ms, max_abs_err=err,
             simulated_gflops=entry["throughput_gflops"])
        totals["ms"] += ms
        totals["plain_ms"] += plain_ms
        totals["library_ms"] += library_ms
        totals["device_ms"] += dev_ms
        totals["library_device_ms"] += library_dev_ms
        totals["bound_ms"] += bound_ms
        totals["bytes_ms"] += bytes_ms
        totals["ops_ms"] += ops_ms
    torch.cuda.synchronize()

    # path 2: RecurrentGemma-2B through the training launcher's autotune
    reset_launches((mm.matmul, fa.flash_attention, lru.rg_lru))
    cfg, lm_run, calls = drive_lm_path("cuda", "recurrentgemma-2b", trials=48)
    lm_launches = {"matmul": mm.matmul.launches,
                   "flash_attention": fa.flash_attention.launches,
                   "rg_lru": lru.rg_lru.launches}
    lm_by_variant = dict(mm.matmul.launches_by_variant)
    fa_by_variant = dict(fa.flash_attention.launches_by_variant)
    emit("lm_path", arch=cfg.name, launches=lm_launches,
         matmul_launches_by_variant=lm_by_variant,
         flash_attention_launches_by_variant=fa_by_variant,
         pretrain_seconds=lm_run.pretrain_seconds,
         pretrain_loss_first=lm_run.pretrain_losses[0],
         pretrain_loss_last=lm_run.pretrain_losses[-1],
         tune_seconds=lm_run.tune_seconds, tasks=len(lm_run.result.tasks),
         measurements=lm_run.result.total_measurements,
         search_seconds_simulated=lm_run.result.total_search_seconds)
    n_gemm = sum(1 for wl, _, _ in calls if wl.kind == "matmul")
    assert len(calls) == 9 and n_gemm == 7, [wl.name for wl, _, _ in calls]
    assert lm_launches["flash_attention"] >= 1, lm_launches
    assert lm_launches["rg_lru"] >= 1, lm_launches
    assert lm_launches["matmul"] >= n_gemm, lm_launches
    # every RecurrentGemma-2B GEMM ran the tensor-core variant
    assert lm_by_variant["simt"] == 0 and \
        lm_by_variant["wgmma"] == lm_launches["matmul"], lm_by_variant
    # the attention ran the tensor-core variant
    assert fa_by_variant["simt"] == 0 and \
        fa_by_variant["wgmma"] == lm_launches["flash_attention"], \
        fa_by_variant
    for t in lm_run.result.tasks:
        assert config_valid(t.workload, t.best_config), t

    per_kernel = {"flash_attention": None, "rg_lru": None}
    for wl, args, out in calls:
        knobs = lm_run.registry.get("tpu_v5e", wl).as_dict()
        line = lm_task_line(wl, args, out, knobs, (mm, fa, lru))
        emit("lm_task", **line)
        if wl.kind == "matmul":
            worst = max(worst, line["max_abs_err"])
            for key in ("ms", "plain_ms", "library_ms", "device_ms",
                        "library_device_ms", "bound_ms", "bytes_ms",
                        "ops_ms"):
                totals[key] += line[key]
        else:
            # both spread over the SMs: at least 80 CTAs
            assert line["ctas"] >= 80, line
            per_kernel["flash_attention" if wl.kind == "attention"
                       else "rg_lru"] = line
    torch.cuda.synchronize()

    # path 3: the serving path on the full RecurrentGemma-2B config
    serve_cfg = get_config("recurrentgemma-2b")
    serve, _, params = drive_serve_path("cuda", serve_cfg, (mm, fa, lru))
    serve["probe_check"] = serve_probe_check(serve_cfg, "cuda")
    serve["scan_choice"] = scan_choice("cuda", 4, 512, serve_cfg.lru_width)
    emit("serve_path", **serve)
    sv = serve["launches"]
    assert min(sv.values()) >= 1, sv  # each kernel, in the engine's probe
    assert serve["requests"] == 8 and serve["tokens_per_request"] == [32], \
        serve
    torch.cuda.empty_cache()
    emit("serve_consistency", arch=serve_cfg.name, **serve_consistency(
        serve_cfg, params, "cuda", (512, serve_cfg.local_window)))
    del params
    torch.cuda.empty_cache()

    # one entry per ported kernel. matmul's times are sums over both paths'
    # GEMMs (one launch each); the other two are their one task's
    entries = [{
        "name": "matmul", "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/matmul_wgmma.cu",
        "sources": {"wgmma": "src/repro_torch/kernels/csrc/matmul_wgmma.cu",
                    "simt": "src/repro_torch/kernels/csrc/matmul.cu"},
        "replaces": f"{TPU_KERNEL}:99",
        "tpu_kernel": f"{TPU_KERNEL}:matmul (pallas_call at :99, k_inner=1,"
                      f" and :115, k_inner=0)",
        "launches": launches["matmul"] + lm_launches["matmul"] + sv["matmul"],
        "launches_by_variant": {
            v: (launches["by_variant"][v] + lm_by_variant[v]
                + serve["launches_by_variant"]["matmul"][v])
            for v in ("wgmma", "simt")},
        "launches_by_path": {"resnet18": launches["matmul"],
                             "recurrentgemma-2b": lm_launches["matmul"],
                             "serve": sv["matmul"]},
        "checked": True, "max_abs_err": worst,
        "ms": totals["ms"], "device_ms": totals["device_ms"],
        "plain_ms": totals["plain_ms"],
        "bound_ms": totals["bound_ms"],
        "bound_by": bound_of(totals["bytes_ms"], totals["ops_ms"])[1],
        "library_ms": totals["library_ms"],
        "library_device_ms": totals["library_device_ms"]}]
    csrc = "src/repro_torch/kernels/csrc"
    for name, src, extra in (
            ("flash_attention", "flash_attention_wgmma.cu", {
                "replaces": "src/repro/kernels/flash_attention.py:100",
                "sources": {"wgmma": f"{csrc}/flash_attention_wgmma.cu",
                            "simt": f"{csrc}/flash_attention.cu"},
                "launches_by_variant": {
                    v: fa_by_variant[v]
                    + serve["launches_by_variant"]["flash_attention"][v]
                    for v in ("wgmma", "simt")}}),
            ("rg_lru", "rg_lru.cu",
             {"replaces": "src/repro/kernels/rg_lru.py:57"})):
        line = per_kernel[name]
        entries.append({
            "name": name, "route": "cuda", "source": f"{csrc}/{src}",
            **extra,
            "launches": launches[name] + lm_launches[name] + sv[name],
            "launches_by_path": {"resnet18": launches[name],
                                 "recurrentgemma-2b": lm_launches[name],
                                 "serve": sv[name]},
            "checked": True, "max_abs_err": line["max_abs_err"],
            "ms": line["ms"], "device_ms": line["device_ms"],
            "plain_ms": line["plain_ms"],
            "bound_ms": line["bound_ms"], "bound_by": line["bound_by"],
            "library_ms": line["library_ms"],
            "library_device_ms": line["library_device_ms"]})
    print(json.dumps({"kernels": entries}), flush=True)
    print(nvidia_smi(), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
