#!/usr/bin/env python3
"""Chip smoke test of the PyTorch port on one NVIDIA card.

    python3 chip_smoke.py

Builds the port's CUDA kernels from the sources in this checkout, holds each
kernel against its plain PyTorch version on the card, then drives the Moses
main path through the port's entry points at full width:

  1. pre-train the paper's cost model (164 -> 512 -> 512 -> 1) on simulated
     tpu_v5p records, as examples/quickstart.py does;
  2. tune all 12 ResNet-18 GEMMs for tpu_v5e under the `moses` strategy
     (lottery-ticket adaptation + AC) into a temporary registry;
  3. launch the matmul kernel with each tuned tile at the GEMM's real shape
     on bf16 operands, and check and time it.

Every phase prints one JSON line. The line before the last is the card's
name and power limit as nvidia-smi prints them; the last line is
{"ok": true, "device": {...}}. Exits non-zero, and prints no result, without
a CUDA card or outside a checkout of the repository. Imports nothing of JAX.
"""
import json
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


def matmul_floor_ms(M: int, N: int, K: int, in_dtype: str, out_bf16: bool):
    """(bytes_ms, ops_ms) for one GEMM on an H100 SXM: each input read once
    and the output written once over the HBM rate, and 2MNK over the input
    type's peak. The bound is the larger of the two."""
    in_b = 2 if in_dtype == "bfloat16" else 4
    moved = (M * K + K * N) * in_b + M * N * (2 if out_bf16 else 4)
    return (moved / HBM_BYTES_PER_S * 1e3,
            2.0 * M * N * K / PEAK_FLOPS[in_dtype] * 1e3)


def bound_of(bytes_ms: float, ops_ms: float):
    """(bound_ms, bound_by)."""
    return max(bytes_ms, ops_ms), ("bytes" if bytes_ms >= ops_ms
                                   else "operations")


def kernel_check(mm, torch_device: str) -> dict:
    """Every case: CUDA matmul vs matmul_plain on the card."""
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
    n, worst = 0, 0.0
    for (M, N, K), (bm, bn, bk) in cases:
        for dtype in (torch.float32, torch.bfloat16):
            a = torch.randn((M, K), generator=gen, device=torch_device).to(
                dtype)
            b = torch.randn((K, N), generator=gen, device=torch_device).to(
                dtype)
            for k_inner in (True, False):
                for out_bf16 in (False, True):
                    knobs = dict(block_m=bm, block_n=bn, block_k=bk,
                                 k_inner=k_inner, out_bf16=out_bf16)
                    got = mm.matmul(a, b, **knobs)
                    want = mm.matmul_plain(a, b, **knobs)
                    worst = max(worst, check_close(
                        got, want, out_bf16, f"{(M, N, K)} {dtype} {knobs}"))
                    n += 1
    torch.cuda.synchronize()
    return {"cases": n, "max_abs_err": worst}


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

    from repro_torch.autotune.space import config_valid
    from repro_torch.autotune.tasks import resnet18_tasks
    from repro_torch.configs.moses import MosesConfig
    from repro_torch.kernels import build
    from repro_torch.kernels import matmul as mm

    smi = nvidia_smi()
    emit("env", nvidia_smi=smi, device=torch.cuda.get_device_name(0),
         count=torch.cuda.device_count(), torch=torch.__version__,
         cuda=torch.version.cuda, python=sys.version.split()[0])

    t0 = time.perf_counter()
    lib = build.build("matmul")
    ptxas = [ln.strip() for ln in
             lib.with_suffix(".so.log").read_text().splitlines()
             if "registers" in ln or "spill" in ln]
    emit("build", seconds=time.perf_counter() - t0,
         library=str(lib.relative_to(ROOT)), ptxas=ptxas)

    # plain versions and the cost model in full float32 (no TF32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    emit("kernel_check", kernel="matmul", tolerance=TOLERANCE,
         **kernel_check(mm, "cuda"))

    moses_cfg = MosesConfig()
    emit("cost_model_parity", max_rel_diff=cost_model_parity("cuda",
                                                             moses_cfg))
    tasks = resnet18_tasks()
    with tempfile.TemporaryDirectory() as tmp:
        mm.matmul.launches = 0
        summary, registry, result, gemms = drive_main_path(
            "cuda", moses_cfg, programs_per_task=24, epochs=10, trials=32,
            registry_path=str(Path(tmp) / "tuned_configs.json"), tasks=tasks)
        launches = mm.matmul.launches
    emit("main_path", launches=launches, **summary)
    assert launches >= len(tasks) == 12, f"matmul launched {launches} times"
    for t in result.tasks:
        assert config_valid(t.workload, t.best_config), t

    totals = {"ms": 0.0, "plain_ms": 0.0, "bound_ms": 0.0,
              "library_ms": 0.0, "bytes_ms": 0.0, "ops_ms": 0.0}
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
        bytes_ms, ops_ms = matmul_floor_ms(M, N, K, "bfloat16",
                                           knobs["out_bf16"])
        bound_ms, bound_by = bound_of(bytes_ms, ops_ms)
        emit("gemm", name=wl.name, dims=[M, N, K], count=wl.count,
             knobs=cfg, ms=ms, plain_ms=plain_ms, library_ms=library_ms,
             bound_ms=bound_ms, bound_by=bound_by, max_abs_err=err,
             simulated_gflops=entry["throughput_gflops"])
        totals["ms"] += ms
        totals["plain_ms"] += plain_ms
        totals["library_ms"] += library_ms
        totals["bound_ms"] += bound_ms
        totals["bytes_ms"] += bytes_ms
        totals["ops_ms"] += ops_ms
    torch.cuda.synchronize()

    # one entry per ported kernel; times are sums over the main path's
    # GEMMs (one launch each)
    print(json.dumps({"kernels": [{
        "name": "matmul", "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/matmul.cu",
        "replaces": f"{TPU_KERNEL}:99",
        "tpu_kernel": f"{TPU_KERNEL}:matmul (pallas_call at :99, k_inner=1,"
                      f" and :115, k_inner=0)",
        "launches": launches, "checked": True, "max_abs_err": worst,
        "ms": totals["ms"], "plain_ms": totals["plain_ms"],
        "bound_ms": totals["bound_ms"],
        "bound_by": bound_of(totals["bytes_ms"], totals["ops_ms"])[1],
        "library_ms": totals["library_ms"]}]}), flush=True)
    print(nvidia_smi(), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
