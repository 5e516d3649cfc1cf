#!/usr/bin/env python3
"""Chip smoke test of the PyTorch port on one NVIDIA card.

    python3 chip_smoke.py

Builds the port's CUDA kernels (matmul and flash attention in two variants
each, wgmma and simt; RG-LRU scan) from the five sources in this checkout,
one nvcc each, all started together; holds each kernel against its plain
PyTorch version on the card over its knob corners, each matmul and
attention case naming the variant it ran; holds both registered cost
models (`mlp`, `residual-mlp`) on the card to the CPU (`cost_model_parity`:
scores, and one training epoch of the residual MLP); then drives thirteen
paths through the port's entry points at full width (eleven serving or
tuning, one training), each with the launch counts set to 0 just before it
and read just after, and asserts that every GEMM of the three tuning paths
below and of the two hub paths, and their attention, ran the wgmma variant.
The first three:

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
  RecurrentGemma-2B as one scheduled campaign (`sched_path`)
    1. `maybe_autotune(..., scheduler="gradient", obs=DIR)`, the launcher's
       --scheduler gradient --obs: the same pre-training, then the 9 tasks
       as one campaign (48 trials a task as the budget, marginal-gain
       grants, the thread executor, draft-then-verify scoring on the card,
       the flight recorder);
    2. each task's kernel launches from the campaign's registry as above,
       one `sched_task` line each. The `sched_path` line gives the host
       seconds, the grants and measurements, the simulator's seconds
       (spent, makespan; named `*_simulated`), draft acceptance, the total
       best latency beside the serial path's, and the recorder's wall-time
       attribution by span; `events.jsonl` and a trace that
       `validate_events` accepts must exist.
  `sched_farm` then replays the reference's farm contract with the cost
  model on the card: two jobs (tpu_v5e, tpu_edge; four ResNet-18 GEMMs
  each) under moses, once through the thread executor and once through the
  spawn-process farm, under one FaultInjector map (worker-killing crashes,
  hangs, transients). Traces, winners and poisoned configs must be
  identical, and while the farm is up nvidia-smi may list no worker.

After the kernel checks, the prefill attention kernel
(`kernels.flash_attention.prefill_attention`, the models' bf16 prefill on
the card), in `prefill_phases`: `prefill_attention_check` holds it to its
plain version over 29 cases (group ratios 1 to 16, ragged S, windows, the
zoo's head dims, strided k and v), elementwise and by each (batch, q head,
128-row band)'s relative error (PREFILL_TOLERANCE); one
`prefill_attention` line each times it at the benchmark's two glm4-9b
prefills (B 16 x S 4070 and 64 x 1018, 32 q heads over 2 kv heads, D 128,
causal), with the band check's reading of a planted fault (one kv tile
dropped from half the rows of two heads), and the tuning path's flash
attention at RecurrentGemma-2B's `self_attn`, beside the plain version,
SDPA and the bound; `prefill_route` runs one glm4-9b prefill at its
published width (40 layers, bf16 weights drawn on the card) and asserts
that all 40 attention calls took the kernel (`attn.prefill_route`) with 40
launches; `prefill_mesh` runs two layers of it on a one-rank NCCL group's
(1, 1) mesh, where the kernel runs on the DTensors' local shards
(`layout().on_shards`), against the same prefill without the mesh.

Then the decode attention kernel (`kernels.decode_attention.
decode_attention`, the models' bf16 GQA decode on the card), in
`decode_phases`: `decode_attention_check` holds it to its plain version
over its cases (group ratios 1 to 20, the zoo's head dims, one and many kv
splits, windows, a wrapped ring, strided k and v, rows with no kept slot,
which must read exactly 0), elementwise and by each (row, q head)'s
relative error (DECODE_TOLERANCE); one `decode_attention` line each times
it at the benchmark's two glm4-9b decodes and recurrentgemma-2b's D 256
local ring (DECODE_SHAPES): `device_ms` beside the bound and its share,
`host_us` (the wrapper's host time a call), the plain version (the float32
loop the kernel replaces) and SDPA with `enable_gqa` as a yardstick, with
the row check's reading of a planted fault (one 16-slot tile dropped from
every row), which must fail it; `decode_route` runs one glm4-9b decode
step at its published width and asserts that all 40 attention calls took
the kernel (`attn.decode_route`) with 40 launches; `decode_mesh` decodes
two layers of it on a one-rank NCCL group's (1, 1) mesh, where the kernel
runs on the DTensors' local shards, against the same decode without the
mesh.

Then the routed-only expert FFN (`kernels.moe_experts.moe_experts`, the
MoE dispatch's bf16 decode on the card), in `moe_phases`:
`moe_experts_check` holds the kernel pair to its plain version over its
cases (C from 1 to 16, one expert to 300, every expert full, none filled,
weights read through strided views), elementwise and by each (expert,
row)'s relative error, rows past fill exactly 0 (MOE_TOLERANCE); one
`moe_experts` line each times it at four MoE decodes (MOE_SHAPES:
deepseek-v3-671b.chat's and a batch of 64, dbrx-132b's in the zoo's serve
path and at 16 rows): `device_ms` beside the bound of the filled experts'
bytes and its share, `host_us`, the plain version and the bmm chain over
all experts as the yardstick, with the row check's reading of a planted
fault (one filled expert's fill set to 0), which must fail it;
`expert_route` runs one deepseek-v3-671b prefill and decode step at its
published width (5 layers, 2 of them MoE) and asserts `moe.expert_route`
reads 2 `bmm` on the prefill and 2 `kernel` with 2 launches on the decode.

A fourth path serves the full RecurrentGemma-2B config (26 layers, d_model
2560, vocab 256000; float32 params from seed 0, bf16 activations) with
`serve.Engine(batch_slots=4, profile_kernels=True)`: 8 greedy requests of
512 prompt tokens and 32 new tokens, in two waves, with the launch counts
set to 0 before the engine is made and read after `generate`. The engine's
kernel probe launches each kernel once per config (float32 probe inputs:
matmul and attention `simt`, the scan `tma`); each is then held against
its plain version at the probe's shapes. The model's own decode attention
launches the decode kernel, once a local-attention layer a step: every
`attn.decode_route` call must take it (`decode_routes`), here and in the
zoo's serve paths below. The `serve_path` line gives the
prefill and step seconds, tokens/s, peak memory and the data-sheet bounds;
`serve_consistency` holds decode's logits to `forward`'s at float32
activations for prompts of 512 and 2048 (= local_window, so the ring
wraps).

Five more serve paths follow, one `zoo_serve` line each (ZOO): the rest of
the LM zoo through `serve.Engine(batch_slots=4, profile_kernels=True)`, 8
greedy requests of 512 random prompt tokens (whisper-tiny: 256) and 16 new
tokens, at the published width, the depth cut only where one card's 80 GB
forces it, and the line names the cut: xlstm-350m (24 layers, whole),
whisper-tiny (4 encoder + 4 decoder layers, whole; 1500 encoder frames),
dbrx-132b (40 -> 2 layers), deepseek-v3-671b (61 -> 4: the 3 dense
layers and one MoE layer) and llama-3.2-vision-90b (100 -> 5: one group of
4 self-attention and 1 cross-attention layers). Whisper's encoder frames
and the VLM's frontend embeddings come from `launch.serve.extra_batch`.
Each line gives the params and bytes, peak memory at init and serving,
both waves' prefill seconds, step p50/p90, tokens/s and the data-sheet
bounds (`serve_bounds`: for MoE, the step's bytes over every expert, which
the bmm route reads, and over only the experts a step can route to);
each probe launch is held against its plain version. The MoE configs'
bf16 decode steps take the routed-only expert kernel pair: every
`moe.expert_route` call counted `kernel` is one launch of it
(`expert_routes`, `launches.moe_experts`); their prefills take bmm. A
`zoo_consistency`
line then holds one decode step to `forward` (prefill prompt - 1 tokens)
at float32 activations, with the check's peak memory; MoE configs at
capacity factor E / top_k so that no token drops.

A tenth path trains the full RecurrentGemma-2B config (float32 params,
bf16 activations, remat "dots") through the training launcher's own
objects (`launch.train.build_training` at its defaults: batch 8, seq 128,
lr 3e-3 cosine, weight decay 0.01) and `train.train_loop.run_training`
with --steps 6, one checkpoint at the last step (keep 1) and
profile_kernels=True, so the loop's probe launches each kernel, each then
held against its plain version. The `train_path` line gives the params,
peak memory after init and during training, the step's p50/p90 (steps
2-6), tokens/s, every step's loss, grad norm and lr, the checkpoint's
seconds and bytes beside the directory's free space, the data-sheet bound
(`train_bounds`) with its share, and the host's enqueue share of a step,
the forward-and-backward and optimizer halves, and the device's kernel
time (`train_split`). `train_restart` runs the reference's fault-tolerance case
on the card (fail at step 15, resume from the step-10 checkpoint, the
final loss within rel 1e-5 of an uninterrupted run), and
`zoo_train_check` holds each smoke config's loss, gradients and one
optimizer update on the card to the port on the CPU at float32.

`dist_path` then runs the distribution layer on a one-rank NCCL process
group (`launch.mesh.init_process_group`, a `file://` rendezvous in the
script's temporary directory) with the (1, 1) ("data", "model") mesh of
`make_host_mesh(1)`, on glm4-9b at its published width (d_model 4096, 32
heads, 2 kv heads, d_ff 13696, vocab 151552, bf16 params, plan fsdp_tp),
each leg held to the same work without a mesh within |err| <= 1e-4 *
max|plain| + 1e-4 * |plain| (float32 activations, TF32 off). Train: 4 of
the 40 layers (2.06 B params, about 16 bytes a param of state with the
float32 master and moments: the cut one 80 GB card forces), from the
launcher's objects (`build_training`: AdamW, data at batch 8 x seq 128);
one step without the mesh, its state copied to the host, then the same
step from the same seed on the mesh's DTensor state (`init_train_state(
mesh=...)`): the loss, grad norm and every leaf of the updated state; a
second step each, timed; then `run_training(mesh=..., profile_kernels=
True)` for 2 more steps, with the launch counts set to 0 just before it
and read just after, each probe kernel then held against its plain
version. Decode: all 40 layers, 4 prompts of 512 tokens, max_len 1024,
prefill, then 8 greedy steps of plain `make_serve_step` and 8 of
`make_serve_step(distributed_cache=True, mesh=...)` on the same tokens,
the cache placed per `decode_state_shardings(seq_shard_threshold=512)`,
so its sequence dim is sharded on "model": every step's logits, step p50
of both, and one more step of each under `torch.profiler` (wall time,
summed host and device self times, the ops that take most of each).
Compress: `compressed_psum` on the NCCL group over a
gradient-sized float32 tensor (4096 x 13696) equals
`simulate_compressed_allreduce` on the same single shard exactly. Ep:
expert parallelism on dbrx-132b at its published width (d_model 6144,
16 experts, top-4, d_ff_expert 10752, GLU, plan fsdp_tp), float32 and
capacity factor E / top_k = 4, so nothing drops: (a) the MoE block alone
(params from seed 0, x [8, 128, 6144] from seed 1), `moe_forward` under
`Hints(moe_impl="expert_parallel")` on the (1, 1) mesh against plain
`moe_forward_scatter` without a mesh, the output, aux and every gradient
of sum(y^2) + aux, both also against `moe_forward_dense`; (b) the model
at 2 of its 40 layers (the zoo's cut), 4 prompts of 512 tokens, prefill
and 8 greedy steps, plainly and expert-parallel on the mesh: every
step's logits and the step p50 both ways; then `serve.Engine` on the
mesh under the same hints serves 4 requests with the probe on, the
launch counts set to 0 just before it and read just after. Pipeline:
`pipeline_apply` on a one-rank ("pod", "data", "model") = (1, 1, 1)
mesh, one stage running the train leg's 4 glm4-9b layers over 4
microbatches of 2 x 128, against the same layers on each microbatch in
order; `bubble_fraction(1, 4)` = 0. Dryrun: `python -m
repro_torch.launch.dryrun` for three cells (glm4-9b train_4k on the
single pod; dbrx-132b train_4k on the multi-pod mesh with --opt
act,epmoe; deepseek-v3-671b decode_32k on the single pod) as parallel
subprocesses on the card machine's CPU, meta tensors on a fake 512-rank
group, under its own torch: each `ok`, its fits check equal to
`DRYRUN_CELLS`' numbers (computed with the reference's arithmetic), its
per-rank FLOPs within 1% of `DRYRUN_CELLS`' count (taken on a CPU under
another torch release: every product with a weight runs on the rank's
own shard, so the split does not follow the release), glm4-9b's useful
share at least 0.80, and its unfused bytes, collective bytes and
roofline terms at the H100's data-sheet rates; the leg names the torch
release. The `dist_path` line gives the world,
mesh, plan and backend, params and bytes per rank, peak memory, every
max difference and the times.

The eleventh path (`hub_path`) tunes RecurrentGemma-2B through the transfer
hub for a device the store has never seen, tpu_v5e_pro: a temporary hub
root is seeded with tpu_v5e and tpu_edge records over the model's 9 tasks
(16 programs a task, as `launch.hub --bootstrap`), then
`launch.train.maybe_autotune(..., source="auto", hub_root=ROOT)` with the
launcher's defaults (cost model 164 -> 512 -> 512 -> 1, 48 trials a task,
the tpu_v5p pool corpus at 16 programs a task, which it bootstraps itself)
fingerprints the target, ranks the sources (tpu_v5e must be nearest),
pre-trains on the mixed pool, tunes the 9 tasks under moses and writes the
winners to an empty registry. A second call must queue nothing and measure
nothing; every winner must be explainable (sources, calibration, the
registry's knobs). `hub_refresh` then calls the lifecycle directly, twice:
the initial version, then the anchored one (`anchor_weights`,
`anchored_train` on the card, the held-out guard), printing the guard's
accuracies, the epoch losses, the distance moved overall and within the
anchor's mask, and the lineage. Each winner launches at its real shape on
bf16 operands from the registry's tpu_v5e_pro entries (one `hub_task` line
each: GEMMs and attention wgmma, the scan tma; the hub tunes 8 distinct
workloads for the 9 tasks, since out_proj and rec_out_proj share one key,
and both launch its winner). The `hub_path` line gives
the bootstrap, fingerprint, pre-train, tune and refresh seconds, the new
measurements, the peak memory and the launches by kernel and variant.
`hub_smoke` runs `python -m repro_torch.launch.hub --smoke --refresh` as a
subprocess on the card; it must exit 0.

The twelfth path (`hub_serve_path`) serves from the same hub root: a
`HubServer` over the launcher's hub (the writer: full-width cost model on
the card, 48 trials a task) with 2 reader processes, which load no torch.
Act 1: one client asks for the model's 9 tasks on tpu_v5e_pro (tune=False),
each key a registry hit with `hub_path`'s knobs, a second round all cache
hits, nothing measured. Act 2: four client processes ask for all 9 tasks on
tpu_v6e (unseen) at once with tune=True; each reader's miss funnels to the
writer, whose `_tune_batch` is counted: no workload key in two jobs, and
every client gets the registry's winners; the writer's params live on the
card and its peak memory rises. Act 3: the four clients hammer the 18
(device, task) pairs for 5 s (zero errors, zero wrong knobs; QPS, and the
readers' merged hit and miss p50/p99). Act 4: kill -9 of one reader
mid-hammer; it is respawned, `endpoints.json` republished, no request
fails, and of `default_serving_slos` on 2 s / 4 s windows (serve-p99 on the
hit path: misses here tune) only reader-respawns fires, once, then clears.
Act 5: nvidia-smi lists no reader or client, none maps torch, each reports
`torch` absent from `sys.modules`. Each served tpu_v6e winner then launches
at its real shape on bf16 operands (one `hub_serve_task` line each; GEMMs
and attention wgmma, the scan tma). `obs_cli` runs `python -m
repro_torch.launch.obs` as subprocesses that must exit 0 and import no
torch: `--watch --once --check` and `--explain` against the live farm,
`--explain` again from disk after shutdown, `--check` and `--report` on
`sched_path`'s flight record with the hub root. `hub_serve_smoke` runs
`python -m repro_torch.launch.hub --smoke --serve` as a subprocess on the
card; it must exit 0.

Kernel times come two ways: `ms`, CUDA events around calls launched back
to back (where a kernel is faster than its wrapper's host work, that is the
host's time), and `device_ms`, the same calls captured into one CUDA graph
and replayed, which the host cannot pace. The library call gets both too.

Every phase prints one JSON line, with `at_s`, the seconds since the
script started. The line before the last is the card's
name and power limit as nvidia-smi prints them; the last line is
{"ok": true, "device": {...}}. Exits non-zero, and prints no result, without
a CUDA card or outside a checkout of the repository. Imports nothing of JAX.
"""
import collections
import contextlib
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
           "flash_attention_wgmma", "rg_lru", "moe_experts")


START = time.perf_counter()


def emit(phase: str, **kw) -> None:
    """One JSON line; `at_s` is the seconds since the script started, so
    each phase's seconds are the difference to the line before."""
    print(json.dumps({"phase": phase, **kw,
                      "at_s": time.perf_counter() - START}), flush=True)


def nvidia_smi(query: str = "--query-gpu=name,power.limit") -> str:
    return subprocess.run(
        ["nvidia-smi", query, "--format=csv,noheader"],
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


# the benchmark's two glm4-9b prefills: (name, B, S padded, H, G, D), causal
PREFILL_SHAPES = (("glm4-9b.longprompt", 16, 4070, 32, 2, 128),
                  ("glm4-9b.chat", 64, 1018, 32, 2, 128))


# the prefill kernel against its plain version: the bf16 elementwise
# tolerance, and each (batch, q head, band of PREFILL_BAND rows)'s relative
# error. The plain version rounds P against the same running max, so the
# two differ by the output's bf16 rounding and the order of float32 sums
PREFILL_BAND = 128
PREFILL_REL_TOL = 1e-2
PREFILL_TOLERANCE = (ATTN_TOLERANCE + "; and ||err|| <= 1e-2 * ||plain|| "
                     "over each (batch, q head, 128-row band)")


def band_rel_err(got, want, band: int = PREFILL_BAND) -> float:
    """The largest ||got - want|| / ||want|| over each (batch, q head,
    band of `band` rows) of [B, S, H, D] outputs (inf where a band of
    zeros in `want` is not zero in `got`)."""
    import torch
    got, want = got.float(), want.float()
    B, S, H, _ = want.shape
    err2 = (got - want).square().sum(dim=-1)         # [B, S, H]
    ref2 = want.square().sum(dim=-1)
    pad = -S % band

    def per_band(x):
        x = torch.nn.functional.pad(x, (0, 0, 0, pad))
        return x.reshape(B, (S + pad) // band, band, H).sum(dim=2)
    err2, ref2 = per_band(err2), per_band(ref2)
    zero = ref2 == 0
    ratio = torch.where(zero, torch.where(err2 == 0, 0.0, float("inf")),
                        err2 / torch.where(zero, 1.0, ref2)).sqrt()
    return float(ratio.max())


def check_prefill(got, want, what: str) -> tuple:
    """The prefill kernel's output within PREFILL_TOLERANCE of its plain
    version's; returns (max abs error, largest band relative error)."""
    tol = ATTN_TOL["bfloat16"]
    err = check_allclose(got, want, tol, tol, what)
    rel = band_rel_err(got, want)
    assert rel <= PREFILL_REL_TOL, \
        f"{what}: a band's relative error {rel} is above {PREFILL_REL_TOL}"
    return err, rel


def planted_fault(q, k, v, got, heads: int = 2):
    """`got` with a planted fault: for batch 0 and its first `heads` q
    heads, causal attention (dense, float32) with one 128-row kv tile,
    [128 j, 128 j + 128) for j = S // 4 // 128, dropped from every row
    from S // 2 on, as a kernel that skipped that tile there would give."""
    import torch
    S, H, D = q.shape[1:]
    k0, r0 = 128 * (S // 4 // 128), S // 2
    pos = torch.arange(S, device=q.device)
    keep = pos[None, :] <= pos[:, None]
    keep &= ~((pos[:, None] >= r0) & (pos[None, :] >= k0)
              & (pos[None, :] < k0 + 128))
    out = got.clone()
    for h in range(heads):
        g = h // (H // k.shape[2])
        s = q[0, :, h].float() @ k[0, :, g].float().T / D ** 0.5
        p = torch.softmax(s.masked_fill(~keep, float("-inf")), dim=-1)
        out[0, :, h] = (p @ v[0, :, g].float()).to(got.dtype)
    return out


def prefill_attention_check(fa, torch_device: str) -> dict:
    """Every case: the prefill kernel (`fa.prefill_attention`, q [B, S, H,
    D] against k, v [B, S, G, D], bf16 out) against
    `prefill_attention_plain` on the card, within PREFILL_TOLERANCE.
    Cases are (B, S, H, G, D, causal, window): group ratios 1, 4 and 16,
    S not a multiple of 64, the zoo's head dims, both q tiles, and k, v
    read through strided views."""
    import torch
    gen = torch.Generator(device=torch_device).manual_seed(5)
    cases = []
    for S in (1, 63, 130, 600):
        for causal, window in ((True, 0), (True, 100), (False, 0)):
            cases.append((2, S, 16, 4, 128, causal, window))
    for H, G in ((4, 4), (16, 1), (32, 2)):
        cases.append((1, 300, H, G, 64, True, 0))
    for D in (64, 80, 120, 128, 192, 256):          # the LM zoo's D
        cases.append((2, 257, 8, 2, D, True, 0))
        cases.append((3, 512, 32, 8, D, True, 0))   # 128-row q tiles
    cases.append((4, 1018, 32, 2, 128, True, 4096))  # a window past S
    cases.append((2, 700, 16, 2, 128, True, 256))   # a sliding window
    worst, worst_rel, ran = 0.0, 0.0, []
    before = fa.prefill_attention.launches
    for B, S, H, G, D, causal, window in cases:
        q = torch.randn((B, S, H, D), generator=gen,
                        device=torch_device).to(torch.bfloat16)
        # k and v as slices of one [B, S, 2, G, D] tensor: strided views
        kv = torch.randn((B, S, 2, G, D), generator=gen,
                         device=torch_device).to(torch.bfloat16)
        k, v = kv[:, :, 0], kv[:, :, 1]
        kw = dict(causal=causal, window=window)
        got = fa.prefill_attention(q, k, v, **kw)
        want = fa.prefill_attention_plain(q, k, v, **kw)
        what = f"prefill attention {(B, S, H, G, D)} {kw}"
        assert got.dtype == torch.bfloat16 and got.shape == q.shape, what
        err, rel = check_prefill(got, want, what)
        worst, worst_rel = max(worst, err), max(worst_rel, rel)
        p = fa.prefill_plan(B, S, H, G, D, q.dtype, causal, window)
        ran.append(f"{B}x{S}x{H}/{G}x{D}/c{int(causal)}w{window}:"
                   f"q{p.q_tile}kv{p.kv_tile}s{p.stages}")
    torch.cuda.synchronize()
    launched = fa.prefill_attention.launches - before
    # CPU tensors take the plain version and count no launch
    assert launched == (len(cases) if torch_device != "cpu" else 0), \
        (launched, len(cases))
    return {"cases": len(ran), "launches": launched, "max_abs_err": worst,
            "max_band_rel_err": worst_rel, "ran": ran}


def prefill_attention_timing(fa, torch_device: str) -> list:
    """One line for each of `PREFILL_SHAPES` (causal) and one for the
    tuning path's flash attention at RecurrentGemma-2B's `self_attn`
    (10, 512, 256; the wgmma kernel's result and time do not depend on the
    tuned blocks): held against the plain version (a prefill shape also
    gives `planted_fault`'s band reading, which must fail the check and
    does not count in `max_band_rel_err`), then the kernel's
    `ms` and `device_ms`, the plain version's `plain_ms` and SDPA's
    `library_ms` / `library_device_ms` (the yardstick; the port never
    calls it: for the prefill on K and V expanded to H heads beforehand,
    outside the timed call), beside the bound."""
    import torch
    import torch.nn.functional as F
    gen = torch.Generator(device=torch_device).manual_seed(6)
    tol = ATTN_TOL["bfloat16"]
    lines = []
    for name, B, S, H, G, D in PREFILL_SHAPES:
        q = torch.randn((B, S, H, D), generator=gen,
                        device=torch_device).to(torch.bfloat16)
        k, v = (torch.randn((B, S, G, D), generator=gen,
                            device=torch_device).to(torch.bfloat16)
                for _ in range(2))
        got = fa.prefill_attention(q, k, v, causal=True)
        want = fa.prefill_attention_plain(q, k, v, causal=True)
        err, rel = check_prefill(got, want, name)
        fault = band_rel_err(planted_fault(q, k, v, got), want)
        assert fault > PREFILL_REL_TOL, (name, fault)
        del got, want
        kernel = lambda: fa.prefill_attention(q, k, v, causal=True)  # noqa: E731,E501
        plain = lambda: fa.prefill_attention_plain(q, k, v, causal=True)  # noqa: E731,E501
        qh, kh, vh = (t.transpose(1, 2) for t in (
            q, k.repeat_interleave(H // G, dim=2),
            v.repeat_interleave(H // G, dim=2)))
        library = lambda: F.scaled_dot_product_attention(  # noqa: E731
            qh, kh, vh, is_causal=True)
        flops = 4.0 * B * H * S * S * D * 0.5
        moved = (2 * B * S * H * D + 2 * B * S * G * D) * 2
        line = {"name": name, "shape": [B, S, H, G, D], "causal": True,
                **dataclasses.asdict(fa.prefill_plan(B, S, H, G, D,
                                                     q.dtype, True, 0)),
                "host_us": host_us(kernel, 5),
                "ms": time_ms(kernel, 5, 3),
                "device_ms": device_ms(kernel, 5, 3),
                "plain_ms": time_ms(plain, 1, 1),
                "library_ms": time_ms(library, 5, 3),
                "library_device_ms": device_ms(library, 5, 3),
                "max_abs_err": err, "max_band_rel_err": rel,
                "planted_fault_band_rel_err": fault}
        line["bytes_ms"] = moved / HBM_BYTES_PER_S * 1e3
        line["ops_ms"] = flops / PEAK_FLOPS["bfloat16"] * 1e3
        line["bound_ms"], line["bound_by"] = bound_of(line["bytes_ms"],
                                                      line["ops_ms"])
        line["bound_share"] = line["bound_ms"] / line["device_ms"]
        line["tflops"] = flops / line["device_ms"] / 1e9
        lines.append(line)
        del q, k, v, qh, kh, vh
        torch.cuda.empty_cache()
    # the tuning path's row: RecurrentGemma-2B's self_attn
    B, S, D = 10, 512, 256
    q, k, v = (torch.randn((B, S, D), generator=gen,
                           device=torch_device).to(torch.bfloat16)
               for _ in range(3))
    kw = dict(causal=True, window=0, block_q=128, block_kv=128)
    err = check_allclose(fa.flash_attention(q, k, v, **kw),
                         fa.flash_attention_plain(q, k, v, **kw), tol, tol,
                         "self_attn")
    kernel = lambda: fa.flash_attention(q, k, v, **kw)  # noqa: E731
    plain = lambda: fa.flash_attention_plain(q, k, v, **kw)  # noqa: E731
    library = lambda: F.scaled_dot_product_attention(  # noqa: E731
        q[None], k[None], v[None], is_causal=True)
    line = {"name": "self_attn (tuning path)", "shape": [B, S, D],
            "causal": True,
            **dataclasses.asdict(fa.plan(B, S, D, q.dtype, 128, 128, True,
                                         0)),
            "host_us": host_us(kernel, 20), "ms": time_ms(kernel, 7, 10),
            "device_ms": device_ms(kernel, 7, 10),
            "plain_ms": time_ms(plain, 3, 1),
            "library_ms": time_ms(library, 7, 10),
            "library_device_ms": device_ms(library, 7, 10),
            "max_abs_err": err}
    line["bytes_ms"], line["ops_ms"] = attention_floor_ms(B, S, D,
                                                          "bfloat16", True)
    line["bound_ms"], line["bound_by"] = bound_of(line["bytes_ms"],
                                                  line["ops_ms"])
    line["bound_share"] = line["bound_ms"] / line["device_ms"]
    lines.append(line)
    return lines


def drawn_model_setup(torch_device: str, layers: int, batch: int,
                      prompt: int, seed: int = 0, arch: str = "glm4-9b"):
    """`arch` (glm4-9b by default) at its published width cut to `layers`
    layers, weights drawn on the device in their dtypes (scales around 1,
    the rest N(0, 0.02)) and `batch` prompts of `prompt` random tokens:
    (cfg, model, params, tokens)."""
    import torch

    from repro_torch.configs import get_config
    from repro_torch.models import build_model
    cfg = get_config(arch)
    if layers != cfg.num_layers:
        cfg = cfg.replace(num_layers=layers)
    model = build_model(cfg)
    gen = torch.Generator(device=torch_device).manual_seed(seed)

    def fill(tree, name=""):
        if isinstance(tree, dict):
            return {k: fill(v, k) for k, v in tree.items()}
        t = torch.empty(tree.shape, dtype=tree.dtype, device=torch_device)
        if name == "scale":
            return t.normal_(1.0, 0.1, generator=gen)
        return t.normal_(0.0, 0.02, generator=gen)

    params = fill(model.abstract_params_and_axes()[0])
    tokens = torch.randint(1, cfg.vocab_size, (batch, prompt),
                           generator=gen, device=torch_device,
                           dtype=torch.int32)
    return cfg, model, params, tokens


def routed(fn, counter: str, routes, kernel, on_card: bool) -> dict:
    """fn() in a fresh metrics registry, synchronised on a card: its
    result (`out`), the metrics counter `counter` by each of `routes`,
    `kernel`'s launches and the seconds."""
    import torch

    from repro_torch.obs import metrics as obs_metrics
    reg = obs_metrics.MetricsRegistry()
    obs_metrics.push_registry(reg)
    before = kernel.launches
    try:
        if on_card:
            torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = fn()
        if on_card:
            torch.cuda.synchronize()
        seconds = time.perf_counter() - t0
    finally:
        obs_metrics.pop_registry(reg)
    return {"out": out,
            "routes": {r: reg.counter(counter, route=r).value
                       for r in routes},
            "launches": kernel.launches - before, "seconds": seconds}


def routed_prefill(prefill, params, tokens) -> dict:
    """One prefill in a fresh metrics registry: the logits,
    `attn.prefill_route` by route, the prefill kernel's launches and the
    seconds."""
    from repro_torch.kernels import flash_attention as fa
    run = routed(lambda: prefill(params, {"tokens": tokens}),
                 "attn.prefill_route", ("kernel", "loop"),
                 fa.prefill_attention, tokens.device.type == "cuda")
    run["logits"] = run.pop("out")[1]
    return run


def prefill_route_share(torch_device: str, batch: int = 2,
                        prompt: int = 1024) -> dict:
    """One glm4-9b prefill at its published width (40 layers, bf16 weights
    drawn on the card) of `batch` prompts of `prompt` tokens, in a fresh
    metrics registry: `attn.prefill_route` by route, the prefill kernel's
    launches, and the seconds."""
    import torch
    from repro_torch.configs import get_config
    cfg, model, params, tokens = drawn_model_setup(
        torch_device, get_config("glm4-9b").num_layers, batch, prompt)
    run = routed_prefill(model.prefill, params, tokens)
    routes = run["routes"]
    out = {"arch": cfg.name, "layers": cfg.num_layers, "batch": batch,
           "prompt": prompt, "routes": routes,
           "kernel_share": routes["kernel"] / max(1.0, sum(routes.values())),
           "launches": run["launches"], "seconds": run["seconds"],
           "finite": bool(torch.isfinite(run["logits"].float()).all())}
    del params, run
    if torch_device != "cpu":
        torch.cuda.empty_cache()
    return out


def prefill_mesh(torch_device: str, tmp: str, layers: int = 2,
                 batch: int = 2, prompt: int = 1024) -> dict:
    """`layers` layers of glm4-9b at its published width (bf16) prefilled
    twice from the same params and tokens: without a mesh, and through
    `make_serve_prefill(mesh=...)` on the (1, 1) ("data", "model") mesh of
    a one-rank process group (NCCL on the card, gloo on the CPU), whose
    attention runs `layout().on_shards` on the DTensors' local shards. The
    logits of both, each row's ||meshed - plain|| / ||plain|| at most
    PREFILL_REL_TOL, and each side's routes and launches. The group is
    left again before it returns."""
    import torch
    import torch.distributed as dist

    from repro_torch.distributed import sharding as sh
    from repro_torch.launch.mesh import init_process_group, make_host_mesh
    from repro_torch.train.train_loop import make_serve_prefill
    cfg, model, params, tokens = drawn_model_setup(torch_device, layers,
                                                   batch, prompt)
    init_process_group(torch_device, init_method="file://" + str(
        Path(tmp) / "prefill_mesh_rendezvous"), rank=0, world_size=1)
    try:
        mesh = make_host_mesh(1)
        dparams = sh.distribute(params, sh.param_shardings(
            params, model.abstract_params_and_axes()[1], mesh,
            cfg.sharding_plan))
        plain = routed_prefill(make_serve_prefill(model), params, tokens)
        meshed = routed_prefill(make_serve_prefill(model, mesh=mesh),
                                dparams, tokens)
        backend = dist.get_backend()
    finally:
        dist.destroy_process_group()
    got = meshed["logits"]
    got = (got.full_tensor() if hasattr(got, "full_tensor") else got).float()
    want = plain["logits"].float()
    assert got.shape == want.shape, (got.shape, want.shape)
    rel = float(((got - want).norm(dim=-1) / want.norm(dim=-1)).max())
    out = {"arch": cfg.name, "layers": layers, "batch": batch,
           "prompt": prompt, "backend": backend,
           "mesh": dict(zip(mesh.mesh_dim_names, mesh.shape)),
           "logits_row_rel_err": rel, "tolerance": PREFILL_REL_TOL,
           **{f"{side}_{key}": run[key] for side, run in
              (("plain", plain), ("meshed", meshed))
              for key in ("routes", "launches", "seconds")}}
    assert rel <= PREFILL_REL_TOL, out
    del params, dparams, plain, meshed
    if torch_device != "cpu":
        torch.cuda.empty_cache()
    return out


# the benchmark's two glm4-9b decodes and the zoo's D 256 local attention:
# (name, B, Sc cache slots, H, G, D, kept slots a row, window, ring). chat:
# 64 rows over a 1288-slot cache with the 1018 prompt slots and 128 steps
# kept (mid-wave); longprompt: 16 rows, 4120 slots, 4070 + 8 kept;
# recurrentgemma-2b's local attention: a 2048-slot ring wrapped once, its
# window 2048 (every slot kept), 10 q heads over 1 kv head
DECODE_SHAPES = (("glm4-9b.chat", 64, 1288, 32, 2, 128, 1146, 0, False),
                 ("glm4-9b.longprompt", 16, 4120, 32, 2, 128, 4078, 0,
                  False),
                 ("recurrentgemma-2b.local", 8, 2048, 10, 1, 256, 2048, 2048,
                  True))
# the decode kernel against its plain version: the bf16 elementwise
# tolerance, and each (row, q head)'s ||err|| / ||plain|| (the plain version
# rounds P against the same running maxes)
DECODE_REL_TOL = 1e-2
DECODE_TOLERANCE = (ATTN_TOLERANCE + "; and ||err|| <= 1e-2 * ||plain|| "
                    "over each (row, q head)")


def decode_inputs(B: int, Sc: int, H: int, G: int, D: int, kept: int,
                  window: int, ring: bool, gen, torch_device: str,
                  strided: bool = False):
    """q [B, H, D], k and v [B, Sc, G, D] (bf16, N(0, 1)), kv_positions and
    cur_pos of a decode: row b keeps `kept` - b slots (at least 1); a ring
    holds positions cur - Sc + 1 .. cur at slot position % Sc, else slots
    0 .. kept - 1 hold positions 0 .. kept - 1 and the rest are empty
    (-1). `strided` takes k and v as slices of one tensor."""
    import torch
    dev = torch_device
    q = torch.randn((B, H, D), generator=gen, device=dev).to(torch.bfloat16)
    if strided:
        kv = torch.randn((B, Sc, 2, G, D), generator=gen,
                         device=dev).to(torch.bfloat16)
        k, v = kv[:, :, 0], kv[:, :, 1]
    else:
        k, v = (torch.randn((B, Sc, G, D), generator=gen,
                            device=dev).to(torch.bfloat16) for _ in range(2))
    slot = torch.arange(Sc, device=dev, dtype=torch.int32)
    n = torch.clamp(kept - torch.arange(B, device=dev, dtype=torch.int32),
                    min=1)
    if ring:
        cur = n + Sc - 1                       # wrapped: every slot written
        pos = cur[:, None] - (cur[:, None] - slot[None, :]) % Sc
    else:
        cur = n - 1
        pos = torch.where(slot[None, :] < n[:, None], slot[None, :], -1)
    return q, k, v, pos.to(torch.int32).contiguous(), cur.to(torch.int32)


def row_rel_err(got, want) -> float:
    """The largest ||got - want|| / ||want|| over each (row, q head) of
    [B, H, D] outputs (inf where a zero row of `want` is not zero)."""
    import torch
    err = (got.float() - want.float()).norm(dim=-1)
    ref = want.float().norm(dim=-1)
    ratio = torch.where(ref == 0, torch.where(err == 0, 0.0, float("inf")),
                        err / torch.where(ref == 0, 1.0, ref))
    return float(ratio.max())


def check_decode(got, want, what: str) -> tuple:
    """The decode kernel's output within DECODE_TOLERANCE of its plain
    version's; returns (max abs error, largest row relative error)."""
    tol = ATTN_TOL["bfloat16"]
    err = check_allclose(got, want, tol, tol, what)
    rel = row_rel_err(got, want)
    assert rel <= DECODE_REL_TOL, \
        f"{what}: a row's relative error {rel} is above {DECODE_REL_TOL}"
    return err, rel


def planted_decode_fault(kv_positions, start: int = 160):
    """A copy of kv_positions with one 16-slot tile (slots start .. start +
    15, kept in every row of DECODE_SHAPES) emptied: the kernel's output on
    it must fail the row check against the plain version on the whole
    cache."""
    dropped = kv_positions.clone()
    dropped[:, start:start + 16] = -1
    return dropped


def decode_attention_check(da, torch_device: str) -> dict:
    """Every case: the decode kernel (`da.decode_attention`) against
    `decode_attention_plain` on the card, within DECODE_TOLERANCE. Cases
    are (B, Sc, H, G, D, kept, window, ring, strided): group ratios 1 to
    20 (two 16-head tiles), the zoo's head dims, short caches, one and many
    kv splits, windows, a wrapped ring, k and v read through strided views;
    then a row with no kept slot, which must be exactly 0."""
    import torch
    gen = torch.Generator(device=torch_device).manual_seed(7)
    cases = [(2, 1, 8, 2, 128, 1, 0, False, False),
             (3, 37, 16, 1, 64, 37, 0, False, False),
             (4, 300, 32, 2, 128, 250, 0, False, True),
             (2, 300, 40, 2, 128, 300, 0, False, False),     # R = 20
             (64, 1288, 32, 2, 128, 1146, 0, False, False),  # chat
             (16, 4120, 32, 2, 128, 4078, 0, False, True),   # longprompt
             (2, 2048, 10, 1, 256, 2048, 2048, True, False),
             (3, 700, 10, 1, 256, 700, 100, True, False),    # window < Sc
             (2, 1500, 6, 6, 64, 1500, 0, False, False)]     # whisper cross
    for D in (64, 80, 120, 128, 192, 256):
        cases.append((2, 513, 16, 2, D, 400, 0, False, False))
        cases.append((1, 3000, 8, 8, D, 3000, 1000, False, False))
    worst, worst_rel, ran = 0.0, 0.0, []
    before = da.decode_attention.launches
    for B, Sc, H, G, D, kept, window, ring, strided in cases:
        q, k, v, pos, cur = decode_inputs(B, Sc, H, G, D, kept, window, ring,
                                          gen, torch_device, strided)
        got = da.decode_attention(q, k, v, pos, cur, window=window)
        want = da.decode_attention_plain(q, k, v, pos, cur, window=window)
        what = f"decode attention {(B, Sc, H, G, D)} kept {kept} " \
            f"window {window} ring {ring}"
        assert got.dtype == torch.bfloat16 and got.shape == q.shape, what
        err, rel = check_decode(got, want, what)
        worst, worst_rel = max(worst, err), max(worst_rel, rel)
        p = da.decode_plan(B, Sc, H, G, D)
        ran.append(f"{B}x{Sc}x{H}/{G}x{D}/w{window}{'r' * ring}:"
                   f"t{p.kv_tile}s{p.stages}x{p.splits}")
    # a row with no kept slot: its positions all -1 (and one past cur)
    q, k, v, pos, cur = decode_inputs(3, 200, 16, 2, 128, 150, 0, False,
                                      gen, torch_device)
    pos[1] = -1
    pos[2] = cur[2] + 1
    got = da.decode_attention(q, k, v, pos, cur)
    assert bool((got[1:].float() == 0).all()), "a row with no kept slot"
    check_decode(got, da.decode_attention_plain(q, k, v, pos, cur),
                 "fully masked rows")
    if torch_device != "cpu":
        torch.cuda.synchronize()
    launched = da.decode_attention.launches - before
    # CPU tensors take the plain version and count no launch
    assert launched == (len(cases) + 1 if torch_device != "cpu" else 0), \
        (launched, len(cases))
    return {"cases": len(ran) + 1, "launches": launched, "max_abs_err": worst,
            "max_row_rel_err": worst_rel, "ran": ran}


def decode_attention_timing(da, torch_device: str) -> list:
    """One line for each of DECODE_SHAPES: held against the plain version
    (`max_row_rel_err`) and, with `planted_decode_fault`'s tile dropped,
    failing that check (`planted_fault_row_rel_err`); then the kernel's
    `ms`, `device_ms` and the wrapper's `host_us` a call, the plain
    version's `plain_ms` (the float32 loop the kernel replaces on the
    card), and SDPA with `enable_gqa` and a boolean mask of the kept slots
    (`library_ms` / `library_device_ms`: the yardstick; the port never
    calls it), beside the bound (`decode_bytes` over 3.35 TB/s)."""
    import torch
    import torch.nn.functional as F

    gen = torch.Generator(device=torch_device).manual_seed(8)
    lines = []
    for name, B, Sc, H, G, D, kept, window, ring in DECODE_SHAPES:
        q, k, v, pos, cur = decode_inputs(B, Sc, H, G, D, kept, window, ring,
                                          gen, torch_device)
        kw = dict(window=window)
        got = da.decode_attention(q, k, v, pos, cur, **kw)
        want = da.decode_attention_plain(q, k, v, pos, cur, **kw)
        err, rel = check_decode(got, want, name)
        fault = row_rel_err(da.decode_attention(
            q, k, v, planted_decode_fault(pos), cur, **kw), want)
        assert fault > DECODE_REL_TOL, (name, fault)
        kernel = lambda: da.decode_attention(q, k, v, pos, cur, **kw)  # noqa: E731,E501
        plain = lambda: da.decode_attention_plain(q, k, v, pos, cur, **kw)  # noqa: E731,E501
        keep = (pos >= 0) & (pos <= cur[:, None])
        if window > 0:
            keep &= pos > cur[:, None] - window
        mask = keep[:, None, None, :]
        qh, kh, vh = q[:, :, None], k.transpose(1, 2), v.transpose(1, 2)
        library = lambda: F.scaled_dot_product_attention(  # noqa: E731
            qh, kh, vh, attn_mask=mask, enable_gqa=True)
        kept_rows = int(keep.sum())
        line = {"name": name, "shape": [B, Sc, H, G, D], "kept_rows":
                kept_rows, "window": window, "ring": ring,
                **dataclasses.asdict(da.decode_plan(B, Sc, H, G, D)),
                "host_us": host_us(kernel, 200),
                "ms": time_ms(kernel, 7, 20),
                "device_ms": device_ms(kernel, 7, 20),
                "plain_ms": time_ms(plain, 3, 3),
                "library_ms": time_ms(library, 7, 20),
                "library_device_ms": device_ms(library, 7, 20),
                "max_abs_err": err, "max_row_rel_err": rel,
                "planted_fault_row_rel_err": fault}
        line["bound_ms"] = da.decode_bytes(B, H, G, D, kept_rows) \
            / HBM_BYTES_PER_S * 1e3
        line["bound_by"] = "bytes"
        line["bound_share"] = line["bound_ms"] / line["device_ms"]
        line["gb_per_s"] = da.decode_bytes(B, H, G, D, kept_rows) \
            / line["device_ms"] / 1e6
        lines.append(line)
        del q, k, v, pos, cur, got, want, kh, vh, mask
        if torch_device != "cpu":
            torch.cuda.empty_cache()
    return lines


def routed_decode(step, params, state, tokens) -> dict:
    """One decode step in a fresh metrics registry: the logits,
    `attn.decode_route` by route, the decode kernel's launches and the
    seconds."""
    from repro_torch.kernels import decode_attention as da
    run = routed(lambda: step(params, state, tokens), "attn.decode_route",
                 ("kernel", "loop"), da.decode_attention,
                 tokens.device.type == "cuda")
    run["logits"] = run.pop("out")[1]
    return run


def decode_route_share(torch_device: str, batch: int = 2,
                       prompt: int = 64) -> dict:
    """glm4-9b at its published width (40 layers, bf16 weights drawn on the
    card): one prefill of `batch` prompts of `prompt` tokens, then one
    decode step in a fresh metrics registry: `attn.decode_route` by route,
    the decode kernel's launches, and the seconds of the step."""
    import torch

    from repro_torch.configs import get_config
    cfg, model, params, tokens = drawn_model_setup(
        torch_device, get_config("glm4-9b").num_layers, batch, prompt)
    state, logits = model.prefill(params, {"tokens": tokens},
                                  max_len=prompt + 16)
    nxt = logits.argmax(dim=-1).to(torch.int32)
    run = routed_decode(model.decode_step, params, state, nxt)
    routes = run["routes"]
    out = {"arch": cfg.name, "layers": cfg.num_layers, "batch": batch,
           "prompt": prompt, "routes": routes,
           "kernel_share": routes["kernel"] / max(1.0, sum(routes.values())),
           "launches": run["launches"], "seconds": run["seconds"],
           "finite": bool(torch.isfinite(run["logits"].float()).all())}
    del params, state, run
    if torch_device != "cpu":
        torch.cuda.empty_cache()
    return out


def decode_mesh(torch_device: str, tmp: str, layers: int = 2,
                batch: int = 2, prompt: int = 1024) -> dict:
    """`layers` layers of glm4-9b at its published width (bf16): the same
    prompts prefilled and one token decoded twice from the same params,
    without a mesh and through `make_serve_prefill` and
    `make_serve_step(mesh=...)` on the (1, 1) ("data", "model") mesh of a
    one-rank process group (NCCL on the card, gloo on the CPU), whose
    decode attention runs `layout().on_shards` on the DTensors' local
    shards. Both decode the token the plain prefill chose. The decode
    logits of both, each row's ||meshed - plain|| / ||plain|| at most
    PREFILL_REL_TOL, and each side's routes, launches and seconds. The
    group is left again before it returns."""
    import torch
    import torch.distributed as dist

    from repro_torch.distributed import sharding as sh
    from repro_torch.launch.mesh import init_process_group, make_host_mesh
    from repro_torch.train.train_loop import (make_serve_prefill,
                                              make_serve_step)
    cfg, model, params, tokens = drawn_model_setup(torch_device, layers,
                                                   batch, prompt)
    max_len = prompt + 16
    init_process_group(torch_device, init_method="file://" + str(
        Path(tmp) / "decode_mesh_rendezvous"), rank=0, world_size=1)
    try:
        mesh = make_host_mesh(1)
        dparams = sh.distribute(params, sh.param_shardings(
            params, model.abstract_params_and_axes()[1], mesh,
            cfg.sharding_plan))
        runs, nxt = {}, None
        for side, m, p in (("plain", None, params), ("meshed", mesh,
                                                     dparams)):
            state, logits = make_serve_prefill(model, max_len, mesh=m)(
                p, {"tokens": tokens})
            if nxt is None:
                nxt = logits.argmax(dim=-1).to(torch.int32)
            runs[side] = routed_decode(make_serve_step(model, mesh=m), p,
                                       state, nxt)
            del state, logits
        backend = dist.get_backend()
    finally:
        dist.destroy_process_group()
    got = runs["meshed"]["logits"]
    got = (got.full_tensor() if hasattr(got, "full_tensor") else got).float()
    want = runs["plain"]["logits"].float()
    assert got.shape == want.shape, (got.shape, want.shape)
    rel = float(((got - want).norm(dim=-1) / want.norm(dim=-1)).max())
    out = {"arch": cfg.name, "layers": layers, "batch": batch,
           "prompt": prompt, "backend": backend,
           "mesh": dict(zip(mesh.mesh_dim_names, mesh.shape)),
           "logits_row_rel_err": rel, "tolerance": PREFILL_REL_TOL,
           **{f"{side}_{key}": run[key] for side, run in runs.items()
              for key in ("routes", "launches", "seconds")}}
    assert rel <= PREFILL_REL_TOL, out
    del params, dparams, runs
    if torch_device != "cpu":
        torch.cuda.empty_cache()
    return out


# The routed-only expert FFN at the zoo's MoE decodes: (name, E, C, d, f,
# tokens, top_k). deepseek-v3-671b.chat's decode step (16 rows, top-8 of
# 256 experts, C 1) and a batch of 64 (C 3); dbrx-132b's decode in the
# zoo's serve path (4 slots, top-4 of 16, C 2) and at 16 rows (C 5).
MOE_SHAPES = (("deepseek-v3-671b.chat", 256, 1, 7168, 2048, 16, 8),
              ("deepseek-v3-671b.b64", 256, 3, 7168, 2048, 64, 8),
              ("dbrx-132b.zoo", 16, 2, 6144, 10752, 4, 4),
              ("dbrx-132b.b16", 16, 5, 6144, 10752, 16, 4))
# the kernel pair against its plain version: the bf16 elementwise
# tolerance (the same rounding points, another summation order), and each
# (expert, row)'s ||err|| / ||plain||
MOE_REL_TOL = 1e-2
MOE_TOLERANCE = (ATTN_TOLERANCE + "; and ||err|| <= 1e-2 * ||plain|| over "
                 "each (expert, row); rows at or past fill exactly 0")


def moe_inputs(E: int, C: int, d: int, f: int, tokens: int, top_k: int,
               gen, torch_device: str):
    """A decode's capacity dispatch drawn on the device: each of `tokens`
    rows picks top_k distinct experts uniformly, each expert keeps
    min(count, C) rows (fill, int32), expert_in [E, C, d] bf16 N(0, 1)
    below fill and 0 past it (as the dispatch leaves it); wi, wg [E, d, f]
    and wo [E, f, d] bf16, N(0, 1 / fan-in). (x, fill, wi, wg, wo)."""
    import torch
    dev = torch_device
    pick = torch.rand((tokens, E), generator=gen, device=dev).argsort(
        dim=1)[:, :top_k]
    fill = torch.clamp(torch.bincount(pick.reshape(-1), minlength=E),
                       max=C).to(torch.int32)
    rows = torch.arange(C, device=dev)
    x = torch.randn((E, C, d), generator=gen, device=dev,
                    dtype=torch.bfloat16)
    x = torch.where((rows[None, :] < fill[:, None])[..., None], x, 0.0)
    wi, wg = (torch.randn((E, d, f), generator=gen, device=dev,
                          dtype=torch.bfloat16).mul_(d ** -0.5)
              for _ in range(2))
    wo = torch.randn((E, f, d), generator=gen, device=dev,
                     dtype=torch.bfloat16).mul_(f ** -0.5)
    return x, fill, wi, wg, wo


def check_moe(got, want, fill, what: str) -> tuple:
    """The kernel pair's output within MOE_TOLERANCE of its plain
    version's; returns (max abs error, largest (expert, row) relative
    error)."""
    import torch
    tol = ATTN_TOL["bfloat16"]
    err = check_allclose(got, want, tol, tol, what)
    rel = row_rel_err(got, want)
    assert rel <= MOE_REL_TOL, \
        f"{what}: an (expert, row)'s relative error {rel} is above " \
        f"{MOE_REL_TOL}"
    past = torch.arange(got.shape[1], device=got.device)[None, :] >= \
        fill[:, None]
    assert bool((got[past] == 0).all()), f"{what}: a row past fill is not 0"
    return err, rel


def moe_experts_check(me, torch_device: str) -> dict:
    """The kernel pair (`me.moe_experts`) against `moe_experts_plain` on
    the card, within MOE_TOLERANCE, over (E, C, d, f, tokens, top_k)
    cases: C from 1 to 16 (one and two 8-wide token tiles), a single
    expert, more items than the grid's CTAs, d and f apart; then every
    expert full, no expert filled (all 0), and weights read through
    strided views."""
    import torch
    gen = torch.Generator(device=torch_device).manual_seed(11)
    cases = [(8, 1, 256, 384, 4, 2), (8, 3, 384, 256, 8, 2),
             (40, 8, 512, 640, 64, 4), (40, 9, 640, 512, 64, 4),
             (5, 16, 1024, 1280, 64, 2), (1, 4, 128, 128, 4, 1),
             (300, 1, 256, 384, 40, 8), (16, 2, 3072, 512, 4, 4)]
    worst, worst_rel, ran = 0.0, 0.0, []
    before = me.moe_experts.launches

    def one(x, fill, wi, wg, wo, what):
        nonlocal worst, worst_rel
        got = me.moe_experts(x, fill, wi, wg, wo)
        want = me.moe_experts_plain(x, fill, wi, wg, wo)
        err, rel = check_moe(got, want, fill, what)
        worst, worst_rel = max(worst, err), max(worst_rel, rel)
        return got

    for E, C, d, f, tokens, top_k in cases:
        x, fill, wi, wg, wo = moe_inputs(E, C, d, f, tokens, top_k, gen,
                                         torch_device)
        one(x, fill, wi, wg, wo, f"experts {(E, C, d, f)}")
        ran.append(f"{E}x{C}x{d}x{f}:{int((fill > 0).sum())}")
    x, fill, wi, wg, wo = moe_inputs(12, 4, 256, 256, 64, 12, gen,
                                     torch_device)
    assert bool((fill == 4).all())
    one(x, fill, wi, wg, wo, "every expert full")
    got = one(x, torch.zeros_like(fill), wi, wg, wo, "no expert filled")
    assert bool((got == 0).all()), "no expert filled"
    big = torch.randn((12, 256, 2, 384), generator=gen, device=torch_device,
                      dtype=torch.bfloat16).mul_(1 / 16)
    # wi and wg read in place, wo (d contiguous no more) through a copy
    one(x, fill, big[:, :, 0, :256], big[:, :, 1, 128:],
        wo.transpose(1, 2).contiguous().transpose(1, 2), "strided weights")
    if torch_device != "cpu":
        torch.cuda.synchronize()
    launched = me.moe_experts.launches - before
    assert launched == (len(cases) + 3 if torch_device != "cpu" else 0), \
        (launched, len(cases))
    return {"cases": len(ran) + 3, "launches": launched,
            "max_abs_err": worst, "max_row_rel_err": worst_rel, "ran": ran}


def moe_experts_timing(me, torch_device: str) -> list:
    """One line for each of MOE_SHAPES: held against the plain version
    (`max_row_rel_err`) and, with one filled expert's fill set to 0,
    failing that check (`planted_fault_row_rel_err`); then the kernel
    pair's `ms`, `device_ms` (CUDA-graph replays) and the wrapper's
    `host_us` a call, the plain version's `plain_ms`, and the bmm chain
    over all E experts (`library_ms` / `library_device_ms`: what the
    dispatch ran before, the yardstick; the port no longer calls it on
    these shapes), beside the bound (`experts_bytes` of the filled
    experts over 3.35 TB/s) and the bytes of all E experts."""
    import torch

    from repro_torch.models.common import silu
    gen = torch.Generator(device=torch_device).manual_seed(12)
    lines = []
    for name, E, C, d, f, tokens, top_k in MOE_SHAPES:
        x, fill, wi, wg, wo = moe_inputs(E, C, d, f, tokens, top_k, gen,
                                         torch_device)
        got = me.moe_experts(x, fill, wi, wg, wo)
        want = me.moe_experts_plain(x, fill, wi, wg, wo)
        err, rel = check_moe(got, want, fill, name)
        planted = fill.clone()
        planted[int(torch.nonzero(fill)[0, 0])] = 0
        fault = row_rel_err(me.moe_experts(x, planted, wi, wg, wo), want)
        assert fault > MOE_REL_TOL, (name, fault)
        kernel = lambda: me.moe_experts(x, fill, wi, wg, wo)  # noqa: E731
        plain = lambda: me.moe_experts_plain(x, fill, wi, wg, wo)  # noqa: E731,E501
        library = lambda: torch.bmm(  # noqa: E731
            silu(torch.bmm(x, wi)) * torch.bmm(x, wg), wo)
        filled, rows = int((fill > 0).sum()), int(fill.sum())
        need = me.experts_bytes(filled, rows, E, C, d, f)
        line = {"name": name, "shape": [E, C, d, f], "tokens": tokens,
                "top_k": top_k, "filled_experts": filled, "rows": rows,
                "host_us": host_us(kernel, 200),
                "ms": time_ms(kernel, 7, 5),
                "device_ms": device_ms(kernel, 7, 5),
                "plain_ms": time_ms(plain, 3, 1),
                "library_ms": time_ms(library, 7, 5),
                "library_device_ms": device_ms(library, 7, 5),
                "max_abs_err": err, "max_row_rel_err": rel,
                "planted_fault_row_rel_err": fault}
        line["bound_ms"] = need / HBM_BYTES_PER_S * 1e3
        line["bound_by"] = "bytes"
        line["bound_share"] = line["bound_ms"] / line["device_ms"]
        line["gb_per_s"] = need / line["device_ms"] / 1e6
        line["all_experts_bound_ms"] = me.experts_bytes(
            E, E * C, E, C, d, f) / HBM_BYTES_PER_S * 1e3
        line["speedup_over_library"] = (line["library_device_ms"]
                                        / line["device_ms"])
        lines.append(line)
        del x, fill, wi, wg, wo, got, want
        if torch_device != "cpu":
            torch.cuda.empty_cache()
    return lines


def expert_route_share(torch_device: str, batch: int = 16,
                       prompt: int = 64, layers: int = 5) -> dict:
    """deepseek-v3-671b at its published width cut to the benchmark's 5
    layers (3 dense, 2 MoE; bf16 weights drawn on the card): one prefill
    of `batch` prompts of `prompt` tokens (C = 40: the bmm route), then one
    decode step (C = 1: the kernel), each in a fresh metrics registry:
    `moe.expert_route` by route, the kernel pair's launches and the
    seconds."""
    import torch

    from repro_torch.kernels import moe_experts as me
    from repro_torch.models.transformer import layer_kinds
    cfg, model, params, tokens = drawn_model_setup(
        torch_device, layers, batch, prompt, arch="deepseek-v3-671b")
    on_card = torch_device != "cpu"

    def run(fn):
        return routed(fn, "moe.expert_route", ("kernel", "bmm"),
                      me.moe_experts, on_card)

    with torch.inference_mode():
        pre = run(lambda: model.prefill(params, {"tokens": tokens},
                                        max_len=prompt + 16))
        state, logits = pre.pop("out")
        nxt = logits.argmax(dim=-1).to(torch.int32)
        dec = run(lambda: model.decode_step(params, state, nxt))
        _, dlogits = dec.pop("out")
    out = {"arch": cfg.name, "layers": cfg.num_layers,
           "moe_layers": layer_kinds(cfg).count("moe_attention"),
           "batch": batch, "prompt": prompt, "prefill": pre, "decode": dec,
           "finite": bool(torch.isfinite(dlogits.float()).all())}
    del params, state, logits, dlogits
    if torch_device != "cpu":
        torch.cuda.empty_cache()
    return out


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
    GEMMs at M = seq). Returns (cfg, AutotuneRun, [(workload, inputs,
    tuned output)])."""
    from repro_torch.configs import get_config
    from repro_torch.launch.train import maybe_autotune

    cfg = get_config(arch)
    run = maybe_autotune("tpu_v5e", cfg, trials=trials,
                         torch_device=torch_device)
    return cfg, run, launch_tuned(cfg, run, torch_device, seed=5,
                                  device="tpu_v5e")


def launch_tuned(cfg, run, torch_device: str, seed: int, device: str,
                 workloads=None) -> list:
    """Launch each of `workloads` (default: the tasks of `run`) once, with
    the config `run.registry` holds for it on the simulated target
    `device`, at the model's real shape on bf16 operands (see
    `drive_lm_path`). Returns [(workload, inputs, tuned output)]."""
    import torch

    from repro_torch.kernels import ops

    ops.set_registry(run.registry)
    gen = torch.Generator(device=torch_device).manual_seed(seed)

    def randn(*shape):
        return torch.randn(shape, generator=gen, device=torch_device).to(
            torch.bfloat16)

    if workloads is None:
        workloads = [t.workload for t in run.result.tasks]
    calls = []
    for wl in workloads:
        if wl.kind == "matmul":
            M, N, K = wl.dims
            args = {"a": randn(M, K), "b": randn(K, N)}
            out = ops.tuned_matmul(args["a"], args["b"], device=device)
        elif wl.kind == "attention":
            S, D = wl.dims
            H, G = cfg.num_heads, cfg.num_kv_heads
            args = {"q": randn(H, S, D),
                    "k": randn(G, S, D).repeat_interleave(H // G, 0),
                    "v": randn(G, S, D).repeat_interleave(H // G, 0),
                    "causal": True, "window": cfg.local_window}
            out = ops.tuned_flash_attention(device=device, **args)
        else:
            S, W = wl.dims
            a, x = scan_inputs(1, S, W, torch.bfloat16, gen, torch_device)
            args = {"a": a, "x": x}
            out = ops.tuned_rg_lru(a, x, device=device)
        calls.append((wl, args, out))
    if torch_device != "cpu":
        torch.cuda.synchronize()
    return calls


def drive_sched_path(torch_device: str, arch: str, trials: int, obs_dir: str,
                     dry_run: bool = False):
    """The scheduled campaign on the same model: `maybe_autotune(...,
    scheduler="gradient", obs=obs_dir)` pre-trains the cost model as the
    serial path does and tunes the model's tasks as one campaign
    (marginal-gain grants, the thread executor, draft-then-verify scoring,
    the flight recorder), then each task's kernel launches once from the
    campaign's registry (`launch_tuned`). Returns (cfg, AutotuneRun,
    calls)."""
    from repro_torch.autotune import registry as registry_mod
    from repro_torch.configs import get_config
    from repro_torch.launch.train import maybe_autotune

    # the campaign's registry starts empty (the serial path's file moves
    # aside): `Registry.ingest` keeps the better of two entries, and each
    # launch below must read the campaign's own winner
    path = Path(registry_mod.Registry().path)
    if path.exists():
        path.rename(path.with_name("serial_" + path.name))
    cfg = get_config(arch)
    run = maybe_autotune("tpu_v5e", cfg, scheduler="gradient", trials=trials,
                         obs=obs_dir, dry_run=dry_run,
                         torch_device=torch_device)
    for t in run.result.tasks:
        assert run.registry.get("tpu_v5e", t.workload).knobs == \
            t.best_config.knobs, t.workload.name
    return cfg, run, launch_tuned(cfg, run, torch_device, seed=6,
                                  device="tpu_v5e")


HUB_TARGET = "tpu_v5e_pro"      # absent from the store until hub_path tunes it
HUB_SEEDED = ("tpu_v5e", "tpu_edge")


def drive_hub_path(torch_device: str, arch: str, hub_root: str,
                   trials: int, dry_run: bool = False) -> tuple:
    """The transfer hub on the same model, for a device it has never seen:
    seed the store with `HUB_SEEDED` over the model's tasks (as `launch.hub
    --bootstrap` does), then `maybe_autotune(HUB_TARGET, source="auto")`
    bootstraps the tpu_v5p pool corpus itself, fingerprints the target,
    ranks the sources, pre-trains on the mixed pool and tunes every task
    (the launcher's defaults). A second call on the same root must serve
    every task with no new measurement; every winner must be explainable,
    with the registry's knobs. The registry starts empty (the scheduled
    campaign's file moves aside). Returns (cfg, AutotuneRun, the second
    AutotuneRun, the numbers of the `hub_path` line)."""
    from repro_torch.autotune import registry as registry_mod
    from repro_torch.autotune.tasks import arch_tasks
    from repro_torch.configs import get_config
    from repro_torch.hub import RecordStore, bootstrap_store
    from repro_torch.launch.train import maybe_autotune

    path = Path(registry_mod.Registry().path)
    if path.exists():
        path.rename(path.with_name("sched_" + path.name))
    cfg = get_config(arch)
    t0 = time.perf_counter()
    seeded = bootstrap_store(RecordStore(os.path.join(hub_root, "store")),
                             HUB_SEEDED, arch_tasks(cfg),
                             programs_per_task=16)
    seed_s = time.perf_counter() - t0
    assert seeded > 0, "the hub root was not empty"
    run = maybe_autotune(HUB_TARGET, cfg, source="auto", hub_root=hub_root,
                         trials=trials, dry_run=dry_run,
                         torch_device=torch_device)
    hub = run.hub.hub
    sel = hub.selection(HUB_TARGET)
    # the reference's own smoke: the near-class clone is the nearest source
    assert sel is not None and sel.best_source == "tpu_v5e", sel.ranked
    again = maybe_autotune(HUB_TARGET, cfg, source="auto", hub_root=hub_root,
                           trials=trials, dry_run=dry_run,
                           torch_device=torch_device)
    assert again.result is None and again.hub.queued == 0, again.hub
    assert again.hub.hub.stats.measurements == 0, again.hub.hub.stats
    assert again.hub.bootstrap_records == 0
    tasks = run.result.tasks
    # the hub queues by workload key: out_proj and rec_out_proj share one
    # (512 x 2560 x 2560), so the job tunes one task fewer than the model
    # has, and the registry serves both from that one winner
    model_tasks = arch_tasks(cfg)[:2] if dry_run else arch_tasks(cfg)
    assert len(tasks) == len({wl.key() for wl in model_tasks}), tasks
    for wl in model_tasks:
        assert run.registry.lookup(HUB_TARGET, wl) is not None, wl.name
    explained = 0
    for t in tasks:
        key = t.workload.key()
        exp = hub.explain(HUB_TARGET, key)
        assert exp is not None, key
        prov = exp["provenance"]
        assert prov.get("sources") and prov.get("calibration"), key
        assert prov["knobs"] == run.registry.entry(HUB_TARGET, key)["knobs"]
        assert prov["knobs"] == dict(t.best_config.knobs), key
        explained += 1
    return cfg, run, again, {
        "target": HUB_TARGET, "seeded_devices": list(HUB_SEEDED),
        "seed_records": seeded, "seed_seconds": seed_s,
        "bootstrap_records": run.hub.bootstrap_records,
        "bootstrap_seconds": run.hub.bootstrap_seconds,
        "fingerprint_seconds": run.hub.fingerprint_seconds,
        "pretrain_seconds": run.pretrain_seconds,
        "tune_seconds": run.tune_seconds,
        "flush_seconds": run.hub.flush_seconds,
        "ranked": sel.ranked, "sources": sel.sources,
        "params_device": sel.params_device, "model_tasks": len(model_tasks),
        "tasks": len(tasks), "queued": run.hub.queued,
        "new_measurements": run.result.total_measurements,
        "second_queued": again.hub.queued,
        "second_new_measurements": again.hub.hub.stats.measurements,
        "explained": explained,
        "store_devices": hub.store.devices(),
        "store_records": {d: hub.store.count(d)
                          for d in hub.store.devices()},
    }


def hub_smoke_cli(root: str, leg: str = "--refresh",
                  timeout_s: float = 600.0) -> dict:
    """`python -m repro_torch.launch.hub --smoke LEG --root ROOT`, one of
    the reference's CI legs (`--refresh`: tuning and continual learning;
    `--serve`: the serving farm), as a subprocess on the card; it must
    exit 0."""
    tag = "[serve-smoke]" if leg == "--serve" else "[hub-smoke]"
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    t0 = time.perf_counter()
    proc = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.hub", "--smoke", leg,
         "--root", root], cwd=ROOT, env=env,
        capture_output=True, text=True, timeout=timeout_s)
    assert proc.returncode == 0 and f"{tag} OK" in proc.stdout, \
        proc.stdout[-4000:] + proc.stderr[-4000:]
    return {"returncode": proc.returncode,
            "seconds": time.perf_counter() - t0,
            "lines": [ln for ln in proc.stdout.splitlines()
                      if ln.startswith(tag)]}


def hub_refresh(hub, device: str) -> dict:
    """Two forced refreshes of `device`'s serving cost model, called on the
    lifecycle directly so that any error fails the phase: the first trains
    the initial version (there is none), the second the anchored one
    (`anchor_weights` and `anchored_train` from the first, then the
    held-out guard). An accepted version must be in the store's lineage and
    may not regress the guard's accuracy beyond its tolerance."""
    import math
    lc = hub.lifecycle
    out = []
    for _ in range(2):
        t0 = time.perf_counter()
        res = lc.refresh(device, trigger="chip_smoke", force=True)
        secs = time.perf_counter() - t0
        lineage = hub.store.model_lineage(device)
        if res.accepted:
            assert res.version in [e["version"] for e in lineage], lineage
            assert hub.store.latest_model_version(device) == res.version
            if not (math.isnan(res.holdout_accuracy_old)
                    or math.isnan(res.holdout_accuracy_new)):
                assert res.holdout_accuracy_new >= \
                    res.holdout_accuracy_old - lc.cfg.guard_eps, res
        else:
            # only the guard may refuse a forced refresh
            assert "regress" in res.reason, res
        out.append({"seconds": secs, **res.to_dict(),
                    "lineage": [e["version"] for e in lineage]})
    assert out[0]["trigger"] == "initial" and out[0]["accepted"], out[0]
    return {"refreshes": out}


SERVE_TARGET = "tpu_v6e"        # a device the store has never seen
SERVE_CLIENTS = 4


def serve_slos():
    """The stock serving SLOs (`default_serving_slos`) on 2 s and 4 s
    windows, as the reference's monitoring e2e test uses them, so that an
    alert fires and clears within the phase. Misses on this farm tune (seconds
    each), so serve-p99 holds the hit path to its ceiling."""
    import dataclasses as dc

    from repro_torch.obs import default_serving_slos
    return [dc.replace(s, key="serve.latency_seconds{path=hit}")
            if s.name == "serve-p99" else s
            for s in default_serving_slos(fast_window_s=2.0,
                                          slow_window_s=4.0)]


def obs_cli_run(argv: list, timeout_s: float = 120.0) -> dict:
    """`python -m repro_torch.launch.obs ARGV` as a subprocess; it must exit
    0 and import no torch (read off `-X importtime`, which lists every
    module the run imports)."""
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    t0 = time.perf_counter()
    proc = subprocess.run(
        [sys.executable, "-X", "importtime", "-m", "repro_torch.launch.obs",
         *argv], cwd=ROOT, env=env, capture_output=True, text=True,
        timeout=timeout_s)
    imported = {ln.rsplit("|", 1)[-1].strip()
                for ln in proc.stderr.splitlines()
                if ln.startswith("import time:")}
    errors = [ln for ln in proc.stderr.splitlines()
              if not ln.startswith("import time:")]
    assert proc.returncode == 0, (argv, proc.stdout[-3000:], errors[-40:])
    assert "repro_torch.launch" in imported and "torch" not in imported, argv
    return {"argv": argv, "returncode": proc.returncode,
            "seconds": time.perf_counter() - t0, "torch_loaded": False,
            "stdout": proc.stdout.splitlines()[-12:]}


def hist_pctl(snap: dict, key: str, p: float):
    """The p-th percentile of the histograms under `key` in a merged scrape
    snapshot (None when empty)."""
    from repro_torch.obs.metrics import hist_percentile
    from repro_torch.obs.timeseries import merge_hist_states
    states = [st for k, st in snap.get("histograms", {}).items()
              if k == key]
    merged = merge_hist_states(states)
    return hist_percentile(merged, p) if merged["count"] else None


def spawn_clients(target, args_of, n: int = SERVE_CLIENTS):
    """`n` spawn processes of `target(*args_of(cid, out_q))`, sharing one
    result queue; returns (processes, queue)."""
    import multiprocessing as mp
    ctx = mp.get_context("spawn")
    out_q = ctx.Queue()
    procs = [ctx.Process(target=target, args=args_of(cid, out_q),
                         daemon=True) for cid in range(n)]
    for p in procs:
        p.start()
    return procs, out_q


def collect(procs, out_q, timeout_s: float) -> list:
    reports = [out_q.get(timeout=timeout_s) for _ in procs]
    for p in procs:
        p.join(10.0)
        assert not p.is_alive(), p
    return reports


def maps_torch(pid: int) -> bool:
    """Whether process `pid` maps libtorch or libcuda."""
    text = Path(f"/proc/{pid}/maps").read_text()
    return "libtorch" in text or "libcuda" in text


def drive_hub_serve_path(torch_device: str, arch: str, hub_root: str,
                         trials: int, dry_run: bool = False,
                         hammer_s: float = 5.0) -> tuple:
    """The hub's serving front end on the root `hub_path` tuned: a
    `HubServer` whose one writer hub (the launcher's: the port's default
    registry, full-width cost model on `torch_device`) tunes, and 2 reader
    processes that serve client processes. Five acts:

      1. registry hits: one client asks for the model's tasks on
         `HUB_TARGET` with tune=False; each key is a registry hit with
         `hub_path`'s knobs (a key the same reader saw already is a cache
         hit), a second round all cache hits, nothing measured;
      2. tune-on-miss: `SERVE_CLIENTS` spawned clients ask for every task on
         `SERVE_TARGET` at once with tune=True; each reader's miss funnels
         to the writer, no workload key is tuned in two jobs, every client
         gets the registry's winners; the writer's params live on
         `torch_device` and its peak memory rose;
      3. hammer: the clients run `get_config` for `hammer_s` over every
         (device, task) pair: zero errors, zero wrong knobs; QPS and the
         readers' merged hit and miss latency percentiles;
      4. kill -9 one reader mid-hammer: respawned, endpoints republished,
         zero failed requests, the reader-respawns SLO fires exactly once
         (nothing before) and clears;
      5. no reader or client maps torch or holds a context (nvidia-smi),
         each reports `torch` absent from `sys.modules`.

    `launch.obs` runs against the live farm (`--watch --once --check`,
    `--explain` through the writer) and after shutdown (`--explain` from
    disk). Returns (cfg, tasks, served registry, the phase line, the
    `obs_cli` runs)."""
    import dataclasses as dc
    import signal

    import torch

    from repro_torch.autotune.registry import Registry
    from repro_torch.autotune.tasks import arch_tasks
    from repro_torch.configs import get_config
    from repro_torch.configs.moses import DEFAULT as MOSES_CFG
    from repro_torch.hub import HubClient, HubServer, TuningHub
    from repro_torch.hub.serving import protocol
    from repro_torch.hub.serving.server import endpoints_path
    from repro_torch.launch import hub as launch_hub
    from repro_torch.launch import obs as obs_mod

    on_card = torch_device != "cpu"
    cfg = get_config(arch)
    tasks = arch_tasks(cfg)
    moses_cfg = MOSES_CFG
    if dry_run:     # maybe_autotune's CI budget, as hub_path's dry run
        moses_cfg = dc.replace(MOSES_CFG, online_epochs=2,
                               adaptation_epochs=2, population_size=32,
                               evolution_rounds=2, top_k_measure=8)
        tasks, trials = tasks[:2], min(trials, 16)
    keys = {wl.key() for wl in tasks}
    hub = TuningHub(hub_root, moses_cfg=moses_cfg, registry=Registry(),
                    trials_per_task=trials, torch_device=torch_device)
    stored = {wl.key(): dict(hub.registry.get(HUB_TARGET, wl).knobs)
              for wl in tasks}
    assert all(hub.registry.lookup(HUB_TARGET, wl) for wl in tasks), \
        "hub_path left no winners"
    jobs = []
    tune_batch = hub._tune_batch

    def counted(device, wls):
        jobs.append(sorted(wl.key() for wl in wls))
        return tune_batch(device, wls)

    hub._tune_batch = counted
    line = {"readers": 2, "clients": SERVE_CLIENTS, "tasks": len(tasks),
            "distinct_keys": len(keys), "serve_target": SERVE_TARGET,
            "hit_target": HUB_TARGET, "slos": [s.name for s in serve_slos()]}
    acts = {}
    obs_runs = []
    t_phase = time.perf_counter()
    with HubServer(hub_root, hub=hub, readers=2, slos=serve_slos()) as srv:
        line["boot_seconds"] = time.perf_counter() - t_phase
        # act 1: registry hits, then cache hits, nothing measured
        t0 = time.perf_counter()
        with HubClient(root=hub_root) as c:
            first = [c.get_config(HUB_TARGET, wl, tune=False) for wl in tasks]
            second = [c.get_config(HUB_TARGET, wl, tune=False)
                      for wl in tasks]
        seen = set()
        for wl, r in zip(tasks, first):
            want = "cache" if wl.key() in seen else "registry"
            seen.add(wl.key())
            assert r.source == want, (wl.name, r.source)
            assert dict(r.config.knobs) == stored[wl.key()], wl.name
        assert [r.source for r in second] == ["cache"] * len(tasks), second
        assert all(dict(r.config.knobs) == stored[wl.key()]
                   for wl, r in zip(tasks, second))
        assert not jobs and hub.stats.measurements == 0
        acts["registry_hits"] = time.perf_counter() - t0
        line["act1_sources"] = dict(collections.Counter(
            r.source for r in first + second))

        # act 2: tune-on-miss for an unseen device, from several clients
        pairs = [[SERVE_TARGET, protocol.workload_to_wire(wl)]
                 for wl in tasks]
        if on_card:
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
        mem0 = torch.cuda.memory_allocated() if on_card else 0
        t0 = time.perf_counter()
        procs, out_q = spawn_clients(
            launch_hub._tune_client_main,
            lambda cid, q: (hub_root, cid, pairs, q))
        reports = collect(procs, out_q, timeout_s=900.0)
        acts["tune_on_miss"] = time.perf_counter() - t0
        flat = [k for job in jobs for k in job]
        assert len(flat) == len(set(flat)), f"a key tuned twice: {jobs}"
        assert set(flat) == keys, (jobs, keys)
        winners = {wl.key(): dict(hub.registry.get(SERVE_TARGET, wl).knobs)
                   for wl in tasks}
        for rep in reports:
            assert not rep["errors"] and not rep["torch_loaded"], rep
            got = {a["key"]: a["knobs"] for a in rep["answers"]}
            assert len(rep["answers"]) == len(tasks) and got == winners, rep
        sel = hub.selection(SERVE_TARGET)
        params_on = sorted({t.device.type
                            for t in sel.pretrained_params.values()})
        assert params_on == [torch.device(torch_device).type], params_on
        if on_card:
            peak = torch.cuda.max_memory_allocated()
            assert peak > mem0, (peak, mem0)
            line["act2_memory_gb"] = {"start": mem0 / 1e9,
                                      "peak": peak / 1e9}
        line.update(
            jobs=jobs, measurements=hub.stats.measurements,
            dedup_skips=hub.stats.dedup_skips,
            writer_params_on=params_on, sources=sel.sources,
            act2_sources=dict(collections.Counter(
                a["source"] for rep in reports for a in rep["answers"])),
            first_answer_s=sorted(min(a["latency_s"] for a in rep["answers"])
                                  for rep in reports),
            last_answer_s=sorted(max(a["latency_s"] for a in rep["answers"])
                                 for rep in reports))
        served = {a["key"]: a for a in reports[0]["answers"]}

        # act 3: the hammer over every (device, task) pair
        pairs = [[dev, protocol.workload_to_wire(wl)]
                 for dev in (HUB_TARGET, SERVE_TARGET) for wl in tasks]
        expect = {f"{dev}|{wl.key()}": dict(hub.registry.get(dev, wl).knobs)
                  for dev in (HUB_TARGET, SERVE_TARGET) for wl in tasks}
        t0 = time.perf_counter()
        hammer = (launch_hub._serve_client_main,
                  lambda cid, q: (hub_root, cid, hammer_s, q, pairs, expect))
        procs, out_q = spawn_clients(*hammer)
        # act 5, while readers and clients are up
        time.sleep(min(2.0, hammer_s / 2))
        pids = {"readers": [r.proc.pid for r in srv._readers],
                "clients": [p.pid for p in procs]}
        line["torch_mapped"] = {k: [maps_torch(p) for p in v]
                                for k, v in pids.items()}
        assert not any(any(v) for v in line["torch_mapped"].values()), line
        if on_card:
            apps = nvidia_smi("--query-compute-apps=pid").splitlines()
            listed = {int(a) for a in apps if a.strip()}
            line["compute_apps"] = sorted(listed)
            # one context, the parent's (nvidia-smi may print pids of
            # another namespace, so the count is the check that binds)
            assert len(listed) <= 1, apps
            assert not listed & set(pids["readers"] + pids["clients"]), \
                (listed, pids)
        reports = collect(procs, out_q, timeout_s=hammer_s + 120.0)
        acts["hammer"] = time.perf_counter() - t0
        n = sum(r["requests"] for r in reports)
        assert sum(r["errors"] for r in reports) == 0, reports
        assert sum(r["wrong"] for r in reports) == 0, reports
        assert not any(r["torch_loaded"] for r in reports), reports
        reader_torch = []
        for ep in srv.endpoints():
            with HubClient(root=hub_root, endpoints=[ep]) as c:
                reader_torch.append(c.stats()["torch_loaded"])
        assert reader_torch == [False, False], reader_torch
        snap = obs_mod._writer_call(hub_root, "metrics")["snapshot"]
        line.update(
            pairs=len(pairs), hammer_seconds=hammer_s, requests=n,
            qps=n / hammer_s,
            hit_p50_ms=1e3 * hist_pctl(snap, "serve.latency_seconds{path=hit}",
                                       50),
            hit_p99_ms=1e3 * hist_pctl(snap, "serve.latency_seconds{path=hit}",
                                       99),
            miss_p50_ms=1e3 * hist_pctl(
                snap, "serve.latency_seconds{path=miss}", 50),
            miss_p99_ms=1e3 * hist_pctl(
                snap, "serve.latency_seconds{path=miss}", 99),
            reader_torch_loaded=reader_torch)

        # act 4: kill -9 one reader mid-hammer
        assert srv.slo.alerts == [] and srv.respawns == 0, srv.slo.alerts
        t0 = time.perf_counter()
        procs, out_q = spawn_clients(*hammer)
        victim = srv._readers[0]
        with HubClient(root=hub_root, endpoints=[
                {"rid": victim.rid, "port": victim.port}]) as c:
            base = c.stats()["served"]
            deadline = time.monotonic() + 60
            while c.stats()["served"] < base + 200 and \
                    time.monotonic() < deadline:
                time.sleep(0.05)
        old_port = victim.port
        os.kill(victim.proc.pid, signal.SIGKILL)
        t_kill = time.perf_counter()
        deadline = time.monotonic() + 60
        while time.monotonic() < deadline:
            eps = json.loads(Path(endpoints_path(hub_root)).read_text())
            if srv.respawns >= 1 and all(e["port"] != old_port
                                         for e in eps["readers"]):
                break
            time.sleep(0.02)
        respawn_s = time.perf_counter() - t_kill
        assert srv.respawns == 1 and len(eps["readers"]) == 2, eps
        reports = collect(procs, out_q, timeout_s=hammer_s + 120.0)
        assert sum(r["errors"] for r in reports) == 0, reports
        assert sum(r["wrong"] for r in reports) == 0, reports
        n_kill = sum(r["requests"] for r in reports)
        # the alert fires within a monitor tick or two of the respawn and
        # clears once the respawn leaves the 4 s window, which may be
        # before the hammer ends: read the transitions, not the state
        deadline = time.monotonic() + 20
        while not srv.slo.alerts and time.monotonic() < deadline:
            time.sleep(0.05)
        assert srv.slo.alerts and srv.slo.alerts[0]["state"] == "firing", \
            srv.slo.alerts
        deadline = time.monotonic() + 30
        while srv.slo.firing() and time.monotonic() < deadline:
            time.sleep(0.1)
        fired = [a for a in srv.slo.alerts if a["state"] == "firing"]
        assert len(fired) == 1 and fired[0]["slo"] == "reader-respawns", \
            srv.slo.alerts
        assert srv.slo.firing() == [], srv.slo.alerts
        acts["kill_respawn"] = time.perf_counter() - t0
        line.update(respawns=srv.respawns, respawn_seconds=respawn_s,
                    kill_hammer_requests=n_kill,
                    alerts=[{k: a.get(k) for k in ("slo", "state")}
                            for a in srv.slo.alerts],
                    health=obs_mod._writer_call(hub_root, "health"))

        # launch.obs against the live farm
        obs_runs.append(obs_cli_run(["--watch", "--once", "--check",
                                     "--root", hub_root]))
        live = obs_cli_run(["--explain", SERVE_TARGET, "attention",
                            "--root", hub_root])
        # the writer's answer carries its registry entry (the launcher's
        # registry, not `<root>/tuned_configs.json` that disk reads)
        assert any("- registry serves:" in ln for ln in live["stdout"]), live
        obs_runs.append(live)
    disk = obs_cli_run(["--explain", SERVE_TARGET, "attention",
                        "--root", hub_root])
    assert not any("- registry serves:" in ln for ln in disk["stdout"]), disk
    obs_runs.append(disk)
    line["acts_seconds"] = acts
    line["seconds"] = time.perf_counter() - t_phase
    # the served winners, as the clients received them
    served_reg = Registry(path=str(Path(hub_root) / "served_winners.json"))
    for wl in tasks:
        a = served[wl.key()]
        served_reg.put(SERVE_TARGET, wl, protocol.config_from_wire(a["knobs"]),
                       None)
    return cfg, tasks, served_reg, line, obs_runs



def sched_summary(run, serial_run, obs_dir: str) -> dict:
    """The campaign's numbers for the `sched_path` line, the serial path's
    beside them, and the recorder's artifacts checked. Seconds named
    `*_simulated` are the simulator's, for the simulated tpu_v5e target;
    the others are the host's clock."""
    from repro_torch.obs import validate_events
    from repro_torch.obs.recorder import EVENTS_NAME, TRACE_NAME, load_trace

    c = run.campaign
    for name in (EVENTS_NAME, TRACE_NAME):
        assert (Path(obs_dir) / name).is_file(), name
    problems = validate_events(load_trace(obs_dir), expect_root="campaign")
    assert problems == [], problems
    s = c.obs_summary
    assert s["problems"] == [], s["problems"]
    spans = ("round.search", "round.measure", "round.update", "tune.finish",
             "exec.measure")
    return {
        "pretrain_seconds": run.pretrain_seconds,
        "campaign_seconds": run.tune_seconds,
        "tasks": len(run.result.tasks), "grants": len(c.trace),
        "grants_by_reason": dict(collections.Counter(
            t.reason for t in c.trace)),
        "measurements": c.total_measurements,
        "spent_seconds_simulated": c.spent_seconds,
        "measured_seconds_simulated": c.measured_seconds,
        "makespan_seconds_simulated": c.wall_seconds,
        "draft_acceptance": c.spec_stats.acceptance,
        "full_model_reduction": c.spec_stats.full_model_reduction,
        "spec_stats": dataclasses.asdict(c.spec_stats),
        "total_best_latency_simulated": run.result.model_latency,
        "obs_wall_seconds": s["total_wall_s"],
        "obs_categories_seconds": s["categories_s"],
        "obs_spans": {k: v for k, v in s["by_name"].items() if k in spans},
        "obs_attributed_pct": s["attributed_pct"],
        "obs_queue_wait": s.get("queue_wait"),
        "serial_measurements": serial_run.result.total_measurements,
        "serial_total_best_latency_simulated":
            serial_run.result.model_latency,
        "serial_tune_seconds": serial_run.tune_seconds,
    }


def sched_farm(torch_device: str, moses_cfg, trials: int = 16,
               programs_per_task: int = 8, epochs: int = 4,
               timeout_s: float = 1.0) -> dict:
    """The reference's replay contract with the cost model on the card in
    the parent: two jobs (tpu_v5e, tpu_edge; four ResNet-18 GEMMs each)
    tuned under moses, once through the thread executor and once through
    the spawn-process farm, both measuring through one FaultInjector map
    (crashes that kill a farm worker, hangs the watchdog must kill, flaky
    transients; no retries, as in tests/test_executor_faults.py). The two
    campaigns must grant, measure, pick and poison identically; while the
    farm is up no worker may hold a CUDA context."""
    import torch

    from repro_torch.autotune.dataset import (generate_records,
                                              training_task_pool)
    from repro_torch.autotune.devices import FaultInjector
    from repro_torch.autotune.tasks import resnet18_tasks
    from repro_torch.core.cost_model import resolve_cost_model
    from repro_torch.sched import (ProcessMeasurementExecutor,
                                   SchedulerConfig,
                                   ThreadMeasurementExecutor, run_campaign)

    source = generate_records(training_task_pool(include_archs=False),
                              moses_cfg.source_device,
                              programs_per_task=programs_per_task, seed=0)
    model = resolve_cost_model("mlp", moses_cfg.cost_model, torch_device)
    params, _ = model.train(model.init(0), source, epochs=epochs)
    tasks = resnet18_tasks()[:4]
    jobs = [("tpu_v5e", tasks), ("tpu_edge", tasks)]
    injector = dict(crash=0.04, hang=0.02, flaky=0.04, seed=13, hang_s=30.0,
                    kill_process=True)
    # one index backward (the ranking loss' scores[ii]) accumulates with
    # atomics on the card unless asked not to; both campaigns must train
    # the same model bit for bit
    deterministic = torch.are_deterministic_algorithms_enabled()
    torch.use_deterministic_algorithms(True, warn_only=True)
    out, runs = {}, {}
    try:
        for backend, cls in (("thread", ThreadMeasurementExecutor),
                             ("process", ProcessMeasurementExecutor)):
            ex = cls(workers=4, retries=0, timeout_s=timeout_s,
                     measure_fn=FaultInjector(**injector))
            t0 = time.perf_counter()
            try:
                res = run_campaign(
                    jobs, moses_cfg, strategy="moses", cost_model=model,
                    pretrained_params=params, source_pool=source, seed=3,
                    trials_per_task=trials,
                    sched=SchedulerConfig(round_trials=4), executor=ex,
                    torch_device=torch_device)
                line = {"wall_seconds": time.perf_counter() - t0,
                        "respawns": ex.respawns,
                        "quarantined": len(ex.quarantined()),
                        "grants": len(res.trace),
                        "measurements": res.total_measurements,
                        "spent_seconds_simulated": res.spent_seconds}
                if backend == "process":
                    pids = [w.proc.pid for w in ex._farm]
                    line["worker_pids"] = pids
                    line["parent_pid"] = os.getpid()
                    # a worker imports no torch: it maps no torch library
                    for pid in pids:
                        assert not maps_torch(pid), pid
                    if torch_device != "cpu":
                        # one context, and no worker's
                        apps = nvidia_smi(
                            "--query-compute-apps=pid,used_memory"
                        ).splitlines()
                        listed = {int(a.split(",")[0]) for a in apps}
                        line["compute_apps"] = apps
                        line["parent_listed"] = listed == {os.getpid()}
                        assert not listed & set(pids), (apps, pids)
                        assert len(listed) <= 1, apps
            finally:
                ex.shutdown()
            out[backend], runs[backend] = line, res
    finally:
        torch.use_deterministic_algorithms(deterministic)

    def picks(res):
        return [[(t.best_config.knobs, t.measured) for t in r.tasks]
                for r in res.results]

    def poisoned(res):
        return [[(c.knobs, i) for c, i, _ in (t.poisoned or [])]
                for r in res.results for t in r.tasks]

    thread, farm = runs["thread"], runs["process"]
    assert farm.trace == thread.trace, "the two campaigns granted differently"
    assert farm.curve() == thread.curve()
    assert picks(farm) == picks(thread)
    assert poisoned(farm) == poisoned(thread)
    n_poisoned = sum(len(p) for p in poisoned(farm))
    assert n_poisoned > 0, "the fault map never fired"
    assert out["process"]["respawns"] > 0, out
    reasons = collections.Counter(t.reason for t in farm.trace)
    return {"jobs": [[d, [w.name for w in ts]] for d, ts in jobs],
            "trials_per_task": trials, "round_trials": 4,
            "injector": injector, "timeout_s": timeout_s,
            "poisoned": n_poisoned, "grants_by_reason": dict(reasons),
            "thread": out["thread"], "process": out["process"]}


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


def _numel(tree) -> int:
    return tree_numel_bytes(tree)[0]


def stack_blocks(cfg, params) -> list:
    """(kind, layers, block params) of the decoder stack; a stacked group's
    params hold all its layers."""
    from repro_torch.models.transformer import stack_plan
    prefix, unit, n_groups, suffix = stack_plan(cfg)
    sp = params["stack"]
    return ([(k, 1, sp["prefix"][f"l{i}"]) for i, k in enumerate(prefix)]
            + [(k, n_groups, sp["groups"][f"b{i}"])
               for i, k in enumerate(unit)]
            + [(k, 1, sp["suffix"][f"l{i}"]) for i, k in enumerate(suffix)])


def serve_bounds(cfg, params, batch: int, prompt: int, max_len: int
                 ) -> dict:
    """Data-sheet bounds of the serve path on an H100 SXM, weights counted
    at bf16 (2 bytes a param). Prefill of one wave (batch x prompt tokens):
    2 FLOPs per weight per token that runs it (an MoE token runs top_k of
    the E experts; cross-attention K/V weights run on the Sc source rows;
    the whisper encoder's weights on its enc_len frames), the attention
    products (QK^T and PV over the kept (q, k) pairs: causal within the
    window for self attention, every source row for cross attention, full
    for the encoder) and the last position's logits, over the bf16 peak;
    or every weight read once. One decode step: every weight it reads once
    (not the encoder's, not the cross K/V projections, whose outputs are
    cached at prefill, and of an untied embedding only the batch's rows)
    plus the caches read once: bf16 KV (GQA: k and v; MLA: the c_kv + k_rope
    latent; cross: the Sc source rows), the float32 RG-LRU carry, the
    float32 mLSTM C/n/m and sLSTM c/n/h/m states, bf16 conv taps. For MoE
    the step's bytes count every expert (`step_*`, what the scatter path
    reads: it runs every expert on its C-row buffer) and, beside them, only
    the min(E, batch * top_k) experts the step can route to
    (`step_routed_*`). Each bound is the larger of bytes over the HBM rate
    and FLOPs over the bf16 peak."""
    from repro_torch.models import cache_length
    d, H, hd = cfg.d_model, cfg.num_heads, cfg.resolved_head_dim
    Sc = cfg.encoder_seq_len or cfg.num_frontend_tokens
    clen = cache_length(cfg, max_len)
    w = min(prompt, clen)
    kept = sum(min(t + 1, w) for t in range(prompt))  # (q, k) pairs a row
    if cfg.mla is not None:
        m = cfg.mla
        pair_flops = 2.0 * H * (m.qk_nope_head_dim + m.qk_rope_head_dim
                                + m.v_head_dim)
        kv_row = (m.kv_lora_rank + m.qk_rope_head_dim) * 2
    else:
        pair_flops = 4.0 * H * hd
        kv_row = cfg.num_kv_heads * hd * 2 * 2
    cw = cfg.conv_width - 1
    tokens = batch * prompt
    flops, step_params, experts, routed, cache = 0.0, 0, 0, 0, 0
    for kind, layers, blk in stack_blocks(cfg, params):
        n = _numel(blk)
        if kind == "moe_attention":
            mo = cfg.moe
            ex = sum(_numel(blk["moe"][k]) for k in ("wi", "wg", "wo")
                     if k in blk["moe"])
            n -= ex
            experts += ex
            routed += ex * min(mo.num_experts,
                               batch * mo.top_k) // mo.num_experts
            flops += 2.0 * ex * mo.top_k / mo.num_experts * tokens
        if kind in ("cross_attention", "encdec_attention"):
            a = blk["attn" if kind == "cross_attention" else "cross_attn"]
            kvp = _numel(a["wk"]) + _numel(a["wv"])
            n -= kvp
            flops += 2.0 * kvp * batch * Sc + (
                pair_flops * batch * prompt * Sc * layers)
            cache += layers * Sc * cfg.num_kv_heads * hd * 2 * 2
        if kind in ("attention", "moe_attention", "encdec_attention"):
            flops += pair_flops * batch * kept * layers
            cache += layers * clen * (kv_row + 4)  # + the int32 positions
        elif kind == "recurrent":
            lru = cfg.lru_width or d
            cache += layers * lru * (4 + cw * 2)
        elif kind == "mlstm":
            D = 2 * d // H
            cache += layers * (H * (D * D + D + 1) * 4 + cw * 2 * d * 2)
        elif kind == "slstm":
            cache += layers * (4 * d * 4 + cw * d * 2)
        flops += 2.0 * n * tokens
        step_params += n
    if cfg.is_encoder_decoder:
        enc = _numel(params["encoder"]) + _numel(params["encoder_norm"])
        flops += (2.0 * enc * batch * Sc
                  + 4.0 * H * hd * batch * Sc * Sc * cfg.encoder_layers)
    embed = params["embed"].numel()
    flops += 2.0 * batch * d * cfg.padded_vocab_size  # last position
    n_params = _numel(params)
    prefill = bound_of(n_params * 2 / HBM_BYTES_PER_S * 1e3,
                       flops / PEAK_FLOPS["bfloat16"] * 1e3)
    head = embed if cfg.tie_embeddings else (
        params["lm_head"].numel() + batch * d)
    step_params += head + _numel(params["final_norm"])
    out = {"prefill_tflop": flops / 1e12,
           "prefill_bound_ms": prefill[0], "prefill_bound_by": prefill[1],
           "cache_gbytes": batch * cache / 1e9}
    for name, ex in (("step", experts), ("step_routed", routed)):
        if name == "step_routed" and not experts:
            continue
        read = (step_params + ex) * 2 + batch * cache
        bound = bound_of(read / HBM_BYTES_PER_S * 1e3,
                         2.0 * (step_params + ex) * batch
                         / PEAK_FLOPS["bfloat16"] * 1e3)
        out.update({f"{name}_gbytes": read / 1e9,
                    f"{name}_bound_ms": bound[0],
                    f"{name}_bound_by": bound[1]})
    if experts:
        out["expert_gbytes"] = experts * 2 / 1e9
    return out


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
    tokens each, in waves of `slots`, with the stub frontend's inputs
    (`launch.serve.extra_batch`) drawn from the same RandomState before the
    prompts, as `launch.serve` draws them; the launch counts are set to 0
    just before the engine is made and read just after `generate`, with
    the decode attention kernel's (the model's, not the probe's) and
    `attn.decode_route` by route. Returns (summary, model, params)."""
    import numpy as np
    import torch

    from repro_torch.kernels import decode_attention as da
    from repro_torch.kernels import moe_experts as me
    from repro_torch.launch.serve import extra_batch
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
    extra = extra_batch(cfg, slots, rng)
    reqs = [Request(prompt=rng.randint(0, cfg.vocab_size, size=prompt).astype(
        np.int32), max_new_tokens=new) for _ in range(requests)]
    reg = obs_metrics.MetricsRegistry()
    obs_metrics.push_registry(reg)
    try:
        reset_launches((mm.matmul, fa.flash_attention, lru.rg_lru,
                        da.decode_attention, me.moe_experts))
        engine = Engine(model, params, max_len=prompt + new + 8,
                        batch_slots=slots, extra_batch=extra,
                        profile_kernels=True, device="tpu_v5e")
        t0 = time.perf_counter()
        engine.generate(reqs)
        if on_card:
            torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches = {"matmul": mm.matmul.launches,
                    "flash_attention": fa.flash_attention.launches,
                    "rg_lru": lru.rg_lru.launches,
                    "decode_attention": da.decode_attention.launches,
                    "moe_experts": me.moe_experts.launches}
        by_variant = {"matmul": dict(mm.matmul.launches_by_variant),
                      "flash_attention": dict(
                          fa.flash_attention.launches_by_variant)}
    finally:
        obs_metrics.pop_registry(reg)
    snap = reg.snapshot()
    hists = snap["histograms"]
    decode_routes = {r: reg.counter("attn.decode_route", route=r).value
                     for r in ("kernel", "loop")}
    expert_routes = {r: reg.counter("moe.expert_route", route=r).value
                     for r in ("kernel", "bmm")}
    pre = reg.histogram("serve.engine.prefill_seconds")
    step = reg.histogram("serve.engine.step_seconds")
    kernel_seconds = {
        k: {c: hists[f"kernel.seconds{{config={c},device=tpu_v5e,"
                     f"kernel={k}}}"]["count"] for c in ("tuned", "default")}
        for k in ("matmul", "attention", "scan")}
    tokens = sum(len(r.out_tokens) for r in reqs)
    summary = {
        "arch": cfg.name, "layers": cfg.num_layers, "d_model": cfg.d_model,
        "vocab": cfg.vocab_size, "param_dtype": cfg.param_dtype,
        "activation_dtype": cfg.activation_dtype, "params": n_params,
        "param_bytes": param_bytes,
        "cast_param_bytes": tree_numel_bytes(engine.params)[1],
        "extra_batch": {k: list(v.shape) for k, v in extra.items()},
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
        "decode_routes": decode_routes, "expert_routes": expert_routes,
        **serve_bounds(cfg, params, slots, prompt, prompt + new + 8)}
    if on_card:  # init's peak (group trees stacked), then serving's
        summary["init_max_memory_allocated_gb"] = init_peak
        summary["max_memory_allocated_gb"] = \
            torch.cuda.max_memory_allocated() / 1e9
    summary["prefill_bound_share"] = (summary["prefill_bound_ms"] / 1e3
                                      / summary["prefill_s_p50"])
    summary["step_bound_share"] = (summary["step_bound_ms"] / 1e3
                                   / summary["step_s_p50"])
    summary["decode_split"] = decode_split(model, engine.params,
                                           torch_device, slots, prompt,
                                           extra=extra)
    del engine
    return summary, model, params


def step_split(step, torch_device: str, steps: int, profiled: int) -> dict:
    """Where one step's time goes: the host's time to enqueue `step()`
    (to its return, no synchronisation) beside its wall time to a
    `torch.cuda.synchronize()`, medians over `steps` calls; then
    `profiled` more calls under torch.profiler: the device's kernel time
    and kernel count per step and the kernels that take most of it.
    Enqueue close to wall, and kernel time far below it, mean the host
    paces the step."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    on_card = torch_device != "cpu"

    def sync():
        if on_card:
            torch.cuda.synchronize()

    sync()
    enqueue, wall = [], []
    for _ in range(steps):
        t0 = time.perf_counter()
        step()
        t1 = time.perf_counter()
        sync()
        enqueue.append(t1 - t0)
        wall.append(time.perf_counter() - t0)
    acts = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if on_card
                                     else [])
    with profile(activities=acts) as prof:
        for _ in range(profiled):
            step()
        sync()
    # the kernels' own events: a CPU op's self device time repeats its
    # kernels' time
    avgs = [e for e in prof.key_averages()
            if e.device_type == DeviceType.CUDA]
    kernel_us = sum(e.self_device_time_total for e in avgs)
    top = sorted(avgs, key=lambda e: -e.self_device_time_total)[:8]
    wall_s = statistics.median(wall)
    return {"steps_timed": steps, "enqueue_s": statistics.median(enqueue),
            "wall_s": wall_s,
            "enqueue_share": statistics.median(enqueue) / wall_s,
            "profiled_steps": profiled,
            "device_kernel_ms_per_step": kernel_us / profiled / 1e3,
            "device_busy_share": kernel_us / profiled / 1e6 / wall_s,
            "kernels_per_step": sum(e.count for e in avgs) / profiled,
            "top_kernels": [{"name": e.key[:80],
                             "per_step": e.count / profiled,
                             "ms_per_step": e.self_device_time_total
                             / profiled / 1e3} for e in top]}


def decode_split(model, params, torch_device: str, batch: int = 4,
                 prompt: int = 512, steps: int = 10, extra=None) -> dict:
    """`step_split` of a decode step on the engine's own (cast) params
    after a prefill of `batch` x `prompt` random tokens: `steps` - 4 timed
    steps after one warm-up, 3 profiled. `extra` (the stub frontend's
    numpy inputs, `batch` rows) joins the prefill's batch."""
    import numpy as np
    import torch

    rng = np.random.RandomState(2)
    toks = torch.as_tensor(rng.randint(0, model.cfg.vocab_size, size=(
        batch, prompt)).astype(np.int32), device=torch_device)
    with torch.inference_mode():
        batch_in = {"tokens": toks, **{
            k: torch.as_tensor(v, device=torch_device)
            for k, v in (extra or {}).items()}}
        state, _ = model.prefill(params, batch_in,
                                 max_len=prompt + steps + 8)
        nxt = toks[:, -1]
        state, _ = model.decode_step(params, state, nxt)  # warm

        def step():
            nonlocal state
            state, _ = model.decode_step(params, state, nxt)
        return step_split(step, torch_device, steps - 4, 3)


def serve_consistency(cfg, params, torch_device: str, prompts, steps: int = 8
                      ) -> dict:
    """Decode against forward at float32 activations (TF32 off), batch 1:
    for each prompt length S, prefill S random tokens and decode `steps`
    more; the prefill's logits and each decode step's must equal
    `forward`'s at that position within |err| <= 1e-4 * max|fwd| + 1e-4 *
    |fwd|, the CPU parity tests' float32 tolerance (the paths differ only
    in summation order: blocked vs single-row attention, log-step vs
    step-by-step scan, chunkwise vs recurrent mLSTM, GEMMs of other
    shapes). S = local_window fills the ring exactly, so decode wraps it:
    each new token overwrites the one that just left the window. Only the
    real vocab's logits set the tolerance: a padded vocab's are -1e30 and
    must be equal. The stub frontend's inputs (one row) are drawn from the
    same RandomState before the tokens. An MoE config must come with a
    capacity factor that drops no token in either path."""
    import numpy as np
    import torch

    from repro_torch.launch.serve import extra_batch
    from repro_torch.models import build_model, cache_length
    model = build_model(cfg.replace(activation_dtype="float32"))
    rng = np.random.RandomState(1)
    V = cfg.vocab_size
    cases = []
    with torch.inference_mode():
        for S in prompts:
            extra = {k: torch.as_tensor(v, device=torch_device)
                     for k, v in extra_batch(cfg, 1, rng).items()}
            toks = torch.as_tensor(rng.randint(
                0, cfg.vocab_size, size=(1, S + steps)).astype(np.int32),
                device=torch_device)
            fwd, _ = model.forward(params, {"tokens": toks, **extra})
            state, lg = model.prefill(params, {"tokens": toks[:, :S],
                                               **extra}, max_len=S + steps)
            sc = cache_length(cfg, S + steps)

            def check(got, ref, what):
                # the padded vocab's logits are -1e30 in both; the
                # tolerance scales with the real vocab's
                assert torch.equal(got[..., V:], ref[..., V:]), what
                got, ref = got[..., :V], ref[..., :V]
                return check_allclose(got, ref, 1e-4,
                                      1e-4 * float(ref.abs().max()), what)

            errs = [check(lg, fwd[:, S - 1], f"prefill S={S}")]
            for s in range(S, S + steps):
                state, lg = model.decode_step(params, state, toks[:, s])
                errs.append(check(lg, fwd[:, s], f"decode S={S} at {s}"))
            cases.append({"prompt": S, "steps": steps, "cache_slots": sc,
                          "wraps": S + steps > sc,
                          "max_abs_err": max(errs),
                          "max_abs_logit": float(
                              fwd[0, S - 1:, :V].abs().max())})
            del fwd, state
    out = {"activation_dtype": "float32",
           "tolerance": "|err| <= 1e-4 * max|fwd| + 1e-4 * |fwd| (the CPU "
                        "parity tests' float32 tolerance; the real vocab's "
                        "logits)",
           "cases": cases}
    if cfg.attention_kind == "local":
        out["not_checked"] = (
            "S > Sc with S % Sc != 0: decode writes position S at slot "
            "S % Sc, over a token still in the window, so decode departs "
            "from forward; a reference property the port reproduces "
            "(ROADMAP Queue 3, tests/test_torch_models.py)")
    return out


# The rest of the LM zoo on the serve path: (arch, layers kept, prompt
# tokens). Width is the published one; depth is cut only where one card's
# 80 GB forces it (None keeps the whole stack). Whisper's real decoder stays
# below 448 tokens, so its prompts are 256.
# the kernels the serve engine's probe (`profile_kernels=True`) launches
PROBE_KERNELS = ("matmul", "flash_attention", "rg_lru")
ZOO = (("xlstm-350m", None, 512),
       ("whisper-tiny", None, 256),
       ("dbrx-132b", 2, 512),
       ("deepseek-v3-671b", 4, 512),
       ("llama-3.2-vision-90b", 5, 512))
ZOO_NEW_TOKENS = 16


def zoo_serve_phase(torch_device: str, cfg, published_layers: int,
                    prompt: int, modules, new: int = ZOO_NEW_TOKENS) -> dict:
    """One configuration of the rest of the zoo on the serve path: the
    `zoo_serve` line (drive_serve_path with 8 requests of `prompt` tokens
    and `new` new tokens in waves of 4, each probe launch held against its
    plain version), then the `zoo_consistency` line: prefill prompt - 1
    tokens, decode one, against `forward` at float32 activations (with its
    peak memory: the float32 copies of the weights are made per call), MoE
    configs at capacity factor E / top_k, so that C >= T and no token drops
    on either path. Frees the card before it returns. Returns the serve
    path's launch counts."""
    import dataclasses

    import torch
    on_card = torch_device != "cpu"
    serve, _, params = drive_serve_path(torch_device, cfg, modules,
                                        prompt=prompt, new=new)
    serve["published_layers"] = published_layers
    serve["depth_cut"] = (
        "none" if cfg.num_layers == published_layers else
        f"{published_layers} -> {cfg.num_layers} layers (one card's 80 GB)")
    serve["probe_check"] = serve_probe_check(cfg, torch_device)
    emit("zoo_serve", **serve)
    sv = serve["launches"]
    if on_card:  # each kernel, in the probe; every decode on the kernel
        assert min(sv[k] for k in PROBE_KERNELS) >= 1, sv
        assert serve["decode_routes"] == {
            "kernel": sv["decode_attention"], "loop": 0}, \
            serve["decode_routes"]
        assert serve["expert_routes"]["kernel"] == sv["moe_experts"], \
            serve["expert_routes"]
    assert serve["requests"] == 8 and \
        serve["tokens_per_request"] == [new], serve
    ccfg, cf = cfg, None
    if cfg.moe is not None:
        cf = cfg.moe.num_experts / cfg.moe.top_k
        ccfg = cfg.replace(moe=dataclasses.replace(cfg.moe,
                                                   capacity_factor=cf))
    if on_card:
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
    check = serve_consistency(ccfg, params, torch_device, (prompt - 1,),
                              steps=1)
    if on_card:
        check["max_memory_allocated_gb"] = \
            torch.cuda.max_memory_allocated() / 1e9
    emit("zoo_consistency", arch=cfg.name, layers=cfg.num_layers,
         capacity_factor=cf, **check)
    del params
    if on_card:
        torch.cuda.empty_cache()
    return {"launches": sv, "launches_by_variant": serve[
        "launches_by_variant"]}


# The training path: the launcher's defaults (batch 8, seq 128, lr 3e-3
# cosine, weight decay 0.01) on the full RecurrentGemma-2B config, 6 steps
TRAIN_ARCH = "recurrentgemma-2b"
TRAIN_STEPS = 6


def train_bounds(cfg, params, batch: int, seq: int, opt_cfg) -> dict:
    """Data-sheet bound of one train step on an H100 SXM, the sum of two
    phases. The forward and backward products over the bf16 peak: 6 FLOPs
    per weight per token (2 forward, 4 backward) for every weight applied
    per token (each leaf of two or more dims: the projections and the
    depthwise conv taps; the embedding gather does none), the attention
    products (QK^T and PV over the kept (q, k) pairs: causal within the
    window; x3 with the backward) and the logits against the embedding
    (tied) or lm_head, x6; remat's recomputation is not counted. The
    optimizer's bytes over the HBM rate: each param read and written, its
    gradient read, each moment read and written at `moment_dtype`, and a
    float32 master read and written. Covers the block kinds of the path it
    bounds (attention, recurrent)."""
    from repro_torch.models.common import tree_leaves
    tokens = batch * seq
    H, hd = cfg.num_heads, cfg.resolved_head_dim
    window = cfg.local_window if cfg.attention_kind == "local" else seq
    kept = sum(min(t + 1, window) for t in range(seq))
    flops = 0.0
    for kind, layers, blk in stack_blocks(cfg, params):
        assert kind in ("attention", "recurrent"), kind
        n = sum(t.numel() for t in tree_leaves(blk) if t.dim() >= 2)
        flops += 6.0 * n * tokens
        if kind == "attention":
            flops += 3 * 4.0 * H * hd * batch * kept * layers
    flops += 6.0 * cfg.d_model * cfg.padded_vocab_size * tokens
    n_params, param_bytes = tree_numel_bytes(params)
    moment = 2 if opt_cfg.moment_dtype == "bfloat16" else 4
    master = 8 if opt_cfg.master_fp32 else 0
    # params read and written, the gradient (the param dtype) read, m and
    # v read and written, the master read and written
    opt_bytes = 3 * param_bytes + n_params * (4 * moment + master)
    flops_ms = flops / PEAK_FLOPS["bfloat16"] * 1e3
    opt_ms = opt_bytes / HBM_BYTES_PER_S * 1e3
    return {"tflop": flops / 1e12, "flops_ms": flops_ms,
            "optimizer_gbytes": opt_bytes / 1e9, "optimizer_ms": opt_ms,
            "bound_ms": flops_ms + opt_ms}


@contextlib.contextmanager
def timed_checkpoints():
    """While entered, times `CheckpointManager.save` (the synchronous copy
    to the host) and `wait` (the file writes of an async save); yields the
    list of their seconds."""
    from repro_torch.train.checkpoint import CheckpointManager as Manager
    orig = Manager.save, Manager.wait
    seconds: list = []

    def timed(fn):
        def run(*a, **kw):
            t0 = time.perf_counter()
            try:
                return fn(*a, **kw)
            finally:
                seconds.append(time.perf_counter() - t0)
        return run

    Manager.save, Manager.wait = map(timed, orig)
    try:
        yield seconds
    finally:
        Manager.save, Manager.wait = orig


def dir_bytes(path: str) -> int:
    return sum(f.stat().st_size for f in Path(path).rglob("*")
               if f.is_file())


def train_split(model, opt, state, data, torch_device: str, steps: int = 3
                ) -> dict:
    """`step_split` of a train step on the state `run_training` returned
    (`steps` timed, 1 profiled; the batches are on the device first), and
    the two halves of one more step apart, each to a synchronisation: the
    forward and backward pass (`loss_and_grads`) and the optimizer's
    `update`."""
    import torch

    from repro_torch.train.train_loop import loss_and_grads, make_train_step
    step_fn = make_train_step(model, opt)
    batches = [{k: torch.as_tensor(v, device=torch_device)
                for k, v in next(data).items()} for _ in range(steps + 2)]
    feed = iter(batches)

    def step():
        nonlocal state
        state, _ = step_fn(state, next(feed))
    split = step_split(step, torch_device, steps, 1)

    def sync():
        if torch_device != "cpu":
            torch.cuda.synchronize()

    t0 = time.perf_counter()
    _, _, grads = loss_and_grads(model, state["params"], batches[-1])
    sync()
    t1 = time.perf_counter()
    opt.update(grads, state["opt"], state["params"])
    sync()
    return {**split, "forward_backward_s": t1 - t0,
            "optimizer_s": time.perf_counter() - t1}


def drive_train_path(torch_device: str, modules, ckpt_dir: str,
                     smoke: bool = False) -> dict:
    """The training path through the launcher's own objects
    (`launch.train.build_training` with --steps 6 --checkpoint-every 6 on
    the full config; `smoke` takes the smoke config, for a CPU rehearsal):
    the train state from `init_train_state` (seed 0), then
    `run_training` with keep_n=1 and profile_kernels=True, so the one save
    is the final one and the probe launches each kernel; the launch counts
    are set to 0 just before the state is made and read just after
    `run_training` returns. The checkpoint directory is removed at the
    end. Returns the `train_path` summary."""
    import math
    import shutil

    import torch

    from repro_torch.kernels.profile import model_workloads
    from repro_torch.launch.train import build_training, parser
    from repro_torch.obs import metrics as obs_metrics
    from repro_torch.train.train_loop import init_train_state, run_training
    mm, fa, lru = modules
    on_card = torch_device != "cpu"
    argv = ["--arch", TRAIN_ARCH, "--steps", str(TRAIN_STEPS),
            "--checkpoint-every", str(TRAIN_STEPS), "--checkpoint-dir",
            ckpt_dir, "--torch-device", torch_device]
    args = parser().parse_args(argv + (["--smoke"] if smoke else []))
    run = build_training(args)
    loop = dataclasses.replace(run.loop, keep_n=1, profile_kernels=True,
                               log_every=1)
    cfg = run.model.cfg
    os.makedirs(ckpt_dir, exist_ok=True)
    reset_launches((mm.matmul, fa.flash_attention, lru.rg_lru))
    if on_card:
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    state = init_train_state(run.model, run.opt, args.seed, torch_device)
    init_peak = 0.0
    if on_card:
        torch.cuda.synchronize()
        init_peak = torch.cuda.max_memory_allocated() / 1e9
        torch.cuda.reset_peak_memory_stats()
    init_s = time.perf_counter() - t0
    n_params, param_bytes = tree_numel_bytes(state["params"])
    free_gb = shutil.disk_usage(ckpt_dir).free / 1e9
    reg = obs_metrics.MetricsRegistry()
    obs_metrics.push_registry(reg)
    logs = []
    try:
        with timed_checkpoints() as saves:
            t0 = time.perf_counter()
            state, hist = run_training(
                run.model, run.opt, run.data, loop, seed=args.seed,
                train_state=state, log_fn=logs.append,
                torch_device=torch_device)
            wall = time.perf_counter() - t0
        launches = {"matmul": mm.matmul.launches,
                    "flash_attention": fa.flash_attention.launches,
                    "rg_lru": lru.rg_lru.launches}
        by_variant = {"matmul": dict(mm.matmul.launches_by_variant),
                      "flash_attention": dict(
                          fa.flash_attention.launches_by_variant)}
    finally:
        obs_metrics.pop_registry(reg)
    peak = torch.cuda.max_memory_allocated() / 1e9 if on_card else 0.0
    ckpt_bytes = dir_bytes(ckpt_dir)
    ckpt_steps = sorted(p.name for p in Path(ckpt_dir).iterdir())
    shutil.rmtree(ckpt_dir)
    steps = reg.histogram("train.step_seconds").state()["window"]
    timed = steps[1:]  # steps 2.. (the first carries the warm-up)
    p50 = statistics.median(timed)
    p90 = sorted(timed)[max(0, int(round(0.9 * len(timed))) - 1)]
    tokens = args.batch * args.seq
    bounds = train_bounds(cfg, state["params"], args.batch, args.seq,
                          run.opt.cfg)
    losses = [h["loss"] for h in hist]
    summary = {
        "arch": cfg.name, "layers": cfg.num_layers, "d_model": cfg.d_model,
        "vocab": cfg.vocab_size, "param_dtype": cfg.param_dtype,
        "activation_dtype": cfg.activation_dtype,
        "remat_policy": cfg.remat_policy,
        "moment_dtype": run.opt.cfg.moment_dtype,
        "master_fp32": run.opt.cfg.master_fp32,
        "params": n_params, "param_bytes": param_bytes,
        "batch": args.batch, "seq": args.seq, "lr": args.lr,
        "steps": len(hist), "init_seconds": init_s,
        "run_training_seconds": wall,
        "step_s": steps, "step_s_p50": p50, "step_s_p90": p90,
        "tokens_per_step": tokens, "tokens_per_s": tokens / p50,
        "loss_first": losses[0], "loss_last": losses[-1], "losses": losses,
        "grad_norm": [h["grad_norm"] for h in hist],
        "lr_by_step": [h["lr"] for h in hist], "loop_log": logs,
        "checkpoint": {"steps_saved": ckpt_steps, "bytes": ckpt_bytes,
                       "seconds": sum(saves),
                       "free_gb_before": free_gb},
        "probe_workloads": {k: list(w.dims) for k, w in
                            model_workloads(cfg).items()},
        "launches": launches, "launches_by_variant": by_variant,
        **bounds}
    summary["bound_share"] = bounds["bound_ms"] / 1e3 / p50
    if on_card:
        summary["init_max_memory_allocated_gb"] = init_peak
        summary["max_memory_allocated_gb"] = peak
    summary["split"] = train_split(run.model, run.opt, state, run.data,
                                   torch_device)
    summary["step_enqueue_share"] = summary["split"]["enqueue_share"]
    assert len(hist) == TRAIN_STEPS, len(hist)
    assert all(math.isfinite(x) for x in losses + summary["grad_norm"]), \
        hist
    assert ckpt_steps == [f"step_{TRAIN_STEPS:08d}"], ckpt_steps
    del state
    if on_card:
        torch.cuda.empty_cache()
    return summary


def train_restart(torch_device: str, tmp: str, total: int = 30,
                  fail_at: int = 15, every: int = 10) -> dict:
    """The reference's own fault-tolerance case on the card
    (tests/test_train.py): smoke xlstm-350m with 2 layers, batch 2, seq
    16, data seed 3, AdamW lr 1e-3; one run uninterrupted, one failing at
    step 15 and resumed from the step-10 checkpoint with the data replayed
    from there. The final losses agree within rel 1e-5."""
    import shutil

    from repro_torch.configs import get_smoke_config
    from repro_torch.models import build_model
    from repro_torch.train.data import DataConfig, data_iterator
    from repro_torch.train.optimizer import AdamW, AdamWConfig
    from repro_torch.train.train_loop import LoopConfig, run_training
    cfg = get_smoke_config("xlstm-350m").replace(num_layers=2)
    model = build_model(cfg)
    opt = AdamW(AdamWConfig(lr=1e-3))

    def data():
        return data_iterator(cfg, DataConfig(batch_size=2, seq_len=16,
                                             seed=3))

    def loop(name):
        return LoopConfig(total_steps=total, checkpoint_every=every,
                          checkpoint_dir=os.path.join(tmp, name),
                          log_every=1000, async_checkpoint=False)

    quiet = dict(log_fn=lambda s: None, torch_device=torch_device)
    t0 = time.perf_counter()
    _, full = run_training(model, opt, data(), loop("full"), **quiet)
    failed = False
    try:
        run_training(model, opt, data(), loop("resumed"),
                     fail_at_step=fail_at, **quiet)
    except RuntimeError as e:
        failed = "simulated node failure" in str(e)
    assert failed, "the run did not fail where asked"
    ckpt_bytes = dir_bytes(os.path.join(tmp, "resumed"))
    it = data()
    for _ in range(every):
        next(it)
    _, resumed = run_training(model, opt, it, loop("resumed"), **quiet)
    seconds = time.perf_counter() - t0
    for name in ("full", "resumed"):
        shutil.rmtree(os.path.join(tmp, name))
    rel = abs(resumed[-1]["loss"] - full[-1]["loss"]) / abs(
        full[-1]["loss"])
    out = {"arch": cfg.name, "layers": cfg.num_layers, "batch": 2,
           "seq": 16, "data_seed": 3, "steps": total,
           "checkpoint_every": every, "fail_at_step": fail_at,
           "resumed_from": every, "resumed_steps": [
               resumed[0]["step"], resumed[-1]["step"]],
           "full_loss_end": [h["loss"] for h in full[-3:]],
           "resumed_loss_end": [h["loss"] for h in resumed[-3:]],
           "final_rel_diff": rel, "tolerance": "rel 1e-5",
           "checkpoint_bytes": ckpt_bytes, "seconds": seconds}
    assert resumed[-1]["step"] == total and rel <= 1e-5, out
    return out


def zoo_train_check(torch_device: str) -> list:
    """Each smoke config's training math on the card against the port on
    the CPU, at float32 activations (TF32 off): from the same seed-0
    params (drawn on the CPU, copied to the card) and the same
    `data_iterator` batch (2 x 16), the loss and every gradient
    (`loss_and_grads`) within 1e-4 * max|cpu| + 1e-4 * |cpu| (plus one
    bf16 ulp for a bf16 param's gradient, which is the float32 gradient
    rounded to bf16), then one
    `make_train_step` on each, whose param updates are compared where the
    CPU's gradient is above that tolerance (Adam moves a weight by about
    lr whatever its gradient's size, so a gradient of rounding noise may
    step either way), within 1e-4 * max|cpu| + 1e-4 * |cpu| plus the
    gradient's tolerance carried through the first step: the update is
    -lr * x / (x + eps) in x = |g| * clip scale (and the weight decay), so
    a gradient within tol_g moves it by up to
    lr * scale * eps * tol_g / (x + eps)^2, which matters where x is a few
    eps. An eleventh case trains glm4-9b (bf16 params at
    full size) with bf16 params, bf16 moments and a float32 master copy,
    whose master updates are compared. Returns one entry per
    case with its worst error as a share of its tolerance."""
    import torch

    from repro_torch.configs import ARCH_IDS, get_smoke_config
    from repro_torch.models import build_model
    from repro_torch.models.common import tree_map
    from repro_torch.train.data import DataConfig, data_iterator
    from repro_torch.train.optimizer import AdamW, AdamWConfig, global_norm
    from repro_torch.train.train_loop import loss_and_grads, make_train_step

    def flat(tree, prefix=""):
        if isinstance(tree, dict):
            return {k2: v2 for k, v in tree.items()
                    for k2, v2 in flat(v, f"{prefix}/{k}").items()}
        return {prefix: tree}

    def share(got, want, mask=None, extra=0.0):
        if want.dtype == torch.bfloat16:
            # the float32 gradient rounded to a bf16 leaf's dtype: a last
            # bit that differs in float32 may round it either way
            extra = extra + torch.exp2(torch.floor(torch.log2(
                want.float().abs().clamp(min=1e-30))) - 7)
        got, want = got.detach().float().cpu(), want.detach().float()
        err = (got - want).abs()
        tol = 1e-4 * float(want.abs().max()) + 1e-4 * want.abs() + extra
        if mask is not None:
            err, tol = err[mask], tol[mask]
        if err.numel() == 0:
            return 0.0
        assert bool(torch.isfinite(got).all())
        return float((err / tol.clamp(min=1e-30)).max())

    cases = [(a, "float32", {}) for a in ARCH_IDS] + [
        ("glm4-9b", "bfloat16", dict(moment_dtype="bfloat16",
                                     master_fp32=True))]
    out = []
    for arch, param_dtype, opt_kw in cases:
        cfg = get_smoke_config(arch).replace(activation_dtype="float32",
                                             param_dtype=param_dtype)
        model = build_model(cfg)
        batch = next(data_iterator(cfg, DataConfig(batch_size=2,
                                                   seq_len=16, seed=0)))
        params = model.init(0, "cpu")
        worst = {}
        states = {}
        for dev in ("cpu", torch_device):
            p = tree_map(lambda t: t.to(dev, copy=True), params)
            opt = AdamW(AdamWConfig(lr=1e-3, **opt_kw))
            states[dev] = (p, opt, {"params": p, "opt": opt.init(p),
                                    "step": torch.zeros(
                                        (), dtype=torch.int32, device=dev)})
        tb = {d: {k: torch.as_tensor(v, device=d) for k, v in batch.items()}
              for d in states}
        ref = loss_and_grads(model, states["cpu"][0], tb["cpu"])
        got = loss_and_grads(model, states[torch_device][0],
                             tb[torch_device])
        worst["loss"] = share(got[0], ref[0])
        gref, ggot = flat(ref[2]), flat(got[2])
        worst["grads"] = max(share(ggot[k], g) for k, g in gref.items())
        before = {k: t.detach().float().clone()
                  for k, t in flat(params).items()}
        for dev, (_, opt, st) in states.items():
            make_train_step(model, opt)(st, tb[dev])
        upd = 0.0
        part = "master" if opt_kw.get("master_fp32") else "params"
        after = {d: flat(st[part] if part == "params" else st["opt"][part])
                 for d, (_, _, st) in states.items()}
        ocfg = states["cpu"][1].cfg
        scale = min(1.0, ocfg.grad_clip_norm / max(float(
            global_norm(ref[2])), 1e-9))
        for k, g in gref.items():
            g = g.float().abs()
            tol_g = 1e-4 * float(g.max()) + 1e-4 * g
            x = g * scale
            carried = (ocfg.lr * scale * ocfg.eps * tol_g
                       / (x + ocfg.eps) ** 2)
            want = after["cpu"][k].float() - before[k]
            have = after[torch_device][k].float().cpu() - before[k]
            upd = max(upd, share(have, want, g > tol_g, carried))
        worst["update"] = upd
        entry = {"arch": arch, "param_dtype": param_dtype,
                 "moment_dtype": opt_kw.get("moment_dtype", "float32"),
                 "master_fp32": opt_kw.get("master_fp32", False),
                 "loss_card": float(got[0]), "loss_cpu": float(ref[0]),
                 "worst_share_of_tolerance": worst}
        out.append(entry)
        assert max(worst.values()) <= 1.0, entry
    return out


DIST_ARCH = "glm4-9b"
DIST_TRAIN_LAYERS = 4       # of 40: 2.06 B params, ~16 bytes each of state
DIST_PROMPTS, DIST_PROMPT, DIST_MAX_LEN, DIST_STEPS = 4, 512, 1024, 8
DIST_TOLERANCE = ("|err| <= 1e-4 * max|plain| + 1e-4 * |plain| (float32 "
                  "activations, TF32 off)")


def dist_err(got, want, what: str) -> float:
    """max |got - want|, asserted within DIST_TOLERANCE of `want`."""
    got, want = got.float(), want.float().to(got.device)
    assert got.shape == want.shape, (what, got.shape, want.shape)
    err = (got - want).abs()
    tol = 1e-4 * want.abs().max() + 1e-4 * want.abs()
    assert bool((err <= tol).all()), f"{what}: max err {float(err.max())}"
    return float(err.max())


def local_numel_bytes(tree) -> tuple:
    """(elements, bytes) this rank holds of a tree of DTensors."""
    from repro_torch.models.common import tree_leaves
    locs = [t.to_local() for t in tree_leaves(tree)]
    return (sum(t.numel() for t in locs),
            sum(t.numel() * t.element_size() for t in locs))


def dist_train_leg(torch_device: str, mesh, modules, tmp: str,
                   smoke: bool) -> dict:
    """The train leg of `dist_path` (see the module docstring)."""
    import shutil

    import torch

    from repro_torch.launch.train import build_training, parser
    from repro_torch.models import build_model
    from repro_torch.models.common import tree_leaves, tree_map
    from repro_torch.train.train_loop import (init_train_state,
                                              make_train_step, run_training)
    mm, fa, lru = modules
    on_card = torch_device != "cpu"
    ckpt_dir = str(Path(tmp) / "dist_ckpt")
    args = parser().parse_args(
        ["--arch", DIST_ARCH, "--steps", "4", "--checkpoint-every", "4",
         "--checkpoint-dir", ckpt_dir, "--torch-device", torch_device]
        + (["--smoke"] if smoke else []))
    run = build_training(args)
    assert run.mesh is None  # one process: the launcher trains without one
    cfg = run.model.cfg.replace(num_layers=min(DIST_TRAIN_LAYERS,
                                               run.model.cfg.num_layers),
                                activation_dtype="float32")
    model = build_model(cfg)
    batches = [next(run.data) for _ in range(2)]

    def sync():
        if on_card:
            torch.cuda.synchronize()

    def timed_step(step, state, batch):
        sync()
        t0 = time.perf_counter()
        state, m = step(state, batch)
        sync()
        return state, m, time.perf_counter() - t0

    # the same two steps without the mesh: step 1 kept on the host
    state = init_train_state(model, run.opt, args.seed, torch_device)
    n_params, param_bytes = tree_numel_bytes(state["params"])
    step = make_train_step(model, run.opt)
    state, m, plain_s1 = timed_step(step, state, batches[0])
    plain = {k: float(m[k]) for k in ("loss", "grad_norm")}
    ref = tree_map(lambda t: t.to("cpu", copy=True), state)
    state, _, plain_s2 = timed_step(step, state, batches[1])
    del state
    if on_card:
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()

    state = init_train_state(model, run.opt, args.seed, torch_device,
                             mesh=mesh)
    local_params, local_bytes = local_numel_bytes(state["params"])
    _, state_bytes = local_numel_bytes(state)
    mstep = make_train_step(model, run.opt, mesh=mesh)
    state, m, mesh_s1 = timed_step(mstep, state, batches[0])
    diffs = {k: abs(float(m[k]) - plain[k]) for k in plain}
    for k in plain:
        assert diffs[k] <= 2e-4 * abs(plain[k]), (k, float(m[k]), plain[k])
    leaf_err = 0.0
    for got, want in zip(tree_leaves(state), tree_leaves(ref)):
        leaf_err = max(leaf_err, dist_err(got.to_local(), want,
                                          "updated leaf"))
    del ref
    state, _, mesh_s2 = timed_step(mstep, state, batches[1])
    step_peak = torch.cuda.max_memory_allocated() / 1e9 if on_card else 0.0

    # the loop on the mesh, with the kernel probe: steps 3 and 4
    loop = dataclasses.replace(run.loop, keep_n=1, profile_kernels=True,
                               log_every=1)
    logs: list = []
    reset_launches((mm.matmul, fa.flash_attention, lru.rg_lru))
    t0 = time.perf_counter()
    state, hist = run_training(model, run.opt, run.data, loop,
                               seed=args.seed, train_state=state,
                               log_fn=logs.append, torch_device=torch_device,
                               mesh=mesh)
    loop_s = time.perf_counter() - t0
    launches = {"matmul": mm.matmul.launches,
                "flash_attention": fa.flash_attention.launches,
                "rg_lru": lru.rg_lru.launches}
    by_variant = {"matmul": dict(mm.matmul.launches_by_variant),
                  "flash_attention": dict(
                      fa.flash_attention.launches_by_variant)}
    shutil.rmtree(ckpt_dir, ignore_errors=True)
    losses = [h["loss"] for h in hist]
    assert [h["step"] for h in hist] == [3, 4], hist
    assert all(map(lambda x: x == x and abs(x) < float("inf"), losses))
    del state
    if on_card:
        torch.cuda.empty_cache()
    return {
        "layers": cfg.num_layers, "depth_cut": f"{cfg.num_layers} of 40 "
        "layers: bf16 params, float32 master and float32 moments are ~16 "
        "bytes a param", "params": n_params, "param_bytes": param_bytes,
        "params_per_rank": local_params, "param_bytes_per_rank": local_bytes,
        "state_bytes_per_rank": state_bytes,
        "batch": args.batch, "seq": args.seq,
        "loss": float(m["loss"]), "plain_loss": plain["loss"],
        "grad_norm": float(m["grad_norm"]),
        "plain_grad_norm": plain["grad_norm"],
        "loss_diff": diffs["loss"], "grad_norm_diff": diffs["grad_norm"],
        "leaf_max_abs_err": leaf_err,
        "step_s": {"plain": [plain_s1, plain_s2], "mesh": [mesh_s1, mesh_s2]},
        "step_max_memory_allocated_gb": step_peak,
        "run_training_seconds": loop_s, "loop_losses": losses,
        "loop_log": logs, "launches": launches,
        "launches_by_variant": by_variant,
        "probe_check": serve_probe_check(cfg, torch_device)}


def dist_decode_leg(torch_device: str, mesh, smoke: bool) -> dict:
    """The decode leg of `dist_path` (see the module docstring)."""
    import numpy as np
    import torch

    from repro_torch.configs import get_config, get_smoke_config
    from repro_torch.distributed import sharding as sh
    from repro_torch.models import build_model
    from repro_torch.train.train_loop import (make_serve_prefill,
                                              make_serve_step)
    on_card = torch_device != "cpu"
    cfg = (get_smoke_config if smoke else get_config)(DIST_ARCH).replace(
        activation_dtype="float32")
    prompt, max_len = (16, 32) if smoke else (DIST_PROMPT, DIST_MAX_LEN)
    model = build_model(cfg)
    if on_card:
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
    params = model.init(0, torch_device)
    n_params, param_bytes = tree_numel_bytes(params)
    dparams = sh.distribute(params, sh.param_shardings(
        params, model.abstract_params_and_axes()[1], mesh, cfg.sharding_plan))
    toks = torch.as_tensor(np.random.RandomState(0).randint(
        0, cfg.vocab_size, (DIST_PROMPTS, prompt)).astype(np.int32),
        device=torch_device)

    def sync():
        if on_card:
            torch.cuda.synchronize()

    def run(prefill, step, p, tokens=None, place=None):
        """Prefill, then DIST_STEPS decode steps on `tokens` (default:
        greedy); returns (state, logits of each, step seconds, tokens)."""
        st, logits = prefill(p, {"tokens": toks})
        if place is not None:
            st = place(st)
        outs, secs, fed = [logits], [], []
        for i in range(DIST_STEPS):
            tok = (tokens[i] if tokens is not None else
                   torch.argmax(logits, dim=-1).to(torch.int32))
            sync()
            t0 = time.perf_counter()
            st, logits = step(p, st, tok)
            sync()
            secs.append(time.perf_counter() - t0)
            outs.append(logits)
            fed.append(tok)
        return st, outs, secs, fed

    def first_k(tree):
        if "k" in tree:
            return tree["k"]
        return next(first_k(v) for v in tree.values()
                    if isinstance(v, dict) and v)

    def traced(step, p, st, tok) -> dict:
        """One more decode step under torch.profiler: its wall time, the
        host's summed self time over the host's events and the device's
        over the kernels, and the host's ops that take most of each
        (name, calls, ms; an op's device time is its kernels')."""
        from torch.autograd import DeviceType
        from torch.profiler import ProfilerActivity, profile
        acts = [ProfilerActivity.CPU] + (
            [ProfilerActivity.CUDA] if on_card else [])
        sync()
        with profile(activities=acts) as prof:
            t0 = time.perf_counter()
            step(p, st, tok)
            sync()
            wall = time.perf_counter() - t0
        events = prof.key_averages()
        host = [e for e in events if e.device_type == DeviceType.CPU]
        kernels = [e for e in events if e.device_type == DeviceType.CUDA]

        def dev_us(e):
            return getattr(e, "self_device_time_total",
                           getattr(e, "self_cuda_time_total", 0.0))

        def top(key):
            return [[e.key, e.count, key(e) / 1e3] for e in sorted(
                host, key=key, reverse=True)[:8] if key(e) > 0]
        return {"wall_ms": wall * 1e3,
                "host_self_ms": sum(e.self_cpu_time_total
                                    for e in host) / 1e3,
                "device_self_ms": sum(dev_us(e) for e in kernels) / 1e3,
                "top_host": top(lambda e: e.self_cpu_time_total),
                "top_device": top(dev_us)}

    specs = model.init_decode_state_specs(DIST_PROMPTS, max_len)
    shardings = sh.decode_state_shardings(
        specs, mesh, DIST_PROMPTS, seq_shard_threshold=min(512, max_len))
    with torch.no_grad():
        plain_step = make_serve_step(model)
        pst, plain, plain_secs, fed = run(
            make_serve_prefill(model, max_len), plain_step, params)
        plain = [t.cpu() for t in plain]
        dist_step = make_serve_step(model, distributed_cache=True, mesh=mesh)
        st, dist, dist_secs, _ = run(
            make_serve_prefill(model, max_len, mesh=mesh), dist_step,
            dparams, tokens=fed,
            place=lambda st: sh.distribute(st, shardings))
        errs = [dist_err(d.to_local(), w, f"decode logits {i}")
                for i, (d, w) in enumerate(zip(dist, plain))]
        trace = {"plain": traced(plain_step, params, pst, fed[-1]),
                 "distributed_cache": traced(dist_step, dparams, st,
                                             fed[-1])}
        del pst
    # the cache [B, Sc, G, D] (with a leading layers dim in a group) keeps
    # its sequence dim sharded on "model" through the steps' slot writes
    from torch.distributed.tensor import Shard
    k = first_k(st["layers"])
    model_dim = list(mesh.mesh_dim_names).index("model")
    assert k.placements[model_dim] == Shard(k.dim() - 3), k.placements
    peak = torch.cuda.max_memory_allocated() / 1e9 if on_card else 0.0
    del params, dparams, st
    if on_card:
        torch.cuda.empty_cache()
    return {
        "layers": cfg.num_layers, "params": n_params,
        "param_bytes": param_bytes, "prompts": DIST_PROMPTS,
        "prompt": prompt, "max_len": max_len, "steps": DIST_STEPS,
        "cache_placements": [str(p) for p in k.placements],
        "prefill_logits_max_abs_err": errs[0],
        "step_logits_max_abs_err": max(errs[1:]),
        "step_s_p50": {"plain": statistics.median(plain_secs),
                       "distributed_cache": statistics.median(dist_secs)},
        "step_s": {"plain": plain_secs, "distributed_cache": dist_secs},
        "trace": trace, "max_memory_allocated_gb": peak}


def dist_compress_leg(torch_device: str) -> dict:
    """The compress leg of `dist_path`: compressed_psum on the default
    group against the simulation on the same single shard."""
    import torch

    from repro_torch.distributed.compression import (
        compressed_psum, simulate_compressed_allreduce)
    gen = torch.Generator(device=torch_device).manual_seed(0)
    x = torch.randn(4096 * 13696, generator=gen, device=torch_device)
    e = torch.zeros_like(x)
    got, new_e = compressed_psum(x, e)
    want, want_e = simulate_compressed_allreduce([x], [e])
    assert torch.equal(got, want) and torch.equal(new_e, want_e[0])
    scale = float(x.abs().max()) / 127
    err = float((got - x).abs().max())
    assert err <= scale * 1.01, (err, scale)
    ms = (time_ms(lambda: compressed_psum(x, e), reps=3, inner=3)
          if torch_device != "cpu" else None)
    return {"numel": x.numel(), "equal_to_simulation": True,
            "max_abs_err_vs_exact": err, "scale": scale, "ms": ms}


EP_ARCH = "dbrx-132b"
EP_TOKENS = (8, 128)        # the block alone: x [8, 128, 6144]
EP_SERVE_LAYERS = 2         # of 40, the zoo's cut (ZOO)


def moe_grads(fn, p, x) -> tuple:
    """(y, aux, grads of sum(y^2) + aux w.r.t. x and every param)."""
    import torch
    req = {k: v.detach().requires_grad_() for k, v in p.items()}
    xr = x.detach().requires_grad_()
    y, aux = fn(req, xr)
    keys = sorted(req)
    grads = torch.autograd.grad((y ** 2).sum() + aux,
                                [xr] + [req[k] for k in keys])
    return (y.detach(), aux.detach(),
            dict(zip(["x"] + keys, grads)))


def dist_ep_leg(torch_device: str, mesh, modules, smoke: bool) -> dict:
    """The ep leg of `dist_path` (see the module docstring)."""
    import dataclasses

    import numpy as np
    import torch

    from repro_torch.configs import get_config, get_smoke_config
    from repro_torch.distributed import sharding as sh
    from repro_torch.distributed.act_sharding import Hints, use_hints
    from repro_torch.launch.serve import extra_batch
    from repro_torch.models import build_model, moe
    from repro_torch.models.common import ParamBuilder
    from repro_torch.serve import Engine, Request
    from repro_torch.train.train_loop import (make_serve_prefill,
                                              make_serve_step)
    mm, fa, lru = modules
    on_card = torch_device != "cpu"
    base = (get_smoke_config if smoke else get_config)(EP_ARCH)
    mo = base.moe
    cf = mo.num_experts / mo.top_k
    cfg = base.replace(activation_dtype="float32", param_dtype="float32",
                       moe=dataclasses.replace(mo, capacity_factor=cf))
    hints = Hints(mesh, ("data",), "model", moe_impl="expert_parallel")

    def sync():
        if on_card:
            torch.cuda.synchronize()

    # (a) the block alone at the published width, float32
    if on_card:
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
    b = ParamBuilder(torch.Generator(device=torch_device).manual_seed(0),
                     "float32")
    moe.init_moe(b, cfg)
    p = b.params["moe"]
    B, S = (2, 16) if smoke else EP_TOKENS
    x = torch.randn(B, S, cfg.d_model, device=torch_device,
                    generator=torch.Generator(device=torch_device)
                    .manual_seed(1))

    def expert_parallel(p_, x_):
        with use_hints(hints):
            return moe.moe_forward(p_, cfg, x_)

    sync()
    t0 = time.perf_counter()
    y_sc, aux_sc, g_sc = moe_grads(
        lambda p_, x_: moe.moe_forward_scatter(p_, cfg, x_), p, x)
    sync()
    t1 = time.perf_counter()
    y_ep, aux_ep, g_ep = moe_grads(expert_parallel, p, x)
    sync()
    block_s = {"scatter": t1 - t0,
               "expert_parallel": time.perf_counter() - t1}
    errs = {"y": dist_err(y_ep, y_sc, "ep output"),
            "aux": dist_err(aux_ep, aux_sc, "ep aux")}
    errs.update({f"grad_{k}": dist_err(g_ep[k], g, f"ep grad {k}")
                 for k, g in g_sc.items()})
    del g_sc, g_ep
    with torch.no_grad():
        y_dense, _ = moe.moe_forward_dense(p, cfg, x)
    dense = {"scatter": dist_err(y_sc, y_dense, "scatter vs dense_mask"),
             "expert_parallel": dist_err(y_ep, y_dense, "ep vs dense_mask")}
    block_peak = torch.cuda.max_memory_allocated() / 1e9 if on_card else 0.0
    n_block = sum(v.numel() for v in p.values())
    del p, x, y_sc, y_ep, y_dense, b
    if on_card:
        torch.cuda.empty_cache()

    # (b) the model at the zoo's cut, served plainly and expert-parallel
    scfg = base.replace(activation_dtype="float32",
                        num_layers=min(EP_SERVE_LAYERS, base.num_layers))
    scfg = scfg.replace(moe=dataclasses.replace(scfg.moe,
                                                capacity_factor=cf))
    model = build_model(scfg)
    params = model.init(0, torch_device)
    dparams = sh.distribute(params, sh.param_shardings(
        params, model.abstract_params_and_axes()[1], mesh,
        scfg.sharding_plan))
    prompt, max_len = (16, 32) if smoke else (DIST_PROMPT, DIST_MAX_LEN)
    toks = torch.as_tensor(np.random.RandomState(0).randint(
        0, scfg.vocab_size, (DIST_PROMPTS, prompt)).astype(np.int32),
        device=torch_device)

    def decode(prefill, step, prm, fed=None):
        st, logits = prefill(prm, {"tokens": toks})
        outs, secs, used = [logits], [], []
        for i in range(DIST_STEPS):
            tok = (fed[i] if fed is not None else
                   torch.argmax(logits, dim=-1).to(torch.int32))
            sync()
            t0 = time.perf_counter()
            st, logits = step(prm, st, tok)
            sync()
            secs.append(time.perf_counter() - t0)
            outs.append(logits)
            used.append(tok)
        return outs, secs, used

    with torch.no_grad():
        plain, plain_secs, fed = decode(make_serve_prefill(model, max_len),
                                        make_serve_step(model), params)
        plain = [t.cpu() for t in plain]
        with use_hints(hints):
            ep, ep_secs, _ = decode(
                make_serve_prefill(model, max_len, mesh=mesh),
                make_serve_step(model, mesh=mesh), dparams, fed)
    step_errs = [dist_err(d.to_local(), w, f"ep decode logits {i}")
                 for i, (d, w) in enumerate(zip(ep, plain))]

    # the engine on the mesh under the same hints, its probe launching
    # each kernel at the model's shapes
    reset_launches((mm.matmul, fa.flash_attention, lru.rg_lru))
    rng = np.random.RandomState(1)
    engine = Engine(model, dparams, max_len=prompt + 16, batch_slots=4,
                    extra_batch=extra_batch(scfg, 4, rng), mesh=mesh,
                    profile_kernels=True)
    reqs = [Request(prompt=rng.randint(0, scfg.vocab_size, size=prompt)
                    .astype(np.int32), max_new_tokens=8) for _ in range(4)]
    t_engine = time.perf_counter()
    with use_hints(hints):
        engine.generate(reqs)
    engine_s = time.perf_counter() - t_engine
    launches = {"matmul": mm.matmul.launches,
                "flash_attention": fa.flash_attention.launches,
                "rg_lru": lru.rg_lru.launches}
    by_variant = {"matmul": dict(mm.matmul.launches_by_variant),
                  "flash_attention": dict(
                      fa.flash_attention.launches_by_variant)}
    assert all(len(r.out_tokens) == 8 for r in reqs), reqs
    peak = torch.cuda.max_memory_allocated() / 1e9 if on_card else 0.0
    del params, dparams, engine
    if on_card:
        torch.cuda.empty_cache()
    return {
        "arch": EP_ARCH, "d_model": cfg.d_model,
        "experts": mo.num_experts, "top_k": mo.top_k,
        "d_ff_expert": mo.d_ff_expert, "plan": base.sharding_plan,
        "block": {"tokens": [B, S], "capacity_factor": cf,
                  "params": n_block, "max_abs_err": errs,
                  "vs_dense_mask": dense,
                  "forward_backward_s": block_s,
                  "max_memory_allocated_gb": block_peak},
        "serve": {"layers": scfg.num_layers, "depth_cut": (
                      f"{base.num_layers} -> {scfg.num_layers} layers "
                      "(the zoo's cut)"),
                  "prompts": DIST_PROMPTS, "prompt": prompt,
                  "steps": DIST_STEPS,
                  "prefill_logits_max_abs_err": step_errs[0],
                  "step_logits_max_abs_err": max(step_errs[1:]),
                  "step_s_p50": {"plain": statistics.median(plain_secs),
                                 "expert_parallel":
                                     statistics.median(ep_secs)},
                  "engine_seconds": engine_s,
                  "max_memory_allocated_gb": peak},
        "launches": launches, "launches_by_variant": by_variant}


PIPE_MICRO, PIPE_BATCH = 4, (2, 128)


def dist_pipeline_leg(torch_device: str, smoke: bool) -> dict:
    """The pipeline leg of `dist_path` (see the module docstring)."""
    import torch
    from torch.distributed.device_mesh import DeviceMesh

    from repro_torch.configs import get_config, get_smoke_config
    from repro_torch.distributed.pipeline import (bubble_fraction,
                                                  pipeline_apply)
    from repro_torch.launch.mesh import group_device_type
    from repro_torch.models import build_model
    from repro_torch.models import transformer as tfm
    on_card = torch_device != "cpu"
    base = (get_smoke_config if smoke else get_config)(DIST_ARCH)
    cfg = base.replace(num_layers=min(DIST_TRAIN_LAYERS, base.num_layers),
                       activation_dtype="float32")
    model = build_model(cfg)
    params = model.init(0, torch_device)
    mesh = DeviceMesh(group_device_type(), torch.arange(1).reshape(1, 1, 1),
                      mesh_dim_names=("pod", "data", "model"))
    b, s = (2, 16) if smoke else PIPE_BATCH
    gen = torch.Generator(device=torch_device).manual_seed(2)
    toks = torch.randint(0, cfg.vocab_size, (PIPE_MICRO, b, s),
                         generator=gen, device=torch_device)
    positions = torch.arange(s, dtype=torch.int32, device=torch_device)

    def stage_fn(stage, h):
        assert stage == 0
        return tfm.stack_forward(params, cfg, h, positions, {})[0]

    with torch.no_grad():
        x = torch.stack([model._embed(params, t) for t in toks])
        if on_card:
            torch.cuda.synchronize()
        t0 = time.perf_counter()
        got = pipeline_apply(stage_fn, x, mesh, num_stages=1)
        if on_card:
            torch.cuda.synchronize()
        pipe_s = time.perf_counter() - t0
        want = torch.stack([stage_fn(0, h) for h in x])
    err = dist_err(got, want, "pipeline vs the layers in order")
    bubble = bubble_fraction(1, PIPE_MICRO)
    assert bubble == 0.0, bubble
    del params
    if on_card:
        torch.cuda.empty_cache()
    return {"arch": DIST_ARCH, "layers": cfg.num_layers,
            "mesh": {"pod": 1, "data": 1, "model": 1},
            "microbatches": PIPE_MICRO, "micro_batch": [b, s],
            "max_abs_err": err, "bubble_fraction": bubble,
            "seconds": pipe_s}


# the dry run's cells under the card machine's torch, each with its fits
# check (`build_lowerable`'s state_bytes_per_device, computed on a CPU and
# equal to the reference's) and its FLOPs a rank, counted on a CPU under
# torch 2.13 (`python -m repro_torch.launch.dryrun`)
DRYRUN_CELLS = (("glm4-9b", "train_4k", "single", "none", 583176200,
                 252166119882752),
                ("dbrx-132b", "train_4k", "multi", "act,epmoe", 2718064136,
                 733318421151744),
                ("deepseek-v3-671b", "decode_32k", "single", "none",
                 6896434464, 717102514176))
DRYRUN_SMOKE_CELLS = (("xlstm-350m", "long_500k", "single", "none",
                       1617871428, 808083456),)
DRYRUN_FLOPS_TOLERANCE = 0.01
# glm4-9b train_4k: model FLOPs over 256 ranks' counted FLOPs
DRYRUN_USEFUL_SHARE = 0.80


def dist_dryrun_leg(tmp: str, smoke: bool) -> dict:
    """The dryrun leg of `dist_path`: `python -m repro_torch.launch.dryrun`
    once a cell, the cells in parallel, each on the meta device of a fake
    512-rank group (no card); each cell's FLOPs a rank held to
    `DRYRUN_CELLS`' count within `DRYRUN_FLOPS_TOLERANCE`, and glm4-9b
    train_4k's useful share to `DRYRUN_USEFUL_SHARE`."""
    import torch
    out_dir = Path(tmp) / "dryrun"
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"),
               REPRO_TORCH_DRYRUN_DIR=str(out_dir), OMP_NUM_THREADS="1",
               CUDA_VISIBLE_DEVICES="")
    t0 = time.perf_counter()
    cells = DRYRUN_SMOKE_CELLS if smoke else DRYRUN_CELLS
    procs = [(cell, subprocess.Popen(
        [sys.executable, "-m", "repro_torch.launch.dryrun", "--arch",
         cell[0], "--shape", cell[1], "--mesh", cell[2], "--opt", cell[3]],
        env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
        text=True)) for cell in cells]
    recs = []
    try:
        for (arch, shape, mesh, opt, want_bytes, want_flops), proc in procs:
            log = proc.communicate(timeout=900)[0]
            assert proc.returncode == 0, log[-3000:]
            mesh_name = ("multi_pod_2x16x16" if mesh == "multi"
                         else "single_pod_16x16")
            suffix = "" if opt == "none" else f"__opt-{opt}"
            rec = json.loads((out_dir / f"{arch}__{shape}__{mesh_name}"
                              f"{suffix}.json").read_text())
            assert rec["status"] == "ok", rec
            assert rec["state_bytes_per_device"] == want_bytes, (
                arch, rec["state_bytes_per_device"], want_bytes)
            flops = rec["cost_analysis"]["flops"]
            assert abs(flops - want_flops) <= \
                DRYRUN_FLOPS_TOLERANCE * want_flops, (arch, flops, want_flops)
            if (arch, shape) == ("glm4-9b", "train_4k"):
                useful = rec["roofline"]["useful_flops_fraction"]
                assert useful >= DRYRUN_USEFUL_SHARE, (arch, useful)
            recs.append({**{k: rec[k] for k in (
                "arch", "shape", "mesh", "opt", "status", "chips",
                "state_bytes_per_device", "param_count", "cost_analysis",
                "collectives", "model_flops", "rates", "roofline",
                "memory_analysis", "step_s", "seconds")},
                "want_flops": want_flops, "flops_vs_want": flops / want_flops})
    finally:
        for _, proc in procs:
            if proc.poll() is None:
                proc.kill()
                proc.wait(timeout=10)
    return {"cells": recs, "torch": torch.__version__,
            "flops_tolerance": DRYRUN_FLOPS_TOLERANCE,
            "seconds": time.perf_counter() - t0}


def drive_dist_path(torch_device: str, modules, tmp: str,
                    smoke: bool = False) -> dict:
    """`dist_path` (see the module docstring): a one-rank process group
    with the device's backend, the (1, 1) host mesh, the three legs, then
    the group is destroyed. `smoke` takes glm4-9b's smoke config, for a
    rehearsal on the CPU (gloo)."""
    import torch
    import torch.distributed as dist

    from repro_torch.launch.mesh import (backend_for, init_process_group,
                                         make_host_mesh)
    t0 = time.perf_counter()
    init_process_group(torch_device, init_method="file://" + str(
        Path(tmp) / "dist_rendezvous"), rank=0, world_size=1)
    try:
        mesh = make_host_mesh(1)
        out = {"arch": DIST_ARCH, "world": dist.get_world_size(),
               "mesh": dict(zip(mesh.mesh_dim_names, mesh.shape)),
               "backend": dist.get_backend(), "tolerance": DIST_TOLERANCE}
        assert out["backend"] == backend_for(torch_device), out
        out["train"] = dist_train_leg(torch_device, mesh, modules, tmp,
                                      smoke)
        out["plan"] = "fsdp_tp"
        out["decode"] = dist_decode_leg(torch_device, mesh, smoke)
        out["compress"] = dist_compress_leg(torch_device)
        t1 = time.perf_counter()
        out["ep"] = dist_ep_leg(torch_device, mesh, modules, smoke)
        out["ep"]["seconds"] = time.perf_counter() - t1
        out["pipeline"] = dist_pipeline_leg(torch_device, smoke)
    finally:
        dist.destroy_process_group()
    out["dryrun"] = dist_dryrun_leg(tmp, smoke)
    out["launches"] = out["train"]["launches"]
    out["launches_by_variant"] = out["train"]["launches_by_variant"]
    out["seconds"] = time.perf_counter() - t0
    if torch_device != "cpu":
        out["nvidia_smi"] = nvidia_smi()
    return out


def cost_model_parity(torch_device: str, moses_cfg) -> dict:
    """Both registered cost models at full width score the same on the card
    as on the CPU (TF32 off; max relative difference below 1e-4), and one
    training epoch of the residual MLP (40 records: one bucket-padded batch
    of 64, the same pairs on both sides) gives the same loss (rel 1e-5),
    gradients (1e-4 * |g| + 1e-5 * max|g|) and Adam step (2e-6 where the
    gradient has a sign; elsewhere Adam turns rounding noise into a step
    of at most lr on either side, as tests/test_torch_cost_model.py
    sets out)."""
    import numpy as np
    import torch

    from repro_torch.autotune.dataset import generate_records
    from repro_torch.autotune.tasks import resnet18_tasks
    from repro_torch.core import cost_model as cm
    cfg = moses_cfg.cost_model
    x = np.random.RandomState(0).rand(64, cfg.feature_dim)
    out = {}
    for name in ("mlp", "residual-mlp"):
        cpu = cm.resolve_cost_model(name, cfg, "cpu")
        card = cm.resolve_cost_model(name, cfg, torch_device)
        params = cpu.init(0)
        want = cpu.predict(params, x)
        got = card.predict(card.clone_params(params), x)
        rel = float(np.max(np.abs(got - want)) / np.max(np.abs(want)))
        assert rel < 1e-4, f"{name} on the card differs from the CPU: {rel}"
        out[name] = {"predict_max_rel_diff": rel}
    # one training epoch of the residual MLP, from its CPU init
    params = cm.resolve_cost_model("residual-mlp", cfg, "cpu").init(0)
    recs = generate_records(resnet18_tasks()[:5], "tpu_v5p",
                            programs_per_task=8, seed=2)
    sub = recs.x[:40], recs.y[:40], recs.g[:40]
    pairs = tuple(np.random.RandomState(3).randint(
        0, 64, (2, cfg.rank_pairs_per_batch)))
    sides = {}
    for dev in ("cpu", torch_device):
        model = cm.resolve_cost_model("residual-mlp", cfg, dev)
        (batch,) = list(cm.Records(*sub).batches(
            cfg.batch_size, np.random.RandomState(3), pad=True,
            torch_device=dev))
        p = model.clone_params(params)
        loss, grads = cm.loss_and_grad(
            lambda q: cm.model_loss(q, batch, None, cfg.loss,
                                    cfg.rank_pairs_per_batch, model.forward,
                                    pairs=pairs), p)
        new, _, _ = cm.train_step(p, cm.adam_init(p), batch, cfg, cfg.lr,
                                  forward=model.forward, pairs=pairs)
        sides[dev] = (float(loss),
                      {k: v.double().cpu() for k, v in grads.items()},
                      {k: v.double().cpu() for k, v in new.items()})
    (l0, g0, n0), (l1, g1, n1) = sides["cpu"], sides[torch_device]
    g_top = max(float(g.abs().max()) for g in g0.values())
    worst = {"loss_rel": abs(l1 - l0) / abs(l0), "grad": 0.0, "step": 0.0}
    for k in g0:
        tol = 1e-4 * g0[k].abs() + 1e-5 * g_top
        worst["grad"] = max(worst["grad"],
                            float(((g1[k] - g0[k]).abs() / tol).max()))
        signed = g0[k].abs() > 1e-5 * g_top
        p0 = params[k].double()
        if bool(signed.any()):
            worst["step"] = max(worst["step"], float(
                (n1[k] - n0[k]).abs()[signed].max()) / 2e-6)
        for side in (n0[k], n1[k]):
            moved = (side - p0).abs()[~signed]
            if moved.numel():
                assert float(moved.max()) <= cfg.lr, (k, float(moved.max()))
    assert worst["loss_rel"] <= 1e-5 and worst["grad"] <= 1.0 and \
        worst["step"] <= 1.0, worst
    out["residual-mlp"].update(epoch_loss=l1, epoch_loss_cpu=l0,
                               worst_share_of_tolerance=worst)
    return out


def build_all(build) -> dict:
    """One nvcc per kernel source, all started together."""
    from concurrent.futures import ThreadPoolExecutor

    def one(name):
        t0 = time.perf_counter()
        lib = build.build(name)
        ptxas = [ln.strip() for ln in
                 lib.with_suffix(".so.log").read_text().splitlines()
                 if "registers" in ln or "spill" in ln
                 or "Compiling entry" in ln or "arning" in ln]
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


def prefill_phases(torch, fa, tmp: str) -> None:
    """The prefill attention kernel: its check over the cases, its times
    at the benchmark's two glm4-9b prefills and the tuning path's
    `self_attn`, the route of one glm4-9b prefill, and its kernel on a
    one-rank mesh's shards."""
    emit("prefill_attention_check", kernel="prefill_attention",
         tolerance=PREFILL_TOLERANCE, **prefill_attention_check(fa, "cuda"))
    for line in prefill_attention_timing(fa, "cuda"):
        emit("prefill_attention", **line)
    route = prefill_route_share("cuda")
    emit("prefill_route", **route)
    assert route["routes"] == {"kernel": 40, "loop": 0} and \
        route["launches"] == 40 and route["finite"], route
    mesh = prefill_mesh("cuda", tmp)
    emit("prefill_mesh", **mesh)
    for side in ("plain", "meshed"):
        assert mesh[f"{side}_routes"] == {"kernel": 2, "loop": 0} and \
            mesh[f"{side}_launches"] == 2, mesh


def decode_phases(torch, da, tmp: str) -> None:
    """The decode attention kernel: its check over the cases, its times at
    the benchmark's two glm4-9b decodes and the zoo's D 256 local ring
    (each with a planted fault that must fail the check), the route of one
    glm4-9b decode step, and two layers' decode on a one-rank mesh."""
    emit("decode_attention_check", kernel="decode_attention",
         tolerance=DECODE_TOLERANCE, **decode_attention_check(da, "cuda"))
    for line in decode_attention_timing(da, "cuda"):
        emit("decode_attention", **line)
    route = decode_route_share("cuda")
    emit("decode_route", **route)
    assert route["routes"] == {"kernel": 40, "loop": 0} and \
        route["launches"] == 40 and route["finite"], route
    mesh = decode_mesh("cuda", tmp)
    emit("decode_mesh", **mesh)
    for side in ("plain", "meshed"):
        assert mesh[f"{side}_routes"] == {"kernel": 2, "loop": 0} and \
            mesh[f"{side}_launches"] == 2, mesh


def moe_phases(torch, me) -> None:
    """The routed-only expert FFN kernel pair: its check over the cases,
    its times at the zoo's MoE decodes (each with a planted fault that
    must fail the check), and the routes of one deepseek-v3-671b prefill
    (bmm) and decode step (the kernel) at published width."""
    emit("moe_experts_check", kernel="moe_experts", tolerance=MOE_TOLERANCE,
         **moe_experts_check(me, "cuda"))
    for line in moe_experts_timing(me, "cuda"):
        emit("moe_experts", **line)
    route = expert_route_share("cuda")
    emit("expert_route", **route)
    assert route["moe_layers"] == 2 and route["finite"], route
    assert route["prefill"]["routes"] == {"kernel": 0, "bmm": 2} and \
        route["prefill"]["launches"] == 0, route
    assert route["decode"]["routes"] == {"kernel": 2, "bmm": 0} and \
        route["decode"]["launches"] == 2, route


def run_phases(torch, tmp: str) -> int:
    from repro_torch.autotune.space import config_valid
    from repro_torch.autotune.tasks import arch_tasks, resnet18_tasks
    from repro_torch.configs import get_config
    from repro_torch.configs.moses import MosesConfig
    from repro_torch.kernels import build
    from repro_torch.kernels import decode_attention as da
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import matmul as mm
    from repro_torch.kernels import moe_experts as me
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
    prefill_phases(torch, fa, tmp)
    decode_phases(torch, da, tmp)
    moe_phases(torch, me)

    moses_cfg = MosesConfig()
    emit("cost_model_parity", **cost_model_parity("cuda", moses_cfg))

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

    # path 3: the same model's tasks tuned as one scheduled campaign
    # (--scheduler gradient --obs), its winners launched from its registry
    reset_launches((mm.matmul, fa.flash_attention, lru.rg_lru))
    obs_dir = str(Path(tmp) / "sched_obs")
    cfg, sched_run, sched_calls = drive_sched_path(
        "cuda", "recurrentgemma-2b", trials=48, obs_dir=obs_dir)
    sched_launches = {"matmul": mm.matmul.launches,
                      "flash_attention": fa.flash_attention.launches,
                      "rg_lru": lru.rg_lru.launches}
    sched_mm = dict(mm.matmul.launches_by_variant)
    sched_fa = dict(fa.flash_attention.launches_by_variant)
    emit("sched_path", arch=cfg.name, launches=sched_launches,
         matmul_launches_by_variant=sched_mm,
         flash_attention_launches_by_variant=sched_fa,
         **sched_summary(sched_run, lm_run, obs_dir))
    assert len(sched_calls) == 9, [wl.name for wl, _, _ in sched_calls]
    assert sched_mm["wgmma"] >= 7 and sched_mm["simt"] == 0, sched_mm
    assert sched_fa["wgmma"] >= 1 and sched_fa["simt"] == 0, sched_fa
    assert sched_launches["rg_lru"] >= 1, sched_launches
    for t in sched_run.result.tasks:
        assert config_valid(t.workload, t.best_config), t
    sched_err = {"flash_attention": 0.0, "rg_lru": 0.0}
    for wl, args, out in sched_calls:
        knobs = sched_run.registry.get("tpu_v5e", wl).as_dict()
        line = lm_task_line(wl, args, out, knobs, (mm, fa, lru))
        emit("sched_task", **line)
        if wl.kind == "matmul":
            worst = max(worst, line["max_abs_err"])
        else:
            sched_err["flash_attention" if wl.kind == "attention"
                      else "rg_lru"] = line["max_abs_err"]
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    farm = sched_farm("cuda", moses_cfg)
    emit("sched_farm", seconds=time.perf_counter() - t0, **farm)

    # path 4: the serving path on the full RecurrentGemma-2B config
    serve_cfg = get_config("recurrentgemma-2b")
    serve, _, params = drive_serve_path("cuda", serve_cfg, (mm, fa, lru))
    serve["probe_check"] = serve_probe_check(serve_cfg, "cuda")
    serve["scan_choice"] = scan_choice("cuda", 4, 512, serve_cfg.lru_width)
    emit("serve_path", **serve)
    sv = serve["launches"]
    # each kernel, in the engine's probe; the local attention's decode on
    # the decode kernel (no MoE layer: no expert kernel)
    assert min(sv[k] for k in (*PROBE_KERNELS, "decode_attention")) >= 1, sv
    assert sv["moe_experts"] == 0, sv
    assert serve["decode_routes"] == {
        "kernel": sv["decode_attention"], "loop": 0}, serve["decode_routes"]
    assert serve["requests"] == 8 and serve["tokens_per_request"] == [32], \
        serve
    torch.cuda.empty_cache()
    emit("serve_consistency", arch=serve_cfg.name, **serve_consistency(
        serve_cfg, params, "cuda", (512, serve_cfg.local_window)))
    del params
    torch.cuda.empty_cache()

    # paths 5-9: the rest of the zoo on the serve path
    zoo = {}
    for arch, layers, prompt in ZOO:
        cfg = get_config(arch)
        zoo[arch] = zoo_serve_phase(
            "cuda", cfg if layers is None else cfg.replace(num_layers=layers),
            cfg.num_layers, prompt, (mm, fa, lru))

    # path 10: training the full RecurrentGemma-2B config through the
    # launcher's objects and run_training (its probe launches each kernel)
    t0 = time.perf_counter()
    train = drive_train_path("cuda", (mm, fa, lru),
                             str(Path(tmp) / "train_ckpt"))
    train["probe_check"] = serve_probe_check(get_config(TRAIN_ARCH), "cuda")
    train["seconds"] = time.perf_counter() - t0
    emit("train_path", **train)
    assert min(train["launches"].values()) >= 1, train["launches"]
    emit("train_restart", **train_restart("cuda", tmp))
    t0 = time.perf_counter()
    emit("zoo_train_check", cases=zoo_train_check("cuda"),
         tolerance="|err| <= 1e-4 * max|cpu| + 1e-4 * |cpu| (float32 "
                   "activations, TF32 off); updates where the CPU's "
                   "gradient is above it",
         seconds=time.perf_counter() - t0)

    # the distribution layer on a one-rank NCCL group and a (1, 1) mesh:
    # glm4-9b's train step, distributed-cache decode and compressed psum,
    # each against the same work without the mesh
    torch.cuda.empty_cache()
    dist_line = drive_dist_path("cuda", (mm, fa, lru), tmp)
    emit("dist_path", **dist_line)
    assert min(dist_line["launches"].values()) >= 1, dist_line["launches"]
    assert min(dist_line["ep"]["launches"].values()) >= 1, dist_line["ep"]

    # path 11: the transfer hub tunes the same model for a device it has
    # never seen (launch.train --source auto), refreshes that device's cost
    # model on the card and launches its winners; then launch.hub's own
    # smoke leg runs as a subprocess
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    hub_mem_start = torch.cuda.memory_allocated() / 1e9
    reset_launches((mm.matmul, fa.flash_attention, lru.rg_lru))
    t0 = time.perf_counter()
    cfg, hub_run, _, hub_line = drive_hub_path(
        "cuda", "recurrentgemma-2b", str(Path(tmp) / "hub"), trials=48)
    t1 = time.perf_counter()
    hub_line.update(hub_refresh(hub_run.hub.hub, HUB_TARGET))
    hub_line["refresh_seconds"] = time.perf_counter() - t1
    hub_calls = launch_tuned(cfg, hub_run, "cuda", seed=7, device=HUB_TARGET,
                             workloads=arch_tasks(cfg))
    hub_launches = {"matmul": mm.matmul.launches,
                    "flash_attention": fa.flash_attention.launches,
                    "rg_lru": lru.rg_lru.launches}
    hub_mm = dict(mm.matmul.launches_by_variant)
    hub_fa = dict(fa.flash_attention.launches_by_variant)
    emit("hub_path", arch=cfg.name, launches=hub_launches,
         matmul_launches_by_variant=hub_mm,
         flash_attention_launches_by_variant=hub_fa,
         seconds=time.perf_counter() - t0,
         memory_allocated_at_start_gb=hub_mem_start,
         max_memory_allocated_gb=torch.cuda.max_memory_allocated() / 1e9,
         **hub_line)
    assert len(hub_calls) == 9, [wl.name for wl, _, _ in hub_calls]
    assert hub_mm["wgmma"] >= 7 and hub_mm["simt"] == 0, hub_mm
    assert hub_fa["wgmma"] >= 1 and hub_fa["simt"] == 0, hub_fa
    assert hub_launches["rg_lru"] >= 1, hub_launches
    hub_err = {"flash_attention": 0.0, "rg_lru": 0.0}
    for wl, args, out in hub_calls:
        knobs = hub_run.registry.get(HUB_TARGET, wl).as_dict()
        line = lm_task_line(wl, args, out, knobs, (mm, fa, lru))
        emit("hub_task", device=HUB_TARGET, **line)
        if wl.kind == "matmul":
            assert line["variant"] == "wgmma", line
            worst = max(worst, line["max_abs_err"])
        else:
            if wl.kind == "attention":
                assert line["variant"] == "wgmma", line
            else:
                assert line["route"] == "tma", line
            hub_err["flash_attention" if wl.kind == "attention"
                    else "rg_lru"] = line["max_abs_err"]
    torch.cuda.synchronize()
    emit("hub_smoke", **hub_smoke_cli(str(Path(tmp) / "hub_smoke")))

    # path 12: the hub's serving front end on the same root — a HubServer
    # whose writer hub tunes on the card and whose torch-free reader
    # processes serve client processes — then each tpu_v6e winner the
    # clients were served launches at the model's shape
    import types
    hub_root = str(Path(tmp) / "hub")
    torch.cuda.empty_cache()
    hs_mem_start = torch.cuda.memory_allocated() / 1e9
    reset_launches((mm.matmul, fa.flash_attention, lru.rg_lru))
    cfg, serve_tasks, served_reg, serve_line, obs_runs = \
        drive_hub_serve_path("cuda", "recurrentgemma-2b", hub_root,
                             trials=48)
    hs_calls = launch_tuned(cfg, types.SimpleNamespace(registry=served_reg),
                            "cuda", seed=8, device=SERVE_TARGET,
                            workloads=serve_tasks)
    hs_launches = {"matmul": mm.matmul.launches,
                   "flash_attention": fa.flash_attention.launches,
                   "rg_lru": lru.rg_lru.launches}
    hs_mm = dict(mm.matmul.launches_by_variant)
    hs_fa = dict(fa.flash_attention.launches_by_variant)
    emit("hub_serve_path", arch=cfg.name, launches=hs_launches,
         matmul_launches_by_variant=hs_mm,
         flash_attention_launches_by_variant=hs_fa,
         memory_allocated_at_start_gb=hs_mem_start,
         max_memory_allocated_gb=torch.cuda.max_memory_allocated() / 1e9,
         **serve_line)
    assert len(hs_calls) == 9, [wl.name for wl, _, _ in hs_calls]
    assert hs_mm["wgmma"] >= 7 and hs_mm["simt"] == 0, hs_mm
    assert hs_fa["wgmma"] >= 1 and hs_fa["simt"] == 0, hs_fa
    assert hs_launches["rg_lru"] >= 1, hs_launches
    hs_err = {"flash_attention": 0.0, "rg_lru": 0.0}
    for wl, args, out in hs_calls:
        knobs = served_reg.get(SERVE_TARGET, wl).as_dict()
        line = lm_task_line(wl, args, out, knobs, (mm, fa, lru))
        emit("hub_serve_task", device=SERVE_TARGET, **line)
        if wl.kind == "matmul":
            assert line["variant"] == "wgmma", line
            worst = max(worst, line["max_abs_err"])
        else:
            if wl.kind == "attention":
                assert line["variant"] == "wgmma", line
            else:
                assert line["route"] == "tma", line
            hs_err["flash_attention" if wl.kind == "attention"
                   else "rg_lru"] = line["max_abs_err"]
    torch.cuda.synchronize()
    obs_runs += [obs_cli_run(["--check", obs_dir, "--root", hub_root]),
                 obs_cli_run(["--report", obs_dir, "--root", hub_root])]
    emit("obs_cli", runs=obs_runs)
    emit("hub_serve_smoke", **hub_smoke_cli(
        str(Path(tmp) / "hub_serve_smoke"), leg="--serve"))

    # one entry per ported kernel. matmul's times are sums over the first
    # two tuning paths' GEMMs (one launch each); the other two are their one
    # task's in the second. Launches by path: the three tuning paths, then
    # each serve path's probe, the training path's and dist_path's
    serve_paths = {"serve": serve, **{f"serve:{a}": z for a, z in zoo.items()},
                   "train": train, "dist_path": dist_line,
                   "dist_path:ep": dist_line["ep"]}

    def by_path(name: str) -> dict:
        return {"resnet18": launches[name],
                "recurrentgemma-2b": lm_launches[name],
                "sched_path": sched_launches[name],
                "hub_path": hub_launches[name],
                "hub_serve_path": hs_launches[name],
                **{p: z["launches"][name] for p, z in serve_paths.items()}}

    def by_variant(name: str, tuning: dict) -> dict:
        return {v: tuning[v] + sum(z["launches_by_variant"][name][v]
                                   for z in serve_paths.values())
                for v in ("wgmma", "simt")}

    paths = by_path("matmul")
    entries = [{
        "name": "matmul", "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/matmul_wgmma.cu",
        "sources": {"wgmma": "src/repro_torch/kernels/csrc/matmul_wgmma.cu",
                    "simt": "src/repro_torch/kernels/csrc/matmul.cu"},
        "replaces": f"{TPU_KERNEL}:99",
        "tpu_kernel": f"{TPU_KERNEL}:matmul (pallas_call at :99, k_inner=1,"
                      f" and :115, k_inner=0)",
        "launches": sum(paths.values()),
        "launches_by_variant": by_variant("matmul", {
            v: launches["by_variant"][v] + lm_by_variant[v] + sched_mm[v]
            + hub_mm[v] + hs_mm[v] for v in ("wgmma", "simt")}),
        "launches_by_path": paths,
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
                "launches_by_variant": by_variant("flash_attention", {
                    v: fa_by_variant[v] + sched_fa[v] + hub_fa[v] + hs_fa[v]
                    for v in ("wgmma", "simt")})}),
            ("rg_lru", "rg_lru.cu",
             {"replaces": "src/repro/kernels/rg_lru.py:57"})):
        line = per_kernel[name]
        paths = by_path(name)
        entries.append({
            "name": name, "route": "cuda", "source": f"{csrc}/{src}",
            **extra,
            "launches": sum(paths.values()),
            "launches_by_path": paths,
            "checked": True,
            "max_abs_err": max(line["max_abs_err"], sched_err[name],
                               hub_err[name], hs_err[name]),
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
