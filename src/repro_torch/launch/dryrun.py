"""Dry run of the production meshes without cards (port of
`repro.launch.dryrun`).

    PYTHONPATH=src python -m repro_torch.launch.dryrun --arch glm4-9b \
        --shape train_4k --mesh single [--opt act,epmoe] [--calibrate]

`main` joins a fake process group of 512 ranks as rank 0 (the fake
backend: collectives return at once and move nothing), and
`launch.mesh.make_production_mesh` carves the (16, 16) ("data", "model")
or (2, 16, 16) ("pod", "data", "model") mesh from it. Importing this
module joins nothing: the reference sets its forced device count here, the
port does it in `main` (`join_fake_group`).

Each (arch, shape, mesh) cell builds its params, optimizer state, batch
and decode state as meta DTensors with the reference's shardings
(`build_lowerable`) and runs the port's own step on them once, on the meta
device, on this rank's shards: `train_loop.make_train_step(mesh=...)` for
train, `make_serve_prefill` for prefill and `make_serve_step(
distributed_cache=_use_distributed_cache(...))` for decode. Meta tensors
hold no data, so nothing is computed or allocated and no kernel launches;
DTensor still plans every redistribution and calls every local op with
this rank's shapes. `roofline.RankCounter` counts them: FLOPs per rank
from the local calls only, the input and output bytes of each local op
(`cost_analysis["unfused_bytes"]`: no fusion, so more than XLA's "bytes
accessed"), and the collectives' bytes by kind. The record keeps the
reference's keys where the port has the number: `state_bytes_per_device`
(the fits check, from the shardings as the reference computes it), the
param counts, `model_flops`, the roofline terms at the H100's data-sheet
rates (`roofline.H100`), and the memory analysis's argument and output
bytes; meta tensors give no temp or peak bytes, which are recorded as
errors, as the reference records a backend that lacks them. On the CPU
(gloo, and the fake group) DTensor turns an all-to-all into an all-gather
and a chunk, so the counts show all-gathers there.

`calibrate_cell` fits the reference's per-group line through two reduced
depths and extrapolates to the full depth. The port's layers run as a
Python loop, so each count is already exact at full depth, and the
extrapolation reproduces it (for stacks without a suffix).

Artifacts go to `artifacts/dryrun_torch/` (or $REPRO_TORCH_DRYRUN_DIR).
`--opt` takes the reference's
tokens: zero3 | act | moe | epmoe (hints) and dpplan | chunk=<n> |
remat=<policy> (config). The port's steps always gather each block's
weights just in time under hints (the launcher's choice too): the
reference's hints without it make DTensor plan redistributions of weights
sharded over two mesh dims, which takes minutes an op.
"""
from __future__ import annotations

import argparse
import json
import math
import os
import time
import traceback
from typing import Any, Dict, Optional

import torch

from repro_torch.configs import ARCH_IDS, SHAPES, get_config
from repro_torch.distributed import sharding as sh
from repro_torch.launch import roofline
from repro_torch.launch.mesh import make_production_mesh
from repro_torch.models import build_model, input_specs
from repro_torch.models.common import tree_leaves
from repro_torch.train.optimizer import AdamW, AdamWConfig

ARTIFACT_DIR = os.environ.get("REPRO_TORCH_DRYRUN_DIR") or os.path.join(
    os.path.dirname(__file__), "..", "..", "..", "artifacts", "dryrun_torch")
WORLD = 512


def join_fake_group(world: int = WORLD) -> None:
    """Join a fake process group of `world` ranks as rank 0 (a no-op when
    this process is in a group already)."""
    import torch.distributed as dist
    if dist.is_initialized():
        return
    from torch.testing._internal.distributed.fake_pg import FakeStore
    dist.init_process_group("fake", store=FakeStore(), rank=0,
                            world_size=world)


def make_opt(cfg) -> AdamW:
    return AdamW(AdamWConfig(
        lr=1e-4, weight_decay=0.1,
        moment_dtype=cfg.moment_dtype,
        master_fp32=(cfg.param_dtype == "bfloat16")))


def _sharded_bytes(abstract_tree, sharding_tree) -> int:
    """Per-device argument bytes given shardings (analytic fits check)."""
    total = 0
    for leaf, shard in zip(tree_leaves(abstract_tree),
                           tree_leaves(sharding_tree)):
        n = math.prod(leaf.shape)
        sizes = sh.axis_sizes(shard.mesh)
        denom = 1
        for entry in shard.spec:
            if entry is None:
                continue
            axes = (entry,) if isinstance(entry, str) else entry
            for a in axes:
                denom *= sizes[a]
        total += n * leaf.element_size() // max(denom, 1)
    return total


def _use_distributed_cache(cfg, shape) -> bool:
    if shape.kind != "decode":
        return False
    if cfg.mla is not None:
        return False  # MLA decodes in latent space (einsum path)
    from repro_torch.models.model import cache_length
    clen = cache_length(cfg, shape.seq_len)
    return clen >= 8192 and clen % 16 == 0


def build_lowerable(arch: str, shape_name: str, mesh,
                    cfg_override=None):
    """Returns (fn, example_args, in_shardings, out_shardings, meta): the
    port's step, its arguments as meta tensors and their shardings
    (`sharding.distribute(example_args[i], in_shardings[i])` places
    them)."""
    from repro_torch.train.train_loop import (make_serve_prefill,
                                              make_serve_step,
                                              make_train_step,
                                              train_state_shardings)
    cfg = cfg_override if cfg_override is not None else get_config(arch)
    shape = SHAPES[shape_name]
    model = build_model(cfg)
    specs = input_specs(cfg, shape)
    params_abs, axes = model.abstract_params_and_axes()
    p_shard = sh.param_shardings(params_abs, axes, mesh, cfg.sharding_plan)
    meta: Dict[str, Any] = {"param_count": cfg.param_count(),
                            "param_count_active": cfg.param_count(True)}

    if shape.kind == "train":
        opt = make_opt(cfg)
        state_shard, params_abs, opt_abs = train_state_shardings(model, opt,
                                                                 mesh)
        state_abs = {"params": params_abs, "opt": opt_abs,
                     "step": torch.zeros((), dtype=torch.int32,
                                         device="meta")}
        batch_abs = specs["batch"]
        baxes = sh.batch_axes_for_plan(mesh, cfg.sharding_plan)
        batch_shard = sh.batch_shardings(batch_abs, mesh, axes=baxes)
        meta["state_bytes_per_device"] = _sharded_bytes(state_abs,
                                                        state_shard)
        return (make_train_step(model, opt, mesh=mesh),
                (state_abs, batch_abs), (state_shard, batch_shard),
                (state_shard, None), meta)

    if shape.kind == "prefill":
        batch_abs = specs["batch"]
        batch_shard = sh.batch_shardings(
            batch_abs, mesh, axes=sh.batch_axes_for_plan(mesh,
                                                         cfg.sharding_plan))
        state_specs = model.init_decode_state_specs(shape.global_batch,
                                                    shape.seq_len)
        state_shard = sh.decode_state_shardings(state_specs, mesh,
                                                shape.global_batch)
        meta["state_bytes_per_device"] = _sharded_bytes(params_abs, p_shard)
        return (make_serve_prefill(model, max_len=shape.seq_len, mesh=mesh),
                (params_abs, batch_abs), (p_shard, batch_shard),
                (state_shard, None), meta)

    # decode
    state_abs = specs["state"]
    tok_abs = specs["tokens"]
    state_shard = sh.decode_state_shardings(state_abs, mesh,
                                            shape.global_batch)
    tok_shard = sh.batch_sharding(mesh, 1, batch_size=shape.global_batch)
    distributed = _use_distributed_cache(cfg, shape)
    if distributed:
        meta["distributed_cache"] = True
    step = make_serve_step(model, distributed_cache=distributed, mesh=mesh,
                           batch_sharded=shape.global_batch % 32 == 0)
    cache_bytes = _sharded_bytes(state_abs, state_shard)
    meta["state_bytes_per_device"] = cache_bytes + _sharded_bytes(
        params_abs, p_shard)
    return (step, (params_abs, state_abs, tok_abs),
            (p_shard, state_shard, tok_shard), (state_shard, None), meta)


def _hints_for(opt: str, mesh):
    if opt in ("", "none", None):
        return None
    from repro_torch.distributed.act_sharding import Hints
    from repro_torch.distributed.sharding import data_axes
    tokens = set((opt or "").split(","))
    if not tokens & {"zero3", "act", "moe", "epmoe"}:
        return None
    # the ZeRO-3 gather is always on: see the module docstring
    return Hints(mesh, data_axes(mesh), "model",
                 zero3_gather=True,
                 constrain_activations=("act" in tokens),
                 moe_expert_parallel=("moe" in tokens),
                 moe_impl=("expert_parallel" if "epmoe" in tokens else None))


def apply_opt_to_cfg(cfg, opt: str):
    """Config-level opt tokens: dpplan | chunk=<n> | remat=<policy>."""
    for tok in (opt or "").split(","):
        if tok == "dpplan":
            cfg = cfg.replace(sharding_plan="dp")
        elif tok.startswith("chunk="):
            cfg = cfg.replace(scan_chunk=int(tok.split("=")[1]))
        elif tok.startswith("remat="):
            cfg = cfg.replace(remat_policy=tok.split("=")[1])
    return cfg


def _local_bytes(tree) -> int:
    """The bytes this rank holds of a tree of (D)Tensors."""
    from torch.distributed.tensor import DTensor
    if isinstance(tree, (list, tuple)):
        return sum(_local_bytes(t) for t in tree)
    if isinstance(tree, dict):
        return sum(_local_bytes(t) for t in tree.values())
    if not isinstance(tree, torch.Tensor):
        return 0
    loc = tree.to_local() if isinstance(tree, DTensor) else tree
    return loc.numel() * loc.element_size()


def count_step(fn, args, in_sh, opt: str, mesh):
    """Place the arguments on the mesh, run `fn` once under the opt's hints
    and count this rank's work. Returns (counter, argument bytes, output
    bytes, seconds to place, seconds to run)."""
    from repro_torch.distributed.act_sharding import use_hints
    t0 = time.perf_counter()
    placed = [sh.distribute(a, s) for a, s in zip(args, in_sh)]
    arg_bytes = _local_bytes(placed)
    t_place = time.perf_counter() - t0
    counter = roofline.RankCounter()
    t0 = time.perf_counter()
    with use_hints(_hints_for(opt, mesh)), counter:
        out = fn(*placed)
    return (counter, arg_bytes, _local_bytes(out), t_place,
            time.perf_counter() - t0)


def _roofline_rec(terms) -> Dict[str, Any]:
    return {"compute_s": terms.compute_s,
            "memory_s": terms.memory_s,
            "collective_s": terms.collective_s,
            "dominant": terms.dominant,
            "step_time_bound_s": terms.step_time_s,
            "useful_flops_fraction": terms.useful_flops_fraction,
            "roofline_fraction": terms.roofline_fraction}


def run_cell(arch: str, shape_name: str, multi_pod: bool,
             save: bool = True, opt: str = "none",
             cfg_override=None) -> Dict[str, Any]:
    cfg = cfg_override if cfg_override is not None else get_config(arch)
    cfg = apply_opt_to_cfg(cfg, opt)
    shape = SHAPES[shape_name]
    mesh_name = "multi_pod_2x16x16" if multi_pod else "single_pod_16x16"
    rec: Dict[str, Any] = {"arch": arch, "shape": shape_name,
                           "mesh": mesh_name, "opt": opt}
    ok, reason = cfg.supports_shape(shape)
    if not ok:
        rec.update(status="skip", reason=reason)
        return _save(rec) if save else rec
    try:
        t_cell = time.perf_counter()
        mesh = make_production_mesh(multi_pod=multi_pod)
        chips = mesh.size()
        t0 = time.perf_counter()
        fn, args, in_sh, _, meta = build_lowerable(
            arch, shape_name, mesh, cfg_override=cfg)
        t_build = time.perf_counter() - t0
        counter, arg_bytes, out_bytes, t_place, t_run = count_step(
            fn, args, in_sh, opt, mesh)
        mem_rec = {
            "argument_bytes": arg_bytes,
            "output_bytes": out_bytes,
            "temp_bytes": {"error": "meta tensors allocate nothing"},
            "peak_bytes": {"error": "meta tensors allocate nothing"},
        }
        cost_clean = {"flops": float(counter.flops),
                      "unfused_bytes": float(counter.bytes)}
        coll = counter.collectives()
        mf = roofline.model_flops_for(cfg, shape)
        terms = roofline.analyze(
            {"flops": counter.flops, "bytes accessed": counter.bytes}, coll,
            chips, model_flops=mf, **roofline.H100)
        print(f"[{arch}|{shape_name}|{mesh_name}] per rank: "
              f"flops={counter.flops:.3e} unfused_bytes={counter.bytes:.3e}"
              f" collective_bytes={coll['total_bytes']:.3e}", flush=True)
        rec.update(
            status="ok",
            chips=chips,
            build_s=t_build,
            place_s=t_place,
            step_s=t_run,
            seconds=time.perf_counter() - t_cell,
            memory_analysis=mem_rec,
            cost_analysis=cost_clean,
            collectives=coll,
            model_flops=mf,
            rates=dict(roofline.H100),
            roofline=_roofline_rec(terms),
            **meta,
        )
    except Exception as e:
        rec.update(status="error", error=f"{type(e).__name__}: {e}",
                   traceback=traceback.format_exc()[-4000:])
    return _save(rec) if save else rec


def calibrate_cell(arch: str, shape_name: str,
                   opt: str = "none",
                   cfg_override=None) -> Optional[Dict[str, Any]]:
    """The reference's depth calibration: count two reduced-depth variants
    (g=1 and g=2 repeated groups) at full width/batch/seq, fit the exact
    per-group line and extrapolate to the full depth:
    metric(G) = intercept + per_group * G. XLA's cost analysis visits a
    scanned body once, so the reference needs it; the port's counts are
    exact at full depth already, and the line reproduces them."""
    from repro_torch.models.transformer import stack_plan

    cfg = apply_opt_to_cfg(cfg_override if cfg_override is not None
                           else get_config(arch), opt)
    shape = SHAPES[shape_name]
    ok, _ = cfg.supports_shape(shape)
    if not ok:
        return None
    prefix, unit, n_groups, suffix = stack_plan(cfg)
    if n_groups == 0:
        return None  # already unrolled; artifact is exact
    n_pre, n_unit = len(prefix), len(unit)
    g_full = (cfg.num_layers - n_pre) / n_unit  # suffix folded fractionally
    mesh = make_production_mesh(multi_pod=False)
    chips = mesh.size()

    samples = {}
    for g in (1, 2):
        depth = n_pre + g * n_unit
        cal_cfg = cfg.replace(num_layers=depth, scan_layers=False)
        fn, args, in_sh, _, _ = build_lowerable(
            arch, shape_name, mesh, cfg_override=cal_cfg)
        counter = count_step(fn, args, in_sh, opt, mesh)[0]
        samples[g] = {
            "flops": float(counter.flops),
            "bytes": float(counter.bytes),
            "coll": float(counter.collectives()["total_bytes"]),
        }

    def extrap(key):
        per_group = samples[2][key] - samples[1][key]
        intercept = samples[1][key] - per_group
        return max(intercept + per_group * g_full, 0.0), per_group, intercept

    flops, _, _ = extrap("flops")
    byts, _, _ = extrap("bytes")
    coll_b, _, _ = extrap("coll")
    mf = roofline.model_flops_for(cfg, shape)
    terms = roofline.analyze({"flops": flops, "bytes accessed": byts},
                             {"total_bytes": coll_b}, chips, model_flops=mf,
                             **roofline.H100)
    return {
        "samples": samples,
        "g_full": g_full,
        "flops_per_chip": flops,
        "bytes_per_chip": byts,
        "collective_bytes_per_chip": coll_b,
        "roofline": _roofline_rec(terms),
    }


def _artifact_path(arch: str, shape: str, mesh: str, opt: str = "none") -> str:
    suffix = "" if opt in ("", "none", None) else f"__opt-{opt}"
    return os.path.join(ARTIFACT_DIR, f"{arch}__{shape}__{mesh}{suffix}.json")


def _save(rec: Dict[str, Any]) -> Dict[str, Any]:
    os.makedirs(ARTIFACT_DIR, exist_ok=True)
    path = _artifact_path(rec["arch"], rec["shape"], rec["mesh"],
                          rec.get("opt", "none"))
    with open(path, "w") as f:
        json.dump(rec, f, indent=1, default=str)
    return rec


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default=None, choices=ARCH_IDS + [None])
    ap.add_argument("--shape", default=None, choices=list(SHAPES) + [None])
    ap.add_argument("--mesh", default="both",
                    choices=["single", "multi", "both"])
    ap.add_argument("--skip-existing", action="store_true")
    ap.add_argument("--opt", default="none",
                    help="optimization variant: none | zero3 | act | "
                         "zero3,act | act,epmoe (artifacts get an __opt- "
                         "suffix)")
    ap.add_argument("--calibrate", action="store_true",
                    help="add depth-extrapolated roofline to existing "
                         "single-pod artifacts")
    args = ap.parse_args(argv)
    join_fake_group()

    archs = [args.arch] if args.arch else ARCH_IDS
    shapes = [args.shape] if args.shape else list(SHAPES)

    if args.calibrate:
        for arch in archs:
            for shape_name in shapes:
                path = _artifact_path(arch, shape_name, "single_pod_16x16",
                                      args.opt)
                if not os.path.exists(path):
                    continue
                with open(path) as f:
                    rec = json.load(f)
                if rec.get("status") != "ok":
                    continue
                if args.skip_existing and "calibrated" in rec:
                    continue
                t0 = time.time()
                try:
                    cal = calibrate_cell(arch, shape_name, opt=args.opt)
                except Exception as e:
                    print(f"CAL-ERR {arch} {shape_name}: {e}", flush=True)
                    continue
                if cal is None:
                    continue
                rec["calibrated"] = cal
                with open(path, "w") as f:
                    json.dump(rec, f, indent=1, default=str)
                r = cal["roofline"]
                print(f"CAL   {arch:22s} {shape_name:12s} "
                      f"dom={r['dominant']} bound={r['step_time_bound_s']:.4f}s"
                      f" useful={r['useful_flops_fraction']:.2f}"
                      f" roof={r['roofline_fraction']:.3f}"
                      f" ({time.time()-t0:.0f}s)", flush=True)
        return 0
    meshes = {"single": [False], "multi": [True],
              "both": [False, True]}[args.mesh]
    n_ok = n_skip = n_err = 0
    for arch in archs:
        for shape_name in shapes:
            for mp in meshes:
                mesh_name = ("multi_pod_2x16x16" if mp
                             else "single_pod_16x16")
                path = _artifact_path(arch, shape_name, mesh_name, args.opt)
                if args.skip_existing and os.path.exists(path):
                    with open(path) as f:
                        if json.load(f).get("status") == "ok":
                            continue
                rec = run_cell(arch, shape_name, mp, opt=args.opt)
                st = rec["status"]
                n_ok += st == "ok"
                n_skip += st == "skip"
                n_err += st == "error"
                if st == "ok":
                    r = rec["roofline"]
                    extra = (f"dom={r['dominant']} "
                             f"bound={r['step_time_bound_s']:.4f}s "
                             f"step={rec['step_s']:.0f}s")
                elif st == "error":
                    extra = rec["error"][:120]
                else:
                    extra = rec["reason"][:60]
                print(f"{st.upper():5s} {arch:22s} {shape_name:12s} "
                      f"{mesh_name:18s} {extra}", flush=True)
    print(f"done: ok={n_ok} skip={n_skip} err={n_err}")
    return 0 if n_err == 0 else 1


if __name__ == "__main__":
    raise SystemExit(main())
