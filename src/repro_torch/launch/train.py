"""Training launcher (port of `repro.launch.train`).

    PYTHONPATH=src python -m repro_torch.launch.train \
        --arch recurrentgemma-2b --steps 200 --batch 8 --seq 128 [--smoke] \
        [--autotune tpu_v5e [--source auto [--hub-root DIR]] \
         [--scheduler gradient] [--obs DIR] [--dry-run]] \
        [--checkpoint-dir DIR] [--torch-device cpu] [--model-parallel N]

Trains the architecture with AdamW (cosine schedule, warmup steps // 20,
weight decay 0.01) on the synthetic data pipeline through the
fault-tolerant loop (`train.train_loop.run_training`), restoring from the
latest checkpoint in --checkpoint-dir, and prints the final loss. --smoke
uses the reduced same-family config (CPU-runnable); the model runs on
--torch-device (default cuda, which raises without a card).

--autotune first runs Moses cost-model adaptation for the target device and
persists the tuned kernel configs of the architecture's tasks (`arch_tasks`)
to the port's registry (`REPRO_TORCH_TUNING_REGISTRY`, default
`tuned_configs_torch.json`). --source names the transfer source device, or
'auto' to route through the transfer hub at --hub-root (fingerprint the
target, warm-start from the nearest measured device in the persistent
store, bootstrapping the stock source corpus on first run; see
`repro_torch.hub`). --scheduler gradient replaces the serial fixed-budget
tuner with one scheduled campaign (`repro_torch.sched`: marginal-gain
budget allocation, async measurement, draft-then-verify scoring), and --obs
DIR writes that campaign's telemetry (`events.jsonl`, `campaign.trace.json`) to DIR.
--dry-run tunes two tasks on a tiny budget and exits before training.

Under `torch.distributed.run` (WORLD_SIZE > 1), or with --model-parallel
N > 1, every process joins the process group (NCCL on cuda, gloo on the
CPU; `launch.mesh.init_process_group`) and trains over the ("data",
"model") host mesh with data = world // N (`launch.mesh.make_host_mesh`):
the state sharded per the config's plan, the batch over "data", --opt act
pins the activations' placements (`distributed.act_sharding`) and --opt
epmoe runs the MoE blocks expert-parallel (`distributed.expert_parallel`).
--production-mesh [--multi-pod] trains over the (16, 16) or (2, 16, 16)
mesh (`launch.mesh.make_production_mesh`), which raises RuntimeError in a
group of fewer ranks. One process with N = 1 trains on one device without
a mesh.

    python -m torch.distributed.run --nproc-per-node 2 -m \
        repro_torch.launch.train --smoke --arch glm4-9b --model-parallel 2 \
        --torch-device cpu --steps 2
"""
from __future__ import annotations

import argparse
import dataclasses
import logging
import os
import tempfile
import time
from typing import TYPE_CHECKING, Dict, Iterator, List, Optional

import numpy as np

from repro_torch.configs import ARCH_IDS, get_config, get_smoke_config
from repro_torch.configs.moses import DEFAULT as MOSES_CFG
from repro_torch.core.placement import TorchDevice

if TYPE_CHECKING:
    from repro_torch.hub import TuningHub
    from repro_torch.models.model import Model
    from repro_torch.sched.scheduler import CampaignResult
    from repro_torch.train.optimizer import AdamW
    from repro_torch.train.train_loop import LoopConfig

log = logging.getLogger(__name__)


@dataclasses.dataclass
class HubAutotune:
    """What `--source auto` did besides tuning: the hub, the tasks it queued
    (the rest it already served), the records the source bootstrap added
    and its seconds, the target's fingerprint seconds (0 when the store
    already held it) and the seconds of the hub's whole flush."""
    hub: "TuningHub"
    queued: int
    bootstrap_records: int
    bootstrap_seconds: float
    fingerprint_seconds: float
    flush_seconds: float


@dataclasses.dataclass
class AutotuneRun:
    """What one autotune step did: the tuning result (None when the hub
    already served every task), the registry it was saved to, the seconds
    of pre-training and of tuning, under `scheduler="gradient"` the whole
    `CampaignResult` (None on the serial path), and under `source="auto"`
    the hub's side (`HubAutotune`; pre-training then is the hub's, its
    losses are not kept, and tuning is the flush less fingerprint and
    pre-training)."""
    result: object
    registry: object
    pretrain_losses: List[float]
    pretrain_seconds: float
    tune_seconds: float
    campaign: Optional["CampaignResult"] = None
    hub: Optional[HubAutotune] = None


def maybe_autotune(device: str, cfg, source: Optional[str] = None,
                   hub_root: str = "artifacts/hub",
                   scheduler: str = "serial", trials: int = 48,
                   dry_run: bool = False, obs: Optional[str] = None,
                   torch_device: TorchDevice = "cuda") -> AutotuneRun:
    """Pre-train the cost model on `source` (default: the Moses source
    device), tune `arch_tasks(cfg)` for `device` under `moses` and save the
    winners to the registry. `source="auto"` routes through the transfer
    hub at `hub_root` instead (`autotune_via_hub`). `scheduler="gradient"`
    tunes the tasks as one scheduled campaign (`TuneSession.run_many`,
    draft-then-verify scoring); `obs` is a directory for that campaign's
    telemetry."""
    if scheduler not in ("serial", "gradient"):
        raise ValueError(f"unknown scheduler {scheduler!r}; expected "
                         "'serial' or 'gradient'")
    from repro_torch.autotune.dataset import (generate_records,
                                              training_task_pool)
    from repro_torch.autotune.registry import Registry
    from repro_torch.autotune.session import TuneSession
    from repro_torch.autotune.tasks import arch_tasks
    from repro_torch.autotune.tuner import tune
    from repro_torch.core.cost_model import resolve_cost_model

    tasks = arch_tasks(cfg)
    moses_cfg = MOSES_CFG
    if dry_run:
        # CI fast path: two tasks, tiny search, shallow updates
        moses_cfg = dataclasses.replace(
            MOSES_CFG, online_epochs=2, adaptation_epochs=2,
            population_size=32, evolution_rounds=2, top_k_measure=8)
        tasks = tasks[:2]
        trials = min(trials, 16)
    if source == "auto":
        return autotune_via_hub(device, tasks, moses_cfg, hub_root,
                                scheduler, trials, dry_run, torch_device)
    src_device = source or moses_cfg.source_device
    log.info("Moses adaptation: source=%s target=%s scheduler=%s",
             src_device, device, scheduler)
    t0 = time.perf_counter()
    pool = training_task_pool(include_archs=False)
    src = generate_records(pool, src_device,
                           programs_per_task=8 if dry_run else 24, seed=0)
    model = resolve_cost_model("mlp", moses_cfg.cost_model, torch_device)
    params = model.init(0)
    params, losses = model.train(params, src, epochs=2 if dry_run else 10)
    pretrain_s = time.perf_counter() - t0
    reg = Registry()
    campaign = None
    t0 = time.perf_counter()
    if scheduler == "gradient":
        session = TuneSession(moses_cfg=moses_cfg, pretrained_params=params,
                              source_pool=src, registry=reg,
                              trials_per_task=trials, cost_model=model,
                              torch_device=torch_device)
        campaign = session.run_many([(device, tasks)], strategy="moses",
                                    scheduler="gradient", speculative=True,
                                    return_campaign=True, obs=obs)
        result = campaign.results[0]
        log.info("campaign done: measurements=%d simulated_s=%.1f "
                 "simulated_wall_s=%.1f grants=%d draft_acceptance=%.2f "
                 "full_model_reduction=%.1f",
                 campaign.total_measurements, campaign.spent_seconds,
                 campaign.wall_seconds, len(campaign.trace),
                 campaign.spec_stats.acceptance,
                 campaign.spec_stats.full_model_reduction)
        if obs:
            log.info("campaign telemetry written: obs_dir=%s", obs)
    else:
        result = tune(tasks, device, "moses", moses_cfg,
                      trials_per_task=trials, pretrained_params=params,
                      source_pool=src, cost_model=model,
                      torch_device=torch_device)
        reg.ingest(result)
    tune_s = time.perf_counter() - t0
    reg.save()
    log.info("autotune done: tuned_tasks=%d registry=%s", len(result.tasks),
             reg.path)
    return AutotuneRun(result, reg, [float(x) for x in losses], pretrain_s,
                       tune_s, campaign)


def autotune_via_hub(device: str, tasks, moses_cfg, hub_root: str,
                     scheduler: str, trials: int, dry_run: bool,
                     torch_device: TorchDevice) -> AutotuneRun:
    """`--source auto`: fingerprint the target, pick the nearest measured
    source(s) from the persistent store at `hub_root` (bootstrapping the
    stock source corpus on first run), tune on miss, and persist winners
    into the port's default registry."""
    from repro_torch.autotune.dataset import training_task_pool
    from repro_torch.autotune.registry import Registry
    from repro_torch.hub import TuningHub, bootstrap_store

    log.info("Moses adaptation via hub: target=%s hub_root=%s scheduler=%s",
             device, hub_root, scheduler)
    hub = TuningHub(hub_root, moses_cfg=moses_cfg, registry=Registry(),
                    trials_per_task=trials, scheduler=scheduler,
                    torch_device=torch_device)
    t0 = time.perf_counter()
    booted = bootstrap_store(hub.store, [moses_cfg.source_device],
                             training_task_pool(include_archs=False),
                             programs_per_task=8 if dry_run else 16)
    boot_s = time.perf_counter() - t0
    queued = sum(hub.request(device, wl) for wl in tasks)
    t0 = time.perf_counter()
    results = hub.flush(device)
    flush_s = time.perf_counter() - t0
    sel = hub.selection(device)
    if sel is not None:
        log.info("transfer sources selected: %s",
                 [(d, round(w, 3)) for d, w in sel.sources])
    log.info("hub autotune done: tuned_tasks=%d registry=%s "
             "already_served=%d", sum(len(r.tasks) for r in results),
             hub.registry.path, len(tasks) - queued)
    fp_s = hub.metrics.histogram("hub.fingerprint_seconds").total
    pretrain_s = hub.metrics.histogram("hub.pretrain_seconds").total
    return AutotuneRun(
        results[0] if results else None, hub.registry, [], pretrain_s,
        flush_s - fp_s - pretrain_s,
        hub=HubAutotune(hub, queued, booted, boot_s, fp_s, flush_s))


def parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True, choices=ARCH_IDS)
    ap.add_argument("--smoke", action="store_true",
                    help="reduced same-family config (CPU-runnable)")
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--lr", type=float, default=3e-3)
    ap.add_argument("--checkpoint-dir", default=os.path.join(
        tempfile.gettempdir(), "repro_torch_ckpt"))
    ap.add_argument("--checkpoint-every", type=int, default=50)
    ap.add_argument("--autotune", default=None,
                    help="target device for Moses kernel tuning")
    ap.add_argument("--source", default=None,
                    help="source device for --autotune transfer, or 'auto' "
                         "to select the nearest measured device via the "
                         "transfer hub's fingerprint ranking")
    ap.add_argument("--hub-root", default="artifacts/hub",
                    help="transfer-hub root used by --source auto")
    ap.add_argument("--scheduler", default="serial",
                    choices=("serial", "gradient"),
                    help="--autotune engine: 'serial' tunes each task with "
                         "a fixed budget; 'gradient' runs one scheduled "
                         "campaign (marginal-gain budget allocation + async "
                         "measurement + draft-then-verify scoring)")
    ap.add_argument("--autotune-trials", type=int, default=48,
                    help="per-task trial budget for --autotune")
    ap.add_argument("--dry-run", action="store_true",
                    help="run the --autotune path on a tiny budget and exit "
                         "before training")
    ap.add_argument("--obs", default=None, metavar="DIR",
                    help="write campaign telemetry (events.jsonl + Chrome "
                         "trace + metrics snapshot) to DIR; applies to the "
                         "--scheduler gradient autotune path")
    ap.add_argument("--production-mesh", action="store_true",
                    help="the (16, 16) mesh: 256 ranks")
    ap.add_argument("--multi-pod", action="store_true",
                    help="with --production-mesh, the (2, 16, 16) mesh: "
                         "512 ranks")
    ap.add_argument("--model-parallel", type=int, default=1,
                    help="ranks on the host mesh's 'model' axis; it must "
                         "divide the processes of torch.distributed.run")
    ap.add_argument("--opt", default="act",
                    help="perf hints under a mesh: act (pin the "
                         "activations' placements) | act,epmoe (also "
                         "expert-parallel MoE) | none")
    ap.add_argument("--seed", type=int, default=0,
                    help="seed of the params and of the data")
    ap.add_argument("--torch-device", default="cuda",
                    help="where the cost model and the model run: cuda "
                         "(default) or cpu")
    return ap


@dataclasses.dataclass
class Training:
    """What the launcher trains with, built from its flags: under a mesh
    also the mesh and the --opt hints (None without)."""
    model: "Model"
    opt: "AdamW"
    data: Iterator[Dict[str, np.ndarray]]
    loop: "LoopConfig"
    mesh: object = None
    hints: object = None


def build_training(args: argparse.Namespace) -> Training:
    """The reference launcher's model, AdamW (cosine schedule with warmup
    max(steps // 20, 1), weight decay 0.01, the config's moment dtype, a
    float32 master copy for bf16 params), data iterator and LoopConfig;
    under torch.distributed.run or --model-parallel > 1, the process group,
    the host mesh and the reference's --opt hints (act, epmoe); under
    --production-mesh the production mesh (RuntimeError in a smaller
    group)."""
    from repro_torch.models import build_model
    from repro_torch.train.data import DataConfig, data_iterator
    from repro_torch.train.optimizer import AdamW, AdamWConfig, cosine_schedule
    from repro_torch.train.train_loop import LoopConfig

    world = int(os.environ.get("WORLD_SIZE", "1"))
    mesh = hints = None
    if args.production_mesh:
        from repro_torch.launch.mesh import (init_process_group,
                                             make_production_mesh)
        if world > 1:
            init_process_group(args.torch_device)
        mesh = make_production_mesh(multi_pod=args.multi_pod)
    elif world > 1 or args.model_parallel > 1:
        if args.model_parallel < 1 or world % args.model_parallel:
            raise ValueError(
                f"--model-parallel {args.model_parallel} must divide the "
                f"{world} processes: run under python -m "
                f"torch.distributed.run --nproc-per-node <a multiple of it>")
        from repro_torch.launch.mesh import init_process_group, make_host_mesh
        init_process_group(args.torch_device)
        mesh = make_host_mesh(args.model_parallel)
    tokens = set((args.opt or "none").split(","))
    if mesh is not None and tokens & {"act", "epmoe"}:
        from repro_torch.distributed.act_sharding import Hints
        from repro_torch.distributed.sharding import data_axes
        # the reference's hints, but with the ZeRO-3 gather on: the port's
        # step computes on each block's gathered weights
        # (`train_loop.make_train_step`)
        hints = Hints(mesh, data_axes(mesh), "model", zero3_gather=True,
                      constrain_activations="act" in tokens,
                      moe_impl="expert_parallel" if "epmoe" in tokens
                      else None)
    cfg = get_smoke_config(args.arch) if args.smoke else get_config(args.arch)
    opt = AdamW(AdamWConfig(
        lr=cosine_schedule(args.lr, max(args.steps // 20, 1), args.steps),
        weight_decay=0.01, moment_dtype=cfg.moment_dtype,
        master_fp32=(cfg.param_dtype == "bfloat16")))
    data = data_iterator(cfg, DataConfig(batch_size=args.batch,
                                         seq_len=args.seq, seed=args.seed))
    loop = LoopConfig(total_steps=args.steps,
                      checkpoint_every=args.checkpoint_every,
                      checkpoint_dir=args.checkpoint_dir)
    return Training(build_model(cfg), opt, data, loop, mesh, hints)


def main(argv=None):
    ap = parser()
    args = ap.parse_args(argv)
    logging.basicConfig(level=logging.INFO,
                        format="%(asctime)s %(name)s %(message)s")

    cfg = get_smoke_config(args.arch) if args.smoke else get_config(args.arch)
    if args.dry_run and not args.autotune:
        ap.error("--dry-run needs --autotune DEVICE")
    run = None if args.dry_run else build_training(args)
    if args.autotune:
        maybe_autotune(args.autotune, cfg, source=args.source,
                       hub_root=args.hub_root, scheduler=args.scheduler,
                       trials=args.autotune_trials, dry_run=args.dry_run,
                       obs=args.obs,
                       torch_device=args.torch_device)
        if args.dry_run:
            log.info("dry-run: autotune path OK; skipping training")
            return
    from repro_torch.distributed.act_sharding import use_hints
    from repro_torch.train.train_loop import run_training
    with use_hints(run.hints):
        _, hist = run_training(run.model, run.opt, run.data, run.loop,
                               seed=args.seed, torch_device=args.torch_device,
                               mesh=run.mesh)
    if run.mesh is not None:
        import torch.distributed as dist
        dist.destroy_process_group()
    if not hist:
        print(f"nothing to train: the checkpoint in {args.checkpoint_dir} "
              f"is at step {args.steps} or later")
        return
    print(f"final loss: {hist[-1]['loss']:.4f} over {len(hist)} steps")


if __name__ == "__main__":
    main()
