"""TuneSession: orchestrates multiple (device, strategy) tuning jobs
(PyTorch port of `repro.autotune.session`).

Every consumer of the tuner — the paper-figure benchmarks, the examples, the
kernel-registry autotune path — needs the same setup: a pretrained cost
model + source record pool shared across jobs, a deterministic-but-isolated
RNG seed per job, per-strategy knob overrides, and optional persistence of
winners into the tuned-config `Registry`. TuneSession owns that boilerplate
once so callers submit jobs instead of re-plumbing `tune(...)` arguments.

RNG isolation: with `isolate_rng=True` (default) each job's seed is derived
by hashing (session seed, device, strategy, salt), so

  * two jobs in one session never share an RNG stream (no hidden coupling
    through np.random state or seed arithmetic collisions), and
  * a job's stream is independent of submission order — re-running a single
    (device, strategy) cell reproduces exactly what the full matrix ran.
"""
from __future__ import annotations

import dataclasses
import hashlib
import logging
from typing import Any, Dict, List, Optional, Sequence, Tuple, Union

from repro_torch.autotune.registry import Registry
from repro_torch.autotune.space import Workload
from repro_torch.autotune.strategies import (STRATEGIES, Strategy,
                                             resolve_strategy, strategy_name)
from repro_torch.autotune.tuner import TuneResult, tune
from repro_torch.configs.moses import DEFAULT as DEFAULT_CFG
from repro_torch.configs.moses import MosesConfig
from repro_torch.core.cost_model import (CostModel, Params, Records,
                                         resolve_cost_model)
from repro_torch.core.placement import TorchDevice

log = logging.getLogger(__name__)
StrategySpec = Union[str, Strategy]


def derive_job_seed(base_seed: int, device: str, strategy: str,
                    salt: str = "") -> int:
    """Stable, order-independent per-job seed (md5 of the job identity)."""
    ident = f"{base_seed}|{device}|{strategy}|{salt}"
    return int(hashlib.md5(ident.encode()).hexdigest()[:8], 16) % (2 ** 31 - 1)


@dataclasses.dataclass
class TuneSession:
    """Shared context for a batch of tuning jobs.

    Attributes:
      moses_cfg: hyperparameters shared by every job (per-job overrides go
        through `run(..., ratio_override=...)` etc.).
      pretrained_params: source-device cost-model parameters. Shared by
        reference — `tune()` deep-copies before mutating, so jobs never
        observe each other's online updates.
      source_pool: source-device records for Moses' adversarial term.
      seed: session base seed; per-job seeds derive from it (see
        `derive_job_seed`) unless `isolate_rng=False`, in which case every
        job receives `seed` verbatim (the legacy behavior).
      trials_per_task: default measurement budget per task; overridable per
        job.
      registry: when set, every finished job's best configs are ingested
        (call `registry.save()` yourself when you want them persisted).
      store: when set, every measurement each job makes is appended to this
        record store (duck-typed `repro_torch.hub.store.RecordStore`:
        put_result + flush) — the hub's persistent cross-device corpus.
        Call `store.flush()` to persist (the TuningHub service does both).
      cost_model: scoring-model family shared by every job — a registered
        name ("mlp", ...) or a `CostModel` instance; None is the paper
        default MLP. Per-job overrides go through `run(..., cost_model=...)`.
      torch_device: where the cost model runs ("cuda" by default; raises
        without a card unless "cpu" is asked for). `device` arguments name
        the simulated tuning target, as in the reference.

    Strategies are registered names or `Strategy` instances throughout —
    `run(tasks, dev, "moses")` and `run(tasks, dev, MosesStrategy())` are
    the same job (string resolution goes through the strategy registry).

    Example:
        session = TuneSession(moses_cfg=MCFG, pretrained_params=params,
                              source_pool=src, seed=1)
        res = session.run(tasks, "tpu_edge", "moses")
        matrix = session.run_matrix({"squeezenet": tasks}, {"TX2": "tpu_edge"},
                                    ("tenset-finetune", "moses"))
    """

    moses_cfg: MosesConfig = dataclasses.field(
        default_factory=lambda: DEFAULT_CFG)
    pretrained_params: Optional[Params] = None
    source_pool: Optional[Records] = None
    seed: int = 0
    trials_per_task: Optional[int] = None
    registry: Optional[Registry] = None
    store: Optional[Any] = None  # duck-typed hub RecordStore (no dep cycle)
    isolate_rng: bool = True
    cost_model: Union[str, CostModel, None] = None
    torch_device: TorchDevice = "cuda"
    results: List[TuneResult] = dataclasses.field(default_factory=list)

    def resolved_cost_model(self) -> CostModel:
        """The session's cost model on `torch_device`, resolved once and
        shared by every job."""
        cached = getattr(self, "_resolved_cm", None)
        if cached is None or cached[0] is not self.cost_model:
            cached = (self.cost_model, resolve_cost_model(
                self.cost_model, self.moses_cfg.cost_model,
                self.torch_device))
            self._resolved_cm = cached
        return cached[1]

    def job_seed(self, device: str, strategy: StrategySpec,
                 salt: str = "") -> int:
        """Seeds key on the strategy NAME, so a registered name and an
        instance of the same strategy land on the same stream."""
        if not self.isolate_rng:
            return self.seed
        return derive_job_seed(self.seed, device, strategy_name(strategy),
                               salt)

    def run(self, tasks: Sequence[Workload], device: str,
            strategy: StrategySpec,
            trials_per_task: Optional[int] = None, salt: str = "",
            **tune_kwargs) -> TuneResult:
        """Run one tuning job; extra kwargs flow through to `tune()`
        (e.g. ratio_override=, cross_task=, model_update_cost=,
        cost_model=)."""
        # resolve early so an unknown name fails here, not mid-matrix
        strategy = resolve_strategy(strategy)
        trials = (trials_per_task if trials_per_task is not None
                  else self.trials_per_task
                  if self.trials_per_task is not None
                  else self.moses_cfg.small_trials)
        tune_kwargs.setdefault("cost_model", self.resolved_cost_model())
        tune_kwargs.setdefault("torch_device", self.torch_device)
        result = tune(
            tasks, device, strategy, self.moses_cfg,
            trials_per_task=trials,
            pretrained_params=self.pretrained_params,
            source_pool=self.source_pool,
            seed=self.job_seed(device, strategy, salt),
            **tune_kwargs)
        self.results.append(result)
        if self.registry is not None:
            self.registry.ingest(result)
        if self.store is not None:
            self.store.put_result(result)
        return result

    def run_many(self, jobs: Union[Dict[str, Sequence[Workload]],
                                   Sequence[Tuple[str, Sequence[Workload]]]],
                 strategy: StrategySpec = "moses",
                 scheduler: str = "gradient",
                 trials_per_task: Optional[int] = None,
                 budget_seconds: Optional[float] = None,
                 total_trials: Optional[int] = None,
                 sched=None, executor=None, speculative: bool = False,
                 salt: str = "", return_campaign: bool = False,
                 **campaign_kwargs):
        """Tune several (device, task-list) jobs as ONE campaign.

        `scheduler="serial"` reproduces the legacy behavior — one `run()`
        per device in job order, each task getting the full
        `trials_per_task`. `scheduler="gradient"` hands the whole job set to
        `repro_torch.sched.run_campaign`: measurement rounds are allocated
        by marginal gain per simulated second under a global budget
        (`total_trials` defaults to the serial spend; `budget_seconds`
        optionally caps simulated device-seconds), measurements run through
        the async executor, and `speculative=True` screens candidates with
        the draft-then-verify scorer. The campaign's cost model runs on the
        session's `torch_device`.

        Returns the per-device `TuneResult` list (job order); with
        `return_campaign=True` returns the full `CampaignResult` (trace,
        budget accounting, spec stats) instead. Either way results land in
        `self.results` and the registry/store exactly like `run()`.
        """
        job_list = (list(jobs.items()) if isinstance(jobs, dict)
                    else [(d, list(ts)) for d, ts in jobs])
        if scheduler == "serial":
            # fail loudly on campaign-only knobs instead of silently
            # ignoring them — an A/B caller passing identical kwargs to
            # both modes must not get an uncapped, unscreened serial run
            dropped = {"budget_seconds": budget_seconds,
                       "total_trials": total_trials, "sched": sched,
                       "executor": executor,
                       "speculative": speculative or None,
                       "return_campaign": return_campaign or None,
                       **campaign_kwargs}
            dropped = {k: v for k, v in dropped.items() if v is not None}
            if dropped:
                raise ValueError(
                    f"run_many(scheduler='serial') does not support "
                    f"{sorted(dropped)}; use scheduler='gradient'")
            return [self.run(tasks, device, strategy,
                             trials_per_task=trials_per_task, salt=salt)
                    for device, tasks in job_list]
        if scheduler != "gradient":
            raise ValueError(f"unknown scheduler {scheduler!r}; "
                             "expected 'serial' or 'gradient'")
        # lazy: the scheduler imports this module for derive_job_seed
        from repro_torch.sched import run_campaign
        trials = (trials_per_task if trials_per_task is not None
                  else self.trials_per_task
                  if self.trials_per_task is not None
                  else self.moses_cfg.small_trials)
        # per-task seeds ride the session's RNG-isolation policy: the salt
        # carries the workload key so each task owns an independent stream
        # (order-independent, like run()'s per-job derivation)
        campaign = run_campaign(
            job_list, self.moses_cfg, strategy=strategy,
            cost_model=self.resolved_cost_model(),
            pretrained_params=self.pretrained_params,
            source_pool=self.source_pool, seed=self.seed,
            trials_per_task=trials, budget_seconds=budget_seconds,
            total_trials=total_trials, sched=sched, executor=executor,
            speculative=speculative,
            seed_fn=lambda dev, key: self.job_seed(
                dev, strategy, salt=f"{key}|{salt}" if salt else key),
            torch_device=self.torch_device, **campaign_kwargs)
        for result in campaign.results:
            self.results.append(result)
            if self.registry is not None:
                self.registry.ingest(result)
            if self.store is not None:
                self.store.put_result(result)
        return campaign if return_campaign else campaign.results

    def refresh_params(self, device: str, params: Params, records: Records,
                       anchor: Optional[Params] = None,
                       weights: Optional[Params] = None,
                       epochs: int = 8, lr: Optional[float] = None,
                       salt: str = "") -> Tuple[Params, List[float]]:
        """Continual-refresh training job: (re)fit `params` on `records`
        with the lottery-mask-anchored L2 pull toward `anchor` (see
        `repro_torch.continual.regularize.anchored_train`; `anchor`/`weights`
        None means plain training — the cold-start path).

        This is how `ModelLifecycle` refreshes ride the session machinery:
        the job uses the session's resolved cost model on its
        `torch_device` and an order-independent derived seed, so a
        background refresh is as reproducible as any `run()` job. Returns
        (new params, per-epoch losses); nothing is persisted here — the
        lifecycle manager owns versioning and the no-regression guard."""
        from repro_torch.continual.regularize import anchored_train
        seed = self.job_seed(device, "continual-refresh", salt)
        return anchored_train(self.resolved_cost_model(), params, records,
                              anchor=anchor, weights=weights, epochs=epochs,
                              lr=lr, seed=seed, torch_device=self.torch_device)

    def run_matrix(self, task_sets: Dict[str, Sequence[Workload]],
                   devices: Dict[str, str],
                   strategies: Sequence[StrategySpec] = STRATEGIES,
                   trials_per_task: Optional[int] = None,
                   ratio_override: Optional[float] = None,
                   progress: bool = False,
                   ) -> Dict[str, Dict[str, TuneResult]]:
        """The benchmark grid: results[f"{set}|{role}"][strategy-name].

        `devices` maps a display role (the paper's device name) to a
        simulated device id; `ratio_override` applies to the moses strategy
        only (the Fig. 6 ablation knob).
        """
        out: Dict[str, Dict[str, TuneResult]] = {}
        for set_name, tasks in task_sets.items():
            for role, device in devices.items():
                key = f"{set_name}|{role}"
                out[key] = {}
                for strat in strategies:
                    name = strategy_name(strat)
                    if progress:
                        log.info("matrix cell %s %s", key, name)
                    out[key][name] = self.run(
                        tasks, device, strat,
                        trials_per_task=trials_per_task, salt=set_name,
                        ratio_override=(ratio_override if name == "moses"
                                        else None))
        return out
