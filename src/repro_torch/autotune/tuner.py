"""The auto-tuning loop (paper Fig. 2 pipeline + §3.6), PyTorch port of
`repro.autotune.tuner`.

The loop is fixed; the policies around it are plugins:

  * adaptation scheme — a `Strategy` (autotune/strategies.py), resolved from
    a registered name or passed as an instance. The five paper strategies
    (paper §4.4: raw, ansor-random, tenset-pretrain, tenset-finetune, moses)
    ship registered; new schemes are one `@register_strategy` class.
  * scoring model — a `CostModel` (core/cost_model.py), resolved the same
    way ("mlp" is the paper default; "residual-mlp" ships as a second
    family). Strategies only ever see the interface.

Search-time accounting mirrors the paper: on-device measurement dominates, so
search_time = sum(measurement_seconds) + small per-round model-update cost.
The AC module (moses only) truncates the measurement phase when the cost
model's CV stabilizes.

Hot path: each task owns a FeatureCache (every distinct config featurized
once) and a RecordsBuilder (records appended incrementally, labels
re-normalized per snapshot); all scoring goes through
`CostModel.batched_predict`. The cost model runs on `torch_device` (the card
by default); the search and the simulated measurement run on the host with
the reference's numpy RNG streams. Use `autotune.session.TuneSession` to run
several (device, strategy) jobs over shared pretrained params.
"""
from __future__ import annotations

import dataclasses
from typing import List, Optional, Sequence, Tuple, Union

import numpy as np

from repro_torch.autotune import devices as dev_mod
from repro_torch.autotune.evolution import evolutionary_search
from repro_torch.autotune.space import (ProgramConfig, Workload,
                                        clip_config_to_space, default_config,
                                        workload_descriptor)
from repro_torch.autotune.strategies import (Strategy, StrategyContext,
                                             resolve_strategy, strategy_name)
from repro_torch.configs.moses import MosesConfig
from repro_torch.core.cost_model import (CostModel, Records, RecordsBuilder,
                                         resolve_cost_model)
from repro_torch.core.features import FeatureCache
from repro_torch.core.placement import TorchDevice


@dataclasses.dataclass
class TaskResult:
    workload: Workload
    best_config: ProgramConfig
    best_throughput: float          # GFLOP/s (noiseless eval)
    best_latency: float             # seconds per call (noiseless)
    measurements: int
    search_seconds: float
    trajectory: List[float]         # best-so-far throughput per measurement
    # every (config, measured throughput, trial index) triple, in
    # measurement order — what the transfer hub's record store persists
    # (trial matters: the simulator's noise redraws per trial, so the store
    # dedups on (task, config, trial)). None for legacy callers.
    measured: Optional[List[Tuple[ProgramConfig, float, int]]] = None
    # configs whose measurement failed under the executor (crash, timeout,
    # quarantine): (config, trial, error). The hub writes these to the store
    # as error records so a refreshed model knows which configs are hostile.
    # None for legacy callers / the serial loop (which has no executor).
    poisoned: Optional[List[Tuple[ProgramConfig, int, str]]] = None


@dataclasses.dataclass
class TuneResult:
    strategy: str
    device: str
    tasks: List[TaskResult]
    total_search_seconds: float
    # the adapted cost-model params at the end of the run (None for
    # model-free strategies). The transfer-provenance layer compares these
    # against the source ticket's params (lottery-mask overlap); they are
    # NOT persisted with the result itself.
    final_params: Optional[object] = None

    @property
    def model_latency(self) -> float:
        """End-to-end latency: sum over subgraphs of best latency x count."""
        return sum(t.best_latency * t.workload.count for t in self.tasks)

    @property
    def total_measurements(self) -> int:
        return sum(t.measurements for t in self.tasks)


def _noiseless_latency(wl: Workload, cfg: ProgramConfig, device: str) -> float:
    return dev_mod.execution_time(wl, cfg, dev_mod.DEVICES[device],
                                  noisy=False)


def tune(
    tasks: Sequence[Workload],
    device: str,
    strategy: Union[str, Strategy],
    moses_cfg: MosesConfig,
    trials_per_task: int = 200,
    pretrained_params=None,
    source_pool: Optional[Records] = None,
    seed: int = 0,
    ratio_override: Optional[float] = None,
    model_update_cost: float = 2.0,
    cross_task: bool = False,
    cost_model: Union[str, CostModel, None] = None,
    calibration=None,
    torch_device: TorchDevice = "cuda",
) -> TuneResult:
    """Tune `tasks` on `device` under an adaptation `strategy`.

    `strategy` and `cost_model` accept registered names (back-compat: the
    five paper strategies and "mlp" resolve exactly as the old string API
    did) or instances for anything custom.

    `calibration` (an `obs.CalibrationTracker`, optional) observes each
    measured batch's predicted-vs-measured calibration. Pure observer:
    passing one changes no tuning result.

    `device` is the simulated target; the cost model runs on
    `torch_device`, which raises when it is "cuda" and no card is present.
    """
    strat = resolve_strategy(strategy)
    cm = resolve_cost_model(cost_model, moses_cfg.cost_model, torch_device)
    strat.prepare(StrategyContext(
        cfg=moses_cfg, cost_model=cm, device=device, seed=seed,
        pretrained_params=pretrained_params, source_pool=source_pool,
        ratio_override=ratio_override, model_update_cost=model_update_cost))
    rng = np.random.RandomState(seed)

    task_results: List[TaskResult] = []
    total_search = 0.0
    # cross-task transfer archive (paper's stated future work; see
    # benchmarks/crosstask.py): (descriptor, best configs) of finished tasks
    archive: List = []

    for gid, wl in enumerate(tasks):
        if not strat.uses_model:
            cfg = default_config(wl)
            lat = _noiseless_latency(wl, cfg, device)
            task_results.append(TaskResult(wl, cfg, wl.flops / lat / 1e9, lat,
                                           0, 0.0, [], measured=[]))
            continue

        strat.begin_task(wl)
        seen: set = set()
        measured: List[Tuple[ProgramConfig, float]] = []
        recorded: List[Tuple[ProgramConfig, float, int]] = []  # + trial idx
        traj: List[float] = []
        best_thr = float("-inf")    # running best-so-far for the trajectory
        search_s = 0.0
        # per-task feature cache + incremental record builder: every config a
        # scoring or training pass touches is featurized exactly once
        cache = FeatureCache()
        builder = RecordsBuilder()

        def score_fn(feats: np.ndarray) -> np.ndarray:
            if strat.params is None:
                return rng.rand(len(feats))
            return cm.batched_predict(strat.params, feats)

        batch_sizes, n_pred = strat.plan(trials_per_task)

        warm_seeds: List[ProgramConfig] = []
        if cross_task and archive:
            desc = workload_descriptor(wl)
            sims = [(float(np.linalg.norm(desc - d)), cfgs)
                    for d, cfgs in archive]
            _, best_cfgs = min(sims, key=lambda t: t[0])
            for c in best_cfgs:
                cc = clip_config_to_space(wl, c)
                if cc is not None and cc.knobs not in seen:
                    warm_seeds.append(cc)

        for bi, bsz in enumerate(batch_sizes):
            cands = evolutionary_search(
                wl, score_fn, rng,
                population=moses_cfg.population_size,
                rounds=moses_cfg.evolution_rounds,
                mutation_prob=moses_cfg.mutation_prob,
                top_k=bsz, eps_greedy=moses_cfg.eps_greedy, seen=seen,
                seed_configs=(warm_seeds if (bi == 0 and not measured) else [])
                + [c for c, _ in sorted(measured, key=lambda t: -t[1])[:8]],
                feature_cache=cache)
            if not cands:  # config space exhausted
                break
            feats = cache.features_batch(wl, cands)
            thr = np.array([dev_mod.measure(wl, c, device, trial=bi)
                            for c in cands], np.float32)
            for c, t, f in zip(cands, thr, feats):
                measured.append((c, float(t)))
                recorded.append((c, float(t), bi))
                builder.append(f, float(t))
                best_thr = max(best_thr, float(t))
                traj.append(best_thr)
            search_s += sum(dev_mod.measurement_seconds(wl, c, device)
                            for c in cands)
            if calibration is not None and strat.params is not None:
                # strat.params still holds the model that scored this
                # batch — on_round (below) is the only mutator.
                # batched_predict is pure; the search RNG is untouched.
                preds = cm.batched_predict(strat.params, feats)
                calibration.observe_round(device, wl.key(), bi, preds, thr)

            # strategy hook: online model update on the incremental record
            # set (features were extracted once at measurement time; only
            # labels re-normalize) — each strategy snapshots only if it
            # trains, and reports its model-update cost + AC termination
            upd = strat.on_round(builder, feats, bi)
            search_s += upd.cost_seconds
            if upd.terminate:
                # early-terminate hardware measurement; remaining trials
                # are pure cost-model predictions (paper §3.5)
                n_pred += sum(batch_sizes[bi + 1:])
                break

        # prediction-only trials: explore with the (adapted) cost model and
        # accept its argmax WITHOUT measuring (zero hardware cost)
        if n_pred > 0 and strat.params is not None:
            cands = evolutionary_search(
                wl, score_fn, rng, population=moses_cfg.population_size,
                rounds=moses_cfg.evolution_rounds, top_k=n_pred, seen=seen,
                feature_cache=cache)
            cands = cands or [default_config(wl)]
            scores = cm.batched_predict(strat.params,
                                        cache.features_batch(wl, cands))
            top = cands[int(np.argmax(scores))]
            # top-1 predicted config gets one confirmation measurement
            thr = dev_mod.measure(wl, top, device, trial=97)
            measured.append((top, float(thr)))
            recorded.append((top, float(thr), 97))
            best_thr = max(best_thr, float(thr))
            traj.append(best_thr)
            search_s += dev_mod.measurement_seconds(wl, top, device)

        best_cfg, _ = max(measured, key=lambda t: t[1])
        lat = _noiseless_latency(wl, best_cfg, device)
        task_results.append(TaskResult(
            wl, best_cfg, wl.flops / lat / 1e9, lat,
            len(measured), search_s, traj, measured=recorded))
        total_search += search_s
        if cross_task:
            top4 = [c for c, _ in sorted(measured, key=lambda t: -t[1])[:4]]
            archive.append((workload_descriptor(wl), top4))

    return TuneResult(strategy_name(strat), device, task_results,
                      total_search, final_params=strat.params)
