"""Stepwise tuning engine: one task, one measured round per `step()`
(port of `repro.sched.engine`; imports repointed, nothing else changed).

`autotune.tuner.tune()` owns a whole task's budget from start to finish —
correct for the paper figures, but a multi-task scheduler needs to *interleave*
tasks: grant one measurement round to whichever (device, workload) currently
buys the most improvement per simulated second, then reassess. `TaskTuner`
is the tune() inner loop re-cut along that seam: the per-task state (strategy
instance, RNG, seen-set, feature cache, records builder, trajectory) lives in
the object, and each `step()` runs exactly one evolutionary-search +
measure + model-update round. `finish()` runs the prediction-only phase and
materializes the same `TaskResult` the serial loop produces.

Differences from the serial loop, by design:
  * one Strategy instance per task (the serial loop shares one across a
    task list, which would leak state across interleaved tasks);
  * measurement goes through a `MeasurementExecutor` (parallel workers,
    timeouts, fault isolation) instead of a bare `devices.measure` loop —
    failed measurements cost simulated seconds but produce no record;
  * candidate scoring can be routed through a `SpeculativeScorer`
    (draft-then-verify) instead of always hitting the full cost model.

Determinism: the task's RNG is derived from (seed, device, strategy,
workload-key), the executor returns outcomes in submission order, and the
simulator's noise keys on (config, trial) — so a campaign's results are a
pure function of its job set, never of thread timing or grant order
interleaving with *other* tasks' RNGs.

In the port the cost model scores on its `torch_device` (the card by
default) inside every evolution round; a task whose strategy has no params
yet draws its scores from the task's numpy RNG in the reference's order.
"""
from __future__ import annotations

import dataclasses
from typing import List, Optional, Tuple

import numpy as np

from repro_torch.autotune import devices as dev_mod
from repro_torch.autotune.evolution import evolutionary_search
from repro_torch.autotune.space import ProgramConfig, Workload, default_config
from repro_torch.autotune.strategies import Strategy
from repro_torch.autotune.tuner import TaskResult
from repro_torch.configs.moses import MosesConfig
from repro_torch.core.cost_model import CostModel
from repro_torch.core.features import FeatureCache
from repro_torch.core.cost_model import RecordsBuilder
from repro_torch.obs import trace as obs_trace
from repro_torch.obs.calibration import CalibrationTracker
from repro_torch.sched.executor import MeasurementExecutor, batch_wall_seconds
from repro_torch.sched.speculative import SpeculativeScorer


@dataclasses.dataclass
class RoundStats:
    """What one `step()` reports back to the scheduler."""
    measured: int               # records produced (excludes failures)
    failed: int                 # measurements that errored / timed out
    measure_seconds: float      # simulated on-device cost of the round
    update_seconds: float       # model-update cost the strategy reported
    wall_seconds: float         # parallel makespan estimate for the round
    # absolute best-latency improvement this round, weighted by the
    # workload's occurrence count — i.e. seconds shaved off the parent
    # model's latency, the quantity the campaign objective sums
    improvement: float
    terminated: bool            # strategy (AC) says stop measuring
    exhausted: bool             # config space ran dry

    @property
    def device_seconds(self) -> float:
        """Total simulated cost of the grant (the scheduler's budget)."""
        return self.measure_seconds + self.update_seconds


class TaskTuner:
    """One (device, workload) tuning job, advanced one round at a time."""

    def __init__(self, wl: Workload, device: str, strategy: Strategy,
                 moses_cfg: MosesConfig, cost_model: CostModel, seed: int,
                 executor: MeasurementExecutor,
                 scorer: Optional[SpeculativeScorer] = None,
                 shared_builder: Optional[RecordsBuilder] = None,
                 group: int = 0,
                 calibration: Optional[CalibrationTracker] = None):
        self.wl = wl
        self.device = device
        self.strategy = strategy
        self.cfg = moses_cfg
        self.cost_model = cost_model
        self.executor = executor
        self.scorer = scorer
        # pure observer: records predicted-vs-measured calibration per
        # round; never touches the RNG or strategy state, so enabling it
        # changes no tuning result (regression-tested)
        self.calibration = calibration
        # multi-task model sharing: when several tasks on one device share a
        # Strategy instance, they also share `shared_builder` — every task's
        # records land there under its own `group` id, so the shared model's
        # per-task-normalized ranking loss trains on the device's WHOLE
        # measurement corpus (each task profits from its neighbors' rounds)
        self.shared_builder = shared_builder
        self.group = group
        self.rng = np.random.RandomState(seed)
        strategy.begin_task(wl)
        # per-task strategy state (moses' AC state): with a shared strategy,
        # each tuner keeps its own snapshot and swaps it in around on_round,
        # so one task's §3.5 early-termination can never cascade to its
        # neighbors on the device
        self._task_state = strategy.task_state()

        self.seen: set = set()
        self.measured: List[Tuple[ProgramConfig, float]] = []
        self.recorded: List[Tuple[ProgramConfig, float, int]] = []
        # configs whose measurement failed (crash / timeout / quarantine):
        # (config, trial, error) — surfaced on TaskResult.poisoned so the
        # hub can persist them as error records instead of losing the signal
        self.poisoned: List[Tuple[ProgramConfig, int, str]] = []
        self.traj: List[float] = []
        self.cache = FeatureCache()
        self.builder = RecordsBuilder()
        self.best_thr = float("-inf")
        self.best_cfg: Optional[ProgramConfig] = None
        self.best_latency = dev_mod.execution_time(
            wl, default_config(wl), dev_mod.DEVICES[device], noisy=False)
        self.search_seconds = 0.0
        self.meas_seconds = 0.0     # on-device measurement seconds only
        self.rounds = 0
        self.terminated = False
        self.exhausted = False
        self.finished = False

    @property
    def key(self) -> str:
        return f"{self.device}|{self.wl.key()}"

    @property
    def active(self) -> bool:
        return not (self.terminated or self.exhausted or self.finished)

    # --- scoring ----------------------------------------------------------
    def _score_fn(self, feats: np.ndarray) -> np.ndarray:
        params = self.strategy.params
        if params is None:
            return self.rng.rand(len(feats))
        if self.scorer is not None:
            return self.scorer(params, feats)
        return self.cost_model.batched_predict(params, feats)

    def _refresh_best(self) -> None:
        cfg, _ = max(self.measured, key=lambda t: t[1])
        if cfg is not self.best_cfg:
            self.best_cfg = cfg
            self.best_latency = dev_mod.execution_time(
                self.wl, cfg, dev_mod.DEVICES[self.device], noisy=False)

    # --- one measured round -----------------------------------------------
    def step(self, batch_size: Optional[int] = None) -> RoundStats:
        assert self.active, "step() on an inactive task"
        bsz = batch_size if batch_size is not None else self.cfg.top_k_measure
        prev_latency = self.best_latency
        # the params that score THIS round's search; on_round replaces them
        # below, so calibration must predict with the pre-update snapshot
        params_for_round = self.strategy.params
        with obs_trace.span("round.search", device=self.device,
                            task=self.wl.key()):
            cands = evolutionary_search(
                self.wl, self._score_fn, self.rng,
                population=self.cfg.population_size,
                rounds=self.cfg.evolution_rounds,
                mutation_prob=self.cfg.mutation_prob,
                top_k=bsz, eps_greedy=self.cfg.eps_greedy, seen=self.seen,
                seed_configs=[c for c, _ in
                              sorted(self.measured, key=lambda t: -t[1])[:8]],
                feature_cache=self.cache)
        if not cands:
            self.exhausted = True
            return RoundStats(0, 0, 0.0, 0.0, 0.0, 0.0, False, True)

        with obs_trace.span("round.measure", device=self.device,
                            task=self.wl.key(), n=len(cands)):
            feats = self.cache.features_batch(self.wl, cands)
            outcomes = self.executor.measure_batch(self.wl, cands,
                                                   self.device,
                                                   trial=self.rounds)
        ok_feats = []
        ok_thrs: List[float] = []
        failed = 0
        for out, f in zip(outcomes, feats):
            if not out.ok:
                failed += 1           # paid for, but poisoned: no record
                self.poisoned.append((out.request.config, out.request.trial,
                                      out.error or "failed"))
                continue
            cfg, thr = out.request.config, out.throughput
            self.measured.append((cfg, thr))
            self.recorded.append((cfg, thr, out.request.trial))
            self.builder.append(f, thr)
            if self.shared_builder is not None:
                self.shared_builder.append(f, thr, group=self.group)
            ok_feats.append(f)
            ok_thrs.append(thr)
            if thr > self.best_thr:
                self.best_thr = thr
            self.traj.append(self.best_thr)
        if (self.calibration is not None and ok_feats
                and params_for_round is not None):
            # cold-start rounds (random scores, no params) carry no model
            # signal; batched_predict is pure, so this observes without
            # perturbing the search
            preds = self.cost_model.batched_predict(params_for_round,
                                                    np.stack(ok_feats))
            self.calibration.observe_round(self.device, self.wl.key(),
                                           self.rounds, preds, ok_thrs)
        costs = [out.seconds for out in outcomes]
        measure_seconds = sum(costs)
        wall = batch_wall_seconds(costs, self.executor.workers)

        terminated = False
        update_seconds = 0.0
        if ok_feats:
            self._refresh_best()
            train_builder = (self.shared_builder
                             if self.shared_builder is not None
                             else self.builder)
            with obs_trace.span("round.update", device=self.device,
                                task=self.wl.key()):
                if self.shared_builder is not None:
                    self.strategy.set_task_state(self._task_state)
                upd = self.strategy.on_round(train_builder,
                                             np.stack(ok_feats), self.rounds)
                if self.shared_builder is not None:
                    self._task_state = self.strategy.task_state()
                if self.scorer is not None and not self.scorer.distill:
                    # label-supervised drafts must train on the same corpus
                    # the full model does — a task-local draft screening a
                    # device-corpus model discards candidates the stronger
                    # verifier would keep. (Distilling drafts feed
                    # themselves from every full-model evaluation; no
                    # snapshot needed.)
                    self.scorer.refit(train_builder.snapshot())
            update_seconds = upd.cost_seconds
            wall += upd.cost_seconds
            terminated = upd.terminate
        self.search_seconds += measure_seconds + update_seconds
        self.meas_seconds += measure_seconds
        self.rounds += 1
        self.terminated = terminated
        improvement = (prev_latency - self.best_latency) * self.wl.count
        return RoundStats(len(ok_feats), failed, measure_seconds,
                          update_seconds, wall, improvement, terminated,
                          False)

    # --- wrap-up ----------------------------------------------------------
    def finish(self, pred_trials: Optional[int] = None) -> TaskResult:
        """Prediction-only phase (explore with the adapted model, confirm its
        argmax with ONE measurement) + TaskResult assembly."""
        assert not self.finished
        self.finished = True
        n_pred = (pred_trials if pred_trials is not None
                  else self.cfg.top_k_measure)
        if (n_pred > 0 and self.strategy.params is not None
                and not self.exhausted and self.measured):
            with obs_trace.span("tune.finish", device=self.device,
                                task=self.wl.key()):
                cands = evolutionary_search(
                    self.wl, self._score_fn, self.rng,
                    population=self.cfg.population_size,
                    rounds=self.cfg.evolution_rounds, top_k=n_pred,
                    seen=self.seen, feature_cache=self.cache)
                cands = cands or [default_config(self.wl)]
                scores = self.cost_model.batched_predict(
                    self.strategy.params,
                    self.cache.features_batch(self.wl, cands))
                top = cands[int(np.argmax(scores))]
                outcome = self.executor.measure_batch(
                    self.wl, [top], self.device, trial=97)[0]
            if outcome.ok:
                self.measured.append((top, outcome.throughput))
                self.recorded.append((top, outcome.throughput, 97))
                self.best_thr = max(self.best_thr, outcome.throughput)
                self.traj.append(self.best_thr)
            else:
                self.poisoned.append((top, 97, outcome.error or "failed"))
            self.search_seconds += outcome.seconds
            self.meas_seconds += outcome.seconds
        if not self.measured:       # nothing survived: vendor default
            cfg = default_config(self.wl)
            lat = dev_mod.execution_time(self.wl, cfg,
                                         dev_mod.DEVICES[self.device],
                                         noisy=False)
            return TaskResult(self.wl, cfg, self.wl.flops / lat / 1e9, lat,
                              0, self.search_seconds, self.traj, measured=[],
                              poisoned=self.poisoned)
        self._refresh_best()
        lat = self.best_latency
        return TaskResult(self.wl, self.best_cfg, self.wl.flops / lat / 1e9,
                          lat, len(self.measured), self.search_seconds,
                          self.traj, measured=self.recorded,
                          poisoned=self.poisoned)
