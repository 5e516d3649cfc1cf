"""Gradient-based multi-task measurement-budget allocation (port of
`repro.sched.scheduler`; the cost model runs on `torch_device`).

The serial tuner walks tasks in order and spends a fixed `trials_per_task`
on each — blind to the fact that budget buys wildly different amounts of
improvement on different (device, workload) pairs, and that a trial on an
embedded board costs ~4x a datacenter trial in simulated seconds. The
scheduler treats the campaign as one pool: every task is a `TaskTuner`
(sched/engine.py) and each grant is ONE measurement round to the task with
the best estimated marginal gain per simulated second:

    priority(task) = max(recent best-latency improvement slope, eps)
                     ----------------------------------------------
                          smoothed cost of one round (seconds)

with a round-robin warmup so every task gets a slope estimate, a per-task
round floor so nothing starves, and a global budget in measurements and/or
simulated seconds. Tasks whose AC terminates (or whose config space runs
dry) leave the pool early; whatever budget they would have burned flows to
tasks still improving. `eps` keeps converged tasks polling occasionally —
a noisy round can re-open a task the slope wrote off.

Everything is deterministic: grants tie-break on job submission order, task
RNGs derive from (seed, device, strategy, workload), and the executor's
result ordering is submission-ordered — rerunning a campaign reproduces it.
"""
from __future__ import annotations

import dataclasses
import sys
from typing import Any, Dict, List, Optional, Sequence, Tuple, Union

from repro_torch.autotune.space import Workload, default_config
from repro_torch.autotune.strategies import (Strategy, StrategyContext,
                                       resolve_strategy, strategy_name)
from repro_torch.autotune.tuner import TaskResult, TuneResult
from repro_torch.autotune import devices as dev_mod
from repro_torch.configs.moses import MosesConfig
from repro_torch.core.cost_model import (CostModel, Params, Records,
                                         resolve_cost_model)
from repro_torch.core.placement import TorchDevice
from repro_torch.obs import FlightRecorder
from repro_torch.obs import metrics as obs_metrics
from repro_torch.obs import trace as obs_trace
from repro_torch.obs.calibration import CalibrationTracker
from repro_torch.sched.engine import TaskTuner
from repro_torch.sched.executor import MeasurementExecutor, resolve_executor
from repro_torch.sched.speculative import (RandomFeatureDraft, SpecStats,
                                     SpeculativeScorer)

Jobs = Sequence[Tuple[str, Sequence[Workload]]]


@dataclasses.dataclass(frozen=True)
class SchedulerConfig:
    """Knobs of the gradient allocator."""
    warmup_rounds: int = 2          # round-robin rounds before gradient mode
    min_rounds: int = 2             # per-task floor (never starved below it)
    slope_window: int = 3           # rounds averaged into the gain slope
    # priority floor for converged tasks; the slope is an ABSOLUTE latency
    # improvement (seconds shaved per round), so the floor sits far below
    # any task still making visible progress while keeping converged tasks
    # polling occasionally
    slope_eps: float = 1e-9
    # optimism: assume a round can still shave this fraction of a task's
    # CURRENT latency, decayed by the rounds already granted. Early slopes
    # are two noisy points — without optimism a task whose round-2 search
    # happened to find nothing is written off even when most of its latency
    # is still on the table (high-latency tasks dominate the campaign
    # objective, so under-exploring them costs the most)
    optimism: float = 0.02
    cost_smoothing: float = 0.5     # EMA factor for per-round cost
    # per-task ceiling, as a multiple of the fair share trials_per_task;
    # bounds how far reallocation can concentrate on one task
    max_share: float = 2.0
    pred_trials: Optional[int] = None   # prediction-only trials at finish
    # measurements per grant; None = moses_cfg.top_k_measure. Smaller rounds
    # give the allocator finer-grained control AND more model updates per
    # measurement (the model matures earlier in each task's budget), at the
    # price of more update overhead
    round_trials: Optional[int] = None


@dataclasses.dataclass
class TraceEntry:
    """One grant decision (the campaign's audit log / benchmark curve)."""
    step: int
    key: str                     # "device|workload-key"
    reason: str                  # warmup | floor | gradient
    priority: float
    spent_seconds: float         # cumulative simulated device-seconds
    measured_seconds: float      # cumulative measurement-only seconds
    wall_seconds: float          # cumulative parallel makespan estimate
    measurements: int            # cumulative (incl. failed) measurements
    total_best_latency: float    # sum of per-task best latencies after grant


@dataclasses.dataclass
class CampaignResult:
    results: List[TuneResult]       # one per device, job submission order
    trace: List[TraceEntry]
    spent_seconds: float            # measurement + model-update seconds
    measured_seconds: float         # on-device measurement seconds only
    wall_seconds: float
    total_measurements: int
    spec_stats: Optional[SpecStats]
    # wall-time attribution + queue-wait summary from the flight recorder
    # (None unless the campaign ran with `obs=`); see obs/recorder.py
    obs_summary: Optional[Dict[str, Any]] = None

    def curve(self) -> List[Tuple[float, float]]:
        """(cumulative measurement seconds, total best latency) per grant,
        closed with the post-finish() point (prediction-only confirmations
        land there)."""
        pts = [(t.measured_seconds, t.total_best_latency)
               for t in self.trace]
        final = sum(t.best_latency * t.workload.count
                    for r in self.results for t in r.tasks)
        pts.append((self.measured_seconds, final))
        return pts


class _Unit:
    """Scheduler-side bookkeeping wrapped around one TaskTuner."""

    def __init__(self, idx: int, tuner: TaskTuner):
        self.idx = idx
        self.tuner = tuner
        self.rounds = 0
        self.cost_ema: Optional[float] = None
        self.slopes: List[float] = []

    def priority(self, cfg: SchedulerConfig) -> float:
        recent = self.slopes[-cfg.slope_window:]
        slope = sum(recent) / len(recent) if recent else 0.0
        t = self.tuner
        optimism = (cfg.optimism * t.best_latency * t.wl.count
                    / max(self.rounds, 1))
        cost = self.cost_ema if self.cost_ema else 1.0
        return max(slope + optimism, cfg.slope_eps) / max(cost, 1e-9)

    def absorb(self, stats, smoothing: float) -> None:
        self.rounds += 1
        self.slopes.append(stats.improvement)
        if self.cost_ema is None:
            self.cost_ema = stats.device_seconds
        else:
            self.cost_ema = (smoothing * stats.device_seconds
                             + (1 - smoothing) * self.cost_ema)


def run_campaign(
    jobs: Jobs,
    moses_cfg: MosesConfig,
    strategy: Union[str, Strategy] = "moses",
    cost_model: Union[str, CostModel, None] = None,
    pretrained_params: Optional[Params] = None,
    source_pool: Optional[Records] = None,
    seed: int = 0,
    trials_per_task: Optional[int] = None,
    budget_seconds: Optional[float] = None,
    total_trials: Optional[int] = None,
    sched: Optional[SchedulerConfig] = None,
    executor: Union[MeasurementExecutor, str, None] = None,
    speculative: bool = False,
    keep_frac: float = 0.35,
    ratio_override: Optional[float] = None,
    model_update_cost: float = 2.0,
    seed_fn=None,
    share_model: bool = True,
    obs: Union[FlightRecorder, str, None] = None,
    calibration: Union[CalibrationTracker, bool, None] = None,
    torch_device: TorchDevice = "cuda",
) -> CampaignResult:
    """Run one scheduled tuning campaign over `jobs` = [(device, tasks)].

    Budget: `total_trials` defaults to `trials_per_task x number of tasks`
    (the serial tuner's spend); `budget_seconds` optionally caps simulated
    device-seconds as well — whichever runs out first ends measurement.
    `seed_fn(device, wl_key) -> int` overrides per-task seed derivation
    (TuneSession passes its `derive_job_seed` so campaign and serial runs
    share streams).

    `share_model=True` (default) gives each device ONE Strategy instance
    and ONE group-tagged records builder shared by all its tasks: the
    online model trains on the device's whole measurement corpus (ranking
    loss groups per task), so every task's rounds sharpen every other
    task's scoring — the campaign-level sample-efficiency win the serial
    loop only gets sequentially. `share_model=False` isolates tasks
    completely (one strategy + builder each).

    `obs` turns on the campaign flight recorder: a directory path gets a
    recorder of its own (artifacts land there as `events.jsonl` +
    `campaign.trace.json`), a `FlightRecorder` instance is used as-is
    (started here if the caller has not; only a recorder started here is
    stopped here). The result's `obs_summary` then carries the wall-time
    attribution; tracing off (`obs=None`) costs one global read per span
    site.

    `calibration` controls search introspection (obs/calibration.py): the
    default (None) creates a tracker, a `CalibrationTracker` instance is
    used as-is (the hub passes its own so provenance records can read the
    per-task summaries), and False disables tracking entirely. The tracker
    is a pure observer — on or off, tuning results are bit-for-bit
    identical (regression-tested).

    The cost model, and with it every strategy's params, lives on
    `torch_device` ("cuda" by default, which raises without a card); a
    `CostModel` instance must already live there. `jobs` name simulated
    tuning targets.
    """
    from repro_torch.autotune.session import derive_job_seed

    sched = sched or SchedulerConfig()
    cm = resolve_cost_model(cost_model, moses_cfg.cost_model, torch_device)
    strat_label = strategy_name(strategy)
    trials = (trials_per_task if trials_per_task is not None
              else moses_cfg.small_trials)

    # flight recorder: start it BEFORE the executor exists so worker pools,
    # unit construction, and every grant land in the campaign registry
    recorder: Optional[FlightRecorder] = None
    started_recorder = False
    if isinstance(obs, str):
        recorder = FlightRecorder(root=obs)
    elif obs is not None:
        recorder = obs
    if recorder is not None:
        started_recorder = not recorder._started
        recorder.start()
    obs_summary: Optional[Dict[str, Any]] = None

    # executor may be an instance, a backend name ("thread" | "process"),
    # or None (default thread pool); owned pools are shut down on exit
    executor, own_executor = resolve_executor(executor, workers=4)
    spec_stats = SpecStats() if speculative else None
    if calibration is False:
        calib: Optional[CalibrationTracker] = None
    elif calibration is None or calibration is True:
        calib = CalibrationTracker()
    else:
        calib = calibration
    campaign_span = obs_trace.span(
        "campaign", strategy=strat_label, devices=len(list(jobs)),
        tasks=sum(len(ts) for _, ts in jobs))
    campaign_span.__enter__()

    # --- build one prepared TaskTuner per (device, workload) -------------
    units: List[_Unit] = []
    raw_results: Dict[Tuple[str, str], TaskResult] = {}
    order: List[Tuple[str, List[Workload]]] = [(d, list(ts)) for d, ts in jobs]
    from repro_torch.autotune.strategies import STRATEGY_REGISTRY
    from repro_torch.core.cost_model import RecordsBuilder
    try:
        # an instance spec with a registered name re-resolves fresh per
        # device (instances carry per-job state); an UNregistered instance
        # cannot be cloned, so it is only sound as the single shared
        # strategy of a single-device share_model campaign — anything wider
        # would re-prepare the one object under other units' feet
        unit_spec = (strategy.name
                     if isinstance(strategy, Strategy)
                     and strategy.name in STRATEGY_REGISTRY else strategy)
        if isinstance(unit_spec, Strategy):
            n_scopes = (len({d for d, _ in jobs}) if share_model
                        else sum(len(ts) for _, ts in jobs))
            if n_scopes > 1:
                raise ValueError(
                    f"strategy instance {type(strategy).__name__} is not in "
                    "the registry and cannot be re-instantiated per "
                    f"{'device' if share_model else 'task'} "
                    f"({n_scopes} needed); register it with "
                    "@register_strategy or pass its name")
        shared: Dict[str, Tuple[Strategy, RecordsBuilder]] = {}
        shared_drafts: Dict[str, RandomFeatureDraft] = {}
        for device, tasks in order:
            for wl in tasks:
                if seed_fn is not None:
                    task_seed = seed_fn(device, wl.key())
                else:
                    task_seed = derive_job_seed(seed, device, strat_label,
                                                salt=wl.key())
                probe = resolve_strategy(unit_spec)
                if not probe.uses_model:        # raw: no search at all
                    cfg = default_config(wl)
                    lat = dev_mod.execution_time(
                        wl, cfg, dev_mod.DEVICES[device], noisy=False)
                    raw_results[(device, wl.key())] = TaskResult(
                        wl, cfg, wl.flops / lat / 1e9, lat, 0, 0.0, [],
                        measured=[])
                    continue
                builder = None
                if share_model:
                    if device not in shared:
                        strat = probe
                        strat.prepare(StrategyContext(
                            cfg=moses_cfg, cost_model=cm, device=device,
                            seed=derive_job_seed(seed, device, strat_label),
                            pretrained_params=pretrained_params,
                            source_pool=source_pool,
                            ratio_override=ratio_override,
                            model_update_cost=model_update_cost))
                        shared[device] = (strat, RecordsBuilder())
                    strat, builder = shared[device]
                else:
                    strat = probe
                    strat.prepare(StrategyContext(
                        cfg=moses_cfg, cost_model=cm, device=device,
                        seed=task_seed, pretrained_params=pretrained_params,
                        source_pool=source_pool,
                        ratio_override=ratio_override,
                        model_update_cost=model_update_cost))
                scorer = None
                if speculative:
                    # tasks sharing a model also share one draft (fit on
                    # the same device corpus); isolated tasks draft alone
                    draft = None
                    if builder is not None:
                        draft = shared_drafts.setdefault(
                            device, RandomFeatureDraft())
                    observer = None
                    if calib is not None:
                        # bind (device, task) now: the shared SpecStats
                        # cannot attribute acceptance per task, the
                        # observer can
                        observer = (lambda acc, _d=device, _k=wl.key():
                                    calib.observe_acceptance(_d, _k, acc))
                    scorer = SpeculativeScorer(cm, draft=draft,
                                               keep_frac=keep_frac,
                                               stats=spec_stats,
                                               observer=observer)
                units.append(_Unit(len(units), TaskTuner(
                    wl, device, strat, moses_cfg, cm, task_seed, executor,
                    scorer=scorer, shared_builder=builder,
                    group=len(units), calibration=calib)))

        # --- the grant loop ---------------------------------------------
        per_round = (sched.round_trials if sched.round_trials is not None
                     else moses_cfg.top_k_measure)
        max_meas = (total_trials if total_trials is not None
                    else trials * max(len(units), 1))
        max_task_rounds = max(1, round(sched.max_share * trials / per_round))
        spent = measured_s = wall = 0.0
        measurements = 0
        trace: List[TraceEntry] = []
        step = 0
        while True:
            active = [u for u in units if u.tuner.active
                      and u.rounds < max_task_rounds]
            if not active:
                break
            if measurements >= max_meas:
                break
            if budget_seconds is not None and spent >= budget_seconds:
                break
            needy = [u for u in active if u.rounds < sched.warmup_rounds]
            floored = [u for u in active if u.rounds < sched.min_rounds]
            if needy:
                unit, reason = needy[0], "warmup"
            elif floored:
                unit, reason = floored[0], "floor"
            else:
                unit = max(active,
                           key=lambda u: (u.priority(sched), -u.idx))
                reason = "gradient"
            won_priority = unit.priority(sched)   # the value that won
            with obs_trace.span("tune.round", device=unit.tuner.device,
                                task=unit.tuner.wl.key(), reason=reason,
                                step=step + 1):
                stats = unit.tuner.step(per_round)
            unit.absorb(stats, sched.cost_smoothing)
            spent += stats.device_seconds
            measured_s += stats.measure_seconds
            wall += stats.wall_seconds
            measurements += stats.measured + stats.failed
            step += 1
            reg = obs_metrics.current()
            reg.counter("sched.grants", reason=reason).inc()
            reg.counter("sched.measure_seconds").inc(stats.measure_seconds)
            reg.counter("sched.update_seconds").inc(stats.update_seconds)
            reg.counter("sched.measurements").inc(stats.measured
                                                  + stats.failed)
            if stats.failed:
                reg.counter("sched.failed").inc(stats.failed)
            total_best = sum(u.tuner.best_latency * u.tuner.wl.count
                             for u in units)
            trace.append(TraceEntry(
                step, unit.tuner.key, reason, won_priority, spent,
                measured_s, wall, measurements, total_best))
            if recorder is not None:
                # mirror of TraceEntry in the on-disk decision log: a
                # campaign that dies mid-flight still shows every grant
                recorder.event(
                    "grant", step=step, key=unit.tuner.key, reason=reason,
                    priority=round(won_priority, 9),
                    measured=stats.measured, failed=stats.failed,
                    spent_seconds=round(spent, 6),
                    total_best_latency=round(total_best, 9))

        # --- wrap-up: prediction-only phase + assembly --------------------
        by_key: Dict[Tuple[str, str], TaskResult] = dict(raw_results)
        for u in units:
            by_key[(u.tuner.device, u.tuner.wl.key())] = u.tuner.finish(
                pred_trials=sched.pred_trials)
        # re-derive totals from the TaskResults so the confirmation
        # measurements of finish() are accounted (failures keep their cost
        # inside search_seconds but produce no measurement count)
        spent = sum(r.search_seconds for r in by_key.values())
        measured_s = sum(u.tuner.meas_seconds for u in units)
        measurements = sum(r.measurements for r in by_key.values())
    finally:
        if own_executor:
            executor.shutdown()
        # inside the finally so an aborted campaign still closes its root
        # span (status=error) and releases the recorder's registry/tracer
        exc = sys.exc_info()
        campaign_span.__exit__(*exc)
        if recorder is not None:
            if exc[0] is None:
                if calib is not None and len(calib):
                    recorder.event("calibration", summary=calib.summary())
                recorder.event("campaign_result",
                               spent_seconds=round(spent, 6),
                               measured_seconds=round(measured_s, 6),
                               measurements=measurements,
                               grants=len(trace))
                obs_summary = recorder.summary()
            if started_recorder:
                recorder.stop()

    # the final adapted model params per device (the provenance layer's
    # ticket-overlap input); with share_model all of a device's units hold
    # the same Strategy, without it the last task's instance stands in
    dev_params: Dict[str, Any] = {}
    for u in units:
        if u.tuner.strategy.params is not None:
            dev_params[u.tuner.device] = u.tuner.strategy.params
    results = []
    for device, tasks in order:
        trs = [by_key[(device, wl.key())] for wl in tasks]
        results.append(TuneResult(strat_label, device, trs,
                                  sum(t.search_seconds for t in trs),
                                  final_params=dev_params.get(device)))
    return CampaignResult(results, trace, spent, measured_s, wall,
                          measurements, spec_stats, obs_summary=obs_summary)
