"""Tuning Scheduler (port of `repro.sched`): multi-task budget allocation +
async measurement.

Three cooperating pieces:

  * `scheduler.run_campaign` — gradient-based allocation of measurement
    rounds across (device, workload) jobs under a global budget;
  * `executor.MeasurementExecutor` — bounded measurement service with
    timeouts, retries, fault isolation, crash quarantine, and deterministic
    result ordering, selectable as ``backend="thread"`` (in-process pool)
    or ``backend="process"`` (spawn-context farm, `farm.py` — survives
    worker crashes and hard-kills wedged measurements);
  * `speculative.SpeculativeScorer` — Pruner-style draft-then-verify
    candidate screening in front of the full cost model.

`TuneSession.run_many(..., scheduler="gradient")` is the integration point.

The names below are those of the reference's `__all__`, but each submodule
is imported on first use: a spawn farm worker unpickles
`repro_torch.sched.farm._farm_worker_main`, which imports this package, and
an eager import would pull in torch (`engine` -> `strategies` ->
`cost_model`) in every worker and every respawn.
"""
import importlib

_EXPORTS = {
    "RoundStats": "engine", "TaskTuner": "engine",
    "MeasureOutcome": "executor", "MeasureRequest": "executor",
    "MeasurementExecutor": "executor", "QuarantinedConfig": "executor",
    "ThreadMeasurementExecutor": "executor",
    "batch_wall_seconds": "executor", "resolve_executor": "executor",
    "ProcessMeasurementExecutor": "farm",
    "CampaignResult": "scheduler", "SchedulerConfig": "scheduler",
    "TraceEntry": "scheduler", "run_campaign": "scheduler",
    "RandomFeatureDraft": "speculative", "RidgeDraft": "speculative",
    "SpecStats": "speculative", "SpeculativeScorer": "speculative",
}

__all__ = sorted(_EXPORTS)


def __getattr__(name: str):
    module = _EXPORTS.get(name)
    if module is None:
        raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
    value = getattr(importlib.import_module(f"{__name__}.{module}"), name)
    globals()[name] = value
    return value
