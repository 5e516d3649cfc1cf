"""Continual Learning & Model Lifecycle for the Transfer Hub (port of
`repro.continual`).

Keeps every device's saved cost model fresh as the hub store grows,
instead of serving a one-shot snapshot forever:

  replay.py      class-balanced, deterministic replay sampling from the
                 store's per-(device, task) shards (reservoir per group),
                 mixed with fresh records at a configurable ratio
  regularize.py  drift-aware continual update — lottery-mask-anchored L2
                 (EWC-lite with the Moses mask as the importance prior)
  drift.py       drift detectors over fingerprint shift and cost-model
                 calibration (rolling pairwise rank accuracy), emitting
                 typed DriftReports
  lifecycle.py   ModelLifecycle: versioned model lineage in the store,
                 refresh/keep/retire decisions, the held-out
                 no-regression guard, TuningHub integration
"""
from repro_torch.continual.drift import (CALIBRATION, FINGERPRINT,
                                         DriftReport, calibration_drift,
                                         detect_drift, fingerprint_drift,
                                         newest_records)
from repro_torch.continual.lifecycle import (STATES, LifecycleConfig,
                                             ModelLifecycle, RefreshResult)
from repro_torch.continual.regularize import anchor_weights, anchored_train
from repro_torch.continual.replay import (ReplayBuffer, ReplayConfig,
                                          build_records, device_rows,
                                          split_tail)

__all__ = [
    "ReplayBuffer", "ReplayConfig", "build_records", "device_rows",
    "split_tail", "anchor_weights", "anchored_train", "DriftReport",
    "FINGERPRINT", "CALIBRATION", "fingerprint_drift", "calibration_drift",
    "detect_drift", "newest_records", "ModelLifecycle", "LifecycleConfig",
    "RefreshResult", "STATES",
]
