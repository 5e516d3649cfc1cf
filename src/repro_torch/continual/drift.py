"""Drift detection: when does a device's saved cost model go stale? (Port of
`repro.continual.drift`; calibration scores where the params live.)

Two independent signals, both cheap relative to a tuning job:

  fingerprint drift — the device's *hardware response* moved. Re-run the
    16-probe fingerprint suite (`hub/fingerprint.py`, ~16 kernel launches)
    and measure the cosine shift against the persisted vector. Firmware
    updates, thermal regimes, driver changes: anything that bends the
    response surface shows up here even before any new tuning data exists.

  calibration drift — the model's *ranking* decayed on what the device is
    measuring now. Compute the pairwise rank accuracy of the saved params
    over the newest records of each task shard (the rolling window). TLP
    observes exactly this failure: a learned cost model quietly misranks
    once the workload distribution shifts, while its loss on old data
    still looks fine.

Both emit a typed `DriftReport`; the lifecycle manager turns reports into
refresh / keep / retire decisions.
"""
from __future__ import annotations

import dataclasses
import math
from typing import List, Optional

import numpy as np

from repro_torch.continual.replay import build_records, device_rows, split_tail
from repro_torch.core.cost_model import (CostModel, Params, Records,
                                         rank_accuracy)

FINGERPRINT = "fingerprint"
CALIBRATION = "calibration"


@dataclasses.dataclass(frozen=True)
class DriftReport:
    """One detector's verdict for one device.

    kind: FINGERPRINT or CALIBRATION.
    value: the measured signal — cosine *shift* (1 - similarity, 0 = no
      drift) for fingerprints; pairwise rank accuracy (1.0 = perfect,
      0.5 = chance) for calibration.
    threshold: the boundary the value was judged against (shift above /
      accuracy below => drifted).
    drifted: the verdict. Detectors with no baseline to compare against
      (no saved fingerprint, no saved params, too few records) report
      drifted=False with the reason in `detail` — absence of evidence is
      a "keep", never a spurious refresh trigger.
    """
    device: str
    kind: str
    value: float
    threshold: float
    drifted: bool
    detail: str = ""


def fingerprint_drift(store, device: str, threshold: float = 0.02,
                      current: Optional[np.ndarray] = None) -> DriftReport:
    """Cosine shift between the persisted fingerprint and a fresh probe.

    `current` lets callers reuse a vector they already probed (the hub's
    miss path fingerprints anyway); otherwise the suite runs here."""
    from repro_torch.hub.fingerprint import device_fingerprint, \
        fingerprint_similarity
    saved = store.get_fingerprint(device)
    if saved is None:
        return DriftReport(device, FINGERPRINT, 0.0, threshold, False,
                           "no saved fingerprint")
    cur = current if current is not None else device_fingerprint(device)
    shift = 1.0 - fingerprint_similarity(saved, cur)
    return DriftReport(device, FINGERPRINT, float(shift), threshold,
                       shift > threshold, "")


def calibration_drift(model: CostModel, params: Optional[Params],
                      records: Records, device: str,
                      threshold: float = 0.65,
                      min_records: int = 8) -> DriftReport:
    """Rolling rank accuracy of `params` on the newest records.

    `records` is the caller's newest-slice window (see `newest_records`);
    accuracy below `threshold` means the saved model misranks what the
    device is measuring now."""
    if params is None:
        return DriftReport(device, CALIBRATION, float("nan"), threshold,
                           False, "no saved params")
    if len(records) < min_records:
        return DriftReport(device, CALIBRATION, float("nan"), threshold,
                           False, f"only {len(records)} recent records")
    acc = rank_accuracy(params, records,
                        predict_fn=model.batched_predict)
    if math.isnan(acc):
        return DriftReport(device, CALIBRATION, float("nan"), threshold,
                           False, "no comparable record pairs")
    return DriftReport(device, CALIBRATION, float(acc), threshold,
                       acc < threshold, "")


def newest_records(store, device: str, per_task: int,
                   rows_by_task=None, holdout_only: bool = False) -> Records:
    """The newest `per_task` rows of every task shard, featurized — the
    rolling window calibration drift (and the refresh's fresh slice +
    held-out guard) reads.

    `rows_by_task` accepts a pre-fetched `device_rows` result so callers
    that already walked the corpus do not pay a second store read.
    `holdout_only=True` keeps only the odd-parity rows of the window — the
    half an accepted refresh NEVER trains on (`lifecycle.py` trains on the
    even half), so calibration is always judged on leak-free data."""
    rows = (rows_by_task if rows_by_task is not None
            else device_rows(store, device))
    _, tail = split_tail(rows, per_task)
    if holdout_only:
        tail = {k: v[1::2] for k, v in tail.items()}
    return build_records(tail)


def detect_drift(store, device: str, model: Optional[CostModel] = None,
                 params: Optional[Params] = None, *,
                 fingerprint_threshold: float = 0.02,
                 calibration_threshold: float = 0.65,
                 window: int = 32,
                 current_fingerprint: Optional[np.ndarray] = None,
                 rows_by_task=None) -> List[DriftReport]:
    """Run every applicable detector for `device`; fingerprint first (it
    needs no model), calibration when a model + params are supplied.
    Calibration reads only the holdout parity of the newest window — the
    rows no refresh has trained on — so a freshly refreshed model cannot
    look calibrated merely by having memorized the window."""
    reports = [fingerprint_drift(store, device,
                                 threshold=fingerprint_threshold,
                                 current=current_fingerprint)]
    if model is not None:
        reports.append(calibration_drift(
            model, params,
            newest_records(store, device, window, rows_by_task=rows_by_task,
                           holdout_only=True), device,
            threshold=calibration_threshold))
    return reports
