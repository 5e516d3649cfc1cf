"""Search introspection: streaming calibration of the learned components
(port of `repro.obs.calibration`; imports repointed).

The tuning stack trusts two learned components on its hot path: the cost
model (ranks candidate programs so only the top-k get measured) and the
speculative draft (screens candidates before the full model sees them).
`CalibrationTracker` watches both *as they are used* — every measured
round hands it the model's predictions next to the simulator's ground
truth — and turns the comparison into the standard metrics sink:

  * ``calib.residual{device,task}``        histogram of |z(pred)-z(meas)|
    per measured candidate (both sides z-scored within the batch: scores
    and GFLOP/s live on different scales, ranking is what matters);
  * ``calib.rank_accuracy{device,task}``   gauge, rolling pairwise
    concordance over every measured pair so far (the same quantity the
    continual-drift detector thresholds, computed from live rounds);
  * ``calib.topk{device,task,result}``     counter, hit/miss — was the
    measured-best candidate inside the model's predicted top-k?
  * ``calib.topk_regret{device,task}``     histogram, relative throughput
    given up by trusting the model's argmax over the measured argmax;
  * ``calib.draft_acceptance{device,task}`` histogram + rolling gauge of
    the draft/verifier top-m agreement per screened batch.

All histograms land on the shared fixed bucket grid (`obs.metrics`), so
campaign snapshots merge exactly like every other instrument.

The tracker is a **pure observer**: it never touches the search RNG, never
mutates strategy state, and predictions are made with the params that
actually scored the round — enabling it changes no tuning result
bit-for-bit (regression-tested). Rounds scored by the cold-start random
policy (no model params yet) carry no model signal and are skipped.
"""
from __future__ import annotations

import dataclasses
import threading
from typing import Dict, Optional

import numpy as np

from repro_torch.obs import metrics as obs_metrics

# label values ride the `name{k=v,...}` exposition format; strip the
# characters that would break parse_key round-tripping
_LABEL_BAD = str.maketrans({c: "_" for c in "{}=,\n"})


def _label(value: str) -> str:
    return str(value).translate(_LABEL_BAD)


@dataclasses.dataclass
class _TaskState:
    """Rolling per-(device, task) calibration aggregates."""
    rounds: int = 0
    n_points: int = 0
    pairs_concordant: float = 0.0
    pairs_total: int = 0
    topk_hits: int = 0
    topk_misses: int = 0
    residual_sum: float = 0.0
    regret_sum: float = 0.0
    acceptance_sum: float = 0.0
    acceptance_n: int = 0

    @property
    def rank_accuracy(self) -> float:
        if self.pairs_total == 0:
            return float("nan")
        return self.pairs_concordant / self.pairs_total

    @property
    def acceptance(self) -> float:
        if self.acceptance_n == 0:
            return float("nan")
        return self.acceptance_sum / self.acceptance_n

    def to_dict(self) -> Dict[str, object]:
        def opt(x: float) -> Optional[float]:
            return None if x != x else round(x, 6)

        return {
            "rounds": self.rounds,
            "n_points": self.n_points,
            "rank_accuracy": opt(self.rank_accuracy),
            "pairs": self.pairs_total,
            "topk_hits": self.topk_hits,
            "topk_misses": self.topk_misses,
            "mean_abs_residual": opt(self.residual_sum / self.n_points
                                     if self.n_points else float("nan")),
            "mean_topk_regret": opt(
                self.regret_sum / (self.topk_hits + self.topk_misses)
                if (self.topk_hits + self.topk_misses) else float("nan")),
            "draft_acceptance": opt(self.acceptance),
            "draft_batches": self.acceptance_n,
        }


def pair_concordance(pred: np.ndarray, meas: np.ndarray):
    """All-pairs rank concordance between two score vectors.

    Returns (concordant, total): pairs tied on the measured side carry no
    ranking signal and are skipped; pairs tied on the predicted side get
    half credit (the model refused to order them). Batches are tiny
    (top-k measured per round), so the O(n^2) sweep is exact and cheap —
    no sampling, no RNG.
    """
    n = pred.size
    concordant, total = 0.0, 0
    for i in range(n):
        for j in range(i + 1, n):
            dm = meas[i] - meas[j]
            if dm == 0.0:
                continue
            dp = pred[i] - pred[j]
            total += 1
            if dp == 0.0:
                concordant += 0.5
            elif (dp > 0.0) == (dm > 0.0):
                concordant += 1.0
    return concordant, total


def _zscore(x: np.ndarray) -> np.ndarray:
    sd = float(x.std())
    return (x - float(x.mean())) / (sd if sd > 0.0 else 1.0)


class CalibrationTracker:
    """Streaming predicted-vs-measured calibration, per (device, task).

    `observe_round` is called once per measured round with the model
    scores for exactly the candidates that got measured; it updates the
    rolling per-task aggregates and exports them through the active
    metrics registry (`obs.metrics.current()` unless one is bound at
    construction — under a running FlightRecorder that is the campaign
    registry, so calibration rides the campaign snapshot for free).
    """

    def __init__(self, registry: Optional[obs_metrics.MetricsRegistry] = None,
                 top_k: int = 3):
        self._registry = registry
        self.top_k = int(top_k)
        self._lock = threading.Lock()
        self._tasks: Dict[tuple, _TaskState] = {}

    def _reg(self) -> obs_metrics.MetricsRegistry:
        return self._registry if self._registry is not None \
            else obs_metrics.current()

    def _state(self, device: str, task: str) -> _TaskState:
        key = (device, task)
        st = self._tasks.get(key)
        if st is None:
            st = self._tasks[key] = _TaskState()
        return st

    # --- observation points -----------------------------------------------
    def observe_round(self, device: str, task: str, round_idx: int,
                      predicted, measured) -> Optional[Dict[str, float]]:
        """One measured round: model scores vs measured throughputs for the
        same candidates, in the same order. Returns the per-round record
        (None when the batch carries no signal)."""
        pred = np.asarray(predicted, dtype=np.float64).reshape(-1)
        meas = np.asarray(measured, dtype=np.float64).reshape(-1)
        if pred.size == 0 or pred.size != meas.size:
            return None
        reg = self._reg()
        labels = {"device": _label(device), "task": _label(task)}

        residuals = np.abs(_zscore(pred) - _zscore(meas))
        conc, total = pair_concordance(pred, meas)

        k = min(self.top_k, pred.size)
        best = int(np.argmax(meas))
        top_pred = np.argsort(pred, kind="stable")[-k:]
        hit = best in set(int(i) for i in top_pred)
        peak = float(meas[best])
        chosen = float(meas[int(np.argmax(pred))])
        regret = max(0.0, (peak - chosen) / peak) if peak > 0.0 else 0.0

        with self._lock:
            st = self._state(device, task)
            st.rounds += 1
            st.n_points += int(pred.size)
            st.pairs_concordant += conc
            st.pairs_total += total
            st.residual_sum += float(residuals.sum())
            st.regret_sum += regret
            if hit:
                st.topk_hits += 1
            else:
                st.topk_misses += 1
            rolling_acc = st.rank_accuracy

        hist = reg.histogram("calib.residual", **labels)
        for r in residuals:
            hist.observe(float(r))
        if rolling_acc == rolling_acc:
            reg.gauge("calib.rank_accuracy", **labels).set(rolling_acc)
        reg.counter("calib.topk", result="hit" if hit else "miss",
                    **labels).inc()
        reg.histogram("calib.topk_regret", **labels).observe(regret)
        return {"round": int(round_idx), "n": int(pred.size),
                "rank_accuracy": conc / total if total else float("nan"),
                "topk_hit": bool(hit), "regret": regret}

    def observe_acceptance(self, device: str, task: str,
                           acceptance: float) -> None:
        """One screened batch's draft/verifier top-m agreement in [0,1]."""
        a = float(acceptance)
        if a != a:
            return
        reg = self._reg()
        labels = {"device": _label(device), "task": _label(task)}
        with self._lock:
            st = self._state(device, task)
            st.acceptance_sum += a
            st.acceptance_n += 1
            rolling = st.acceptance
        reg.histogram("calib.draft_acceptance", **labels).observe(a)
        reg.gauge("calib.acceptance", **labels).set(rolling)

    # --- readout -----------------------------------------------------------
    def per_task(self, device: str, task: str) -> Optional[Dict[str, object]]:
        with self._lock:
            st = self._tasks.get((device, task))
            return st.to_dict() if st is not None else None

    def summary(self) -> Dict[str, object]:
        """All per-task aggregates, keyed ``device|task`` — the recorder
        event / explain-report payload."""
        with self._lock:
            items = sorted(self._tasks.items())
            return {f"{d}|{t}": st.to_dict() for (d, t), st in items}

    def __len__(self) -> int:
        with self._lock:
            return len(self._tasks)
