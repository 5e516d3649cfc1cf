"""Adaptive Controller (paper §3.5): early-terminates on-device measurement.

For a subgraph s being tuned, trials are split into measurement-backed
training trials (ratio p) and cost-model-predicted trials. The training
trials are divided into q batches; after each batch we compute the
coefficient of variation

    CV = sigma(C(t_train(s))_1..q) / mu(C(t_train(s))_1..q)

over the cost model's predictions on the measured batches. When CV drops
below the threshold, the model is considered certain and the (expensive)
hardware-measurement phase terminates early; the remaining trials rely on
cost-model predictions only.
"""
from __future__ import annotations

import dataclasses
from typing import List

import numpy as np


@dataclasses.dataclass
class ACState:
    batch_means: List[float] = dataclasses.field(default_factory=list)
    terminated: bool = False
    cv_history: List[float] = dataclasses.field(default_factory=list)


class AdaptiveController:
    def __init__(self, train_ratio: float = 0.5, num_batches: int = 4,
                 cv_threshold: float = 0.08, min_batches: int = 2):
        self.train_ratio = train_ratio
        self.num_batches = num_batches
        self.cv_threshold = cv_threshold
        self.min_batches = min_batches

    def plan(self, total_trials: int):
        """Split a task's budget into (per-measure-batch sizes, n_pred)."""
        t_train = int(round(total_trials * self.train_ratio))
        t_pred = total_trials - t_train
        q = max(1, self.num_batches)
        base = t_train // q
        sizes = [base + (1 if i < t_train % q else 0) for i in range(q)]
        return [s for s in sizes if s > 0], t_pred

    def observe(self, state: ACState, cost_model, params,
                feats: np.ndarray) -> ACState:
        """Score the latest measured batch with a `CostModel` and update the
        CV state. The controller only ever sees scores — any registered model
        family plugs in here without the AC knowing its internals."""
        return self.update(state, cost_model.batched_predict(params, feats))

    def update(self, state: ACState, predictions: np.ndarray) -> ACState:
        """Feed the cost model's predictions on the latest measured batch."""
        state.batch_means.append(float(np.mean(predictions)))
        if len(state.batch_means) >= self.min_batches:
            mu = float(np.mean(state.batch_means))
            sigma = float(np.std(state.batch_means))
            cv = sigma / max(abs(mu), 1e-9)
            state.cv_history.append(cv)
            if cv < self.cv_threshold:
                state.terminated = True
        return state
