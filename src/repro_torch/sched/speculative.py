"""Draft-then-verify candidate scoring (Pruner-style speculative screening;
port of `repro.sched.speculative`).

Once the AC truncates hardware measurement, cost-model queries dominate
search time — and most of them are wasted on candidates that were never
going to rank. Pruner's observation: a *draft* scorer that is much cheaper
than the full cost model can discard the bulk of a candidate batch, and only
the surviving fraction needs the full `batched_predict`.

The draft here is a ridge regression over a strided subset of the 164-d
Ansor features, refit each round on the task's own measured records — a few
hundred rows against ~40 columns, one `np.linalg.solve` per refit. The
combined score vector is rank-safe for the evolutionary search's argsort
consumers: verified rows keep their full-model scores, unverified rows are
mapped strictly below the verified minimum while preserving draft order, so
the search's elite/top-k selection can only ever pick a draft-only row after
every verified row.

In the port the verifier (`CostModel.batched_predict`) runs where the
params live, the card by default, and returns numpy float32 as the
reference's does; the draft stays numpy on the host, and `observe` sees
exactly the scores the verifier returned.

`SpecStats.acceptance` measures how well the draft agrees with the verifier:
the overlap between the draft's top-m and the full model's top-m on each
screened batch — the draft-acceptance stat the benchmark reports.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Callable, Optional

import numpy as np

from repro_torch.core.cost_model import CostModel, Params, Records


@dataclasses.dataclass
class SpecStats:
    """Counters for the draft/verify split, aggregatable across tasks."""
    batches: int = 0            # score calls routed through the scorer
    screened: int = 0           # of those, how many the draft pre-filtered
    draft_rows: int = 0         # rows scored by the draft predictor
    full_rows: int = 0          # rows scored by the full cost model
    unscreened_rows: int = 0    # rows the full model WOULD have scored anyway
    acceptance_sum: float = 0.0
    acceptance_n: int = 0

    @property
    def acceptance(self) -> float:
        """Mean draft/verifier top-m agreement over screened batches."""
        return (self.acceptance_sum / self.acceptance_n
                if self.acceptance_n else 0.0)

    @property
    def full_model_reduction(self) -> float:
        """How many x fewer rows hit the full model than a no-draft run:
        (rows a plain run would score) / (rows this run actually scored)."""
        would = self.unscreened_rows + self.draft_rows
        return would / max(self.full_rows + self.unscreened_rows, 1)

    def merge(self, other: "SpecStats") -> "SpecStats":
        for f in dataclasses.fields(SpecStats):
            setattr(self, f.name,
                    getattr(self, f.name) + getattr(other, f.name))
        return self


class RidgeDraft:
    """Cheap draft predictor: ridge regression on every `stride`-th feature.

    Fitting on the per-task normalized labels keeps the draft on the same
    scale the full model was trained against; `min_rows` gates fitting until
    there is enough signal to beat random screening.

    Caveat: a linear scorer is monotone in every feature, so on an evolved
    (mutant-heavy) population it systematically promotes feature-space
    corners. Fine as a test fixture and for mild screening; the default
    draft for real campaigns is `RandomFeatureDraft`, whose tanh features
    saturate instead of extrapolating.
    """

    def __init__(self, stride: int = 4, l2: float = 1e-2, min_rows: int = 16,
                 refit_every: int = 128, max_rows: int = 2048):
        self.stride = stride
        self.l2 = l2
        self.min_rows = min_rows
        self.refit_every = refit_every
        self.max_rows = max_rows
        self._w: Optional[np.ndarray] = None
        self._cols: Optional[np.ndarray] = None
        self._buf_x: list = []
        self._buf_y: list = []
        self._buf_rows = 0
        self._since_fit = 0

    @property
    def fitted(self) -> bool:
        return self._w is not None

    def _pre_fit(self) -> None:
        """Hook run before each (re)fit; subclasses refresh input stats."""

    def _design(self, x: np.ndarray) -> np.ndarray:
        if self._cols is None:
            self._cols = np.arange(0, x.shape[1], self.stride)
        sub = x[:, self._cols]
        return np.concatenate([sub, np.ones((len(sub), 1), sub.dtype)], 1)

    def fit_xy(self, x: np.ndarray, y: np.ndarray) -> bool:
        """Ridge-fit the readout on (x, y); returns True once fitted."""
        if len(x) < self.min_rows:
            return self.fitted
        self._pre_fit()
        a = self._design(np.asarray(x, np.float64))
        y = np.asarray(y, np.float64)
        gram = a.T @ a + self.l2 * np.eye(a.shape[1])
        self._w = np.linalg.solve(gram, a.T @ y)
        return True

    def fit(self, records: Records) -> bool:
        """Refit on measured records (label-supervised mode)."""
        return self.fit_xy(records.x, records.y)

    def observe(self, x: np.ndarray, y: np.ndarray) -> None:
        """Distillation mode: accumulate (features, teacher score) rows and
        refit every `refit_every` new rows over the freshest `max_rows`.
        The teacher is whatever scored `x` — fitting on the verifier's own
        outputs over the very populations being screened removes the
        domain shift a measured-records fit suffers (the search visits
        mutants far outside the measured set) and tracks the online model
        as it adapts."""
        self._buf_x.append(np.asarray(x, np.float32))
        self._buf_y.append(np.asarray(y, np.float32))
        self._buf_rows += len(x)
        self._since_fit += len(x)
        while (self._buf_rows - len(self._buf_x[0]) >= self.max_rows
               and len(self._buf_x) > 1):
            self._buf_rows -= len(self._buf_x.pop(0))
            self._buf_y.pop(0)
        if not self.fitted or self._since_fit >= self.refit_every:
            if self.fit_xy(np.concatenate(self._buf_x),
                           np.concatenate(self._buf_y)):
                self._since_fit = 0

    def predict(self, x: np.ndarray) -> np.ndarray:
        assert self._w is not None, "predict() before fit()"
        return (self._design(np.asarray(x, np.float64)) @ self._w
                ).astype(np.float32)


class RandomFeatureDraft(RidgeDraft):
    """Feature-subset MLP draft: a fixed random tanh hidden layer + ridge
    readout (only the readout is ever fit — one `width`-dim solve).

    The tanh saturation is the point: candidates outside the measured
    region score near the hidden units' plateaus instead of being linearly
    extrapolated to the top, so the draft cannot steer the evolutionary
    search into unmeasured feature-space corners. Inputs are standardized
    with the fit set's moments (refreshed every refit).
    """

    def __init__(self, width: int = 256, stride: int = 1, l2: float = 1e-2,
                 min_rows: int = 16, seed: int = 0,
                 refit_every: int = 64, max_rows: int = 2048):
        super().__init__(stride=stride, l2=l2, min_rows=min_rows,
                         refit_every=refit_every, max_rows=max_rows)
        self.width = width
        self.seed = seed
        self._proj: Optional[np.ndarray] = None
        self._bias: Optional[np.ndarray] = None
        self._mu = self._sigma = None

    def _pre_fit(self) -> None:
        self._mu = None           # refresh standardization to the fit set

    def _design(self, x: np.ndarray) -> np.ndarray:
        if self._cols is None:
            self._cols = np.arange(0, x.shape[1], self.stride)
        sub = x[:, self._cols]
        if self._proj is None:
            rng = np.random.RandomState(self.seed)
            d = sub.shape[1]
            self._proj = rng.randn(d, self.width) / np.sqrt(d)
            self._bias = rng.randn(self.width) * 0.5
        if self._mu is None:      # first call is always from a fit
            self._mu = sub.mean(0)
            self._sigma = sub.std(0) + 1e-6
        z = np.tanh((sub - self._mu) / self._sigma @ self._proj + self._bias)
        return np.concatenate([z, np.ones((len(z), 1), z.dtype)], 1)


class SpeculativeScorer:
    """score_fn replacement: draft-screen a batch, full-score the top slice.

    Until the draft is fitted (or on small batches where screening cannot
    save anything) every row goes to the full model, so a cold task behaves
    exactly like an unscreened one.
    """

    def __init__(self, cost_model: CostModel, draft: Optional[RidgeDraft] = None,
                 keep_frac: float = 0.35, min_full: int = 16,
                 verify_top: int = 8, distill: bool = True,
                 audit: int = 8, seed: int = 0,
                 stats: Optional[SpecStats] = None,
                 observer: Optional[Callable[[float], None]] = None):
        assert 0.0 < keep_frac <= 1.0
        self.cost_model = cost_model
        self.draft = draft if draft is not None else RandomFeatureDraft()
        self.keep_frac = keep_frac
        self.min_full = min_full
        self.verify_top = verify_top
        self.distill = distill
        # acceptance observer (e.g. CalibrationTracker.observe_acceptance
        # bound to this scorer's task): called with each screened batch's
        # top-m agreement. Shared `stats` aggregate across a whole device;
        # the observer is what keeps per-task attribution.
        self.observer = observer
        # audit rows: a few RANDOM draft-rejected rows are full-scored each
        # screened batch. Without them distillation only ever receives
        # teacher feedback on rows the draft itself promoted — a feedback
        # loop in which the draft's blind spots are never corrected.
        self.audit = audit
        self._rng = np.random.RandomState(seed)
        self.stats = stats if stats is not None else SpecStats()

    def refit(self, records: Records) -> None:
        """Per-round refresh hook. In distillation mode (default) the draft
        feeds itself from every full-model evaluation via `observe`, so
        there is nothing to do; label-supervised drafts refit on the
        measured records."""
        if not self.distill:
            self.draft.fit(records)

    def __call__(self, params: Params, feats: np.ndarray) -> np.ndarray:
        n = len(feats)
        self.stats.batches += 1
        keep = max(self.min_full, int(math.ceil(self.keep_frac * n)))
        if not self.draft.fitted or keep >= n:
            self.stats.unscreened_rows += n
            scores = self.cost_model.batched_predict(params, feats)
            if self.distill:
                self.draft.observe(feats, scores)
            return scores

        self.stats.screened += 1
        draft_scores = self.draft.predict(feats)
        self.stats.draft_rows += n
        order = np.argsort(-draft_scores, kind="stable")
        top, rest = order[:keep], order[keep:]
        if self.audit > 0 and len(rest):
            picked = self._rng.choice(len(rest),
                                      size=min(self.audit, len(rest)),
                                      replace=False)
            audit_rows = rest[np.sort(picked)]
            top = np.concatenate([top, audit_rows])
            rest = np.setdiff1d(rest, audit_rows, assume_unique=True)
        full_scores = self.cost_model.batched_predict(params, feats[top])
        self.stats.full_rows += len(top)
        if self.distill:
            self.draft.observe(feats[top], full_scores)

        m = min(self.verify_top, keep)
        if m > 0:
            # draft's global top-m vs the verifier's top-m of the kept slice
            full_top = set(top[np.argsort(-full_scores, kind="stable")[:m]]
                           .tolist())
            acc = len(full_top.intersection(order[:m].tolist())) / m
            self.stats.acceptance_sum += acc
            self.stats.acceptance_n += 1
            if self.observer is not None:
                self.observer(acc)

        out = np.empty(n, np.float32)
        out[top] = full_scores
        # rank-safe fill: rest sit strictly below the verified minimum, in
        # draft order, so argsort-based consumers prefer verified rows
        floor = float(full_scores.min())
        rest_rank = np.argsort(np.argsort(-draft_scores[rest], kind="stable"))
        out[rest] = floor - 1.0 - rest_rank.astype(np.float32)
        return out
