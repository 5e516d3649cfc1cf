"""ModelLifecycle: versioned, drift-aware serving models for the hub (port of
`repro.continual.lifecycle`; the refresh trains on the `torch_device` the
manager is given, the card by default).

The Transfer Hub at first saved each device's pretrained params exactly once
and served them forever. This manager closes the loop TCL argues for —
continual, replay-based updates as the corpus grows — with an explicit
state machine per (device, model family):

    fresh ──drift detected──► stale ──refresh()──► refreshing
      ▲                         │                      │
      │                         │ retire-grade drift   │ guard passes:
      │                         ▼                      │ new version saved
      └──────────────────── retired ◄──────────────────┘ (else: kept, stale)

Every accepted refresh is a NEW version in the store's lineage
(`hub/store.py`): parent version, records-seen watermark, drift trigger,
held-out rank accuracy and parameter distance travel with it, so "which
model served device X when" is answerable after the fact. Serving always
loads the newest non-retired version; `retire()` is for drift beyond
repair (the response surface moved so far the lineage is worthless — start
over from the neighbors).

The refresh itself is TCL-shaped: class-balanced replay from the store
(`replay.py`) mixed with the newest records, trained under the
lottery-mask-anchored L2 (`regularize.py`), and gated by a no-regression
guard — candidate params that rank the held-out newest slice worse than
the serving version are rejected, so a refresh can never make serving
worse on the data that triggered it.
"""
from __future__ import annotations

import dataclasses
import json
import math
import os
import threading
import time
from typing import Any, Dict, List, Optional

from repro_torch.configs.moses import DEFAULT as DEFAULT_CFG
from repro_torch.configs.moses import MosesConfig
from repro_torch.continual.drift import (CALIBRATION, FINGERPRINT, DriftReport,
                                   detect_drift)
from repro_torch.continual.regularize import anchor_weights
from repro_torch.continual.replay import (ReplayBuffer, ReplayConfig,
                                    build_records, device_rows, split_tail)
from repro_torch.core import lottery
from repro_torch.core.cost_model import (CostModel, Params, param_distance,
                                         rank_accuracy, resolve_cost_model)
from repro_torch.core.placement import TorchDevice, resolve_torch_device
from repro_torch.obs import metrics as obs_metrics
from repro_torch.obs import trace as obs_trace


STATES = ("absent", "fresh", "stale", "refreshing", "retired")


@dataclasses.dataclass(frozen=True)
class LifecycleConfig:
    """Policy knobs of the lifecycle manager.

    fingerprint_threshold: cosine shift above which the device counts as
      drifted; retire_threshold: shift beyond repair — the lineage is
      abandoned rather than refreshed.
    calibration_threshold: rank accuracy on the newest records below which
      the serving model counts as stale.
    window: newest rows per task shard forming the fresh slice (split
      half/half into refresh-training and held-out guard rows).
    min_fresh: refuse to refresh on fewer fresh training rows (a refresh
      triggered by two noisy measurements would be pure churn).
    guard_eps: tolerated held-out rank-accuracy regression (absorbs
      sampling noise in the accuracy estimate itself).
    """
    fingerprint_threshold: float = 0.02
    retire_threshold: float = 0.5
    calibration_threshold: float = 0.65
    window: int = 32
    min_fresh: int = 8
    refresh_epochs: int = 8
    refresh_lr: Optional[float] = None
    anchor_strength: float = 1e-2
    guard_eps: float = 0.01
    replay: ReplayConfig = dataclasses.field(default_factory=ReplayConfig)


@dataclasses.dataclass
class RefreshResult:
    """What one `refresh()` attempt did (accepted or not). Beyond the
    reference's fields: the training job's per-epoch losses, and for an
    anchored refresh the share of params in the anchor's transferable mask
    (`ticket_fraction`; ties at the ratio threshold are all kept, so it
    can exceed the ratio) and the relative distance moved within it
    (`ticket_distance`; `param_distance` is over all params)."""
    device: str
    accepted: bool
    reason: str                          # why rejected / "saved"
    trigger: str = ""
    version: Optional[int] = None        # new lineage version when accepted
    parent: Optional[int] = None
    holdout_accuracy_old: float = float("nan")
    holdout_accuracy_new: float = float("nan")
    param_distance: float = float("nan")
    n_fresh: int = 0
    n_mix: int = 0
    records_seen: int = 0
    losses: List[float] = dataclasses.field(default_factory=list)
    ticket_fraction: float = float("nan")
    ticket_distance: float = float("nan")

    def to_dict(self) -> Dict[str, Any]:
        d = dataclasses.asdict(self)
        for k, v in d.items():
            if isinstance(v, float) and math.isnan(v):
                d[k] = None
        return d


class ModelLifecycle:
    """Drift-aware refresh/keep/retire decisions over a hub record store.

    Thread-compatible with the hub's background jobs: refreshes for one
    device serialize (a second concurrent `refresh()` for the same device
    returns immediately as rejected), and all store writes go through the
    store's own locking. Models load and train on `torch_device` (raises
    without a card unless "cpu" is asked for); a `session` must run its
    cost model there too.
    """

    def __init__(self, store, model_name: str = "mlp",
                 moses_cfg: MosesConfig = DEFAULT_CFG,
                 cfg: Optional[LifecycleConfig] = None, seed: int = 0,
                 session=None, torch_device: TorchDevice = "cuda"):
        self.store = store
        self.torch_device = resolve_torch_device(torch_device)
        self.model_name = model_name
        self.moses_cfg = moses_cfg
        self.cfg = cfg if cfg is not None else LifecycleConfig()
        self.seed = seed
        self._session = session
        self._model: Optional[CostModel] = None
        self._lock = threading.RLock()
        self._refreshing: set = set()
        self.history: List[RefreshResult] = []

    # --- shared machinery -------------------------------------------------
    def model(self) -> CostModel:
        if self._model is None:
            if self._session is not None:
                self._model = self._session.resolved_cost_model()
            if self._model is None:
                self._model = resolve_cost_model(self.model_name,
                                                 self.moses_cfg.cost_model,
                                                 self.torch_device)
        return self._model

    def session(self):
        """The TuneSession refresh jobs run through (hub passes its own so
        refreshes share the serving stack's cost model and seed policy)."""
        if self._session is None:
            from repro_torch.autotune.session import TuneSession
            self._session = TuneSession(moses_cfg=self.moses_cfg,
                                        seed=self.seed,
                                        cost_model=self.model_name,
                                        torch_device=self.torch_device)
        return self._session

    def serving_params(self, device: str) -> Optional[Params]:
        """The newest non-retired version for `device`, or None."""
        return self.store.load_model_params(device,
                                            model_name=self.model_name,
                                            torch_device=self.torch_device)

    # --- decision log -----------------------------------------------------
    # Every refresh attempt and drift decision lands in
    # <store.root>/refresh_log.jsonl WITH the calibration evidence it was
    # judged on (drift-report values, held-out rank accuracies), so a
    # report (the reference's `launch.obs --report`) can answer "why did the
    # serving model change" (or refuse to) long after the in-memory history
    # is gone.
    def _decision_path(self) -> str:
        return os.path.join(self.store.root, "refresh_log.jsonl")

    def _log_decision(self, kind: str, device: str,
                      payload: Dict[str, Any]) -> None:
        rec = {"t": round(time.time(), 3), "kind": kind, "device": device}
        rec.update(payload)
        path = self._decision_path()
        try:
            os.makedirs(os.path.dirname(path), exist_ok=True)
            with open(path, "a") as f:
                f.write(json.dumps(rec, sort_keys=True) + "\n")
        except OSError:
            pass                    # evidence must never fail the decision

    def decision_log(self, device: Optional[str] = None
                     ) -> List[Dict[str, Any]]:
        """The persisted decision records, oldest first (all devices, or
        one). Tolerates a torn trailing line like every JSONL reader here."""
        path = self._decision_path()
        if not os.path.exists(path):
            return []
        with open(path) as f:
            lines = f.read().splitlines()
        out: List[Dict[str, Any]] = []
        for i, line in enumerate(lines):
            if not line.strip():
                continue
            try:
                rec = json.loads(line)
            except json.JSONDecodeError:
                if i == len(lines) - 1:
                    continue
                raise
            if device is None or rec.get("device") == device:
                out.append(rec)
        return out

    # --- drift + state ----------------------------------------------------
    def check(self, device: str, current_fingerprint=None,
              rows_by_task=None) -> List[DriftReport]:
        """Run both drift detectors against the serving version."""
        return detect_drift(
            self.store, device, model=self.model(),
            params=self.serving_params(device),
            fingerprint_threshold=self.cfg.fingerprint_threshold,
            calibration_threshold=self.cfg.calibration_threshold,
            window=self.cfg.window,
            current_fingerprint=current_fingerprint,
            rows_by_task=rows_by_task)

    def decide(self, device: str,
               reports: Optional[List[DriftReport]] = None) -> str:
        """refresh / keep / retire, from the drift reports."""
        reports = reports if reports is not None else self.check(device)
        for r in reports:
            if (r.kind == FINGERPRINT and r.drifted
                    and r.value >= self.cfg.retire_threshold):
                return "retire"
        return "refresh" if any(r.drifted for r in reports) else "keep"

    def drift_summary(self, device: str) -> Dict[str, Any]:
        """One row of lifecycle state for dashboards (`launch.hub --stats`):
        fingerprint shift, serving-model rank accuracy on the newest
        records, lineage version, and the state-machine status. Scoped to
        this manager's model family — versions another family saved are
        not "our" serving model."""
        entries = [e for e in self.store.model_lineage(device)
                   if e.get("model") in (None, self.model_name)]
        version = self.store.latest_model_version(
            device, model_name=self.model_name)
        reports = self.check(device)
        by_kind = {r.kind: r for r in reports}
        with self._lock:
            refreshing = device in self._refreshing
        if refreshing:
            status = "refreshing"
        elif not entries:
            status = "absent"
        elif version is None:
            status = "retired"
        elif any(r.drifted for r in reports):
            status = "stale"
        else:
            status = "fresh"
        shift = by_kind[FINGERPRINT].value
        rank = (by_kind[CALIBRATION].value
                if CALIBRATION in by_kind else float("nan"))
        from repro_torch.obs import metrics as obs_metrics
        reg = obs_metrics.current()
        if shift == shift:  # skip NaN — a gauge of NaN hides history
            reg.gauge("continual.fingerprint_shift", device=device).set(shift)
        if rank == rank:
            reg.gauge("continual.rank_accuracy", device=device).set(rank)
        return {"device": device, "status": status, "version": version,
                "fingerprint_shift": shift,
                "rank_accuracy": rank,
                "reports": reports}

    def status(self, device: str) -> str:
        return self.drift_summary(device)["status"]

    def retire(self, device: str) -> bool:
        """Abandon the device's serving lineage (drift beyond repair).

        Retires EVERY non-retired version of this family — retire-grade
        drift invalidates the whole chain, not just its newest link, so
        serving must fall through to the neighbors (a fresh source
        selection), never to an even older version."""
        any_retired = False
        while True:
            version = self.store.latest_model_version(
                device, model_name=self.model_name)
            if version is None or not self.store.retire_model(device,
                                                              version):
                return any_retired
            any_retired = True

    # --- the refresh ------------------------------------------------------
    def refresh(self, device: str, trigger: str = "manual",
                force: bool = False, rows_by_task=None) -> RefreshResult:
        """One replay-based continual update of the device's serving model.

        Builds the fresh slice (newest `window` rows per task shard, parity
        split into train/held-out halves), mixes it with the class-balanced
        replay sample, trains under the mask-anchored L2 from the serving
        version, and saves a new lineage version iff the held-out
        rank-accuracy guard passes. With no serving version yet, trains an
        initial version from the mix (trigger "initial"). `force` bypasses
        the min-fresh floor, not the guard — nothing bypasses the guard.
        """
        with self._lock:
            if device in self._refreshing:
                return RefreshResult(device, False, "already refreshing",
                                     trigger=trigger)
            self._refreshing.add(device)
        try:
            with obs_trace.span("lifecycle.refresh", device=device,
                                trigger=trigger):
                result = self._refresh_locked(device, trigger, force,
                                              rows_by_task)
        finally:
            with self._lock:
                self._refreshing.discard(device)
        obs_metrics.current().counter(
            "continual.refresh",
            accepted=str(result.accepted).lower()).inc()
        with self._lock:
            self.history.append(result)
        self._log_decision("refresh", device, result.to_dict())
        return result

    def _refresh_locked(self, device: str, trigger: str, force: bool,
                        rows_by_task=None) -> RefreshResult:
        cfg = self.cfg
        model = self.model()
        current = self.serving_params(device)
        parent = self.store.latest_model_version(
            device, model_name=self.model_name)
        rows = (rows_by_task if rows_by_task is not None
                else device_rows(self.store, device))
        records_seen = sum(len(v) for v in rows.values())
        head, tail = split_tail(rows, cfg.window)
        # deterministic parity split: even tail rows train, odd are the
        # held-out guard slice (both halves span every task)
        fresh = build_records({k: v[0::2] for k, v in tail.items()})
        holdout = build_records({k: v[1::2] for k, v in tail.items()})
        if len(fresh) == 0:
            return RefreshResult(device, False, "no records in store",
                                 trigger=trigger, parent=parent,
                                 records_seen=records_seen)
        if len(fresh) < cfg.min_fresh and not force:
            return RefreshResult(device, False,
                                 f"only {len(fresh)} fresh rows "
                                 f"(min_fresh={cfg.min_fresh})",
                                 trigger=trigger, parent=parent,
                                 n_fresh=len(fresh),
                                 records_seen=records_seen)
        replay_cfg = dataclasses.replace(cfg.replay, seed=self.seed)
        # `head` is exactly the corpus minus the fresh window: hand it to
        # the buffer so sampling does not re-walk the whole store
        buf = ReplayBuffer(self.store, device, replay_cfg,
                           rows_by_task=head)
        mix = buf.mix(fresh)

        session = self.session()
        mask = None
        if current is None:
            init = model.init(self.seed)
            new_params, losses = session.refresh_params(
                device, init, mix, epochs=cfg.refresh_epochs,
                lr=cfg.refresh_lr, salt="initial")
            trigger = trigger if parent is not None else "initial"
        else:
            weights = anchor_weights(
                model, current, mix,
                ratio=self.moses_cfg.transferable_ratio,
                strength=cfg.anchor_strength, seed=self.seed,
                torch_device=self.torch_device)
            mask = {k: (w > 0).to(w.dtype) for k, w in weights.items()}
            new_params, losses = session.refresh_params(
                device, current, mix, anchor=current, weights=weights,
                epochs=cfg.refresh_epochs, lr=cfg.refresh_lr,
                salt=f"v{parent}")

        acc_old = acc_new = float("nan")
        if len(holdout) >= 2:
            acc_new = rank_accuracy(new_params, holdout,
                                    predict_fn=model.batched_predict)
            if current is not None:
                acc_old = rank_accuracy(current, holdout,
                                        predict_fn=model.batched_predict)
        # the no-regression guard: never ship a version that ranks the
        # newest records worse than what is already serving
        if (current is not None and not math.isnan(acc_new)
                and not math.isnan(acc_old)
                and acc_new < acc_old - cfg.guard_eps):
            return RefreshResult(
                device, False,
                f"held-out rank accuracy regressed "
                f"{acc_old:.3f} -> {acc_new:.3f}", trigger=trigger,
                parent=parent, holdout_accuracy_old=acc_old,
                holdout_accuracy_new=acc_new, n_fresh=len(fresh),
                n_mix=len(mix), records_seen=records_seen, losses=losses)

        dist = (param_distance(new_params, current)
                if current is not None else float("nan"))
        ticket = (param_distance(new_params, current, mask=mask)
                  if mask is not None else float("nan"))
        frac = (float(lottery.mask_fraction(mask)) if mask is not None
                else float("nan"))
        self.store.save_model_params(
            device, new_params, self.model_name,
            lineage={"trigger": trigger, "records_seen": records_seen,
                     "rank_accuracy": None if math.isnan(acc_new)
                     else round(acc_new, 4),
                     "parent_rank_accuracy": None if math.isnan(acc_old)
                     else round(acc_old, 4),
                     "param_distance": None if math.isnan(dist)
                     else round(dist, 6)})
        return RefreshResult(
            device, True, "saved", trigger=trigger,
            version=self.store.latest_model_version(device), parent=parent,
            holdout_accuracy_old=acc_old, holdout_accuracy_new=acc_new,
            param_distance=dist, n_fresh=len(fresh), n_mix=len(mix),
            records_seen=records_seen, losses=losses,
            ticket_fraction=frac, ticket_distance=ticket)

    def maybe_refresh(self, device: str,
                      current_fingerprint=None) -> Optional[RefreshResult]:
        """Check drift and act on the decision: refresh on drift, retire on
        retire-grade fingerprint shift, None on keep.

        `current_fingerprint` lets callers reuse a probe vector they
        already measured this session (the hub's miss path probes new
        devices anyway); otherwise the suite runs once here. After an
        accepted refresh — or a retire — the persisted baseline is
        RE-ANCHORED to the current vector: the drift has been acted on, so
        the same shift must not re-trigger on every subsequent job.
        """
        if current_fingerprint is None:
            from repro_torch.hub.fingerprint import device_fingerprint
            current_fingerprint = device_fingerprint(device)
        rows = device_rows(self.store, device)   # one walk for check+refresh
        reports = self.check(device, current_fingerprint=current_fingerprint,
                             rows_by_task=rows)
        decision = self.decide(device, reports)
        obs_metrics.current().counter(
            "continual.drift_decisions", decision=decision).inc()
        # the evidence the decision was made on, drift-report by detector
        evidence = [{"kind": r.kind, "value": None if r.value != r.value
                     else round(float(r.value), 6),
                     "threshold": r.threshold, "drifted": r.drifted,
                     "detail": r.detail} for r in reports]
        self._log_decision("drift_decision", device,
                           {"decision": decision, "evidence": evidence})
        if decision == "keep":
            return None
        if decision == "retire":
            self.retire(device)
            self.store.put_fingerprint(device, current_fingerprint)
            result = RefreshResult(device, False, "retired",
                                   trigger="drift:fingerprint")
            with self._lock:
                self.history.append(result)
            self._log_decision("refresh", device, result.to_dict())
            return result
        drifted = ",".join(r.kind for r in reports if r.drifted)
        result = self.refresh(device, trigger=f"drift:{drifted}",
                              rows_by_task=rows)
        if result.accepted:
            self.store.put_fingerprint(device, current_fingerprint)
        return result
