"""Transfer provenance: why did this device get this config? (Port of
`repro.hub.provenance`.)

Moses' central claim is that the *right* cost-model features transfer
across devices. The hub acts on that claim on every miss — it picks
source devices by fingerprint similarity, mixes their corpora, warm-starts
from a neighbor's params — but until now none of those decisions survived
the tuning job that consumed them. `TransferProvenance` is the flight
record of one tuned winner:

  * which source devices contributed, with the fingerprint similarity
    that ranked them and the softmax mixing weight they received
    (`hub/transfer.py`);
  * which params version the job warm-started from and that version's
    lineage chain (`hub/store.py`);
  * the lottery-mask overlap between the source ticket and the final
    adapted params (`core/lottery.py`) — the paper's transferable-feature
    claim made directly observable: a high overlap means the parameters
    the source marked as hardware-invariant stayed the load-bearing ones
    after adaptation;
  * the measurement budget the winner cost (measurements, simulated
    seconds, poisoned configs) and the cost model's live calibration
    while it chose (`obs/calibration.py`).

Records persist next to the store's shards (`RecordStore.put_provenance`)
behind the schema bump to v2 and are read back by `TuningHub.explain`, the
serving writer's RPC `explain` op and `launch.obs --explain` (which falls
back to the shards on disk). This module itself stays import-light
(no torch at module scope): `ticket_overlap` pulls torch lazily, so the
serving/CLI read path can deserialize records without the tuning stack.
"""
from __future__ import annotations

import dataclasses
import time
from typing import Any, Dict, List, Optional

PROVENANCE_VERSION = 1

Params = Any    # a flat {name: tensor} mapping (repro_torch.core.cost_model)


@dataclasses.dataclass
class TransferProvenance:
    """Everything the hub knew when it crowned one (device, task) winner."""
    device: str
    task: str                               # workload key
    knobs: Dict[str, int]                   # the winning config
    throughput_gflops: float
    strategy: str
    # [{"device", "similarity", "weight"}], mixing order (best first)
    sources: List[Dict[str, Any]]
    params_device: Optional[str]            # whose params warm-started us
    params_version: Optional[int]
    lineage: List[Dict[str, Any]]           # that device's version chain
    mask_overlap: Optional[float]           # source ticket vs final params
    measurements: int
    search_seconds: float
    poisoned: int
    trials_per_task: Optional[int]
    calibration: Optional[Dict[str, Any]]   # CalibrationTracker.per_task()
    created_at: float = 0.0
    version: int = PROVENANCE_VERSION

    def to_dict(self) -> Dict[str, Any]:
        d = dataclasses.asdict(self)
        if not d.get("created_at"):
            d["created_at"] = round(time.time(), 3)
        return d

    @classmethod
    def from_dict(cls, d: Dict[str, Any]) -> "TransferProvenance":
        """Tolerant decode: unknown keys (a future provenance version) are
        dropped, missing optional fields default."""
        fields = {f.name for f in dataclasses.fields(cls)}
        kw = {k: v for k, v in d.items() if k in fields}
        for name, default in (("sources", []), ("lineage", []),
                              ("knobs", {})):
            kw.setdefault(name, default)
        for name in ("params_device", "params_version", "mask_overlap",
                     "trials_per_task", "calibration"):
            kw.setdefault(name, None)
        kw.setdefault("measurements", 0)
        kw.setdefault("search_seconds", 0.0)
        kw.setdefault("poisoned", 0)
        kw.setdefault("strategy", "")
        kw.setdefault("throughput_gflops", 0.0)
        return cls(**kw)


def source_attribution(sel) -> List[Dict[str, Any]]:
    """Flatten a `SourceSelection` into the provenance `sources` list:
    the chosen devices with BOTH the similarity that ranked them and the
    softmax mixing weight they got."""
    sims = {d: s for d, s in sel.ranked}
    out = []
    for dev, weight in sel.sources:
        sim = sims.get(dev)
        out.append({"device": dev,
                    "similarity": None if sim is None else round(float(sim),
                                                                 6),
                    "weight": round(float(weight), 6)})
    return out


def ticket_overlap(source_params: Optional[Params],
                   final_params: Optional[Params],
                   ratio: float = 0.5) -> Optional[float]:
    """Lottery-mask overlap between the source ticket and the final params.

    The realized adaptation step stands in for the gradient in Eq. 5:
    xi = |w * (final - source)| ranks each parameter by how much signal it
    carried through adaptation. Masking the top-`ratio` fraction on the
    source side (the "ticket" the paper claims transfers) and again on the
    final side, the overlap is |mask_src AND mask_final| / |mask_src| —
    1.0 means the source's transferable set stayed exactly the
    load-bearing set after adaptation. None when either is missing or the
    two are not comparable (other keys or shapes: a different model
    family), as in the reference; computed on the source params' device.
    """
    if source_params is None or final_params is None:
        return None
    if set(source_params) != set(final_params) or any(
            tuple(w.shape) != tuple(final_params[k].shape)
            for k, w in source_params.items()):
        return None
    dev = next(iter(source_params.values())).device
    final = {k: final_params[k].to(dev) for k in source_params}
    from repro_torch.core.lottery import mask_by_ratio, xi_scores

    delta = {k: final[k] - w for k, w in source_params.items()}
    m_src = mask_by_ratio(xi_scores(source_params, delta), ratio)
    m_fin = mask_by_ratio(xi_scores(final, delta), ratio)
    inter = sum(float((m_src[k] * m_fin[k]).sum()) for k in sorted(m_src))
    src_on = sum(float(m_src[k].sum()) for k in sorted(m_src))
    return round(inter / max(src_on, 1.0), 6)


def build_provenance(task_result, device: str, strategy: str, sel=None,
                     params_version: Optional[int] = None,
                     lineage: Optional[List[Dict[str, Any]]] = None,
                     mask_overlap: Optional[float] = None,
                     trials_per_task: Optional[int] = None,
                     calibration: Optional[Dict[str, Any]] = None,
                     ) -> TransferProvenance:
    """Assemble the record for one `TaskResult` (the hub's attachment
    point; see `TuningHub._tune_batch_inner`)."""
    return TransferProvenance(
        device=device,
        task=task_result.workload.key(),
        knobs={k: int(v) for k, v in dict(
            task_result.best_config.knobs).items()},
        throughput_gflops=round(float(task_result.best_throughput), 6),
        strategy=strategy,
        sources=source_attribution(sel) if sel is not None else [],
        params_device=getattr(sel, "params_device", None),
        params_version=params_version,
        lineage=list(lineage or []),
        mask_overlap=mask_overlap,
        measurements=int(task_result.measurements),
        search_seconds=round(float(task_result.search_seconds), 6),
        poisoned=len(task_result.poisoned or []),
        trials_per_task=trials_per_task,
        calibration=calibration,
        created_at=round(time.time(), 3))
