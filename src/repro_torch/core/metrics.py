"""Evaluation metrics (paper §4.3; port of `repro.core.metrics`).

  latency gain        = latency_baseline / latency_strategy       (Fig. 4)
  search-eff gain     = search_time_baseline / search_time_strategy (Fig. 5)
  CMAT                = (gain_search_eff * reduction_latency - 1) * 100%
                        (Table 1; both factors relative to Tenset-Finetune)
"""
from __future__ import annotations

from typing import Dict


def latency_gain(base_latency: float, new_latency: float) -> float:
    return base_latency / max(new_latency, 1e-12)


def search_efficiency_gain(base_seconds: float, new_seconds: float) -> float:
    return base_seconds / max(new_seconds, 1e-12)


def cmat(search_gain: float, latency_reduction: float) -> float:
    """Cost Model & Auto-tuning efficiency gain score, in percent."""
    return (search_gain * latency_reduction - 1.0) * 100.0


def summarize(results: Dict[str, "TuneResult"], reference: str
              ) -> Dict[str, Dict[str, float]]:
    """Per-strategy gains vs a reference strategy (e.g. tenset-finetune)."""
    ref = results[reference]
    out = {}
    for name, r in results.items():
        sg = search_efficiency_gain(ref.total_search_seconds,
                                    r.total_search_seconds)
        lg = latency_gain(ref.model_latency, r.model_latency)
        out[name] = {
            "model_latency_ms": r.model_latency * 1e3,
            "search_seconds": r.total_search_seconds,
            "measurements": r.total_measurements,
            "latency_gain_vs_ref": lg,
            "search_gain_vs_ref": sg,
            "cmat_vs_ref": cmat(sg, lg),
        }
    return out
