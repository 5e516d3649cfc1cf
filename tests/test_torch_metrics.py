"""The paper's §4.3 metrics (`core.metrics`) in both packages: the gains,
CMAT and `summarize` agree exactly on the same inputs. The results are
TuneResult-shaped (`total_search_seconds`, `model_latency`,
`total_measurements`), named as in tests/test_system.py's CMAT case:
tenset-pretrain, tenset-finetune and moses on tpu_edge, against
tenset-finetune."""
import types

import numpy as np
import pytest

from repro.core import metrics as j_metrics
from repro_torch.core import metrics as t_metrics

STRATEGIES = ("tenset-pretrain", "tenset-finetune", "moses")


def _results(seed: int):
    rng = np.random.RandomState(seed)
    return {s: types.SimpleNamespace(
        strategy=s, device="tpu_edge",
        total_search_seconds=float(rng.uniform(10.0, 400.0)),
        model_latency=float(rng.uniform(1e-4, 5e-2)),
        total_measurements=int(rng.randint(50, 200)))
        for s in STRATEGIES}


@pytest.mark.parametrize("seed", range(4))
def test_summarize_matches_reference(seed):
    results = _results(seed)
    want = j_metrics.summarize(results, "tenset-finetune")
    got = t_metrics.summarize(results, "tenset-finetune")
    assert got == want
    ref = got["tenset-finetune"]
    assert ref["latency_gain_vs_ref"] == ref["search_gain_vs_ref"] == 1.0
    assert ref["cmat_vs_ref"] == 0.0


@pytest.mark.parametrize("fn", ["latency_gain", "search_efficiency_gain",
                                "cmat"])
def test_scalar_metrics_match_reference(fn):
    vals = [0.0, 1e-13, 1e-12, 0.5, 1.0, 3.25, 1e6]
    for a in vals:
        for b in vals:
            assert getattr(t_metrics, fn)(a, b) == \
                getattr(j_metrics, fn)(a, b), (fn, a, b)


def test_cmat_definition():
    # (search gain x latency reduction - 1) x 100%: 2x faster search at
    # equal latency is +100%
    assert t_metrics.cmat(2.0, 1.0) == 100.0
    assert t_metrics.cmat(1.0, 1.0) == 0.0
    assert t_metrics.latency_gain(2.0, 0.0) == 2.0 / 1e-12
