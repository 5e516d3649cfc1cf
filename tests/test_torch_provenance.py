"""The port's transfer provenance (`repro_torch.hub.provenance`) against the
reference, on the CPU.

  * `TransferProvenance` records cross between the packages: a dict one
    writes, the other decodes to equal fields (exact: plain JSON).
  * `ticket_overlap` is exact: the realized step, |w·delta| and the ratio
    masks are the same float32 arithmetic in both packages, and the mask
    counts are integers. Incomparable params give None in both; missing
    ones too.
  * The store's provenance files read alike in both directions, and every
    winner a port hub tunes under `moses` is explainable.
"""
import dataclasses
import json
import os
import types

import jax
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.hub import provenance as jprov  # noqa: E402
from repro.hub.store import RecordStore as JStore  # noqa: E402
from repro_torch.autotune.space import Workload, default_config  # noqa: E402
from repro_torch.configs.moses import CostModelConfig as TCfg  # noqa: E402
from repro_torch.configs.moses import DEFAULT as MCFG  # noqa: E402
from repro_torch.hub import (TransferProvenance, TuningHub,  # noqa: E402
                             bootstrap_store, build_provenance,
                             ticket_overlap)
from repro_torch.hub.provenance import source_attribution  # noqa: E402
from repro_torch.hub.store import SCHEMA_VERSION, RecordStore  # noqa: E402

WL_A = Workload("matmul", (256, 256, 128), name="a")
WL_B = Workload("matmul", (512, 256, 128), name="b")


@pytest.fixture(autouse=True)
def one_torch_thread():
    """One torch thread per test: the suite runs several workers on the
    machine's cores (see tests/test_torch_train.py)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _fields(task="matmul:256x256x128", gflops=100.0):
    return dict(
        device="tpu_v5e_pro", task=task, knobs={"block_m": 64},
        throughput_gflops=gflops, strategy="moses",
        sources=[{"device": "tpu_v5e", "similarity": 0.99, "weight": 0.9}],
        params_device="tpu_v5e", params_version=1,
        lineage=[{"version": 1, "trigger": "pretrain"}],
        mask_overlap=0.875, measurements=16, search_seconds=4.4,
        poisoned=0, trials_per_task=16,
        calibration={"rounds": 2, "rank_accuracy": 0.8})


def test_records_cross_between_packages():
    mine = TransferProvenance(**_fields())
    theirs = jprov.TransferProvenance(**_fields())
    d = json.loads(json.dumps(mine.to_dict()))
    assert dataclasses.asdict(jprov.TransferProvenance.from_dict(d)) == d
    d2 = json.loads(json.dumps(theirs.to_dict()))
    assert dataclasses.asdict(TransferProvenance.from_dict(d2)) == d2
    future = {"device": "d", "task": "t", "from_the_future": 1}
    assert dataclasses.asdict(TransferProvenance.from_dict(future)) == \
        dataclasses.asdict(jprov.TransferProvenance.from_dict(future))


def test_source_attribution_and_build_match():
    sel = types.SimpleNamespace(
        ranked=[("a", 0.9123456789), ("b", 0.5), ("c", 0.1)],
        sources=[("a", 0.75), ("b", 0.25)], params_device="a")
    assert source_attribution(sel) == jprov.source_attribution(sel)
    cfg = default_config(WL_A)
    tr = types.SimpleNamespace(
        workload=WL_A, best_config=cfg, best_throughput=123.4567891,
        measurements=8, search_seconds=2.2222222, poisoned=["x", "y"])
    kw = dict(sel=sel, params_version=3, mask_overlap=0.5,
              trials_per_task=16, calibration={"rounds": 1})
    mine = build_provenance(tr, "dev", "moses", **kw).to_dict()
    theirs = jprov.build_provenance(tr, "dev", "moses", **kw).to_dict()
    mine.pop("created_at")
    theirs.pop("created_at")
    assert mine == theirs
    assert mine["poisoned"] == 2 and mine["params_device"] == "a"


def _params(seed, shapes=(("w0", (16, 8)), ("b0", (8,)), ("w1", (8, 1)),
                          ("b1", (1,)))):
    rng = np.random.RandomState(seed)
    return {k: rng.randn(*s).astype(np.float32) for k, s in shapes}


@pytest.mark.parametrize("seed,ratio,scale", [
    (0, 0.5, 0.01), (1, 0.25, 0.1), (2, 0.75, 1.0), (3, 0.5, 0.0)])
def test_ticket_overlap_exact(seed, ratio, scale):
    src = _params(seed)
    rng = np.random.RandomState(100 + seed)
    fin = {k: v + scale * rng.randn(*v.shape).astype(np.float32)
           for k, v in src.items()}
    fin["b1"] = src["b1"].copy()          # an untouched leaf: xi ties at 0
    want = jprov.ticket_overlap({k: jax.numpy.asarray(v)
                                 for k, v in src.items()},
                                {k: jax.numpy.asarray(v)
                                 for k, v in fin.items()}, ratio)
    got = ticket_overlap({k: torch.tensor(v) for k, v in src.items()},
                         {k: torch.tensor(v) for k, v in fin.items()},
                         ratio)
    assert got is not None and got == want
    assert 0.0 <= got <= 1.0
    if scale == 0.0:
        assert got == 1.0        # no step: every xi ties, all kept


def test_ticket_overlap_none_when_missing_or_incomparable():
    p = {k: torch.tensor(v) for k, v in _params(0).items()}
    assert ticket_overlap(None, p) is None
    assert ticket_overlap(p, None) is None
    assert ticket_overlap(p, {"other": torch.ones(3)}) is None
    wider = {k: torch.tensor(v) for k, v in _params(
        0, (("w0", (16, 4)), ("b0", (4,)), ("w1", (4, 1)),
            ("b1", (1,)))).items()}
    assert ticket_overlap(p, wider) is None
    assert jprov.ticket_overlap(
        {k: jax.numpy.asarray(v.numpy()) for k, v in p.items()},
        {"other": jax.numpy.ones(3)}) is None


@pytest.mark.parametrize("writer", ["reference", "port"])
def test_store_provenance_reads_alike(writer, tmp_path):
    root = str(tmp_path / "s")
    store = RecordStore(root) if writer == "port" else JStore(root)
    for task, gflops in ((WL_A.key(), 100.0), (WL_A.key(), 200.0),
                         (WL_B.key(), 50.0)):
        store.put_provenance("tpu_v5e_pro",
                             TransferProvenance(**_fields(task, gflops))
                             .to_dict())
    with open(os.path.join(root, "provenance", "tpu_v5e_pro.jsonl"),
              "a") as f:
        f.write('{"task": "tr')                      # a killed writer
    mine, theirs = RecordStore(root), JStore(root)
    assert mine.get_provenance("tpu_v5e_pro") == \
        theirs.get_provenance("tpu_v5e_pro")
    assert mine.get_provenance("tpu_v5e_pro", WL_A.key())[
        "throughput_gflops"] == 200.0
    assert mine.get_provenance("tpu_v5e_pro", WL_A.key())["schema"] == \
        SCHEMA_VERSION
    assert mine.provenance_devices() == theirs.provenance_devices() == \
        ["tpu_v5e_pro"]
    assert mine.get_provenance("ghost") == {}


def test_every_winner_explainable(tmp_path):
    hub = TuningHub(str(tmp_path / "hub"), trials_per_task=8,
                    pretrain_epochs=2, torch_device="cpu",
                    moses_cfg=dataclasses.replace(
                        MCFG, cost_model=TCfg(hidden_dims=(32, 32)),
                        online_epochs=2, adaptation_epochs=2,
                        population_size=32, evolution_rounds=2,
                        top_k_measure=8))
    bootstrap_store(hub.store, ("tpu_v5e", "tpu_edge"), [WL_A, WL_B],
                    programs_per_task=8)
    target = "tpu_v5e_pro"
    assert not hub.get_config(target, WL_A).cache_hit
    assert hub.explain("ghost", WL_A.key()) is None
    for task_key in hub.registry.task_keys(target):
        exp = hub.explain(target, task_key)
        prov = exp["provenance"]
        assert prov["device"] == target and prov["task"] == task_key
        assert prov["sources"] and prov["strategy"] == "moses"
        assert prov["measurements"] > 0
        assert prov["calibration"]["rounds"] > 0
        assert prov["knobs"] == exp["registry"]["knobs"]
        # moses adapted the source params: the overlap is a real number
        assert 0.0 < prov["mask_overlap"] <= 1.0
        assert prov["params_device"] == "tpu_v5e"
        assert prov["params_version"] == 1
    # the reference decodes the port's record
    p = jprov.TransferProvenance.from_dict(
        JStore(hub.store.root).get_provenance(target, WL_A.key()))
    assert p.throughput_gflops > 0
