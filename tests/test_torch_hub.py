"""The port's transfer hub (`repro_torch.hub`) against the reference, on the
CPU, with the same numpy inputs.

  * The store's on-disk format is shared: shards, byte-offset sidecars,
    fingerprints, `.npz` params and their lineage written by one package
    read back identically in the other, in both directions (exact: both
    packages parse the same JSON and the same arrays). A schema-v1 shard
    reads alike.
  * Fingerprints are numpy on the simulated devices: bit for bit.
    `rank_by_similarity` and `select_sources` give the same ranking and
    pool exactly, and the mixing weights to 1e-12.
  * `TuningHub` under `tenset-pretrain`, with params both packages load
    from one `.npz`, picks the same sources, weights, winners and
    measurement counts as the reference's, and writes the same provenance
    (the calibration evidence is held to its counts: its residuals are
    float noise apart).
  * `launch.hub --smoke --refresh` (and `--stats` beside a live farm) and
    `launch.train --source auto` (dry run), on the CPU.
  * The compact-under-reader race: the port's store under readers racing
    five duplicate-and-compact cycles.
"""
import dataclasses
import json
import os
import shutil
import sys
import threading

import jax
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.autotune.space import Workload as JWorkload  # noqa: E402
from repro.autotune.space import default_config as j_default  # noqa: E402
from repro.configs.moses import CostModelConfig as JCfg  # noqa: E402
from repro.configs.moses import DEFAULT as J_MCFG  # noqa: E402
from repro.core.cost_model import MLPCostModel as JMLP  # noqa: E402
from repro.hub import TuningHub as JHub  # noqa: E402
from repro.hub import bootstrap_store as j_bootstrap  # noqa: E402
from repro.hub import fingerprint as jfp  # noqa: E402
from repro.hub import select_sources as j_select  # noqa: E402
from repro.hub.serving import index as j_index  # noqa: E402
from repro.hub.store import RecordStore as JStore  # noqa: E402
from repro_torch.autotune import registry as t_registry  # noqa: E402
from repro_torch.autotune.devices import DEVICES  # noqa: E402
from repro_torch.autotune.space import ProgramConfig, Workload  # noqa: E402
from repro_torch.autotune.space import default_config  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.configs.moses import CostModelConfig as TCfg  # noqa: E402
from repro_torch.configs.moses import DEFAULT as MCFG  # noqa: E402
from repro_torch.hub import (TuningHub, bootstrap_store,  # noqa: E402
                             select_sources)
from repro_torch.hub import fingerprint as tfp  # noqa: E402
from repro_torch.hub.serving import index as t_index  # noqa: E402
from repro_torch.hub.store import RecordStore  # noqa: E402
from repro_torch.launch import hub as launch_hub  # noqa: E402
from repro_torch.launch import train  # noqa: E402

WL_A = Workload("matmul", (256, 256, 128), name="a")
WL_B = Workload("matmul", (512, 256, 128), name="b")
J_WL_A = JWorkload("matmul", (256, 256, 128), name="a")
J_WL_B = JWorkload("matmul", (512, 256, 128), name="b")
CFG_A2 = dict(block_m=64, block_n=128, block_k=128, k_inner=0, unroll=1,
              out_bf16=1)
CM = dict(hidden_dims=(32, 32), batch_size=64, rank_pairs_per_batch=256)
HUB_MOSES = dict(online_epochs=2, adaptation_epochs=2, population_size=32,
                 evolution_rounds=2, top_k_measure=8)


@pytest.fixture(autouse=True)
def one_torch_thread():
    """One torch thread per test: the suite runs several workers on the
    machine's cores (see tests/test_torch_train.py)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture
def registry_file(tmp_path, monkeypatch):
    """The port's default registry, pointed at a temporary file."""
    path = str(tmp_path / "tuned_configs_torch.json")
    monkeypatch.setattr(t_registry, "_DEFAULT_PATH", path)
    return path


# --- the store round trip ------------------------------------------------


def _jax_params(seed):
    return JMLP(JCfg(**CM)).init(jax.random.PRNGKey(seed))


def _params_as(pkg, tree):
    """Numpy arrays as the package's own param type."""
    if pkg == "port":
        return {k: torch.tensor(np.asarray(v)) for k, v in tree.items()}
    return {k: jax.numpy.asarray(v) for k, v in tree.items()}


def _fill(pkg, root):
    """Write a small store with one package: good and error records over
    two devices and two tasks, fingerprints, two params versions with
    lineage metadata (one retired), and a provenance record."""
    if pkg == "port":
        store = RecordStore(root)
        wa, wb, cfg_a = WL_A, WL_B, default_config(WL_A)
        cfg_b = ProgramConfig.make(**CFG_A2)
    else:
        from repro.autotune.space import ProgramConfig as JPC
        store = JStore(root)
        wa, wb, cfg_a = J_WL_A, J_WL_B, j_default(J_WL_A)
        cfg_b = JPC.make(**CFG_A2)
    for dev, scale in (("tpu_v5e", 1.0), ("tpu_edge", 0.25)):
        store.put(dev, wa, cfg_a, 100.0 * scale)
        store.put(dev, wa, cfg_b, 150.0 * scale, trial=1)
        store.put(dev, wb, cfg_a, 75.0 * scale)
        store.put(dev, wb, cfg_b, None, trial=2, error="timeout")
    assert store.flush() == 8
    fp = tfp if pkg == "port" else jfp
    store.put_fingerprint("tpu_v5e", fp.device_fingerprint("tpu_v5e"))
    store.put_fingerprint("tpu_edge", fp.device_fingerprint("tpu_edge"))
    for seed, trigger in ((0, "pretrain"), (1, "refresh")):
        store.save_model_params(
            "tpu_v5e", _params_as(pkg, _jax_params(seed)), "mlp",
            lineage={"trigger": trigger, "records_seen": 3 + seed})
    store.save_model_params("tpu_v5e", _params_as(pkg, _jax_params(2)),
                            "mlp", lineage={"trigger": "late"})
    store.retire_model("tpu_v5e")
    store.put_provenance("tpu_v5e", {"task": wa.key(), "knobs": {"x": 1},
                                     "created_at": 1.0})
    return store


def _view(store, params_of):
    """Everything a reader can ask the store, as plain Python."""
    out = {}
    for dev in store.devices():
        recs = store.records(dev)
        out[dev] = {
            "rows": list(store.iter_device(dev, include_errors=True)),
            "records": [a.tolist() for a in (recs.x, recs.y, recs.g,
                                             recs.raw_throughput)],
            "count": (store.count(dev), store.count(dev, True)),
            "task_keys": store.task_keys(dev),
            "best": {k: store.best_record(dev, k)
                     for k in store.task_keys(dev)},
            "tail": {k: store.tail_rows(dev, k, 1)
                     for k in store.task_keys(dev)},
            "errors": store.error_records(dev),
            "lineage": store.model_lineage(dev),
            "serving": store.latest_model_version(dev, "mlp"),
            "params": {v: params_of(store, dev, v) for v in (None, 1, 2, 3)},
            "provenance": store.get_provenance(dev),
        }
    out["fingerprints"] = {d: v.tolist()
                           for d, v in store.fingerprints().items()}
    return out


def _t_params(store, dev, version):
    p = store.load_model_params(dev, "mlp", version, torch_device="cpu")
    return None if p is None else {k: v.numpy().tolist()
                                   for k, v in p.items()}


def _j_params(store, dev, version):
    p = store.load_model_params(dev, "mlp", version)
    return None if p is None else {k: np.asarray(v).tolist()
                                   for k, v in p.items()}


@pytest.mark.parametrize("writer", ["reference", "port"])
def test_store_round_trip_across_packages(writer, tmp_path):
    root = str(tmp_path / "s")
    _fill(writer, root)
    mine = _view(RecordStore(root), _t_params)
    ref = _view(JStore(root), _j_params)
    assert mine == ref
    v5e = mine["tpu_v5e"]
    assert v5e["count"] == (3, 4) and v5e["serving"] == 2
    assert [e["status"] for e in v5e["lineage"]] == ["active", "active",
                                                     "retired"]
    assert v5e["params"][None] == v5e["params"][2] != v5e["params"][1]
    # the writer's sidecars are fresh for the other package's reader
    for dev in ("tpu_v5e", "tpu_edge"):
        for wl in (WL_A, WL_B):
            shard = RecordStore(root)._shard_path(dev, wl.key())
            st = os.stat(shard)
            stamp = (st.st_mtime_ns, st.st_size)
            assert t_index.load_index(shard, stamp) is not None
            assert j_index.load_index(shard, stamp) is not None


def test_sidecar_written_by_one_package_serves_the_other(tmp_path):
    """An index the port rebuilds (stale sidecar) is what the reference
    would have written, byte for byte."""
    root = str(tmp_path / "s")
    _fill("reference", root)
    shard = RecordStore(root)._shard_path("tpu_v5e", WL_A.key())
    sidecar = t_index.index_path(shard)
    want = open(sidecar).read()
    os.remove(sidecar)
    assert RecordStore(root).best_record(
        "tpu_v5e", WL_A.key())["throughput_gflops"] == 150.0
    assert open(sidecar).read() == want


def _v1_store(tmp_path):
    root = tmp_path / "v1"
    shard_dir = root / "records" / "tpu_v5e"
    shard_dir.mkdir(parents=True)
    rows = [{"schema": 1, "device": "tpu_v5e",
             "task": {"kind": WL_A.kind, "dims": list(WL_A.dims),
                      "name": WL_A.name, "count": WL_A.count,
                      "dtype_bytes": WL_A.dtype_bytes},
             "knobs": dict(default_config(WL_A).knobs),
             "throughput_gflops": thr, "trial": trial}
            for trial, thr in enumerate([100.0, 80.0, 120.0])]
    rows += rows[:2]
    (shard_dir / "matmul_256x256x128.jsonl").write_text(
        "".join(json.dumps(r) + "\n" for r in rows))
    (root / "fingerprints.json").write_text(json.dumps(
        {"schema": 1, "probe_version": tfp.PROBE_VERSION,
         "devices": {"tpu_v5e": [0.1] * 16}}))
    return str(root)


def test_schema_v1_store_reads_and_compacts_alike(tmp_path):
    root = _v1_store(tmp_path)
    mine = _view(RecordStore(root), _t_params)
    assert mine == _view(JStore(root), _j_params)
    assert mine["tpu_v5e"]["count"] == (5, 5)
    assert mine["tpu_v5e"]["provenance"] == {}
    assert RecordStore(root).compact() == 2
    assert _view(RecordStore(root), _t_params) == _view(JStore(root),
                                                        _j_params)
    assert JStore(root).count("tpu_v5e") == 3


# --- fingerprints and source selection -----------------------------------


@pytest.mark.parametrize("device", sorted(DEVICES))
def test_fingerprint_bit_for_bit(device):
    got = tfp.device_fingerprint(device)
    want = jfp.device_fingerprint(device)
    assert got.dtype == want.dtype == np.float32
    np.testing.assert_array_equal(got, want)


def test_probe_suite_and_ranking_match():
    assert [(w.key(), c.knobs) for w, c in tfp.probe_suite()] == \
        [(w.key(), c.knobs) for w, c in jfp.probe_suite()]
    known = {d: jfp.device_fingerprint(d) for d in sorted(DEVICES)
             if d != "tpu_v5e_pro"}
    target = jfp.device_fingerprint("tpu_v5e_pro")
    assert tfp.rank_by_similarity(target, known) == \
        jfp.rank_by_similarity(target, known)
    assert tfp.rank_by_similarity(target, known)[0][0] == "tpu_v5e"


def _boot_both(tmp_path, devices=("tpu_v5e", "tpu_edge", "tpu_lite"), n=8):
    jroot, troot = str(tmp_path / "j"), str(tmp_path / "t")
    nj = j_bootstrap(JStore(jroot), devices, [J_WL_A, J_WL_B],
                     programs_per_task=n)
    nt = bootstrap_store(RecordStore(troot), devices, [WL_A, WL_B],
                         programs_per_task=n)
    assert nj == nt > 0
    return jroot, troot


def test_bootstrap_writes_identical_shards(tmp_path):
    jroot, troot = _boot_both(tmp_path)
    names = sorted(os.path.relpath(os.path.join(d, f), jroot)
                   for d, _, fs in os.walk(jroot) for f in fs)
    assert names == sorted(os.path.relpath(os.path.join(d, f), troot)
                           for d, _, fs in os.walk(troot) for f in fs)
    for name in names:
        if name.endswith(".jsonl"):
            assert open(os.path.join(jroot, name)).read() == \
                open(os.path.join(troot, name)).read(), name
    assert bootstrap_store(RecordStore(troot), ("tpu_v5e",), [WL_A]) == 0


@pytest.mark.parametrize("top_k,pool_cap", [(1, 4096), (2, 20), (3, 4096)])
def test_select_sources_matches(tmp_path, top_k, pool_cap):
    jroot, troot = _boot_both(tmp_path)
    fp = jfp.device_fingerprint("tpu_v5e_pro")
    ref = j_select(JStore(jroot), "tpu_v5e_pro", top_k=top_k,
                   pool_cap=pool_cap, target_fingerprint=fp, seed=3)
    mine = select_sources(RecordStore(troot), "tpu_v5e_pro", top_k=top_k,
                          pool_cap=pool_cap, target_fingerprint=fp, seed=3,
                          torch_device="cpu")
    assert mine.ranked == ref.ranked
    assert [d for d, _ in mine.sources] == [d for d, _ in ref.sources]
    np.testing.assert_allclose([w for _, w in mine.sources],
                               [w for _, w in ref.sources], rtol=0,
                               atol=1e-12)
    for a, b in ((mine.pool.x, ref.pool.x), (mine.pool.y, ref.pool.y),
                 (mine.pool.g, ref.pool.g),
                 (mine.pool.raw_throughput, ref.pool.raw_throughput)):
        np.testing.assert_array_equal(a, b)
    assert mine.best_source == ref.best_source == "tpu_v5e"
    assert mine.pretrained_params is None and ref.pretrained_params is None


def test_select_sources_loads_the_shared_params(tmp_path):
    jroot, troot = _boot_both(tmp_path)
    params = _jax_params(0)
    JStore(jroot).save_model_params("tpu_v5e", params, "mlp")
    RecordStore(troot).save_model_params(
        "tpu_v5e", _params_as("port", params), "mlp")
    mine = select_sources(RecordStore(troot), "tpu_v5e_pro",
                          torch_device="cpu")
    ref = j_select(JStore(jroot), "tpu_v5e_pro")
    assert mine.params_device == ref.params_device == "tpu_v5e"
    for k, v in ref.pretrained_params.items():
        assert mine.pretrained_params[k].device.type == "cpu"
        np.testing.assert_array_equal(mine.pretrained_params[k].numpy(),
                                      np.asarray(v))


def test_empty_store_and_target_never_its_own_source(tmp_path):
    sel = select_sources(RecordStore(str(tmp_path / "e")), "tpu_v5e",
                         torch_device="cpu")
    assert sel.sources == [] and sel.pool is None
    _, troot = _boot_both(tmp_path)
    sel = select_sources(RecordStore(troot), "tpu_v5e", top_k=5,
                         torch_device="cpu")
    assert "tpu_v5e" not in [d for d, _ in sel.ranked]


# --- TuningHub parity ----------------------------------------------------


def _hub_roots(tmp_path):
    """Two identical hub roots: three bootstrapped sources and tpu_v5e's
    params pre-trained by the reference, written once and copied, so both
    packages load the same `.npz`."""
    from repro.core.cost_model import Records as JRecords  # noqa: F401
    jroot = str(tmp_path / "jhub")
    jstore = JStore(os.path.join(jroot, "store"))
    j_bootstrap(jstore, ("tpu_v5e", "tpu_edge", "tpu_lite"),
                [J_WL_A, J_WL_B], programs_per_task=16)
    model = JMLP(JCfg(**CM))
    params, _ = model.train(model.init(jax.random.PRNGKey(0)),
                            jstore.records("tpu_v5e"), epochs=3)
    jstore.save_model_params("tpu_v5e", params, "mlp",
                             lineage={"trigger": "pretrain"})
    troot = str(tmp_path / "thub")
    shutil.copytree(jroot, troot)
    return jroot, troot


@pytest.mark.parametrize("scheduler", ["serial", "gradient"])
def test_tenset_pretrain_hub_job_matches_the_reference(tmp_path, scheduler):
    jroot, troot = _hub_roots(tmp_path)
    from repro.configs.moses import MosesConfig as JMoses
    from repro_torch.configs.moses import MosesConfig as TMoses
    kw = dict(strategy="tenset-pretrain", trials_per_task=12, seed=1,
              scheduler=scheduler)
    ref = JHub(jroot, moses_cfg=JMoses(cost_model=JCfg(**CM), **HUB_MOSES),
               **kw)
    mine = TuningHub(troot, moses_cfg=TMoses(cost_model=TCfg(**CM),
                                             **HUB_MOSES),
                     torch_device="cpu", **kw)
    target = "tpu_v5e_pro"
    for hub, wls in ((ref, (J_WL_A, J_WL_B)), (mine, (WL_A, WL_B))):
        assert all(hub.request(target, wl) for wl in wls)
    (jres,), (tres,) = ref.flush(), mine.flush()

    jsel, tsel = ref.selection(target), mine.selection(target)
    assert tsel.ranked == jsel.ranked
    assert [d for d, _ in tsel.sources] == [d for d, _ in jsel.sources]
    np.testing.assert_allclose([w for _, w in tsel.sources],
                               [w for _, w in jsel.sources], atol=1e-12)
    assert tsel.params_device == jsel.params_device == "tpu_v5e"
    assert tres.strategy == jres.strategy == "tenset-pretrain"
    assert tres.total_measurements == jres.total_measurements > 0
    for t1, t2 in zip(tres.tasks, jres.tasks):
        assert t1.workload.key() == t2.workload.key()
        assert t1.best_config.knobs == t2.best_config.knobs
        assert t1.measurements == t2.measurements
        assert [(c.knobs, t, i) for c, t, i in t1.measured] == \
            [(c.knobs, t, i) for c, t, i in t2.measured]
    assert mine.stats.to_dict() == ref.stats.to_dict()

    for key in (WL_A.key(), WL_B.key()):
        e1, e2 = mine.explain(target, key), ref.explain(target, key)
        assert e1["registry"] == e2["registry"]
        p1, p2 = (dict(e["provenance"]) for e in (e1, e2))
        c1, c2 = p1.pop("calibration"), p2.pop("calibration")
        for p in (p1, p2):
            p.pop("created_at")
        assert p1 == p2
        assert p1["mask_overlap"] == 1.0      # frozen params: no step taken
        assert p1["params_version"] == 1 and p1["sources"]
        assert sorted(c1) == sorted(c2)
        for f in ("rounds", "n_points", "pairs"):
            assert c1[f] == c2[f] > 0, f
        assert c1["draft_batches"] == c2["draft_batches"]
        np.testing.assert_allclose(c1["mean_abs_residual"],
                                   c2["mean_abs_residual"], rtol=1e-4)
    # the store gained the same measurements, and reads alike in both
    assert RecordStore(os.path.join(troot, "store")).count(target) == \
        JStore(os.path.join(jroot, "store")).count(target)
    assert _view(RecordStore(os.path.join(troot, "store")), _t_params) == \
        _view(JStore(os.path.join(troot, "store")), _j_params)


def _tiny_hub(tmp_path, **kw):
    cfg = dataclasses.replace(MCFG, cost_model=TCfg(**CM), **HUB_MOSES)
    hub = TuningHub(str(tmp_path / "hub"), moses_cfg=cfg, trials_per_task=8,
                    pretrain_epochs=2, torch_device="cpu", **kw)
    bootstrap_store(hub.store, ("tpu_v5e", "tpu_edge"), [WL_A, WL_B],
                    programs_per_task=8)
    return hub


def test_unseen_device_e2e_and_dedup(tmp_path):
    hub = _tiny_hub(tmp_path)
    assert hub.request("tpu_v5e_pro", WL_A)
    assert not hub.request("tpu_v5e_pro", WL_A)
    assert hub.stats.dedup_skips == 1
    assert hub.pending_by_device() == {"tpu_v5e_pro": 1}
    r1 = hub.get_config("tpu_v5e_pro", WL_B)
    assert not r1.cache_hit and r1.new_measurements > 0
    sel = hub.selection("tpu_v5e_pro")
    assert sel.best_source == "tpu_v5e" and sel.pretrained_params is not None
    # pre-trained on the pool, then kept in the source's lineage
    assert hub.store.model_lineage("tpu_v5e")[-1]["trigger"] == "pretrain"
    assert hub.metrics.histogram("hub.pretrain_seconds").count == 1
    assert hub.metrics.histogram("hub.fingerprint_seconds").count == 1
    assert hub.get_config("tpu_v5e_pro", WL_A).cache_hit   # one batch
    r2 = hub.get_config("tpu_v5e_pro", WL_B)
    assert r2.cache_hit and r2.new_measurements == 0
    assert r2.config.knobs == r1.config.knobs
    assert hub.stats.jobs == 1 and hub.pending() == 0
    for key in (WL_A.key(), WL_B.key()):
        prov = hub.explain("tpu_v5e_pro", key)["provenance"]
        assert prov["calibration"] and prov["sources"]
        assert 0.0 <= prov["mask_overlap"] <= 1.0


def test_cold_universe_falls_back_to_online_baseline(tmp_path):
    hub = TuningHub(str(tmp_path / "hub"), trials_per_task=8,
                    strategy="tenset-finetune", torch_device="cpu",
                    moses_cfg=dataclasses.replace(
                        MCFG, cost_model=TCfg(**CM), **HUB_MOSES))
    r = hub.get_config("tpu_v5e", WL_A)
    assert not r.cache_hit and r.new_measurements > 0
    assert hub.explain("tpu_v5e", WL_A.key())["provenance"]["strategy"] == \
        "ansor-random"


# --- the launchers --------------------------------------------------------


def test_launch_hub_smoke_refresh_on_cpu(tmp_path, capsys):
    root = str(tmp_path / "hub")
    assert launch_hub.main(["--smoke", "--refresh", "--root", root,
                            "--torch-device", "cpu"]) == 0
    out = capsys.readouterr().out
    assert "[hub-smoke] OK" in out and "forced refresh(tpu_v5e_pro)" in out
    # warm root: everything served, zero measurements
    assert launch_hub.main(["--smoke", "--root", root,
                            "--torch-device", "cpu"]) == 0
    assert "second get_config: hit=True new_measurements=0" in \
        capsys.readouterr().out
    # `--stats` beside a live farm on the same root adds its reader columns
    from repro_torch.hub import HubServer
    with HubServer(root, readers=1, monitor=False, torch_device="cpu"):
        assert launch_hub.main(["--stats", "--root", root,
                                "--torch-device", "cpu"]) == 0
    out = capsys.readouterr().out
    assert "tpu_v5e_pro" in out and "live readers (1 endpoint(s)):" in out
    assert "farm health: 1/1 alive, respawns=0" in out
    assert launch_hub.main(["--lineage", "--root", root]) == 0
    assert "tpu_v5e_pro: 2 version(s), serving=2" in capsys.readouterr().out
    assert launch_hub.main(["--compact", "--root", root]) == 0
    assert "0 duplicate/torn row(s) dropped" in capsys.readouterr().out
    # the reference reads what the port's hub wrote
    ref = JStore(os.path.join(root, "store"))
    assert [e["version"] for e in ref.model_lineage("tpu_v5e_pro")] == [1, 2]
    assert ref.get_provenance("tpu_v5e_pro")


def test_launch_hub_tunes_a_device(tmp_path, capsys):
    root = str(tmp_path / "hub")
    assert launch_hub.main(["--device", "tpu_lite", "--arch",
                            "recurrentgemma-2b", "--trials", "2",
                            "--bootstrap",
                            "tpu_v5e,tpu_edge", "--root", root,
                            "--torch-device", "cpu"]) == 0
    assert "jobs=1" in capsys.readouterr().out
    assert launch_hub.main(["--root", root]) == 2


def test_source_auto_dry_run(tmp_path, registry_file):
    root = str(tmp_path / "hub")
    cfg = get_config("recurrentgemma-2b")
    run = train.maybe_autotune("tpu_v5e_pro", cfg, source="auto",
                               hub_root=root, dry_run=True,
                               torch_device="cpu")
    assert run.registry.path == registry_file
    assert run.hub.queued == 2 and run.hub.bootstrap_records > 0
    # the hub drains a device's tasks in workload-key order
    assert [t.workload.name for t in run.result.tasks] == ["self_attn",
                                                           "qkv_proj"]
    assert run.hub.hub.selection("tpu_v5e_pro").best_source == "tpu_v5p"
    assert run.pretrain_seconds > 0 and run.tune_seconds > 0
    assert len(t_registry.Registry(registry_file)._data["tpu_v5e_pro"]) == 2
    again = train.maybe_autotune("tpu_v5e_pro", cfg, source="auto",
                                 hub_root=root, dry_run=True,
                                 torch_device="cpu")
    assert again.result is None and again.hub.queued == 0
    assert again.hub.bootstrap_records == 0
    assert again.hub.hub.stats.measurements == 0


def test_source_auto_cli(tmp_path, registry_file):
    train.main(["--arch", "recurrentgemma-2b", "--smoke", "--autotune",
                "tpu_lite", "--source", "auto", "--hub-root",
                str(tmp_path / "hub"), "--dry-run", "--autotune-trials", "4",
                "--torch-device", "cpu"])
    assert len(t_registry.Registry(registry_file)._data["tpu_lite"]) == 2


def test_entry_points_raise_without_cuda(tmp_path, monkeypatch):
    from repro_torch.continual import ModelLifecycle
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="torch_device='cpu'"):
        TuningHub(str(tmp_path / "h"))
    store = RecordStore(str(tmp_path / "s"))
    with pytest.raises(RuntimeError):
        ModelLifecycle(store)
    with pytest.raises(RuntimeError):
        store.load_model_params("tpu_v5e")
    assert store.load_model_params("tpu_v5e", torch_device="cpu") is None
    with pytest.raises(RuntimeError):
        train.maybe_autotune("tpu_v5e_pro", get_config("recurrentgemma-2b"),
                             source="auto", hub_root=str(tmp_path / "h"),
                             dry_run=True)


# --- the compact-under-reader race ---------------------------------------


def test_compact_under_concurrent_reader(tmp_path):
    """Readers racing compaction always see a consistent (shard, sidecar)
    pair. A second process double-appends the two distinct rows and the
    store compacts them away, five times: the shard only ever holds 2 or 4
    rows, so a reader must see the true winner and one of those counts.
    (The reference's case appends onto an already doubled shard in its
    first cycle, so its shard really holds 8 rows until the first compact,
    which its (2, 4) check does not admit.)"""
    store = RecordStore(str(tmp_path / "s"))
    store.put("tpu_v5e", WL_A, default_config(WL_A), 100.0)
    store.put("tpu_v5e", WL_A, ProgramConfig.make(**CFG_A2), 150.0, trial=1)
    store.flush()
    shard = store._shard_path("tpu_v5e", WL_A.key())
    body = open(shard).read()
    stop = threading.Event()
    failures, reads = [], []

    def _reader():
        while not stop.is_set():
            r = RecordStore(store.root)
            try:
                best = r.best_record("tpu_v5e", WL_A.key())
                n = r.count("tpu_v5e")
            except Exception as e:  # noqa: BLE001
                failures.append(repr(e))
                return
            if best is None or best["throughput_gflops"] != 150.0 or \
                    n not in (2, 4):
                failures.append(f"torn view: best={best} n={n}")
                return
            reads.append(n)

    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-5)
    threads = [threading.Thread(target=_reader) for _ in range(3)]
    try:
        for t in threads:
            t.start()
        for _ in range(5):
            with open(shard, "a") as f:
                f.write(body)
            assert store.compact("tpu_v5e") == 2
    finally:
        stop.set()
        for t in threads:
            t.join(10.0)
        sys.setswitchinterval(old)
    assert not any(t.is_alive() for t in threads)
    assert not failures, failures
    assert reads
    assert store.count("tpu_v5e") == 2
    assert JStore(store.root).count("tpu_v5e") == 2


def test_chip_smoke_hub_path_rehearses_on_cpu(registry_file, tmp_path,
                                              monkeypatch):
    """chip_smoke.py's `hub_path` at the smoke config and the dry-run
    budget on the CPU: the seeded store, `--source auto` picking tpu_v5e,
    the second call serving everything, every winner explained, both
    forced refreshes (initial, then anchored) and the winners launched for
    the hub's target (the plain versions here)."""
    import importlib.util
    from pathlib import Path

    import repro_torch.configs as t_configs
    from repro_torch.configs import get_smoke_config

    path = Path(__file__).resolve().parents[1] / "chip_smoke.py"
    spec = importlib.util.spec_from_file_location("chip_smoke", path)
    smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(smoke)
    monkeypatch.setattr(t_configs, "get_config", get_smoke_config)
    open(registry_file, "w").write("{}")
    cfg, run, again, line = smoke.drive_hub_path(
        "cpu", "recurrentgemma-2b", str(tmp_path / "hub"), trials=8,
        dry_run=True)
    assert os.path.exists(os.path.join(os.path.dirname(registry_file),
                                       "sched_tuned_configs_torch.json"))
    assert line["sources"][0][0] == "tpu_v5e"
    assert line["second_queued"] == line["second_new_measurements"] == 0
    assert line["explained"] == line["tasks"] == 2
    assert line["store_devices"] == ["tpu_edge", "tpu_v5e", "tpu_v5e_pro",
                                     "tpu_v5p"]
    refresh = smoke.hub_refresh(run.hub.hub, smoke.HUB_TARGET)["refreshes"]
    assert refresh[0]["trigger"] == "initial" and refresh[0]["losses"]
    epochs = run.hub.hub.lifecycle.cfg.refresh_epochs
    assert refresh[1]["parent"] == 1 and len(refresh[1]["losses"]) == epochs
    if refresh[1]["accepted"]:
        assert refresh[1]["lineage"] == [1, 2]
        assert 0.0 <= refresh[1]["ticket_distance"]
    calls = smoke.launch_tuned(cfg, run, "cpu", seed=7,
                               device=smoke.HUB_TARGET)
    assert [wl.name for wl, _, _ in calls] == ["self_attn", "qkv_proj"]
    for wl, _, out in calls:
        assert torch.isfinite(out.float()).all(), wl.name
    json.dumps(line)
