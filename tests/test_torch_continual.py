"""The port's continual learning (`repro_torch.continual`) and the cost-model
functions it reads, against the reference, on the CPU with the same numpy
inputs.

Tolerances:
  * `pairwise_rank_accuracy`, replay samples, fingerprint drift and
    `decide`: exact (numpy in both packages).
  * `param_distance`: rel 1e-12 (float64 sums of the same float32 arrays).
  * rank accuracies from scores: the port's and the reference's scores
    differ by float32 summation order (rel 1e-5 of the largest score), so
    a pair whose reference scores are closer than that may flip. The
    accuracies may differ by at most those pairs.
  * `anchor_weights`' mask: exact except for parameters whose reference
    xi lies within rel 1e-3 of the ratio threshold (the gradients differ
    in float32 rounding; ties at the threshold are all kept in both).
  * one `anchored_train` step (TF32 off: PyTorch's default): loss rtol
    1e-5, gradients rtol 1e-4 with atol 1e-5·max, params after the Adam
    step atol 2e-6 where the reference's gradient is above its tolerance
    (see tests/test_torch_cost_model.py for why Adam's first step is held
    only there).
"""
import dataclasses
import math

import jax
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.autotune.space import Workload as JWorkload  # noqa: E402
from repro.configs.moses import CostModelConfig as JCfg  # noqa: E402
from repro.configs.moses import MosesConfig as JMoses  # noqa: E402
from repro.continual import LifecycleConfig as JLC  # noqa: E402
from repro.continual import ModelLifecycle as JLifecycle  # noqa: E402
from repro.continual import ReplayBuffer as JReplay  # noqa: E402
from repro.continual import ReplayConfig as JReplayCfg  # noqa: E402
from repro.continual import drift as jdrift  # noqa: E402
from repro.continual import regularize as jreg  # noqa: E402
from repro.continual import replay as jreplay  # noqa: E402
from repro.core import cost_model as jcm  # noqa: E402
from repro.hub import bootstrap_store as j_bootstrap  # noqa: E402
from repro.hub.store import RecordStore as JStore  # noqa: E402
from repro_torch.autotune.session import TuneSession  # noqa: E402
from repro_torch.autotune.space import Workload  # noqa: E402
from repro_torch.autotune.tuner import tune  # noqa: E402
from repro_torch.configs.moses import CostModelConfig as TCfg  # noqa: E402
from repro_torch.configs.moses import MosesConfig as TMoses  # noqa: E402
from repro_torch.continual import (CALIBRATION, FINGERPRINT,  # noqa: E402
                                   LifecycleConfig, ModelLifecycle,
                                   ReplayBuffer, ReplayConfig,
                                   anchor_weights, anchored_train,
                                   build_records, calibration_drift,
                                   detect_drift, device_rows,
                                   fingerprint_drift, newest_records,
                                   split_tail)
from repro_torch.continual.regularize import anchored_step  # noqa: E402
from repro_torch.core import convert  # noqa: E402
from repro_torch.core import cost_model as tcm  # noqa: E402
from repro_torch.hub import TuningHub, bootstrap_store  # noqa: E402
from repro_torch.hub import device_fingerprint  # noqa: E402
from repro_torch.hub.store import RecordStore  # noqa: E402
from repro_torch.obs.calibration import CalibrationTracker  # noqa: E402

WL_A = Workload("matmul", (256, 256, 128), name="a")
WL_B = Workload("matmul", (512, 256, 128), name="b")
J_WLS = [JWorkload("matmul", (256, 256, 128), name="a"),
         JWorkload("matmul", (512, 256, 128), name="b")]
CM = dict(hidden_dims=(32, 32), batch_size=64, rank_pairs_per_batch=256)
SMALL = dict(online_epochs=2, adaptation_epochs=2, population_size=32,
             evolution_rounds=2, top_k_measure=8)
T_MOSES = TMoses(cost_model=TCfg(**CM), **SMALL)
J_MOSES = JMoses(cost_model=JCfg(**CM), **SMALL)
LC = dict(window=8, min_fresh=4, refresh_epochs=2)


@pytest.fixture(autouse=True)
def one_torch_thread():
    """One torch thread per test: the suite runs several workers on the
    machine's cores (see tests/test_torch_train.py)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _np(tree):
    return {k: (v.detach().cpu().numpy() if isinstance(v, torch.Tensor)
                else np.asarray(v, np.float32)) for k, v in tree.items()}


def _jparams(seed=0):
    return jcm.init_mlp_params(JCfg(**CM), jax.random.PRNGKey(seed))


def _tparams(jparams):
    return convert.cost_model_params(_np(jparams), "cpu")


def _model():
    return tcm.resolve_cost_model("mlp", TCfg(**CM), "cpu")


@pytest.fixture
def roots(tmp_path):
    """The same bootstrapped store written by each package."""
    jroot, troot = str(tmp_path / "j"), str(tmp_path / "t")
    j_bootstrap(JStore(jroot), ("tpu_v5e",), J_WLS, programs_per_task=24)
    bootstrap_store(RecordStore(troot), ("tpu_v5e",), [WL_A, WL_B],
                    programs_per_task=24)
    return jroot, troot


def _records(n=40, groups=2, seed=0):
    rng = np.random.RandomState(seed)
    x = rng.randn(n, 164).astype(np.float32)
    raw = rng.rand(n).astype(np.float32) + 0.1
    g = (np.arange(n) % groups).astype(np.int32)
    return tcm.Records(x=x, y=tcm.normalize_per_task(raw, g), g=g,
                       raw_throughput=raw)


def _same_records(a, b):
    for f in ("x", "y", "g", "raw_throughput"):
        np.testing.assert_array_equal(getattr(a, f), getattr(b, f), f)


# --- cost-model functions --------------------------------------------------


@pytest.mark.parametrize("seed,n,groups,max_pairs", [
    (0, 30, 3, 8192), (1, 60, 2, 100), (2, 5, 5, 8192), (3, 40, 1, 64)])
def test_pairwise_rank_accuracy_matches(seed, n, groups, max_pairs):
    rng = np.random.RandomState(seed)
    scores = rng.randn(n).astype(np.float32)
    labels = rng.randint(0, 6, n).astype(np.float32)   # many label ties
    g = rng.randint(0, groups, n)
    want = jcm.pairwise_rank_accuracy(scores, labels, g, max_pairs, seed)
    got = tcm.pairwise_rank_accuracy(scores, labels, g, max_pairs, seed)
    assert got == want or (math.isnan(got) and math.isnan(want))


def test_pairwise_rank_accuracy_no_pairs_is_nan():
    assert math.isnan(tcm.pairwise_rank_accuracy(
        np.zeros(3), np.array([1.0, 2.0, 3.0]), np.array([0, 1, 2])))
    assert math.isnan(tcm.rank_accuracy({}, _records(0)))


def _near_pairs(scores, labels, groups, tol):
    """Comparable pairs, and those whose scores are closer than `tol`."""
    n = near = 0
    for g in np.unique(groups):
        idx = np.nonzero(groups == g)[0]
        for i in range(len(idx)):
            for j in range(i + 1, len(idx)):
                a, b = idx[i], idx[j]
                if labels[a] == labels[b]:
                    continue
                n += 1
                near += abs(float(scores[a]) - float(scores[b])) <= tol
    return n, near


def test_rank_accuracy_with_converted_params():
    recs = _records(48, groups=3, seed=4)
    jp = _jparams(1)
    want = jcm.rank_accuracy(jp, jcm.Records(recs.x, recs.y, recs.g))
    got = tcm.rank_accuracy(_tparams(jp), recs)
    scores = jcm.predict(jp, recs.x)
    n, near = _near_pairs(scores, recs.y, recs.g,
                          1e-5 * np.abs(scores).max())
    assert abs(got - want) * n <= near + 1e-9
    assert 0.0 <= got <= 1.0


@pytest.mark.parametrize("masked", [False, True])
def test_param_distance_matches(masked):
    a, b = _np(_jparams(0)), _np(_jparams(1))
    mask = None
    if masked:
        rng = np.random.RandomState(0)
        mask = {k: (rng.rand(*v.shape) > 0.5).astype(np.float32)
                for k, v in a.items()}
    want = jcm.param_distance(a, b, mask)
    got = tcm.param_distance({k: torch.tensor(v) for k, v in a.items()},
                             {k: torch.tensor(v) for k, v in b.items()},
                             None if mask is None else
                             {k: torch.as_tensor(v) for k, v in mask.items()})
    assert got == pytest.approx(want, rel=1e-12)
    assert tcm.param_distance(_tparams(_jparams(0)),
                              _tparams(_jparams(0))) == 0.0


def test_records_concat_matches():
    rs = [_records(5, seed=1), _records(0), _records(7, seed=2)]
    want = jcm.Records.concat([jcm.Records(r.x, r.y, r.g) for r in rs])
    got = tcm.Records.concat(rs)
    for f in ("x", "y", "g"):
        np.testing.assert_array_equal(getattr(got, f), getattr(want, f))
    assert got.raw_throughput is None and len(got) == 12


# --- the anchored update ---------------------------------------------------


def _jax_pairs(key, batch_len, n_pairs):
    """The pair indices `repro.core.cost_model.pairwise_rank_loss` draws."""
    k1, k2 = jax.random.split(key)
    return (np.asarray(jax.random.randint(k1, (n_pairs,), 0, batch_len)),
            np.asarray(jax.random.randint(k2, (n_pairs,), 0, batch_len)))


@pytest.mark.parametrize("ratio", [0.25, 0.5])
def test_anchor_weights_mask_matches(ratio):
    recs = _records(40, groups=2, seed=5)   # one bucket of 64 rows
    jp = _jparams(2)
    jmodel = jcm.MLPCostModel(JCfg(**CM))
    seed = 7
    want = jreg.anchor_weights(jmodel, jp, jcm.Records(recs.x, recs.y,
                                                       recs.g),
                               ratio=ratio, strength=3.0, seed=seed)
    pairs = _jax_pairs(jax.random.PRNGKey(seed), 64,
                       CM["rank_pairs_per_batch"])
    got = anchor_weights(_model(), _tparams(jp), recs, ratio=ratio,
                         strength=3.0, pairs=pairs, torch_device="cpu")
    # where the masks may differ: xi within rel 1e-3 of the threshold
    batch = jreg._full_batch(jcm.Records(recs.x, recs.y, recs.g))
    grads = jax.grad(jcm.model_loss)(jp, batch, jax.random.PRNGKey(seed),
                                     "rank", CM["rank_pairs_per_batch"])
    xi = {k: np.abs(np.asarray(jp[k]) * np.asarray(grads[k])) for k in jp}
    flat = np.sort(np.concatenate([v.ravel() for v in xi.values()]))
    k = int(np.clip(np.round(np.float32(ratio) * flat.size), 1, flat.size))
    thresh = flat[flat.size - k]
    differ = near = 0
    for name in jp:
        w, g = np.asarray(want[name]), got[name].numpy()
        assert set(np.unique(g)) <= {0.0, 3.0}
        differ += int((w != g).sum())
        near += int((np.abs(xi[name] - thresh) <= 1e-3 * thresh).sum())
    assert differ <= near
    on = sum(int((v.numpy() > 0).sum()) for v in got.values())
    assert on / flat.size == pytest.approx(ratio, abs=0.02)


def test_one_anchored_step_matches():
    """One epoch over 40 records is one bucket-padded batch: the
    reference's `anchored_train` against `anchored_step` with the pairs the
    reference drew, from an anchor away from the start so the penalty
    pulls."""
    recs = _records(40, groups=2, seed=6)
    jrec = jcm.Records(recs.x, recs.y, recs.g)
    jp, janchor = _jparams(3), _jparams(4)
    rng = np.random.RandomState(1)
    weights = {k: (rng.rand(*np.shape(v)) > 0.5).astype(np.float32) * 0.5
               for k, v in jp.items()}
    jmodel = jcm.MLPCostModel(JCfg(**CM))
    seed = 11
    want, jlosses = jreg.anchored_train(
        jmodel, jp, jrec, anchor=janchor,
        weights={k: jax.numpy.asarray(v) for k, v in weights.items()},
        epochs=1, seed=seed)
    _, key = jax.random.split(jax.random.PRNGKey(seed))
    pairs = _jax_pairs(key, 64, CM["rank_pairs_per_batch"])
    jbatch = next(jrec.batches(64, np.random.RandomState(seed), pad=True))
    _, _, jgrads = jreg._anchored_loss_and_grad(
        jp, janchor, {k: jax.numpy.asarray(v) for k, v in weights.items()},
        jbatch, key, "rank", CM["rank_pairs_per_batch"])

    model = _model()
    tp = _tparams(jp)
    batch = next(recs.batches(64, np.random.RandomState(seed), pad=True,
                              torch_device="cpu"))
    tw = {k: torch.as_tensor(v) for k, v in weights.items()}
    tanchor = _tparams(janchor)
    loss, tgrads = tcm.loss_and_grad(
        lambda p: tcm.model_loss(p, batch, None, "rank",
                                 CM["rank_pairs_per_batch"], pairs=pairs)
        + sum(0.5 * torch.sum(tw[k] * torch.square(p[k] - tanchor[k]))
              for k in sorted(p)), tp)
    g_top = max(float(np.abs(np.asarray(g)).max()) for g in jgrads.values())
    for k in jgrads:
        np.testing.assert_allclose(tgrads[k].numpy(), np.asarray(jgrads[k]),
                                   rtol=1e-4, atol=1e-5 * g_top, err_msg=k)
    new, opt, step_loss = anchored_step(model, tp, tcm.adam_init(tp), batch,
                                        tanchor, tw, TCfg(**CM).lr,
                                        pairs=pairs)
    assert opt.count == 1
    np.testing.assert_allclose(float(step_loss), jlosses[0], rtol=1e-5)
    np.testing.assert_allclose(float(loss), jlosses[0], rtol=1e-5)
    for k, g in jgrads.items():
        signed = np.abs(np.asarray(g)) > 1e-5 * g_top
        np.testing.assert_allclose(new[k].numpy()[signed],
                                   np.asarray(want[k])[signed], rtol=0,
                                   atol=2e-6, err_msg=k)


def test_anchored_train_deterministic_and_pinned():
    model = _model()
    params = model.init(0)
    recs = _records(32, groups=1)
    a, la = anchored_train(model, params, recs, epochs=2, seed=3,
                           torch_device="cpu")
    b, lb = anchored_train(model, params, recs, epochs=2, seed=3,
                           torch_device="cpu")
    assert tcm.param_distance(a, b) == 0.0 and la == lb
    w = anchor_weights(model, params, recs, ratio=0.5, strength=1e4,
                       torch_device="cpu")
    free, _ = anchored_train(model, params, recs, anchor=params, epochs=3,
                             seed=0, torch_device="cpu")
    pinned, _ = anchored_train(model, params, recs, anchor=params,
                               weights=w, epochs=3, seed=0,
                               torch_device="cpu")
    mask = {k: v / 1e4 for k, v in w.items()}
    assert tcm.param_distance(pinned, params, mask=mask) < \
        tcm.param_distance(free, params, mask=mask) * 0.2
    inv = {k: 1.0 - m for k, m in mask.items()}
    assert tcm.param_distance(pinned, params, mask=inv) > 0.0
    # the caller's params are never modified
    assert tcm.param_distance(params, model.init(0)) == 0.0


# --- replay ----------------------------------------------------------------


@pytest.mark.parametrize("per_task,exclude_tail,fresh_ratio", [
    (8, 0, 0.5), (64, 8, 0.25), (4, 4, 1.0)])
def test_replay_sample_and_mix_match(roots, per_task, exclude_tail,
                                     fresh_ratio):
    jroot, troot = roots
    cfg = dict(per_task=per_task, fresh_ratio=fresh_ratio, seed=3)
    jbuf = JReplay(JStore(jroot), "tpu_v5e", JReplayCfg(**cfg),
                   exclude_tail=exclude_tail)
    tbuf = ReplayBuffer(RecordStore(troot), "tpu_v5e", ReplayConfig(**cfg),
                        exclude_tail=exclude_tail)
    assert tbuf.sample_rows() == jbuf.sample_rows()
    _same_records(tbuf.sample(), jbuf.sample())
    rows = device_rows(RecordStore(troot), "tpu_v5e")
    assert rows == jreplay.device_rows(JStore(jroot), "tpu_v5e")
    head, tail = split_tail(rows, 8)
    assert (head, tail) == jreplay.split_tail(rows, 8)
    fresh = build_records(tail)
    _same_records(fresh, jreplay.build_records(tail))
    _same_records(tbuf.mix(fresh), jbuf.mix(jreplay.build_records(tail)))


# --- drift -----------------------------------------------------------------


def _report(r):
    d = dataclasses.asdict(r)
    return {k: (None if isinstance(v, float) and math.isnan(v) else v)
            for k, v in d.items()}


def test_fingerprint_drift_matches(roots):
    jroot, troot = roots
    for store in (JStore(jroot), RecordStore(troot)):
        store.put_fingerprint("tpu_v5e", device_fingerprint("tpu_v5e"))
    for current in (None, device_fingerprint("tpu_lite")):
        got = fingerprint_drift(RecordStore(troot), "tpu_v5e",
                                current=current)
        want = jdrift.fingerprint_drift(JStore(jroot), "tpu_v5e",
                                        current=current)
        assert _report(got) == _report(want)
    assert not fingerprint_drift(RecordStore(troot), "tpu_lite").drifted


def test_calibration_drift_and_decide_match(roots):
    """Drift reports and decisions on the same store and params: the
    fingerprint reports exactly, calibration within its near-tie
    allowance, and the same decision."""
    jroot, troot = roots
    jp = _jparams(5)
    jstore, tstore = JStore(jroot), RecordStore(troot)
    jstore.save_model_params("tpu_v5e", jp, "mlp")
    tstore.save_model_params("tpu_v5e", _tparams(jp), "mlp")
    for store in (jstore, tstore):
        store.put_fingerprint("tpu_v5e", device_fingerprint("tpu_lite"))
    jlc = JLifecycle(jstore, moses_cfg=J_MOSES, cfg=JLC(**LC))
    tlc = ModelLifecycle(tstore, moses_cfg=T_MOSES,
                         cfg=LifecycleConfig(**LC), torch_device="cpu")
    jrep, trep = jlc.check("tpu_v5e"), tlc.check("tpu_v5e")
    assert [r.kind for r in trep] == [FINGERPRINT, CALIBRATION]
    assert _report(trep[0]) == _report(jrep[0])
    window = newest_records(tstore, "tpu_v5e", LC["window"],
                            holdout_only=True)
    _same_records(window, jdrift.newest_records(jstore, "tpu_v5e",
                                                LC["window"],
                                                holdout_only=True))
    scores = jcm.predict(jp, window.x)
    n, near = _near_pairs(scores, window.y, window.g,
                          1e-5 * np.abs(scores).max())
    assert abs(trep[1].value - jrep[1].value) * n <= near + 1e-9
    assert tlc.decide("tpu_v5e", trep) == jlc.decide("tpu_v5e", jrep)
    assert tlc.decide("tpu_v5e", trep) in ("refresh", "retire")
    got = calibration_drift(tlc.model(), None, window, "tpu_v5e")
    assert not got.drifted and got.detail == "no saved params"
    reports = detect_drift(tstore, "tpu_v5e")
    assert [r.kind for r in reports] == [FINGERPRINT]


# --- the lifecycle ---------------------------------------------------------


def _lifecycle(root, **kw):
    store = RecordStore(root)
    cfg = kw.pop("cfg", LifecycleConfig(**LC,
                                        replay=ReplayConfig(per_task=8)))
    return ModelLifecycle(store, moses_cfg=T_MOSES, cfg=cfg,
                          torch_device="cpu", **kw)


def test_refresh_versions_read_back_by_the_reference(roots):
    _, troot = roots
    lc = _lifecycle(troot)
    assert lc.status("tpu_v5e") == "absent"
    r1 = lc.refresh("tpu_v5e", force=True)
    assert r1.accepted and r1.version == 1 and r1.trigger == "initial"
    r2 = lc.refresh("tpu_v5e", trigger="drift:calibration", force=True)
    ref = JStore(troot)
    if r2.accepted:
        assert r2.parent == 1 and r2.version == 2
        assert ref.model_lineage("tpu_v5e")[-1]["trigger"] == \
            "drift:calibration"
        assert ref.model_lineage("tpu_v5e")[-1]["param_distance"] == \
            round(r2.param_distance, 6)
    else:
        assert "regress" in r2.reason
    version = ref.latest_model_version("tpu_v5e")
    assert version == lc.store.latest_model_version("tpu_v5e")
    mine = lc.serving_params("tpu_v5e")
    theirs = ref.load_model_params("tpu_v5e", model_name="mlp")
    for k, v in theirs.items():
        np.testing.assert_array_equal(mine[k].numpy(), np.asarray(v))
    assert ref.model_lineage("tpu_v5e") == lc.store.model_lineage("tpu_v5e")
    # the reference's lifecycle takes the port's version as its serving one
    jlc = JLifecycle(ref, moses_cfg=J_MOSES, cfg=JLC(**LC))
    assert jlc.status("tpu_v5e") in ("fresh", "stale")
    log = lc.decision_log("tpu_v5e")
    assert [e["kind"] for e in log] == ["refresh", "refresh"]
    assert log[0]["accepted"] is True


def test_guard_rejects_regressing_params(roots, monkeypatch):
    _, troot = roots
    lc = _lifecycle(troot)
    assert lc.refresh("tpu_v5e", force=True).accepted

    def garbage(device, params, records, **kw):
        return {k: -v for k, v in params.items()}, [0.0]

    monkeypatch.setattr(lc.session(), "refresh_params", garbage)
    res = lc.refresh("tpu_v5e", trigger="drift:test")
    assert not res.accepted and "regress" in res.reason
    assert lc.store.latest_model_version("tpu_v5e") == 1
    assert res.holdout_accuracy_new < res.holdout_accuracy_old


def test_floor_empty_device_and_retire(tmp_path, roots):
    _, troot = roots
    lc = _lifecycle(str(tmp_path / "empty"))
    res = lc.refresh("ghost", force=True)
    assert not res.accepted and res.reason == "no records in store"
    lc = _lifecycle(troot, cfg=LifecycleConfig(**dict(LC, min_fresh=64)))
    res = lc.refresh("tpu_v5e")
    assert not res.accepted and "min_fresh" in res.reason
    lc = _lifecycle(troot, cfg=LifecycleConfig(
        **dict(LC, retire_threshold=0.0001, calibration_threshold=0.0)))
    assert lc.refresh("tpu_v5e", force=True).accepted
    assert lc.maybe_refresh("tpu_v5e") is None      # no baseline: keep
    lc.store.put_fingerprint("tpu_v5e", device_fingerprint("tpu_lite"))
    assert lc.decide("tpu_v5e") == "retire"
    res = lc.maybe_refresh("tpu_v5e")
    assert res.reason == "retired"
    assert lc.store.latest_model_version("tpu_v5e") is None
    assert lc.status("tpu_v5e") == "retired"
    # the baseline was re-anchored to the current probe
    assert not fingerprint_drift(lc.store, "tpu_v5e").drifted


def test_drift_summary_shape(roots):
    _, troot = roots
    lc = _lifecycle(troot)
    lc.store.put_fingerprint("tpu_v5e", device_fingerprint("tpu_v5e"))
    lc.refresh("tpu_v5e", force=True)
    row = lc.drift_summary("tpu_v5e")
    assert row["status"] in ("fresh", "stale") and row["version"] == 1
    assert row["fingerprint_shift"] == pytest.approx(0.0, abs=1e-6)
    assert 0.0 <= row["rank_accuracy"] <= 1.0


# --- the hub and the session -----------------------------------------------


def _hub(tmp_path, **kw):
    hub = TuningHub(str(tmp_path / "hub"), moses_cfg=T_MOSES,
                    trials_per_task=8, pretrain_epochs=2,
                    lifecycle_cfg=LifecycleConfig(
                        **dict(LC, calibration_threshold=1.01)),
                    torch_device="cpu", **kw)
    bootstrap_store(hub.store, ("tpu_v5e", "tpu_edge"), [WL_A, WL_B],
                    programs_per_task=16)
    return hub


@pytest.mark.parametrize("mode", ["sync", "auto"])
def test_hub_refresh_after_job(tmp_path, mode):
    hub = _hub(tmp_path, refresh=mode)
    r = hub.get_config("tpu_v5e_pro", WL_A)
    assert not r.cache_hit
    hub.join_refreshes(timeout=120)
    assert hub.stats.refreshes + hub.stats.refresh_rejects == 1
    if hub.stats.refreshes:
        assert hub.store.latest_model_version("tpu_v5e_pro") is not None


def test_hub_refresh_off_and_bad_mode(tmp_path):
    hub = _hub(tmp_path)
    hub.get_config("tpu_v5e_pro", WL_A)
    assert hub.stats.refreshes == 0 and hub.stats.refresh_rejects == 0
    with pytest.raises(ValueError):
        TuningHub(str(tmp_path / "x"), refresh="sometimes",
                  torch_device="cpu")


def test_accepted_refresh_invalidates_dependent_selections(tmp_path):
    hub = _hub(tmp_path)
    hub.get_config("tpu_v5e_pro", WL_A)
    sel = hub.selection("tpu_v5e_pro")
    assert sel is not None and sel.params_device == "tpu_v5e"
    hub._run_refresh("tpu_v5e")     # the source device gains a version
    assert hub.stats.refreshes + hub.stats.refresh_rejects == 1
    if hub.stats.refreshes:
        assert hub.selection("tpu_v5e_pro") is None


def test_session_refresh_params_deterministic_and_isolated(roots):
    _, troot = roots
    recs = RecordStore(troot).records("tpu_v5e")
    model = _model()
    params = model.init(0)
    session = TuneSession(moses_cfg=T_MOSES, seed=5, torch_device="cpu")
    a, la = session.refresh_params("tpu_v5e", params, recs, epochs=2)
    b, lb = session.refresh_params("tpu_v5e", params, recs, epochs=2)
    assert tcm.param_distance(a, b) == 0.0 and la == lb
    c, _ = session.refresh_params("tpu_edge", params, recs, epochs=2)
    assert tcm.param_distance(a, c) > 0.0
    legacy = TuneSession(seed=5, isolate_rng=False, torch_device="cpu")
    assert legacy.job_seed("tpu_v5e", "moses", "x") == 5
    assert session.job_seed("tpu_v5e", "moses") != 5


def test_session_store_receives_every_measurement(tmp_path):
    store = RecordStore(str(tmp_path / "s"))
    session = TuneSession(moses_cfg=T_MOSES, seed=2, trials_per_task=8,
                          store=store, torch_device="cpu")
    res = session.run([WL_A], "tpu_v5e", "ansor-random")
    assert store.flush() == len(res.tasks[0].measured) > 0
    camp = session.run_many([("tpu_edge", [WL_B])], strategy="ansor-random")
    assert store.flush() == len(camp[0].tasks[0].measured) > 0


def test_tune_calibration_is_a_pure_observer():
    model = _model()
    pretrained = model.init(0)
    kw = dict(trials_per_task=8, pretrained_params=pretrained, seed=4,
              cost_model=model, torch_device="cpu")
    calib = CalibrationTracker()
    with_obs = tune([WL_A], "tpu_v5e", "tenset-finetune", T_MOSES,
                    calibration=calib, **kw)
    without = tune([WL_A], "tpu_v5e", "tenset-finetune", T_MOSES, **kw)
    assert [(c.knobs, t, i) for c, t, i in with_obs.tasks[0].measured] == \
        [(c.knobs, t, i) for c, t, i in without.tasks[0].measured]
    row = calib.per_task("tpu_v5e", WL_A.key())
    assert row["rounds"] > 0 and row["n_points"] == with_obs.tasks[0] \
        .measurements
