"""The port's tuning scheduler (`repro_torch.sched`) and
`TuneSession.run_many` against the reference, on the CPU.

  * The executor returns the same outcomes, costs and quarantine as the
    reference's on the same requests; `FaultInjector.fault_for` draws the
    same fault map.
  * The drafts are numpy in both packages: equal predictions after the same
    fit. The speculative scorer verifies the same rows; their scores agree
    to rel 1e-5 (the verifier is torch here, jax there).
  * `run_campaign`: `raw` gives identical results, and `tenset-pretrain`
    with frozen converted params grants, measures and picks exactly what
    the reference's campaign does. `moses` with draft-then-verify trains on
    the way with torch's own pair indices, so it is checked by outcome: its
    registry feeds both packages' kernels.
  * Calibration on or off changes no result; serial `run_many` rejects
    campaign-only knobs; interleaved tasks sharing one moses strategy keep
    their own AC state.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.autotune.dataset import generate_records as j_generate  # noqa: E402
from repro.autotune.dataset import training_task_pool as j_pool  # noqa: E402
from repro.autotune.devices import FaultInjector as JInjector  # noqa: E402
from repro.autotune.registry import Registry as JRegistry  # noqa: E402
from repro.autotune.space import Workload as JWorkload  # noqa: E402
from repro.autotune.strategies import Strategy as JStrategy  # noqa: E402
from repro.autotune.tasks import resnet18_tasks as j_resnet18  # noqa: E402
from repro.configs.moses import CostModelConfig as JCfg  # noqa: E402
from repro.configs.moses import DEFAULT as J_MCFG  # noqa: E402
from repro.configs.moses import MosesConfig as JMoses  # noqa: E402
from repro.core.cost_model import MLPCostModel as JMLP  # noqa: E402
from repro.core.cost_model import Records as JRecords  # noqa: E402
from repro.kernels import ops as j_ops  # noqa: E402
from repro.sched import engine as j_engine  # noqa: E402
from repro.sched import executor as j_executor  # noqa: E402
from repro.sched import run_campaign as j_run_campaign  # noqa: E402
from repro.sched import speculative as j_spec  # noqa: E402
from repro_torch.autotune import devices as dev_mod  # noqa: E402
from repro_torch.autotune.devices import FaultInjector  # noqa: E402
from repro_torch.autotune.registry import Registry  # noqa: E402
from repro_torch.autotune.session import TuneSession  # noqa: E402
from repro_torch.autotune.space import (Workload, config_valid,  # noqa: E402
                                        default_config, random_config)
from repro_torch.autotune.strategies import (AnsorRandomStrategy,  # noqa: E402
                                             Strategy, resolve_strategy)
from repro_torch.autotune.tasks import resnet18_tasks  # noqa: E402
from repro_torch.configs.moses import CostModelConfig as TCfg  # noqa: E402
from repro_torch.configs.moses import DEFAULT as MCFG  # noqa: E402
from repro_torch.configs.moses import MosesConfig as TMoses  # noqa: E402
from repro_torch.core import convert  # noqa: E402
from repro_torch.core.ac import ACState  # noqa: E402
from repro_torch.core.cost_model import (Records, RecordsBuilder,  # noqa: E402
                                         resolve_cost_model)
from repro_torch.kernels import ops as t_ops  # noqa: E402
from repro_torch.obs import metrics as obs_metrics  # noqa: E402
from repro_torch.obs.calibration import CalibrationTracker  # noqa: E402
from repro_torch.sched import (MeasurementExecutor,  # noqa: E402
                               RandomFeatureDraft, RidgeDraft, SpecStats,
                               SpeculativeScorer, TaskTuner,
                               batch_wall_seconds, run_campaign)

WL = Workload("matmul", (256, 256, 128), name="wl")
J_WL = JWorkload("matmul", (256, 256, 128), name="wl")
TINY_CFG = dataclasses.replace(
    MCFG, online_epochs=2, adaptation_epochs=2, population_size=32,
    evolution_rounds=2, top_k_measure=8)
JOBS = [("tpu_v5e", [Workload("matmul", (256, 256, 128), name="a"),
                     Workload("scan", (1024, 512), name="s")]),
        ("tpu_edge", [Workload("matmul", (512, 256, 128), name="b")])]


def _j_jobs(jobs):
    return [(d, [JWorkload(w.kind, w.dims, name=w.name, count=w.count)
                 for w in ts]) for d, ts in jobs]


@pytest.fixture(autouse=True)
def one_torch_thread():
    """One torch thread per test: the suite runs several workers on the
    machine's cores (see tests/test_torch_train.py)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _configs(n, seed=0, wl=WL):
    rng = np.random.RandomState(seed)
    out, seen = [], set()
    while len(out) < n:
        c = random_config(wl, rng)
        if c.knobs not in seen:
            seen.add(c.knobs)
            out.append(c)
    return out


def _j_config(cfg):
    from repro.autotune.space import ProgramConfig
    return ProgramConfig(cfg.knobs)


# ---------------------------------------------------------------------------
# executor + fault injector
# ---------------------------------------------------------------------------


def _outcome_rows(outs):
    return [(o.request.config.knobs, o.request.trial, o.throughput,
             o.seconds, o.attempts, o.error) for o in outs]


@pytest.mark.parametrize("workers", [1, 4])
def test_executor_matches_the_reference(workers):
    """Crashes, transients and healthy requests through both packages'
    thread pools: the same outcomes, the same simulated costs, the same
    quarantine, and quarantine hits on resubmission."""
    cfgs = _configs(24)
    kw = dict(crash=0.15, flaky=0.2, seed=7)
    got = {}
    for name, ex_cls, fi_cls, wl, conv in (
            ("mine", MeasurementExecutor, FaultInjector, WL, lambda c: c),
            ("ref", j_executor.MeasurementExecutor, JInjector, J_WL,
             _j_config)):
        batch = [conv(c) for c in cfgs]
        with ex_cls(workers=workers, retries=1, measure_fn=fi_cls(**kw)) \
                as ex:
            first = ex.measure_batch(wl, batch, "tpu_v5p", trial=2)
            again = ex.measure_batch(wl, batch, "tpu_v5p", trial=2)
            q = [(e.device, e.workload_key, e.knobs, e.trial, e.error)
                 for e in ex.quarantined()]
        got[name] = (_outcome_rows(first), _outcome_rows(again), sorted(q))
    assert got["mine"] == got["ref"]
    first, again, q = got["mine"]
    assert any(r[5] and "InjectedCrash" in r[5] for r in first)
    assert any(r[4] == 2 and r[2] is not None for r in first)  # flaky, healed
    assert len(q) == sum(r[2] is None for r in first) > 0
    assert sum(r[5] is not None and r[5].startswith("quarantined:")
               for r in again) == len(q)


def test_batch_wall_seconds_matches_the_reference():
    rng = np.random.RandomState(0)
    for workers in (1, 2, 4, 7):
        costs = list(rng.rand(13) * 3)
        assert batch_wall_seconds(costs, workers) == \
            j_executor.batch_wall_seconds(costs, workers)
    assert batch_wall_seconds([], 4) == 0.0
    assert batch_wall_seconds([3, 1, 1, 1], 2) == 3.0


def test_fault_for_matches_the_reference_on_200_identities():
    mine = FaultInjector(crash=0.1, hang=0.1, flaky=0.1, slow=0.1, seed=2)
    ref = JInjector(crash=0.1, hang=0.1, flaky=0.1, slow=0.1, seed=2)
    cfgs = _configs(100)
    got = [mine.fault_for(WL, c, t) for c in cfgs for t in (0, 5)]
    want = [ref.fault_for(J_WL, _j_config(c), t) for c in cfgs for t in (0, 5)]
    assert len(got) == 200 and got == want
    assert len(set(got) - {None}) == 4


def test_fault_injector_measures_healthy_identities_exactly():
    fi = FaultInjector(crash=0.3, seed=7)
    for c in _configs(16):
        if fi.fault_for(WL, c, 0) is None:
            assert fi(WL, c, "tpu_v5e") == dev_mod.measure(WL, c, "tpu_v5e")
        else:
            with pytest.raises(dev_mod.InjectedCrash):
                fi(WL, c, "tpu_v5e")


# ---------------------------------------------------------------------------
# draft-then-verify
# ---------------------------------------------------------------------------


def _records(n=64, seed=0):
    rng = np.random.RandomState(seed)
    x = rng.rand(n, MCFG.cost_model.feature_dim).astype(np.float32)
    # labels linearly tied to a feature the draft's stride keeps (col 0)
    y = (0.2 + 0.8 * x[:, 0]).astype(np.float32)
    return x, y


@pytest.mark.parametrize("kind", ["ridge", "random-feature"])
def test_drafts_predict_as_the_reference(kind):
    mine = RidgeDraft() if kind == "ridge" else RandomFeatureDraft(seed=3)
    ref = (j_spec.RidgeDraft() if kind == "ridge"
           else j_spec.RandomFeatureDraft(seed=3))
    x, y = _records(128)
    g = np.zeros(len(x), np.int32)
    assert mine.fit(Records(x, y, g)) and ref.fit(JRecords(x, y, g))
    xt, _ = _records(96, seed=4)
    np.testing.assert_allclose(mine.predict(xt), ref.predict(xt), rtol=1e-6,
                               atol=1e-6)
    # distillation: the same teacher rows, the same refits
    mine = RidgeDraft(refit_every=32) if kind == "ridge" else \
        RandomFeatureDraft(seed=3, refit_every=32)
    ref = j_spec.RidgeDraft(refit_every=32) if kind == "ridge" else \
        j_spec.RandomFeatureDraft(seed=3, refit_every=32)
    for s in range(5):
        xb, yb = _records(24, seed=10 + s)
        mine.observe(xb, yb)
        ref.observe(xb, yb)
    np.testing.assert_allclose(mine.predict(xt), ref.predict(xt), rtol=1e-6,
                               atol=1e-6)


@pytest.fixture(scope="module")
def models():
    """The paper's cost model (164 -> 512 -> 512 -> 1) in both packages,
    with the reference's seed-0 params converted for the port."""
    jmodel = JMLP(J_MCFG.cost_model)
    jparams = jmodel.init(jax.random.PRNGKey(0))
    model = resolve_cost_model("mlp", MCFG.cost_model, "cpu")
    params = convert.cost_model_params(
        {k: np.asarray(v) for k, v in jparams.items()}, "cpu")
    return model, params, jmodel, jparams


@pytest.mark.parametrize("audit", [0, 8])
def test_speculative_scorer_verifies_as_the_reference(models, audit):
    model, params, jmodel, jparams = models
    x, y = _records(128)
    g = np.zeros(len(x), np.int32)
    kw = dict(keep_frac=0.25, min_full=8, audit=audit, distill=False)
    mine = SpeculativeScorer(model, draft=RidgeDraft(), **kw)
    ref = j_spec.SpeculativeScorer(jmodel, draft=j_spec.RidgeDraft(), **kw)
    mine.refit(Records(x, y, g))
    ref.refit(JRecords(x, y, g))
    got, want = mine(params, x), np.asarray(ref(jparams, x))
    n_full = 32 + audit
    verified = np.sort(np.argsort(-got)[:n_full])
    assert np.array_equal(verified, np.sort(np.argsort(-want)[:n_full]))
    # rel 1e-5 of the batch's score scale: a score that is a near
    # cancellation (|s| ~ 1e-3 of the largest) keeps the absolute error of
    # its neighbours, not their relative one
    scale = float(np.abs(want[verified]).max())
    np.testing.assert_allclose(got[verified], want[verified], rtol=1e-5,
                               atol=1e-5 * scale)
    rest = np.setdiff1d(np.arange(128), verified)
    assert got[rest].max() < got[verified].min()
    # the unverified rows keep the draft's order, as in the reference
    assert np.array_equal(np.argsort(-got[rest], kind="stable"),
                          np.argsort(-want[rest], kind="stable"))
    assert got.dtype == np.float32
    assert dataclasses.asdict(mine.stats) == dataclasses.asdict(ref.stats)


def test_screened_batch_is_rank_safe(models):
    """tests/test_sched.py's case on the port. Verified rows keep the full
    model's scores and every draft-only row ranks below every verified
    row. The scores are compared at rel 1e-5, not bit for bit: the scorer
    runs the model on the 32 kept rows, the check on all 128, and a matmul
    over a different row count may sum in another order (the reference's
    own case fails for the same reason, its bucket padding giving
    0.03671293 against 0.03671297)."""
    model, params, _, _ = models
    scorer = SpeculativeScorer(model, keep_frac=0.25, min_full=8, audit=0,
                               distill=False, draft=RidgeDraft())
    x, y = _records(128)
    scorer.refit(Records(x, y, np.zeros(128, np.int32)))
    out = scorer(params, x)
    st = scorer.stats
    assert st.screened == 1
    assert st.full_rows == 32 and st.draft_rows == 128
    full = model.batched_predict(params, x)
    verified = np.argsort(-out)[:32]
    scale = float(np.abs(full[verified]).max())
    assert out[verified[0]] == pytest.approx(full[verified].max(), rel=1e-5,
                                             abs=1e-5 * scale)
    np.testing.assert_allclose(out[verified], full[verified], rtol=1e-5,
                               atol=1e-5 * scale)
    unverified = np.setdiff1d(np.arange(128), verified)
    assert out[unverified].max() < out[verified].min()
    assert 0.0 <= st.acceptance <= 1.0


def test_distilling_draft_observes_the_verifiers_scores(models):
    model, params, _, _ = models
    scorer = SpeculativeScorer(model, keep_frac=0.25, min_full=8)
    seen = []
    observe = scorer.draft.observe
    scorer.draft.observe = lambda x, y: (seen.append((x, y)), observe(x, y))
    x, _ = _records(128)
    first = scorer(params, x)               # unscreened: every row
    assert np.array_equal(seen[0][1], first)
    x2, _ = _records(128, seed=5)
    out = scorer(params, x2)                # screened
    assert scorer.stats.screened == 1
    rows, scores = seen[1]
    assert scores.dtype == np.float32
    top = [int(np.flatnonzero((x2 == r).all(1))[0]) for r in rows]
    assert np.array_equal(out[top], scores)
    assert SpecStats(draft_rows=400, full_rows=100,
                     unscreened_rows=100).full_model_reduction == 2.5


# ---------------------------------------------------------------------------
# the stepwise engine: cold-start draws
# ---------------------------------------------------------------------------


class _NoModel(Strategy):
    """A strategy that searches but never has params: the tuner scores
    from its numpy RNG."""
    name = "no-model"


class _JNoModel(JStrategy):
    name = "no-model"


def test_cold_start_tuner_draws_as_the_reference():
    """With no params the score function is the task's numpy RNG; both
    packages draw in the same order, so they measure the same configs."""
    from repro.configs.moses import MosesConfig as JMC
    cfg = dataclasses.replace(TMoses(), population_size=16,
                              evolution_rounds=2, top_k_measure=4)
    jcfg = dataclasses.replace(JMC(), population_size=16,
                               evolution_rounds=2, top_k_measure=4)
    measured = []
    for tuner_cls, strat, wl, model, ex in (
            (TaskTuner, _NoModel(), WL,
             resolve_cost_model("mlp", cfg.cost_model, "cpu"),
             MeasurementExecutor(workers=2)),
            (j_engine.TaskTuner, _JNoModel(), J_WL, JMLP(jcfg.cost_model),
             j_executor.MeasurementExecutor(workers=2))):
        with ex:
            tuner = tuner_cls(wl, "tpu_v5e", strat,
                              cfg if tuner_cls is TaskTuner else jcfg,
                              model, 11, ex)
            for _ in range(3):
                tuner.step()
            res = tuner.finish()
        measured.append(([(c.knobs, t, i) for c, t, i in res.measured],
                         res.best_config.knobs, tuner.rng.rand()))
    assert measured[0] == measured[1]


# ---------------------------------------------------------------------------
# campaigns across packages
# ---------------------------------------------------------------------------


def test_raw_campaign_identical():
    mine = run_campaign(JOBS, TINY_CFG, strategy="raw", trials_per_task=8,
                        torch_device="cpu")
    ref = j_run_campaign(_j_jobs(JOBS), J_MCFG, strategy="raw",
                         trials_per_task=8)
    assert mine.total_measurements == ref.total_measurements == 0
    for r1, r2 in zip(mine.results, ref.results):
        for t1, t2 in zip(r1.tasks, r2.tasks):
            assert t1.best_config.knobs == t2.best_config.knobs
            assert t1.best_latency == t2.best_latency
            assert t1.best_config.knobs == default_config(t1.workload).knobs


def test_equal_workload_keys_share_one_result_alike():
    """Two tasks of one job with equal dims (RecurrentGemma-2B's `out_proj`
    and `rec_out_proj`) have one workload key, and the campaign's results,
    keyed on it, give both places the later task's result: a reference
    property the port keeps."""
    jobs = [("tpu_v5e", [Workload("matmul", (512, 2560, 2560), name="first"),
                         Workload("matmul", (512, 2560, 2560),
                                  name="second")])]
    mine = run_campaign(jobs, TINY_CFG, strategy="raw", torch_device="cpu")
    ref = j_run_campaign(_j_jobs(jobs), J_MCFG, strategy="raw")
    for res in (mine, ref):
        assert [t.workload.name for t in res.results[0].tasks] == \
            ["second", "second"]


CM = dict(hidden_dims=(32, 32), batch_size=64, rank_pairs_per_batch=256)
MOSES = dict(population_size=16, evolution_rounds=2, top_k_measure=4,
             online_epochs=3)
R18 = ("fc", "proj1x1_64_128")


def _pick(tasks):
    by_name = {t.name: t for t in tasks}
    return [by_name[n] for n in R18]


@pytest.fixture(scope="module")
def pretrained():
    """Small-width configs and params pre-trained by the reference, as in
    tests/test_torch_slice.py."""
    jcfg = JMoses(cost_model=JCfg(**CM), **MOSES)
    tcfg = TMoses(cost_model=TCfg(**CM), **MOSES)
    jsource = j_generate(j_pool(include_archs=False)[::6], "tpu_v5p",
                         programs_per_task=6)
    jmodel = JMLP(jcfg.cost_model)
    jparams, _ = jmodel.train(jmodel.init(jax.random.PRNGKey(0)), jsource,
                              epochs=2)
    tparams = convert.cost_model_params(
        {k: np.asarray(v) for k, v in jparams.items()}, "cpu")
    tsource = Records(jsource.x, jsource.y, jsource.g,
                      jsource.raw_throughput)
    return jcfg, tcfg, jmodel, jparams, jsource, tparams, tsource


def test_tenset_pretrain_campaign_grants_measures_and_picks_the_same(
        pretrained):
    """Frozen converted params score the same up to float noise, so the
    campaign grants the same rounds, measures the same configs and picks
    the same winners as the reference's."""
    jcfg, tcfg, jmodel, jparams, jsource, tparams, tsource = pretrained
    jobs = [("tpu_v5e", _pick(resnet18_tasks())),
            ("tpu_edge", _pick(resnet18_tasks())[:1])]
    kw = dict(strategy="tenset-pretrain", seed=1, trials_per_task=12,
              speculative=False)
    mine = run_campaign(jobs, tcfg, pretrained_params=tparams,
                        source_pool=tsource, torch_device="cpu", **kw)
    ref = j_run_campaign(_j_jobs(jobs), jcfg, cost_model=jmodel,
                         pretrained_params=jparams, source_pool=jsource, **kw)

    def trace(c):
        return [(t.key, t.reason, t.measurements, t.spent_seconds)
                for t in c.trace]

    assert trace(mine) == trace(ref)
    assert {t.reason for t in mine.trace} >= {"warmup", "gradient"}
    assert mine.total_measurements == ref.total_measurements
    assert mine.spent_seconds == ref.spent_seconds
    assert mine.curve() == ref.curve()
    for r1, r2 in zip(mine.results, ref.results):
        for t1, t2 in zip(r1.tasks, r2.tasks):
            assert [(c.knobs, t, i) for c, t, i in t1.measured] == \
                [(c.knobs, t, i) for c, t, i in t2.measured]
            assert t1.best_config.knobs == t2.best_config.knobs
            assert t1.best_latency == t2.best_latency


def test_moses_speculative_campaign_registry_feeds_both_kernels(
        pretrained, tmp_path):
    """moses trains with torch's own pair indices, so the campaign is held
    to outcomes: budget kept, valid configs, and a registry that the
    reference reads and both packages' tuned matmul agree on."""
    _, tcfg, _, _, _, tparams, tsource = pretrained
    path = str(tmp_path / "tuned.json")
    session = TuneSession(moses_cfg=tcfg, pretrained_params=tparams,
                          source_pool=tsource, seed=1, trials_per_task=16,
                          registry=Registry(path), torch_device="cpu")
    campaign = session.run_many([("tpu_v5e", _pick(resnet18_tasks()))],
                                strategy="moses", speculative=True,
                                return_campaign=True)
    session.registry.save()
    res = campaign.results[0]
    assert session.results == campaign.results
    assert campaign.total_measurements <= 16 * 2 + 2
    assert campaign.spec_stats.batches > 0
    assert campaign.wall_seconds <= campaign.spent_seconds + 1e-6
    for t in res.tasks:
        assert config_valid(t.workload, t.best_config)
        assert 0 < t.measurements and t.best_throughput > 0
    assert all(torch.isfinite(p).all() for p in res.final_params.values())
    jreg = JRegistry(path)
    old_j, old_t = j_ops._registry, t_ops._registry
    j_ops.set_registry(jreg)
    t_ops.set_registry(Registry(path))
    try:
        rng = np.random.RandomState(0)
        for jwl, twl in zip(_pick(j_resnet18()), _pick(resnet18_tasks())):
            entry = jreg.lookup("tpu_v5e", jwl)
            assert entry is not None
            M, N, K = jwl.dims
            a = rng.randn(M, K).astype(np.float32)
            b = rng.randn(K, N).astype(np.float32)
            want = np.asarray(j_ops.tuned_matmul(
                jnp.asarray(a), jnp.asarray(b), device="tpu_v5e",
                interpret=True), np.float32)
            got = t_ops.tuned_matmul(torch.as_tensor(a), torch.as_tensor(b),
                                     device="tpu_v5e").float().numpy()
            top = float(np.abs(want).max())
            if entry["knobs"]["out_bf16"]:  # one bf16 ulp at the output scale
                tol = 2.0 ** (np.floor(np.log2(top)) - 7)
                np.testing.assert_allclose(got, want, rtol=0, atol=tol)
            else:  # float32: summation order only
                np.testing.assert_allclose(got, want, rtol=1e-5,
                                           atol=1e-5 * top)
    finally:
        j_ops.set_registry(old_j)
        t_ops.set_registry(old_t)


# ---------------------------------------------------------------------------
# the port's campaign on its own
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def campaign():
    return run_campaign(JOBS, TINY_CFG, strategy="ansor-random",
                        trials_per_task=24, speculative=True,
                        torch_device="cpu")


def test_campaign_budget_and_grant_order(campaign):
    assert [r.device for r in campaign.results] == ["tpu_v5e", "tpu_edge"]
    assert campaign.total_measurements <= 24 * 3 + 3
    assert campaign.spent_seconds == pytest.approx(
        sum(r.total_search_seconds for r in campaign.results))
    reasons = [t.reason for t in campaign.trace]
    assert all(r == "warmup" for r in reasons[:6])
    assert set(reasons[6:]) <= {"floor", "gradient"}
    spent = [t.spent_seconds for t in campaign.trace]
    assert spent == sorted(spent)
    st = campaign.spec_stats
    assert st.batches > 0 and st.full_rows + st.unscreened_rows > 0


def test_campaign_deterministic_and_calibration_is_a_pure_observer(campaign):
    """A rerun with a calibration tracker of its own, and one with
    calibration off, land bit-identical results."""
    tracker = CalibrationTracker(registry=obs_metrics.MetricsRegistry())
    for calibration in (tracker, False):
        again = run_campaign(JOBS, TINY_CFG, strategy="ansor-random",
                             trials_per_task=24, speculative=True,
                             torch_device="cpu", calibration=calibration)
        assert again.curve() == campaign.curve()
        assert [t.key for t in again.trace] == \
            [t.key for t in campaign.trace]
        for r1, r2 in zip(campaign.results, again.results):
            for t1, t2 in zip(r1.tasks, r2.tasks):
                assert t1.best_config.knobs == t2.best_config.knobs
                assert t1.measured == t2.measured
    assert len(tracker) == 3
    assert all(d["rounds"] > 0 for d in tracker.summary().values())
    assert any(d["draft_batches"] > 0 for d in tracker.summary().values())


def test_campaign_defaults_to_the_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        run_campaign(JOBS, TINY_CFG, strategy="ansor-random",
                     trials_per_task=8)


# ---------------------------------------------------------------------------
# TuneSession.run_many
# ---------------------------------------------------------------------------


def test_run_many_serial_matches_run():
    s1 = TuneSession(moses_cfg=TINY_CFG, seed=3, trials_per_task=8,
                     torch_device="cpu")
    r_many = s1.run_many(dict(JOBS), strategy="ansor-random",
                         scheduler="serial")
    s2 = TuneSession(moses_cfg=TINY_CFG, seed=3, trials_per_task=8,
                     torch_device="cpu")
    r_each = [s2.run(tasks, dev, "ansor-random") for dev, tasks in JOBS]
    for a, b in zip(r_many, r_each):
        assert a.device == b.device
        for ta, tb in zip(a.tasks, b.tasks):
            assert ta.best_config.knobs == tb.best_config.knobs


@pytest.mark.parametrize("kw", [
    {"speculative": True}, {"budget_seconds": 10.0}, {"total_trials": 8},
    {"return_campaign": True}, {"obs": "telemetry"}])
def test_run_many_serial_rejects_campaign_only_knobs(kw):
    session = TuneSession(moses_cfg=TINY_CFG, torch_device="cpu")
    with pytest.raises(ValueError, match="serial.*" + next(iter(kw))):
        session.run_many(dict(JOBS), scheduler="serial", **kw)


def test_run_many_rejects_unknown_scheduler():
    session = TuneSession(moses_cfg=TINY_CFG, torch_device="cpu")
    with pytest.raises(ValueError, match="unknown scheduler"):
        session.run_many(dict(JOBS), scheduler="mystery")


def test_run_many_gradient_ingests_registry(tmp_path):
    reg = Registry(path=str(tmp_path / "reg.json"))
    session = TuneSession(moses_cfg=TINY_CFG, seed=3, registry=reg,
                          trials_per_task=8, torch_device="cpu")
    results = session.run_many(dict(JOBS), strategy="ansor-random",
                               scheduler="gradient")
    assert session.results == results
    for r in results:
        for t in r.tasks:
            assert reg.lookup(r.device, t.workload) is not None


# ---------------------------------------------------------------------------
# a strategy shared by a device's tasks
# ---------------------------------------------------------------------------


def test_moses_task_state_roundtrip():
    strat = resolve_strategy("moses")
    strat.ac_state = ACState(batch_means=(1.0, 2.0), terminated=True)
    snap = strat.task_state()
    strat.begin_task(WL)               # another task resets the state
    assert strat.task_state().terminated is False
    strat.set_task_state(snap)         # swap the first task back in
    assert strat.task_state().terminated is True
    assert strat.task_state().batch_means == (1.0, 2.0)


def test_interleaved_tasks_keep_their_own_ac_state(pretrained):
    """Two tuners on one moses strategy, stepped in turn: each keeps its own
    AC state, one observation per round it ran, held as host floats, so no
    swap can alias a tensor of the shared model's."""
    _, tcfg, _, _, _, tparams, tsource = pretrained
    from repro_torch.autotune.strategies import StrategyContext
    cm = resolve_cost_model("mlp", tcfg.cost_model, "cpu")
    strat = resolve_strategy("moses")
    strat.prepare(StrategyContext(cfg=tcfg, cost_model=cm, device="tpu_v5e",
                                  seed=1, pretrained_params=tparams,
                                  source_pool=tsource))
    builder = RecordsBuilder()
    tasks = _pick(resnet18_tasks())
    with MeasurementExecutor(workers=2) as ex:
        tuners = [TaskTuner(wl, "tpu_v5e", strat, tcfg, cm, 5 + i, ex,
                            shared_builder=builder, group=i)
                  for i, wl in enumerate(tasks)]
        steps = [0, 0]
        for i in (0, 1, 0, 0, 1):
            if tuners[i].active:
                tuners[i].step()
                steps[i] += 1
    states = [t._task_state for t in tuners]
    assert states[0] is not states[1]
    for st, n in zip(states, steps):
        assert len(st.batch_means) == n
        assert all(type(m) is float for m in st.batch_means)
    assert len(builder) == sum(len(t.measured) for t in tuners)
    assert all(isinstance(p, torch.Tensor) for p in strat.params.values())


def test_unregistered_instance_rejected_across_scopes():
    class Unregistered(AnsorRandomStrategy):
        name = "not-in-registry"

    with pytest.raises(ValueError, match="not in the\n?.*registry"):
        run_campaign(JOBS, TINY_CFG, strategy=Unregistered(),
                     trials_per_task=8, torch_device="cpu")
