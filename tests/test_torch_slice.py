"""The whole slice: two ResNet-18 GEMMs through `TuneSession.run` in both
packages, from the same pretrained params, then the tuned registry into the
kernels.

  * `raw` needs no model: identical results.
  * `tenset-pretrain` scores with the frozen converted params: evolution is
    driven by the same numpy RNG and the same score order, so it measures
    the same configs in the same order.
  * `moses` trains on the way, with torch's own pair indices, so it is
    checked by outcome: its registry file is read by the reference's
    `Registry`, and both packages' `tuned_matmul` agree on it.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.autotune.dataset import generate_records as j_generate  # noqa: E402
from repro.autotune.registry import Registry as JRegistry  # noqa: E402
from repro.autotune.session import TuneSession as JSession  # noqa: E402
from repro.autotune.tasks import resnet18_tasks as j_resnet18  # noqa: E402
from repro.configs.moses import CostModelConfig as JCfg  # noqa: E402
from repro.configs.moses import MosesConfig as JMoses  # noqa: E402
from repro.core.cost_model import MLPCostModel as JMLP  # noqa: E402
from repro.kernels import ops as j_ops  # noqa: E402
from repro_torch.autotune.dataset import training_task_pool  # noqa: E402
from repro_torch.autotune.registry import Registry as TRegistry  # noqa: E402
from repro_torch.autotune.session import TuneSession as TSession  # noqa: E402
from repro_torch.autotune.space import config_valid  # noqa: E402
from repro_torch.autotune.tasks import resnet18_tasks as t_resnet18  # noqa: E402
from repro_torch.configs.moses import CostModelConfig as TCfg  # noqa: E402
from repro_torch.configs.moses import MosesConfig as TMoses  # noqa: E402
from repro_torch.core import convert  # noqa: E402
from repro_torch.core import cost_model as tcm  # noqa: E402
from repro_torch.kernels import ops as t_ops  # noqa: E402

TASKS = ("fc", "proj1x1_64_128")
CM = dict(hidden_dims=(32, 32), batch_size=64, rank_pairs_per_batch=256)
MOSES = dict(population_size=16, evolution_rounds=2, top_k_measure=4,
             online_epochs=3)
TRIALS = 16


def _pick(tasks):
    by_name = {t.name: t for t in tasks}
    return [by_name[n] for n in TASKS]


@pytest.fixture(scope="module")
def setup():
    jcfg = JMoses(cost_model=JCfg(**CM), **MOSES)
    tcfg = TMoses(cost_model=TCfg(**CM), **MOSES)
    from repro.autotune.dataset import training_task_pool as j_pool
    pool = j_pool(include_archs=False)
    assert [w.key() for w in pool] == [
        w.key() for w in training_task_pool(include_archs=False)]
    jsource = j_generate(pool[::6], "tpu_v5p", programs_per_task=6)
    jmodel = JMLP(jcfg.cost_model)
    jparams, _ = jmodel.train(jmodel.init(jax.random.PRNGKey(0)), jsource,
                              epochs=2)
    tparams = convert.cost_model_params(
        {k: np.asarray(v) for k, v in jparams.items()}, "cpu")
    tsource = tcm.Records(jsource.x, jsource.y, jsource.g,
                          jsource.raw_throughput)
    jsession = JSession(moses_cfg=jcfg, pretrained_params=jparams,
                        source_pool=jsource, seed=1, trials_per_task=TRIALS,
                        cost_model=jmodel)
    tsession = TSession(moses_cfg=tcfg, pretrained_params=tparams,
                        source_pool=tsource, seed=1, trials_per_task=TRIALS,
                        torch_device="cpu")
    return jsession, tsession


def _run_both(setup, strategy):
    jsession, tsession = setup
    return (jsession.run(_pick(j_resnet18()), "tpu_v5e", strategy),
            tsession.run(_pick(t_resnet18()), "tpu_v5e", strategy))


def test_raw_identical(setup):
    jres, tres = _run_both(setup, "raw")
    for jt, tt in zip(jres.tasks, tres.tasks):
        assert jt.best_config.knobs == tt.best_config.knobs
        assert jt.best_throughput == tt.best_throughput
        assert jt.best_latency == tt.best_latency
    assert jres.model_latency == tres.model_latency


def test_tenset_pretrain_measures_the_same_configs(setup):
    jres, tres = _run_both(setup, "tenset-pretrain")
    for jt, tt in zip(jres.tasks, tres.tasks):
        assert [(c.knobs, t, i) for c, t, i in jt.measured] == \
            [(c.knobs, t, i) for c, t, i in tt.measured]
        assert jt.best_config.knobs == tt.best_config.knobs
    assert jres.total_search_seconds == tres.total_search_seconds


def test_moses_registry_feeds_both_packages_kernels(setup, tmp_path):
    _, tsession = setup
    path = str(tmp_path / "tuned.json")
    tsession.registry = TRegistry(path)
    try:
        tres = tsession.run(_pick(t_resnet18()), "tpu_v5e", "moses")
    finally:
        tsession.registry.save()
        tsession.registry = None
    assert len(tres.tasks) == 2 and tres.total_measurements > 0
    assert all(np.isfinite(p.numpy()).all()
               for p in tres.final_params.values())
    jreg = JRegistry(path)
    old_j, old_t = j_ops._registry, t_ops._registry
    j_ops.set_registry(jreg)
    t_ops.set_registry(TRegistry(path))
    try:
        rng = np.random.RandomState(0)
        for jwl, twl in zip(_pick(j_resnet18()), _pick(t_resnet18())):
            entry = jreg.lookup("tpu_v5e", jwl)
            assert entry is not None
            assert config_valid(twl, t_ops.get_registry().get("tpu_v5e", twl))
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


@pytest.mark.parametrize("strategy", ["ansor-random", "tenset-finetune",
                                      "moses"])
def test_training_strategies_run_to_the_end(setup, strategy):
    """The strategies that train draw torch's own pair indices, so they are
    held to outcomes: the reference's measurement plan, valid winners and
    finite adapted params. (Beating the vendor default is not an outcome
    to hold them to: at this budget the reference's own moses run does
    not.)"""
    jres, tres = _run_both(setup, strategy)
    for jt, tt in zip(jres.tasks, tres.tasks):
        assert config_valid(tt.workload, tt.best_config)
        if strategy != "moses":  # the AC may stop measuring at any round
            assert tt.measurements == jt.measurements == TRIALS
        assert 0 < tt.measurements <= TRIALS + 1
        assert tt.best_throughput > 0
    assert all(torch.isfinite(p).all() for p in tres.final_params.values())


def test_run_matrix_grid(setup):
    _, tsession = setup
    out = tsession.run_matrix({"r18": _pick(t_resnet18())},
                              {"2060": "tpu_v5e"}, ("raw", "moses"),
                              ratio_override=0.3)
    assert sorted(out) == ["r18|2060"]
    assert sorted(out["r18|2060"]) == ["moses", "raw"]


def test_session_defaults_to_the_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    session = TSession(moses_cfg=TMoses(cost_model=TCfg(**CM), **MOSES))
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        session.run(_pick(t_resnet18()), "tpu_v5e", "ansor-random")
