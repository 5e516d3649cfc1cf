"""The port's lottery-ticket adaptation phase against the reference's, on
identical inputs: params, discriminator, batches and the ranking loss's
pair indices (drawn from JAX's key and handed to the port).

Tolerances: losses rtol 1e-5 (float32, summation order only); the masks and
the transferable fraction must be identical; params and discriminator after
each phase atol 2e-6 where the gradient has a defined sign (see
test_torch_cost_model.py: Adam turns a gradient that is zero up to rounding
into a step of either sign, at most lr).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.configs.moses import CostModelConfig as JCfg  # noqa: E402
from repro.configs.moses import MosesConfig as JMoses  # noqa: E402
from repro.core import adaptation as jad  # noqa: E402
from repro.core import cost_model as jcm  # noqa: E402
from repro.core import lottery as jlot  # noqa: E402
from repro_torch.autotune.dataset import generate_records  # noqa: E402
from repro_torch.autotune.tasks import resnet18_tasks  # noqa: E402
from repro_torch.configs.moses import CostModelConfig as TCfg  # noqa: E402
from repro_torch.configs.moses import MosesConfig as TMoses  # noqa: E402
from repro_torch.core import adaptation as tad  # noqa: E402
from repro_torch.core import convert  # noqa: E402
from repro_torch.core import cost_model as tcm  # noqa: E402
from repro_torch.core import lottery as tlot  # noqa: E402

HIDDEN = 32
N_PAIRS = 256
LR, THETA, DECAY, BETA = 1e-3, 0.5, 0.05, 0.05


def np_tree(tree):
    return {k: np.asarray(v, np.float32) for k, v in tree.items()}


def t_tree(tree):
    return {k: v.detach().cpu().numpy() for k, v in tree.items()}


@pytest.fixture(scope="module")
def data():
    target = generate_records(resnet18_tasks()[5:8], "tpu_v5e",
                              programs_per_task=7, seed=4)
    source = generate_records(resnet18_tasks()[:6], "tpu_v5p",
                              programs_per_task=9, seed=5)
    return target, source


def _batches(target, source, phase):
    """Phase `phase`'s target batch (bucket-padded) and source batch, built
    from numpy in both frameworks."""
    args = (target.x, target.y, target.g)
    jb = next(jcm.Records(*args).batches(64, np.random.RandomState(phase),
                                         pad=True))
    tb = next(tcm.Records(*args).batches(64, np.random.RandomState(phase),
                                         pad=True, torch_device="cpu"))
    idx = np.random.RandomState(phase).randint(0, len(source),
                                               size=len(tb["x"]))
    js = {k: jnp.asarray(getattr(source, k)[idx]) for k in "xyg"}
    ts = {k: torch.as_tensor(getattr(source, k)[idx]) for k in "xyg"}
    return jb, tb, js, ts


def _jax_pairs(key, batch_len):
    k1, k2 = jax.random.split(key)
    return (np.asarray(jax.random.randint(k1, (N_PAIRS,), 0, batch_len)),
            np.asarray(jax.random.randint(k2, (N_PAIRS,), 0, batch_len)))


def _signed_close(got, want, before, grads, what):
    top = max(float(np.abs(np.asarray(g)).max()) for g in grads.values())
    for k, p0 in before.items():
        signed = np.abs(np.asarray(grads[k])) > 1e-5 * top
        np.testing.assert_allclose(got[k][signed], want[k][signed], rtol=0,
                                   atol=2e-6, err_msg=f"{what} {k}")
        for side in (got[k], want[k]):
            assert np.abs(side - p0)[~signed].max(initial=0) <= LR * 1.001


@pytest.mark.parametrize("use_ratio", [True, False], ids=["ratio", "theta"])
def test_adapt_phases_match(data, use_ratio):
    target, source = data
    jparams = jcm.init_mlp_params(JCfg(hidden_dims=(HIDDEN, HIDDEN)),
                                  jax.random.PRNGKey(0))
    jdisc = jad.init_discriminator(jax.random.PRNGKey(1), HIDDEN, width=16)
    jopt, jdopt = jcm.adam_init(jparams), jcm.adam_init(jdisc)
    tparams = convert.cost_model_params(np_tree(jparams), "cpu")
    tdisc = convert.discriminator_params(np_tree(jdisc), "cpu")
    topt, tdopt = tcm.adam_init(tparams), tcm.adam_init(tdisc)

    for phase in range(2):
        jb, tb, js, ts = _batches(target, source, phase)
        key = jax.random.PRNGKey(10 + phase)
        pairs = _jax_pairs(key, len(tb["x"]))

        # the masks each framework derives from its own gradient
        (_, _), (jg, jgd) = jax.value_and_grad(
            jad._adaptation_loss, argnums=(0, 1), has_aux=True)(
            jparams, jdisc, jb, js, key, BETA, N_PAIRS)
        jmask = jlot.transferable_mask(jparams, jg, ratio=0.5, theta=THETA,
                                       use_ratio=use_ratio)
        _, tg = tcm.loss_and_grad(
            lambda p: tad._adaptation_loss(p, tdisc, tb, ts, None, BETA,
                                           N_PAIRS, pairs=pairs)[0], tparams)
        tmask = tlot.transferable_mask(tparams, tg, ratio=0.5, theta=THETA,
                                       use_ratio=use_ratio)
        for k in jmask:
            np.testing.assert_array_equal(tmask[k].numpy(),
                                          np.asarray(jmask[k]), err_msg=k)

        before_p, before_d = np_tree(jparams), np_tree(jdisc)
        (jparams, jdisc, jopt, jdopt, jloss, jrank, jadv,
         jfrac) = jad._adapt_phase(jparams, jdisc, jopt, jdopt, jb, js, key,
                                   LR, 0.5, THETA, DECAY, BETA, N_PAIRS,
                                   use_ratio)
        (tparams, tdisc, topt, tdopt, tloss, trank, tadv,
         tfrac) = tad._adapt_phase(tparams, tdisc, topt, tdopt, tb, ts, None,
                                   LR, 0.5, THETA, DECAY, BETA, N_PAIRS,
                                   use_ratio, pairs=pairs)
        np.testing.assert_allclose(
            [float(tloss), float(trank), float(tadv)],
            [float(jloss), float(jrank), float(jadv)], rtol=1e-5)
        assert float(tadv) > 0
        assert float(tfrac) == float(jfrac)
        assert topt.count == int(jopt.count) == phase + 1
        _signed_close(t_tree(tparams), np_tree(jparams), before_p, jg,
                      "params")
        _signed_close(t_tree(tdisc), np_tree(jdisc), before_d, jgd, "disc")
        # carry the reference's state on, so phase 2 starts from one place
        tparams = convert.cost_model_params(np_tree(jparams), "cpu")
        tdisc = convert.discriminator_params(np_tree(jdisc), "cpu")
        topt = tcm.AdamState(convert._to_tensors(jopt.m, "cpu"),
                             convert._to_tensors(jopt.v, "cpu"), topt.count)
        tdopt = tcm.AdamState(convert._to_tensors(jdopt.m, "cpu"),
                              convert._to_tensors(jdopt.v, "cpu"),
                              tdopt.count)


def test_grad_reverse_negates_only_the_gradient():
    x = torch.tensor([1.0, -2.0], requires_grad=True)
    y = tad.grad_reverse(x)
    assert torch.equal(y, x)
    (3 * y).sum().backward()
    assert torch.equal(x.grad, torch.tensor([-3.0, -3.0]))


def test_adapter_streams_match_reference(data):
    """MosesAdapter keeps the reference's numpy streams: the same source
    batches and the same number of phases over the same target records."""
    target, source = data
    cfg_kw = dict(cost_model=dict(hidden_dims=(HIDDEN, HIDDEN),
                                  batch_size=8, rank_pairs_per_batch=64))
    jcfg = JMoses(cost_model=JCfg(**cfg_kw["cost_model"]))
    tcfg = TMoses(cost_model=TCfg(**cfg_kw["cost_model"]))
    jparams = jcm.init_mlp_params(jcfg.cost_model, jax.random.PRNGKey(0))
    jsrc = jcm.Records(source.x, source.y, source.g)
    jad_ = jad.MosesAdapter(cfg=jcfg, params=jparams, source_pool=jsrc)
    tad_ = tad.MosesAdapter(cfg=tcfg, params=convert.cost_model_params(
        np_tree(jparams), "cpu"), source_pool=source)
    for n in (0, 3):
        jad_.history = [{}] * n
        tad_.history = [{}] * n
        np.testing.assert_array_equal(tad_._source_batch(16)["x"].numpy(),
                                      np.asarray(jad_._source_batch(16)["x"]))
    jad_.history, tad_.history = [], []
    jtarget = jcm.Records(target.x, target.y, target.g)
    jad_.adapt(jtarget, epochs=2)
    tad_.adapt(target, epochs=2)
    assert len(tad_.history) == len(jad_.history) == 2 * -(-len(target) // 8)
    assert [h["mask_frac"] for h in tad_.history] == pytest.approx(
        [h["mask_frac"] for h in jad_.history], abs=1e-3)
    assert all(np.isfinite(h["loss"]) for h in tad_.history)


@pytest.mark.parametrize("ratio", [0.3, 0.7])
def test_prune_variant_matches(ratio):
    """Winning-ticket extraction: the variant params are zeroed exactly as
    the reference zeroes them."""
    rng = np.random.RandomState(int(ratio * 10))
    params = {"w0": rng.randn(12, HIDDEN).astype(np.float32),
              "b0": rng.randn(HIDDEN).astype(np.float32),
              "w1": rng.randn(HIDDEN, 1).astype(np.float32),
              "b1": rng.randn(1).astype(np.float32)}
    grads = {k: rng.randn(*v.shape).astype(np.float32)
             for k, v in params.items()}
    jmask = jlot.transferable_mask({k: jnp.asarray(v) for k, v in
                                    params.items()},
                                   {k: jnp.asarray(v) for k, v in
                                    grads.items()}, ratio=ratio)
    tmask = tlot.transferable_mask({k: torch.as_tensor(v) for k, v in
                                    params.items()},
                                   {k: torch.as_tensor(v) for k, v in
                                    grads.items()}, ratio=ratio)
    want = jlot.prune_variant({k: jnp.asarray(v) for k, v in params.items()},
                              jmask)
    got = tlot.prune_variant({k: torch.as_tensor(v) for k, v in
                              params.items()}, tmask)
    for k in params:
        np.testing.assert_array_equal(got[k].numpy(), np.asarray(want[k]))
    kept = sum(int((got[k] != 0).sum()) for k in got)
    assert kept == int(round(float(tlot.mask_fraction(tmask))
                             * sum(v.size for v in params.values())))
