"""The port's cost model, lottery masks and weight carry-over against the
reference, on the same numpy inputs.

Tolerances:
  * scores: rtol 1e-5 with atol 1e-5 * max|score| — float32 on both sides,
    differing only in summation order inside the matmuls.
  * gradients: rtol 1e-4 with atol 1e-5 * max|grad| — the backward pass
    adds a second float32 reduction.
  * params after an Adam step: atol 2e-6. The first step moves each param
    by lr * g / (|g| + eps), about lr = 1e-3 in size, so float32 rounding
    in g changes it by far less than 2e-6 except where |g| is near eps.
    Those exceptions are real: the ranking loss does not change when every
    score shifts by one constant, so the gradient of the output bias, and
    of every hidden bias whose ReLU is active on all rows of the batch, is
    zero up to rounding (about 1e-9, with either sign), and Adam scales
    that noise to a step of up to lr. Where the reference's gradient is
    within the gradient tolerance of zero, the step is held to at most lr.
"""
import jax
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.configs.moses import CostModelConfig as JCfg  # noqa: E402
from repro.core import cost_model as jcm  # noqa: E402
from repro.core import lottery as jlot  # noqa: E402
from repro_torch.autotune.dataset import generate_records  # noqa: E402
from repro_torch.autotune.tasks import resnet18_tasks  # noqa: E402
from repro_torch.configs.moses import CostModelConfig as TCfg  # noqa: E402
from repro_torch.core import convert  # noqa: E402
from repro_torch.core import cost_model as tcm  # noqa: E402
from repro_torch.core import lottery as tlot  # noqa: E402

CFG = dict(hidden_dims=(32, 32), batch_size=64, rank_pairs_per_batch=256)


def np_tree(tree):
    return {k: np.asarray(v, np.float32) for k, v in tree.items()}


def t_tree(tree):
    return {k: v.detach().cpu().numpy() for k, v in tree.items()}


def assert_tree_close(got, want, rtol=0.0, atol=0.0, rel_atol=0.0,
                      skip=()):
    """rel_atol scales with the largest magnitude over the whole tree."""
    assert sorted(got) == sorted(want)
    top = max(float(np.abs(np.asarray(w)).max()) for w in want.values())
    for k in want:
        if k in skip:
            continue
        w = np.asarray(want[k], np.float32)
        tol = atol + rel_atol * top
        np.testing.assert_allclose(np.asarray(got[k]), w, rtol=rtol, atol=tol,
                                   err_msg=k)


@pytest.fixture(scope="module")
def records():
    """Real 164-d features of ResNet-18 configs on the source device."""
    return generate_records(resnet18_tasks()[:5], "tpu_v5p",
                            programs_per_task=8, seed=2)


@pytest.fixture(scope="module")
def jparams():
    return jcm.init_mlp_params(JCfg(**CFG), jax.random.PRNGKey(0))


def test_converted_params_score_the_same(records, jparams):
    want = jcm.predict(jparams, records.x)
    tp = convert.cost_model_params(np_tree(jparams), "cpu")
    got = tcm.predict(tp, records.x)
    np.testing.assert_allclose(got, want, rtol=1e-5,
                               atol=1e-5 * np.abs(want).max())
    model = tcm.resolve_cost_model("mlp", TCfg(**CFG), "cpu")
    np.testing.assert_array_equal(model.batched_predict(tp, records.x), got)
    assert model.batched_predict(tp, records.x[:0]).shape == (0,)


def _jax_pairs(key, batch_len, n_pairs):
    """The pair indices `repro.core.cost_model.pairwise_rank_loss` draws."""
    k1, k2 = jax.random.split(key)
    return (np.asarray(jax.random.randint(k1, (n_pairs,), 0, batch_len)),
            np.asarray(jax.random.randint(k2, (n_pairs,), 0, batch_len)))


def test_one_train_step_matches(records, jparams):
    """One epoch over 40 records is one bucket-padded batch (64 rows)."""
    seed = 3
    sub = records.x[:40], records.y[:40], records.g[:40]
    jrec = jcm.Records(*sub)
    trec = tcm.Records(*sub)
    jcfg, tcfg = JCfg(**CFG), TCfg(**CFG)
    want, jlosses = jcm.train_cost_model(jparams, jrec, jcfg, epochs=1,
                                         seed=seed, pad=True)
    # the key the reference's training loop hands its only batch
    _, key = jax.random.split(jax.random.PRNGKey(seed))
    pairs = _jax_pairs(key, 64, jcfg.rank_pairs_per_batch)

    batches = list(trec.batches(tcfg.batch_size, np.random.RandomState(seed),
                                pad=True, torch_device="cpu"))
    assert len(batches) == 1 and batches[0]["x"].shape[0] == 64
    batch = batches[0]
    tp = convert.cost_model_params(np_tree(jparams), "cpu")

    jbatch = next(jrec.batches(jcfg.batch_size, np.random.RandomState(seed),
                               pad=True))
    jloss, jgrads = jcm._loss_and_grad(jparams, jbatch, key, "rank",
                                       jcfg.rank_pairs_per_batch)
    tloss, tgrads = tcm.loss_and_grad(
        lambda p: tcm.model_loss(p, batch, None, "rank",
                                 tcfg.rank_pairs_per_batch, pairs=pairs), tp)
    np.testing.assert_allclose(float(tloss), float(jloss), rtol=1e-5)
    assert_tree_close(t_tree(tgrads), np_tree(jgrads), rtol=1e-4,
                      rel_atol=1e-5)

    new, opt, loss = tcm.train_step(tp, tcm.adam_init(tp), batch, tcfg,
                                    tcfg.lr, pairs=pairs)
    assert opt.count == 1
    np.testing.assert_allclose(float(loss), jlosses[0], rtol=1e-5)
    g_top = max(float(np.abs(np.asarray(g)).max()) for g in jgrads.values())
    got_new, want_new = t_tree(new), np_tree(want)
    for k, p0 in np_tree(jparams).items():
        signed = np.abs(np.asarray(jgrads[k])) > 1e-5 * g_top
        np.testing.assert_allclose(got_new[k][signed], want_new[k][signed],
                                   rtol=0, atol=2e-6, err_msg=k)
        for side in (got_new[k], want_new[k]):
            assert np.abs(side - p0)[~signed].max(initial=0) <= tcfg.lr
    # the input params are never modified
    assert_tree_close(t_tree(tp), np_tree(jparams))


def test_pair_fold_lands_on_real_rows():
    scores = torch.arange(8, dtype=torch.float32)
    labels = torch.arange(8, dtype=torch.float32)
    g = torch.tensor([0, 0, 0, -1, -1, -1, -1, -1])
    valid = torch.tensor([1, 1, 1, 0, 0, 0, 0, 0], dtype=torch.float32)
    ii, jj = np.array([0, 3, 7, 5]), np.array([1, 4, 2, 6])
    # folded onto the 3 real rows: (0,1) (0,1) (1,2) (2,0), margins 1 1 1 2
    got = tcm.pairwise_rank_loss(scores, labels, g, valid=valid,
                                 pairs=(ii, jj))
    assert float(got) == pytest.approx(
        (3 * np.log1p(np.exp(-1.0)) + np.log1p(np.exp(-2.0))) / 4)
    # and with the pairs JAX draws, the same loss as the reference
    key = jax.random.PRNGKey(4)
    want = jcm.pairwise_rank_loss(
        jax.numpy.asarray(scores.numpy()), jax.numpy.asarray(labels.numpy()),
        jax.numpy.asarray(g.numpy()), key, 16,
        valid=jax.numpy.asarray(valid.numpy()))
    got = tcm.pairwise_rank_loss(scores, labels, g, valid=valid,
                                 pairs=_jax_pairs(key, 8, 16))
    assert float(got) == pytest.approx(float(want), rel=1e-6)


def test_npz_round_trip_across_packages(tmp_path, jparams):
    jpath = str(tmp_path / "ref.npz")
    jcm.MLPCostModel(JCfg(**CFG)).save(jparams, jpath, meta={"round": 1})
    model = tcm.resolve_cost_model("mlp", TCfg(**CFG), "cpu")
    tp = model.load(jpath)
    assert_tree_close(t_tree(tp), np_tree(jparams))
    assert_tree_close(t_tree(convert.cost_model_params_from_npz(jpath, "cpu")),
                      np_tree(jparams))
    _, meta = tcm.load_params(jpath, "cpu")
    assert meta == {"model": "mlp", "round": 1}

    tpath = str(tmp_path / "port.npz")
    model.save(tp, tpath, meta={"round": 2})
    back, meta = jcm.load_params(tpath)
    assert meta == {"model": "mlp", "round": 2}
    assert_tree_close(np_tree(back), np_tree(jparams))
    assert jcm.MLPCostModel(JCfg(**CFG)).load(tpath).keys() == tp.keys()


def test_convert_checks_structure(jparams):
    tree = np_tree(jparams)
    with pytest.raises(ValueError):
        convert.cost_model_params({k: v for k, v in tree.items()
                                   if k != "b1"}, "cpu")
    disc = {"w0": np.zeros((32, 8)), "b0": np.zeros(8),
            "w1": np.zeros((8, 1)), "b1": np.zeros(1)}
    td = convert.discriminator_params(disc, "cpu")
    assert td["w0"].dtype == torch.float32 and td["w1"].shape == (8, 1)
    with pytest.raises(ValueError):
        convert.discriminator_params(tree, "cpu")


def test_train_reduces_loss(records):
    model = tcm.resolve_cost_model("mlp", TCfg(**CFG), "cpu")
    p0 = model.init(0)
    p1, losses = model.train(p0, records, epochs=6)
    assert losses[-1] < losses[0]
    assert tcm.rank_correlation(p1, records, model.predict) > \
        tcm.rank_correlation(p0, records, model.predict)
    # a seed gives the same params wherever they live
    assert_tree_close(t_tree(model.init(0)), t_tree(p0))


@pytest.mark.parametrize("ratio", [0.01, 0.3, 0.5, 0.7])
def test_mask_by_ratio_matches_with_ties(ratio):
    rng = np.random.RandomState(int(ratio * 100))
    scores = {"w0": rng.randint(0, 5, (16, 7)).astype(np.float32),
              "b0": np.zeros(7, np.float32),
              "w1": rng.rand(7, 1).astype(np.float32), "b1": np.ones(1,
                                                                   np.float32)}
    want = jlot.mask_by_ratio({k: jax.numpy.asarray(v)
                               for k, v in scores.items()}, ratio)
    got = tlot.mask_by_ratio({k: torch.as_tensor(v)
                              for k, v in scores.items()}, ratio)
    for k in scores:
        np.testing.assert_array_equal(got[k].numpy(), np.asarray(want[k]))


@pytest.mark.parametrize("theta", [0.1, 0.5])
def test_mask_by_threshold_and_degenerate_scores(theta):
    rng = np.random.RandomState(1)
    scores = {"w0": rng.rand(5, 3).astype(np.float32),
              "b0": rng.rand(3).astype(np.float32)}
    flat = {"w0": np.full((5, 3), 0.25, np.float32),
            "b0": np.full(3, 0.25, np.float32)}
    for tree in (scores, flat):
        want = jlot.mask_by_threshold({k: jax.numpy.asarray(v)
                                       for k, v in tree.items()}, theta)
        got = tlot.mask_by_threshold({k: torch.as_tensor(v)
                                      for k, v in tree.items()}, theta)
        for k in tree:
            np.testing.assert_array_equal(got[k].numpy(), np.asarray(want[k]))
    assert all(float(m.min()) == 1.0 for m in tlot.mask_by_threshold(
        {k: torch.as_tensor(v) for k, v in flat.items()}, theta).values())


def test_entry_points_raise_without_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="torch_device='cpu'"):
        tcm.resolve_cost_model("mlp")
    with pytest.raises(RuntimeError):
        tcm.MLPCostModel(TCfg(**CFG))
    model = tcm.resolve_cost_model("mlp", TCfg(**CFG), "cpu")
    with pytest.raises(RuntimeError):
        tcm.resolve_cost_model(model)  # a CPU instance, asked for on "cuda"


# --- the residual MLP ("residual-mlp") -------------------------------------

RES = dict(width=32, depth=2)


@pytest.fixture(scope="module")
def jres():
    model = jcm.ResidualMLPCostModel(JCfg(**CFG), **RES)
    return model, model.init(jax.random.PRNGKey(5))


def test_residual_mlp_registered_like_the_reference():
    model = tcm.resolve_cost_model("residual-mlp", TCfg(**CFG), "cpu")
    ref = jcm.resolve_cost_model("residual-mlp", JCfg(**CFG))
    assert isinstance(model, tcm.ResidualMLPCostModel)
    assert (model.width, model.depth, model.hidden_dim) == \
        (ref.width, ref.depth, ref.hidden_dim) == (256, 3, 256)
    p, jp = model.init(0), ref.init(jax.random.PRNGKey(0))
    assert {k: tuple(v.shape) for k, v in p.items()} == \
        {k: tuple(v.shape) for k, v in jp.items()}
    assert float(p["b_in"].abs().max()) == float(p["b_out"].abs().max()) == 0


def test_residual_mlp_forward_and_predict_match(records, jres):
    jmodel, jparams = jres
    model = tcm.ResidualMLPCostModel(TCfg(**CFG), torch_device="cpu", **RES)
    tp = convert.cost_model_params(np_tree(jparams), "cpu")
    want = jmodel.predict(jparams, records.x)
    got = model.predict(tp, records.x)
    np.testing.assert_allclose(got, want, rtol=1e-5,
                               atol=1e-5 * np.abs(want).max())
    np.testing.assert_allclose(model.batched_predict(tp, records.x),
                               jmodel.batched_predict(jparams, records.x),
                               rtol=1e-5, atol=1e-5 * np.abs(want).max())
    score, hidden = model.forward(tp, torch.as_tensor(records.x),
                                  return_hidden=True)
    jscore, jhidden = jmodel.forward(jparams, jax.numpy.asarray(records.x),
                                     return_hidden=True)
    assert hidden.shape == (len(records.x), model.hidden_dim)
    np.testing.assert_allclose(hidden.numpy(), np.asarray(jhidden),
                               rtol=1e-5,
                               atol=1e-5 * float(np.abs(jhidden).max()))
    # depth is read back from the params: a 3-block tree scores as the
    # reference scores it, whatever the instance's depth
    deep = jcm.ResidualMLPCostModel(JCfg(**CFG), width=32, depth=3)
    jdeep = deep.init(jax.random.PRNGKey(6))
    np.testing.assert_allclose(
        model.predict(convert.cost_model_params(np_tree(jdeep), "cpu"),
                      records.x[:8]),
        deep.predict(jdeep, records.x[:8]), rtol=1e-5, atol=1e-5)


def test_residual_mlp_one_training_epoch_matches(records, jres):
    """One epoch of 40 records (one bucket-padded batch of 64) with the
    pairs JAX draws: loss, gradients and the Adam step as the MLP's."""
    jmodel, jparams = jres
    seed = 7
    sub = records.x[:40], records.y[:40], records.g[:40]
    jcfg, tcfg = JCfg(**CFG), TCfg(**CFG)
    want, jlosses = jcm.train_cost_model(jparams, jcm.Records(*sub), jcfg,
                                         epochs=1, seed=seed, pad=True,
                                         forward=jmodel.forward)
    _, key = jax.random.split(jax.random.PRNGKey(seed))
    pairs = _jax_pairs(key, 64, jcfg.rank_pairs_per_batch)
    model = tcm.ResidualMLPCostModel(tcfg, torch_device="cpu", **RES)
    tp = convert.cost_model_params(np_tree(jparams), "cpu")
    (batch,) = list(tcm.Records(*sub).batches(
        tcfg.batch_size, np.random.RandomState(seed), pad=True,
        torch_device="cpu"))
    jbatch = next(jcm.Records(*sub).batches(
        jcfg.batch_size, np.random.RandomState(seed), pad=True))
    _, jgrads = jcm._loss_and_grad(jparams, jbatch, key, "rank",
                                   jcfg.rank_pairs_per_batch, jmodel.forward)
    tloss, tgrads = tcm.loss_and_grad(
        lambda p: tcm.model_loss(p, batch, None, "rank",
                                 tcfg.rank_pairs_per_batch, model.forward,
                                 pairs=pairs), tp)
    np.testing.assert_allclose(float(tloss), jlosses[0], rtol=1e-5)
    assert_tree_close(t_tree(tgrads), np_tree(jgrads), rtol=1e-4,
                      rel_atol=1e-5)
    new, _, loss = tcm.train_step(tp, tcm.adam_init(tp), batch, tcfg,
                                  tcfg.lr, forward=model.forward,
                                  pairs=pairs)
    np.testing.assert_allclose(float(loss), jlosses[0], rtol=1e-5)
    g_top = max(float(np.abs(np.asarray(g)).max()) for g in jgrads.values())
    got_new, want_new = t_tree(new), np_tree(want)
    for k, p0 in np_tree(jparams).items():
        signed = np.abs(np.asarray(jgrads[k])) > 1e-5 * g_top
        np.testing.assert_allclose(got_new[k][signed], want_new[k][signed],
                                   rtol=0, atol=2e-6, err_msg=k)
        for side in (got_new[k], want_new[k]):
            assert np.abs(side - p0)[~signed].max(initial=0) <= tcfg.lr


def test_residual_mlp_npz_round_trip_and_structure(tmp_path, jres):
    jmodel, jparams = jres
    jpath = str(tmp_path / "res.npz")
    jmodel.save(jparams, jpath)
    model = tcm.resolve_cost_model("residual-mlp", TCfg(**CFG), "cpu")
    assert_tree_close(t_tree(model.load(jpath)), np_tree(jparams))
    assert_tree_close(t_tree(convert.cost_model_params_from_npz(jpath,
                                                                "cpu")),
                      np_tree(jparams))
    with pytest.raises(ValueError, match="not 'mlp'"):
        tcm.resolve_cost_model("mlp", TCfg(**CFG), "cpu").load(jpath)
    tree = np_tree(jparams)
    for broken in ({k: v for k, v in tree.items() if k != "b_out"},
                   {**tree, "w1": np.zeros((32, 8), np.float32)}):
        with pytest.raises(ValueError):
            convert.cost_model_params(broken, "cpu")
