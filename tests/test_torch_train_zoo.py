"""The port's training math on the LM zoo against the reference on the CPU:
`Model.loss` and its gradients, the train step (AdamW, clipping, the
schedule, gradient accumulation) and rematerialisation. Both packages get
the same numpy batch, and the reference's params carried over with
`convert.model_params`.

The reference is jitted with XLA's excess precision off
(`xla_allow_excess_precision=False`): by default XLA lets a jitted bf16
computation skip roundings its code writes (a convert to bf16 and back is
folded away), so its bf16 gradients would be those of another program; off,
it rounds where its code says, as eager JAX does.

Tolerances:
  * float32 activations: |err| <= 1e-4 * max|ref| + 1e-4 * |ref|, for the
    loss, its metrics and every gradient leaf;
  * bf16 activations: |err| <= 3e-2 * max|ref| for the loss, its metrics
    and every gradient leaf but the cross-attention gates' scalars
    (`gate_attn`, `gate_mlp`). Those get 3e-2 * max|ref| + |ref - ref32|,
    where ref32 is the reference's gradient at float32 activations: the
    added term is the reference's own bf16 rounding error. A gate's
    gradient is one sum over the whole batch that cancels, so both
    packages' bf16 values sit a few percent from the float32 one, on
    either side, and their distance can exceed 3e-2 of the value itself.
    A control holds that a port whose backward pass ran in float32 fails
    this check.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.configs import ARCH_IDS  # noqa: E402
from repro.configs import get_smoke_config as j_smoke  # noqa: E402
from repro.models import build_model as j_build  # noqa: E402
from repro.train import optimizer as j_opt  # noqa: E402
from repro.train import train_loop as j_loop  # noqa: E402
from repro_torch.configs import get_smoke_config as t_smoke  # noqa: E402
from repro_torch.core import convert  # noqa: E402
from repro_torch.models import build_model as t_build  # noqa: E402
from repro_torch.train import optimizer as t_opt  # noqa: E402
from repro_torch.train import train_loop as t_loop  # noqa: E402
from repro_torch.train.data import DataConfig, data_iterator  # noqa: E402

B, S = 2, 12


@pytest.fixture(autouse=True)
def one_torch_thread():
    """Each test runs torch on one thread: the suite runs several workers on
    the machine's cores, and a backward pass's many small ops, each spread
    over as many threads again, then spin on each other's barriers (six
    workers made the restart case 25x slower)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def flat(tree, prefix=""):
    if isinstance(tree, dict):
        out = {}
        for k, v in tree.items():
            out.update(flat(v, f"{prefix}/{k}"))
        return out
    return {prefix: tree}


def f32(x):
    if isinstance(x, torch.Tensor):
        return x.detach().float().numpy()
    return np.asarray(x, np.float32)


def close(got, ref, what, rtol=1e-4, extra=0.0):
    """|got - ref| <= rtol * max|ref| (+ rtol * |ref| when rtol is the
    float32 one) + extra, elementwise."""
    got, ref = f32(got), f32(ref)
    assert got.shape == ref.shape, (what, got.shape, ref.shape)
    assert np.isfinite(got).all(), what
    tol = rtol * np.abs(ref).max() + extra
    if rtol == 1e-4:
        tol = tol + 1e-4 * np.abs(ref)
    err = np.abs(got - ref)
    assert (err <= tol).all(), f"{what}: max err {err.max()} " \
                               f"at max|ref| {np.abs(ref).max()}"


def strict_jit(fn, *args):
    """`fn` jitted and compiled for `args` with XLA's excess precision
    off, so that it rounds where its code says."""
    return jax.jit(fn).lower(*args).compile(
        compiler_options={"xla_allow_excess_precision": False})


def _cfgs(arch, **kw):
    return j_smoke(arch).replace(**kw), t_smoke(arch).replace(**kw)


def _batch(cfg, batch=B, seq=S, seed=0):
    return next(data_iterator(cfg, DataConfig(batch_size=batch,
                                              seq_len=seq, seed=seed)))


def _jbatch(batch):
    return {k: jnp.asarray(v) for k, v in batch.items()}


def _tbatch(batch):
    return {k: torch.as_tensor(v) for k, v in batch.items()}


def port_loss_and_grads(model, params, batch):
    return t_loop.loss_and_grads(model, params, _tbatch(batch))


@pytest.fixture(scope="module")
def reference():
    """(params, batch, loss, metrics, flat grads) of the reference per
    (arch, activation dtype), from PRNGKey(0); scan_layers off, as the
    smoke configs have it."""
    cache = {}

    def get(arch, dtype):
        if (arch, dtype) not in cache:
            jcfg, _ = _cfgs(arch, activation_dtype=dtype)
            model = j_build(jcfg)
            if (arch, "float32") in cache:
                params = cache[arch, "float32"][0]
            else:
                params = jax.tree.map(np.asarray,
                                      model.init(jax.random.PRNGKey(0)))
            batch = _batch(jcfg)
            jb = _jbatch(batch)
            (loss, metrics), grads = strict_jit(
                jax.value_and_grad(model.loss, has_aux=True), params, jb)(
                params, jb)
            cache[arch, dtype] = (params, batch, loss, metrics,
                                  flat(jax.tree.map(np.asarray, grads)))
        return cache[arch, dtype]
    return get


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("arch", ARCH_IDS)
def test_loss_and_grads_match_reference(reference, arch, dtype):
    """Model.loss, its four metrics and the gradient of every param leaf
    (embeddings tied or not, stub frontends, MoE dispatch with its aux
    loss, the xLSTM loops, the RG-LRU scan) against
    `jax.value_and_grad(model.loss)`."""
    params, batch, loss, metrics, grads = reference(arch, dtype)
    _, tcfg = _cfgs(arch, activation_dtype=dtype)
    tl, tm, tg = port_loss_and_grads(
        t_build(tcfg), convert.model_params(params, "cpu"), batch)
    rtol = 1e-4 if dtype == "float32" else 3e-2
    close(tl, loss, "loss", rtol)
    assert sorted(tm) == sorted(metrics) == ["aux", "ce", "ppl_proxy",
                                             "zloss"]
    for k in metrics:
        close(tm[k], metrics[k], k, rtol)
    tflat = flat(tg)
    assert sorted(tflat) == sorted(grads)
    ref32 = reference(arch, "float32")[4]
    for k, want in grads.items():
        assert str(tflat[k].dtype) == f"torch.{want.dtype}", k
        close(tflat[k], want, f"grad {k}", rtol, _gate_extra(k, want, ref32)
              if dtype == "bfloat16" else 0.0)


def _gate_extra(key, ref, ref32):
    """The bf16 check's added term: the reference's own bf16 rounding
    error, on the cross-attention gates' scalars only."""
    if key.rsplit("/", 1)[-1] in ("gate_attn", "gate_mlp"):
        return np.abs(f32(ref) - ref32[key])
    return 0.0


@pytest.mark.parametrize("arch", ["dbrx-132b", "xlstm-350m"])
def test_float32_backward_fails_the_bf16_check(reference, arch):
    """Control: the port run at float32 activations, so that its backward
    pass skips the bf16 roundings the config asks for, is held against the
    reference's bf16 gradients by the bf16 check above, and some leaf
    fails it. (For the other smoke configs 3e-2 * max|ref| is wider than
    the bf16 rounding and cannot tell the two apart.)"""
    params, batch, _, _, grads = reference(arch, "bfloat16")
    ref32 = reference(arch, "float32")[4]
    _, tcfg = _cfgs(arch, activation_dtype="float32")
    _, _, tg = port_loss_and_grads(
        t_build(tcfg), convert.model_params(params, "cpu"), batch)
    tflat = flat(tg)
    failed = []
    for k, want in grads.items():
        try:
            close(tflat[k], want, k, 3e-2, _gate_extra(k, want, ref32))
        except AssertionError:
            failed.append(k)
    assert failed, "a float32 backward passed the bf16 check"


def test_loss_mask_and_padded_vocab(reference):
    """A loss_mask weights the cross entropy and the z-loss, and a vocab
    padded to its multiple (the -1e30 logits) gets zero gradient in its
    pad rows, as in the reference."""
    jcfg, tcfg = _cfgs("whisper-tiny", vocab_size=500,
                       activation_dtype="float32")
    assert jcfg.padded_vocab_size == 512
    jm = j_build(jcfg)
    params = jax.tree.map(np.asarray, jm.init(jax.random.PRNGKey(1)))
    batch = _batch(tcfg)
    batch["loss_mask"] = (np.random.RandomState(2).rand(B, S) < 0.6
                          ).astype(np.float32)
    jb = _jbatch(batch)
    (loss, metrics), grads = strict_jit(
        jax.value_and_grad(jm.loss, has_aux=True), params, jb)(params, jb)
    tl, tm, tg = port_loss_and_grads(
        t_build(tcfg), convert.model_params(params, "cpu"), batch)
    close(tl, loss, "masked loss")
    close(tm["zloss"], metrics["zloss"], "masked zloss")
    close(tg["embed"], grads["embed"], "embed grad")
    assert float(tg["embed"][500:].abs().max()) == 0.0


# ---------------------------------------------------------------------------
# The train step
# ---------------------------------------------------------------------------

# (arch, config overrides, AdamW overrides): the hybrid stack with its
# stacked groups under "dots" remat; bf16 params with bf16 moments and a
# float32 master copy
STEP_CASES = {
    "recurrentgemma-2b-scan": ("recurrentgemma-2b",
                               dict(scan_layers=True, num_layers=5), {}),
    "h2o-danube-bf16-master": ("h2o-danube-1.8b",
                               dict(param_dtype="bfloat16"),
                               dict(moment_dtype="bfloat16",
                                    master_fp32=True)),
}


def _opt_pair(steps, **kw):
    cfg = dict(weight_decay=0.01, **kw)
    return (j_opt.AdamW(j_opt.AdamWConfig(
                lr=j_opt.cosine_schedule(3e-3, 1, steps), **cfg)),
            t_opt.AdamW(t_opt.AdamWConfig(
                lr=t_opt.cosine_schedule(3e-3, 1, steps), **cfg)))


def _states(jmodel, jopt, topt):
    params = jax.tree.map(np.asarray, jmodel.init(jax.random.PRNGKey(0)))
    jstate = {"params": params, "opt": jopt.init(params),
              "step": jnp.zeros((), jnp.int32)}
    tparams = convert.model_params(params, "cpu")
    tstate = {"params": tparams, "opt": topt.init(tparams),
              "step": torch.zeros((), dtype=torch.int32)}
    return params, jstate, tstate


def _mesh():
    return jax.make_mesh((1, 1), ("data", "model"),
                         axis_types=(jax.sharding.AxisType.Auto,) * 2)


def _update_mask(grad_ref):
    """Where the reference's gradient is above the float32 gradient
    tolerance: Adam moves a weight by about lr whatever its gradient's
    size, so a gradient of rounding noise may step either way."""
    g = np.abs(f32(grad_ref))
    return g > 1e-4 * g.max() + 1e-4 * g


@pytest.mark.parametrize("case", sorted(STEP_CASES))
def test_train_steps_match_reference(case):
    """Three steps of make_train_step: each step's loss, metrics, grad
    norm and learning rate; after the first, the moments, the count and
    each param's update where the gradient is above its tolerance (the
    master copy's, and the bf16 params within one bf16 ulp)."""
    arch, over, opt_over = STEP_CASES[case]
    jcfg, tcfg = _cfgs(arch, activation_dtype="float32", **over)
    jm, tm = j_build(jcfg), t_build(tcfg)
    jopt, topt = _opt_pair(3, moment_dtype=opt_over.get(
        "moment_dtype", "float32"), master_fp32=opt_over.get(
        "master_fp32", False))
    params, jstate, tstate = _states(jm, jopt, topt)
    jstep = j_loop.make_train_step(jm, jopt, _mesh(), donate=False)
    tstep = t_loop.make_train_step(tm, topt)
    batches = list(zip(range(3), data_iterator(tcfg, DataConfig(
        batch_size=B, seq_len=S, seed=5))))
    grad1 = flat(jax.tree.map(np.asarray, jax.jit(jax.grad(
        lambda p, b: jm.loss(p, b)[0]))(params, _jbatch(batches[0][1]))))
    before = {k: f32(v).copy() for k, v in flat(tstate["params"]).items()}
    for i, batch in batches:
        jstate, jmet = jstep(jstate, _jbatch(batch))
        tstate, tmet = tstep(tstate, batch)
        assert sorted(tmet) == sorted(jmet)
        for k in jmet:
            close(tmet[k], jmet[k], f"step {i} {k}")
        if i:
            continue
        assert int(tstate["step"]) == 1 == int(tstate["opt"]["count"])
        for part in ("m", "v"):
            tf, jf = flat(tstate["opt"][part]), flat(jstate["opt"][part])
            for k in jf:
                assert str(tf[k].dtype) == f"torch.{jf[k].dtype}", k
                close(tf[k], jf[k], f"{part} {k}",
                      1e-4 if jf[k].dtype == jnp.float32 else 1 / 128)
        master = "master" in jstate["opt"]
        tp = flat(tstate["opt"]["master"] if master else tstate["params"])
        jp = flat(jstate["opt"]["master"] if master else jstate["params"])
        for k, g in grad1.items():
            mask = _update_mask(g)
            want = f32(jp[k]) - before[k]
            got = f32(tp[k]) - before[k]
            close(got[mask], want[mask], f"update {k}")
            if master:  # the bf16 params: the master rounded
                got_p = f32(flat(tstate["params"])[k])
                want_p = f32(flat(jstate["params"])[k])
                ulp = 2.0 ** (np.floor(np.log2(np.maximum(
                    np.abs(want_p), 1e-30))) - 7)
                assert (np.abs(got_p - want_p)[mask] <= ulp[mask]).all(), k


def test_microbatches_match_reference():
    """microbatches=2 accumulates float32 gradients over the two halves
    of the batch and averages them, as the reference's scan does: the
    loss and grad norm, and the first moment (0.1 x the clipped mean
    gradient) of every leaf."""
    jcfg, tcfg = _cfgs("deepseek-v3-671b", activation_dtype="float32")
    jm, tm = j_build(jcfg), t_build(tcfg)
    jopt, topt = _opt_pair(1)
    _, jstate, tstate = _states(jm, jopt, topt)
    batch = _batch(tcfg, batch=4, seed=9)
    jstate, jmet = j_loop.make_train_step(jm, jopt, _mesh(), microbatches=2,
                                          donate=False)(jstate,
                                                        _jbatch(batch))
    tstate, tmet = t_loop.make_train_step(tm, topt, microbatches=2)(
        tstate, batch)
    assert sorted(tmet) == sorted(jmet) == ["grad_norm", "loss", "lr"]
    for k in jmet:
        close(tmet[k], jmet[k], k)
    tm1, jm1 = flat(tstate["opt"]["m"]), flat(jstate["opt"]["m"])
    for k in jm1:
        close(tm1[k], jm1[k], f"m {k}")


@pytest.mark.parametrize("arch", ["recurrentgemma-2b", "deepseek-v3-671b"])
def test_remat_changes_no_bit(arch):
    """remat_policy none, dots and full give the same loss and gradients,
    bit for bit, on a stack with a prefix (deepseek-v3's dense layers) or
    a suffix (recurrentgemma's trailing recurrent blocks) around its
    stacked groups; none saves more for the backward pass than the
    other two, whose blocks recompute."""
    base = t_smoke(arch).replace(scan_layers=True, num_layers=5)
    params = t_build(base).init(0, "cpu")
    batch = _batch(base)
    results, saved = {}, {}
    for policy in ("none", "dots", "full"):
        packed = []

        def pack(t):
            packed.append(t.numel() * t.element_size())
            return t

        with torch.autograd.graph.saved_tensors_hooks(pack, lambda t: t):
            loss, _, grads = port_loss_and_grads(
                t_build(base.replace(remat_policy=policy)), params, batch)
        results[policy] = (loss, flat(grads))
        saved[policy] = sum(packed)
    loss0, grads0 = results["none"]
    for policy in ("dots", "full"):
        loss, grads = results[policy]
        assert torch.equal(loss, loss0), policy
        for k, g in grads0.items():
            assert torch.equal(grads[k], g), (policy, k)
        assert saved[policy] < saved["none"], saved
