"""The port's training substrate against the reference on the CPU: AdamW
and its schedules, the data pipeline, checkpoints (each package restores
what the other wrote), the fault-tolerant loop and the training launcher.
Inputs are numpy arrays from a seed; tolerances are float32's,
|err| <= 1e-4 * max|ref| + 1e-4 * |ref|, unless a test says otherwise."""
import importlib.util
import io
import math
import os
import types
from pathlib import Path
from contextlib import redirect_stdout

import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.configs import ARCH_IDS  # noqa: E402
from repro.configs import get_config as j_config  # noqa: E402
from repro.configs import get_smoke_config as j_smoke  # noqa: E402
from repro.models import build_model as j_build  # noqa: E402
from repro.train import checkpoint as j_ckpt  # noqa: E402
from repro.train import data as j_data  # noqa: E402
from repro.train import optimizer as j_opt  # noqa: E402
from repro.train import train_loop as j_loop  # noqa: E402
from repro_torch.configs import get_config as t_config  # noqa: E402
from repro_torch.configs import get_smoke_config as t_smoke  # noqa: E402
from repro_torch.core import convert  # noqa: E402
from repro_torch.kernels import flash_attention as t_fa  # noqa: E402
from repro_torch.kernels import matmul as t_mm  # noqa: E402
from repro_torch.kernels import rg_lru as t_lru  # noqa: E402
from repro_torch.launch import train as t_launch  # noqa: E402
from repro_torch.models import build_model as t_build  # noqa: E402
from repro_torch.obs import metrics as obs_metrics  # noqa: E402
from repro_torch.train import checkpoint as t_ckpt  # noqa: E402
from repro_torch.train import data as t_data  # noqa: E402
from repro_torch.train import optimizer as t_opt  # noqa: E402
from repro_torch.train import train_loop as t_loop  # noqa: E402


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


def close(got, ref, what=""):
    got, ref = f32(got), f32(ref)
    assert got.shape == ref.shape, (what, got.shape, ref.shape)
    err = np.abs(got - ref)
    tol = 1e-4 * np.abs(ref).max() + 1e-4 * np.abs(ref)
    assert (err <= tol).all(), f"{what}: max err {err.max()}"


# ---------------------------------------------------------------------------
# AdamW and its schedules
# ---------------------------------------------------------------------------


def test_cosine_and_constant_schedules_match_reference():
    jl, tl = (j_opt.cosine_schedule(1e-3, 10, 100),
              t_opt.cosine_schedule(1e-3, 10, 100))
    for step in (0, 1, 5, 9, 10, 11, 50, 99, 100, 150):
        got = tl(torch.tensor(step, dtype=torch.int32))
        assert got.dtype == torch.float32
        close(got, jl(jnp.asarray(step, jnp.int32)), f"cosine at {step}")
    assert float(t_opt.constant_schedule(3e-4)(torch.tensor(7))) == \
        float(j_opt.constant_schedule(3e-4)(jnp.asarray(7)))


# (AdamWConfig fields, param dtype): the reference's defaults; the
# launcher's weight decay and schedule; no clipping; bf16 params with bf16
# moments and a float32 master copy
OPT_CASES = {
    "default": ({}, "float32"),
    "cosine-wd": (dict(weight_decay=0.01, grad_clip_norm=1.0), "float32"),
    "no-clip": (dict(grad_clip_norm=0.0, b2=0.999), "float32"),
    "bf16-master": (dict(moment_dtype="bfloat16", master_fp32=True,
                         weight_decay=0.1), "bfloat16"),
}


def _opt_inputs(dtype, rng):
    shapes = {"w": (5, 7), "blk": {"b": (7,), "s": (3, 2, 4)}}

    def draw(scale):
        def leaf(shape):
            return (rng.randn(*shape) * scale).astype(np.float32)
        return {"w": leaf(shapes["w"]),
                "blk": {k: leaf(v) for k, v in shapes["blk"].items()}}
    params = draw(1.0)
    if dtype == "bfloat16":
        params = jax.tree.map(lambda x: np.asarray(
            jnp.asarray(x, jnp.bfloat16)), params)
    return params, [draw(s) for s in (0.1, 3.0, 0.01, 1.0)]


@pytest.mark.parametrize("case", sorted(OPT_CASES))
def test_adamw_update_matches_reference(case):
    """Four updates from the same gradients (clipped and not): params,
    moments in their dtype, the master copy, the count and the metrics."""
    fields, dtype = OPT_CASES[case]
    lr = (j_opt.cosine_schedule(1e-2, 2, 4), t_opt.cosine_schedule(1e-2, 2, 4)
          ) if case == "cosine-wd" else (5e-2, 5e-2)
    jo = j_opt.AdamW(j_opt.AdamWConfig(lr=lr[0], **fields))
    to = t_opt.AdamW(t_opt.AdamWConfig(lr=lr[1], **fields))
    params, grads = _opt_inputs(dtype, np.random.RandomState(0))
    jp, js = params, jo.init(params)
    tp = convert.model_params(params, "cpu")
    ts = to.init(tp)
    assert sorted(ts) == sorted(js)
    ids = {id(t) for t in flat(tp).values()}
    for i, g in enumerate(grads):
        jp, js, jm = jo.update(g, js, jp)
        tp2, ts2, tm = to.update(convert.model_params(g, "cpu"), ts, tp)
        # in place: the same tensors come back, holding the new values
        assert tp2 is tp and ts2 is ts
        assert {id(t) for t in flat(tp).values()} == ids
        assert int(ts["count"]) == int(js["count"]) == i + 1
        assert ts["count"].dtype == torch.int32
        for k in ("grad_norm", "lr"):
            close(tm[k], jm[k], f"step {i} {k}")
        for name, want, got in (("params", jp, tp), ("m", js["m"], ts["m"]),
                                ("v", js["v"], ts["v"])):
            for key, w in flat(want).items():
                t = flat(got)[key]
                assert str(t.dtype) == f"torch.{w.dtype}", (name, key)
                if w.dtype == jnp.bfloat16:  # within one bf16 ulp
                    w32 = f32(w)
                    ulp = 2.0 ** (np.floor(np.log2(np.maximum(
                        np.abs(w32), 1e-30))) - 7)
                    assert (np.abs(f32(t) - w32) <= ulp).all(), (name, key)
                else:
                    close(t, w, f"step {i} {name}{key}")
        if "master" in js:
            for key, w in flat(js["master"]).items():
                close(flat(ts["master"])[key], w, f"master{key}")


def test_grad_clipping_reports_the_norm_before_clipping():
    opt = t_opt.AdamW(t_opt.AdamWConfig(lr=1e-3, grad_clip_norm=1.0))
    params = {"w": torch.zeros(4)}
    _, state, m = opt.update({"w": torch.full((4,), 100.0)},
                             opt.init(params), params)
    assert float(m["grad_norm"]) == pytest.approx(200.0)
    # the first moment holds 0.1 x the clipped gradient (norm 1)
    np.testing.assert_allclose(state["m"]["w"].numpy(), 0.1 * 0.5,
                               rtol=1e-6)


# ---------------------------------------------------------------------------
# Data
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_data_iterator_is_the_reference_bit_for_bit(arch):
    """Tokens, targets and the stub frontends' inputs (whisper's encoder
    frames, the VLM's frontend embeddings), three batches each."""
    cfg = t_smoke(arch)
    dc = dict(batch_size=3, seq_len=10, seed=4, host_id=1, num_hosts=2)
    ref = j_data.data_iterator(j_smoke(arch), j_data.DataConfig(**dc))
    got = t_data.data_iterator(cfg, t_data.DataConfig(**dc))
    for _ in range(3):
        a, b = next(ref), next(got)
        assert sorted(a) == sorted(b)
        for k in a:
            assert a[k].dtype == b[k].dtype, k
            np.testing.assert_array_equal(b[k], a[k])
    assert ("encoder_embeddings" in b) == cfg.is_encoder_decoder
    assert ("frontend_embeddings" in b) == (cfg.cross_attn_every > 0)


# ---------------------------------------------------------------------------
# Checkpoints
# ---------------------------------------------------------------------------


def _tree():
    return {"a": torch.arange(6, dtype=torch.int32).reshape(2, 3),
            "b": {"c": torch.linspace(-2, 2, 5).to(torch.bfloat16),
                  "z": torch.randn(3, generator=torch.Generator()
                                   .manual_seed(0))},
            "step": torch.tensor(7, dtype=torch.int32)}


def _equal(a, b):
    fa, fb = flat(a), flat(b)
    assert sorted(fa) == sorted(fb)
    for k in fa:
        assert fa[k].dtype == fb[k].dtype and torch.equal(fa[k], fb[k]), k


def test_checkpoint_roundtrip_keep_n_atomic_async(tmp_path):
    ckpt = t_ckpt.CheckpointManager(str(tmp_path), keep_n=2)
    tree = _tree()
    ckpt.save(10, tree)
    out = ckpt.restore(10, tree, torch_device="cpu")
    _equal(out, tree)
    assert list(out["b"]) == list(tree["b"])
    # keep-N
    for s in (11, 12, 13):
        ckpt.save(s, tree)
    assert ckpt.all_steps() == [12, 13] and ckpt.latest_step() == 13
    # atomic publish: no staging dir left, and one left behind by a crash
    # is neither listed nor restored from
    os.makedirs(tmp_path / "step_00000099.tmp")
    assert ckpt.latest_step() == 13
    assert not [d for d in os.listdir(tmp_path)
                if d.endswith(".tmp") and "99" not in d]
    # async: the host copy is taken at save time, so an in-place update
    # after save() does not reach the file
    actx = t_ckpt.CheckpointManager(str(tmp_path / "async"), keep_n=2,
                                    async_save=True)
    live = {"w": torch.zeros(4)}
    actx.save(5, live)
    live["w"].add_(1.0)
    actx.wait()
    assert actx.latest_step() == 5
    assert float(actx.restore(5, live, "cpu")["w"].abs().max()) == 0.0
    with pytest.raises(KeyError, match="missing leaf"):
        ckpt.restore(13, {"nope": torch.zeros(1)}, "cpu")


def test_checkpoint_paths_are_jax_paths(tmp_path):
    tree = _tree()
    paths, _ = t_ckpt.flatten_with_paths(tree)
    jpaths = ["/".join(str(k) for k in p) for p, _ in
              jax.tree_util.tree_flatten_with_path(
                  jax.tree.map(lambda t: np.zeros(t.shape), tree))[0]]
    assert paths == jpaths
    assert "['b']/['c']" in paths


def test_reference_checkpoint_restores_in_the_port(tmp_path):
    tree = _tree()
    jtree = jax.tree.map(lambda t: jnp.asarray(f32(t)).astype(
        {torch.int32: jnp.int32, torch.bfloat16: jnp.bfloat16,
         torch.float32: jnp.float32}[t.dtype]), tree)
    j_ckpt.CheckpointManager(str(tmp_path)).save(3, jtree)
    out = t_ckpt.CheckpointManager(str(tmp_path)).restore(3, tree, "cpu")
    _equal(out, tree)


def test_port_checkpoint_restores_in_the_reference(tmp_path):
    tree = _tree()
    t_ckpt.CheckpointManager(str(tmp_path)).save(4, tree)
    like = jax.tree.map(lambda t: jax.ShapeDtypeStruct(
        t.shape, {torch.int32: jnp.int32, torch.bfloat16: jnp.bfloat16,
                  torch.float32: jnp.float32}[t.dtype]), tree)
    out = j_ckpt.CheckpointManager(str(tmp_path)).restore(4, like)
    assert out["b"]["c"].dtype == jnp.bfloat16
    for k, v in flat(tree).items():
        np.testing.assert_array_equal(f32(flat(out)[k]), f32(v), k)


def _small_model():
    return t_smoke("xlstm-350m").replace(num_layers=2)


def test_train_state_checkpoints_cross_packages(tmp_path):
    """A whole train state (params, AdamW state with a bf16 moment tree
    and a master copy, step) written by the port restores in the
    reference into its own model's structure, and back."""
    cfg = dict(moment_dtype="bfloat16", master_fp32=True)
    jm, tm = j_build(j_smoke("xlstm-350m").replace(num_layers=2)), \
        t_build(_small_model())
    jo, to = j_opt.AdamW(j_opt.AdamWConfig(**cfg)), \
        t_opt.AdamW(t_opt.AdamWConfig(**cfg))
    state = t_loop.init_train_state(tm, to, 0, "cpu")
    state["step"].fill_(12)
    t_ckpt.CheckpointManager(str(tmp_path / "p")).save(12, state)
    like = jax.eval_shape(lambda r: {
        "params": jm.init(r), "opt": jo.init(jm.init(r)),
        "step": jnp.zeros((), jnp.int32)}, jax.random.PRNGKey(0))
    jstate = j_ckpt.CheckpointManager(str(tmp_path / "p")).restore(12, like)
    assert int(jstate["step"]) == 12
    j_ckpt.CheckpointManager(str(tmp_path / "j")).save(12, jstate)
    back = t_ckpt.CheckpointManager(str(tmp_path / "j")).restore(
        12, t_loop.abstract_train_state(tm, to), "cpu")
    _equal(back, state)


# ---------------------------------------------------------------------------
# The fault-tolerant loop
# ---------------------------------------------------------------------------


def _loop(path, total=30, **kw):
    return t_loop.LoopConfig(total_steps=total, checkpoint_every=10,
                             checkpoint_dir=str(path), log_every=1000,
                             async_checkpoint=False, **kw)


def _data(cfg, seed=3):
    return t_data.data_iterator(cfg, t_data.DataConfig(batch_size=2,
                                                       seq_len=16, seed=seed))


def test_failure_restart_continues_identically(tmp_path):
    """The reference's own fault-tolerance case: fail at step 15, restart
    from the step-10 checkpoint with the data replayed from there, and end
    where the uninterrupted run ends."""
    cfg = _small_model()
    model = t_build(cfg)
    opt = t_opt.AdamW(t_opt.AdamWConfig(lr=1e-3))
    _, full = t_loop.run_training(model, opt, _data(cfg), _loop(
        tmp_path / "a"), log_fn=lambda s: None, torch_device="cpu")
    loop2 = _loop(tmp_path / "b")
    with pytest.raises(RuntimeError, match="simulated node failure"):
        t_loop.run_training(model, opt, _data(cfg), loop2, fail_at_step=15,
                            log_fn=lambda s: None, torch_device="cpu")
    assert t_ckpt.CheckpointManager(str(tmp_path / "b")).all_steps() == [10]
    it = _data(cfg)
    for _ in range(10):
        next(it)
    logs = []
    _, resumed = t_loop.run_training(model, opt, it, loop2,
                                     log_fn=logs.append, torch_device="cpu")
    assert logs[0].startswith("[restart] restored step 10")
    assert [h["step"] for h in resumed] == list(range(11, 31))
    assert resumed[-1]["loss"] == pytest.approx(full[-1]["loss"], rel=1e-5)
    assert all(np.isfinite(h["loss"]) for h in full)


def test_run_training_history_matches_reference(tmp_path):
    """Four steps of the port's loop and of the reference's from the same
    params and batches: each step's metrics."""
    jcfg = j_smoke("recurrentgemma-2b").replace(activation_dtype="float32")
    tcfg = t_smoke("recurrentgemma-2b").replace(activation_dtype="float32")
    jm, tm = j_build(jcfg), t_build(tcfg)
    fields = dict(lr=5e-3, weight_decay=0.01)
    jo, to = j_opt.AdamW(j_opt.AdamWConfig(**fields)), \
        t_opt.AdamW(t_opt.AdamWConfig(**fields))
    params = jax.tree.map(np.asarray, jm.init(jax.random.PRNGKey(0)))
    mesh = jax.make_mesh((1, 1), ("data", "model"),
                         axis_types=(jax.sharding.AxisType.Auto,) * 2)
    jloop = j_loop.LoopConfig(total_steps=4, checkpoint_every=10,
                              checkpoint_dir=str(tmp_path / "j"),
                              async_checkpoint=False)
    _, jh = j_loop.run_training(
        jm, jo, mesh, _data(tcfg, seed=1), jloop, log_fn=lambda s: None,
        train_state={"params": params, "opt": jo.init(params),
                     "step": jnp.zeros((), jnp.int32)})
    tp = convert.model_params(params, "cpu")
    _, th = t_loop.run_training(
        tm, to, _data(tcfg, seed=1), _loop(tmp_path / "t", total=4),
        log_fn=lambda s: None, torch_device="cpu",
        train_state={"params": tp, "opt": to.init(tp),
                     "step": torch.zeros((), dtype=torch.int32)})
    assert len(th) == len(jh) == 4
    for a, b in zip(th, jh):
        assert sorted(a) == sorted(b)
        for k in b:
            close(np.float32(a[k]), np.float32(b[k]), f"{k} at {b['step']}")


def test_straggler_hook_and_step_histogram(tmp_path, monkeypatch):
    """A step slower than straggler_factor x the window's median fires the
    hook; every step lands in train.step_seconds. The loop's clock is a
    fake that each step moves by 0.1 s, and the seventh by 1 s."""
    cfg = _small_model()
    model = t_build(cfg)
    opt = t_opt.AdamW(t_opt.AdamWConfig(lr=1e-3))
    real = t_loop.make_train_step(model, opt)
    clock, calls = [0.0], []

    def slow_on_7(m, o):
        def fn(state, batch):
            calls.append(1)
            clock[0] += 1.0 if len(calls) == 7 else 0.1
            return real(state, batch)
        return fn

    monkeypatch.setattr(t_loop, "make_train_step", slow_on_7)
    monkeypatch.setattr(t_loop, "time", types.SimpleNamespace(
        perf_counter=lambda: clock[0]))
    reg = obs_metrics.MetricsRegistry()
    obs_metrics.push_registry(reg)
    logs = []
    try:
        t_loop.run_training(model, opt, _data(cfg), _loop(
            tmp_path, total=8, straggler_window=3, straggler_factor=3.0),
            log_fn=logs.append, torch_device="cpu")
    finally:
        obs_metrics.pop_registry(reg)
    stragglers = [s for s in logs if s.startswith("[straggler]")]
    assert len(stragglers) == 1 and stragglers[0].startswith(
        "[straggler] step 6 took 1.000s"), logs
    assert reg.snapshot()["histograms"]["train.step_seconds"]["count"] == 8


def test_profile_kernels_runs_the_three_plain_versions(tmp_path, monkeypatch):
    """LoopConfig.profile_kernels runs the kernel probe once at the model's
    capped shapes: on the CPU each wrapper takes its plain version (the
    tuned and the default config), and the kernel.seconds histograms fill."""
    counts = {}
    for mod, name in ((t_mm, "matmul_plain"),
                      (t_fa, "flash_attention_plain"),
                      (t_lru, "rg_lru_plain")):
        real = getattr(mod, name)

        def counted(*a, _real=real, _name=name, **kw):
            counts[_name] = counts.get(_name, 0) + 1
            return _real(*a, **kw)
        monkeypatch.setattr(mod, name, counted)
    cfg = _small_model()
    reg = obs_metrics.MetricsRegistry()
    obs_metrics.push_registry(reg)
    try:
        t_loop.run_training(t_build(cfg), t_opt.AdamW(t_opt.AdamWConfig()),
                            _data(cfg), _loop(tmp_path, total=1,
                                              profile_kernels=True),
                            log_fn=lambda s: None, torch_device="cpu")
    finally:
        obs_metrics.pop_registry(reg)
    assert counts == {"matmul_plain": 2, "flash_attention_plain": 2,
                      "rg_lru_plain": 2}
    hists = reg.snapshot()["histograms"]
    assert sum(1 for k in hists if k.startswith("kernel.seconds")) == 6


# ---------------------------------------------------------------------------
# The launcher
# ---------------------------------------------------------------------------


def _argv(tmp_path, *extra, steps=4):
    return ["--arch", "recurrentgemma-2b", "--smoke", "--steps", str(steps),
            "--torch-device", "cpu", "--checkpoint-dir",
            str(tmp_path / "ck"), *extra]


@pytest.mark.parametrize("steps,extra", [(4, ["--opt", "none"]), (2, [])])
def test_launch_train_smoke_prints_final_loss(tmp_path, steps, extra):
    out = io.StringIO()
    with redirect_stdout(out):
        t_launch.main(_argv(tmp_path, *extra, steps=steps))
    last = out.getvalue().strip().splitlines()[-1]
    assert last.startswith("final loss: ")
    assert last.endswith(f"over {steps} steps")
    assert np.isfinite(float(last.split()[2]))


def test_launch_train_builds_the_reference_objects(tmp_path):
    """AdamW with the cosine schedule (warmup steps // 20), weight decay
    0.01, the config's moment dtype and a master copy for bf16 params; the
    data pipeline at --batch x --seq from --seed."""
    args = t_launch.parser().parse_args(
        ["--arch", "glm4-9b", "--steps", "40", "--batch", "4", "--seq", "8",
         "--seed", "2", "--checkpoint-dir", str(tmp_path)])
    run = t_launch.build_training(args)
    c = run.opt.cfg
    assert (c.weight_decay, c.moment_dtype, c.master_fp32) == (
        0.01, "float32", True)
    assert run.model.cfg == t_config("glm4-9b")
    assert run.loop.total_steps == 40
    jl = j_opt.cosine_schedule(3e-3, 2, 40)
    for s in (1, 2, 20):
        close(c.lr(torch.tensor(s)), jl(jnp.asarray(s)), f"lr at {s}")
    batch = next(run.data)
    np.testing.assert_array_equal(batch["tokens"], next(
        j_data.data_iterator(j_config("glm4-9b"), j_data.DataConfig(
            batch_size=4, seq_len=8, seed=2)))["tokens"])


@pytest.mark.parametrize("flags", [["--production-mesh"], ["--multi-pod"],
                                   ["--model-parallel", "2"],
                                   ["--opt", "act,epmoe"]])
def test_launch_train_multi_card_flags_raise(tmp_path, flags, monkeypatch,
                                            capsys):
    """In one process: --model-parallel 2 raises because 2 does not divide
    the world of 1 (tests/test_torch_distributed.py runs it under
    torch.distributed.run); --production-mesh raises the reference's
    RuntimeError (256 ranks needed); --multi-pod without
    --production-mesh and --opt act,epmoe without a mesh change nothing,
    as in the reference, and the launcher trains on one device."""
    monkeypatch.delenv("WORLD_SIZE", raising=False)
    if flags[0] == "--model-parallel":
        with pytest.raises(ValueError, match="must divide the 1 processes"):
            t_launch.main(_argv(tmp_path, *flags))
        return
    if flags[0] == "--production-mesh":
        with pytest.raises(RuntimeError, match="needs 256 devices"):
            t_launch.main(_argv(tmp_path, *flags))
        return
    t_launch.main(_argv(tmp_path, *flags))
    assert "final loss:" in capsys.readouterr().out


def test_launch_train_defaults_to_the_card(tmp_path, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    argv = [a for a in _argv(tmp_path) if a not in ("--torch-device",
                                                    "cpu")]
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        t_launch.main(argv)


def test_chip_smoke_train_path_rehearses_on_cpu(tmp_path):
    """chip_smoke.py's `train_path` phase at the smoke config on the CPU:
    the launcher's objects, 6 steps of `run_training` with the probe on,
    one final checkpoint, the step split; no kernel launches here (the
    probe runs the plain versions)."""
    path = Path(__file__).resolve().parents[1] / "chip_smoke.py"
    spec = importlib.util.spec_from_file_location("chip_smoke", path)
    smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(smoke)
    out = smoke.drive_train_path("cpu", (t_mm, t_fa, t_lru),
                                 str(tmp_path / "ck"), smoke=True)
    assert len(out["losses"]) == smoke.TRAIN_STEPS
    assert all(math.isfinite(x) for x in out["losses"])
    assert out["checkpoint"]["steps_saved"] == ["step_00000006"]
    assert not (tmp_path / "ck").exists()
    assert out["launches"] == {"matmul": 0, "flash_attention": 0,
                               "rg_lru": 0}
    split = out["split"]
    assert split["steps_timed"] == 3 and split["profiled_steps"] == 1
    assert 0 < split["enqueue_share"] <= 1
    assert split["forward_backward_s"] > 0 and split["optimizer_s"] > 0
