"""The port's serving path (`repro_torch.serve.Engine`,
`repro_torch.train.train_loop`'s serving steps, `repro_torch.launch.serve`)
against the reference's, on the CPU, with the reference's params carried
over.

Greedy tokens are compared at float32 activations, where the logits agree
within 1e-4 * max|ref| + 1e-4 * |ref| (tests/test_torch_models.py): a
token must match wherever the reference's top-2 margin exceeds twice that,
since each of the two logits may move by the tolerance. After the first
step whose margin is smaller, the two sequences may part, so the rest of
that request is not compared.
"""
import jax
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.configs import get_smoke_config as j_smoke  # noqa: E402
from repro.models import build_model as j_build  # noqa: E402
from repro.serve import Engine as JEngine  # noqa: E402
from repro.serve import Request as JRequest  # noqa: E402
from repro_torch.autotune.registry import Registry  # noqa: E402
from repro_torch.configs import get_smoke_config as t_smoke  # noqa: E402
from repro_torch.core import convert  # noqa: E402
from repro_torch.kernels import ops  # noqa: E402
from repro_torch.launch import serve as t_launch  # noqa: E402
from repro_torch.models import build_model as t_build  # noqa: E402
from repro_torch.obs import metrics as obs_metrics  # noqa: E402
from repro_torch.serve import Engine, Request  # noqa: E402
from repro_torch.train.train_loop import make_serve_step  # noqa: E402

ARCH = "recurrentgemma-2b"


def _mesh():
    try:
        return jax.make_mesh((1, 1), ("data", "model"),
                             axis_types=(jax.sharding.AxisType.Auto,) * 2)
    except (AttributeError, TypeError):  # older jax: no axis_types
        return jax.make_mesh((1, 1), ("data", "model"))


class RecordingEngine(JEngine):
    """The reference engine, keeping the logits of every sampling call."""

    def __init__(self, *a, **kw):
        super().__init__(*a, **kw)
        self.seen = []

    def _sample(self, logits, temps):
        self.seen.append(np.asarray(logits, np.float32))
        return super()._sample(logits, temps)


@pytest.fixture
def tmp_registry(tmp_path):
    old = ops.get_registry()
    ops.set_registry(Registry(str(tmp_path / "tuned.json")))
    yield
    ops.set_registry(old)


def _requests(cls, vocab):
    rng = np.random.RandomState(11)
    lens, budgets = (8, 5, 8, 3, 6), (6, 4, 6, 6, 5)
    return [cls(prompt=rng.randint(0, vocab, size=n).astype(np.int32),
                max_new_tokens=m) for n, m in zip(lens, budgets)]


def test_engine_greedy_tokens_match_reference():
    """Three waves of two slots, prompts of different lengths (left-padded)
    and different budgets."""
    jcfg = j_smoke(ARCH).replace(activation_dtype="float32")
    tcfg = t_smoke(ARCH).replace(activation_dtype="float32")
    jmodel, tmodel = j_build(jcfg), t_build(tcfg)
    jp = jmodel.init(jax.random.PRNGKey(0))
    tp = convert.model_params(jax.tree.map(np.asarray, jp), "cpu")
    jeng = RecordingEngine(jmodel, jp, _mesh(), max_len=24, batch_slots=2)
    teng = Engine(tmodel, tp, max_len=24, batch_slots=2)
    jreqs = jeng.generate(_requests(JRequest, jcfg.vocab_size))
    treqs = teng.generate(_requests(Request, tcfg.vocab_size))
    assert [len(r.out_tokens) for r in treqs] == [6, 4, 6, 6, 5]
    assert all(r.done for r in treqs)

    # sampling calls per wave: the wave's largest budget (no EOS)
    calls, compared = iter(jeng.seen), 0
    for w in range(0, len(jreqs), 2):
        wave = jreqs[w:w + 2]
        logits = [next(calls) for _ in range(max(r.max_new_tokens
                                                 for r in wave))]
        for i, (jr, tr) in enumerate(zip(wave, treqs[w:w + 2])):
            for k, tok in enumerate(jr.out_tokens):
                row = np.sort(logits[k][i])
                tol = 1e-4 * np.abs(logits[k][i]).max() + 1e-4 * abs(row[-1])
                if row[-1] - row[-2] <= 2 * tol:
                    break
                assert tr.out_tokens[k] == tok, (w + i, k)
                compared += 1
    assert compared >= 20, compared  # of 27 tokens


def test_engine_profiling_leaves_per_kernel_histograms(tmp_registry):
    """The mirror of the reference's TestEngineProfiling: one decode run
    with profiling on leaves timing histograms for all three kernels plus
    engine-level timing."""
    cfg = t_smoke(ARCH)
    model = t_build(cfg)
    params = model.init(0, "cpu")
    reg = obs_metrics.MetricsRegistry()
    obs_metrics.push_registry(reg)
    try:
        eng = Engine(model, params, max_len=32, batch_slots=2,
                     profile_kernels=True)
        prompt = np.arange(1, 9, dtype=np.int32) % cfg.vocab_size
        eng.generate([Request(prompt=prompt, max_new_tokens=4)])
    finally:
        obs_metrics.pop_registry(reg)
    hists = reg.snapshot()["histograms"]
    for kernel in ("matmul", "attention", "scan"):
        keys = [k for k in hists
                if k.startswith("kernel.seconds") and f"kernel={kernel}" in k]
        assert keys, (kernel, sorted(hists))
    assert hists["serve.engine.prefill_seconds"]["count"] == 1
    assert hists["serve.engine.step_seconds"]["count"] == 3
    assert reg.snapshot()["counters"]["serve.engine.tokens"] == 4.0


def test_engine_sampling_is_seeded():
    cfg = t_smoke(ARCH)
    model = t_build(cfg)
    params = model.init(0, "cpu")

    def run(seed):
        reqs = [Request(prompt=np.arange(1, 7, dtype=np.int32),
                        max_new_tokens=5, temperature=t) for t in (1.0, 0.0)]
        return [r.out_tokens for r in Engine(model, params, max_len=16,
                                             seed=seed).generate(reqs)]

    a, b = run(3), run(3)
    assert a == b
    greedy = Engine(model, params, max_len=16).generate(
        [Request(prompt=np.arange(1, 7, dtype=np.int32), max_new_tokens=5)])
    assert a[1] == greedy[0].out_tokens  # temperature 0 is greedy


def test_distributed_cache_raises():
    model = t_build(t_smoke(ARCH))
    with pytest.raises(NotImplementedError, match="Queue 1 item 12"):
        make_serve_step(model, distributed_cache=True)
    with pytest.raises(NotImplementedError, match="Queue 1 item 12"):
        Engine(model, model.init(0, "cpu"), distributed_cache=True)


@pytest.mark.parametrize("arch", ["recurrentgemma-2b", "h2o-danube-1.8b"])
def test_launch_serve_smoke_on_cpu(arch, capsys):
    reqs = t_launch.main(["--arch", arch, "--smoke", "--torch-device", "cpu",
                          "--requests", "3", "--prompt-len", "6",
                          "--max-new", "4", "--batch-slots", "2"])
    assert [len(r.out_tokens) for r in reqs] == [4, 4, 4]
    assert "served 3 requests, 12 tokens" in capsys.readouterr().out


def test_launch_serve_defaults_to_the_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        t_launch.main(["--arch", ARCH, "--smoke"])


def test_launch_serve_production_mesh_raises():
    with pytest.raises(NotImplementedError, match="Queue 1 item 12"):
        t_launch.main(["--arch", ARCH, "--smoke", "--torch-device", "cpu",
                       "--production-mesh"])


def test_launch_serve_unported_arch_raises():
    with pytest.raises(NotImplementedError, match="Queue 1 item 11"):
        t_launch.main(["--arch", "xlstm-350m", "--smoke", "--torch-device",
                       "cpu"])
