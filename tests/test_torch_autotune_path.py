"""The slice as a whole: the training launcher's autotune step on
RecurrentGemma-2B in the port, its registry read by the reference, and the
tuned kernels of both packages at the model's real attention shape. The
scheduled path (`--scheduler gradient --obs DIR`) fills the registry and
writes the campaign's telemetry.

  * `maybe_autotune(dry_run=True)` runs to the end into a temporary
    registry; the JAX `Registry` reads it, and both packages'
    `tuned_flash_attention` agree at (S, D) = (512, 256) with the tuned
    blocks (float32 inputs: the reference's 1e-4).
  * `tenset-pretrain` scores with frozen converted params, so on the
    model's `self_attn` and `rg_lru_scan` tasks both packages measure the
    same configs in the same order and pick the same winners.
"""
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.autotune.dataset import generate_records as j_generate  # noqa: E402
from repro.autotune.dataset import training_task_pool as j_pool  # noqa: E402
from repro.autotune.registry import Registry as JRegistry  # noqa: E402
from repro.autotune.session import TuneSession as JSession  # noqa: E402
from repro.autotune.tasks import arch_tasks as j_arch_tasks  # noqa: E402
from repro.configs import get_config as j_get_config  # noqa: E402
from repro.configs.moses import CostModelConfig as JCfg  # noqa: E402
from repro.configs.moses import MosesConfig as JMoses  # noqa: E402
from repro.core.cost_model import MLPCostModel as JMLP  # noqa: E402
from repro.kernels import ops as j_ops  # noqa: E402
from repro_torch.autotune import registry as t_registry  # noqa: E402
from repro_torch.autotune.session import TuneSession as TSession  # noqa: E402
from repro_torch.autotune.space import config_valid  # noqa: E402
from repro_torch.autotune.tasks import arch_tasks as t_arch_tasks  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.configs.moses import CostModelConfig as TCfg  # noqa: E402
from repro_torch.configs.moses import MosesConfig as TMoses  # noqa: E402
from repro_torch.core import convert  # noqa: E402
from repro_torch.core import cost_model as tcm  # noqa: E402
from repro_torch.kernels import ops as t_ops  # noqa: E402
from repro_torch.launch import train  # noqa: E402

ARCH = "recurrentgemma-2b"


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


def test_dry_run_registry_feeds_both_packages_kernels(registry_file):
    run = train.maybe_autotune("tpu_v5e", get_config(ARCH), dry_run=True,
                               torch_device="cpu")
    assert run.registry.path == registry_file
    assert [t.workload.name for t in run.result.tasks] == ["qkv_proj",
                                                           "self_attn"]
    assert run.pretrain_losses[-1] < run.pretrain_losses[0]
    for t in run.result.tasks:
        assert config_valid(t.workload, t.best_config)

    jreg = JRegistry(registry_file)
    attn = [w for w in j_arch_tasks(j_get_config(ARCH))
            if w.name == "self_attn"][0]
    entry = jreg.lookup("tpu_v5e", attn)
    assert entry is not None and set(entry["knobs"]) == {
        "block_q", "block_kv", "stages", "unroll"}
    S, D = attn.dims
    assert (S, D) == (512, 256)
    rng = np.random.RandomState(0)
    q, k, v = (rng.randn(1, S, D).astype(np.float32) for _ in range(3))
    window = get_config(ARCH).local_window
    old_j, old_t = j_ops._registry, t_ops._registry
    j_ops.set_registry(jreg)
    t_ops.set_registry(run.registry)
    try:
        want = j_ops.tuned_flash_attention(
            jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), window=window,
            device="tpu_v5e", interpret=True)
        got = t_ops.tuned_flash_attention(
            torch.as_tensor(q), torch.as_tensor(k), torch.as_tensor(v),
            window=window, device="tpu_v5e")
    finally:
        j_ops.set_registry(old_j)
        t_ops.set_registry(old_t)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-4,
                               atol=1e-4)


def test_cli_dry_run(registry_file):
    train.main(["--arch", ARCH, "--smoke", "--autotune", "tpu_v5e",
                "--dry-run", "--autotune-trials", "4", "--torch-device",
                "cpu"])
    assert len(t_registry.Registry(registry_file)._data["tpu_v5e"]) == 2


def test_gradient_dry_run_fills_registry_and_writes_telemetry(
        registry_file, tmp_path):
    obs = str(tmp_path / "obs")
    run = train.maybe_autotune("tpu_v5e", get_config(ARCH),
                               scheduler="gradient", dry_run=True, obs=obs,
                               torch_device="cpu")
    campaign = run.campaign
    assert campaign is not None and campaign.results[0] is run.result
    assert [t.workload.name for t in run.result.tasks] == ["qkv_proj",
                                                           "self_attn"]
    for t in run.result.tasks:
        assert config_valid(t.workload, t.best_config)
    assert campaign.spec_stats.batches > 0
    assert campaign.total_measurements <= 16 * 2 + 2
    reg = t_registry.Registry(registry_file)
    assert len(reg._data["tpu_v5e"]) == 2
    assert sorted(os.listdir(obs)) == ["campaign.trace.json", "events.jsonl"]
    summary = campaign.obs_summary
    assert summary["problems"] == [] and summary["root"] == "campaign"
    assert summary["attributed_pct"] >= 95.0
    assert {"search", "measure", "update"} <= set(summary["categories_s"])
    # the serial path keeps no campaign
    assert train.maybe_autotune("tpu_v5e", get_config(ARCH), dry_run=True,
                                torch_device="cpu").campaign is None


def test_cli_gradient_dry_run(registry_file, tmp_path):
    train.main(["--arch", ARCH, "--smoke", "--autotune", "tpu_v5e",
                "--scheduler", "gradient", "--dry-run", "--autotune-trials",
                "8", "--torch-device", "cpu", "--obs",
                str(tmp_path / "obs")])
    assert len(t_registry.Registry(registry_file)._data["tpu_v5e"]) == 2
    assert os.path.exists(tmp_path / "obs" / "events.jsonl")


def test_autotune_defaults_to_the_card(registry_file, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        train.maybe_autotune("tpu_v5e", get_config(ARCH), dry_run=True)


CM = dict(hidden_dims=(32, 32), batch_size=64, rank_pairs_per_batch=256)
MOSES = dict(population_size=16, evolution_rounds=2, top_k_measure=4,
             online_epochs=3)


def test_tenset_pretrain_picks_the_same_configs():
    jcfg = JMoses(cost_model=JCfg(**CM), **MOSES)
    tcfg = TMoses(cost_model=TCfg(**CM), **MOSES)
    jsource = j_generate(j_pool(include_archs=False)[::6], "tpu_v5p",
                         programs_per_task=6)
    jmodel = JMLP(jcfg.cost_model)
    jparams, _ = jmodel.train(jmodel.init(jax.random.PRNGKey(0)), jsource,
                              epochs=2)
    tparams = convert.cost_model_params(
        {k: np.asarray(v) for k, v in jparams.items()}, "cpu")
    tsource = tcm.Records(jsource.x, jsource.y, jsource.g,
                          jsource.raw_throughput)
    jsession = JSession(moses_cfg=jcfg, pretrained_params=jparams,
                        source_pool=jsource, seed=1, trials_per_task=16,
                        cost_model=jmodel)
    tsession = TSession(moses_cfg=tcfg, pretrained_params=tparams,
                        source_pool=tsource, seed=1, trials_per_task=16,
                        torch_device="cpu")
    names = ("self_attn", "rg_lru_scan")
    jtasks = [w for w in j_arch_tasks(j_get_config(ARCH)) if w.name in names]
    ttasks = [w for w in t_arch_tasks(get_config(ARCH)) if w.name in names]
    jres = jsession.run(jtasks, "tpu_v5e", "tenset-pretrain")
    tres = tsession.run(ttasks, "tpu_v5e", "tenset-pretrain")
    assert [t.workload.name for t in tres.tasks] == list(names)
    for jt, tt in zip(jres.tasks, tres.tasks):
        assert [(c.knobs, t, i) for c, t, i in jt.measured] == \
            [(c.knobs, t, i) for c, t, i in tt.measured]
        assert jt.best_config.knobs == tt.best_config.knobs
    assert jres.total_search_seconds == tres.total_search_seconds


def test_chip_smoke_sched_path_rehearses_on_cpu(registry_file, tmp_path,
                                                monkeypatch):
    """chip_smoke.py's `sched_path` at the smoke config and the dry-run
    budget on the CPU: the serial path's registry moves aside, the
    campaign's winners launch from the campaign's registry (the plain
    versions here), and the line's numbers and the recorder's artifacts are
    there."""
    import importlib.util
    from pathlib import Path

    import repro_torch.configs as t_configs
    from repro_torch.configs import get_smoke_config

    path = Path(__file__).resolve().parents[1] / "chip_smoke.py"
    spec = importlib.util.spec_from_file_location("chip_smoke", path)
    smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(smoke)
    monkeypatch.setattr(t_configs, "get_config", get_smoke_config)
    serial = train.maybe_autotune("tpu_v5e", get_config(ARCH), dry_run=True,
                                  torch_device="cpu")
    obs = str(tmp_path / "obs")
    cfg, run, calls = smoke.drive_sched_path("cpu", ARCH, trials=8,
                                             obs_dir=obs, dry_run=True)
    assert os.path.exists(os.path.join(os.path.dirname(registry_file),
                                       "serial_tuned_configs_torch.json"))
    assert [wl.name for wl, _, _ in calls] == ["qkv_proj", "self_attn"]
    for wl, args, out in calls:
        assert torch.isfinite(out.float()).all(), wl.name
    line = smoke.sched_summary(run, serial, obs)
    assert line["grants"] == len(run.campaign.trace) > 0
    assert line["serial_measurements"] == serial.result.total_measurements
    assert {"round.search", "round.measure", "round.update"} <= set(
        line["obs_spans"])
    assert line["obs_attributed_pct"] >= 95.0
    json.dumps(line)
