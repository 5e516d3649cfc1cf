"""The port's copied LM configurations and their tuning tasks agree exactly
with the reference: every config field, `arch_tasks`, the pre-training
task pool and the 164-d features of the architectures' tasks."""
import dataclasses

import numpy as np
import pytest

pytest.importorskip("torch")

from repro import configs as j_configs  # noqa: E402
from repro.autotune import dataset as j_dataset  # noqa: E402
from repro.autotune import space as j_space  # noqa: E402
from repro.autotune import tasks as j_tasks  # noqa: E402
from repro.core import features as j_features  # noqa: E402
from repro_torch import configs as t_configs  # noqa: E402
from repro_torch.autotune import dataset as t_dataset  # noqa: E402
from repro_torch.autotune import space as t_space  # noqa: E402
from repro_torch.autotune import tasks as t_tasks  # noqa: E402
from repro_torch.core import features as t_features  # noqa: E402

ARCHS = list(j_configs.ARCH_IDS)


def _task_tuple(w):
    return (w.name, w.kind, w.dims, w.count, w.dtype_bytes)


def test_registry_of_archs_identical():
    assert t_configs.ARCH_IDS == j_configs.ARCH_IDS and len(ARCHS) == 10
    assert {k: dataclasses.asdict(v) for k, v in t_configs.SHAPES.items()} \
        == {k: dataclasses.asdict(v) for k, v in j_configs.SHAPES.items()}
    assert list(t_configs.all_cells()) == list(j_configs.all_cells())


@pytest.mark.parametrize("arch", ARCHS)
@pytest.mark.parametrize("smoke", [False, True], ids=["full", "smoke"])
def test_config_identical_field_by_field(arch, smoke):
    get = "get_smoke_config" if smoke else "get_config"
    ref = getattr(j_configs, get)(arch)
    port = getattr(t_configs, get)(arch)
    assert type(port).__module__ == "repro_torch.configs.base"
    assert dataclasses.asdict(port) == dataclasses.asdict(ref)
    assert port.resolved_head_dim == ref.resolved_head_dim
    assert port.padded_vocab_size == ref.padded_vocab_size


@pytest.mark.parametrize("arch", ARCHS)
def test_arch_tasks_identical(arch):
    ref = j_tasks.arch_tasks(j_configs.get_config(arch))
    port = t_tasks.arch_tasks(t_configs.get_config(arch))
    assert [_task_tuple(w) for w in port] == [_task_tuple(w) for w in ref]


def test_recurrentgemma_tasks_at_published_widths():
    port = t_tasks.arch_tasks(t_configs.get_config("recurrentgemma-2b"))
    assert [(w.name, w.dims, w.count) for w in port] == [
        ("qkv_proj", (512, 3072, 2560), 8),
        ("self_attn", (512, 256), 8),
        ("out_proj", (512, 2560, 2560), 8),
        ("ffn_in", (512, 15360, 2560), 26),
        ("ffn_out", (512, 2560, 7680), 26),
        ("rec_in_proj", (512, 5120, 2560), 18),
        ("rg_lru_scan", (512, 2560), 18),
        ("rec_out_proj", (512, 2560, 2560), 18),
        ("lm_head", (512, 256000, 2560), 1)]


@pytest.mark.parametrize("include_archs,size", [(None, 157), (False, 97)],
                         ids=["default", "no_archs"])
def test_training_task_pool_identical(include_archs, size):
    kw = {} if include_archs is None else {"include_archs": include_archs}
    ref = j_dataset.training_task_pool(**kw)
    port = t_dataset.training_task_pool(**kw)
    assert [w.key() for w in port] == [w.key() for w in ref]
    assert len(port) == size


@pytest.mark.parametrize("arch", ARCHS)
def test_arch_task_features_byte_identical(arch):
    """Sampled configs of every task of the architecture; numpy RNG streams
    are the same in both packages, so both sample the same configs."""
    rng_j, rng_t = np.random.RandomState(7), np.random.RandomState(7)
    for wl, twl in zip(j_tasks.arch_tasks(j_configs.get_config(arch)),
                       t_tasks.arch_tasks(t_configs.get_config(arch))):
        for _ in range(4):
            cj = j_space.random_config(wl, rng_j)
            ct = t_space.random_config(twl, rng_t)
            assert cj.knobs == ct.knobs
            fj = j_features.extract_features(wl, cj)
            ft = t_features.extract_features(twl, ct)
            assert fj.dtype == ft.dtype and fj.tobytes() == ft.tobytes()
