"""The port's copied numpy layer agrees exactly with the reference: knob
space, device simulator, task suites, 164-d features and job seeds."""
import numpy as np
import pytest

pytest.importorskip("torch")

from repro.autotune import devices as j_devices  # noqa: E402
from repro.autotune import space as j_space  # noqa: E402
from repro.autotune import tasks as j_tasks  # noqa: E402
from repro.autotune.session import derive_job_seed as j_seed  # noqa: E402
from repro.core import features as j_features  # noqa: E402
from repro_torch.autotune import devices as t_devices  # noqa: E402
from repro_torch.autotune import space as t_space  # noqa: E402
from repro_torch.autotune import tasks as t_tasks  # noqa: E402
from repro_torch.autotune.session import derive_job_seed as t_seed  # noqa: E402
from repro_torch.core import features as t_features  # noqa: E402


def _as_port(wl):
    return t_space.Workload(wl.kind, wl.dims, wl.name, wl.count,
                            wl.dtype_bytes)


@pytest.mark.parametrize("dnn", j_tasks.PAPER_DNN_NAMES)
def test_task_suites_identical(dnn):
    ref = j_tasks.paper_dnn_tasks(dnn)
    port = t_tasks.paper_dnn_tasks(dnn)
    assert [(w.kind, w.dims, w.name, w.count, w.dtype_bytes) for w in ref] \
        == [(w.kind, w.dims, w.name, w.count, w.dtype_bytes) for w in port]


@pytest.mark.parametrize("dnn", j_tasks.PAPER_DNN_NAMES)
def test_features_byte_identical(dnn):
    """Sampled configs of every task of the DNN; numpy RNG streams are the
    same in both packages, so both sample the same configs."""
    rng_j, rng_t = np.random.RandomState(3), np.random.RandomState(3)
    cache = t_features.FeatureCache()
    for wl in j_tasks.paper_dnn_tasks(dnn):
        twl = _as_port(wl)
        for _ in range(6):
            cj = j_space.random_config(wl, rng_j)
            ct = t_space.random_config(twl, rng_t)
            assert cj.knobs == ct.knobs
            fj = j_features.extract_features(wl, cj)
            ft = t_features.extract_features(twl, ct)
            assert fj.dtype == ft.dtype and fj.tobytes() == ft.tobytes()
            assert cache.features(twl, ct).tobytes() == fj.tobytes()
        mj = j_space.mutate_config(wl, cj, rng_j, n_mut=2)
        mt = t_space.mutate_config(twl, ct, rng_t, n_mut=2)
        assert mj.knobs == mt.knobs


@pytest.mark.parametrize("device", sorted(j_devices.DEVICES))
def test_simulated_measurements_identical(device):
    rng = np.random.RandomState(5)
    for wl in j_tasks.resnet18_tasks() + j_tasks.bert_base_tasks():
        twl = _as_port(wl)
        cfg = j_space.random_config(wl, rng)
        tcfg = t_space.ProgramConfig(cfg.knobs)
        for trial in (0, 3):
            assert (j_devices.measure(wl, cfg, device, trial=trial)
                    == t_devices.measure(twl, tcfg, device, trial=trial))
        assert (j_devices.measurement_seconds(wl, cfg, device)
                == t_devices.measurement_seconds(twl, tcfg, device))


@pytest.mark.parametrize("ident", [
    (0, "tpu_v5e", "moses", ""), (1, "tpu_edge", "tenset-pretrain", "x"),
    (12345, "tpu_v5p", "raw", "resnet18"),
    (7, "tpu_lite", "ansor-random", "matmul:1x1000x512")])
def test_derive_job_seed_matches(ident):
    assert t_seed(*ident) == j_seed(*ident)
