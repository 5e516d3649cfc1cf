"""The port's package exports against the reference's: `repro_torch.
autotune` and `repro_torch.core` resolve every name of the reference's
`__all__`, lazily (a process that reads only the knob space or the
features loads no torch), and `autotune.dataset` saves and loads records
in the reference's `.npz` format, each package reading the other's file."""
import os
import pathlib
import subprocess
import sys

import numpy as np
import pytest

pytest.importorskip("torch")

import repro.autotune as j_autotune  # noqa: E402
import repro.core as j_core  # noqa: E402
from repro.autotune import dataset as j_dataset  # noqa: E402
from repro_torch.autotune import dataset as t_dataset  # noqa: E402

ROOT = pathlib.Path(__file__).resolve().parents[1]


@pytest.mark.parametrize("pkg,names", [
    ("repro_torch.autotune", j_autotune.__all__),
    ("repro_torch.core", j_core.__all__)], ids=["autotune", "core"])
def test_every_reference_export_resolves(pkg, names):
    import importlib
    mod = importlib.import_module(pkg)
    assert sorted(mod.__all__) == sorted(names)
    for name in names:
        assert getattr(mod, name) is not None, name
        assert name in dir(mod)
    with pytest.raises(AttributeError):
        getattr(mod, "no_such_name")


def test_exported_names_are_the_ported_objects():
    from repro_torch.autotune import (STRATEGIES, Strategy, TuneSession,
                                      register_strategy, resolve_strategy)
    from repro_torch.autotune import session, strategies
    assert TuneSession is session.TuneSession
    assert (STRATEGIES, Strategy, register_strategy, resolve_strategy) == (
        strategies.STRATEGIES, strategies.Strategy,
        strategies.register_strategy, strategies.resolve_strategy)
    assert STRATEGIES == j_autotune.STRATEGIES


@pytest.mark.parametrize("module", [
    "repro_torch.autotune.space", "repro_torch.autotune.registry",
    "repro_torch.core.features", "repro_torch.core.ac",
    "repro_torch.core.metrics"])
def test_light_modules_load_no_torch(module):
    """In a fresh process: importing the module through its lazy package,
    then touching the package, leaves torch out of sys.modules."""
    pkg = module.rsplit(".", 1)[0]
    code = (f"import sys, {module}, {pkg}\n"
            f"dir({pkg})\n"
            "print('torch' in sys.modules)\n")
    env = {**os.environ, "PYTHONPATH": str(ROOT / "src")}
    out = subprocess.run([sys.executable, "-c", code], env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "False", out.stdout


def _records(mod, raw: bool):
    rng = np.random.RandomState(3)
    g = np.repeat(np.arange(4, dtype=np.int32), 5)
    x = rng.randn(20, 164).astype(np.float32)
    y = rng.rand(20).astype(np.float32)
    return mod.Records(x=x, y=y, g=g, raw_throughput=(
        rng.rand(20).astype(np.float32) * 100 if raw else None))


@pytest.mark.parametrize("raw", [True, False], ids=["raw", "no-raw"])
@pytest.mark.parametrize("writer,reader", [
    (j_dataset, t_dataset), (t_dataset, j_dataset),
    (t_dataset, t_dataset)], ids=["ref-to-port", "port-to-ref",
                                  "port-to-port"])
def test_records_round_trip_across_packages(tmp_path, writer, reader, raw):
    from repro.core import cost_model as j_cm
    from repro_torch.core import cost_model as t_cm
    cm = j_cm if writer is j_dataset else t_cm
    rec = _records(cm, raw)
    path = str(tmp_path / "sub" / "records.npz")
    writer.save_records(rec, path)
    got = reader.load_records(path)
    for field in ("x", "y", "g"):
        np.testing.assert_array_equal(getattr(got, field),
                                      getattr(rec, field))
        assert getattr(got, field).dtype == getattr(rec, field).dtype
    if raw:
        np.testing.assert_array_equal(got.raw_throughput, rec.raw_throughput)
    else:
        assert got.raw_throughput is None
