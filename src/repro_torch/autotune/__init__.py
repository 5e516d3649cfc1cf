"""Autotuning stack: config space, device simulator, strategies, sessions
and the tuned-config registry (port of `repro.autotune`).

Submodules and names resolve lazily (PEP 562): `space` and `registry` are
import-light (numpy and the standard library) and are all that the hub's
serving readers and clients touch, while `session`/`tuner`/`strategies`
pull in torch. Eager package imports would make every registry lookup pay
for the full tuning stack.
"""
from __future__ import annotations

import importlib

_SUBMODULES = ("dataset", "devices", "evolution", "registry", "session",
               "space", "strategies", "tasks", "tuner")
_EXPORTS = {
    "TuneSession": "repro_torch.autotune.session",
    "STRATEGIES": "repro_torch.autotune.strategies",
    "Strategy": "repro_torch.autotune.strategies",
    "register_strategy": "repro_torch.autotune.strategies",
    "resolve_strategy": "repro_torch.autotune.strategies",
}

__all__ = sorted(set(_SUBMODULES) | set(_EXPORTS))


def __getattr__(name):
    if name in _SUBMODULES:
        value = importlib.import_module(f"{__name__}.{name}")
    elif name in _EXPORTS:
        value = getattr(importlib.import_module(_EXPORTS[name]), name)
    else:
        raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
    globals()[name] = value
    return value


def __dir__():
    return sorted(set(globals()) | set(__all__))
