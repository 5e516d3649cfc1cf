"""Moses core: features, the cost model, lottery-ticket adaptation, the
adaptive controller and the paper's metrics (port of `repro.core`).

The submodules resolve lazily (PEP 562): `features`, `ac` and `metrics`
are numpy or plain Python, and a process that only reads features must
not load torch, which `cost_model`, `lottery` and `adaptation` import.
"""
from __future__ import annotations

import importlib

__all__ = ["ac", "adaptation", "cost_model", "features", "lottery", "metrics"]


def __getattr__(name):
    if name not in __all__:
        raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
    value = importlib.import_module(f"{__name__}.{name}")
    globals()[name] = value
    return value


def __dir__():
    return sorted(set(globals()) | set(__all__))
