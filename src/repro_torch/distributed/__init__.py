"""The distribution layer on `torch.distributed` (port of
`repro.distributed`): sharding rules and DTensor placements
(`sharding`), activation and weight hints (`act_sharding`),
sequence-sharded decode attention (`decode_attention`), int8 compressed
all-reduce (`compression`), expert-parallel MoE (`expert_parallel`) and
the GPipe schedule over "pod" (`pipeline`).

The submodules resolve lazily (PEP 562): the models import `act_sharding`,
and a process without a mesh must not pay for importing
`torch.distributed.tensor`, which `sharding` does.
"""
from __future__ import annotations

import importlib

__all__ = ["compression", "decode_attention", "expert_parallel", "pipeline",
           "sharding"]


def __getattr__(name):
    if name not in __all__:
        raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
    value = importlib.import_module(f"{__name__}.{name}")
    globals()[name] = value
    return value
