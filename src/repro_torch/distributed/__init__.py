"""The distribution layer on `torch.distributed` (port of
`repro.distributed`): sharding rules and DTensor placements
(`sharding`), activation and weight hints (`act_sharding`),
sequence-sharded decode attention (`decode_attention`) and int8 compressed
all-reduce (`compression`). Expert parallelism and the pipeline are not
ported yet (ROADMAP Queue 1 item 12b).

The submodules resolve lazily (PEP 562): the models import `act_sharding`,
and a process without a mesh must not pay for importing
`torch.distributed.tensor`, which `sharding` does.
"""
from __future__ import annotations

import importlib

__all__ = ["compression", "decode_attention", "sharding"]


def __getattr__(name):
    if name not in __all__:
        raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
    value = importlib.import_module(f"{__name__}.{name}")
    globals()[name] = value
    return value
