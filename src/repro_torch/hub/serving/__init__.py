"""Hub serving subsystem (port of `repro.hub.serving`): the read path for
tuned configs.

  index.py     byte-offset sidecar indexes over the JSONL record shards
  cache.py     tuned-config LRU + latency windows (the zero-I/O hit path)

The reference's socket front end (`protocol.py`, `server.py`,
`client.py`) waits for ROADMAP Queue 1 item 9b: asking for its names
raises NotImplementedError.

Submodules resolve lazily (PEP 562): `store.py` imports `serving.index`,
and read-only callers should not pay for modules they never touch.
"""
from __future__ import annotations

import importlib

_EXPORTS = {
    "ShardIndex": "repro_torch.hub.serving.index",
    "build_index": "repro_torch.hub.serving.index",
    "load_index": "repro_torch.hub.serving.index",
    "write_index": "repro_torch.hub.serving.index",
    "read_rows": "repro_torch.hub.serving.index",
    "TunedConfigCache": "repro_torch.hub.serving.cache",
    "LatencyWindow": "repro_torch.hub.serving.cache",
}

# the reference's socket front end, not ported yet
NOT_PORTED = ("ProtocolError", "send_frame", "recv_frame", "HubServer",
              "HubClient", "ServeResult")

__all__ = sorted(_EXPORTS)


def not_ported(name: str) -> NotImplementedError:
    return NotImplementedError(
        f"{name} belongs to the hub's socket front end, which waits for "
        f"ROADMAP Queue 1 item 9b")


def __getattr__(name):
    if name in NOT_PORTED:
        raise not_ported(name)
    target = _EXPORTS.get(name)
    if target is None:
        raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
    value = getattr(importlib.import_module(target), name)
    globals()[name] = value
    return value


def __dir__():
    return sorted(set(globals()) | set(__all__))
