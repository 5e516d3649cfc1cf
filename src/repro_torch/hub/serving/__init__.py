"""Hub serving subsystem (port of `repro.hub.serving`): the production read
path for tuned configs.

  index.py     byte-offset sidecar indexes over the JSONL record shards
  cache.py     tuned-config LRU + latency windows (the zero-I/O hit path)
  protocol.py  length-prefixed JSON socket framing + wire forms
  server.py    spawn-based multi-process front end: N read-only reader
               processes, tune-on-miss funneled to the single writer hub
  client.py    socket client with endpoint discovery and reader failover

Submodules resolve lazily (PEP 562): `store.py` imports `serving.index`,
while `serving.server` imports the store back — eager package imports would
cycle, and read-only client and reader processes should not pay for
modules they never touch (they load no torch).
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
    "ProtocolError": "repro_torch.hub.serving.protocol",
    "send_frame": "repro_torch.hub.serving.protocol",
    "recv_frame": "repro_torch.hub.serving.protocol",
    "HubServer": "repro_torch.hub.serving.server",
    "HubClient": "repro_torch.hub.serving.client",
    "ServeResult": "repro_torch.hub.serving.client",
}

__all__ = sorted(_EXPORTS)


def __getattr__(name):
    target = _EXPORTS.get(name)
    if target is None:
        raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
    value = getattr(importlib.import_module(target), name)
    globals()[name] = value
    return value


def __dir__():
    return sorted(set(globals()) | set(__all__))
