"""Transfer Hub (port of `repro.hub`): the persistent cross-device experience
layer.

Sits between the simulator/dataset layer and the tuning stack:

  store.py        append-only on-disk record store (JSONL shards keyed by
                  device/task; schema-versioned, deduplicated, atomic writes,
                  byte-offset sidecar indexes for the serving read path) in
                  the reference's format, so either package reads the other's
  fingerprint.py  micro-probe suite -> normalized device fingerprint vector
                  + similarity metric
  transfer.py     source-selection policy: rank known devices by fingerprint
                  similarity, assemble a mixed weighted source pool +
                  pretrained cost-model params for an unseen target
  provenance.py   TransferProvenance: the flight record attached to every
                  tuned winner (sources + similarities + mixing weights,
                  params lineage, lottery-ticket overlap, budget spent,
                  calibration) — the `explain` op's payload
  service.py      TuningHub facade: get_config(device, workload) serves from
                  the tuned-config LRU cache / Registry on hit and schedules
                  batched TuneSession jobs on miss (in-flight dedup,
                  writeback of winners and of every new measurement)
  serving/        the production read path: indexed reads, the tuned-config
                  cache, and the socket front end — `HubServer` (one writer
                  hub on the card, N torch-free reader processes) and
                  `HubClient` (endpoint discovery, reader failover)

Exports resolve lazily (PEP 562): readers import `repro_torch.hub.store` /
`repro_torch.hub.serving.*` without paying for the tuning stack
(`service.py` pulls in torch) they never call.
"""
from __future__ import annotations

import importlib

_EXPORTS = {
    "SCHEMA_VERSION": "repro_torch.hub.store",
    "COMPAT_SCHEMA_VERSIONS": "repro_torch.hub.store",
    "RecordStore": "repro_torch.hub.store",
    "PROVENANCE_VERSION": "repro_torch.hub.provenance",
    "TransferProvenance": "repro_torch.hub.provenance",
    "build_provenance": "repro_torch.hub.provenance",
    "ticket_overlap": "repro_torch.hub.provenance",
    "StoreSchemaError": "repro_torch.hub.store",
    "workload_from_record": "repro_torch.hub.store",
    "PROBE_VERSION": "repro_torch.hub.fingerprint",
    "probe_suite": "repro_torch.hub.fingerprint",
    "device_fingerprint": "repro_torch.hub.fingerprint",
    "fingerprint_similarity": "repro_torch.hub.fingerprint",
    "rank_by_similarity": "repro_torch.hub.fingerprint",
    "SourceSelection": "repro_torch.hub.transfer",
    "select_sources": "repro_torch.hub.transfer",
    "bootstrap_store": "repro_torch.hub.transfer",
    "TuningHub": "repro_torch.hub.service",
    "HubResponse": "repro_torch.hub.service",
    "HubStats": "repro_torch.hub.service",
    "HubServer": "repro_torch.hub.serving.server",
    "HubClient": "repro_torch.hub.serving.client",
    "ServeResult": "repro_torch.hub.serving.client",
    "ProtocolError": "repro_torch.hub.serving.protocol",
    "send_frame": "repro_torch.hub.serving.protocol",
    "recv_frame": "repro_torch.hub.serving.protocol",
    "TunedConfigCache": "repro_torch.hub.serving.cache",
    "LatencyWindow": "repro_torch.hub.serving.cache",
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
