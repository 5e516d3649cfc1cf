"""Socket client for the hub serving front end (a copy of
`repro.hub.serving.client`, imports repointed; torch-free, so a client
process never loads torch).

A client holds ONE persistent framed connection to a reader (`offset`
staggers which one, so a fleet of clients spreads across the farm). Every
failure mode — reader killed, torn frame, stale endpoint — is handled the
same way: drop the connection, re-read `endpoints.json` (the parent
republishes it on every respawn), and retry against the next endpoint.
`get_config` raises `ConnectionError` only after two full passes over the
current endpoint set fail.
"""
from __future__ import annotations

import dataclasses
import json
import os
import socket
import time
from typing import Any, Dict, List, Optional

from repro_torch.hub.serving import protocol
from repro_torch.obs import trace as obs_trace


@dataclasses.dataclass
class ServeResult:
    """One served answer, decoded off the wire."""
    device: str
    workload: Any                            # autotune.space.Workload
    config: Any                              # autotune.space.ProgramConfig
    throughput_gflops: Optional[float]
    source: str                              # cache|registry|tuned|store|...
    cache_hit: bool
    rid: int                                 # reader that answered
    latency_s: float


class HubClient:
    def __init__(self, root: Optional[str] = None,
                 endpoints: Optional[List[Dict[str, int]]] = None,
                 endpoints_file: Optional[str] = None,
                 host: str = "127.0.0.1",
                 timeout_s: float = 30.0,
                 tune_timeout_s: float = 600.0,
                 offset: int = 0):
        if endpoints is None and endpoints_file is None and root is None:
            raise ValueError("need root=, endpoints=, or endpoints_file=")
        if endpoints_file is None and root is not None:
            from repro_torch.hub.serving.server import endpoints_path
            endpoints_file = endpoints_path(root)
        self._file = endpoints_file
        self.host = host
        self.timeout_s = timeout_s
        self.tune_timeout_s = tune_timeout_s
        self._offset = int(offset)
        self._endpoints: List[Dict[str, int]] = list(endpoints or [])
        self._sock: Optional[socket.socket] = None
        self.rid: Optional[int] = None       # reader currently connected
        if not self._endpoints:
            self._refresh_endpoints()

    # --- connection management -------------------------------------------
    def _refresh_endpoints(self) -> None:
        if self._file is None:
            return
        try:
            with open(self._file) as f:
                data = json.load(f)
        except (OSError, json.JSONDecodeError):
            return
        eps = data.get("readers") or []
        if eps:
            self._endpoints = eps
            self.host = data.get("host", self.host)

    def _drop(self) -> None:
        if self._sock is not None:
            try:
                self._sock.close()
            except OSError:
                pass
        self._sock = None
        self.rid = None

    def _connect(self) -> socket.socket:
        if self._sock is not None:
            return self._sock
        eps = self._endpoints
        n = len(eps)
        for i in range(n):
            ep = eps[(self._offset + i) % n]
            try:
                s = socket.create_connection(
                    (self.host, int(ep["port"])), timeout=self.timeout_s)
            except OSError:
                continue
            s.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
            self._sock = s
            self.rid = int(ep.get("rid", -1))
            return s
        raise ConnectionError(
            f"no reachable reader among {n} endpoint(s)")

    def _call(self, req: Dict[str, Any],
              timeout_s: float) -> Dict[str, Any]:
        """One request/reply with failover: on any transport failure, drop
        the connection, refresh endpoints, advance to the next reader, and
        retry — two full passes before giving up.

        When the calling thread has an open trace span, its context rides
        the request frame; the reader answers with a `serve.handle` span
        event that is merged back into the active tracer, so a campaign
        timeline shows reader-side time across the process boundary."""
        ctx = obs_trace.current_context()
        if ctx is not None:
            req = dict(req, trace=list(ctx))
        attempts = max(2, 2 * max(1, len(self._endpoints)))
        last: Optional[Exception] = None
        for _ in range(attempts):
            try:
                s = self._connect()
                s.settimeout(timeout_s)
                protocol.send_frame(s, req)
                reply = protocol.recv_frame(s)
                if reply is None:
                    raise protocol.ProtocolError("reader hung up")
                events = reply.pop("span_events", None)
                if events:
                    tracer = obs_trace.current_tracer()
                    if tracer is not None:
                        tracer.add_events(events)
                return reply
            except (OSError, protocol.ProtocolError) as e:
                last = e
                self._drop()
                self._offset += 1           # fail over to the next reader
                self._refresh_endpoints()
        raise ConnectionError(f"hub serving RPC failed: {last!r}")

    # --- API --------------------------------------------------------------
    def ping(self) -> bool:
        reply = self._call({"op": "ping"}, self.timeout_s)
        return bool(reply.get("ok"))

    def stats(self) -> Dict[str, Any]:
        return self._call({"op": "stats"}, self.timeout_s)

    def _writer_call(self, req: Dict[str, Any],
                     timeout_s: float) -> Dict[str, Any]:
        """One request/reply against the WRITER socket (ops the readers do
        not serve: explain, metrics, health). No failover — there is
        exactly one writer; its port comes from the endpoints file."""
        port = None
        if self._file is not None:
            try:
                with open(self._file) as f:
                    port = json.load(f).get("writer_port")
            except (OSError, json.JSONDecodeError):
                port = None
        if not port:
            raise ConnectionError("no writer endpoint published")
        with socket.create_connection((self.host, int(port)),
                                      timeout=timeout_s) as s:
            protocol.send_frame(s, req)
            reply = protocol.recv_frame(s)
        if reply is None:
            raise protocol.ProtocolError("writer hung up")
        return reply

    def explain(self, device: str, task_key: str) -> Dict[str, Any]:
        """The provenance + registry story behind one served winner, from
        the writer hub. Raises RuntimeError when the hub never tuned
        (device, task_key)."""
        reply = self._writer_call(
            {"op": "explain", "device": device, "task": task_key},
            self.timeout_s)
        if not reply.get("ok"):
            raise RuntimeError(f"explain failed: {reply.get('error')}")
        return reply

    def get_config(self, device: str, wl, tune: bool = True) -> ServeResult:
        """Serve the best known config for (device, workload). `tune=False`
        never triggers measurements — a miss falls back to the store's best
        record or the vendor default."""
        t0 = time.perf_counter()
        reply = self._call(
            {"op": "get_config", "device": device,
             "workload": protocol.workload_to_wire(wl), "tune": tune},
            self.tune_timeout_s if tune else self.timeout_s)
        if not reply.get("ok"):
            raise RuntimeError(f"get_config failed: {reply.get('error')}")
        return ServeResult(
            device=device, workload=wl,
            config=protocol.config_from_wire(reply["knobs"]),
            throughput_gflops=reply.get("throughput_gflops"),
            source=reply.get("source", ""),
            cache_hit=bool(reply.get("cache_hit")),
            rid=int(reply.get("rid", -1)),
            latency_s=time.perf_counter() - t0)

    def close(self) -> None:
        self._drop()

    def __enter__(self) -> "HubClient":
        return self

    def __exit__(self, *exc) -> None:
        self.close()
