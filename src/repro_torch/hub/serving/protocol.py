"""Length-prefixed JSON framing for the hub serving RPC (a copy of
`repro.hub.serving.protocol`: frames are byte-identical across the two
packages, so a client of one talks to a server of the other).

One frame = a 4-byte big-endian payload length + a UTF-8 JSON object. JSON,
not pickle: the server must never execute attacker-chosen bytes off a
socket, and every value that crosses this wire (workload dims, knob dicts,
throughputs, counters) is plain data. Frames are bounded (`MAX_FRAME`) so a
corrupt or hostile length prefix cannot balloon a reader's memory.

A cleanly closed socket between frames reads as `None` (the peer hung up);
a socket that dies MID-frame raises `ProtocolError` — the caller sees a
torn frame, never a half-parsed message. This module is import-light on
purpose (stdlib only): client processes and spawned reader processes boot
without the tuning stack.
"""
from __future__ import annotations

import json
import socket
import struct
from typing import Any, Dict, Optional

MAX_FRAME = 8 << 20     # 8 MiB: orders of magnitude above any real message
_LEN = struct.Struct(">I")


class ProtocolError(RuntimeError):
    """A torn, oversized, or non-JSON frame."""


def _recv_exact(sock: socket.socket, n: int) -> Optional[bytes]:
    """Read exactly n bytes. None on clean EOF at a frame boundary (nothing
    read yet); ProtocolError on EOF mid-frame."""
    chunks = []
    got = 0
    while got < n:
        chunk = sock.recv(min(n - got, 1 << 16))
        if not chunk:
            if got == 0:
                return None
            raise ProtocolError(f"connection closed mid-frame "
                                f"({got}/{n} bytes)")
        chunks.append(chunk)
        got += len(chunk)
    return b"".join(chunks)


def send_frame(sock: socket.socket, obj: Dict[str, Any]) -> None:
    data = json.dumps(obj, separators=(",", ":")).encode()
    if len(data) > MAX_FRAME:
        raise ProtocolError(f"frame of {len(data)} bytes exceeds "
                            f"MAX_FRAME={MAX_FRAME}")
    sock.sendall(_LEN.pack(len(data)) + data)


def recv_frame(sock: socket.socket) -> Optional[Dict[str, Any]]:
    header = _recv_exact(sock, _LEN.size)
    if header is None:
        return None
    (length,) = _LEN.unpack(header)
    if length > MAX_FRAME:
        raise ProtocolError(f"frame length {length} exceeds "
                            f"MAX_FRAME={MAX_FRAME}")
    body = _recv_exact(sock, length)
    if body is None:
        raise ProtocolError("connection closed before frame body")
    try:
        obj = json.loads(body)
    except json.JSONDecodeError as e:
        raise ProtocolError(f"undecodable frame: {e}") from e
    if not isinstance(obj, dict):
        raise ProtocolError(f"frame is not an object: {type(obj).__name__}")
    return obj


# --- workload / config wire forms ----------------------------------------
# Mirrors the record store's on-disk task dict so both ends agree with the
# persisted corpus about what identifies a workload.

def workload_to_wire(wl) -> Dict[str, Any]:
    return {"kind": wl.kind, "dims": list(wl.dims), "name": wl.name,
            "count": wl.count, "dtype_bytes": wl.dtype_bytes}


def workload_from_wire(d: Dict[str, Any]):
    from repro_torch.autotune.space import Workload
    return Workload(d["kind"], tuple(int(x) for x in d["dims"]),
                    name=d.get("name", ""), count=int(d.get("count", 1)),
                    dtype_bytes=int(d.get("dtype_bytes", 2)))


def config_to_wire(cfg) -> Dict[str, int]:
    return {k: int(v) for k, v in cfg.knobs}


def config_from_wire(knobs: Dict[str, Any]):
    from repro_torch.autotune.space import ProgramConfig
    return ProgramConfig(tuple(sorted((k, int(v))
                               for k, v in knobs.items())))
