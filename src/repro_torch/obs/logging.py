"""Structured status logger: level + key=value fields, zero dependencies
(a verbatim copy of `repro.obs.logging`; both packages read the same
environment variables).

Replaces the ad-hoc bracketed `print()` status lines that had grown across
session/hub/serving/launch. One line per call:

    [hub] continual refresh failed device=tpu_lite error=ValueError(...)

Level control is environmental, checked per call (so tests can monkeypatch
the env): ``REPRO_LOG_LEVEL`` in debug|info|warning|error|off. The default
is ``info`` — except under pytest (``PYTEST_CURRENT_TEST`` set), where it
is ``warning`` so test output stays clean without every test muting the
stack. Lines go to stderr, keeping stdout for data (CSV, tables, JSON).

``REPRO_LOG_JSON=1`` switches the stderr format to one JSON object per
line (``{"t": ..., "level": ..., "logger": ..., "msg": ..., <fields>}``)
carrying the same fields as the human format — for log shippers and
``--watch``-style tooling that wants machine-parseable status.

Sinks: a `FlightRecorder` (or any callable) can attach via `add_sink` to
mirror warning+ lines into `events.jsonl`, so a campaign's artifact also
records what went wrong, not just what was measured.
"""
from __future__ import annotations

import json
import os
import sys
import threading
import time
from typing import Callable, Dict, List

LEVELS: Dict[str, int] = {"debug": 10, "info": 20, "warning": 30,
                          "error": 40, "off": 100}

_sinks: List[Callable[[str, str, str, Dict[str, object]], None]] = []
_sink_lock = threading.Lock()


def threshold() -> int:
    """The active numeric level, re-read from the environment per call."""
    lvl = os.environ.get("REPRO_LOG_LEVEL", "").strip().lower()
    if lvl in LEVELS:
        return LEVELS[lvl]
    if "PYTEST_CURRENT_TEST" in os.environ:
        return LEVELS["warning"]
    return LEVELS["info"]


def add_sink(fn: Callable[[str, str, str, Dict[str, object]], None]) -> None:
    """Register `fn(level, name, msg, fields)` to receive warning+ lines
    regardless of the print threshold."""
    with _sink_lock:
        if fn not in _sinks:
            _sinks.append(fn)


def remove_sink(fn) -> None:
    with _sink_lock:
        if fn in _sinks:
            _sinks.remove(fn)


def _fmt_value(v: object) -> str:
    if isinstance(v, float):
        return f"{v:.6g}"
    s = str(v)
    return repr(s) if " " in s else s


class Logger:
    """One named logger; `get_logger("hub")` prints `[hub] ...` lines."""
    __slots__ = ("name",)

    def __init__(self, name: str):
        self.name = name

    def _emit(self, level: str, msg: str, fields: Dict[str, object]) -> None:
        num = LEVELS[level]
        if num >= LEVELS["warning"]:
            with _sink_lock:
                sinks = list(_sinks)
            for fn in sinks:
                try:
                    fn(level, self.name, msg, fields)
                except Exception:       # a broken sink must not mute stderr
                    pass
        if num < threshold():
            return
        if os.environ.get("REPRO_LOG_JSON", "").strip().lower() in (
                "1", "true", "yes"):
            rec: Dict[str, object] = {"t": round(time.time(), 6),
                                      "level": level, "logger": self.name,
                                      "msg": msg}
            for k, v in fields.items():
                rec[k] = v if isinstance(v, (str, int, float, bool)) \
                    or v is None else str(v)
            print(json.dumps(rec), file=sys.stderr, flush=True)
            return
        kv = " ".join(f"{k}={_fmt_value(v)}" for k, v in fields.items())
        tag = "" if level == "info" else f" {level.upper()}:"
        print(f"[{self.name}]{tag} {msg}" + (f" {kv}" if kv else ""),
              file=sys.stderr, flush=True)

    def debug(self, msg: str, **fields) -> None:
        self._emit("debug", msg, fields)

    def info(self, msg: str, **fields) -> None:
        self._emit("info", msg, fields)

    def warning(self, msg: str, **fields) -> None:
        self._emit("warning", msg, fields)

    def error(self, msg: str, **fields) -> None:
        self._emit("error", msg, fields)


_loggers: Dict[str, Logger] = {}
_logger_lock = threading.Lock()


def get_logger(name: str) -> Logger:
    with _logger_lock:
        lg = _loggers.get(name)
        if lg is None:
            lg = _loggers[name] = Logger(name)
        return lg
