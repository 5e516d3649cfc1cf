"""Trace spans: Chrome-trace/Perfetto events with cross-process context
(a copy of `repro.obs.trace` with the two additions below, so traces of
both packages have the same event format).

`span("tune.round", device=..., task=...)` is a context manager that — when
a `Tracer` is active — records one Chrome-trace complete event ("ph": "X",
microsecond ts/dur, pid/tid) on exit, parented to the innermost open span
of the calling thread. With no tracer active it returns a shared no-op
singleton, so instrumented code pays one global read on the disabled path.

Cross-process propagation is by value, not by magic: `current_context()`
yields a `(trace_id, span_id)` pair small enough to ride a farm pipe
instruction or a serving RPC frame; the remote side builds plain event
dicts with `remote_event()` (no Tracer needed — spawn workers stay
dependency-free) and ships them back with its result, where
`Tracer.add_events()` merges them into the one timeline. Remote span ids
are pid-prefixed, so two workers can never collide.

Timeline base: `ts` is wall-clock epoch microseconds (shared across
processes on one host), `dur` comes from a monotonic clock. The output of
`to_chrome_trace()` loads directly in chrome://tracing or
https://ui.perfetto.dev.

Two additions of the port, for spans inside a device program:

- `Tracer(annotate=f)`: every span also enters `f(name)`, a context
  manager, for its duration. Passing `torch.profiler.record_function` (or
  torch's cheaper `_RecordFunctionFast`) makes each span a range of a
  running profiler, on the profiler's own clock, so the device work it
  launches links back to it.
- A closed span joins the tracer's events as it is; its event is built
  when the events are read (`Tracer.events`, `to_chrome`), and there an
  attr with `.item()` or `.tolist()` (a device scalar) becomes a number.
  So a span costs no dict at exit, and a device scalar set as an attr
  waits for nothing there.

Span-tree wellformedness (single root, no orphans, closed statuses) is
checked by `validate_events()` — the contract the fault-injection tests
and the chip smoke's `sched_path` pin.
"""
from __future__ import annotations

import itertools
import os
import threading
import time
from typing import (Callable, ContextManager, Dict, List, Optional,
                    Tuple)

SpanContext = Tuple[str, str]               # (trace_id, span_id)

_id_counter = itertools.count(1)


def _new_trace_id() -> str:
    return f"t{os.getpid():x}-{os.urandom(4).hex()}"


class Span:
    """One open span; on exit it joins its tracer's events as it is, and
    its event dict is built when the events are read (`Tracer.events`)."""
    __slots__ = ("_tracer", "name", "trace_id", "span_id", "parent_id",
                 "attrs", "status", "_t0_wall", "_t0_perf", "_dur_s",
                 "_tid", "_annotation", "_open_spans")

    def __init__(self, tracer: "Tracer", name: str,
                 parent_id: Optional[str], attrs: Dict[str, object]):
        self._tracer = tracer
        self.name = name
        self.trace_id = tracer.trace_id
        self.span_id = f"s{next(_id_counter)}"
        self.parent_id = parent_id
        self.attrs = attrs
        self.status = "ok"
        self._annotation = None

    @property
    def context(self) -> SpanContext:
        return (self.trace_id, self.span_id)

    def set_attr(self, **attrs) -> "Span":
        self.attrs.update(attrs)
        return self

    def __enter__(self) -> "Span":
        tracer = self._tracer
        self._t0_wall = time.time()
        self._t0_perf = time.perf_counter()
        self._open_spans = tracer._stack()  # the entering thread's
        self._open_spans.append(self)
        if tracer.annotate is not None:
            self._annotation = tracer.annotate(self.name)
            self._annotation.__enter__()
        return self

    def __exit__(self, exc_type, exc, tb) -> None:
        if self._annotation is not None:
            self._annotation.__exit__(exc_type, exc, tb)
        self._dur_s = time.perf_counter() - self._t0_perf
        self._tid = threading.get_ident()
        if exc_type is not None:
            self.status = "error"
            self.attrs.setdefault("error", f"{exc_type.__name__}: {exc}")
        st = self._open_spans
        if st and st[-1] is self:
            st.pop()
        else:
            self._tracer._pop(self)
        with self._tracer._lock:
            self._tracer._events.append(self)

    def event(self) -> Dict[str, object]:
        """This closed span's Chrome-trace event (attrs made plain)."""
        return _event(self.name, self.trace_id, self.span_id,
                      self.parent_id, self._t0_wall, self._dur_s,
                      self.status, self.attrs, self._tid)


class _NoopSpan:
    """Returned by `span()` when no tracer is active: enter/exit/set_attr
    are all no-ops and `context` is None, so instrumented code never
    branches on tracing being enabled."""
    __slots__ = ()
    context = None
    span_id = None

    def set_attr(self, **attrs) -> "_NoopSpan":
        return self

    def __enter__(self) -> "_NoopSpan":
        return self

    def __exit__(self, *exc) -> None:
        return None


NOOP_SPAN = _NoopSpan()


_PLAIN = (str, int, float, bool, type(None))


def _plain(v: object) -> object:
    """An attr value as the event holds it: a plain value as it is, a
    scalar with `.item()` or `.tolist()` (a device or numpy scalar) as
    that number, anything else as its `str`."""
    if isinstance(v, _PLAIN):
        return v
    for method in ("item", "tolist"):
        f = getattr(v, method, None)
        if f is None:
            continue
        try:
            out = f()
        except (ValueError, RuntimeError):  # not one element
            continue
        if isinstance(out, _PLAIN):
            return out
    return str(v)


def _event(name: str, trace_id: str, span_id: str, parent_id: Optional[str],
           t0_wall: float, dur_s: float, status: str,
           attrs: Dict[str, object], tid: int) -> Dict[str, object]:
    args = {k: _plain(v) for k, v in attrs.items()}
    args.update(trace_id=trace_id, span_id=span_id, parent_id=parent_id,
                status=status)
    return {"name": name, "cat": "repro", "ph": "X",
            "ts": int(t0_wall * 1e6), "dur": max(0, int(dur_s * 1e6)),
            "pid": os.getpid(), "tid": tid % 100000, "args": args}


def make_event(name: str, trace_id: str, span_id: str,
               parent_id: Optional[str], t0_wall: float, dur_s: float,
               status: str, attrs: Dict[str, object]) -> Dict[str, object]:
    """One Chrome-trace complete event carrying the span-tree ids in
    `args`. All values are JSON-serializable by construction."""
    return _event(name, trace_id, span_id, parent_id, t0_wall, dur_s,
                  status, attrs, threading.get_ident())


def remote_event(name: str, ctx: Optional[SpanContext], t0_wall: float,
                 dur_s: float, status: str = "ok",
                 **attrs) -> Dict[str, object]:
    """Build a span event in a process that has no Tracer (farm workers,
    serving readers). `ctx` is the parent context shipped over the wire;
    the fresh span id is pid-prefixed so remote ids never collide with
    the parent's or each other's."""
    trace_id, parent_id = ctx if ctx is not None else ("", None)
    span_id = f"r{os.getpid():x}-{next(_id_counter)}"
    return make_event(name, trace_id, span_id, parent_id, t0_wall, dur_s,
                      status, attrs)


class Tracer:
    """Event sink + per-thread span stack for one trace (one campaign).
    `annotate`, where given, is a factory name -> context manager that
    every span enters for its duration (`torch.profiler.record_function`
    puts the spans on a running profiler's timeline)."""

    def __init__(self, trace_id: Optional[str] = None,
                 annotate: Optional[Callable[[str], ContextManager]] = None):
        self.trace_id = trace_id or _new_trace_id()
        self.annotate = annotate
        self._events: List[object] = []  # event dicts and closed Spans
        self._lock = threading.Lock()
        self._tls = threading.local()

    # --- span stack (per thread) -----------------------------------------
    def _stack(self) -> List[Span]:
        st = getattr(self._tls, "stack", None)
        if st is None:
            st = self._tls.stack = []
        return st

    def _pop(self, s: Span) -> None:
        st = self._stack()
        if s in st:
            while st and st[-1] is not s:
                st.pop()            # exception unwound past inner spans
            if st:
                st.pop()

    def current_span(self) -> Optional[Span]:
        st = self._stack()
        return st[-1] if st else None

    def span(self, name: str, parent: Optional[SpanContext] = None,
             **attrs) -> Span:
        return self._open(name, parent, attrs)

    def _open(self, name: str, parent: Optional[SpanContext],
              attrs: Dict[str, object]) -> Span:
        if parent is not None:
            return Span(self, name, parent[1], attrs)
        st = self._stack()
        return Span(self, name, st[-1].span_id if st else None, attrs)

    # --- events -----------------------------------------------------------
    def add_events(self, events: List[Dict[str, object]]) -> None:
        if not events:
            return
        with self._lock:
            self._events.extend(events)

    @property
    def events(self) -> List[Dict[str, object]]:
        """The events; a closed span's is built here, once."""
        with self._lock:
            self._events = [e.event() if isinstance(e, Span) else e
                            for e in self._events]
            return list(self._events)

    def to_chrome(self) -> Dict[str, object]:
        return to_chrome_trace(self.events)


def to_chrome_trace(events: List[Dict[str, object]]) -> Dict[str, object]:
    """The chrome://tracing / Perfetto file format."""
    return {"traceEvents": sorted(events, key=lambda e: e.get("ts", 0)),
            "displayTimeUnit": "ms"}


# --- the active tracer ----------------------------------------------------
_active: Optional[Tracer] = None
_active_lock = threading.Lock()


def activate(tracer: Tracer) -> None:
    global _active
    with _active_lock:
        _active = tracer


def deactivate(tracer: Tracer) -> None:
    global _active
    with _active_lock:
        if _active is tracer:
            _active = None


def current_tracer() -> Optional[Tracer]:
    return _active


def span(name: str, parent: Optional[SpanContext] = None, **attrs):
    """Open a span on the active tracer; a shared no-op when tracing is
    off (the <2% disabled-overhead contract: one global read + compare)."""
    t = _active
    if t is None:
        return NOOP_SPAN
    return t._open(name, parent, attrs)


def current_context() -> Optional[SpanContext]:
    """(trace_id, span_id) of this thread's innermost open span — the
    value farm pipe messages and serving RPC frames carry."""
    t = _active
    if t is None:
        return None
    s = t.current_span()
    return s.context if s is not None else None


# --- validation -----------------------------------------------------------
def validate_events(events: List[Dict[str, object]],
                    expect_root: Optional[str] = None) -> List[str]:
    """Span-tree wellformedness problems (empty list == valid):
    required keys present, ids unique, exactly one root, every parent id
    resolves (no orphans), statuses closed as ok|error."""
    problems: List[str] = []
    spans = [e for e in events if e.get("ph") == "X"]
    if not spans:
        return ["no span events"]
    ids: Dict[str, Dict] = {}
    roots: List[Dict] = []
    for e in spans:
        for k in ("name", "ts", "dur", "pid", "args"):
            if k not in e:
                problems.append(f"span missing key {k!r}: {e}")
        args = e.get("args", {})
        sid = args.get("span_id")
        if sid is None:
            problems.append(f"span {e.get('name')!r} has no span_id")
            continue
        if sid in ids:
            problems.append(f"duplicate span_id {sid}")
        ids[sid] = e
        if args.get("status") not in ("ok", "error"):
            problems.append(
                f"span {e.get('name')!r} ({sid}) has unclosed status "
                f"{args.get('status')!r}")
        if args.get("parent_id") is None:
            roots.append(e)
    if len(roots) != 1:
        problems.append(f"expected exactly 1 root span, found "
                        f"{len(roots)}: "
                        f"{[r.get('name') for r in roots]}")
    elif expect_root is not None and roots[0].get("name") != expect_root:
        problems.append(f"root span is {roots[0].get('name')!r}, "
                        f"expected {expect_root!r}")
    for e in spans:
        pid = e.get("args", {}).get("parent_id")
        if pid is not None and pid not in ids:
            problems.append(f"orphan span {e.get('name')!r} "
                            f"({e['args'].get('span_id')}): parent "
                            f"{pid!r} not in trace")
    return problems
