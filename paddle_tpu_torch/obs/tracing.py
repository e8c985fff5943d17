"""Distributed tracing: spans, context, and cross-process carriers.

The metrics registry answers "how much, in aggregate"; this module
answers "where did THIS request spend its time" — a causally-linked
span tree that survives process boundaries:

- A **span** is one named, timed operation: `trace_id` (shared by the
  whole causal chain), `span_id`, `parent_id`, a wall-clock start
  (`ts`), a duration (`dur_s`), free-form string `labels`, and a
  `status` ("ok" or a failure reason). Finished spans are emitted as
  `kind="span"` events on the registry's JSONL EventStream — there is
  no second export pipe to keep alive.

- **Thread-local context** (`span(...)` context manager) nests spans
  automatically within one thread. Code that crosses threads or wants
  to stamp spans post-hoc from timestamps it already measured (the
  serving scheduler) uses the explicit API:
  `new_trace_id()` / `new_span_id()` / `emit_span(...)`.

- The **carrier** is an explicit dict `{"trace_id": ..., "span_id":
  ...}` — small enough to ride any protocol that can carry two
  strings (the serving TCP JSON frame's `trace` field, an env var for
  spawned workers). `inject()` captures the current context into a
  carrier; `attach(carrier)` makes a remote parent the local context
  so this process's spans join the caller's trace.

Sampling is owned by the instrumented subsystems (serving traces
every carrier-bearing request plus every `trace_serve_period`-th
anonymous one), not here: emitting a span with no stream attached
costs one None check.

A copy of the JAX package's `obs/tracing.py` (same span records and
carrier, so one trace can cross both implementations). Pure stdlib.
"""

from __future__ import annotations

import binascii
import os
import threading
import time
from typing import Optional

from paddle_tpu_torch.obs import metrics as _metrics

# env var a parent process sets to make a child's spans join its
# trace (the spawned-worker analogue of the TCP `trace` field)
CARRIER_ENV = "PADDLE_TRACE_CARRIER"


def new_trace_id() -> str:
    """128-bit random hex — collision-safe across processes."""
    return binascii.hexlify(os.urandom(16)).decode()


def new_span_id() -> str:
    """64-bit random hex."""
    return binascii.hexlify(os.urandom(8)).decode()


class _Context(threading.local):
    def __init__(self):
        self.stack = []  # [(trace_id, span_id), ...]


_ctx = _Context()


def current() -> Optional[tuple]:
    """(trace_id, span_id) of the innermost active span/attachment in
    this thread, or None."""
    return _ctx.stack[-1] if _ctx.stack else None


def inject() -> Optional[dict]:
    """Current context as a carrier dict, or None outside any trace."""
    cur = current()
    if cur is None:
        return None
    return {"trace_id": cur[0], "span_id": cur[1]}


def extract(carrier) -> Optional[tuple]:
    """Parse a carrier dict into (trace_id, parent_span_id); None on
    anything malformed — a bad carrier degrades to an untraced
    operation, never an error on the serving path."""
    if not isinstance(carrier, dict):
        return None
    tid, sid = carrier.get("trace_id"), carrier.get("span_id")
    if not isinstance(tid, str) or not tid:
        return None
    if not isinstance(sid, str) or not sid:
        sid = ""
    return tid, sid


class attach:
    """Context manager: make `carrier` the current context WITHOUT
    opening a span — spans created inside become children of the
    remote parent. A None/malformed carrier attaches nothing (the
    body still runs)."""

    def __init__(self, carrier):
        self._parsed = extract(carrier)

    def __enter__(self):
        if self._parsed is not None:
            _ctx.stack.append(self._parsed)
        return self

    def __exit__(self, *exc):
        if self._parsed is not None:
            _ctx.stack.pop()
        return False


def attach_from_env():
    """`attach` using the CARRIER_ENV env var (JSON carrier) — how a
    spawned worker joins the trace of the process that launched it."""
    import json

    raw = os.environ.get(CARRIER_ENV)
    carrier = None
    if raw:
        try:
            carrier = json.loads(raw)
        except ValueError:
            carrier = None
    return attach(carrier)


class Span:
    """One in-flight operation. Created by `span(...)` (context-
    managed, thread-local nesting) or `start_span(...)` (manual;
    caller must call `finish()`). Emission happens at finish()."""

    __slots__ = ("name", "trace_id", "span_id", "parent_id", "labels",
                 "status", "_t0_mono", "_ts_wall", "_registry",
                 "_finished")

    def __init__(self, name: str, trace_id: str, parent_id: str,
                 labels: Optional[dict] = None, registry=None):
        self.name = name
        self.trace_id = trace_id
        self.span_id = new_span_id()
        self.parent_id = parent_id or ""
        self.labels = dict(labels) if labels else {}
        self.status = "ok"
        self._t0_mono = time.monotonic()
        self._ts_wall = time.time()
        self._registry = registry
        self._finished = False

    def set_label(self, key: str, value) -> None:
        self.labels[str(key)] = value

    def finish(self, status: Optional[str] = None) -> None:
        if self._finished:
            return
        self._finished = True
        if status is not None:
            self.status = status
        emit_span(
            self.name, self.trace_id, self.span_id, self.parent_id,
            dur_s=time.monotonic() - self._t0_mono,
            ts=self._ts_wall, status=self.status, labels=self.labels,
            registry=self._registry,
        )


class span:
    """`with span("master.get_task", op=2) as s:` — child of the
    current thread context (or the root of a brand-new trace), pushed
    while the body runs, emitted on exit; an exception marks status
    "error" and propagates."""

    def __init__(self, name: str, registry=None, **labels):
        self._name = name
        self._labels = labels
        self._registry = registry
        self._span: Optional[Span] = None

    def __enter__(self) -> Span:
        cur = current()
        tid = cur[0] if cur else new_trace_id()
        parent = cur[1] if cur else ""
        self._span = Span(self._name, tid, parent, self._labels,
                          registry=self._registry)
        _ctx.stack.append((tid, self._span.span_id))
        return self._span

    def __exit__(self, exc_type, exc, tb):
        _ctx.stack.pop()
        if exc_type is not None and self._span.status == "ok":
            self._span.status = "error"
        self._span.finish()
        return False


def start_span(name: str, trace_id: Optional[str] = None,
               parent_id: Optional[str] = None, registry=None,
               **labels) -> Span:
    """Manual span: NOT pushed on the thread context (safe to finish
    from another thread). Defaults parent to the current context."""
    if trace_id is None:
        cur = current()
        if cur is not None:
            trace_id, parent_id = cur[0], parent_id or cur[1]
        else:
            trace_id = new_trace_id()
    return Span(name, trace_id, parent_id or "", labels,
                registry=registry)


def emit_span(name: str, trace_id: str, span_id: str, parent_id: str,
              dur_s: float, ts: Optional[float] = None,
              t0_mono: Optional[float] = None, status: str = "ok",
              labels: Optional[dict] = None, registry=None) -> None:
    """Emit one finished span record (post-hoc path: the caller
    already measured the interval). `ts` is the wall-clock START; when
    only a monotonic start `t0_mono` is known, the wall start is
    recovered via the current mono->wall offset (valid within one
    process — exactly where monotonic stamps come from)."""
    if ts is None:
        if t0_mono is not None:
            ts = time.time() - (time.monotonic() - t0_mono)
        else:
            ts = time.time() - dur_s
    reg = registry or _metrics.get_registry()
    reg.event(
        "span",
        name=name,
        trace_id=trace_id,
        span_id=span_id,
        parent_id=parent_id or "",
        ts=round(ts, 6),
        dur_s=round(dur_s, 9),
        status=status,
        labels=labels or {},
    )
