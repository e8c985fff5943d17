"""Client for the networked elastic master (native/src/master_server.cc)
— `paddle_tpu/data/master_client.py` for the port, speaking the same
frames: the port's client talks to the JAX package's server and back.
Its counters and spans go to the port's own `obs/metrics` and
`obs/tracing`.

The counterpart of the reference's Go master client
(go/master/client.go, consumed from Python via ctypes in
python/paddle/v2/master/client.py): trainer processes connect over TCP,
lease chunk tasks, and report done/failed. `MasterClient` duck-types
`paddle_tpu_torch.native.master.Master`, so
`paddle_tpu_torch.data.reader.elastic` works with either — in-process
for single-host, networked for multi-host fault tolerance.

Resilience: every call reconnects and retries for up to
`retry_seconds` with capped exponential backoff and FULL JITTER
(delay ~ U(0, min(cap, base*2^attempt)) — decorrelates a thundering
herd of trainers hammering a restarting master). Connection-shaped
errors (refused/reset/EOF/timeout: the master is restarting from its
snapshot, go/master/service.go:166-207) retry; malformed frames are a
`MasterProtocolError` and fail fast — retrying a peer that speaks the
wrong protocol only hides a real bug. Every recv is bounded by the
remaining retry budget, so a master that ACCEPTS but never answers (a
black hole) still trips the deadline instead of hanging the trainer
on an unbounded read. When the deadline expires the caller gets a
`MasterRetryTimeout` naming the address, elapsed time and attempt
count instead of a generic socket error. Lease state
lives on the server, so a client reconnect does not lose or duplicate
tasks.
"""

from __future__ import annotations

import random
import socket
import struct
import time
from typing import Optional

from paddle_tpu_torch.obs import metrics as _obs
from paddle_tpu_torch.obs import tracing as _tracing

_BACKOFF_BASE = 0.05
_BACKOFF_CAP = 1.0
_MAX_FRAME = 1 << 30  # >1GiB response length = garbage, not a frame


class MasterError(Exception):
    """Base for master-client failures."""


class MasterProtocolError(MasterError):
    """The peer answered with a malformed frame. NOT retried: the
    master is alive but speaking garbage (version skew, wrong port) —
    reconnecting cannot fix it."""


class MasterRetryTimeout(MasterError, ConnectionError):
    """The master stayed unreachable for the whole retry budget.
    Subclasses ConnectionError so pre-existing `except ConnectionError`
    callers (ping, elastic readers) keep working."""

_OP_ADD_TASK = 1
_OP_GET_TASK = 2
_OP_TASK_DONE = 3
_OP_TASK_FAILED = 4
_OP_PASS_FINISHED = 5
_OP_START_PASS = 6
_OP_COUNT = 7
_OP_SET_LEASE = 8
_OP_SNAPSHOT = 9
_OP_REQUEST_SAVE = 10
_OP_PING = 11
_OP_SHUTDOWN = 12

_OP_NAMES = {
    _OP_ADD_TASK: "add_task", _OP_GET_TASK: "get_task",
    _OP_TASK_DONE: "task_done", _OP_TASK_FAILED: "task_failed",
    _OP_PASS_FINISHED: "pass_finished", _OP_START_PASS: "start_pass",
    _OP_COUNT: "count", _OP_SET_LEASE: "set_lease",
    _OP_SNAPSHOT: "snapshot", _OP_REQUEST_SAVE: "request_save",
    _OP_PING: "ping", _OP_SHUTDOWN: "shutdown",
}


class MasterClient:
    def __init__(
        self,
        addr: str,
        retry_seconds: float = 30.0,
        connect_timeout: float = 5.0,
        trace_carrier: Optional[dict] = None,
    ):
        """`addr` is "host:port". `trace_carrier`: an explicit tracing
        carrier ({"trace_id", "span_id"}, obs/tracing.py) this
        client's RPC spans join — how a trainer's lease/save path
        stays one trace across the master boundary even when the
        calling thread carries no tracing context (e.g. a reader
        thread). With neither a carrier nor an active context, RPCs
        are untraced (zero overhead)."""
        host, _, port = addr.rpartition(":")
        self._host = host or "127.0.0.1"
        self._port = int(port)
        self._retry = retry_seconds
        self._timeout = connect_timeout
        self._trace_carrier = trace_carrier
        self._sock: Optional[socket.socket] = None

    # ---- wire ----
    def _connect(self):
        s = socket.create_connection(
            (self._host, self._port), timeout=self._timeout
        )
        s.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
        self._sock = s

    def _recv_full(self, n: int) -> bytes:
        out = b""
        while len(out) < n:
            chunk = self._sock.recv(n - len(out))
            if not chunk:
                raise ConnectionError("master closed connection")
            out += chunk
        return out

    def _call_once(self, op: int, body: bytes,
                   timeout: Optional[float] = None) -> tuple:
        """One framed request/response. EVERY send/recv is bounded by
        `timeout` (default: the connect timeout) — a master that
        accepts but never answers (a black-hole failure: alive at TCP,
        dead at the protocol layer) surfaces as socket.timeout and
        enters the normal retry path instead of hanging the trainer
        forever past its retry deadline."""
        if self._sock is None:
            self._connect()
        self._sock.settimeout(
            self._timeout if timeout is None else timeout
        )
        frame = struct.pack("<IB", 1 + len(body), op) + body
        self._sock.sendall(frame)
        (rlen,) = struct.unpack("<I", self._recv_full(4))
        if rlen < 8 or rlen > _MAX_FRAME:
            # too short to carry a status / absurdly long: not our
            # protocol — poison the connection and fail fast
            self.close()
            raise MasterProtocolError(
                f"master at {self._host}:{self._port} sent a malformed "
                f"frame (length {rlen})"
            )
        resp = self._recv_full(rlen)
        (status,) = struct.unpack("<q", resp[:8])
        return status, resp[8:]

    def _call(self, op: int, body: bytes = b"") -> tuple:
        """AT-LEAST-ONCE delivery: a request retried after a connection
        error may have already been processed by the server. The
        protocol is designed so every duplicate is safe-by-semantics:
        duplicate TASK_DONE/TASK_FAILED return -1 (same as an expired
        lease — the caller path already treats that as lease-lost, and
        lease-timeout requeue makes task execution at-least-once anyway,
        exactly like the reference's Go master, go/master/service.go:313);
        duplicate GET_TASK just leases another task; a duplicate
        ADD_TASK can enqueue a chunk twice, which costs one redundant
        task but never corrupts pass accounting (the duplicate is its
        own task with its own done entry).

        Connection errors retry with capped full-jitter backoff until
        `retry_seconds`, then raise MasterRetryTimeout; malformed
        frames raise MasterProtocolError immediately. Each attempt's
        recv is bounded by the REMAINING retry budget (never less than
        the connect timeout, so a late first attempt still gets a fair
        read window) — the deadline fires even against a master that
        accepts and then goes silent. `min_timeout` raises the
        per-attempt floor for ops the server legitimately parks
        (save-model election blocks up to its block_seconds).

        Tracing: when a context or `trace_carrier` is active, the
        whole retried RPC is ONE parent span `master.<op>` whose
        attempts are sibling child spans `master.attempt` — a retry
        storm reads as N short failed attempts under one RPC, not N
        unrelated traces."""
        if self._trace_carrier is not None or \
                _tracing.current() is not None:
            name = _OP_NAMES.get(op, str(op))
            with _tracing.attach(self._trace_carrier):
                with _tracing.span(f"master.{name}", op=op) as sp:
                    try:
                        return self._call_retrying(op, body, sp)
                    except MasterError as e:
                        sp.status = type(e).__name__
                        raise
        return self._call_retrying(op, body, None)

    def _call_retrying(self, op: int, body: bytes, rpc_span) -> tuple:
        start = time.monotonic()
        deadline = start + self._retry
        attempt = 0
        min_timeout = self._timeout
        if op == _OP_REQUEST_SAVE:
            (block_s,) = struct.unpack("<d", body[:8])
            min_timeout = max(min_timeout, block_s + 5.0)
        reg = _obs.get_registry()
        while True:
            att = (
                _tracing.start_span(
                    "master.attempt", trace_id=rpc_span.trace_id,
                    parent_id=rpc_span.span_id, attempt=attempt,
                ) if rpc_span is not None else None
            )
            try:
                remaining = deadline - time.monotonic()
                result = self._call_once(
                    op, body, timeout=max(remaining, min_timeout)
                )
                if att is not None:
                    att.finish("ok")
                return result
            except MasterProtocolError:
                if att is not None:
                    att.finish("protocol_error")
                reg.counter("master_client.protocol_errors").inc()
                raise  # alive-but-wrong peer: retrying hides the bug
            except (OSError, ConnectionError) as e:
                if att is not None:
                    att.finish(type(e).__name__)
                self.close()
                reg.counter("master_client.retries").inc(op=op)
                now = time.monotonic()
                if now >= deadline:
                    reg.counter(
                        "master_client.retry_timeouts"
                    ).inc(op=op)
                    raise MasterRetryTimeout(
                        f"master at {self._host}:{self._port} "
                        f"unreachable for {now - start:.1f}s "
                        f"({attempt + 1} attempts, retry_seconds="
                        f"{self._retry}); last error: "
                        f"{type(e).__name__}: {e}"
                    ) from e
                # full jitter: U(0, min(cap, base*2^attempt)), clipped
                # to the remaining budget so the deadline is honored
                ceil = min(_BACKOFF_CAP, _BACKOFF_BASE * (2 ** attempt))
                delay = min(random.uniform(0, ceil), deadline - now)
                reg.counter("master_client.backoff_s").inc(delay)
                time.sleep(delay)
                attempt += 1

    def close(self):
        if self._sock is not None:
            try:
                self._sock.close()
            finally:
                self._sock = None

    # ---- Master-compatible API ----
    def add_task(self, payload) -> int:
        if isinstance(payload, str):
            payload = payload.encode()
        status, _ = self._call(_OP_ADD_TASK, payload)
        return status

    def add_chunk_tasks(self, path: str, num_chunks: int) -> None:
        import json

        for i in range(num_chunks):
            self.add_task(json.dumps({"path": path, "chunk": i}).encode())

    def get_task(self) -> Optional[tuple]:
        """Lease a task: (task_id, payload) or None if nothing leasable."""
        status, body = self._call(_OP_GET_TASK)
        if status == -3:
            return None
        if status < 0:
            raise RuntimeError(f"get_task failed (code {status})")
        (lease,) = struct.unpack("<q", body[:8])
        return lease, body[8 : 8 + status]

    def task_done(self, task_id: int) -> bool:
        status, _ = self._call(_OP_TASK_DONE, struct.pack("<q", task_id))
        return status == 0

    def task_failed(self, task_id: int) -> bool:
        status, _ = self._call(_OP_TASK_FAILED, struct.pack("<q", task_id))
        return status == 0

    def pass_finished(self) -> bool:
        status, _ = self._call(_OP_PASS_FINISHED)
        return status == 1

    def start_pass(self) -> int:
        status, _ = self._call(_OP_START_PASS)
        return status

    @property
    def counts(self) -> dict:
        out = {}
        for i, k in enumerate(("todo", "pending", "done", "discarded")):
            status, _ = self._call(_OP_COUNT, struct.pack("<i", i))
            out[k] = status
        return out

    def set_lease(self, seconds: float) -> None:
        self._call(_OP_SET_LEASE, struct.pack("<d", seconds))

    def snapshot(self) -> None:
        status, _ = self._call(_OP_SNAPSHOT)
        if status != 0:
            raise IOError(
                "snapshot failed"
                + (" (server has no snapshot path)" if status == -2 else "")
            )

    def request_save_model(
        self, trainer_id: str, block_seconds: float = 60.0
    ) -> bool:
        """Save-model election (go/master/service.go:467-495)."""
        status, _ = self._call(
            _OP_REQUEST_SAVE,
            struct.pack("<d", block_seconds) + trainer_id.encode(),
        )
        if status < 0:
            raise ValueError("trainer_id must be non-empty")
        return status == 1

    def ping(self) -> bool:
        try:
            return self._call_once(_OP_PING, b"")[0] == 0
        except (OSError, ConnectionError):
            self.close()
            return False

    def shutdown(self) -> None:
        """Ask the serving process to stop (it snapshots first if
        configured)."""
        try:
            self._call_once(_OP_SHUTDOWN, b"")
        except (OSError, ConnectionError):
            pass
        finally:
            self.close()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()
