"""TCP front end: length-prefixed JSON over a threaded socket server.

The port of `paddle_tpu/serving/tcp.py`: the same protocol on the wire,
so a client of either implementation talks to both.

Frame = 4-byte LE length + UTF-8 JSON. Request:

    {"model": str, "ids": [int, ...], "deadline_ms": int?,
     "hooks": str?,            # hooks = a model-registered hook name
     "trace": {"trace_id": str, "span_id": str}?}   # trace carrier
  | {"metricz": true}          # telemetry scrape (no inference)
  | {"tracez": true, "top": int?}   # slow-request exemplars
  | {"flightz": true}          # flight-ring dump (incident stitch)
  | {"admin": "swap_model", "model": str, "tag": str?}  # hot-swap

Response:

    {"ok": true, "id": int, "tokens": [...], "score": float,
     "path": str, "latency_ms": float, "trace_id": str?}
  | {"ok": false, "error": "overloaded"|"deadline"|"quarantined"|
     "shutting_down"|"unknown_model"|"unknown_hook"|"execution"|
     "bad_request"}
  | {"ok": true, "metricz": <registry snapshot>, "stats": <server
     stats>}                   # for a metricz request
  | {"ok": true, "tracez": [exemplar, ...]}   # for a tracez request
  | {"ok": true, "flightz": {"pid": int, "enabled": bool,
     "events": [...], "capacity": int}}   # for a flightz request

The `trace` carrier makes one trace_id span the whole request path:
the client's `client.request` span, the server's `serve.request` root
and its queued / batch-form / dispatch / decode children all join the
caller's trace (obs/tracing.py). `tracez`, like `metricz`, is
answered OUTSIDE the admission queue: the slow-request exemplars
(latency + queued-vs-dispatch split + trace_id) stay scrapeable while
the server sheds.

`metricz` serves the process-wide obs registry (queue depth +
high-water mark, batch occupancy, shed/breaker counts, admitted-
latency histograms — plus whatever else the process recorded) without
touching the admission queue, so a scrape succeeds even when the
server is overloaded and shedding inference traffic.

Robustness contract: a client that vanishes — RST mid-request,
half-written frame, cut mid-response — costs the server exactly one
connection-handler thread unwinding on OSError. The
in-flight request still reaches a terminal state inside
InferenceServer (nothing leaks), and every other connection keeps
being served.
"""

from __future__ import annotations

import json
import os
import random
import socket
import struct
import threading
import time

from paddle_tpu_torch.obs import flight_recorder as _flight
from paddle_tpu_torch.obs import metrics as _obs
from paddle_tpu_torch.obs import tracing as _tracing
from paddle_tpu_torch.serving.server import (
    InferenceServer,
    ServeError,
    ServeRejected,
)
_MAX_FRAME = 1 << 24  # 16 MiB of JSON is garbage, not a request


def send_msg(sock: socket.socket, obj: dict) -> None:
    body = json.dumps(obj).encode()
    sock.sendall(struct.pack("<I", len(body)) + body)


def recv_msg(sock: socket.socket):
    """One frame, or None on clean EOF. Raises ConnectionError on a
    torn frame or an absurd length."""
    hdr = b""
    while len(hdr) < 4:
        chunk = sock.recv(4 - len(hdr))
        if not chunk:
            if hdr:
                raise ConnectionError("torn frame header")
            return None
        hdr += chunk
    (n,) = struct.unpack("<I", hdr)
    if n > _MAX_FRAME:
        raise ConnectionError(f"frame length {n} exceeds limit")
    body = b""
    while len(body) < n:
        chunk = sock.recv(n - len(body))
        if not chunk:
            raise ConnectionError("connection closed mid-frame")
        body += chunk
    return json.loads(body.decode())


class ServingTCPServer:
    """Accept loop + one handler thread per connection, all daemonic.
    `stop()` closes the listener and the open connections —
    `stop(drain=True)` first waits (bounded) for in-flight requests
    to finish and their responses to flush, then joins the handler
    threads, so "zero admitted requests lost" is a guarantee rather
    than a timing accident. The underlying InferenceServer
    is NOT shut down here (the CLI owns its drain) so in-flight
    dispatches complete.

    `model_loader` (optional): callable `(model_name, tag) -> model`
    backing the `{"admin": "swap_model"}` frame — the zero-downtime
    rollout hook. The loader runs on the admin connection's handler
    thread while every other connection keeps being served; the swap
    itself is atomic inside InferenceServer.swap_model."""

    def __init__(self, server: InferenceServer, host: str = "127.0.0.1",
                 port: int = 0, model_loader=None):
        self.server = server
        self.model_loader = model_loader
        self._listener = socket.socket()
        self._listener.setsockopt(socket.SOL_SOCKET,
                                  socket.SO_REUSEADDR, 1)
        self._listener.bind((host, port))
        self._listener.listen(64)
        self.port = self._listener.getsockname()[1]
        self._stopped = False
        self._conns: list = []
        self._handlers: list = []
        self._inflight = 0
        self._lock = threading.Lock()
        self._thread = threading.Thread(
            target=self._accept_loop, name="serve-tcp", daemon=True
        )
        self._thread.start()

    def _accept_loop(self):
        while not self._stopped:
            try:
                conn, _ = self._listener.accept()
            except OSError:
                return
            conn.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
            with self._lock:
                if self._stopped:
                    # raced stop_accepting() between accept() and
                    # registration: this connection would outlive
                    # stop()'s sweep of self._conns — close it here
                    # instead of serving it
                    try:
                        conn.close()
                    except OSError:
                        pass
                    return
                self._conns.append(conn)
                t = threading.Thread(target=self._serve_conn,
                                     args=(conn,), daemon=True)
                self._handlers.append(t)
                self._handlers = [
                    h for h in self._handlers if h.is_alive() or h is t
                ]
            t.start()

    def _serve_conn(self, conn: socket.socket):
        try:
            while True:
                try:
                    msg = recv_msg(conn)
                except (ConnectionError, OSError, ValueError):
                    return  # torn/garbage client: drop the connection
                if msg is None:
                    return
                # in-flight accounting covers handle AND the response
                # send: drain counts a request until its bytes left
                with self._lock:
                    self._inflight += 1
                try:
                    resp = self._handle(msg)
                    try:
                        send_msg(conn, resp)
                    except OSError:
                        return  # client gone mid-response: request
                        # already terminal server-side, nothing leaks
                finally:
                    with self._lock:
                        self._inflight -= 1
        finally:
            with self._lock:
                if conn in self._conns:
                    self._conns.remove(conn)
            try:
                conn.close()
            except OSError:
                pass

    def _handle(self, msg: dict) -> dict:
        if isinstance(msg, dict) and msg.get("metricz"):
            # telemetry scrape: answered outside the admission queue,
            # so it works during overload/drain
            return {
                "ok": True,
                "metricz": _obs.get_registry().snapshot(),
                "stats": self.server.stats(),
            }
        if isinstance(msg, dict) and msg.get("tracez"):
            # slow-request exemplars: also outside the admission queue
            try:
                top = int(msg.get("top", 10))
            except (TypeError, ValueError):
                return {"ok": False, "error": "bad_request",
                        "detail": f"top={msg.get('top')!r}"}
            return {
                "ok": True,
                "tracez": self.server.slow_exemplars(top=top),
            }
        if isinstance(msg, dict) and msg.get("flightz"):
            # flight-ring dump for cross-process incident stitching:
            # like metricz, answered OUTSIDE the admission queue — an
            # overloaded replica is exactly the one whose ring an
            # incident bundle needs
            rec = _flight.get_flight_recorder()
            return {
                "ok": True,
                "flightz": {
                    "pid": os.getpid(),
                    "enabled": rec is not None,
                    "events": rec.snapshot() if rec is not None else [],
                    "capacity": rec.capacity if rec is not None else 0,
                },
            }
        if isinstance(msg, dict) and msg.get("admin") == "swap_model":
            # zero-downtime hot swap: runs on this connection's handler
            # thread while every other connection keeps serving. The
            # actual switch is atomic inside InferenceServer.swap_model
            # (under the admission lock), so queued requests dispatch
            # against the new model and nothing is lost.
            name = msg.get("model")
            if not isinstance(name, str):
                return {"ok": False, "error": "bad_request",
                        "detail": "admin swap_model needs a model name"}
            if self.model_loader is None:
                return {"ok": False, "error": "no_loader",
                        "detail": "server started without a model_loader"}
            try:
                new_model = self.model_loader(name, msg.get("tag"))
                self.server.swap_model(name, new_model)
            except KeyError:
                return {"ok": False, "error": "unknown_model"}
            except Exception as e:
                return {"ok": False, "error": "swap_failed",
                        "detail": f"{type(e).__name__}: {e}"}
            return {"ok": True, "swapped": name,
                    "tag": msg.get("tag")}
        try:
            model = msg["model"]
            ids = msg["ids"]
            deadline_s = (
                msg["deadline_ms"] / 1e3 if "deadline_ms" in msg else None
            )
            hooks_name = msg.get("hooks")
            trace = msg.get("trace")
        except (KeyError, TypeError):
            return {"ok": False, "error": "bad_request"}
        try:
            req = self.server.submit(model, ids, deadline_s=deadline_s,
                                     hooks_name=hooks_name, trace=trace)
        except ServeRejected as e:
            return {"ok": False, "error": e.reason, "detail": str(e)}
        except Exception as e:
            # malformed payload (ids over the largest bucket, wrong
            # dtype, ...): the client gets bad_request, not a dropped
            # connection from a dead handler thread
            return {"ok": False, "error": "bad_request",
                    "detail": f"{type(e).__name__}: {e}"}
        try:
            # the scheduler enforces the deadline; the extra slack only
            # bounds a wedged dispatch so the handler thread cannot
            # block forever
            out = req.result(
                timeout=(req.deadline - req.t_submit) + 30.0
            )
        except ServeRejected as e:
            return {"ok": False, "error": e.reason, "id": req.id}
        except (ServeError, TimeoutError) as e:
            return {"ok": False, "error": "execution", "detail": str(e),
                    "id": req.id}
        resp = {"ok": True, "id": req.id,
                "latency_ms": round(req.latency_s * 1e3, 3)}
        if req.trace_id is not None:
            resp["trace_id"] = req.trace_id
        resp.update(out)
        return resp

    def stop_accepting(self, timeout: float = 1.0):
        """Close the listener only — established connections keep
        being served. Sets `_stopped` under the connection lock BEFORE
        closing the listener, so an accept() that races this call
        cannot register a new connection after `stop()` has swept
        `self._conns`; the accept thread is then joined (bounded) so
        no accept-loop activity overlaps the rest of the drain. The
        drain sequence is stop_accepting() ->
        InferenceServer.shutdown(drain=True) -> stop(drain=True), so
        clients with in-flight requests receive their drained
        responses instead of a reset. Idempotent."""
        with self._lock:
            self._stopped = True
        try:
            # shutdown() wakes a thread blocked in accept() (a bare
            # close() does not, on Linux); then release the fd
            self._listener.shutdown(socket.SHUT_RDWR)
        except OSError:
            pass
        try:
            self._listener.close()
        except OSError:
            pass
        if self._thread is not threading.current_thread():
            self._thread.join(timeout)

    def stop(self, drain: bool = False, timeout: float = 5.0):
        """Tear down the front end. With `drain=True`, wait (up to
        `timeout` seconds) for in-flight requests — admitted frames
        whose response has not yet been sent — to reach zero before
        closing connections, then join handler threads with the
        remaining deadline. Idle keep-alive connections do not count
        as in-flight, so drain cannot be stalled by a client that is
        merely connected."""
        deadline = time.monotonic() + timeout
        self.stop_accepting(timeout=min(1.0, timeout))
        if drain:
            while time.monotonic() < deadline:
                with self._lock:
                    if self._inflight == 0:
                        break
                time.sleep(0.005)
        with self._lock:
            conns, self._conns = self._conns, []
            handlers, self._handlers = self._handlers, []
        for c in conns:
            try:
                c.close()
            except OSError:
                pass
        if drain:
            for h in handlers:
                h.join(max(0.0, deadline - time.monotonic()))


class ServeClient:
    """Blocking single-connection client (tests + load generator).
    Reconnects lazily after a connection error.

    `_connect` retries refused/reset connects with jittered
    exponential backoff (`retries` attempts beyond the first,
    doubling from `backoff_s` capped at `backoff_max_s`): the fleet
    router rides over a replica restart instead of failing the first
    request after a respawn. `retries=0` preserves fail-fast
    behavior for tests that assert a dead address errors
    immediately."""

    def __init__(self, addr: str, connect_timeout: float = 5.0,
                 retries: int = 3, backoff_s: float = 0.05,
                 backoff_max_s: float = 1.0,
                 admin_timeout: float = 5.0):
        host, _, port = addr.rpartition(":")
        self._host = host or "127.0.0.1"
        self._port = int(port)
        self._timeout = connect_timeout
        self._retries = max(0, int(retries))
        self._backoff_s = backoff_s
        self._backoff_max_s = backoff_max_s
        # admin frames (metricz/tracez/flightz) default to a BOUNDED
        # timeout distinct from the request path: a black-holed replica
        # must cost a poller `admin_timeout`, not a thread wedged forever
        self._admin_timeout = admin_timeout
        self._sock = None

    def _connect(self):
        delay = self._backoff_s
        for attempt in range(self._retries + 1):
            try:
                sock = socket.create_connection(
                    (self._host, self._port), timeout=self._timeout
                )
                break
            except (ConnectionRefusedError, ConnectionResetError):
                if attempt == self._retries:
                    raise
                # full jitter on the low half so a fleet of clients
                # reconnecting to a restarted replica doesn't stampede
                time.sleep(delay * (0.5 + random.random() * 0.5))
                delay = min(delay * 2, self._backoff_max_s)
        sock.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
        sock.settimeout(None)
        self._sock = sock

    def call(self, model: str, ids, deadline_ms: int = None,
             hooks: str = None, timeout: float = None,
             trace=None) -> dict:
        """`trace`: None = inherit any active tracing context (the
        request joins it, with a `client.request` span around the
        roundtrip); True = force a fresh trace even without context;
        a carrier dict = join that remote trace; False = never
        trace."""
        msg = {"model": model, "ids": list(map(int, ids))}
        if deadline_ms is not None:
            msg["deadline_ms"] = int(deadline_ms)
        if hooks is not None:
            msg["hooks"] = hooks
        if isinstance(trace, dict):
            with _tracing.attach(trace):
                return self._traced_roundtrip(msg, timeout)
        if trace is True or (trace is None
                             and _tracing.current() is not None):
            return self._traced_roundtrip(msg, timeout)
        return self._roundtrip(msg, timeout)

    def _traced_roundtrip(self, msg: dict, timeout) -> dict:
        with _tracing.span("client.request",
                           model=msg.get("model", "")) as sp:
            msg["trace"] = _tracing.inject()
            resp = self._roundtrip(msg, timeout)
            if isinstance(resp, dict) and not resp.get("ok", False):
                sp.status = resp.get("error", "error")
            return resp

    def metricz(self, timeout: float = None) -> dict:
        """Scrape the server's registry snapshot + stats."""
        return self._roundtrip({"metricz": True},
                               self._admin(timeout))

    def tracez(self, top: int = 10, timeout: float = None) -> dict:
        """Scrape the server's slow-request exemplars."""
        return self._roundtrip({"tracez": True, "top": int(top)},
                               self._admin(timeout))

    def flightz(self, timeout: float = None) -> dict:
        """Fetch the server's flight-ring dump (incident stitching)."""
        return self._roundtrip({"flightz": True},
                               self._admin(timeout))

    def _admin(self, timeout):
        return timeout if timeout is not None else self._admin_timeout

    def _roundtrip(self, msg: dict, timeout: float = None) -> dict:
        if self._sock is None:
            self._connect()
        try:
            # set every call: None restores blocking mode, so a
            # timeout passed once cannot leak into later calls
            self._sock.settimeout(timeout)
            send_msg(self._sock, msg)
            resp = recv_msg(self._sock)
        except (OSError, ConnectionError):
            self.close()
            raise
        if resp is None:
            self.close()
            raise ConnectionError("server closed connection")
        return resp

    def close(self):
        if self._sock is not None:
            try:
                self._sock.close()
            finally:
                self._sock = None

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()
