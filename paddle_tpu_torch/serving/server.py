"""Continuous-batching inference server with overload protection.

The port of `paddle_tpu/serving/server.py`. Requests arrive
continuously and variable-length, are admitted into a BOUNDED queue
(full queue = explicit rejection, never unbounded growth), and a
scheduler thread packs compatible requests — same model, same length
bucket, same hook configuration — into batches dispatched to the
model. SLO machinery, in dispatch order:

- **Load shedding at admission.** `submit` rejects with
  `ServeRejected("overloaded")` the instant the queue is full:
  overload shows up as fast explicit failures the client can retry
  elsewhere, not as latency collapse.
- **Deadline-aware batch formation.** Every request carries a
  deadline. At batch-formation time the scheduler drops requests whose
  deadline has passed OR whose remaining budget is smaller than the
  model's EWMA batch service time — expired work is rejected BEFORE it
  reaches the device, not after.
- **Bucketed packing.** Sequence lengths round up to the configured
  buckets and batch sizes round up to power-of-two batch buckets.
- **Circuit breaker per model.** `breaker_threshold` consecutive
  dispatch failures quarantine the model: submits reject instantly
  with `ServeRejected("quarantined")` for `breaker_reset_s`, then one
  half-open probe batch decides re-close vs re-open.
- **Drain on shutdown.** `shutdown(drain=True)` stops admission
  (rejects with "shutting_down"), lets the scheduler finish or
  deadline-reject everything queued, and joins the workers. Every
  request ever admitted reaches a terminal state — nothing leaks.

Not ported yet (the JAX server has them, ROADMAP A6): co-dispatch of
several models in one program (`MultiForwardHost`), the host-fallback
rescue of a failed device dispatch (a request that names a hook already
takes the model's host rung, `serving/models.py`), recompile guards,
and the flight-recorder anomaly dumps.
"""

from __future__ import annotations

import itertools
import threading
import time
from collections import deque
from dataclasses import dataclass, field
from typing import Optional

import numpy as np

from paddle_tpu_torch.analysis.lock_order import named_lock
from paddle_tpu_torch.core import flags as _flags
from paddle_tpu_torch.data.feeder import _bucket
from paddle_tpu_torch.obs import metrics as _obs
from paddle_tpu_torch.obs import tracing as _tracing


class ServeRejected(Exception):
    """Explicit request rejection. `reason` is one of: overloaded,
    deadline, quarantined, shutting_down, unknown_model,
    unknown_hook."""

    def __init__(self, reason: str, detail: str = ""):
        super().__init__(f"{reason}{': ' + detail if detail else ''}")
        self.reason = reason


class ServeError(Exception):
    """The request was dispatched but execution failed."""


@dataclass
class ServeConfig:
    max_queue: int = 64           # admission bound (requests)
    max_batch: int = 8            # per-dispatch batch cap
    default_deadline_s: float = 2.0
    buckets: tuple = (8, 16, 32, 64, 128)  # sequence-length buckets
    breaker_threshold: int = 3    # consecutive failures -> quarantine
    breaker_reset_s: float = 5.0  # quarantine window before half-open
    workers: int = 1              # scheduler/dispatch threads
    # margin multiplier on the EWMA service time used by the
    # deadline-aware batch former (drop if remaining < ewma * margin)
    service_margin: float = 1.0

    def batch_bucket(self, n: int) -> int:
        b = 1
        while b < n and b < self.max_batch:
            b *= 2
        return min(b, self.max_batch)


_ids = itertools.count(1)


class PendingResult:
    """Handle returned by submit(): blocks in result(), or poll state.
    Terminal states: done / rejected / error."""

    __slots__ = ("id", "model", "ids", "bucket", "deadline", "hooks",
                 "hooks_key", "t_submit", "t_done", "_event", "_result",
                 "_exc", "trace_id", "parent_span", "span_id",
                 "t_popped")

    def __init__(self, model, ids, bucket, deadline, hooks, hooks_key,
                 trace=None):
        self.id = next(_ids)
        self.model = model
        self.ids = ids
        self.bucket = bucket
        self.deadline = deadline
        self.hooks = hooks
        self.hooks_key = hooks_key
        self.t_submit = time.monotonic()
        self.t_done = None
        # tracing: (trace_id, parent span from the carrier); span_id
        # is this request's pre-allocated `serve.request` root so
        # spans can be stamped post-hoc from any worker thread
        self.trace_id = trace[0] if trace else None
        self.parent_span = (trace[1] or "") if trace else ""
        self.span_id = _tracing.new_span_id() if trace else None
        self.t_popped = None  # set when batch formation picks it up
        self._event = threading.Event()
        self._result = None
        self._exc = None

    # -- completion (server side) --
    def _finish(self, result=None, exc=None):
        self._result, self._exc = result, exc
        self.t_done = time.monotonic()
        self._event.set()

    # -- consumption (client side) --
    @property
    def state(self) -> str:
        if not self._event.is_set():
            return "pending"
        if self._exc is None:
            return "done"
        if isinstance(self._exc, ServeRejected):
            return f"rejected:{self._exc.reason}"
        return "error"

    @property
    def latency_s(self) -> Optional[float]:
        return None if self.t_done is None else self.t_done - self.t_submit

    def result(self, timeout: float = None):
        if not self._event.wait(timeout):
            raise TimeoutError(f"request {self.id} still pending")
        if self._exc is not None:
            raise self._exc
        return self._result


class _Breaker:
    """Per-model circuit breaker: closed -> open after N consecutive
    failures -> half-open probe after reset_s -> closed on success.
    State transitions are counted in the process registry
    (`serving.breaker_opens{model=}` / `serving.dispatch_failures`).
    Thread-safe on its own lock, a leaf ordered strictly after
    `serving.admission` wherever both are held: two threads racing
    `try_probe()` in half-open admit exactly one probe."""

    def __init__(self, threshold: int, reset_s: float,
                 model: str = ""):
        self.threshold = threshold
        self.reset_s = reset_s
        self.model = model
        self.failures = 0
        self.opened_at = None
        self.probing = False
        self._lock = named_lock("serving.breaker")

    @property
    def state(self) -> str:
        if self.opened_at is None:
            return "closed"
        if time.monotonic() - self.opened_at >= self.reset_s:
            return "half-open"
        return "open"

    def admits(self) -> bool:
        return self.state != "open"

    def try_probe(self) -> bool:
        """In half-open, exactly one in-flight probe batch at a time —
        the probing flag is checked-and-set under the breaker lock, so
        concurrent callers cannot both win."""
        with self._lock:
            st = self.state
            if st == "closed":
                return True
            if st == "half-open" and not self.probing:
                self.probing = True
                return True
            return False

    def record(self, ok: bool):
        """A failed record while open/half-open re-opens the breaker
        with the backoff window reset (opened_at moves to now): a
        failed probe buys a full fresh quarantine, not a shortened
        one."""
        with self._lock:
            self.probing = False
            if ok:
                self.failures = 0
                self.opened_at = None
            else:
                self.failures += 1
                _obs.get_registry().counter(
                    "serving.dispatch_failures"
                ).inc(model=self.model)
                if self.failures >= self.threshold:
                    was_open = self.opened_at is not None
                    self.opened_at = time.monotonic()
                    if not was_open:
                        _obs.get_registry().counter(
                            "serving.breaker_opens"
                        ).inc(model=self.model)


@dataclass
class _ModelEntry:
    model: object
    breaker: _Breaker
    ewma_batch_s: float = 0.0     # EWMA dispatch service time
    dispatch_keys: set = field(default_factory=set)


class InferenceServer:
    """Register models with add_model(), feed it with submit(), stop it
    with shutdown(). Thread-safe; owns `config.workers` scheduler
    threads. A model is any object with

        run_batch(ids [B, T_bucket] int32, lens [B] int32,
                  hooks, host: bool) -> list of per-row result dicts

    plus optional `named_hooks` (str -> hooks, the TCP-addressable
    hook registry)."""

    def __init__(self, config: ServeConfig = None):
        self.config = config or ServeConfig()
        self._models: dict = {}
        self._queue: deque = deque()
        # the admission-queue lock — a known lock for the lock-order
        # checker (analysis/lock_order.py); the instrumented wrapper is
        # Condition-compatible
        self._lock = named_lock("serving.admission")
        self._work = threading.Condition(self._lock)
        self._draining = False
        self._stopped = False
        self._stats = {
            "admitted": 0, "completed": 0,
            "shed_overload": 0, "shed_deadline": 0, "shed_quarantined": 0,
            "shed_shutdown": 0, "failed": 0, "batches": 0,
            "max_queue_depth": 0,
        }
        # recent completed-request exemplars for the `tracez` scrape
        self._slow: deque = deque(maxlen=256)
        self._trace_seq = itertools.count(1)  # anonymous-trace sampler
        self._threads = [
            threading.Thread(target=self._worker, name=f"serve-{i}",
                             daemon=True)
            for i in range(self.config.workers)
        ]
        for t in self._threads:
            t.start()

    # ------------------------------------------------------------ API
    def add_model(self, name: str, model) -> None:
        with self._lock:
            self._models[name] = _ModelEntry(
                model=model,
                breaker=_Breaker(self.config.breaker_threshold,
                                 self.config.breaker_reset_s,
                                 model=name),
            )

    def swap_model(self, name: str, model) -> None:
        """Atomic hot-swap: replace `name`'s model behind the admission
        queue. Requests already queued dispatch on the NEW model (batch
        formation resolves the entry at pop time); batches already in
        flight complete on the old one. The fresh entry also resets
        the breaker and the EWMA service time."""
        with self._lock:
            if name not in self._models:
                raise KeyError(f"unknown model {name!r}")
            self._models[name] = _ModelEntry(
                model=model,
                breaker=_Breaker(self.config.breaker_threshold,
                                 self.config.breaker_reset_s,
                                 model=name),
            )
        _obs.get_registry().counter("serving.model_swaps").inc(
            model=name
        )

    def submit(self, model: str, ids, deadline_s: float = None,
               hooks=None, hooks_name: str = None,
               trace=None) -> PendingResult:
        """Admit one request (ids: 1-D int sequence). Raises
        ServeRejected instead of queueing when the server cannot meet
        it — the explicit-shed contract.

        `trace`: an optional carrier dict ({"trace_id", "span_id"},
        the TCP frame's `trace` field) — the request's span tree joins
        the caller's trace. Without a carrier the thread's tracing
        context applies, and `trace_serve_period` > 0 additionally
        samples every Nth anonymous request into a fresh
        server-originated trace."""
        cfg = self.config
        reg = _obs.get_registry()
        tr = _tracing.extract(trace) if trace is not None else None
        if tr is None:
            cur = _tracing.current()
            if cur is not None:
                tr = cur
            else:
                period = _flags.get_flag("trace_serve_period")
                if period and next(self._trace_seq) % period == 0:
                    tr = (_tracing.new_trace_id(), "")
        # registry updates are published AFTER self._lock is released:
        # the lock is the admission hot spot, and the registry takes
        # locks of its own
        try:
            with self._lock:
                if self._draining or self._stopped:
                    self._stats["shed_shutdown"] += 1
                    raise ServeRejected("shutting_down")
                entry = self._models.get(model)
                if entry is None:
                    raise ServeRejected("unknown_model", model)
                if hooks_name is not None:
                    named = getattr(entry.model, "named_hooks",
                                    None) or {}
                    hooks = named.get(hooks_name)
                    if hooks is None:
                        raise ServeRejected(
                            "unknown_hook",
                            f"model {model!r} has no hook "
                            f"{hooks_name!r}",
                        )
                if not entry.breaker.admits():
                    self._stats["shed_quarantined"] += 1
                    raise ServeRejected("quarantined", model)
                if len(self._queue) >= cfg.max_queue:
                    self._stats["shed_overload"] += 1
                    raise ServeRejected(
                        "overloaded", f"queue at bound {cfg.max_queue}"
                    )
                ids = np.asarray(ids, np.int32).reshape(-1)
                bucket = _bucket(max(len(ids), 1), cfg.buckets)
                deadline = time.monotonic() + (
                    deadline_s if deadline_s is not None
                    else cfg.default_deadline_s
                )
                hooks_key = (hooks_name or id(hooks)) \
                    if hooks is not None else None
                req = PendingResult(model, ids, bucket, deadline,
                                    hooks, hooks_key, trace=tr)
                self._queue.append(req)
                depth = len(self._queue)
                self._stats["admitted"] += 1
                self._stats["max_queue_depth"] = max(
                    self._stats["max_queue_depth"], depth
                )
                self._work.notify()
        except ServeRejected as e:
            reg.counter("serving.shed").inc(reason=e.reason)
            if tr is not None:
                # a shed request still leaves a span: rejection is a
                # terminal outcome, not a missing trace
                _tracing.emit_span(
                    "serve.request", tr[0], _tracing.new_span_id(),
                    tr[1], dur_s=0.0, status=e.reason,
                    labels={"model": model},
                )
            raise
        reg.counter("serving.admitted").inc(model=model)
        reg.gauge("serving.queue_depth").set(depth)
        reg.gauge("serving.queue_depth_hwm").set_max(depth)
        return req

    def stats(self) -> dict:
        with self._lock:
            out = dict(self._stats)
            out["queue_depth"] = len(self._queue)
            out["models"] = {
                n: {"breaker": e.breaker.state,
                    "ewma_batch_ms": round(e.ewma_batch_s * 1e3, 2),
                    "dispatch_keys": len(e.dispatch_keys)}
                for n, e in self._models.items()
            }
            return out

    def slow_exemplars(self, top: int = 10) -> list:
        """The `tracez` payload: the slowest of the last 256 completed
        requests, each carrying its trace_id (when traced) and its
        queued-vs-dispatch split."""
        with self._lock:
            recent = list(self._slow)
        recent.sort(key=lambda e: e["latency_ms"], reverse=True)
        return recent[: max(int(top), 1)]

    def shutdown(self, drain: bool = True, timeout: float = 30.0) -> None:
        """Stop admission; with drain=True finish (or deadline-reject)
        queued work, else reject everything queued. Idempotent."""
        with self._lock:
            self._draining = True
            if not drain:
                while self._queue:
                    self._reject_locked(self._queue.popleft(),
                                        "shutting_down")
            self._work.notify_all()
        deadline = time.monotonic() + timeout
        for t in self._threads:
            t.join(max(0.0, deadline - time.monotonic()))
        with self._lock:
            self._stopped = True
            # anything a worker left behind (join timeout) is
            # rejected, never silently dropped
            while self._queue:
                self._reject_locked(self._queue.popleft(), "shutting_down")

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.shutdown(drain=True)

    # ------------------------------------------------------ scheduler
    def _reject_locked(self, req: PendingResult, reason: str):
        stat = "shed_shutdown" if reason == "shutting_down" \
            else f"shed_{reason}"
        self._stats[stat] = self._stats.get(stat, 0) + 1
        _obs.get_registry().counter("serving.shed").inc(reason=reason)
        req._finish(exc=ServeRejected(reason))
        if req.trace_id is not None:
            # admitted-then-rejected: the span still closes, covering
            # the whole admitted phase, with the rejection as status
            _tracing.emit_span(
                "serve.request", req.trace_id, req.span_id,
                req.parent_span, dur_s=req.t_done - req.t_submit,
                t0_mono=req.t_submit, status=reason,
                labels={"model": req.model, "id": req.id},
            )

    def _pop_batch_locked(self):
        """Form one dispatchable batch: FIFO head picks the key
        (model, bucket, hooks); compatible requests join up to
        max_batch. Deadline-expired or budget-short requests are
        rejected here — before dispatch. Returns (entry, key, reqs) or
        None. Skips (leaves queued) requests whose model breaker is
        open-with-probe-in-flight."""
        now = time.monotonic()
        cfg = self.config
        skipped = []
        head = None
        while self._queue:
            r = self._queue.popleft()
            entry = self._models.get(r.model)
            if entry is None:
                r._finish(exc=ServeRejected("unknown_model", r.model))
                continue
            margin = entry.ewma_batch_s * cfg.service_margin
            if now > r.deadline or now + margin > r.deadline:
                self._reject_locked(r, "deadline")
                continue
            if not entry.breaker.try_probe():
                if entry.breaker.state == "open":
                    self._reject_locked(r, "quarantined")
                else:
                    skipped.append(r)  # half-open, probe in flight
                continue
            head = (entry, r)
            break
        for r in reversed(skipped):
            self._queue.appendleft(r)
        if head is None:
            return None
        entry, first = head
        key = (first.model, first.bucket, first.hooks_key)
        first.t_popped = time.monotonic()
        batch = [first]
        if entry.breaker.state == "closed":
            rest = []
            while self._queue and len(batch) < cfg.max_batch:
                r = self._queue.popleft()
                if (r.model, r.bucket, r.hooks_key) == key:
                    margin = entry.ewma_batch_s * cfg.service_margin
                    if now + margin > r.deadline:
                        self._reject_locked(r, "deadline")
                    else:
                        r.t_popped = time.monotonic()
                        batch.append(r)
                else:
                    rest.append(r)
            for r in reversed(rest):
                self._queue.appendleft(r)
        return entry, key, batch

    def _worker(self):
        while True:
            with self._work:
                while not self._queue and not self._draining:
                    self._work.wait(timeout=0.1)
                if not self._queue and self._draining:
                    return
                popped = self._pop_batch_locked()
                _obs.get_registry().gauge("serving.queue_depth").set(
                    len(self._queue)
                )
                if popped is None:
                    if self._queue:
                        # everything queued is parked behind a
                        # half-open probe: yield, don't hot-spin
                        self._work.wait(timeout=0.01)
                    continue
            self._dispatch(*popped)

    # ------------------------------------------------------- dispatch
    def _pack(self, batch, bucket):
        """[B_bucket, T_bucket] ids + [B] lens; rows beyond the real
        batch repeat row 0 (pure padding — results discarded)."""
        bb = self.config.batch_bucket(len(batch))
        ids = np.zeros((bb, bucket), np.int32)
        lens = np.zeros((bb,), np.int32)
        for i, r in enumerate(batch):
            ids[i, : len(r.ids)] = r.ids
            lens[i] = len(r.ids)
        for i in range(len(batch), bb):
            ids[i] = ids[0]
            lens[i] = lens[0]
        return ids, lens

    def _emit_request_spans(self, req, t0, t_end, status, path=None,
                            dispatch_span=None, batch_n=None):
        """Stamp one admitted request's span tree post-hoc from the
        monotonic timestamps the scheduler already recorded:
        serve.request (root, child of the client carrier) over
        serve.queued / serve.batch_form / serve.dispatch. Safe from
        any thread — nothing touches the thread-local context."""
        if req.trace_id is None:
            return
        tid, root = req.trace_id, req.span_id
        labels = {"model": req.model, "id": req.id}
        if path is not None:
            labels["path"] = path
        _tracing.emit_span(
            "serve.request", tid, root, req.parent_span,
            dur_s=req.t_done - req.t_submit, t0_mono=req.t_submit,
            status=status, labels=labels,
        )
        tp = req.t_popped if req.t_popped is not None else t0
        _tracing.emit_span(
            "serve.queued", tid, _tracing.new_span_id(), root,
            dur_s=max(tp - req.t_submit, 0.0), t0_mono=req.t_submit,
        )
        _tracing.emit_span(
            "serve.batch_form", tid, _tracing.new_span_id(), root,
            dur_s=max(t0 - tp, 0.0), t0_mono=tp,
        )
        _tracing.emit_span(
            "serve.dispatch", tid,
            dispatch_span or _tracing.new_span_id(), root,
            dur_s=max(t_end - t0, 0.0), t0_mono=t0,
            labels={"batch": batch_n} if batch_n else {},
        )

    def _dispatch(self, entry, key, batch):
        model_name, bucket, _hooks_key = key
        hooks = batch[0].hooks
        host = hooks is not None
        # the first traced request's dispatch span is pre-allocated and
        # attached as thread context while the model runs, so spans the
        # model emits land under it
        rep = next((r for r in batch if r.trace_id is not None), None)
        rep_dispatch = _tracing.new_span_id() if rep is not None else None
        run_ctx = _tracing.attach(
            {"trace_id": rep.trace_id, "span_id": rep_dispatch}
            if rep is not None else None
        )
        t0 = time.monotonic()
        try:
            ids, lens = self._pack(batch, bucket)
            with run_ctx:
                rows = entry.model.run_batch(ids, lens, hooks, host)
        except Exception as e:
            # a failed dispatch fails its requests (and counts toward
            # the breaker); the worker keeps serving
            t_end = time.monotonic()
            failed = []
            with self._lock:
                entry.breaker.record(False)
                self._stats["failed"] += len(batch)
                for r in batch:
                    r._finish(exc=ServeError(f"{type(e).__name__}: {e}"))
                    if r.trace_id is not None:
                        failed.append(r)
            for r in failed:
                self._emit_request_spans(
                    r, t0, t_end, status="error",
                    dispatch_span=rep_dispatch if r is rep else None,
                    batch_n=len(batch),
                )
            return
        dt = time.monotonic() - t0
        # per-request latencies are collected under the lock but
        # published to the registry AFTER it: submit() contends on
        # self._lock, and the registry takes its own locks
        lats, waits = [], []
        with self._lock:
            self._stats["batches"] += 1
            entry.breaker.record(True)
            entry.ewma_batch_s = (
                dt if entry.ewma_batch_s == 0.0
                else 0.7 * entry.ewma_batch_s + 0.3 * dt
            )
            entry.dispatch_keys.add(
                (bucket, self.config.batch_bucket(len(batch)),
                 hooks is not None,
                 getattr(entry.model, "tokens_per_dispatch", 1))
            )
            for i, r in enumerate(batch):
                out = dict(rows[i])
                out.setdefault("path", "host" if host else "device")
                r._finish(result=out)
                self._stats["completed"] += 1
                lats.append(r.t_done - r.t_submit)
                waits.append(max(t0 - r.t_submit, 0.0))
        t_end = t0 + dt
        path_label = "host" if host else "device"
        reg = _obs.get_registry()
        reg.counter("serving.dispatch_s").inc(dt)
        for r in batch:
            self._emit_request_spans(
                r, t0, t_end, status="ok", path=path_label,
                dispatch_span=rep_dispatch if r is rep else None,
                batch_n=len(batch),
            )
            tp = r.t_popped if r.t_popped is not None else t0
            # lint: unlocked-ok — deque.append is atomic under the GIL
            # and exemplars tolerate interleaving; the admission lock
            # must not cover span bookkeeping
            self._slow.append({
                "id": r.id,
                "model": r.model,
                "trace_id": r.trace_id,
                "latency_ms": round((r.t_done - r.t_submit) * 1e3, 3),
                "queued_ms": round(max(tp - r.t_submit, 0.0) * 1e3, 3),
                "dispatch_ms": round(dt * 1e3, 3),
                "path": path_label,
                "ts": round(time.time(), 3),
            })
        # occupancy bookkeeping: one formed batch, its real (un-padded)
        # request count alongside
        reg.counter("serving.batches").inc(model=model_name)
        reg.counter("serving.batch_requests").inc(
            len(lats), model=model_name
        )
        # admitted-request time attribution: queued vs executing vs
        # (residual) scheduling overhead
        reg.counter("serving.request_latency_s").inc(sum(lats))
        reg.counter("serving.request_queue_wait_s").inc(sum(waits))
        reg.counter("serving.request_dispatch_s").inc(dt * len(lats))
        hist = reg.histogram("serving.admitted_latency_s")
        for lat in lats:
            hist.observe(lat, model=model_name)
