"""Anomaly-triggered flight recorder: a bounded in-memory ring of
recent observability events, dumped as a self-contained JSON bundle
the moment something goes wrong.

The failure mode this closes: a watchdog rung fires, a circuit
breaker opens, the admitted-p99 SLO breaks — and by the time anyone
looks, the evidence (the spans of the slow requests, the step
timeline around the bad batch, the ladder events leading up to the
abort) has scrolled out of the process or died with it. The recorder
taps the SAME `registry.event()` pipe the EventStream reads (spans,
`timeline` samples, `watchdog` rungs, `serving` anomalies,
`preempt_flush`), keeps the last `capacity` of them in a ring, and on
`maybe_dump(reason)` writes everything — ring + registry snapshot +
trigger context — as one bundle file `tools/trace_view.py` and the
`check_bench_record.py bundle` lint understand.

Dump discipline (the "no dump storm" contract, pinned by test):

- rate-limited: at most one bundle per `min_interval_s` — a breaker
  flapping 100 times produces ONE bundle, with the other 99 triggers
  counted on `flight.dumps_suppressed`;
- bounded dir: at most `max_bundles` bundle files are kept; the
  oldest is deleted when a new one lands.

Optional profiler hook (`flight_profiler_capture` flag): a dump also
runs a short `torch.profiler` capture (CUDA activities too when a card
is present), writes its Chrome trace beside the bundle and feeds it
through `tools/trace_attribution.py`, committing the `*.attrib.json`
next to the bundle. Every step is exception-guarded: where the profiler
cannot run the bundle path still runs end to end and the bundle records
`profile: {"captured": false}`.

The port of `paddle_tpu/obs/flight_recorder.py`: the same bundle schema,
the same dump discipline. torch is imported only inside the capture.
"""

from __future__ import annotations

import collections
import json
import os
import threading
import time
from typing import Optional

from paddle_tpu_torch.analysis.lock_order import named_lock
from paddle_tpu_torch.core import flags as _flags
from paddle_tpu_torch.obs import metrics as _metrics

BUNDLE_SCHEMA = "paddle-tpu-flight-bundle/v1"


class BoundedBundleDir:
    """The shared dump discipline for bundle writers (flight bundles
    here, fleet incident bundles in serving/fleet.py): rate limiting,
    sequence numbering, atomic writes, and bounded-dir rotation are
    ONE implementation, not a copy per bundle kind.

    Contract (pinned by test):

    - `try_begin()` hands out a sequence number at most once per
      `min_interval_s`; a suppressed trigger returns None (the caller
      counts the suppression on its own counter, so flight and
      incident suppressions stay separately attributable);
    - `write(seq, reason, doc)` lands `{prefix}{seq:05d}-{reason}.json`
      via tmp + `os.replace` (a bundle is complete or absent), then
      prunes the dir down to `max_bundles` files with that prefix —
      oldest first. With no `dump_dir` it returns None (ring-only /
      in-memory mode: the caller keeps the doc itself)."""

    def __init__(self, dump_dir: Optional[str],
                 prefix: str = "flight-",
                 max_bundles: int = 8,
                 min_interval_s: float = 60.0,
                 lock_name: str = "obs.bundle_dir"):
        self.dump_dir = dump_dir
        self.prefix = prefix
        self.max_bundles = int(max_bundles)
        self.min_interval_s = float(min_interval_s)
        # a known lock: instrumented under the lock-order checker
        # (analysis/lock_order.py)
        self._lock = named_lock(lock_name)
        self._last_mono: Optional[float] = None
        self._seq = 0
        if dump_dir:
            os.makedirs(dump_dir, exist_ok=True)

    def try_begin(self) -> Optional[int]:
        now = time.monotonic()
        with self._lock:
            if (self._last_mono is not None
                    and now - self._last_mono < self.min_interval_s):
                return None
            self._last_mono = now
            self._seq += 1
            return self._seq

    def path_for(self, seq: int, reason: str) -> Optional[str]:
        if not self.dump_dir:
            return None
        return os.path.join(
            self.dump_dir, f"{self.prefix}{seq:05d}-{reason}.json"
        )

    def write(self, seq: int, reason: str, doc: dict) -> Optional[str]:
        path = self.path_for(seq, reason)
        if path is None:
            return None
        tmp = path + ".tmp"
        with open(tmp, "w") as f:
            json.dump(doc, f, default=str)
        os.replace(tmp, path)  # a bundle is complete or absent
        self.prune()
        return path

    def prune(self) -> None:
        try:
            bundles = sorted(
                f for f in os.listdir(self.dump_dir)
                if f.startswith(self.prefix) and f.endswith(".json")
            )
        except (OSError, TypeError):
            return
        for f in bundles[: max(len(bundles) - self.max_bundles, 0)]:
            try:
                os.remove(os.path.join(self.dump_dir, f))
            except OSError:
                pass


class FlightRecorder:
    """Ring buffer + bundle writer. Attach to a registry with
    `enable_flight_recorder()` (production) or construct privately
    and pass `registry=` (tests)."""

    def __init__(self, dump_dir: Optional[str] = None,
                 capacity: Optional[int] = None,
                 min_interval_s: Optional[float] = None,
                 max_bundles: Optional[int] = None,
                 profiler_capture: Optional[bool] = None,
                 registry=None):
        self.dump_dir = dump_dir
        self.capacity = int(
            capacity if capacity is not None
            else _flags.get_flag("flight_ring_capacity")
        )
        self.profiler_capture = bool(
            profiler_capture if profiler_capture is not None
            else _flags.get_flag("flight_profiler_capture")
        )
        # rate limiting / seq / atomic write / rotation all live in
        # the shared BoundedBundleDir (one dump discipline for flight
        # AND fleet-incident bundles)
        self._dir = BoundedBundleDir(
            dump_dir,
            prefix="flight-",
            max_bundles=int(
                max_bundles if max_bundles is not None
                else _flags.get_flag("flight_max_bundles")
            ),
            min_interval_s=float(
                min_interval_s if min_interval_s is not None
                else _flags.get_flag("flight_min_dump_interval_s")
            ),
        )
        self._reg = registry or _metrics.get_registry()
        self._ring = collections.deque(maxlen=self.capacity)
        # a known lock: instrumented under the lock-order checker
        # (analysis/lock_order.py)
        self._lock = named_lock("obs.flight_ring")
        self.last_bundle: Optional[dict] = None
        self.last_bundle_path: Optional[str] = None

    @property
    def min_interval_s(self) -> float:
        return self._dir.min_interval_s

    @property
    def max_bundles(self) -> int:
        return self._dir.max_bundles

    # ---- ring (called from registry.event via the recorder tap) ----
    def record(self, obj: dict) -> None:
        with self._lock:
            self._ring.append(obj)

    def snapshot(self) -> list:
        with self._lock:
            return list(self._ring)

    def spans(self) -> list:
        """Just the span events currently in the ring (the bench
        rows' span-split source)."""
        return [e for e in self.snapshot() if e.get("kind") == "span"]

    # ---- dumping ----
    def maybe_dump(self, reason: str, /, **context) -> Optional[str]:
        """Write one bundle for `reason`, unless a bundle was written
        less than `min_interval_s` ago (then: count the suppression,
        return None). Never raises — the recorder must not be able to
        take down the subsystem that tripped it."""
        seq = self._dir.try_begin()
        if seq is None:
            self._reg.counter("flight.dumps_suppressed").inc(
                reason=reason
            )
            return None
        events = self.snapshot()
        try:
            return self._dump(reason, context, events, seq)
        except Exception:
            # an unwritable dump dir / full disk must not cascade
            self._reg.counter("flight.dump_errors").inc()
            return None

    def _dump(self, reason, context, events, seq) -> Optional[str]:
        self._reg.counter("flight.dumps").inc(reason=reason)
        bundle = {
            "schema": BUNDLE_SCHEMA,
            "reason": reason,
            "ts": round(time.time(), 6),
            "pid": os.getpid(),
            "seq": seq,
            "context": context,
            "events": events,
            "metrics": self._reg.snapshot(),
            "profile": {"captured": False},
        }
        path = self._dir.path_for(seq, reason)
        if path is None:
            # ring-only mode (bench rows, tests reading spans()):
            # nothing to write, but the trigger is still counted and
            # the bundle is handed back in-memory via last_bundle
            self.last_bundle = bundle
            return None
        if self.profiler_capture:
            bundle["profile"] = _profiler_capture(path)
        path = self._dir.write(seq, reason, bundle)
        self.last_bundle = bundle
        self.last_bundle_path = path
        return path


def _profiler_capture(bundle_path: str, duration_s: float = 0.5) -> dict:
    """A `torch.profiler` capture of `duration_s` (CUDA activities too
    where a card is present) written as a Chrome trace beside the
    bundle, then trace attribution. Returns the bundle's `profile`
    stanza; {"captured": False} on any failure (no profiler, another
    profiler already active, no trace written)."""
    prof_dir = bundle_path + ".profile"
    trace = os.path.join(prof_dir, "trace.json")
    try:
        import torch
        from torch.profiler import ProfilerActivity, profile

        acts = [ProfilerActivity.CPU]
        if torch.cuda.is_available():
            acts.append(ProfilerActivity.CUDA)
        os.makedirs(prof_dir, exist_ok=True)
        with profile(activities=acts) as prof:
            time.sleep(duration_s)
        prof.export_chrome_trace(trace)
        _device_layout(trace)
    except Exception:
        return {"captured": False}
    out = {"captured": True, "profile_dir": prof_dir,
           "trace": trace, "attrib": None}
    try:
        import subprocess
        import sys

        attrib = bundle_path + ".attrib.json"
        tool = os.path.join(
            os.path.dirname(os.path.dirname(os.path.dirname(
                os.path.abspath(__file__)))),
            "tools", "trace_attribution.py",
        )
        r = subprocess.run(
            [sys.executable, tool, trace, "--out", attrib],
            capture_output=True, timeout=120,
        )
        if r.returncode == 0 and os.path.exists(attrib):
            out["attrib"] = attrib
    except Exception:
        pass
    return out


# the torch trace's device-side event categories
_DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")


def _device_layout(trace: str) -> None:
    """Name the torch trace's device lanes the way the attribution tool
    reads a device trace: each (pid, tid) lane that holds kernels or
    copies gets the process name "/device:GPU:<pid>" and the thread
    name "XLA Ops" (metadata appended last, so it wins)."""
    with open(trace) as f:
        doc = json.load(f)
    evs = doc.get("traceEvents", [])
    lanes = sorted({(e["pid"], e.get("tid")) for e in evs
                    if e.get("ph") == "X" and e.get("cat") in _DEVICE_CATS},
                   key=str)
    for pid in sorted({p for p, _ in lanes}, key=str):
        evs.append({"ph": "M", "name": "process_name", "pid": pid,
                    "args": {"name": f"/device:GPU:{pid}"}})
    for pid, tid in lanes:
        evs.append({"ph": "M", "name": "thread_name", "pid": pid,
                    "tid": tid, "args": {"name": "XLA Ops"}})
    doc["traceEvents"] = evs
    with open(trace, "w") as f:
        json.dump(doc, f)


# ---- process-global instance --------------------------------------
_RECORDER: Optional[FlightRecorder] = None
_RECORDER_LOCK = threading.Lock()


def get_flight_recorder() -> Optional[FlightRecorder]:
    return _RECORDER


def enable_flight_recorder(dump_dir: Optional[str] = None,
                           **kw) -> FlightRecorder:
    """Attach a FlightRecorder to the global registry (replacing any
    previous one). `dump_dir=None` runs ring-only (spans are
    collectable, triggers are counted, nothing is written)."""
    global _RECORDER
    with _RECORDER_LOCK:
        rec = FlightRecorder(dump_dir=dump_dir, **kw)
        _RECORDER = rec
        _metrics.get_registry().attach_recorder(rec)
    return rec


def disable_flight_recorder() -> None:
    global _RECORDER
    with _RECORDER_LOCK:
        _RECORDER = None
        _metrics.get_registry().attach_recorder(None)


def enable_from_env() -> Optional[FlightRecorder]:
    """`PADDLE_FLIGHT_DIR=<dir>` turns the recorder on in any
    entrypoint that calls this (serve/train CLIs, the preemptible
    test worker) without new command-line surface."""
    d = os.environ.get("PADDLE_FLIGHT_DIR")
    if not d:
        return None
    return enable_flight_recorder(dump_dir=d)


def maybe_dump(reason: str, /, **context) -> Optional[str]:
    """Module-level convenience: dump on the global recorder if one
    is enabled; silently nothing otherwise (instrumentation call
    sites stay one line)."""
    rec = _RECORDER
    if rec is None:
        return None
    return rec.maybe_dump(reason, **context)
