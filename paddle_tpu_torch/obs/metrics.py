"""Process-wide metrics registry + JSONL event stream.

Three metric kinds, all thread-safe and all supporting labeled series
(a metric is a family; each distinct label set is one series):

- `Counter`   — monotonically increasing float (`inc`).
- `Gauge`     — last-written value (`set`), plus `set_max` for
                high-water marks (serving queue depth).
- `Histogram` — bucketed distribution with exact count/sum/min/max.

Two export paths:

- `MetricsRegistry.snapshot()` / `render_text()` — one-shot dump,
  served over the serving TCP front end as a `{"metricz": true}`
  request.
- `EventStream` — append-only JSONL of discrete events (spans,
  serving events), with a periodic background flusher, size-based
  rotation, and an atexit drain so a process that exits without
  closing still leaves a complete stream.
  `enable_event_stream(path)` attaches one to the global registry;
  `registry.event(kind, **fields)` is a no-op until then, so
  instrumented code never pays for an unconfigured stream.

A copy of the JAX package's `obs/metrics.py` (same classes, same
snapshot schema, so fleet tooling reads both). Pure stdlib: the
registry never touches torch.
"""

from __future__ import annotations

import atexit
import json
import os
import threading
import time
from typing import Optional

from paddle_tpu_torch.analysis.lock_order import named_lock

# seconds-oriented default buckets: covers a 0.1 ms dispatch floor up
# to a 60 s checkpoint stall
DEFAULT_BUCKETS = (
    0.0001, 0.00025, 0.0005, 0.001, 0.0025, 0.005, 0.01, 0.025,
    0.05, 0.1, 0.25, 0.5, 1.0, 2.5, 5.0, 10.0, 30.0, 60.0,
)


def _label_key(labels: dict) -> tuple:
    return tuple(sorted((str(k), str(v)) for k, v in labels.items()))


def _series_name(name: str, key: tuple) -> str:
    if not key:
        return name
    return name + "{" + ",".join(f"{k}={v}" for k, v in key) + "}"


class Counter:
    """Monotonic float counter with labeled series."""

    __slots__ = ("name", "_lock", "_series")
    kind = "counter"

    def __init__(self, name: str):
        self.name = name
        self._lock = threading.Lock()
        self._series: dict = {}

    def inc(self, value: float = 1.0, **labels) -> None:
        key = _label_key(labels)
        with self._lock:
            self._series[key] = self._series.get(key, 0.0) + value

    def get(self, **labels) -> float:
        with self._lock:
            return self._series.get(_label_key(labels), 0.0)

    def reset(self) -> None:
        with self._lock:
            self._series.clear()

    def snapshot(self) -> dict:
        with self._lock:
            return {
                _series_name(self.name, k): v
                for k, v in sorted(self._series.items())
            }


class Gauge:
    """Last-written value with labeled series; `set_max` keeps the
    high-water mark (only writes when the new value is larger)."""

    __slots__ = ("name", "_lock", "_series")
    kind = "gauge"

    def __init__(self, name: str):
        self.name = name
        self._lock = threading.Lock()
        self._series: dict = {}

    def set(self, value: float, **labels) -> None:
        with self._lock:
            self._series[_label_key(labels)] = value

    def set_max(self, value: float, **labels) -> None:
        key = _label_key(labels)
        with self._lock:
            cur = self._series.get(key)
            if cur is None or value > cur:
                self._series[key] = value

    def get(self, default=None, **labels):
        with self._lock:
            return self._series.get(_label_key(labels), default)

    def reset(self) -> None:
        with self._lock:
            self._series.clear()

    def snapshot(self) -> dict:
        with self._lock:
            return {
                _series_name(self.name, k): v
                for k, v in sorted(self._series.items())
            }


class _HistSeries:
    __slots__ = ("count", "sum", "min", "max", "bucket_counts")

    def __init__(self, n_buckets: int):
        self.count = 0
        self.sum = 0.0
        self.min = float("inf")
        self.max = 0.0
        # bucket_counts[i] counts observations v <= bounds[i] (and
        # > bounds[i-1]); the final slot is the +inf overflow
        self.bucket_counts = [0] * (n_buckets + 1)


class Histogram:
    """Bucketed distribution. `bounds` are upper-inclusive ("le")
    boundaries; an observation equal to a boundary lands in that
    boundary's bucket. Also tracks exact count/sum/min/max per series
    so StatSet-style avg/max reports need no bucket approximation."""

    __slots__ = ("name", "bounds", "_lock", "_series")
    kind = "histogram"

    def __init__(self, name: str, buckets=None):
        self.name = name
        self.bounds = tuple(sorted(buckets or DEFAULT_BUCKETS))
        self._lock = threading.Lock()
        self._series: dict = {}

    def _at_locked(self, key: tuple) -> _HistSeries:
        s = self._series.get(key)
        if s is None:
            s = self._series[key] = _HistSeries(len(self.bounds))
        return s

    def observe(self, value: float, **labels) -> None:
        key = _label_key(labels)
        with self._lock:
            s = self._at_locked(key)
            s.count += 1
            s.sum += value
            if value < s.min:
                s.min = value
            if value > s.max:
                s.max = value
            for i, b in enumerate(self.bounds):
                if value <= b:
                    s.bucket_counts[i] += 1
                    break
            else:
                s.bucket_counts[-1] += 1

    # ---- StatSet-view accessors (default = unlabeled series) ----
    def count(self, **labels) -> int:
        with self._lock:
            s = self._series.get(_label_key(labels))
            return s.count if s else 0

    def sum(self, **labels) -> float:
        with self._lock:
            s = self._series.get(_label_key(labels))
            return s.sum if s else 0.0

    def min(self, **labels) -> float:
        with self._lock:
            s = self._series.get(_label_key(labels))
            return s.min if s else float("inf")

    def max(self, **labels) -> float:
        with self._lock:
            s = self._series.get(_label_key(labels))
            return s.max if s else 0.0

    def avg(self, **labels) -> float:
        with self._lock:
            s = self._series.get(_label_key(labels))
            return s.sum / s.count if s and s.count else 0.0

    def buckets(self, **labels) -> dict:
        """{"<=bound": n, ..., "+inf": n} — non-cumulative counts."""
        with self._lock:
            s = self._series.get(_label_key(labels))
            counts = s.bucket_counts if s else [0] * (len(self.bounds) + 1)
            out = {f"<={b:g}": counts[i] for i, b in enumerate(self.bounds)}
            out["+inf"] = counts[-1]
            return out

    def reset(self) -> None:
        with self._lock:
            self._series.clear()

    def snapshot(self) -> dict:
        # bounds + per-bucket counts ride the snapshot: a metricz
        # scrape carries what a fleet aggregator needs to merge N
        # replicas' histograms bucket-wise (quantiles do not merge)
        with self._lock:
            out = {}
            for k, s in sorted(self._series.items()):
                out[_series_name(self.name, k)] = {
                    "count": s.count,
                    "sum": round(s.sum, 9),
                    "min": s.min if s.count else None,
                    "max": s.max,
                    "avg": s.sum / s.count if s.count else 0.0,
                    "bounds": list(self.bounds),
                    "buckets": list(s.bucket_counts),
                }
            return out


class EventStream:
    """Append-only JSONL event sink with periodic flush + rotation.

    - `emit(obj)` buffers one JSON-serializable dict (a `ts` wall
      timestamp is stamped if absent) — cheap under contention.
    - A daemon flusher writes the buffer every `flush_interval_s`.
    - When the file exceeds `rotate_bytes` it is renamed to
      `<path>.1` (one previous generation kept) and a fresh file
      starts — the stream never grows unbounded.
    - `close()` drains and stops; registered with atexit so a process
      that exits without closing still flushes its tail.
    """

    def __init__(self, path: str, flush_interval_s: float = 1.0,
                 rotate_bytes: int = 64 << 20):
        self.path = path
        self.flush_interval_s = flush_interval_s
        self.rotate_bytes = rotate_bytes
        self._buf: list = []
        # a known lock: instrumented under the lock-order checker
        # (analysis/lock_order.py)
        self._lock = named_lock("obs.event_stream")
        self._closed = False
        d = os.path.dirname(os.path.abspath(path))
        os.makedirs(d, exist_ok=True)
        self._wake = threading.Event()
        self._thread = threading.Thread(
            target=self._flusher, name="obs-events", daemon=True
        )
        self._thread.start()
        atexit.register(self.close)

    def emit(self, obj: dict) -> None:
        if self._closed:
            return
        if "ts" not in obj:
            obj = {"ts": round(time.time(), 6), **obj}
        with self._lock:
            self._buf.append(obj)

    def flush(self) -> None:
        with self._lock:
            buf, self._buf = self._buf, []
        if not buf:
            return
        lines = "".join(json.dumps(o, default=str) + "\n" for o in buf)
        try:
            if (
                os.path.exists(self.path)
                and os.path.getsize(self.path) + len(lines)
                > self.rotate_bytes
            ):
                os.replace(self.path, self.path + ".1")
            with open(self.path, "a") as f:
                f.write(lines)
        except OSError:
            pass  # an unwritable stream must never take down serving

    def _flusher(self):
        while not self._closed:
            self._wake.wait(self.flush_interval_s)
            self._wake.clear()
            self.flush()

    def close(self) -> None:
        if self._closed:
            return
        self._closed = True
        self._wake.set()
        self._thread.join(timeout=5.0)
        self.flush()


class MetricsRegistry:
    """Get-or-create registry of metric families. One per process
    (`get_registry()`); tests may instantiate private ones."""

    def __init__(self):
        # a known lock: instrumented under the lock-order checker
        # (analysis/lock_order.py)
        self._lock = named_lock("obs.registry")
        self._metrics: dict = {}
        self._stream: Optional[EventStream] = None
        self._recorder = None

    def _get(self, cls, name: str, **kw):
        with self._lock:
            m = self._metrics.get(name)
            if m is None:
                m = self._metrics[name] = cls(name, **kw)
            elif not isinstance(m, cls):
                raise ValueError(
                    f"metric {name!r} already registered as {m.kind}"
                )
            return m

    def counter(self, name: str) -> Counter:
        return self._get(Counter, name)

    def gauge(self, name: str) -> Gauge:
        return self._get(Gauge, name)

    def histogram(self, name: str, buckets=None) -> Histogram:
        # buckets are fixed at first registration; later callers share
        return self._get(Histogram, name, buckets=buckets)

    # ---- event stream ----
    def attach_stream(self, stream: Optional[EventStream]) -> None:
        old, self._stream = self._stream, stream
        if old is not None and old is not stream:
            old.close()

    @property
    def stream(self) -> Optional[EventStream]:
        return self._stream

    def attach_recorder(self, recorder) -> None:
        """Tap every event() into a flight-recorder ring (see
        obs/flight_recorder.py) alongside — or instead of — the
        stream. None detaches."""
        self._recorder = recorder

    @property
    def recorder(self):
        return self._recorder

    def event(self, kind: str, **fields) -> None:
        """Emit one structured event; no-op until a stream or a
        flight recorder is attached, so hot-loop call sites cost two
        None checks."""
        s = self._stream
        r = self._recorder
        if s is None and r is None:
            return
        obj = {"kind": kind, **fields}
        if s is not None:
            s.emit(obj)
        if r is not None:
            if "ts" not in obj:
                obj = {"ts": round(time.time(), 6), **obj}
            r.record(obj)

    # ---- export ----
    def snapshot(self) -> dict:
        with self._lock:
            metrics = list(self._metrics.values())
        out = {"counters": {}, "gauges": {}, "histograms": {}}
        for m in metrics:
            out[m.kind + "s"].update(m.snapshot())
        return out

    def render_text(self) -> str:
        snap = self.snapshot()
        lines = []
        for kind in ("counters", "gauges", "histograms"):
            if not snap[kind]:
                continue
            lines.append(f"=== {kind} ===")
            for name, v in snap[kind].items():
                if isinstance(v, dict):
                    lines.append(
                        f"{name:56s} count={v['count']:8d} "
                        f"sum={v['sum']:12.6f} avg={v['avg']:10.6f} "
                        f"max={v['max']:10.6f}"
                    )
                else:
                    lines.append(f"{name:56s} {v:g}")
        return "\n".join(lines) if lines else "(no metrics recorded)"

    def reset_prefix(self, prefix: str) -> None:
        """Zero every metric whose family name starts with `prefix`,
        IN PLACE (objects survive, so held references keep working —
        the StatSet per-pass reset contract)."""
        with self._lock:
            metrics = [
                m for n, m in self._metrics.items()
                if n.startswith(prefix)
            ]
        for m in metrics:
            m.reset()


_REGISTRY = MetricsRegistry()


def get_registry() -> MetricsRegistry:
    return _REGISTRY


def enable_event_stream(path: str, flush_interval_s: float = 1.0,
                        rotate_bytes: int = 64 << 20) -> EventStream:
    """Attach a JSONL event stream at `path` to the global registry
    (replacing and closing any previous one). Returns the stream."""
    s = EventStream(path, flush_interval_s=flush_interval_s,
                    rotate_bytes=rotate_bytes)
    _REGISTRY.attach_stream(s)
    return s
