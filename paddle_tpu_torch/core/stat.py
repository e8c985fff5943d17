"""Timers and stats: a view over the metrics registry.

A copy of the JAX package's `core/stat.py` (the reference's
Stat/StatSet and REGISTER_TIMER, paddle/utils/Stat.h:63,114,244) on the
port's `obs/metrics.py`. The timer state lives in the registry (one
histogram per timer, family name `stat.<set>.<timer>`), so every timer
is also in the metrics snapshot and `metricz`; this module keeps only
the per-pass report text, the same text as the JAX package's.

No duplicate timer plumbing: `StatInfo` holds no numbers of its own;
total/count/max/min/avg all read through to the registry histogram.
"""

from __future__ import annotations

import contextlib
import threading
import time

from paddle_tpu_torch.obs import metrics as _metrics


class StatInfo:
    """View over one registry histogram (seconds)."""

    __slots__ = ("_hist",)

    def __init__(self, hist: _metrics.Histogram):
        self._hist = hist

    def add(self, dt: float):
        self._hist.observe(dt)

    @property
    def total(self) -> float:
        return self._hist.sum()

    @property
    def count(self) -> int:
        return self._hist.count()

    @property
    def max(self) -> float:
        return self._hist.max()

    @property
    def min(self) -> float:
        return self._hist.min()

    @property
    def avg(self) -> float:
        return self._hist.avg()


class StatSet:
    def __init__(self, name: str = "default", registry=None):
        self.name = name
        self._reg = registry or _metrics.get_registry()
        self._names: set = set()
        self._lock = threading.Lock()

    @property
    def _prefix(self) -> str:
        return f"stat.{self.name}."

    def stat(self, name: str) -> StatInfo:
        with self._lock:
            self._names.add(name)
        return StatInfo(self._reg.histogram(self._prefix + name))

    @contextlib.contextmanager
    def timer(self, name: str):
        stat = self.stat(name)
        t0 = time.perf_counter()
        try:
            yield
        finally:
            stat.add(time.perf_counter() - t0)

    def report(self) -> str:
        lines = [f"=== StatSet[{self.name}] ==="]
        with self._lock:
            names = sorted(self._names)
        for name in names:
            s = StatInfo(self._reg.histogram(self._prefix + name))
            if not s.count:
                continue  # reset since last use: nothing to report
            lines.append(
                f"{name:40s} count={s.count:8d} total={s.total:10.4f}s "
                f"avg={s.avg * 1e3:9.3f}ms max={s.max * 1e3:9.3f}ms"
            )
        return "\n".join(lines)

    def reset(self):
        """Zero this set's registry series in place (held StatInfo
        views keep working — they read through to the same
        histograms)."""
        self._reg.reset_prefix(self._prefix)
        with self._lock:
            self._names.clear()


GLOBAL_STATS = StatSet("global")
timer = GLOBAL_STATS.timer
