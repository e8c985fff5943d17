"""Lock-order checker.

The serving process holds several families of locks that can meet on
one call path: the metrics registry (obs/metrics.py — taken inside
`registry.event()`, which every subsystem calls), the event stream,
the serving admission queue (serving/server.py — held while forming
batches) and the per-model circuit breakers. A lock-order inversion
between any two of them is a deadlock that only fires under unlucky
timing — exactly the kind of bug a test suite passes over 99 times and
wedges on the 100th.

Instrumentation: the known locks are created through `named_lock()`.
When checking is DISABLED (the default) that returns a plain
`threading.Lock` — zero overhead, nothing changes. When enabled
(`PADDLE_LOCK_CHECK=1` in the environment at process start, or
`enable()` before the locks are constructed), it returns an
instrumented wrapper that records, per thread, which named locks are
held at every acquire and builds the global acquired-while-holding
edge graph. A cycle in that
graph is a lock-order inversion: `violations()` names the locks and
the first stack that created each offending edge.

The wrapper supports the full Lock protocol including use as the
underlying lock of a `threading.Condition` (the admission queue's
`_work` condition wraps the queue lock).

Pure stdlib.
"""

from __future__ import annotations

import os
import threading
import traceback

__all__ = [
    "named_lock", "enable", "disable", "enabled", "violations",
    "reset", "edges", "LockOrderMonitor", "InstrumentedLock",
]


class LockOrderMonitor:
    """Collects held-set edges from every instrumented lock."""

    def __init__(self):
        self._meta = threading.Lock()  # guards the edge graph only
        # (held_name, acquired_name) -> short stack of first sighting
        self._edges: dict = {}
        self._tls = threading.local()

    # -- per-thread held set ---------------------------------------
    def _held(self) -> list:
        h = getattr(self._tls, "held", None)
        if h is None:
            h = self._tls.held = []
        return h

    def on_acquired(self, name: str) -> None:
        held = self._held()
        new_edges = [
            (h, name) for h in held
            if h != name and (h, name) not in self._edges
        ]
        if new_edges:
            stack = "".join(traceback.format_stack(limit=8)[:-2])
            with self._meta:
                for e in new_edges:
                    self._edges.setdefault(e, stack)
        held.append(name)

    def on_released(self, name: str) -> None:
        held = self._held()
        # remove the most recent acquisition of `name` (locks are
        # typically released LIFO but the protocol does not require
        # it — Condition.wait releases out of order)
        for i in range(len(held) - 1, -1, -1):
            if held[i] == name:
                del held[i]
                break

    # -- reporting --------------------------------------------------
    def edges(self) -> dict:
        with self._meta:
            return dict(self._edges)

    def violations(self) -> list:
        """Every cycle in the edge graph, reported as one violation
        per cycle (deduped by cycle set)."""
        graph: dict = {}
        edge_map = self.edges()
        for (a, b) in edge_map:
            graph.setdefault(a, set()).add(b)

        seen_cycles = set()
        out = []

        def dfs(start, node, path):
            for nxt in graph.get(node, ()):
                if nxt == start:
                    cyc = frozenset(path)
                    if cyc not in seen_cycles:
                        seen_cycles.add(cyc)
                        order = path + [start]
                        stacks = {
                            f"{x}->{y}": edge_map.get((x, y), "")
                            for x, y in zip(order, order[1:])
                        }
                        out.append({
                            "cycle": order,
                            "detail": (
                                "lock-order inversion: "
                                + " -> ".join(order)
                                + " (each lock acquired while "
                                  "holding the previous)"
                            ),
                            "stacks": stacks,
                        })
                elif nxt not in path:
                    dfs(start, nxt, path + [nxt])

        for node in sorted(graph):
            dfs(node, node, [node])
        return out

    def reset(self) -> None:
        with self._meta:
            self._edges = {}


class InstrumentedLock:
    """threading.Lock wrapper reporting acquisitions to a monitor.
    Condition-compatible: acquire/release/locked plus the context
    protocol (Condition probes ownership via acquire(False))."""

    def __init__(self, name: str, monitor: LockOrderMonitor,
                 lock=None):
        self.name = name
        self._monitor = monitor
        self._lock = lock if lock is not None else threading.Lock()

    def acquire(self, blocking: bool = True, timeout: float = -1):
        got = self._lock.acquire(blocking, timeout)
        if got:
            # record AFTER a successful acquire (a failed
            # non-blocking probe — Condition._is_owned — held
            # nothing, so it must not create an edge)
            self._monitor.on_acquired(self.name)
        return got

    def release(self) -> None:
        self._monitor.on_released(self.name)
        self._lock.release()

    def locked(self) -> bool:
        return self._lock.locked()

    def __enter__(self):
        self.acquire()
        return self

    def __exit__(self, *exc):
        self.release()
        return False

    def __repr__(self):
        return f"<InstrumentedLock {self.name!r} {self._lock!r}>"


_MONITOR = LockOrderMonitor()
_ENABLED = bool(os.environ.get("PADDLE_LOCK_CHECK"))


def enable() -> LockOrderMonitor:
    """Turn instrumentation on for locks created AFTER this call.
    (Module singletons build their locks at import time — to cover
    them, set PADDLE_LOCK_CHECK=1 in the environment instead.)"""
    global _ENABLED
    _ENABLED = True
    return _MONITOR


def disable() -> None:
    global _ENABLED
    _ENABLED = False


def enabled() -> bool:
    return _ENABLED


def named_lock(name: str):
    """The known-lock constructor: a plain threading.Lock when
    checking is off (the production path — zero overhead), an
    instrumented one when on."""
    if not _ENABLED:
        return threading.Lock()
    return InstrumentedLock(name, _MONITOR)


def violations() -> list:
    return _MONITOR.violations()


def edges() -> dict:
    return _MONITOR.edges()


def reset() -> None:
    _MONITOR.reset()
