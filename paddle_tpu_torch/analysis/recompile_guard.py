"""Recompile guard: a tracker of steady-state captures, the port's copy
of `paddle_tpu/analysis/recompile_guard.py`.

The JAX package's guard counts jit traces: in steady state the hot
loop's compiled program must never retrace. The port has no jit; what
costs it the same in steady state is a new program of the same kinds:

- a CUDA-graph capture (`parallel/graph.py`: one graph of K train steps
  per chunk length and feed signature; `beam_search.py::_DecodeGraph`:
  one decode graph per batch and bucket), 2-10x a replay, and about
  0.2 s on the first request of each (batch, bucket) a server serves;
- the first sight of a signature wherever the JAX package traces (the
  train step, the eval forward, the decoders, the paged LM, the serving
  forward), where the port runs eagerly and a new shape means new
  kernel plans, new allocator pools and a capture still to come.

So `note()` runs at the first sight of a signature wherever the JAX
package traces, and at every CUDA-graph capture: on the same feed
sequence the port counts what the JAX guard counts, and a steady-state
capture is a violation.

    guard = RecompileGuard("train_step")
    ...
    guard.note(feed_signature)       # first sight of a signature only
    ...
    guard.arm(strict=True)
    # any further note => violation (strict: RecompileError raised
    # from the call that would capture or trace, failing it loudly)

Each guard also counts notes while disarmed (the warmup count, visible
in `obs` metrics as `recompile_guard.traces{label=...}`).

The trainer (SGD, via the `recompile_guard` flag) and the server
(`InferenceServer.arm_recompile_guard`) arm their guards after warmup;
`assert_steady_state()` is the bench-harness hook that fails a measured
row whose hot loop captured or traced again.

`note_once` (the port's own) notes a program key the first time it is
seen, where a (bounded) JAX program cache would trace it: the guard
keeps the keys, in one namespace per program cache its owner has.

Pure stdlib (the noted operands are only used via getattr-probed
shape/dtype).
"""

from __future__ import annotations

import threading
import time
import weakref

__all__ = [
    "RecompileError", "RecompileGuard", "all_guards", "arm_all",
    "disarm_all", "all_violations", "assert_steady_state",
]


class RecompileError(RuntimeError):
    """A hot loop captured or traced again while its guard was armed."""


_GUARDS: "weakref.WeakSet[RecompileGuard]" = weakref.WeakSet()
_GUARDS_LOCK = threading.Lock()


def _signature(args, kwargs):
    """Shape/dtype signature of the noted operands (tensors or anything
    with shape/dtype attributes; other leaves by type name)."""

    def leaf(x):
        s = getattr(x, "shape", None)
        d = getattr(x, "dtype", None)
        if s is None and d is None:
            return type(x).__name__
        return (tuple(s) if s is not None else None, str(d))

    def walk(x):
        if isinstance(x, dict):
            return tuple(
                (k, walk(v)) for k, v in sorted(x.items())
            )
        if isinstance(x, (list, tuple)):
            return tuple(walk(v) for v in x)
        return leaf(x)

    return walk(list(args) + sorted(kwargs.items()))


class RecompileGuard:
    """One guard per program family (a TrainStep and its graphs, a
    decode cache, a merged serving forward). Thread-safe."""

    def __init__(self, label: str):
        self.label = label
        self._lock = threading.Lock()
        self._armed = False
        self._strict = False
        self.traces = 0          # total traces ever
        self.warmup_traces = 0   # traces while disarmed
        self.violations: list = []
        self._seen: dict = {}    # namespace -> {program key: True}
        with _GUARDS_LOCK:
            _GUARDS.add(self)

    # -- called where a program is traced or captured ---------------
    def note(self, *args, **kwargs) -> None:
        """Record one trace or capture. Passing the operands gives the
        violation record a shape signature to name it."""
        with self._lock:
            self.traces += 1
            armed, strict = self._armed, self._strict
            if not armed:
                self.warmup_traces += 1
        self._count_metric()
        if not armed:
            return
        try:
            sig = _signature(args, kwargs)
        except Exception:
            sig = "<unavailable>"
        rec = {
            "label": self.label,
            "ts": round(time.time(), 6),
            "signature": repr(sig),
            "trace_n": self.traces,
        }
        with self._lock:
            self.violations.append(rec)
        self._report_violation(rec)
        if strict:
            raise RecompileError(
                f"{self.label}: hot loop retraced in steady state "
                f"(trace #{self.traces}, signature {sig!r}) — a cached "
                f"program or captured graph was expected; something in "
                f"the call is churning the cache"
            )

    def note_once(self, key, *args, limit=None, cache=None, force=False,
                  via=None, **kwargs) -> bool:
        """Note `key` (with the operands of `note`) where a JAX program
        cache would trace it: the first time it is seen in the namespace
        `cache` since it was last dropped, or every time with `force`
        (a CUDA-graph capture). `limit` bounds the namespace as the JAX
        cache is bounded (the oldest key dropped first). `via`: the
        guard that notes, where one JAX cache serves programs of two
        guards. Returns whether it noted; a strict armed guard raises
        before the key is kept, so the next call raises again."""
        with self._lock:
            seen = self._seen.setdefault(cache, {})
            if key in seen and not force:
                return False
        (via or self).note(*args, **kwargs)
        with self._lock:
            seen.pop(key, None)
            if limit is not None and len(seen) >= limit:
                seen.pop(next(iter(seen)))
            seen[key] = True
        return True

    def forget(self, cache=None) -> None:
        """Drop the namespace `cache`: its program cache was dropped, so
        each of its keys traces again."""
        with self._lock:
            self._seen.pop(cache, None)

    # -- lifecycle --------------------------------------------------
    def arm(self, strict: bool = False) -> "RecompileGuard":
        with self._lock:
            self._armed = True
            self._strict = strict
        return self

    def disarm(self) -> "RecompileGuard":
        with self._lock:
            self._armed = False
        return self

    @property
    def armed(self) -> bool:
        return self._armed

    def reset(self) -> None:
        with self._lock:
            self.violations = []

    # -- reporting (lazy obs imports: analysis stays stdlib-clean
    # and usable before the metrics registry exists) ----------------
    def _count_metric(self) -> None:
        try:
            from paddle_tpu_torch.obs import metrics as _m

            _m.get_registry().counter("recompile_guard.traces").inc(
                label=self.label
            )
        except Exception:
            pass

    def _report_violation(self, rec: dict) -> None:
        try:
            from paddle_tpu_torch.obs import metrics as _m

            reg = _m.get_registry()
            reg.counter("recompile_guard.violations").inc(
                label=self.label
            )
            reg.event("recompile", **rec)
        except Exception:
            pass
        try:
            from paddle_tpu_torch.obs import flight_recorder as _f

            _f.maybe_dump("recompile", **rec)
        except Exception:
            pass


def all_guards() -> list:
    with _GUARDS_LOCK:
        return sorted(_GUARDS, key=lambda g: g.label)


def arm_all(strict: bool = False, label_prefix: str = "") -> list:
    armed = []
    for g in all_guards():
        if g.label.startswith(label_prefix):
            armed.append(g.arm(strict=strict))
    return armed


def disarm_all(label_prefix: str = "") -> None:
    for g in all_guards():
        if g.label.startswith(label_prefix):
            g.disarm()


def all_violations() -> list:
    out = []
    for g in all_guards():
        out.extend(g.violations)
    return out


def assert_steady_state(label_prefix: str = "") -> None:
    """Raise RecompileError if any (matching) guard recorded a
    violation: the bench-harness/CI hook."""
    bad = [
        v for v in all_violations()
        if v["label"].startswith(label_prefix)
    ]
    if bad:
        labels = sorted({v["label"] for v in bad})
        raise RecompileError(
            f"{len(bad)} steady-state retrace(s) recorded on "
            f"guard(s) {labels}: {bad[:3]}"
        )
