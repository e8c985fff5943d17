"""Profiling hooks: the JAX package's `core/profiler.py` API on
`torch.profiler`.

`start(log_dir)` / `stop()` (or `trace(log_dir)`) capture the host and,
on a machine with a card, its kernels, and write a Chrome trace
(`trace.json`, viewable in chrome://tracing or Perfetto) into
`log_dir`; `scope(name)` / `annotate_fn(name)` name a region of the
trace (`torch.profiler.record_function`), the REGISTER_TIMER_INFO
analogue.
"""

from __future__ import annotations

import contextlib
import functools
import os

import torch

__all__ = ["start", "stop", "trace", "scope", "annotate_fn"]

_active = None  # (profile, log_dir) while a capture runs


def start(log_dir: str) -> None:
    """Begin a capture (hl_profiler_start analogue)."""
    global _active
    if _active is not None:
        raise RuntimeError("a profiler capture is already running")
    from torch.profiler import ProfilerActivity, profile

    acts = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(ProfilerActivity.CUDA)
    prof = profile(activities=acts)
    prof.__enter__()
    _active = (prof, log_dir)


def stop() -> None:
    """End the capture and write `<log_dir>/trace.json` (hl_profiler_end
    analogue)."""
    global _active
    if _active is None:
        raise RuntimeError("no profiler capture is running")
    prof, log_dir = _active
    _active = None
    prof.__exit__(None, None, None)
    os.makedirs(log_dir, exist_ok=True)
    prof.export_chrome_trace(os.path.join(log_dir, "trace.json"))


@contextlib.contextmanager
def trace(log_dir: str):
    start(log_dir)
    try:
        yield
    finally:
        stop()


def scope(name: str):
    """Named region inside a trace; shows as an annotation over the
    work it encloses."""
    return torch.profiler.record_function(name)


def annotate_fn(name: str):
    """Decorator form of `scope`."""

    def deco(fn):
        @functools.wraps(fn)
        def wrapped(*a, **kw):
            with torch.profiler.record_function(name):
                return fn(*a, **kw)

        return wrapped

    return deco
