"""The trainer: the JAX package's `trainer/__init__.py` exports on the
port. The events and the watchdog's names import eagerly (no torch);
`SGD`, `AsyncCheckpointer` and `AsyncCheckpointError` resolve lazily,
so `paddle_tpu_torch.trainer.watchdog`'s exit-code contract stays
importable without loading torch."""

from paddle_tpu_torch.trainer.events import (  # noqa: F401
    BeginIteration,
    BeginPass,
    EndIteration,
    EndPass,
    TestResult,
)
from paddle_tpu_torch.trainer.watchdog import (  # noqa: F401
    EXIT_PREEMPTED,
    Preempted,
    Watchdog,
    WatchdogAbort,
    WatchdogConfig,
    WatchdogReport,
)

_LAZY = {
    "SGD": "paddle_tpu_torch.trainer.trainer",
    "Inferencer": "paddle_tpu_torch.trainer.trainer",
    "AsyncCheckpointer": "paddle_tpu_torch.trainer.async_checkpoint",
    "AsyncCheckpointError": "paddle_tpu_torch.trainer.async_checkpoint",
}


def __getattr__(name):
    if name in _LAZY:
        import importlib

        return getattr(importlib.import_module(_LAZY[name]), name)
    raise AttributeError(
        f"module 'paddle_tpu_torch.trainer' has no attribute {name!r}"
    )
