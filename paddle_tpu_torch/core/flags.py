"""Global process flags.

A copy of the JAX package's `core/flags.py` mechanism (a typed global
key/value store), holding the flags the port reads.
"""

from __future__ import annotations

from typing import Any

_DEFAULTS: dict[str, Any] = {
    # distributed tracing (obs/tracing.py): serving traces every
    # request that arrives WITH a carrier, plus every Nth anonymous
    # request when trace_serve_period > 0 (0 = carrier-bearing only)
    "trace_serve_period": 0,
    # training (trainer/trainer.py, network.py): log every Nth batch;
    # the trainer's seed when SGD gets none (0 = from the OS); the
    # on-device non-finite skip; the matmul precision ("default" =
    # f32; "bfloat16" or "bf16" = the mixed-precision cast rule of
    # network.py: f32 masters, bf16 compute layers, f32 cost layers)
    "log_period": 100,
    "seed": 0,
    "watchdog": True,
    "matmul_precision": "default",
    # the LSTM/GRU layers (layers/recurrent.py): None = the hand-written
    # sequence kernels for a CUDA input with the default activations,
    # the masked scan otherwise; True = the kernels' path (their plain
    # versions on a CPU input); False = always the scan
    "use_pallas_rnn": None,
}

_flags: dict[str, Any] = dict(_DEFAULTS)


def get_flag(name: str) -> Any:
    if name not in _flags:
        raise KeyError(f"unknown flag {name!r}")
    return _flags[name]


def set_flag(name: str, value: Any) -> None:
    _flags[name] = value


def reset_flags() -> None:
    _flags.clear()
    _flags.update(_DEFAULTS)
