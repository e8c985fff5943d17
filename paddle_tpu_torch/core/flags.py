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
    "show_parameter_stats_period": 0,
    "seed": 0,
    "watchdog": True,
    "matmul_precision": "default",
    # the LSTM/GRU layers (layers/recurrent.py): None = the hand-written
    # sequence kernels for a CUDA input with the default activations,
    # the masked scan otherwise; True = the kernels' path (their plain
    # versions on a CPU input); False = always the scan
    "use_pallas_rnn": None,
    # multi-step dispatch (trainer/trainer.py): SGD's default
    # steps_per_dispatch; K > 1 runs K consecutive train steps as one
    # dispatch (on the card, the replay of a CUDA graph of K steps)
    "steps_per_dispatch": 1,
    # checkpoints (trainer/trainer.py): "sync" = a blocking save_pass
    # each pass; "async" = only the device->host snapshot blocks, the
    # write overlaps the next pass (trainer/async_checkpoint.py);
    # save_only_one keeps the newest pass only
    "checkpoint_mode": "sync",
    "save_only_one": False,
    # per-step timeline attribution (obs/timeline.py): fence the card
    # every Nth step, so device time is measured end to end there while
    # the other steps stay asynchronous (0 = never fence)
    "timeline_sample_period": 16,
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
