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
    # recompile guard (analysis/recompile_guard.py): after the first pass
    # (warmup: every expected shape, the ragged reader tail included, has
    # been seen once) the trainer arms the TrainStep's guard. "off" =
    # never arm; "record" = count steady-state traces and CUDA-graph
    # captures (recompile_guard.violations metric +
    # SGD.recompile_violations()) without failing; "strict" = raise
    # RecompileError from the step that would trace or capture
    "recompile_guard": "off",
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
    # flight recorder (obs/flight_recorder.py): ring size, dump rate
    # limit, dump-dir bound, and the torch.profiler capture a dump runs
    "flight_ring_capacity": 4096,
    "flight_min_dump_interval_s": 60.0,
    "flight_max_bundles": 8,
    "flight_profiler_capture": False,
    # anomaly thresholds that trip a flight-recorder dump on the
    # serving path: admitted-p99 SLO (ms over a 128-request sliding
    # window; 0 disables) and shed-rate spike (shed fraction over a
    # serve_shed_window_s window, needing >= 20 decisions)
    "serve_p99_slo_ms": 0,
    "serve_shed_rate_threshold": 0.5,
    "serve_shed_window_s": 5.0,
    # fleet SLO burn-rate monitor (obs/aggregate.py wired into
    # serving/fleet.py): availability target, the fast/slow
    # multi-window burn-rate pairs (an alert needs the budget burning in
    # both the short window and its long companion), and the
    # incident-bundle dump discipline (the flight recorder's rate limit
    # and bounded dir)
    "fleet_availability_target": 0.999,
    "fleet_burn_fast_window_s": 60.0,
    "fleet_burn_fast_threshold": 14.4,
    "fleet_burn_slow_window_s": 300.0,
    "fleet_burn_slow_threshold": 6.0,
    "fleet_burn_min_decisions": 20,
    "fleet_incident_min_interval_s": 60.0,
    "fleet_incident_max_bundles": 8,
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
