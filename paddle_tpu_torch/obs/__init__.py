"""Unified telemetry: the port of `paddle_tpu/obs/`.

- `metrics` — the process-wide registry of counters / gauges /
  histograms, the JSONL event stream, and the flight-recorder tap in
  `registry.event()`.
- `timeline` — per-step wall-time attribution.
- `tracing` — trace/span ids and carriers across processes.
- `flight_recorder` — the bounded ring of recent events, dumped as a
  `paddle-tpu-flight-bundle/v1` bundle when an anomaly fires.
- `aggregate` — fleet-wide snapshot merging and the SLO burn-rate
  monitor (pure stdlib).

No module here imports torch at module level (the flight recorder's
profiler capture imports it inside the capture): the registry stays
importable in routers, CLIs and data workers without a device runtime.
"""

# Lazy exports (PEP 562): importing the package loads no submodule.
_EXPORTS = {
    "MetricsRegistry": "paddle_tpu_torch.obs.metrics",
    "EventStream": "paddle_tpu_torch.obs.metrics",
    "enable_event_stream": "paddle_tpu_torch.obs.metrics",
    "get_registry": "paddle_tpu_torch.obs.metrics",
    "StepTimeline": "paddle_tpu_torch.obs.timeline",
    "BoundedBundleDir": "paddle_tpu_torch.obs.flight_recorder",
    "FlightRecorder": "paddle_tpu_torch.obs.flight_recorder",
    "enable_flight_recorder": "paddle_tpu_torch.obs.flight_recorder",
    "disable_flight_recorder": "paddle_tpu_torch.obs.flight_recorder",
    "get_flight_recorder": "paddle_tpu_torch.obs.flight_recorder",
    "BurnRateMonitor": "paddle_tpu_torch.obs.aggregate",
    "FleetAggregator": "paddle_tpu_torch.obs.aggregate",
    "SnapshotMergeError": "paddle_tpu_torch.obs.aggregate",
    "merge_snapshots": "paddle_tpu_torch.obs.aggregate",
    "quantile": "paddle_tpu_torch.obs.aggregate",
    "snapshot_delta": "paddle_tpu_torch.obs.aggregate",
}


def __getattr__(name):
    if name in _EXPORTS:
        import importlib

        value = getattr(importlib.import_module(_EXPORTS[name]), name)
        globals()[name] = value
        return value
    raise AttributeError(
        f"module {__name__!r} has no attribute {name!r}")


def __dir__():
    return sorted(set(globals()) | set(_EXPORTS))
