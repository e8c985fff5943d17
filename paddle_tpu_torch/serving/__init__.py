"""Continuous-batching inference serving.

The pieces:
- `server` — bounded admission queue, load shedding, deadline-aware
  batch formation, bucketed continuous packing, per-model circuit
  breaker, drain-on-shutdown.
- `models` — GenerationModel (beam decode, and the host-stepped rung
  for hooks) and MultiForwardHost (several scorers co-dispatched in
  one merged forward).
- `host_decode` — the host-stepped decode rung.
- `lm_engine` — the paged Transformer LM's engine.
- `tcp` — length-prefixed-JSON TCP front end + client.
- `fleet` — FleetRouter over replica processes: spill-before-shed,
  breaker-gated rotation, zero-downtime rollout, the SLO burn-rate
  monitor and its incident bundles.

CLI: `python -m paddle_tpu_torch serve --config serve_conf.py [--port
N]` where the config defines `get_server() -> InferenceServer`;
`python -m paddle_tpu_torch fleetz --addr ...` watches a fleet.
"""

# Lazy exports (PEP 562): importing the package loads no submodule.
_EXPORTS = {
    "InferenceServer": "paddle_tpu_torch.serving.server",
    "PendingResult": "paddle_tpu_torch.serving.server",
    "ServeConfig": "paddle_tpu_torch.serving.server",
    "ServeError": "paddle_tpu_torch.serving.server",
    "ServeRejected": "paddle_tpu_torch.serving.server",
    "GenerationModel": "paddle_tpu_torch.serving.models",
    "MultiForwardHost": "paddle_tpu_torch.serving.models",
    "FleetConfig": "paddle_tpu_torch.serving.fleet",
    "FleetMonitor": "paddle_tpu_torch.serving.fleet",
    "FleetRouter": "paddle_tpu_torch.serving.fleet",
    "ReplicaHandle": "paddle_tpu_torch.serving.fleet",
    "RolloutReport": "paddle_tpu_torch.serving.fleet",
    "host_generate": "paddle_tpu_torch.serving.host_decode",
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
