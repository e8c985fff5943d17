"""Parameter and optimizer-state dicts between numpy (or the JAX
package) and torch.

The port keeps the JAX package's flat parameter names — the global
names `Network.param_confs` gives (`_lm_emb.w0`, `_lm_att0.wq`, ...)
— so one numpy dict feeds both implementations. Values keep their
dtype and bits: the round trip numpy -> torch -> numpy is exact.
"""

from __future__ import annotations

import numpy as np
import torch

from paddle_tpu_torch.core.device import resolve_device


def params_from_numpy(np_params: dict, device=None) -> dict:
    """{name: array-like} -> {name: tensor on `device`}. Accepts numpy
    arrays and anything `np.asarray` reads (JAX arrays included)."""
    dev = resolve_device(device)
    return {
        name: torch.from_numpy(np.array(value, copy=True)).to(dev)
        for name, value in np_params.items()
    }


def params_to_numpy(params: dict) -> dict:
    """{name: tensor} -> {name: numpy array} on the host."""
    return {name: t.detach().cpu().numpy() for name, t in params.items()}


def opt_state_from_numpy(np_state: dict, device=None) -> dict:
    """{param name: {slot: array-like}} -> the same nesting of tensors
    on `device` — an optimizer state (`Optimizer.init_state`'s shape),
    e.g. the JAX package's, carried across bit for bit."""
    dev = resolve_device(device)
    return {name: params_from_numpy(slots, device=dev)
            for name, slots in np_state.items()}


def opt_state_to_numpy(state: dict) -> dict:
    """{param name: {slot: tensor}} -> numpy on the host."""
    return {name: params_to_numpy(slots) for name, slots in state.items()}
