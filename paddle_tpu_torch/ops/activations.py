"""Activation functions, the table of `paddle_tpu/ops/activations.py`
on torch: sigmoid, softmax, sequence_softmax, relu, brelu, tanh, stanh,
softrelu, abs, square, exponential, reciprocal, sqrt, log (+ linear =
identity). Forward only: autograd gives the backward.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from paddle_tpu_torch.core.registry import ACTIVATIONS

_FUNCS = {}


def register_activation(name):
    def deco(fn):
        _FUNCS[name] = fn
        ACTIVATIONS.register(name)(
            type("Act_" + name, (), {"fn": staticmethod(fn)}))
        return fn

    return deco


def get(name: str):
    if name in ("", "linear", None):
        return lambda x: x
    try:
        return _FUNCS[name]
    except KeyError:
        raise KeyError(
            f"unknown activation {name!r}; known: {sorted(_FUNCS)}"
        ) from None


register_activation("sigmoid")(torch.sigmoid)
register_activation("relu")(torch.relu)
register_activation("tanh")(torch.tanh)
register_activation("abs")(torch.abs)
register_activation("square")(torch.square)
register_activation("exponential")(torch.exp)
register_activation("sqrt")(torch.sqrt)
register_activation("log")(torch.log)


@register_activation("softmax")
def softmax(x):
    return torch.softmax(x, dim=-1)


@register_activation("brelu")
def brelu(x):
    # bounded relu: min(max(x, 0), 24)
    return torch.clamp(x, 0.0, 24.0)


@register_activation("stanh")
def stanh(x):
    # scaled tanh: 1.7159 * tanh(2/3 x)
    return 1.7159 * torch.tanh(x * (2.0 / 3.0))


@register_activation("softrelu")
def softrelu(x):
    # log(1 + exp(x)), input clipped to +-40
    return F.softplus(torch.clamp(x, -40.0, 40.0))


@register_activation("reciprocal")
def reciprocal(x):
    return 1.0 / x


@register_activation("sequence_softmax")
def sequence_softmax_unmasked(x):
    """Placeholder registration, as in the JAX package: the masked
    softmax over the time axis needs the lengths, and
    Layer.apply_activation_and_dropout routes there (masked_softmax)."""
    return torch.softmax(x, dim=-1)


def masked_softmax(x, seq_lens):
    """Softmax over the time axis of [B, T] with padding masked out
    (the sequence_softmax activation)."""
    pos = torch.arange(x.shape[1], device=x.device)
    m = (pos[None, :] < seq_lens[:, None]).to(x.dtype)
    z = torch.where(m > 0, x, torch.full_like(x, -1e30))
    return torch.softmax(z, dim=1) * m
