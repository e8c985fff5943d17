"""Batch normalization: `paddle_tpu/layers/norm.py::BatchNormLayer` on
torch.

Running mean and variance live in the network's state, not its
parameters, and are never differentiated: the running-average update
runs under `torch.no_grad()`. The statistics follow the JAX package for
f32 input: the mean in one reduction, the centered variance
E[(x - mean)^2] (no E[x^2] - E[x]^2 cancellation), over every axis but
the channel one, with padded timesteps of a sequence masked out.

Left out, still to port (ROADMAP A9): `norm` (cross-map LRN) and
`row_l2_norm`, and the bf16 one-pass statistics of the AMP rule.
"""

from __future__ import annotations

import torch

from paddle_tpu_torch.core.arg import Arg
from paddle_tpu_torch.core.config import ParameterConf
from paddle_tpu_torch.core.registry import LAYERS
from paddle_tpu_torch.layers.base import Layer


def running_update(old: dict, new: dict, frac: float) -> dict:
    """{slot: old * frac + new * (1 - frac)}, detached from autograd."""
    with torch.no_grad():
        return {k: old[k] * frac + new[k].detach() * (1 - frac) for k in old}


@LAYERS.register("batch_norm", "cudnn_batch_norm")
class BatchNormLayer(Layer):
    """Batch normalization over the channel (last) axis. attrs:
    moving_average_fraction (default .9, reference
    BatchNormBaseLayer movingAvgFraction_), epsilon (1e-5),
    use_global_stats (force inference stats)."""

    def build(self, in_specs):
        (s,) = in_specs
        c = s.dim[-1] if len(s.dim) > 1 else s.size
        self._channels = c
        pcs = {
            "w0": self.weight_conf(0, (c,)),
            "b": self.bias_conf((c,)) or ParameterConf(
                name=f"_{self.name}.wbias", dims=(c,)),
        }
        # scale init = 1 (reference initializes gamma to 1)
        if pcs["w0"].initial_std is None:
            pcs["w0"].initial_strategy = "constant"
            pcs["w0"].initial_value = 1.0
        return s, pcs

    def init_state(self, device):
        c = self._channels
        return {"mean": torch.zeros((c,), device=device),
                "var": torch.ones((c,), device=device)}

    def forward(self, params, inputs, ctx):
        (arg,) = inputs
        a = self.conf.attrs
        if arg.value.dtype != torch.float32:
            raise NotImplementedError(
                f"{self.name}: batch_norm runs f32 only (the bf16 one-pass "
                "statistics come with the AMP rule)")
        eps = a.get("epsilon", 1e-5)
        frac = a.get("moving_average_fraction", 0.9)
        use_global = a.get("use_global_stats", False) or not ctx.train
        x = arg.value
        st = ctx.state[self.name]
        red = tuple(range(x.ndim - 1))
        if use_global:
            mean, var = st["mean"], st["var"]
            ctx.updated_state[self.name] = st
        else:
            if arg.is_seq:
                # mask padded timesteps out of the statistics: padding
                # must never affect results (core/arg.py)
                m = arg.mask(x.dtype).reshape(
                    x.shape[:2] + (1,) * (x.ndim - 2))
                n = torch.clamp(m.sum(), min=1.0) * (
                    x.numel() / (x.shape[0] * x.shape[1] * x.shape[-1]))
                mean = (x * m).sum(dim=red) / n
                var = torch.square((x - mean) * m).sum(dim=red) / n
            else:
                mean = x.mean(dim=red)
                var = torch.square(x - mean).mean(dim=red)
            ctx.updated_state[self.name] = running_update(
                st, {"mean": mean, "var": var}, frac)
        scale = params["w0"] * torch.rsqrt(var + eps)
        offset = params["b"] - mean * scale
        y = x * scale + offset
        y = self.apply_activation_and_dropout(y, ctx, arg.seq_lens)
        return Arg(value=y, seq_lens=arg.seq_lens)
