"""Normalization layers of `paddle_tpu/layers/norm.py` on torch: batch
normalization, the cross-map (local response) norm and row_l2_norm.

Running mean and variance live in the network's state, not its
parameters, and are never differentiated: the running-average update
runs under `torch.no_grad()`. The statistics follow the JAX package,
over every axis but the channel one, with padded timesteps of a
sequence masked out, accumulated in f32: for f32 input the mean and
the centered variance E[(x - mean)^2] (no cancellation); for bf16
input (the AMP rule) one pass, E[x] and E[x^2] - E[x]^2 clamped at 0,
with x^2 rounded to bf16 as the JAX layer squares it. The affine
y = x * scale + offset runs in x's dtype.

The cross-map norm divides by (1 + scale * sum of x^2 over a window of
`size` channels)^pow, over the last (channel) axis of the NHWC value,
with `scale` NOT divided by `size`: `F.local_response_norm` divides it,
which is another function.

On a mesh (inside `core/mesh.py::batch_context`) the statistics are
those of the global batch, as the JAX step's under GSPMD: the sums and
the count are all-reduced over the data axis before the moments
(`moments`), so the running averages agree on every rank and the
gradients compose.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from paddle_tpu_torch.core.arg import Arg
from paddle_tpu_torch.core.config import ParameterConf
from paddle_tpu_torch.core.mesh import DATA_AXIS, batch_mesh
from paddle_tpu_torch.core.registry import LAYERS
from paddle_tpu_torch.layers.base import Layer
from paddle_tpu_torch.parallel import collectives as C


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
        eps = a.get("epsilon", 1e-5)
        frac = a.get("moving_average_fraction", 0.9)
        use_global = a.get("use_global_stats", False) or not ctx.train
        x = arg.value
        st = ctx.state[self.name]
        if use_global:
            mean, var = st["mean"], st["var"]
            ctx.updated_state[self.name] = st
        else:
            m = None
            if arg.is_seq:
                # mask padded timesteps out of the statistics: padding
                # must never affect results (core/arg.py)
                m = arg.mask(x.dtype).reshape(
                    x.shape[:2] + (1,) * (x.ndim - 2))
            mean, var = moments(x, m)
            ctx.updated_state[self.name] = running_update(
                st, {"mean": mean, "var": var}, frac)
        scale, offset = bn_affine(params["w0"], params["b"], mean, var, eps)
        y = x * scale.to(x.dtype) + offset.to(x.dtype)
        y = self.apply_activation_and_dropout(y, ctx, arg.seq_lens)
        return Arg(value=y, seq_lens=arg.seq_lens)


def bn_affine(gamma, beta, mean, var, eps):
    """BN normalize folded to per-channel (scale, shift), f32."""
    f32 = torch.float32
    scale = gamma.to(f32) * torch.rsqrt(var.to(f32) + eps)
    return scale, beta.to(f32) - mean.to(f32) * scale


def moments(x, m=None):
    """f32 (mean, var) over every axis of x but the last; m, x's 0/1
    mask broadcast over its trailing axes, leaves masked positions out.
    f32 x: the centered variance; bf16 x: one pass, E[x^2] - E[x]^2
    clamped at 0 (the JAX layers' two forms). Each moment is a sum over
    a count; inside a batch context (`core/mesh.py::batch_context`) the
    sums and the count are all-reduced over the mesh's data axis first,
    so they are the global batch's (the f32 centered variance takes a
    second all-reduce, of the squared deviations from the global mean).
    On a one-rank mesh the all-reduce returns its operand's bits, and
    the moments are the meshless step's."""
    mesh = batch_mesh()

    def total(*parts):
        return global_sums(mesh, *parts) if mesh is not None else parts

    f32 = torch.float32
    red = tuple(range(x.ndim - 1))
    inner = x.numel() // (x.shape[0] * x.shape[-1])
    if m is None:
        cnt = torch.full((1,), float(x.numel() // x.shape[-1]), dtype=f32,
                         device=x.device)
        xm = x
    else:
        inner //= x.shape[1]
        cnt = (m.sum(dtype=f32) * inner).reshape(1)
        xm = x * m
    s1, n = total(xm.sum(dim=red, dtype=f32), cnt)
    if m is not None:
        n = torch.clamp(n, min=float(inner))
    mean = s1 / n
    if x.dtype == f32:
        d = x - mean if m is None else (x - mean) * m
        (s2,) = total(torch.square(d).sum(dim=red))
        return mean, s2 / n
    (s2,) = total(torch.square(xm).sum(dim=red, dtype=f32))
    return mean, torch.clamp_min(s2 / n - torch.square(mean), 0.0)


def global_sums(mesh, *parts):
    """Per-rank partial sums (f32 tensors) summed over the data axis,
    in one all-reduce (`parallel/collectives.py::all_reduce`, whose
    backward all-reduces)."""
    sizes = [p.numel() for p in parts]
    flat = C.all_reduce(torch.cat([p.reshape(-1) for p in parts]), mesh,
                        DATA_AXIS)
    return [t.view(p.shape) for t, p in zip(flat.split(sizes), parts)]


@LAYERS.register("norm", "cmrnorm-projection")
class CrossMapNormLayer(Layer):
    """Local response normalization across channels
    (function/CrossMapNormalOp.cpp): y = x / (1 + scale * sum x^2)^pow
    over a window of `size` channels centred on each. attrs: size (5),
    scale (1e-4), pow (0.75)."""

    def build(self, in_specs):
        return in_specs[0], {}

    def forward(self, params, inputs, ctx):
        (arg,) = inputs
        a = self.conf.attrs
        n = a.get("size", 5)
        x = arg.value
        half = n // 2
        padded = F.pad(torch.square(x), (half, n - 1 - half))
        c = x.shape[-1]
        # summed in the JAX layer's order, window offset by offset
        window = sum(padded[..., i:i + c] for i in range(n))
        denom = torch.pow(1.0 + a.get("scale", 1e-4) * window,
                          a.get("pow", 0.75))
        return arg.with_value(x / denom)


@LAYERS.register("row_l2_norm")
class RowL2NormLayer(Layer):
    """Row-wise L2 normalization (RowL2NormLayer.cpp): x / max(|x|,
    1e-12) over the last axis."""

    def build(self, in_specs):
        return in_specs[0], {}

    def forward(self, params, inputs, ctx):
        x = inputs[0].value
        n = torch.linalg.vector_norm(x, dim=-1, keepdim=True)
        return inputs[0].with_value(x / torch.clamp_min(n, 1e-12))
