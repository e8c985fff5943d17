"""Fused bottleneck layers over the BN->ReLU->1x1-GEMM kernels:
`paddle_tpu/layers/fused.py` on torch.

The graph-level face of `ops/bn_act_conv1x1.py`. Two layer types
replace chains of the ResNet bottleneck block (`models/image.py
_bottleneck`, fused=True):

- `fused_conv1x1_bn` = conv(1x1, no bias) + batch_norm(act): the GEMM
  (B1) runs with a statistics epilogue, so the BN statistics cost no
  extra pass over the conv output; the normalize + act stays plain
  elementwise.
- `fused_bottleneck_tail` = batch_norm(act=relu) + conv(1x1, no bias)
  + batch_norm + residual add + act: the first BN's normalize/ReLU is
  folded into the GEMM's input side (never stored), the second BN's
  statistics come from the epilogue, and the out-BN normalize, the
  residual add and the act are one plain elementwise chain.

Parameter names and state slots are the JAX package's (`w0`, `g`, `b`;
`w0`, `gi`, `bi`, `go`, `bo`; `mean`/`var`; `in_mean`, `in_var`,
`out_mean`, `out_var`). The running statistics are updated detached
(`layers/norm.py::running_update`). Under the AMP rule the activations,
w and y are bf16 (the op's bf16 form), the folded affines and the
statistics f32 (the in-BN's one-pass, `layers/norm.py::moments`), and
the out-BN normalize runs in y's dtype, as in the JAX layers.
"""

from __future__ import annotations

import torch

from paddle_tpu_torch.core.arg import Arg
from paddle_tpu_torch.core.config import ParameterConf
from paddle_tpu_torch.core.registry import LAYERS
from paddle_tpu_torch.layers.base import Layer, Spec
from paddle_tpu_torch.layers.norm import bn_affine, moments, running_update
from paddle_tpu_torch.ops.bn_act_conv1x1 import bn_act_conv1x1


def moments_from_epilogue(s1, s2, n):
    """Mean and variance from the epilogue's sums: E[y], E[y^2]-E[y]^2
    (clamped at 0), as the JAX layers take them."""
    mean = s1 / n
    return mean, torch.clamp_min(s2 / n - torch.square(mean), 0.0)


def _bn_param_confs(layer, c, prefix):
    gamma = ParameterConf(
        name=f"_{layer.name}.{prefix}g", dims=(c,),
        initial_strategy="constant", initial_value=1.0,
    )
    beta = ParameterConf(
        name=f"_{layer.name}.{prefix}b", dims=(c,),
        initial_strategy="constant", initial_value=0.0,
    )
    return gamma, beta


def _no_seq(layer, s):
    assert not s.is_seq, (
        f"{layer.name}: fused BN layers compute unmasked batch "
        "statistics — sequence inputs would let padding corrupt "
        "them (use conv+batch_norm)"
    )


def _rows(x):
    """An NHWC activation as the contiguous [N, C] matrix of the op."""
    b, h, w, c = x.shape
    return x.reshape(b * h * w, c).contiguous()


@LAYERS.register("fused_conv1x1_bn")
class FusedConv1x1BN(Layer):
    """1x1 conv (stride 1, no bias) + BatchNorm(act) with the BN stats
    accumulated in the GEMM's epilogue. attrs: num_filters, epsilon,
    moving_average_fraction, use_global_stats."""

    def build(self, in_specs):
        (s,) = in_specs
        _no_seq(self, s)
        h, w, c = s.dim
        nf = self.conf.attrs.get("num_filters", self.conf.size)
        pcs = {"w0": self.weight_conf(0, (c, nf))}
        if pcs["w0"].initial_std is None:
            pcs["w0"].initial_std = (2.0 / c) ** 0.5
        pcs["g"], pcs["b"] = _bn_param_confs(self, nf, "bn")
        self._channels = nf
        self._in_shape = (h, w, c)
        return Spec(dim=(h, w, nf), is_seq=s.is_seq), pcs

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
        b, h, w, _c = x.shape
        n = b * h * w
        cin = self._in_shape[2]
        ones = torch.ones((cin,), device=x.device)
        zeros = torch.zeros((cin,), device=x.device)
        y2d, s1, s2 = bn_act_conv1x1(_rows(x), ones, zeros, params["w0"],
                                     act="")
        st = ctx.state[self.name]
        if use_global:
            mean, var = st["mean"], st["var"]
            ctx.updated_state[self.name] = st
        else:
            mean, var = moments_from_epilogue(s1, s2, n)
            ctx.updated_state[self.name] = running_update(
                st, {"mean": mean, "var": var}, frac)
        scale, shift = bn_affine(params["g"], params["b"], mean, var, eps)
        y = y2d.reshape(b, h, w, -1)
        y = y * scale.to(y.dtype) + shift.to(y.dtype)
        y = self.apply_activation_and_dropout(y, ctx, arg.seq_lens)
        return Arg(value=y, seq_lens=arg.seq_lens)


@LAYERS.register("fused_bottleneck_tail")
class FusedBottleneckTail(Layer):
    """BN(in)+ReLU -> 1x1 conv -> BN(out) [+ residual] -> act, with the
    in-BN normalize/ReLU fused into the GEMM input side and the out-BN
    stats from the epilogue. Inputs: [conv_raw, residual?]. attrs:
    num_filters, epsilon, moving_average_fraction, use_global_stats."""

    def build(self, in_specs):
        s = in_specs[0]
        _no_seq(self, s)
        h, w, c = s.dim
        nf = self.conf.attrs.get("num_filters", self.conf.size)
        if len(in_specs) > 1:
            rs = in_specs[1]
            assert rs.dim == (h, w, nf), (
                f"{self.name}: residual dim {rs.dim} != output "
                f"{(h, w, nf)}"
            )
        pcs = {"w0": self.weight_conf(0, (c, nf))}
        if pcs["w0"].initial_std is None:
            pcs["w0"].initial_std = (2.0 / c) ** 0.5
        pcs["gi"], pcs["bi"] = _bn_param_confs(self, c, "bni")
        pcs["go"], pcs["bo"] = _bn_param_confs(self, nf, "bno")
        self._cin, self._cout = c, nf
        return Spec(dim=(h, w, nf), is_seq=s.is_seq), pcs

    def init_state(self, device):
        return {
            "in_mean": torch.zeros((self._cin,), device=device),
            "in_var": torch.ones((self._cin,), device=device),
            "out_mean": torch.zeros((self._cout,), device=device),
            "out_var": torch.ones((self._cout,), device=device),
        }

    def forward(self, params, inputs, ctx):
        arg = inputs[0]
        res = inputs[1].value if len(inputs) > 1 else None
        a = self.conf.attrs
        eps = a.get("epsilon", 1e-5)
        frac = a.get("moving_average_fraction", 0.9)
        use_global = a.get("use_global_stats", False) or not ctx.train
        x = arg.value
        b, h, w, _c = x.shape
        n = b * h * w
        st = ctx.state[self.name]

        # in-BN statistics over the raw conv output with plain ops (one
        # pass for bf16, layers/norm.py's rule)
        if use_global:
            in_mean, in_var = st["in_mean"], st["in_var"]
        else:
            in_mean, in_var = moments(x)
        scale_i, shift_i = bn_affine(params["gi"], params["bi"], in_mean,
                                     in_var, eps)
        # the residual joins after the out-BN, as in the JAX layer — the
        # op's residual input stays unused here
        y2d, s1, s2 = bn_act_conv1x1(_rows(x), scale_i, shift_i,
                                     params["w0"], act="relu")
        if use_global:
            out_mean, out_var = st["out_mean"], st["out_var"]
            ctx.updated_state[self.name] = st
        else:
            out_mean, out_var = moments_from_epilogue(s1, s2, n)
            ctx.updated_state[self.name] = running_update(st, {
                "in_mean": in_mean, "in_var": in_var,
                "out_mean": out_mean, "out_var": out_var}, frac)
        scale_o, shift_o = bn_affine(params["go"], params["bo"], out_mean,
                                     out_var, eps)
        y = y2d.reshape(b, h, w, -1)
        y = y * scale_o.to(y.dtype) + shift_o.to(y.dtype)
        if res is not None:
            y = y + res
        y = self.apply_activation_and_dropout(y, ctx, arg.seq_lens)
        return Arg(value=y, seq_lens=arg.seq_lens)
