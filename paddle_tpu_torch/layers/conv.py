"""Convolution: `paddle_tpu/layers/conv.py::ConvLayer` on torch.

Activations stay NHWC at the layer boundary, as in the JAX package, and
weights keep its HWIO layout [fh, fw, cin/groups, nf], so one numpy
parameter dict feeds both packages. The convolution itself is
`F.conv2d` on `x.permute(0, 3, 1, 2)`: the NCHW view of NHWC memory is
channels-last, so the permute copies nothing, and the output's NHWC
view is contiguous again. The JAX package leaves these convolutions to
XLA (`lax.conv_general_dilated`) outside any Pallas kernel, as the port
leaves them to cuDNN, with TF32 off (`core/device.py`). bf16 input (the
AMP rule) gives bf16 output, cuDNN's bf16 convolution with f32
accumulation, as the JAX layer keeps bf16 outputs.

Left out, still to port (ROADMAP A9): `ConvTransLayer` and
`ConvOperatorLayer`.
"""

from __future__ import annotations

import torch.nn.functional as F

from paddle_tpu_torch.core.arg import Arg
from paddle_tpu_torch.core.registry import LAYERS
from paddle_tpu_torch.layers.base import Layer, Spec


def _pair(v):
    return tuple(v) if isinstance(v, (tuple, list)) else (v, v)


def conv_out_size(in_size, filt, stride, pad):
    return (in_size + 2 * pad - filt) // stride + 1


def _image_shape(name, s, attrs):
    """(H, W, C) of the input. Flat inputs (v1 configs declare
    data_layer(size=H*W*C), and fc outputs feeding the GAN deconv
    stack are flat) infer a square image from num_channels — the
    reference config_parser's img_pixels = sqrt(size/channels) rule."""
    if isinstance(s.dim, tuple) and len(s.dim) == 3:
        return s.dim
    size = s.dim if isinstance(s.dim, int) else 1
    if not isinstance(s.dim, int):
        for d in s.dim:
            size *= d
    c = attrs.get("num_channels")
    if not c:
        raise ValueError(
            f"conv '{name}': flat input of size {size} "
            "needs num_channels to infer the image shape"
        )
    hw = int(round((size / c) ** 0.5))
    if hw * hw * c != size:
        raise ValueError(
            f"conv '{name}': input size {size} is not "
            f"a square image with {c} channels"
        )
    return (hw, hw, c)


def nchw(x):
    """The NCHW view of an NHWC tensor (channels-last memory, no copy)."""
    return x.permute(0, 3, 1, 2)


def nhwc(x):
    """The NHWC view of an NCHW tensor."""
    return x.permute(0, 2, 3, 1)


@LAYERS.register("exconv", "cudnn_conv", "conv")
class ConvLayer(Layer):
    """2-D convolution. attrs: num_filters (or conf.size used as out dim),
    filter_size, stride=1, padding=0, groups=1, dilation=1.
    Input spec dim must be (H, W, C), or flat with num_channels."""

    def build(self, in_specs):
        (s,) = in_specs
        a = self.conf.attrs
        h, w, c = _image_shape(self.conf.name, s, a)
        fh, fw = _pair(a.get("filter_size", 3))
        sh, sw = _pair(a.get("stride", 1))
        ph, pw = _pair(a.get("padding", 0))
        dh, dw = _pair(a.get("dilation", 1))
        groups = a.get("groups", 1)
        nf = a.get("num_filters", self.conf.size)
        oh = conv_out_size(h, dh * (fh - 1) + 1, sh, ph)
        ow = conv_out_size(w, dw * (fw - 1) + 1, sw, pw)
        pcs = {"w0": self.weight_conf(0, (fh, fw, c // groups, nf))}
        if pcs["w0"].initial_std is None:
            # match reference conv init: std = sqrt(2 / (fan_in))
            pcs["w0"].initial_std = (2.0 / (fh * fw * c / groups)) ** 0.5
        b = self.bias_conf((nf,))
        if b is not None:
            pcs["b"] = b
        self._shape = (h, w, c)
        return Spec(dim=(oh, ow, nf), is_seq=s.is_seq), pcs

    def forward(self, params, inputs, ctx):
        (arg,) = inputs
        a = self.conf.attrs
        x = arg.value
        x = x.reshape((x.shape[0],) + self._shape)
        y = nhwc(F.conv2d(
            nchw(x),
            params["w0"].permute(3, 2, 0, 1),     # HWIO -> OIHW
            stride=_pair(a.get("stride", 1)),
            padding=_pair(a.get("padding", 0)),
            dilation=_pair(a.get("dilation", 1)),
            groups=a.get("groups", 1),
        ))
        if "b" in params:
            y = y + params["b"]
        y = self.apply_activation_and_dropout(y, ctx, arg.seq_lens)
        return Arg(value=y, seq_lens=arg.seq_lens)
