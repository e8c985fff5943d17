"""Spatial pooling: `paddle_tpu/layers/pool.py::PoolLayer` on torch.

NHWC at the layer boundary; `F.max_pool2d` / `F.avg_pool2d` run on the
channels-last NCHW view (`layers/conv.py::nchw`). Max pooling pads
with -inf; average pooling leaves the padding out of the divisor
(cuDNN's avg-pool-exclude-padding, the reference's AvgPooling). Where
the padding exceeds half the window, which PyTorch's pooling refuses,
the input is padded explicitly: with -inf for max; for avg, a sum
over the zero-padded input is divided by a count of real elements.
Pooling runs in the input's dtype (bf16 under the AMP rule; PyTorch's
average pooling accumulates a bf16 window in f32).

Left out, still to port (ROADMAP A9): `maxout`, `spp` and
`blockexpand`.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from paddle_tpu_torch.core.arg import Arg
from paddle_tpu_torch.core.registry import LAYERS
from paddle_tpu_torch.layers.base import Layer, Spec
from paddle_tpu_torch.layers.conv import _pair, conv_out_size, nchw, nhwc


def _pool2d(x, kind, window, stride, pad):
    """Pool an NCHW tensor as `paddle_tpu/layers/pool.py::_pool2d`
    pools NHWC."""
    (kh, kw), (ph, pw) = window, pad
    native = 2 * ph <= kh and 2 * pw <= kw
    if kind in ("max", "max-projection", "cudnn-max-pool"):
        if native:
            return F.max_pool2d(x, window, stride, pad)
        x = F.pad(x, (pw, pw, ph, ph), value=float("-inf"))
        return F.max_pool2d(x, window, stride)
    if native:
        return F.avg_pool2d(x, window, stride, pad, count_include_pad=False)
    summed = F.avg_pool2d(F.pad(x, (pw, pw, ph, ph)), window, stride,
                          divisor_override=1)
    ones = F.pad(torch.ones_like(x[:1, :1]), (pw, pw, ph, ph))
    counts = F.avg_pool2d(ones, window, stride, divisor_override=1)
    return summed / counts


@LAYERS.register("pool", "cudnn_pool")
class PoolLayer(Layer):
    """attrs: pool_type in {max, avg}, pool_size, stride, padding.
    Input spec dim (H, W, C)."""

    def build(self, in_specs):
        (s,) = in_specs
        h, w, c = s.dim
        a = self.conf.attrs
        kh, kw = _pair(a.get("pool_size", 2))
        sh, sw = _pair(a.get("stride", a.get("pool_size", 2)))
        ph, pw = _pair(a.get("padding", 0))
        oh = conv_out_size(h, kh, sh, ph)
        ow = conv_out_size(w, kw, sw, pw)
        self._shape = (h, w, c)
        return Spec(dim=(oh, ow, c), is_seq=s.is_seq), {}

    def forward(self, params, inputs, ctx):
        (arg,) = inputs
        a = self.conf.attrs
        kind = a.get("pool_type", "max")
        window = _pair(a.get("pool_size", 2))
        stride = _pair(a.get("stride", a.get("pool_size", 2)))
        pad = _pair(a.get("padding", 0))
        x = arg.value.reshape((arg.value.shape[0],) + self._shape)
        y = nhwc(_pool2d(nchw(x), kind, window, stride, pad))
        return Arg(value=y, seq_lens=arg.seq_lens)
