"""Spatial pooling: `paddle_tpu/layers/pool.py` on torch — pool,
maxout, the spatial pyramid (spp) and blockexpand.

NHWC at the layer boundary; `F.max_pool2d` / `F.avg_pool2d` run on the
channels-last NCHW view (`layers/conv.py::nchw`). Max pooling pads
with -inf; average pooling leaves the padding out of the divisor
(cuDNN's avg-pool-exclude-padding, the reference's AvgPooling). Where
the padding exceeds half the window, which PyTorch's pooling refuses,
the input is padded explicitly: with -inf for max; for avg, a sum
over the zero-padded input is divided by a count of real elements.
Pooling runs in the input's dtype (bf16 under the AMP rule; PyTorch's
average pooling accumulates a bf16 window in f32).

`blockexpand` is `F.unfold` on the NCHW view: its patch vector is
ordered channel-major (c, row, column), the order of the JAX layer's
`lax.conv_general_dilated_patches`.
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


@LAYERS.register("maxout")
class MaxOutLayer(Layer):
    """Max over `groups` consecutive channels (MaxOutLayer.cpp)."""

    def build(self, in_specs):
        (s,) = in_specs
        h, w, c = s.dim
        g = self.conf.attrs["groups"]
        self._shape = (h, w, c)
        return Spec(dim=(h, w, c // g), is_seq=s.is_seq), {}

    def forward(self, params, inputs, ctx):
        (arg,) = inputs
        g = self.conf.attrs["groups"]
        h, w, c = self._shape
        x = arg.value.reshape(-1, h, w, c // g, g)
        return Arg(value=x.amax(dim=-1), seq_lens=arg.seq_lens)


@LAYERS.register("spp")
class SpatialPyramidPoolLayer(Layer):
    """Spatial pyramid pooling (SpatialPyramidPoolLayer.cpp): levels l <
    pyramid_height of 2^l x 2^l bins, each pooled (pool_type) and
    concatenated into a fixed-length vector."""

    def build(self, in_specs):
        (s,) = in_specs
        h, w, c = s.dim
        ph = self.conf.attrs.get("pyramid_height", 3)
        total = sum((2 ** lv) * (2 ** lv) for lv in range(ph)) * c
        self._shape = (h, w, c)
        return Spec(dim=(total,), is_seq=s.is_seq), {}

    def forward(self, params, inputs, ctx):
        (arg,) = inputs
        ph = self.conf.attrs.get("pyramid_height", 3)
        kind = self.conf.attrs.get("pool_type", "max")
        h, w, c = self._shape
        x = nchw(arg.value.reshape((-1, h, w, c)))
        outs = []
        for lv in range(ph):
            bins = 2 ** lv
            kh, kw = -(-h // bins), -(-w // bins)
            pad = ((kh * bins - h + 1) // 2, (kw * bins - w + 1) // 2)
            y = nhwc(_pool2d(x, kind, (kh, kw), (kh, kw), pad))
            outs.append(y.reshape(y.shape[0], -1))
        return Arg(value=torch.cat(outs, dim=-1), seq_lens=arg.seq_lens)


@LAYERS.register("blockexpand", "block_expand")
class BlockExpandLayer(Layer):
    """Image -> sequence of patches (BlockExpandLayer.cpp): each output
    timestep is one [bh*bw*C] block, scanned row-major."""

    def build(self, in_specs):
        (s,) = in_specs
        h, w, c = s.dim
        a = self.conf.attrs
        bh, bw = _pair(a["block"])
        sh, sw = _pair(a.get("stride", a["block"]))
        ph, pw = _pair(a.get("padding", 0))
        self._shape = (h, w, c)
        self._steps = (conv_out_size(h, bh, sh, ph)
                       * conv_out_size(w, bw, sw, pw))
        return Spec(dim=(bh * bw * c,), is_seq=True), {}

    def forward(self, params, inputs, ctx):
        (arg,) = inputs
        a = self.conf.attrs
        x = nchw(arg.value.reshape((-1,) + self._shape))
        patches = F.unfold(x, _pair(a["block"]),
                           padding=_pair(a.get("padding", 0)),
                           stride=_pair(a.get("stride", a["block"])))
        b = patches.shape[0]
        lens = torch.full((b,), self._steps, dtype=torch.int32,
                          device=x.device)
        return Arg(value=patches.transpose(1, 2), seq_lens=lens)
