"""Long-tail layers of `paddle_tpu/layers/extras.py`, every type of it:
selective FC, the NTM conv-shift, bilinear interpolation, convex
combination, the EOS check, power, clip, row (lookahead) conv,
feature-map expand, PReLU, the gated unit, repeat, k-max sequence
score, vector-matrix cosine, data norm, print, get_output and eltmul.

Reference: gserver/layers/{SelectiveFullyConnectedLayer,ConvShiftLayer,
BilinearInterpLayer,ConvexCombinationLayer,EosIdCheckLayer,PowerLayer,
ClipLayer,RowConvLayer,FeatureMapExpandLayer,...}.cpp.

Where the JAX layer differs in kind from an eager one:
- `kmax_seq_score` takes `lax.top_k`, which orders equal scores by the
  lower index; `torch.topk` on CUDA does not promise that, so the
  layer selects through `ops/topk.py::top_k_stable`.
- `print` is `jax.debug.print` inside jit there. Here it prints on the
  host when it runs; inside a CUDA-graph capture (`parallel/graph.py`)
  a host print cannot run, so the layer raises there, naming itself.
- `get_output` renames its input edge to `<producer>@<arg>` when it is
  built, so that `Network` resolves it to the producer's extra output,
  as the JAX builder does.
"""

from __future__ import annotations

import torch

from paddle_tpu_torch.core.arg import Arg
from paddle_tpu_torch.core.registry import LAYERS
from paddle_tpu_torch.layers.base import Layer, Spec
from paddle_tpu_torch.ops.sequence_ops import seq_shift
from paddle_tpu_torch.ops.topk import top_k_stable


@LAYERS.register("selective_fc")
class SelectiveFCLayer(Layer):
    """FC that scores only a selected subset of output columns. inputs:
    [x] or [x, sel], sel.value a dense 0/1 mask [B, out]. With a softmax
    the denominator runs over the selected columns only; non-selected
    outputs are zeroed after the activation."""

    def build(self, in_specs):
        out = self.conf.size
        pcs = {"w0": self.weight_conf(0, (in_specs[0].size, out))}
        b = self.bias_conf((out,))
        if b is not None:
            pcs["b"] = b
        return Spec(dim=(out,), is_seq=in_specs[0].is_seq), pcs

    def forward(self, params, inputs, ctx):
        x = inputs[0]
        y = torch.matmul(x.value, params["w0"])
        if "b" in params:
            y = y + params["b"]
        sel = inputs[1].value if len(inputs) > 1 else None
        if sel is not None and self.conf.active_type in (
                "softmax", "sequence_softmax"):
            y = torch.where(sel > 0, y, -1e9)
        y = self.apply_activation_and_dropout(y, ctx, x.seq_lens)
        if sel is not None:
            y = y * sel
        return Arg(value=y, seq_lens=x.seq_lens)


@LAYERS.register("conv_shift")
class ConvShiftLayer(Layer):
    """Circular convolution (NTM addressing): inputs [a (B, M), b (B,
    N)], N odd; c[i] = sum_{j=-(N-1)/2}^{(N-1)/2} a[(i+j) mod M] *
    b[j]."""

    def build(self, in_specs):
        sa, sb = in_specs
        assert sb.size % 2 == 1, "conv_shift filter width must be odd"
        self._n = sb.size
        return Spec(dim=(sa.size,), is_seq=sa.is_seq), {}

    def forward(self, params, inputs, ctx):
        a, b = inputs[0].value, inputs[1].value
        half = (self._n - 1) // 2
        c = 0.0
        for j in range(-half, half + 1):
            c = c + torch.roll(a, -j, dims=-1) * b[..., j + half:j + half + 1]
        return Arg(value=c, seq_lens=inputs[0].seq_lens)


@LAYERS.register("bilinear_interp")
class BilinearInterpLayer(Layer):
    """Align-corners bilinear resize of an (H, W, C) map
    (BilinearInterpLayer.cpp: ratio (in-1)/(out-1), corners kept).
    attrs: out_size_x (W), out_size_y (H)."""

    def build(self, in_specs):
        (s,) = in_specs
        assert len(s.dim) == 3, "bilinear_interp needs an (H,W,C) input"
        self._c = s.dim[2]
        self._oh = self.conf.attrs["out_size_y"]
        self._ow = self.conf.attrs["out_size_x"]
        return Spec(dim=(self._oh, self._ow, self._c)), {}

    def forward(self, params, inputs, ctx):
        x = inputs[0].value
        h, w = x.shape[1], x.shape[2]
        oh, ow = self._oh, self._ow
        ry = (h - 1) / (oh - 1) if oh > 1 else 0.0
        rx = (w - 1) / (ow - 1) if ow > 1 else 0.0
        # the sample positions in f32, as the JAX layer's arange * ratio
        ys = torch.arange(oh, device=x.device, dtype=torch.float32) * ry
        xs = torch.arange(ow, device=x.device, dtype=torch.float32) * rx
        y0 = torch.floor(ys).long()
        x0 = torch.floor(xs).long()
        y1 = torch.clamp(y0 + 1, max=h - 1)
        x1 = torch.clamp(x0 + 1, max=w - 1)
        wy = (ys - y0).to(x.dtype)[None, :, None, None]
        wx = (xs - x0).to(x.dtype)[None, None, :, None]
        r0, r1 = x[:, y0], x[:, y1]
        top = r0[:, :, x0] * (1 - wx) + r0[:, :, x1] * wx
        bot = r1[:, :, x0] * (1 - wx) + r1[:, :, x1] * wx
        return Arg(value=top * (1 - wy) + bot * wy)


@LAYERS.register("convex_comb", "linear_comb")
class ConvexCombLayer(Layer):
    """Weighted combination of M sub-vectors: inputs [w (B, M), x (B,
    M*D)]; out[b] = sum_m w[b, m] * x[b, m, :]."""

    def build(self, in_specs):
        sw, sx = in_specs
        d = self.conf.size
        assert sx.size == sw.size * d, (
            f"convex_comb: {sx.size} != {sw.size} * {d}")
        self._m = sw.size
        return Spec(dim=(d,), is_seq=sx.is_seq), {}

    def forward(self, params, inputs, ctx):
        w, x = inputs[0].value, inputs[1].value
        xm = x.reshape(x.shape[:-1] + (self._m, -1))
        return Arg(value=torch.sum(w[..., None] * xm, dim=-2),
                   seq_lens=inputs[1].seq_lens)


@LAYERS.register("eos_id")
class EosIdCheckLayer(Layer):
    """1.0 where the input id equals attrs["eos_id"]."""

    def build(self, in_specs):
        (s,) = in_specs
        return Spec(dim=(1,), is_seq=s.is_seq), {}

    def forward(self, params, inputs, ctx):
        ids = inputs[0].ids
        v = (ids == self.conf.attrs["eos_id"]).to(torch.float32)[..., None]
        return Arg(value=v, seq_lens=inputs[0].seq_lens)


@LAYERS.register("power")
class PowerLayer(Layer):
    """y = x^w with a per-example scalar exponent: inputs [w (B, 1), x
    (B, D)]."""

    def build(self, in_specs):
        return Spec(dim=(in_specs[1].size,), is_seq=in_specs[1].is_seq), {}

    def forward(self, params, inputs, ctx):
        w, x = inputs[0].value, inputs[1].value
        return Arg(value=torch.pow(x, w), seq_lens=inputs[1].seq_lens)


@LAYERS.register("clip")
class ClipLayer(Layer):
    """Clamp to [attrs min, attrs max]."""

    def build(self, in_specs):
        (s,) = in_specs
        return s, {}

    def forward(self, params, inputs, ctx):
        a = self.conf.attrs
        x = inputs[0]
        return x.with_value(torch.clamp(x.value, a.get("min", -1.0),
                                        a.get("max", 1.0)))


@LAYERS.register("row_conv")
class RowConvLayer(Layer):
    """Lookahead (row) convolution over future timesteps (DeepSpeech2):
    y[t] = sum_{j<L} W[j] * x[t+j], weight [context_length, D], zero
    past each sequence's own end."""

    def build(self, in_specs):
        (s,) = in_specs
        self._L = self.conf.attrs["context_length"]
        pcs = {"w0": self.weight_conf(0, (self._L, s.size))}
        return Spec(dim=(s.size,), is_seq=True), pcs

    def forward(self, params, inputs, ctx):
        x, lens = inputs[0].value, inputs[0].seq_lens
        w = params["w0"]
        y = 0.0
        for j in range(self._L):
            y = y + seq_shift(x, lens, j) * w[j]
        return Arg(value=y, seq_lens=lens)


@LAYERS.register("featmap_expand")
class FeatureMapExpandLayer(Layer):
    """Tile a [B, D] vector across attrs["num_filters"] feature maps ->
    [B, num_filters * D]."""

    def build(self, in_specs):
        (s,) = in_specs
        self._n = self.conf.attrs["num_filters"]
        return Spec(dim=(self._n * s.size,), is_seq=s.is_seq), {}

    def forward(self, params, inputs, ctx):
        x = inputs[0].value
        y = x[..., None, :].expand(x.shape[:-1] + (self._n, x.shape[-1]))
        return Arg(value=y.reshape(x.shape[:-1] + (-1,)),
                   seq_lens=inputs[0].seq_lens)


@LAYERS.register("prelu")
class PReluLayer(Layer):
    """PReLU with learnable negative-side slopes. attrs partial_sum
    groups them: 0 = one slope per element, size = one shared slope,
    else each slope covers partial_sum consecutive elements. w0 starts
    at 0.25 unless the user configured its init."""

    def build(self, in_specs):
        (s,) = in_specs
        n = self.conf.attrs.get("partial_sum", 0) or 1
        assert s.size % n == 0, (
            f"prelu partial_sum {n} must divide input size {s.size}")
        self._group = n
        pcs = {"w0": self.weight_conf(0, (s.size // n,))}
        if (pcs["w0"].initial_std is None
                and pcs["w0"].initial_strategy == "normal"
                and pcs["w0"].initial_mean == 0.0):
            pcs["w0"].initial_strategy = "constant"
            pcs["w0"].initial_value = 0.25
        self._spec = s
        return s, pcs

    def forward(self, params, inputs, ctx):
        (x,) = inputs
        v = x.value
        a = torch.repeat_interleave(params["w0"], self._group).reshape(
            self._spec.dim)
        return x.with_value(torch.where(v >= 0, v, v * a))


@LAYERS.register("gated_unit")
class GatedUnitLayer(Layer):
    """GLU: act(x W0 + b) * sigmoid(x Wg); wg is named after w0 with
    `_gate`."""

    def build(self, in_specs):
        (s,) = in_specs
        out = self.conf.size
        pcs = {"w0": self.weight_conf(0, (s.size, out)),
               "wg": self.weight_conf(0, (s.size, out))}
        pcs["wg"].name = pcs["w0"].name + "_gate"
        b = self.bias_conf((out,))
        if b is not None:
            pcs["b"] = b
        return Spec(dim=(out,), is_seq=s.is_seq), pcs

    def forward(self, params, inputs, ctx):
        (x,) = inputs
        h = torch.matmul(x.value, params["w0"])
        if "b" in params:
            h = h + params["b"]
        h = self.apply_activation_and_dropout(h, ctx, x.seq_lens)
        gate = torch.sigmoid(torch.matmul(x.value, params["wg"]))
        return Arg(value=h * gate, seq_lens=x.seq_lens)


@LAYERS.register("repeat")
class RepeatLayer(Layer):
    """Tile the feature vector attrs["num_repeats"] times."""

    def build(self, in_specs):
        (s,) = in_specs
        self._n = self.conf.attrs["num_repeats"]
        return Spec(dim=(s.size * self._n,), is_seq=s.is_seq), {}

    def forward(self, params, inputs, ctx):
        (x,) = inputs
        reps = (1,) * (x.value.ndim - 1) + (self._n,)
        return Arg(value=x.value.repeat(reps), seq_lens=x.seq_lens)


@LAYERS.register("kmax_seq_score")
class KmaxSeqScoreLayer(Layer):
    """Positions of the top-k scores within each sequence: input [B, T,
    1] scores (seq); output ids [B, k], equal scores by the lower
    position (`lax.top_k`'s rule), -1 where a sequence is shorter than
    k."""

    def build(self, in_specs):
        self._k = self.conf.attrs.get("beam_size", 1)
        return Spec(dim=(self._k,), is_ids=True), {}

    def forward(self, params, inputs, ctx):
        (x,) = inputs
        v = x.value[..., 0] if x.value.ndim == 3 else x.value
        neg = torch.finfo(v.dtype).min
        masked = torch.where(x.bool_mask(), v, neg)
        top_s, idx = top_k_stable(masked, self._k)
        return Arg(ids=torch.where(top_s > neg, idx, -1))


@LAYERS.register("cos_vm")
class CosSimVecMatLayer(Layer):
    """Cosine similarity between a vector and each row of a matrix (NTM
    content addressing): inputs [v (B, D), m (B, W*D)]; out[b, i] =
    scale * cos(v[b], m[b, i, :]); size = W. The norms are sqrt(sum +
    1e-12), finite in the gradient at a zero row."""

    def build(self, in_specs):
        sv, sm = in_specs
        w = self.conf.size
        assert sm.size == w * sv.size, f"cos_vm: {sm.size} != {w} * {sv.size}"
        self._w = w
        return Spec(dim=(w,)), {}

    def forward(self, params, inputs, ctx):
        v, m = inputs[0].value, inputs[1].value
        mm = m.reshape(m.shape[0], self._w, -1)
        scale = self.conf.attrs.get("scale", 1.0)
        dot = torch.sum(v[:, None, :] * mm, dim=-1)
        nv = torch.sqrt(torch.sum(torch.square(v), -1, keepdim=True) + 1e-12)
        nm = torch.sqrt(torch.sum(torch.square(mm), -1) + 1e-12)
        return Arg(value=scale * dot / (nv * nm))


@LAYERS.register("data_norm")
class DataNormLayer(Layer):
    """Normalize inputs with precomputed statistics held as a static
    parameter w0 [3, D] (rows mean|min|decimal-scale, std|max-min|_),
    attrs data_norm_strategy in {z-score, min-max, decimal-scaling}. A
    zero divisor (statistics not loaded) means the identity."""

    def build(self, in_specs):
        (s,) = in_specs
        pc = self.weight_conf(0, (3, s.size))
        pc.is_static = True
        pc.initial_strategy = "zero"
        return s, {"w0": pc}

    def forward(self, params, inputs, ctx):
        (x,) = inputs
        stats = params["w0"]
        strat = self.conf.attrs.get("data_norm_strategy", "z-score")

        def denom(row):
            return torch.where(row == 0, 1.0, row)

        if strat in ("z-score", "min-max"):
            y = (x.value - stats[0]) / denom(stats[1])
        elif strat == "decimal-scaling":
            y = x.value / denom(stats[0])
        else:
            raise KeyError(f"unknown data_norm_strategy {strat!r}")
        return x.with_value(y)


@LAYERS.register("print")
class PrintLayer(Layer):
    """Identity that prints `<name>: <value>` on the host as it runs. A
    CUDA graph cannot hold a host print: inside a capture the layer
    raises, naming itself, rather than drop the print."""

    def build(self, in_specs):
        return in_specs[0], {}

    def forward(self, params, inputs, ctx):
        (x,) = inputs
        v = x.value if x.value is not None else x.ids
        if v.is_cuda and torch.cuda.is_current_stream_capturing():
            raise RuntimeError(
                f"print layer {self.name!r} cannot run inside a CUDA-graph "
                "capture (a host print); run this network eagerly "
                "(steps_per_dispatch 1) or drop the print layer")
        print(f"{self.name}: {v.detach().cpu().numpy()}", flush=True)
        return x


@LAYERS.register("get_output")
class GetOutputLayer(Layer):
    """Forward a named extra output of the single input layer
    (GetOutputLayer.cpp). The edge's `input_layer_argument` selects it:
    the edge is renamed to `<producer>@<arg>`, the name `Network` keeps
    that extra output under, and the layer is otherwise the
    identity."""

    def __init__(self, conf, model):
        super().__init__(conf, model)
        if len(conf.inputs) != 1:
            raise ValueError(
                f"get_output layer {conf.name!r} needs exactly 1 input, "
                f"got {len(conf.inputs)}")
        edge = conf.inputs[0]
        if "@" not in edge.name:
            arg = edge.attrs.get("input_layer_argument")
            if not arg:
                raise ValueError(
                    f"get_output layer {conf.name!r} input edge must set "
                    f"attrs['input_layer_argument'] (the named output of "
                    f"{edge.name!r} to forward)")
            edge.name = f"{edge.name}@{arg}"

    def build(self, in_specs):
        (s,) = in_specs
        return s, {}

    def forward(self, params, inputs, ctx):
        (x,) = inputs
        return x


@LAYERS.register("eltmul")
class ElementwiseMulLayer(Layer):
    """Elementwise product a * b (* scale): the mixed layer's
    DotMulOperator as a layer of its own."""

    def build(self, in_specs):
        a, b = in_specs
        assert a.size == b.size, (
            f"eltmul {self.name}: operand sizes differ ({a.size} vs {b.size})")
        return Spec(dim=a.dim, is_seq=a.is_seq or b.is_seq), {}

    def forward(self, params, inputs, ctx):
        a, b = inputs
        scale = self.conf.attrs.get("scale", 1.0)
        return a.with_value(scale * a.value * b.value)
