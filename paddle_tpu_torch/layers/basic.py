"""Core dense layers of `paddle_tpu/layers/basic.py`: data, fc,
embedding, addto, concat, scaling, mixed with all of its projections,
and the combinators cos, interpolation, dot_mul, slope_intercept,
tensor, outer_prod, sum_to_one_norm, trans and resize. Every type of
that module is here; the products are `torch.matmul` / `torch.einsum`,
as the JAX layers leave them to XLA outside any Pallas kernel.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from paddle_tpu_torch.core.arg import Arg
from paddle_tpu_torch.core.registry import LAYERS
from paddle_tpu_torch.layers.base import Layer, Spec


@LAYERS.register("data")
class DataLayer(Layer):
    """Input placeholder. attrs: is_seq, has_subseq, is_ids, dim
    (feature shape tuple) or size."""

    def build(self, in_specs):
        a = self.conf.attrs
        dim = tuple(a.get("dim", (self.conf.size,)))
        return (
            Spec(
                dim=dim,
                is_seq=a.get("is_seq", False),
                has_subseq=a.get("has_subseq", False),
                is_ids=a.get("is_ids", False),
            ),
            {},
        )

    def forward(self, params, inputs, ctx):
        raise RuntimeError("data layers are fed, not computed")


@LAYERS.register("fc")
class FCLayer(Layer):
    """Fully connected: y = act(sum_i x_i @ W_i + b). Multiple inputs
    sum into one output."""

    def build(self, in_specs):
        out = self.conf.size
        pcs = {}
        seq = any(s.is_seq for s in in_specs)
        sub = any(s.has_subseq for s in in_specs)
        for i, s in enumerate(in_specs):
            pcs[f"w{i}"] = self.weight_conf(i, (s.size, out))
        b = self.bias_conf((out,))
        if b is not None:
            pcs["b"] = b
        return Spec(dim=(out,), is_seq=seq, has_subseq=sub), pcs

    def forward(self, params, inputs, ctx):
        y = None
        seq_lens = None
        subseq_lens = None
        any_seq = any(a.is_seq for a in inputs)
        for i, arg in enumerate(inputs):
            x = arg.value
            if arg.is_seq:
                seq_lens = arg.seq_lens
                subseq_lens = arg.subseq_lens
            x = x.reshape(x.shape[: 2 if arg.is_seq else 1] + (-1,))
            t = torch.matmul(x, params[f"w{i}"])
            if any_seq and not arg.is_seq:
                # mixed seq + non-seq inputs: broadcast the per-example
                # term over the time axis
                t = t[:, None, :]
            y = t if y is None else y + t
        if "b" in params:
            y = y + params["b"]
        y = self.apply_activation_and_dropout(y, ctx, seq_lens)
        return Arg(value=y, seq_lens=seq_lens, subseq_lens=subseq_lens)


@LAYERS.register("embedding")
class EmbeddingLayer(Layer):
    """Id -> row lookup. Input must carry ids. The table is marked
    sparse_update, as in the JAX package (the port's optimizers update
    it densely)."""

    def build(self, in_specs):
        (s,) = in_specs
        assert s.is_ids, f"embedding layer {self.name} needs an ids input"
        vocab = self.conf.attrs["vocab_size"]
        pc = self.weight_conf(0, (vocab, self.conf.size))
        pc.sparse_update = True
        if self.conf.attrs.get("sharded", False):
            pc.sparse_remote_update = True
        return (
            Spec(
                dim=(self.conf.size,),
                is_seq=s.is_seq,
                has_subseq=s.has_subseq,
            ),
            {"w0": pc},
        )

    def forward(self, params, inputs, ctx):
        (arg,) = inputs
        # F.embedding, not params["w0"][ids]: the same rows, but its
        # backward sums the gradients of repeated ids in parallel, where
        # indexing's backward walks them one by one — and every padded
        # position of a batch repeats one id
        y = F.embedding(arg.ids, params["w0"])
        if arg.is_seq:
            y = y * arg.mask(y.dtype)[..., None]
        return Arg(
            value=y, seq_lens=arg.seq_lens, subseq_lens=arg.subseq_lens
        )


@LAYERS.register("addto")
class AddtoLayer(Layer):
    """Elementwise sum of same-shaped inputs + bias + activation."""

    def build(self, in_specs):
        s0 = in_specs[0]
        pcs = {}
        b = self.bias_conf((s0.size,))
        if b is not None:
            pcs["b"] = b
        return s0, pcs

    def forward(self, params, inputs, ctx):
        y = inputs[0].value
        for a in inputs[1:]:
            y = y + a.value
        if "b" in params:
            y = y + params["b"]
        y = self.apply_activation_and_dropout(y, ctx, inputs[0].seq_lens)
        return inputs[0].with_value(y)


@LAYERS.register("concat", "concat2")
class ConcatLayer(Layer):
    """Feature-axis concat (gserver/layers/ConcatenateLayer.cpp). When all
    inputs are same-H,W image specs, concatenates channels and keeps the
    spatial shape; otherwise flattens."""

    def build(self, in_specs):
        seq = any(s.is_seq for s in in_specs)
        sub = any(s.has_subseq for s in in_specs)
        self._image = (
            all(len(s.dim) == 3 for s in in_specs)
            and len({s.dim[:2] for s in in_specs}) == 1
        )
        pcs = {}
        if self._image:
            h, w = in_specs[0].dim[:2]
            c = sum(s.dim[2] for s in in_specs)
            self._in_dims = [s.dim for s in in_specs]
            dim = (h, w, c)
        else:
            dim = (sum(s.size for s in in_specs),)
        b = self.bias_conf((Spec(dim=dim).size,))
        if b is not None:
            pcs["b"] = b
        return Spec(dim=dim, is_seq=seq, has_subseq=sub), pcs

    def forward(self, params, inputs, ctx):
        flat = []
        seq_lens = None
        subseq_lens = None
        for i, a in enumerate(inputs):
            x = a.value
            lead = 2 if a.is_seq else 1
            if a.is_seq:
                seq_lens = a.seq_lens
                subseq_lens = a.subseq_lens
            if self._image:
                x = x.reshape(x.shape[:lead] + tuple(self._in_dims[i]))
            else:
                x = x.reshape(x.shape[:lead] + (-1,))
            flat.append(x)
        y = torch.cat(flat, dim=-1)
        if "b" in params:
            b = params["b"]
            y = y + (b.reshape(y.shape[-3:]) if self._image else b)
        y = self.apply_activation_and_dropout(y, ctx, seq_lens)
        return Arg(value=y, seq_lens=seq_lens, subseq_lens=subseq_lens)


@LAYERS.register("scaling")
class ScalingLayer(Layer):
    """y = scalar_input * vector_input (gserver/layers/ScalingLayer.cpp).
    inputs: [weight (dim 1), x]."""

    def build(self, in_specs):
        return in_specs[1], {}

    def forward(self, params, inputs, ctx):
        return inputs[1].with_value(inputs[0].value * inputs[1].value)


@LAYERS.register("mixed")
class MixedLayer(Layer):
    """Sum of projections (gserver/layers/MixedLayer.cpp). Each input
    edge has attrs["proj"] in {identity, full_matrix, trans_full_matrix,
    table, dotmul, scaling, slice, context}; the results are summed,
    then bias and activation. An edge with attrs["conv_bias"] (a conv
    projection's filter count) makes the bias one per filter, shared
    over the spatial positions."""

    def build(self, in_specs):
        from paddle_tpu_torch.dsl import mixed_proj_size

        out = self.conf.size
        if not out:
            # size omitted: infer it from a size-preserving projection
            for s, ic in zip(in_specs, self.conf.inputs):
                out = mixed_proj_size(ic.attrs.get("proj", "full_matrix"),
                                      s.size, ic.attrs)
                if out:
                    break
            assert out, (
                f"mixed layer {self.name}: size must be given (no "
                f"size-preserving projection to infer it from)")
            self.conf.size = out
        pcs = {}
        seq = any(s.is_seq for s in in_specs)
        for i, (s, ic) in enumerate(zip(in_specs, self.conf.inputs)):
            proj = ic.attrs.get("proj", "full_matrix")
            if proj == "full_matrix":
                pcs[f"w{i}"] = self.weight_conf(i, (s.size, out))
            elif proj == "trans_full_matrix":
                pcs[f"w{i}"] = self.weight_conf(i, (out, s.size))
            elif proj == "table":
                pc = self.weight_conf(i, (ic.attrs["vocab_size"], out))
                pc.sparse_update = True
                pcs[f"w{i}"] = pc
            elif proj == "dotmul":
                pcs[f"w{i}"] = self.weight_conf(i, (out,))
            elif proj == "scaling":
                pcs[f"w{i}"] = self.weight_conf(i, (1,))
            elif proj == "identity":
                assert s.size == out, (
                    f"identity proj size mismatch on {self.name}")
            elif proj == "slice":
                # SliceProjection.cpp: concat of [start, end) slices
                tot = sum(e - b for b, e in ic.attrs["slices"])
                assert tot == out, (
                    f"slice proj on {self.name}: slices sum to {tot}, "
                    f"layer is {out} wide")
                for b_, e_ in ic.attrs["slices"]:
                    assert e_ <= s.size, (
                        f"slice ({b_}, {e_}) beyond input width {s.size}")
            elif proj == "context":
                # ContextProjection.h: concat context_length neighbouring
                # timesteps starting at offset context_start
                n = ic.attrs["context_length"]
                assert s.size * n == out, (
                    f"context proj on {self.name}: {s.size}*{n} != {out}")
                assert s.is_seq, "context projection needs a sequence input"
            else:
                raise KeyError(f"unknown projection {proj!r}")
        conv_bias = [ic.attrs.get("conv_bias") for ic in self.conf.inputs]
        self._shared_bias = bool(conv_bias and conv_bias[0])
        bias_width = (sum(cb or 0 for cb in conv_bias) if self._shared_bias
                      else out)
        b = self.bias_conf((bias_width,))
        if b is not None:
            pcs["b"] = b
        sub = any(s.has_subseq for s in in_specs)
        if self._shared_bias and len(in_specs[0].dim) == 3:
            # a mixed over conv projections keeps the conv's spatial
            # shape, so that a concat after it merges channels
            return Spec(dim=in_specs[0].dim, is_seq=seq,
                        has_subseq=sub), pcs
        return Spec(dim=(out,), is_seq=seq, has_subseq=sub), pcs

    def forward(self, params, inputs, ctx):
        y = None
        seq_lens = subseq_lens = None
        for i, (a, ic) in enumerate(zip(inputs, self.conf.inputs)):
            proj = ic.attrs.get("proj", "full_matrix")
            if a.is_seq:
                seq_lens, subseq_lens = a.seq_lens, a.subseq_lens
            if proj == "identity":
                t = a.value
            elif proj == "full_matrix":
                t = torch.matmul(a.value, params[f"w{i}"])
            elif proj == "trans_full_matrix":
                t = torch.matmul(a.value, params[f"w{i}"].T)
            elif proj == "table":
                t = F.embedding(a.ids, params[f"w{i}"])
            elif proj == "dotmul":
                t = a.value * params[f"w{i}"]
            elif proj == "scaling":
                t = a.value * params[f"w{i}"][0]
            elif proj == "slice":
                lead = 2 if a.is_seq else 1
                xs = a.value.reshape(a.value.shape[:lead] + (-1,))
                t = torch.cat([xs[..., b_:e_]
                               for b_, e_ in ic.attrs["slices"]], dim=-1)
            else:  # context
                from paddle_tpu_torch.ops.sequence_ops import seq_shift

                n = ic.attrs["context_length"]
                start = ic.attrs.get("context_start", -(n // 2))
                t = torch.cat([seq_shift(a.value, a.seq_lens, start + o)
                               for o in range(n)], dim=-1)
            y = t if y is None else y + t
        if "b" in params:
            b = params["b"]
            if self._shared_bias and y.shape[-1] != b.shape[0]:
                # a per-filter bias over an NHWC-flattened conv output:
                # channels are the fastest axis, so tile over positions
                b = b.repeat(y.shape[-1] // b.shape[0])
            y = y + b
        y = self.apply_activation_and_dropout(y, ctx, seq_lens)
        return Arg(value=y, seq_lens=seq_lens, subseq_lens=subseq_lens)


@LAYERS.register("cos")
class CosSimLayer(Layer):
    """Cosine similarity of two inputs, scaled (CosSimLayer.cpp). attrs:
    scale (default 1). With size=k > 1, input b packs k vectors of a's
    width and the output is the k similarities per example."""

    def build(self, in_specs):
        seq = any(s.is_seq for s in in_specs)
        k = self.conf.size or 1
        if k > 1:
            assert in_specs[1].size == k * in_specs[0].size, (
                f"cos {self.name}: size={k} needs b of width "
                f"{k}*{in_specs[0].size}, got {in_specs[1].size}")
        return Spec(dim=(k,), is_seq=seq), {}

    def forward(self, params, inputs, ctx):
        a, b = inputs[0].value, inputs[1].value
        scale = self.conf.attrs.get("scale", 1.0)
        k = self.conf.size or 1
        keep = k == 1
        if not keep:
            b = b.reshape(b.shape[:-1] + (k, a.shape[-1]))
            a = a[..., None, :]
        num = torch.sum(a * b, dim=-1, keepdim=keep)
        den = (torch.linalg.vector_norm(a, dim=-1, keepdim=keep)
               * torch.linalg.vector_norm(b, dim=-1, keepdim=keep))
        return Arg(value=scale * num / torch.clamp(den, min=1e-8),
                   seq_lens=inputs[0].seq_lens)


@LAYERS.register("interpolation")
class InterpolationLayer(Layer):
    """y = w*x1 + (1-w)*x2 with a per-example scalar w
    (InterpolationLayer.cpp). inputs: [w (1 wide), x1, x2]."""

    def build(self, in_specs):
        return in_specs[1], {}

    def forward(self, params, inputs, ctx):
        w = inputs[0].value
        y = w * inputs[1].value + (1.0 - w) * inputs[2].value
        return inputs[1].with_value(y)


@LAYERS.register("dot_mul")
class DotMulLayer(Layer):
    """Elementwise product of two inputs (the mixed layer's
    DotMulOperator)."""

    def build(self, in_specs):
        return in_specs[0], {}

    def forward(self, params, inputs, ctx):
        y = inputs[0].value * inputs[1].value
        y = self.apply_activation_and_dropout(y, ctx, inputs[0].seq_lens)
        return inputs[0].with_value(y)


@LAYERS.register("slope_intercept")
class SlopeInterceptLayer(Layer):
    """y = slope*x + intercept (SlopeInterceptLayer.cpp)."""

    def build(self, in_specs):
        return in_specs[0], {}

    def forward(self, params, inputs, ctx):
        a = self.conf.attrs
        y = a.get("slope", 1.0) * inputs[0].value + a.get("intercept", 0.0)
        return inputs[0].with_value(y)


@LAYERS.register("tensor")
class TensorLayer(Layer):
    """Bilinear tensor product y_k = x1 @ W_k @ x2 (TensorLayer.cpp);
    w0 is [out, size1, size2]."""

    def build(self, in_specs):
        s1, s2 = in_specs
        out = self.conf.size
        pcs = {"w0": self.weight_conf(0, (out, s1.size, s2.size))}
        b = self.bias_conf((out,))
        if b is not None:
            pcs["b"] = b
        return Spec(dim=(out,), is_seq=s1.is_seq), pcs

    def forward(self, params, inputs, ctx):
        x1, x2 = inputs[0].value, inputs[1].value
        # (x1 @ W_k) . x2 for every k: one matmul against [s1, out*s2]
        w = params["w0"]
        k, s1, s2 = w.shape
        t = torch.matmul(x1, w.permute(1, 0, 2).reshape(s1, k * s2))
        y = torch.sum(t.reshape(t.shape[:-1] + (k, s2)) * x2[..., None, :],
                      dim=-1)
        if "b" in params:
            y = y + params["b"]
        y = self.apply_activation_and_dropout(y, ctx, inputs[0].seq_lens)
        return inputs[0].with_value(y)


@LAYERS.register("outer_prod", "out_prod")
class OuterProdLayer(Layer):
    """Outer product of two vectors, flattened (OuterProdLayer.cpp)."""

    def build(self, in_specs):
        s1, s2 = in_specs
        return Spec(dim=(s1.size * s2.size,), is_seq=s1.is_seq), {}

    def forward(self, params, inputs, ctx):
        x1, x2 = inputs[0].value, inputs[1].value
        y = x1[..., :, None] * x2[..., None, :]
        return inputs[0].with_value(y.reshape(y.shape[:-2] + (-1,)))


@LAYERS.register("sum_to_one_norm")
class SumToOneNormLayer(Layer):
    """Row-normalize to sum 1 (SumToOneNormLayer.cpp); a row summing to
    0 stays as it is."""

    def build(self, in_specs):
        return in_specs[0], {}

    def forward(self, params, inputs, ctx):
        x = inputs[0].value
        s = torch.sum(x, dim=-1, keepdim=True)
        return inputs[0].with_value(x / torch.where(s == 0, 1.0, s))


@LAYERS.register("trans")
class TransLayer(Layer):
    """Matrix transpose of the per-example [H, W] view (TransLayer.cpp).
    attrs: height, width; else the input spec's (H, W[, C]) or a square
    flat width."""

    def build(self, in_specs):
        (s,) = in_specs
        a = self.conf.attrs
        h, w = a.get("height"), a.get("width")
        if not (h and w):
            if len(s.dim) >= 2:
                h, w = s.dim[0], s.dim[1] * (s.dim[2] if len(s.dim) == 3
                                             else 1)
            else:
                hw = int(round(s.size ** 0.5))
                assert hw * hw == s.size, (
                    f"trans {self.name}: flat width {s.size} is not "
                    "square; pass height/width")
                h = w = hw
        self._hw = (h, w)
        return Spec(dim=(w * h,), is_seq=s.is_seq), {}

    def forward(self, params, inputs, ctx):
        h, w = self._hw
        x = inputs[0].value
        lead = x.shape[:-1]
        y = x.reshape(lead + (h, w)).transpose(-1, -2).reshape(lead + (h * w,))
        return inputs[0].with_value(y)


@LAYERS.register("resize")
class ResizeLayer(Layer):
    """Reshape the feature dim (ResizeLayer.cpp)."""

    def build(self, in_specs):
        return Spec(dim=(self.conf.size,), is_seq=in_specs[0].is_seq), {}

    def forward(self, params, inputs, ctx):
        x = inputs[0].value
        lead = 2 if inputs[0].is_seq else 1
        return inputs[0].with_value(
            x.reshape(x.shape[:lead] + (self.conf.size,)))
