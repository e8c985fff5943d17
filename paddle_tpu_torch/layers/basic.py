"""Core dense layers of `paddle_tpu/layers/basic.py`: data, fc,
embedding and addto (the Transformer LM's), concat and scaling (the
sequence models'), and mixed with all of its projections (the beam
decoders' and the served bigram model's step; the first item of
ROADMAP A9, ported with A3a). The other nine types of that module are
still to port (ROADMAP A9).
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
