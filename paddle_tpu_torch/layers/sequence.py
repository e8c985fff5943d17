"""Sequence-structure layers: `paddle_tpu/layers/sequence.py` on torch.

seqpool, seqlastins and expand at every level (whole sequence,
strided, sub-sequence, `output_max_index`), and seqconcat,
seqreshape, seqreverse, slice, padding, crop, rotate, gen_output,
subseq and sub_nested_seq. Mask semantics over dense [B,T,...] (see
ops/sequence_ops.py); a nested sequence is flat-packed [B,T,...] with
`subseq_lens` [B,S]. Plain tensor ops: no host synchronisation, so a
step through them can be captured as a CUDA graph.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from paddle_tpu_torch.core.arg import Arg
from paddle_tpu_torch.core.registry import LAYERS
from paddle_tpu_torch.layers.base import Layer, Spec
from paddle_tpu_torch.ops import sequence_ops as sops


@LAYERS.register("seqpool", "sequence_pool", "average", "max")
class SequencePoolLayer(Layer):
    """Pool a sequence to one vector per example, or each sub-sequence to
    one timestep. attrs: pool_type in {sum, average, max, sqrt_average},
    level ("seq" -> [B,D], "subseq" -> [B,S,D]), stride (> 0: one frame
    per stride-window, a sequence of ceil(len/stride) frames),
    output_max_index (the argmax timestep per feature, as a value)."""

    _OPS = {
        "sum": sops.seq_sum,
        "average": sops.seq_avg,
        "avg": sops.seq_avg,
        "sqrt_average": sops.seq_sqrt_avg,
        "max": sops.seq_max,
    }
    _SUBSEQ_OPS = {
        "sum": "sum", "average": "avg", "avg": "avg", "max": "max",
        "sqrt_average": "sqrt_avg", "last": "last", "first": "first",
    }

    def build(self, in_specs):
        (s,) = in_specs
        a = self.conf.attrs
        assert not (a.get("stride", 0) and a.get("output_max_index")), (
            f"seqpool {self.name}: stride with output_max_index is "
            "ambiguous")
        if a.get("stride", 0) or a.get("level", "seq") == "subseq":
            # a plain sequence at the subseq level is its own ONE
            # sub-sequence -> [B, 1, D]
            return Spec(dim=s.dim, is_seq=True), {}
        return Spec(dim=s.dim), {}

    def forward(self, params, inputs, ctx):
        (arg,) = inputs
        a = self.conf.attrs
        # the reference's AverageLayer/MaxLayer are separate types with
        # the pool kind baked into the type name
        default = (self.conf.type if self.conf.type in ("average", "max")
                   else "sum")
        kind = a.get("pool_type", default)
        stride = a.get("stride", 0) or 0
        x = arg.value
        if a.get("output_max_index"):
            t = x.shape[1]
            pos = torch.arange(t, device=x.device)[None, :, None]
            masked = torch.where(pos < arg.seq_lens[:, None, None], x,
                                 torch.full_like(x, -torch.inf))
            return Arg(value=torch.argmax(masked, dim=1).to(x.dtype))
        if stride > 0:
            return self._strided(x, arg.seq_lens, kind, stride)
        if a.get("level", "seq") == "subseq":
            if kind not in self._SUBSEQ_OPS:
                raise KeyError(
                    f"seqpool {self.name}: pool_type {kind!r} not supported "
                    f"at subseq level (supported: {sorted(self._SUBSEQ_OPS)})")
            if arg.subseq_lens is None:
                y = self._OPS[kind](x, arg.seq_lens)[:, None]
                ones = torch.ones((y.shape[0],), dtype=torch.int32,
                                  device=y.device)
                return Arg(value=y, seq_lens=ones)
            y = sops.subseq_pool(x, arg.subseq_lens, self._SUBSEQ_OPS[kind])
            lens = torch.sum(arg.subseq_lens > 0, dim=1, dtype=torch.int32)
            return Arg(value=y, seq_lens=lens)
        return Arg(value=self._OPS[kind](x, arg.seq_lens))

    @staticmethod
    def _strided(x, seq_lens, kind, stride):
        """One pooled frame per window of `stride` timesteps
        (SequencePoolLayer.cpp stride_)."""
        b, t = x.shape[0], x.shape[1]
        n_w = -(-t // stride)
        trail = x.shape[2:]
        xw = F.pad(x, (0, 0) * len(trail) + (0, n_w * stride - t))
        xw = xw.reshape((b, n_w, stride) + trail)
        pos = torch.arange(n_w * stride, device=x.device).reshape(
            1, n_w, stride)
        m = (pos < seq_lens[:, None, None]).to(x.dtype)
        m = m.reshape((b, n_w, stride) + (1,) * len(trail))
        if kind in ("sum", "average", "avg", "sqrt_average"):
            y = torch.sum(xw * m, dim=2)
            if kind in ("average", "avg"):
                y = y / torch.clamp_min(m.sum(dim=2), 1.0)
            elif kind == "sqrt_average":
                y = y / torch.sqrt(torch.clamp_min(m.sum(dim=2), 1.0))
        else:  # max
            y = torch.amax(torch.where(m > 0, xw, -torch.inf), dim=2)
            y = torch.where(torch.isfinite(y), y, 0.0)
        out_lens = torch.div(seq_lens + (stride - 1), stride,
                             rounding_mode="floor")
        return Arg(value=y, seq_lens=out_lens.to(torch.int32))


@LAYERS.register("seqlastins", "last_seq")
class SequenceLastInstanceLayer(Layer):
    """Last (or first) real timestep (SequenceLastInstanceLayer.cpp).
    attrs: select_first; stride (> 0: one frame per stride-window, the
    output stays a sequence); level ("subseq": one frame per
    sub-sequence of a nested input, a plain sequence over them)."""

    def build(self, in_specs):
        (s,) = in_specs
        stride = self.conf.attrs.get("stride", 0) or 0
        level = self.conf.attrs.get("level", "seq")
        is_seq = stride > 0 or (level == "subseq" and s.has_subseq)
        return Spec(dim=s.dim, is_seq=is_seq), {}

    def forward(self, params, inputs, ctx):
        (arg,) = inputs
        first = self.conf.attrs.get("select_first", False)
        stride = self.conf.attrs.get("stride", 0) or 0
        level = self.conf.attrs.get("level", "seq")
        if level == "subseq" and arg.subseq_lens is not None:
            sub = arg.subseq_lens
            csum = torch.cumsum(sub, dim=1)
            idx = torch.where(sub > 0, csum - sub if first else csum - 1, 0)
            n_sub = torch.sum(sub > 0, dim=1, dtype=torch.int32)
            return Arg(value=sops._gather_time(arg.value, idx), seq_lens=n_sub)
        if stride > 0:
            # window w is valid when w*stride < len; its frame is the last
            # (first) valid timestep inside [w*stride, min(len, (w+1)*stride))
            t = arg.value.shape[1]
            lens = arg.seq_lens
            start = (torch.arange(-(-t // stride), device=lens.device)
                     * stride).expand(lens.shape[0], -1)
            end = torch.minimum(start + stride, lens[:, None])
            idx = torch.clamp(start if first else end - 1, 0, t - 1)
            out_lens = torch.div(lens + (stride - 1), stride,
                                 rounding_mode="floor")
            return Arg(value=sops._gather_time(arg.value, idx),
                       seq_lens=out_lens.to(torch.int32))
        pick = sops.seq_first if first else sops.seq_last
        return Arg(value=pick(arg.value, arg.seq_lens))


@LAYERS.register("expand")
class ExpandLayer(Layer):
    """Broadcast along the time axis of a reference sequence
    (ExpandLayer.cpp). inputs: [x, seq_ref]. Default (FROM_NO_SEQUENCE)
    x is [B,D] repeated per timestep; expand_level="seq" (FROM_SEQUENCE)
    over a NESTED ref: x has one frame per sub-sequence of the ref, each
    repeated over its sub-sequence (over a plain ref it coincides with
    the default)."""

    def build(self, in_specs):
        x, ref = in_specs
        if self.conf.attrs.get("expand_level") == "seq" and ref.has_subseq:
            return Spec(dim=x.dim, is_seq=True, has_subseq=True), {}
        return Spec(dim=x.dim, is_seq=True), {}

    def forward(self, params, inputs, ctx):
        x, ref = inputs
        t = ref.max_len
        if (self.conf.attrs.get("expand_level") == "seq"
                and ref.subseq_lens is not None):
            # timestep t belongs to sub-sequence j(t) = #(ends <= t)
            csum = torch.cumsum(ref.subseq_lens, dim=1)
            pos = torch.arange(t, device=csum.device)[None, :, None]
            j = torch.sum(pos >= csum[:, None, :], dim=-1)
            j = torch.clamp(j, 0, x.value.shape[1] - 1)
            return Arg(value=sops._gather_time(x.value, j), seq_lens=ref.seq_lens,
                       subseq_lens=ref.subseq_lens)
        y = sops.expand_to_seq(x.value, ref.seq_lens, t)
        return Arg(value=y, seq_lens=ref.seq_lens)


@LAYERS.register("seqconcat")
class SequenceConcatLayer(Layer):
    """Concat two sequences along time, per example
    (SequenceConcatLayer.cpp)."""

    def build(self, in_specs):
        a, _b = in_specs
        return Spec(dim=a.dim, is_seq=True), {}

    def forward(self, params, inputs, ctx):
        a, b = inputs
        y, lens = sops.seq_concat(a.value, a.seq_lens, b.value, b.seq_lens)
        return Arg(value=y, seq_lens=lens)


@LAYERS.register("seqreshape")
class SequenceReshapeLayer(Layer):
    """[B,T,D] -> [B,T*D/newD,newD] keeping the token count
    (SequenceReshapeLayer.cpp); padding stays padding."""

    def build(self, in_specs):
        return Spec(dim=(self.conf.size,), is_seq=True), {}

    def forward(self, params, inputs, ctx):
        (arg,) = inputs
        b, t, d = arg.value.shape
        nd = self.conf.size
        y = arg.value.reshape(b, t * d // nd, nd)
        return Arg(value=y, seq_lens=arg.seq_lens * d // nd)


@LAYERS.register("seqreverse", "sequence_reverse")
class SequenceReverseLayer(Layer):
    def build(self, in_specs):
        return in_specs[0], {}

    def forward(self, params, inputs, ctx):
        (arg,) = inputs
        return arg.with_value(sops.reverse_seq(arg.value, arg.seq_lens))


@LAYERS.register("slice", "seq_slice")
class SeqSliceLayer(Layer):
    """Static time-window slice (SeqSliceLayer.cpp static case).
    attrs: begin, size."""

    def build(self, in_specs):
        (s,) = in_specs
        return Spec(dim=s.dim, is_seq=True), {}

    def forward(self, params, inputs, ctx):
        (arg,) = inputs
        a = self.conf.attrs
        y, lens = sops.seq_slice_window(arg.value, arg.seq_lens, a["begin"],
                                        a["size"])
        return Arg(value=y, seq_lens=lens)


@LAYERS.register("padding", "pad")
class PadLayer(Layer):
    """Zero-pad the spatial dims of an NHWC image (PadLayer.cpp).
    attrs: pad_c/pad_h/pad_w as (before, after)."""

    def build(self, in_specs):
        (s,) = in_specs
        h, w, c = s.dim
        a = self.conf.attrs
        pc = tuple(a.get("pad_c", (0, 0)))
        ph = tuple(a.get("pad_h", (0, 0)))
        pw = tuple(a.get("pad_w", (0, 0)))
        self._shape = (h, w, c)
        # F.pad lists the last axis first: C, then W, then H
        self._pads = pc + pw + ph
        return Spec(dim=(h + sum(ph), w + sum(pw), c + sum(pc)),
                    is_seq=s.is_seq), {}

    def forward(self, params, inputs, ctx):
        (arg,) = inputs
        x = arg.value.reshape((arg.value.shape[0],) + self._shape)
        return arg.with_value(F.pad(x, self._pads))


@LAYERS.register("crop")
class CropLayer(Layer):
    """Crop the spatial dims of an NHWC image (CropLayer.cpp). attrs:
    crop_h/crop_w as (begin, size), or the target shape from a second
    input (offset_h/offset_w, default centred)."""

    def build(self, in_specs):
        s = in_specs[0]
        h, w, c = s.dim
        a = self.conf.attrs
        if len(in_specs) > 1:
            th, tw, _ = in_specs[1].dim
            bh = a.get("offset_h", (h - th) // 2)
            bw = a.get("offset_w", (w - tw) // 2)
        else:
            bh, th = a["crop_h"]
            bw, tw = a["crop_w"]
        self._crop = (bh, th, bw, tw)
        self._shape = (h, w, c)
        return Spec(dim=(th, tw, c), is_seq=s.is_seq), {}

    def forward(self, params, inputs, ctx):
        arg = inputs[0]
        bh, th, bw, tw = self._crop
        x = arg.value.reshape((arg.value.shape[0],) + self._shape)
        return arg.with_value(x[:, bh:bh + th, bw:bw + tw, :])


@LAYERS.register("rotate")
class RotateLayer(Layer):
    """Rotate each [H,W] channel plane 90 degrees clockwise
    (RotateLayer.cpp: y(j,i,:) = x(M-i-1,j,:)). attrs: height, width."""

    def build(self, in_specs):
        s = in_specs[0]
        h, w = self.conf.attrs["height"], self.conf.attrs["width"]
        if s.size % (h * w):
            raise ValueError(f"rotate: input size {s.size} not divisible "
                             f"by height*width {h}x{w}")
        return s, {}

    def forward(self, params, inputs, ctx):
        (arg,) = inputs
        h, w = self.conf.attrs["height"], self.conf.attrs["width"]
        x = arg.value
        lead, size = x.shape[:-1], x.shape[-1]
        y = x.reshape(lead + (size // (h * w), h, w))
        # clockwise: y[a, b] = x[h-1-b, a] (flip the rows, then transpose)
        y = torch.flip(y, dims=(-2,)).transpose(-1, -2)
        return arg.with_value(y.reshape(lead + (size,)))


@LAYERS.register("gen_output")
class GenOutputLayer(Layer):
    """Placeholder for the id sequences a generating beam-search group
    emits (the v1 '__beam_search_predict__' layer): generation runs
    through `beam_search.BeamSearchDecoder`; this layer only anchors the
    graph."""

    def build(self, in_specs):
        return Spec(dim=(1,), is_seq=True, is_ids=True), {}

    def forward(self, params, inputs, ctx):
        raise RuntimeError(
            f"{self.name}: generated sequences come from the beam-search "
            "decoder (beam_search.BeamSearchDecoder), not Network.forward")


@LAYERS.register("subseq", "sub_seq")
class SubSequenceLayer(Layer):
    """A per-example span of each sequence from dynamic offset and size
    inputs (SubSequenceLayer.cpp; inputs [seq, offset, size], [B] id
    args). The span is clamped inside the real sequence, an offset at or
    past the end gives an EMPTY sequence; the output keeps the input's
    time axis, zero past each new length."""

    def build(self, in_specs):
        s = in_specs[0]
        assert s.is_seq, "subseq needs a sequence input"
        return Spec(dim=s.dim, is_seq=True, dtype=s.dtype), {}

    def forward(self, params, inputs, ctx):
        x, off, size = inputs
        v = x.value
        t = v.shape[1]
        lens = x.seq_lens.long()
        o = off.ids.reshape(-1).long()
        n = size.ids.reshape(-1).long()
        in_range = o < lens
        o = torch.minimum(torch.clamp_min(o, 0), torch.clamp_min(lens - 1, 0))
        n = torch.where(in_range,
                        torch.minimum(torch.clamp_min(n, 0), lens - o), 0)
        pos = torch.arange(t, device=v.device)[None, :]
        y = sops._gather_time(v, torch.clamp(o[:, None] + pos, 0, t - 1))
        mask = (pos < n[:, None]).to(v.dtype)
        y = y * mask.reshape(mask.shape + (1,) * (v.ndim - 2))
        return Arg(value=y, seq_lens=n.to(torch.int32))


@LAYERS.register("sub_nested_seq")
class SubNestedSequenceLayer(Layer):
    """Select sub-sequences of a nested sequence by per-example indices
    (SubNestedSequenceLayer.cpp). inputs: [nested, selected (ids
    [B,K])]. Output: the nested sequence of the K selected
    sub-sequences, in selection order, compacted to the front; -1
    sentinels and slots past the selection's own length select
    nothing."""

    def build(self, in_specs):
        s, _sel = in_specs
        assert s.has_subseq, "sub_nested_seq needs a nested input"
        return Spec(dim=s.dim, is_seq=True, has_subseq=True), {}

    def forward(self, params, inputs, ctx):
        x, sel = inputs
        v = x.value
        t = v.shape[1]
        sl = x.subseq_lens.long()
        ends = torch.cumsum(sl, dim=1)
        starts = ends - sl
        k_idx = sel.ids.long()
        k = k_idx.shape[1]
        valid_sel = k_idx >= 0
        if sel.seq_lens is not None:
            valid_sel = valid_sel & (
                torch.arange(k, device=v.device)[None, :]
                < sel.seq_lens[:, None])
        safe_idx = torch.clamp(k_idx, 0, sl.shape[1] - 1)
        sel_lens = torch.gather(sl, 1, safe_idx) * valid_sel
        in_starts = torch.gather(starts, 1, safe_idx)
        out_ends = torch.cumsum(sel_lens, dim=1)
        out_starts = out_ends - sel_lens
        pos = torch.arange(t, device=v.device)[None, :]
        # the selected segment output position p falls into
        seg = torch.sum(pos[:, :, None] >= out_ends[:, None, :], dim=-1)
        seg = torch.clamp_max(seg, k - 1)
        src = (torch.gather(in_starts, 1, seg) + pos
               - torch.gather(out_starts, 1, seg))
        valid = pos < out_ends[:, -1:]
        y = sops._gather_time(v, torch.clamp(src, 0, t - 1))
        y = y * valid.reshape(valid.shape + (1,) * (v.ndim - 2)).to(y.dtype)
        return Arg(value=y,
                   seq_lens=torch.sum(sel_lens, dim=1).to(torch.int32),
                   subseq_lens=sel_lens.to(torch.int32))
