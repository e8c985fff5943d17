"""Sequence-structure layers of `paddle_tpu/layers/sequence.py` the
sequence slice runs: seqpool, seqlastins and expand, at the whole-
sequence level. Mask semantics over dense [B,T,...] (see
ops/sequence_ops.py).

Left out, still to port (ROADMAP A3): the strided and sub-sequence
levels and `output_max_index` of these three, and the module's ten
other types.
"""

from __future__ import annotations

from paddle_tpu_torch.core.arg import Arg
from paddle_tpu_torch.core.registry import LAYERS
from paddle_tpu_torch.layers.base import Layer, Spec
from paddle_tpu_torch.ops import sequence_ops as sops


def _not_ported(layer, what):
    raise NotImplementedError(
        f"{layer.conf.type} {layer.name}: {what} is not ported yet "
        f"(ROADMAP A3)")


@LAYERS.register("seqpool", "sequence_pool", "average", "max")
class SequencePoolLayer(Layer):
    """Pool a sequence to one vector per example. attrs: pool_type in
    {sum, average, max, sqrt_average}."""

    _OPS = {
        "sum": sops.seq_sum,
        "average": sops.seq_avg,
        "avg": sops.seq_avg,
        "sqrt_average": sops.seq_sqrt_avg,
        "max": sops.seq_max,
    }

    def build(self, in_specs):
        (s,) = in_specs
        a = self.conf.attrs
        if a.get("stride", 0):
            _not_ported(self, "strided pooling")
        if a.get("level", "seq") == "subseq":
            _not_ported(self, "sub-sequence pooling")
        if a.get("output_max_index"):
            _not_ported(self, "output_max_index")
        return Spec(dim=s.dim), {}

    def forward(self, params, inputs, ctx):
        (arg,) = inputs
        # the reference's AverageLayer/MaxLayer are separate types with
        # the pool kind baked into the type name
        default = (self.conf.type if self.conf.type in ("average", "max")
                   else "sum")
        kind = self.conf.attrs.get("pool_type", default)
        return Arg(value=self._OPS[kind](arg.value, arg.seq_lens))


@LAYERS.register("seqlastins", "last_seq")
class SequenceLastInstanceLayer(Layer):
    """Last (or first) real timestep (SequenceLastInstanceLayer.cpp).
    attrs: select_first."""

    def build(self, in_specs):
        (s,) = in_specs
        if self.conf.attrs.get("stride", 0):
            _not_ported(self, "strided selection")
        if self.conf.attrs.get("level", "seq") == "subseq" and s.has_subseq:
            _not_ported(self, "sub-sequence selection")
        return Spec(dim=s.dim), {}

    def forward(self, params, inputs, ctx):
        (arg,) = inputs
        first = self.conf.attrs.get("select_first", False)
        pick = sops.seq_first if first else sops.seq_last
        return Arg(value=pick(arg.value, arg.seq_lens))


@LAYERS.register("expand")
class ExpandLayer(Layer):
    """Broadcast along the time axis of a reference sequence
    (ExpandLayer.cpp). inputs: [x, seq_ref]; x is [B,D] repeated per
    timestep (FROM_NO_SEQUENCE, and FROM_SEQUENCE over a plain ref,
    which coincides with it)."""

    def build(self, in_specs):
        x, ref = in_specs
        if self.conf.attrs.get("expand_level") == "seq" and ref.has_subseq:
            _not_ported(self, "expansion over a nested reference")
        return Spec(dim=x.dim, is_seq=True), {}

    def forward(self, params, inputs, ctx):
        x, ref = inputs
        y = sops.expand_to_seq(x.value, ref.seq_lens, ref.max_len)
        return Arg(value=y, seq_lens=ref.seq_lens)
