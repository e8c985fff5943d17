"""Structured-prediction layers: `paddle_tpu/layers/structured.py` on
torch — crf, crf_decoding, and ctc/warp_ctc.

The CRF weight is a trainable [num_tags+2, num_tags] parameter
(ops/crf.py's layout); a crf cost and a crf_decoding layer share it by
name (the taggers' "crfw"). CTC has no parameters. The math is
ops/crf.py and ops/ctc.py: plain tensor ops, no kernel.
"""

from __future__ import annotations

import torch

from paddle_tpu_torch.core.arg import Arg
from paddle_tpu_torch.core.registry import LAYERS
from paddle_tpu_torch.layers.base import Layer, Spec
from paddle_tpu_torch.layers.cost import CostLayerBase
from paddle_tpu_torch.ops import crf as crf_ops
from paddle_tpu_torch.ops import ctc as ctc_ops


def _crf_weight(layer, in_specs):
    n = layer.conf.size or in_specs[0].size
    return {"w0": layer.weight_conf(0, (n + 2, n))}


@LAYERS.register("crf")
class CRFLayer(CostLayerBase):
    """Linear-chain CRF negative log-likelihood (CRFLayer.cpp). inputs:
    [emission (seq [B,T,N]), label (seq ids)]. size = num_tags; attrs:
    coeff."""

    def build(self, in_specs):
        return Spec(dim=(1,), is_seq=False), _crf_weight(self, in_specs)

    def forward(self, params, inputs, ctx):
        emit, label = inputs
        ll = crf_ops.crf_log_likelihood(emit.value, label.ids, emit.seq_lens,
                                        params["w0"])
        return Arg(value=self.conf.attrs.get("coeff", 1.0) * (-ll))


@LAYERS.register("crf_decoding")
class CRFDecodingLayer(Layer):
    """Viterbi decode (CRFDecodingLayer.cpp). inputs: [emission] and an
    optional label, with which it emits a 0/1 error per token instead of
    the ids."""

    def build(self, in_specs):
        return (Spec(dim=(1,), is_seq=True, is_ids=True),
                _crf_weight(self, in_specs))

    def forward(self, params, inputs, ctx):
        emit = inputs[0]
        paths, _ = crf_ops.crf_decode(emit.value, emit.seq_lens,
                                      params["w0"])
        if len(inputs) > 1:
            err = (paths != inputs[1].ids).to(torch.float32)[..., None]
            return Arg(value=err, seq_lens=emit.seq_lens)
        return Arg(ids=paths, seq_lens=emit.seq_lens)


@LAYERS.register("ctc", "warp_ctc")
class CTCLayer(CostLayerBase):
    """CTC loss (CTCLayer.cpp / WarpCTCLayer.cpp). inputs: [logits or
    probabilities (seq [B,T,C]), label (seq ids)]. attrs: blank (0),
    norm_by_times (divide by the input length), apply_softmax (True: the
    input is pre-softmax logits, as warp-ctc takes), coeff."""

    def build(self, in_specs):
        return Spec(dim=(1,), is_seq=False), {}

    def forward(self, params, inputs, ctx):
        logits, label = inputs
        a = self.conf.attrs
        x = logits.value
        lp = (torch.log_softmax(x, dim=-1) if a.get("apply_softmax", True)
              else torch.log(torch.clamp_min(x, 1e-20)))
        nll = ctc_ops.ctc_loss(lp, logits.seq_lens, label.ids,
                               label.seq_lens, blank=a.get("blank", 0))
        if a.get("norm_by_times", False):
            nll = nll / torch.clamp_min(logits.seq_lens, 1).to(nll.dtype)
        return Arg(value=a.get("coeff", 1.0) * nll)
