"""Cost (loss) layers of `paddle_tpu/layers/cost.py` the port runs:
the base (masked per-token reduction, label alignment, per-example
weight), classification_cost (fused softmax + cross entropy on
logits), cross_entropy on probabilities, and square_error. The other
nine types are still to port, each with the slice whose path runs it
(ROADMAP A2-A4, A9).

Each outputs a per-example cost [B]; for sequence inputs padding
tokens contribute exactly zero and the per-example cost is the sum
over real timesteps. Label ids are int64, the index type of
`torch.gather`.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from paddle_tpu_torch.core.arg import Arg
from paddle_tpu_torch.core.registry import LAYERS
from paddle_tpu_torch.layers.base import Layer, Spec

_EPS = 1e-10


class CostLayerBase(Layer):
    is_cost = True

    def build(self, in_specs):
        self._in_specs = in_specs
        return Spec(dim=(1,), is_seq=False), {}

    def _reduce(self, per_token, arg: Arg):
        """per_token: [B] (non-seq) or [B,T] (seq) -> per-example [B]."""
        w = self.conf.attrs.get("coeff", 1.0)
        if arg.is_seq and per_token.ndim == 2:
            per_token = per_token * arg.mask(per_token.dtype)
            per_token = torch.sum(per_token, dim=1)
        return Arg(value=w * per_token)

    def _weighted(self, cost_arg: Arg, rest) -> Arg:
        """Optional per-example weight input: multiplies each example's
        cost."""
        if not rest:
            return cost_arg
        w = rest[0].value.reshape(cost_arg.value.shape[0])
        return Arg(value=cost_arg.value * w)

    @staticmethod
    def _aligned_ids(pred: Arg, label: Arg):
        """(ids, label_mask): label ids padded/trimmed to the
        prediction's time axis, plus the LABEL's own validity mask on
        that axis (None when no reconciliation applies), so positions
        with no real label contribute zero cost."""
        ids = label.ids
        lmask = None
        if pred.seq_lens is not None and ids is not None and ids.ndim == 2:
            tp = pred.value.shape[1]
            tl = ids.shape[1]
            if tl > tp:
                ids = ids[:, :tp]
            elif tl < tp:
                ids = F.pad(ids, (0, tp - tl))
            if label.seq_lens is not None:
                pos = torch.arange(tp, device=ids.device)
                lmask = (pos[None, :] < label.seq_lens[:, None]).to(
                    pred.value.dtype)
        return ids, lmask


def _pick(x, ids):
    """x[..., ids] along the last axis (take_along_axis)."""
    return torch.gather(x, -1, ids.long()[..., None])[..., 0]


@LAYERS.register("multi-class-cross-entropy", "cross_entropy")
class MultiClassCrossEntropy(CostLayerBase):
    """-log p[label]; input is a probability distribution.
    inputs: [prob, label(ids)]."""

    def forward(self, params, inputs, ctx):
        prob, label, *rest = inputs
        ids, lmask = self._aligned_ids(prob, label)
        per = -torch.log(torch.clamp(_pick(prob.value, ids), min=_EPS))
        if lmask is not None:
            per = per * lmask
        return self._weighted(self._reduce(per, prob), rest)


@LAYERS.register("classification_cost", "softmax_with_cross_entropy")
class SoftmaxCrossEntropy(CostLayerBase):
    """Fused softmax + cross entropy on logits: one logsumexp, no
    materialized probabilities."""

    def forward(self, params, inputs, ctx):
        logits, label, *rest = inputs
        ids, lmask = self._aligned_ids(logits, label)
        per = torch.logsumexp(logits.value, dim=-1) - _pick(logits.value, ids)
        if lmask is not None:
            per = per * lmask
        return self._weighted(self._reduce(per, logits), rest)


@LAYERS.register("square_error", "sum_of_squares", "mse")
class SumOfSquaresCost(CostLayerBase):
    """0.5*||x - y||^2 per example."""

    def forward(self, params, inputs, ctx):
        x, y, *rest = inputs
        d = x.value - y.value
        return self._weighted(
            self._reduce(0.5 * torch.sum(torch.square(d), dim=-1), x), rest
        )
