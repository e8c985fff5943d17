"""Cost (loss) layers of `paddle_tpu/layers/cost.py`, every type of
it: the base (masked per-token reduction, label alignment, per-example
weight), classification_cost (fused softmax + cross entropy on
logits), cross_entropy on probabilities, square_error, smooth_l1,
sum_cost, the soft and multi-label binary cross entropies, rank-cost,
the two-class huber, lambda_cost, the standalone softmax and the
self-normalized cross entropy; the CRF and CTC costs are
`layers/structured.py`'s.

Each outputs a per-example cost [B]; for sequence inputs padding
tokens contribute exactly zero and the per-example cost is the sum
over real timesteps. Label ids are int64, the index type of
`torch.gather`.
"""

from __future__ import annotations

import math

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


@LAYERS.register("smooth_l1")
class SmoothL1Cost(CostLayerBase):
    """Smooth-L1 (CostLayer.cpp SmoothL1CostLayer)."""

    def forward(self, params, inputs, ctx):
        x, y = inputs
        d = torch.abs(x.value - y.value)
        per = torch.where(d < 1.0, 0.5 * d * d, d - 0.5)
        return self._reduce(torch.sum(per, dim=-1), x)


@LAYERS.register("sum_cost")
class SumCost(CostLayerBase):
    """cost = sum over the input vector (SumCostLayer; the VAE's KL
    term)."""

    def forward(self, params, inputs, ctx):
        (x,) = inputs
        return self._reduce(torch.sum(x.value, dim=-1), x)


@LAYERS.register("soft_binary_class_cross_entropy")
class SoftBinaryCE(CostLayerBase):
    """Elementwise binary cross entropy with soft labels."""

    def forward(self, params, inputs, ctx):
        x, y = inputs
        p = torch.clamp(x.value, _EPS, 1.0 - _EPS)
        per = -(y.value * torch.log(p) + (1 - y.value) * torch.log(1 - p))
        return self._reduce(torch.sum(per, dim=-1), x)


@LAYERS.register("multi_binary_label_cross_entropy")
class MultiBinaryLabelCE(CostLayerBase):
    """Multi-label binary cross entropy; the label is a dense 0/1
    matrix (the feeder densifies sparse binary labels)."""

    forward = SoftBinaryCE.forward


@LAYERS.register("rank-cost")
class RankingCost(CostLayerBase):
    """Pairwise rank cost (CostLayer.cpp RankingCost): inputs [score_a,
    score_b, label] with label in [0, 1]; cost = log(1 + exp(o)) - t*o,
    o = a - b."""

    def forward(self, params, inputs, ctx):
        a, b, t = inputs
        o = (a.value - b.value)[..., 0]
        label = t.value[..., 0] if t.value is not None else t.ids.to(o.dtype)
        per = torch.logaddexp(torch.zeros_like(o), o) - label * o
        return self._reduce(per, a)


@LAYERS.register("huber_classification", "huber-two-class", "huber")
class HuberTwoClassCost(CostLayerBase):
    """Huber loss for two-class classification with a {-1, 1} margin
    (CostLayer.cpp HuberTwoClassification): a 1-wide score, label
    0/1."""

    def forward(self, params, inputs, ctx):
        x, t = inputs
        y = 2.0 * t.ids.to(x.value.dtype) - 1.0
        a = y * x.value[..., 0]
        per = torch.where(a < -1.0, -4.0 * a,
                          torch.where(a < 1.0, torch.square(1.0 - a), 0.0))
        return self._reduce(per, x)


@LAYERS.register("lambda_cost")
class LambdaCost(CostLayerBase):
    """LambdaRank NDCG cost over a sequence of (score, relevance)
    (CostLayer.cpp LambdaCost). inputs: [score (seq [B, T, 1]), rel
    (seq)]. attrs: NDCG_num (default 5). The ideal DCG sorts the
    relevances: ties do not change the sorted values, but they decide
    which position the gradient reaches, so the sort is stable, as
    `jnp.sort` is (CUDA's unstable sort sent it elsewhere)."""

    def forward(self, params, inputs, ctx):
        score, rel = inputs
        s = score.value[..., 0]
        r = rel.value[..., 0]
        mask = score.mask(s.dtype)
        k = self.conf.attrs.get("NDCG_num", 5)
        r_masked = torch.where(mask > 0, r, torch.full_like(r, -1e30))
        r_sorted = torch.sort(r_masked, dim=1, descending=True,
                              stable=True).values[:, :k]
        disc = 1.0 / torch.log2(torch.arange(2, k + 2, dtype=s.dtype,
                                             device=s.device))
        idcg = torch.sum((torch.exp2(torch.clamp(r_sorted, min=0)) - 1)
                         * disc[:r_sorted.shape[1]], dim=1)
        idcg = torch.clamp(idcg, min=_EPS)
        si, sj = s[:, :, None], s[:, None, :]
        mij = mask[:, :, None] * mask[:, None, :]
        hi = (r[:, :, None] > r[:, None, :]).to(s.dtype)
        o = si - sj
        pair = torch.logaddexp(torch.zeros_like(o), -o) / math.log(2.0)
        per = torch.sum(hi * pair * mij, dim=(1, 2)) / idcg
        return Arg(value=self.conf.attrs.get("coeff", 1.0) * per)


@LAYERS.register("softmax")
class SoftmaxLayer(Layer):
    """Standalone softmax output layer."""

    def build(self, in_specs):
        return in_specs[0], {}

    def forward(self, params, inputs, ctx):
        (arg,) = inputs
        return arg.with_value(torch.softmax(arg.value, dim=-1))


@LAYERS.register("multi_class_cross_entropy_with_selfnorm")
class MultiClassCrossEntropyWithSelfNorm(CostLayerBase):
    """Cross entropy over probabilities plus softmax_selfnorm_alpha *
    log(Z)^2 (CostLayer.cpp MultiClassCrossEntropyWithSelfNorm)."""

    def forward(self, params, inputs, ctx):
        prob, label = inputs
        ids, lmask = self._aligned_ids(prob, label)
        z = torch.sum(prob.value, dim=-1)
        p = _pick(prob.value / torch.clamp(z, min=_EPS)[..., None], ids)
        alpha = self.conf.attrs.get("softmax_selfnorm_alpha", 0.1)
        per = (-torch.log(torch.clamp(p, min=_EPS))
               + alpha * torch.square(torch.log(torch.clamp(z, min=_EPS))))
        if lmask is not None:
            per = per * lmask
        return self._reduce(per, prob)
