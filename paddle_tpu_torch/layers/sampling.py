"""Sampling-based output layers of `paddle_tpu/layers/sampling.py`, every
type of it: NCE, hierarchical sigmoid, sampling_id, max_id and
multiplex.

Draws: the JAX layers draw with `jax.random.categorical`, NCE from
`ctx.split(name)` in training and from `jax.random.key(0)` otherwise.
The port's draws cannot equal those (`core/rng.py`): they come from the
port's own counter-based keys (`StepKey.uniform`) by the inverse CDF,
on the device, so a step replayed in a CUDA graph draws what the eager
step draws. The NCE objective is therefore split in two: `nce_sample`
draws the negatives, and `nce_cost` is a function of explicit
negatives, the part held against the JAX layer (on negatives the JAX
package drew). `max_id` takes the first maximum, as `jnp.argmax`
does.
"""

from __future__ import annotations

import math

import numpy as np
import torch
import torch.nn.functional as F

from paddle_tpu_torch.core import rng as _rng
from paddle_tpu_torch.core.arg import Arg
from paddle_tpu_torch.core.registry import LAYERS
from paddle_tpu_torch.layers.base import Layer, Spec
from paddle_tpu_torch.layers.cost import CostLayerBase


def categorical(key: _rng.StepKey, probs: torch.Tensor, shape) -> torch.Tensor:
    """Draws of `shape` + () from the categorical distribution of each
    row of `probs` ([..., N], rows summing to 1; `shape` must equal
    probs' leading shape with any trailing sample axes), by the inverse
    CDF of `key`'s uniforms: index c where cdf[c-1] <= u < cdf[c]."""
    u = key.uniform(shape, dtype=probs.dtype).to(probs.device)
    cdf = torch.cumsum(probs, dim=-1)
    lead = cdf.shape[:-1]
    extra = len(shape) - len(lead)
    cdf = cdf.reshape(lead + (1,) * extra + cdf.shape[-1:]).expand(
        tuple(shape) + cdf.shape[-1:]).contiguous()
    idx = torch.searchsorted(cdf, u[..., None].contiguous(), right=True)[..., 0]
    return torch.clamp(idx, max=probs.shape[-1] - 1)


def nce_logq(attrs: dict, device=None) -> torch.Tensor:
    """The noise distribution's log-probabilities [num_classes]:
    log(neg_distribution + 1e-20), or uniform."""
    nc = attrs["num_classes"]
    neg_dist = attrs.get("neg_distribution")
    if neg_dist is not None:
        q = torch.as_tensor(np.asarray(neg_dist, np.float32), device=device)
        return torch.log(q + 1e-20)
    return torch.full((nc,), -math.log(nc), dtype=torch.float32,
                      device=device)


def nce_sample(key: _rng.StepKey, logq: torch.Tensor, batch: int,
               k: int) -> torch.Tensor:
    """[batch, k] negative classes drawn from softmax(logq)."""
    return categorical(key, torch.softmax(logq, dim=-1), (batch, k))


def nce_cost(xs, label, ws, b, neg, logq) -> torch.Tensor:
    """Per-example NCE loss [B] on explicit negatives: xs / ws the
    feature inputs [B, d_i] and their weights [num_classes, d_i], b the
    bias [num_classes] or None, label [B] ids, neg [B, k] ids, logq
    [num_classes]. softplus(-(s_pos - log k - logq[pos])) + sum over the
    negatives of softplus(s_neg - log k - logq[neg])."""
    bsz, k = neg.shape

    def score(cls_idx):
        s = 0.0
        for x, w in zip(xs, ws):
            rows = F.embedding(cls_idx, w)               # [B, m, d]
            s = s + torch.sum(x.reshape(bsz, 1, -1) * rows, dim=-1)
        if b is not None:
            s = s + b[cls_idx]
        return s

    label = label.long().reshape(bsz)
    neg = neg.long()
    logk = math.log(float(k))
    logq = logq.to(xs[0].dtype)
    pos_logit = score(label[:, None])[:, 0] - (logk + logq[label])
    neg_logit = score(neg) - (logk + logq[neg])
    return F.softplus(-pos_logit) + torch.sum(F.softplus(neg_logit), dim=1)


@LAYERS.register("nce")
class NCELayer(CostLayerBase):
    """Noise-contrastive estimation (NCELayer.cpp). inputs: [feature(s)...,
    label (ids)]. attrs: num_classes, num_neg_samples (default 10),
    neg_distribution (optional class probabilities). Params per feature
    input w{i} [num_classes, dim_i]; bias [num_classes]. Outside
    training the negatives come from a fixed key (seed 0), so the cost
    is deterministic."""

    def build(self, in_specs):
        nc = self.conf.attrs["num_classes"]
        pcs = {}
        for i, s in enumerate(in_specs[:-1]):
            pcs[f"w{i}"] = self.weight_conf(i, (nc, s.size))
        b = self.bias_conf((nc,))
        if b is not None:
            pcs["b"] = b
        # logq on each device, made at the first forward there (a CUDA
        # graph's capture copies nothing from the host)
        self._logq = {}
        return Spec(dim=(1,), is_seq=False), pcs

    def forward(self, params, inputs, ctx):
        a = self.conf.attrs
        label, feats = inputs[-1], inputs[:-1]
        dev = label.ids.device
        if dev not in self._logq:
            self._logq[dev] = nce_logq(a, dev)
        logq = self._logq[dev]
        key = (ctx.split(self.name) if ctx.train else _rng.StepKey(
            torch.zeros((), dtype=torch.int64, device=dev)))
        neg = nce_sample(key, logq, label.ids.shape[0],
                         a.get("num_neg_samples", 10))
        loss = nce_cost([f.value for f in feats], label.ids,
                        [params[f"w{i}"] for i in range(len(feats))],
                        params.get("b"), neg, logq)
        return self._reduce(loss, feats[0])


@LAYERS.register("hsigmoid")
class HierarchicalSigmoidLayer(CostLayerBase):
    """Hierarchical sigmoid over a complete binary tree
    (HierarchicalSigmoidLayer.cpp): class c's path is the bit pattern
    of c + num_classes; internal node j has weight row j-1. Params per
    feature input w{i} [num_classes-1, dim_i]; bias [num_classes-1]."""

    def build(self, in_specs):
        nc = self.conf.attrs["num_classes"]
        self._depth = int(np.ceil(np.log2(nc))) + 1
        pcs = {}
        for i, s in enumerate(in_specs[:-1]):
            pcs[f"w{i}"] = self.weight_conf(i, (nc - 1, s.size))
        b = self.bias_conf((nc - 1,))
        if b is not None:
            pcs["b"] = b
        return Spec(dim=(1,), is_seq=False), pcs

    def forward(self, params, inputs, ctx):
        nc = self.conf.attrs["num_classes"]
        label, feats = inputs[-1], inputs[:-1]
        bsz = label.ids.shape[0]
        dtype = feats[0].value.dtype
        code = label.ids.long().reshape(bsz) + nc
        loss = torch.zeros(bsz, dtype=dtype, device=code.device)
        for _ in range(self._depth):
            parent = torch.div(code, 2, rounding_mode="floor")
            right = (code % 2) == 1
            node = torch.clamp(parent - 1, 0, nc - 2)
            s = 0.0
            for i, f in enumerate(feats):
                s = s + torch.sum(f.value.reshape(bsz, -1)
                                  * F.embedding(node, params[f"w{i}"]),
                                  dim=-1)
            if "b" in params:
                s = s + params["b"][node]
            step = F.softplus(torch.where(right, -s, s))
            loss = loss + torch.where(parent >= 1, step, 0.0)
            code = parent
        return self._reduce(loss, feats[0])


@LAYERS.register("sampling_id")
class SamplingIdLayer(Layer):
    """Sample an id from each probability row (SamplingIdLayer.cpp)."""

    def build(self, in_specs):
        return Spec(dim=(1,), is_seq=in_specs[0].is_seq, is_ids=True), {}

    def forward(self, params, inputs, ctx):
        (arg,) = inputs
        p = torch.clamp(arg.value, min=1e-20)
        p = p / torch.sum(p, dim=-1, keepdim=True)
        ids = categorical(ctx.split(self.name), p.detach(), p.shape[:-1])
        return Arg(ids=ids, seq_lens=arg.seq_lens)


@LAYERS.register("max_id", "maxid")
class MaxIdLayer(Layer):
    """Argmax id (MaxIdLayer.cpp); the first of equal maxima."""

    def build(self, in_specs):
        return Spec(dim=(1,), is_seq=in_specs[0].is_seq, is_ids=True), {}

    def forward(self, params, inputs, ctx):
        (arg,) = inputs
        return Arg(ids=torch.argmax(arg.value, dim=-1), seq_lens=arg.seq_lens)


@LAYERS.register("multiplex")
class MultiplexLayer(Layer):
    """Row-wise select among N inputs by an index input
    (MultiplexLayer.cpp). inputs: [selector (ids), x1..xN]."""

    def build(self, in_specs):
        return in_specs[1], {}

    def forward(self, params, inputs, ctx):
        sel = inputs[0].ids.long()
        stacked = torch.stack([a.value for a in inputs[1:]], dim=0)
        idx = sel.reshape((1, -1) + (1,) * (stacked.ndim - 2)).expand(
            (1,) + stacked.shape[1:])
        return inputs[1].with_value(torch.gather(stacked, 0, idx)[0])
