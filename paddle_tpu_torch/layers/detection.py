"""SSD detection layers of `paddle_tpu/layers/detection.py`: priorbox,
multibox_loss and detection_output, on `ops/detection.py`.

Ground truth arrives as fixed-shape Args, as in the JAX package: boxes
[B, G, 4] with seq_lens giving each image's ground-truth count, labels
[B, G] ids (or the v1 packed record, `packed_label`). The prior boxes
are numpy at build time; each layer keeps its device copy after the
first forward, so a CUDA-graph capture copies nothing from the host.
"""

from __future__ import annotations

import torch

from paddle_tpu_torch.core.arg import Arg
from paddle_tpu_torch.core.registry import LAYERS
from paddle_tpu_torch.layers.base import Layer, Spec
from paddle_tpu_torch.layers.cost import CostLayerBase
from paddle_tpu_torch.ops import detection as D


@LAYERS.register("priorbox")
class PriorBoxLayer(Layer):
    """inputs: [feature map (H, W, C), image (H, W, C)]; attrs: min_size,
    max_size, aspect_ratio, variance, flip, clip. Output [B, P*8] prior
    (box4, var4) rows, the same for every example."""

    def build(self, in_specs):
        feat, img = in_specs
        assert len(feat.dim) == 3, "priorbox needs an (H,W,C) feature map"
        assert len(img.dim) == 3, "priorbox needs an (H,W,C) image input"
        a = self.conf.attrs
        self._priors = D.prior_boxes(
            layer_hw=feat.dim[:2], image_hw=img.dim[:2],
            min_sizes=list(a.get("min_size", [])),
            max_sizes=list(a.get("max_size", [])),
            aspect_ratios=list(a.get("aspect_ratio", [])),
            variances=list(a.get("variance", (0.1, 0.1, 0.2, 0.2))),
            flip=a.get("flip", True), clip=a.get("clip", True))
        self.num_priors = self._priors.shape[0]
        self._on = {}
        return Spec(dim=(self.num_priors * 8,)), {}

    def forward(self, params, inputs, ctx):
        x = inputs[0].value
        dev = x.device
        if dev not in self._on:
            self._on[dev] = torch.from_numpy(self._priors.reshape(-1)).to(dev)
        flat = self._on[dev]
        return Arg(value=flat.to(x.dtype).expand(inputs[0].batch,
                                                 flat.shape[0]))


def _split_priors(prior_arg: Arg):
    pr = prior_arg.value[0].reshape(-1, 8)
    return pr[:, :4], pr[:, 4:]


@LAYERS.register("multibox_loss")
class MultiBoxLossLayer(CostLayerBase):
    """inputs: [priorbox, label boxes ([B, G, 4] seq), label ids ([B, G]
    ids seq), loc_pred [B, P*4], conf_pred [B, P*C]]; attrs:
    num_classes, overlap_threshold, neg_pos_ratio, neg_overlap,
    background_id, packed_label. The batch's cost is (smooth-L1 sum +
    confidence sum) / num_matches (MultiBoxLossLayer.cpp); each
    example's value is scaled so that their mean is that."""

    def forward(self, params, inputs, ctx):
        prior, gt_box, gt_label, loc, conf = inputs
        a = self.conf.attrs
        if a.get("packed_label"):
            # per box [label, x1, y1, x2, y2, difficult]
            packed = gt_box.value.reshape(gt_box.value.shape[0], -1, 6)
            gt_label = Arg(ids=packed[..., 0].long(),
                           seq_lens=gt_box.seq_lens)
            gt_box = Arg(value=packed[..., 1:5], seq_lens=gt_box.seq_lens)
        c = a["num_classes"]
        priors, variances = _split_priors(prior)
        p = priors.shape[0]
        boxes = gt_box.value
        mask = gt_box.bool_mask().to(boxes.dtype)
        loc_l, conf_l, n_pos = D.multibox_loss(
            loc.value.reshape(-1, p, 4), conf.value.reshape(-1, p, c),
            priors, variances, boxes, gt_label.ids, mask,
            overlap_threshold=a.get("overlap_threshold", 0.5),
            neg_pos_ratio=a.get("neg_pos_ratio", 3.0),
            neg_overlap=a.get("neg_overlap", 0.5),
            background_id=a.get("background_id", 0))
        denom = torch.clamp(torch.sum(n_pos).to(loc_l.dtype), min=1.0)
        per_img = (loc_l + conf_l) * (loc_l.shape[0] / denom)
        return Arg(value=a.get("coeff", 1.0) * per_img)


@LAYERS.register("detection_output")
class DetectionOutputLayer(Layer):
    """inputs: [priorbox, loc_pred, conf_pred]; attrs: num_classes,
    nms_threshold, nms_top_k, keep_top_k, confidence_threshold,
    background_id. Output [B, keep_top_k*6]: rows (label, score, box4),
    score 0 marks padding."""

    def build(self, in_specs):
        self._keep = self.conf.attrs.get("keep_top_k", 200)
        return Spec(dim=(self._keep * 6,)), {}

    def forward(self, params, inputs, ctx):
        prior, loc, conf = inputs
        a = self.conf.attrs
        c = a["num_classes"]
        priors, variances = _split_priors(prior)
        p = priors.shape[0]
        dets = D.detection_output(
            loc.value.reshape(-1, p, 4), conf.value.reshape(-1, p, c),
            priors, variances, num_classes=c,
            background_id=a.get("background_id", 0),
            nms_threshold=a.get("nms_threshold", 0.45),
            nms_top_k=a.get("nms_top_k", 400), keep_top_k=self._keep,
            confidence_threshold=a.get("confidence_threshold", 0.01))
        return Arg(value=dets.reshape(dets.shape[0], -1))
