"""SSD detection: prior boxes, IoU, encode/decode, matching, NMS —
`paddle_tpu/ops/detection.py` on torch, over the whole batch at once.

Reference: paddle/gserver/layers/DetectionUtil.cpp (jaccardOverlap,
encodeBBoxWithVar, decodeBBoxWithVar, matchBBox, applyNMSFast,
getDetectionIndices) and PriorBox.cpp.

The JAX functions work on one image and are vmapped (over images, and
NMS over classes); here every function takes the batch: ground truth is
[B, G, 4] with a [B, G] mask, heads are [B, P, ...]. The sequential
parts stay sequential, each step a few tensor ops over the whole batch:
the bipartite match is a loop over G, the greedy NMS a loop over its k
candidates on [B, C, k] at once. Ties are taken as the JAX package
takes them: `argmax` the first maximum, the hard-negative rank a stable
argsort, and the NMS candidates and `keep_top_k` through
`ops/topk.py::top_k_stable` (`lax.top_k`'s lower index first). Boxes
are (xmin, ymin, xmax, ymax), normalized to [0, 1].
"""

from __future__ import annotations

import math

import numpy as np
import torch

from paddle_tpu_torch.ops.topk import top_k_stable


def prior_boxes(layer_hw, image_hw, min_sizes, max_sizes, aspect_ratios,
                variances, flip: bool = True, clip: bool = True) -> np.ndarray:
    """[P, 8] rows of (box4, variance4), numpy at build time, in
    PriorBox.cpp's write order: per location, for each min_size the min
    prior and then one sqrt(min*max) prior per max_size; after that
    loop, the aspect-ratio priors once, sized by the last min_size.
    Every prior the loop emits is returned (the reference's declared
    count undercounts multi-size configs)."""
    lh, lw = layer_hw
    ih, iw = image_hw
    step_w, step_h = iw / lw, ih / lh
    ars = [1.0]
    for ar in aspect_ratios:
        ars.append(ar)
        if flip:
            ars.append(1.0 / ar)
    if max_sizes:
        assert len(min_sizes) == len(max_sizes), (
            "PriorBox.cpp:117 requires len(min_sizes)==len(max_sizes)")
    rows = []
    for h in range(lh):
        for w in range(lw):
            cx, cy = (w + 0.5) * step_w, (h + 0.5) * step_h
            for mn in min_sizes:
                rows.append((cx, cy, mn, mn))
                for mx in max_sizes or ():
                    m = math.sqrt(mn * mx)
                    rows.append((cx, cy, m, m))
            mn = min_sizes[-1]
            for ar in ars:
                if abs(ar - 1.0) < 1e-6:
                    continue
                rows.append((cx, cy, mn * math.sqrt(ar), mn / math.sqrt(ar)))
    r = np.asarray(rows, np.float32)
    boxes = np.stack([(r[:, 0] - r[:, 2] / 2) / iw,
                      (r[:, 1] - r[:, 3] / 2) / ih,
                      (r[:, 0] + r[:, 2] / 2) / iw,
                      (r[:, 1] + r[:, 3] / 2) / ih], axis=1)
    if clip:
        boxes = np.clip(boxes, 0.0, 1.0)
    var = np.broadcast_to(np.asarray(variances, np.float32),
                          boxes.shape).copy()
    return np.concatenate([boxes, var], axis=1)


def iou_matrix(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """[..., N, M] Jaccard overlap of a [..., N, 4] and b [..., M, 4]."""
    ax1, ay1, ax2, ay2 = (a[..., i:i + 1] for i in range(4))
    bx1, by1, bx2, by2 = (b[..., None, :, i] for i in range(4))
    iw = torch.clamp(torch.minimum(ax2, bx2) - torch.maximum(ax1, bx1),
                     min=0.0)
    ih = torch.clamp(torch.minimum(ay2, by2) - torch.maximum(ay1, by1),
                     min=0.0)
    inter = iw * ih
    area_a = (ax2 - ax1) * (ay2 - ay1)
    area_b = (bx2 - bx1) * (by2 - by1)
    return inter / torch.clamp(area_a + area_b - inter, min=1e-10)


def _center(boxes):
    w = boxes[..., 2] - boxes[..., 0]
    h = boxes[..., 3] - boxes[..., 1]
    return ((boxes[..., 0] + boxes[..., 2]) / 2,
            (boxes[..., 1] + boxes[..., 3]) / 2, w, h)


def encode_boxes(priors, variances, gt):
    """[..., P, 4] regression targets (encodeBBoxWithVar)."""
    pcx, pcy, pw, ph = _center(priors)
    gcx, gcy, gw, gh = _center(gt)
    pw, ph = torch.clamp(pw, min=1e-10), torch.clamp(ph, min=1e-10)
    return torch.stack([
        (gcx - pcx) / pw / variances[:, 0],
        (gcy - pcy) / ph / variances[:, 1],
        torch.log(torch.abs(gw / pw) + 1e-10) / variances[:, 2],
        torch.log(torch.abs(gh / ph) + 1e-10) / variances[:, 3],
    ], dim=-1)


def decode_boxes(priors, variances, loc):
    """[..., P, 4] decoded boxes (decodeBBoxWithVar)."""
    pcx, pcy, pw, ph = _center(priors)
    cx = variances[:, 0] * loc[..., 0] * pw + pcx
    cy = variances[:, 1] * loc[..., 1] * ph + pcy
    w = torch.exp(variances[:, 2] * loc[..., 2]) * pw
    h = torch.exp(variances[:, 3] * loc[..., 3]) * ph
    return torch.stack([cx - w / 2, cy - h / 2, cx + w / 2, cy + h / 2],
                       dim=-1)


def match_boxes(priors, gt_boxes, gt_mask, overlap_threshold: float):
    """(match_idx [B, P] int64 with -1 = unmatched, match_overlap [B,
    P]) (matchBBox): a bipartite phase, G steps in which each image's
    globally best (prior, free ground truth) pair claims each other
    (the first maximum of the flattened [P, G] overlaps); then every
    still-free prior whose best overlap exceeds the threshold takes its
    argmax ground truth."""
    bsz, g = gt_boxes.shape[:2]
    p = priors.shape[0]
    ov = iou_matrix(priors.expand(bsz, p, 4), gt_boxes) * gt_mask[:, None, :]
    match_idx = torch.full((bsz, p), -1, dtype=torch.int64,
                           device=ov.device)
    gt_free = gt_mask.to(ov.dtype)
    rows = torch.arange(p, device=ov.device)
    cols = torch.arange(g, device=ov.device)
    for _ in range(g):
        m = ov * gt_free[:, None, :] * (match_idx == -1)[:, :, None]
        flat = torch.argmax(m.reshape(bsz, p * g), dim=1)
        pi, gj = flat // g, flat % g
        valid = torch.gather(m.reshape(bsz, -1), 1, flat[:, None])[:, 0] > 1e-6
        match_idx = torch.where(valid[:, None] & (rows[None] == pi[:, None]),
                                gj[:, None], match_idx)
        gt_free = torch.where(valid[:, None] & (cols[None] == gj[:, None]),
                              0.0, gt_free)
    best_ov = torch.amax(ov, dim=2)
    best_gt = torch.argmax(ov, dim=2)
    take = (match_idx == -1) & (best_ov > overlap_threshold)
    return torch.where(take, best_gt, match_idx), best_ov


def multibox_loss(loc_pred, conf_logits, priors, variances, gt_boxes,
                  gt_labels, gt_mask, overlap_threshold=0.5,
                  neg_pos_ratio=3.0, neg_overlap=0.5, background_id=0):
    """Per-image (loc_loss_sum [B], conf_loss_sum [B], num_matches [B])
    (MultiBoxLossLayer.cpp): smooth-L1 on matched priors against the
    encoded targets; softmax cross entropy over matched priors (their
    ground-truth label) and hard negatives (background), the negatives
    the highest background losses among priors of overlap below
    neg_overlap, at most neg_pos_ratio * num_pos. loc_pred [B, P, 4],
    conf_logits [B, P, C], ground truth [B, G, 4] / [B, G] / [B, G]."""
    with torch.no_grad():
        match_idx, match_ov = match_boxes(priors, gt_boxes, gt_mask,
                                          overlap_threshold)
    pos = match_idx >= 0
    n_pos = torch.sum(pos, dim=1)
    safe = torch.clamp(match_idx, min=0)
    gt_for_prior = torch.gather(gt_boxes, 1, safe[..., None].expand(
        safe.shape + (4,)))
    targets = encode_boxes(priors, variances, gt_for_prior)
    d = torch.abs(loc_pred - targets)
    sl1 = torch.where(d < 1.0, 0.5 * d * d, d - 0.5)
    loc_loss = torch.sum(torch.where(pos[..., None], sl1, 0.0), dim=(1, 2))

    lse = torch.logsumexp(conf_logits, dim=-1)
    label = torch.where(pos, torch.gather(gt_labels.long(), 1, safe),
                        background_id)
    ce = lse - torch.gather(conf_logits, 2, label[..., None])[..., 0]
    pos_conf = torch.sum(torch.where(pos, ce, 0.0), dim=1)

    bg_ce = lse - conf_logits[..., background_id]
    neg_cand = ~pos & (match_ov < neg_overlap)
    with torch.no_grad():
        neg_scores = torch.where(neg_cand, bg_ce, -math.inf)
        n_neg = torch.minimum((neg_pos_ratio * n_pos).to(torch.int64),
                              torch.sum(neg_cand, dim=1))
        order = torch.argsort(-neg_scores, dim=1, stable=True)
        rank = torch.argsort(order, dim=1, stable=True)
        neg = neg_cand & (rank < n_neg[:, None])
    neg_conf = torch.sum(torch.where(neg, bg_ce, 0.0), dim=1)
    return loc_loss, pos_conf + neg_conf, n_pos


def nms_keep(boxes, scores, threshold: float, top_k: int):
    """Greedy NMS (applyNMSFast) for every (image, class) at once:
    boxes [B, N, 4], scores [B, C, N]. Only the top_k scores of each
    row are candidates; walking them by descending score, a candidate
    is kept iff its score is positive and its IoU with every kept one
    is at most the threshold. Returns the kept scores [B, C, N] (0
    elsewhere)."""
    bsz, c, n = scores.shape
    k = min(top_k, n)
    top_s, top_i = top_k_stable(scores.reshape(bsz * c, n), k)
    top_s, top_i = top_s.reshape(bsz, c, k), top_i.reshape(bsz, c, k)
    cand = torch.gather(boxes[:, None].expand(bsz, c, n, 4), 2,
                        top_i[..., None].expand(bsz, c, k, 4))
    ov = iou_matrix(cand, cand)                           # [B, C, k, k]
    keep = torch.zeros((bsz, c, k), dtype=torch.bool, device=scores.device)
    for i in range(k):
        ok = torch.all(~keep | (ov[..., i, :] <= threshold), dim=-1)
        keep[..., i] = ok & (top_s[..., i] > 0)
    kept = torch.zeros_like(scores).scatter(
        2, top_i, torch.where(keep, top_s, 0.0))
    return kept


def detection_output(loc_pred, conf_logits, priors, variances,
                     num_classes: int, background_id: int = 0,
                     nms_threshold: float = 0.45, nms_top_k: int = 400,
                     keep_top_k: int = 200,
                     confidence_threshold: float = 0.01):
    """[B, keep_top_k, 6] rows (label, score, x1, y1, x2, y2), padded
    with zero rows (DetectionOutputLayer.cpp): decode, per-class NMS
    over the non-background classes, then the global top keep_top_k by
    score."""
    boxes = decode_boxes(priors, variances, loc_pred)     # [B, P, 4]
    probs = torch.softmax(conf_logits, dim=-1).transpose(1, 2)  # [B, C, P]
    bsz, c, p = probs.shape
    cls_ok = torch.arange(c, device=probs.device)[None, :, None] != (
        background_id)
    s = torch.where(cls_ok & (probs > confidence_threshold), probs, 0.0)
    kept = nms_keep(boxes, s, nms_threshold, nms_top_k)
    k = min(keep_top_k, c * p)
    top_s, top_i = top_k_stable(kept.reshape(bsz, c * p), k)
    cls = (top_i // p).to(probs.dtype)
    box = torch.gather(boxes, 1, (top_i % p)[..., None].expand(bsz, k, 4))
    rows = torch.cat([cls[..., None], top_s[..., None], box], dim=-1)
    rows = torch.where(top_s[..., None] > 0, rows, 0.0)
    if k < keep_top_k:
        rows = torch.cat([rows, rows.new_zeros((bsz, keep_top_k - k, 6))], 1)
    return rows
