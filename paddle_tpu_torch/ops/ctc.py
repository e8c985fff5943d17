"""CTC (Connectionist Temporal Classification): `paddle_tpu/ops/ctc.py`
on torch — the loss and best-path decoding.

The loss is the JAX module's lattice, not `F.ctc_loss` (whose
conventions for zero-length labels and infinite losses differ): the
extended label sequence [2L+1] (blank, l1, blank, ..., blank) walked in
the log domain over time, batched and masked, with -1e30 for an
impossible state. `blank` is a class index (default 0). Label ids
outside [0, C) are clamped into it before any gather (padding past a
label's length is never read as a label; the feeder pads with 0).
Plain tensor ops in a Python loop over the static time axis: no host
synchronisation.
"""

from __future__ import annotations

import torch

NEG_INF = -1e30


def ctc_loss(log_probs, input_lens, labels, label_lens, blank=0):
    """log_probs [B,T,C] log-softmax outputs; input_lens [B]; labels
    [B,L] ids (padded with anything); label_lens [B]. Returns [B]
    negative log likelihoods."""
    bsz, t, c = log_probs.shape
    dev = log_probs.device
    s = 2 * labels.shape[1] + 1
    label_lens = label_lens.long()
    ext = torch.full((bsz, s), blank, dtype=torch.long, device=dev)
    ext[:, 1::2] = torch.clamp(labels.long(), 0, c - 1)
    ext_valid = (torch.arange(s, device=dev)[None, :]
                 < (2 * label_lens + 1)[:, None])
    # a skip from s-2 to s: only onto a label that differs from s-2's
    can_skip = torch.cat([
        torch.zeros((bsz, min(s, 2)), dtype=torch.bool, device=dev),
        (ext[:, 2:] != ext[:, :-2]) & (ext[:, 2:] != blank)], dim=1)
    has_label = label_lens > 0

    def neg(n):
        return log_probs.new_full((bsz, n), NEG_INF)

    emit0 = torch.gather(log_probs[:, 0], 1, ext)
    alpha = emit0[:, :1]
    if s > 1:
        alpha = torch.cat([alpha, torch.where(has_label, emit0[:, 1],
                                              NEG_INF)[:, None],
                           neg(s - 2)], dim=1)
    pos = torch.arange(1, t, device=dev)
    step_mask = pos[None, :] < input_lens[:, None]
    for i in range(1, t):
        emit = torch.gather(log_probs[:, i], 1, ext)
        prev1 = torch.cat([neg(1), alpha[:, :-1]], dim=1)
        prev2 = torch.where(can_skip,
                            torch.cat([neg(2), alpha[:, :-2]], dim=1)[:, :s],
                            NEG_INF)
        new = torch.logaddexp(torch.logaddexp(alpha, prev1), prev2) + emit
        new = torch.where(ext_valid, new, NEG_INF)
        alpha = torch.where(step_mask[:, i - 1, None], new, alpha)
    # the sum of the last blank's and the last label's states
    a_end = torch.gather(alpha, 1, torch.clamp_max(2 * label_lens,
                                                   s - 1)[:, None])[:, 0]
    lab = torch.clamp(2 * label_lens - 1, 0, s - 1)
    a_lab = torch.where(has_label,
                        torch.gather(alpha, 1, lab[:, None])[:, 0], NEG_INF)
    return -torch.logaddexp(a_end, a_lab)


def ctc_greedy_decode(log_probs, input_lens, blank=0):
    """Best-path decode: argmax per step, collapse repeats, drop blanks.
    `log_probs` [B, T, C], `input_lens` [B] (tensors or array-likes).
    Returns (paths [B, T] int32 padded with blank, lens [B] int32), the
    kept tokens of each row moved to its front in time order."""
    lp = torch.as_tensor(log_probs)
    pred = lp.argmax(dim=-1).to(torch.int32)  # [B, T]
    bsz, t = pred.shape
    lens_in = torch.as_tensor(input_lens, device=pred.device)
    pos = torch.arange(t, device=pred.device)[None, :]
    valid = pos < lens_in[:, None]
    prev = torch.cat([torch.full((bsz, 1), -1, dtype=torch.int32,
                                 device=pred.device), pred[:, :-1]], dim=1)
    keep = valid & (pred != blank) & (pred != prev)
    # compact the kept tokens to the left, in order
    order = torch.argsort(torch.where(keep, pos, t + pos), dim=1,
                          stable=True)
    gathered = torch.gather(pred, 1, order)
    lens = keep.sum(dim=1).to(torch.int32)
    out = torch.where(pos < lens[:, None], gathered,
                      torch.full_like(gathered, blank))
    return out, lens
