"""Linear-chain CRF: negative log-likelihood and Viterbi decoding —
`paddle_tpu/ops/crf.py` on torch.

The weight is [N+2, N] as in the reference's LinearChainCRF.cpp: row 0
the start scores a, row 1 the end scores b, rows 2.. the transitions
w[i, j] = score(tag i -> tag j). The forward recursion runs in the log
domain over time with a masked carry (padded steps carry alpha
through); autograd of log Z gives the marginals. Plain tensor ops in a
Python loop over the (static) time axis: no host synchronisation.

Tag ids outside [0, N) are clamped into it before any gather, so a
padded position never reads out of bounds on the card. The port's
feeder pads with 0, where both packages read the same entry.
"""

from __future__ import annotations

import torch


def _split(w):
    return w[0], w[1], w[2:]


def _tags(labels, n):
    return torch.clamp(labels.long(), 0, n - 1)


def _step_mask(seq_lens, t, dtype):
    """[B, T-1]: 1 where step t >= 1 is real."""
    pos = torch.arange(1, t, device=seq_lens.device)
    return (pos[None, :] < seq_lens[:, None]).to(dtype)


def crf_log_likelihood(emit, labels, seq_lens, w):
    """emit [B,T,N] unnormalised per-step tag scores; labels [B,T] ids;
    seq_lens [B]. Returns [B] log p(labels | emit) (the negative cost)."""
    return _crf_score(emit, labels, seq_lens, w) - crf_log_norm(
        emit, seq_lens, w)


def _crf_score(emit, labels, seq_lens, w):
    a, b, trans = _split(w)
    _bsz, t, n = emit.shape
    labels = _tags(labels, n)
    pos = torch.arange(t, device=emit.device)
    mask = (pos[None, :] < seq_lens[:, None]).to(emit.dtype)
    picked = torch.gather(emit, 2, labels[..., None])[..., 0]
    score = torch.sum(picked * mask, dim=1) + a[labels[:, 0]]
    last = torch.clamp_min(seq_lens.long() - 1, 0)
    score = score + b[torch.gather(labels, 1, last[:, None])[:, 0]]
    # transitions between consecutive real steps
    tr = trans[labels[:, :-1], labels[:, 1:]]
    return score + torch.sum(tr * mask[:, 1:], dim=1)


def crf_log_norm(emit, seq_lens, w):
    """log Z by the masked forward recursion."""
    a, b, trans = _split(w)
    t = emit.shape[1]
    alpha = a[None, :] + emit[:, 0]
    mask = _step_mask(seq_lens, t, emit.dtype)
    for s in range(1, t):
        nxt = torch.logsumexp(alpha[:, :, None] + trans[None], dim=1) + (
            emit[:, s])
        m = mask[:, s - 1, None]
        alpha = m * nxt + (1 - m) * alpha
    return torch.logsumexp(alpha + b[None, :], dim=1)


def crf_decode(emit, seq_lens, w):
    """Viterbi: (best paths [B,T] int64, best scores [B]). A padded step
    records the identity backpointer, so the path holds its last real
    tag through the padding. Ties go to the first maximum, as in JAX."""
    a, b, trans = _split(w)
    _bsz, t, n = emit.shape
    delta = a[None, :] + emit[:, 0]
    mask = _step_mask(seq_lens, t, torch.float32) > 0
    ident = torch.arange(n, device=emit.device)[None, :]
    bps = []
    for s in range(1, t):
        cand = delta[:, :, None] + trans[None]  # [B, from, to]
        best, best_prev = torch.max(cand, dim=1)
        m = mask[:, s - 1, None]
        delta = torch.where(m, best + emit[:, s], delta)
        bps.append(torch.where(m, best_prev, ident))
    final = delta + b[None, :]
    best_score, tag = torch.max(final, dim=1)
    path = [tag]
    for bp in reversed(bps):
        tag = torch.gather(bp, 1, tag[:, None])[:, 0]
        path.append(tag)
    return torch.stack(path[::-1], dim=1), best_score
