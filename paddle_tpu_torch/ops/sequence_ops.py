"""Sequence ops over dense-packed [B, T, ...] batches:
`paddle_tpu/ops/sequence_ops.py` on torch.

Mask semantics on static shapes: every op takes [B, T, ...] plus
seq_lens [B] and guarantees that padding positions never affect
results. Plain tensor ops, no kernels.
"""

from __future__ import annotations

import torch

NEG_INF = -1e30


def _mask(seq_lens: torch.Tensor, t: int, dtype=torch.float32) -> torch.Tensor:
    pos = torch.arange(t, dtype=torch.int32, device=seq_lens.device)[None, :]
    return (pos < seq_lens[:, None]).to(dtype)


def _trail(m: torch.Tensor, ndim: int) -> torch.Tensor:
    """[B, T] -> [B, T, 1, ...] broadcastable against an ndim tensor."""
    return m.reshape(m.shape + (1,) * (ndim - 2))


def seq_sum(x: torch.Tensor, seq_lens: torch.Tensor) -> torch.Tensor:
    """[B,T,D] -> [B,D] sum over real timesteps."""
    m = _mask(seq_lens, x.shape[1], x.dtype)
    return torch.einsum("bt,bt...->b...", m, x)


def seq_avg(x: torch.Tensor, seq_lens: torch.Tensor) -> torch.Tensor:
    denom = torch.clamp_min(seq_lens, 1).to(x.dtype)
    return seq_sum(x, seq_lens) / denom[:, None]


def seq_sqrt_avg(x: torch.Tensor, seq_lens: torch.Tensor) -> torch.Tensor:
    """sum / sqrt(len) — the reference's "SqrtAvgPooling"."""
    denom = torch.sqrt(torch.clamp_min(seq_lens, 1).to(x.dtype))
    return seq_sum(x, seq_lens) / denom[:, None]


def seq_max(x: torch.Tensor, seq_lens: torch.Tensor) -> torch.Tensor:
    m = _mask(seq_lens, x.shape[1], x.dtype)
    masked = torch.where(_trail(m, x.ndim) > 0, x,
                         torch.full_like(x, NEG_INF))
    return torch.amax(masked, dim=1)


def seq_last(x: torch.Tensor, seq_lens: torch.Tensor) -> torch.Tensor:
    """[B,T,D] -> [B,D] value at t = len-1 (SequenceLastInstanceLayer)."""
    idx = torch.clamp_min(seq_lens.long() - 1, 0)
    return x[torch.arange(x.shape[0], device=x.device), idx]


def seq_first(x: torch.Tensor, seq_lens: torch.Tensor) -> torch.Tensor:
    del seq_lens
    return x[:, 0]


def expand_to_seq(x: torch.Tensor, seq_lens: torch.Tensor,
                  t: int) -> torch.Tensor:
    """[B,D] -> [B,T,D] broadcast along time (ExpandLayer)."""
    out = x[:, None].expand((x.shape[0], t) + tuple(x.shape[1:]))
    return out * _trail(_mask(seq_lens, t, x.dtype), x.ndim + 1)


def masked_softmax(x: torch.Tensor, seq_lens: torch.Tensor) -> torch.Tensor:
    """Softmax over the time axis of [B,T] with padding masked out
    (the reference's sequence_softmax activation)."""
    m = _mask(seq_lens, x.shape[1], x.dtype)
    z = torch.where(m > 0, x, torch.full_like(x, NEG_INF))
    return torch.softmax(z, dim=1) * m


def _gather_time(x: torch.Tensor, src: torch.Tensor) -> torch.Tensor:
    """out[b, t] = x[b, src[b, t]] for src [B, T'] (take_along_axis on
    the time axis)."""
    idx = src.long().reshape(src.shape + (1,) * (x.ndim - 2))
    return torch.gather(x, 1, idx.expand(src.shape + tuple(x.shape[2:])))


def reverse_seq(x: torch.Tensor, seq_lens: torch.Tensor) -> torch.Tensor:
    """Reverse each sequence in place, keeping padding at the tail
    (reference: SequenceReverseLayer / reversed recurrent groups)."""
    t = x.shape[1]
    pos = torch.arange(t, dtype=torch.int32, device=x.device)[None, :]
    lens = seq_lens[:, None].to(torch.int32)
    src = torch.where(pos < lens, lens - 1 - pos, pos)
    return _gather_time(x, src)


def seq_concat(a, a_lens, b, b_lens):
    """Concatenate two sequence batches along time per-row
    (SequenceConcatLayer). Output time dim = Ta + Tb (static)."""
    ta, tb = a.shape[1], b.shape[1]
    out_lens = a_lens + b_lens
    pos = torch.arange(ta + tb, dtype=torch.int32, device=a.device)[None, :]
    from_a = pos < a_lens[:, None]
    a_gath = _gather_time(a, torch.clamp(pos.expand(a.shape[0], -1), 0,
                                         ta - 1))
    b_gath = _gather_time(b, torch.clamp(pos - a_lens[:, None], 0, tb - 1))
    valid = pos < out_lens[:, None]
    out = torch.where(_trail(from_a, a.ndim), a_gath, b_gath)
    return out * _trail(valid, a.ndim).to(out.dtype), out_lens


def seq_shift(x: torch.Tensor, seq_lens: torch.Tensor,
              shift: int) -> torch.Tensor:
    """Per-sequence time shift with zero padding OUTSIDE each sequence's
    own [0, seq_len): y[b,t] = x[b,t+shift] when both t and t+shift are
    inside sequence b, else 0."""
    t = x.shape[1]
    pos = torch.arange(t, device=x.device)
    src = pos + shift
    inside = ((src >= 0)[None, :]
              & (src[None, :] < seq_lens[:, None])
              & (pos[None, :] < seq_lens[:, None]))
    y = x[:, torch.clamp(src, 0, t - 1)]
    return torch.where(_trail(inside, x.ndim), y, torch.zeros_like(y))


def seq_slice_window(x, seq_lens, begin: int, size: int):
    """Static window slice along time (SeqSliceLayer, static case)."""
    sl = torch.clamp(seq_lens - begin, 0, size)
    return x[:, begin: begin + size], sl


def subseq_to_seq_lens(subseq_lens: torch.Tensor) -> torch.Tensor:
    """[B,S] nested lengths -> [B] total lengths."""
    return torch.sum(subseq_lens, dim=1)


def subseq_pool(x, subseq_lens, op: str = "sum"):
    """Pool each sub-sequence: [B,T,D] + [B,S] -> [B,S,D], where the
    s-th output row pools x[t] for t in the s-th sub-sequence."""
    t = x.shape[1]
    ends = torch.cumsum(subseq_lens, dim=1)
    starts = ends - subseq_lens
    pos = torch.arange(t, device=x.device)[None, None, :]
    inside = (pos >= starts[..., None]) & (pos < ends[..., None])  # [B,S,T]
    inside_f = inside.to(x.dtype)
    if op in ("sum", "avg", "sqrt_avg"):
        s = torch.einsum("bst,btd->bsd", inside_f, x)
        if op == "sum":
            return s
        denom = torch.clamp_min(subseq_lens, 1).to(x.dtype)[..., None]
        return s / (denom if op == "avg" else torch.sqrt(denom))
    if op == "max":
        big = torch.where(inside[..., None], x[:, None],
                          torch.full_like(x[:, None], NEG_INF))
        return torch.amax(big, dim=2)
    if op == "last":
        return _gather_time(x, torch.clamp_min(ends - 1, 0))
    if op == "first":
        # a padded sub-sequence that starts at T reads step T-1 (the JAX
        # gather fills NaN there); its value is padding either way
        return _gather_time(x, torch.clamp_max(starts, t - 1))
    raise ValueError(f"unknown subseq pool op {op!r}")
