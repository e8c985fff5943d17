"""Single-device attention: the dense reference and flash attention.

The single-chip part of `paddle_tpu/parallel/ring.py`, same names and
the same masked-attention contract (q, k, v [B, T, H, D], kv_len [B]):

- `dense_attention`: the reference path — materializes the
  [B, H, Tq, Tk] scores and masks with an additive NEG_INF, exactly
  as the JAX function does (so a fully-masked row attends uniformly,
  as there). Scores, softmax and the product run in q's dtype (bf16
  under the AMP rule), as there.
- `flash_dense_attention`: flash attention, forward and backward. On
  the card they are the hand-written Hopper kernels
  (`ops/flash_attention.py`, replacing the Pallas kernels); on a CPU
  tensor the kernels' plain versions. A row with no visible key
  yields 0 and gets no gradient.

Ring and Ulysses attention (the mesh `seq` axis) come with the
multi-GPU part of the port.
"""

from __future__ import annotations

import math

import torch

from paddle_tpu_torch.ops import flash_attention as _fa

NEG_INF = -1e30


def dense_attention(q, k, v, *, causal=False, kv_len=None, scale=None):
    """Reference masked attention. q,k,v: [B, T, H, D]; kv_len: [B] valid
    K/V length (padding masked out)."""
    B, Tq, H, D = q.shape
    Tk = k.shape[1]
    if scale is None:
        # 1/sqrt(D) in q's dtype, as the JAX function rounds it
        scale = float(torch.tensor(1.0 / math.sqrt(D), dtype=q.dtype))
    s = torch.einsum("bqhd,bkhd->bhqk", q, k) * scale
    mask = torch.zeros((B, 1, Tq, Tk), dtype=q.dtype, device=q.device)
    if kv_len is not None:
        pad = (torch.arange(Tk, device=q.device)[None, :]
               >= kv_len.to(q.device)[:, None])
        mask = torch.where(pad[:, None, None, :], NEG_INF, mask)
    if causal:
        qpos = torch.arange(Tq, device=q.device)[:, None]
        kpos = torch.arange(Tk, device=q.device)[None, :]
        mask = mask + torch.where(kpos > qpos, NEG_INF, 0.0).to(q.dtype)
    p = torch.softmax(s + mask, dim=-1)
    return torch.einsum("bhqk,bkhd->bqhd", p, v)


def flash_dense_attention(q, k, v, *, causal=False, kv_len=None,
                          q_len=None, scale=None):
    """Flash attention with dense_attention's contract, plus `q_len`
    (query rows at or past it are fully masked and return 0). Never
    materializes the [B, H, T, T] scores on the card. Differentiable
    in q, k and v: the backward is the flash backward (the Hopper dkv
    and dq kernels on the card). kv_len and q_len are cast to the int32
    the kernels take."""
    if kv_len is not None:
        kv_len = kv_len.to(device=q.device, dtype=torch.int32).contiguous()
    if q_len is not None:
        q_len = q_len.to(device=q.device, dtype=torch.int32).contiguous()
    return _fa.FlashAttention.apply(
        q.contiguous(), k.contiguous(), v.contiguous(), kv_len, q_len,
        bool(causal), scale,
    )
