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

Sequence parallelism over the mesh `seq` axis (JAX `ring_attention`,
`ulysses_attention`). Both take q, k, v that every rank of the axis
holds whole (the attention layer's projections of activations the
port keeps whole on every axis but `data`) and return the whole
output; inside, each rank works on its slice of T
(`parallel/collectives.py::split` / `gather`, whose backwards are the
all-gather and the slice):

- `ring_attention`: the rank's queries against every rank's K/V block,
  the blocks rotating around the ring (batched isend / irecv), with an
  online softmax across and inside ring steps (score tiles of at most
  `RING_BLOCK_K` keys). It is an autograd function that saves only its
  output, the log-sum-exp and the K/V shards, O(T) a rank; its backward
  recomputes each tile's p from the log-sum-exp, as flash does, and
  rotates the K/V cotangents back to their owners. Plain torch, as the
  JAX body is plain jnp.
- `ulysses_attention`: all-to-all from time shards to head groups,
  local attention over the whole T for H / n heads (dense, or the
  flash kernels with attn_impl="flash"), all-to-all back. The heads
  must divide the axis.

A rank's slice masks by global position (q_off = index * T / n) and
kv_lens stay global.
"""

from __future__ import annotations

import math

import torch

from paddle_tpu_torch.core.mesh import SEQ_AXIS
from paddle_tpu_torch.ops import flash_attention as _fa
from paddle_tpu_torch.parallel import collectives as C

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
    return _fa.flash_attention(
        q.contiguous(), k.contiguous(), v.contiguous(), causal=causal,
        kv_len=kv_len, q_len=q_len, scale=scale,
    )[0]


# largest local score tile a ring step materializes: a K/V shard longer
# than this (and divisible by it) is walked in tiles of this many keys
RING_BLOCK_K = 2048


def _ring_tiles(tk: int) -> int:
    return RING_BLOCK_K if tk > RING_BLOCK_K and tk % RING_BLOCK_K == 0 \
        else tk


def _ring_scores(q32, kb, k_off, qpos, kv_lens, causal, scale):
    """Masked f32 scores [B, H, Tq, blk] of q against one key tile at
    global offset k_off (masked entries pushed below 0.5 * NEG_INF)."""
    B, Tq = q32.shape[:2]
    blk = kb.shape[1]
    s = torch.einsum("bqhd,bkhd->bhqk", q32, kb.float()) * scale
    kpos = k_off + torch.arange(blk, device=q32.device)
    neg = torch.zeros((B, 1, Tq, blk), dtype=torch.float32,
                      device=q32.device)
    if kv_lens is not None:
        pad = kpos[None, :] >= kv_lens.to(q32.device)[:, None]
        neg = torch.where(pad[:, None, None, :], NEG_INF, neg)
    if causal:
        neg = neg + torch.where(kpos[None, :] > qpos[:, None], NEG_INF,
                                0.0)[None, None]
    return s + neg


class _Ring(torch.autograd.Function):
    """Ring attention on this rank's shards: q [B, Tq, H, D] at global
    offset q_off, k/v [B, Tk, H, D] (this rank's blocks)."""

    @staticmethod
    def forward(ctx, q, k, v, mesh, axis, causal, kv_lens, scale):
        n = mesh.axis_size(axis)
        my = mesh.axis_index(axis)
        B, Tq, H, D = q.shape
        Tk = k.shape[1]
        q_off = my * Tq
        q32 = q.float()
        qpos = q_off + torch.arange(Tq, device=q.device)
        acc = torch.zeros((B, Tq, H, D), dtype=torch.float32,
                          device=q.device)
        m = torch.full((B, H, Tq), NEG_INF, dtype=torch.float32,
                       device=q.device)
        den = torch.zeros((B, H, Tq), dtype=torch.float32, device=q.device)
        blk = _ring_tiles(Tk)
        kc, vc = k, v
        for i in range(n):
            k_off = ((my - i) % n) * Tk
            for j in range(0, Tk, blk):
                s = _ring_scores(q32, kc[:, j:j + blk], k_off + j, qpos,
                                 kv_lens, causal, scale)
                m_new = torch.maximum(m, s.amax(-1))
                corr = torch.exp(m - m_new)
                p = torch.where(s > 0.5 * NEG_INF,
                                torch.exp(s - m_new[..., None]), 0.0)
                den = den * corr + p.sum(-1)
                acc = acc * corr.transpose(1, 2)[..., None] + torch.einsum(
                    "bhqk,bkhd->bqhd", p, vc[:, j:j + blk].float())
                m = m_new
                del s, p
            if i < n - 1:
                kc, vc = C.shift_(mesh, axis, [kc, vc], 1)
        den = torch.where(den == 0.0, 1.0, den)  # fully-masked rows
        out = acc / den.transpose(1, 2)[..., None]
        lse = m + torch.log(den)
        ctx.save_for_backward(q, k, v, out, lse,
                              kv_lens if kv_lens is not None else
                              torch.empty(0))
        ctx.args = (mesh, axis, causal, kv_lens is not None, scale)
        return out.to(q.dtype)

    @staticmethod
    def backward(ctx, dout):
        q, k, v, out, lse, kv_lens = ctx.saved_tensors
        mesh, axis, causal, has_lens, scale = ctx.args
        kv_lens = kv_lens if has_lens else None
        n = mesh.axis_size(axis)
        my = mesh.axis_index(axis)
        B, Tq, H, D = q.shape
        Tk = k.shape[1]
        q32 = q.float()
        do = dout.float()
        qpos = my * Tq + torch.arange(Tq, device=q.device)
        delta = (do * out).sum(-1).transpose(1, 2)  # [B, H, Tq]
        dq = torch.zeros_like(q32)
        dk = torch.zeros((B, Tk, H, D), dtype=torch.float32,
                         device=q.device)
        dv = torch.zeros_like(dk)
        blk = _ring_tiles(Tk)
        kc, vc = k, v
        for i in range(n):
            k_off = ((my - i) % n) * Tk
            for j in range(0, Tk, blk):
                kb, vb = kc[:, j:j + blk].float(), vc[:, j:j + blk].float()
                s = _ring_scores(q32, kb, k_off + j, qpos, kv_lens, causal,
                                 scale)
                p = torch.where(s > 0.5 * NEG_INF,
                                torch.exp(s - lse[..., None]), 0.0)
                del s
                dv[:, j:j + blk] += torch.einsum("bhqk,bqhd->bkhd", p, do)
                dp = torch.einsum("bqhd,bkhd->bhqk", do, vb)
                ds = p * (dp - delta[..., None])
                del p, dp
                dq += torch.einsum("bhqk,bkhd->bqhd", ds, kb) * scale
                dk[:, j:j + blk] += torch.einsum("bhqk,bqhd->bkhd", ds,
                                                 q32) * scale
                del ds
            # the cotangents travel with their blocks; one hop more
            # after the last step takes each home
            if i < n - 1:
                kc, vc, dk, dv = C.shift_(mesh, axis, [kc, vc, dk, dv], 1)
            else:
                dk, dv = C.shift_(mesh, axis, [dk, dv], 1)
        return (dq.to(q.dtype), dk.to(k.dtype), dv.to(v.dtype), None, None,
                None, None, None)


def ring_attention(q, k, v, mesh, *, axis: str = SEQ_AXIS, causal=False,
                   kv_lens=None):
    """q, k, v: [B, T, H, D], held whole by every rank of `axis`;
    kv_lens: [B] valid lengths (global). Each rank attends its T / n
    queries over the ring; returns [B, T, H, D] whole on every rank."""
    _need_groups(mesh, axis)
    scale = 1.0 / (q.shape[-1] ** 0.5)
    ql, kl, vl = (C.split(x, mesh, axis, 1) for x in (q, k, v))
    if kv_lens is not None:
        kv_lens = kv_lens.to(device=q.device, dtype=torch.int64)
    out = _Ring.apply(ql, kl, vl, mesh, axis, bool(causal), kv_lens, scale)
    return C.gather(out, mesh, axis, 1)


def _need_groups(mesh, axis):
    if mesh.axis_size(axis) > 1 and not mesh.distributed:
        raise ValueError(
            f"sequence parallelism over {axis!r} needs a mesh with process "
            f"groups (core/mesh.py::distributed_init); {mesh!r} has a "
            f"shape only")


def ulysses_attention(q, k, v, mesh, *, axis: str = SEQ_AXIS, causal=False,
                      kv_lens=None, attn_impl="dense"):
    """All-to-all sequence parallelism (DeepSpeed-Ulysses): each rank's
    time shard [B, T/n, H, D] resharded to [B, T, H/n, D], local
    attention per head group ("dense", or "flash": the flash kernels),
    resharded back. q, k, v and the result are whole on every rank of
    `axis`, as for `ring_attention`."""
    _need_groups(mesh, axis)
    n = mesh.axis_size(axis)
    H = q.shape[2]
    if H % n:
        raise ValueError(f"heads {H} not divisible by seq shards {n}")
    qh, kh, vh = (C.all_to_all(C.split(x, mesh, axis, 1), mesh, axis, 2, 1)
                  for x in (q, k, v))
    if attn_impl == "flash":
        out = flash_dense_attention(qh, kh, vh, causal=causal,
                                    kv_len=kv_lens)
    else:
        out = dense_attention(qh, kh, vh, causal=causal, kv_len=kv_lens)
    out = C.all_to_all(out, mesh, axis, 1, 2)
    return C.gather(out, mesh, axis, 1)
