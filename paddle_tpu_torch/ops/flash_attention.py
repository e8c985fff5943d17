"""Flash attention forward and backward: the Hopper kernels, their plain
versions, the autograd Function and the launch counters.

Replaces the TPU kernels behind `paddle_tpu/parallel/ring.py::
_pallas_flash` — the Pallas flash-attention forward and its two
backward calls (dkv and dq). The contract is the blocked oracle's,
`ring.py::_blocked_fwd` and `ring.py::_flash_blocked_bwd`:

- q [B, Tq, H, D], k and v [B, Tk, H, D], f32, the JAX layout (bf16,
  which the JAX flash takes under the AMP rule, raises: ROADMAP B-2);
- `causal` (key j visible to query i only when j <= i);
- optional `kv_len` [B] and `q_len` [B] int32: keys at or past
  kv_len[b] are masked, and a query row at or past q_len[b] sees no
  key at all;
- `scale`, default 1/sqrt(D);
- any head dim D <= 128: the kernels instantiate D in KERNEL_HEAD_DIMS,
  and `flash_attention` / `flash_attention_bwd` pad another D with zero
  columns of q, k, v (and dout) up to the next one and slice the
  padding off the results (zero columns add nothing to q.k and give
  zero columns of out, dq, dk and dv); `scale` stays that of the
  original D.

The forward returns (out [B, Tq, H, D] f32, lse [B, H, Tq] f32). A row
with no visible key gets out = 0 and lse = +1e30. The backward takes
(q, k, v, out, lse, dout) and returns (dq, dk, dv) with

    p     = exp(s * scale - lse), exactly 0 at masked pairs
    delta = sum_d dout * out                (per query row)
    ds    = p * (dout . v - delta) * scale
    dq = ds @ k,  dk = ds^T @ q,  dv = p^T @ dout

so a row with no visible key has dq = 0 and adds nothing to dk, dv.
A padded query row of self-attention (q_len unset, i >= kv_len) still
sees the valid keys: its output is garbage the layer zeroes, its dout
is 0, and the backward treats it as any other row.

A CUDA tensor goes through the kernels (`csrc/flash_attn_fwd.cu`,
`csrc/flash_attn_bwd.cu`) or the call raises — never a fallback. A CPU
tensor goes through `attention_plain` / `attention_bwd_plain`, the
straightforward versions that state the contract; the CPU tests use
them and the chip smoke holds the kernels against them on the card.
`FlashAttention` (an autograd Function) ties the two directions
together; `parallel/ring.py::flash_dense_attention` calls it.
"""

from __future__ import annotations

import ctypes
import math

import torch

from paddle_tpu_torch.ops import _build

KERNEL = "flash_attn_fwd"
BWD_KERNEL = "flash_attn_bwd"
KERNEL_HEAD_DIMS = (32, 64, 96, 128)   # the dims the kernels instantiate
MAX_HEAD_DIM = KERNEL_HEAD_DIMS[-1]
LSE_MASKED = 1e30

# kernel launches since the last reset, one counter per kernel (the
# chip smoke zeroes them just before driving a path and reads them just
# after)
launches = 0            # forward
bwd_dkv_launches = 0    # backward, dk and dv
bwd_dq_launches = 0     # backward, dq


def _visible(B, Tq, Tk, causal, kv_len, q_len, device):
    """[B, 1, Tq, Tk] bool: query i may see key j."""
    qpos = torch.arange(Tq, device=device)[:, None]
    kpos = torch.arange(Tk, device=device)[None, :]
    valid = torch.ones((B, 1, Tq, Tk), dtype=torch.bool, device=device)
    if kv_len is not None:
        valid = valid & (kpos < kv_len.to(device).view(B, 1, 1, 1))
    if q_len is not None:
        valid = valid & (qpos < q_len.to(device).view(B, 1, 1, 1))
    if causal:
        valid = valid & (kpos <= qpos)
    return valid


def _scale(scale, D):
    return float(scale) if scale is not None else 1.0 / math.sqrt(D)


def attention_plain(q, k, v, causal=False, kv_len=None, q_len=None,
                    scale=None):
    """The plain PyTorch forward: masked softmax in f32 over the
    [B, H, Tq, Tk] scores. Same inputs and outputs as flash_attention."""
    B, Tq, H, D = q.shape
    Tk = k.shape[1]
    scale = _scale(scale, D)
    s = torch.einsum("bqhd,bkhd->bhqk", q.float(), k.float()) * scale
    valid = _visible(B, Tq, Tk, causal, kv_len, q_len, q.device)
    s = s.masked_fill(~valid, float("-inf"))
    alive = valid.any(dim=-1)                      # [B, 1|H, Tq]
    m = torch.where(alive, s.amax(dim=-1), 0.0)    # [B, H, Tq]
    p = torch.exp(s - m[..., None])                # exactly 0 where masked
    den = p.sum(dim=-1)
    safe = torch.where(alive, den, 1.0)
    out = torch.einsum("bhqk,bkhd->bqhd", p, v.float())
    out = out / safe.permute(0, 2, 1)[..., None]
    lse = torch.where(alive, m + torch.log(safe),
                      torch.tensor(LSE_MASKED, device=q.device))
    return out, lse


def attention_bwd_plain(q, k, v, out, lse, dout, causal=False,
                        kv_len=None, q_len=None, scale=None):
    """The plain PyTorch backward: recomputes p from lse over the
    [B, H, Tq, Tk] scores. Returns (dq, dk, dv) f32; see the module
    docstring for the contract."""
    B, Tq, H, D = q.shape
    Tk = k.shape[1]
    scale = _scale(scale, D)
    qf, kf, vf, dof = q.float(), k.float(), v.float(), dout.float()
    s = torch.einsum("bqhd,bkhd->bhqk", qf, kf) * scale
    valid = _visible(B, Tq, Tk, causal, kv_len, q_len, q.device)
    p = torch.where(valid, torch.exp(s - lse[..., None]), 0.0)
    delta = torch.einsum("bqhd,bqhd->bhq", dof, out.float())
    dp = torch.einsum("bqhd,bkhd->bhqk", dof, vf)
    ds = p * (dp - delta[..., None]) * scale
    dq = torch.einsum("bhqk,bkhd->bqhd", ds, kf)
    dk = torch.einsum("bhqk,bqhd->bkhd", ds, qf)
    dv = torch.einsum("bhqk,bqhd->bkhd", p, dof)
    return dq, dk, dv


def _bind(name):
    lib = _build.load(name)
    p = ctypes.c_void_p
    i = ctypes.c_int
    if name == KERNEL:
        fns = {"flash_attn_fwd": [p] * 7 + [i] * 6 + [ctypes.c_float, i, p]}
    else:
        fns = {
            "flash_attn_bwd_dkv": [p] * 10 + [i] * 6 + [ctypes.c_float, i, p],
            "flash_attn_bwd_dq": [p] * 9 + [i] * 6 + [ctypes.c_float, i, p],
        }
    for fn, argtypes in fns.items():
        f = getattr(lib, fn)
        if f.argtypes is None:
            f.argtypes = argtypes
            f.restype = ctypes.c_int
    lib.flash_attn_error_string.argtypes = [ctypes.c_int]
    lib.flash_attn_error_string.restype = ctypes.c_char_p
    return lib


def _check_lens(x, B, name, device):
    if x is None:
        return None
    if (x.dtype != torch.int32 or x.shape != (B,) or x.device != device
            or not x.is_contiguous()):
        raise ValueError(
            f"{name} must be a contiguous int32 [B={B}] tensor on "
            f"{device}, got {x.dtype} {tuple(x.shape)} on {x.device}"
        )
    return x


def kernel_head_dim(D):
    """The head dim the kernels run a call of head dim D at: the
    smallest of KERNEL_HEAD_DIMS that is >= D."""
    for d in KERNEL_HEAD_DIMS:
        if D <= d:
            return d
    raise ValueError(f"head dim {D} > {MAX_HEAD_DIM}: the flash kernels "
                     f"take head dims up to {MAX_HEAD_DIM}")


def pad_head_dim(x, dk):
    """x [..., D] with dk - D zero columns appended (x itself when D ==
    dk), contiguous."""
    D = x.shape[-1]
    if D == dk:
        return x
    return torch.nn.functional.pad(x, (0, dk - D)).contiguous()


def _aligned(x):
    """x, or a copy of it when its data is not 16-byte aligned (the
    kernels read q, k, v and dout in 16-byte pieces)."""
    return x if x.data_ptr() % 16 == 0 else x.clone()


def _refuse_bf16(where, *tensors):
    """The kernels and their plain versions run f32; their bf16 forms
    (the JAX flash runs in q's dtype under the AMP rule) are ROADMAP
    B-2. No upcast, no fallback to the dense path."""
    if any(x.dtype == torch.bfloat16 for x in tensors):
        raise NotImplementedError(
            f"{where}: bf16 flash attention (the AMP rule's "
            f"attn_impl='flash') is not ported yet, ROADMAP B-2; use "
            f"attn_impl='dense' under the bf16 flag")


def _check_cuda(where, q, tensors, kernel_dims=True):
    """Validate the kernels' inputs on a CUDA device; returns the dims
    (B, Tq, Tk, H, D). D must be one of KERNEL_HEAD_DIMS, or with
    kernel_dims=False at most MAX_HEAD_DIM (the caller pads it)."""
    if q.device.type != "cuda":
        raise ValueError(f"{where}: unsupported device {q.device}")
    B, Tq, H, D = q.shape
    Tk = tensors["k"].shape[1]
    for name, x in tensors.items():
        t = Tk if name in ("k", "v") else Tq
        if (x.dtype != torch.float32 or x.device != q.device
                or tuple(x.shape) != (B, t, H, D)
                or not x.is_contiguous()):
            raise ValueError(
                f"{where}: {name} must be contiguous f32 "
                f"[{B},{t},{H},{D}] on {q.device}, got {x.dtype} "
                f"{tuple(x.shape)} on {x.device}"
            )
    if D > MAX_HEAD_DIM:
        raise ValueError(f"{where}: head dim {D} > {MAX_HEAD_DIM}: the "
                         f"flash kernels take head dims up to "
                         f"{MAX_HEAD_DIM}")
    if kernel_dims and D not in KERNEL_HEAD_DIMS:
        raise ValueError(f"{where}: head dim {D} not in {KERNEL_HEAD_DIMS} "
                         f"(flash_attention pads other dims)")
    return B, Tq, Tk, H, D


def _launch(lib, fn, *args):
    _build.launch(lib, fn, "flash_attn_error_string", *args)


def flash_attention(q, k, v, causal=False, kv_len=None, q_len=None,
                    scale=None):
    """(out, lse) of masked attention; see the module docstring. A
    CUDA tensor goes through the Hopper kernel, a CPU tensor through
    attention_plain."""
    global launches
    _refuse_bf16("flash_attention", q, k, v)
    if q.device.type == "cpu":
        return attention_plain(q, k, v, causal=causal, kv_len=kv_len,
                               q_len=q_len, scale=scale)
    B, Tq, Tk, H, D = _check_cuda("flash_attention", q,
                                  {"q": q, "k": k, "v": v},
                                  kernel_dims=False)
    kv_len = _check_lens(kv_len, B, "kv_len", q.device)
    q_len = _check_lens(q_len, B, "q_len", q.device)
    scale = _scale(scale, D)
    dk = kernel_head_dim(D)
    q, k, v = (_aligned(pad_head_dim(x, dk)) for x in (q, k, v))
    lib = _bind(KERNEL)
    out = torch.empty_like(q)
    lse = torch.empty((B, H, Tq), dtype=torch.float32, device=q.device)
    _launch(lib, "flash_attn_fwd", q.data_ptr(), k.data_ptr(),
            v.data_ptr(), out.data_ptr(), lse.data_ptr(),
            _build.ptr(kv_len), _build.ptr(q_len), B, Tq, Tk, H, dk,
            int(bool(causal)), scale, *_build.device_and_stream(q))
    launches += 1
    return (out if dk == D else out[..., :D].contiguous()), lse


def _check_rows(where, name, x, B, H, Tq, device):
    if (x.dtype != torch.float32 or tuple(x.shape) != (B, H, Tq)
            or x.device != device or not x.is_contiguous()):
        raise ValueError(
            f"{where}: {name} must be contiguous f32 [{B},{H},{Tq}] on "
            f"{device}, got {x.dtype} {tuple(x.shape)} on {x.device}"
        )


def _bwd_launch_args(where, q, k, v, dout, lse, delta, causal, kv_len,
                     q_len, scale):
    """Validate one backward kernel's inputs; returns (lib, lens, dims)
    where dims are the trailing int/float/stream arguments."""
    B, Tq, Tk, H, D = _check_cuda(where, q,
                                  {"q": q, "k": k, "v": v, "dout": dout})
    _check_rows(where, "lse", lse, B, H, Tq, q.device)
    _check_rows(where, "delta", delta, B, H, Tq, q.device)
    kv_len = _check_lens(kv_len, B, "kv_len", q.device)
    q_len = _check_lens(q_len, B, "q_len", q.device)
    dims = (B, Tq, Tk, H, D, int(bool(causal)), _scale(scale, D),
            *_build.device_and_stream(q))
    return _bind(BWD_KERNEL), (_build.ptr(kv_len), _build.ptr(q_len)), dims


def flash_attention_bwd_dkv(q, k, v, dout, lse, delta, causal=False,
                            kv_len=None, q_len=None, scale=None):
    """(dk, dv) from the dkv kernel (CUDA tensors only); `delta` is
    sum_d dout * out, [B, H, Tq]."""
    global bwd_dkv_launches
    lib, lens, dims = _bwd_launch_args(
        "flash_attention_bwd_dkv", q, k, v, dout, lse, delta, causal,
        kv_len, q_len, scale)
    dk = torch.empty_like(k)
    dv = torch.empty_like(v)
    _launch(lib, "flash_attn_bwd_dkv", q.data_ptr(), k.data_ptr(),
            v.data_ptr(), dout.data_ptr(), lse.data_ptr(),
            delta.data_ptr(), dk.data_ptr(), dv.data_ptr(), *lens, *dims)
    bwd_dkv_launches += 1
    return dk, dv


def flash_attention_bwd_dq(q, k, v, dout, lse, delta, causal=False,
                           kv_len=None, q_len=None, scale=None):
    """dq from the dq kernel (CUDA tensors only)."""
    global bwd_dq_launches
    lib, lens, dims = _bwd_launch_args(
        "flash_attention_bwd_dq", q, k, v, dout, lse, delta, causal,
        kv_len, q_len, scale)
    dq = torch.empty_like(q)
    _launch(lib, "flash_attn_bwd_dq", q.data_ptr(), k.data_ptr(),
            v.data_ptr(), dout.data_ptr(), lse.data_ptr(),
            delta.data_ptr(), dq.data_ptr(), *lens, *dims)
    bwd_dq_launches += 1
    return dq


def flash_attention_bwd(q, k, v, out, lse, dout, causal=False,
                        kv_len=None, q_len=None, scale=None):
    """(dq, dk, dv) of masked attention from the forward's out and lse;
    see the module docstring. A CUDA tensor goes through the two
    Hopper kernels (dkv, then dq), a CPU tensor through
    attention_bwd_plain."""
    _refuse_bf16("flash_attention_bwd", q, k, v, dout)
    if q.device.type == "cpu":
        return attention_bwd_plain(q, k, v, out, lse, dout, causal=causal,
                                   kv_len=kv_len, q_len=q_len, scale=scale)
    D = _check_cuda("flash_attention_bwd", q, {"q": q, "out": out, "k": k},
                    kernel_dims=False)[-1]
    # the softmax-jacobian row term, a plain reduction as in the JAX
    # package (the library computes it outside its kernels too)
    delta = torch.einsum("bqhd,bqhd->bhq", dout, out).contiguous()
    kw = dict(causal=causal, kv_len=kv_len, q_len=q_len,
              scale=_scale(scale, D))
    d_k = kernel_head_dim(D)
    q, k, v, dout = (_aligned(pad_head_dim(x, d_k)) for x in (q, k, v, dout))
    dk, dv = flash_attention_bwd_dkv(q, k, v, dout, lse, delta, **kw)
    dq = flash_attention_bwd_dq(q, k, v, dout, lse, delta, **kw)
    if d_k != D:
        dq, dk, dv = (x[..., :D].contiguous() for x in (dq, dk, dv))
    return dq, dk, dv


class FlashAttention(torch.autograd.Function):
    """out = flash attention of (q, k, v), differentiable in q, k, v.
    The forward saves q, k, v, out and lse; the backward recomputes p
    from lse (flash_attention_bwd). kv_len / q_len are int32 [B] or
    None; causal and scale are plain values."""

    @staticmethod
    def forward(ctx, q, k, v, kv_len, q_len, causal, scale):
        out, lse = flash_attention(q, k, v, causal=causal, kv_len=kv_len,
                                   q_len=q_len, scale=scale)
        ctx.save_for_backward(q, k, v, out, lse, kv_len, q_len)
        ctx.causal = causal
        ctx.scale = scale
        return out

    @staticmethod
    @torch.autograd.function.once_differentiable
    def backward(ctx, dout):
        q, k, v, out, lse, kv_len, q_len = ctx.saved_tensors
        dq, dk, dv = flash_attention_bwd(
            q, k, v, out, lse, dout.contiguous(), causal=ctx.causal,
            kv_len=kv_len, q_len=q_len, scale=ctx.scale)
        return dq, dk, dv, None, None, None, None
