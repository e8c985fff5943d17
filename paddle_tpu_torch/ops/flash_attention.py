"""Flash-attention forward: the Hopper kernel, its plain version, and
the launch counter.

Replaces the TPU kernel behind `paddle_tpu/parallel/ring.py::
_pallas_flash` (the Pallas flash-attention forward); the contract is
`ring.py::_blocked_fwd`'s:

- q [B, Tq, H, D], k and v [B, Tk, H, D], f32, the JAX layout;
- `causal` (key j visible to query i only when j <= i);
- optional `kv_len` [B] and `q_len` [B] int32: keys at or past
  kv_len[b] are masked, and a query row at or past q_len[b] sees no
  key at all;
- `scale`, default 1/sqrt(D).

Returns (out [B, Tq, H, D] f32, lse [B, H, Tq] f32). A row with no
visible key gets out = 0 and lse = +1e30, so a backward that
recomputes p = exp(s - lse) gets p = 0 there.

`flash_attention` launches the CUDA kernel (`csrc/flash_attn_fwd.cu`)
on a CUDA tensor, or raises — it never falls back. On a CPU tensor it
takes `attention_plain`, the straightforward masked softmax that states
the contract; the CPU tests use it and the chip smoke holds the kernel
against it on the card.
"""

from __future__ import annotations

import ctypes
import math

import torch

from paddle_tpu_torch.ops import _build

KERNEL = "flash_attn_fwd"
SUPPORTED_HEAD_DIMS = (32, 64, 128)
LSE_MASKED = 1e30

# kernel launches since the last reset (the chip smoke zeroes it just
# before driving the serving path and reads it just after)
launches = 0


def attention_plain(q, k, v, causal=False, kv_len=None, q_len=None,
                    scale=None):
    """The plain PyTorch version: masked softmax in f32 over the
    [B, H, Tq, Tk] scores. Same inputs and outputs as flash_attention."""
    B, Tq, H, D = q.shape
    Tk = k.shape[1]
    scale = float(scale) if scale is not None else 1.0 / math.sqrt(D)
    s = torch.einsum("bqhd,bkhd->bhqk", q.float(), k.float()) * scale
    qpos = torch.arange(Tq, device=q.device)[:, None]
    kpos = torch.arange(Tk, device=q.device)[None, :]
    valid = torch.ones((B, 1, Tq, Tk), dtype=torch.bool, device=q.device)
    if kv_len is not None:
        valid = valid & (kpos < kv_len.to(q.device).view(B, 1, 1, 1))
    if q_len is not None:
        valid = valid & (qpos < q_len.to(q.device).view(B, 1, 1, 1))
    if causal:
        valid = valid & (kpos <= qpos)
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


def _bind():
    lib = _build.load(KERNEL)
    fn = lib.flash_attn_fwd
    if fn.argtypes is None:
        p = ctypes.c_void_p
        fn.argtypes = [p, p, p, p, p, p, p] + [ctypes.c_int] * 6 + [
            ctypes.c_float, ctypes.c_int, p,
        ]
        fn.restype = ctypes.c_int
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


def flash_attention(q, k, v, causal=False, kv_len=None, q_len=None,
                    scale=None):
    """(out, lse) of masked attention; see the module docstring. A
    CUDA tensor goes through the Hopper kernel, a CPU tensor through
    attention_plain."""
    global launches
    if q.device.type == "cpu":
        return attention_plain(q, k, v, causal=causal, kv_len=kv_len,
                               q_len=q_len, scale=scale)
    if q.device.type != "cuda":
        raise ValueError(f"flash_attention: unsupported device {q.device}")
    B, Tq, H, D = q.shape
    Tk = k.shape[1]
    for name, x, t in (("q", q, Tq), ("k", k, Tk), ("v", v, Tk)):
        if (x.dtype != torch.float32 or x.device != q.device
                or tuple(x.shape) != (B, t, H, D)
                or not x.is_contiguous()):
            raise ValueError(
                f"flash_attention: {name} must be contiguous f32 "
                f"[{B},{t},{H},{D}] on {q.device}, got {x.dtype} "
                f"{tuple(x.shape)} on {x.device}"
            )
    if D not in SUPPORTED_HEAD_DIMS:
        raise ValueError(
            f"flash_attention: head dim {D} not in {SUPPORTED_HEAD_DIMS}"
        )
    kv_len = _check_lens(kv_len, B, "kv_len", q.device)
    q_len = _check_lens(q_len, B, "q_len", q.device)
    scale = float(scale) if scale is not None else 1.0 / math.sqrt(D)
    lib = _bind()
    out = torch.empty_like(q)
    lse = torch.empty((B, H, Tq), dtype=torch.float32, device=q.device)
    # the caller's thread may be a serving worker: launch on ITS
    # current stream of q's device
    stream = torch.cuda.current_stream(q.device).cuda_stream
    rc = lib.flash_attn_fwd(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
        lse.data_ptr(),
        kv_len.data_ptr() if kv_len is not None else None,
        q_len.data_ptr() if q_len is not None else None,
        B, Tq, Tk, H, D, int(bool(causal)), scale,
        q.device.index if q.device.index is not None
        else torch.cuda.current_device(),
        stream,
    )
    if rc != 0:
        msg = lib.flash_attn_error_string(rc).decode()
        raise RuntimeError(f"flash_attn_fwd launch failed: {msg} ({rc})")
    launches += 1
    return out, lse
