"""Flash attention forward and backward: the Hopper kernels, their plain
versions, the custom ops and the launch counters.

Replaces the TPU kernels behind `paddle_tpu/parallel/ring.py::
_pallas_flash` — the Pallas flash-attention forward and its two
backward calls (dkv and dq). The contract is the blocked oracle's,
`ring.py::_blocked_fwd` and `ring.py::_flash_blocked_bwd`:

- q [B, Tq, H, D], k and v [B, Tk, H, D], the JAX layout, all f32 or
  all bf16 (the JAX flash runs in q's dtype under the AMP rule; mixed
  dtypes raise, nothing is upcast);
- `causal` (key j visible to query i only when j <= i);
- optional `kv_len` [B] and `q_len` [B] int32: keys at or past
  kv_len[b] are masked, and a query row at or past q_len[b] sees no
  key at all;
- `scale`, default 1/sqrt(D);
- any head dim D: up to 128 the kernels instantiate D in
  KERNEL_HEAD_DIMS (the bf16 forms in BF16_KERNEL_HEAD_DIMS); above 128
  they run the D-split (`csrc/flash_dsplit.cuh`: a grid axis over
  chunks of the output's head dims, S recomputed over the whole D in
  each, the D > 128 forms with counters of their own; COUNTERS names
  all twelve)
  at any multiple of SPLIT_HEAD_DIM. `flash_attention` /
  `flash_attention_bwd` pad another D with zero columns of q, k, v (and
  dout) up to the next dim the kernels take (`kernel_head_dim`) and
  slice the padding off the results (zero columns add nothing to q.k
  and give zero columns of out, dq, dk and dv); `scale` stays that of
  the original D. The bf16 kernels' tiles are TMA boxes of 32 or 64
  columns, so a bf16 call at D = 96 runs at 128: a third more
  tensor-core work and bytes than D = 96 needs (no model of the repo
  uses 96);
- any `scale` (the bf16 kernels take the running max of q.k before
  scaling, so for a negative scale the wrapper hands them -q and -scale,
  which gives the same s exactly, and negates dq).

The forward returns (out [B, Tq, H, D] in q's dtype, lse [B, H, Tq]
f32). A row with no visible key gets out = 0 and lse = +1e30. The
backward takes (q, k, v, out, lse, dout) and returns (dq, dk, dv) with

    p     = exp(s * scale - lse), exactly 0 at masked pairs
    delta = sum_d dout * out                (per query row, f32)
    ds    = p * (dout . v - delta) * scale
    dq = ds @ k,  dk = ds^T @ q,  dv = p^T @ dout

so a row with no visible key has dq = 0 and adds nothing to dk, dv;
dq, dk and dv come back in q's dtype.

A padded query row of self-attention (q_len unset, i >= kv_len) still
sees the valid keys: its output is garbage the layer zeroes, its dout
is 0, and the backward treats it as any other row.

The bf16 forms keep the library kernel's roundings
(`jax/experimental/pallas/ops/tpu/flash_attention.py`), which
`attention_plain_bf16` / `attention_bwd_plain_bf16` state: every
product takes bf16 operands and sums in f32; p is rounded to bf16
before P.V and before dv = p^T.dout, ds before dk = ds^T.q and
dq = ds.k; m, l, lse and delta stay f32; out, dq, dk and dv are
rounded to bf16 once, at the end.

A CUDA tensor goes through the kernels (`csrc/flash_attn_fwd.cu`,
`csrc/flash_attn_bwd.cu`; f32 or bf16 entry points by q's dtype) or
the call raises — never a fallback. A CPU tensor goes through
`attention_plain` / `attention_bwd_plain` (bf16: the `_bf16` forms),
the straightforward versions that state the contract; the CPU tests
use them and the chip smoke holds the kernels against them on the
card.
The forward, dkv and dq are the custom ops `paddle_tpu_torch::
flash_attention_fwd`, `_bwd_dkv` and `_bwd_dq` (`ops/_library.py`):
the CUDA implementation launches the kernel, the CPU one runs the plain
version. The forward op's autograd formula calls the two backward ops;
`parallel/ring.py::flash_dense_attention` calls `flash_attention`.
"""

from __future__ import annotations

import ctypes
import functools
import math

import torch

from paddle_tpu_torch.ops import _build, _library

KERNEL = "flash_attn_fwd"
BWD_KERNEL = "flash_attn_bwd"
KERNEL_HEAD_DIMS = (32, 64, 96, 128)   # the dims the kernels instantiate
BF16_KERNEL_HEAD_DIMS = (32, 64, 128)  # ... their bf16 forms
SPLIT_HEAD_DIM = 64   # above 128: the D-split takes multiples of this
LSE_MASKED = 1e30

# kernel launches since the last reset, one counter per kernel and form
# (the chip smoke zeroes them just before driving a path and reads them
# just after)
launches = 0                # forward, f32
bwd_dkv_launches = 0        # backward, dk and dv, f32
bwd_dq_launches = 0         # backward, dq, f32
bf16_launches = 0           # forward, bf16
bwd_dkv_bf16_launches = 0   # backward, dk and dv, bf16
bwd_dq_bf16_launches = 0    # backward, dq, bf16
# ... and the D-split forms, at D > 128 (`csrc/flash_dsplit.cuh`)
dsplit_launches = 0               # forward, f32
bwd_dkv_dsplit_launches = 0       # backward, dk and dv, f32
bwd_dq_dsplit_launches = 0        # backward, dq, f32
dsplit_bf16_launches = 0          # forward, bf16
bwd_dkv_dsplit_bf16_launches = 0  # backward, dk and dv, bf16
bwd_dq_dsplit_bf16_launches = 0   # backward, dq, bf16
COUNTERS = ("launches", "bwd_dkv_launches", "bwd_dq_launches",
            "bf16_launches", "bwd_dkv_bf16_launches", "bwd_dq_bf16_launches",
            "dsplit_launches", "bwd_dkv_dsplit_launches",
            "bwd_dq_dsplit_launches", "dsplit_bf16_launches",
            "bwd_dkv_dsplit_bf16_launches", "bwd_dq_dsplit_bf16_launches")


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


def _attention(q, k, v, causal, kv_len, q_len, scale, bf16):
    """attention_plain (bf16=False) or attention_plain_bf16 (True)."""
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
    if bf16:
        p = _round_bf16(p)
    out = torch.einsum("bhqk,bkhd->bqhd", p, v.float())
    out = out / safe.permute(0, 2, 1)[..., None]
    lse = torch.where(alive, m + torch.log(safe),
                      torch.tensor(LSE_MASKED, device=q.device))
    return (out.to(q.dtype) if bf16 else out), lse


def _round_bf16(x):
    """x rounded to bf16 (to nearest even), kept in f32."""
    return x.to(torch.bfloat16).float()


def attention_plain(q, k, v, causal=False, kv_len=None, q_len=None,
                    scale=None):
    """The plain PyTorch forward: masked softmax in f32 over the
    [B, H, Tq, Tk] scores. Same inputs and outputs as flash_attention;
    out f32."""
    return _attention(q, k, v, causal, kv_len, q_len, scale, bf16=False)


def attention_plain_bf16(q, k, v, causal=False, kv_len=None, q_len=None,
                         scale=None):
    """The plain forward of the bf16 form, with the library kernel's
    roundings: s from the bf16 operands in f32, p = exp(s - m) in f32
    (its sum l too) rounded to bf16 before P.V, out summed in f32,
    divided by l and rounded to bf16; lse f32. The kernel rounds p
    against the running max, this version against the row's final
    one: the two agree to about a bf16 ulp of out, not bit for bit."""
    return _attention(q, k, v, causal, kv_len, q_len, scale, bf16=True)


def row_delta(dout, out):
    """delta [B, H, Tq] = sum_d dout * out, in f32 whatever the inputs'
    dtype (a bf16 delta would cancel badly in dp - delta)."""
    return torch.einsum("bqhd,bqhd->bhq", dout.float(),
                        out.float()).contiguous()


def _attention_bwd(q, k, v, out, lse, dout, causal, kv_len, q_len, scale,
                   bf16):
    """attention_bwd_plain (bf16=False) or attention_bwd_plain_bf16."""
    return _attention_bwd_delta(q, k, v, lse, row_delta(dout, out), dout,
                                causal, kv_len, q_len, scale, bf16)


def _attention_bwd_delta(q, k, v, lse, delta, dout, causal, kv_len, q_len,
                         scale, bf16, want=("dq", "dk", "dv")):
    """The plain backward from delta = row_delta(dout, out): the
    gradients named in `want`, in that order (f32; bf16 when bf16)."""
    B, Tq, H, D = q.shape
    Tk = k.shape[1]
    scale = _scale(scale, D)
    qf, kf, vf, dof = q.float(), k.float(), v.float(), dout.float()
    s = torch.einsum("bqhd,bkhd->bhqk", qf, kf) * scale
    valid = _visible(B, Tq, Tk, causal, kv_len, q_len, q.device)
    p = torch.where(valid, torch.exp(s - lse[..., None]), 0.0)
    dp = torch.einsum("bqhd,bkhd->bhqk", dof, vf)
    ds = p * (dp - delta[..., None]) * scale
    if bf16:
        p, ds = _round_bf16(p), _round_bf16(ds)
    grads = {
        "dq": lambda: torch.einsum("bhqk,bkhd->bqhd", ds, kf),
        "dk": lambda: torch.einsum("bhqk,bqhd->bkhd", ds, qf),
        "dv": lambda: torch.einsum("bhqk,bqhd->bkhd", p, dof),
    }
    return tuple(grads[g]().to(q.dtype) if bf16 else grads[g]()
                 for g in want)


def attention_bwd_plain(q, k, v, out, lse, dout, causal=False,
                        kv_len=None, q_len=None, scale=None):
    """The plain PyTorch backward: recomputes p from lse over the
    [B, H, Tq, Tk] scores. Returns (dq, dk, dv) f32; see the module
    docstring for the contract."""
    return _attention_bwd(q, k, v, out, lse, dout, causal, kv_len, q_len,
                          scale, bf16=False)


def attention_bwd_plain_bf16(q, k, v, out, lse, dout, causal=False,
                             kv_len=None, q_len=None, scale=None):
    """The plain backward of the bf16 form, with the library kernels'
    roundings: s and dp = dout.v^T from the bf16 operands in f32, p =
    exp(s * scale - lse) and delta = sum_d dout * out in f32, ds = p *
    (dp - delta) * scale in f32; p rounded to bf16 before dv = p^T.dout,
    ds before dk = ds^T.q and dq = ds.k, each summed in f32 and rounded
    to bf16 at the end."""
    return _attention_bwd(q, k, v, out, lse, dout, causal, kv_len, q_len,
                          scale, bf16=True)


def _bind(name):
    lib = _build.load(name)
    p = ctypes.c_void_p
    i = ctypes.c_int
    if name == KERNEL:
        fwd = [p] * 7 + [i] * 6 + [ctypes.c_float, i, p]
        fns = {"flash_attn_fwd": fwd, "flash_attn_fwd_bf16": fwd}
    else:
        dkv = [p] * 10 + [i] * 6 + [ctypes.c_float, i, p]
        dq = [p] * 9 + [i] * 6 + [ctypes.c_float, i, p]
        fns = {"flash_attn_bwd_dkv": dkv, "flash_attn_bwd_dq": dq,
               "flash_attn_bwd_dkv_bf16": dkv, "flash_attn_bwd_dq_bf16": dq}
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


def kernel_head_dim(D, dims=KERNEL_HEAD_DIMS):
    """The head dim the kernels run a call of head dim D at: the
    smallest of `dims` (KERNEL_HEAD_DIMS, or BF16_KERNEL_HEAD_DIMS for
    the bf16 forms) that is >= D; above them the D-split's, D rounded up
    to a multiple of SPLIT_HEAD_DIM."""
    for d in dims:
        if D <= d:
            return d
    return -(-D // SPLIT_HEAD_DIM) * SPLIT_HEAD_DIM


def is_split(D):
    """Whether the kernels run head dim D (as padded) as a D-split."""
    return D > KERNEL_HEAD_DIMS[-1]


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


def _one_dtype(where, **tensors):
    """The dtype every tensor of a call shares; mixed dtypes raise
    (nothing is upcast)."""
    dtypes = {x.dtype for x in tensors.values()}
    if len(dtypes) != 1:
        raise ValueError(
            f"{where}: q, k, v (and out, dout) must share one dtype, got "
            + ", ".join(f"{n} {x.dtype}" for n, x in tensors.items()))
    return dtypes.pop()


def _head_dims(dtype):
    """The head dims the kernels of `dtype` instantiate."""
    return BF16_KERNEL_HEAD_DIMS if dtype == torch.bfloat16 else \
        KERNEL_HEAD_DIMS


def _check_cuda(where, q, tensors, kernel_dims=True):
    """Validate the kernels' inputs on a CUDA device: every tensor
    contiguous, of q's dtype (f32 or bf16) and shape; returns the dims
    (B, Tq, Tk, H, D). With kernel_dims D must be one the kernels of q's
    dtype take (`_head_dims`, or a multiple of SPLIT_HEAD_DIM above
    them); without, any D (the caller pads it)."""
    if q.device.type != "cuda":
        raise ValueError(f"{where}: unsupported device {q.device}")
    if q.dtype not in (torch.float32, torch.bfloat16):
        raise ValueError(f"{where}: the flash kernels take f32 or bf16, "
                         f"got {q.dtype}")
    B, Tq, H, D = q.shape
    Tk = tensors["k"].shape[1]
    for name, x in tensors.items():
        t = Tk if name in ("k", "v") else Tq
        if (x.dtype != q.dtype or x.device != q.device
                or tuple(x.shape) != (B, t, H, D)
                or not x.is_contiguous()):
            raise ValueError(
                f"{where}: {name} must be contiguous {q.dtype} "
                f"[{B},{t},{H},{D}] on {q.device}, got {x.dtype} "
                f"{tuple(x.shape)} on {x.device}"
            )
    if kernel_dims and kernel_head_dim(D, _head_dims(q.dtype)) != D:
        raise ValueError(f"{where}: head dim {D} not in "
                         f"{_head_dims(q.dtype)} nor a multiple of "
                         f"{SPLIT_HEAD_DIM} above them (flash_attention "
                         f"pads other dims)")
    return B, Tq, Tk, H, D


def _positive_scale(q, scale):
    """(q, scale, flipped): a bf16 q with a negative scale becomes -q
    and -scale (the same s = q.k * scale exactly; the bf16 kernels take
    the running max of q.k before scaling), and flipped says dq must
    be negated."""
    if q.dtype == torch.bfloat16 and scale < 0:
        return -q, -scale, True
    return q, scale, False


def _launch(lib, fn, *args):
    _build.launch(lib, fn, "flash_attn_error_string", *args)


def _fwd_cuda(q, k, v, causal, kv_len, q_len, scale):
    """The forward op's CUDA implementation: the Hopper kernel of q's
    dtype, any D padded to the kernels' head dims (the D-split above
    128)."""
    global launches, bf16_launches, dsplit_launches, dsplit_bf16_launches
    bf16 = _one_dtype("flash_attention", q=q, k=k, v=v) == torch.bfloat16
    B, Tq, Tk, H, D = _check_cuda("flash_attention", q,
                                  {"q": q, "k": k, "v": v},
                                  kernel_dims=False)
    kv_len = _check_lens(kv_len, B, "kv_len", q.device)
    q_len = _check_lens(q_len, B, "q_len", q.device)
    scale = _scale(scale, D)
    dk = kernel_head_dim(D, _head_dims(q.dtype))
    q, k, v = (_aligned(pad_head_dim(x, dk)) for x in (q, k, v))
    q, scale, _ = _positive_scale(q, scale)
    lib = _bind(KERNEL)
    out = torch.empty_like(q)
    lse = torch.empty((B, H, Tq), dtype=torch.float32, device=q.device)
    _launch(lib, "flash_attn_fwd_bf16" if bf16 else "flash_attn_fwd",
            q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
            lse.data_ptr(), _build.ptr(kv_len), _build.ptr(q_len), B, Tq,
            Tk, H, dk, int(bool(causal)), scale,
            *_build.device_and_stream(q))
    if is_split(dk):
        if bf16:
            dsplit_bf16_launches += 1
        else:
            dsplit_launches += 1
    elif bf16:
        bf16_launches += 1
    else:
        launches += 1
    return (out if dk == D else out[..., :D].contiguous()), lse


def _fwd_cpu(q, k, v, causal, kv_len, q_len, scale):
    bf16 = _one_dtype("flash_attention", q=q, k=k, v=v) == torch.bfloat16
    plain = attention_plain_bf16 if bf16 else attention_plain
    out, lse = plain(q, k, v, causal=causal, kv_len=kv_len, q_len=q_len,
                     scale=scale)
    return out.contiguous(), lse


def _fwd_fake(q, k, v, causal, kv_len, q_len, scale):
    _one_dtype("flash_attention", q=q, k=k, v=v)
    B, Tq, H, D = q.shape
    return q.new_empty(q.shape), q.new_empty((B, H, Tq), dtype=torch.float32)


def _check_rows(where, name, x, B, H, Tq, device):
    if (x.dtype != torch.float32 or tuple(x.shape) != (B, H, Tq)
            or x.device != device or not x.is_contiguous()):
        raise ValueError(
            f"{where}: {name} must be contiguous f32 [{B},{H},{Tq}] on "
            f"{device}, got {x.dtype} {tuple(x.shape)} on {x.device}"
        )


def _bwd_launch_args(where, q, k, v, dout, lse, delta, causal, kv_len,
                     q_len, scale):
    """Validate one backward kernel's inputs; returns (lib, q, lens,
    dims, flipped) where q is what the kernel takes (`_positive_scale`),
    dims the trailing int/float/stream arguments and flipped whether dq
    must be negated."""
    B, Tq, Tk, H, D = _check_cuda(where, q,
                                  {"q": q, "k": k, "v": v, "dout": dout})
    _check_rows(where, "lse", lse, B, H, Tq, q.device)
    _check_rows(where, "delta", delta, B, H, Tq, q.device)
    kv_len = _check_lens(kv_len, B, "kv_len", q.device)
    q_len = _check_lens(q_len, B, "q_len", q.device)
    q, scale, flipped = _positive_scale(q, _scale(scale, D))
    dims = (B, Tq, Tk, H, D, int(bool(causal)), scale,
            *_build.device_and_stream(q))
    return (_bind(BWD_KERNEL), q, (_build.ptr(kv_len), _build.ptr(q_len)),
            dims, flipped)


def flash_attention_bwd_dkv(q, k, v, dout, lse, delta, causal=False,
                            kv_len=None, q_len=None, scale=None):
    """(dk, dv) from the dkv kernel of q's dtype (CUDA tensors only);
    `delta` is sum_d dout * out, [B, H, Tq] f32."""
    global bwd_dkv_launches, bwd_dkv_bf16_launches
    global bwd_dkv_dsplit_launches, bwd_dkv_dsplit_bf16_launches
    lib, q, lens, dims, _ = _bwd_launch_args(
        "flash_attention_bwd_dkv", q, k, v, dout, lse, delta, causal,
        kv_len, q_len, scale)
    bf16 = q.dtype == torch.bfloat16
    fn = "flash_attn_bwd_dkv_bf16" if bf16 else "flash_attn_bwd_dkv"
    dk = torch.empty_like(k)
    dv = torch.empty_like(v)
    _launch(lib, fn, q.data_ptr(), k.data_ptr(), v.data_ptr(),
            dout.data_ptr(), lse.data_ptr(), delta.data_ptr(),
            dk.data_ptr(), dv.data_ptr(), *lens, *dims)
    if is_split(q.shape[-1]):
        if bf16:
            bwd_dkv_dsplit_bf16_launches += 1
        else:
            bwd_dkv_dsplit_launches += 1
    elif bf16:
        bwd_dkv_bf16_launches += 1
    else:
        bwd_dkv_launches += 1
    return dk, dv


def flash_attention_bwd_dq(q, k, v, dout, lse, delta, causal=False,
                           kv_len=None, q_len=None, scale=None):
    """dq from the dq kernel of q's dtype (CUDA tensors only)."""
    global bwd_dq_launches, bwd_dq_bf16_launches
    global bwd_dq_dsplit_launches, bwd_dq_dsplit_bf16_launches
    lib, q, lens, dims, flipped = _bwd_launch_args(
        "flash_attention_bwd_dq", q, k, v, dout, lse, delta, causal,
        kv_len, q_len, scale)
    bf16 = q.dtype == torch.bfloat16
    fn = "flash_attn_bwd_dq_bf16" if bf16 else "flash_attn_bwd_dq"
    dq = torch.empty_like(q)
    _launch(lib, fn, q.data_ptr(), k.data_ptr(), v.data_ptr(),
            dout.data_ptr(), lse.data_ptr(), delta.data_ptr(),
            dq.data_ptr(), *lens, *dims)
    if is_split(q.shape[-1]):
        if bf16:
            bwd_dq_dsplit_bf16_launches += 1
        else:
            bwd_dq_dsplit_launches += 1
    elif bf16:
        bwd_dq_bf16_launches += 1
    else:
        bwd_dq_launches += 1
    return -dq if flipped else dq


def _bwd_cuda(which, q, k, v, dout, lse, delta, causal, kv_len, q_len,
              scale):
    """The backward ops' CUDA implementation: the dkv or dq kernel of
    q's dtype, any D padded to the kernels' head dims (the D-split above
    128)."""
    _one_dtype(f"flash_attention_bwd_{which}", q=q, k=k, v=v, dout=dout)
    D = _check_cuda(f"flash_attention_bwd_{which}", q,
                    {"q": q, "dout": dout, "k": k}, kernel_dims=False)[-1]
    kw = dict(causal=causal, kv_len=kv_len, q_len=q_len,
              scale=_scale(scale, D))
    d_k = kernel_head_dim(D, _head_dims(q.dtype))
    q, k, v, dout = (_aligned(pad_head_dim(x, d_k)) for x in (q, k, v, dout))
    if which == "dkv":
        grads = flash_attention_bwd_dkv(q, k, v, dout, lse, delta, **kw)
    else:
        grads = (flash_attention_bwd_dq(q, k, v, dout, lse, delta, **kw),)
    if d_k != D:
        grads = tuple(x[..., :D].contiguous() for x in grads)
    return grads if which == "dkv" else grads[0]


def _bwd_cpu(which, q, k, v, dout, lse, delta, causal, kv_len, q_len,
             scale):
    bf16 = _one_dtype(f"flash_attention_bwd_{which}", q=q, k=k, v=v,
                      dout=dout) == torch.bfloat16
    want = ("dk", "dv") if which == "dkv" else ("dq",)
    grads = tuple(g.contiguous() for g in _attention_bwd_delta(
        q, k, v, lse, delta, dout, causal, kv_len, q_len, scale, bf16, want))
    return grads if which == "dkv" else grads[0]


_ATTN = "Tensor q, Tensor k, Tensor v"
_MASKS = "bool causal, Tensor? kv_len, Tensor? q_len, float? scale"
fwd_op = _library.define(
    "flash_attention_fwd", f"({_ATTN}, {_MASKS}) -> (Tensor, Tensor)",
    _fwd_cuda, _fwd_cpu, _fwd_fake)
bwd_dkv_op = _library.define(
    "flash_attention_bwd_dkv",
    f"({_ATTN}, Tensor dout, Tensor lse, Tensor delta, {_MASKS}) -> "
    "(Tensor, Tensor)",
    functools.partial(_bwd_cuda, "dkv"), functools.partial(_bwd_cpu, "dkv"),
    lambda q, k, v, *_: (k.new_empty(k.shape), v.new_empty(v.shape)))
bwd_dq_op = _library.define(
    "flash_attention_bwd_dq",
    f"({_ATTN}, Tensor dout, Tensor lse, Tensor delta, {_MASKS}) -> Tensor",
    functools.partial(_bwd_cuda, "dq"), functools.partial(_bwd_cpu, "dq"),
    lambda q, *_: q.new_empty(q.shape))


def flash_attention(q, k, v, causal=False, kv_len=None, q_len=None,
                    scale=None):
    """(out, lse) of masked attention; see the module docstring. The op
    `paddle_tpu_torch::flash_attention_fwd`: a CUDA tensor goes through
    the Hopper kernel of its dtype (f32 or bf16), a CPU tensor through
    attention_plain (bf16: attention_plain_bf16). Differentiable in q, k
    and v through `flash_attention_bwd`'s two ops."""
    return fwd_op(q, k, v, bool(causal), kv_len, q_len,
                  None if scale is None else float(scale))


def flash_attention_bwd(q, k, v, out, lse, dout, causal=False,
                        kv_len=None, q_len=None, scale=None):
    """(dq, dk, dv) of masked attention from the forward's out and lse;
    see the module docstring. The ops `paddle_tpu_torch::
    flash_attention_bwd_dkv`, then `_bwd_dq`: on a CUDA tensor the two
    Hopper kernels of its dtype, on a CPU tensor the plain backward
    (bf16: attention_bwd_plain_bf16's roundings). delta, the
    softmax-jacobian row term, is a plain f32 reduction outside them, as
    in the JAX package (the library computes it outside its kernels
    too)."""
    _one_dtype("flash_attention_bwd", q=q, k=k, v=v, out=out, dout=dout)
    delta = row_delta(dout, out)
    args = (q, k, v, dout, lse, delta, bool(causal), kv_len, q_len,
            None if scale is None else float(scale))
    dk, dv = bwd_dkv_op(*args)
    return bwd_dq_op(*args), dk, dv


def _setup(ctx, inputs, output):
    q, k, v, causal, kv_len, q_len, scale = inputs
    ctx.save_for_backward(q, k, v, output[0], output[1], kv_len, q_len)
    ctx.causal, ctx.scale = causal, scale


def _backward(ctx, dout, _dlse):
    """p recomputed from lse; lse's cotangent is not used (the layers
    read only out)."""
    q, k, v, out, lse, kv_len, q_len = ctx.saved_tensors
    dq, dk, dv = flash_attention_bwd(q, k, v, out, lse, dout.contiguous(),
                                     ctx.causal, kv_len, q_len, ctx.scale)
    return dq, dk, dv, None, None, None, None


_library.register_autograd(fwd_op, _backward, _setup)
