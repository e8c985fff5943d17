"""Fused BN -> ReLU -> 1x1-conv GEMM with a statistics epilogue: the
Hopper kernels, their plain versions, the custom ops and the launch
counters.

Replaces the TPU kernels of `paddle_tpu/ops/pallas_fused.py` — B1
`_fwd_kernel`, B2 `_bwd_dx_kernel` and B3 `_bwd_dw_kernel` — with the
contract of its `bn_act_conv1x1`:

    z    = act(u * scale + shift [+ residual])    (never stored)
    y    = z @ w                                   f32 accumulation
    ssum = sum_n y,  ssq = sum_n y * y             the next BN's statistics

u [N, Cin], scale and shift [Cin] (the previous BN folded to an affine;
ones and zeros for a plain conv), w [Cin, Cout], residual [N, Cin] or
None, act "relu" or "". Returns y [N, Cout], ssum and ssq [Cout]. Its
gradient, from the cotangents (dy, d1, d2) of (y, ssum, ssq):

    dy_eff = dy + d1 + 2 * y * d2
    dz     = (dy_eff @ w^T) * (pre > 0 under relu),  pre = u*scale+shift[+res]
    du = dz * scale,  dres = dz,  dscale = sum_n dz * u,  dshift = sum_n dz
    dw = z^T @ dy_eff

Two forms of each kernel, chosen by u's dtype, with the JAX kernels'
dtypes (`pallas_fused.py`):

- f32: u, w, residual, y, dy f32; the products at f32 accuracy (3xTF32).
- bf16 (the AMP rule): u, w, residual, y and dy bf16; scale, shift, d1
  and d2 f32. z and dy_eff are formed in f32 and rounded to bf16 for the
  products, which accumulate in f32; ssum and ssq come from that f32 y
  before it is rounded to bf16; du and dres come out bf16, dscale and
  dshift f32; dw accumulates in f32 (the kernel's output) and the
  autograd formula casts it to w's dtype. Cin and Cout must be multiples of 8
  and every tensor 16-byte aligned (the kernels read and write them by
  TMA: Hopper kernels with wgmma, `fwd_wgmma_kernel`,
  `bwd_dx_wgmma_kernel` and `bwd_dw_wgmma_kernel`).

No other dtype, and no upcast: a CUDA input of another dtype raises.

A CUDA tensor goes through the kernels of `csrc/bn_act_conv1x1.cu` or
the call raises — never a fallback. A CPU tensor goes through
`bn_act_conv1x1_plain`, `bn_act_conv1x1_bwd_dx_plain` and
`bn_act_conv1x1_bwd_dw_plain`, the straightforward versions that state
the contract; the CPU tests use them and the chip smoke holds the
kernels against them on the card. The three are the custom ops
`paddle_tpu_torch::bn_act_conv1x1_fwd`, `_bwd_dx` and `_bwd_dw`
(`ops/_library.py`): the CUDA implementation launches the kernel, the
CPU one runs the plain version. The forward op's autograd formula calls
the two backward ops; `bn_act_conv1x1` is the entry `layers/fused.py`
calls.
"""

from __future__ import annotations

import ctypes

import torch

from paddle_tpu_torch.ops import _build, _library

KERNEL = "bn_act_conv1x1"
ACTS = ("relu", "")

# kernel launches since the last reset, one counter per kernel and
# dtype (the chip smoke zeroes them just before driving a path and reads
# them just after)
fwd_launches = 0      # B1 f32: y, ssum, ssq
bwd_dx_launches = 0   # B2 f32: du, dres, dscale, dshift
bwd_dw_launches = 0   # B3 f32: dw
fwd_bf16_launches = 0     # B1 bf16 (fwd_wgmma_kernel)
bwd_dx_bf16_launches = 0  # B2 bf16 (bwd_dx_wgmma_kernel)
bwd_dw_bf16_launches = 0  # B3 bf16 (bwd_dw_wgmma_kernel)
DTYPES = (torch.float32, torch.bfloat16)

# scratch kinds of bn_act_conv1x1_scratch_floats (csrc)
_FWD, _BWD_DX, _BWD_DW = 0, 1, 2


# ---------------------------------------------------------------- plain
# Every plain version computes in f32 and returns the dtypes of the
# contract. For bf16 each GEMM operand is rounded to bf16 and the
# product taken in f32 (products of bf16 values are exact in f32): bf16
# operands, f32 accumulation, as the kernels. A bf16 @ bf16 would round
# y before the statistics, which is another function.
def _gemm(a, b, dtype):
    """a @ b in f32, each operand rounded to `dtype` first."""
    if dtype != torch.float32:
        a, b = a.to(dtype).float(), b.to(dtype).float()
    return a @ b


def _pre(u, scale, shift, residual):
    pre = u.float() * scale + shift
    return pre if residual is None else pre + residual.float()


def _z(u, scale, shift, residual, act):
    z = _pre(u, scale, shift, residual)
    return torch.clamp_min(z, 0.0) if act == "relu" else z


def bn_act_conv1x1_plain(u, scale, shift, w, residual=None, act="relu"):
    """The plain PyTorch forward: (y in u's dtype, ssum, ssq f32) of the
    contract, the sums taken from the f32 y."""
    y = _gemm(_z(u, scale, shift, residual, act), w, u.dtype)
    return y.to(u.dtype), y.sum(dim=0), (y * y).sum(dim=0)


def _dy_eff(y, dy, d1, d2):
    return dy.float() + d1 + 2.0 * y.float() * d2


def bn_act_conv1x1_bwd_dx_plain(u, scale, shift, w, residual, y, dy, d1,
                                d2, act="relu"):
    """The plain B2: (du, dscale, dshift, dres), du and dres in u's
    dtype, dscale and dshift f32; dres is None without a residual."""
    dz = _gemm(_dy_eff(y, dy, d1, d2), w.t(), u.dtype)
    if act == "relu":
        dz = dz * (_pre(u, scale, shift, residual) > 0)
    return ((dz * scale).to(u.dtype), (dz * u.float()).sum(dim=0),
            dz.sum(dim=0), None if residual is None else dz.to(u.dtype))


def bn_act_conv1x1_bwd_dw_plain(u, scale, shift, residual, y, dy, d1, d2,
                                act="relu"):
    """The plain B3: dw [Cin, Cout], f32."""
    return _gemm(_z(u, scale, shift, residual, act).t(),
                 _dy_eff(y, dy, d1, d2), u.dtype)


# --------------------------------------------------------------- kernels
def _bind():
    lib = _build.load(KERNEL)
    p, i = ctypes.c_void_p, ctypes.c_int
    fns = {
        "bn_act_conv1x1_fwd": [p] * 9 + [i] * 5 + [p],
        "bn_act_conv1x1_bwd_dx": [p] * 14 + [i] * 5 + [p],
        "bn_act_conv1x1_bwd_dw": [p] * 10 + [i] * 5 + [p],
    }
    for sfx in ("", "_bf16"):   # the f32 and the bf16 forms
        for fn, argtypes in fns.items():
            f = getattr(lib, fn + sfx)
            if f.argtypes is None:
                f.argtypes = argtypes
                f.restype = ctypes.c_int
        f = getattr(lib, "bn_act_conv1x1_scratch_floats" + sfx)
        f.argtypes, f.restype = [i] * 4, ctypes.c_longlong
        f = getattr(lib, "bn_act_conv1x1_plan" + sfx)
        f.argtypes = [i] * 5 + [ctypes.POINTER(ctypes.c_longlong)]
        f.restype = None
    lib.bn_act_conv1x1_error_string.argtypes = [i]
    lib.bn_act_conv1x1_error_string.restype = ctypes.c_char_p
    return lib


def _suffix(dtype):
    """The C entry points' suffix for the kernels of `dtype`."""
    return "_bf16" if dtype == torch.bfloat16 else ""


def launch_plan(n, cin, cout, residual=False, dtype=torch.float32):
    """B1's, B2's and B3's launches at these widths and dtype, for
    reports: {"fwd", "bwd_dx" or "bwd_dw": {"tile", "blocks",
    "smem_bytes"}} (the tile in rows or Cin by columns, the dynamic
    shared memory a block); "fwd" also has "flush", the stages between
    B1's flushes of its accumulators into f32 sums (0: none), and
    "bwd_dw" "chunk", the rows of one of B3's splits."""
    lib = _bind()
    plan = getattr(lib, "bn_act_conv1x1_plan" + _suffix(dtype))
    out = (ctypes.c_longlong * 5)()
    plans = {}
    for name, kind in (("fwd", _FWD), ("bwd_dx", _BWD_DX),
                       ("bwd_dw", _BWD_DW)):
        plan(kind, n, cin, cout, int(residual), out)
        plans[name] = {"tile": [out[0], out[1]], "blocks": out[2],
                       "smem_bytes": out[3]}
        if kind == _FWD:
            plans[name]["flush"] = out[4]
        elif kind == _BWD_DW:
            plans[name]["chunk"] = out[4]
    return plans


_SHAPES = {   # name -> its shape in (N, Cin, Cout)
    "u": "nc", "residual": "nc", "scale": "c", "shift": "c", "w": "co",
    "y": "no", "dy": "no", "d1": "o", "d2": "o",
}
_F32_ALWAYS = ("scale", "shift", "d1", "d2")


def _check(where, act, u, other, **tensors):
    """Validate the kernels' inputs; returns (N, Cin, Cout), read from
    u [N, Cin] and the last dim of `other` (w or y). u is f32 or bf16;
    u, residual, w, y and dy share its dtype, the per-channel vectors
    are f32. bf16 also needs Cin and Cout multiples of 8 and 16-byte
    aligned data."""
    if u.device.type != "cuda":
        raise ValueError(f"{where}: unsupported device {u.device}")
    if act not in ACTS:
        raise ValueError(f"{where}: act must be one of {ACTS}, got {act!r}")
    if u.dtype not in DTYPES:
        raise ValueError(f"{where}: u must be f32 or bf16, got {u.dtype}")
    if u.dim() != 2 or other.dim() != 2:
        raise ValueError(f"{where}: u and w/y must be 2-D, got "
                         f"{tuple(u.shape)} and {tuple(other.shape)}")
    dims = {"n": u.shape[0], "c": u.shape[1], "o": other.shape[1]}
    if min(dims.values()) == 0:
        raise ValueError(f"{where}: empty input {dims}")
    bf16 = u.dtype == torch.bfloat16
    if bf16 and (dims["c"] % 8 or dims["o"] % 8):
        raise ValueError(f"{where}: the bf16 kernels take Cin and Cout "
                         f"multiples of 8, got {dims['c']} and {dims['o']}")
    for name, x in {"u": u, **tensors}.items():
        if x is None:
            continue
        shape = tuple(dims[d] for d in _SHAPES[name])
        dtype = torch.float32 if name in _F32_ALWAYS else u.dtype
        if (x.dtype != dtype or x.device != u.device
                or tuple(x.shape) != shape or not x.is_contiguous()):
            raise ValueError(
                f"{where}: {name} must be a contiguous {dtype} "
                f"{list(shape)} tensor on {u.device}, got {x.dtype} "
                f"{tuple(x.shape)} on {x.device}"
                f"{'' if x.is_contiguous() else ' (strided)'}")
        if bf16 and x.data_ptr() % 16:
            raise ValueError(f"{where}: {name} must be 16-byte aligned "
                             f"for the bf16 kernels")
    return dims["n"], dims["c"], dims["o"]


def _launch(lib, fn, *args):
    _build.launch(lib, fn, "bn_act_conv1x1_error_string", *args)


def _scratch(lib, kind, n, cin, cout, device, dtype):
    floats = getattr(lib, "bn_act_conv1x1_scratch_floats" + _suffix(dtype))(
        kind, n, cin, cout)
    return torch.empty((max(floats, 1),), dtype=torch.float32, device=device)


def bn_act_conv1x1_fwd(u, scale, shift, w, residual=None, act="relu"):
    """B1 on the card, the form of u's dtype: (y in u's dtype, ssum,
    ssq f32) of the contract."""
    global fwd_launches, fwd_bf16_launches
    n, cin, cout = _check("bn_act_conv1x1_fwd", act, u, w, scale=scale,
                          shift=shift, w=w, residual=residual)
    lib = _bind()
    y = torch.empty((n, cout), dtype=u.dtype, device=u.device)
    ssum = torch.empty((cout,), dtype=torch.float32, device=u.device)
    ssq = torch.empty((cout,), dtype=torch.float32, device=u.device)
    scratch = _scratch(lib, _FWD, n, cin, cout, u.device, u.dtype)
    _launch(lib, "bn_act_conv1x1_fwd" + _suffix(u.dtype), u.data_ptr(),
            scale.data_ptr(), shift.data_ptr(), w.data_ptr(),
            _build.ptr(residual), y.data_ptr(), ssum.data_ptr(),
            ssq.data_ptr(), scratch.data_ptr(), n, cin, cout,
            int(act == "relu"), *_build.device_and_stream(u))
    if u.dtype == torch.bfloat16:
        fwd_bf16_launches += 1
    else:
        fwd_launches += 1
    return y, ssum, ssq


def bn_act_conv1x1_bwd_dx(u, scale, shift, w, residual, y, dy, d1, d2,
                          act="relu"):
    """B2 on the card, the form of u's dtype: (du, dscale, dshift,
    dres), du and dres in u's dtype; dres is None without a residual."""
    global bwd_dx_launches, bwd_dx_bf16_launches
    n, cin, cout = _check("bn_act_conv1x1_bwd_dx", act, u, w, scale=scale,
                          shift=shift, w=w, residual=residual, y=y, dy=dy,
                          d1=d1, d2=d2)
    lib = _bind()
    dev = u.device
    du = torch.empty((n, cin), dtype=u.dtype, device=dev)
    dres = (torch.empty((n, cin), dtype=u.dtype, device=dev)
            if residual is not None else None)
    dscale = torch.empty((cin,), dtype=torch.float32, device=dev)
    dshift = torch.empty((cin,), dtype=torch.float32, device=dev)
    scratch = _scratch(lib, _BWD_DX, n, cin, cout, dev, u.dtype)
    _launch(lib, "bn_act_conv1x1_bwd_dx" + _suffix(u.dtype), u.data_ptr(),
            scale.data_ptr(), shift.data_ptr(), w.data_ptr(),
            _build.ptr(residual), y.data_ptr(), dy.data_ptr(),
            d1.data_ptr(), d2.data_ptr(), du.data_ptr(), _build.ptr(dres),
            dscale.data_ptr(), dshift.data_ptr(), scratch.data_ptr(), n,
            cin, cout, int(act == "relu"), *_build.device_and_stream(u))
    if u.dtype == torch.bfloat16:
        bwd_dx_bf16_launches += 1
    else:
        bwd_dx_launches += 1
    return du, dscale, dshift, dres


def bn_act_conv1x1_bwd_dw(u, scale, shift, residual, y, dy, d1, d2,
                          act="relu"):
    """B3 on the card, the form of u's dtype: dw [Cin, Cout], f32 (the
    bf16 form's f32 accumulation, before any cast)."""
    global bwd_dw_launches, bwd_dw_bf16_launches
    n, cin, cout = _check("bn_act_conv1x1_bwd_dw", act, u, y, scale=scale,
                          shift=shift, residual=residual, y=y, dy=dy, d1=d1,
                          d2=d2)
    lib = _bind()
    dw = torch.empty((cin, cout), dtype=torch.float32, device=u.device)
    scratch = _scratch(lib, _BWD_DW, n, cin, cout, u.device, u.dtype)
    _launch(lib, "bn_act_conv1x1_bwd_dw" + _suffix(u.dtype), u.data_ptr(),
            scale.data_ptr(), shift.data_ptr(), _build.ptr(residual),
            y.data_ptr(), dy.data_ptr(), d1.data_ptr(), d2.data_ptr(),
            dw.data_ptr(), scratch.data_ptr(), n, cin, cout,
            int(act == "relu"), *_build.device_and_stream(u))
    if u.dtype == torch.bfloat16:
        bwd_dw_bf16_launches += 1
    else:
        bwd_dw_launches += 1
    return dw


# ------------------------------------------------------------ custom ops
def _dims(u, w_or_y, act):
    """(N, Cin, Cout) from u [N, Cin] and w [Cin, Cout] (or y [N,
    Cout]), with the shape rules the kernels' launch plans take: act
    known, 2-D, nothing empty; bf16 widths multiples of 8."""
    if act not in ACTS:
        raise ValueError(f"act must be one of {ACTS}, got {act!r}")
    if u.dim() != 2 or w_or_y.dim() != 2:
        raise ValueError(f"u and w/y must be 2-D, got {tuple(u.shape)} and "
                         f"{tuple(w_or_y.shape)}")
    n, cin, cout = u.shape[0], u.shape[1], w_or_y.shape[1]
    if u.dtype == torch.bfloat16 and (cin % 8 or cout % 8):
        raise ValueError(f"the bf16 kernels take Cin and Cout multiples of "
                         f"8, got {cin} and {cout}")
    return n, cin, cout


def _no_dres(u):
    """The op's dres where there is no residual: an empty tensor."""
    return u.new_empty((0,))


def _fwd_fake(u, scale, shift, w, residual, act):
    n, _cin, cout = _dims(u, w, act)
    return (u.new_empty((n, cout)),
            u.new_empty((cout,), dtype=torch.float32),
            u.new_empty((cout,), dtype=torch.float32))


def _bwd_dx_cuda(u, scale, shift, w, residual, y, dy, d1, d2, act):
    du, dscale, dshift, dres = bn_act_conv1x1_bwd_dx(
        u, scale, shift, w, residual, y, dy, d1, d2, act)
    return du, dscale, dshift, _no_dres(u) if dres is None else dres


def _bwd_dx_cpu(u, scale, shift, w, residual, y, dy, d1, d2, act):
    du, dscale, dshift, dres = bn_act_conv1x1_bwd_dx_plain(
        u, scale, shift, w, residual, y, dy, d1, d2, act)
    return du, dscale, dshift, _no_dres(u) if dres is None else dres


def _bwd_dx_fake(u, scale, shift, w, residual, y, dy, d1, d2, act):
    n, cin, _cout = _dims(u, w, act)
    return (u.new_empty((n, cin)),
            u.new_empty((cin,), dtype=torch.float32),
            u.new_empty((cin,), dtype=torch.float32),
            _no_dres(u) if residual is None else u.new_empty((n, cin)))


def _bwd_dw_fake(u, scale, shift, residual, y, dy, d1, d2, act):
    _n, cin, cout = _dims(u, y, act)
    return u.new_empty((cin, cout), dtype=torch.float32)


_U = "Tensor u, Tensor scale, Tensor shift"
fwd_op = _library.define(
    "bn_act_conv1x1_fwd",
    f"({_U}, Tensor w, Tensor? residual, str act) -> (Tensor, Tensor, Tensor)",
    bn_act_conv1x1_fwd, bn_act_conv1x1_plain, _fwd_fake)
bwd_dx_op = _library.define(
    "bn_act_conv1x1_bwd_dx",
    f"({_U}, Tensor w, Tensor? residual, Tensor y, Tensor dy, Tensor d1, "
    "Tensor d2, str act) -> (Tensor, Tensor, Tensor, Tensor)",
    _bwd_dx_cuda, _bwd_dx_cpu, _bwd_dx_fake)
bwd_dw_op = _library.define(
    "bn_act_conv1x1_bwd_dw",
    f"({_U}, Tensor? residual, Tensor y, Tensor dy, Tensor d1, Tensor d2, "
    "str act) -> Tensor",
    bn_act_conv1x1_bwd_dw, bn_act_conv1x1_bwd_dw_plain, _bwd_dw_fake)


def _setup(ctx, inputs, output):
    u, scale, shift, w, residual, act = inputs
    ctx.save_for_backward(u, scale, shift, w, residual, output[0])
    ctx.act = act


def _backward(ctx, dy, d1, d2):
    """The JAX custom VJP's dtypes: du in u's dtype, dscale and dshift
    f32, dw in w's dtype. A cotangent autograd leaves undefined (ssum or
    ssq unused) arrives as zeros."""
    u, scale, shift, w, residual, y = ctx.saved_tensors
    dy, d1, d2 = dy.contiguous(), d1.contiguous(), d2.contiguous()
    du, dscale, dshift, dres = bwd_dx_op(u, scale, shift, w, residual, y, dy,
                                         d1, d2, ctx.act)
    dw = bwd_dw_op(u, scale, shift, residual, y, dy, d1, d2, ctx.act)
    return (du, dscale, dshift, dw.to(w.dtype),
            None if residual is None else dres, None)


_library.register_autograd(fwd_op, _backward, _setup)


def bn_act_conv1x1(u, scale, shift, w, residual=None, act="relu"):
    """y, ssum, ssq = act(u*scale + shift [+ residual]) @ w with the
    output statistics from the GEMM's epilogue; see the module
    docstring. Differentiable in u, scale, shift, w and residual (B2
    and B3 recompute z from u). The op `paddle_tpu_torch::
    bn_act_conv1x1_fwd`: the kernels on a CUDA tensor, the plain
    versions on a CPU one."""
    if act not in ACTS:
        raise ValueError(f"act must be one of {ACTS}, got {act!r}")
    return fwd_op(u, scale, shift, w, residual, act)
