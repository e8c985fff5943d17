"""Fused BN -> ReLU -> 1x1-conv GEMM with a statistics epilogue: the
Hopper kernels, their plain versions, the autograd Function and the
launch counters.

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

f32 only, as the port's Network: the kernels raise on other types.

A CUDA tensor goes through the kernels of `csrc/bn_act_conv1x1.cu` or
the call raises — never a fallback. A CPU tensor goes through
`bn_act_conv1x1_plain`, `bn_act_conv1x1_bwd_dx_plain` and
`bn_act_conv1x1_bwd_dw_plain`, the straightforward versions that state
the contract; the CPU tests use them and the chip smoke holds the
kernels against them on the card. `BnActConv1x1` (an autograd
Function) ties the directions together; `bn_act_conv1x1` is the entry
`layers/fused.py` calls.
"""

from __future__ import annotations

import ctypes

import torch

from paddle_tpu_torch.ops import _build

KERNEL = "bn_act_conv1x1"
ACTS = ("relu", "")

# kernel launches since the last reset, one counter per kernel (the
# chip smoke zeroes them just before driving a path and reads them just
# after)
fwd_launches = 0      # B1: y, ssum, ssq
bwd_dx_launches = 0   # B2: du, dres, dscale, dshift
bwd_dw_launches = 0   # B3: dw

# scratch kinds of bn_act_conv1x1_scratch_floats (csrc)
_FWD, _BWD_DX, _BWD_DW = 0, 1, 2


# ---------------------------------------------------------------- plain
def _pre(u, scale, shift, residual):
    pre = u * scale + shift
    return pre if residual is None else pre + residual


def bn_act_conv1x1_plain(u, scale, shift, w, residual=None, act="relu"):
    """The plain PyTorch forward: (y, ssum, ssq) of the contract."""
    z = _pre(u, scale, shift, residual)
    if act == "relu":
        z = torch.clamp_min(z, 0.0)
    y = z @ w
    return y, y.sum(dim=0), (y * y).sum(dim=0)


def _dy_eff(y, dy, d1, d2):
    return dy + d1 + 2.0 * y * d2


def bn_act_conv1x1_bwd_dx_plain(u, scale, shift, w, residual, y, dy, d1,
                                d2, act="relu"):
    """The plain B2: (du, dscale, dshift, dres); dres is None without a
    residual."""
    dz = _dy_eff(y, dy, d1, d2) @ w.t()
    if act == "relu":
        dz = dz * (_pre(u, scale, shift, residual) > 0)
    return (dz * scale, (dz * u).sum(dim=0), dz.sum(dim=0),
            None if residual is None else dz)


def bn_act_conv1x1_bwd_dw_plain(u, scale, shift, residual, y, dy, d1, d2,
                                act="relu"):
    """The plain B3: dw [Cin, Cout]."""
    z = _pre(u, scale, shift, residual)
    if act == "relu":
        z = torch.clamp_min(z, 0.0)
    return z.t() @ _dy_eff(y, dy, d1, d2)


# --------------------------------------------------------------- kernels
def _bind():
    lib = _build.load(KERNEL)
    p, i = ctypes.c_void_p, ctypes.c_int
    fns = {
        "bn_act_conv1x1_fwd": [p] * 9 + [i] * 5 + [p],
        "bn_act_conv1x1_bwd_dx": [p] * 14 + [i] * 5 + [p],
        "bn_act_conv1x1_bwd_dw": [p] * 10 + [i] * 5 + [p],
    }
    for fn, argtypes in fns.items():
        f = getattr(lib, fn)
        if f.argtypes is None:
            f.argtypes = argtypes
            f.restype = ctypes.c_int
    lib.bn_act_conv1x1_scratch_floats.argtypes = [i] * 4
    lib.bn_act_conv1x1_scratch_floats.restype = ctypes.c_longlong
    lib.bn_act_conv1x1_error_string.argtypes = [i]
    lib.bn_act_conv1x1_error_string.restype = ctypes.c_char_p
    lib.bn_act_conv1x1_plan.argtypes = [i] * 5 + [
        ctypes.POINTER(ctypes.c_longlong)]
    lib.bn_act_conv1x1_plan.restype = None
    return lib


def launch_plan(n, cin, cout, residual=False):
    """B1's, B2's and B3's launches at these widths, for reports:
    {"fwd", "bwd_dx" or "bwd_dw": {"tile", "blocks", "smem_bytes"}} (the
    tile in rows or Cin by columns, the dynamic shared memory a block);
    "fwd" also has "flush", the stages between B1's flushes of its
    accumulators into f32 sums (0: none)."""
    lib = _bind()
    out = (ctypes.c_longlong * 5)()
    plans = {}
    for name, kind in (("fwd", _FWD), ("bwd_dx", _BWD_DX),
                       ("bwd_dw", _BWD_DW)):
        lib.bn_act_conv1x1_plan(kind, n, cin, cout, int(residual), out)
        plans[name] = {"tile": [out[0], out[1]], "blocks": out[2],
                       "smem_bytes": out[3]}
        if kind == _FWD:
            plans[name]["flush"] = out[4]
    return plans


_SHAPES = {   # name -> its shape in (N, Cin, Cout)
    "u": "nc", "residual": "nc", "scale": "c", "shift": "c", "w": "co",
    "y": "no", "dy": "no", "d1": "o", "d2": "o",
}


def _check(where, act, u, other, **tensors):
    """Validate the kernels' inputs; returns (N, Cin, Cout), read from
    u [N, Cin] and the last dim of `other` (w or y)."""
    if u.device.type != "cuda":
        raise ValueError(f"{where}: unsupported device {u.device}")
    if act not in ACTS:
        raise ValueError(f"{where}: act must be one of {ACTS}, got {act!r}")
    if u.dim() != 2 or other.dim() != 2:
        raise ValueError(f"{where}: u and w/y must be 2-D, got "
                         f"{tuple(u.shape)} and {tuple(other.shape)}")
    dims = {"n": u.shape[0], "c": u.shape[1], "o": other.shape[1]}
    if min(dims.values()) == 0:
        raise ValueError(f"{where}: empty input {dims}")
    for name, x in {"u": u, **tensors}.items():
        if x is None:
            continue
        shape = tuple(dims[d] for d in _SHAPES[name])
        if (x.dtype != torch.float32 or x.device != u.device
                or tuple(x.shape) != shape or not x.is_contiguous()):
            raise ValueError(
                f"{where}: {name} must be a contiguous f32 {list(shape)} "
                f"tensor on {u.device}, got {x.dtype} {tuple(x.shape)} on "
                f"{x.device}{'' if x.is_contiguous() else ' (strided)'}")
    return dims["n"], dims["c"], dims["o"]


def _launch(lib, fn, *args):
    _build.launch(lib, fn, "bn_act_conv1x1_error_string", *args)


def _scratch(lib, kind, n, cin, cout, device):
    floats = lib.bn_act_conv1x1_scratch_floats(kind, n, cin, cout)
    return torch.empty((max(floats, 1),), dtype=torch.float32, device=device)


def bn_act_conv1x1_fwd(u, scale, shift, w, residual=None, act="relu"):
    """B1 on the card: (y, ssum, ssq) of the contract."""
    global fwd_launches
    n, cin, cout = _check("bn_act_conv1x1_fwd", act, u, w, scale=scale,
                          shift=shift, w=w, residual=residual)
    lib = _bind()
    y = torch.empty((n, cout), dtype=torch.float32, device=u.device)
    ssum = torch.empty((cout,), dtype=torch.float32, device=u.device)
    ssq = torch.empty((cout,), dtype=torch.float32, device=u.device)
    scratch = _scratch(lib, _FWD, n, cin, cout, u.device)
    _launch(lib, "bn_act_conv1x1_fwd", u.data_ptr(), scale.data_ptr(),
            shift.data_ptr(), w.data_ptr(), _build.ptr(residual), y.data_ptr(),
            ssum.data_ptr(), ssq.data_ptr(), scratch.data_ptr(), n, cin,
            cout, int(act == "relu"), *_build.device_and_stream(u))
    fwd_launches += 1
    return y, ssum, ssq


def bn_act_conv1x1_bwd_dx(u, scale, shift, w, residual, y, dy, d1, d2,
                          act="relu"):
    """B2 on the card: (du, dscale, dshift, dres); dres is None without
    a residual."""
    global bwd_dx_launches
    n, cin, cout = _check("bn_act_conv1x1_bwd_dx", act, u, w, scale=scale,
                          shift=shift, w=w, residual=residual, y=y, dy=dy,
                          d1=d1, d2=d2)
    lib = _bind()
    dev = u.device
    du = torch.empty((n, cin), dtype=torch.float32, device=dev)
    dres = (torch.empty((n, cin), dtype=torch.float32, device=dev)
            if residual is not None else None)
    dscale = torch.empty((cin,), dtype=torch.float32, device=dev)
    dshift = torch.empty((cin,), dtype=torch.float32, device=dev)
    scratch = _scratch(lib, _BWD_DX, n, cin, cout, dev)
    _launch(lib, "bn_act_conv1x1_bwd_dx", u.data_ptr(), scale.data_ptr(),
            shift.data_ptr(), w.data_ptr(), _build.ptr(residual), y.data_ptr(),
            dy.data_ptr(), d1.data_ptr(), d2.data_ptr(), du.data_ptr(),
            _build.ptr(dres), dscale.data_ptr(), dshift.data_ptr(),
            scratch.data_ptr(), n, cin, cout, int(act == "relu"),
            *_build.device_and_stream(u))
    bwd_dx_launches += 1
    return du, dscale, dshift, dres


def bn_act_conv1x1_bwd_dw(u, scale, shift, residual, y, dy, d1, d2,
                          act="relu"):
    """B3 on the card: dw [Cin, Cout]."""
    global bwd_dw_launches
    n, cin, cout = _check("bn_act_conv1x1_bwd_dw", act, u, y, scale=scale,
                          shift=shift, residual=residual, y=y, dy=dy, d1=d1,
                          d2=d2)
    lib = _bind()
    dw = torch.empty((cin, cout), dtype=torch.float32, device=u.device)
    scratch = _scratch(lib, _BWD_DW, n, cin, cout, u.device)
    _launch(lib, "bn_act_conv1x1_bwd_dw", u.data_ptr(), scale.data_ptr(),
            shift.data_ptr(), _build.ptr(residual), y.data_ptr(),
            dy.data_ptr(), d1.data_ptr(), d2.data_ptr(), dw.data_ptr(),
            scratch.data_ptr(), n, cin, cout, int(act == "relu"),
            *_build.device_and_stream(u))
    bwd_dw_launches += 1
    return dw


# --------------------------------------------------------------- autograd
class BnActConv1x1(torch.autograd.Function):
    """(y, ssum, ssq) of the contract, differentiable in u, scale,
    shift, w and residual. The forward saves its inputs and y; the
    backward recomputes z from u (B2 and B3). A cotangent autograd
    leaves undefined (ssum or ssq unused) arrives as zeros."""

    @staticmethod
    def forward(ctx, u, scale, shift, w, residual, act):
        cpu = u.device.type == "cpu"
        fwd = bn_act_conv1x1_plain if cpu else bn_act_conv1x1_fwd
        y, ssum, ssq = fwd(u, scale, shift, w, residual, act)
        ctx.save_for_backward(u, scale, shift, w, residual, y)
        ctx.act = act
        return y, ssum, ssq

    @staticmethod
    @torch.autograd.function.once_differentiable
    def backward(ctx, dy, d1, d2):
        u, scale, shift, w, residual, y = ctx.saved_tensors
        dy = dy.contiguous()
        cpu = u.device.type == "cpu"
        dx = bn_act_conv1x1_bwd_dx_plain if cpu else bn_act_conv1x1_bwd_dx
        dw = bn_act_conv1x1_bwd_dw_plain if cpu else bn_act_conv1x1_bwd_dw
        du, dscale, dshift, dres = dx(u, scale, shift, w, residual, y, dy,
                                      d1, d2, ctx.act)
        dw = dw(u, scale, shift, residual, y, dy, d1, d2, ctx.act)
        return du, dscale, dshift, dw, dres, None


def bn_act_conv1x1(u, scale, shift, w, residual=None, act="relu"):
    """y, ssum, ssq = act(u*scale + shift [+ residual]) @ w with the
    output statistics from the GEMM's epilogue; see the module
    docstring. Differentiable in u, scale, shift, w and residual."""
    if act not in ACTS:
        raise ValueError(f"act must be one of {ACTS}, got {act!r}")
    return BnActConv1x1.apply(u, scale, shift, w, residual, act)
