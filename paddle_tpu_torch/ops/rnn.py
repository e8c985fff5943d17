"""LSTM and GRU over whole sequences: the Hopper kernels, their plain
versions, the autograd Functions and the launch counters.

Replaces the TPU kernels of `paddle_tpu/ops/pallas_rnn.py` — B5
`_lstm_fwd_pallas`, B6 `_lstm_bwd_pallas`, B7 `_gru_fwd_kernel` and B8
`_gru_bwd_pallas` — with the contract of its `lstm_fused` and
`gru_fused`:

    LSTM  x [B,T,4h] pre-projected as [i, f, g, o]; w [h,4h]; gate bias
          gb [4h]; peepholes wci, wcf, wco [h]
          g = x_t + h_{t-1} @ w + gb
          i = sig(g_i + wci*c_{t-1}), f = sig(g_f + wcf*c_{t-1}),
          c_t = f*c_{t-1} + i*tanh(g_g), o = sig(g_o + wco*c_t),
          out = o*tanh(c_t)
    GRU   x [B,T,3h] pre-projected as [u, r, c]; w_g [h,2h]; w_c [h,h];
          b [3h]
          u = sig(x_u + b_u + h_{t-1} @ w_g[:, :h]), r likewise,
          c = tanh(x_c + b_c + (r*h_{t-1}) @ w_c),
          out = u*h_{t-1} + (1-u)*c

with masked carry: at t >= lens[b] the state carries through and
y = 0 (the SequenceToBatch contract).

Each kernel takes one of two routes, by shape alone (`fwd_plan`,
`bwd_plan`, whose rules live in the C entry points `*_seq_fwd_plan`
and `*_seq_bwd_plan`): the cluster route wherever a block's shared
memory holds its slice of the weights (h <= 320; B7: 352), else the
walk (a block per few batch rows, the weights from L2). On the cluster route
thread-block clusters keep the weights in shared memory and walk the
sequence together: the forward (B5, B7) exchanges each step's h through
distributed shared memory; the backward (B6, B8) hoists the gate
recompute onto the tensor cores first. `route="walk"` or `"cluster"`
on a kernel's wrapper asks for that route, and raises where it does not
take the shape.

The kernels run f32 and raise on other types. `lstm_fused` and
`gru_fused` take bf16 (the AMP rule) as the JAX wrappers do
(`pallas_rnn.py::_lstm_fwd_pallas`, `_gru_fwd_kernel`): x, the weights
and the biases cast up to f32 around the kernels (or their plain
versions on the CPU), y cast back to x's dtype; autograd casts the
gradients back through the same casts. The kernels take the bias as one
vector — b7 = [gb | wci | wcf | wco] for the LSTM.

A CUDA tensor goes through the kernels of `csrc/lstm_seq.cu` and
`csrc/gru_seq.cu` or the call raises — never a fallback. A CPU tensor
goes through `lstm_plain` / `gru_plain` (the JAX package's `lstm_ref`
and `gru_ref`) and `lstm_bwd_plain` / `gru_bwd_plain`, written with the
kernels' recompute formulas; the CPU tests use them and the chip smoke
holds the kernels against them on the card. There is no VMEM planning,
no scan fallback and no small-batch fallback: a shape the kernels do
not take raises, naming it.
"""

from __future__ import annotations

import ctypes

import torch

from paddle_tpu_torch.ops import _build
from paddle_tpu_torch.ops.sequence_ops import _mask

LSTM_KERNEL = "lstm_seq"
GRU_KERNEL = "gru_seq"

# kernel launches since the last reset, one counter per kernel (the chip
# smoke zeroes them just before driving a path and reads them just after)
lstm_fwd_launches = 0        # B5 with the cell sequence c (training)
lstm_fwd_infer_launches = 0  # B5 without c (inference)
lstm_fwd_cluster_launches = 0        # B5 with c on the cluster route
lstm_fwd_infer_cluster_launches = 0  # B5 without c on the cluster route
lstm_bwd_launches = 0        # B6, either route
lstm_bwd_cluster_launches = 0  # B6 on the cluster route
gru_fwd_launches = 0         # B7, either route
gru_fwd_cluster_launches = 0   # B7 on the cluster route
gru_bwd_launches = 0         # B8, either route
gru_bwd_cluster_launches = 0   # B8 on the cluster route

ROUTES = ("walk", "cluster")   # the kernels' routes, by their C numbers


# ---------------------------------------------------------------- plain
def _prev(seq):
    """[B,T,h] -> the sequence one step later: out[:, t] = seq[:, t-1],
    zeros at t = 0 (h_{t-1} and c_{t-1} read from saved outputs)."""
    return torch.cat([torch.zeros_like(seq[:, :1]), seq[:, :-1]], dim=1)


def lstm_plain(x, w, gb, wci, wcf, wco, lens, want_c=False):
    """The plain LSTM (`pallas_rnn.lstm_ref`): y [B,T,h], and with
    `want_c` also the carried cell sequence c [B,T,h] the backward
    reads, as B5's training variant writes it."""
    h = w.shape[0]
    m = _mask(lens, x.shape[1], x.dtype)
    hp = x.new_zeros((x.shape[0], h))
    cp = x.new_zeros((x.shape[0], h))
    ys, cs = [], []
    for t in range(x.shape[1]):
        g = x[:, t] + hp @ w + gb
        gi, gf, gg, go = torch.split(g, h, dim=-1)
        i = torch.sigmoid(gi + wci * cp)
        f = torch.sigmoid(gf + wcf * cp)
        cand = torch.tanh(gg)
        c = f * cp + i * cand
        o = torch.sigmoid(go + wco * c)
        out = o * torch.tanh(c)
        mt = m[:, t, None]
        hp = mt * out + (1 - mt) * hp
        cp = mt * c + (1 - mt) * cp
        ys.append(out * mt)
        cs.append(cp)
    y = torch.stack(ys, dim=1)
    return (y, torch.stack(cs, dim=1)) if want_c else y


def lstm_bwd_plain(x, w, b7, lens, y, c, dy):
    """The plain B6: (dx [B,T,4h], dw [h,4h], db7 [7h]) from the saved
    y and c, the gates recomputed as `_lstm_bwd_kernel` recomputes them
    (`pallas_rnn.py:248-282`)."""
    h = w.shape[0]
    gb, wci, wcf, wco = torch.split(b7, [4 * h, h, h, h])
    m = _mask(lens, x.shape[1], x.dtype)
    hps, cps = _prev(y), _prev(c)
    dh = x.new_zeros((x.shape[0], h))
    dc = torch.zeros_like(dh)
    dgs = [None] * x.shape[1]
    dpeep = [x.new_zeros(h) for _ in range(3)]
    for t in reversed(range(x.shape[1])):
        hp, cp, mt = hps[:, t], cps[:, t], m[:, t, None]
        g = x[:, t] + hp @ w + gb
        gi, gf, gg, go = torch.split(g, h, dim=-1)
        ig = torch.sigmoid(gi + wci * cp)
        fg = torch.sigmoid(gf + wcf * cp)
        cand = torch.tanh(gg)
        ct = fg * cp + ig * cand
        og = torch.sigmoid(go + wco * ct)
        tc = torch.tanh(ct)
        dout = mt * (dh + dy[:, t])
        dg_o = dout * tc * og * (1 - og)
        dc_tot = mt * dc + dout * og * (1 - tc * tc) + dg_o * wco
        dg_i = dc_tot * cand * ig * (1 - ig)
        dg_f = dc_tot * cp * fg * (1 - fg)
        dg_g = dc_tot * ig * (1 - cand * cand)
        dg = torch.cat([dg_i, dg_f, dg_g, dg_o], dim=-1)
        dgs[t] = dg
        dh = (1 - mt) * dh + dg @ w.t()
        dc = dc_tot * fg + dg_i * wci + dg_f * wcf + (1 - mt) * dc
        dpeep[0] = dpeep[0] + (dg_i * cp).sum(0)
        dpeep[1] = dpeep[1] + (dg_f * cp).sum(0)
        dpeep[2] = dpeep[2] + (dg_o * ct).sum(0)
    dx = torch.stack(dgs, dim=1)
    dw = hps.reshape(-1, h).t() @ dx.reshape(-1, 4 * h)
    return dx, dw, torch.cat([dx.sum((0, 1)), *dpeep])


def gru_plain(x, w_g, w_c, b, lens):
    """The plain GRU (`pallas_rnn.gru_ref`): y [B,T,h]."""
    h = w_c.shape[0]
    m = _mask(lens, x.shape[1], x.dtype)
    hp = x.new_zeros((x.shape[0], h))
    ys = []
    for t in range(x.shape[1]):
        xu, xr, xc = torch.split(x[:, t] + b, h, dim=-1)
        gur = hp @ w_g
        u = torch.sigmoid(xu + gur[:, :h])
        r = torch.sigmoid(xr + gur[:, h:])
        c = torch.tanh(xc + (r * hp) @ w_c)
        out = u * hp + (1 - u) * c
        mt = m[:, t, None]
        hp = mt * out + (1 - mt) * hp
        ys.append(out * mt)
    return torch.stack(ys, dim=1)


def gru_bwd_plain(x, w_g, w_c, b, lens, y, dy):
    """The plain B8: (dx [B,T,3h], dw_g [h,2h], dw_c [h,h], db [3h])
    from the saved y, the gates recomputed as `_gru_bwd_kernel`
    recomputes them (`pallas_rnn.py:592-632`)."""
    h = w_c.shape[0]
    m = _mask(lens, x.shape[1], x.dtype)
    hps = _prev(y)
    dh = x.new_zeros((x.shape[0], h))
    dxs, rhs = [None] * x.shape[1], [None] * x.shape[1]
    for t in reversed(range(x.shape[1])):
        hp, mt = hps[:, t], m[:, t, None]
        xu, xr, xc = torch.split(x[:, t] + b, h, dim=-1)
        gur = hp @ w_g
        u = torch.sigmoid(xu + gur[:, :h])
        r = torch.sigmoid(xr + gur[:, h:])
        rh = r * hp
        c = torch.tanh(xc + rh @ w_c)
        dout = mt * (dh + dy[:, t])
        du = dout * (hp - c)
        dg_c = dout * (1 - u) * (1 - c * c)
        drh = dg_c @ w_c.t()
        dg_u = du * u * (1 - u)
        dg_r = drh * hp * r * (1 - r)
        dg_ur = torch.cat([dg_u, dg_r], dim=-1)
        dh = (1 - mt) * dh + drh * r + dout * u + dg_ur @ w_g.t()
        dxs[t] = torch.cat([dg_ur, dg_c], dim=-1)
        rhs[t] = rh
    dx = torch.stack(dxs, dim=1)
    rh_seq = torch.stack(rhs, dim=1)
    dw_g = hps.reshape(-1, h).t() @ dx[..., :2 * h].reshape(-1, 2 * h)
    dw_c = rh_seq.reshape(-1, h).t() @ dx[..., 2 * h:].reshape(-1, h)
    return dx, dw_g, dw_c, dx.sum((0, 1))


# --------------------------------------------------------------- kernels
def _bind(name):
    lib = _build.load(name)
    p, i = ctypes.c_void_p, ctypes.c_int
    # tensors, then B, T, h, route, the route taken (int *), device, stream
    tail = [i] * 4 + [ctypes.POINTER(i), i, p]
    if name == LSTM_KERNEL:
        fns = {"lstm_seq_fwd": [p] * 6 + tail,
               "lstm_seq_bwd": [p] * 11 + tail}
    else:
        fns = {"gru_seq_fwd": [p] * 6 + tail,
               "gru_seq_bwd": [p] * 12 + tail}
    for kind in ("fwd", "bwd"):
        fns[f"{name}_{kind}_plan"] = [i] * 4 + [p]
    for fn, argtypes in fns.items():
        f = getattr(lib, fn)
        if f.argtypes is None:
            f.argtypes = argtypes
            f.restype = ctypes.c_int
    getattr(lib, f"{name}_bwd_scratch_floats").argtypes = [i, i, i]
    getattr(lib, f"{name}_bwd_scratch_floats").restype = ctypes.c_longlong
    getattr(lib, f"{name}_error_string").argtypes = [i]
    getattr(lib, f"{name}_error_string").restype = ctypes.c_char_p
    return lib


def _request(route):
    """The C number of `route` (None: -1, the rule); raises ValueError on
    a name that is not a route, before anything is built."""
    if route is None:
        return -1
    if route not in ROUTES:
        raise ValueError(f"route must be None or one of {ROUTES}, got "
                         f"{route!r}")
    return ROUTES.index(route)


def _refused(name, kind, route, b, h):
    which = "no route" if route is None else f"the {route} route"
    return ValueError(f"{name} {kind}: {which} takes h = {h} (B={b}): a "
                      f"block's shared memory does not hold it")


def _plan(kind, name, b, h, device, route):
    request = _request(route)
    lib = _bind(name)
    out = (ctypes.c_int * 4)()
    index = device.index if device.index is not None else \
        torch.cuda.current_device()
    _build.launch(lib, f"{name}_{kind}_plan", f"{name}_error_string", b, h,
                  index, request, out)
    if out[0] < 0:
        raise _refused(name, kind, route, b, h)
    return {"route": ROUTES[out[0]], "rows": out[1], "blocks": out[2],
            "active": out[3]}


def _run(name, kind, route, x, *args):
    """Launch `name`'s forward or backward (`kind`) entry point on `args`
    (its tensors' pointers, then B, T, h) at `route` on x's device and
    current stream. Returns the route the entry point took (the rule's
    where `route` is None); raises ValueError where `route` does not take
    the width."""
    lib = _bind(name)
    taken = ctypes.c_int(-1)
    _build.launch(lib, f"{name}_{kind}", f"{name}_error_string", *args,
                  _request(route), ctypes.byref(taken),
                  *_build.device_and_stream(x))
    if taken.value < 0:
        raise _refused(name, kind, route, args[-3], args[-1])
    return ROUTES[taken.value]


def fwd_plan(name, b, h, device, route=None):
    """B5's (`name` LSTM_KERNEL) or B7's (GRU_KERNEL) plan at batch b and
    width h on CUDA `device`: {"route": "cluster" or "walk", "rows": batch
    rows a cluster or block takes, "blocks": clusters or blocks,
    "active": the clusters the card holds at once (0 on the walk)}. `route`
    None takes the rule (the cluster route wherever it holds h); "walk"
    or "cluster" asks for that route, and raises where it does not take
    h."""
    return _plan("fwd", name, b, h, device, route)


def bwd_plan(name, b, h, device, route=None):
    """B6's (`name` LSTM_KERNEL) or B8's (GRU_KERNEL) plan, as
    `fwd_plan`'s."""
    return _plan("bwd", name, b, h, device, route)


def _check(where, x, width, lens, **shapes):
    """Validate a kernel's inputs: x [B, T, width*h] and each of
    `shapes` ({name: (tensor, shape in multiples of B, T, h)}) contiguous
    f32 on x's CUDA device, lens int32 [B]. Returns (B, T, h)."""
    if x.device.type != "cuda":
        raise ValueError(f"{where}: unsupported device {x.device}")
    if x.dim() != 3 or x.shape[2] % width or 0 in x.shape:
        raise ValueError(f"{where}: x must be [B, T, {width}*h] with B, T, "
                         f"h >= 1, got {tuple(x.shape)}")
    b, t, h = x.shape[0], x.shape[1], x.shape[2] // width
    dims = {"B": b, "T": t, "h": h}
    for name, (v, spec) in {"x": (x, ("B", "T", f"{width}h")),
                            **shapes}.items():
        shape = tuple(int(s[:-1] or 1) * dims[s[-1]] for s in spec)
        if (v.dtype != torch.float32 or v.device != x.device
                or tuple(v.shape) != shape or not v.is_contiguous()):
            raise ValueError(
                f"{where}: {name} must be a contiguous f32 {list(shape)} "
                f"tensor on {x.device}, got {v.dtype} {tuple(v.shape)} on "
                f"{v.device}{'' if v.is_contiguous() else ' (strided)'}")
    if (lens.dtype != torch.int32 or lens.device != x.device
            or tuple(lens.shape) != (b,) or not lens.is_contiguous()):
        raise ValueError(f"{where}: lens must be a contiguous int32 [{b}] "
                         f"tensor on {x.device}, got {lens.dtype} "
                         f"{tuple(lens.shape)} on {lens.device}")
    return b, t, h


def _empty(shape, like):
    return torch.empty(shape, dtype=torch.float32, device=like.device)


def lstm_seq_fwd(x, w, b7, lens, want_c=True, route=None):
    """B5 on the card: (y, c) with `want_c` (training: the backward
    reads c), else (y, None), on the route of `fwd_plan` (`route` None:
    the rule)."""
    global lstm_fwd_launches, lstm_fwd_infer_launches
    global lstm_fwd_cluster_launches, lstm_fwd_infer_cluster_launches
    where = "lstm_seq_fwd"
    _request(route)
    b, t, h = _check(where, x, 4, lens, w=(w, ("h", "4h")),
                     b7=(b7, ("7h",)))
    y = _empty((b, t, h), x)
    c = _empty((b, t, h), x) if want_c else None
    cluster = _run(LSTM_KERNEL, "fwd", route, x, x.data_ptr(), w.data_ptr(),
                   b7.data_ptr(), lens.data_ptr(), y.data_ptr(),
                   _build.ptr(c), b, t, h) == "cluster"
    if want_c:
        lstm_fwd_launches += 1
        lstm_fwd_cluster_launches += cluster
    else:
        lstm_fwd_infer_launches += 1
        lstm_fwd_infer_cluster_launches += cluster
    return y, c


def lstm_seq_bwd(x, w, b7, lens, y, c, dy, route=None):
    """B6 on the card: (dx [B,T,4h], dw [h,4h], db7 [7h]), on the route
    of `bwd_plan` (`route` None: the rule)."""
    global lstm_bwd_launches, lstm_bwd_cluster_launches
    where = "lstm_seq_bwd"
    _request(route)
    seq = ("B", "T", "h")
    b, t, h = _check(where, x, 4, lens, w=(w, ("h", "4h")),
                     b7=(b7, ("7h",)), y=(y, seq), c=(c, seq), dy=(dy, seq))
    dx = _empty((b, t, 4 * h), x)
    dw = _empty((h, 4 * h), x)
    db7 = _empty((7 * h,), x)
    scratch = _empty(
        (_bind(LSTM_KERNEL).lstm_seq_bwd_scratch_floats(b, t, h),), x)
    taken = _run(LSTM_KERNEL, "bwd", route, x, x.data_ptr(), w.data_ptr(),
                 b7.data_ptr(), lens.data_ptr(), y.data_ptr(), c.data_ptr(),
                 dy.data_ptr(), dx.data_ptr(), dw.data_ptr(), db7.data_ptr(),
                 scratch.data_ptr(), b, t, h)
    lstm_bwd_launches += 1
    lstm_bwd_cluster_launches += taken == "cluster"
    return dx, dw, db7


def gru_seq_fwd(x, w_g, w_c, b, lens, route=None):
    """B7 on the card: y [B,T,h], on the route of `fwd_plan` (`route`
    None: the rule)."""
    global gru_fwd_launches, gru_fwd_cluster_launches
    where = "gru_seq_fwd"
    _request(route)
    bsz, t, h = _check(where, x, 3, lens, w_g=(w_g, ("h", "2h")),
                       w_c=(w_c, ("h", "h")), b=(b, ("3h",)))
    y = _empty((bsz, t, h), x)
    taken = _run(GRU_KERNEL, "fwd", route, x, x.data_ptr(), w_g.data_ptr(),
                 w_c.data_ptr(), b.data_ptr(), lens.data_ptr(), y.data_ptr(),
                 bsz, t, h)
    gru_fwd_launches += 1
    gru_fwd_cluster_launches += taken == "cluster"
    return y


def gru_seq_bwd(x, w_g, w_c, b, lens, y, dy, route=None):
    """B8 on the card: (dx [B,T,3h], dw_g [h,2h], dw_c [h,h], db [3h]),
    on the route of `bwd_plan` (`route` None: the rule)."""
    global gru_bwd_launches, gru_bwd_cluster_launches
    where = "gru_seq_bwd"
    _request(route)
    seq = ("B", "T", "h")
    bsz, t, h = _check(where, x, 3, lens, w_g=(w_g, ("h", "2h")),
                       w_c=(w_c, ("h", "h")), b=(b, ("3h",)), y=(y, seq),
                       dy=(dy, seq))
    dx = _empty((bsz, t, 3 * h), x)
    dw_g = _empty((h, 2 * h), x)
    dw_c = _empty((h, h), x)
    db = _empty((3 * h,), x)
    scratch = _empty(
        (_bind(GRU_KERNEL).gru_seq_bwd_scratch_floats(bsz, t, h),), x)
    taken = _run(GRU_KERNEL, "bwd", route, x, x.data_ptr(), w_g.data_ptr(),
                 w_c.data_ptr(), b.data_ptr(), lens.data_ptr(), y.data_ptr(),
                 dy.data_ptr(), dx.data_ptr(), dw_g.data_ptr(),
                 dw_c.data_ptr(), db.data_ptr(), scratch.data_ptr(), bsz, t,
                 h)
    gru_bwd_launches += 1
    gru_bwd_cluster_launches += taken == "cluster"
    return dx, dw_g, dw_c, db


# --------------------------------------------------------------- autograd
class LstmSeq(torch.autograd.Function):
    """y = LSTM(x; w, b7) over the sequence, differentiable in x, w and
    b7. The forward saves y and the cell sequence c; the backward
    recomputes the gates from them (B6, or `lstm_bwd_plain` on the
    CPU)."""

    @staticmethod
    def forward(ctx, x, w, b7, lens):
        if x.device.type == "cpu":
            h = w.shape[0]
            y, c = lstm_plain(x, w, *torch.split(b7, [4 * h, h, h, h]), lens,
                              want_c=True)
        else:
            y, c = lstm_seq_fwd(x, w, b7, lens, want_c=True)
        ctx.save_for_backward(x, w, b7, lens, y, c)
        return y

    @staticmethod
    @torch.autograd.function.once_differentiable
    def backward(ctx, dy):
        x, w, b7, lens, y, c = ctx.saved_tensors
        bwd = lstm_bwd_plain if x.device.type == "cpu" else lstm_seq_bwd
        dx, dw, db7 = bwd(x, w, b7, lens, y, c, dy.contiguous())
        return dx, dw, db7, None


class GruSeq(torch.autograd.Function):
    """y = GRU(x; w_g, w_c, b) over the sequence, differentiable in x,
    w_g, w_c and b. The forward saves y; the backward recomputes the
    gates from it (B8, or `gru_bwd_plain` on the CPU)."""

    @staticmethod
    def forward(ctx, x, w_g, w_c, b, lens):
        fwd = gru_plain if x.device.type == "cpu" else gru_seq_fwd
        y = fwd(x, w_g, w_c, b, lens)
        ctx.save_for_backward(x, w_g, w_c, b, lens, y)
        return y

    @staticmethod
    @torch.autograd.function.once_differentiable
    def backward(ctx, dy):
        x, w_g, w_c, b, lens, y = ctx.saved_tensors
        bwd = gru_bwd_plain if x.device.type == "cpu" else gru_seq_bwd
        dx, dw_g, dw_c, db = bwd(x, w_g, w_c, b, lens, y, dy.contiguous())
        return dx, dw_g, dw_c, db, None


def _needs_grad(*tensors):
    return torch.is_grad_enabled() and any(t.requires_grad for t in tensors)


def _f32(*tensors):
    return tuple(t.float() for t in tensors)


def lstm_fused(x, w, gb, wci, wcf, wco, lens):
    """y [B,T,h] of the LSTM contract (module docstring), in x's dtype.
    With gradients wanted: `LstmSeq` (B5 with c, then B6); without: B5's
    inference variant, which skips the c output. CPU tensors take the
    plain versions. bf16 runs in f32 inside (the module docstring)."""
    if x.dtype == torch.bfloat16:
        return lstm_fused(*_f32(x, w, gb, wci, wcf, wco), lens).to(x.dtype)
    x = x.contiguous()
    b7 = torch.cat([gb, wci, wcf, wco])
    lens = lens.to(device=x.device, dtype=torch.int32).contiguous()
    w = w.contiguous()
    if _needs_grad(x, w, b7):
        return LstmSeq.apply(x, w, b7, lens)
    if x.device.type == "cpu":
        return lstm_plain(x, w, gb, wci, wcf, wco, lens)
    return lstm_seq_fwd(x, w, b7, lens, want_c=False)[0]


def gru_fused(x, w_g, w_c, b, lens):
    """y [B,T,h] of the GRU contract (module docstring), through
    `GruSeq` (B7, and B8 for the gradient), in x's dtype; CPU tensors
    take the plain versions. bf16 runs in f32 inside (the module
    docstring)."""
    if x.dtype == torch.bfloat16:
        return gru_fused(*_f32(x, w_g, w_c, b), lens).to(x.dtype)
    lens = lens.to(device=x.device, dtype=torch.int32).contiguous()
    return GruSeq.apply(x.contiguous(), w_g.contiguous(), w_c.contiguous(),
                        b.contiguous(), lens)
