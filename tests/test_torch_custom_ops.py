"""The port's kernels as `torch.library` custom ops, on the CPU.

- Every kernel entry point (B1-B9) is an op of the namespace
  `paddle_tpu_torch` with a CUDA and a CPU implementation, a fake one,
  and for the forward ops an autograd formula; a tensor on another
  device finds no implementation.
- `torch.library.opcheck` passes for each op on CPU tensors (the schema,
  the fake implementation against the real one, the autograd
  registration and AOT dispatch with dynamic shapes).
- The fake outputs' shapes and dtypes equal the real ones, and a fake
  call allocates nothing on a device.
- Gradients through the forward ops equal the JAX custom VJPs (the
  Pallas kernels in interpret mode, as the JAX package's tests run them)
  within 1e-5 of the largest entry.
"""

import numpy as np
import pytest
import torch
from torch._subclasses.fake_tensor import FakeTensorMode

import jax
import jax.numpy as jnp

from paddle_tpu.ops import pallas_rnn as jrnn
from paddle_tpu.ops.pallas_fused import bn_act_conv1x1 as jfused
from paddle_tpu.parallel import ring as jring
from paddle_tpu_torch.ops import _library
from paddle_tpu_torch.ops import bn_act_conv1x1 as fop
from paddle_tpu_torch.ops import flash_attention as fa
from paddle_tpu_torch.ops import rnn
from paddle_tpu_torch.ops import sparse_rows as sr

TOL = 1e-5
OPS = ["bn_act_conv1x1_fwd", "bn_act_conv1x1_bwd_dx", "bn_act_conv1x1_bwd_dw",
       "flash_attention_fwd", "flash_attention_bwd_dkv",
       "flash_attention_bwd_dq", "lstm_seq_fwd", "lstm_seq_bwd",
       "gru_seq_fwd", "gru_seq_bwd", "sparse_row_update",
       "sparse_row_gather", "sparse_row_scatter"]
FORWARD_OPS = ["bn_act_conv1x1_fwd", "flash_attention_fwd", "lstm_seq_fwd",
               "gru_seq_fwd"]


def _rng(seed):
    return np.random.default_rng(seed)


def _f32(rng, *shape, scale=1.0):
    return torch.from_numpy((rng.standard_normal(shape) * scale).astype(
        np.float32))


def _close(got, want, what):
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape, what
    scale = max(float(np.abs(want).max()), 1e-30)
    err = float(np.abs(got - want).max()) / scale
    assert err <= TOL, f"{what}: {err:.3g} relative to max > {TOL}"


# ---- the inputs of every op, at small shapes -----------------------------
def _bn(rng, dtype=torch.float32, res=True, grad=False):
    n, cin, cout = 24, 16, 8
    u, r = _f32(rng, n, cin), _f32(rng, n, cin)
    sc, sh = _f32(rng, cin), _f32(rng, cin)
    w = _f32(rng, cin, cout, scale=0.2)
    u, w, r = u.to(dtype), w.to(dtype), r.to(dtype)
    ins = [u, sc, sh, w, r if res else None]
    if grad:
        ins = [None if x is None else x.requires_grad_(True) for x in ins]
    return ins


def _bn_bwd(rng, dtype=torch.float32, res=True):
    u, sc, sh, w, r = _bn(rng, dtype, res)
    y, _s1, _s2 = fop.bn_act_conv1x1_plain(u, sc, sh, w, r, "relu")
    dy = _f32(rng, *y.shape).to(dtype)
    return u, sc, sh, w, r, y, dy, _f32(rng, w.shape[1]), _f32(
        rng, w.shape[1])


def _attn(rng, dtype=torch.float32, grad=False, d=8):
    b, t, h = 2, 6, 2
    q, k, v = (_f32(rng, b, t, h, d).to(dtype) for _ in range(3))
    if grad:
        q, k, v = (x.requires_grad_(True) for x in (q, k, v))
    return q, k, v


def _attn_bwd(rng, dtype=torch.float32, d=8):
    q, k, v = _attn(rng, dtype, d=d)
    kv_len = torch.tensor([6, 4], dtype=torch.int32)
    out, lse = fa.attention_plain(q, k, v, True, kv_len)
    dout = _f32(rng, *q.shape).to(dtype)
    return q, k, v, dout, lse, fa.row_delta(dout, out), kv_len


LENS = torch.tensor([5, 0, 3], dtype=torch.int32)


def _lstm(rng, grad=False):
    h = 4
    ins = [_f32(rng, 3, 5, 4 * h), _f32(rng, h, 4 * h, scale=0.5),
           _f32(rng, 7 * h, scale=0.5)]
    if grad:
        ins = [x.requires_grad_(True) for x in ins]
    return ins


def _gru(rng, grad=False):
    h = 4
    ins = [_f32(rng, 3, 5, 3 * h), _f32(rng, h, 2 * h, scale=0.5),
           _f32(rng, h, h, scale=0.5), _f32(rng, 3 * h, scale=0.5)]
    if grad:
        ins = [x.requires_grad_(True) for x in ins]
    return ins


def _tables(rng):
    t = _f32(rng, 11, 1, 4)
    return [t, torch.abs(_f32(rng, 11, 1, 4))]


IDS = torch.tensor([1, 3, 3, 7, 12, 0])


def _cases():
    """(op name, case name, args) for opcheck."""
    rng = _rng(0)
    out = []
    for dtype in (torch.float32, torch.bfloat16):
        for res in (True, False):
            for act in ("relu", ""):
                tag = f"{str(dtype)[6:]}_{'res' if res else 'nores'}_{act}"
                out.append(("bn_act_conv1x1_fwd", tag,
                            (*_bn(rng, dtype, res, grad=True), act)))
                u, sc, sh, w, r, y, dy, d1, d2 = _bn_bwd(rng, dtype, res)
                out.append(("bn_act_conv1x1_bwd_dx", tag,
                            (u, sc, sh, w, r, y, dy, d1, d2, act)))
                out.append(("bn_act_conv1x1_bwd_dw", tag,
                            (u, sc, sh, r, y, dy, d1, d2, act)))
        kv = torch.tensor([6, 3], dtype=torch.int32)
        ql = torch.tensor([5, 6], dtype=torch.int32)
        d = str(dtype)[6:]
        out.append(("flash_attention_fwd", f"{d}_causal_kvlen",
                    (*_attn(rng, dtype, grad=True), True, kv, None, None)))
        out.append(("flash_attention_fwd", f"{d}_cross_qlen_scale",
                    (*_attn(rng, dtype, grad=True), False, None, ql, -0.3)))
        q, k, v, dout, lse, delta, kvl = _attn_bwd(rng, dtype)
        for name in ("flash_attention_bwd_dkv", "flash_attention_bwd_dq"):
            out.append((name, d, (q, k, v, dout, lse, delta, True, kvl, None,
                                  None)))
        # a head dim the card runs as a D-split (> 128)
        out.append(("flash_attention_fwd", f"{d}_d160_causal_kvlen",
                    (*_attn(rng, dtype, grad=True, d=160), True, kv, None,
                     None)))
        q, k, v, dout, lse, delta, kvl = _attn_bwd(rng, dtype, d=160)
        for name in ("flash_attention_bwd_dkv", "flash_attention_bwd_dq"):
            out.append((name, f"{d}_d160", (q, k, v, dout, lse, delta, True,
                                            kvl, None, None)))
    x, w, b7 = _lstm(rng, grad=True)
    out.append(("lstm_seq_fwd", "train", (x, w, b7, LENS, True, None)))
    out.append(("lstm_seq_fwd", "infer", (*(t.detach() for t in (x, w, b7)),
                                          LENS, False, None)))
    x, w, b7 = _lstm(rng)
    y, c = rnn.lstm_fwd_op(x, w, b7, LENS, True)
    out.append(("lstm_seq_bwd", "", (x, w, b7, LENS, y, c,
                                     _f32(rng, *y.shape), None)))
    out.append(("gru_seq_fwd", "", (*_gru(rng, grad=True), LENS, None)))
    g = _gru(rng)
    y = rnn.gru_fwd_op(*g, LENS)
    out.append(("gru_seq_bwd", "", (*g, LENS, y, _f32(rng, *y.shape), None)))
    g = _f32(rng, IDS.shape[0], 4)
    out.append(("sparse_row_update", "momentum",
                (_tables(rng), IDS, g, "momentum", 0.1, 0.9, 4, 10)))
    out.append(("sparse_row_update", "sgd",
                (_tables(rng)[:1], IDS, g, "sgd", 0.1, 0.0, 3, 10)))
    out.append(("sparse_row_gather", "", (_tables(rng), IDS, g, 4, 10)))
    uids = torch.tensor([0, 1, 3, -1], dtype=torch.int32)
    out.append(("sparse_row_scatter", "",
                (_tables(rng), [_f32(rng, 4, 4), _f32(rng, 4, 4)], uids,
                 10)))
    return out


CASES = _cases()


def _op(name):
    return getattr(torch.ops.paddle_tpu_torch, name).default


def test_every_kernel_entry_point_is_a_registered_op():
    assert sorted(_library.OPS) == sorted(OPS)
    for name in OPS:
        qual = f"{_library.NAMESPACE}::{name}"
        for key in ("CUDA", "CPU", "Meta"):
            assert torch._C._dispatch_has_kernel_for_dispatch_key(
                qual, key), (name, key)
        assert torch._C._dispatch_has_kernel_for_dispatch_key(
            qual, "Autograd") == (name in FORWARD_OPS), name
    # each op of the list above is reached from a case of opcheck
    assert {c[0] for c in CASES} == set(OPS)


def test_no_implementation_for_another_device():
    """Only CUDA and CPU tensors (and fake ones) find an implementation:
    no composite kernel would catch another backend's tensor."""
    for name in OPS:
        qual = f"{_library.NAMESPACE}::{name}"
        for key in ("CompositeImplicitAutograd", "CompositeExplicitAutograd",
                    "XPU", "MPS", "PrivateUse1"):
            assert not torch._C._dispatch_has_kernel_for_dispatch_key(
                qual, key), (name, key)


@pytest.mark.parametrize("name,tag,args", CASES,
                         ids=[f"{n}-{t}" for n, t, _ in CASES])
def test_opcheck_on_cpu_tensors(name, tag, args):
    torch.library.opcheck(_op(name), args)


def _fake_like(mode, x):
    if torch.is_tensor(x):
        return mode.from_tensor(x)
    if isinstance(x, list):
        return [_fake_like(mode, t) for t in x]
    return x


def _flat(out):
    if torch.is_tensor(out):
        return [out]
    if out is None:
        return []
    return [t for o in out for t in _flat(o)]


@pytest.mark.parametrize("name,tag,args", CASES,
                         ids=[f"{n}-{t}" for n, t, _ in CASES])
def test_fake_outputs_match_real(name, tag, args):
    args = tuple([t.clone() for t in a] if isinstance(a, list)
                 else a.detach() if torch.is_tensor(a) else a for a in args)
    real = _flat(_op(name)(*args))
    with FakeTensorMode() as mode:
        fake = _flat(_op(name)(*(_fake_like(mode, a) for a in args)))
    assert len(fake) == len(real)
    for f, r in zip(fake, real):
        assert (tuple(f.shape), f.dtype, f.device) == (
            tuple(r.shape), r.dtype, r.device), name


# ---- gradients through the ops against the JAX custom VJPs ---------------
@pytest.mark.parametrize("act,res", [("relu", True), ("", False)])
def test_bn_act_conv1x1_gradients_match_jax(act, res):
    u, sc, sh, w, r = _bn(_rng(2), res=res, grad=True)
    rng = _rng(3)
    dy, d1, d2 = (_f32(rng, 24, 8), _f32(rng, 8), _f32(rng, 8))
    y, s1, s2 = fop.bn_act_conv1x1(u, sc, sh, w, r, act)
    leaves = [x for x in (u, sc, sh, w, r) if x is not None]
    got = torch.autograd.grad((y * dy).sum() + (s1 * d1).sum()
                              + (s2 * d2).sum(), leaves)
    jargs = [jnp.asarray(x.detach().numpy()) for x in leaves]

    def f(*a):
        return jfused(*a[:4], residual=a[4] if res else None, act=act)

    _out, vjp = jax.vjp(f, *jargs)
    want = vjp(tuple(jnp.asarray(x.numpy()) for x in (dy, d1, d2)))
    for name, g, j in zip(("du", "dscale", "dshift", "dw", "dres"), got,
                          want):
        _close(g.numpy(), j, name)


def test_flash_attention_gradients_match_jax():
    q, k, v = _attn(_rng(4), grad=True)
    kv = torch.tensor([6, 4], dtype=torch.int32)
    dout = _f32(_rng(5), *q.shape)
    out, _lse = fa.flash_attention(q, k, v, causal=True, kv_len=kv)
    got = torch.autograd.grad((out * dout).sum(), (q, k, v))

    def f(q, k, v):
        return jring.flash_blocked_attention(
            q, k, v, causal=True, kv_len=jnp.asarray(kv.numpy()), block_k=4)

    _y, vjp = jax.vjp(f, *(jnp.asarray(x.detach().numpy())
                           for x in (q, k, v)))
    for name, g, j in zip(("dq", "dk", "dv"), got,
                          vjp(jnp.asarray(dout.numpy()))):
        _close(g.numpy(), j, name)


def test_lstm_gradients_match_jax():
    x, w, b7 = _lstm(_rng(6), grad=True)
    dy = _f32(_rng(7), 3, 5, 4)
    y = rnn.lstm_seq(x, w, b7, LENS)
    got = torch.autograd.grad((y * dy).sum(), (x, w, b7))
    h = 4
    parts = np.split(b7.detach().numpy(), [4 * h, 5 * h, 6 * h])

    def f(x, w, *b):
        return jrnn.lstm_fused(x, w, *b, jnp.asarray(LENS.numpy()), True)

    _y, vjp = jax.vjp(f, jnp.asarray(x.detach().numpy()),
                      jnp.asarray(w.detach().numpy()),
                      *(jnp.asarray(p) for p in parts))
    jx, jw, *jb = vjp(jnp.asarray(dy.numpy()))
    _close(got[0].numpy(), jx, "dx")
    _close(got[1].numpy(), jw, "dw")
    _close(got[2].numpy(), np.concatenate([np.asarray(p) for p in jb]),
           "db7")


def test_gru_gradients_match_jax():
    args = _gru(_rng(8), grad=True)
    dy = _f32(_rng(9), 3, 5, 4)
    y = rnn.gru_seq(*args, LENS)
    got = torch.autograd.grad((y * dy).sum(), args)

    def f(*a):
        return jrnn.gru_fused(*a, jnp.asarray(LENS.numpy()), True)

    _y, vjp = jax.vjp(f, *(jnp.asarray(a.detach().numpy()) for a in args))
    for name, g, j in zip(("dx", "dw_g", "dw_c", "db"), got,
                          vjp(jnp.asarray(dy.numpy()))):
        _close(g.numpy(), j, name)


@pytest.mark.parametrize("op", ["lstm", "gru"])
def test_autograd_kernel_fills_left_out_defaults(op):
    """The dispatcher hands the ops' Autograd kernel no trailing argument
    left at its default (`route`): a forward op called without it
    differentiates as one called with it, and under no_grad returns the
    same outputs."""
    if op == "lstm":
        leaves = _lstm(_rng(10), grad=True)
        call = (lambda *a: rnn.lstm_fwd_op(*leaves, LENS, True, *a)[0])
    else:
        leaves = _gru(_rng(10), grad=True)
        call = (lambda *a: rnn.gru_fwd_op(*leaves, LENS, *a))
    dy = _f32(_rng(11), 3, 5, 4)
    short = torch.autograd.grad((call() * dy).sum(), leaves)
    full = torch.autograd.grad((call(None) * dy).sum(), leaves)
    for a, b in zip(short, full):
        assert torch.equal(a, b)
    with torch.no_grad():
        assert torch.equal(call(), call(None))


def test_sparse_ops_declare_their_mutations():
    """The rule op and the scatter op mutate the tables they are given,
    in place, and nothing else; the gather op mutates nothing."""
    tabs = _tables(_rng(10))
    before = [t.clone() for t in tabs]
    ptrs = [t.data_ptr() for t in tabs]
    sr.sparse_rows(sr.RowRule("momentum", 0.1, 0.9), tabs, IDS,
                   _f32(_rng(11), 6, 4), 4, 10)
    assert [t.data_ptr() for t in tabs] == ptrs
    assert not torch.equal(tabs[0], before[0])
    for schema_name, mutated in (("sparse_row_update", True),
                                 ("sparse_row_gather", False),
                                 ("sparse_row_scatter", True)):
        schema = _op(schema_name)._schema
        assert schema.arguments[0].alias_info is not None and \
            schema.arguments[0].alias_info.is_write == mutated or (
                not mutated and schema.arguments[0].alias_info is None)
