"""The port's flash-attention backward against the JAX package's.

The same numpy q, k, v and output gradient go through
`jax.vjp(paddle_tpu/parallel/ring.py::flash_blocked_attention)` (the
blocked oracle whose custom VJP, `_flash_blocked_bwd`, states the
contract the TPU kernels implement) and through the port's
`ops/flash_attention.attention_bwd_plain` and the custom op's autograd
formula behind `parallel/ring.flash_dense_attention`. f32 on the CPU in
both: rtol = atol = 1e-5 (the summation orders differ).

The JAX function has no `q_len`: for cross-attention the output
gradient of rows at or past q_len is 0 there (the attention layer
zeroes those rows), so dk and dv agree, dq agrees on the live rows,
and the port's dq of the dead rows is exactly 0.

`test_emulated_kernel_arithmetic_holds_f32_accuracy` runs the
kernels' tensor-core arithmetic (`csrc/flash_attn_bwd.cu`) in numpy.

`TestOnCard` (marked `cuda`) holds the Hopper kernels against
attention_bwd_plain on the card, checks that they are bit-identical on
a repeat and shows that `loss.backward()` through
flash_dense_attention reaches q, k and v. It skips here; on a machine
with an H100 and no JAX it runs alone:
`python -m pytest -m cuda tests/test_torch_flash_bwd.py`.
"""

import numpy as np
import pytest
import torch

try:  # the CPU parity tests need JAX; the on-card tests do not
    import jax
    import jax.numpy as jnp
    from jax.experimental.pallas import tpu as pltpu

    from paddle_tpu.parallel import ring as jring
except ImportError:
    jax = None

from paddle_tpu_torch.ops import flash_attention as fa
from paddle_tpu_torch.parallel import ring as tring

TOL = 1e-5
BF16 = torch.bfloat16
# bf16 gradients are held element by element within one bf16 ulp of the
# reference plus a fraction of its largest entry: p and ds are rounded to
# bf16 in both, but from an s and a dp summed in another order, and the
# library's T = 128 forward rounds p after normalising it. Readings
# (BF16_CASES against the library kernel in interpret mode, the largest
# beyond one ulp over the largest entry): dq 3.4e-3, dk 2.4e-3, dv 1.7e-4.
BF16_GRAD_FRAC = 5e-3

# (B, Tq, Tk, H, D, causal, kv_len, q_len), as tests/test_torch_attention.py's
BF16_CASES = {
    "causal_ragged_t200_d64": (2, 200, 200, 2, 64, True, [200, 77], None),
    "cross_qlen_d32": (2, 100, 200, 2, 32, False, [200, 120], [100, 40]),
    "causal_kvlen0_row_d96": (2, 200, 200, 2, 96, True, [0, 150], None),
    "causal_full_t128_d40": (1, 128, 128, 2, 40, True, None, None),
}

# name: (B, Tq, Tk, H, D, causal, kv_len, q_len, block_k)
CASES = {
    "causal_full": (2, 48, 48, 2, 16, True, None, None, 512),
    "noncausal_full": (2, 40, 40, 2, 16, False, None, None, 512),
    "causal_ragged_kvlen0": (3, 37, 37, 2, 8, True, [37, 20, 0], None, 512),
    "noncausal_ragged_kvlen0": (3, 29, 29, 3, 8, False, [29, 5, 0], None,
                                512),
    "cross_qlen": (2, 21, 45, 2, 16, False, [45, 30], [13, 21], 512),
    "causal_block_k_lt_t": (2, 37, 37, 2, 16, True, [37, 25], None, 16),
    "noncausal_block_k_lt_t": (2, 33, 33, 2, 8, False, [9, 33], None, 8),
}

# the kernels instantiate head dims 32, 64, 96 and 128; the wrapper pads
# the others (40, 48)
CARD_CASES = {
    "causal_full_d64": (2, 128, 128, 2, 64, True, None, None),
    "causal_ragged_d64": (3, 150, 150, 2, 64, True, [150, 70, 1], None),
    "causal_odd_t_d32": (2, 77, 77, 3, 32, True, [77, 40], None),
    "noncausal_kvlen0_d32": (2, 64, 64, 2, 32, False, [0, 64], None),
    "cross_qlen_d128": (2, 64, 200, 2, 128, False, [200, 123], [50, 64]),
    "causal_ragged_d40": (2, 150, 150, 2, 40, True, [150, 71], None),
    "noncausal_kvlen0_d48": (2, 64, 64, 2, 48, False, [0, 64], None),
    "cross_qlen_d96": (2, 70, 133, 2, 96, False, [133, 64], [70, 9]),
    # LM training's long shape: a key's dk and dv sum over 16 query tiles
    "causal_t1024_ragged_d64": (2, 1024, 1024, 2, 64, True, [1024, 333],
                                None),
}


# the bf16 kernels' tile edges, as tests/test_torch_attention.py's
# BF16_EDGE_CASES (128-key and 128-query blocks, 64-key and 64- or 32-query
# walked tiles): T one short of and one past a tile, a kv_len ending
# mid-tile, Tq != Tk with q_len and a kv_len = 0 row, and K, V rows past
# kv_len holding NaN, at every head dim the wrapper takes
BF16_EDGE_CASES = {
    f"{name}_d{D}": (*case[:4], D, *case[4:])
    for D in (32, 64, 96, 128)
    for name, case in {
        "causal_t127_ragged": (2, 127, 127, 2, True, [127, 70], None),
        "causal_t129": (1, 129, 129, 2, True, None, None),
        "causal_t200_kvlen_mid_tile": (2, 200, 200, 2, True, [200, 150],
                                       None),
        "cross_tq129_tk200_qlen_kvlen0": (2, 129, 200, 2, False, [0, 77],
                                          [129, 100]),
        "causal_t200_nan_past_kvlen": (2, 200, 200, 2, True, [130, 61],
                                       None),
    }.items()
}


def nan_past_kv_len(x, kv):
    """A copy of k or v [B, T, H, D] with every row at or past kv_len[b]
    set to NaN."""
    x = x.clone()
    for b, n in enumerate(kv.tolist()):
        x[b, n:] = float("nan")
    return x


def needs_jax():
    if jax is None:
        pytest.skip("the CPU parity tests need JAX")


def _inputs(case, seed=0):
    B, Tq, Tk, H, D, causal, kv_len, q_len = case[:8]
    rng = np.random.default_rng(seed)
    q = rng.standard_normal((B, Tq, H, D)).astype(np.float32)
    k = rng.standard_normal((B, Tk, H, D)).astype(np.float32)
    v = rng.standard_normal((B, Tk, H, D)).astype(np.float32)
    do = rng.standard_normal((B, Tq, H, D)).astype(np.float32)
    kv = None if kv_len is None else np.asarray(kv_len, np.int32)
    ql = None if q_len is None else np.asarray(q_len, np.int32)
    if ql is not None:
        # the attention layer zeroes rows past q_len, so their output
        # gradient is 0
        do = do * (np.arange(Tq)[None, :] < ql[:, None])[..., None, None]
    return q, k, v, do, causal, kv, ql


def _t(x):
    return None if x is None else torch.from_numpy(x)


def _jax_grads(case):
    q, k, v, do, causal, kv, _ql = _inputs(case)
    kvj = None if kv is None else jnp.asarray(kv)

    def f(q, k, v):
        return jring.flash_blocked_attention(q, k, v, causal=causal,
                                             kv_len=kvj,
                                             block_k=case[8])

    _out, vjp = jax.vjp(f, jnp.asarray(q), jnp.asarray(k), jnp.asarray(v))
    return [np.asarray(g) for g in vjp(jnp.asarray(do))]


def _live_rows(B, Tq, ql):
    """[B, Tq] bool: rows before q_len (all rows without it)."""
    if ql is None:
        return np.ones((B, Tq), bool)
    return np.arange(Tq)[None, :] < ql[:, None]


def _check(case, got):
    q, _k, _v, _do, _causal, _kv, ql = _inputs(case)
    ref = _jax_grads(case)
    live = _live_rows(q.shape[0], q.shape[1], ql)
    dq, dk, dv = (g.detach().numpy() for g in got)
    np.testing.assert_allclose(dq[live], ref[0][live], rtol=TOL, atol=TOL)
    assert (dq[~live] == 0).all()
    np.testing.assert_allclose(dk, ref[1], rtol=TOL, atol=TOL)
    np.testing.assert_allclose(dv, ref[2], rtol=TOL, atol=TOL)


@pytest.mark.parametrize("name", sorted(CASES))
def test_plain_backward_matches_jax_vjp(name):
    needs_jax()
    q, k, v, do, causal, kv, ql = (_t(x) if isinstance(x, np.ndarray)
                                   else x for x in _inputs(CASES[name]))
    kw = dict(causal=causal, kv_len=kv, q_len=ql)
    out, lse = fa.attention_plain(q, k, v, **kw)
    _check(CASES[name], fa.attention_bwd_plain(q, k, v, out, lse, do, **kw))


@pytest.mark.parametrize("name", sorted(CASES))
def test_autograd_function_matches_jax_vjp(name):
    needs_jax()
    q, k, v, do, causal, kv, ql = (_t(x) if isinstance(x, np.ndarray)
                                   else x for x in _inputs(CASES[name]))
    leaves = [x.clone().requires_grad_(True) for x in (q, k, v)]
    before = (fa.launches, fa.bwd_dkv_launches, fa.bwd_dq_launches)
    out = tring.flash_dense_attention(*leaves, causal=causal, kv_len=kv,
                                      q_len=ql)
    out.backward(do)
    # CPU tensors take the plain versions: no kernel launch is counted
    assert (fa.launches, fa.bwd_dkv_launches, fa.bwd_dq_launches) == before
    _check(CASES[name], [x.grad for x in leaves])


def test_rows_without_keys_get_no_gradient():
    """A batch row with kv_len = 0 (lse = 1e30) has dq exactly 0 and
    adds nothing to dk/dv: its keys' gradients are exactly 0 too."""
    q, k, v, do, causal, kv, ql = (_t(x) if isinstance(x, np.ndarray)
                                   else x for x in
                                   _inputs(CASES["causal_ragged_kvlen0"]))
    out, lse = fa.attention_plain(q, k, v, causal=causal, kv_len=kv)
    assert (lse[2] == fa.LSE_MASKED).all() and (out[2] == 0).all()
    dq, dk, dv = fa.attention_bwd_plain(q, k, v, out, lse, do,
                                        causal=causal, kv_len=kv)
    assert (dq[2] == 0).all() and (dk[2] == 0).all() and (dv[2] == 0).all()
    # masked keys of a live row get no gradient either
    assert (dk[1, 20:] == 0).all() and (dv[1, 20:] == 0).all()
    # padded query rows of self-attention are live (they see the valid
    # keys): a nonzero output gradient there reaches dq
    assert (dq[1, 20:] != 0).any()


# ---- the bf16 forms -------------------------------------------------------

def bf16_close(got, ref, frac, name):
    """Element by element within one bf16 ulp of the reference plus
    `frac` of its largest entry."""
    got, ref = (torch.from_numpy(np.array(x, np.float32)) for x in (got,
                                                                    ref))
    ulp = torch.ldexp(torch.ones_like(ref), torch.frexp(ref)[1] - 8)
    beyond = (got - ref).abs() - ulp
    top = ref.abs().max()
    bad = beyond > frac * top
    assert not bad.any(), (
        f"{name}: {int(bad.sum())} of {bad.numel()} elements off, worst "
        f"{(beyond.max() / top).item():.3g} of the largest beyond an ulp")


def _bf16_inputs(case, seed=0):
    """q, k, v and dout rounded to bf16 (numpy f32 holding bf16 values);
    dout is 0 on the rows the attention layer zeroes (at or past q_len,
    or else kv_len: the library's padding segment)."""
    B, Tq, Tk, H, D, causal, kv_len, q_len = case
    rng = np.random.default_rng(seed)
    q, k, v, do = (torch.from_numpy(rng.standard_normal(
        (B, t, H, D)).astype(np.float32)).to(BF16).float().numpy()
        for t in (Tq, Tk, Tk, Tq))
    kv = None if kv_len is None else np.asarray(kv_len, np.int32)
    ql = None if q_len is None else np.asarray(q_len, np.int32)
    n = ql if ql is not None else kv if kv is not None else [Tq] * B
    do = do * (np.arange(Tq)[None, :] < np.asarray(n)[:, None])[
        ..., None, None]
    return q, k, v, do, causal, kv, ql


@pytest.mark.parametrize("name", sorted(BF16_CASES))
def test_bf16_plain_backward_matches_library_vjp(name):
    """attention_bwd_plain_bf16 (from attention_plain_bf16's out and
    lse) against `jax.vjp` of the JAX package's TPU path
    (`flash_dense_attention(impl="pallas")`: the library's dkv and dq
    kernels, in interpret mode) on the same bf16 inputs: dq, dk and dv
    bf16, within one bf16 ulp plus BF16_GRAD_FRAC of the largest
    entry."""
    needs_jax()
    q, k, v, do, causal, kv, ql = _bf16_inputs(BF16_CASES[name])
    jb = lambda x: jnp.asarray(x, jnp.bfloat16)   # noqa: E731

    def f(q, k, v):
        return jring.flash_dense_attention(
            q, k, v, causal=causal,
            kv_len=None if kv is None else jnp.asarray(kv),
            q_len=None if ql is None else jnp.asarray(ql), impl="pallas")

    with pltpu.force_tpu_interpret_mode():
        _out, vjp = jax.vjp(f, jb(q), jb(k), jb(v))
        ref = [np.asarray(g.astype(jnp.float32)) for g in vjp(jb(do))]
    tq, tk, tv, tdo = (torch.from_numpy(x).to(BF16) for x in (q, k, v, do))
    kw = dict(causal=causal, kv_len=_t(kv), q_len=_t(ql))
    out, lse = fa.attention_plain_bf16(tq, tk, tv, **kw)
    got = fa.attention_bwd_plain_bf16(tq, tk, tv, out, lse, tdo, **kw)
    for n, g, r in zip(("dq", "dk", "dv"), got, ref):
        assert g.dtype == BF16, n
        bf16_close(g.float().numpy(), r, BF16_GRAD_FRAC, f"{name} {n}")


def _flash_bwd_bf16_emulated(q, k, v, out, lse, do, causal, kv_len, exp2):
    """csrc/flash_attn_bwd.cu's bf16 forms' arithmetic in torch for
    [B, T, H, D] bf16 q, k, v, out, dout: s and dp from the bf16
    operands in f32, p and ds = p * (dp - delta) * scale in f32 (0 where
    masked), each rounded to bf16 before its products, every sum in f32,
    the outputs rounded to bf16. exp2=False is the first bf16 kernels'
    exponential (p = exp(s * scale - lse)); exp2=True the wgmma kernels'
    (p = 2^fma(s, c, -lse * log2(e)) with c = scale * log2(e), the
    product lse * log2(e) rounded to f32 as the producer warp stores it;
    the FMA's one rounding emulated in f64). Returns (dq, dk, dv)."""
    B, T, H, D = q.shape
    scale = np.float32(1.0 / np.sqrt(D))
    qf, kf, vf, dof = (x.float() for x in (q, k, v, do))
    raw = torch.einsum("bqhd,bkhd->bhqk", qf, kf)
    valid = fa._visible(B, T, T, causal, kv_len, None, q.device)
    if exp2:
        c = np.float64(np.float32(scale * np.log2(np.e)))
        lse2 = (lse * np.float32(np.log2(np.e))).double()[..., None]
        p = torch.exp2((raw.double() * c - lse2).float())
    else:
        p = torch.exp(raw * scale - lse[..., None])
    p = torch.where(valid, p, 0.0)
    dp = torch.einsum("bqhd,bkhd->bhqk", dof, vf)
    ds = torch.where(valid, p * (dp - fa.row_delta(do, out)[..., None])
                     * scale, 0.0)
    p, ds = p.to(BF16).float(), ds.to(BF16).float()
    dq = torch.einsum("bhqk,bkhd->bqhd", ds, kf)
    dk = torch.einsum("bhqk,bqhd->bkhd", ds, qf)
    dv = torch.einsum("bhqk,bqhd->bkhd", p, dof)
    return tuple(x.to(BF16) for x in (dq, dk, dv))


@pytest.mark.parametrize("exp2", [False, True], ids=["exp", "exp2"])
def test_emulated_bf16_backward_is_within_the_card_bound(exp2):
    """The bf16 backward kernels' arithmetic, emulated with either
    exponential, at T = 1024 causal with a ragged kv_len, from the bf16
    plain forward's out and lse: dq, dk and dv within one bf16 ulp plus
    BF16_GRAD_FRAC of the largest entry of attention_bwd_plain_bf16 (the
    card's bound; the rounding points are the plain version's), and no
    farther from the f32 plain backward on the same inputs than the bf16
    plain version is, within one bf16 ulp of the largest entry."""
    rng = np.random.default_rng(6)
    q, k, v, do = (torch.from_numpy(rng.standard_normal(
        (2, 1024, 2, 64)).astype(np.float32)).to(BF16) for _ in range(4))
    kw = dict(causal=True, kv_len=torch.tensor([1000, 333], dtype=torch.int32))
    out, lse = fa.attention_plain_bf16(q, k, v, **kw)
    got = _flash_bwd_bf16_emulated(q, k, v, out, lse, do, exp2=exp2, **kw)
    plain = fa.attention_bwd_plain_bf16(q, k, v, out, lse, do, **kw)
    out32, lse32 = fa.attention_plain(q, k, v, **kw)
    exact = fa.attention_bwd_plain(q, k, v, out32, lse32, do, **kw)
    for n, g, r, e in zip(("dq", "dk", "dv"), got, plain, exact):
        bf16_close(g.float().numpy(), r.float().numpy(), BF16_GRAD_FRAC,
                   f"emulated {n}")
        top = e.abs().max()
        ulp = torch.ldexp(torch.ones_like(top), torch.frexp(top)[1] - 8)
        assert ((g.float() - e).abs().max()
                <= (r.float() - e).abs().max() + ulp), n


def test_bf16_backward_takes_delta_in_f32_and_returns_bf16(monkeypatch):
    """flash_attention_bwd on bf16 tensors (the CPU: the bf16 plain
    version) forms delta = sum_d dout * out in f32 and returns dq, dk, dv
    in bf16, launching nothing; the op's autograd formula hands bf16
    gradients to bf16 leaves."""
    q, k, v, do, causal, kv, ql = _bf16_inputs(
        BF16_CASES["causal_ragged_t200_d64"])
    q, k, v, do = (torch.from_numpy(x).to(BF16) for x in (q, k, v, do))
    kw = dict(causal=causal, kv_len=_t(kv), q_len=_t(ql))
    deltas = []
    row_delta = fa.row_delta

    def watched(dout, out):
        deltas.append(row_delta(dout, out))
        return deltas[-1]

    monkeypatch.setattr(fa, "row_delta", watched)
    out, lse = fa.flash_attention(q, k, v, **kw)
    before = [getattr(fa, n) for n in fa.COUNTERS]
    got = fa.flash_attention_bwd(q, k, v, out, lse, do, **kw)
    assert [getattr(fa, n) for n in fa.COUNTERS] == before
    assert [d.dtype for d in deltas] == [torch.float32]
    assert [g.dtype for g in got] == [BF16] * 3
    ref = fa.attention_bwd_plain_bf16(q, k, v, out, lse, do, **kw)
    assert all(torch.equal(a, b) for a, b in zip(got, ref))
    leaves = [x.clone().requires_grad_(True) for x in (q, k, v)]
    y = tring.flash_dense_attention(*leaves, **kw)
    assert y.dtype == BF16
    y.backward(do)
    assert all(x.grad.dtype == BF16 for x in leaves)
    assert all(torch.equal(x.grad, r) for x, r in zip(leaves, ref))
    with pytest.raises(ValueError, match="one dtype"):
        fa.flash_attention_bwd(q, k, v, out, lse, do.float(), **kw)


def _tf32(x):
    """x (f32) rounded to TF32 as `cvt.rna.tf32.f32` rounds (a copy of
    tests/test_torch_attention.py's helper)."""
    bits = np.ascontiguousarray(x, np.float32).view(np.uint32)
    return ((bits + np.uint32(0x1000)) & np.uint32(0xFFFFE000)).view(
        np.float32)


def _split(x):
    """The kernels' split_tf32_alu: hi rounded to TF32, lo = x - hi
    truncated to TF32 (low 13 bits cleared)."""
    hi = _tf32(x)
    lo = (np.ascontiguousarray(x - hi, np.float32).view(np.uint32)
          & np.uint32(0xFFFFE000)).view(np.float32)
    return hi, lo


def _trunc_add(acc, x):
    """acc (f32) + x (f64) rounded toward zero to f32: the tensor cores'
    add of a product into their accumulator, as modelled here."""
    s = acc + x
    r = s.astype(np.float32)
    # rounded away from zero: one step back (sign and magnitude bits)
    return (r.view(np.uint32) - (np.abs(r) > np.abs(s))).view(np.float32)


def _mm3(a, b):
    """a @ b (f32, 2-D, a's columns a multiple of 8) as the kernels form
    it on mma.sync: hi/lo TF32 splits of both operands; for each k-step
    of 8 the three products lo*hi, hi*lo, hi*hi (small terms first), each
    summed exactly and added into one f32 accumulator that starts at 0,
    rounded toward zero."""
    (a_hi, a_lo), (b_hi, b_lo) = _split(a), _split(b)
    M, K = a.shape

    def steps(x, y):  # [K / 8, M, N] f64: each k-step's products
        x3 = torch.from_numpy(x.astype(np.float64)).reshape(M, K // 8, 8)
        y3 = torch.from_numpy(y.astype(np.float64)).reshape(K // 8, 8, -1)
        return torch.bmm(x3.permute(1, 0, 2), y3).numpy()

    parts = [steps(a_lo, b_hi), steps(a_hi, b_lo), steps(a_hi, b_hi)]
    acc = np.zeros((M, b.shape[1]), np.float32)
    for s in range(K // 8):
        for p in parts:
            acc = _trunc_add(acc, p[s])
    return acc


# inside each group of 8 of a product's k (queries for dV and dK, keys for
# dQ), the A fragment's column k holds PERM[k]: k = t is 2t, k = t + 4 is
# 2t + 1
PERM = np.asarray([0, 2, 4, 6, 1, 3, 5, 7])


def _flash_bwd_emulated(q, k, v, do, lse, delta, kv_len, block=64):
    """csrc/flash_attn_bwd.cu's arithmetic in numpy for one (b, h),
    causal: q, do [T, D], k, v [T, D], lse, delta [T] f32. dkv: each
    64-key tile walks the query tiles from its own; dq: each 64-query
    tile walks the key tiles up to its last one; at D <= 64 two walk
    groups take a walk's tiles in turn (the walks here reach 16 tiles),
    each with its own sums, added in order at the end. Every product in
    3xTF32 with truncating adds (_mm3); P and dS with the mask tested a
    pair (p = 0 exactly); the second products' k permuted in groups of 8
    (A's columns and B's rows alike); each tile's product into a fresh
    accumulator added to the running sum in round-to-nearest f32.
    Returns (dq, dk, dv)."""
    T, D = q.shape
    groups = 2 if D <= 64 else 1
    scale = np.float32(1.0 / np.sqrt(D))
    perm = (np.arange(block) // 8) * 8 + PERM[np.arange(block) % 8]

    def tile(x, r0, lim):
        out = np.zeros((block, D), np.float32)
        n = max(0, min(block, lim - r0))
        out[:n] = x[r0:r0 + n]
        return out

    def p_ds(s_t, dp_t, rows, cols, row_lse, row_delta):
        vis = (cols[None, :] < kv_len) & (cols[None, :] <= rows[:, None])
        p = np.where(vis, np.exp(s_t * scale - row_lse[:, None]),
                     0).astype(np.float32)
        ds = (p * (dp_t - row_delta[:, None]) * scale).astype(np.float32)
        return p, ds

    def _in_order(parts):
        out = parts[0]
        for x in parts[1:]:
            out = out + x
        return out

    dk = np.zeros((T, D), np.float32)
    dv = np.zeros((T, D), np.float32)
    for k0 in range(0, min(kv_len, T), block):
        kt, vt = tile(k, k0, kv_len), tile(v, k0, kv_len)
        keys = k0 + np.arange(block)
        dks = np.zeros((groups, block, D), np.float32)
        dvs = np.zeros((groups, block, D), np.float32)
        for i0 in range(k0, T, block):
            grp = (i0 - k0) // block % groups
            qt, dot = tile(q, i0, T), tile(do, i0, T)
            lt, dlt = np.zeros(block, np.float32), np.zeros(block, np.float32)
            n = min(block, T - i0)
            lt[:n], dlt[:n] = lse[i0:i0 + n], delta[i0:i0 + n]
            s_t = _mm3(kt, np.ascontiguousarray(qt.T))      # S^T
            dp_t = _mm3(vt, np.ascontiguousarray(dot.T))    # dP^T
            # visibility by (query, key): transpose in, transpose out
            p, ds = p_ds(s_t.T, dp_t.T, i0 + np.arange(block), keys, lt,
                         dlt)
            dvs[grp] += _mm3(np.ascontiguousarray(p.T[:, perm]), dot[perm])
            dks[grp] += _mm3(np.ascontiguousarray(ds.T[:, perm]), qt[perm])
        dks, dvs = _in_order(dks), _in_order(dvs)
        n = min(block, T - k0)
        live = keys[:n] < kv_len
        dk[k0:k0 + n] = np.where(live[:, None], dks[:n], 0)
        dv[k0:k0 + n] = np.where(live[:, None], dvs[:n], 0)

    dq = np.zeros((T, D), np.float32)
    for q0 in range(0, T, block):
        qt, dot = tile(q, q0, T), tile(do, q0, T)
        rows = q0 + np.arange(block)
        rl = np.zeros(block, np.float32)
        rd = np.zeros(block, np.float32)
        n = min(block, T - q0)
        rl[:n], rd[:n] = lse[q0:q0 + n], delta[q0:q0 + n]
        dqs = np.zeros((groups, block, D), np.float32)
        for k0 in range(0, min(kv_len, q0 + block), block):
            grp = k0 // block % groups
            kt, vt = tile(k, k0, kv_len), tile(v, k0, kv_len)
            s = _mm3(qt, np.ascontiguousarray(kt.T))
            dp = _mm3(dot, np.ascontiguousarray(vt.T))
            _p, ds = p_ds(s, dp, rows, k0 + np.arange(block), rl, rd)
            dqs[grp] += _mm3(np.ascontiguousarray(ds[:, perm]), kt[perm])
        dq[q0:q0 + n] = _in_order(dqs)[:n]
    return dq, dk, dv


@pytest.mark.parametrize("D", [64, 128])
def test_emulated_kernel_arithmetic_holds_f32_accuracy(D):
    """The backward kernels' tensor-core arithmetic, emulated, at T = 1024
    causal with a ragged kv_len: dq, dk and dv within 1e-5 of the largest
    entry of the f64 result. 1e-5: each 3xTF32 product keeps ~2^-21 of
    each term, its truncating adds chain over one tile only, and a
    tile's sum is added once in round-to-nearest f32, so the error stays
    within a few f32 roundings (1.5e-6 to 5.8e-6 here); a lost lo pass
    or a wrong permutation would exceed it, and so would, at D = 128,
    truncating adds chained over the 16 tiles (~2.3e-5; ~1e-5 at D =
    64). lse and delta come from the f32 forward, as the kernels receive
    them."""
    B, T = 2, 1024
    rng = np.random.default_rng(D)
    q, k, v, do = (rng.standard_normal((B, T, 1, D)).astype(np.float32)
                   for _ in range(4))
    kv = np.asarray([1000, 333], np.int32)
    kvt = torch.from_numpy(kv)
    out, lse = fa.attention_plain(*(torch.from_numpy(x) for x in (q, k, v)),
                                  causal=True, kv_len=kvt)
    delta = torch.einsum("bqhd,bqhd->bhq", torch.from_numpy(do), out)
    q64, k64, v64, do64 = (torch.from_numpy(x).double() for x in
                           (q, k, v, do))
    out64, lse64 = fa.attention_plain(q64, k64, v64, causal=True,
                                      kv_len=kvt)
    ref = fa.attention_bwd_plain(q64, k64, v64, out64, lse64, do64,
                                 causal=True, kv_len=kvt)
    for b in range(B):
        got = _flash_bwd_emulated(q[b, :, 0], k[b, :, 0], v[b, :, 0],
                                  do[b, :, 0], lse[b, 0].numpy(),
                                  delta[b, 0].numpy(), int(kv[b]))
        for g, r in zip(got, ref):
            r = r[b, :, 0].numpy()
            assert np.abs(g - r).max() <= 1e-5 * np.abs(r).max()


@pytest.mark.cuda
class TestOnCard:
    """The backward kernels against attention_bwd_plain on the card."""

    @pytest.fixture(autouse=True)
    def _card(self):
        if not torch.cuda.is_available():
            pytest.skip("needs a CUDA device: the kernels have no CPU mode")

    @staticmethod
    def _dev(x):
        return None if x is None else torch.from_numpy(x).cuda()

    @pytest.mark.parametrize("name", sorted(CARD_CASES))
    def test_kernels_match_plain(self, name):
        q, k, v, do, causal, kv, ql = (self._dev(x) if isinstance(
            x, np.ndarray) else x for x in _inputs(CARD_CASES[name]))
        kw = dict(causal=causal, kv_len=kv, q_len=ql)
        out, lse = fa.flash_attention(q, k, v, **kw)
        before = (fa.bwd_dkv_launches, fa.bwd_dq_launches)
        got = fa.flash_attention_bwd(q, k, v, out, lse, do, **kw)
        torch.cuda.synchronize()
        assert (fa.bwd_dkv_launches, fa.bwd_dq_launches) == (
            before[0] + 1, before[1] + 1)
        ref = fa.attention_bwd_plain(q, k, v, out, lse, do, **kw)
        for g, r in zip(got, ref):
            assert torch.isfinite(g).all()
            scale = max(r.abs().max().item(), 1e-30)
            assert (g - r).abs().max().item() / scale <= 1e-4
        dead = (lse >= fa.LSE_MASKED).permute(0, 2, 1)     # [B, Tq, H]
        assert (got[0][dead] == 0).all()
        # keys at or past kv_len get exactly no gradient
        if kv is not None:
            for b, n in enumerate(kv.tolist()):
                assert (got[1][b, n:] == 0).all()
                assert (got[2][b, n:] == 0).all()

    @pytest.mark.parametrize("name", sorted(CARD_CASES))
    def test_kernels_are_bit_identical_on_a_repeat(self, name):
        """No atomics and one writer an output: two calls on the same
        inputs give the same bits."""
        q, k, v, do, causal, kv, ql = (self._dev(x) if isinstance(
            x, np.ndarray) else x for x in _inputs(CARD_CASES[name],
                                                  seed=3))
        kw = dict(causal=causal, kv_len=kv, q_len=ql)
        out, lse = fa.flash_attention(q, k, v, **kw)
        runs = [fa.flash_attention_bwd(q, k, v, out, lse, do, **kw)
                for _ in range(2)]
        torch.cuda.synchronize()
        for a, b in zip(*runs):
            assert torch.equal(a, b)

    @pytest.mark.parametrize("name", sorted(CARD_CASES))
    def test_bf16_kernels_match_bf16_plain(self, name):
        """The bf16 forms of dkv and dq against attention_bwd_plain_bf16
        from the same out and lse: element by element within one bf16
        ulp plus BF16_GRAD_FRAC of the largest entry, dq of rows without
        keys and dk, dv of keys past kv_len exactly 0, bit-identical on a
        repeat, only the bf16 forms launched."""
        q, k, v, do, causal, kv, ql = (self._dev(x) if isinstance(
            x, np.ndarray) else x for x in _inputs(CARD_CASES[name]))
        q, k, v, do = (x.to(BF16) for x in (q, k, v, do))
        kw = dict(causal=causal, kv_len=kv, q_len=ql)
        out, lse = fa.flash_attention(q, k, v, **kw)
        before = [getattr(fa, n) for n in fa.COUNTERS]
        got = fa.flash_attention_bwd(q, k, v, out, lse, do, **kw)
        again = fa.flash_attention_bwd(q, k, v, out, lse, do, **kw)
        torch.cuda.synchronize()
        after = [getattr(fa, n) for n in fa.COUNTERS]
        # only the bf16 backward (no D-split form)
        assert [a - b for a, b in zip(after, before)] == \
            [0, 0, 0, 0, 2, 2] + [0] * 6
        assert all(torch.equal(a, b) for a, b in zip(got, again))
        ref = fa.attention_bwd_plain_bf16(q, k, v, out, lse, do, **kw)
        for n, g, r in zip(("dq", "dk", "dv"), got, ref):
            assert g.dtype == BF16 and torch.isfinite(g).all(), n
            bf16_close(g.float().cpu().numpy(), r.float().cpu().numpy(),
                       BF16_GRAD_FRAC, f"{name} {n}")
        dead = (lse >= fa.LSE_MASKED).permute(0, 2, 1)     # [B, Tq, H]
        assert (got[0][dead] == 0).all()
        if kv is not None:
            for b, n in enumerate(kv.tolist()):
                assert (got[1][b, n:] == 0).all()
                assert (got[2][b, n:] == 0).all()

    @pytest.mark.parametrize("name", sorted(BF16_EDGE_CASES))
    def test_bf16_kernels_at_tile_edges(self, name):
        """The bf16 forms of dkv and dq at the edges of their tiles
        (tests/test_torch_attention.py's BF16_EDGE_CASES: 128-key and
        128-query blocks, 64- and 32-row walked tiles) against
        attention_bwd_plain_bf16 on the same inputs (with the NaN rows
        past kv_len, which no visible pair reads, left finite): dq, dk
        and dv finite and within one bf16 ulp plus BF16_GRAD_FRAC of the
        largest entry, dq of rows without keys and dk, dv of keys past
        kv_len exactly 0, bit-identical on a repeat, only the bf16 forms
        launched."""
        q, k, v, do, causal, kv, ql = (self._dev(x) if isinstance(
            x, np.ndarray) else x for x in _inputs(BF16_EDGE_CASES[name]))
        q, k, v, do = (x.to(BF16) for x in (q, k, v, do))
        kn, vn = k, v
        if "nan" in name:
            kn, vn = (nan_past_kv_len(x, kv) for x in (k, v))
        kw = dict(causal=causal, kv_len=kv, q_len=ql)
        out, lse = fa.flash_attention(q, kn, vn, **kw)
        before = [getattr(fa, n) for n in fa.COUNTERS]
        got = fa.flash_attention_bwd(q, kn, vn, out, lse, do, **kw)
        again = fa.flash_attention_bwd(q, kn, vn, out, lse, do, **kw)
        torch.cuda.synchronize()
        after = [getattr(fa, n) for n in fa.COUNTERS]
        # only the bf16 backward (no D-split form)
        assert [a - b for a, b in zip(after, before)] == \
            [0, 0, 0, 0, 2, 2] + [0] * 6
        assert all(torch.equal(a, b) for a, b in zip(got, again))
        ref = fa.attention_bwd_plain_bf16(q, k, v, out, lse, do, **kw)
        for n, g, r in zip(("dq", "dk", "dv"), got, ref):
            assert g.dtype == BF16 and torch.isfinite(g).all(), n
            bf16_close(g.float().cpu().numpy(), r.float().cpu().numpy(),
                       BF16_GRAD_FRAC, f"{name} {n}")
        dead = (lse >= fa.LSE_MASKED).permute(0, 2, 1)     # [B, Tq, H]
        assert (got[0][dead] == 0).all()
        for b, n in enumerate([] if kv is None else kv.tolist()):
            assert (got[1][b, n:] == 0).all() and (got[2][b, n:] == 0).all()

    def test_bf16_kernels_take_a_negative_scale(self):
        """A negative scale through the bf16 forms (the wrapper hands the
        kernels -q and -scale and negates dq) against
        attention_bwd_plain_bf16 at that scale, from the same out and
        lse: within one bf16 ulp plus BF16_GRAD_FRAC."""
        q, k, v, do, causal, kv, ql = (self._dev(x) if isinstance(
            x, np.ndarray) else x for x in _inputs(
                CARD_CASES["causal_ragged_d64"]))
        q, k, v, do = (x.to(BF16) for x in (q, k, v, do))
        kw = dict(causal=causal, kv_len=kv, q_len=ql, scale=-0.2)
        out, lse = fa.flash_attention(q, k, v, **kw)
        got = fa.flash_attention_bwd(q, k, v, out, lse, do, **kw)
        torch.cuda.synchronize()
        ref = fa.attention_bwd_plain_bf16(q, k, v, out, lse, do, **kw)
        for n, g, r in zip(("dq", "dk", "dv"), got, ref):
            bf16_close(g.float().cpu().numpy(), r.float().cpu().numpy(),
                       BF16_GRAD_FRAC, f"negative scale {n}")

    def test_backward_reaches_q_k_v(self):
        """loss.backward() through flash_dense_attention on the card
        gives q, k and v the plain version's gradients (an output
        without grad_fn would leave them None)."""
        q, k, v, do, causal, kv, ql = (self._dev(x) if isinstance(
            x, np.ndarray) else x for x in
            _inputs(CARD_CASES["causal_ragged_d64"]))
        leaves = [x.clone().requires_grad_(True) for x in (q, k, v)]
        out = tring.flash_dense_attention(*leaves, causal=causal,
                                          kv_len=kv)
        assert out.grad_fn is not None
        (out * do).sum().backward()
        torch.cuda.synchronize()
        outp, lse = fa.attention_plain(q, k, v, causal=causal, kv_len=kv)
        ref = fa.attention_bwd_plain(q, k, v, outp, lse, do, causal=causal,
                                     kv_len=kv)
        for x, r in zip(leaves, ref):
            assert x.grad is not None and (x.grad != 0).any()
            assert (x.grad - r).abs().max().item() <= 1e-4 * r.abs().max().item()
