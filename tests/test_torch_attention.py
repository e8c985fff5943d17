"""The port's flash attention against the JAX package's attention.

The same numpy inputs go through `paddle_tpu/parallel/ring.py`
(`flash_blocked_attention`, `dense_attention`, `_blocked_fwd`) and the
port's `ops/flash_attention.attention_plain` (the plain version the
kernel is held against on the card) and `parallel/ring.py`. f32 on the
CPU in both: atol 1e-5 on the rows that see at least one key (the
summation order differs). Rows that see no key are the port's own
rule: out exactly 0, lse exactly 1e30.

`test_emulated_kernel_arithmetic_*` replays the kernel's tensor-core
arithmetic (3xTF32 splits, 64-key tiles, the in-group key permutation
of P.V) in numpy. `test_padded_head_dim_*` checks the zero-column
padding the wrappers apply to a head dim the kernels do not
instantiate.

The kernel itself runs only on the card: `TestOnCard` is marked `cuda`
and skips here; on a machine with an H100 and no JAX it runs alone
(`python -m pytest -m cuda tests/test_torch_attention.py`).
"""

import numpy as np
import pytest
import torch

try:  # the CPU parity tests need JAX; the on-card tests do not
    import jax.numpy as jnp
    from jax.experimental.pallas import tpu as pltpu
    from jax.experimental.pallas.ops.tpu import flash_attention as jlib

    from paddle_tpu.parallel import ring as jring
except ImportError:
    jnp = None
from paddle_tpu_torch.ops import flash_attention as fa
from paddle_tpu_torch.parallel import ring as tring

ATOL = 1e-5
BF16 = torch.bfloat16
# bf16 outputs are held element by element within one bf16 ulp of the
# reference plus a fraction of its largest entry. The library kernel
# rounds p after normalising it (one key block) or against its running
# max, the kernel against its running max, attention_plain_bf16 against
# the row's final max: each p's rounding differs. Readings (this file's
# tests, the largest beyond one ulp over the largest entry): the library
# 9.8e-4 (BF16_CASES), the emulated kernel 2.3e-4 (T = 1024).
BF16_OUT_FRAC = 2e-3
# the JAX blocked path in bf16 rounds at other places again (a bf16 p
# under XLA's rules): readings up to 1.0e-3
BF16_BLOCKED_FRAC = 5e-3

# (B, Tq, Tk, H, D, causal, kv_len, q_len)
CASES = {
    "causal_ragged_odd_t": (2, 37, 37, 2, 16, True, [37, 20], None),
    "noncausal_kvlen": (2, 29, 29, 3, 8, False, [29, 5], None),
    "causal_full": (1, 64, 64, 2, 32, True, None, None),
    "causal_kvlen_zero_row": (2, 19, 19, 2, 8, True, [0, 19], None),
    "cross_qlen_kvlen": (2, 21, 45, 2, 16, False, [45, 30], [13, 21]),
    "causal_ragged_d48": (2, 37, 37, 2, 48, True, [37, 20], None),
}


# the kernel instantiates head dims 32, 64, 96 and 128 and the wrapper
# pads the others (40, 48): the same masks at those, T not a multiple of
# 16 or 64, kv_len 0 and 1, Tq != Tk
CARD_CASES = {
    "causal_ragged_odd_t_d32": (2, 37, 37, 2, 32, True, [37, 20], None),
    "noncausal_kvlen_d64": (2, 29, 29, 3, 64, False, [29, 5], None),
    "causal_full_d32": (1, 64, 64, 2, 32, True, None, None),
    "causal_kvlen_zero_row_d64": (2, 19, 19, 2, 64, True, [0, 19], None),
    "cross_qlen_kvlen_d128": (2, 21, 45, 2, 128, False, [45, 30], [13, 21]),
    "causal_ragged_t150_d40": (2, 150, 150, 2, 40, True, [150, 71], None),
    "noncausal_kvlen_d48": (2, 29, 29, 3, 48, False, [29, 5], None),
    "cross_qlen_kvlen_d96": (2, 70, 133, 2, 96, False, [133, 64], [70, 9]),
    "causal_kvlen_0_and_1_t70_d64": (2, 70, 70, 2, 64, True, [0, 1], None),
    "causal_tq100_tk37_d64": (1, 100, 37, 2, 64, True, [37], None),
    "noncausal_tq7_tk300_d64": (2, 7, 300, 1, 64, False, [300, 129], None),
}


# (B, Tq, Tk, H, D, causal, kv_len, q_len) of the bf16 form against the
# library kernel in interpret mode: ragged causal, cross-attention with
# q_len, a kv_len = 0 row, a head dim the kernels pad (40 -> 64), T over
# one key block of the library (128) and within one
BF16_CASES = {
    "causal_ragged_t200_d64": (2, 200, 200, 2, 64, True, [200, 77], None),
    "cross_qlen_d32": (2, 100, 200, 2, 32, False, [200, 120], [100, 40]),
    "causal_kvlen0_row_d96": (2, 200, 200, 2, 96, True, [0, 150], None),
    "causal_full_t128_d40": (1, 128, 128, 2, 40, True, None, None),
}


# the bf16 kernels' tile edges (128-row query and key tiles): T one short
# of and one past a tile, a kv_len ending mid-tile, Tq != Tk with q_len and
# a kv_len = 0 row, and K, V rows past kv_len holding NaN (TMA fills only
# rows past T, so the kernel's masks must keep them out), at every head dim
# the wrapper takes (96 runs padded to 128)
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
    if jnp is None:
        pytest.skip("the CPU parity tests need JAX")


def _inputs(case, seed=0):
    B, Tq, Tk, H, D, causal, kv_len, q_len = case
    rng = np.random.default_rng(seed)
    q = rng.standard_normal((B, Tq, H, D)).astype(np.float32)
    k = rng.standard_normal((B, Tk, H, D)).astype(np.float32)
    v = rng.standard_normal((B, Tk, H, D)).astype(np.float32)
    kv = None if kv_len is None else np.asarray(kv_len, np.int32)
    ql = None if q_len is None else np.asarray(q_len, np.int32)
    return q, k, v, causal, kv, ql


def _visible(B, Tq, Tk, causal, kv, ql):
    """[B, Tq] bool: the query row sees at least one key."""
    rows = np.zeros((B, Tq), bool)
    for b in range(B):
        klen = Tk if kv is None else kv[b]
        qlen = Tq if ql is None else ql[b]
        for i in range(qlen):
            rows[b, i] = (min(klen, i + 1) if causal else klen) > 0
    return rows


def _t(x):
    return None if x is None else torch.from_numpy(x)


def _port(q, k, v, causal, kv, ql):
    out, lse = fa.attention_plain(_t(q), _t(k), _t(v), causal=causal,
                                  kv_len=_t(kv), q_len=_t(ql))
    return out.numpy(), lse.numpy()


@pytest.mark.parametrize("name", sorted(CASES))
def test_plain_matches_jax_flash_and_dense(name):
    needs_jax()
    q, k, v, causal, kv, ql = _inputs(CASES[name])
    B, Tq = q.shape[:2]
    out, lse = _port(q, k, v, causal, kv, ql)
    kvj = None if kv is None else jnp.asarray(kv)
    ref_flash = np.asarray(jring.flash_blocked_attention(
        q, k, v, causal=causal, kv_len=kvj))
    ref_dense = np.asarray(jring.dense_attention(
        q, k, v, causal=causal, kv_len=kvj))
    vis = _visible(B, Tq, k.shape[1], causal, kv, ql)
    assert vis.any()
    np.testing.assert_allclose(out[vis], ref_flash[vis], atol=ATOL)
    np.testing.assert_allclose(out[vis], ref_dense[vis], atol=ATOL)
    # rows that see no key: exactly zero, lse exactly +1e30
    dead = ~vis
    assert (out[dead] == 0).all()
    assert (lse.transpose(0, 2, 1)[dead] == fa.LSE_MASKED).all()


@pytest.mark.parametrize("name", sorted(CASES))
def test_lse_matches_jax_blocked_fwd(name):
    needs_jax()
    q, k, v, causal, kv, ql = _inputs(CASES[name], seed=1)
    B, Tq, H, D = q.shape
    Tk = k.shape[1]
    kbias = np.zeros((B, Tk), np.float32)
    if kv is not None:
        kbias = np.where(np.arange(Tk)[None, :] >= kv[:, None],
                         np.float32(jring.NEG_INF), kbias)
    _o, ref_lse = jring._blocked_fwd(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
        jnp.asarray(kbias), causal, 1.0 / np.sqrt(D), 16)
    ref_lse = np.asarray(ref_lse).transpose(0, 2, 1)   # [B, Tq, H]
    _out, lse = _port(q, k, v, causal, kv, ql)
    lse = lse.transpose(0, 2, 1)
    vis = _visible(B, Tq, Tk, causal, kv, ql)
    np.testing.assert_allclose(lse[vis], ref_lse[vis], atol=ATOL)
    if ql is None:
        # without q_len both implementations mark the same rows dead
        assert (ref_lse[~vis] == 1e30).all()


@pytest.mark.parametrize("D", [160, 256, 384])
def test_plain_matches_jax_blocked_past_head_dim_128(D):
    """Head dims the JAX package's kernel takes and the port runs as a
    D-split on the card (`csrc/flash_dsplit.cuh`): the plain forward,
    the kernels' reference, against the JAX blocked path (out within
    1e-5 of the largest entry) and its lse (`_blocked_fwd`, 1e-5)."""
    needs_jax()
    case = (2, 45, 45, 2, D, True, [45, 28], None)
    q, k, v, causal, kv, ql = _inputs(case, seed=D)
    out, lse = _port(q, k, v, causal, kv, ql)
    kvj = jnp.asarray(kv)
    ref = np.asarray(jring.flash_dense_attention(
        q, k, v, causal=causal, kv_len=kvj, impl="blocked"))
    assert np.abs(out - ref).max() <= ATOL * np.abs(ref).max()
    kbias = np.where(np.arange(45)[None, :] >= kv[:, None],
                     np.float32(jring.NEG_INF), 0.0).astype(np.float32)
    _o, ref_lse = jring._blocked_fwd(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
        jnp.asarray(kbias), causal, 1.0 / np.sqrt(D), 16)
    np.testing.assert_allclose(lse, np.asarray(ref_lse), atol=ATOL)


def test_port_ring_matches_jax_ring():
    """The port's ring.dense_attention is the JAX one (fully-masked
    rows included: both attend uniformly there), and its
    flash_dense_attention agrees with the JAX flash on visible rows."""
    needs_jax()
    q, k, v, causal, kv, _ql = _inputs(CASES["causal_kvlen_zero_row"])
    kvj = jnp.asarray(kv)
    np.testing.assert_allclose(
        tring.dense_attention(_t(q), _t(k), _t(v), causal=causal,
                              kv_len=_t(kv)).numpy(),
        np.asarray(jring.dense_attention(q, k, v, causal=causal,
                                         kv_len=kvj)),
        atol=ATOL)
    out = tring.flash_dense_attention(_t(q), _t(k), _t(v), causal=causal,
                                      kv_len=_t(kv).long()).numpy()
    ref = np.asarray(jring.flash_dense_attention(
        q, k, v, causal=causal, kv_len=kvj, impl="blocked"))
    vis = _visible(q.shape[0], q.shape[1], k.shape[1], causal, kv, None)
    np.testing.assert_allclose(out[vis], ref[vis], atol=ATOL)
    assert (out[~vis] == 0).all()


@pytest.mark.parametrize("D", [8, 40, 48, 100])
def test_padded_head_dim_gives_the_unpadded_result(D):
    """What the wrappers do on the card for a head dim the kernels do
    not instantiate: zero columns of q, k, v (and dout) up to
    kernel_head_dim(D), the scale of D, the padding sliced off. With the
    plain versions on the CPU it gives the unpadded call's out, lse, dq,
    dk and dv."""
    case = (2, 37, 45, 2, D, False, [45, 20], [37, 30])
    q, k, v, causal, kv, ql = (_t(x) if isinstance(x, np.ndarray) else x
                               for x in _inputs(case))
    do = torch.from_numpy(np.random.default_rng(7).standard_normal(
        q.shape).astype(np.float32))
    kw = dict(causal=causal, kv_len=kv, q_len=ql)
    out, lse = fa.attention_plain(q, k, v, **kw)
    grads = fa.attention_bwd_plain(q, k, v, out, lse, do, **kw)
    dk = fa.kernel_head_dim(D)
    assert dk in fa.KERNEL_HEAD_DIMS and dk > D
    qp, kp, vp, dop = (fa.pad_head_dim(x, dk) for x in (q, k, v, do))
    assert qp.shape[-1] == dk and (qp[..., D:] == 0).all()
    scale = 1.0 / np.sqrt(D)
    outp, lsep = fa.attention_plain(qp, kp, vp, scale=scale, **kw)
    gradp = fa.attention_bwd_plain(qp, kp, vp, outp, lsep, dop, scale=scale,
                                   **kw)
    assert (outp[..., D:] == 0).all()
    np.testing.assert_allclose(lsep.numpy(), lse.numpy(), rtol=1e-6,
                               atol=1e-6)
    for got, ref in zip((outp, *gradp), (out, *grads)):
        assert (got[..., D:] == 0).all()
        np.testing.assert_allclose(got[..., :D].numpy(), ref.numpy(),
                                   rtol=1e-6, atol=1e-6)


def test_kernel_head_dims():
    """D <= 128 runs at the next instantiated dim; D > 128 runs as a
    D-split at the next multiple of SPLIT_HEAD_DIM (64), in both
    dtypes' forms."""
    assert [fa.kernel_head_dim(d) for d in (1, 32, 33, 64, 65, 96, 97,
                                            128)] == [32, 32, 64, 64, 96,
                                                      96, 128, 128]
    for dims in (fa.KERNEL_HEAD_DIMS, fa.BF16_KERNEL_HEAD_DIMS):
        assert [fa.kernel_head_dim(d, dims) for d in (
            129, 160, 192, 193, 256, 257, 384)] == [
            192, 192, 192, 256, 256, 320, 384]
    assert [fa.is_split(d) for d in (128, 192)] == [False, True]


def _tf32(x):
    """x (f32) rounded to TF32 as `cvt.rna.tf32.f32` rounds: 10 mantissa
    bits, to nearest, ties away from zero (finite x)."""
    bits = np.ascontiguousarray(x, np.float32).view(np.uint32)
    return ((bits + np.uint32(0x1000)) & np.uint32(0xFFFFE000)).view(
        np.float32)


def _split(x):
    """The kernel's split_tf32_alu: hi rounded to TF32 as cvt.rna rounds,
    lo = x - hi truncated to TF32 (low 13 bits cleared)."""
    hi = _tf32(x)
    lo = (np.ascontiguousarray(x - hi, np.float32).view(np.uint32)
          & np.uint32(0xFFFFE000)).view(np.float32)
    return hi, lo


def _mm3(a, b):
    """a @ b (f32, 2-D) as the kernel forms it: hi/lo TF32 splits of both
    operands, the three products summed in f32, small terms first."""
    (a_hi, a_lo), (b_hi, b_lo) = _split(a), _split(b)

    def mm(x, y):
        return (torch.from_numpy(x) @ torch.from_numpy(y)).numpy()

    return (mm(a_lo, b_hi) + mm(a_hi, b_lo)) + mm(a_hi, b_hi)


# inside each group of 8 keys, P.V's A fragment column k holds key
# PERM[k]: k = t is key 2t, k = t + 4 is key 2t + 1
PERM = np.asarray([0, 2, 4, 6, 1, 3, 5, 7])


def _flash_fwd_emulated(q, k, v, causal, kv_len, groups, block=64):
    """csrc/flash_attn_fwd.cu's arithmetic in numpy for one (b, h): q
    [T, D], k, v [Tk, D] f32. `groups` key groups take the 64-key tiles
    in turn (group g tiles g, g + groups, ...), each running the online
    softmax with the mask tested a pair (p = 0 exactly), S = Q.K^T and
    P.V in 3xTF32 with the keys permuted in groups of 8 (A's columns and
    V's rows alike) and each tile's P.V in a fresh accumulator added to
    the corrected output; the groups' (max, sum, output) are then merged
    in order. Returns (out [T, D], lse [T])."""
    T, D = q.shape
    scale = np.float32(1.0 / np.sqrt(D))
    rows = np.arange(T)[:, None]
    perm = (np.arange(block) // 8) * 8 + PERM[np.arange(block) % 8]
    parts = []
    for grp in range(groups):
        m = np.full(T, -np.inf, np.float32)
        l = np.zeros(T, np.float32)
        o = np.zeros((T, D), np.float32)
        for k0 in range(grp * block, kv_len, groups * block):
            keys = k0 + np.arange(block)
            kt = np.zeros((block, D), np.float32)
            vt = np.zeros((block, D), np.float32)
            live = keys < kv_len
            kt[live], vt[live] = k[keys[live]], v[keys[live]]
            s = _mm3(q, np.ascontiguousarray(kt.T)) * scale
            vis = (keys[None, :] < kv_len) & (
                (not causal) | (keys[None, :] <= rows))
            s = np.where(vis, s, -np.inf).astype(np.float32)
            m_new = np.maximum(m, s.max(axis=1))
            seen = m_new > -np.inf
            corr = np.where(seen, np.exp(m - np.where(seen, m_new, 0)),
                            1).astype(np.float32)
            p = np.where(vis, np.exp(s - np.where(seen, m_new, 0)[:, None]),
                         0).astype(np.float32)
            l = (l * corr + p.sum(axis=1)).astype(np.float32)
            ot = _mm3(np.ascontiguousarray(p[:, perm]), vt[perm])
            o = (o * corr[:, None] + ot).astype(np.float32)
            m = m_new
        parts.append((m, l, o))
    m, l, o = parts[0]
    for mb, lb, ob in parts[1:]:
        m_new = np.maximum(m, mb)
        ca = np.where(m > -np.inf, np.exp(m - np.where(m_new > -np.inf,
                                                       m_new, 0)), 0)
        cb = np.where(mb > -np.inf, np.exp(mb - np.where(m_new > -np.inf,
                                                         m_new, 0)), 0)
        l = (l * ca + lb * cb).astype(np.float32)
        o = (o * ca[:, None] + ob * cb[:, None]).astype(np.float32)
        m = m_new
    alive = l > 0
    out = np.where(alive[:, None], o / np.where(alive, l, 1)[:, None], 0)
    lse = np.where(alive, m + np.log(np.where(alive, l, 1)), 1e30)
    return out.astype(np.float32), lse.astype(np.float32)


@pytest.mark.parametrize("D, groups", [(64, 2), (64, 1), (128, 1)])
def test_emulated_kernel_arithmetic_holds_f32_accuracy(D, groups):
    """The forward kernel's tensor-core arithmetic, emulated, at T = 1024
    causal with a ragged kv_len, with the key groups the kernel takes at
    this size (two at D = 64 on a small grid, one otherwise): within 1e-5
    of the f64 result (relative to the largest |out|) and within 1e-4 of
    attention_plain."""
    B, T = 2, 1024
    rng = np.random.default_rng(D)
    q, k, v = (rng.standard_normal((B, T, 1, D)).astype(np.float32)
               for _ in range(3))
    kv = np.asarray([1000, 333], np.int32)
    ref, ref_lse = fa.attention_plain(
        *(torch.from_numpy(x).double() for x in (q, k, v)), causal=True,
        kv_len=torch.from_numpy(kv))
    plain, plain_lse = fa.attention_plain(
        *(torch.from_numpy(x) for x in (q, k, v)), causal=True,
        kv_len=torch.from_numpy(kv))
    for b in range(B):
        out, lse = _flash_fwd_emulated(q[b, :, 0], k[b, :, 0], v[b, :, 0],
                                       True, int(kv[b]), groups)
        r = ref[b, :, 0].numpy()
        assert np.abs(out - r).max() <= 1e-5 * np.abs(r).max()
        assert np.abs(out - plain[b, :, 0].numpy()).max() <= 1e-4
        np.testing.assert_allclose(lse, plain_lse[b, 0].numpy(), atol=1e-4)
        np.testing.assert_allclose(lse, ref_lse[b, 0].numpy(), atol=1e-5)


def test_wrapper_takes_plain_path_on_cpu_and_counts_nothing():
    q, k, v, causal, kv, ql = _inputs(CASES["cross_qlen_kvlen"])
    before = fa.launches
    out, lse = fa.flash_attention(_t(q), _t(k), _t(v), causal=causal,
                                  kv_len=_t(kv), q_len=_t(ql))
    ref_out, ref_lse = _port(q, k, v, causal, kv, ql)
    assert fa.launches == before
    np.testing.assert_array_equal(out.numpy(), ref_out)
    np.testing.assert_array_equal(lse.numpy(), ref_lse)


# ---- the bf16 form --------------------------------------------------------

def _f32(x):
    if torch.is_tensor(x):
        return x.detach().float().cpu()
    return torch.from_numpy(np.asarray(x, np.float32))


def bf16_ulp(x):
    """The spacing of bf16 numbers (8 significant bits) at |x|."""
    x = _f32(x)
    return torch.ldexp(torch.ones_like(x), torch.frexp(x)[1] - 8)


def bf16_close(got, ref, frac, name):
    """Element by element within one bf16 ulp of the reference plus
    `frac` of its largest entry."""
    got, ref = _f32(got), _f32(ref)
    top = ref.abs().max()
    beyond = (got - ref).abs() - bf16_ulp(ref)
    bad = beyond > frac * top
    assert not bad.any(), (
        f"{name}: {int(bad.sum())} of {bad.numel()} elements off, worst "
        f"{(beyond.max() / top).item():.3g} of the largest beyond an ulp")


def _bf16_inputs(case, seed=0):
    """_inputs rounded to bf16 (numpy f32 holding bf16 values)."""
    q, k, v, causal, kv, ql = _inputs(case, seed)
    q, k, v = (torch.from_numpy(x).to(BF16).float().numpy()
               for x in (q, k, v))
    return q, k, v, causal, kv, ql


def _query_rows(B, Tq, kv, ql):
    """[B, Tq] bool: the rows the library computes (its segment ids mark
    rows at or past q_len, or else kv_len, as padding that attends only
    to padding)."""
    n = ql if ql is not None else kv if kv is not None else [Tq] * B
    return np.arange(Tq)[None, :] < np.asarray(n)[:, None]


def _library_fwd(monkeypatch, q, k, v, causal, kv, ql):
    """The JAX package's TPU path (`ring.flash_dense_attention`,
    impl="pallas": `_pallas_flash` and the library kernel) on bf16
    inputs, the kernel run in interpret mode: (out [B, Tq, H, D], lse
    [B, H, Tq]) as f32 numpy, lse = m + log(l) from the library's own
    residuals."""
    saved = {}

    def with_residuals(q, k, v, ab=None, segment_ids=None, *, causal,
                       sm_scale, block_sizes=None, debug=False):
        sizes = jlib.BlockSizes.get_default(*q.shape[:3], k.shape[2],
                                            q.shape[3])
        o, saved["l"], saved["m"] = jlib._flash_attention(
            q, k, v, ab, segment_ids, True, causal, sm_scale, sizes, debug)
        return o

    monkeypatch.setattr(jlib, "flash_attention", with_residuals)
    jb = lambda x: jnp.asarray(x, jnp.bfloat16)   # noqa: E731
    with pltpu.force_tpu_interpret_mode():
        out = jring.flash_dense_attention(
            jb(q), jb(k), jb(v), causal=causal,
            kv_len=None if kv is None else jnp.asarray(kv),
            q_len=None if ql is None else jnp.asarray(ql), impl="pallas")
        out = np.asarray(out.astype(jnp.float32))
        lse = np.asarray(saved["m"] + jnp.log(saved["l"]))
    return out, lse[:, :, :q.shape[1]]


def _port_bf16(q, k, v, causal, kv, ql):
    out, lse = fa.attention_plain_bf16(
        *(torch.from_numpy(x).to(BF16) for x in (q, k, v)), causal=causal,
        kv_len=_t(kv), q_len=_t(ql))
    assert out.dtype == BF16 and lse.dtype == torch.float32
    return out.float().numpy(), lse.numpy()


@pytest.mark.parametrize("name", sorted(BF16_CASES))
def test_bf16_plain_matches_library_kernel(name, monkeypatch):
    """attention_plain_bf16 against the TPU kernel's own arithmetic (the
    library kernel in interpret mode, bf16 in): out within one bf16 ulp
    plus BF16_OUT_FRAC of the largest entry and lse within 1e-4
    relative, on the rows the library computes; rows that see no key
    are the port's rule (out exactly 0, lse exactly 1e30)."""
    needs_jax()
    q, k, v, causal, kv, ql = _bf16_inputs(BF16_CASES[name])
    B, Tq = q.shape[:2]
    ref, ref_lse = _library_fwd(monkeypatch, q, k, v, causal, kv, ql)
    out, lse = _port_bf16(q, k, v, causal, kv, ql)
    rows = _query_rows(B, Tq, kv, ql)
    bf16_close(out[rows], ref[rows], BF16_OUT_FRAC, name)
    lse_t, ref_t = lse.transpose(0, 2, 1), ref_lse.transpose(0, 2, 1)
    assert (np.abs(lse_t[rows] - ref_t[rows])
            <= 1e-4 * np.abs(ref_t[rows])).all()
    dead = ~_visible(B, Tq, k.shape[1], causal, kv, ql)
    assert (out[dead] == 0).all() and (lse_t[dead] == fa.LSE_MASKED).all()


@pytest.mark.parametrize("name", sorted(BF16_CASES))
def test_bf16_plain_matches_jax_blocked(name):
    """attention_plain_bf16 against the JAX package's portable flash
    (`flash_dense_attention(impl="blocked")`) on the same bf16 inputs,
    on the rows that see a key: within one bf16 ulp plus
    BF16_BLOCKED_FRAC of the largest entry."""
    needs_jax()
    q, k, v, causal, kv, ql = _bf16_inputs(BF16_CASES[name])
    B, Tq = q.shape[:2]
    jb = lambda x: jnp.asarray(x, jnp.bfloat16)   # noqa: E731
    ref = jring.flash_dense_attention(
        jb(q), jb(k), jb(v), causal=causal,
        kv_len=None if kv is None else jnp.asarray(kv), impl="blocked")
    out, _lse = _port_bf16(q, k, v, causal, kv, ql)
    vis = _visible(B, Tq, k.shape[1], causal, kv, ql)
    bf16_close(out[vis], np.asarray(ref.astype(jnp.float32))[vis],
               BF16_BLOCKED_FRAC, name)


def _flash_fwd_bf16_emulated(q, k, v, causal, kv_len, block=64,
                             exp2=False):
    """csrc/flash_attn_fwd.cu's bf16 form in torch for [B, T, H, D] bf16
    q, k, v: `block`-key tiles, S from the bf16 operands in f32, the
    online softmax in f32 with the mask tested a pair (p = 0 exactly), p
    rounded to bf16 against the running max before P.V, out divided by
    the sum and rounded to bf16 at the end. exp2=False is the first
    bf16 kernel's exponential (exp(s * scale - m)); exp2=True the wgmma
    kernel's: the max kept of x = s * c with c = scale * log2(e), p =
    2^fma(s, c, -m) (one rounding, emulated in f64), lse = (m + log2 l)
    * ln 2. Returns (out bf16, lse)."""
    B, T, H, D = q.shape
    qf, kf, vf = (x.float() for x in (q, k, v))
    scale = 1.0 / np.sqrt(D)
    c = torch.tensor(scale * np.log2(np.e), dtype=torch.float32)
    valid = fa._visible(B, T, T, causal, kv_len, None, q.device)
    m = torch.full((B, H, T), float("-inf"))
    l = torch.zeros((B, H, T))
    o = torch.zeros((B, H, T, D))
    for k0 in range(0, T, block):
        kt, vt = kf[:, k0:k0 + block], vf[:, k0:k0 + block]
        s = torch.einsum("bqhd,bkhd->bhqk", qf, kt)
        s = s * c if exp2 else s * np.float32(scale)
        vis = valid[..., k0:k0 + block]
        s = s.masked_fill(~vis, float("-inf"))
        m_new = torch.maximum(m, s.amax(-1))
        seen = m_new > float("-inf")
        mu = torch.where(seen, m_new, 0.0)[..., None]
        if exp2:
            corr = torch.where(seen, torch.exp2(m - m_new), 1.0)
            raw = torch.einsum("bqhd,bkhd->bhqk", qf, kt).double()
            x = (raw * c.double() - mu.double()).float()
            p = torch.where(vis, torch.exp2(x), 0.0)
        else:
            corr = torch.where(seen, torch.exp(m - m_new), 1.0)
            p = torch.where(vis, torch.exp(s - mu), 0.0)
        l = l * corr + p.sum(-1)
        o = o * corr[..., None] + torch.einsum(
            "bhqk,bkhd->bhqd", p.to(BF16).float(), vt)
        m = m_new
    alive = l > 0
    out = torch.where(alive[..., None], o / torch.where(
        alive, l, 1.0)[..., None], 0.0).permute(0, 2, 1, 3)
    safe = torch.where(alive, l, 1.0)
    lse = (m + torch.log2(safe)) * np.float32(np.log(2)) if exp2 else \
        m + torch.log(safe)
    lse = torch.where(alive, lse, fa.LSE_MASKED)
    return out.to(BF16), lse


@pytest.mark.parametrize("block", [64, 128])
@pytest.mark.parametrize("exp2", [False, True], ids=["exp", "exp2"])
def test_emulated_bf16_kernel_is_within_the_card_bound(block, exp2):
    """The bf16 kernel's arithmetic, emulated, at T = 1024 causal with a
    ragged kv_len, with the first bf16 kernel's tiles and exponential
    (64 keys, exp) and the wgmma kernel's (128 keys, exp2 with the scale
    folded into one FMA): out within one bf16 ulp plus BF16_OUT_FRAC of
    the largest entry of attention_plain_bf16 (the bound the card holds
    the kernel to) and lse within 1e-4; and no farther from the f32
    plain version on the same inputs than attention_plain_bf16 is,
    within one bf16 ulp of the largest entry (the card's witness)."""
    rng = np.random.default_rng(5)
    q, k, v = (torch.from_numpy(rng.standard_normal(
        (2, 1024, 2, 64)).astype(np.float32)).to(BF16) for _ in range(3))
    kw = dict(causal=True, kv_len=torch.tensor([1000, 333], dtype=torch.int32))
    out, lse = _flash_fwd_bf16_emulated(q, k, v, block=block, exp2=exp2,
                                        **kw)
    plain, plain_lse = fa.attention_plain_bf16(q, k, v, **kw)
    exact, _ = fa.attention_plain(q, k, v, **kw)
    bf16_close(out, plain, BF16_OUT_FRAC, "emulated kernel")
    assert (lse - plain_lse).abs().max().item() <= 1e-4
    top = exact.abs().max()
    assert ((out.float() - exact).abs().max()
            <= (plain.float() - exact).abs().max() + bf16_ulp(top))


def test_bf16_kernels_take_a_positive_scale():
    """The bf16 wrappers hand the kernels -q and -scale for a negative
    scale: the same s = q.k * scale exactly (negation is exact), so the
    same out and lse, and dq negated (ops/flash_attention.py::
    _positive_scale), here with the bf16 plain versions."""
    q, k, v, causal, kv, ql = _inputs(CASES["causal_ragged_odd_t"])
    q, k, v = (_t(x).to(BF16) for x in (q, k, v))
    do = torch.from_numpy(np.random.default_rng(2).standard_normal(
        q.shape).astype(np.float32)).to(BF16)
    kw = dict(causal=causal, kv_len=_t(kv), q_len=_t(ql))
    qn, sn, flipped = fa._positive_scale(q, -0.3)
    assert flipped and sn == 0.3 and torch.equal(qn, -q)
    assert fa._positive_scale(q, 0.3)[2] is False
    assert fa._positive_scale(q.float(), -0.3)[2] is False
    out, lse = fa.attention_plain_bf16(q, k, v, scale=-0.3, **kw)
    outn, lsen = fa.attention_plain_bf16(qn, k, v, scale=sn, **kw)
    assert torch.equal(out, outn) and torch.equal(lse, lsen)
    grads = fa.attention_bwd_plain_bf16(q, k, v, out, lse, do, scale=-0.3,
                                        **kw)
    gradn = fa.attention_bwd_plain_bf16(qn, k, v, out, lse, do, scale=sn,
                                        **kw)
    assert torch.equal(grads[0], -gradn[0])
    assert torch.equal(grads[1], gradn[1]) and torch.equal(grads[2],
                                                           gradn[2])


def test_bf16_head_dims():
    """The bf16 kernels take D = 32, 64, 128: 96 runs at 128."""
    assert [fa.kernel_head_dim(d, fa.BF16_KERNEL_HEAD_DIMS)
            for d in (1, 32, 33, 64, 65, 96, 97, 128)] == [
        32, 32, 64, 64, 128, 128, 128, 128]


def test_wrapper_takes_bf16_plain_path_on_cpu_and_counts_nothing():
    """A bf16 call on the CPU goes through attention_plain_bf16 (out in
    bf16, lse f32) and launches nothing; mixed dtypes raise."""
    q, k, v, causal, kv, ql = _inputs(CASES["cross_qlen_kvlen"])
    q, k, v = (_t(x).to(BF16) for x in (q, k, v))
    kw = dict(causal=causal, kv_len=_t(kv), q_len=_t(ql))
    before = [getattr(fa, n) for n in fa.COUNTERS]
    out, lse = fa.flash_attention(q, k, v, **kw)
    ref_out, ref_lse = fa.attention_plain_bf16(q, k, v, **kw)
    assert [getattr(fa, n) for n in fa.COUNTERS] == before
    assert out.dtype == BF16 and lse.dtype == torch.float32
    assert torch.equal(out, ref_out) and torch.equal(lse, ref_lse)
    with pytest.raises(ValueError, match="one dtype"):
        fa.flash_attention(q, k.float(), v, **kw)


@pytest.mark.cuda
class TestOnCard:
    """The kernel against its plain version on the card (run with
    `python -m pytest -m cuda tests/test_torch_attention.py` on a
    machine with an H100)."""

    @pytest.mark.parametrize("name", sorted(CARD_CASES))
    def test_kernel_matches_plain(self, name):
        if not torch.cuda.is_available():
            pytest.skip("needs a CUDA device: the kernel has no CPU mode")
        q, k, v, causal, kv, ql = _inputs(CARD_CASES[name])

        def dev(x):
            return None if x is None else torch.from_numpy(x).cuda()

        before = fa.launches
        out, lse = fa.flash_attention(dev(q), dev(k), dev(v),
                                      causal=causal, kv_len=dev(kv),
                                      q_len=dev(ql))
        torch.cuda.synchronize()
        assert fa.launches == before + 1
        ref_out, ref_lse = _port(q, k, v, causal, kv, ql)
        assert out.shape == ref_out.shape
        np.testing.assert_allclose(out.cpu().numpy(), ref_out, atol=1e-4)
        np.testing.assert_allclose(lse.cpu().numpy(), ref_lse, atol=1e-4)
        # rows without a visible key: exactly out 0 and lse 1e30
        dead = ref_lse >= fa.LSE_MASKED
        assert (lse.cpu().numpy()[dead] == fa.LSE_MASKED).all()
        assert (out.cpu().numpy().transpose(0, 2, 1, 3)[dead] == 0).all()

    @pytest.mark.parametrize("name", sorted(CARD_CASES))
    def test_bf16_kernel_matches_bf16_plain(self, name):
        """The bf16 form against attention_plain_bf16: out element by
        element within one bf16 ulp plus BF16_OUT_FRAC of the largest
        entry (the kernel rounds p against the running max), lse within
        1e-4; rows without a visible key exactly out 0 and lse 1e30;
        bit-identical on a repeat; only the bf16 form launched."""
        if not torch.cuda.is_available():
            pytest.skip("needs a CUDA device: the kernel has no CPU mode")
        q, k, v, causal, kv, ql = (
            None if x is None else torch.from_numpy(x).cuda()
            if isinstance(x, np.ndarray) else x
            for x in _inputs(CARD_CASES[name]))
        q, k, v = (x.to(torch.bfloat16) for x in (q, k, v))
        kw = dict(causal=causal, kv_len=kv, q_len=ql)
        before = [getattr(fa, n) for n in fa.COUNTERS]
        out, lse = fa.flash_attention(q, k, v, **kw)
        again = fa.flash_attention(q, k, v, **kw)
        torch.cuda.synchronize()
        after = [getattr(fa, n) for n in fa.COUNTERS]
        # only the bf16 forward (no D-split form)
        assert [a - b for a, b in zip(after, before)] == \
            [0, 0, 0, 2] + [0] * 8
        assert torch.equal(out, again[0]) and torch.equal(lse, again[1])
        ref_out, ref_lse = fa.attention_plain_bf16(q, k, v, **kw)
        assert out.dtype == torch.bfloat16 and lse.dtype == torch.float32
        bf16_close(out, ref_out, BF16_OUT_FRAC, name)
        alive = ref_lse < fa.LSE_MASKED
        assert (lse - ref_lse)[alive].abs().max().item() <= 1e-4
        dead = (~alive).permute(0, 2, 1)
        assert (lse[~alive] == fa.LSE_MASKED).all()
        assert (out[dead] == 0).all()

    @pytest.mark.parametrize("name", sorted(BF16_EDGE_CASES))
    def test_bf16_kernel_at_tile_edges(self, name):
        """The bf16 form at the edges of its tiles (BF16_EDGE_CASES)
        against attention_plain_bf16 on the same inputs (with the NaN
        rows past kv_len, which no visible pair reads, left finite):
        out finite and within one bf16 ulp plus BF16_OUT_FRAC of the
        largest entry, lse within 1e-4, rows without a visible key
        exactly out 0 and lse 1e30, bit-identical on a repeat, only
        the bf16 form launched."""
        if not torch.cuda.is_available():
            pytest.skip("needs a CUDA device: the kernel has no CPU mode")
        q, k, v, causal, kv, ql = (
            None if x is None else torch.from_numpy(x).cuda()
            if isinstance(x, np.ndarray) else x
            for x in _inputs(BF16_EDGE_CASES[name]))
        q, k, v = (x.to(torch.bfloat16) for x in (q, k, v))
        kn, vn = k, v
        if "nan" in name:
            kn, vn = (nan_past_kv_len(x, kv) for x in (k, v))
        kw = dict(causal=causal, kv_len=kv, q_len=ql)
        before = [getattr(fa, n) for n in fa.COUNTERS]
        out, lse = fa.flash_attention(q, kn, vn, **kw)
        again = fa.flash_attention(q, kn, vn, **kw)
        torch.cuda.synchronize()
        after = [getattr(fa, n) for n in fa.COUNTERS]
        # only the bf16 forward (no D-split form)
        assert [a - b for a, b in zip(after, before)] == \
            [0, 0, 0, 2] + [0] * 8
        assert torch.equal(out, again[0]) and torch.equal(lse, again[1])
        assert torch.isfinite(out).all()
        ref_out, ref_lse = fa.attention_plain_bf16(q, k, v, **kw)
        bf16_close(out, ref_out, BF16_OUT_FRAC, name)
        alive = ref_lse < fa.LSE_MASKED
        assert (lse - ref_lse)[alive].abs().max().item() <= 1e-4
        assert (lse[~alive] == fa.LSE_MASKED).all()
        assert (out[(~alive).permute(0, 2, 1)] == 0).all()

    def test_bf16_kernel_takes_a_negative_scale(self):
        """A negative scale through the bf16 form (the wrapper hands the
        kernel -q and -scale) against attention_plain_bf16 at that scale:
        out within one bf16 ulp plus BF16_OUT_FRAC, lse within 1e-4."""
        if not torch.cuda.is_available():
            pytest.skip("needs a CUDA device: the kernel has no CPU mode")
        q, k, v, causal, kv, ql = (
            None if x is None else torch.from_numpy(x).cuda()
            if isinstance(x, np.ndarray) else x
            for x in _inputs(CARD_CASES["causal_ragged_t150_d40"]))
        q, k, v = (x.to(torch.bfloat16) for x in (q, k, v))
        kw = dict(causal=causal, kv_len=kv, q_len=ql, scale=-0.2)
        out, lse = fa.flash_attention(q, k, v, **kw)
        torch.cuda.synchronize()
        ref_out, ref_lse = fa.attention_plain_bf16(q, k, v, **kw)
        bf16_close(out, ref_out, BF16_OUT_FRAC, "negative scale")
        assert (lse - ref_lse).abs().max().item() <= 1e-4

    @pytest.mark.parametrize("name", ["causal_ragged_t150_d40",
                                      "causal_kvlen_0_and_1_t70_d64",
                                      "cross_qlen_kvlen_d128"])
    def test_kernel_is_bit_identical_on_a_repeat(self, name):
        if not torch.cuda.is_available():
            pytest.skip("needs a CUDA device: the kernel has no CPU mode")
        q, k, v, causal, kv, ql = (
            None if x is None else torch.from_numpy(x).cuda()
            if isinstance(x, np.ndarray) else x
            for x in _inputs(CARD_CASES[name], seed=3))
        runs = [fa.flash_attention(q, k, v, causal=causal, kv_len=kv,
                                   q_len=ql) for _ in range(2)]
        torch.cuda.synchronize()
        for a, b in zip(*runs):
            assert torch.equal(a, b)
