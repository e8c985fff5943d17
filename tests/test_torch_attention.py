"""The port's flash attention against the JAX package's attention.

The same numpy inputs go through `paddle_tpu/parallel/ring.py`
(`flash_blocked_attention`, `dense_attention`, `_blocked_fwd`) and the
port's `ops/flash_attention.attention_plain` (the plain version the
kernel is held against on the card) and `parallel/ring.py`. f32 on the
CPU in both: atol 1e-5 on the rows that see at least one key (the
summation order differs). Rows that see no key are the port's own
rule: out exactly 0, lse exactly 1e30.

The kernel itself runs only on the card: `TestOnCard` is marked `cuda`
and skips here; on a machine with an H100 and no JAX it runs alone
(`python -m pytest -m cuda tests/test_torch_attention.py`).
"""

import numpy as np
import pytest
import torch

try:  # the CPU parity tests need JAX; the on-card tests do not
    import jax.numpy as jnp

    from paddle_tpu.parallel import ring as jring
except ImportError:
    jnp = None
from paddle_tpu_torch.ops import flash_attention as fa
from paddle_tpu_torch.parallel import ring as tring

ATOL = 1e-5

# (B, Tq, Tk, H, D, causal, kv_len, q_len)
CASES = {
    "causal_ragged_odd_t": (2, 37, 37, 2, 16, True, [37, 20], None),
    "noncausal_kvlen": (2, 29, 29, 3, 8, False, [29, 5], None),
    "causal_full": (1, 64, 64, 2, 32, True, None, None),
    "causal_kvlen_zero_row": (2, 19, 19, 2, 8, True, [0, 19], None),
    "cross_qlen_kvlen": (2, 21, 45, 2, 16, False, [45, 30], [13, 21]),
}


# the kernel takes head dims 32, 64 and 128: the same masks at those
CARD_CASES = {
    "causal_ragged_odd_t_d32": (2, 37, 37, 2, 32, True, [37, 20], None),
    "noncausal_kvlen_d64": (2, 29, 29, 3, 64, False, [29, 5], None),
    "causal_full_d32": (1, 64, 64, 2, 32, True, None, None),
    "causal_kvlen_zero_row_d64": (2, 19, 19, 2, 64, True, [0, 19], None),
    "cross_qlen_kvlen_d128": (2, 21, 45, 2, 128, False, [45, 30], [13, 21]),
}


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


def test_wrapper_takes_plain_path_on_cpu_and_counts_nothing():
    q, k, v, causal, kv, ql = _inputs(CASES["cross_qlen_kvlen"])
    before = fa.launches
    out, lse = fa.flash_attention(_t(q), _t(k), _t(v), causal=causal,
                                  kv_len=_t(kv), q_len=_t(ql))
    ref_out, ref_lse = _port(q, k, v, causal, kv, ql)
    assert fa.launches == before
    np.testing.assert_array_equal(out.numpy(), ref_out)
    np.testing.assert_array_equal(lse.numpy(), ref_lse)


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
        np.testing.assert_allclose(out.cpu().numpy(), ref_out, atol=1e-4)
        np.testing.assert_allclose(lse.cpu().numpy(), ref_lse, atol=1e-4)
