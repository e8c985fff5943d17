"""The port's flash-attention backward against the JAX package's.

The same numpy q, k, v and output gradient go through
`jax.vjp(paddle_tpu/parallel/ring.py::flash_blocked_attention)` (the
blocked oracle whose custom VJP, `_flash_blocked_bwd`, states the
contract the TPU kernels implement) and through the port's
`ops/flash_attention.attention_bwd_plain` and the autograd Function
behind `parallel/ring.flash_dense_attention`. f32 on the CPU in both:
rtol = atol = 1e-5 (the summation orders differ).

The JAX function has no `q_len`: for cross-attention the output
gradient of rows at or past q_len is 0 there (the attention layer
zeroes those rows), so dk and dv agree, dq agrees on the live rows,
and the port's dq of the dead rows is exactly 0.

`TestOnCard` (marked `cuda`) holds the Hopper kernels against
attention_bwd_plain on the card and shows that `loss.backward()`
through flash_dense_attention reaches q, k and v. It skips here; on a
machine with an H100 and no JAX it runs alone:
`python -m pytest -m cuda tests/test_torch_flash_bwd.py`.
"""

import numpy as np
import pytest
import torch

try:  # the CPU parity tests need JAX; the on-card tests do not
    import jax
    import jax.numpy as jnp

    from paddle_tpu.parallel import ring as jring
except ImportError:
    jax = None

from paddle_tpu_torch.ops import flash_attention as fa
from paddle_tpu_torch.parallel import ring as tring

TOL = 1e-5

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

# the kernels take head dims 32, 64 and 128
CARD_CASES = {
    "causal_full_d64": (2, 128, 128, 2, 64, True, None, None),
    "causal_ragged_d64": (3, 150, 150, 2, 64, True, [150, 70, 1], None),
    "causal_odd_t_d32": (2, 77, 77, 3, 32, True, [77, 40], None),
    "noncausal_kvlen0_d32": (2, 64, 64, 2, 32, False, [0, 64], None),
    "cross_qlen_d128": (2, 64, 200, 2, 128, False, [200, 123], [50, 64]),
}


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
