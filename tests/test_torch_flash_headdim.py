"""Flash attention past head dim 128 (the D-split forms) against the JAX
package, on the CPU.

The JAX wrapper hands any head dim to its kernel, and its blocked path
(`flash_dense_attention(impl="blocked")`) takes any D on the CPU. On the
card the port runs D > 128 through the D-split kernels
(`csrc/flash_dsplit.cuh`, at D padded to a multiple of 64); on the CPU
through the plain versions, which are what the kernels are held to on
the card (`chip_smoke.py` phase 3c). Here:

- the plain forward and backward against the JAX blocked path and its
  `jax.vjp` at D = 160, 256 and 384: out within 1e-5 of the largest
  entry, dq, dk, dv within 1e-4; the f32 and bf16 ops' CPU route and
  the zero-column padding the card's wrappers apply (D = 160 at 192);
- the port's LM at head dim 256 (`LMSpec(d_model=512, num_heads=2)`, 2
  layers, T = 64, attn_impl="flash") against the JAX LM on the same
  numpy weights: logits, loss and every gradient within 1e-4 of the
  largest entry; the served tokens (the paged LM through `generate`)
  equal to `greedy_decode_recompute`'s.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from paddle_tpu.core import arg as jarg
from paddle_tpu.decoding import kv_cache as jkv
from paddle_tpu.models import lm as jlm
from paddle_tpu.network import Network as JNetwork
from paddle_tpu.parallel import ring as jring

from paddle_tpu_torch.core import arg as targ
from paddle_tpu_torch.decoding import kv_cache as tkv
from paddle_tpu_torch.models import lm as tlm
from paddle_tpu_torch.network import Network as TNetwork
from paddle_tpu_torch.ops import flash_attention as fa
from paddle_tpu_torch.weights import params_from_numpy

DIMS = (160, 256, 384)
FWD_TOL, GRAD_TOL = 1e-5, 1e-4
# (B, T, H, causal, kv_len): kv_len >= 1 (the JAX blocked path gives a
# row without a key another value than the port's 0)
SHAPES = {"causal_ragged": (2, 70, 2, True, [70, 33]),
          "noncausal_kvlen": (2, 40, 1, False, [40, 9])}


def _inputs(B, T, H, D, seed):
    rng = np.random.default_rng(seed)
    return [rng.standard_normal((B, T, H, D)).astype(np.float32)
            for _ in range(4)]


def _max_rel(got, want):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return np.abs(got - want).max() / np.abs(want).max()


@pytest.mark.parametrize("shape", sorted(SHAPES))
@pytest.mark.parametrize("D", DIMS)
def test_plain_backward_matches_jax_blocked_vjp(D, shape):
    B, T, H, causal, kv_len = SHAPES[shape]
    q, k, v, do = _inputs(B, T, H, D, seed=D)
    kv = np.asarray(kv_len, np.int32)

    def jfn(q, k, v):
        return jring.flash_dense_attention(
            q, k, v, causal=causal, kv_len=jnp.asarray(kv), impl="blocked")

    ref_out, vjp = jax.vjp(jfn, *(jnp.asarray(x) for x in (q, k, v)))
    ref = vjp(jnp.asarray(do))
    tq, tk, tv, tdo = (torch.from_numpy(x) for x in (q, k, v, do))
    kw = dict(causal=causal, kv_len=torch.from_numpy(kv))
    out, lse = fa.attention_plain(tq, tk, tv, **kw)
    assert _max_rel(out.numpy(), ref_out) <= FWD_TOL
    grads = fa.attention_bwd_plain(tq, tk, tv, out, lse, tdo, **kw)
    for n, g, r in zip(("dq", "dk", "dv"), grads, ref):
        assert _max_rel(g.numpy(), r) <= GRAD_TOL, (D, shape, n)


@pytest.mark.parametrize("D", DIMS)
def test_ops_take_the_plain_route_on_the_cpu(D):
    """flash_attention / flash_attention_bwd on CPU tensors at D > 128:
    the plain versions (f32 and bf16), no launch, equal to calling them
    directly."""
    B, T, H, causal, kv_len = SHAPES["causal_ragged"]
    q, k, v, do = (torch.from_numpy(x) for x in _inputs(B, T, H, D, 1))
    kw = dict(causal=causal, kv_len=torch.tensor(kv_len, dtype=torch.int32))
    before = [getattr(fa, n) for n in fa.COUNTERS]
    for dt, plain, plain_bwd in (
            (torch.float32, fa.attention_plain, fa.attention_bwd_plain),
            (torch.bfloat16, fa.attention_plain_bf16,
             fa.attention_bwd_plain_bf16)):
        x = [t.to(dt) for t in (q, k, v, do)]
        out, lse = fa.flash_attention(*x[:3], **kw)
        ref_out, ref_lse = plain(*x[:3], **kw)
        assert torch.equal(out, ref_out) and torch.equal(lse, ref_lse)
        got = fa.flash_attention_bwd(*x[:3], out, lse, x[3], **kw)
        ref = plain_bwd(*x[:3], out, lse, x[3], **kw)
        assert all(torch.equal(a, b) for a, b in zip(got, ref))
        assert all(g.dtype == dt for g in got)
    assert [getattr(fa, n) for n in fa.COUNTERS] == before


def test_split_padding_gives_the_unpadded_result():
    """What the card's wrappers do at D = 160: zero columns up to 192
    (the D-split takes multiples of 64), the scale of 160, the padding
    sliced off: the unpadded call's out, lse, dq, dk and dv."""
    B, T, H, causal, kv_len = SHAPES["causal_ragged"]
    D = 160
    q, k, v, do = (torch.from_numpy(x) for x in _inputs(B, T, H, D, 2))
    kw = dict(causal=causal, kv_len=torch.tensor(kv_len, dtype=torch.int32))
    out, lse = fa.attention_plain(q, k, v, **kw)
    grads = fa.attention_bwd_plain(q, k, v, out, lse, do, **kw)
    dp = fa.kernel_head_dim(D)
    assert dp == 192 and fa.is_split(dp)
    qp, kp, vp, dop = (fa.pad_head_dim(x, dp) for x in (q, k, v, do))
    outp, lsep = fa.attention_plain(qp, kp, vp, scale=D ** -0.5, **kw)
    gradp = fa.attention_bwd_plain(qp, kp, vp, outp, lsep, dop,
                                   scale=D ** -0.5, **kw)
    np.testing.assert_allclose(lsep.numpy(), lse.numpy(), rtol=1e-6,
                               atol=1e-6)
    for got, ref in zip((outp, *gradp), (out, *grads)):
        assert (got[..., D:] == 0).all()
        np.testing.assert_allclose(got[..., :D].numpy(), ref.numpy(),
                                   rtol=1e-6, atol=1e-6)


# ---- the LM at head dim 256 ----------------------------------------------

SPEC = dict(vocab=128, d_model=512, num_heads=2, num_layers=2,
            attn_impl="flash")
T_LM = 64
LENS = np.asarray([64, 41, 17], np.int32)
EOS = 1


@pytest.fixture(scope="module")
def lm_params():
    jspec = jlm.LMSpec(**SPEC)
    assert jspec.head_dim == 256
    jp = jlm.lm_init_params(jspec, jax.random.key(0))
    np_p = {k: np.asarray(v) for k, v in jp.items()}
    return jp, np_p, params_from_numpy(np_p, device="cpu")


def test_lm_logits_match_jax(lm_params):
    jp, _np, tp = lm_params
    ids = np.random.default_rng(0).integers(
        2, SPEC["vocab"], (3, T_LM)).astype(np.int32)
    ref = np.asarray(jlm.lm_forward(jlm.LMSpec(**SPEC), jp, ids,
                                    lens=LENS))
    got = tlm.lm_forward(tlm.LMSpec(**SPEC), tp, torch.from_numpy(ids),
                         lens=torch.from_numpy(LENS)).numpy()
    for r, n in enumerate(LENS):
        assert _max_rel(got[r, :n], ref[r, :n]) <= 1e-4, r


def test_lm_loss_and_gradients_match_jax(lm_params):
    """The training path (the DSL conf through Network.loss_fn): the
    loss and every parameter's gradient within 1e-4 of the largest
    entry."""
    _jp, np_p, _tp = lm_params
    rng = np.random.default_rng(1)
    ids = rng.integers(2, SPEC["vocab"], (3, T_LM)).astype(np.int32)
    lbl = rng.integers(2, SPEC["vocab"], (3, T_LM)).astype(np.int32)
    jnet = JNetwork(jlm.transformer_lm(jlm.LMSpec(**SPEC)))
    tnet = TNetwork(tlm.transformer_lm(tlm.LMSpec(**SPEC)))
    (jloss, _aux), jg = jax.value_and_grad(jnet.loss_fn, has_aux=True)(
        {k: jnp.asarray(v) for k, v in np_p.items()},
        {"ids": jarg.id_arg(ids, LENS), "label": jarg.id_arg(lbl, LENS)})
    tp = {k: v.requires_grad_(True)
          for k, v in params_from_numpy(np_p, device="cpu").items()}
    tloss, _aux = tnet.loss_fn(
        tp, {"ids": targ.id_arg(ids, LENS), "label": targ.id_arg(lbl, LENS)})
    tloss.backward()
    assert abs(tloss.item() - float(jloss)) <= 1e-4 * abs(float(jloss))
    assert set(jg) == set(tp)
    for k in jg:
        assert _max_rel(tp[k].grad.numpy(), jg[k]) <= 1e-4, k


def test_lm_served_tokens_equal_the_recompute(lm_params):
    """The paged LM (flash prefill, paged decode) at head dim 256: its
    tokens equal `greedy_decode_recompute`'s, the port's and the JAX
    package's."""
    jp, _np, tp = lm_params
    ids = np.random.default_rng(2).integers(
        2, SPEC["vocab"], (3, 40)).astype(np.int32)
    lens = np.asarray([40, 23, 9], np.int32)
    spec = tlm.LMSpec(**SPEC)
    cache = tkv.PagedKVCache(spec, num_pages=64, page_size=8,
                             max_pages_per_seq=8, device="cpu")
    got, _s = tkv.PagedLM(spec, tp, cache, eos_id=EOS).generate(ids, lens,
                                                                 6)
    ref, _rs = tlm.greedy_decode_recompute(
        dataclasses.replace(spec, attn_impl="dense"), tp, ids, lens, 6, EOS)
    jref, _js = jlm.greedy_decode_recompute(
        jlm.LMSpec(**dict(SPEC, attn_impl="dense")), jp, ids, lens, 6, EOS)
    np.testing.assert_array_equal(np.asarray(got), np.asarray(ref))
    np.testing.assert_array_equal(np.asarray(ref), np.asarray(jref))
