"""The port's LM math (`paddle_tpu_torch/models/lm.py`) against
`paddle_tpu/models/lm.py` on the same parameters.

Params come from the JAX package's own initializer
(`lm_init_params(SPEC, jax.random.key(0))`) and cross over through
`weights.params_from_numpy`; inputs are numpy draws from a seed. Logits
agree to atol 1e-4 (f32 matmuls in two different BLAS libraries); the
greedy reference's tokens are exact.
"""

import dataclasses

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from paddle_tpu.models import lm as jlm
from paddle_tpu_torch.models import lm as tlm
from paddle_tpu_torch.weights import params_from_numpy, params_to_numpy

JSPEC = jlm.LMSpec(vocab=128, d_model=64, num_heads=2, num_layers=2)
TSPEC = tlm.LMSpec(vocab=128, d_model=64, num_heads=2, num_layers=2)
ATOL = 1e-4
EOS = 1


@pytest.fixture(scope="module")
def params():
    jp = jlm.lm_init_params(JSPEC, jax.random.key(0))
    np_params = {k: np.asarray(v) for k, v in jp.items()}
    return jp, np_params, params_from_numpy(np_params, device="cpu")


def _prompts(b=3, t0=11, seed=0):
    rng = np.random.default_rng(seed)
    ids = rng.integers(2, JSPEC.vocab, (b, t0)).astype(np.int32)
    lens = np.asarray([t0, t0 - 3, t0 - 5], np.int32)[:b]
    return ids, lens


def test_param_names_shapes_and_bit_exact_round_trip(params):
    jp, np_params, tp = params
    assert tlm.lm_param_shapes(TSPEC) == {
        k: tuple(v.shape) for k, v in jp.items()
    }
    back = params_to_numpy(tp)
    for k, v in np_params.items():
        assert back[k].dtype == v.dtype
        np.testing.assert_array_equal(back[k], v)
    init = tlm.lm_init_params(TSPEC, torch.Generator().manual_seed(0),
                              device="cpu")
    assert {k: tuple(v.shape) for k, v in init.items()} == \
        tlm.lm_param_shapes(TSPEC)
    assert all(v.dtype == torch.float32 for v in init.values())


@pytest.mark.parametrize("impl", ["dense", "flash"])
def test_lm_forward_logits_and_kv(params, impl):
    jp, _np, tp = params
    ids, lens = _prompts()
    ref, rk, rv = jlm.lm_forward(dataclasses.replace(JSPEC, attn_impl=impl),
                                 jp, ids, lens=lens, with_kv=True)
    got, gk, gv = tlm.lm_forward(
        dataclasses.replace(TSPEC, attn_impl=impl), tp,
        torch.from_numpy(ids), lens=torch.from_numpy(lens), with_kv=True)
    ref, got = np.asarray(ref), got.numpy()
    for r, ln in enumerate(lens):
        np.testing.assert_allclose(got[r, :ln], ref[r, :ln], atol=ATOL)
        np.testing.assert_allclose(gk.numpy()[:, r, :ln],
                                   np.asarray(rk)[:, r, :ln], atol=ATOL)
        np.testing.assert_allclose(gv.numpy()[:, r, :ln],
                                   np.asarray(rv)[:, r, :ln], atol=ATOL)


def test_decode_chunk_matches_jax(params):
    jp, _np, tp = params
    rng = np.random.default_rng(1)
    b, t0, n = 2, 6, 3
    L, H, hd = TSPEC.num_layers, TSPEC.num_heads, TSPEC.head_dim
    s = t0 + n + 2
    ctx_k = rng.standard_normal((L, b, s, H, hd)).astype(np.float32)
    ctx_v = rng.standard_normal((L, b, s, H, hd)).astype(np.float32)
    toks = rng.integers(2, TSPEC.vocab, (b, n)).astype(np.int32)
    start = np.asarray([t0, t0 - 2], np.int32)
    ref, rk, rv = jlm.lm_decode_chunk(JSPEC, jp, toks, start,
                                      jnp.asarray(ctx_k),
                                      jnp.asarray(ctx_v))
    got, gk, gv = tlm.lm_decode_chunk(
        TSPEC, tp, torch.from_numpy(toks), torch.from_numpy(start),
        torch.from_numpy(ctx_k.copy()), torch.from_numpy(ctx_v.copy()))
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), atol=ATOL)
    np.testing.assert_allclose(gk.numpy(), np.asarray(rk), atol=ATOL)
    np.testing.assert_allclose(gv.numpy(), np.asarray(rv), atol=ATOL)


def test_chunk_attention_matches_jax():
    rng = np.random.default_rng(2)
    q = rng.standard_normal((2, 3, 2, 8)).astype(np.float32)
    ck = rng.standard_normal((2, 10, 2, 8)).astype(np.float32)
    cv = rng.standard_normal((2, 10, 2, 8)).astype(np.float32)
    start = np.asarray([4, 7], np.int32)
    ref = jlm.chunk_attention(jnp.asarray(q), jnp.asarray(ck),
                              jnp.asarray(cv), jnp.asarray(start))
    got = tlm.chunk_attention(torch.from_numpy(q), torch.from_numpy(ck),
                              torch.from_numpy(cv), torch.from_numpy(start))
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), atol=1e-5)


@pytest.mark.parametrize("impl", ["dense", "flash"])
def test_greedy_recompute_tokens_exact(params, impl):
    jp, _np, tp = params
    ids, lens = _prompts()
    ref_t, ref_s = jlm.greedy_decode_recompute(
        dataclasses.replace(JSPEC, attn_impl=impl), jp, ids, lens, 7, EOS)
    got_t, got_s = tlm.greedy_decode_recompute(
        dataclasses.replace(TSPEC, attn_impl=impl), tp, ids, lens, 7, EOS)
    np.testing.assert_array_equal(got_t, ref_t)
    np.testing.assert_allclose(got_s, ref_s, rtol=1e-4, atol=1e-4)


def test_accounting_matches_jax():
    for spec in (JSPEC, jlm.LMSpec(d_model=256, num_layers=3)):
        tspec = tlm.LMSpec(**dataclasses.asdict(spec))
        assert tlm.lm_prefix_token_recompute_bytes(tspec) == \
            jlm.lm_prefix_token_recompute_bytes(spec)
