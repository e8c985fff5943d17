"""The port's paged KV cache (`paddle_tpu_torch/decoding/kv_cache.py`)
against `paddle_tpu/decoding/kv_cache.py` and the recompute reference.

Same params (the JAX initializer's, carried over as numpy), same
prompts: generation through the page pool must give the same tokens as
the full recompute (`greedy_decode_recompute`, deterministic), scores
within rtol 1e-4. The JAX PagedLM is not a steady oracle under pytest:
in some runs it returns other tokens for two of the three prompts
(ROADMAP C1). Its tokens, scores and cache counters are compared with
the port's only in a run where its tokens equal the recompute's. The
pool after a prefill holds the JAX pool's K/V at the written slots
(atol 1e-5, f32 matmuls in two BLAS libraries); every page comes back.
"""

import dataclasses

import numpy as np
import pytest

import jax

from paddle_tpu.decoding import kv_cache as jkv
from paddle_tpu.models import lm as jlm
from paddle_tpu_torch.decoding import kv_cache as tkv
from paddle_tpu_torch.models import lm as tlm
from paddle_tpu_torch.weights import params_from_numpy

JSPEC = jlm.LMSpec(vocab=128, d_model=64, num_heads=2, num_layers=2)
TSPEC = tlm.LMSpec(vocab=128, d_model=64, num_heads=2, num_layers=2)
EOS = 1


@pytest.fixture(scope="module")
def params():
    jp = jlm.lm_init_params(JSPEC, jax.random.key(0))
    return jp, params_from_numpy({k: np.asarray(v) for k, v in jp.items()},
                                 device="cpu")


def _prompts(b=3, t0=11, seed=0):
    rng = np.random.default_rng(seed)
    ids = rng.integers(2, JSPEC.vocab, (b, t0)).astype(np.int32)
    lens = np.asarray([t0, t0 - 3, t0 - 5], np.int32)[:b]
    return ids, lens


def _jplm(jp, spec=JSPEC):
    cache = jkv.PagedKVCache(spec, num_pages=64, page_size=4,
                             max_pages_per_seq=16)
    return jkv.PagedLM(spec, jp, cache, eos_id=EOS)


def _tplm(tp, spec=TSPEC, num_pages=64):
    cache = tkv.PagedKVCache(spec, num_pages=num_pages, page_size=4,
                             max_pages_per_seq=16, device="cpu")
    return tkv.PagedLM(spec, tp, cache, eos_id=EOS)


@pytest.mark.parametrize("impl", ["dense", "flash"])
def test_generate_matches_jax_and_recompute(params, impl):
    jp, tp = params
    ids, lens = _prompts()
    max_new = 9
    jspec = dataclasses.replace(JSPEC, attn_impl=impl)
    tspec = dataclasses.replace(TSPEC, attn_impl=impl)
    ref_t, ref_s = jlm.greedy_decode_recompute(jspec, jp, ids, lens,
                                               max_new, EOS)
    tplm = _tplm(tp, tspec)
    got_t, got_s = tplm.generate(ids, lens, max_new)
    np.testing.assert_array_equal(got_t, ref_t)
    np.testing.assert_allclose(got_s, ref_s, rtol=1e-4, atol=1e-4)
    assert tplm.last_chain_depth == max_new
    jplm = _jplm(jp, jspec)
    j_t, j_s = jplm.generate(ids, lens, max_new)
    if np.array_equal(j_t, ref_t):
        np.testing.assert_array_equal(got_t, j_t)
        np.testing.assert_allclose(got_s, j_s, rtol=1e-4, atol=1e-4)
        # the measured counters agree with the JAX cache's
        for name in ("prefilled_tokens", "appended_tokens",
                     "cached_prefix_tokens"):
            assert getattr(tplm.cache, name) == getattr(jplm.cache, name)


def test_pool_after_prefill_matches_jax(params):
    jp, tp = params
    ids, lens = _prompts()
    bucket = 12
    padded = np.zeros((3, bucket), np.int32)
    padded[:, :ids.shape[1]] = ids
    jplm, tplm = _jplm(jp), _tplm(tp)
    pages = [[3, 7, 1], [0, 9, 4], [12, 2, 5]]
    j_tok, j_sc = jplm.prefill(padded, lens, pages)
    t_tok, t_sc = tplm.prefill(padded, lens, pages)
    np.testing.assert_array_equal(t_tok.numpy(), np.asarray(j_tok))
    np.testing.assert_allclose(t_sc.numpy(), np.asarray(j_sc), rtol=1e-5)
    jk, jv = (np.asarray(x) for x in jplm.cache.pool)
    tk, tv = (x.numpy() for x in tplm.cache.pool)
    ps = 4
    for r, ln in enumerate(lens):
        for p in range(int(ln)):
            page, off = pages[r][p // ps], p % ps
            np.testing.assert_allclose(tk[:, page, off], jk[:, page, off],
                                       atol=1e-5)
            np.testing.assert_allclose(tv[:, page, off], jv[:, page, off],
                                       atol=1e-5)


def test_pool_pages_all_returned(params):
    _jp, tp = params
    ids, lens = _prompts()
    plm = _tplm(tp)
    total = plm.cache.free_page_count()
    plm.generate(ids, lens, 6)
    assert plm.cache.free_page_count() == total
    assert plm.cache.cached_prefix_tokens > 0
    assert plm.cache.appended_tokens > 0


def test_page_geometry_matches_jax():
    j = jkv.PagedKVCache(JSPEC, num_pages=40, page_size=4,
                         max_pages_per_seq=16)
    t = tkv.PagedKVCache(TSPEC, num_pages=40, page_size=4,
                         max_pages_per_seq=16, device="cpu")
    assert t.max_seq_len == j.max_seq_len
    for n in range(1, t.max_seq_len + 1):
        assert t.bucket_for(n) == j.bucket_for(n)
        assert t.pages_for_len(n) == j.pages_for_len(n)
    with pytest.raises(tkv.PoolExhausted):
        t.alloc(41)
    got = t.alloc(5)
    assert got == j.alloc(5)
    t.free(got)
    assert t.free_page_count() == 40
    np.testing.assert_array_equal(
        tkv._page_table([[3, 1], [5]], 4), jkv._page_table([[3, 1], [5]], 4))
