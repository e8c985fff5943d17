"""The port's beam and speculative decode over the paged KV pool
(`paddle_tpu_torch/decoding/kv_cache.py`, `models/lm.py`) against
`paddle_tpu/decoding/kv_cache.py` and `paddle_tpu/models/lm.py`.

Same params (the JAX initializer's, carried over as numpy), same
prompts:

- The beam expansion rule (`beam_init_select`, `beam_step_select`) on
  seeded log-probs with ties and finished beams: parents, tokens and
  finished flags exact, scores within 1e-6.
- `beam_decode_recompute` against the JAX one; the port's paged
  `beam_generate` against the JAX recompute for prompt lengths [11, 8]
  and [3, 11], dense and flash: each group's beams as a canonical set
  (rounded score, tokens), scores within 1e-4. With [3, 11] the first
  group's prompt is shorter than a page, so page 0 (its first beam
  row's first page) holds generated tokens: the JAX `beam_generate`
  writes stale contents there through the padded slots of its page
  table (ROADMAP C4) and is compared with the port only on [11, 8].
- Pages the decode's rows do not own, page 0 among them, hold a
  sentinel before the decode and still hold it after.
- `SpeculativePagedLM` with a bad draft and with the target as its own
  draft: tokens equal to the recompute, scores within 1e-4, and chain
  depth, accept rate and cache counters equal to the JAX object's on
  the same inputs where the JAX tokens equal the recompute's (the JAX
  paged LM is not a steady oracle under pytest, ROADMAP C1).
"""

import dataclasses

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from paddle_tpu.decoding import kv_cache as jkv
from paddle_tpu.models import lm as jlm
from paddle_tpu_torch.decoding import kv_cache as tkv
from paddle_tpu_torch.models import lm as tlm
from paddle_tpu_torch.weights import params_from_numpy

JSPEC = jlm.LMSpec(vocab=128, d_model=64, num_heads=2, num_layers=2)
TSPEC = tlm.LMSpec(vocab=128, d_model=64, num_heads=2, num_layers=2)
EOS = 1
K, MAX_NEW = 3, 7
SENTINEL = 12345.0
COUNTERS = ("prefilled_tokens", "appended_tokens", "cached_prefix_tokens")


def _both(jp):
    return jp, params_from_numpy({k: np.asarray(v) for k, v in jp.items()},
                                 device="cpu")


@pytest.fixture(scope="module")
def params():
    return _both(jlm.lm_init_params(JSPEC, jax.random.key(0)))


def _ids(b=2, t0=11, seed=0):
    rng = np.random.default_rng(seed)
    return rng.integers(2, JSPEC.vocab, (b, t0)).astype(np.int32)


def _jplm(jp, spec=JSPEC):
    cache = jkv.PagedKVCache(spec, num_pages=64, page_size=4,
                             max_pages_per_seq=16)
    return jkv.PagedLM(spec, jp, cache, eos_id=EOS)


def _tplm(tp, spec=TSPEC, num_pages=64):
    cache = tkv.PagedKVCache(spec, num_pages=num_pages, page_size=4,
                             max_pages_per_seq=16, device="cpu")
    return tkv.PagedLM(spec, tp, cache, eos_id=EOS)


def _canon(toks, scores, g):
    return sorted((round(float(scores[g, j]), 3),
                   tuple(int(x) for x in toks[g, j]))
                  for j in range(toks.shape[1]))


def _same_beams(got, ref):
    (gt, gs), (rt, rs) = got, ref
    assert gt.shape == rt.shape and gt.dtype == np.int32
    for g in range(rt.shape[0]):
        assert _canon(gt, gs, g) == _canon(rt, rs, g), g
    np.testing.assert_allclose(np.sort(gs, axis=1), np.sort(rs, axis=1),
                               rtol=1e-4, atol=1e-4)


def _select_inputs(seed, b=3, k=4, v=20):
    """Seeded scores and log-probs rounded to one decimal (many exact
    ties), a finished beam in each group but the last."""
    rng = np.random.default_rng(seed)
    scores = np.round(rng.normal(-3, 1, (b, k)), 1).astype(np.float32)
    logp = np.round(rng.normal(-3, 1, (b, k, v)), 1).astype(np.float32)
    finished = np.zeros((b, k), bool)
    finished[:-1, 1] = True
    finished[0, 3] = True
    return scores, logp, finished


@pytest.mark.parametrize("k", [1, 3, 5])
def test_beam_init_select_matches_jax(k):
    logp0 = np.round(np.random.default_rng(k).normal(-3, 1, (4, 30)),
                     1).astype(np.float32)
    logp0[1, :] = -2.0                      # a row of exact ties
    js, jt = jlm.beam_init_select(jnp.asarray(logp0), k)
    ts, tt = tlm.beam_init_select(torch.from_numpy(logp0), k)
    assert tt.dtype == torch.int32
    np.testing.assert_array_equal(tt.numpy(), np.asarray(jt))
    np.testing.assert_allclose(ts.numpy(), np.asarray(js), rtol=0,
                               atol=1e-6)


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_beam_step_select_matches_jax(seed):
    scores, logp, finished = _select_inputs(seed)
    jout = jlm.beam_step_select(jnp.asarray(scores), jnp.asarray(logp),
                                jnp.asarray(finished), EOS)
    tout = tlm.beam_step_select(torch.from_numpy(scores),
                                torch.from_numpy(logp),
                                torch.from_numpy(finished), EOS)
    names = ("scores", "parent", "token", "finished")
    for name, j, t in zip(names, jout, tout):
        if name == "scores":
            np.testing.assert_allclose(t.numpy(), np.asarray(j), rtol=0,
                                       atol=1e-6)
        else:
            np.testing.assert_array_equal(t.numpy(), np.asarray(j))
    # a finished beam survives only as eos at its frozen score
    assert (tout[2][tout[3] & torch.gather(
        torch.from_numpy(finished), 1, tout[1].long())] == EOS).all()


@pytest.mark.parametrize("lens", [[11, 8], [3, 11]])
def test_beam_decode_recompute_matches_jax(params, lens):
    jp, tp = params
    ids, lens = _ids(), np.asarray(lens, np.int32)
    ref = jlm.beam_decode_recompute(JSPEC, jp, ids, lens, K, MAX_NEW, EOS)
    got = tlm.beam_decode_recompute(TSPEC, tp, ids, lens, K, MAX_NEW, EOS)
    np.testing.assert_array_equal(got[0], np.asarray(ref[0]))
    np.testing.assert_allclose(got[1], np.asarray(ref[1]), rtol=1e-5,
                               atol=1e-5)


@pytest.mark.parametrize("impl", ["dense", "flash"])
@pytest.mark.parametrize("lens", [[11, 8], [3, 11]])
def test_beam_generate_matches_jax_recompute(params, lens, impl):
    jp, tp = params
    ids, lens = _ids(), np.asarray(lens, np.int32)
    jspec = dataclasses.replace(JSPEC, attn_impl=impl)
    tspec = dataclasses.replace(TSPEC, attn_impl=impl)
    ref = jlm.beam_decode_recompute(jspec, jp, ids, lens, K, MAX_NEW, EOS)
    plm = _tplm(tp, tspec)
    total = plm.cache.free_page_count()
    got = plm.beam_generate(ids, lens, K, MAX_NEW)
    _same_beams(got, (np.asarray(ref[0]), np.asarray(ref[1])))
    assert plm.last_chain_depth == MAX_NEW
    assert plm.last_copy_bytes > 0
    tl = plm.last_timeline
    assert tl["dispatch_s"] > 0 and tl["device_s"] >= 0
    assert plm.cache.free_page_count() == total


def test_beam_generate_matches_jax_paged_and_its_counters(params):
    """Prompt lengths [11, 8], where the JAX paged beam agrees with its
    own recompute: the same beams and the same measured counters."""
    jp, tp = params
    ids, lens = _ids(), np.asarray([11, 8], np.int32)
    jplm, tplm = _jplm(jp), _tplm(tp)
    j_t, j_s = jplm.beam_generate(ids, lens, K, MAX_NEW)
    got = tplm.beam_generate(ids, lens, K, MAX_NEW)
    ref = jlm.beam_decode_recompute(JSPEC, jp, ids, lens, K, MAX_NEW, EOS)
    _same_beams(got, (np.asarray(ref[0]), np.asarray(ref[1])))
    if all(_canon(j_t, j_s, g) == _canon(*ref, g) for g in range(2)):
        _same_beams(got, (j_t, j_s))
    assert tplm.last_chain_depth == jplm.last_chain_depth
    for name in COUNTERS:
        assert getattr(tplm.cache, name) == getattr(jplm.cache, name), name


def test_prefill_beam_k_matches_jax(params):
    """The beam prefill selects the first K expansions in the same call,
    and writes the rows' pages as the JAX prefill does."""
    jp, tp = params
    ids = _ids(3)
    lens = np.asarray([11, 3, 7], np.int32)
    padded = np.zeros((3, 12), np.int32)
    padded[:, :11] = ids
    pages = [[3, 7, 1], [0, 9, 4], [12, 2, 5]]
    jplm, tplm = _jplm(jp), _tplm(tp)
    j_tok, j_sc = jplm.prefill(padded, lens, pages, beam_k=K)
    t_tok, t_sc = tplm.prefill(padded, lens, pages, beam_k=K)
    assert tuple(t_tok.shape) == (3, K) and t_tok.dtype == torch.int32
    np.testing.assert_array_equal(t_tok.numpy(), np.asarray(j_tok))
    np.testing.assert_allclose(t_sc.numpy(), np.asarray(j_sc), rtol=1e-5)
    jk = np.asarray(jplm.cache.pool[0])
    tk = tplm.cache.pool[0].numpy()
    for r, ln in enumerate(lens):
        for p in range(int(ln)):
            page, off = pages[r][p // 4], p % 4
            np.testing.assert_allclose(tk[:, page, off], jk[:, page, off],
                                       atol=1e-5)
    assert tplm.cache.prefilled_tokens == jplm.cache.prefilled_tokens


@pytest.mark.parametrize("lens", [[11, 8], [3, 11]])
def test_beam_never_writes_pages_its_rows_do_not_own(params, lens):
    """Another request holds pages 0..3 (page 0 is where padded page
    table slots point). Those pages and every page the free list never
    hands out hold a sentinel before the decode and after it."""
    _jp, tp = params
    ids, lens = _ids(), np.asarray(lens, np.int32)
    plm = _tplm(tp, num_pages=80)
    foreign = plm.cache.alloc(4)
    assert foreign == [0, 1, 2, 3]
    handed = set()
    alloc = plm.cache.alloc

    def recording_alloc(n):
        got = alloc(n)
        handed.update(got)
        return got

    plm.cache.alloc = recording_alloc
    pool_k, pool_v = plm.cache.ensure_pool()
    pool_k.fill_(SENTINEL)
    pool_v.fill_(SENTINEL)
    got = plm.beam_generate(ids, lens, K, MAX_NEW)
    unowned = [p for p in range(plm.cache.num_pages) if p not in handed]
    assert set(foreign) <= set(unowned) and len(unowned) > 4
    for pool in (pool_k, pool_v):
        assert (pool[:, unowned] == SENTINEL).all()
    # and the sentinel, read through the padded slots, changed nothing
    ref = tlm.beam_decode_recompute(TSPEC, tp, ids, lens, K, MAX_NEW, EOS)
    _same_beams(got, ref)


def test_beam_parent_copy_moves_only_owned_slots(params):
    """The copy plan: a row whose parent is itself moves nothing; every
    other row's pages receive its parent's, slot by slot."""
    _jp, tp = params
    plm = _tplm(tp)
    pool_k, pool_v = plm.cache.ensure_pool()
    for p in range(plm.cache.num_pages):
        pool_k[:, p] = p
        pool_v[:, p] = -p
    rows = [[[5, 6], [7, 8], [9, 10]], [[20], [21], [22]]]
    parent = np.asarray([[0, 0, 2], [2, 1, 2]])
    moved = plm._parent_copy(parent, rows)
    page_bytes = pool_k[:, 0].numel() * 4
    assert moved == 2 * 2 * 3 * page_bytes   # rows (0,1) and (1,0)
    want = {5: 5, 6: 6, 7: 5, 8: 6, 9: 9, 10: 10, 20: 22, 21: 21, 22: 22}
    for page, src in want.items():
        assert (pool_k[:, page] == src).all() and (
            pool_v[:, page] == -src).all(), page
    assert (pool_k[:, 0] == 0).all()


def _spec_pair(jp, tp, jdp, tdp, propose_k=3):
    jspec = jkv.SpeculativePagedLM(_jplm(jp), _jplm(jdp),
                                   propose_k=propose_k)
    tspec = tkv.SpeculativePagedLM(_tplm(tp), _tplm(tdp),
                                   propose_k=propose_k)
    return jspec, tspec


@pytest.mark.parametrize("draft", ["bad", "self"])
def test_speculative_paged_matches_target_and_jax(params, draft):
    jp, tp = params
    ids = _ids(3)
    lens = np.asarray([11, 8, 6], np.int32)
    max_new = 10 if draft == "bad" else 9
    if draft == "bad":
        jdp, tdp = _both(jlm.lm_init_params(JSPEC, jax.random.key(7)))
    else:
        jdp, tdp = jp, tp
    ref_t, ref_s = jlm.greedy_decode_recompute(JSPEC, jp, ids, lens,
                                               max_new, EOS)
    jspec, tspec = _spec_pair(jp, tp, jdp, tdp)
    got_t, got_s = tspec.generate(ids, lens, max_new)
    np.testing.assert_array_equal(got_t, ref_t)
    np.testing.assert_allclose(got_s, ref_s, rtol=1e-4, atol=1e-4)
    greedy_t, _ = _tplm(tp).generate(ids, lens, max_new)
    np.testing.assert_array_equal(got_t, greedy_t)
    if draft == "self":
        assert tspec.last_accept_rate == pytest.approx(1.0)
        assert tspec.last_chain_depth < max_new
    else:
        assert 0.0 < tspec.last_accept_rate < 1.0
    j_t, _j_s = jspec.generate(ids, lens, max_new)
    if np.array_equal(j_t, ref_t):
        assert tspec.last_chain_depth == jspec.last_chain_depth
        assert tspec.last_accept_rate == jspec.last_accept_rate
        for name in COUNTERS:
            assert getattr(tspec.target.cache, name) == getattr(
                jspec.target.cache, name), name
    for plm in (tspec.target, tspec.draft):
        assert plm.cache.free_page_count() == plm.cache.num_pages


def test_prefix_recompute_bytes_saved_matches_jax():
    for n in (0, 1, 4096):
        assert tlm.lm_prefix_recompute_bytes_saved(TSPEC, n) == \
            jlm.lm_prefix_recompute_bytes_saved(JSPEC, n)
