"""The port's continuous-batching engine (`paddle_tpu_torch/serving/
lm_engine.py`) against the recompute reference and the JAX engine.

The engine stops a request at eos while the recompute reference keeps
emitting eos up to max_new, so answers are compared THROUGH THE FIRST
EOS: `_through_eos(reference row)` is what the engine must return.
"""

import numpy as np
import pytest

import jax

from paddle_tpu.decoding import kv_cache as jkv
from paddle_tpu.models import lm as jlm
from paddle_tpu.serving import lm_engine as jeng
from paddle_tpu_torch.decoding import kv_cache as tkv
from paddle_tpu_torch.models import lm as tlm
from paddle_tpu_torch.serving.lm_engine import LMEngine, PagedLMModel
from paddle_tpu_torch.weights import params_from_numpy

JSPEC = jlm.LMSpec(vocab=128, d_model=64, num_heads=2, num_layers=2)
TSPEC = tlm.LMSpec(vocab=128, d_model=64, num_heads=2, num_layers=2)
EOS = 1
MAX_NEW = 8


@pytest.fixture(scope="module")
def params():
    jp = jlm.lm_init_params(JSPEC, jax.random.key(0))
    return jp, params_from_numpy({k: np.asarray(v) for k, v in jp.items()},
                                 device="cpu")


@pytest.fixture(scope="module")
def reference(params):
    _jp, tp = params
    ids, lens = _prompts()
    ref, _ = tlm.greedy_decode_recompute(TSPEC, tp, ids, lens, MAX_NEW, EOS)
    return ref


def _prompts(b=3, t0=11, seed=0):
    rng = np.random.default_rng(seed)
    ids = rng.integers(2, JSPEC.vocab, (b, t0)).astype(np.int32)
    lens = np.asarray([t0, t0 - 3, t0 - 5], np.int32)[:b]
    return ids, lens


def _through_eos(row):
    row = [int(x) for x in row]
    return row[:row.index(EOS) + 1] if EOS in row else row


def _tplm(tp, num_pages=64):
    cache = tkv.PagedKVCache(TSPEC, num_pages=num_pages, page_size=4,
                             max_pages_per_seq=16, device="cpu")
    return tkv.PagedLM(TSPEC, tp, cache, eos_id=EOS)


def test_continuous_batching_matches_reference(params, reference):
    """Fewer slots than requests: admissions ride between decode steps
    and every request gets the reference output through its eos."""
    _jp, tp = params
    ids, lens = _prompts()
    eng = LMEngine(_tplm(tp), slots=2, max_new=MAX_NEW)
    rids = [eng.submit(ids[i, :lens[i]]) for i in range(3)]
    eng.run()
    assert EOS in reference[2]   # the eos convention is exercised
    for i, rid in enumerate(rids):
        res = eng.result(rid)
        assert res["finished"]
        assert res["tokens"] == _through_eos(reference[i])
    assert eng.prefill_dispatches == 3
    assert eng.cache.free_page_count() == eng.cache.num_pages - 1


def test_pool_exhaustion_auto_evicts_and_matches_jax_engine(params,
                                                            reference):
    """A pool too small for all requests at once still converges:
    admission evicts the cheapest live request, which re-enters later
    byte-identical — and the port's engine makes the same decisions as
    the JAX engine on the same pool."""
    jp, tp = params
    ids, lens = _prompts()
    plm = _tplm(tp, num_pages=9)
    eng = LMEngine(plm, slots=3, max_new=MAX_NEW)
    rids = [eng.submit(ids[i, :lens[i]]) for i in range(3)]
    eng.run()
    assert plm.cache.evictions > 0 and eng.reprefilled_tokens > 0
    jcache = jkv.PagedKVCache(JSPEC, num_pages=9, page_size=4,
                              max_pages_per_seq=16)
    jengine = jeng.LMEngine(jkv.PagedLM(JSPEC, jp, jcache, eos_id=EOS),
                            slots=3, max_new=MAX_NEW)
    jrids = [jengine.submit(ids[i, :lens[i]]) for i in range(3)]
    jengine.run()
    for i, rid in enumerate(rids):
        got = eng.result(rid)["tokens"]
        assert got == _through_eos(reference[i])
        assert got == [int(x) for x in jengine.result(jrids[i])["tokens"]]
    assert plm.cache.evictions == jcache.evictions
    assert eng.reprefilled_tokens == jengine.reprefilled_tokens


def test_evict_readmit_byte_identical(params):
    """A request evicted mid-generation (pages freed) and readmitted
    later resumes byte-identically: re-prefilling prompt+emitted
    re-derives the evicted pool state."""
    _jp, tp = params
    ids, lens = _prompts(b=1)
    max_new = 12
    ref = LMEngine(_tplm(tp), slots=1, max_new=max_new)
    r0 = ref.submit(ids[0, :lens[0]])
    ref.run()
    want = ref.result(r0)

    plm = _tplm(tp)
    eng = LMEngine(plm, slots=1, max_new=max_new)
    r1 = eng.submit(ids[0, :lens[0]])
    for _ in range(4):
        eng.step()
    free_before = plm.cache.free_page_count()
    eng.evict(r1, requeue=False)
    assert plm.cache.free_page_count() > free_before
    assert eng.step() == 0   # nothing live while parked
    eng.readmit(r1)
    eng.run()
    got = eng.result(r1)
    assert got["tokens"] == want["tokens"]
    assert got["score"] == pytest.approx(want["score"], rel=1e-4)
    assert got["prefills"] == 2 and want["prefills"] == 1
    assert plm.cache.evictions == 1
    assert 0.0 < eng.cache_hit_frac < 1.0
    assert eng.prefix_recompute_bytes_saved > 0


def test_serving_model_contract(params):
    """PagedLMModel packs batch rows through the engine and returns
    the run_batch row dicts the server expects (trailing eos cut)."""
    _jp, tp = params
    ids, lens = _prompts()
    model = PagedLMModel(_tplm(tp), slots=2, max_new=6)
    rows = model.run_batch(ids, lens, None, host=False)
    ref_t, _ = tlm.greedy_decode_recompute(TSPEC, tp, ids, lens, 6, EOS)
    assert len(rows) == 3
    for i, row in enumerate(rows):
        assert row["path"] == "paged"
        want = _through_eos(ref_t[i])
        if want and want[-1] == EOS:
            want = want[:-1]
        assert row["tokens"] == want
    assert model.recompile_guards == ()
    assert model.tokens_per_dispatch == 1
