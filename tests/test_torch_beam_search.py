"""The port's beam search, its host-stepped rung and its serving model
against the JAX package's, on the CPU.

Both decoders are built from one description (`paddle_tpu.dsl` and the
port's copy) and run on the same numpy parameters. The step nets are the
JAX tests' (`tests/test_beam_search.py`, `tests/test_decoding.py`): a
bigram table (embedding -> mixed identity -> softmax), an encoder
summary with a state memory, `simple_attention` with `static_sizes`,
and the attention NMT's decoder (`seq2seq_attention_decoder`).

- Tokens: every beam's sequence and length equal to the JAX decoder's
  (exact here, which the serving rule — equal unless the reference's
  top-2 margin at the first differing step is below 1e-4 — allows), the
  scores within atol 1e-5.
- K-token dispatch: K in {2, 4, 5, 8, 32} `torch.equal` to K = 1 (seqs,
  lens, scores); `last_steps` and `last_chain_depth` equal to the JAX
  decoder's own readings at the same K (on the peaked table JAX reads 6
  steps, where `test_decoding.py::test_early_finish_mid_chunk` asserts
  5: the port is held to the measurement).
- Hooks (adjust, drop, stop) called at the JAX decoder's `t` values,
  with the same outputs, at K = 1 and 4.
- Ties: on the peaked table every empty beam ties at NEG_INF + logp at
  t = 0; `_top_k_stable` puts the lower flat index first, as
  `lax.top_k`, so all K beams equal JAX's.
- The host rung (`serving/host_decode.py`) per token and chunked, the
  decode-graph runner with CUDA capture swapped for eager replays, and
  `GenerationModel` behind `InferenceServer` and TCP with the
  `decode.token` / `decode.chunk` spans under the dispatch span.
- On the card (`TestOnCard`, marked cuda): CUDA-graph replays at K in
  {1, 4, 5, 32} `torch.equal` to eager decoding, one graph per (batch,
  signature) reused across calls, the host rung chunked equal and per
  token with the same tokens, and a capture that fails raising.
"""

import threading
import time

import numpy as np
import pytest
import torch

try:
    import jax
    import jax.numpy as jnp

    from paddle_tpu import dsl as jdsl
    from paddle_tpu.beam_search import BeamHooks as JHooks
    from paddle_tpu.beam_search import BeamSearchDecoder as JDec
    from paddle_tpu.core import arg as jarg
    from paddle_tpu.core.config import ParameterConf as JPC
    from paddle_tpu.models import text as jtext
    from paddle_tpu.network import Network as JNetwork
    from paddle_tpu.serving.host_decode import host_generate as \
        jhost_generate
except ImportError:  # the card's machine has no JAX: TestOnCard runs there
    jax = jdsl = JPC = JDec = JHooks = None
from paddle_tpu_torch import beam_search as tbs
from paddle_tpu_torch import dsl as tdsl
from paddle_tpu_torch.beam_search import BeamHooks as THooks
from paddle_tpu_torch.beam_search import BeamSearchDecoder as TDec
from paddle_tpu_torch.core import arg as targ
from paddle_tpu_torch.core.config import ParameterConf as TPC
from paddle_tpu_torch.models import text as ttext
from paddle_tpu_torch.network import Network as TNetwork
from paddle_tpu_torch.obs import metrics as tmetrics
from paddle_tpu_torch.obs import tracing as ttracing
from paddle_tpu_torch.serving import host_decode as thd
from paddle_tpu_torch.serving.models import GenerationModel
from paddle_tpu_torch.serving.server import InferenceServer, ServeConfig
from paddle_tpu_torch.serving.tcp import ServeClient, ServingTCPServer
from paddle_tpu_torch.weights import params_from_numpy

V, EOS, BOS = 10, 1, 0
SCORE_ATOL = 1e-5
PKG = {"jax": (jdsl, JPC, JDec, JHooks), "torch": (tdsl, TPC, TDec, THooks)}


def _bigram_dec(pkg, pname, vocab=V, beam=4, max_len=13, k_tok=1,
                hooks=None, logprob_fn=None):
    dsl, pc, dec_cls, _ = PKG[pkg]

    def step(word):
        emb = dsl.embedding(word, size=vocab, vocab_size=vocab,
                            param=pc(name=pname))
        return dsl.mixed(vocab, [(emb, "identity")], act="softmax",
                         bias=False, name="prob")

    return dec_cls(step, n_static=0, bos_id=BOS, eos_id=EOS,
                   beam_size=beam, max_length=max_len, hooks=hooks,
                   logprob_fn=logprob_fn, tokens_per_dispatch=k_tok)


def _rand_table(seed, scale=3.0, vocab=V):
    rng = np.random.default_rng(seed)
    return (rng.normal(size=(vocab, vocab)) * scale).astype(np.float32)


def _peaked_table(vocab=V):
    """Sharply peaked chain 0->2->3->eos."""
    t = np.full((vocab, vocab), -5.0, np.float32)
    t[0, 2] = t[2, 3] = t[3, EOS] = 5.0
    return t


def _gen(dec, table, pname, b=3):
    if isinstance(dec, TDec):
        out = dec.generate({pname: torch.from_numpy(table)}, [],
                           batch_size=b)
        return tuple(x.numpy() for x in out)
    out = dec.generate({pname: jnp.asarray(table)}, [], batch_size=b)
    return tuple(np.asarray(x) for x in out)


def _same_tokens(got, ref):
    """Every beam's tokens and length equal, scores within atol."""
    np.testing.assert_array_equal(got[0], ref[0])
    np.testing.assert_array_equal(got[1], ref[1])
    np.testing.assert_allclose(got[2], ref[2], rtol=0, atol=SCORE_ATOL)


def _equal(got, ref):
    for g, r in zip(got, ref):
        assert g.dtype == r.dtype and np.array_equal(g, r)


# ---- the JAX beam tests' cases -------------------------------------------

def test_beam_finds_best_bigram_path():
    table = np.full((5, 5), -5.0, np.float32)
    table[0, 2] = table[2, 3] = table[3, EOS] = 5.0
    ref = _gen(_bigram_dec("jax", "bigram", 5, max_len=6), table, "bigram",
               b=2)
    got = _gen(_bigram_dec("torch", "bigram", 5, max_len=6), table,
               "bigram", b=2)
    _same_tokens(got, ref)
    assert got[1][0, 0] == 3 and got[0][0, 0, :3].tolist() == [2, 3, EOS]
    assert got[0].dtype == np.int32 and got[1].dtype == np.int32
    assert np.all(np.diff(got[2], axis=1) <= 1e-6)


def test_decode_program_not_stale_after_config_mutation():
    table = np.zeros((5, 5), np.float32)
    table[:, EOS] = -50.0
    dec = _bigram_dec("torch", "bigram_cfg", 5, max_len=6)
    assert _gen(dec, table, "bigram_cfg", b=1)[0].shape[2] == 6
    dec.max_length = 3
    seqs, lens, _ = _gen(dec, table, "bigram_cfg", b=1)
    assert seqs.shape[2] == 3 and lens.max() <= 3
    dec.k = 2
    assert _gen(dec, table, "bigram_cfg", b=1)[0].shape[1] == 2
    # the cache stays bounded under fresh hook lambdas a call
    for i in range(10):
        dec.hooks = THooks(adjust=lambda lp, t, i=i: lp)
        _gen(dec, table, "bigram_cfg", b=1)
    assert len(dec._decode_cache) == tbs.CACHE_ENTRIES


def _enc_step(pkg, h=6, v=8, e=4):
    dsl, pc, _, _ = PKG[pkg]

    def step(word, enc_sum):
        emb = dsl.embedding(word, size=e, vocab_size=v,
                            param=pc(name="trg_emb"))
        prev = dsl.memory("s", size=h)
        s = dsl.fc(emb, prev, enc_sum, size=h, act="tanh", name="s")
        return dsl.fc(s, size=v, act="softmax", name="prob")

    return step


def test_beam_with_decoder_state_and_encoder():
    h = 6
    rng = np.random.default_rng(0)
    enc = rng.standard_normal((2, h)).astype(np.float32)
    boot = rng.standard_normal((2, h)).astype(np.float32)
    jd = JDec(_enc_step("jax"), n_static=1, bos_id=0, eos_id=1,
              beam_size=3, max_length=5)
    td = TDec(_enc_step("torch"), n_static=1, bos_id=0, eos_id=1,
              beam_size=3, max_length=5)
    jenc = jarg.non_seq(jnp.asarray(enc))
    p = {k: np.asarray(v) for k, v in
         jd._build([jenc]).init_params(jax.random.key(0)).items()}
    tenc = targ.non_seq(enc)
    assert {k: tuple(c.dims) for k, c in td.param_confs([tenc]).items()} \
        == {k: tuple(c.dims) for k, c in jd.param_confs([jenc]).items()}
    ref = [np.asarray(x) for x in jd.generate(
        {k: jnp.asarray(v) for k, v in p.items()}, statics=[jenc],
        boots={"s": jnp.asarray(boot)})]
    tp = params_from_numpy(p, device="cpu")
    got = [x.numpy() for x in td.generate(tp, statics=[tenc],
                                          boots={"s": torch.tensor(boot)})]
    assert got[0].shape == (2, 3, 5) and np.isfinite(got[2]).all()
    _same_tokens(got, ref)
    again = [x.numpy() for x in td.generate(tp, statics=[tenc],
                                            boots={"s": torch.tensor(boot)})]
    _equal(again, got)
    assert td.last_steps == jd.last_steps


def test_boot_layer_memory_without_boots_raises():
    def step(word):
        prev = tdsl.memory("s", size=3, boot_layer=tdsl.LayerRef(
            "enc_last", tdsl.current()))
        emb = tdsl.embedding(word, size=3, vocab_size=5)
        s = tdsl.fc(emb, prev, size=3, name="s")
        return tdsl.fc(s, size=5, act="softmax", name="prob")

    dec = TDec(step, n_static=0, bos_id=0, eos_id=1, beam_size=2,
               max_length=3)
    with pytest.raises(ValueError, match="boot_layer"):
        dec.prepare([], batch_size=2, device="cpu")


def test_beam_logprob_hook():
    banned = 2
    table = np.full((5, 5), -5.0, np.float32)
    table[0, banned] = 5.0
    table[0, 3] = 2.0
    table[3, EOS] = 5.0

    def jban(logp, t):
        return logp.at[..., banned].set(-1e30)

    def tban(logp, t):
        logp = logp.clone()
        logp[..., banned] = -1e30
        return logp

    jd = _bigram_dec("jax", "bigram2", 5, max_len=6, logprob_fn=jban)
    td = _bigram_dec("torch", "bigram2", 5, max_len=6, logprob_fn=tban)
    ref, got = _gen(jd, table, "bigram2", b=1), _gen(td, table, "bigram2",
                                                     b=1)
    _same_tokens(got, ref)
    assert got[0][0, 0, :got[1][0, 0]].tolist() == [3, EOS]
    # the host rung calls the same torch function on the host's logp
    hs = thd.host_generate(td, {"bigram2": torch.from_numpy(table)},
                           batch_size=1)
    _same_tokens(hs, ref)


def test_decoder_static_sizes_enable_simple_attention():
    hid, vocab, b, t = 8, 12, 2, 4

    def mk(pkg):
        dsl, _, dec_cls, _ = PKG[pkg]

        def step(word, enc_s, enc_p):
            emb = dsl.embedding(word, size=4, vocab_size=vocab)
            prev = dsl.memory("s", size=hid)
            ctxv = dsl.simple_attention(enc_s, enc_p, prev, name="att")
            s = dsl.fc(emb, prev, ctxv, size=hid, act="tanh", name="s")
            return dsl.fc(s, size=vocab, act="softmax", name="prob")

        return dec_cls(step, n_static=2, bos_id=0, eos_id=1, beam_size=2,
                       max_length=5, static_sizes=[hid, hid])

    rng = np.random.default_rng(0)
    encv = rng.standard_normal((b, t, hid)).astype(np.float32)
    lens = np.asarray([t, 2], np.int32)
    jenc = jarg.seq(jnp.asarray(encv), jnp.asarray(lens))
    tenc = targ.seq(encv, lens)
    jd, td = mk("jax"), mk("torch")
    confs = jd.param_confs([jenc, jenc])
    assert sorted(td.param_confs([tenc, tenc])) == sorted(confs)
    p = {n: (rng.standard_normal(c.dims) * 0.1).astype(np.float32)
         for n, c in confs.items()}
    ref = [np.asarray(x) for x in jd.generate(
        {k: jnp.asarray(v) for k, v in p.items()}, [jenc, jenc])]
    got = [x.numpy() for x in td.generate(params_from_numpy(p, device="cpu"),
                                          [tenc, tenc])]
    assert got[0].shape == (b, 2, 5)
    _same_tokens(got, ref)


# ---- hooks ----------------------------------------------------------------

def _chains_table():
    # two competitive chains: 0->2->3->eos and 0->4->3->eos
    t = np.full((5, 5), -4.0, np.float32)
    t[0, 2], t[0, 4] = 3.0, 2.5
    t[2, 3] = t[4, 3] = t[3, EOS] = 3.0
    return t


def _recording_hooks(pkg, calls, adjust=True, drop=True, stop=True):
    def a(logp, t):
        calls.setdefault("adjust", []).append(int(t))
        out = np.array(logp, copy=True)
        out[:, :, 4] = -1e30
        return out

    def d(words, scores, t):
        calls.setdefault("drop", []).append(int(t))
        return scores, words == 5

    def s(finished, scores, t):
        calls.setdefault("stop", []).append(int(t))
        return t >= 6

    return PKG[pkg][3](adjust=a if adjust else None,
                       drop=d if drop else None, stop=s if stop else None)


@pytest.mark.parametrize("which", ["adjust", "drop", "stop", "all"])
@pytest.mark.parametrize("k_tok", [1, 4])
def test_hooks_match_jax_outputs_and_call_pattern(which, k_tok):
    """Each hook alone and all three, at K = 1 and 4: the outputs of the
    JAX decoder, and the hooks called at its `t` values; K = 4 equal to
    K = 1 bit for bit, with the JAX chain depth."""
    on = {h: which in (h, "all") for h in ("adjust", "drop", "stop")}
    table = _rand_table(11)
    jcalls, tcalls, t1calls = {}, {}, {}
    jd = _bigram_dec("jax", "bg_h", k_tok=k_tok,
                     hooks=_recording_hooks("jax", jcalls, **on))
    td = _bigram_dec("torch", "bg_h", k_tok=k_tok,
                     hooks=_recording_hooks("torch", tcalls, **on))
    t1 = _bigram_dec("torch", "bg_h",
                     hooks=_recording_hooks("torch", t1calls, **on))
    ref = _gen(jd, table, "bg_h")
    got = _gen(td, table, "bg_h")
    _same_tokens(got, ref)
    assert tcalls == jcalls and tcalls
    _equal(got, _gen(t1, table, "bg_h"))
    assert (td.last_steps, td.last_chain_depth) == (jd.last_steps,
                                                    jd.last_chain_depth)
    if on["adjust"]:
        assert not (got[0] == 4).any()


def test_jax_hook_tests_cases():
    """tests/test_beam_search.py::TestHostHooks on the port: the adjust
    hook reroutes the beam around token 2, the drop hook kills the 4
    chain, the stop hook ends at t = 1, and an early finish leaves eos
    behind."""
    table = _chains_table()

    def forbid2(logp, t):
        logp = logp.copy()
        logp[:, :, 2] = -1e30
        return logp

    def run(pkg, hooks, max_len=6, beam=3, tab=table):
        dec = _bigram_dec(pkg, "bg_hooks", 5, beam=beam, max_len=max_len,
                          hooks=hooks)
        return _gen(dec, tab, "bg_hooks", b=1), dec

    for hooks in ({"adjust": forbid2},
                  {"drop": lambda w, s, t: (s, w == 4)}):
        ref, _ = run("jax", JHooks(**hooks))
        got, _ = run("torch", THooks(**hooks))
        _same_tokens(got, ref)
    got, _ = run("torch", THooks(adjust=forbid2))
    assert got[0][0, 0, :3].tolist() == [4, 3, EOS] and 2 not in got[0][0]
    got, _ = run("torch", THooks(drop=lambda w, s, t: (s, w == 4)))
    assert got[0][0, 0, :3].tolist() == [2, 3, EOS]
    for kk in range(got[0].shape[1]):
        if 4 in got[0][0, kk, :got[1][0, kk]]:
            assert got[2][0, kk] <= -1e29
    seen = []
    run("torch", THooks(stop=lambda f, s, t: seen.append(t) or t >= 1))
    assert seen == [0, 1]
    peaked = np.full((5, 5), -8.0, np.float32)
    peaked[0, 2] = peaked[2, 3] = peaked[3, EOS] = 8.0
    got, dec = run("torch", None, max_len=50, beam=2, tab=peaked)
    assert got[0][0, 0, :3].tolist() == [2, 3, EOS] and got[1][0, 0] == 3
    assert (got[0][0, 0, 3:] == EOS).all() and dec.last_steps < 50


# ---- multi-token dispatch ---------------------------------------------------

def _no_eos(seed):
    table = _rand_table(seed)
    table[:, EOS] = -50.0  # no eos: a full-length walk
    return table


@pytest.mark.parametrize("table_name", ["no_eos", "random", "peaked"])
def test_beam_bit_identical_across_k(table_name):
    table = {"no_eos": lambda: _no_eos(0), "random": lambda: _rand_table(2),
             "peaked": _peaked_table}[table_name]()
    td1 = _bigram_dec("torch", "bg")
    ref = _gen(td1, table, "bg")
    jd1 = _bigram_dec("jax", "bg")
    _same_tokens(ref, _gen(jd1, table, "bg"))
    assert (td1.last_steps, td1.last_chain_depth) == (
        jd1.last_steps, jd1.last_chain_depth)
    for k_tok in (2, 4, 5, 8, 32):
        td = _bigram_dec("torch", "bg", k_tok=k_tok)
        jd = _bigram_dec("jax", "bg", k_tok=k_tok)
        _equal(_gen(td, table, "bg"), ref)
        _gen(jd, table, "bg")
        assert td.last_steps == jd.last_steps == td1.last_steps, k_tok
        assert td.last_chain_depth == jd.last_chain_depth, k_tok
        assert td.last_chain_depth == -(-td.last_steps // k_tok)


def test_early_finish_mid_chunk_reads_what_jax_measures():
    """The peaked chain ends every beam early: the port's readings equal
    the JAX decoder's (6 steps at K = 1 and K = 8; chain depth 6 and
    1), not the 5 that the red JAX test asserts."""
    table = _peaked_table()
    readings = {}
    for pkg in ("jax", "torch"):
        for k_tok in (1, 8):
            dec = _bigram_dec(pkg, "bg_p", k_tok=k_tok)
            out = _gen(dec, table, "bg_p")
            readings[pkg, k_tok] = (dec.last_steps, dec.last_chain_depth)
            if pkg == "torch":
                _equal(out, readings.setdefault("out", out))
    assert readings["torch", 1] == readings["jax", 1] == (6, 6)
    assert readings["torch", 8] == readings["jax", 8] == (6, 1)


def test_greedy_token_for_token():
    table = _rand_table(3)
    ref = _gen(_bigram_dec("torch", "bg_g", beam=1), table, "bg_g")
    _same_tokens(ref, _gen(_bigram_dec("jax", "bg_g", beam=1), table,
                           "bg_g"))
    for k_tok in (3, 4, 16):
        _equal(_gen(_bigram_dec("torch", "bg_g", beam=1, k_tok=k_tok),
                    table, "bg_g"), ref)


def test_program_cache_keyed_on_k():
    table = _no_eos(0)
    dec = _bigram_dec("torch", "bg")
    ref = _gen(dec, table, "bg")
    assert dec.last_chain_depth == 13
    dec.tokens_per_dispatch = 4
    _equal(_gen(dec, table, "bg"), ref)
    assert dec.last_chain_depth == 4 and len(dec._decode_cache) == 2


def test_peaked_table_ties_order_by_index_like_lax_top_k():
    """At t = 0 the K-1 empty beams score NEG_INF + logp (-1e30 in f32
    for every word): all K beams, their parents' order included, equal
    the JAX decoder's."""
    table = _peaked_table()
    for beam in (2, 4, 6):
        ref = _gen(_bigram_dec("jax", "bg_t", beam=beam), table, "bg_t")
        got = _gen(_bigram_dec("torch", "bg_t", beam=beam), table, "bg_t")
        _same_tokens(got, ref)
        np.testing.assert_array_equal(got[2], ref[2])


def test_top_k_stable_orders_ties_by_index():
    rng = np.random.default_rng(0)
    flat = rng.integers(-3, 3, (5, 40)).astype(np.float32)
    flat[0, :] = -1e30
    flat[1, 5], flat[1, 7] = -0.0, 0.0
    flat[2, :4] = [np.inf, -np.inf, 1e30, -1e-30]
    vals, idx = tbs._top_k_stable(torch.from_numpy(flat), 6)
    jv, ji = jax.lax.top_k(jnp.asarray(flat), 6)
    nv, ni = thd._top_k_stable(flat, 6)
    np.testing.assert_array_equal(idx.numpy(), np.asarray(ji))
    np.testing.assert_array_equal(idx.numpy(), ni)
    np.testing.assert_array_equal(vals.numpy(), nv)


def test_seq2seq_attention_decoder_matches_jax():
    """The conditioned NMT decoder (statics, a boot memory, attention)
    from the trained conf's parameters: tokens equal to the JAX
    decoder's at K in {1, 4} with a ragged tail (max_len 10), K = 4
    equal to K = 1 bit for bit, and JAX's readings."""
    vocab, emb, hidden = 32, 8, 8
    jconf = jtext.seq2seq_attention(src_vocab=vocab, trg_vocab=vocab,
                                    emb_dim=emb, hidden=hidden)
    jnet = JNetwork(jconf)
    p = {k: np.asarray(v) for k, v in
         jnet.init_params(jax.random.key(0)).items()}
    src = np.asarray([[2, 3, 4, 5, 6], [6, 7, 8, 9, 0]], np.int32)
    lens = np.asarray([5, 3], np.int32)
    jo, _ = jnet.forward({k: jnp.asarray(v) for k, v in p.items()},
                         {"src": jarg.id_arg(src, lens)},
                         outputs=["enc", "dec_boot"])
    tnet = TNetwork(ttext.seq2seq_attention(src_vocab=vocab,
                                            trg_vocab=vocab, emb_dim=emb,
                                            hidden=hidden))
    tp = params_from_numpy(p, device="cpu")
    with torch.no_grad():
        to, _ = tnet.forward(tp, {"src": targ.id_arg(src, lens)},
                             outputs=["enc", "dec_boot"])
    kw = dict(trg_vocab=vocab, emb_dim=emb, hidden=hidden, bos_id=BOS,
              eos_id=EOS, beam_size=4, max_length=10)
    outs = {}
    for k_tok in (1, 4):
        jd = jtext.seq2seq_attention_decoder(tokens_per_dispatch=k_tok, **kw)
        td = ttext.seq2seq_attention_decoder(tokens_per_dispatch=k_tok, **kw)
        assert sorted(td.param_confs([to["enc"]])) == sorted(
            jd.param_confs([jo["enc"]]))
        ref = [np.asarray(x) for x in jd.generate(
            {k: jnp.asarray(v) for k, v in p.items()}, statics=[jo["enc"]],
            boots={"dec_state": jo["dec_boot"].value})]
        outs[k_tok] = got = [x.numpy() for x in td.generate(
            tp, statics=[to["enc"]],
            boots={"dec_state": to["dec_boot"].value})]
        _same_tokens(got, ref)
        assert (td.last_steps, td.last_chain_depth) == (
            jd.last_steps, jd.last_chain_depth)
    _equal(outs[4], outs[1])


def test_decoder_refuses_the_cpu_unless_asked(monkeypatch):
    """With nothing to take a device from (no statics, no boots), the
    decoder's feed goes to the card, and raises without one; the
    parameters' device decides for generate() and the host rung."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    dec = _bigram_dec("torch", "bg")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        dec.prepare([], batch_size=2)
    feed, mems, b = dec.prepare([], batch_size=2, device="cpu")
    assert feed == {} and mems == {} and b == 2
    table = torch.from_numpy(_no_eos(0))
    assert dec.generate({"bg": table}, [], batch_size=2)[0].device.type \
        == "cpu"
    assert thd.host_generate(dec, {"bg": table}, batch_size=2)[0].shape \
        == (2, 4, 13)


# ---- the host rung ---------------------------------------------------------

class TestHostRung:
    def test_per_token_and_chunked_match_jax(self):
        table = _no_eos(5)
        params = {"bg_c": torch.from_numpy(table)}
        ref = _gen(_bigram_dec("torch", "bg_c"), table, "bg_c")
        for k_tok, depth in ((1, 13), (5, 3)):
            td = _bigram_dec("torch", "bg_c", k_tok=k_tok)
            jd = _bigram_dec("jax", "bg_c", k_tok=k_tok)
            got = thd.host_generate(td, params, batch_size=3)
            jref = jhost_generate(jd, {"bg_c": jnp.asarray(table)},
                                  batch_size=3)
            _same_tokens(got, [np.asarray(x) for x in jref])
            _same_tokens(got, ref)
            assert td.last_chain_depth == jd.last_chain_depth == depth
            assert td.last_steps == jd.last_steps == 13

    def test_chunked_early_finish_stops_dispatching(self):
        table = _peaked_table()
        params = {"bg_cp": torch.from_numpy(table)}
        ref = _gen(_bigram_dec("torch", "bg_cp"), table, "bg_cp")
        td = _bigram_dec("torch", "bg_cp", k_tok=3)
        jd = _bigram_dec("jax", "bg_cp", k_tok=3)
        got = thd.host_generate(td, params, batch_size=3)
        jhost_generate(jd, {"bg_cp": jnp.asarray(table)}, batch_size=3)
        _same_tokens(got, ref)
        assert td.last_chain_depth == jd.last_chain_depth == 2
        assert td.last_steps == jd.last_steps

    def test_empty_hooks_object_still_chunks(self):
        table = _no_eos(5)
        ref = _gen(_bigram_dec("torch", "bg_c"), table, "bg_c")
        td = _bigram_dec("torch", "bg_c", k_tok=5)
        got = thd.host_generate(td, {"bg_c": torch.from_numpy(table)},
                                batch_size=3, hooks=THooks())
        np.testing.assert_array_equal(got[0], ref[0])
        assert td.last_chain_depth == 3

    def test_hooks_force_per_token_with_the_device_rungs_pattern(self):
        table = _rand_table(11)
        dcalls, hcalls, jcalls = {}, {}, {}
        dev = _bigram_dec("torch", "bg_hh", k_tok=4,
                          hooks=_recording_hooks("torch", dcalls))
        ref = _gen(dev, table, "bg_hh")
        host = _bigram_dec("torch", "bg_hh", k_tok=4)
        got = thd.host_generate(host, {"bg_hh": torch.from_numpy(table)},
                                batch_size=3,
                                hooks=_recording_hooks("torch", hcalls))
        jd = _bigram_dec("jax", "bg_hh", k_tok=4)
        jhost_generate(jd, {"bg_hh": jnp.asarray(table)}, batch_size=3,
                       hooks=_recording_hooks("jax", jcalls))
        _same_tokens(got, ref)
        assert hcalls == dcalls == jcalls
        assert host.last_chain_depth == dev.last_steps == jd.last_steps

    def test_encoder_decoder_on_the_host_rung(self):
        h = 6
        rng = np.random.default_rng(1)
        enc = targ.non_seq(rng.standard_normal((2, h)).astype(np.float32))
        boot = torch.tensor(rng.standard_normal((2, h)).astype(np.float32))
        td = TDec(_enc_step("torch"), n_static=1, bos_id=0, eos_id=1,
                  beam_size=3, max_length=5, tokens_per_dispatch=2)
        tp = td._build([enc]).init_params(torch.Generator().manual_seed(0),
                                          device="cpu")
        ref = [x.numpy() for x in td.generate(tp, [enc], {"s": boot})]
        for k_tok in (1, 2):
            got = thd.host_generate(td, tp, [enc], {"s": boot},
                                    tokens_per_dispatch=k_tok)
            _same_tokens(got, ref)


# ---- the decode graphs, with the capture replaced by eager replays --------

def test_decode_graphs_with_eager_replays(monkeypatch):
    """`_DecodeGraph`'s bookkeeping with CUDA capture swapped for eager
    execution of the captured chunk (a CPU has no graphs): static
    parameters, feed and carry, reset at each start, one graph per
    (batch, signature), each replay one chunk, equal bit for bit to
    eager decoding, new parameter values read at the next start."""
    monkeypatch.setattr(tbs.torch.cuda, "graph_pool_handle", lambda: None)
    monkeypatch.setattr(tbs.torch.cuda, "Stream", lambda device: None)
    monkeypatch.setattr(tbs.torch.cuda, "CUDAGraph", lambda: None)
    captures = []
    monkeypatch.setattr(tbs._DecodeGraph, "capture",
                        lambda self: captures.append(self) or setattr(
                            self, "captured", True))
    monkeypatch.setattr(tbs._DecodeGraph, "replay",
                        lambda self: self._chunk(write_back=True))
    # the CUDA-device condition dropped: graphs wherever use_graphs
    monkeypatch.setattr(tbs._DecodeProgram, "_graphed",
                        lambda self, dev: self.dec.use_graphs)
    h = 6
    rng = np.random.default_rng(2)
    dec = TDec(_enc_step("torch"), n_static=1, bos_id=0, eos_id=1,
               beam_size=3, max_length=7, tokens_per_dispatch=3)
    ref_dec = TDec(_enc_step("torch"), n_static=1, bos_id=0, eos_id=1,
                   beam_size=3, max_length=7, tokens_per_dispatch=3)
    ref_dec.use_graphs = False
    enc2 = targ.non_seq(rng.standard_normal((2, h)).astype(np.float32))
    p = dec._build([enc2]).init_params(torch.Generator().manual_seed(0),
                                       device="cpu")
    for b in (2, 2, 4, 2):
        enc = targ.non_seq(rng.standard_normal((b, h)).astype(np.float32))
        boot = {"s": torch.tensor(rng.standard_normal((b, h)).astype(
            np.float32))}
        got = dec.generate(p, [enc], boot)
        want = ref_dec.generate(p, [enc], boot)
        for g, w in zip(got, want):
            assert torch.equal(g, w)
        assert (dec.last_steps, dec.last_chain_depth) == (
            ref_dec.last_steps, ref_dec.last_chain_depth)
    prog = next(iter(dec._decode_cache.values()))
    assert len(prog.graphs) == 2 and len(captures) == 2
    assert set(dec._graph_params) == set(dec._net.param_confs)
    p2 = {k: v * 1.5 for k, v in p.items()}
    got = dec.generate(p2, [enc], boot)
    for g, w in zip(got, ref_dec.generate(p2, [enc], boot)):
        assert torch.equal(g, w)
    assert len(captures) == 2


def test_captures_run_with_the_garbage_collector_off(monkeypatch):
    """Both graph runners capture after a collection and with the cyclic
    collector off (a CUDA graph freed by a collection mid-capture ends
    the capture in error; on the card an unreachable trainer's graph
    did so), and turn it back on after a failed capture, which raises."""
    import contextlib
    import gc

    from paddle_tpu_torch.parallel import graph as tgraph

    class _Stream:
        def wait_stream(self, other):
            pass

    seen = []
    collected = []
    real_collect = gc.collect
    monkeypatch.setattr(tgraph.gc, "collect",
                        lambda: collected.append(1) or real_collect())

    @contextlib.contextmanager
    def fake_graph(graph, pool=None, stream=None):
        seen.append(gc.isenabled())
        yield

    monkeypatch.setattr(torch.cuda, "graph", fake_graph)
    monkeypatch.setattr(torch.cuda, "stream",
                        lambda s: contextlib.nullcontext())
    monkeypatch.setattr(torch.cuda, "current_stream", lambda: _Stream())
    monkeypatch.setattr(torch.cuda, "graph_pool_handle", lambda: None)
    monkeypatch.setattr(torch.cuda, "Stream", lambda device: _Stream())
    monkeypatch.setattr(torch.cuda, "CUDAGraph", lambda: None)
    monkeypatch.setattr(tbs._DecodeProgram, "_graphed",
                        lambda self, dev: True)
    monkeypatch.setattr(tbs._DecodeGraph, "replay",
                        lambda self: self._chunk(write_back=True))
    assert gc.isenabled()
    dec = _bigram_dec("torch", "bg", k_tok=4)
    table = {"bg": torch.from_numpy(_no_eos(0))}
    dec.generate(table, [], batch_size=2)
    assert seen == [False] and collected and gc.isenabled()

    def broken(logp, t):
        # fails inside the capture only (the warm-up runs before it)
        if not gc.isenabled():
            raise ValueError("no")
        return logp

    dec.logprob_fn = broken
    with pytest.raises(RuntimeError, match="CUDA graph failed"):
        dec.generate(table, [], batch_size=2)
    assert seen == [False, False] and gc.isenabled()
    with tgraph.no_gc():
        assert not gc.isenabled()
    assert gc.isenabled()


# ---- serving ---------------------------------------------------------------

def _bigram_model(vocab=6, beam=3, max_len=6, seed=0, named_hooks=None,
                  k_tok=1, pname="srv_bigram"):
    rng = np.random.default_rng(seed)
    table = (rng.standard_normal((vocab, vocab)) * 2).astype(np.float32)
    dec = _bigram_dec("torch", pname, vocab, beam=beam, max_len=max_len,
                      k_tok=k_tok)
    params = {pname: torch.from_numpy(table)}
    return dec, table, GenerationModel(dec, params,
                                       named_hooks=named_hooks)


def test_generation_model_rows_and_paths():
    seen = []

    def forbid3(logp, t):
        seen.append(t)
        logp = logp.copy()
        logp[:, :, 3] = -1e30
        return logp

    dec, table, model = _bigram_model(named_hooks={
        "no3": THooks(adjust=forbid3)})
    jd = _bigram_dec("jax", "srv_bigram", 6, beam=3, max_len=6)
    ref = _gen(jd, table, "srv_bigram", b=2)
    ids = np.zeros((2, 4), np.int32)
    rows = model.run_batch(ids, np.asarray([4, 2], np.int32), None, False)
    for i, r in enumerate(rows):
        assert r["path"] == "jit"
        assert r["tokens"] == ref[0][i, 0, :ref[1][i, 0]].tolist()
        assert abs(r["score"] - float(ref[2][i, 0])) <= SCORE_ATOL
    host = model.run_batch(ids, np.asarray([4, 2], np.int32), None, True)
    assert [r["tokens"] for r in host] == [r["tokens"] for r in rows]
    assert all(r["path"] == "host" for r in host)
    hooked = model.run_batch(ids, np.asarray([4, 2], np.int32),
                             model.named_hooks["no3"], True)
    assert seen and all(3 not in r["tokens"] for r in hooked)
    assert model.recompile_guards == (dec._recompile_guard,) and \
        model.can_host
    assert model.tokens_per_dispatch == 1
    # the speculative rung needs the draft's parameters
    with pytest.raises(AssertionError, match="draft_params"):
        GenerationModel(dec, model.params, speculative=object())


def test_generation_model_behind_the_server_and_tcp():
    """Requests over TCP from several threads: each answer equal to a
    lone `generate()` of its row, a named hook answer on the host path,
    an unknown hook rejected."""
    dec, table, model = _bigram_model(
        named_hooks={"noop": THooks(), "no2": THooks(
            adjust=lambda lp, t: np.where(np.arange(6) == 2, -1e30, lp))},
        k_tok=2)
    server = InferenceServer(ServeConfig(max_queue=32, max_batch=4,
                                         buckets=(4, 8),
                                         default_deadline_s=60.0))
    server.add_model("gen", model)
    tcp = ServingTCPServer(server)
    addr = f"127.0.0.1:{tcp.port}"
    answers = {}

    def client(i):
        with ServeClient(addr) as c:
            for j in range(3):
                n = i * 3 + j
                hooks = "no2" if n == 4 else ("noop" if n == 7 else None)
                answers[n] = c.call("gen", [2] * (1 + n % 5), hooks=hooks,
                                    timeout=60)

    try:
        threads = [threading.Thread(target=client, args=(i,))
                   for i in range(4)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(120)
        with ServeClient(addr) as c:
            bad = c.call("gen", [2, 3], hooks="nope", timeout=60)
    finally:
        tcp.stop()
        server.shutdown(drain=True)
    assert bad["ok"] is False and bad["error"] == "unknown_hook"
    lone = [x.numpy() for x in dec.generate(model.params, [], batch_size=1)]
    assert len(answers) == 12
    for n, a in answers.items():
        assert a["ok"], a
        assert a["path"] == ("host" if n in (4, 7) else "jit")
        if n == 4:
            assert 2 not in a["tokens"]
            continue
        assert a["tokens"] == lone[0][0, 0, :lone[1][0, 0]].tolist()
        assert a["latency_ms"] > 0


class _Spans:
    """A stand-in event stream that keeps the span records."""

    def __init__(self):
        self.events = []

    def emit(self, obj):
        self.events.append(obj)

    def close(self):
        pass

    def by_name(self):
        out = {}
        for e in list(self.events):
            if e.get("kind") == "span":
                out.setdefault(e["name"], []).append(e)
        return out


@pytest.fixture
def spans():
    reg = tmetrics.get_registry()
    old = reg.stream
    rec = _Spans()
    reg._stream = rec
    try:
        yield rec
    finally:
        reg._stream = old


def _wait(rec, name, timeout=10.0):
    deadline = time.monotonic() + timeout
    while time.monotonic() < deadline:
        by = rec.by_name()
        if by.get(name):
            return by
        time.sleep(0.01)
    return rec.by_name()


@pytest.mark.parametrize("k_tok,max_len,span_name", [
    (1, 4, "decode.token"), (4, 6, "decode.chunk")])
def test_decode_spans_under_the_dispatch_span(spans, k_tok, max_len,
                                              span_name):
    """The host rung's per-token `decode.token` spans (K = 1) or
    per-chunk `decode.chunk` spans with a `tokens` label (K = 4, a full
    walk of 6: chunks of 4 and 2), parented under the batch's
    `serve.dispatch` span, as tests/test_tracing.py holds the JAX
    rung's."""
    vocab = 16
    rng = np.random.default_rng(0)
    table = rng.standard_normal((vocab, vocab)).astype(np.float32)
    table[:, EOS] = -50.0
    dec = _bigram_dec("torch", "trace_bigram", vocab, beam=2,
                      max_len=max_len, k_tok=k_tok)
    model = GenerationModel(dec, {"trace_bigram": torch.from_numpy(table)},
                            named_hooks={"noop": THooks()})
    server = InferenceServer(ServeConfig(max_queue=8, max_batch=1))
    server.add_model("gen", model)
    try:
        req = server.submit("gen", [2, 3], deadline_s=120.0,
                            hooks_name="noop",
                            trace={"trace_id": ttracing.new_trace_id(),
                                   "span_id": ""})
        out = req.result(timeout=120)
        assert out["path"] == "host"
        by = _wait(spans, "serve.dispatch")
    finally:
        server.shutdown(drain=True)
    disp = by["serve.dispatch"][0]
    got = by.get(span_name, [])
    assert got and all(s["parent_id"] == disp["span_id"] for s in got)
    assert all(s["trace_id"] == disp["trace_id"] for s in got)
    other = "decode.chunk" if span_name == "decode.token" else "decode.token"
    assert other not in by
    if k_tok == 1:
        assert 1 <= len(got) <= max_len
    else:
        assert [s["labels"]["tokens"] for s in got] == [4, 2]


@pytest.mark.cuda
class TestOnCard:
    """The decode graphs on the card against eager decoding there."""

    @pytest.fixture(autouse=True)
    def _card(self):
        if not torch.cuda.is_available():
            pytest.skip("needs a CUDA device: the decode graphs replay on "
                        "the card")

    @pytest.mark.parametrize("table_name", ["no_eos", "random", "peaked"])
    def test_graph_replays_equal_eager(self, table_name):
        table = torch.from_numpy({
            "no_eos": lambda: _no_eos(0), "random": lambda: _rand_table(2),
            "peaked": _peaked_table}[table_name]()).cuda()
        ref_dec = _bigram_dec("torch", "bg")
        ref_dec.use_graphs = False
        ref = ref_dec.generate({"bg": table}, [], batch_size=3)
        for k_tok in (1, 4, 5, 32):
            dec = _bigram_dec("torch", "bg", k_tok=k_tok)
            for _ in range(2):
                got = dec.generate({"bg": table}, [], batch_size=3)
                assert all(torch.equal(g, r) for g, r in zip(got, ref))
                assert dec.last_steps == ref_dec.last_steps
                assert dec.last_chain_depth == -(-dec.last_steps // k_tok)
            prog = next(iter(dec._decode_cache.values()))
            assert len(prog.graphs) == 1
            assert set(dec.last_timeline) == {"dispatch_s", "device_s"}

    def test_encoder_decoder_graphs_and_the_host_rung(self):
        h = 6
        rng = np.random.default_rng(3)
        dec = TDec(_enc_step("torch"), n_static=1, bos_id=0, eos_id=1,
                   beam_size=3, max_length=9, tokens_per_dispatch=4)
        eager = TDec(_enc_step("torch"), n_static=1, bos_id=0, eos_id=1,
                     beam_size=3, max_length=9)
        eager.use_graphs = False
        enc = targ.non_seq(rng.standard_normal((5, h)).astype(np.float32),
                           device="cuda")
        boots = {"s": torch.tensor(rng.standard_normal((5, h)).astype(
            np.float32), device="cuda")}
        p = dec._build([enc]).init_params(torch.Generator().manual_seed(0),
                                          device="cuda")
        p = {k: v * 3 for k, v in p.items()}  # decisive margins
        ref = eager.generate(p, [enc], boots)
        got = dec.generate(p, [enc], boots)
        assert all(torch.equal(g, r) for g, r in zip(got, ref))
        ref = [x.cpu().numpy() for x in ref]
        chunked = thd.host_generate(dec, p, [enc], boots)
        _equal(chunked, ref)
        per_token = thd.host_generate(dec, p, [enc], boots,
                                      tokens_per_dispatch=1)
        _same_tokens(per_token, ref)

    def test_a_failed_capture_raises(self):
        """A host read inside the chunk cannot be captured: generate()
        raises instead of decoding eagerly."""
        def syncing(logp, t):
            return logp + 0.0 * float(t.item())

        dec = _bigram_dec("torch", "bg", logprob_fn=syncing)
        with pytest.raises(RuntimeError, match="CUDA graph failed"):
            dec.generate({"bg": torch.from_numpy(_no_eos(0)).cuda()}, [],
                         batch_size=2)
        torch.cuda.synchronize()
