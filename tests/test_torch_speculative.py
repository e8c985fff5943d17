"""The port's speculative greedy decoding (`paddle_tpu_torch/decoding/
speculative.py`) and `GenerationModel`'s speculative rung against
`paddle_tpu/decoding/speculative.py`, on the CPU.

The cases of `tests/test_decoding.py::TestSpeculativeGreedy` (a bigram
table target with close, garbage and exact drafts at propose_k 3, 4
and 8; eos inside a proposal; a self-draft's measured chain), plus the
attention NMT's decoder with a draft of other parameters. Both packages
run from one description and the same numpy parameters:

- seqs and lens exactly the JAX decoder's, scores within atol 1e-5;
- `last_chain_depth`, `last_steps` and `last_accept_rate` equal to the
  JAX decoder's readings;
- and token for token the port's own target `generate()` (greedy).

`GenerationModel(speculative=...)` answers hook-free requests on path
"spec" with the target's tokens, a hook request on path "host", and a
failing speculative decode raises instead of serving another rung.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from paddle_tpu import dsl as jdsl
from paddle_tpu.beam_search import BeamSearchDecoder as JDec
from paddle_tpu.core import arg as jarg
from paddle_tpu.core.config import ParameterConf as JPC
from paddle_tpu.decoding import SpeculativeGreedyDecoder as JSpec
from paddle_tpu.decoding import make_draft_decoder as jmake_draft
from paddle_tpu.models import text as jtext
from paddle_tpu.network import Network as JNetwork
from paddle_tpu_torch import dsl as tdsl
from paddle_tpu_torch.beam_search import BeamHooks
from paddle_tpu_torch.beam_search import BeamSearchDecoder as TDec
from paddle_tpu_torch.core import arg as targ
from paddle_tpu_torch.core.config import ParameterConf as TPC
from paddle_tpu_torch.decoding import SpeculativeGreedyDecoder as TSpec
from paddle_tpu_torch.decoding import make_draft_decoder as tmake_draft
from paddle_tpu_torch.models import text as ttext
from paddle_tpu_torch.network import Network as TNetwork
from paddle_tpu_torch.serving.models import GenerationModel
from paddle_tpu_torch.serving.server import InferenceServer, ServeConfig
from paddle_tpu_torch.weights import params_from_numpy

V, EOS, BOS = 10, 1, 0
SCORE_ATOL = 1e-5
PKG = {"jax": (jdsl, JPC, JDec, jmake_draft, JSpec),
       "torch": (tdsl, TPC, TDec, tmake_draft, TSpec)}


def _bigram_step(pkg, pname, vocab=V):
    dsl, pc = PKG[pkg][:2]

    def step(word):
        emb = dsl.embedding(word, size=vocab, vocab_size=vocab,
                            param=pc(name=pname))
        return dsl.mixed(vocab, [(emb, "identity")], act="softmax",
                         bias=False, name="prob")

    return step


def _target(pkg, max_len=17):
    dec_cls = PKG[pkg][2]
    return dec_cls(_bigram_step(pkg, "sp_t"), n_static=0, bos_id=BOS,
                   eos_id=EOS, beam_size=1, max_length=max_len)


def _draft(pkg, pname, max_len=17):
    return PKG[pkg][3](_bigram_step(pkg, pname), n_static=0, bos_id=BOS,
                       eos_id=EOS, max_length=max_len)


def _rand_table(seed, scale=3.0, vocab=V):
    rng = np.random.default_rng(seed)
    return (rng.normal(size=(vocab, vocab)) * scale).astype(np.float32)


def _peaked_table(vocab=V):
    """Sharply peaked chain 0->2->3->eos: every beam finishes at t=3."""
    t = np.full((vocab, vocab), -5.0, np.float32)
    t[0, 2] = t[2, 3] = t[3, EOS] = 5.0
    return t


def _params(pkg, named):
    if pkg == "jax":
        return {k: jnp.asarray(v) for k, v in named.items()}
    return {k: torch.from_numpy(v) for k, v in named.items()}


def _both_spec(table, draft_table, pname, k_prop, b, max_len=17):
    """(port outputs, JAX outputs, port decoder, JAX decoder)."""
    out, decs = {}, {}
    for pkg in ("torch", "jax"):
        spec = PKG[pkg][4](_target(pkg, max_len), _draft(pkg, pname,
                                                         max_len),
                           propose_k=k_prop)
        res = spec.generate(_params(pkg, {"sp_t": table}),
                            _params(pkg, {pname: draft_table}),
                            batch_size=b)
        out[pkg] = tuple(np.asarray(x) for x in res)
        decs[pkg] = spec
    return out["torch"], out["jax"], decs["torch"], decs["jax"]


def _held(got, ref, tspec, jspec):
    np.testing.assert_array_equal(got[0], ref[0])
    np.testing.assert_array_equal(got[1], ref[1])
    np.testing.assert_allclose(got[2], ref[2], rtol=0, atol=SCORE_ATOL)
    assert got[0].dtype == np.int32 and got[1].dtype == np.int32
    assert got[2].dtype == np.float32
    assert (tspec.last_chain_depth, tspec.last_steps,
            tspec.last_accept_rate) == (jspec.last_chain_depth,
                                        jspec.last_steps,
                                        jspec.last_accept_rate)


def _greedy(table, b, max_len=17):
    out = _target("torch", max_len).generate(
        {"sp_t": torch.from_numpy(table)}, [], batch_size=b)
    return tuple(x.numpy() for x in out)


@pytest.mark.parametrize("k_prop", [3, 4, 8])
@pytest.mark.parametrize("draft", ["close", "garbage", "exact"])
def test_token_for_token_any_draft_quality(draft, k_prop):
    table = _rand_table(7)
    rng = np.random.default_rng(8)
    draft_table = {
        "close": table + rng.normal(size=(V, V)).astype(np.float32),
        "garbage": _rand_table(99),
        "exact": table,
    }[draft]
    got, ref, tspec, jspec = _both_spec(table, draft_table,
                                        f"sp_d_{draft}", k_prop, b=4)
    _held(got, ref, tspec, jspec)
    greedy = _greedy(table, 4)
    np.testing.assert_array_equal(got[0], greedy[0])
    np.testing.assert_array_equal(got[1], greedy[1])
    np.testing.assert_allclose(got[2], greedy[2], rtol=0, atol=1e-4)
    assert tspec.last_chain_depth >= 2


def test_eos_mid_proposal_truncates_exactly():
    table = _peaked_table()
    got, ref, tspec, jspec = _both_spec(table, table, "sp_dp", 8, b=3)
    _held(got, ref, tspec, jspec)
    assert got[1][0, 0] == 3          # 2, 3, eos
    assert tspec.last_chain_depth == 2  # one propose + one verify


def test_chain_depth_and_accept_rate_measured():
    table = _rand_table(2)
    table[:, EOS] = -50.0  # no eos: full-length walk
    got, ref, tspec, jspec = _both_spec(table, table, "sp_ds", 8, b=4,
                                        max_len=16)
    _held(got, ref, tspec, jspec)
    assert got[1][0, 0] == 16
    assert tspec.last_chain_depth == 4
    assert tspec.last_accept_rate == 1.0 and tspec.last_steps == 16


def test_rejects_beam_search_decoders_and_mismatched_ids():
    beam = TDec(_bigram_step("torch", "sp_b"), n_static=0, bos_id=BOS,
                eos_id=EOS, beam_size=4, max_length=17)
    with pytest.raises(AssertionError):
        TSpec(beam, _target("torch"), propose_k=4)
    other_eos = TDec(_bigram_step("torch", "sp_e"), n_static=0,
                     bos_id=BOS, eos_id=2, beam_size=1, max_length=17)
    with pytest.raises(AssertionError, match="eos_id"):
        TSpec(_target("torch"), other_eos)
    assert [g.label for g in TSpec(_target("torch"), _draft(
        "torch", "d")).recompile_guards] == ["spec_decode"]


def test_position_independent_logprob_fn_matches_jax():
    """A logprob_fn (here: forbid token 4) composes when it ignores t;
    the port's gets torch tensors, the JAX one jnp arrays."""
    table = _rand_table(3)

    def forbid(mod):
        def fn(logp, t):
            return mod.where(mod.arange(V) == 4, -1e30, logp)
        return fn

    out = {}
    for pkg, mod in (("torch", torch), ("jax", jnp)):
        dec_cls, make = PKG[pkg][2], PKG[pkg][3]
        tgt = dec_cls(_bigram_step(pkg, "sp_t"), n_static=0, bos_id=BOS,
                      eos_id=EOS, beam_size=1, max_length=12,
                      logprob_fn=forbid(mod))
        drf = make(_bigram_step(pkg, "sp_dl"), n_static=0, bos_id=BOS,
                   eos_id=EOS, max_length=12, logprob_fn=forbid(mod))
        spec = PKG[pkg][4](tgt, drf, propose_k=4)
        res = spec.generate(_params(pkg, {"sp_t": table}),
                            _params(pkg, {"sp_dl": _rand_table(5)}),
                            batch_size=3)
        out[pkg] = (tuple(np.asarray(x) for x in res), spec)
    _held(out["torch"][0], out["jax"][0], out["torch"][1], out["jax"][1])
    seqs, lens = out["torch"][0][:2]
    assert all(4 not in seqs[i, 0, :lens[i, 0]] for i in range(3))


# ---- the attention NMT's decoder: memories rolled to the accepted prefix --

NMT_KW = dict(trg_vocab=32, emb_dim=8, hidden=8, bos_id=BOS, eos_id=EOS,
              beam_size=1, max_length=10)


@pytest.fixture(scope="module")
def nmt():
    vocab = 32
    jconf = jtext.seq2seq_attention(src_vocab=vocab, trg_vocab=vocab,
                                    emb_dim=8, hidden=8)
    jnet = JNetwork(jconf)
    p = {k: np.asarray(v) for k, v in
         jnet.init_params(jax.random.key(0)).items()}
    # sharper output distributions, so the greedy walk is not all eos
    p["_dec_prob.w0"] = p["_dec_prob.w0"] * 8
    rng = np.random.default_rng(1)
    dp = {k: (v + rng.normal(0, 0.5, v.shape)).astype(np.float32)
          for k, v in p.items()}
    src = np.asarray([[2, 3, 4, 5, 6], [6, 7, 8, 9, 0], [9, 9, 3, 2, 2]],
                     np.int32)
    lens = np.asarray([5, 3, 4], np.int32)
    jo, _ = jnet.forward({k: jnp.asarray(v) for k, v in p.items()},
                         {"src": jarg.id_arg(src, lens)},
                         outputs=["enc", "dec_boot"])
    tnet = TNetwork(ttext.seq2seq_attention(src_vocab=vocab,
                                            trg_vocab=vocab, emb_dim=8,
                                            hidden=8))
    tp = params_from_numpy(p, device="cpu")
    with torch.no_grad():
        to, _ = tnet.forward(tp, {"src": targ.id_arg(src, lens)},
                             outputs=["enc", "dec_boot"])
    return dict(p=p, dp=dp, jo=jo, to=to, tp=tp, tnet=tnet)


@pytest.mark.parametrize("draft", ["self", "other"])
def test_nmt_decoder_speculative_matches_jax(nmt, draft):
    dp = nmt["p"] if draft == "self" else nmt["dp"]
    jo, to = nmt["jo"], nmt["to"]
    jspec = JSpec(jtext.seq2seq_attention_decoder(**NMT_KW),
                  jtext.seq2seq_attention_decoder(**NMT_KW), propose_k=4)
    tspec = TSpec(ttext.seq2seq_attention_decoder(**NMT_KW),
                  ttext.seq2seq_attention_decoder(**NMT_KW), propose_k=4)
    jst, jbt = [jo["enc"]], {"dec_state": jo["dec_boot"].value}
    ref = tuple(np.asarray(x) for x in jspec.generate(
        {k: jnp.asarray(v) for k, v in nmt["p"].items()},
        {k: jnp.asarray(v) for k, v in dp.items()}, statics=jst, boots=jbt,
        draft_statics=jst, draft_boots=jbt))
    tst, tbt = [to["enc"]], {"dec_state": to["dec_boot"].value}
    got = tspec.generate(nmt["tp"], params_from_numpy(dp, device="cpu"),
                         statics=tst, boots=tbt, draft_statics=tst,
                         draft_boots=tbt)
    _held(got, ref, tspec, jspec)
    greedy = [x.numpy() for x in tspec.target.generate(nmt["tp"], tst, tbt)]
    np.testing.assert_array_equal(got[0], greedy[0])
    np.testing.assert_array_equal(got[1], greedy[1])
    if draft == "self":
        assert tspec.last_accept_rate == 1.0
    else:
        assert tspec.last_accept_rate < 1.0
    assert got[1].min() > 1


# ---- GenerationModel's speculative rung ------------------------------------

def _spec_model(draft_table, table, propose_k=4, named_hooks=None):
    tgt = _target("torch")
    spec = TSpec(tgt, _draft("torch", "sp_dsv"), propose_k=propose_k)
    return GenerationModel(
        tgt, {"sp_t": torch.from_numpy(table)}, speculative=spec,
        draft_params={"sp_dsv": torch.from_numpy(draft_table)},
        named_hooks=named_hooks)


def test_generation_model_spec_path_behind_the_server():
    table = _rand_table(7)
    ref = _greedy(table, 1)
    model = _spec_model(_rand_table(99), table,
                        named_hooks={"noop": BeamHooks()})
    assert model.tokens_per_dispatch == 1
    assert [g.label for g in model.recompile_guards] == ["beam_decode",
                                                         "spec_decode"]
    srv = InferenceServer(ServeConfig(max_queue=8, max_batch=1))
    srv.add_model("gen", model)
    try:
        out = srv.submit("gen", [2, 3], deadline_s=120.0).result(
            timeout=120)
        assert out["path"] == "spec"
        assert out["tokens"] == ref[0][0, 0, :ref[1][0, 0]].tolist()
        hooked = srv.submit("gen", [2, 3], deadline_s=120.0,
                            hooks=model.named_hooks["noop"]).result(
            timeout=120)
        assert hooked["path"] == "host"
        assert hooked["tokens"] == out["tokens"]
    finally:
        srv.shutdown(drain=True)


def test_generation_model_spec_rows_host_and_draft_encode():
    table = _rand_table(7)
    model = _spec_model(table, table)
    ids = np.zeros((3, 4), np.int32)
    lens = np.asarray([4, 2, 3], np.int32)
    rows = model.run_batch(ids, lens, None, False)
    greedy = _greedy(table, 3)
    for i, r in enumerate(rows):
        assert r["path"] == "spec"
        assert r["tokens"] == greedy[0][i, 0, :greedy[1][i, 0]].tolist()
        assert abs(r["score"] - float(greedy[2][i, 0])) <= 1e-4
    host = model.run_batch(ids, lens, None, True)
    assert all(r["path"] == "host" for r in host)
    assert [r["tokens"] for r in host] == [r["tokens"] for r in rows]
    seen = []
    model.draft_encode = lambda i, ln: seen.append(len(i)) or ([], None)
    assert [r["tokens"] for r in model.run_batch(ids, lens, None, False)] \
        == [r["tokens"] for r in rows]
    assert seen == [3]


def test_generation_model_spec_asserts_and_raises_without_fallback():
    table = _rand_table(7)
    tgt = _target("torch")
    spec = TSpec(tgt, _draft("torch", "sp_dsv"))
    with pytest.raises(AssertionError, match="draft_params"):
        GenerationModel(tgt, {"sp_t": torch.from_numpy(table)},
                        speculative=spec)
    with pytest.raises(AssertionError, match="served decoder"):
        GenerationModel(_target("torch"), {"sp_t": torch.from_numpy(table)},
                        speculative=spec,
                        draft_params={"sp_dsv": torch.from_numpy(table)})
    # a draft whose table is missing fails the speculative decode: the
    # failure reaches the caller, no other rung answers instead
    model = GenerationModel(tgt, {"sp_t": torch.from_numpy(table)},
                            speculative=spec,
                            draft_params={"wrong": torch.from_numpy(table)})
    with pytest.raises(KeyError):
        model.run_batch(np.zeros((1, 2), np.int32),
                        np.asarray([2], np.int32), None, False)
