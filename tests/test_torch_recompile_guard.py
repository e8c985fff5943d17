"""The recompile guard on the port, against the JAX package's, on the CPU.

Mirrors `tests/test_recompile_guard.py` (the unit tests, the trainer's
strict, record and off modes, the server's cold bucket, strict dispatch
and model-guard collection) on `paddle_tpu_torch`, and holds the port's
counts against the JAX guard's on the same feed sequences: the port
notes the first sight of a signature where the JAX package traces
(the train step and its K-step chunks, the eval forward, the beam
decoder, the paged LM, the serving forward), so the two count the same
traces. On the card a CUDA-graph capture is a note too; here the graph
runners run with their capture swapped for eager execution (the way the
port's multistep and beam tests exercise them), and a strict guard
raises before the capture begins.
"""

import numpy as np
import pytest
import torch

from paddle_tpu import dsl as jdsl
from paddle_tpu.analysis import recompile_guard as jrg
from paddle_tpu.beam_search import BeamSearchDecoder as JDec
from paddle_tpu.core import arg as jarg
from paddle_tpu.core import flags as jflags
from paddle_tpu.core.config import OptimizationConf as JOpt
from paddle_tpu.core.config import ParameterConf as JPC
from paddle_tpu.trainer.trainer import SGD as JSGD
from paddle_tpu_torch import beam_search as tbs
from paddle_tpu_torch import dsl as tdsl
from paddle_tpu_torch.analysis import recompile_guard as rg
from paddle_tpu_torch.beam_search import BeamSearchDecoder as TDec
from paddle_tpu_torch.core import arg as targ
from paddle_tpu_torch.core import flags as tflags
from paddle_tpu_torch.core.config import OptimizationConf as TOpt
from paddle_tpu_torch.core.config import ParameterConf as TPC
from paddle_tpu_torch.obs import metrics as tmetrics
from paddle_tpu_torch.parallel import graph as tgraph
from paddle_tpu_torch.parallel.dp import stack_feeds
from paddle_tpu_torch.serving.models import GenerationModel, MultiForwardHost
from paddle_tpu_torch.serving.server import (
    InferenceServer,
    ServeConfig,
    ServeError,
)
from paddle_tpu_torch.trainer.trainer import SGD


def _conf(dsl):
    with dsl.model() as m:
        x = dsl.data("x", dim=8)
        y = dsl.data("label", dim=(), is_ids=True)
        o = dsl.fc(dsl.fc(x, size=16, act="relu"), size=4, act="")
        dsl.classification_cost(o, y)
    return m.conf


def _batches(n, bs=8, seed=0):
    r = np.random.default_rng(seed)
    return [(r.standard_normal((bs, 8)).astype(np.float32),
             r.integers(0, 4, bs).astype(np.int32)) for _ in range(n)]


def _feeder(raw):
    return {"x": targ.non_seq(raw[0]), "label": targ.id_arg(raw[1])}


def _jfeeder(raw):
    return {"x": jarg.non_seq(raw[0]), "label": jarg.id_arg(raw[1])}


def _sgd(**kw):
    return SGD(_conf(tdsl), TOpt(learning_method="adam", learning_rate=1e-2),
               seed=1, device="cpu", **kw)


@pytest.fixture(autouse=True)
def _reset_flags():
    yield
    tflags.reset_flags()
    jflags.reset_flags()


class TestGuardUnit:
    def test_warmup_counts_and_arming(self):
        g = rg.RecompileGuard("unit")
        g.note(torch.zeros((2, 2)))
        g.note(torch.zeros((4, 2)))
        assert g.traces == 2 and g.warmup_traces == 2
        assert not g.violations
        g.arm(strict=False)
        g.note(torch.zeros((8, 2)))
        assert len(g.violations) == 1
        v = g.violations[0]
        assert v["label"] == "unit" and "(8, 2)" in v["signature"]
        g.disarm()
        g.note(torch.zeros((16, 2)))
        assert len(g.violations) == 1   # disarmed: counted, not flagged

    def test_strict_raises_from_note(self):
        g = rg.RecompileGuard("unit_strict").arm(strict=True)
        with pytest.raises(rg.RecompileError, match="retraced"):
            g.note(torch.zeros((2,)))

    def test_assert_steady_state_and_label_filter(self):
        a = rg.RecompileGuard("fleet.a").arm()
        rg.RecompileGuard("fleet.b").arm()
        a.note()
        with pytest.raises(rg.RecompileError, match="fleet.a"):
            rg.assert_steady_state("fleet.")
        rg.assert_steady_state("fleet.b")   # b is clean
        rg.disarm_all("fleet.")
        assert not any(g.armed for g in rg.all_guards()
                       if g.label.startswith("fleet."))

    def test_violation_counts_in_registry(self):
        reg = tmetrics.get_registry()
        before = reg.counter("recompile_guard.violations").get(
            label="unit_metric")
        traces = reg.counter("recompile_guard.traces").get(
            label="unit_metric")
        g = rg.RecompileGuard("unit_metric").arm()
        g.note()
        assert reg.counter("recompile_guard.violations").get(
            label="unit_metric") == before + 1
        assert reg.counter("recompile_guard.traces").get(
            label="unit_metric") == traces + 1

    def test_note_once_bounds_namespaces_and_forgets(self):
        """note_once notes a key once per namespace, drops the oldest
        past `limit`, notes again with `force`, keeps no key a strict
        guard refused, and `via` notes with another guard."""
        g = rg.RecompileGuard("unit_once")
        assert g.note_once("a", limit=2) and not g.note_once("a", limit=2)
        assert g.note_once("b", limit=2) and g.note_once("c", limit=2)
        assert g.note_once("a", limit=2)       # "a" was dropped for "c"
        assert g.note_once("a", cache="other")
        assert g.note_once("a", cache="other", force=True)
        assert g.traces == 6
        g.forget("other")
        assert g.note_once("a", cache="other") and g.traces == 7
        other = rg.RecompileGuard("unit_once_via")
        assert g.note_once("v", cache="shared", via=other)
        assert (g.traces, other.traces) == (7, 1)
        g.arm(strict=True)
        for _ in range(2):
            with pytest.raises(rg.RecompileError):
                g.note_once("new")
        assert not g.note_once("a", limit=2)   # warm keys stay quiet


class TestTrainerGuard:
    def test_armed_after_first_pass_and_strict_raises(self):
        """The flag contract: warmup = the first pass; a steady-state
        shape change then fails loudly in strict mode."""
        tflags.set_flag("recompile_guard", "strict")
        t = _sgd()
        g = t.step_fn.recompile_guard
        assert not g.armed
        t.train(reader=lambda: iter(_batches(3)), feeder=_feeder,
                num_passes=2)
        assert g.armed and g.warmup_traces >= 1
        assert t.recompile_violations() == []
        with pytest.raises(rg.RecompileError, match="train_step"):
            t.train(reader=lambda: iter(_batches(2, bs=16)),
                    feeder=_feeder, num_passes=1)
        assert len(t.recompile_violations()) == 1

    def test_record_mode_does_not_raise(self):
        tflags.set_flag("recompile_guard", "record")
        t = _sgd()
        t.train(reader=lambda: iter(_batches(3)), feeder=_feeder,
                num_passes=2)
        # a seeded violation: a cold shape in steady state
        t.train(reader=lambda: iter(_batches(2, bs=32)), feeder=_feeder,
                num_passes=1)
        vs = t.recompile_violations()
        assert len(vs) == 1 and vs[0]["label"] == "train_step"

    def test_default_off_never_arms(self):
        t = _sgd()
        t.train(reader=lambda: iter(_batches(3)), feeder=_feeder,
                num_passes=2)
        assert not t.step_fn.recompile_guard.armed
        t.train(reader=lambda: iter(_batches(2, bs=16)), feeder=_feeder,
                num_passes=1)
        assert t.recompile_violations() == []

    def test_steady_state_without_shape_change_is_clean(self):
        tflags.set_flag("recompile_guard", "strict")
        t = _sgd()
        for _ in range(3):
            t.train(reader=lambda: iter(_batches(3)), feeder=_feeder,
                    num_passes=1)
        assert t.recompile_violations() == []

    @pytest.mark.parametrize("spd", [1, 4])
    def test_trace_counts_equal_jax(self, spd):
        """The same feed sequence (two passes of 9 batches, a pass at
        another batch size, an eval pass) through both trainers: the
        step's and the eval forward's guards count the same traces (K =
        4: a chunk of 4 and a tail chunk of 1 a signature)."""
        seq = [(9, 8), (9, 8), (3, 16)]
        t = _sgd(steps_per_dispatch=spd)
        j = JSGD(_conf(jdsl), JOpt(learning_method="adam",
                                   learning_rate=1e-2),
                 seed=1, steps_per_dispatch=spd)
        for trainer, feeder in ((t, _feeder), (j, _jfeeder)):
            for n, bs in seq:
                trainer.train(reader=lambda n=n, bs=bs: iter(_batches(n, bs)),
                              feeder=feeder, num_passes=1)
            trainer.test(lambda: iter(_batches(2, 5)), feeder)
            trainer.test(lambda: iter(_batches(2, 5)), feeder)
        # K = 1: a step a signature; K = 4: two chunks (4 and the tail
        # of 1) at batch 8 and one of 3 at batch 16, each with its body
        assert t.step_fn.recompile_guard.traces == \
            j.step_fn.recompile_guard.traces == (6 if spd > 1 else 2)
        assert t._eval_guard.traces == j._eval_guard.traces == 1


def _eager_graphs(monkeypatch):
    """`parallel/graph.py` with the CUDA capture swapped for eager
    execution; returns the list of captures."""
    captures = []
    monkeypatch.setattr(tgraph.torch.cuda, "graph_pool_handle", lambda: None)
    monkeypatch.setattr(tgraph.torch.cuda, "Stream", lambda device: None)
    monkeypatch.setattr(tgraph.torch.cuda, "CUDAGraph", lambda: None)
    monkeypatch.setattr(tgraph._Graph, "capture",
                        lambda self: captures.append(self.k))

    def replay(self):
        self.losses, self.outs = self._steps(self.k, write_back=True)
        return (self.losses.clone(),
                {n: tgraph._arg_map(torch.clone, a)
                 for n, a in self.outs.items()})

    monkeypatch.setattr(tgraph._Graph, "replay", replay)
    return captures


def test_a_capture_is_a_note_and_strict_raises_before_it(monkeypatch):
    """Every capture of the graph runner is noted with the step's guard;
    armed, a capture in steady state is a violation, and strict raises
    before the capture begins (nothing captured, nothing cached)."""
    captures = _eager_graphs(monkeypatch)
    t = _sgd()
    step = t.step_fn
    runner = step.graphs = tgraph.StepGraphs(step)
    feeds8 = [_feeder(b) for b in _batches(4)]
    feeds16 = [_feeder(b) for b in _batches(4, bs=16)]

    def run(feeds):
        tables = step.step_tables(0, len(feeds), 1, 1.0,
                                  next(iter(t.params.values())))
        return runner.run(t.params, t.opt_state, t.state,
                          stack_feeds(feeds), *tables)

    g = step.recompile_guard
    run(feeds8)
    run(feeds8)
    assert captures == [4] and g.traces == 2   # the chunk and its body
    g.arm(strict=True)
    run(feeds8)   # a replay: nothing noted
    with pytest.raises(rg.RecompileError, match="train_step"):
        run(feeds16)
    assert captures == [4] and len(runner.graphs) == 1
    g.arm(strict=False)
    run(feeds16)
    assert captures == [4, 4] and len(g.violations) == 3


# ---- the decoders -----------------------------------------------------------
V, EOS, BOS = 10, 1, 0


def _bigram_dec(dsl, pc, dec_cls, pname="rg_bg", k_tok=1):
    def step(word):
        emb = dsl.embedding(word, size=V, vocab_size=V,
                            param=pc(name=pname))
        return dsl.mixed(V, [(emb, "identity")], act="softmax", bias=False,
                         name="prob")

    return dec_cls(step, n_static=0, bos_id=BOS, eos_id=EOS, beam_size=3,
                   max_length=6, tokens_per_dispatch=k_tok)


def _table(seed=0):
    return (np.random.default_rng(seed).standard_normal((V, V)) * 2).astype(
        np.float32)


def test_beam_decoder_counts_equal_jax():
    """Batch sizes 2, 2, 3, 2, then another hook-free K: each package's
    `beam_decode` guard counts a trace at each new (program, batch)."""
    import jax.numpy as jnp

    table = _table()
    td = _bigram_dec(tdsl, TPC, TDec)
    jd = _bigram_dec(jdsl, JPC, JDec)
    for b in (2, 2, 3, 2):
        td.generate({"rg_bg": torch.from_numpy(table)}, [], batch_size=b)
        jd.generate({"rg_bg": jnp.asarray(table)}, [], batch_size=b)
    td.tokens_per_dispatch = jd.tokens_per_dispatch = 3
    for dec, p in ((td, torch.from_numpy(table)), (jd, jnp.asarray(table))):
        dec.generate({"rg_bg": p}, [], batch_size=2)
    assert td._recompile_guard.traces == jd._recompile_guard.traces == 3


def test_decode_graph_capture_is_a_note(monkeypatch):
    """A `_DecodeGraph` capture is a note; strict, a cold batch raises
    before its graph (and its static buffers) is built, and the warm
    ones keep decoding."""
    monkeypatch.setattr(tbs.torch.cuda, "graph_pool_handle", lambda: None)
    monkeypatch.setattr(tbs.torch.cuda, "Stream", lambda device: None)
    monkeypatch.setattr(tbs.torch.cuda, "CUDAGraph", lambda: None)
    captures = []
    monkeypatch.setattr(tbs._DecodeGraph, "capture",
                        lambda self: captures.append(self.b) or setattr(
                            self, "captured", True))
    monkeypatch.setattr(tbs._DecodeGraph, "replay",
                        lambda self: self._chunk(write_back=True))
    monkeypatch.setattr(tbs._DecodeProgram, "_graphed",
                        lambda self, dev: self.dec.use_graphs)
    dec = _bigram_dec(tdsl, TPC, TDec, k_tok=2)
    p = {"rg_bg": torch.from_numpy(_table())}
    dec.generate(p, [], batch_size=2)
    dec.generate(p, [], batch_size=2)
    g = dec._recompile_guard
    assert captures == [2] and g.traces == 1
    g.arm(strict=True)
    with pytest.raises(rg.RecompileError, match="beam_decode"):
        dec.generate(p, [], batch_size=4)
    assert captures == [2]
    assert [key[0] for key in dec._decode_program().graphs] == [2]
    want = dec.generate(p, [], batch_size=2)
    dec.use_graphs = False
    got = dec.generate(p, [], batch_size=2)
    for a, b in zip(got, want):
        assert torch.equal(a, b)


def test_paged_lm_counts_equal_jax():
    """The paged LM's generate over batches 2, 2, 3 and a beam decode:
    both packages' `paged_lm` guards count the same program keys."""
    import jax

    from paddle_tpu.decoding import kv_cache as jkv
    from paddle_tpu.models import lm as jlm
    from paddle_tpu_torch.decoding import kv_cache as tkv
    from paddle_tpu_torch.models import lm as tlm
    from paddle_tpu_torch.weights import params_from_numpy

    jspec = jlm.LMSpec(vocab=32, d_model=16, num_heads=2, num_layers=1)
    tspec = tlm.LMSpec(vocab=32, d_model=16, num_heads=2, num_layers=1)
    jp = jlm.lm_init_params(jspec, jax.random.key(0))
    tp = params_from_numpy({k: np.asarray(v) for k, v in jp.items()},
                           device="cpu")
    jm = jkv.PagedLM(jspec, jp, jkv.PagedKVCache(jspec, 64, 4), eos_id=1)
    tm = tkv.PagedLM(tspec, tp, tkv.PagedKVCache(tspec, 64, 4,
                                                 device="cpu"), eos_id=1)
    rng = np.random.default_rng(0)
    for b in (2, 2, 3):
        ids = rng.integers(2, 32, (b, 6)).astype(np.int32)
        lens = np.full((b,), 6, np.int32)
        jm.generate(ids, lens, 4)
        tm.generate(ids, lens, 4)
    ids = rng.integers(2, 32, (2, 6)).astype(np.int32)
    jm.beam_generate(ids, np.full((2,), 6, np.int32), 2, 3)
    tm.beam_generate(ids, np.full((2,), 6, np.int32), 2, 3)
    (jg,), (tg,) = jm.recompile_guards, tm.recompile_guards
    assert tg.label == "paged_lm"
    assert tg.traces == jg.traces == 6


# ---- serving ----------------------------------------------------------------
def _host():
    with tdsl.model() as g:
        w = tdsl.data("w", (1,), is_seq=True, is_ids=True)
        emb = tdsl.embedding(w, size=8, vocab_size=20, name="emb")
        pooled = tdsl.seq_pool(emb, pool_type="average", name="pool")
        tdsl.fc(pooled, size=3, act="softmax", name="out")
        g.conf.output_layer_names.append("out")
    return MultiForwardHost({"m": g.conf},
                            generator=torch.Generator().manual_seed(0),
                            device="cpu")


class TestServingGuard:
    def test_batcher_guard_trips_on_cold_bucket(self):
        """Warm one length bucket, arm, then serve a request of another
        bucket: the merged forward's guard records it."""
        host = _host()
        (guard,) = host.recompile_guards

        def run(n):
            ids = (np.arange(n, dtype=np.int32) % 19 + 1)[None, :]
            host.run_group({"m": (ids, np.asarray([n], np.int32))})

        run(4)
        assert guard.warmup_traces == 1
        guard.arm(strict=False)
        run(4)   # seen: no note
        assert guard.violations == []
        run(32)  # a cold bucket in steady state
        assert len(guard.violations) == 1
        assert guard.violations[0]["label"] == "serve_forward"

    def test_strict_guard_is_loud_through_dispatch(self):
        """Strict mode fails the request, never rescued on the host rung
        (a rescue would repeat raise -> fallback on every request of the
        bucket); the server keeps serving the warm bucket."""
        host = _host()
        srv = InferenceServer(ServeConfig(max_queue=8, max_batch=2))
        try:
            srv.add_model("m", host.sub("m"))
            srv.submit("m", [1, 2, 3]).result(timeout=120)   # warmup
            srv.arm_recompile_guard(strict=True)
            req = srv.submit("m", [i % 19 + 1 for i in range(24)])  # cold
            with pytest.raises(ServeError, match="RecompileError"):
                req.result(timeout=120)
            assert srv.submit("m", [3, 2, 1]).result(timeout=120)
        finally:
            srv.shutdown()

    def test_generation_model_cold_batch_fails_only_its_request(self):
        dec = _bigram_dec(tdsl, TPC, TDec, k_tok=2)
        model = GenerationModel(dec, {"rg_bg": torch.from_numpy(_table())})
        srv = InferenceServer(ServeConfig(max_queue=8, max_batch=1,
                                          host_fallback=True))
        try:
            srv.add_model("gen", model)
            srv.submit("gen", [1, 2]).result(timeout=120)    # warmup
            assert srv.arm_recompile_guard(strict=True) == [
                dec._recompile_guard]
            warm = srv.submit("gen", [3, 4]).result(timeout=120)
            assert warm
            assert srv.recompile_violations() == []
            dec.max_length = 5   # a new decode program: a cold one
            with pytest.raises(ServeError, match="RecompileError"):
                srv.submit("gen", [1, 2]).result(timeout=120)
            assert len(srv.recompile_violations()) == 1
            dec.max_length = 6
            assert srv.submit("gen", [3, 4]).result(timeout=120) == warm
        finally:
            srv.shutdown()

    def test_server_arm_collects_model_guards(self):
        host = _host()
        srv = InferenceServer(ServeConfig(max_queue=8, max_batch=2))
        try:
            srv.add_model("m", host.sub("m"))
            srv.submit("m", [1, 2, 3]).result(timeout=120)   # warmup
            armed = srv.arm_recompile_guard(strict=False)
            assert host._recompile_guard in armed
            assert host._recompile_guard.armed
            assert srv.recompile_violations() == []
            srv.disarm_recompile_guard()
            assert not host._recompile_guard.armed
        finally:
            srv.shutdown()


def test_serving_forward_counts_equal_jax():
    """The same requests through both packages' merged forwards: the
    `serve_forward` guards count the same traces."""
    from paddle_tpu.serving.models import MultiForwardHost as JHost

    with jdsl.model() as g:
        w = jdsl.data("w", (1,), is_seq=True, is_ids=True)
        emb = jdsl.embedding(w, size=8, vocab_size=20, name="emb")
        pooled = jdsl.seq_pool(emb, pool_type="average", name="pool")
        jdsl.fc(pooled, size=3, act="softmax", name="out")
        g.conf.output_layer_names.append("out")
    jh, th = JHost({"m": g.conf}), _host()
    for n, b in ((4, 1), (4, 1), (8, 1), (4, 2), (8, 1)):
        ids = np.ones((b, n), np.int32)
        for h in (jh, th):
            h.run_group({"m": (ids, np.full((b,), n, np.int32))})
    assert th.recompile_guards[0].traces == \
        jh.recompile_guards[0].traces == 3
    assert jrg  # the JAX guard module the counts are held against
