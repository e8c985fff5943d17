"""The serving side of the flight recorder and the fleet on the port,
against the JAX package, on the CPU.

- `multi_network.merge_confs` / `prefix_feed` build the JAX package's
  merged confs (compared as conf JSON), with and without shared
  parameters, recurrent groups included.
- `MultiForwardHost` scores equal the JAX `MultiForwardHost`'s on the
  robustness test's confs and on two LSTM classifiers (within 1e-5 of
  the largest), served alone and co-dispatched (`batches_codispatch`).
- The server's anomaly events (`slo_breach`, `breaker_open`) on scripted
  traffic with toy models equal the JAX server's, and `_AnomalyWatch`
  fires as the JAX one on the same decisions.
- The host-fallback rescue: a device failure counts once on the breaker
  (`serving.dispatch_failures`), the request is answered on the host
  rung (`path: "host"`, `completed_host`), a `GenerationModel`'s
  rescued tokens equal its device decode; no rescue without
  `host_fallback` or `can_host`.
- The `flightz` frame answers the ring as the JAX front end does.
"""

import time

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from paddle_tpu import dsl as jdsl
from paddle_tpu import multi_network as jmn
from paddle_tpu.core import flags as jflags
from paddle_tpu.core.config import ParameterConf as JPC
from paddle_tpu.models import text as jtext
from paddle_tpu.obs import flight_recorder as jfr
from paddle_tpu.obs import metrics as jom
from paddle_tpu.serving import models as jmodels
from paddle_tpu.serving import server as jserver
from paddle_tpu.serving import tcp as jtcp
from paddle_tpu_torch import dsl as tdsl
from paddle_tpu_torch import multi_network as tmn
from paddle_tpu_torch.beam_search import BeamSearchDecoder
from paddle_tpu_torch.core import flags as tflags
from paddle_tpu_torch.core.config import ParameterConf as TPC
from paddle_tpu_torch.models import text as ttext
from paddle_tpu_torch.obs import flight_recorder as tfr
from paddle_tpu_torch.obs import metrics as tom
from paddle_tpu_torch.serving import models as tmodels
from paddle_tpu_torch.serving import server as tserver
from paddle_tpu_torch.serving import tcp as ttcp

SEED = 24
TOL = 1e-5


def _scorer(dsl, pc, classes, shared):
    """The robustness test's scorer: embedding -> average pool -> fc
    softmax, the embedding optionally under an explicit shared name."""
    with dsl.model() as g:
        w = dsl.data("w", (1,), is_seq=True, is_ids=True)
        emb = dsl.embedding(w, size=8, vocab_size=20, name="emb",
                            param=pc(name="shared_emb") if shared
                            else None)
        pooled = dsl.seq_pool(emb, pool_type="average", name="pool")
        dsl.fc(pooled, size=classes, act="softmax", name="out")
        g.conf.output_layer_names.append("out")
    return g.conf


def _confs(pkg, kind):
    dsl, pc, text = ((jdsl, JPC, jtext) if pkg == "jax"
                     else (tdsl, TPC, ttext))
    if kind == "scorers":
        return {"a": _scorer(dsl, pc, 3, False),
                "b": _scorer(dsl, pc, 5, False)}
    if kind == "shared":
        return {"a": _scorer(dsl, pc, 3, True),
                "b": _scorer(dsl, pc, 4, True)}
    if kind == "lstm":
        return {n: text.stacked_lstm_classifier(
            vocab_size=50, emb_dim=8, hidden=8, num_layers=2,
            num_classes=c) for n, c in (("a", 2), ("b", 3))}
    # a recurrent group (the generic attention decoder) beside a scorer
    return {"s2s": text.seq2seq_attention(src_vocab=30, trg_vocab=30,
                                          emb_dim=8, hidden=8),
            "cls": _scorer(dsl, pc, 3, True)}


@pytest.mark.parametrize("kind", ["scorers", "shared", "lstm", "group"])
@pytest.mark.parametrize("share", [True, False])
def test_merge_confs_equal_to_jax(kind, share):
    got = tmn.merge_confs(_confs("torch", kind), share_params=share)
    want = jmn.merge_confs(_confs("jax", kind), share_params=share)
    assert got.to_json() == want.to_json()
    names = [lc.name for lc in got.layers]
    assert all("/" in n for n in names)
    feed = {"w": 1, "x": 2}
    assert tmn.prefix_feed("a", feed) == jmn.prefix_feed("a", feed) == {
        "a/w": 1, "a/x": 2}


def _hosts(kind):
    """The port's host from a seeded generator on the CPU, and the JAX
    host on the same merged parameters."""
    th = tmodels.MultiForwardHost(
        _confs("torch", kind),
        generator=torch.Generator().manual_seed(SEED), device="cpu")
    jh = jmodels.MultiForwardHost(
        _confs("jax", kind),
        params={k: jnp.asarray(v.numpy()) for k, v in th.params.items()})
    assert sorted(th.params) == sorted(jh.net.init_params(
        __import__("jax").random.key(0)))
    return th, jh


def _packed(names, seed, vocab):
    rng = np.random.default_rng(seed)
    out = {}
    for i, name in enumerate(names):
        b, t = 3 + i, 6 + 2 * i
        lens = rng.integers(1, t + 1, b).astype(np.int32)
        ids = np.zeros((b, t), np.int32)
        for r in range(b):
            ids[r, :lens[r]] = rng.integers(1, vocab, lens[r])
        out[name] = (ids, lens)
    return out


def _close(got, want):
    scale = max(1.0, max(abs(x) for r in want for x in r["scores"]))
    for g, w in zip(got, want):
        np.testing.assert_allclose(g["scores"], w["scores"], rtol=0,
                                   atol=TOL * scale)


@pytest.mark.parametrize("kind,vocab", [("scorers", 20), ("shared", 20),
                                        ("lstm", 50)])
def test_multi_forward_host_scores_equal_jax(kind, vocab):
    th, jh = _hosts(kind)
    assert [g.label for g in th.recompile_guards] == ["serve_forward"]
    packed = _packed(th.names, SEED, vocab)
    got, want = th.run_group(packed), jh.run_group(packed)
    assert set(got) == set(want) == set(th.names)
    for name in th.names:
        assert len(got[name]) == len(packed[name][0])
        assert all(r["path"] == "device" for r in got[name])
        _close(got[name], want[name])
    # one submodel alone (its sibling gets the 1-row zero feed)
    alone = th.sub("a").run_batch(*packed["a"], None, False)
    _close(alone, want["a"])
    assert [r["scores"] for r in alone] == [r["scores"] for r in got["a"]]


def _serve_scores(host, server_mod, reqs, batch=4):
    srv = server_mod.InferenceServer(server_mod.ServeConfig(
        max_queue=64, max_batch=batch, default_deadline_s=120.0))
    for name in host.names:
        srv.add_model(name, host.sub(name))
    try:
        pend = [(n, srv.submit(n, ids)) for n, ids in reqs]
        out = [(n, p.result(timeout=120)) for n, p in pend]
        return out, srv.stats()
    finally:
        srv.shutdown(drain=True)


def test_codispatch_serves_each_model_as_alone():
    """Three requests a model, queued before the worker looks: the
    second model's batch joins the first's dispatch, and every answer
    equals the model served alone and the JAX server's answer."""
    th, jh = _hosts("lstm")
    rng = np.random.default_rng(SEED + 1)
    reqs = [(n, rng.integers(1, 50, int(rng.integers(2, 9))).tolist())
            for n in ("a", "b") for _ in range(3)]
    got, st = _serve_scores(th, tserver, reqs)
    want, _ = _serve_scores(jh, jserver, reqs)
    assert st["batches_codispatch"] >= 1
    for (n, g), (_, w), (_, ids) in zip(got, want, reqs):
        _close([g], [w])
        lone = th.sub(n).run_batch(np.asarray([ids], np.int32),
                                   np.asarray([len(ids)], np.int32),
                                   None, False)[0]
        np.testing.assert_allclose(g["scores"], lone["scores"], rtol=0,
                                   atol=1e-6)


@pytest.fixture
def rings():
    """Ring-only recorders on both packages' global registries."""
    trec = tfr.enable_flight_recorder(min_interval_s=3600.0)
    jrec = jfr.enable_flight_recorder(min_interval_s=3600.0)
    try:
        yield trec, jrec
    finally:
        tfr.disable_flight_recorder()
        jfr.disable_flight_recorder()


class _Toy:
    can_host = False
    engine = None
    named_hooks = {}

    def __init__(self, delay_s=0.002, fail=False):
        self.delay_s = delay_s
        self.fail = fail

    def run_batch(self, ids, lens, hooks, host):
        time.sleep(self.delay_s)
        if self.fail:
            raise RuntimeError("poisoned")
        return [{"tokens": [int(lens[i])], "score": 0.0}
                for i in range(ids.shape[0])]


def _script(server_mod):
    srv = server_mod.InferenceServer(server_mod.ServeConfig(
        max_queue=16, max_batch=1, breaker_threshold=3,
        breaker_reset_s=60.0, default_deadline_s=30.0))
    srv.add_model("ok", _Toy())
    srv.add_model("bad", _Toy(fail=True))
    outcomes = []
    try:
        for i in range(45):
            outcomes.append(srv.submit("ok", [1, 2]).result(30)["tokens"])
        for i in range(5):
            try:
                srv.submit("bad", [1]).result(30)
                outcomes.append("done")
            except server_mod.ServeRejected as e:
                outcomes.append(e.reason)
            except server_mod.ServeError:
                outcomes.append("error")
    finally:
        srv.shutdown(drain=True)
    return outcomes, srv.stats()


def _serving_events(rec, timeout=10.0):
    deadline = time.monotonic() + timeout
    evs = []
    while time.monotonic() < deadline:
        evs = [(e["event"], e.get("model")) for e in rec.snapshot()
               if e.get("kind") == "serving"]
        if ("breaker_open", "bad") in evs:
            break
        time.sleep(0.01)
    return evs


def test_anomaly_events_equal_jax_server(rings, monkeypatch):
    trec, jrec = rings
    for flags in (tflags, jflags):
        monkeypatch.setitem(flags._flags, "serve_p99_slo_ms", 0.001)
    got = _script(tserver)
    want = _script(jserver)
    assert got[0] == want[0]
    assert got[0][-5:] == ["error"] * 3 + ["quarantined"] * 2
    assert {k: v for k, v in got[1].items() if k != "models"} == {
        k: v for k, v in want[1].items() if k != "models"}
    tev, jev = _serving_events(trec), _serving_events(jrec)
    assert tev == jev
    assert tev.count(("slo_breach", None)) == 2
    assert tev[-1] == ("breaker_open", "bad")
    # the p99 and the SLO ride the event
    slo = [e for e in trec.snapshot() if e.get("event") == "slo_breach"]
    assert slo[0]["slo_ms"] == 0.001 and slo[0]["p99_ms"] > 0.001


@pytest.mark.parametrize("pattern", ["spike", "calm", "few"])
def test_anomaly_watch_equal_jax(rings, monkeypatch, pattern):
    trec, jrec = rings
    for flags in (tflags, jflags):
        monkeypatch.setitem(flags._flags, "serve_shed_window_s", 3600.0)
    tw, jw = tserver._AnomalyWatch(), jserver._AnomalyWatch()
    n = {"spike": 30, "calm": 30, "few": 10}[pattern]
    for w in (tw, jw):
        for i in range(n):
            w.admission(shed=(i % 5 < 3) if pattern != "calm"
                        else i % 5 == 0)
        w._win_start -= 7200.0  # the window has closed
        w.admission(shed=True)
    tev = [(e["event"], e.get("shed_rate"), e.get("decisions"))
           for e in trec.snapshot() if e.get("kind") == "serving"]
    jev = [(e["event"], e.get("shed_rate"), e.get("decisions"))
           for e in jrec.snapshot() if e.get("kind") == "serving"]
    assert tev == jev
    assert bool(tev) == (pattern == "spike")


class _Rescued:
    """Fails its device dispatch `fail` times (its host rung too when
    `host_fails`)."""

    engine = None
    named_hooks = {}

    def __init__(self, can_host=True, fail=1, host_fails=False):
        self.can_host = can_host
        self.fail = fail
        self.host_fails = host_fails
        self.calls = []

    def run_batch(self, ids, lens, hooks, host):
        self.calls.append(host)
        if host and self.host_fails:
            raise RuntimeError("host rung failed too")
        if not host and self.fail:
            self.fail -= 1
            raise RuntimeError("device dispatch failed")
        return [{"tokens": [int(lens[i])], "score": 1.0}
                for i in range(ids.shape[0])]


def _failures():
    return tom.get_registry().counter("serving.dispatch_failures").get(
        model="r")


@pytest.mark.parametrize("case", ["rescued", "host_fails", "no_fallback",
                                  "cannot_host"])
def test_rescue_counts_the_device_failure_once(case):
    model = _Rescued(can_host=case != "cannot_host",
                     host_fails=case == "host_fails")
    srv = tserver.InferenceServer(tserver.ServeConfig(
        max_queue=8, max_batch=4, breaker_threshold=3,
        host_fallback=case != "no_fallback"))
    srv.add_model("r", model)
    before = _failures()
    try:
        p = srv.submit("r", [1, 2, 3])
        if case == "rescued":
            out = p.result(30)
            assert out["path"] == "host" and out["tokens"] == [3]
        else:
            with pytest.raises(tserver.ServeError):
                p.result(30)
        st = srv.stats()
    finally:
        srv.shutdown(drain=True)
    assert _failures() - before == 1
    rescued = case in ("rescued", "host_fails")
    assert model.calls == ([False, True] if rescued else [False])
    assert st["completed_host"] == (1 if case == "rescued" else 0)
    assert st["failed"] == (0 if case == "rescued" else 1)
    # a success after the rescue closes the count: the breaker saw one
    # failure and stays closed
    assert st["models"]["r"]["breaker"] == "closed"


def test_generation_model_rescue_equals_device_decode():
    """A GenerationModel whose device `generate` raises once: the
    request is answered by the host rung with the tokens of a device
    decode of the same request."""
    vocab, pname = 10, "rescue_bigram"

    def step(word):
        emb = tdsl.embedding(word, size=vocab, vocab_size=vocab,
                             param=TPC(name=pname))
        return tdsl.mixed(vocab, [(emb, "identity")], act="softmax",
                          bias=False, name="prob")

    rng = np.random.default_rng(SEED)
    params = {pname: torch.from_numpy(
        (rng.standard_normal((vocab, vocab)) * 2).astype(np.float32))}
    dec = BeamSearchDecoder(step, n_static=0, bos_id=0, eos_id=1,
                            beam_size=3, max_length=8)

    class FailOnce:
        def __init__(self, inner):
            self.inner = inner
            self.failed = 0

        def __getattr__(self, name):
            return getattr(self.inner, name)

        def generate(self, *a, **k):
            if not self.failed:
                self.failed += 1
                raise RuntimeError("device decode failed")
            return self.inner.generate(*a, **k)

    model = tmodels.GenerationModel(FailOnce(dec), params)
    srv = tserver.InferenceServer(tserver.ServeConfig(
        max_queue=8, max_batch=2, buckets=(4,), default_deadline_s=60.0))
    srv.add_model("gen", model)
    before = tom.get_registry().counter("serving.dispatch_failures").get(
        model="gen")
    try:
        out = srv.submit("gen", [2, 3]).result(60)
        again = srv.submit("gen", [2, 3]).result(60)
        st = srv.stats()
    finally:
        srv.shutdown(drain=True)
    assert out["path"] == "host" and again["path"] == "jit"
    seqs, lens, _ = (x.numpy() for x in dec.generate(params, [],
                                                    batch_size=1))
    assert out["tokens"] == seqs[0, 0, :lens[0, 0]].tolist()
    assert again["tokens"] == out["tokens"]
    assert tom.get_registry().counter("serving.dispatch_failures").get(
        model="gen") - before == 1
    assert st["completed_host"] == 1 and st["failed"] == 0


def _flightz(tcp_mod, server_mod, rec_mod, om):
    om.get_registry().event("serving", event="slo_breach", p99_ms=3.0)
    om.get_registry().event("span", name="serve.request", trace_id="t",
                            span_id="s", parent_id="", dur_s=0.1)
    srv = server_mod.InferenceServer(server_mod.ServeConfig())
    front = tcp_mod.ServingTCPServer(srv)
    try:
        with tcp_mod.ServeClient(f"127.0.0.1:{front.port}") as c:
            return c.flightz(timeout=10)
    finally:
        front.stop()
        srv.shutdown(drain=False)


def test_flightz_frame_equal_jax(rings):
    got = _flightz(ttcp, tserver, tfr, tom)
    want = _flightz(jtcp, jserver, jfr, jom)
    g, w = got["flightz"], want["flightz"]
    assert got["ok"] and g["enabled"] and g["capacity"] == w["capacity"]
    assert g["pid"] > 0
    strip = [{k: v for k, v in e.items() if k != "ts"} for e in g["events"]]
    assert strip == [{k: v for k, v in e.items() if k != "ts"}
                     for e in w["events"]]
    assert [e["kind"] for e in g["events"]][-2:] == ["serving", "span"]


def test_flightz_without_recorder():
    assert tfr.get_flight_recorder() is None
    srv = tserver.InferenceServer(tserver.ServeConfig())
    front = ttcp.ServingTCPServer(srv)
    try:
        with ttcp.ServeClient(f"127.0.0.1:{front.port}",
                              admin_timeout=5.0) as c:
            resp = c.flightz()
    finally:
        front.stop()
        srv.shutdown(drain=False)
    assert resp["ok"] and resp["flightz"]["enabled"] is False
    assert resp["flightz"]["events"] == [] and resp["flightz"][
        "capacity"] == 0
