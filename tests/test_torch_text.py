"""The port's sequence slice against the JAX package's, on the CPU.

Each conf is built twice from one description — once through
`paddle_tpu.dsl`, once through the port's copy — and both networks run
on the same numpy parameters and feed (numpy seeds; B = 5, T = 13,
lengths with a 0 and a 1). f32 on the CPU in both. The port's RNN layers
run both of their arms: the sequence kernels' path (`use_pallas_rnn =
True`, which on a CPU tensor runs the kernels' plain versions through
the custom ops) and the masked scan (`False`); the JAX layers
run their scan.

- Each new layer type — lstmemory and grumemory (forward and reversed,
  and an lstmemory with a non-default activation, which takes the scan
  on either arm), recurrent, seqpool (sum, average, sqrt_average, max),
  seqlastins (last, first), expand, concat, scaling and a
  recurrent_group with a boot layer and a static link (forward and
  reversed) — within 1e-5 (atol) of the JAX layer.
- The IMDB stacked-LSTM classifier, the attention NMT and the
  bidirectional LSTM tagger at narrow widths, the classifier at the
  bench's hidden 512, and the NMT at hidden 1024 and 2000 (encoder GRUs
  of h = 512 and RNNsearch's 1000, where B7 and B8 take the grid route
  on the card; small vocab, B and T): the loss (rtol 1e-4) and every
  gradient (1e-4 of its largest entry) on both arms, and three adam
  steps of `SGD.train` (the costs, rtol 1e-4, and every parameter after
  them; at the classifier's hidden 512 within the port's own f64 noise,
  at the NMT's hidden 1024 in f64 in both packages), against the JAX
  `Network` and `SGD`.
- `Inferencer` of the classifier against the JAX `Inferencer`; the
  flag's policy; the step net's context; the flat JAX parameter names
  (the GRU's `_{name}.wc`, a group's renamed step parameters) carried
  by `params_from_numpy`; the parts once missing (the nested document
  classifier, a strided seqpool) equal the JAX confs, and the generation
  decoder (ported) decodes the JAX decoder's tokens from the trained
  conf's parameters.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from paddle_tpu import dsl as jdsl
from paddle_tpu.core import arg as jarg
from paddle_tpu.core.config import OptimizationConf as JOptConf
from paddle_tpu.models import text as jtext
from paddle_tpu.network import Network as JNetwork
from paddle_tpu.trainer.events import EndIteration as JEnd
from paddle_tpu.trainer.trainer import SGD as JSGD
from paddle_tpu.trainer.trainer import Inferencer as JInferencer
from paddle_tpu_torch import dsl as tdsl
from paddle_tpu_torch.core import arg as targ
from paddle_tpu_torch.core import flags as tflags
from paddle_tpu_torch.core.config import OptimizationConf as TOptConf
from paddle_tpu_torch.models import text as ttext
from paddle_tpu_torch.network import Network as TNetwork
from paddle_tpu_torch.ops import rnn
from paddle_tpu_torch.trainer.events import EndIteration as TEnd
from paddle_tpu_torch.trainer.trainer import SGD as TSGD
from paddle_tpu_torch.trainer.trainer import Inferencer as TInferencer
from paddle_tpu_torch.weights import params_from_numpy, params_to_numpy

B, T, HID = 5, 13, 6
LENS = np.asarray([13, 0, 1, 7, 12], np.int32)
LAYER_TOL = 1e-5
NET_TOL = 1e-4
ARMS = {"kernels": True, "scan": False}


@pytest.fixture(params=sorted(ARMS))
def arm(request):
    tflags.set_flag("use_pallas_rnn", ARMS[request.param])
    yield request.param
    tflags.reset_flags()


def _rel(got, ref):
    got, ref = np.asarray(got), np.asarray(ref)
    assert got.shape == ref.shape
    return float(np.abs(got - ref).max()) / max(float(np.abs(ref).max()),
                                                1e-30)


def _np_params(jnet, seed):
    """The JAX init, with 1-D parameters (biases, peepholes) perturbed
    so that they are not trivially 0."""
    rng = np.random.default_rng(seed)
    out = {}
    for k, v in jnet.init_params(jax.random.key(seed)).items():
        v = np.asarray(v)
        if v.ndim == 1:
            v = v + 0.3 * rng.standard_normal(v.shape).astype(np.float32)
        out[k] = v
    return out


# ---- single layers -------------------------------------------------------

def _group(dsl, seq, vec, reverse):
    """A recurrent_group over `seq` with a memory booted from a parent
    layer, a static link (the whole `seq` pooled in the step) and an
    unnamed step layer (its parameters take the group's prefix)."""
    boot = dsl.fc(vec, size=HID, act="tanh", name="boot")

    def step(x_t, enc):
        prev = dsl.memory("state", size=HID, boot_layer=boot)
        pooled = dsl.seq_pool(enc, pool_type="average", name="pooled")
        mix = dsl.fc(x_t, prev, size=HID, act="tanh")
        return dsl.fc(mix, pooled, size=HID, act="tanh", name="state")

    return dsl.recurrent_group(step, [seq, dsl.StaticInput(seq)],
                               name="out", reversed=reverse)


def _layer_conf(dsl, kind):
    """A small conf whose layer `out` is of the kind under test."""
    with dsl.model() as g:
        seq = dsl.data("seq", 4 * HID, is_seq=True)
        vec = dsl.data("vec", HID)
        one = dsl.data("one", 1, is_seq=True)
        if kind.startswith("lstm"):
            dsl.lstmemory(seq, HID, name="out", reversed=kind == "lstm_rev",
                          act="relu" if kind == "lstm_relu" else "tanh")
        elif kind.startswith("gru"):
            x = dsl.fc(seq, size=3 * HID, name="proj")
            dsl.grumemory(x, HID, name="out", reversed=kind == "gru_rev")
        elif kind.startswith("recurrent_"):
            x = dsl.fc(seq, size=HID, name="proj")
            dsl.recurrent(x, HID, name="out",
                          reversed=kind == "recurrent_rev")
        elif kind.startswith("seqpool_"):
            dsl.seq_pool(seq, pool_type=kind[len("seqpool_"):], name="out")
        elif kind in ("last_seq", "first_seq"):
            getattr(dsl, kind)(seq, name="out")
        elif kind == "expand":
            dsl.expand(vec, seq, name="out")
        elif kind == "concat":
            dsl.concat(seq, dsl.fc(seq, size=3, name="proj"), name="out")
        elif kind == "scaling":
            dsl.scaling(one, seq, name="out")
        elif kind.startswith("group"):
            _group(dsl, seq, vec, reverse=kind == "group_rev")
        else:
            raise ValueError(kind)
    return g.conf


LAYER_KINDS = ["lstm_fwd", "lstm_rev", "lstm_relu", "gru_fwd", "gru_rev",
               "recurrent_fwd", "recurrent_rev", "seqpool_sum",
               "seqpool_average", "seqpool_sqrt_average", "seqpool_max",
               "last_seq", "first_seq", "expand", "concat", "scaling",
               "group_fwd", "group_rev"]


def _layer_feeds(seed=0):
    rng = np.random.default_rng(seed)
    seq = rng.standard_normal((B, T, 4 * HID)).astype(np.float32)
    seq *= (np.arange(T)[None, :, None] < LENS[:, None, None])
    vec = rng.standard_normal((B, HID)).astype(np.float32)
    one = rng.standard_normal((B, T, 1)).astype(np.float32)
    jf = {"seq": jarg.seq(jnp.asarray(seq), LENS),
          "vec": jarg.non_seq(jnp.asarray(vec)),
          "one": jarg.seq(jnp.asarray(one), LENS)}
    tf = {"seq": targ.seq(seq, LENS), "vec": targ.non_seq(vec),
          "one": targ.seq(one, LENS)}
    return jf, tf


@pytest.mark.parametrize("kind", LAYER_KINDS)
def test_layer_matches_jax(kind, arm):
    jnet, tnet = (JNetwork(_layer_conf(jdsl, kind)),
                  TNetwork(_layer_conf(tdsl, kind)))
    assert {k: tuple(p.dims) for k, p in tnet.param_confs.items()} == {
        k: tuple(p.dims) for k, p in jnet.param_confs.items()}
    np_p = _np_params(jnet, 0)
    jf, tf = _layer_feeds()
    jout = jnet.forward({k: jnp.asarray(v) for k, v in np_p.items()}, jf,
                        outputs=["out"])[0]["out"]
    tout = tnet.forward(params_from_numpy(np_p, device="cpu"), tf,
                        outputs=["out"])[0]["out"]
    np.testing.assert_allclose(tout.value.numpy(), np.asarray(jout.value),
                               atol=LAYER_TOL, err_msg=kind)
    assert (tout.seq_lens is None) == (jout.seq_lens is None)


# ---- the models ----------------------------------------------------------

CONFS = {
    "classifier": ("stacked_lstm_classifier",
                   dict(vocab_size=50, emb_dim=8, hidden=16)),
    "nmt": ("seq2seq_attention",
            dict(src_vocab=40, trg_vocab=30, emb_dim=8, hidden=16)),
    "tagger": ("bidi_lstm_tagger", dict(vocab_size=50, emb_dim=8, hidden=16)),
}
# the bench rows' optimizers (bench.py bench_lstm, bench_nmt)
# bench_lstm's hidden 512 (on the card: the grid route of B5 and B6), and
# the NMT at hidden 1024 and 2000 (encoder GRUs of h = 512 and 1000 a
# direction, RNNsearch's width: on the card the grid route of B7 and B8),
# at a small vocab, B and T
WIDE = {"classifier_h512": ("stacked_lstm_classifier",
                            dict(vocab_size=50, emb_dim=8, hidden=512)),
        "nmt_h1024": ("seq2seq_attention",
                      dict(src_vocab=40, trg_vocab=30, emb_dim=8,
                           hidden=1024)),
        "nmt_h2000": ("seq2seq_attention",
                      dict(src_vocab=40, trg_vocab=30, emb_dim=8,
                           hidden=2000))}
ADAM = {"classifier": 2e-3, "classifier_h512": 2e-3, "nmt": 1e-3,
        "nmt_h1024": 1e-3, "nmt_h2000": 1e-3, "tagger": 2e-3}


def _confs(name):
    fn, kw = {**CONFS, **WIDE}[name]
    return getattr(jtext, fn)(**kw), getattr(ttext, fn)(**kw)


def _batch(name, seed):
    """Numpy ids for one batch of conf `name` (the NMT's lengths have no
    0: its decoder boots from the first step of the reversed encoder)."""
    rng = np.random.default_rng(seed)
    if name == "classifier_h512":
        # every row at least one step long: an empty row max-pools to -1e30
        # (the JAX semantics, held at hidden 16), a loss of ~1e29 that
        # would drown the recurrent weights' gradients this case holds
        return {"words": (rng.integers(0, 50, (B, T)), np.maximum(LENS, 1)),
                "label": (rng.integers(0, 2, B), None)}
    if name == "classifier":
        return {"words": (rng.integers(0, 50, (B, T)), LENS),
                "label": (rng.integers(0, 2, B), None)}
    if name == "tagger":
        return {"words": (rng.integers(0, 50, (B, T)), LENS),
                "tags": (rng.integers(0, 9, (B, T)), LENS)}
    lens = np.maximum(LENS, 1)
    return {k: (rng.integers(2, 30, (B, T)), lens)
            for k in ("src", "trg_in", "trg_out")}


def _jfeed(batch):
    return {k: jarg.id_arg(ids.astype(np.int32), lens)
            for k, (ids, lens) in batch.items()}


def _tfeed(batch):
    return {k: targ.id_arg(ids.astype(np.int32), lens)
            for k, (ids, lens) in batch.items()}


@pytest.mark.parametrize("name", sorted(CONFS) + sorted(WIDE))
def test_conf_loss_and_gradients_match_jax(name, arm):
    jconf, tconf = _confs(name)
    jnet, tnet = JNetwork(jconf), TNetwork(tconf)
    np_p = _np_params(jnet, 1)
    batch = _batch(name, 2)
    (jloss, _aux), jgrads = jax.value_and_grad(jnet.loss_fn, has_aux=True)(
        {k: jnp.asarray(v) for k, v in np_p.items()}, _jfeed(batch))
    tp = {k: v.requires_grad_(True)
          for k, v in params_from_numpy(np_p, device="cpu").items()}
    tloss, _ = tnet.loss_fn(tp, _tfeed(batch))
    tloss.backward()
    np.testing.assert_allclose(tloss.item(), float(jloss), rtol=NET_TOL)
    assert sorted(jgrads) == sorted(tp)
    for k, g in jgrads.items():
        err = _rel(tp[k].grad.numpy(), g)
        assert err <= NET_TOL, f"{name} grad {k}: {err:.3g}"


def _train(trainer, batches, feeder, end_cls):
    costs = []
    trainer.train(reader=lambda: iter(batches), feeder=feeder, num_passes=1,
                  event_handler=lambda e: costs.append(e.cost)
                  if isinstance(e, end_cls) else None)
    return np.asarray(costs)


@pytest.mark.parametrize("name", sorted(CONFS))
def test_sgd_adam_steps_match_jax(name, arm):
    jconf, tconf = _confs(name)
    p0 = _np_params(JNetwork(jconf), 3)
    opt = dict(learning_method="adam", learning_rate=ADAM[name])
    batches = [_batch(name, 10 + i) for i in range(3)]
    jt = JSGD(jconf, JOptConf(**opt), seed=1,
              params={k: jnp.asarray(v) for k, v in p0.items()})
    tt = TSGD(tconf, TOptConf(**opt), seed=1,
              params=params_from_numpy(p0, device="cpu"), device="cpu")
    jcosts = _train(jt, batches, _jfeed, JEnd)
    tcosts = _train(tt, batches, _tfeed, TEnd)
    assert np.isfinite(tcosts).all() and len(tcosts) == 3
    np.testing.assert_allclose(tcosts, jcosts, rtol=NET_TOL)
    for k, v in params_to_numpy(tt.params).items():
        assert _rel(v, jt.params[k]) <= NET_TOL, k


def test_sgd_adam_steps_match_jax_at_the_bench_width(arm):
    """Three adam steps of the classifier at hidden 512 through `SGD.train`
    against the JAX `SGD`, as test_sgd_adam_steps_match_jax: the costs
    within rtol NET_TOL, and every parameter within NET_TOL of its largest
    entry plus twice the port's own f32 noise there (its distance from
    the same steps in f64: adam divides near-zero gradient components by
    their own size, and 512-wide sums round differently in the two
    packages, ~7e-5 after three steps), the rule of the chip smoke's held
    step. The port's f32 run must also be as close to its f64 run as the
    JAX run is, within NET_TOL."""
    run = _adam_runs("classifier_h512")
    p64 = run["port64"]
    for k, v in run["port"].items():
        noise = _rel(v, p64[k])
        assert _rel(v, run["jax"][k]) <= NET_TOL + 2 * noise, (k, noise)
        assert noise <= NET_TOL + _rel(run["jax"][k], p64[k]), k


def test_sgd_adam_steps_match_jax_at_the_nmt_width(arm):
    """Three adam steps of the NMT at hidden 1024 (encoder GRUs of h =
    512, the grid route's width on the card) through `SGD.train` against
    the JAX `SGD`. In f64 in both packages, where adam's f32 noise is
    gone, every parameter within NET_TOL of the JAX run's (~3e-5) and the
    costs within rtol NET_TOL. In f32 the costs within rtol NET_TOL, and
    the port's run as close to the JAX f64 run as the JAX f32 run is,
    within NET_TOL: at this width adam's division by near-zero second
    moments moves the decoder's boot and state weights by up to ~2e-3 in
    either package's f32, in directions of their own, so the two f32
    runs are held each against f64 and not against each other."""
    run = _adam_runs("nmt_h1024", jax64=True)
    np.testing.assert_allclose(run["port64_costs"], run["jax64_costs"],
                               rtol=NET_TOL)
    j64 = run["jax64"]
    for k, v in run["port64"].items():
        assert _rel(v, j64[k]) <= NET_TOL, (k, _rel(v, j64[k]))
    for k, v in run["port"].items():
        err, jerr = _rel(v, j64[k]), _rel(run["jax"][k], j64[k])
        assert err <= NET_TOL + jerr, (k, err, jerr)


def _adam_runs(name, jax64=False):
    """Three adam steps of conf `name` from one set of parameters in the
    port (f32 and f64) and in JAX (f32, and f64 if `jax64`), the f32
    costs held within rtol NET_TOL; returns each run's parameters as
    numpy (`port`, `port64`, `jax`, `jax64`) and the f64 runs' costs."""
    jconf, tconf = _confs(name)
    p0 = _np_params(JNetwork(jconf), 3)
    opt = dict(learning_method="adam", learning_rate=ADAM[name])
    batches = [_batch(name, 10 + i) for i in range(3)]
    jt = JSGD(jconf, JOptConf(**opt), seed=1,
              params={k: jnp.asarray(v) for k, v in p0.items()})
    tt = TSGD(tconf, TOptConf(**opt), seed=1,
              params=params_from_numpy(p0, device="cpu"), device="cpu")
    t64 = TSGD(tconf, TOptConf(**opt), seed=1,
               params={k: v.double() for k, v in params_from_numpy(
                   p0, device="cpu").items()}, device="cpu")
    jcosts = _train(jt, batches, _jfeed, JEnd)
    tcosts = _train(tt, batches, _tfeed, TEnd)
    out = {"port64_costs": _train(t64, batches, _tfeed, TEnd)}
    assert np.isfinite(tcosts).all() and len(tcosts) == 3
    np.testing.assert_allclose(tcosts, jcosts, rtol=NET_TOL)
    out["port"] = params_to_numpy(tt.params)
    out["port64"] = {k: v.detach().numpy() for k, v in t64.params.items()}
    out["jax"] = {k: np.asarray(v) for k, v in jt.params.items()}
    if jax64:
        with jax.enable_x64(True):
            j64 = JSGD(jconf, JOptConf(**opt), seed=1, params={
                k: jnp.asarray(v, jnp.float64) for k, v in p0.items()})
            out["jax64_costs"] = _train(j64, batches, _jfeed, JEnd)
            out["jax64"] = {k: np.asarray(v) for k, v in j64.params.items()}
        assert {str(v.dtype) for v in out["jax64"].values()} == {"float64"}
    assert {str(v.dtype) for v in out["port64"].values()} == {"float64"}
    return out


def test_classifier_inference_matches_jax(arm):
    jconf, tconf = _confs("classifier")
    np_p = _np_params(JNetwork(jconf), 4)
    batch = _batch("classifier", 5)
    words = {"words": batch["words"]}
    want = JInferencer(JNetwork(jconf),
                       {k: jnp.asarray(v) for k, v in np_p.items()},
                       outputs=["output"]).infer(_jfeed(words))["output"]
    got = TInferencer(TNetwork(tconf), params_from_numpy(np_p, device="cpu"),
                      outputs=["output"], device="cpu").infer(
        _tfeed(words))["output"]
    assert got.shape == (B, 2)
    # the empty row pools to -1e30 (seq_max's padding): rtol holds it
    np.testing.assert_allclose(got, want, rtol=LAYER_TOL, atol=LAYER_TOL)


@pytest.mark.parametrize("flag,grad,engaged", [
    (None, True, False), (True, True, True), (True, False, True),
    (False, True, False)])
def test_flag_policy_on_the_cpu(monkeypatch, flag, grad, engaged):
    """None takes the scan for a CPU input (the kernels only for a CUDA
    one), True the kernels' path (here: their plain versions), False
    always the scan — and both give the same output."""
    calls = []
    for fn in ("lstm_fused", "gru_fused"):
        real = getattr(rnn, fn)
        monkeypatch.setattr(rnn, fn, lambda *a, _r=real: (
            calls.append(1), _r(*a))[1])
    net = TNetwork(_layer_conf(tdsl, "gru_rev"))
    np_p = _np_params(JNetwork(_layer_conf(jdsl, "gru_rev")), 6)
    _jf, tf = _layer_feeds(7)
    tflags.set_flag("use_pallas_rnn", flag)
    try:
        p = params_from_numpy(np_p, device="cpu")
        with torch.set_grad_enabled(grad):
            got = net.forward({k: v.requires_grad_(grad) for k, v in
                               p.items()}, tf)[0]["out"].value
        tflags.set_flag("use_pallas_rnn", False)
        ref = net.forward(params_from_numpy(np_p, device="cpu"), tf)[0]["out"]
    finally:
        tflags.reset_flags()
    assert bool(calls) == engaged
    torch.testing.assert_close(got.detach(), ref.value, atol=1e-6, rtol=1e-6)


def test_step_net_runs_with_the_parent_ctx(monkeypatch):
    net = TNetwork(_layer_conf(tdsl, "group_fwd"))
    step_net = net.layers["out"].step_net
    seen = []
    real = step_net.forward

    def spy(params, feed, **kw):
        seen.append((kw["train"], kw["rng"]))
        return real(params, feed, **kw)

    monkeypatch.setattr(step_net, "forward", spy)
    gen = torch.Generator().manual_seed(5)
    p = net.init_params(torch.Generator().manual_seed(0), device="cpu")
    net.forward(p, _layer_feeds()[1], train=True, rng=gen)
    assert len(seen) == T and all(t is True and r is gen for t, r in seen)


def test_params_from_numpy_keeps_the_flat_jax_names():
    """The GRU's candidate weight `_{name}.wc` and a group's renamed
    auto-named step parameters (`_{group}.___fc_0__.w0`) have the same
    flat names and shapes in both packages, and params_from_numpy
    carries each value under its name."""
    _jc, tconf = _confs("nmt")
    jnet, tnet = JNetwork(_jc), TNetwork(tconf)
    for jn, tn in ((jnet, tnet), (JNetwork(_layer_conf(jdsl, "group_fwd")),
                                  TNetwork(_layer_conf(tdsl, "group_fwd")))):
        assert {k: tuple(p.dims) for k, p in tn.param_confs.items()} == {
            k: tuple(p.dims) for k, p in jn.param_confs.items()}
        np_p = _np_params(jn, 8)
        back = params_to_numpy(params_from_numpy(np_p, device="cpu"))
        for k, v in np_p.items():
            np.testing.assert_array_equal(back[k], v)
    assert {"_enc_fwd.wc", "_enc_bwd.wc"} <= set(tnet.param_confs)
    group = TNetwork(_layer_conf(tdsl, "group_fwd"))
    renamed = [k for k in group.param_confs if k.startswith("_out.___")]
    assert renamed and not any(k.startswith("___") for k in group.param_confs)


def test_parts_still_to_port_raise():
    """The parts this test once found missing are ported: the nested
    document classifier and a strided seqpool now equal the JAX confs
    (loss; outputs and lengths), and the generation decoder decodes the
    JAX decoder's tokens from the trained conf's parameters."""
    jnet = JNetwork(jtext.hierarchical_lstm_classifier())
    tnet = TNetwork(ttext.hierarchical_lstm_classifier())
    np_p = _np_params(jnet, 6)
    rng = np.random.default_rng(6)
    sub = np.asarray([[3, 0, 4], [2, 2, 2], [1, 0, 0]], np.int32)
    ids = rng.integers(0, 1000, (3, 7)) * (
        np.arange(7)[None, :] < sub.sum(axis=1)[:, None])
    label = rng.integers(0, 2, 3)
    jloss, _ = jnet.loss_fn({k: jnp.asarray(v) for k, v in np_p.items()}, {
        "words": jarg.sub_seq(jnp.asarray(ids, jnp.int32), sub, is_ids=True),
        "label": jarg.id_arg(label.astype(np.int32))})
    with torch.no_grad():
        tloss, _ = tnet.loss_fn(params_from_numpy(np_p, device="cpu"), {
            "words": targ.sub_seq(ids, sub, is_ids=True),
            "label": targ.id_arg(label)})
    np.testing.assert_allclose(tloss.item(), float(jloss), rtol=NET_TOL)
    # the generation decoder is ported (A3a): it takes the trained NMT's
    # parameters by name and decodes the JAX decoder's tokens
    jconf, tconf = _confs("nmt")
    jnet, tnet = JNetwork(jconf), TNetwork(tconf)
    np_p = _np_params(jnet, 4)
    src = _batch("nmt", 5)["src"]
    jo, _ = jnet.forward({k: jnp.asarray(v) for k, v in np_p.items()},
                         {"src": jarg.id_arg(src[0].astype(np.int32),
                                             src[1])},
                         outputs=["enc", "dec_boot"])
    tp = params_from_numpy(np_p, device="cpu")
    with torch.no_grad():
        to, _ = tnet.forward(tp, {"src": targ.id_arg(src[0], src[1])},
                             outputs=["enc", "dec_boot"])
    kw = dict(trg_vocab=30, emb_dim=8, hidden=16, beam_size=3,
              max_length=6)
    jdec = jtext.seq2seq_attention_decoder(**kw)
    tdec = ttext.seq2seq_attention_decoder(**kw)
    assert set(tdec.param_confs([to["enc"]])) == set(
        jdec.param_confs([jo["enc"]])) <= set(tnet.param_confs)
    jseqs, jlens, jscores = jdec.generate(
        {k: jnp.asarray(v) for k, v in np_p.items()}, [jo["enc"]],
        {"dec_state": jo["dec_boot"].value})
    tseqs, tlens, tscores = tdec.generate(
        tp, [to["enc"]], {"dec_state": to["dec_boot"].value})
    np.testing.assert_array_equal(tseqs.numpy(), np.asarray(jseqs))
    np.testing.assert_array_equal(tlens.numpy(), np.asarray(jlens))
    np.testing.assert_allclose(tscores.numpy(), np.asarray(jscores),
                               rtol=0, atol=1e-5)
    outs = []
    for dsl, mod in ((jdsl, jarg), (tdsl, targ)):
        with dsl.model() as g:
            seq = dsl.data("seq", 4, is_seq=True)
            dsl.seq_pool(seq, pool_type="max", stride=2, name="out")
        v = np.random.default_rng(7).standard_normal((B, T, 4)).astype(
            np.float32)
        if mod is jarg:
            out = JNetwork(g.conf).forward(
                {}, {"seq": jarg.seq(jnp.asarray(v), LENS)})[0]["out"]
        else:
            out = TNetwork(g.conf).forward(
                {}, {"seq": targ.seq(v, LENS)})[0]["out"]
        outs.append((np.asarray(out.value), np.asarray(out.seq_lens)))
    (jv, jl), (tv, tl) = outs
    np.testing.assert_array_equal(tl, jl)
    np.testing.assert_allclose(tv, jv, atol=LAYER_TOL)
