"""The port's recurrent_group over nested sequences, and its secondary
out_links, against the JAX package's, on the CPU.

The nets are `tests/test_recurrent_group.py::TestNestedRecurrentGroup`'s
(an inner rnn over one sub-sequence, a memory that chains the last
inner state across sub-sequences) and their variants: a
sequence-valued out_link (packed back into the flat layout), reversed,
`max_subseq_len` truncation, a memory fed from a per-timestep layer
(the last valid frame is carried), an lstmemory in the step (both of
the port's RNN arms: the kernels' plain versions and the masked scan)
and a second out_link, in the nested and in the flat walk. The feed
has a zero-length sub-sequence mid-row, an all-zero `subseq_lens`
column, an empty row and a row whose last sub-sequence ends at T-1
(the pack-back must add, not overwrite). Each built once through each
package's DSL, run on the same numpy parameters and feed: outputs and
lengths, and the gradients of a seeded projection of the outputs with
respect to every parameter and the input, within 1e-5 (atol, f32).

Port-only: the outer steps against a manual split over the plain inner
net, the reversed walk against the forward walk on reversed sub-sequence
order, and no host synchronisation in the walk (`.item()`, `bool()` and
friends raise while it runs).

The two document classifiers — `models/text.py::hierarchical_lstm_classifier`
and the same conf with the sentence encoder an `simple_lstm` (the chip
smoke's phase 21a model) — on both arms: loss (rtol 1e-4), every
gradient (1e-4 of its largest entry) and one adam step through `SGD`
(cost rtol 1e-4, every parameter within 1e-4 of its largest entry).
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
from paddle_tpu_torch import dsl as tdsl
from paddle_tpu_torch.core import arg as targ
from paddle_tpu_torch.core import flags as tflags
from paddle_tpu_torch.core.config import OptimizationConf as TOptConf
from paddle_tpu_torch.models import text as ttext
from paddle_tpu_torch.network import Network as TNetwork
from paddle_tpu_torch.trainer.events import EndIteration as TEnd
from paddle_tpu_torch.trainer.trainer import SGD as TSGD
from paddle_tpu_torch.weights import params_from_numpy, params_to_numpy

H = 4
TOL = 1e-5
NET_TOL = 1e-4
T = 12
SUB = np.asarray([[3, 0, 2, 4, 0],
                  [1, 4, 2, 5, 0],
                  [2, 2, 0, 0, 0],
                  [0, 0, 0, 0, 0]], np.int32)
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


def _x(seed, sub=SUB, h=H):
    rng = np.random.default_rng(seed)
    t = max(T, int(sub.sum(axis=1).max()))
    x = rng.standard_normal((sub.shape[0], t, h)).astype(np.float32)
    return x * (np.arange(t)[None, :, None] < sub.sum(axis=1)[:, None, None])


# ---- the nets --------------------------------------------------------------

def _step(dsl, kind):
    """The step net of case `kind` over one sub-sequence `x_sub`."""

    def step(x_sub):
        if kind == "seq_memory":
            # the memory's source is a sequence: its last valid frame of
            # the sub-sequence is carried
            prev = dsl.memory("proj", size=H)
            e = dsl.expand(prev, x_sub)
            return dsl.fc(x_sub, e, size=H, act="tanh", name="proj")
        boot = dsl.memory("enc", size=H)
        if kind == "lstm":
            inner = dsl.simple_lstm(x_sub, H, name="inner")
        else:
            inner = dsl.recurrent(x_sub, size=H, name="inner", act="tanh",
                                  bias=False)
        if kind == "inner_seq":
            dsl.last_seq(inner, name="enc")
            return inner
        last = dsl.last_seq(inner, name="pre")
        enc = dsl.mixed(H, [(last, "identity"), (boot, "full_matrix")],
                        act="tanh", bias=False, name="enc")
        return (enc, inner) if kind == "extra_outs" else enc

    return step


NESTED = ("last_state", "inner_seq", "reversed", "truncated", "seq_memory",
          "lstm", "extra_outs")


def _nested_conf(dsl, kind):
    with dsl.model() as g:
        x = dsl.data("x", (H,), is_seq=True, has_subseq=True)
        dsl.recurrent_group(_step(dsl, kind), [x], name="outer",
                            reversed=kind == "reversed")
        if kind == "extra_outs":
            # the parent consumes the extra (nested) output
            dsl.seq_pool(dsl.LayerRef("inner", g), "sum", level="subseq",
                         name="pooled")
    if kind == "truncated":
        g.conf.layer("outer").attrs["max_subseq_len"] = 3
    return g.conf


def _flat_extra_conf(dsl):
    """A flat recurrent_group with a second out_link that a parent layer
    reads."""
    with dsl.model() as g:
        x = dsl.data("x", (H,), is_seq=True)

        def step(x_t):
            prev = dsl.memory("state", size=H)
            state = dsl.fc(x_t, prev, size=H, act="tanh", name="state")
            return state, dsl.fc(state, size=2, act="sigmoid", name="aux")

        dsl.recurrent_group(step, [x], name="outer")
        dsl.seq_pool(dsl.LayerRef("aux", g), "max", name="pooled")
    return g.conf


def _outputs(kind):
    if kind == "extra_outs":
        return ["outer", "inner", "pooled"]
    if kind == "flat_extra":
        return ["outer", "aux", "pooled"]
    return ["outer"]


def _parity(jconf, tconf, outputs, jfeed_fn, tfeed_fn, x, seed):
    """Forward outputs and lengths, and every gradient of sum(out * R)
    over the outputs, port against JAX."""
    jnet, tnet = JNetwork(jconf), TNetwork(tconf)
    assert {k: tuple(p.dims) for k, p in tnet.param_confs.items()} == {
        k: tuple(p.dims) for k, p in jnet.param_confs.items()}
    np_p = _np_params(jnet, seed)
    jo = jnet.forward({k: jnp.asarray(v) for k, v in np_p.items()},
                      jfeed_fn(jnp.asarray(x)), outputs=outputs)[0]
    rng = np.random.default_rng(seed + 1)
    rs = {o: rng.standard_normal(jo[o].value.shape).astype(np.float32)
          for o in outputs}

    def jloss(p, xv):
        out = jnet.forward(p, jfeed_fn(xv), outputs=outputs)[0]
        return sum(jnp.sum(out[o].value * rs[o]) for o in outputs)

    jgp, jgx = jax.grad(jloss, argnums=(0, 1))(
        {k: jnp.asarray(v) for k, v in np_p.items()}, jnp.asarray(x))
    tp = {k: v.requires_grad_(True)
          for k, v in params_from_numpy(np_p, device="cpu").items()}
    tx = torch.tensor(x, requires_grad=True)
    to = tnet.forward(tp, tfeed_fn(tx), outputs=outputs)[0]
    for o in outputs:
        for field in ("seq_lens", "subseq_lens"):
            jv, tv = getattr(jo[o], field), getattr(to[o], field)
            assert (jv is None) == (tv is None), (o, field)
            if jv is not None:
                np.testing.assert_array_equal(tv.numpy(), np.asarray(jv))
        np.testing.assert_allclose(to[o].value.detach().numpy(),
                                   np.asarray(jo[o].value), rtol=TOL,
                                   atol=TOL, err_msg=o)
    sum((to[o].value * torch.from_numpy(rs[o])).sum()
        for o in outputs).backward()
    for k, g in jgp.items():
        np.testing.assert_allclose(tp[k].grad.numpy(), np.asarray(g),
                                   rtol=TOL, atol=TOL, err_msg=k)
    np.testing.assert_allclose(tx.grad.numpy(), np.asarray(jgx), rtol=TOL,
                               atol=TOL)
    return jo, to


def _nested_parity(kind, sub=SUB, seed=0):
    x = _x(seed, sub)
    return _parity(_nested_conf(jdsl, kind), _nested_conf(tdsl, kind),
                   _outputs(kind), lambda v: {"x": jarg.sub_seq(v, sub)},
                   lambda v: {"x": targ.sub_seq(v, sub)}, x, seed)


@pytest.mark.parametrize("kind", NESTED)
def test_nested_group_matches_jax(kind, arm):
    _nested_parity(kind)


def test_flat_group_extra_outputs_match_jax(arm):
    x = _x(1, SUB)
    lens = SUB.sum(axis=1)
    jo, to = _parity(_flat_extra_conf(jdsl), _flat_extra_conf(tdsl),
                     _outputs("flat_extra"),
                     lambda v: {"x": jarg.seq(v, lens)},
                     lambda v: {"x": targ.seq(v, lens)}, x, 1)
    assert to["aux"].value.shape == (4, x.shape[1], 2)


def test_nested_seq_output_roundtrip():
    """A sequence-valued out_link keeps the flat nested layout: the same
    subseq_lens, zeros past each row's length, and the frame at T-1 of
    the row that fills T is the real one (a scatter that overwrote
    would put a masked zero there)."""
    _jo, to = _nested_parity("inner_seq")
    y = to["outer"]
    assert y.has_subseq and y.value.shape == (4, T, H)
    np.testing.assert_array_equal(y.subseq_lens.numpy(), SUB)
    v = y.value.detach().numpy()
    for b, n in enumerate(SUB.sum(axis=1)):
        assert (v[b, n:] == 0).all()
    assert SUB[1].sum() == T and (v[1, T - 1] != 0).all()


def test_truncation_clamps_the_lengths():
    _jo, to = _nested_parity("truncated")
    np.testing.assert_array_equal(to["outer"].seq_lens.numpy(),
                                  (SUB > 0).sum(axis=1))


def test_outer_steps_match_a_manual_split():
    """Outer step s equals the plain inner net run on sub-sequence s
    alone, with the memory's recurrence applied by hand; an empty
    sub-sequence leaves the memory and writes zeros."""
    net = TNetwork(_nested_conf(tdsl, "last_state"))
    with tdsl.model() as g:
        x = tdsl.data("x", (H,), is_seq=True)
        tdsl.recurrent(x, size=H, name="inner", act="tanh", bias=False)
    flat = TNetwork(g.conf)
    p = net.init_params(torch.Generator().manual_seed(1), device="cpu")
    (wname,) = flat.param_confs
    wmix = p[next(k for k in p if k != wname)].numpy()
    x = _x(3)
    with torch.no_grad():
        got = net.forward(p, {"x": targ.sub_seq(x, SUB)})[0]["outer"]
    np.testing.assert_array_equal(got.seq_lens.numpy(),
                                  (SUB > 0).sum(axis=1))
    got = got.value.numpy()
    for b in range(SUB.shape[0]):
        mem, off = np.zeros(H, np.float32), 0
        for s, ln in enumerate(SUB[b]):
            if ln == 0:
                assert (got[b, s] == 0).all()
                continue
            piece = torch.from_numpy(x[b, off:off + ln][None])
            off += ln
            with torch.no_grad():
                inner = flat.forward({wname: p[wname]}, {
                    "x": targ.seq(piece, [ln])})[0]["inner"].value.numpy()
            mem = np.tanh(inner[0, ln - 1] + mem @ wmix)
            np.testing.assert_allclose(got[b, s], mem, atol=TOL,
                                       err_msg=f"b={b} s={s}")


def test_reversed_walks_the_sub_sequences_right_to_left():
    """reversed=True flips the order of the sub-sequences, not the time
    inside each: on equal-length sub-sequences it equals the forward
    walk over the reversed order, read backwards."""
    fwd = TNetwork(_nested_conf(tdsl, "last_state"))
    rev = TNetwork(_nested_conf(tdsl, "reversed"))
    p = fwd.init_params(torch.Generator().manual_seed(5), device="cpu")
    sub = np.asarray([[2, 2, 2]], np.int32)
    x = _x(4, sub)[:, :6]
    flip = np.concatenate([x[:, 4:6], x[:, 2:4], x[:, 0:2]], axis=1)
    with torch.no_grad():
        r = rev.forward(p, {"x": targ.sub_seq(x, sub)})[0]["outer"]
        f = fwd.forward(p, {"x": targ.sub_seq(flip, sub)})[0]["outer"]
    np.testing.assert_allclose(r.value.numpy(), f.value.numpy()[:, ::-1],
                               atol=TOL)


class _NoHostSync:
    """Raise on every host read of a tensor's value while active."""

    NAMES = ("item", "tolist", "__bool__", "__int__", "__float__")

    def __enter__(self):
        self.saved = {n: getattr(torch.Tensor, n) for n in self.NAMES}

        def refuse(*_a, **_k):
            raise AssertionError("host synchronisation in the walk")

        for n in self.NAMES:
            setattr(torch.Tensor, n, refuse)

    def __exit__(self, *exc):
        for n, f in self.saved.items():
            setattr(torch.Tensor, n, f)


@pytest.mark.parametrize("kind", ["inner_seq", "lstm", "truncated"])
def test_the_walk_reads_nothing_on_the_host(kind, arm):
    net = TNetwork(_nested_conf(tdsl, kind))
    p = {k: v.requires_grad_(True) for k, v in net.init_params(
        torch.Generator().manual_seed(0), device="cpu").items()}
    feed = {"x": targ.sub_seq(_x(0), SUB)}
    with _NoHostSync():
        out = net.forward(p, feed)[0]["outer"]
        out.value.sum().backward()
    assert all(v.grad is not None for v in p.values())


# ---- the document classifiers ----------------------------------------------

DOC = dict(vocab_size=60, emb_dim=8, hidden=16)
DOC_SUB = np.asarray([[3, 0, 2, 4, 0], [1, 4, 2, 5, 0], [2, 2, 0, 0, 0],
                      [6, 1, 1, 1, 0], [1, 1, 1, 1, 0]], np.int32)


def lstm_doc_classifier(dsl, vocab_size, emb_dim, hidden, num_classes=2):
    """hierarchical_lstm_classifier with the sentence encoder's
    `recurrent` replaced by `simple_lstm` (the chip smoke's 21a
    variant): B5/B6 run once per sub-sequence on the card."""
    with dsl.model() as g:
        words = dsl.data("words", (1,), is_seq=True, is_ids=True,
                         has_subseq=True)
        lbl = dsl.data("label", (1,), is_ids=True)

        def sentence_step(w_sub):
            doc_prev = dsl.memory("doc", size=hidden)
            emb = dsl.embedding(w_sub, size=emb_dim, vocab_size=vocab_size,
                                name="word_emb")
            enc = dsl.simple_lstm(emb, hidden, name="sent_lstm")
            last = dsl.last_seq(enc, name="sent_vec")
            return dsl.mixed(hidden, [(last, "identity"),
                                      (doc_prev, "full_matrix")],
                             act="tanh", bias=False, name="doc")

        sent = dsl.recurrent_group(sentence_step, [words], name="doc_enc")
        out = dsl.fc(dsl.last_seq(sent, name="doc_vec"), size=num_classes,
                     name="output")
        dsl.classification_cost(out, lbl)
        g.conf.output_layer_names.append("output")
    return g.conf


DOC_CONFS = {
    "hierarchical": (lambda: jtext.hierarchical_lstm_classifier(**DOC),
                     lambda: ttext.hierarchical_lstm_classifier(**DOC)),
    "nested_lstm": (lambda: lstm_doc_classifier(jdsl, **DOC),
                    lambda: lstm_doc_classifier(tdsl, **DOC)),
}


def _doc_batch(seed):
    rng = np.random.default_rng(seed)
    ids = rng.integers(0, DOC["vocab_size"], (DOC_SUB.shape[0], T))
    ids = ids * (np.arange(T)[None, :] < DOC_SUB.sum(axis=1)[:, None])
    return ids, rng.integers(0, 2, DOC_SUB.shape[0])


def _jdoc(batch):
    ids, label = batch
    return {"words": jarg.sub_seq(jnp.asarray(ids, jnp.int32), DOC_SUB,
                                  is_ids=True),
            "label": jarg.id_arg(label.astype(np.int32))}


def _tdoc(batch):
    ids, label = batch
    return {"words": targ.sub_seq(ids, DOC_SUB, is_ids=True),
            "label": targ.id_arg(label)}


@pytest.mark.parametrize("name", sorted(DOC_CONFS))
def test_doc_classifier_loss_and_gradients_match_jax(name, arm):
    jmake, tmake = DOC_CONFS[name]
    jnet, tnet = JNetwork(jmake()), TNetwork(tmake())
    np_p = _np_params(jnet, 1)
    assert sorted(tnet.param_confs) == sorted(np_p)
    batch = _doc_batch(2)
    (jloss, _aux), jgrads = jax.value_and_grad(jnet.loss_fn, has_aux=True)(
        {k: jnp.asarray(v) for k, v in np_p.items()}, _jdoc(batch))
    tp = {k: v.requires_grad_(True)
          for k, v in params_from_numpy(np_p, device="cpu").items()}
    tloss, _ = tnet.loss_fn(tp, _tdoc(batch))
    tloss.backward()
    np.testing.assert_allclose(tloss.item(), float(jloss), rtol=NET_TOL)
    for k, g in jgrads.items():
        assert _rel(tp[k].grad.numpy(), g) <= NET_TOL, k


@pytest.mark.parametrize("name", sorted(DOC_CONFS))
def test_doc_classifier_adam_step_matches_jax(name, arm):
    jmake, tmake = DOC_CONFS[name]
    p0 = _np_params(JNetwork(jmake()), 3)
    opt = dict(learning_method="adam", learning_rate=2e-3)
    jt = JSGD(jmake(), JOptConf(**opt), seed=1,
              params={k: jnp.asarray(v) for k, v in p0.items()})
    tt = TSGD(tmake(), TOptConf(**opt), seed=1,
              params=params_from_numpy(p0, device="cpu"), device="cpu")
    costs = {}
    for key, trainer, feeder, end in (("jax", jt, _jdoc, JEnd),
                                      ("port", tt, _tdoc, TEnd)):
        costs[key] = []
        trainer.train(reader=lambda: iter([_doc_batch(10)]), feeder=feeder,
                      num_passes=1, event_handler=lambda e, c=costs[key]:
                      c.append(e.cost) if isinstance(e, end) else None)
    np.testing.assert_allclose(costs["port"], costs["jax"], rtol=NET_TOL)
    for k, v in params_to_numpy(tt.params).items():
        assert _rel(v, jt.params[k]) <= NET_TOL, k
