"""The port's structured heads and the cross-map norm against the JAX
package's, on the CPU.

- `ops/crf.py`: `crf_log_likelihood` and its gradients in the emissions
  and the [N+2, N] weight (1e-5), `crf_decode`'s paths (exactly) and
  scores (1e-5) on random f32 emissions, where no two scores tie, and
  Viterbi against a brute-force search over every path of a small case.
  Tags are padded as the port's `DataFeeder` pads them.
- `ops/ctc.py::ctc_loss` and its gradient (1e-5), with a zero-length
  label, a blank inside a label's ids, padded labels from the feeder and
  an input shorter than its label needs (an impossible alignment: the
  lattice's -1e30 floor, where both packages give ~1e30); where
  `F.ctc_loss` takes the same case (feasible, labels without blanks)
  the port equals it too.
- The layers `crf` (coeff), `crf_decoding` (ids, and its 0/1 errors
  with a label), `ctc`/`warp_ctc` (softmax applied or not, a blank
  other than 0, norm_by_times, coeff), `norm`/`cmrnorm-projection`
  (odd and even windows) and `row_l2_norm`: outputs and input
  gradients within 1e-5.
- The three confs of this head: `linear_crf_tagger` and
  `rnn_crf_tagger` (on both RNN arms) and `alexnet` at a 67x67 image
  (dropout off): the loss (rtol 1e-4), every gradient (1e-4 of its
  largest entry), the decoded ids exactly, and one optimizer step
  through `SGD` (adam for the taggers, momentum for alexnet; the cost
  at rtol 1e-4, every parameter within 1e-4 of its largest entry).
"""

import itertools

import numpy as np
import pytest
import torch
import torch.nn.functional as F

import jax
import jax.numpy as jnp

from paddle_tpu import dsl as jdsl
from paddle_tpu.core import arg as jarg
from paddle_tpu.core.config import OptimizationConf as JOptConf
from paddle_tpu.data import feeder as jfeeder
from paddle_tpu.models import image as jimage
from paddle_tpu.models import text as jtext
from paddle_tpu.network import Network as JNetwork
from paddle_tpu.ops import crf as jcrf
from paddle_tpu.ops import ctc as jctc
from paddle_tpu.trainer.events import EndIteration as JEnd
from paddle_tpu.trainer.trainer import SGD as JSGD
from paddle_tpu_torch import dsl as tdsl
from paddle_tpu_torch.core import arg as targ
from paddle_tpu_torch.core import flags as tflags
from paddle_tpu_torch.core.config import OptimizationConf as TOptConf
from paddle_tpu_torch.data import feeder as tfeeder
from paddle_tpu_torch.models import image as timage
from paddle_tpu_torch.models import text as ttext
from paddle_tpu_torch.network import Network as TNetwork
from paddle_tpu_torch.ops import crf as tcrf
from paddle_tpu_torch.ops import ctc as tctc
from paddle_tpu_torch.trainer.events import EndIteration as TEnd
from paddle_tpu_torch.trainer.trainer import SGD as TSGD
from paddle_tpu_torch.weights import params_from_numpy, params_to_numpy

TOL = 1e-5
NET_TOL = 1e-4
N_TAGS = 5
LENS = [7, 0, 1, 3, 6]
ARMS = {"kernels": True, "scan": False}
# each conf once, the RNN tagger on both of the port's RNN arms
CONF_CASES = [("alexnet", None), ("linear_crf_tagger", None),
              ("rnn_crf_tagger", "kernels"), ("rnn_crf_tagger", "scan")]


@pytest.fixture
def rnn_arm(request):
    arm = request.node.callspec.params["arm"]
    if arm is not None:
        tflags.set_flag("use_pallas_rnn", ARMS[arm])
    yield arm
    tflags.reset_flags()


def _rel(got, ref):
    got, ref = np.asarray(got), np.asarray(ref)
    assert got.shape == ref.shape
    return float(np.abs(got - ref).max()) / max(float(np.abs(ref).max()),
                                                1e-30)


def _padded(seqs, vocab):
    """(ids [B, T], lens [B]) as the port's DataFeeder pads a sequence
    column."""
    f = tfeeder.DataFeeder({"s": 0}, {"s": tfeeder.integer_value_sequence(
        vocab)})
    a = f([(s,) for s in seqs])["s"]
    return a.ids.numpy(), a.seq_lens.numpy()


def _tags(seed, n=N_TAGS, lens=LENS):
    rng = np.random.default_rng(seed)
    return _padded([list(rng.integers(0, n, ln)) for ln in lens], n)


# ---- ops/crf.py -------------------------------------------------------------

def _crf_case(seed):
    rng = np.random.default_rng(seed)
    tags, lens = _tags(seed)
    emit = rng.standard_normal((len(LENS), tags.shape[1], N_TAGS)).astype(
        np.float32)
    w = rng.standard_normal((N_TAGS + 2, N_TAGS)).astype(np.float32)
    return emit, tags, lens, w


def test_crf_log_likelihood_and_gradients_match_jax():
    emit, tags, lens, w = _crf_case(0)
    r = np.random.default_rng(9).standard_normal(len(LENS)).astype(
        np.float32)

    def jf(e, ww):
        return jnp.sum(jcrf.crf_log_likelihood(
            e, jnp.asarray(tags, jnp.int32), jnp.asarray(lens), ww) * r)

    jll = jcrf.crf_log_likelihood(jnp.asarray(emit),
                                  jnp.asarray(tags, jnp.int32),
                                  jnp.asarray(lens), jnp.asarray(w))
    jge, jgw = jax.grad(jf, argnums=(0, 1))(jnp.asarray(emit),
                                             jnp.asarray(w))
    te = torch.tensor(emit, requires_grad=True)
    tw = torch.tensor(w, requires_grad=True)
    tll = tcrf.crf_log_likelihood(te, torch.from_numpy(tags),
                                  torch.from_numpy(lens), tw)
    (tll * torch.from_numpy(r)).sum().backward()
    np.testing.assert_allclose(tll.detach().numpy(), np.asarray(jll),
                               rtol=TOL, atol=TOL)
    np.testing.assert_allclose(te.grad.numpy(), np.asarray(jge), rtol=TOL,
                               atol=TOL)
    np.testing.assert_allclose(tw.grad.numpy(), np.asarray(jgw), rtol=TOL,
                               atol=TOL)


@pytest.mark.parametrize("seed", [1, 2, 3])
def test_crf_decode_matches_jax(seed):
    emit, _tags_, lens, w = _crf_case(seed)
    jp, js = jcrf.crf_decode(jnp.asarray(emit), jnp.asarray(lens),
                             jnp.asarray(w))
    tp, ts = tcrf.crf_decode(torch.from_numpy(emit), torch.from_numpy(lens),
                             torch.from_numpy(w))
    np.testing.assert_array_equal(tp.numpy(), np.asarray(jp))
    np.testing.assert_allclose(ts.numpy(), np.asarray(js), rtol=TOL,
                               atol=TOL)


def test_crf_decode_is_the_best_path():
    """Viterbi's path has the highest score of every path, and its
    score is that path's score (a + emissions + transitions + b)."""
    rng = np.random.default_rng(4)
    n, t = 3, 4
    emit = rng.standard_normal((1, t, n)).astype(np.float32)
    w = rng.standard_normal((n + 2, n)).astype(np.float32)

    def score(p):
        s = w[0, p[0]] + w[1, p[-1]] + sum(emit[0, i, k]
                                           for i, k in enumerate(p))
        return s + sum(w[2 + a, b] for a, b in zip(p[:-1], p[1:]))

    best = max(itertools.product(range(n), repeat=t), key=score)
    path, s = tcrf.crf_decode(torch.from_numpy(emit),
                              torch.tensor([t], dtype=torch.int32),
                              torch.from_numpy(w))
    assert tuple(path[0].tolist()) == best
    np.testing.assert_allclose(s.item(), score(best), rtol=1e-5)


# ---- ops/ctc.py -------------------------------------------------------------

CTC_LENS = [9, 9, 4, 7, 2]
# a zero-length label, a blank id (0) inside a label, repeats, and a
# label longer than its input allows (4 labels with a repeat in 2 steps)
CTC_LABELS = [[1, 2, 2, 3], [], [2, 0, 3], [4, 4], [1, 1, 2, 2]]


def _ctc_case(seed, c=6):
    rng = np.random.default_rng(seed)
    ids, label_lens = _padded(CTC_LABELS, c)
    logits = rng.standard_normal((len(CTC_LENS), max(CTC_LENS), c)).astype(
        np.float32)
    return logits, np.asarray(CTC_LENS, np.int32), ids, label_lens


def test_ctc_loss_and_gradient_match_jax():
    logits, in_lens, ids, label_lens = _ctc_case(0)

    def jf(x):
        lp = jax.nn.log_softmax(x, axis=-1)
        return jctc.ctc_loss(lp, jnp.asarray(in_lens),
                             jnp.asarray(ids, jnp.int32),
                             jnp.asarray(label_lens))

    jl = jf(jnp.asarray(logits))
    r = np.ones(len(CTC_LENS), np.float32)
    r[4] = 0.0    # the impossible row: a loss of ~1e30, no gradient held
    jg = jax.grad(lambda x: jnp.sum(jf(x) * r))(jnp.asarray(logits))
    tx = torch.tensor(logits, requires_grad=True)
    tl = tctc.ctc_loss(torch.log_softmax(tx, dim=-1),
                       torch.from_numpy(in_lens), torch.from_numpy(ids),
                       torch.from_numpy(label_lens))
    (tl * torch.from_numpy(r)).sum().backward()
    np.testing.assert_allclose(tl.detach().numpy(), np.asarray(jl),
                               rtol=TOL, atol=TOL)
    assert tl[4].item() > 1e29
    np.testing.assert_allclose(tx.grad.numpy(), np.asarray(jg), rtol=TOL,
                               atol=TOL)


def test_ctc_loss_equals_torch_where_their_conventions_agree():
    logits, in_lens, ids, label_lens = _ctc_case(1)
    rows = [0, 3]     # feasible, non-empty, no blank among the labels
    lp = torch.log_softmax(torch.from_numpy(logits), dim=-1)
    ours = tctc.ctc_loss(lp, torch.from_numpy(in_lens),
                         torch.from_numpy(ids),
                         torch.from_numpy(label_lens))[rows]
    ref = F.ctc_loss(lp[rows].transpose(0, 1), torch.from_numpy(ids[rows]),
                     torch.from_numpy(in_lens[rows]),
                     torch.from_numpy(label_lens[rows]), blank=0,
                     reduction="none")
    np.testing.assert_allclose(ours.numpy(), ref.numpy(), rtol=TOL)


# ---- the layers --------------------------------------------------------------

def _layer_conf(dsl, kind):
    with dsl.model() as g:
        emit = dsl.data("emit", N_TAGS, is_seq=True)
        tags = dsl.data("tags", 1, is_seq=True, is_ids=True)
        img = dsl.data("img", (4, 3, 7))
        vec = dsl.data("vec", 6, is_seq=True)
        if kind == "crf":
            dsl.crf(emit, tags, num_tags=N_TAGS, name="out", coeff=0.5)
        elif kind == "crf_decoding":
            dsl.crf_decoding(emit, num_tags=N_TAGS, name="out")
        elif kind == "crf_decoding_errors":
            dsl.crf_decoding(emit, num_tags=N_TAGS, label=tags, name="out")
        elif kind.startswith(("ctc", "warp_ctc")):
            type_, _, variant = kind.partition("-")
            attrs = {"softmax_off": dict(apply_softmax=False),
                     "blank2_norm": dict(blank=2, norm_by_times=True,
                                         coeff=2.0)}.get(variant, {})
            dsl._add(type_, [emit, tags], name="out", bias=False, **attrs)
        elif kind.startswith(("norm", "cmrnorm-projection")):
            type_, _, size = kind.partition("-size")
            dsl._add(type_, [img], name="out")
            # `size` is the window here, an attr (not the conf's width)
            g.conf.layer("out").attrs.update(size=int(size), scale=0.3,
                                             pow=0.75)
        elif kind == "row_l2_norm":
            dsl._add("row_l2_norm", [vec], name="out")
    return g.conf


LAYER_KINDS = ["crf", "crf_decoding", "crf_decoding_errors", "ctc",
               "warp_ctc", "ctc-softmax_off", "ctc-blank2_norm",
               "norm-size5", "norm-size4", "cmrnorm-projection-size3",
               "row_l2_norm"]


def _layer_feeds(kind, seed=0):
    rng = np.random.default_rng(seed)
    tags, lens = _tags(seed)
    t = tags.shape[1]
    emit = rng.standard_normal((len(LENS), t, N_TAGS)).astype(np.float32)
    if kind == "ctc-softmax_off":
        # probabilities
        emit = np.exp(emit) / np.exp(emit).sum(-1, keepdims=True)
    if kind.startswith(("ctc", "warp_ctc")):
        # labels no longer than the inputs allow
        tags, _ = _padded([list(rng.integers(1, N_TAGS, ln // 2))
                           for ln in LENS], N_TAGS)
        tags = np.pad(tags, ((0, 0), (0, t - tags.shape[1])))
        tag_lens = np.asarray([ln // 2 for ln in LENS], np.int32)
    else:
        tag_lens = lens
    vec = rng.standard_normal((len(LENS), t, 6)).astype(np.float32)
    img = rng.standard_normal((len(LENS), 4, 3, 7)).astype(np.float32)
    return {"emit": ("seq", emit, lens), "tags": ("ids", tags, tag_lens),
            "img": ("img", img, None), "vec": ("seq", vec, lens)}


@pytest.mark.parametrize("kind", LAYER_KINDS)
def test_layer_matches_jax(kind):
    jnet, tnet = JNetwork(_layer_conf(jdsl, kind)), TNetwork(
        _layer_conf(tdsl, kind))
    assert {k: tuple(p.dims) for k, p in tnet.param_confs.items()} == {
        k: tuple(p.dims) for k, p in jnet.param_confs.items()}
    rng = np.random.default_rng(7)
    np_p = {k: rng.standard_normal(tuple(p.dims)).astype(np.float32)
            for k, p in jnet.param_confs.items()}
    feeds = _layer_feeds(kind)
    floats = [n for n, (k, _v, _l) in feeds.items() if k != "ids"]

    def jfeed(vals):
        out = {}
        for n, (k, v, lens) in feeds.items():
            if k == "ids":
                out[n] = jarg.id_arg(jnp.asarray(v, jnp.int32), lens)
            elif k == "seq":
                out[n] = jarg.seq(vals[n], lens)
            else:
                out[n] = jarg.non_seq(vals[n])
        return out

    def tfeed(vals):
        out = {}
        for n, (k, v, lens) in feeds.items():
            if k == "ids":
                out[n] = targ.id_arg(v, lens)
            elif k == "seq":
                out[n] = targ.seq(vals[n], lens)
            else:
                out[n] = targ.non_seq(vals[n])
        return out

    jvals = {n: jnp.asarray(feeds[n][1]) for n in floats}
    jp = {k: jnp.asarray(v) for k, v in np_p.items()}
    jo = jnet.forward(jp, jfeed(jvals), outputs=["out"])[0]["out"]
    tvals = {n: torch.tensor(feeds[n][1], requires_grad=True)
             for n in floats}
    tp = {k: v.requires_grad_(True)
          for k, v in params_from_numpy(np_p, device="cpu").items()}
    to = tnet.forward(tp, tfeed(tvals), outputs=["out"])[0]["out"]
    if jo.ids is not None:
        np.testing.assert_array_equal(to.ids.numpy(), np.asarray(jo.ids))
        np.testing.assert_array_equal(to.seq_lens.numpy(),
                                      np.asarray(jo.seq_lens))
        return
    np.testing.assert_allclose(to.value.detach().numpy(),
                               np.asarray(jo.value), rtol=TOL, atol=TOL)
    if not to.value.requires_grad:
        return
    r = np.random.default_rng(8).standard_normal(jo.value.shape).astype(
        np.float32)
    jgp, jgv = jax.grad(lambda p, v: jnp.sum(jnet.forward(
        p, jfeed(v), outputs=["out"])[0]["out"].value * r),
        argnums=(0, 1))(jp, jvals)
    (to.value * torch.from_numpy(r)).sum().backward()
    for k, g in jgp.items():
        np.testing.assert_allclose(tp[k].grad.numpy(), np.asarray(g),
                                   rtol=TOL, atol=TOL, err_msg=k)
    for n, g in jgv.items():
        got = tvals[n].grad
        got = np.zeros_like(np.asarray(g)) if got is None else got.numpy()
        np.testing.assert_allclose(got, np.asarray(g), rtol=TOL, atol=TOL,
                                   err_msg=n)


def test_cross_map_norm_is_not_torch_local_response_norm():
    """The window's sum is scaled by `scale`, not `scale / size`: the
    port's layer equals the formula, and F.local_response_norm (which
    divides by size) gives another function."""
    conf = _layer_conf(tdsl, "norm-size5")
    x = torch.from_numpy(_layer_feeds("norm-size5")["img"][1])
    y = TNetwork(conf).forward({}, {"img": targ.non_seq(x)},
                               outputs=["out"])[0]["out"].value
    sq = F.pad(x * x, (2, 2))
    window = sum(sq[..., i:i + 7] for i in range(5))
    torch.testing.assert_close(y, x / (1 + 0.3 * window) ** 0.75)
    lrn = F.local_response_norm(x.permute(0, 3, 1, 2), 5, alpha=0.3,
                                beta=0.75, k=1.0).permute(0, 2, 3, 1)
    assert (y - lrn).abs().max() > 1e-2


# ---- the confs ---------------------------------------------------------------

TAGGERS = {"linear_crf_tagger": dict(vocab_size=50, num_tags=N_TAGS,
                                     emb_dim=8),
           "rnn_crf_tagger": dict(vocab_size=50, num_tags=N_TAGS, emb_dim=8,
                                  hidden=12)}


def _tagger_batch(seed):
    """One batch as the feeder packs it: words and tags padded with 0."""
    rng = np.random.default_rng(seed)
    samples = [(list(rng.integers(0, 50, ln)),
                list(rng.integers(0, N_TAGS, ln))) for ln in
               [7, 3, 1, 6, 2]]
    types = {"words": "integer_value_sequence",
             "tags": "integer_value_sequence"}
    feeds = {}
    for pkg, mod in (("jax", jfeeder), ("port", tfeeder)):
        f = mod.DataFeeder({"words": 0, "tags": 1}, {
            k: getattr(mod, v)(50 if k == "words" else N_TAGS)
            for k, v in types.items()})
        feeds[pkg] = f(samples)
    return feeds


def _tagger_confs(name):
    return (getattr(jtext, name)(**TAGGERS[name]),
            getattr(ttext, name)(**TAGGERS[name]))


def _alexnet_confs():
    confs = (jimage.alexnet((67, 67, 3), 10), timage.alexnet((67, 67, 3),
                                                             10))
    for c in confs:
        for lc in c.layers:
            lc.drop_rate = 0.0
    return confs


def _image_batch(seed):
    rng = np.random.default_rng(seed)
    image = rng.standard_normal((3, 67, 67, 3)).astype(np.float32)
    label = rng.integers(0, 10, 3).astype(np.int32)
    return {"jax": {"image": jarg.non_seq(jnp.asarray(image)),
                    "label": jarg.id_arg(jnp.asarray(label))},
            "port": {"image": targ.non_seq(image),
                     "label": targ.id_arg(label)}}


def _np_params(jnet, seed):
    rng = np.random.default_rng(seed)
    out = {}
    for k, v in jnet.init_params(jax.random.key(seed)).items():
        v = np.asarray(v)
        if v.ndim == 1:
            v = v + 0.3 * rng.standard_normal(v.shape).astype(np.float32)
        out[k] = v
    return out


def _conf_case(name):
    if name == "alexnet":
        return _alexnet_confs(), _image_batch
    return _tagger_confs(name), _tagger_batch


@pytest.mark.parametrize("name,arm", CONF_CASES)
def test_conf_loss_gradients_and_decode_match_jax(name, arm, rnn_arm):
    (jconf, tconf), batch_fn = _conf_case(name)
    jnet, tnet = JNetwork(jconf), TNetwork(tconf)
    np_p = _np_params(jnet, 1)
    assert sorted(tnet.param_confs) == sorted(np_p)
    if name != "alexnet":
        assert "crfw" in np_p
    batch = batch_fn(2)
    jp = {k: jnp.asarray(v) for k, v in np_p.items()}
    (jloss, (jouts, _s)), jgrads = jax.value_and_grad(
        jnet.loss_fn, has_aux=True)(jp, batch["jax"])
    tp = {k: v.requires_grad_(True)
          for k, v in params_from_numpy(np_p, device="cpu").items()}
    tloss, (touts, _s) = tnet.loss_fn(tp, batch["port"])
    tloss.backward()
    np.testing.assert_allclose(tloss.item(), float(jloss), rtol=NET_TOL)
    for k, g in jgrads.items():
        assert _rel(tp[k].grad.numpy(), g) <= NET_TOL, k
    if name != "alexnet":
        np.testing.assert_array_equal(touts["decoded"].ids.numpy(),
                                      np.asarray(jouts["decoded"].ids))


# `SGD` here takes the port's feeds as they are (the JAX trainer puts
# them on its device)
def _feeder(pkg):
    return lambda b: b[pkg]


@pytest.mark.parametrize("name,arm", CONF_CASES)
def test_conf_optimizer_step_matches_jax(name, arm, rnn_arm):
    (jconf, tconf), batch_fn = _conf_case(name)
    p0 = _np_params(JNetwork(jconf), 3)
    opt = (dict(learning_method="momentum", learning_rate=0.01,
                momentum=0.9) if name == "alexnet"
           else dict(learning_method="adam", learning_rate=2e-3))
    jt = JSGD(jconf, JOptConf(**opt), seed=1,
              params={k: jnp.asarray(v) for k, v in p0.items()})
    tt = TSGD(tconf, TOptConf(**opt), seed=1,
              params=params_from_numpy(p0, device="cpu"), device="cpu")
    costs = {}
    for key, trainer, end in (("jax", jt, JEnd), ("port", tt, TEnd)):
        costs[key] = []
        trainer.train(reader=lambda: iter([batch_fn(10)]),
                      feeder=_feeder(key), num_passes=1,
                      event_handler=lambda e, c=costs[key]:
                      c.append(e.cost) if isinstance(e, end) else None)
    np.testing.assert_allclose(costs["port"], costs["jax"], rtol=NET_TOL)
    for k, v in params_to_numpy(tt.params).items():
        assert _rel(v, jt.params[k]) <= NET_TOL, k
