"""The port's multi-step dispatch against its single step and against
the JAX package's `TrainStep.multi`, on the CPU.

Three tiny models — the IMDB classifier (hidden 16, its LSTMs on the
kernels' path: their plain versions on the CPU), the two-block fused
ResNet of `tests/test_torch_image.py` with BN state, and the tiny
Transformer LM — each under adam with a `poly` LR schedule from global
step 7, `lr_scale` 0.5, the watchdog on, and L1, L2 and clipping on one
parameter:

- the port's `TrainStep.multi` over K = 4 equals 4 of its single steps
  exactly (`torch.equal` on params, slots, layer state and the health
  rows);
- it equals the JAX `TrainStep.multi` over the same 4 steps within the
  tolerances `tests/test_torch_text.py` holds three adam steps to (the
  costs rtol 1e-4, every parameter 1e-4 of its largest entry);
- a batch with a NaN image mid-chunk is skipped by both packages: its
  health row says so, and the chunk ends where the JAX chunk does;
- a conf with dropout: `multi` walks the eager steps' trajectory (the
  masks come from each step's own key), and another start step draws
  other masks;
- `SGD.train` with `steps_per_dispatch=3`, fed by the port's
  `DataFeeder` through `batched(shuffle(...))` with length buckets,
  fires the JAX trainer's events in the same order and walks the same
  costs, including the early flushes at a change of the feed's shape
  signature (another bucket, the short last batch), and walks the
  trajectory of `steps_per_dispatch=1` exactly.

`TestOnCard` (marked `cuda`, skipped without a card) holds a graph's
replays against eager chunks on the classifier, as `chip_smoke.py`'s
phase 18c does for every model of the card's paths.
"""

import dataclasses

import numpy as np
import pytest
import torch

try:  # the CPU parity tests need JAX; the on-card tests do not
    import jax
    import jax.numpy as jnp

    from paddle_tpu import dsl as jdsl
    from paddle_tpu.core import arg as jarg
    from paddle_tpu.core.config import OptimizationConf as JOptConf
    from paddle_tpu.data import feeder as jfeeder
    from paddle_tpu.data import reader as jreader
    from paddle_tpu.models import image as jimage
    from paddle_tpu.models import lm as jlm
    from paddle_tpu.models import text as jtext
    from paddle_tpu.network import Network as JNetwork
    from paddle_tpu.optimizers import create_optimizer as jcreate
    from paddle_tpu.parallel.dp import TrainStep as JTrainStep
    from paddle_tpu.trainer.trainer import SGD as JSGD
except ImportError:
    jax = None

from paddle_tpu_torch import dsl as tdsl
from paddle_tpu_torch.core import arg as targ
from paddle_tpu_torch.core import flags as tflags
from paddle_tpu_torch.core import rng as trng
from paddle_tpu_torch.core.config import OptimizationConf as TOptConf
from paddle_tpu_torch.data import feeder as tfeeder
from paddle_tpu_torch.data import reader as treader
from paddle_tpu_torch.models import image as timage
from paddle_tpu_torch.models import lm as tlm
from paddle_tpu_torch.models import text as ttext
from paddle_tpu_torch.network import Network as TNetwork
from paddle_tpu_torch.optimizers import create_optimizer as tcreate
from paddle_tpu_torch.parallel.dp import TrainStep as TTrainStep
from paddle_tpu_torch.parallel.dp import stack_feeds
from paddle_tpu_torch.trainer.trainer import SGD as TSGD
from paddle_tpu_torch.weights import params_from_numpy, state_from_numpy

needs_jax = pytest.mark.skipif(jax is None, reason="needs JAX (CPU parity)")

K = 4
STEP0 = 7
LR_SCALE = 0.5
NET_TOL = 1e-4
OPT = dict(learning_method="adam", learning_rate=0.01,
           learning_rate_schedule="poly", learning_rate_decay_a=0.1,
           learning_rate_decay_b=0.5)
# L1, L2 and clipping on one parameter of each model
HYPER = dict(decay_rate_l1=1e-3, decay_rate=1e-2,
             gradient_clipping_threshold=0.01)
HYPER_PARAM = {"classifier": "_lstm0.w0", "resnet": "_output.w0",
               "lm": "_lm_head.w0"}
CLS = dict(vocab_size=50, emb_dim=8, hidden=16)
LM = dict(vocab=64, d_model=32, num_heads=2, num_layers=2)
CLS_LENS = np.asarray([13, 1, 5, 7, 12], np.int32)
LM_LENS = np.asarray([20, 13, 7, 20], np.int32)


def _tiny_resnet(dsl, image):
    with dsl.model() as g:
        img = dsl.data("image", (8, 8, 16))
        lbl = dsl.data("label", (1,), is_ids=True)
        h = image._bottleneck("blk_a", img, 4, 1, project=True, fused=True)
        h = image._bottleneck("blk_b", h, 4, 1, project=False, fused=True)
        h = dsl.pool(h, 8, 1, pool_type="avg")
        out = dsl.fc(h, size=3, name="output", act="softmax")
        dsl.classification_cost(out, lbl, name="cost")
    return g.conf


def _confs(name):
    if name == "classifier":
        return (jtext.stacked_lstm_classifier(**CLS),
                ttext.stacked_lstm_classifier(**CLS))
    if name == "resnet":
        return _tiny_resnet(jdsl, jimage), _tiny_resnet(tdsl, timage)
    return (jlm.transformer_lm(jlm.LMSpec(**LM)),
            tlm.transformer_lm(tlm.LMSpec(**LM)))


def _np_weights(name, jnet):
    """The JAX init (1-D parameters perturbed off 0) and state."""
    rng = np.random.default_rng(3)
    params = {}
    for k, v in jnet.init_params(jax.random.key(3)).items():
        v = np.asarray(v)
        if v.ndim == 1:
            v = v + 0.3 * rng.standard_normal(v.shape).astype(np.float32)
        params[k] = v
    state = jax.tree_util.tree_map(np.asarray, jnet.init_state())
    return params, state


def _batches(name, n=K, seed=0, nan_at=None):
    """n numpy batches of model `name`: {input: (array, lens)}."""
    rng = np.random.default_rng(seed)
    out = []
    for i in range(n):
        if name == "classifier":
            b = {"words": (rng.integers(0, 50, (5, 13)), CLS_LENS),
                 "label": (rng.integers(0, 2, 5), None)}
        elif name == "resnet":
            x = rng.standard_normal((4, 8, 8, 16)).astype(np.float32)
            if i == nan_at:
                x[1, 2, 3, 4] = np.nan
            b = {"image": (x, None), "label": (rng.integers(0, 3, 4), None)}
        else:
            b = {k: (rng.integers(2, LM["vocab"], (4, 20)), LM_LENS)
                 for k in ("ids", "label")}
        out.append(b)
    return out


def _jfeed(b):
    return {k: jarg.non_seq(jnp.asarray(x)) if x.dtype == np.float32
            else jarg.id_arg(x.astype(np.int32), lens)
            for k, (x, lens) in b.items()}


def _tfeed(b):
    return {k: targ.non_seq(x) if x.dtype == np.float32
            else targ.id_arg(x, lens) for k, (x, lens) in b.items()}


def _param_confs(name, net):
    pcs = dict(net.param_confs)
    pcs[HYPER_PARAM[name]] = dataclasses.replace(pcs[HYPER_PARAM[name]],
                                                 **HYPER)
    return pcs


@pytest.fixture(autouse=True)
def _kernels_path():
    # the classifier's LSTMs on the kernels' path (their plain versions
    # on the CPU), as on the card
    tflags.set_flag("use_pallas_rnn", True)
    yield
    tflags.reset_flags()


def _port(name, watchdog=True):
    """(TrainStep, params, opt_state, state) of the port from the JAX
    init."""
    jconf, tconf = _confs(name)
    np_p, np_s = _np_weights(name, JNetwork(jconf))
    net = TNetwork(tconf)
    opt = tcreate(TOptConf(**OPT), _param_confs(name, net))
    p = params_from_numpy(np_p, device="cpu")
    return (TTrainStep(net, opt, watchdog=watchdog, device="cpu"), p,
            opt.init_state(p), state_from_numpy(np_s, device="cpu"))


def _singles(step, p, o, s, feeds, step0, root):
    healths = []
    for k, feed in enumerate(feeds):
        p, o, s, h, _ = step(p, o, s, feed, step0 + k,
                             trng.split_for_step(root, step0 + k),
                             lr_scale=LR_SCALE)
        healths.append(h)
    return p, o, s, torch.stack(healths)


def _assert_trees_equal(a, b, what):
    if isinstance(a, dict):
        assert a.keys() == b.keys(), what
        for k in a:
            _assert_trees_equal(a[k], b[k], f"{what}.{k}")
    else:
        assert torch.equal(a, b), what


def _rel(got, ref):
    got, ref = np.asarray(got), np.asarray(ref)
    assert got.shape == ref.shape
    return float(np.abs(got - ref).max()) / max(float(np.abs(ref).max()),
                                                1e-30)


@needs_jax
@pytest.mark.parametrize("name", ["classifier", "resnet", "lm"])
def test_multi_equals_single_steps_exactly(name):
    step, p, o, s = _port(name)
    feeds = [_tfeed(b) for b in _batches(name)]
    root = trng.generator(11)
    sp, so, ss, sh = _singles(step, p, o, s, feeds, STEP0, root)
    mp, mo, ms, mh, outs = step.multi(p, o, s, stack_feeds(feeds), STEP0,
                                      root, lr_scale=LR_SCALE)
    assert mh.shape == (K, 2) and bool(mh[:, 1].all())
    assert torch.equal(mh, sh)
    _assert_trees_equal(mp, sp, "params")
    _assert_trees_equal(mo, so, "opt_state")
    _assert_trees_equal(ms, ss, "state")
    # the kept outputs come back stacked [K, ...]
    assert all(v.value.shape[0] == K for v in outs.values()
               if v.value is not None)


@needs_jax
@pytest.mark.parametrize("name", ["classifier", "resnet", "lm"])
def test_multi_matches_the_jax_multi(name):
    jconf, _tconf = _confs(name)
    jnet = JNetwork(jconf)
    np_p, np_s = _np_weights(name, jnet)
    batches = _batches(name)
    jopt = jcreate(JOptConf(**OPT), _param_confs(name, jnet))
    jp = {k: jnp.asarray(v) for k, v in np_p.items()}
    jfeeds = jax.tree_util.tree_map(lambda *xs: jnp.stack(xs),
                                    *[_jfeed(b) for b in batches])
    jp, jo, _js, jh, _jo = JTrainStep(jnet, jopt, donate=False,
                                      watchdog=True).multi(
        jp, jopt.init_state(jp), jax.tree_util.tree_map(jnp.asarray, np_s),
        jfeeds, STEP0, jax.random.key(1), lr_scale=LR_SCALE)
    step, p, o, s = _port(name)
    tp, to, _ts, th, _to = step.multi(
        p, o, s, stack_feeds([_tfeed(b) for b in batches]), STEP0,
        trng.generator(11), lr_scale=LR_SCALE)
    np.testing.assert_allclose(th.numpy(), np.asarray(jh), rtol=NET_TOL)
    for k, v in tp.items():
        assert _rel(v.numpy(), jp[k]) <= NET_TOL, k
    for k, slots in to.items():
        for slot, v in slots.items():
            assert _rel(v.numpy(), jo[k][slot]) <= NET_TOL, (k, slot)


@needs_jax
def test_nan_batch_mid_chunk_is_skipped_by_both():
    name = "resnet"
    batches = _batches(name, nan_at=2)
    step, p, o, s = _port(name)
    feeds = [_tfeed(b) for b in batches]
    root = trng.generator(11)
    mp, mo, ms, mh, _ = step.multi(p, o, s, stack_feeds(feeds), STEP0, root,
                                   lr_scale=LR_SCALE)
    assert mh[:, 1].tolist() == [1.0, 1.0, 0.0, 1.0]
    assert torch.isnan(mh[2, 0])
    sp, so, ss, sh = _singles(step, p, o, s, feeds, STEP0, root)
    assert torch.equal(mh[:, 1], sh[:, 1])
    _assert_trees_equal(mp, sp, "params")
    _assert_trees_equal(mo, so, "opt_state")
    _assert_trees_equal(ms, ss, "state")
    # the skipped batch leaves the chunk where three steps without it
    # leave it
    skip = [feeds[i] for i in (0, 1, 3)]
    kp, _ko, ks, _kh = _singles(step, p, o, s, skip[:2], STEP0, root)
    kp, _ko, ks, _kh = _singles(step, kp, _ko, ks, skip[2:], STEP0 + 3,
                                root)
    _assert_trees_equal(mp, kp, "params without the NaN batch")
    _assert_trees_equal(ms, ks, "state without the NaN batch")

    jnet = JNetwork(_confs(name)[0])
    np_p, np_s = _np_weights(name, jnet)
    jopt = jcreate(JOptConf(**OPT), _param_confs(name, jnet))
    jp = {k: jnp.asarray(v) for k, v in np_p.items()}
    jfeeds = jax.tree_util.tree_map(lambda *xs: jnp.stack(xs),
                                    *[_jfeed(b) for b in batches])
    jp, _jo, _js, jh, _ = JTrainStep(jnet, jopt, donate=False,
                                     watchdog=True).multi(
        jp, jopt.init_state(jp), jax.tree_util.tree_map(jnp.asarray, np_s),
        jfeeds, STEP0, jax.random.key(1), lr_scale=LR_SCALE)
    assert np.asarray(jh)[:, 1].tolist() == [1.0, 1.0, 0.0, 1.0]
    for k, v in mp.items():
        assert _rel(v.numpy(), jp[k]) <= NET_TOL, k


def _dropout_mlp(dsl):
    with dsl.model() as m:
        x = dsl.data("x", dim=6)
        y = dsl.data("label", dim=(), is_ids=True)
        h = dsl.fc(x, size=32, act="relu", name="h", drop_rate=0.3)
        o = dsl.fc(h, size=3, name="o")
        dsl.classification_cost(o, y)
    return m.conf


def test_dropout_conf_walks_the_eager_trajectory():
    net = TNetwork(_dropout_mlp(tdsl))
    opt = tcreate(TOptConf(**OPT), net.param_confs)
    step = TTrainStep(net, opt, watchdog=True, device="cpu")
    p = net.init_params(torch.Generator().manual_seed(0), device="cpu")
    o, s = opt.init_state(p), {}
    rng = np.random.default_rng(5)
    feeds = [{"x": targ.non_seq(rng.standard_normal((8, 6))
                                .astype(np.float32)),
              "label": targ.id_arg(rng.integers(0, 3, 8))}
             for _ in range(K)]
    root = trng.generator(11)
    stacked = stack_feeds(feeds)
    mp, mo, _ms, mh, _ = step.multi(p, o, s, stacked, STEP0, root,
                                    lr_scale=LR_SCALE)
    sp, so, _ss, sh = _singles(step, p, o, s, feeds, STEP0, root)
    assert torch.equal(mh, sh)
    _assert_trees_equal(mp, sp, "params")
    _assert_trees_equal(mo, so, "opt_state")
    # the masks are the steps' own: other steps, other losses
    _p, _o, _s, other, _ = step.multi(p, o, s, stacked, STEP0 + K, root,
                                      lr_scale=LR_SCALE)
    assert not torch.equal(other[0, 0], mh[0, 0])


# ---- SGD.train: reader -> DataFeeder -> chunks -> events ------------------

BUCKETS = (8, 16)
# batch 0's rows all fit the bucket 8, the others reach 16, and the last
# batch is short: the signature changes twice
SAMPLE_LENS = [3, 8, 1, 5, 7] + [12, 4, 16, 9, 2] * 3 + [10, 3, 6]


def _samples():
    rng = np.random.default_rng(9)
    return [(list(rng.integers(0, 50, n)), int(rng.integers(0, 2)))
            for n in SAMPLE_LENS]


def _train(sgd, feeder, reader_mod):
    samples = _samples()
    # a shuffle buffer of one batch: rows move within their batch only
    reader = reader_mod.batched(
        reader_mod.shuffle(lambda: iter(samples), 5, seed=4), 5,
        drop_last=False)
    events = []
    sgd.train(reader=reader, feeder=feeder, num_passes=2,
              event_handler=events.append)
    names = [(type(e).__name__, getattr(e, "pass_id", None),
              getattr(e, "batch_id", None)) for e in events]
    costs = [e.cost for e in events if type(e).__name__ == "EndIteration"]
    return names, np.asarray(costs)


@needs_jax
def test_sgd_train_pipelined_matches_jax_and_the_single_steps():
    jconf, tconf = _confs("classifier")
    np_p, _np_s = _np_weights("classifier", JNetwork(jconf))
    types = {"words": 0, "label": 1}
    jt = JSGD(jconf, JOptConf(**OPT), seed=1, watchdog=True,
              params={k: jnp.asarray(v) for k, v in np_p.items()},
              steps_per_dispatch=3)
    jnames, jcosts = _train(jt, jfeeder.DataFeeder(types, {
        "words": jfeeder.integer_value_sequence(50),
        "label": jfeeder.integer_value(2)}, buckets=BUCKETS), jreader)
    tfeed = tfeeder.DataFeeder(types, {
        "words": tfeeder.integer_value_sequence(50),
        "label": tfeeder.integer_value(2)}, buckets=BUCKETS)
    tt = TSGD(tconf, TOptConf(**OPT), seed=1, watchdog=True,
              params=params_from_numpy(np_p, device="cpu"), device="cpu",
              steps_per_dispatch=3)
    chunks = []
    real = tt.run_steps
    tt.run_steps = lambda feeds, *a: chunks.append(len(feeds)) or real(
        feeds, *a)
    tnames, tcosts = _train(tt, tfeed, treader)
    # each pass: batch 0 (bucket 8) flushed alone at batch 1 (bucket 16),
    # batches 1-3 as one chunk, the short last batch alone
    assert chunks == [1, 3, 1] * 2
    assert tnames == jnames
    assert len(tcosts) == 2 * 5 and np.isfinite(tcosts).all()
    np.testing.assert_allclose(tcosts, jcosts, rtol=NET_TOL)
    for k, v in tt.params.items():
        assert _rel(v.numpy(), jt.params[k]) <= NET_TOL, k
    assert tt.global_step == jt.global_step == 10
    # off the card nothing is captured
    assert tt.graphs_captured == 0

    one = TSGD(tconf, TOptConf(**OPT), seed=1, watchdog=True,
               params=params_from_numpy(np_p, device="cpu"), device="cpu",
               steps_per_dispatch=1)
    _onames, ocosts = _train(one, tfeed, treader)
    np.testing.assert_array_equal(ocosts, tcosts)
    _assert_trees_equal(one.params, tt.params, "params")
    _assert_trees_equal(one.opt_state, tt.opt_state, "opt_state")


def test_run_steps_chunks_through_multi_and_one_batch_through_run_step(
        monkeypatch):
    tt = TSGD(_dropout_mlp(tdsl), TOptConf(**OPT), seed=1, device="cpu",
              steps_per_dispatch=3)
    calls = []
    real_multi, real_step = tt.step_fn.multi, tt.run_step
    monkeypatch.setattr(tt.step_fn, "multi",
                        lambda *a, **kw: calls.append("multi")
                        or real_multi(*a, **kw))
    monkeypatch.setattr(tt, "run_step",
                        lambda *a, **kw: calls.append("step")
                        or real_step(*a, **kw))
    rng = np.random.default_rng(0)

    def feed(b):
        return {"x": targ.non_seq(rng.standard_normal((b, 6))
                                  .astype(np.float32)),
                "label": targ.id_arg(rng.integers(0, 3, b))}

    # four batches of 8 rows, then one of 5: chunks of 3, 1 (the flush
    # at the new signature) and 1
    batches = [8, 8, 8, 8, 5]
    events = []
    tt.train(reader=lambda: iter(batches), feeder=feed,
             event_handler=events.append)
    assert calls == ["multi", "step", "step"]
    order = [(type(e).__name__, getattr(e, "batch_id", None))
             for e in events]
    assert order == [
        ("BeginPass", None),
        ("BeginIteration", 0), ("BeginIteration", 1), ("BeginIteration", 2),
        ("EndIteration", 0), ("EndIteration", 1), ("EndIteration", 2),
        ("BeginIteration", 3), ("BeginIteration", 4),
        ("EndIteration", 3), ("EndIteration", 4),
        ("EndPass", None)]
    assert tt.global_step == 5


def test_steps_per_dispatch_is_checked_and_defaults_to_the_flag():
    conf = _dropout_mlp(tdsl)
    with pytest.raises(ValueError, match="steps_per_dispatch"):
        TSGD(conf, TOptConf(**OPT), seed=1, device="cpu",
             steps_per_dispatch=0)
    assert TSGD(conf, TOptConf(**OPT), seed=1,
                device="cpu").steps_per_dispatch == 1
    tflags.set_flag("steps_per_dispatch", 5)
    assert TSGD(conf, TOptConf(**OPT), seed=1,
                device="cpu").steps_per_dispatch == 5


@pytest.mark.parametrize("method", ["adam", "adamax", "momentum"])
def test_step_scalars_are_rounded_once_from_double(method):
    """The update reads its scalars from a tensor: each the double value
    of the LR (times lr_mult and lr_scale), the L1 shrink and the bias
    corrections rounded once to f32, whatever step it is read at."""
    net = TNetwork(_dropout_mlp(tdsl))
    pcs = dict(net.param_confs)
    pcs["_o.w0"] = dataclasses.replace(pcs["_o.w0"], learning_rate=0.5,
                                       **HYPER)
    opt = tcreate(TOptConf(**{**OPT, "learning_method": method}), pcs)
    keys = opt.scalar_keys
    assert ("lr", 0.5) in keys and ("l1", 0.5, HYPER["decay_rate_l1"]) in keys
    got = opt.step_scalars(STEP0, LR_SCALE)
    lr = 0.01 * (1 + 0.1 * STEP0) ** -0.5 * LR_SCALE
    assert got[keys.index(("lr", 0.5))] == lr * 0.5
    assert got[keys.index(("l1", 0.5, 1e-3))] == lr * 0.5 * 1e-3
    if method == "adam":
        assert got[keys.index(("inv_bc1",))] == 1 / (1 - 0.9 ** (STEP0 + 1))
    p = net.init_params(torch.Generator().manual_seed(0), device="cpu")
    g = {k: torch.full_like(v, 0.25) for k, v in p.items()}
    a = opt.update(g, p, opt.init_state(p), STEP0, lr_scale=LR_SCALE)
    b = opt.update(g, p, opt.init_state(p), None,
                   scalars=opt.scalars_tensor(STEP0, LR_SCALE,
                                              p["_o.w0"]))
    _assert_trees_equal(a[0], b[0], "params")


def test_step_keys_fold_on_the_device_as_on_the_host():
    root = trng.generator(5)
    key = trng.split_for_step(root, 3)
    assert int(key.seed) == trng.step_seed(5, 3) == trng.fold_in(5, 3)
    assert int(key.fold_in(77).seed) == trng.fold_in(trng.fold_in(5, 3), 77)
    u = key.uniform((64, 64))
    assert u.dtype == torch.float32 and 0 <= float(u.min())
    assert float(u.max()) < 1 and abs(float(u.mean()) - 0.5) < 0.02
    assert torch.equal(u, key.uniform((64, 64)))
    assert not torch.equal(u, trng.split_for_step(root, 4).uniform((64, 64)))


def test_graph_runner_bookkeeping_with_eager_replays(monkeypatch):
    """`parallel/graph.py::StepGraphs` with the CUDA capture swapped for
    eager execution of the captured steps (a CPU has no graphs): its
    static trees, inputs, write-back and output copies walk the single
    steps' trajectory exactly, across two feed signatures, two chunks of
    one graph and an eager step between replays (`TrainStep.settle`)."""
    from paddle_tpu_torch.parallel import graph as tgraph

    monkeypatch.setattr(tgraph.torch.cuda, "graph_pool_handle", lambda: None)
    monkeypatch.setattr(tgraph.torch.cuda, "Stream", lambda device: None)
    monkeypatch.setattr(tgraph.torch.cuda, "CUDAGraph", lambda: None)
    monkeypatch.setattr(tgraph._Graph, "capture", lambda self: None)

    def replay(self):
        self.losses, self.outs = self._steps(self.k, write_back=True)
        return (self.losses.clone(),
                {n: tgraph._arg_map(torch.clone, a)
                 for n, a in self.outs.items()})

    monkeypatch.setattr(tgraph._Graph, "replay", replay)
    step, p, o, s = _port("resnet")
    runner = step.graphs = tgraph.StepGraphs(step)
    feeds = [_tfeed(b) for b in _batches("resnet", n=9, nan_at=5)]
    short = [_tfeed(b) for b in _batches("resnet", n=1, seed=3)]
    short = [{"image": targ.non_seq(f["image"].value[:2]),
              "label": targ.id_arg(f["label"].ids[:2])} for f in short]
    root = trng.generator(11)
    # the reference: one eager step after another
    order = feeds[:4] + short + feeds[4:]
    rp, ro, rs, rh = _singles(step.__class__(step.net, step.opt,
                                             watchdog=True, device="cpu"),
                              p, o, s, order, STEP0, root)
    # K = 4, an eager step on another signature, K = 4 again
    mp, mo, ms, h1, _ = runner.run(p, o, s, stack_feeds(feeds[:4]),
                                   *step.step_tables(STEP0, 4, 11, LR_SCALE,
                                                     p["_output.w0"]))
    assert mp is runner.params
    ep, eo, es, h2, _ = step(mp, mo, ms, short[0], STEP0 + 4,
                             trng.split_for_step(root, STEP0 + 4),
                             lr_scale=LR_SCALE)
    ep, eo, es = step.settle(ep, eo, es)
    assert ep is runner.params and eo is runner.opt_state
    mp, mo, ms, h3, _ = runner.run(ep, eo, es, stack_feeds(feeds[4:8]),
                                   *step.step_tables(STEP0 + 5, 4, 11,
                                                     LR_SCALE,
                                                     p["_output.w0"]))
    mp, mo, ms, h4, _ = runner.run(mp, mo, ms, stack_feeds(feeds[8:]),
                                   *step.step_tables(STEP0 + 9, 1, 11,
                                                     LR_SCALE,
                                                     p["_output.w0"]))
    assert step.graphs_captured == 2          # (4, sig) and (1, sig)
    got = torch.cat([h1, h2[None], h3, h4])
    assert torch.equal(got.isnan(), rh.isnan()) and got[6, 1] == 0
    assert torch.equal(got.nan_to_num(0.0), rh.nan_to_num(0.0))
    _assert_trees_equal(mp, rp, "params")
    _assert_trees_equal(mo, ro, "opt_state")
    _assert_trees_equal(ms, rs, "state")


@pytest.mark.cuda
class TestOnCard:
    """A graph's replays against eager chunks on the classifier, on the
    card: two chunks of K = 10 steps, the second at a later global step
    under lr_scale 0.5; params, slots and losses bit-equal where two
    eager runs agree bit for bit."""

    @pytest.fixture(autouse=True)
    def _card(self):
        if not torch.cuda.is_available():
            pytest.skip("needs a CUDA device: the graph runner replays "
                        "on the card")

    def test_graph_replays_match_eager_chunks(self):
        tflags.reset_flags()
        conf = ttext.stacked_lstm_classifier(vocab_size=1000, emb_dim=32,
                                             hidden=128)
        rng = np.random.default_rng(0)
        feeds = [{"words": targ.id_arg(rng.integers(0, 1000, (16, 40)),
                                       rng.integers(1, 41, 16)),
                  "label": targ.id_arg(rng.integers(0, 2, 16))}
                 for _ in range(20)]
        opt_conf = TOptConf(**OPT)

        def run(graph):
            net = TNetwork(conf)
            opt = tcreate(opt_conf, net.param_confs)
            step = TTrainStep(net, opt, watchdog=True, device="cuda")
            p = net.init_params(torch.Generator().manual_seed(0),
                                device="cuda")
            o, s = opt.init_state(p), {}
            root = trng.generator(3)
            losses = []
            for c, (step0, scale) in enumerate(((0, 1.0), (10, 0.5))):
                chunk = feeds[10 * c:10 * c + 10]
                if graph:
                    p, o, s, h, _ = step.multi(p, o, s, stack_feeds(chunk),
                                               step0, root, lr_scale=scale)
                else:
                    hs = []
                    for k, f in enumerate(chunk):
                        p, o, s, h1, _ = step(
                            p, o, s, f, step0 + k,
                            trng.split_for_step(root, step0 + k),
                            lr_scale=scale)
                        hs.append(h1)
                    h = torch.stack(hs)
                losses.append(h)
            torch.cuda.synchronize()
            return p, o, torch.cat(losses), step.graphs_captured

        e1, e2, g = run(False), run(False), run(True)
        assert g[3] == 1 and e1[3] == 0
        for a, b, c, what in ((e1[0], e2[0], g[0], "params"),
                              (e1[1], e2[1], g[1], "opt_state"),
                              ({"h": e1[2]}, {"h": e2[2]}, {"h": g[2]},
                               "losses")):
            for k in a:
                x, y, z = a[k], b[k], c[k]
                if isinstance(x, dict):
                    pairs = [(x[s], y[s], z[s]) for s in x]
                else:
                    pairs = [(x, y, z)]
                for xe, ye, ze in pairs:
                    own = float((xe - ye).abs().max())
                    far = float((ze - xe).abs().max())
                    assert far <= 2 * own, (what, k, far, own)
