"""Mixed precision (the `matmul_precision` flag at "bfloat16") in the port
against the JAX package, on the CPU.

Under the flag both `Network`s keep f32 master parameters, hand every
compute layer bf16 operands and bf16 views of its parameters, and every
cost layer f32 ones (`network.py`'s cast rule, per consuming edge).

- The three checks of `tests/test_amp.py` on the port: a conv net trains
  under the flag with its masters, and the optimizer's slots, f32; a
  regression target consumed by a cost layer stays f32; so does one
  that also feeds a compute layer.
- The port against the JAX package under the flag, on the same numpy
  parameters and feed: the LM at test width (dense and flash
  attention), bench.py's long-context conf at a narrow width, the
  ResNet two-block net plain and fused (the JAX fused layers run their
  Pallas kernels in interpret mode), the IMDB classifier and the
  attention NMT at narrow widths (both of the port's RNN arms), and
  `ctr_wide_deep`. The loss within 1e-2 relative. Each gradient within
  2e-2 of its largest entry plus twice the distance bf16 moves the JAX
  gradient from its f32 value, and never more than 0.3 (a zeroed or
  detached gradient reads 1, a flipped one 2), of the JAX gradient
  under the flag or of the f32 one. The two packages round to bf16 at
  other places (XLA keeps f32 intermediates that PyTorch rounds, and
  sums in another order), and a gradient that cancels (conv weights
  before a BN in training mode, the NMT's attention projections at
  init) is bf16 noise in either package: the JAX gradient moves up to
  0.85 of its largest entry from f32 there (the two-block net's
  `_blk_b_c.w0`), the port's 0.22. The two-block net also runs with
  its BNs on their running statistics, where nothing cancels, and there
  every weight matrix (conv, fc, and the fused layers' B3 dw) is held
  at 2e-2 flat. The dtypes that show the rule ran: compute-layer
  outputs bf16, cost outputs f32, gradients f32.
- The numbers behind `chip_smoke.py`'s AMP gradient bound (phases 6c
  and 13b): how far bf16 moves the JAX package's gradients of the LM,
  the classifier and the NMT from f32 at the card's widths and weights
  (the batch cut), in relative L2 norm; and the port's own distance
  here within the bound the card holds it to.
- The bf16 plain versions of B1-B3 (`ops/bn_act_conv1x1.py`) against
  the JAX `bn_act_conv1x1` on bf16 inputs, forward and `jax.vjp`, at
  ragged shapes: bf16 outputs within one bf16 ulp of the JAX value plus
  1e-5 of the largest entry, f32 outputs within 1e-5 of the largest.
- The flash path under the flag: the LM and bench.py's long-context
  conf with attn_impl="flash", the port's bf16 flash forms against the
  JAX package's flash in bf16.
"""

import contextlib
import importlib.util
import os

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from paddle_tpu import dsl as jdsl
from paddle_tpu.core import arg as jarg
from paddle_tpu.core import flags as jflags
from paddle_tpu.models import ctr as jctr
from paddle_tpu.models import image as jimage
from paddle_tpu.models import lm as jlm
from paddle_tpu.models import text as jtext
from paddle_tpu.network import Network as JNetwork
from paddle_tpu.ops.pallas_fused import bn_act_conv1x1 as jfused
from paddle_tpu_torch import dsl as tdsl
from paddle_tpu_torch.core import arg as targ
from paddle_tpu_torch.core import flags as tflags
from paddle_tpu_torch.core.config import OptimizationConf as TOptConf
from paddle_tpu_torch.models import ctr as tctr
from paddle_tpu_torch.models import image as timage
from paddle_tpu_torch.models import lm as tlm
from paddle_tpu_torch.models import text as ttext
from paddle_tpu_torch.network import Network as TNetwork
from paddle_tpu_torch.ops import bn_act_conv1x1 as op
from paddle_tpu_torch.optimizers import create_optimizer
from paddle_tpu_torch.parallel.dp import TrainStep
from paddle_tpu_torch.weights import (
    fused_resnet_from_plain,
    params_from_numpy,
    params_to_numpy,
    state_from_numpy,
    state_to_numpy,
)

LOSS_RTOL = 1e-2
GRAD_TOL = 2e-2
GRAD_CAP = 0.3      # below a zeroed (1) or a flipped (2) gradient
BF16 = torch.bfloat16


@pytest.fixture
def amp():
    """The bf16 flag in both packages, reset after the test."""
    with _flags("bfloat16"):
        yield


def _rel(got, ref):
    got = np.asarray(got, np.float32)
    ref = np.asarray(ref, np.float32)
    assert got.shape == ref.shape
    return float(np.abs(got - ref).max()) / max(float(np.abs(ref).max()),
                                                1e-30)


# ---- the checks of tests/test_amp.py ------------------------------------

def _conv_net():
    with tdsl.model() as g:
        x = tdsl.data("img", (8, 8, 3))
        y = tdsl.data("y", 1, is_ids=True)
        h = tdsl.conv(x, 8, 3, padding=1, act="relu")
        h = tdsl.pool(h, 2, 2)
        out = tdsl.fc(h, size=4, name="logits")
        tdsl.classification_cost(out, y, name="cost")
        g.conf.output_layer_names.append("logits")
    return g.conf


def test_amp_trains_and_keeps_fp32_masters(amp):
    net = TNetwork(_conv_net())
    params = net.init_params(torch.Generator().manual_seed(0), device="cpu")
    opt = create_optimizer(
        TOptConf(learning_method="adam", learning_rate=0.01),
        net.param_confs)
    st = opt.init_state(params)
    rng = np.random.default_rng(0)
    img = rng.standard_normal((16, 8, 8, 3)).astype(np.float32)
    lab = (img.mean((1, 2, 3)) > 0).astype(np.int32) + 2 * (
        img[:, :4].mean((1, 2, 3)) > 0).astype(np.int32)
    feed = {"img": targ.non_seq(img), "y": targ.id_arg(lab)}
    step = TrainStep(net, opt, device="cpu")
    state = {}
    losses = []
    for i in range(40):
        params, st, state, loss, _outs = step(params, st, state, feed, i,
                                              None)
        losses.append(float(loss))
    assert losses[-1] < losses[0] * 0.5, (losses[0], losses[-1])
    for k, v in params.items():
        assert v.dtype == torch.float32, k
    for k, slots in st.items():
        for s, v in slots.items():
            if isinstance(v, torch.Tensor) and v.is_floating_point():
                assert v.dtype == torch.float32, (k, s)
    outs, _ = net.forward(params, feed, outputs=["logits"])
    assert outs["logits"].value.dtype == BF16
    assert net.loss_fn(params, feed)[0].dtype == torch.float32


def _target_net(extra_consumer):
    with tdsl.model() as g:
        x = tdsl.data("x", 4)
        t = tdsl.data("t", 1)
        out = tdsl.fc(x, size=1, name="pred")
        if extra_consumer:
            tdsl.scaling(t, out, name="side")   # a non-cost consumer of t
            g.conf.output_layer_names.extend(["pred", "side"])
        tdsl.square_error(out, t, name="cost")
    return g.conf


@pytest.mark.parametrize("extra_consumer", [False, True])
def test_amp_keeps_regression_targets_fp32(amp, extra_consumer):
    """A target consumed by a cost layer does not round-trip through
    bf16 (1000.3 would round to 1000), also where the same data layer
    feeds a compute layer: the cast is per consuming edge."""
    net = TNetwork(_target_net(extra_consumer))
    params = net.init_params(torch.Generator().manual_seed(0), device="cpu")
    feed = {"x": targ.non_seq(np.ones((2, 4), np.float32)),
            "t": targ.non_seq(np.full((2, 1), 1000.3, np.float32))}
    loss, (outs, _) = net.loss_fn(params, feed)
    pred = outs["pred"].value.float()
    want = float(torch.mean(0.5 * (pred[:, 0] - 1000.3) ** 2))
    assert abs(float(loss) - want) / want < 1e-3, (float(loss), want)
    if extra_consumer:
        assert outs["side"].value.dtype == BF16


# ---- the port against the JAX package under the flag --------------------

@contextlib.contextmanager
def _flags(precision, use_pallas_rnn=None):
    """`matmul_precision` (and `use_pallas_rnn`) in both packages."""
    for f in (jflags, tflags):
        f.set_flag("matmul_precision", precision)
        f.set_flag("use_pallas_rnn", use_pallas_rnn)
    try:
        yield
    finally:
        jflags.set_flag("matmul_precision", "default")
        jflags.set_flag("use_pallas_rnn", None)
        tflags.reset_flags()


def _jax_grads(jnet, np_p, jfeed, np_s=None, train=True):
    kw = {} if np_s is None else dict(
        state=jax.tree_util.tree_map(jnp.asarray, np_s), train=train)
    (loss, (_outs, state)), grads = jax.value_and_grad(
        jnet.loss_fn, has_aux=True)(
        {k: jnp.asarray(v) for k, v in np_p.items()}, jfeed, **kw)
    return float(loss), grads, state


def _port_grads(tnet, np_p, tfeed, np_s=None, train=True):
    tp = {k: v.requires_grad_(True)
          for k, v in params_from_numpy(np_p, device="cpu").items()}
    kw = {} if np_s is None else dict(
        state=state_from_numpy(np_s, device="cpu"), train=train)
    loss, (outs, state) = tnet.loss_fn(tp, tfeed, **kw)
    loss.backward()
    return loss, tp, outs, state


def _assert_parity(name, jnet, tnet, np_p, jfeed, tfeed, np_s=None,
                   use_pallas_rnn=None, train=True, flat=()):
    """Under the flag: the loss within LOSS_RTOL; each gradient within
    GRAD_TOL of its largest entry plus twice the distance bf16 itself
    moves the JAX gradient from its f32 value, capped at GRAD_CAP, of
    the JAX gradient under the flag or of the f32 one (a gradient that
    cancels, as BN's and attention's do at these widths, is bf16 noise
    to that distance in either package); the gradients named in `flat`
    within GRAD_TOL; and the dtypes that show the rule ran. Returns
    both new states."""
    with _flags("default", use_pallas_rnn):
        _l, jg32, _s = _jax_grads(jnet, np_p, jfeed, np_s, train)
    with _flags("bfloat16", use_pallas_rnn):
        jloss, jgrads, jstate = _jax_grads(jnet, np_p, jfeed, np_s, train)
        tloss, tp, touts, tstate = _port_grads(tnet, np_p, tfeed, np_s,
                                               train)
    assert tloss.dtype == torch.float32
    assert abs(tloss.item() - jloss) <= LOSS_RTOL * abs(jloss), (
        name, tloss.item(), jloss)
    assert sorted(jgrads) == sorted(tp)
    assert set(flat) <= set(tp), sorted(set(flat) - set(tp))
    for k, g in jgrads.items():
        assert tp[k].grad.dtype == torch.float32, k
        bound = GRAD_TOL if k in flat else min(
            GRAD_TOL + 2 * _rel(g, jg32[k]), GRAD_CAP)
        got = tp[k].grad.numpy()
        err = min(_rel(got, g), _rel(got, jg32[k]))
        assert err <= bound, f"{name} grad {k}: {err:.3g} > {bound:.3g}"
    n_compute = 0
    for layer, a in touts.items():
        lc = tnet.conf.layer(layer)
        if lc.type == "data" or a.value is None:
            continue
        want = (torch.float32 if getattr(tnet.layers[layer], "is_cost",
                                         False) else BF16)
        assert a.value.dtype == want, (layer, lc.type, a.value.dtype)
        n_compute += want == BF16
    assert n_compute > 0
    return jstate, tstate


LM_SPEC = dict(vocab=64, d_model=32, num_heads=2, num_layers=2,
               attn_impl="dense")
LM_LENS = np.asarray([24, 17, 5, 3], np.int32)


def _lm_parity(name, attn_impl):
    spec = {**LM_SPEC, "attn_impl": attn_impl}
    jspec = jlm.LMSpec(**spec)
    np_p = {k: np.asarray(v) for k, v in
            jlm.lm_init_params(jspec, jax.random.key(0)).items()}
    rng = np.random.default_rng(0)
    ids = rng.integers(2, 64, (4, 24)).astype(np.int32)
    lbl = rng.integers(2, 64, (4, 24)).astype(np.int32)
    _assert_parity(
        name, JNetwork(jlm.transformer_lm(jspec)),
        TNetwork(tlm.transformer_lm(tlm.LMSpec(**spec))), np_p,
        {"ids": jarg.id_arg(ids, LM_LENS), "label": jarg.id_arg(lbl, LM_LENS)},
        {"ids": targ.id_arg(ids, LM_LENS), "label": targ.id_arg(lbl, LM_LENS)})


def test_lm_matches_jax_under_the_flag():
    _lm_parity("lm", "dense")


def test_lm_flash_matches_jax_under_the_flag():
    """attn_impl="flash" under the flag: the port's bf16 flash (its bf16
    plain versions on the CPU) against the JAX package's flash (its
    blocked lowering off a TPU), both in bf16."""
    _lm_parity("lm_flash", "flash")


def test_lm_forward_stays_f32_under_the_flag():
    """models/lm.py::lm_forward, the served LM's functional forward,
    under the flag in both packages with attn_impl="flash": it takes no
    cast rule in either, so its logits stay f32 (the f32 flash forms:
    their plain versions here) and agree with the JAX package's at
    atol 1e-4 on the valid rows."""
    spec = {**LM_SPEC, "attn_impl": "flash"}
    jspec = jlm.LMSpec(**spec)
    jp = jlm.lm_init_params(jspec, jax.random.key(0))
    rng = np.random.default_rng(1)
    ids = rng.integers(2, 64, (4, 24)).astype(np.int32)
    with _flags("bfloat16"):
        ref = np.asarray(jlm.lm_forward(jspec, jp, ids, lens=LM_LENS))
        got = tlm.lm_forward(
            tlm.LMSpec(**spec),
            params_from_numpy({k: np.asarray(v) for k, v in jp.items()},
                              device="cpu"),
            torch.from_numpy(ids), lens=torch.from_numpy(LM_LENS))
    assert ref.dtype == np.float32 and got.dtype == torch.float32
    for r, n in enumerate(LM_LENS):
        np.testing.assert_allclose(got[r, :n].numpy(), ref[r, :n],
                                   atol=1e-4)


@pytest.mark.parametrize("attn_impl", ["flash", "dense"])
def test_longctx_matches_jax_under_the_flag(attn_impl):
    """bench.py::longctx_conf (the long-context trainer's model) at a
    narrow width, 2 layers, under the flag in both packages: the JAX
    conf from bench.py, the port's from chip_smoke.py's copy in its own
    DSL, one weight map, bench.py::longctx_feed's batch."""
    import bench

    cs = _chip_smoke()
    kw = dict(d=32, heads=2, layers=2, classes=16, vocab=64)
    tnet = TNetwork(cs.longctx_conf(attn_impl=attn_impl, **kw))
    np_p = params_to_numpy(tnet.init_params(
        torch.Generator().manual_seed(0), device="cpu"))
    _assert_parity(
        f"longctx_{attn_impl}",
        JNetwork(bench.longctx_conf(24, attn_impl=attn_impl, **kw)), tnet,
        np_p, bench.longctx_feed(2, 24, classes=16, vocab=64),
        cs.longctx_feed(2, 24, classes=16, vocab=64, device="cpu"))


def _tiny(dsl, image, fused):
    """The two-block net of `test_layers_extras.py::TestFusedBottleneck`
    (as tests/test_torch_image.py builds it)."""
    with dsl.model() as g:
        img = dsl.data("image", (8, 8, 16))
        lbl = dsl.data("label", (1,), is_ids=True)
        h = image._bottleneck("blk_a", img, 4, 1, project=True, fused=fused)
        h = image._bottleneck("blk_b", h, 4, 1, project=False, fused=fused)
        h = dsl.pool(h, 8, 1, pool_type="avg")
        out = dsl.fc(h, size=3, name="output", act="softmax")
        dsl.classification_cost(out, lbl, name="cost")
    return g.conf


def _perturbed(jnet, seed, state=False):
    """The JAX init with 1-D parameters perturbed (and a running state
    away from its start), as numpy."""
    rng = np.random.default_rng(seed)
    p = {}
    for k, v in jnet.init_params(jax.random.key(seed)).items():
        v = np.asarray(v)
        if v.ndim == 1:
            v = v + 0.3 * rng.standard_normal(v.shape).astype(np.float32)
        p[k] = v
    if not state:
        return p
    s = {layer: {n: (np.asarray(v) + 0.2 * np.abs(rng.standard_normal(
        v.shape))).astype(np.float32) for n, v in slots.items()}
        for layer, slots in jnet.init_state().items()}
    return p, s


def _tiny_case(fused):
    """(JAX net, port net, params, state, JAX feed, port feed) of the
    two-block net from one numpy map."""
    np_p, np_s = _perturbed(JNetwork(_tiny(jdsl, jimage, False)), 3,
                            state=True)
    tnet = TNetwork(_tiny(tdsl, timage, fused))
    if fused:
        np_p, np_s = fused_resnet_from_plain(tnet, np_p, np_s)
    rng = np.random.default_rng(0)
    x = rng.standard_normal((4, 8, 8, 16)).astype(np.float32)
    y = rng.integers(0, 3, 4).astype(np.int32)
    return (JNetwork(_tiny(jdsl, jimage, fused)), tnet, np_p, np_s,
            {"image": jarg.non_seq(jnp.asarray(x)), "label": jarg.id_arg(y)},
            {"image": targ.non_seq(x), "label": targ.id_arg(y)})


@pytest.mark.parametrize("fused", [False, True])
def test_tiny_resnet_matches_jax_under_the_flag(fused):
    jnet, tnet, np_p, np_s, jfeed, tfeed = _tiny_case(fused)
    jstate, tstate = _assert_parity(f"resnet fused={fused}", jnet, tnet,
                                    np_p, jfeed, tfeed, np_s)
    for layer, slots in state_to_numpy(tstate).items():
        for s, v in slots.items():
            assert tstate[layer][s].dtype == torch.float32
            err = _rel(v, jstate[layer][s])
            assert err <= GRAD_TOL, f"state {layer}.{s}: {err:.3g}"
    if fused:
        assert sum(lc.type.startswith("fused_")
                   for lc in tnet.conf.layers) == 4


@pytest.mark.parametrize("fused", [False, True])
def test_tiny_resnet_on_running_stats_matches_jax_under_the_flag(fused):
    """The BNs on their running statistics (use_global_stats, as in
    test mode): no batch statistics, so no gradient cancels in them,
    and every weight matrix — among them the fused layers' dw, from
    B3's bf16 plain version and its cast to w's dtype — is held at
    GRAD_TOL flat."""
    jnet, tnet, np_p, np_s, jfeed, tfeed = _tiny_case(fused)
    flat = [k for k, v in np_p.items() if v.ndim >= 2]
    assert len(flat) == 8          # seven convs and the fc
    _assert_parity(f"resnet fused={fused} running stats", jnet, tnet, np_p,
                   jfeed, tfeed, np_s, train=False, flat=flat)


TEXT = {
    "classifier": ("stacked_lstm_classifier",
                   dict(vocab_size=50, emb_dim=8, hidden=16)),
    "nmt": ("seq2seq_attention",
            dict(src_vocab=40, trg_vocab=30, emb_dim=8, hidden=16)),
}
# lengths >= 1: a zero-length row pools to -1e30 under max pooling, and
# its logits would then hold the whole loss
TEXT_LENS = np.asarray([13, 2, 1, 7, 12], np.int32)


def _text_batch(name, seed):
    rng = np.random.default_rng(seed)
    if name == "classifier":
        return {"words": (rng.integers(0, 50, (5, 13)), TEXT_LENS),
                "label": (rng.integers(0, 2, 5), None)}
    return {k: (rng.integers(2, 30, (5, 13)), TEXT_LENS)
            for k in ("src", "trg_in", "trg_out")}


@pytest.mark.parametrize("rnn_arm", ["kernels", "scan"])
@pytest.mark.parametrize("name", sorted(TEXT))
def test_text_matches_jax_under_the_flag(name, rnn_arm):
    """Each of the port's RNN arms against the JAX layer's same arm: the
    sequence kernels' path (here the plain versions; f32 inside, bf16
    cast up around them in both packages; the JAX kernels in interpret
    mode) and the masked scan (bf16 throughout in both)."""
    fn, kw = TEXT[name]
    batch = _text_batch(name, 2)
    jnet = JNetwork(getattr(jtext, fn)(**kw))
    _assert_parity(
        f"{name} {rnn_arm}", jnet, TNetwork(getattr(ttext, fn)(**kw)),
        _perturbed(jnet, 1),
        {k: jarg.id_arg(ids.astype(np.int32), lens)
         for k, (ids, lens) in batch.items()},
        {k: targ.id_arg(ids.astype(np.int32), lens)
         for k, (ids, lens) in batch.items()},
        use_pallas_rnn=True if rnn_arm == "kernels" else None)


def test_ctr_wide_deep_matches_jax_under_the_flag():
    kw = dict(feature_dim=1000, emb_dim=8, hidden=(16, 8))
    jnet = JNetwork(jctr.ctr_wide_deep(**kw))
    tnet = TNetwork(tctr.ctr_wide_deep(**kw))
    rng = np.random.default_rng(1)
    np_p = {k: np.asarray(v) + 0.1 * rng.standard_normal(
        np.shape(v)).astype(np.float32)
        for k, v in jnet.init_params(jax.random.key(1)).items()}
    feats = rng.integers(0, 1000, (32, 8)).astype(np.int32)
    lens = rng.integers(1, 9, 32).astype(np.int32)
    label = (feats < 120).any(axis=1).astype(np.int32)
    _assert_parity(
        "ctr_wide_deep", jnet, tnet, np_p,
        {"features": jarg.id_arg(jnp.asarray(feats), jnp.asarray(lens)),
         "label": jarg.id_arg(jnp.asarray(label))},
        {"features": targ.id_arg(feats, lens), "label": targ.id_arg(label)})
    # the sparse tables' gradients reach their f32 masters in f32, so the
    # row updater (B9) runs its f32 form under the flag
    with _flags("bfloat16"):
        _l, tp, _o, _s = _port_grads(tnet, np_p, {
            "features": targ.id_arg(feats, lens),
            "label": targ.id_arg(label)})
    assert tp["wide_w"].grad.dtype == tp["deep_emb"].grad.dtype == (
        torch.float32)


# ---- the JAX package's own bf16 distance at the card's widths -----------

def _chip_smoke():
    """chip_smoke.py, at the root of the repo, as a module (it imports
    nothing beyond numpy until it runs)."""
    path = os.path.join(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))), "chip_smoke.py")
    spec = importlib.util.spec_from_file_location("chip_smoke", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _card_case(cs, model):
    """(JAX net, port net, numpy params, JAX feed, port feed) of
    chip_smoke.py's phase 6c (the LM), 6d (the long-context conf, flash)
    or 13b (the classifier, the NMT): the card's widths and weights, the
    batch cut (4 rows; the classifier 8; the long-context conf 2 rows of
    T = 256, bench.py::longctx_feed's)."""
    rng = np.random.default_rng(0)
    if model == "longctx":
        import bench

        kw = dict(cs.LONGCTX, attn_impl="flash")
        fkw = dict(classes=kw["classes"], vocab=kw["vocab"])
        return (JNetwork(bench.longctx_conf(256, **kw)),
                TNetwork(cs.longctx_conf(**kw)),
                cs.longctx_params(torch), bench.longctx_feed(2, 256, **fkw),
                cs.longctx_feed(2, 256, device="cpu", **fkw))
    if model == "lm":
        spec = dict(vocab=2048, d_model=256, num_heads=4, num_layers=2,
                    attn_impl="dense")
        jnet = JNetwork(jlm.transformer_lm(jlm.LMSpec(**spec)))
        tnet = TNetwork(tlm.transformer_lm(tlm.LMSpec(**spec)))
        np_p = cs.random_params(tlm.LMSpec(**spec), tlm)
        lens = np.full(4, 128, np.int32)
        ids, lbl, _ = cs.lm_batches(np.random.default_rng(cs.SEED + 2), 1,
                                    4, 128, lens, spec["vocab"])[0]
        batch = {"ids": (ids, lens), "label": (lbl, lens)}
    else:
        fn, kw, b, t = {
            "classifier": ("stacked_lstm_classifier", cs.CLS, 8, cs.CLS_T),
            "nmt": ("seq2seq_attention", cs.NMT, 4, cs.NMT_T)}[model]
        jnet = JNetwork(getattr(jtext, fn)(**kw))
        tnet = TNetwork(getattr(ttext, fn)(**kw))
        np_p = params_to_numpy(tnet.init_params(
            torch.Generator().manual_seed(cs.SEED + 1), device="cpu"))
        lens = np.full(b, t, np.int32)
        if model == "classifier":
            batch = {"words": (rng.integers(0, kw["vocab_size"], (b, t)),
                               lens),
                     "label": (rng.integers(0, 2, b), None)}
        else:
            batch = {k: (rng.integers(2, kw["src_vocab"], (b, t)), lens)
                     for k in ("src", "trg_in", "trg_out")}
    return (jnet, tnet, np_p,
            {k: jarg.id_arg(np.asarray(i, np.int32), n)
             for k, (i, n) in batch.items()},
            {k: targ.id_arg(np.asarray(i, np.int32), n)
             for k, (i, n) in batch.items()})


def _floored(grads, ref, floor):
    """chip_smoke.py's distance of each gradient from its reference: the
    norm of the difference over the reference's norm, or over `floor`
    of the largest reference norm where its own is below that."""
    ref = {k: np.asarray(v, np.float64) for k, v in ref.items()}
    top = max(float(np.linalg.norm(v)) for v in ref.values())
    return {k: float(np.linalg.norm(np.asarray(grads[k], np.float64) - v))
            / max(float(np.linalg.norm(v)), floor * top)
            for k, v in ref.items()}


@pytest.mark.parametrize("model", ["lm", "classifier", "nmt", "longctx"])
def test_card_amp_readings(model):
    """The numbers behind chip_smoke.py's AMP gradient bound (phases 6c,
    6d and 13b): the largest distance bf16 moves the JAX package's
    gradient of each model from f32 at the card's widths and weights
    (the batch cut; the JAX RNNs on their masked scan, its flash on the
    blocked lowering), within 5% of `JAX_BF16_GRAD_MOVE`; and the port's
    own distance here within the bound the card holds it to."""
    cs = _chip_smoke()
    jnet, tnet, np_p, jfeed, tfeed = _card_case(cs, model)
    with _flags("default"):
        _l, j32, _s = _jax_grads(jnet, np_p, jfeed)
        _l, t32, _o, _s = _port_grads(tnet, np_p, tfeed)
    with _flags("bfloat16"):
        _l, j16, _s = _jax_grads(jnet, np_p, jfeed)
        _l, t16, _o, _s = _port_grads(tnet, np_p, tfeed)
    moved = _floored(j16, j32, cs.AMP_GRAD_FLOOR)
    want = cs.JAX_BF16_GRAD_MOVE[model]
    assert abs(max(moved.values()) - want) <= 0.05 * want, (
        model, max(moved, key=moved.get), max(moved.values()), want)
    bound = min(cs.AMP_GRAD_TOL + 2 * want, cs.AMP_GRAD_CAP)
    port = _floored({k: v.grad for k, v in t16.items()},
                    {k: v.grad for k, v in t32.items()}, cs.AMP_GRAD_FLOOR)
    assert max(port.values()) <= bound, (
        model, max(port, key=port.get), max(port.values()), bound)


# ---- the bf16 plain versions of B1-B3 against the JAX op ----------------

# (N, Cin, Cout, act, with_res): ragged rows against any tile
FUSED_CASES = {
    "relu_res_n100_24_16": (100, 24, 16, "relu", True),
    "linear_n37_40_56": (37, 40, 56, "", False),
}


def _bf16_close(got, ref, name):
    """Element by element within one bf16 ulp of the reference value
    plus 1e-5 of the reference's largest entry."""
    got = torch.tensor(np.asarray(got, np.float32))
    ref = torch.tensor(np.asarray(ref, np.float32))
    ulp = torch.ldexp(torch.ones_like(ref),
                      torch.frexp(ref)[1] - 8)   # bf16: 8 significant bits
    bound = ulp + 1e-5 * ref.abs().max()
    bad = (got - ref).abs() > bound
    assert not bad.any(), f"{name}: {int(bad.sum())} elements off"


def _f32_close(got, ref, name):
    err = _rel(np.asarray(got, np.float32), np.asarray(ref, np.float32))
    assert err <= 1e-5, f"{name}: {err:.3g}"


@pytest.mark.parametrize("case", sorted(FUSED_CASES))
def test_bf16_plain_fused_op_matches_jax(case):
    n, cin, cout, act, with_res = FUSED_CASES[case]
    rng = np.random.default_rng(7)
    f = lambda *s: rng.standard_normal(s).astype(np.float32)  # noqa: E731
    u, r, w = f(n, cin), f(n, cin), 0.1 * f(cin, cout)
    sc, sh = f(cin), f(cin)
    dy, d1, d2 = f(n, cout), f(cout), 0.01 * f(cout)
    jb = lambda x: jnp.asarray(x, jnp.bfloat16)   # noqa: E731
    res = jb(r) if with_res else None

    def jfn(u, sc, sh, w, *rest):
        return jfused(u, sc, sh, w, residual=rest[0] if rest else None,
                      act=act)

    jargs = (jb(u), jnp.asarray(sc), jnp.asarray(sh), jb(w)) + (
        (res,) if with_res else ())
    (jy, js1, js2), vjp = jax.vjp(jfn, *jargs)
    jgrads = vjp((jb(dy), jnp.asarray(d1), jnp.asarray(d2)))

    tb = lambda x: torch.from_numpy(x).to(BF16)   # noqa: E731
    targs = [tb(u), torch.from_numpy(sc), torch.from_numpy(sh), tb(w)]
    tres = tb(r) if with_res else None
    y, s1, s2 = op.bn_act_conv1x1_plain(*targs, residual=tres, act=act)
    assert (y.dtype, s1.dtype, s2.dtype) == (BF16, torch.float32,
                                             torch.float32)
    _bf16_close(y.float(), jy.astype(jnp.float32), f"{case} y")
    _f32_close(s1, js1, f"{case} ssum")
    _f32_close(s2, js2, f"{case} ssq")

    leaves = [x.clone().requires_grad_(True) for x in targs] + (
        [tres.clone().requires_grad_(True)] if with_res else [])
    ty, ts1, ts2 = op.bn_act_conv1x1(*leaves[:4], residual=(
        leaves[4] if with_res else None), act=act)
    torch.autograd.backward((ty, ts1, ts2), (tb(dy), torch.from_numpy(d1),
                                             torch.from_numpy(d2)))
    for nm, leaf, g in zip(("du", "dscale", "dshift", "dw", "dres"), leaves,
                           jgrads):
        assert leaf.grad.dtype == leaf.dtype, nm
        if leaf.dtype == BF16:
            _bf16_close(leaf.grad.float(), g.astype(jnp.float32),
                        f"{case} {nm}")
        else:
            _f32_close(leaf.grad, g, f"{case} {nm}")
