"""The port's image slice against the JAX package's, on the CPU.

Each conf is built twice from one description — once through
`paddle_tpu.dsl`, once through the port's copy — and both networks run
on the same numpy parameters, state and feed (numpy seeds). f32 on the
CPU in both; the JAX fused layers run their Pallas kernels in interpret
mode.

- `ConvLayer` (stride, padding, dilation, groups, bias, rectangular
  filters, a flat input with num_channels), `PoolLayer` (max; avg with
  the padding left out of the divisor, with PyTorch's own padding and
  with the explicit padding it needs beyond half a window),
  `BatchNormLayer` (train and eval, non-sequence and masked sequence,
  and the new state), and `fc` over a [B, 1, 1, C] pooled input: the
  output within 1e-5 of the JAX output's largest entry (other summation
  orders), the state within rtol 1e-5.
- The two-block net of `test_layers_extras.py::TestFusedBottleneck`,
  plain and fused: loss (rtol 1e-5), every gradient and the new state
  (5e-5 of each one's largest entry: ten layers of f32 round-off, and
  the fused graph's one-pass variance E[y^2] - E[y]^2), and one momentum
  `TrainStep` (params, momentum and BN state, same bound).
- Fused against plain in the port, from one weight map
  (`weights.fused_resnet_from_plain`): loss, every gradient and the new
  state (5e-5 relative, the variance formulas differ), the running
  statistics advance in training and are read in eval.
- The F1 and F2 repairs: the watchdog keeps every BN slot of a NaN
  batch bit-equal and the state leaves the step detached; state is made
  on the requested device, and on the card unless the caller asks for
  the CPU.
- `resnet(50)` confs, fused and plain, equal in both packages (JSON,
  parameter and state shapes); one fused CPU forward of a 32x32
  ResNet-50 through `Inferencer(device="cpu")`.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from paddle_tpu import dsl as jdsl
from paddle_tpu.core import arg as jarg
from paddle_tpu.core.config import OptimizationConf as JOptConf
from paddle_tpu.models import image as jimage
from paddle_tpu.network import Network as JNetwork
from paddle_tpu.optimizers import create_optimizer as jcreate_optimizer
from paddle_tpu.parallel.dp import TrainStep as JTrainStep
from paddle_tpu.trainer.trainer import Inferencer as JInferencer
from paddle_tpu_torch import dsl as tdsl
from paddle_tpu_torch.core import arg as targ
from paddle_tpu_torch.core.config import OptimizationConf as TOptConf
from paddle_tpu_torch.models import image as timage
from paddle_tpu_torch.network import Network as TNetwork
from paddle_tpu_torch.optimizers import create_optimizer as tcreate_optimizer
from paddle_tpu_torch.parallel.dp import TrainStep as TTrainStep
from paddle_tpu_torch.trainer.trainer import SGD as TSGD
from paddle_tpu_torch.trainer.trainer import Inferencer as TInferencer
from paddle_tpu_torch.weights import (
    fused_resnet_from_plain,
    fused_resnet_map,
    opt_state_to_numpy,
    params_from_numpy,
    params_to_numpy,
    state_from_numpy,
    state_to_numpy,
)

LAYER_TOL = 1e-5
NET_TOL = 5e-5
B, H, W, C = 3, 8, 8, 4
LENS = np.asarray([5, 2, 7], np.int32)
MOMENTUM = dict(learning_method="momentum", learning_rate=0.01, momentum=0.9)


def _rel(got, ref):
    got, ref = np.asarray(got), np.asarray(ref)
    assert got.shape == ref.shape
    return float(np.abs(got - ref).max()) / max(float(np.abs(ref).max()),
                                                1e-30)


def _assert_rel(got, ref, tol, name):
    err = _rel(got, ref)
    assert err <= tol, f"{name}: {err:.3g} relative to max > {tol}"


# ---- single layers -------------------------------------------------------

def _layer_conf(dsl, kind):
    """A small conf whose layer `out` is of the kind under test."""
    with dsl.model() as g:
        img = dsl.data("img", (H, W, C))
        flat = dsl.data("flat", (H * W * C,))
        seq = dsl.data("seq", 6, is_seq=True)
        if kind == "conv_stride_pad_bias":
            dsl.conv(img, 6, 3, stride=2, padding=1, act="relu", name="out")
        elif kind == "conv_dilation_nobias":
            dsl.conv(img, 5, 3, padding=2, dilation=2, act="", bias=False,
                     name="out")
        elif kind == "conv_groups":
            dsl.conv(img, 6, 3, padding=1, groups=2, act="tanh", name="out")
        elif kind == "conv_rect":
            dsl.conv(img, 4, (3, 1), stride=(1, 2), padding=(1, 0), act="",
                     name="out")
        elif kind == "conv_flat_num_channels":
            dsl.conv(flat, 4, 3, padding=1, num_channels=C, name="out")
        elif kind.startswith("pool_"):
            _, ptype, k, s, p = kind.split("_")
            dsl.pool(img, int(k), int(s), padding=int(p), pool_type=ptype,
                     name="out")
        elif kind in ("bn_train", "bn_eval"):
            dsl.batch_norm(img, act="relu", name="out")
        elif kind in ("bn_seq_train", "bn_seq_eval"):
            dsl.batch_norm(seq, act="", name="out")
        elif kind == "fc_pooled":
            h = dsl.pool(img, H, 1, pool_type="avg", name="gap")
            dsl.fc(h, size=5, act="", name="out")
        else:
            raise ValueError(kind)
    return g.conf


LAYER_KINDS = [
    "conv_stride_pad_bias", "conv_dilation_nobias", "conv_groups",
    "conv_rect", "conv_flat_num_channels",
    "pool_max_3_2_1", "pool_avg_3_2_1", "pool_avg_2_2_1", "pool_max_3_1_2",
    "pool_avg_3_2_2", "pool_avg_8_1_0",
    "bn_train", "bn_eval", "bn_seq_train", "bn_seq_eval", "fc_pooled",
]


def _np_params(jnet, seed):
    """The JAX init, with 1-D parameters (BN gamma/beta, biases)
    perturbed so that they are not trivially 1 and 0."""
    rng = np.random.default_rng(seed)
    out = {}
    for k, v in jnet.init_params(jax.random.key(seed)).items():
        v = np.asarray(v)
        if v.ndim == 1:
            v = v + 0.3 * rng.standard_normal(v.shape).astype(np.float32)
        out[k] = v
    return out


def _np_state(jnet, seed):
    """A running state away from its initial value."""
    rng = np.random.default_rng(seed)
    return {layer: {s: (np.asarray(v) + 0.2 * np.abs(rng.standard_normal(
        v.shape))).astype(np.float32) for s, v in slots.items()}
        for layer, slots in jnet.init_state().items()}


def _np_feed(seed=0, batch=B):
    rng = np.random.default_rng(seed)
    return {
        "img": rng.standard_normal((batch, H, W, C)).astype(np.float32),
        "flat": rng.standard_normal((batch, H * W * C)).astype(np.float32),
        "seq": rng.standard_normal((batch, 7, 6)).astype(np.float32),
    }


def _feeds(np_feed):
    jf = {"img": jarg.non_seq(jnp.asarray(np_feed["img"])),
          "flat": jarg.non_seq(jnp.asarray(np_feed["flat"])),
          "seq": jarg.seq(jnp.asarray(np_feed["seq"]), LENS)}
    tf = {"img": targ.non_seq(np_feed["img"]),
          "flat": targ.non_seq(np_feed["flat"]),
          "seq": targ.seq(np_feed["seq"], LENS)}
    return jf, tf


@pytest.mark.parametrize("kind", LAYER_KINDS)
def test_layer_matches_jax(kind):
    jnet, tnet = JNetwork(_layer_conf(jdsl, kind)), TNetwork(
        _layer_conf(tdsl, kind))
    assert {k: tuple(p.dims) for k, p in tnet.param_confs.items()} == {
        k: tuple(p.dims) for k, p in jnet.param_confs.items()}
    np_p, np_s = _np_params(jnet, 0), _np_state(jnet, 1)
    jf, tf = _feeds(_np_feed())
    train = kind.endswith("train")
    jouts, jstate = jnet.forward({k: jnp.asarray(v) for k, v in np_p.items()},
                                 jf, state=jax.tree_util.tree_map(
                                     jnp.asarray, np_s),
                                 train=train, outputs=["out"])
    touts, tstate = tnet.forward(params_from_numpy(np_p, device="cpu"), tf,
                                 state=state_from_numpy(np_s, device="cpu"),
                                 train=train, outputs=["out"])
    _assert_rel(touts["out"].value.numpy(), jouts["out"].value, LAYER_TOL,
                kind)
    assert sorted(tstate) == sorted(jstate)
    for layer, slots in state_to_numpy(tstate).items():
        for s, v in slots.items():
            np.testing.assert_allclose(v, np.asarray(jstate[layer][s]),
                                       rtol=LAYER_TOL, atol=1e-7,
                                       err_msg=f"{layer}.{s}")
    if train and kind.startswith("bn"):
        assert not np.array_equal(tstate["out"]["mean"], np_s["out"]["mean"])


def test_pool_divisor_leaves_padding_out():
    """A 3x3 average at a corner with padding 1 divides by the 4 real
    elements, not 9; max pooling pads with -inf, so an all-negative
    corner keeps its own maximum."""
    with tdsl.model() as g:
        img = tdsl.data("img", (4, 4, 1))
        tdsl.pool(img, 3, 2, padding=1, pool_type="avg", name="avg")
        tdsl.pool(img, 3, 2, padding=1, pool_type="max", name="max")
    net = TNetwork(g.conf)
    x = -np.arange(1, 17, dtype=np.float32).reshape(1, 4, 4, 1)
    outs, _ = net.forward({}, {"img": targ.non_seq(x)})
    corner = x[0, :2, :2, 0]
    assert outs["avg"].value[0, 0, 0, 0].item() == pytest.approx(
        corner.mean())
    assert outs["max"].value[0, 0, 0, 0].item() == corner.max()


# ---- the two-block net of TestFusedBottleneck -----------------------------

def _tiny(dsl, image, fused):
    with dsl.model() as g:
        img = dsl.data("image", (8, 8, 16))
        lbl = dsl.data("label", (1,), is_ids=True)
        h = image._bottleneck("blk_a", img, 4, 1, project=True, fused=fused)
        h = image._bottleneck("blk_b", h, 4, 1, project=False, fused=fused)
        h = dsl.pool(h, 8, 1, pool_type="avg")
        out = dsl.fc(h, size=3, name="output", act="softmax")
        dsl.classification_cost(out, lbl, name="cost")
    return g.conf


def _tiny_feeds(seed=0, batch=4):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((batch, 8, 8, 16)).astype(np.float32)
    y = rng.integers(0, 3, batch).astype(np.int32)
    return ({"image": jarg.non_seq(jnp.asarray(x)), "label": jarg.id_arg(y)},
            {"image": targ.non_seq(x), "label": targ.id_arg(y)})


@pytest.fixture(scope="module")
def tiny_weights():
    """Plain-graph numpy params and state (from the JAX init, perturbed)
    and the same mapped onto the fused graph."""
    jplain = JNetwork(_tiny(jdsl, jimage, False))
    np_p, np_s = _np_params(jplain, 3), _np_state(jplain, 4)
    fnet = TNetwork(_tiny(tdsl, timage, True))
    np_fp, np_fs = fused_resnet_from_plain(fnet, np_p, np_s)
    return {False: (np_p, np_s), True: (np_fp, np_fs)}


@pytest.mark.parametrize("fused", [False, True])
def test_tiny_resnet_loss_gradients_state_match_jax(tiny_weights, fused):
    np_p, np_s = tiny_weights[fused]
    jnet = JNetwork(_tiny(jdsl, jimage, fused))
    tnet = TNetwork(_tiny(tdsl, timage, fused))
    jf, tf = _tiny_feeds()
    (jloss, (_o, jstate)), jgrads = jax.value_and_grad(
        jnet.loss_fn, has_aux=True)(
        {k: jnp.asarray(v) for k, v in np_p.items()}, jf,
        state=jax.tree_util.tree_map(jnp.asarray, np_s), train=True)
    tp = {k: v.requires_grad_(True) for k, v in
          params_from_numpy(np_p, device="cpu").items()}
    tloss, (_to, tstate) = tnet.loss_fn(
        tp, tf, state=state_from_numpy(np_s, device="cpu"), train=True)
    tloss.backward()
    np.testing.assert_allclose(tloss.item(), float(jloss), rtol=1e-5)
    assert sorted(jgrads) == sorted(tp)
    for k, g in jgrads.items():
        _assert_rel(tp[k].grad.numpy(), g, NET_TOL, f"grad {k}")
    for layer, slots in state_to_numpy(tstate).items():
        for s, v in slots.items():
            _assert_rel(v, jstate[layer][s], NET_TOL, f"state {layer}.{s}")
            assert not tstate[layer][s].requires_grad


@pytest.mark.parametrize("fused", [False, True])
def test_tiny_resnet_momentum_step_matches_jax(tiny_weights, fused):
    np_p, np_s = tiny_weights[fused]
    jnet = JNetwork(_tiny(jdsl, jimage, fused))
    tnet = TNetwork(_tiny(tdsl, timage, fused))
    jopt = jcreate_optimizer(JOptConf(**MOMENTUM), jnet.param_confs)
    topt = tcreate_optimizer(TOptConf(**MOMENTUM), tnet.param_confs)
    jf, tf = _tiny_feeds(seed=1)
    jp = {k: jnp.asarray(v) for k, v in np_p.items()}
    jnp_, jos, jst, _l, _o = JTrainStep(jnet, jopt, donate=False)(
        jp, jopt.init_state(jp), jax.tree_util.tree_map(jnp.asarray, np_s),
        jf, 0, None)
    tp = params_from_numpy(np_p, device="cpu")
    tnp, tos, tst, _tl, _to = TTrainStep(tnet, topt, device="cpu")(
        tp, topt.init_state(tp), state_from_numpy(np_s, device="cpu"), tf, 0,
        None)
    for k, v in params_to_numpy(tnp).items():
        _assert_rel(v, jnp_[k], NET_TOL, f"param {k}")
    for k, slots in opt_state_to_numpy(tos).items():
        _assert_rel(slots["mom"], jos[k]["mom"], NET_TOL, f"momentum {k}")
    for layer, slots in state_to_numpy(tst).items():
        for s, v in slots.items():
            _assert_rel(v, jst[layer][s], NET_TOL, f"state {layer}.{s}")


def test_tiny_fused_matches_plain_in_the_port(tiny_weights):
    """TestFusedBottleneck.test_forward_and_grad_parity on the port:
    one weight map, the loss, every gradient and the new state of the
    fused graph against the plain graph's."""
    plain = TNetwork(_tiny(tdsl, timage, False))
    fused = TNetwork(_tiny(tdsl, timage, True))
    pmap, smap = fused_resnet_map(fused)
    _jf, tf = _tiny_feeds(seed=2)
    out = {}
    for is_fused, net in ((False, plain), (True, fused)):
        np_p, np_s = tiny_weights[is_fused]
        p = {k: v.requires_grad_(True) for k, v in
             params_from_numpy(np_p, device="cpu").items()}
        loss, (_o, st) = net.loss_fn(p, tf, state=state_from_numpy(
            np_s, device="cpu"), train=True)
        loss.backward()
        out[is_fused] = (loss.item(), p, st)
    (lp, pp, sp), (lf, pf, sf) = out[False], out[True]
    np.testing.assert_allclose(lf, lp, rtol=1e-5)
    for k, src in pmap.items():
        _assert_rel(pf[k].grad.reshape(pp[src].shape).numpy(),
                    pp[src].grad.numpy(), NET_TOL, f"grad {k} vs {src}")
    for layer, slots in smap.items():
        for s, (pl, ps) in slots.items():
            _assert_rel(sf[layer][s].numpy(), sp[pl][ps].numpy(), NET_TOL,
                        f"state {layer}.{s}")


def test_inference_uses_running_stats(tiny_weights):
    """TestFusedBottleneck.test_inference_uses_running_stats on the port,
    and the port's Inferencer against the JAX Inferencer on the
    advanced state, fused and plain."""
    fused = TNetwork(_tiny(tdsl, timage, True))
    np_p, np_s = tiny_weights[True]
    p = params_from_numpy(np_p, device="cpu")
    st = fused.init_state("cpu")
    _jf, tf = _tiny_feeds(seed=3, batch=2)
    with torch.no_grad():
        _l, (_o, st1) = fused.loss_fn(p, tf, state=st, train=True)
    assert not torch.equal(st1["blk_a_tail"]["out_mean"],
                           st["blk_a_tail"]["out_mean"])
    o1, _ = fused.forward(p, tf, state=st1, train=False)
    o2, _ = fused.forward(p, tf, state=st1, train=False)
    assert torch.equal(o1["output"].value, o2["output"].value)

    jf, tf = _tiny_feeds(seed=4)
    for is_fused in (False, True):
        np_p, np_s = tiny_weights[is_fused]
        jnet = JNetwork(_tiny(jdsl, jimage, is_fused))
        want = JInferencer(jnet, {k: jnp.asarray(v) for k, v in np_p.items()},
                           jax.tree_util.tree_map(jnp.asarray, np_s),
                           outputs=["output"]).infer({"image": jf["image"]})
        got = TInferencer(TNetwork(_tiny(tdsl, timage, is_fused)),
                          params_from_numpy(np_p, device="cpu"),
                          state_from_numpy(np_s, device="cpu"),
                          outputs=["output"], device="cpu").infer(
            {"image": tf["image"]})
        _assert_rel(got["output"], want["output"], LAYER_TOL,
                    f"inference fused={is_fused}")


# ---- the F1 and F2 repairs -----------------------------------------------

def _bn_mlp():
    with tdsl.model() as m:
        x = tdsl.data("x", dim=6)
        y = tdsl.data("label", dim=(), is_ids=True)
        h = tdsl.fc(x, size=8, act="", bias=False, name="h")
        h = tdsl.batch_norm(h, act="relu", name="h_bn")
        o = tdsl.fc(h, size=3, name="o")
        tdsl.classification_cost(o, y)
    return m.conf


def test_watchdog_keeps_batch_norm_state_of_a_nan_batch():
    """F1: the watchdog's keep reaches every slot of a layer's state."""
    rng = np.random.default_rng(0)

    def feed(bad=False):
        x = rng.standard_normal((8, 6)).astype(np.float32)
        if bad:
            x[3, 2] = np.nan
        return {"x": targ.non_seq(x),
                "label": targ.id_arg(rng.integers(0, 3, 8).astype(np.int32))}

    sgd = TSGD(_bn_mlp(), TOptConf(**MOMENTUM), seed=1, watchdog=True,
               device="cpu")
    init = state_to_numpy(sgd.state)
    cost, finite, _ = sgd.run_step(feed())
    assert finite and np.isfinite(cost)
    after = state_to_numpy(sgd.state)
    assert not np.array_equal(after["h_bn"]["mean"], init["h_bn"]["mean"])
    assert not np.array_equal(after["h_bn"]["var"], init["h_bn"]["var"])
    for slots in sgd.state.values():
        for t in slots.values():
            assert t.grad_fn is None and not t.requires_grad
    before = (params_to_numpy(sgd.params), opt_state_to_numpy(sgd.opt_state),
              after)
    cost, finite, _ = sgd.run_step(feed(bad=True))
    assert np.isnan(cost) and not finite
    kept = (params_to_numpy(sgd.params), opt_state_to_numpy(sgd.opt_state),
            state_to_numpy(sgd.state))
    for k, v in kept[0].items():
        np.testing.assert_array_equal(v, before[0][k])
    for k, slots in kept[1].items():
        for s, v in slots.items():
            np.testing.assert_array_equal(v, before[1][k][s])
    for layer, slots in kept[2].items():
        for s, v in slots.items():
            np.testing.assert_array_equal(v, before[2][layer][s])
    sgd.run_step(feed())
    assert not np.array_equal(state_to_numpy(sgd.state)["h_bn"]["mean"],
                              before[2]["h_bn"]["mean"])


def test_state_is_made_on_the_requested_device(monkeypatch):
    """F2: init_state takes a device, resolved as init_params resolves
    it: the card unless the caller asks for the CPU."""
    net = TNetwork(_bn_mlp())
    st = net.init_state(device="cpu")
    assert st["h_bn"]["mean"].device.type == "cpu"
    assert TSGD(_bn_mlp(), TOptConf(**MOMENTUM), device="cpu").state[
        "h_bn"]["var"].device.type == "cpu"
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    p = net.init_params(torch.Generator().manual_seed(0), device="cpu")
    np_state = state_to_numpy(st)
    for call in (lambda: net.init_state(),
                 lambda: TInferencer(net, p),
                 lambda: state_from_numpy(np_state)):
        with pytest.raises(RuntimeError, match="device='cpu'"):
            call()


def test_state_round_trip_is_bit_exact():
    jnet = JNetwork(jimage.resnet(50, (32, 32, 3), 10, fused=True))
    np_s = _np_state(jnet, 5)
    back = state_to_numpy(state_from_numpy(np_s, device="cpu"))
    assert sorted(back) == sorted(np_s)
    for layer, slots in np_s.items():
        for s, v in slots.items():
            assert back[layer][s].dtype == v.dtype
            np.testing.assert_array_equal(back[layer][s], v)


# ---- ResNet-50 ---------------------------------------------------------

@pytest.mark.parametrize("fused", [False, True])
def test_resnet50_conf_is_the_same(fused):
    jconf = jimage.resnet(50, (224, 224, 3), 1000, fused=fused)
    tconf = timage.resnet(50, (224, 224, 3), 1000, fused=fused)
    assert tconf.to_json() == jconf.to_json()
    jnet, tnet = JNetwork(jconf), TNetwork(tconf)
    assert {k: tuple(p.dims) for k, p in tnet.param_confs.items()} == {
        k: tuple(p.dims) for k, p in jnet.param_confs.items()}
    assert {layer: {s: tuple(v.shape) for s, v in slots.items()}
            for layer, slots in tnet.init_state("cpu").items()} == {
        layer: {s: tuple(v.shape) for s, v in slots.items()}
        for layer, slots in jnet.init_state().items()}
    n_fused = sum(lc.type.startswith("fused_") for lc in tconf.layers)
    assert n_fused == (29 if fused else 0)


def test_resnet50_cpu_forward_through_inferencer():
    """One fused forward of a 32x32 ResNet-50 at B=2 on the CPU, and the
    plain graph from the same weights (the port only: JAX is not run)."""
    plain = TNetwork(timage.resnet(50, (32, 32, 3), 10, fused=False))
    fused = TNetwork(timage.resnet(50, (32, 32, 3), 10, fused=True))
    p = plain.init_params(torch.Generator().manual_seed(0), device="cpu")
    fp, fs = fused_resnet_from_plain(fused, p, plain.init_state("cpu"))
    image = np.random.default_rng(0).standard_normal(
        (2, 32, 32, 3)).astype(np.float32)
    got = TInferencer(fused, fp, fs, device="cpu").infer(
        {"image": targ.non_seq(image)})["output"]
    want = TInferencer(plain, p, device="cpu").infer(
        {"image": targ.non_seq(image)})["output"]
    assert got.shape == (2, 10) and np.isfinite(got).all()
    _assert_rel(got, want, LAYER_TOL, "fused vs plain logits")
