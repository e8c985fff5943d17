"""The port's `Network` against the JAX package's, on the same confs.

Each conf is built twice from one description — once through
`paddle_tpu.dsl`, once through the port's copy — and both networks run
on the same numpy parameters (the JAX `init_params`, carried across by
flat name) and the same numpy feed. f32 on the CPU in both.

- Per layer type (data, fc, embedding, addto, multi_head_attention
  dense / flash / cross-attention, classification_cost, cross_entropy,
  square_error): the layer's output equals the JAX layer's (atol 1e-5
  at valid positions).
- `transformer_lm`, both attn_impls: `loss_fn` and every gradient equal
  `jax.value_and_grad(Network.loss_fn)` (rtol 1e-5, atol 1e-6), and the
  DSL graph's logits equal the port's functional `lm_forward` at valid
  positions.
"""

import dataclasses

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from paddle_tpu import dsl as jdsl
from paddle_tpu.core import arg as jarg
from paddle_tpu.models import lm as jlm
from paddle_tpu.network import Network as JNetwork
from paddle_tpu_torch import dsl as tdsl
from paddle_tpu_torch.core import arg as targ
from paddle_tpu_torch.models import lm as tlm
from paddle_tpu_torch.network import Network as TNetwork
from paddle_tpu_torch.weights import params_from_numpy

ATOL = 1e-5
B, T, V, D = 3, 11, 17, 16
LENS = np.asarray([11, 6, 1], np.int32)


def _feed_np(seed=0):
    rng = np.random.default_rng(seed)
    return {
        "x": rng.standard_normal((B, T, D)).astype(np.float32),
        "y": rng.standard_normal((B, T, D)).astype(np.float32),
        "kv": rng.standard_normal((B, T + 4, D)).astype(np.float32),
        "ids": rng.integers(0, V, (B, T)).astype(np.int32),
        "label": rng.integers(0, V, (B, T)).astype(np.int32),
    }


KV_LENS = np.asarray([15, 9, 3], np.int32)


def _feed(pkg_arg, np_feed, as_input):
    """Args of one package from the numpy feed."""
    f = {
        "x": pkg_arg.seq(as_input(np_feed["x"]), LENS),
        "y": pkg_arg.seq(as_input(np_feed["y"]), LENS),
        "kv": pkg_arg.seq(as_input(np_feed["kv"]), KV_LENS),
        "ids": pkg_arg.id_arg(np_feed["ids"], LENS),
        "label": pkg_arg.id_arg(np_feed["label"], LENS),
    }
    return f


def _conf(dsl, kind):
    """A small conf whose layer `out` is of the type under test."""
    with dsl.model() as g:
        x = dsl.data("x", dim=D, is_seq=True)
        y = dsl.data("y", dim=D, is_seq=True)
        kv = dsl.data("kv", dim=D, is_seq=True)
        ids = dsl.data("ids", dim=(), is_ids=True, is_seq=True)
        label = dsl.data("label", dim=(), is_ids=True, is_seq=True)
        if kind == "fc":
            dsl.fc(x, y, size=8, act="tanh", name="out")
        elif kind == "embedding":
            dsl.embedding(ids, size=D, vocab_size=V, name="out")
        elif kind == "addto":
            dsl.addto(x, y, act="relu", bias=True, name="out")
        elif kind.startswith("attention"):
            impl = kind.split("_")[-1]
            ins = [x, kv] if "cross" in kind else [x]
            dsl._add("multi_head_attention", ins, size=D, num_heads=2,
                     causal="cross" not in kind, attn_impl=impl,
                     name="out")
        elif kind == "classification_cost":
            logits = dsl.fc(x, size=V, name="logits")
            dsl.classification_cost(logits, label, name="out")
        elif kind == "cross_entropy":
            prob = dsl.fc(x, size=V, act="softmax", name="prob")
            dsl.cross_entropy(prob, label, name="out")
        elif kind == "square_error":
            dsl.square_error(x, y, name="out")
        else:
            raise ValueError(kind)
    return g.conf


KINDS = ["fc", "embedding", "addto", "attention_dense", "attention_flash",
         "attention_cross_dense", "attention_cross_flash",
         "classification_cost", "cross_entropy", "square_error"]


@pytest.mark.parametrize("kind", KINDS)
def test_layer_forward_matches_jax(kind):
    jnet = JNetwork(_conf(jdsl, kind))
    tnet = TNetwork(_conf(tdsl, kind))
    assert sorted(jnet.param_confs) == sorted(tnet.param_confs)
    jp = jnet.init_params(jax.random.key(0))
    np_feed = _feed_np()
    jouts, _ = jnet.forward(jp, _feed(jarg, np_feed, jnp.asarray),
                            outputs=["out"])
    touts, _ = tnet.forward(
        params_from_numpy(jp, device="cpu"),
        _feed(targ, np_feed, torch.from_numpy), outputs=["out"])
    ref = np.asarray(jouts["out"].value)
    got = touts["out"].value.numpy()
    assert got.shape == ref.shape
    if ref.ndim >= 2 and jouts["out"].seq_lens is not None:
        for r, n in enumerate(np.asarray(jouts["out"].seq_lens)):
            np.testing.assert_allclose(got[r, :n], ref[r, :n], atol=ATOL)
            if kind.startswith("attention"):
                # padded query rows are zeroed by the layer in both
                assert (got[r, n:] == 0).all()
    else:
        np.testing.assert_allclose(got, ref, atol=ATOL, rtol=ATOL)


# ---- the Transformer LM ---------------------------------------------

JSPEC = jlm.LMSpec(vocab=64, d_model=32, num_heads=2, num_layers=2)
TSPEC = tlm.LMSpec(vocab=64, d_model=32, num_heads=2, num_layers=2)
LM_LENS = np.asarray([24, 17, 5, 0], np.int32)


@pytest.fixture(scope="module")
def lm_params():
    return {k: np.asarray(v) for k, v in
            jlm.lm_init_params(JSPEC, jax.random.key(0)).items()}


def _lm_batch(seed=0, t=24):
    rng = np.random.default_rng(seed)
    ids = rng.integers(2, JSPEC.vocab, (len(LM_LENS), t)).astype(np.int32)
    lbl = rng.integers(2, JSPEC.vocab, (len(LM_LENS), t)).astype(np.int32)
    return ids, lbl


@pytest.mark.parametrize("impl", ["dense", "flash"])
def test_lm_loss_and_gradients_match_jax(lm_params, impl):
    ids, lbl = _lm_batch()
    jconf = jlm.transformer_lm(dataclasses.replace(JSPEC, attn_impl=impl))
    jnet = JNetwork(jconf)
    jfeed = {"ids": jarg.id_arg(ids, LM_LENS),
             "label": jarg.id_arg(lbl, LM_LENS)}
    (jloss, _aux), jgrads = jax.value_and_grad(
        jnet.loss_fn, has_aux=True)(
        {k: jnp.asarray(v) for k, v in lm_params.items()}, jfeed)

    tnet = TNetwork(tlm.transformer_lm(
        dataclasses.replace(TSPEC, attn_impl=impl)))
    tp = {k: v.requires_grad_(True) for k, v in
          params_from_numpy(lm_params, device="cpu").items()}
    tfeed = {"ids": targ.id_arg(ids, LM_LENS),
             "label": targ.id_arg(lbl, LM_LENS)}
    tloss, _ = tnet.loss_fn(tp, tfeed)
    tloss.backward()
    np.testing.assert_allclose(tloss.item(), float(jloss), rtol=1e-5)
    assert sorted(jgrads) == sorted(tp)
    for k, g in jgrads.items():
        np.testing.assert_allclose(tp[k].grad.numpy(), np.asarray(g),
                                   rtol=1e-5, atol=1e-6, err_msg=k)


@pytest.mark.parametrize("impl", ["dense", "flash"])
def test_lm_network_equals_functional_forward(lm_params, impl):
    spec = dataclasses.replace(TSPEC, attn_impl=impl)
    tp = params_from_numpy(lm_params, device="cpu")
    ids, _ = _lm_batch(seed=1)
    net = TNetwork(tlm.transformer_lm(spec))
    outs, _ = net.forward(tp, {"ids": targ.id_arg(ids, LM_LENS)},
                          outputs=["lm_head"])
    got = tlm.lm_forward(spec, tp, torch.from_numpy(ids),
                         lens=torch.from_numpy(LM_LENS))
    for r, n in enumerate(LM_LENS):
        np.testing.assert_allclose(outs["lm_head"].value[r, :n].numpy(),
                                   got[r, :n].numpy(), rtol=2e-5,
                                   atol=2e-5)


def test_lm_init_params_names_are_the_networks(lm_params):
    init = tlm.lm_init_params(TSPEC, torch.Generator().manual_seed(0),
                              device="cpu")
    assert {k: tuple(v.shape) for k, v in init.items()} == {
        k: v.shape for k, v in lm_params.items()} == tlm.lm_param_shapes(
        TSPEC)


def test_shared_parameter_is_one_tensor():
    """Two fc layers naming one parameter share it: one entry in
    param_confs, and its gradient sums both uses."""
    from paddle_tpu_torch.core.config import ParameterConf

    with tdsl.model() as g:
        x = tdsl.data("x", dim=D, is_seq=True)
        a = tdsl.fc(x, size=D, param=ParameterConf(name="shared"),
                    bias=False, name="a")
        tdsl.fc(a, size=D, param=ParameterConf(name="shared"), bias=False,
                name="b")
    net = TNetwork(g.conf)
    assert sorted(net.param_confs) == ["shared"]
    p = net.init_params(torch.Generator().manual_seed(0), device="cpu")
    w = p["shared"].requires_grad_(True)
    x = torch.from_numpy(_feed_np()["x"])
    outs, _ = net.forward(p, {"x": targ.seq(x, LENS)})
    outs["b"].value.sum().backward()
    torch.testing.assert_close(
        w.grad, torch.autograd.grad((x @ w @ w).sum(), w)[0])


def test_dropout_is_seeded_by_step_and_layer():
    """Dropout draws its mask from Ctx.split(layer name): the same step
    generator gives the same mask, another step another one; kept values
    are scaled by 1/keep; test mode drops nothing. (Masks cannot equal
    jax.random's, so parity tests run without dropout.)"""
    from paddle_tpu_torch.core import rng as trng

    with tdsl.model() as g:
        x = tdsl.data("x", dim=64)
        tdsl.fc(x, size=64, act="", drop_rate=0.25, name="h")
    net = TNetwork(g.conf)
    p = net.init_params(torch.Generator().manual_seed(0), device="cpu")
    feed = {"x": targ.non_seq(np.ones((32, 64), np.float32))}
    root = trng.generator(7)

    def run(step, train=True):
        outs, _ = net.forward(p, feed, train=train,
                              rng=trng.split_for_step(root, step))
        return outs["h"].value

    a, b, c = run(0), run(0), run(1)
    full = run(0, train=False)
    assert torch.equal(a, b) and not torch.equal(a, c)
    dropped = (a == 0) & (full != 0)
    assert 0.15 < dropped.float().mean().item() < 0.35
    torch.testing.assert_close(a[~dropped], full[~dropped] / 0.75)
