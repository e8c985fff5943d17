"""The port's Fluid-style op framework (`paddle_tpu_torch/framework/`)
and its `paddle.v2.framework` counterpart (`compat/v2_framework/`)
against the JAX package's, on the CPU.

- every one of the 24 op types' forward, and the grad ops of each of the
  11 registered gradients, against the JAX op on the same numpy inputs
  (rtol 1e-5); the random ops by shape, dtype, determinism under one
  seed and their moments (another generator: not the JAX values);
- `backward()`'s net: op types and variable names, in order, equal to
  the JAX `backward()`'s (the @RENAME@ counters numbered by first
  appearance), for the MLP, a fan-out, a no-grad set, an unused output
  and nets holding a RecurrentOp;
- the reference's MLP (mul, rowwise_add, sigmoid, softmax,
  onehot_cross_entropy, mean, then backward() and sgd ops) trained 5
  steps eagerly in both packages (losses and parameters within 1e-5),
  and through `net_to_fn` under torch.autograd;
- `RecurrentOp` eager and through `scan_fn` against the JAX op, its grad
  op against `jax.grad` over the JAX `scan_fn`, and torch.autograd over
  the port's `scan_fn` against both;
- the reference op tests written as `tests/test_v2_framework.py` writes
  them (OpTestMeta TestCases, GradientChecker.check_grad), run against
  the port's namespace, and a reference-style source exec'd with
  `v1_builtins` so that its `paddle.v2.framework` imports resolve to it.
"""

import io
import re
import unittest

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import paddle_tpu.framework as J
from paddle_tpu.framework import op as jop

import paddle_tpu_torch.framework as T
from paddle_tpu_torch.compat.config_parser import v1_builtins
from paddle_tpu_torch.compat.v2_framework import core as tcore
from paddle_tpu_torch.compat.v2_framework import default_scope_funcs as tdsf
from paddle_tpu_torch.compat.v2_framework.gradient_checker import (
    GradientChecker,
    create_op,
    get_numeric_gradient,
    grad_var_name,
)
from paddle_tpu_torch.compat.v2_framework.op import Operator
from paddle_tpu_torch.compat.v2_framework.op_test_util import OpTestMeta
from paddle_tpu_torch.framework import op as top

G = "@GRAD"
RTOL = 1e-5


def _r(seed, *shape, lo=-1.0, hi=1.0):
    return np.random.default_rng(seed).uniform(lo, hi, shape).astype(
        np.float32)


def _probs(seed, n, k):
    p = _r(seed, n, k, lo=0.1, hi=1.0)
    return p / p.sum(1, keepdims=True)


IDX = np.asarray([1, 1, 3], np.int32)
LABEL = np.asarray([0, 2, 4, 1], np.int32)

# op type -> (inputs {slot: {var: value}}, outputs {slot: var}, attrs)
OP_CASES = {
    "add": ({"X": {"x": _r(0, 4, 3)}, "Y": {"y": _r(1, 4, 3)}},
            {"Out": "o"}, {}),
    "identity": ({"X": {"x": _r(2, 4, 3)}}, {"Out": "o"}, {}),
    "reduce_to_shape_of": ({"X": {"x": _r(3, 2, 4, 3)},
                            "Like": {"like": _r(4, 1, 3)}},
                           {"Out": "o"}, {}),
    "sum": ({"X": {"a": _r(5, 4, 3), "b": _r(6, 4, 3), "c": _r(7, 4, 3)}},
            {"Out": "o"}, {}),
    "mul": ({"X": {"x": _r(8, 4, 3)}, "Y": {"y": _r(9, 3, 5)}},
            {"Out": "o"}, {}),
    "matmul_nt": ({"X": {"x": _r(10, 4, 5)}, "Y": {"y": _r(11, 3, 5)}},
                  {"Out": "o"}, {}),
    "matmul_tn": ({"X": {"x": _r(12, 4, 3)}, "Y": {"y": _r(13, 4, 5)}},
                  {"Out": "o"}, {}),
    "mean": ({"X": {"x": _r(14, 4, 3)}}, {"Out": "o"}, {}),
    "mean_grad": ({"X": {"x": _r(15, 4, 3)},
                   "Out@G": {"og": np.float32(0.7)}}, {"Out": "o"}, {}),
    "scale": ({"X": {"x": _r(16, 4, 3)}}, {"Out": "o"}, {"scale": 2.5}),
    "sigmoid": ({"X": {"x": _r(17, 4, 3)}}, {"Y": "o"}, {}),
    "sigmoid_grad": ({"Y": {"y": _r(18, 4, 3, lo=0.1, hi=0.9)},
                      "Y@G": {"yg": _r(19, 4, 3)}}, {"Out": "o"}, {}),
    "softmax": ({"X": {"x": _r(20, 4, 5)}}, {"Y": "o"}, {}),
    "softmax_grad": ({"Y": {"y": _probs(21, 4, 5)},
                      "Y@G": {"yg": _r(22, 4, 5)}}, {"Out": "o"}, {}),
    "onehot_cross_entropy": ({"X": {"x": _probs(23, 4, 5)},
                              "label": {"label": LABEL}}, {"Y": "o"}, {}),
    "onehot_cross_entropy_grad": ({"X": {"x": _probs(24, 4, 5)},
                                   "label": {"label": LABEL},
                                   "Y@G": {"yg": _r(25, 4)}},
                                  {"Out": "o"}, {}),
    "rowwise_add": ({"X": {"x": _r(26, 4, 3)}, "b": {"b": _r(27, 3)}},
                    {"Out": "o"}, {}),
    "sgd": ({"param": {"p": _r(28, 5, 4)}, "grad": {"g": _r(29, 5, 4)}},
            {"param_out": "o"}, {"learning_rate": 0.1}),
    "fill_zeros_like": ({"Src": {"s": _r(30, 4, 3)}}, {"Dst": "o"}, {}),
    "gather": ({"X": {"x": _r(31, 5, 3)}, "Index": {"idx": IDX}},
               {"Out": "o"}, {}),
    "scatter_add_like": ({"Like": {"like": _r(32, 5, 3)},
                          "Index": {"idx": IDX},
                          "Updates": {"u": _r(33, 3, 3)}}, {"Out": "o"}, {}),
    "scatter": ({"Ref": {"ref": _r(34, 5, 3)}, "Index": {"idx": IDX},
                 "Updates": {"u": _r(35, 3, 3)}}, {"Out": "o"}, {}),
}
RANDOM_OPS = {
    "gaussian_random": dict(dims=[1000, 784], mean=0.5, std=2.0),
    "uniform_random": dict(dims=[1000, 784], min=-5.0, max=10.0),
}


def _slots(case):
    ins, outs, attrs = case
    return ({slot: list(vs) for slot, vs in ins.items()}, dict(outs),
            dict(attrs))


def _values(case):
    return {n: v for vs in case[0].values() for n, v in vs.items()}


def _jscope(values):
    s = J.Scope()
    for k, v in values.items():
        s.set(k, jnp.asarray(v))
    return s


def _tscope(values):
    s = T.Scope(device="cpu")
    for k, v in values.items():
        s.set(k, torch.from_numpy(np.array(v, copy=True)))
    return s


def _close(got, want, what):
    got = got.detach().numpy() if isinstance(got, torch.Tensor) else got
    np.testing.assert_allclose(np.asarray(got), np.asarray(want),
                               rtol=RTOL, atol=RTOL, err_msg=what)


def test_the_registries_hold_every_op_and_gradient():
    assert top.op_types() == jop.op_types() == sorted(
        list(OP_CASES) + list(RANDOM_OPS))
    assert len(top.op_types()) == 24
    assert sorted(top._GRAD_BUILDERS) == sorted(jop._GRAD_BUILDERS)
    assert len(top._GRAD_BUILDERS) == 11
    for t in jop.op_types():
        jin, jout, jattrs = jop.op_signature(t)
        tin, tout, tattrs = top.op_signature(t)
        assert (tin, tout) == (jin, jout), t
        # the random ops also take `device`
        assert tuple(a for a in tattrs if a != "device") == jattrs, t


@pytest.mark.parametrize("op_type", sorted(OP_CASES))
def test_op_forward_matches_jax(op_type):
    ins, outs, attrs = _slots(OP_CASES[op_type])
    values = _values(OP_CASES[op_type])
    js, ts = _jscope(values), _tscope(values)
    J.create_op(op_type, ins, outs, attrs).run(js)
    T.create_op(op_type, ins, outs, attrs).run(ts)
    got, want = ts.get("o"), js.get("o")
    assert isinstance(got, torch.Tensor)
    assert tuple(got.shape) == tuple(want.shape), op_type
    assert str(got.dtype).split(".")[-1] == str(want.dtype), op_type
    _close(got, want, op_type)


def test_op_runs_on_numpy_inputs_like_jax():
    """A numpy value in the scope becomes a tensor on the scope's device
    when an op reads it (float64 as float32, as the JAX package's
    arrays)."""
    s = T.Scope(device="cpu")
    s.set("x", np.arange(6, dtype=np.float64).reshape(2, 3))
    T.create_op("scale", {"X": "x"}, {"Out": "o"}, {"scale": 2.0}).run(s)
    assert s.get("o").dtype == torch.float32
    np.testing.assert_array_equal(s.get("o").numpy(),
                                  2 * np.arange(6).reshape(2, 3))


@pytest.mark.parametrize("op_type", sorted(RANDOM_OPS))
def test_random_op_shape_dtype_seed_and_moments(op_type):
    attrs = RANDOM_OPS[op_type]
    s = T.Scope()

    def draw(seed):
        T.create_op(op_type, {}, {"Out": "r"},
                    dict(attrs, seed=seed, device="cpu")).run(s)
        return s.get("r")

    a, b, c = draw(10), draw(10), draw(11)
    assert tuple(a.shape) == (1000, 784) and a.dtype == torch.float32
    assert torch.equal(a, b) and not torch.equal(a, c)
    js = J.Scope()
    J.create_op(op_type, {}, {"Out": "r"}, dict(attrs, seed=10)).run(js)
    ref = np.asarray(js.get("r"))
    assert ref.shape == tuple(a.shape) and str(ref.dtype) == "float32"
    x = a.numpy().astype(np.float64)
    if op_type == "gaussian_random":
        want_mean, want_std = attrs["mean"], attrs["std"]
    else:
        lo, hi = attrs["min"], attrs["max"]
        want_mean, want_std = (lo + hi) / 2, (hi - lo) / np.sqrt(12)
        assert x.min() >= lo and x.max() < hi
    # 784 000 draws: the mean within 4 standard errors, the std within 1%
    se = want_std / np.sqrt(x.size)
    for got in (x, ref.astype(np.float64)):
        assert abs(got.mean() - want_mean) < 4 * se
        assert abs(got.std() / want_std - 1) < 0.01


def test_random_op_defaults_to_the_card(monkeypatch):
    """No `device`: the card, as every entry point of the port; without
    one it raises instead of drawing on the CPU."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    op = T.create_op("gaussian_random", {}, {"Out": "r"}, {"dims": [2]})
    with pytest.raises(RuntimeError, match="no CUDA device"):
        op.run(T.Scope())


def test_numpy_inputs_default_to_the_card(monkeypatch):
    """No device on the op or its scope: a numpy input goes to the card
    too, as the random ops' draws; without one it raises."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    s = T.Scope()
    s.set("x", np.ones((2, 3), np.float32))
    op = T.create_op("scale", {"X": "x"}, {"Out": "o"}, {"scale": 2.0})
    with pytest.raises(RuntimeError, match="no CUDA device"):
        op.run(s)


@pytest.mark.parametrize("where", ["scope", "kid scope", "ops"])
def test_random_weights_into_mul_with_a_numpy_input(where):
    """The reference op tests' pattern: gaussian_random weights times a
    numpy `x` lie on one device, the one the scope (or a parent) or
    every op names."""
    rng = np.random.default_rng(17)
    x = rng.standard_normal((4, 6)).astype(np.float32)
    s = T.Scope(device=None if where == "ops" else "cpu")
    if where == "kid scope":
        s = s.new_scope()
    op_dev = {"device": "cpu"} if where == "ops" else {}
    s.set("x", x)
    net = T.NetOp()
    net.add_op("gaussian_random", {}, {"Out": "w"},
               dict(dims=[6, 3], seed=3, **op_dev))
    net.add_op("mul", {"X": "x", "Y": "w"}, {"Out": "y"}, op_dev)
    net.run(s)
    w, y = s.get("w"), s.get("y")
    assert w.device.type == y.device.type == "cpu"
    np.testing.assert_allclose(y.numpy(), x @ w.numpy(), rtol=RTOL,
                               atol=RTOL)


GRAD_CASES = sorted(jop._GRAD_BUILDERS)


@pytest.mark.parametrize("op_type", GRAD_CASES)
def test_registered_gradient_matches_jax(op_type):
    """The grad ops of the op's registered builder: the same types and
    wiring as the JAX builder's, and the same values on the same
    forward inputs and output gradients."""
    ins, outs, attrs = _slots(OP_CASES[op_type])
    values = _values(OP_CASES[op_type])
    jf = J.create_op(op_type, ins, outs, attrs)
    tf = T.create_op(op_type, ins, outs, attrs)
    js, ts = _jscope(values), _tscope(values)
    jf.run(js)
    tf.run(ts)
    out = np.asarray(js.get("o"))
    og = np.random.default_rng(99).uniform(-1, 1, out.shape).astype(
        np.float32)
    js.set("o" + G, jnp.asarray(og))
    ts.set("o" + G, torch.from_numpy(og.copy()))
    jg, tg = J.grad_op_for(jf), T.grad_op_for(tf)
    assert [(o.type, o.inputs, o.outputs, o.attrs) for o in tg] == [
        (o.type, o.inputs, o.outputs, o.attrs) for o in jg]
    for o in jg:
        o.run(js)
    for o in tg:
        o.run(ts)
    for o in tg:
        for n in o.output_vars():
            _close(ts.get(n), js.get(n), f"{op_type}: {n}")


def _mlp(F):
    """x@w + b -> sigmoid -> softmax -> xent(label) -> mean (the JAX
    package's tests' MLP), in framework F."""
    net = F.NetOp()
    net.add_op("mul", {"X": "x", "Y": "w"}, {"Out": "xw"})
    net.add_op("rowwise_add", {"X": "xw", "b": "b"}, {"Out": "z"})
    net.add_op("sigmoid", {"X": "z"}, {"Y": "h"})
    net.add_op("softmax", {"X": "h"}, {"Y": "p"})
    net.add_op("onehot_cross_entropy", {"X": "p", "label": "label"},
               {"Y": "ce"})
    net.add_op("mean", {"X": "ce"}, {"Out": "loss"})
    net.complete_add_op()
    return net


def _fanout(F):
    net = F.NetOp()
    net.add_op("sigmoid", {"X": "x"}, {"Y": "a"})
    net.add_op("scale", {"X": "x"}, {"Out": "b"}, {"scale": 3.0})
    net.add_op("add", {"X": "a", "Y": "b"}, {"Out": "s"})
    net.add_op("mean", {"X": "s"}, {"Out": "loss"})
    net.complete_add_op()
    return net


def _unused(F):
    net = F.NetOp()
    net.add_op("sigmoid", {"X": "x"}, {"Y": "h"})
    net.add_op("sigmoid", {"X": "h"}, {"Y": "unused"})
    net.add_op("mean", {"X": "h"}, {"Out": "loss"})
    net.complete_add_op()
    return net


def _rnn(F):
    """h_t = sigmoid(x_t @ W + h_{t-1} @ U), one memory."""
    step = F.NetOp()
    step.add_op("mul", {"X": "x", "Y": "W"}, {"Out": "xw"})
    step.add_op("mul", {"X": "h_pre", "Y": "U"}, {"Out": "hu"})
    step.add_op("add", {"X": "xw", "Y": "hu"}, {"Out": "z"})
    step.add_op("sigmoid", {"X": "z"}, {"Y": "h"})
    step.complete_add_op()
    return F.RecurrentOp(stepnet=step, inlinks=["x"], outlinks=["h"],
                         memories=[F.MemoryAttr(var="h", pre_var="h_pre",
                                                boot_var="h0")])


def _rnn_in_net(F):
    """The RNN with W and x also read outside it (fan-out through the
    recurrent grad op)."""
    outer = F.NetOp()
    outer.append_op(_rnn(F))
    outer.add_op("mean", {"X": "h"}, {"Out": "mh"})
    outer.add_op("mean", {"X": "W"}, {"Out": "mw"})
    outer.add_op("mean", {"X": "x"}, {"Out": "mx"})
    outer.add_op("add", {"X": "mh", "Y": "mw"}, {"Out": "s"})
    outer.add_op("add", {"X": "s", "Y": "mx"}, {"Out": "loss"})
    outer.complete_add_op()
    return outer


def _structure(net):
    """(type, inputs, outputs) of every op, the @RENAME@ counters
    numbered by first appearance."""
    seen = {}

    def norm(name):
        return re.sub(r"@RENAME@(\d+)",
                      lambda m: "@RENAME@%d" % seen.setdefault(
                          m.group(1), len(seen)), name)

    return [(o.type,
             {k: [norm(n) for n in v] for k, v in o.inputs.items()},
             {k: [norm(n) for n in v] for k, v in o.outputs.items()})
            for o in net.ops]


@pytest.mark.parametrize("name,build,no_grad", [
    ("mlp", _mlp, ()), ("mlp_no_grad_x", _mlp, ("x",)),
    ("fanout", _fanout, ()), ("unused_output", _unused, ()),
    ("recurrent_in_net", _rnn_in_net, ()),
])
def test_backward_net_equals_jax(name, build, no_grad):
    jb = J.backward(build(J), no_grad=set(no_grad), seeded={"loss"})
    tb = T.backward(build(T), no_grad=set(no_grad), seeded={"loss"})
    assert _structure(tb) == _structure(jb)
    assert tb.inputs == jb.inputs and tb.outputs == jb.outputs
    if name == "recurrent_in_net":
        jr = next(o for o in jb.ops if o.type == "recurrent_grad")
        tr = next(o for o in tb.ops if o.type == "recurrent_grad")
        assert _structure(tr.grad_stepnet) == _structure(jr.grad_stepnet)


MLP_STEPS, MLP_LR = 5, 0.5


def _mlp_values(seed=1):
    rng = np.random.default_rng(seed)
    return {"x": rng.standard_normal((4, 3)).astype(np.float32),
            "w": rng.standard_normal((3, 5)).astype(np.float32),
            "b": rng.standard_normal(5).astype(np.float32),
            "label": LABEL}


def _train_mlp(F, scope, one, steps):
    """`steps` eager steps of the MLP: forward, backward() seeded with
    d loss = 1, sgd ops writing w and b in place; returns the losses."""
    net = _mlp(F)
    bwd = F.backward(net, no_grad={"x", "label"}, seeded={"loss"})
    upd = F.NetOp()
    for p in ("w", "b"):
        upd.add_op("sgd", {"param": p, "grad": p + G}, {"param_out": p},
                   {"learning_rate": MLP_LR})
    losses = []
    for _ in range(steps):
        net.run(scope)
        losses.append(float(scope.get("loss")))
        scope.set("loss" + G, one)
        bwd.run(scope)
        upd.run(scope)
    return losses


def test_mlp_trains_like_jax():
    vals = _mlp_values()
    js, ts = _jscope(vals), _tscope(vals)
    jl = _train_mlp(J, js, jnp.float32(1.0), MLP_STEPS)
    tl = _train_mlp(T, ts, torch.tensor(1.0), MLP_STEPS)
    np.testing.assert_allclose(tl, jl, rtol=RTOL)
    assert tl[-1] < tl[0]
    for p in ("w", "b"):
        _close(ts.get(p), js.get(p), p)


def test_net_to_fn_under_autograd_matches_the_backward_net():
    """torch.autograd over `net_to_fn` gives backward()'s gradients (the
    JAX package's jax.grad over it)."""
    vals = _mlp_values(3)
    net = _mlp(T)
    ts = _tscope(vals)
    net.run(ts)
    ts.set("loss" + G, torch.tensor(1.0))
    T.backward(net, seeded={"loss"}).run(ts)
    fn = T.net_to_fn(net, ["x", "w", "b", "label"], ["loss"])
    xs = [torch.from_numpy(vals[n].copy()).requires_grad_(True)
          for n in ("x", "w", "b")]
    (loss,) = fn(*xs, torch.from_numpy(vals["label"]))
    grads = torch.autograd.grad(loss, xs)
    for n, g in zip(("x", "w", "b"), grads):
        _close(g, ts.get(n + G).numpy(), n)


def _rnn_values():
    rng = np.random.default_rng(6)
    return {"x": rng.standard_normal((5, 2, 3)).astype(np.float32),
            "W": rng.standard_normal((3, 4)).astype(np.float32),
            "U": rng.standard_normal((4, 4)).astype(np.float32),
            "h0": np.zeros((2, 4), np.float32)}


def test_recurrent_eager_and_scan_match_jax():
    vals = _rnn_values()
    jr, tr = _rnn(J), _rnn(T)
    js, ts = _jscope(vals), _tscope(vals)
    jr.run(js)
    tr.run(ts)
    eager = ts.get("h")
    assert tuple(eager.shape) == (5, 2, 4)
    _close(eager, js.get("h"), "eager")
    ext = tr.extern_names()
    assert ext == jr.extern_names() == ["W", "U"]
    (h_seq,) = tr.scan_fn(ext)([ts.get(n) for n in ext], [ts.get("h0")],
                               [ts.get("x")])
    (jh,) = jax.jit(jr.scan_fn(ext))([js.get(n) for n in ext],
                                     [js.get("h0")], [js.get("x")])
    _close(h_seq, jh, "scan")
    assert torch.equal(h_seq, eager)
    # literal per-step scopes, kept in the parent scope
    steps = ts.get(tr._scopes_name())
    assert len(steps) == 5 and torch.equal(steps[2].get("h"), eager[2])


def test_recurrent_grad_op_and_autograd_match_jax_grad():
    vals = _rnn_values()
    tr, jr = _rnn(T), _rnn(J)
    ts = _tscope(vals)
    tr.run(ts)
    ts.set("h" + G, torch.ones_like(ts.get("h")))
    tr.build_grad_op().run(ts)
    ext = jr.extern_names()
    jscan = jr.scan_fn(ext)

    def total(W, U, h0, x):
        (h_seq,) = jscan([W, U], [h0], [x])
        return jnp.sum(h_seq)

    names = ("W", "U", "h0", "x")
    ref = jax.grad(total, argnums=(0, 1, 2, 3))(
        *(jnp.asarray(vals[n]) for n in names))
    tscan = tr.scan_fn(ext)
    xs = [torch.from_numpy(vals[n].copy()).requires_grad_(True)
          for n in names]
    (h_seq,) = tscan(xs[:2], [xs[2]], [xs[3]])
    auto = torch.autograd.grad(h_seq.sum(), xs)
    for n, r, a in zip(names, ref, auto):
        _close(ts.get(n + G), r, f"grad op {n}")
        _close(a, r, f"autograd {n}")


def test_backward_of_a_net_holding_a_recurrent_op_matches_jax():
    vals = _rnn_values()
    js, ts = _jscope(vals), _tscope(vals)
    jnet, tnet = _rnn_in_net(J), _rnn_in_net(T)
    jnet.run(js)
    tnet.run(ts)
    _close(ts.get("loss"), js.get("loss"), "loss")
    js.set("loss" + G, jnp.float32(1.0))
    ts.set("loss" + G, torch.tensor(1.0))
    J.backward(jnet, seeded={"loss"}).run(js)
    T.backward(tnet, seeded={"loss"}).run(ts)
    for n in ("W", "U", "x", "h0"):
        _close(ts.get(n + G), js.get(n + G), n)


def test_scope_hierarchy():
    root = T.Scope()
    root.set("a", 1)
    kid = root.new_scope()
    assert kid.get("a") == 1
    assert root.device is None and kid.device is None
    assert T.Scope(device="cpu").new_scope().new_scope().device == "cpu"
    kid.set("a", 2)
    assert kid.get("a") == 2 and root.get("a") == 1
    assert "missing" not in kid
    with pytest.raises(KeyError):
        kid.get("missing")
    with pytest.raises(KeyError, match="unknown op type"):
        T.create_op("nope", {}, {})


def test_exported_names_equal_the_jax_packages():
    public = {n for n in dir(J) if not n.startswith("_")}
    assert public <= {n for n in dir(T) if not n.startswith("_")}


# ---- the reference op tests, as tests/test_v2_framework.py writes them,
# against the port's paddle.v2.framework counterpart -----------------------


class TestAddOp(unittest.TestCase, metaclass=OpTestMeta):
    type = "add_two"

    def setUp(self):
        rng = np.random.default_rng(0)
        x = rng.uniform(0, 1, (17, 31)).astype(np.float32)
        y = rng.uniform(0, 1, (17, 31)).astype(np.float32)
        self.inputs = {"X": x, "Y": y}
        self.outputs = {"Out": x + y}


class TestSoftmaxOp(unittest.TestCase, metaclass=OpTestMeta):
    type = "softmax"

    def setUp(self):
        def stable_softmax(x):
            shiftx = x - np.max(x)
            exps = np.exp(shiftx)
            return exps / np.sum(exps)

        x = np.random.default_rng(1).uniform(
            0.1, 1, (10, 10)).astype(np.float32)
        self.inputs = {"X": x}
        self.outputs = {"Y": np.apply_along_axis(stable_softmax, 1, x)}


class TestRowwiseAddOp(unittest.TestCase, metaclass=OpTestMeta):
    type = "rowwise_add"

    def setUp(self):
        rng = np.random.default_rng(2)
        x = rng.uniform(0, 1, (13, 7)).astype(np.float32)
        b = rng.uniform(0, 1, (7,)).astype(np.float32)
        self.inputs = {"X": x, "b": b}
        self.outputs = {"Out": x + b}


class TestSgdOp(unittest.TestCase, metaclass=OpTestMeta):
    type = "sgd"

    def setUp(self):
        rng = np.random.default_rng(3)
        p = rng.uniform(0, 1, (5, 4)).astype(np.float32)
        g = rng.uniform(0, 1, (5, 4)).astype(np.float32)
        self.inputs = {"param": p, "grad": g}
        self.attrs = {"learning_rate": 0.1}
        self.outputs = {"param_out": p - 0.1 * g}


class TestMeanOp(unittest.TestCase, metaclass=OpTestMeta):
    type = "mean"

    def setUp(self):
        x = np.random.default_rng(10).random((10, 10)).astype(np.float32)
        self.inputs = {"X": x}
        self.outputs = {"Out": np.mean(x)}


class TestMulOp(unittest.TestCase, metaclass=OpTestMeta):
    type = "mul"

    def setUp(self):
        rng = np.random.default_rng(11)
        a = rng.random((32, 84)).astype(np.float32)
        b = rng.random((84, 100)).astype(np.float32)
        self.inputs = {"X": a, "Y": b}
        self.outputs = {"Out": a @ b}


class TestSigmoidOp(unittest.TestCase, metaclass=OpTestMeta):
    type = "sigmoid"

    def setUp(self):
        x = np.random.default_rng(12).random((15, 31)).astype(np.float32)
        self.inputs = {"X": x}
        self.outputs = {"Y": 1.0 / (1.0 + np.exp(-x))}


class TestFillZerosLikeOp(unittest.TestCase, metaclass=OpTestMeta):
    type = "fill_zeros_like"

    def setUp(self):
        x = np.random.default_rng(13).random((219, 232)).astype(np.float32)
        self.inputs = {"Src": x}
        self.outputs = {"Dst": np.zeros_like(x)}


class TestCrossEntropyOp(unittest.TestCase, metaclass=OpTestMeta):
    type = "onehot_cross_entropy"

    def setUp(self):
        rng = np.random.default_rng(14)
        bs, classes = 32, 10
        x = rng.uniform(0.1, 1.0, (bs, classes)).astype(np.float32)
        labels = rng.integers(0, classes, bs).astype(np.int32)
        self.inputs = {"X": x, "label": labels}
        self.outputs = {
            "Y": -np.log(x[np.arange(bs), labels]).astype(np.float32)}


class TestNumericGradient(unittest.TestCase):
    def test_add_grad_is_ones(self):
        op = Operator("add_two", X="X", Y="Y", Out="Z")
        rng = np.random.default_rng(4)
        x = rng.uniform(0, 1, (10, 1)).astype(np.float32)
        y = rng.uniform(0, 1, (10, 1)).astype(np.float32)
        arr = get_numeric_gradient(op, {"X": x, "Y": y}, "Z", "X")
        self.assertAlmostEqual(float(arr.mean()), 1.0, delta=1e-2)


class TestMulGradChecker(GradientChecker):
    def test_mul(self):
        op = create_op("mul")
        rng = np.random.default_rng(5)
        inputs = {"X": rng.uniform(0.1, 1, (4, 6)).astype(np.float32),
                  "Y": rng.uniform(0.1, 1, (6, 3)).astype(np.float32)}
        self.check_grad(op, inputs, {"X", "Y"}, "Out",
                        max_relative_error=0.01)

    def test_mul_no_grad_x(self):
        op = create_op("mul")
        rng = np.random.default_rng(6)
        inputs = {"X": rng.uniform(0.1, 1, (4, 6)).astype(np.float32),
                  "Y": rng.uniform(0.1, 1, (6, 3)).astype(np.float32)}
        self.check_grad(op, inputs, {"Y"}, "Out", no_grad_set={"X"},
                        max_relative_error=0.01)


class TestSigmoidGradChecker(GradientChecker):
    def test_sigmoid(self):
        op = create_op("sigmoid")
        x = np.random.default_rng(7).uniform(-1, 1, (11, 8)).astype(
            np.float32)
        self.check_grad(op, {"X": x}, {"X"}, "Y", max_relative_error=0.01)


class TestScatterGradChecker(GradientChecker):
    def test_scatter(self):
        op = create_op("scatter")
        rng = np.random.default_rng(8)
        inputs = {"Ref": rng.uniform(0.1, 1, (6, 3)).astype(np.float32),
                  "Index": np.asarray([1, 4], np.int32),
                  "Updates": rng.uniform(0.1, 1, (2, 3)).astype(np.float32)}
        self.check_grad(op, inputs, {"Ref", "Updates"}, "Out",
                        no_grad_set={"Index"}, max_relative_error=0.01)


def test_the_harness_runs_at_every_place(monkeypatch):
    """Where the port has a card (`core.is_compile_gpu()`), OpTestMeta
    and check_grad run each op on the CPU and then on the card, as the
    reference's CPUPlace / GPUPlace arms; `only_cpu` keeps the CPU's."""
    assert tcore.is_compile_gpu() == torch.cuda.is_available()
    monkeypatch.setattr(tcore, "is_compile_gpu", lambda: True)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    case = TestAddOp("test_all")
    case.setUp()
    with pytest.raises(RuntimeError, match="no CUDA device"):
        case.test_all()
    checker = TestSigmoidGradChecker("test_sigmoid")
    x = np.random.default_rng(7).uniform(-1, 1, (3, 4)).astype(np.float32)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        checker.check_grad(create_op("sigmoid"), {"X": x}, {"X"}, "Y",
                           max_relative_error=0.01)
    checker.check_grad(create_op("sigmoid"), {"X": x}, {"X"}, "Y",
                       max_relative_error=0.01, only_cpu=True)


class TestDefaultScopeFuncs(unittest.TestCase):
    def test_cur_scope(self):
        self.assertIsNotNone(tdsf.get_cur_scope())

    def test_scoped_function(self):
        outer = tdsf.new_var("outer")
        self.assertIsNotNone(outer)

        def inner():
            self.assertIsNotNone(tdsf.new_var("inner"))
            self.assertIsNotNone(tdsf.find_var("outer"))

        tdsf.scoped_function(inner)
        self.assertIsNone(tdsf.get_cur_scope()._vars.get("inner"))


class TestOperatorFactory(unittest.TestCase):
    def test_slot_introspection(self):
        self.assertEqual(Operator.get_op_input_names("mul"), ["X", "Y"])
        self.assertEqual(Operator.get_op_output_names("softmax"), ["Y"])
        self.assertIn("learning_rate", Operator.get_op_attr_names("sgd"))

    def test_unknown_kwarg_rejected(self):
        with self.assertRaises(ValueError):
            Operator("add_two", X="X", Y="Y", Nope="Z")


class TestRandomOps(unittest.TestCase):
    # the reference's calls, on the CPU by the `device` attribute
    def test_gaussian_random(self):
        scope = tcore.Scope()
        Operator("gaussian_random", Out="X", dims=[1000, 784], mean=0.0,
                 std=1.0, seed=10, device="cpu").run(scope)
        tensor = np.asarray(scope.get("X"))
        self.assertEqual(tensor.shape, (1000, 784))
        self.assertAlmostEqual(float(tensor.mean()), 0.0, delta=0.1)
        self.assertAlmostEqual(float(tensor.std()), 1.0, delta=0.1)

    def test_uniform_random(self):
        scope = tcore.Scope()
        Operator("uniform_random", Out="X", dims=[1000, 784], min=-5.0,
                 max=10.0, seed=10, device="cpu").run(scope)
        tensor = np.asarray(scope.get("X"))
        self.assertEqual(tensor.shape, (1000, 784))
        self.assertAlmostEqual(float(tensor.mean()), 2.5, delta=0.5)


class TestScopeAndNet(unittest.TestCase):
    def test_create_var_get_var(self):
        scope = tcore.Scope()
        self.assertIsNotNone(scope.new_var("var_a"))
        self.assertIsNotNone(scope.new_scope().find_var("var_a"))
        scope.set("test_int", 10)
        self.assertEqual(scope.get("test_int"), 10)

    def test_net_all(self):
        net = T.NetOp()
        net.add_op("add", {"X": "X", "Y": "Y"}, {"Out": "Out"})
        net.add_op("mul", {"X": "Out", "Y": "W"}, {"Out": "FC"})
        net.complete_add_op()
        self.assertEqual(sorted(net.inputs["X"]), ["W", "X", "Y"])
        self.assertIn("FC", net.outputs["Out"])
        rng = np.random.default_rng(15)
        scope = tcore.Scope(device="cpu")
        vals = {k: rng.random(s).astype(np.float32) for k, s in (
            ("X", (3, 4)), ("Y", (3, 4)), ("W", (4, 2)))}
        for k, v in vals.items():
            scope.set(k, v)
        net.run(scope)
        np.testing.assert_allclose(
            scope.get("FC").numpy(), (vals["X"] + vals["Y"]) @ vals["W"],
            rtol=1e-5)

    def test_backward_of_mul(self):
        fwd = Operator("mul", X="A", Y="B", Out="C")
        bwd = tcore.Operator.backward(fwd, set())
        rng = np.random.default_rng(16)
        a = rng.random((4, 6)).astype(np.float32)
        b = rng.random((6, 3)).astype(np.float32)
        scope = tcore.Scope(device="cpu")
        scope.set("A", a)
        scope.set("B", b)
        fwd.run(scope)
        scope.set(grad_var_name("C"), np.ones((4, 3), np.float32))
        bwd.run(scope)
        np.testing.assert_allclose(scope.get(grad_var_name("A")).numpy(),
                                   np.ones((4, 3)) @ b.T, rtol=1e-5)
        np.testing.assert_allclose(scope.get(grad_var_name("B")).numpy(),
                                   a.T @ np.ones((4, 3)), rtol=1e-5)


REFERENCE_STYLE = '''
import unittest
import numpy as np
from paddle.v2.framework.tests.gradient_checker import GradientChecker
from paddle.v2.framework.tests.gradient_checker import create_op
from paddle.v2.framework.tests.op_test_util import OpTestMeta
import paddle.v2.framework.core as core


class TestRowwiseAdd(unittest.TestCase, metaclass=OpTestMeta):
    def setUp(self):
        self.type = "rowwise_add"
        x = np.random.random((4, 3)).astype("float32")
        b = np.random.random(3).astype("float32")
        self.inputs = {"X": x, "b": b}
        self.outputs = {"Out": x + b}


class TestSoftmaxGrad(GradientChecker):
    def test_softmax(self):
        op = create_op("softmax")
        x = np.random.uniform(0.1, 1, [5, 7]).astype("float32")
        self.check_grad(op, {"X": x}, set(["X"]), "Y")
'''


def test_reference_style_source_runs_against_the_port():
    """A reference op-test source, exec'd as a v1 source is (the port's
    `v1_builtins`): its `paddle.v2.framework` imports resolve to the
    port's namespace (never the repo-root package), and its tests
    pass."""
    import sys

    had_paddle = "paddle" in sys.modules
    ns = {"__builtins__": v1_builtins(), "__name__": "reference_op_tests"}
    exec(compile(REFERENCE_STYLE, "test_reference_ops.py", "exec"), ns)
    assert ns["core"] is tcore
    assert ns["GradientChecker"] is GradientChecker
    assert ("paddle" in sys.modules) == had_paddle
    suite = unittest.TestSuite([
        unittest.defaultTestLoader.loadTestsFromTestCase(ns[c])
        for c in ("TestRowwiseAdd", "TestSoftmaxGrad")])
    res = unittest.TextTestRunner(stream=io.StringIO()).run(suite)
    assert res.wasSuccessful() and res.testsRun == 2, res.failures
