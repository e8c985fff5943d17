"""The port's `mixed`, extra outputs, step cells and fused attention
decoder against the JAX package's, on the CPU.

Each conf is built twice from one description, once through
`paddle_tpu.dsl` and once through the port's copy; both networks run on
the same numpy parameters (the JAX init, 1-D ones perturbed off 0) and
feed (numpy seeds, ragged lengths). f32 on the CPU in both.

- `mixed`, one case per projection (full_matrix, trans_full_matrix,
  table, dotmul, scaling, identity, slice, context over ragged
  sequences, the per-filter shared bias of conv projections, a sum of
  several), activation and bias: forward and the gradients of
  sum(out * cotangent) for every parameter and dense input within 1e-5
  of the largest entry.
- Extra outputs: `lstm_step`'s `<name>@state` read by a later layer and
  by `outputs=`; a name collision raises.
- `gru_step` and `lstm_step` forward and gradients (1e-5 of the
  largest); `gru_step` in a recurrent_group equal to `grumemory` with
  the same weights (atol 1e-5), as `tests/test_steps_misc.py` holds the
  JAX layer.
- `fused_att_decoder` through `seq2seq_attention(fused_decoder=True)`
  at ragged source lengths: loss (rtol 1e-5) and every gradient (1e-5
  of the largest) against the JAX fused conf and against the port's
  generic `recurrent_group` arm; three adam steps of `SGD.train` against
  the JAX trainer (costs rtol 1e-4, parameters 1e-4 of the largest).
- Parameter names and shapes equal to JAX's for every new layer, and
  `weights.py` round-tripping them bit for bit.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from paddle_tpu import dsl as jdsl
from paddle_tpu.core import arg as jarg
from paddle_tpu.core.config import OptimizationConf as JOptConf
from paddle_tpu.core.config import ParameterConf as JPC
from paddle_tpu.models import text as jtext
from paddle_tpu.network import Network as JNetwork
from paddle_tpu.trainer.events import EndIteration as JEnd
from paddle_tpu.trainer.trainer import SGD as JSGD
from paddle_tpu_torch import dsl as tdsl
from paddle_tpu_torch.core import arg as targ
from paddle_tpu_torch.core.config import OptimizationConf as TOptConf
from paddle_tpu_torch.core.config import ParameterConf as TPC
from paddle_tpu_torch.models import text as ttext
from paddle_tpu_torch.network import Network as TNetwork
from paddle_tpu_torch.trainer.events import EndIteration as TEnd
from paddle_tpu_torch.trainer.trainer import SGD as TSGD
from paddle_tpu_torch.weights import params_from_numpy, params_to_numpy

B, T = 4, 6
LENS = np.asarray([6, 1, 4, 3], np.int32)
TOL = 1e-5
TRAIN_TOL = 1e-4


def _rel(got, ref):
    got, ref = np.asarray(got), np.asarray(ref)
    assert got.shape == ref.shape, (got.shape, ref.shape)
    return float(np.abs(got - ref).max()) / max(float(np.abs(ref).max()),
                                                1e-30)


def _np_params(jnet, seed=0):
    rng = np.random.default_rng(seed)
    out = {}
    for k, v in jnet.init_params(jax.random.key(seed)).items():
        v = np.asarray(v)
        if v.ndim == 1:
            v = v + 0.3 * rng.standard_normal(v.shape).astype(np.float32)
        out[k] = v
    return out


def _j(x):
    return None if x is None else jnp.asarray(x)


def _t(x, dtype):
    return None if x is None else torch.tensor(x, dtype=dtype)


def _feeds(spec):
    """{name: dict(value=, ids=, seq_lens=)} of numpy -> (JAX feed,
    port feed, port tensors that take gradients)."""
    jf, tf, leaves = {}, {}, {}
    for n, f in spec.items():
        jf[n] = jarg.Arg(value=_j(f.get("value")), ids=_j(f.get("ids")),
                         seq_lens=_j(f.get("seq_lens")))
        v = _t(f.get("value"), torch.float32)
        if v is not None:
            v.requires_grad_(True)
            leaves[n] = v
        tf[n] = targ.Arg(value=v, ids=_t(f.get("ids"), torch.int64),
                         seq_lens=_t(f.get("seq_lens"), torch.int32))
    return jf, tf, leaves


def _hold_forward_and_grads(build, spec, outs, seed=0):
    """Both packages' forward of `outs` and the gradients of
    sum(out * cotangent) over them, for every parameter and dense
    input, held within TOL of the largest entry."""
    jnet, tnet = JNetwork(build(jdsl)), TNetwork(build(tdsl))
    assert {k: tuple(p.dims) for k, p in tnet.param_confs.items()} == {
        k: tuple(p.dims) for k, p in jnet.param_confs.items()}
    p = _np_params(jnet, seed)
    jf, tf, leaves = _feeds(spec)
    rng = np.random.default_rng(seed + 1)

    def jloss(params, values):
        feed = {n: (a.with_value(values[n]) if n in values else a)
                for n, a in jf.items()}
        o, _ = jnet.forward(params, feed, outputs=outs)
        return [o[n].value for n in outs]

    jvals = {n: jf[n].value for n in leaves}
    jouts, vjp = jax.vjp(jloss, {k: jnp.asarray(v) for k, v in p.items()},
                         jvals)
    cts = [rng.standard_normal(np.shape(o)).astype(np.float32)
           for o in jouts]
    jgp, jgx = vjp([jnp.asarray(c) for c in cts])

    tp = {k: torch.tensor(v, requires_grad=True) for k, v in p.items()}
    o, _ = tnet.forward(tp, tf, outputs=outs)
    touts = [o[n].value for n in outs]
    for n, got, ref in zip(outs, touts, jouts):
        assert _rel(got.detach(), ref) <= TOL, n
    loss = sum((y * torch.from_numpy(c)).sum() for y, c in zip(touts, cts))
    loss.backward()
    for k in p:
        assert _rel(tp[k].grad, jgp[k]) <= TOL, k
    for n, v in leaves.items():
        # an input no output reads has no gradient (JAX: zeros)
        g = v.grad if v.grad is not None else torch.zeros_like(v)
        assert _rel(g, jgx[n]) <= TOL, n
    return jnet, tnet, p


# ---- mixed ---------------------------------------------------------------

def _seq_value(rng, width):
    v = rng.standard_normal((B, T, width)).astype(np.float32)
    return v * (np.arange(T)[None, :, None] < LENS[:, None, None])


MIXED = {
    "full_matrix": lambda dsl, x, _s, _i, _im: [(x, "full_matrix")],
    "trans_full_matrix": lambda dsl, x, *_: [(x, "trans_full_matrix")],
    "table": lambda dsl, _x, _s, ids, _im: [(ids, "table",
                                             {"vocab_size": 7})],
    "dotmul": lambda dsl, x, *_: [(x, "dotmul")],
    "scaling": lambda dsl, x, *_: [(x, "scaling")],
    "identity": lambda dsl, x, *_: [(x, "identity")],
    "slice": lambda dsl, x, *_: [(x, "slice",
                                  {"slices": ((0, 2), (1, 4))})],
    "context": lambda dsl, _x, s, *_: [dsl.context_projection(s, 3, -1)],
    "conv_bias": lambda dsl, _x, _s, _i, im: [(im, "identity",
                                               {"conv_bias": 3})],
    "sum": lambda dsl, x, _s, ids, _im: [
        (x, "full_matrix"), (x, "dotmul"),
        (ids, "table", {"vocab_size": 7}), (x, "identity")],
}


@pytest.mark.parametrize("case", sorted(MIXED))
def test_mixed_projection_matches_jax(case):
    width = {"context": 9, "conv_bias": 12}.get(case, 5)
    act = "" if case == "scaling" else "tanh"
    bias = case != "trans_full_matrix"

    def build(dsl):
        with dsl.model() as g:
            x = dsl.data("x", 5)
            s = dsl.data("s", 3, is_seq=True)
            ids = dsl.data("ids", 1, is_ids=True)
            im = dsl.data("im", (2, 2, 3))
            dsl.mixed(width, MIXED[case](dsl, x, s, ids, im), name="out",
                      act=act, bias=bias)
        return g.conf

    rng = np.random.default_rng(3)
    spec = {"x": {"value": rng.standard_normal((B, 5)).astype(np.float32)},
            "s": {"value": _seq_value(rng, 3), "seq_lens": LENS},
            "ids": {"ids": rng.integers(0, 7, (B,)).astype(np.int32)},
            "im": {"value": rng.standard_normal((B, 12)).astype(
                np.float32)}}
    _hold_forward_and_grads(build, spec, ["out"])


def test_mixed_infers_its_size_and_refuses_a_bad_slice():
    with tdsl.model() as g:
        x = tdsl.data("x", 5)
        tdsl.mixed(0, [(x, "dotmul")], name="out", bias=False)
    net = TNetwork(g.conf)
    assert net.specs["out"].size == 5
    with tdsl.model() as g:
        x = tdsl.data("x", 5)
        tdsl.mixed(5, [(x, "slice", {"slices": ((0, 2), (3, 6))})],
                   name="out")
    with pytest.raises(AssertionError, match="beyond input width"):
        TNetwork(g.conf)


# ---- step cells and extra outputs -----------------------------------------

H = 4


def _lstm_step_conf(dsl):
    with dsl.model() as g:
        x4 = dsl.data("x4", 4 * H)
        h = dsl.data("h", H)
        c = dsl.data("c", H)
        dsl._add("lstm_step", [x4, h, c], name="ls", size=H)
        # a consumer of the extra output
        dsl.fc("ls@state", size=3, act="tanh", name="after")
    return g.conf


def _cell_spec(rng, widths):
    return {n: {"value": rng.standard_normal((B, w)).astype(np.float32)}
            for n, w in widths.items()}


def test_lstm_step_and_its_state_output_match_jax():
    rng = np.random.default_rng(4)
    spec = _cell_spec(rng, {"x4": 4 * H, "h": H, "c": H})
    _hold_forward_and_grads(_lstm_step_conf, spec,
                            ["ls", "ls@state", "after"])


def test_gru_step_matches_jax():
    def build(dsl):
        with dsl.model() as g:
            x = dsl.data("x", 3 * H)
            p = dsl.data("p", H)
            dsl._add("gru_step", [x, p], name="gs", size=H)
        return g.conf

    rng = np.random.default_rng(5)
    jnet, tnet, _ = _hold_forward_and_grads(
        build, _cell_spec(rng, {"x": 3 * H, "p": H}), ["gs"])
    assert {"_gs.w0", "_gs.wc", "_gs.wbias"} == set(tnet.param_confs)


def test_extra_output_names_and_collisions():
    net = TNetwork(_lstm_step_conf(tdsl))
    assert net.specs["ls@state"].size == H
    assert net._ancestors(["ls@state"]) >= {"ls", "x4", "h", "c"}
    feed = {n: targ.non_seq(np.ones((2, w), np.float32))
            for n, w in (("x4", 4 * H), ("h", H), ("c", H))}
    p = net.init_params(torch.Generator().manual_seed(0), device="cpu")
    outs, _ = net.forward(p, feed, outputs=["ls@state"])
    assert set(outs) >= {"ls", "ls@state"} and "after" not in outs
    with tdsl.model() as g:
        x4 = tdsl.data("x4", 4 * H)
        h = tdsl.data("h", H)
        tdsl.data("ls@state", H)
        tdsl._add("lstm_step", [x4, h, h], name="ls", size=H)
    with pytest.raises(KeyError, match="collides"):
        TNetwork(g.conf)


def test_gru_step_in_a_group_equals_grumemory():
    """A recurrent_group whose step is gru_step equals the grumemory
    layer with the same weights, in the port as in the JAX package."""
    with tdsl.model() as g:
        x = tdsl.data("x", 3 * H, is_seq=True)
        tdsl.grumemory(x, H, name="gru", bias=False)

        def step(xt):
            prev = tdsl.memory("s", size=H)
            return tdsl._add("gru_step", [xt, prev], name="s", size=H,
                             bias=False)

        tdsl.recurrent_group(step, [x], name="rg")
    net = TNetwork(g.conf)
    params = dict(net.init_params(torch.Generator().manual_seed(0),
                                  device="cpu"))
    params["_s.w0"] = params["_gru.w0"]
    params["_s.wc"] = params["_gru.wc"]
    rng = np.random.default_rng(5)
    xv = rng.standard_normal((B, T, 3 * H)).astype(np.float32)
    outs, _ = net.forward(params, {"x": targ.seq(xv, LENS)},
                          outputs=["gru", "rg"])
    m = (np.arange(T)[None, :, None] < LENS[:, None, None])
    np.testing.assert_allclose(outs["gru"].value.detach().numpy() * m,
                               outs["rg"].value.detach().numpy() * m,
                               rtol=0, atol=TOL)


# ---- the fused attention decoder ------------------------------------------

NMT = dict(src_vocab=29, trg_vocab=31, emb_dim=6, hidden=8)
SRC_LENS = np.asarray([7, 2, 5, 1], np.int32)
TRG_LENS = np.asarray([5, 5, 3, 4], np.int32)


def _nmt_spec(seed=6):
    rng = np.random.default_rng(seed)
    ids = lambda v, t: rng.integers(2, v, (B, t)).astype(np.int32)  # noqa
    return {"src": {"ids": ids(29, 7), "seq_lens": SRC_LENS},
            "trg_in": {"ids": ids(31, 5), "seq_lens": TRG_LENS},
            "trg_out": {"ids": ids(31, 5), "seq_lens": TRG_LENS}}


def _port_loss_grads(conf, p, tf):
    net = TNetwork(conf)
    tp = {k: torch.tensor(v, requires_grad=True) for k, v in p.items()}
    loss = net.loss_fn(tp, tf)[0]
    loss.backward()
    return loss.item(), {k: v.grad.numpy() for k, v in tp.items()}


def test_fused_att_decoder_matches_jax_and_the_generic_arm():
    jconf = jtext.seq2seq_attention(fused_decoder=True, **NMT)
    jnet = JNetwork(jconf)
    p = _np_params(jnet, 6)
    jf, tf, _ = _feeds(_nmt_spec())
    jl, jg = jax.value_and_grad(lambda pp: jnet.loss_fn(pp, jf)[0])(
        {k: jnp.asarray(v) for k, v in p.items()})
    fused = ttext.seq2seq_attention(fused_decoder=True, **NMT)
    generic = ttext.seq2seq_attention(**NMT)
    assert sorted(TNetwork(fused).param_confs) == sorted(jnet.param_confs)
    assert sorted(TNetwork(generic).param_confs) == sorted(jnet.param_confs)
    lf, gf = _port_loss_grads(fused, p, tf)
    lg, gg = _port_loss_grads(generic, p, tf)
    np.testing.assert_allclose(lf, float(jl), rtol=TOL)
    np.testing.assert_allclose(lg, lf, rtol=TOL)
    for k in p:
        assert _rel(gf[k], jg[k]) <= TOL, k
        assert _rel(gf[k], gg[k]) <= TOL, k


def test_fused_att_decoder_layer_states_match_jax():
    """The layer's own output (the decoder states at every target step,
    the attention masked over each row's source length)."""
    jnet = JNetwork(jtext.seq2seq_attention(fused_decoder=True, **NMT))
    tnet = TNetwork(ttext.seq2seq_attention(fused_decoder=True, **NMT))
    p = _np_params(jnet, 7)
    jf, tf, _ = _feeds(_nmt_spec(8))
    jo, _ = jnet.forward({k: jnp.asarray(v) for k, v in p.items()}, jf,
                         outputs=["decoder"])
    to, _ = tnet.forward(params_from_numpy(p, device="cpu"), tf,
                         outputs=["decoder"])
    assert _rel(to["decoder"].value.detach(), jo["decoder"].value) <= TOL
    assert torch.equal(to["decoder"].seq_lens, torch.from_numpy(TRG_LENS))


def _batches(n, seed):
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(n):
        src = rng.integers(2, 29, (B, 7)).astype(np.int32)
        trg = rng.integers(2, 31, (B, 6)).astype(np.int32)
        out.append((src, SRC_LENS, trg[:, :5], trg[:, 1:], TRG_LENS))
    return out


def _feed(arg, b):
    src, sl, ti, to, tl = b
    return {"src": arg.id_arg(src, sl), "trg_in": arg.id_arg(ti, tl),
            "trg_out": arg.id_arg(to, tl)}


def _train(trainer, batches, feeder, end_cls):
    costs = []
    trainer.train(reader=lambda: iter(batches), feeder=feeder, num_passes=1,
                  event_handler=lambda e: costs.append(e.cost)
                  if isinstance(e, end_cls) else None)
    return np.asarray(costs)


def test_fused_decoder_trains_like_jax():
    opt = dict(learning_method="adam", learning_rate=1e-2)
    jconf = jtext.seq2seq_attention(fused_decoder=True, **NMT)
    p = _np_params(JNetwork(jconf), 9)
    batches = _batches(3, 10)
    jt = JSGD(jconf, JOptConf(**opt), seed=1,
              params={k: jnp.asarray(v) for k, v in p.items()})
    tt = TSGD(ttext.seq2seq_attention(fused_decoder=True, **NMT),
              TOptConf(**opt), seed=1,
              params=params_from_numpy(p, device="cpu"), device="cpu")
    jcosts = _train(jt, batches, lambda b: _feed(jarg, b), JEnd)
    tcosts = _train(tt, batches, lambda b: _feed(targ, b), TEnd)
    assert np.isfinite(tcosts).all() and len(tcosts) == 3
    np.testing.assert_allclose(tcosts, jcosts, rtol=TRAIN_TOL)
    for k, v in params_to_numpy(tt.params).items():
        assert _rel(v, jt.params[k]) <= TRAIN_TOL, k


def test_new_layers_parameters_round_trip():
    confs = {"steps": _lstm_step_conf,
             "mixed": lambda dsl: _mixed_all(dsl)}
    for name, build in confs.items():
        jnet, tnet = JNetwork(build(jdsl)), TNetwork(build(tdsl))
        assert {k: tuple(p.dims) for k, p in tnet.param_confs.items()} == {
            k: tuple(p.dims) for k, p in jnet.param_confs.items()}, name
        p = _np_params(jnet, 1)
        back = params_to_numpy(params_from_numpy(p, device="cpu"))
        for k, v in p.items():
            np.testing.assert_array_equal(back[k], v)
    fused = TNetwork(ttext.seq2seq_attention(fused_decoder=True, **NMT))
    assert {"_dec_state.w0", "_dec_state.w1", "_dec_state.w2",
            "_dec_state.wbias", "_att_dec_proj.w0",
            "_att_score.w0"} <= set(fused.param_confs)


def _mixed_all(dsl):
    with dsl.model() as g:
        x = dsl.data("x", 5)
        ids = dsl.data("ids", 1, is_ids=True)
        dsl.mixed(5, MIXED["sum"](dsl, x, None, ids, None)
                  + [(x, "trans_full_matrix", {"param": (
                      JPC if dsl is jdsl else TPC)(name="shared_t")}),
                     (x, "scaling")], name="out")
    return g.conf
