"""The CTR models and the optimizers of the sparse CTR slice against the
JAX package's, on the CPU.

- `ctr_linear` and `ctr_wide_deep` (the port's copy of `models/ctr.py`)
  at narrow widths: the loss and every gradient through the port's
  `Network` against the JAX `Network`, on the same numpy parameters and
  feed (1e-5 of the largest entry);
- adagrad, decayed_adagrad, adadelta, rmsprop and adamax: one and five
  updates on the same numpy parameters, gradients and state, with
  per-parameter L2 / L1 / clipping / LR multipliers, against the JAX
  optimizers (1e-6 of the largest entry: the port evaluates the scalar
  factors on the host in double, the JAX package in f32);
- a short `SGD.train` of each model (adam 0.02, as
  `tests/test_compat_ctr.py`) walks the JAX loss curve (rtol 1e-4), and
  the loss falls.

The tables keep the `sparse_update` mark and are updated densely, as in
the JAX package.
"""

import numpy as np
import pytest

import jax
import jax.numpy as jnp

from paddle_tpu import optimizers as jopt
from paddle_tpu.core import arg as jarg
from paddle_tpu.core.config import OptimizationConf as JOptConf
from paddle_tpu.core.config import ParameterConf as JParamConf
from paddle_tpu.models import ctr as jctr
from paddle_tpu.network import Network as JNetwork
from paddle_tpu.trainer.trainer import SGD as JSGD
from paddle_tpu_torch import optimizers as topt
from paddle_tpu_torch.core import arg as targ
from paddle_tpu_torch.core.config import OptimizationConf as TOptConf
from paddle_tpu_torch.core.config import ParameterConf as TParamConf
from paddle_tpu_torch.models import ctr as tctr
from paddle_tpu_torch.network import Network as TNetwork
from paddle_tpu_torch.trainer.trainer import SGD as TSGD
from paddle_tpu_torch.weights import opt_state_from_numpy, params_from_numpy

F, B, ACTIVE = 1000, 32, 8
MODELS = {
    "linear": dict(feature_dim=F),
    "wide_deep": dict(feature_dim=F, emb_dim=8, hidden=(16, 8)),
}
CTORS = {"linear": "ctr_linear", "wide_deep": "ctr_wide_deep"}


def _rel(got, ref):
    got, ref = np.asarray(got), np.asarray(ref)
    assert got.shape == ref.shape
    return float(np.abs(got - ref).max()) / max(float(np.abs(ref).max()),
                                                1e-30)


def _confs(name):
    return (getattr(jctr, CTORS[name])(**MODELS[name]),
            getattr(tctr, CTORS[name])(**MODELS[name]))


def _batch(seed):
    """Feature ids, labels driven by the presence of low ids, lengths
    from 1 to ACTIVE."""
    rng = np.random.default_rng(seed)
    feats = rng.integers(0, F, (B, ACTIVE)).astype(np.int32)
    lens = rng.integers(1, ACTIVE + 1, B).astype(np.int32)
    live = np.arange(ACTIVE)[None, :] < lens[:, None]
    label = ((feats < 120) & live).any(axis=1).astype(np.int32)
    return feats, label, lens


def _jfeed(b):
    return {"features": jarg.id_arg(jnp.asarray(b[0]), jnp.asarray(b[2])),
            "label": jarg.id_arg(jnp.asarray(b[1]))}


def _tfeed(b):
    return {"features": targ.id_arg(b[0], b[2]), "label": targ.id_arg(b[1])}


def _np_params(jnet, seed):
    rng = np.random.default_rng(seed)
    out = {}
    for k, v in jnet.init_params(jax.random.key(seed)).items():
        v = np.asarray(v)
        out[k] = v + 0.1 * rng.standard_normal(v.shape).astype(np.float32)
    return out


@pytest.mark.parametrize("name", sorted(MODELS))
def test_loss_and_gradients_match_jax(name):
    jconf, tconf = _confs(name)
    assert tconf.to_json() == jconf.to_json()
    jnet, tnet = JNetwork(jconf), TNetwork(tconf)
    p0 = _np_params(jnet, 1)
    batch = _batch(2)
    (jloss, _aux), jgrads = jax.value_and_grad(jnet.loss_fn, has_aux=True)(
        {k: jnp.asarray(v) for k, v in p0.items()}, _jfeed(batch))
    tp = {k: v.requires_grad_(True)
          for k, v in params_from_numpy(p0, device="cpu").items()}
    tloss, _ = tnet.loss_fn(tp, _tfeed(batch))
    tloss.backward()
    assert _rel(tloss.item(), float(jloss)) <= 1e-5
    assert sorted(jgrads) == sorted(tp)
    assert tnet.param_confs["wide_w"].sparse_update
    for k, g in jgrads.items():
        assert _rel(tp[k].grad.numpy(), g) <= 1e-5, k


NEW_OPTS = {
    "adagrad": dict(ada_epsilon=1e-6),
    "decayed_adagrad": dict(ada_rou=0.9, ada_epsilon=1e-6),
    "adadelta": dict(ada_rou=0.95, ada_epsilon=1e-6),
    "rmsprop": dict(ada_rou=0.9, ada_epsilon=1e-6),
    "adamax": dict(adam_beta1=0.9, adam_beta2=0.999),
}
PARAM_FIELDS = {
    "w": dict(learning_rate=0.5, decay_rate=0.01),
    "b": dict(gradient_clipping_threshold=0.05),
    "e": dict(decay_rate_l1=0.002),
}
SHAPES = {"w": (5, 4), "b": (4,), "e": (7, 3)}


@pytest.mark.parametrize("steps", [1, 5])
@pytest.mark.parametrize("method", sorted(NEW_OPTS))
def test_new_optimizers_match_jax(method, steps):
    fields = dict(learning_method=method, learning_rate=0.05,
                  **NEW_OPTS[method])
    jo = jopt.create_optimizer(
        JOptConf(**fields),
        {k: JParamConf(name=k, dims=SHAPES[k], **f)
         for k, f in PARAM_FIELDS.items()})
    to = topt.create_optimizer(
        TOptConf(**fields),
        {k: TParamConf(name=k, dims=SHAPES[k], **f)
         for k, f in PARAM_FIELDS.items()})
    rng = np.random.default_rng(3)
    p_np = {k: rng.standard_normal(s).astype(np.float32)
            for k, s in SHAPES.items()}
    jp = {k: jnp.asarray(v) for k, v in p_np.items()}
    js = jo.init_state(jp)
    # a non-zero starting state, the same on both sides (rmsprop's
    # E[g^2] at least E[g]^2, as its updates keep it)
    s_np = {k: {s: np.abs(rng.standard_normal(x.shape)).astype(np.float32)
                * 0.1 for s, x in v.items()} for k, v in js.items()}
    for v in s_np.values():
        if "g2" in v:
            v["g2"] = v["g2"] + np.square(v["g1"])
    js = {k: {s: jnp.asarray(x) for s, x in v.items()}
          for k, v in s_np.items()}
    tp = params_from_numpy(p_np, device="cpu")
    ts = opt_state_from_numpy(s_np, device="cpu")
    assert {k: sorted(v) for k, v in ts.items()} == {
        k: sorted(v) for k, v in to.init_state(tp).items()}
    for step in range(steps):
        g_np = {k: rng.standard_normal(s).astype(np.float32)
                for k, s in SHAPES.items()}
        jp, js = jo.update({k: jnp.asarray(v) for k, v in g_np.items()},
                           jp, js, step)
        tp, ts = to.update(params_from_numpy(g_np, device="cpu"), tp, ts,
                           step)
    for k in SHAPES:
        assert _rel(tp[k].numpy(), jp[k]) <= 1e-6, k
        for slot, x in js[k].items():
            assert _rel(ts[k][slot].numpy(), x) <= 1e-6, f"{k}.{slot}"


def _costs(trainer, batches, feeder):
    costs = []
    trainer.train(reader=lambda: iter(batches), feeder=feeder, num_passes=1,
                  event_handler=lambda e: costs.append(e.cost)
                  if type(e).__name__ == "EndIteration" else None)
    return np.asarray(costs)


@pytest.mark.parametrize("name", sorted(MODELS))
def test_sgd_loss_falls_as_jax(name):
    jconf, tconf = _confs(name)
    opt = dict(learning_method="adam", learning_rate=0.02)
    p0 = _np_params(JNetwork(jconf), 4)
    batches = [_batch(5)] * 12
    jt = JSGD(jconf, JOptConf(**opt), seed=1,
              params={k: jnp.asarray(v) for k, v in p0.items()},
              watchdog=True)
    tt = TSGD(tconf, TOptConf(**opt), seed=1,
              params=params_from_numpy(p0, device="cpu"), watchdog=True,
              device="cpu")
    jcosts = _costs(jt, batches, _jfeed)
    tcosts = _costs(tt, batches, _tfeed)
    np.testing.assert_allclose(tcosts, jcosts, rtol=1e-4)
    assert tcosts[-1] < 0.7 * tcosts[0]
