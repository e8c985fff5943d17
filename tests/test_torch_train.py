"""The port's optimizers, train step and SGD trainer against the JAX
package's, from the same numpy parameters and optimizer state.

- momentum (plain and Nesterov) and adam, each under a non-constant LR
  schedule and with per-parameter L2 / L1 / clipping / LR multipliers:
  three consecutive updates on the same numpy gradients equal the JAX
  optimizers' (rtol 1e-5, atol 1e-6: a few f32 ulps of the O(1)
  values — the port evaluates the schedule and the scalar factors on
  the host in double, the JAX package in f32);
- a 5-step `SGD.train` of the tiny Transformer LM (watchdog on) walks
  the JAX `SGD.train` loss curve (rtol 1e-4) and fires the same events
  in the same order;
- a batch with a NaN is skipped by both trainers: cost NaN, the
  parameters and optimizer state exactly as before it, and the next
  batches continue the same curve.
"""

import dataclasses

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from paddle_tpu import dsl as jdsl
from paddle_tpu import optimizers as jopt
from paddle_tpu.core import arg as jarg
from paddle_tpu.core.config import OptimizationConf as JOptConf
from paddle_tpu.core.config import ParameterConf as JParamConf
from paddle_tpu.models import lm as jlm
from paddle_tpu.trainer.trainer import SGD as JSGD
from paddle_tpu_torch import dsl as tdsl
from paddle_tpu_torch import optimizers as topt
from paddle_tpu_torch.core import arg as targ
from paddle_tpu_torch.core.config import OptimizationConf as TOptConf
from paddle_tpu_torch.core.config import ParameterConf as TParamConf
from paddle_tpu_torch.models import lm as tlm
from paddle_tpu_torch.trainer.trainer import SGD as TSGD
from paddle_tpu_torch.weights import (
    opt_state_from_numpy,
    opt_state_to_numpy,
    params_from_numpy,
    params_to_numpy,
)

# (learning_method, schedule fields, extra OptimizationConf fields)
OPT_CASES = {
    "momentum_poly": ("momentum", dict(learning_rate_schedule="poly",
                                       learning_rate_decay_a=0.1,
                                       learning_rate_decay_b=0.5),
                      dict(momentum=0.9)),
    "momentum_nesterov_discexp": (
        "momentum", dict(learning_rate_schedule="discexp",
                         learning_rate_decay_a=0.5,
                         learning_rate_decay_b=2.0),
        dict(momentum=0.8, use_nesterov=True)),
    "adam_manual": ("adam", dict(learning_rate_schedule="manual",
                                 learning_rate_args="0:1.0,1:0.5,5:0.1"),
                    {}),
    "adam_linear": ("adam", dict(learning_rate_schedule="linear",
                                 learning_rate_decay_a=0.01,
                                 learning_rate_decay_b=0.02), {}),
}

# per-parameter hyperparameters: name -> ParameterConf fields
PARAM_FIELDS = {
    "w": dict(learning_rate=0.5, decay_rate=0.01),
    "b": dict(gradient_clipping_threshold=0.05),
    "e": dict(decay_rate_l1=0.02),
}
SHAPES = {"w": (5, 4), "b": (4,), "e": (7, 3)}


@pytest.mark.parametrize("name", sorted(OPT_CASES))
def test_optimizer_updates_match_jax(name):
    method, sched, extra = OPT_CASES[name]
    fields = dict(learning_method=method, learning_rate=0.05,
                  **sched, **extra)
    jo = jopt.create_optimizer(
        JOptConf(**fields),
        {k: JParamConf(name=k, dims=SHAPES[k], **f)
         for k, f in PARAM_FIELDS.items()})
    to = topt.create_optimizer(
        TOptConf(**fields),
        {k: TParamConf(name=k, dims=SHAPES[k], **f)
         for k, f in PARAM_FIELDS.items()})
    rng = np.random.default_rng(0)
    p_np = {k: rng.standard_normal(s).astype(np.float32)
            for k, s in SHAPES.items()}
    jp = {k: jnp.asarray(v) for k, v in p_np.items()}
    js = jo.init_state(jp)
    tp = params_from_numpy(p_np, device="cpu")
    ts = opt_state_from_numpy(
        {k: {s: np.asarray(x) for s, x in v.items()} for k, v in js.items()},
        device="cpu")
    for step in range(3):
        g_np = {k: rng.standard_normal(s).astype(np.float32)
                for k, s in SHAPES.items()}
        jp, js = jo.update({k: jnp.asarray(v) for k, v in g_np.items()},
                           jp, js, step)
        tp, ts = to.update(params_from_numpy(g_np, device="cpu"), tp, ts,
                           step)
        np.testing.assert_allclose(topt.lr_at(to.conf, step),
                                   float(jopt.lr_at(jo.conf, step)),
                                   rtol=1e-6)
        for k in SHAPES:
            np.testing.assert_allclose(tp[k].numpy(), np.asarray(jp[k]),
                                       rtol=1e-5, atol=1e-6, err_msg=k)
            for slot, x in js[k].items():
                np.testing.assert_allclose(ts[k][slot].numpy(),
                                           np.asarray(x), rtol=1e-5,
                                           atol=1e-6, err_msg=f"{k}.{slot}")


# ---- the trainer ----------------------------------------------------

SPEC = dict(vocab=64, d_model=32, num_heads=2, num_layers=2)
LENS = np.asarray([20, 13, 7, 20], np.int32)


def _lm_batches(n, seed=0, t=20):
    rng = np.random.default_rng(seed)
    return [(rng.integers(2, SPEC["vocab"], (len(LENS), t)).astype(np.int32),
             rng.integers(2, SPEC["vocab"], (len(LENS), t)).astype(np.int32))
            for _ in range(n)]


def _run(sgd, batches, feeder):
    events = []
    sgd.train(reader=lambda: iter(batches), feeder=feeder, num_passes=1,
              event_handler=events.append)
    names = [type(e).__name__ for e in events]
    costs = [e.cost for e in events if type(e).__name__ == "EndIteration"]
    return names, np.asarray(costs)


@pytest.mark.parametrize("impl,method", [("flash", "momentum"),
                                         ("dense", "adam")])
def test_sgd_loss_curve_matches_jax(impl, method):
    opt = dict(learning_method=method, learning_rate=0.05, momentum=0.9,
               learning_rate_schedule="poly", learning_rate_decay_a=0.1,
               learning_rate_decay_b=0.5)
    jspec = jlm.LMSpec(attn_impl=impl, **SPEC)
    tspec = tlm.LMSpec(attn_impl=impl, **SPEC)
    p0 = {k: np.asarray(v) for k, v in
          jlm.lm_init_params(jspec, jax.random.key(3)).items()}
    batches = _lm_batches(5)
    jt = JSGD(jlm.transformer_lm(jspec), JOptConf(**opt), seed=1,
              params={k: jnp.asarray(v) for k, v in p0.items()},
              watchdog=True)
    jnames, jcosts = _run(jt, batches, lambda b: {
        "ids": jarg.id_arg(b[0], LENS), "label": jarg.id_arg(b[1], LENS)})
    tt = TSGD(tlm.transformer_lm(tspec), TOptConf(**opt), seed=1,
              params=params_from_numpy(p0, device="cpu"), watchdog=True,
              device="cpu")
    tnames, tcosts = _run(tt, batches, lambda b: {
        "ids": targ.id_arg(b[0], LENS), "label": targ.id_arg(b[1], LENS)})
    assert tnames == jnames
    assert np.isfinite(tcosts).all()
    np.testing.assert_allclose(tcosts, jcosts, rtol=1e-4)
    assert tt.global_step == jt.global_step == len(batches)


def _mlp(dsl):
    with dsl.model() as m:
        x = dsl.data("x", dim=6)
        y = dsl.data("label", dim=(), is_ids=True)
        h = dsl.fc(x, size=8, act="relu", name="h")
        o = dsl.fc(h, size=3, name="o")
        dsl.classification_cost(o, y)
    return m.conf


def test_nan_batch_is_skipped_by_both():
    rng = np.random.default_rng(0)
    batches = [(rng.standard_normal((8, 6)).astype(np.float32),
                rng.integers(0, 3, 8).astype(np.int32)) for _ in range(4)]
    batches[1][0][3, 2] = np.nan
    opt = dict(learning_method="adam", learning_rate=0.05)
    from paddle_tpu.network import Network as JNetwork

    p0 = {k: np.asarray(v) for k, v in
          JNetwork(_mlp(jdsl)).init_params(jax.random.key(0)).items()}
    jt = JSGD(_mlp(jdsl), JOptConf(**opt), seed=1, watchdog=True,
              params={k: jnp.asarray(v) for k, v in p0.items()})
    tt = TSGD(_mlp(tdsl), TOptConf(**opt), seed=1, watchdog=True,
              params=params_from_numpy(p0, device="cpu"), device="cpu")

    def tfeed(b):
        return {"x": targ.non_seq(b[0]), "label": targ.id_arg(b[1])}

    tt.train_batch(tfeed(batches[0]))
    before = (params_to_numpy(tt.params), opt_state_to_numpy(tt.opt_state))
    cost, finite, _ = tt.run_step(tfeed(batches[1]))
    assert np.isnan(cost) and not finite
    for k, v in params_to_numpy(tt.params).items():
        np.testing.assert_array_equal(v, before[0][k])
    for k, slots in opt_state_to_numpy(tt.opt_state).items():
        for s, v in slots.items():
            np.testing.assert_array_equal(v, before[1][k][s])

    # the whole curve, NaN batch included, against the JAX trainer
    tt = TSGD(_mlp(tdsl), TOptConf(**opt), seed=1, watchdog=True,
              params=params_from_numpy(p0, device="cpu"), device="cpu")
    _jn, jcosts = _run(jt, batches, lambda b: {
        "x": jarg.non_seq(jnp.asarray(b[0])), "label": jarg.id_arg(b[1])})
    _tn, tcosts = _run(tt, batches, tfeed)
    assert np.isnan(jcosts[1]) and np.isnan(tcosts[1])
    keep = [0, 2, 3]
    np.testing.assert_allclose(tcosts[keep], jcosts[keep], rtol=1e-4)


def test_trainer_runs_flash_lm_without_watchdog():
    """The watchdog off: the step returns the scalar loss and every
    batch's update applies."""
    spec = tlm.LMSpec(attn_impl="flash", **SPEC)
    tt = TSGD(tlm.transformer_lm(spec),
              TOptConf(learning_method="adam", learning_rate=0.01),
              seed=5, watchdog=False, device="cpu")
    ids, lbl = _lm_batches(1)[0]
    feed = {"ids": targ.id_arg(ids, LENS), "label": targ.id_arg(lbl, LENS)}
    costs = [tt.train_batch(feed) for _ in range(4)]
    assert costs[-1] < costs[0] and tt.global_step == 4


def test_lm_accounting_matches_jax():
    for d in (32, 256):
        js = jlm.LMSpec(vocab=2048, d_model=d, num_heads=4, num_layers=2)
        ts = tlm.LMSpec(vocab=2048, d_model=d, num_heads=4, num_layers=2)
        assert tlm.lm_param_bytes(ts) == jlm.lm_param_bytes(js)
        assert (tlm.lm_train_flops_per_batch(ts, 32, 128)
                == jlm.lm_train_flops_per_batch(js, 32, 128))
        assert tlm.lm_param_bytes(ts) == 4 * sum(
            int(np.prod(s)) for s in tlm.lm_param_shapes(ts).values())


def test_dataclass_specs_agree():
    assert [f.name for f in dataclasses.fields(tlm.LMSpec)] == [
        f.name for f in dataclasses.fields(jlm.LMSpec)]
