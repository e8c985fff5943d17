"""Optimizers and learning-rate schedules: `paddle_tpu/optimizers/
__init__.py` on torch.

The same functional contract: `update(grads, params, state, step)`
returns new params and new state dicts (the inputs are not modified),
with per-parameter static hyperparameters (`ParamHyper`) from the
ParameterConfs. Ported: the base with clipping, L2 folded into the
gradient and L1 shrinkage after the step; all eight LR schedules; sgd /
momentum (+ Nesterov), adagrad, decayed_adagrad, adadelta, rmsprop,
adam and adamax, with the JAX formulas. Still to port (ROADMAP A7):
ParameterAverager and the static-pruning mask (a ParameterConf with
sparsity_ratio raises).

The schedule is evaluated on the host for the step's integer counter,
in double precision, with every other scalar that moves from step to
step: the LR times each `lr_mult` and the watchdog's `lr_scale`, the L1
shrink, and adam's and adamax's bias corrections, adam's as
reciprocals that the update multiplies by (`step_scalars`, in
the order of `scalar_keys`). Each is rounded once to the parameters'
dtype and read by the update from a device tensor (`scalars`), so a
step replayed in a CUDA graph reads the values of its own step, and
the eager and the replayed update agree bit for bit. The update then
runs on the parameters' device, as one plain PyTorch expression per
parameter.
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Optional

import torch

from paddle_tpu_torch.core.config import OptimizationConf, ParameterConf
from paddle_tpu_torch.core.device import host_to_device
from paddle_tpu_torch.core.registry import LR_SCHEDULERS, OPTIMIZERS


# ---------------- learning-rate schedules ----------------

def _sched_constant(conf: OptimizationConf, t):
    return 1.0


def _sched_poly(conf, t):
    # lr * (1 + a*t)^(-b)
    return (1.0 + conf.learning_rate_decay_a * t) ** (
        -conf.learning_rate_decay_b)


def _sched_exp(conf, t):
    # lr * a^(t/b)
    return conf.learning_rate_decay_a ** (t / conf.learning_rate_decay_b)


def _sched_discexp(conf, t):
    # lr * a^floor(t/b)
    return conf.learning_rate_decay_a ** math.floor(
        t / conf.learning_rate_decay_b)


def _sched_linear(conf, t):
    # max(lr - a*t, b) / lr
    lr = conf.learning_rate
    return max(lr - conf.learning_rate_decay_a * t,
               conf.learning_rate_decay_b) / lr


def _sched_caffe_poly(conf, t):
    # lr * (1 - t/a)^b while t <= a, else 0 (time axis: batch steps)
    a, b = conf.learning_rate_decay_a, conf.learning_rate_decay_b
    return max(1.0 - t / a, 0.0) ** b if t <= a else 0.0


def _parse_lr_args(conf):
    """"seg1:rate1,seg2:rate2,..." (manual segment table)."""
    segs, rates = [], []
    for part in conf.learning_rate_args.split(","):
        part = part.strip()
        if not part:
            continue
        s, r = part.split(":")
        segs.append(float(s))
        rates.append(float(r))
    assert segs, "manual LR schedule needs learning_rate_args"
    return segs, rates


def _manual_select(segs, rates, t):
    for s, r in zip(segs, rates):
        if t <= s:
            return r
    return rates[-1]


def _sched_manual(conf, t):
    # segment table over batch steps
    segs, rates = _parse_lr_args(conf)
    return _manual_select(segs, rates, t)


def _sched_pass_manual(conf, t):
    # segments over the pass number, derived from batches_per_pass when
    # set, else `t` is taken as the pass
    segs, rates = _parse_lr_args(conf)
    bpp = getattr(conf, "batches_per_pass", 0)
    return _manual_select(segs, rates, math.floor(t / bpp) if bpp else t)


for _n, _f in [
    ("constant", _sched_constant),
    ("poly", _sched_poly),
    ("caffe_poly", _sched_caffe_poly),
    ("exp", _sched_exp),
    ("discexp", _sched_discexp),
    ("linear", _sched_linear),
    ("manual", _sched_manual),
    ("pass_manual", _sched_pass_manual),
]:
    LR_SCHEDULERS.register(_n)(type("S_" + _n, (), {"fn": staticmethod(_f)}))


def lr_at(conf: OptimizationConf, step) -> float:
    """Effective learning rate at batch step `step`."""
    sched = LR_SCHEDULERS.get(conf.learning_rate_schedule).fn
    return conf.learning_rate * sched(conf, float(step))


# ---------------- per-parameter static hyperparams ----------------

@dataclass(frozen=True)
class ParamHyper:
    lr_mult: float = 1.0
    l1: float = 0.0
    l2: float = 0.0
    clip: float = 0.0  # per-parameter clip threshold
    is_static: bool = False
    momentum: Optional[float] = None
    sparsity_ratio: Optional[float] = None


def hyper_from_conf(pc: ParameterConf, opt: OptimizationConf) -> ParamHyper:
    return ParamHyper(
        lr_mult=pc.learning_rate,
        l1=pc.decay_rate_l1 if pc.decay_rate_l1 is not None else opt.l1_rate,
        l2=pc.decay_rate if pc.decay_rate is not None else opt.l2_rate,
        clip=pc.gradient_clipping_threshold or opt.gradient_clipping_threshold,
        is_static=pc.is_static,
        momentum=pc.momentum,
        sparsity_ratio=getattr(pc, "sparsity_ratio", None),
    )


# ---------------- optimizer base ----------------

class Optimizer:
    """Functional optimizer. State is {param name: {slot: tensor}}."""

    name = None

    def __init__(self, conf: OptimizationConf, hypers: dict):
        self.conf = conf
        self.hypers = hypers  # param name -> ParamHyper
        pruned = sorted(k for k, h in hypers.items() if h.sparsity_ratio)
        if pruned:
            raise NotImplementedError(
                f"static pruning (sparsity_ratio on {pruned}) is not "
                f"ported yet"
            )
        # the step's scalars: the LR at each lr_mult (a parameter
        # without a conf takes 1.0), the L1 shrink at each (lr_mult,
        # l1), then the optimizer's own
        mults = sorted({1.0} | {h.lr_mult for h in hypers.values()})
        l1s = sorted({(h.lr_mult, h.l1) for h in hypers.values()
                      if h.l1 > 0.0})
        self.scalar_keys = ([("lr", m) for m in mults]
                            + [("l1", m, l1) for m, l1 in l1s]
                            + self._own_scalar_keys(mults))
        self._index = {k: i for i, k in enumerate(self.scalar_keys)}

    def init_state(self, params: dict) -> dict:
        return {k: self._init_one(v) for k, v in params.items()}

    def step_scalars(self, step, lr_scale=None) -> list:
        """The step's scalars in the order of `scalar_keys`, computed on
        the host in double."""
        lr = lr_at(self.conf, step)
        if lr_scale is not None:
            lr = lr * lr_scale
        t = float(step) + 1.0
        out = []
        for key in self.scalar_keys:
            if key[0] == "lr":
                out.append(lr * key[1])
            elif key[0] == "l1":
                out.append(lr * key[1] * key[2])
            else:
                out.append(self._own_scalar(key, lr, t))
        return out

    def scalars_tensor(self, step, lr_scale, like) -> torch.Tensor:
        """`step_scalars` as a [len(scalar_keys)] tensor in `like`'s
        dtype on its device (copied there without a host sync)."""
        return host_to_device(torch.tensor(self.step_scalars(step, lr_scale),
                                           dtype=like.dtype), like.device)

    @torch.no_grad()
    def update(self, grads: dict, params: dict, state: dict, step,
               lr_scale=None, scalars=None) -> tuple:
        """Returns (new_params, new_state). `step` is the global batch
        counter (0-based). `lr_scale` scales the scheduled LR for this
        step (not the gradients, so adaptive moments see the true
        gradient). `scalars`: the step's `scalars_tensor` (then `step`
        and `lr_scale` are not read), else it is made here from them."""
        if scalars is None:
            scalars = self.scalars_tensor(step, lr_scale,
                                          next(iter(params.values())))
        sc = {k: scalars[i] for k, i in self._index.items()}
        new_p, new_s = {}, {}
        for k, p in params.items():
            h = self.hypers.get(k, ParamHyper())
            g = grads.get(k)
            if g is None or h.is_static:
                new_p[k], new_s[k] = p, state[k]
                continue
            if h.clip > 0.0:
                g = torch.clamp(g, -h.clip, h.clip)
            # L2 decay folded into the gradient
            if h.l2 > 0.0:
                g = g + h.l2 * p
            np_, ns_ = self._apply_one(p, g, state[k], sc[("lr", h.lr_mult)],
                                       h, sc)
            # L1: proximal shrinkage after the step
            if h.l1 > 0.0:
                shrink = sc[("l1", h.lr_mult, h.l1)]
                np_ = torch.sign(np_) * torch.clamp(np_.abs() - shrink,
                                                    min=0.0)
            new_p[k], new_s[k] = np_, ns_
        return new_p, new_s

    def _own_scalar_keys(self, mults) -> list:
        """Keys of the optimizer's own per-step scalars."""
        return []

    def _own_scalar(self, key, lr, t) -> float:
        """The value of own key `key` at LR `lr` (lr_scale applied) and
        t = step + 1."""
        raise NotImplementedError

    def _init_one(self, p):
        raise NotImplementedError

    def _apply_one(self, p, g, s, lr, h, sc):
        """One parameter's update at LR `lr` (a 0-dim tensor: the step's
        LR times h.lr_mult); `sc` maps every scalar key to its 0-dim
        tensor."""
        raise NotImplementedError


@OPTIMIZERS.register("sgd", "momentum")
class SgdOptimizer(Optimizer):
    """SGD + (optionally Nesterov) momentum."""

    def _init_one(self, p):
        return {"mom": torch.zeros_like(p)}

    def _apply_one(self, p, g, s, lr, h, sc):
        mu = h.momentum if h.momentum is not None else self.conf.momentum
        v = mu * s["mom"] - lr * g
        if self.conf.use_nesterov:
            p_new = p + mu * v - lr * g
        else:
            p_new = p + v
        return p_new, {"mom": v}


@OPTIMIZERS.register("adagrad")
class AdagradOptimizer(Optimizer):
    """accum += g^2; p -= lr * g / (sqrt(accum) + eps)."""

    def _init_one(self, p):
        return {"accum": torch.zeros_like(p)}

    def _apply_one(self, p, g, s, lr, h, sc):
        accum = s["accum"] + torch.square(g)
        p_new = p - lr * g / (torch.sqrt(accum) + self.conf.ada_epsilon)
        return p_new, {"accum": accum}


@OPTIMIZERS.register("decayed_adagrad")
class DecayedAdagradOptimizer(Optimizer):
    """accum = rou*accum + (1-rou)*g^2; p -= lr * g / (sqrt(accum) +
    eps)."""

    def _init_one(self, p):
        return {"accum": torch.zeros_like(p)}

    def _apply_one(self, p, g, s, lr, h, sc):
        rou = self.conf.ada_rou
        accum = rou * s["accum"] + (1 - rou) * torch.square(g)
        p_new = p - lr * g / (torch.sqrt(accum) + self.conf.ada_epsilon)
        return p_new, {"accum": accum}


@OPTIMIZERS.register("adadelta")
class AdadeltaOptimizer(Optimizer):
    """Adadelta: the update scaled by sqrt((E[upd^2] + eps) / (E[g^2] +
    eps))."""

    def _init_one(self, p):
        return {"accum": torch.zeros_like(p),
                "accum_update": torch.zeros_like(p)}

    def _apply_one(self, p, g, s, lr, h, sc):
        rou, eps = self.conf.ada_rou, self.conf.ada_epsilon
        accum = rou * s["accum"] + (1 - rou) * torch.square(g)
        upd = g * torch.sqrt((s["accum_update"] + eps) / (accum + eps))
        accum_update = (rou * s["accum_update"]
                        + (1 - rou) * torch.square(upd))
        return p - lr * upd, {"accum": accum, "accum_update": accum_update}


@OPTIMIZERS.register("rmsprop")
class RMSPropOptimizer(Optimizer):
    """g2 = rou*g2 + (1-rou)*g^2 and g1 = rou*g1 + (1-rou)*g; p -= lr * g
    / sqrt(g2 - g1^2 + eps) (the mean-removal form)."""

    def _init_one(self, p):
        return {"g2": torch.zeros_like(p), "g1": torch.zeros_like(p)}

    def _apply_one(self, p, g, s, lr, h, sc):
        rou, eps = self.conf.ada_rou, self.conf.ada_epsilon
        g2 = rou * s["g2"] + (1 - rou) * torch.square(g)
        g1 = rou * s["g1"] + (1 - rou) * g
        denom = torch.sqrt(g2 - torch.square(g1) + eps)
        return p - lr * g / denom, {"g2": g2, "g1": g1}


@OPTIMIZERS.register("adam")
class AdamOptimizer(Optimizer):
    """Adam with bias correction at t = step + 1."""

    def _init_one(self, p):
        return {"m": torch.zeros_like(p), "v": torch.zeros_like(p)}

    def _own_scalar_keys(self, mults):
        return [("inv_bc1",), ("inv_bc2",)]

    def _own_scalar(self, key, lr, t):
        # 1 / (1 - beta^t), the reciprocal taken in double: on the card
        # this is the multiplier PyTorch used for a host scalar divisor
        c = self.conf
        beta = c.adam_beta1 if key == ("inv_bc1",) else c.adam_beta2
        return 1 / (1 - beta ** t)

    def _apply_one(self, p, g, s, lr, h, sc):
        b1, b2 = self.conf.adam_beta1, self.conf.adam_beta2
        eps = self.conf.adam_epsilon
        m = b1 * s["m"] + (1 - b1) * g
        v = b2 * s["v"] + (1 - b2) * torch.square(g)
        mhat = m * sc[("inv_bc1",)]
        vhat = v * sc[("inv_bc2",)]
        return p - lr * mhat / (torch.sqrt(vhat) + eps), {"m": m, "v": v}


@OPTIMIZERS.register("adamax")
class AdamaxOptimizer(Optimizer):
    """m = b1*m + (1-b1)*g; u = max(b2*u, |g|); p -= lr / (1 - b1^t) * m
    / (u + 1e-12), t = step + 1."""

    def _init_one(self, p):
        return {"m": torch.zeros_like(p), "u": torch.zeros_like(p)}

    def _own_scalar_keys(self, mults):
        # lr / (1 - b1^t) at each lr_mult, in double as one scalar
        return [("lr_bc1", m) for m in mults]

    def _own_scalar(self, key, lr, t):
        return lr * key[1] / (1 - self.conf.adam_beta1 ** t)

    def _apply_one(self, p, g, s, lr, h, sc):
        b1, b2 = self.conf.adam_beta1, self.conf.adam_beta2
        m = b1 * s["m"] + (1 - b1) * g
        u = torch.maximum(b2 * s["u"], torch.abs(g))
        p_new = p - sc[("lr_bc1", h.lr_mult)] * m / (u + 1e-12)
        return p_new, {"m": m, "u": u}


def create_optimizer(conf: OptimizationConf, param_confs: dict) -> Optimizer:
    hypers = {k: hyper_from_conf(pc, conf) for k, pc in param_confs.items()}
    cls = OPTIMIZERS.get(conf.learning_method)
    return cls(conf, hypers)
