"""SGD trainer — the event-driven training loop of
`paddle_tpu/trainer/trainer.py` on torch, on one device.

    trainer = SGD(model_conf, opt_conf)            # on the card
    trainer = SGD(model_conf, opt_conf, device="cpu")
    trainer.train(reader=batched_reader, feeder=feeder,
                  num_passes=10, event_handler=handler)

It fires the same events in the same order as the JAX trainer:
BeginPass, then per batch BeginIteration and EndIteration(cost), then
EndPass. With the watchdog on (the default, the `watchdog` flag) a
batch whose loss or any gradient is non-finite is skipped on the
device (`parallel/dp.py::TrainStep`): the model and optimizer state
keep their old values and the batch's cost stays out of the pass mean.

Left out, still to port (ROADMAP A7; the mesh A8): evaluators,
multi-step dispatch, checkpoints (sync and async), resume and
preemption, the watchdog's escalation ladder beyond the skip (LR
backoff, rollback, abort), the step timeline and spans, and `test()`.
"""

from __future__ import annotations

import logging
from typing import Callable, Optional

import numpy as np

from paddle_tpu_torch.core import flags as _flags
from paddle_tpu_torch.core import rng as _rng
from paddle_tpu_torch.core.config import ModelConf, OptimizationConf
from paddle_tpu_torch.core.device import resolve_device
from paddle_tpu_torch.network import Network
from paddle_tpu_torch.optimizers import create_optimizer
from paddle_tpu_torch.parallel.dp import TrainStep
from paddle_tpu_torch.trainer.events import (
    BeginIteration,
    BeginPass,
    EndIteration,
    EndPass,
)

log = logging.getLogger("paddle_tpu_torch.trainer")


class SGD:
    def __init__(
        self,
        model_conf: ModelConf,
        opt_conf: OptimizationConf,
        seed: int = 0,
        params: Optional[dict] = None,
        watchdog=None,
        device=None,
    ):
        """`params`: {name: tensor} to start from (moved to the
        device), else drawn from `seed`. `watchdog`: None = the
        `watchdog` flag (default on); True enables the on-device
        non-finite skip, False disables it."""
        self.device = resolve_device(device)
        if watchdog is None:
            watchdog = bool(_flags.get_flag("watchdog"))
        self.net = Network(model_conf)
        self.opt_conf = opt_conf
        self.opt = create_optimizer(opt_conf, self.net.param_confs)
        root = _rng.root_generator(seed or _flags.get_flag("seed"))
        init_gen = _rng.split_for_step(root, -1)
        # per-step generators live on the device dropout draws on
        self.step_root = _rng.generator(root.initial_seed(), self.device)
        if params is not None:
            self.params = {k: v.detach().to(self.device)
                           for k, v in params.items()}
        else:
            self.params = self.net.init_params(init_gen, self.device)
        self.state = self.net.init_state()
        self.opt_state = self.opt.init_state(self.params)
        self.step_fn = TrainStep(self.net, self.opt,
                                 watchdog=bool(watchdog), device=self.device)
        self.global_step = 0

    def train_batch(self, feed) -> float:
        """One train step on an already-fed Arg dict; returns the
        cost."""
        cost, _finite, _outs = self.run_step(feed)
        return cost

    def run_step(self, feed, lr_scale: float = 1.0) -> tuple:
        """One step on an already-fed Arg dict; returns (cost, finite,
        outs). With the watchdog, the step's health vector [loss,
        all_finite] comes back in ONE device->host copy, and a
        non-finite batch's update was already skipped on the device."""
        rng = _rng.split_for_step(self.step_root, self.global_step)
        (
            self.params,
            self.opt_state,
            self.state,
            loss,
            outs,
        ) = self.step_fn(
            self.params, self.opt_state, self.state, feed,
            self.global_step, rng, lr_scale=lr_scale,
        )
        self.global_step += 1
        if self.step_fn.watchdog:
            health = loss.cpu().numpy()  # the single host fetch
            return float(health[0]), bool(health[1]), outs
        return float(loss), True, outs

    def train(
        self,
        reader: Callable,
        feeder: Callable,
        num_passes: int = 1,
        event_handler: Optional[Callable] = None,
    ):
        """reader yields raw batches; feeder converts one to an Arg
        dict."""
        event_handler = event_handler or (lambda e: None)
        log_period = _flags.get_flag("log_period")
        for pass_id in range(num_passes):
            event_handler(BeginPass(pass_id))
            costs = []
            for batch_id, raw in enumerate(reader()):
                event_handler(BeginIteration(pass_id, batch_id))
                cost, finite, _outs = self.run_step(feeder(raw))
                if finite:
                    costs.append(cost)
                event_handler(EndIteration(pass_id, batch_id, cost, {}))
                if (batch_id + 1) % log_period == 0:
                    log.info(
                        "pass %d batch %d cost %.5f", pass_id, batch_id,
                        float(np.mean(costs[-log_period:]))
                        if costs else float("nan"),
                    )
            event_handler(EndPass(pass_id, {}))
