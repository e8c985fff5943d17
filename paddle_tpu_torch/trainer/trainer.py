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

Multi-step dispatch: with `steps_per_dispatch` K > 1 (or the flag of
that name) a pass buffers the fed batches and runs them K at a time
through `run_steps`, one `TrainStep.multi` dispatch a chunk (on the
card the replay of a CUDA graph of K steps, one graph per chunk length
and feed signature: `graphs_captured`). BeginIteration fires when a
batch is collected, EndIteration for each batch in order after its
chunk lands; a change of the feed's shape signature (another length
bucket, a short last batch) flushes the buffer early, and a chunk of
one batch runs as an eager step. The trajectory is that of K = 1.

`Inferencer(net, params, state)` runs the forward in test mode (layer
state read, never advanced) and returns numpy outputs.

Left out, still to port (ROADMAP A7; the mesh A8): evaluators,
checkpoints (sync and async), resume and preemption, the watchdog's
escalation ladder beyond the skip (LR backoff, rollback, abort), the
step timeline and spans, parameter statistics, `test()`, and
`Inferencer.from_merged` (it reads merged checkpoints).
"""

from __future__ import annotations

import logging
from typing import Callable, Optional

import numpy as np
import torch

from paddle_tpu_torch.core import flags as _flags
from paddle_tpu_torch.core import rng as _rng
from paddle_tpu_torch.core.config import ModelConf, OptimizationConf
from paddle_tpu_torch.core.device import resolve_device
from paddle_tpu_torch.network import Network
from paddle_tpu_torch.optimizers import create_optimizer
from paddle_tpu_torch.parallel.dp import (
    TrainStep,
    feed_signature,
    stack_feeds,
    stack_outs,
)
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
        steps_per_dispatch: Optional[int] = None,
    ):
        """`params`: {name: tensor} to start from (moved to the
        device), else drawn from `seed`. `watchdog`: None = the
        `watchdog` flag (default on); True enables the on-device
        non-finite skip, False disables it. `steps_per_dispatch`: None =
        the flag (default 1); K > 1 trains K batches a dispatch."""
        self.device = resolve_device(device)
        if watchdog is None:
            watchdog = bool(_flags.get_flag("watchdog"))
        if steps_per_dispatch is None:
            steps_per_dispatch = int(
                _flags.get_flag("steps_per_dispatch") or 1)
        if steps_per_dispatch < 1:
            raise ValueError(
                f"steps_per_dispatch must be >= 1, got {steps_per_dispatch}")
        self.steps_per_dispatch = steps_per_dispatch
        self.net = Network(model_conf)
        self.opt_conf = opt_conf
        self.opt = create_optimizer(opt_conf, self.net.param_confs)
        root = _rng.root_generator(seed or _flags.get_flag("seed"))
        init_gen = _rng.generator(_rng.step_seed(root.initial_seed(), -1))
        # the step keys live on the device dropout draws on
        self.step_root = _rng.generator(root.initial_seed(), self.device)
        if params is not None:
            self.params = {k: v.detach().to(self.device)
                           for k, v in params.items()}
        else:
            self.params = self.net.init_params(init_gen, self.device)
        self.state = self.net.init_state(self.device)
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
        # between graph replays the result lands in the tensors the
        # graphs read
        self.params, self.opt_state, self.state = self.step_fn.settle(
            self.params, self.opt_state, self.state)
        self.global_step += 1
        if self.step_fn.watchdog:
            health = loss.cpu().numpy()  # the single host fetch
            return float(health[0]), bool(health[1]), outs
        return float(loss), True, outs

    @property
    def graphs_captured(self) -> int:
        """CUDA graphs of K steps captured so far (0 off the card)."""
        return self.step_fn.graphs_captured

    def run_steps(self, feeds: list, lr_scale: float = 1.0) -> tuple:
        """Run len(feeds) consecutive steps in ONE dispatch
        (`TrainStep.multi`); one feed runs as `run_step`. Returns (costs,
        finites, outs): per-batch cost and finiteness lists in step
        order (one device->host fetch carries all of them), and the kept
        outputs stacked [n, ...]. The trajectory is that of n calls of
        run_step. All feeds of one call share one shape signature."""
        n = len(feeds)
        if n == 1:
            cost, finite, outs = self.run_step(feeds[0], lr_scale)
            return [cost], [finite], stack_outs([outs])
        (
            self.params,
            self.opt_state,
            self.state,
            losses,
            outs,
        ) = self.step_fn.multi(
            self.params, self.opt_state, self.state, stack_feeds(feeds),
            self.global_step, self.step_root, lr_scale=lr_scale,
        )
        self.global_step += n
        health = losses.cpu().numpy()  # the single host fetch
        if self.step_fn.watchdog:
            return ([float(h) for h in health[:, 0]],
                    [bool(h) for h in health[:, 1]], outs)
        return [float(h) for h in health], [True] * n, outs

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
            if self.steps_per_dispatch > 1:
                self._run_pass_pipelined(pass_id, reader(), feeder,
                                         event_handler, costs, log_period)
                event_handler(EndPass(pass_id, {}))
                continue
            for batch_id, raw in enumerate(reader()):
                event_handler(BeginIteration(pass_id, batch_id))
                cost, finite, _outs = self.run_step(feeder(raw))
                if finite:
                    costs.append(cost)
                event_handler(EndIteration(pass_id, batch_id, cost, {}))
                self._log(pass_id, batch_id, costs, log_period)
            event_handler(EndPass(pass_id, {}))

    @staticmethod
    def _log(pass_id, batch_id, costs, log_period):
        if (batch_id + 1) % log_period == 0:
            log.info(
                "pass %d batch %d cost %.5f", pass_id, batch_id,
                float(np.mean(costs[-log_period:]))
                if costs else float("nan"),
            )

    def _run_pass_pipelined(self, pass_id, batch_iter, feeder,
                            event_handler, costs, log_period):
        """One pass with steps_per_dispatch > 1: batches are buffered
        and run as chunks of `run_steps`. BeginIteration fires when a
        batch is collected (before its step runs), EndIteration for
        every batch in order after its chunk lands. A change of the
        feed's shape signature flushes the buffer early."""
        buf = []  # (batch_id, feed)
        sig = None

        def flush():
            nonlocal buf, sig
            if not buf:
                return
            cs, fs, _outs = self.run_steps([f for _, f in buf])
            for j, (bid, _feed) in enumerate(buf):
                if fs[j]:
                    costs.append(cs[j])
                event_handler(EndIteration(pass_id, bid, cs[j], {}))
                self._log(pass_id, bid, costs, log_period)
            buf, sig = [], None

        for batch_id, raw in enumerate(batch_iter):
            event_handler(BeginIteration(pass_id, batch_id))
            feed = feeder(raw)
            fsig = feed_signature(feed)
            if buf and fsig != sig:
                flush()
            buf.append((batch_id, feed))
            sig = fsig
            if len(buf) >= self.steps_per_dispatch:
                flush()
        flush()


class Inferencer:
    """Inference runner: `paddle_tpu/trainer/trainer.py::Inferencer` on
    one device. `params` and `state` ({name: tensor}, {layer: {slot:
    tensor}}) are moved to the device; `state` defaults to the
    network's initial state. `infer(feed)` runs the forward with
    train=False under no_grad, pruned to `outputs` (default the
    network's), and returns {name: numpy array}."""

    def __init__(self, net: Network, params: dict, state=None, outputs=None,
                 device=None):
        self.device = resolve_device(device)
        self.net = net
        self.params = {k: v.detach().to(self.device)
                       for k, v in params.items()}
        self.state = ({k: {s: t.to(self.device) for s, t in slots.items()}
                       for k, slots in state.items()}
                      if state is not None else net.init_state(self.device))
        self.output_names = list(outputs or net.output_names)

    def infer(self, feed: dict) -> dict:
        feed = {k: a.to(self.device) for k, a in feed.items()}
        with torch.no_grad():
            outs, _ = self.net.forward(self.params, feed, state=self.state,
                                       train=False,
                                       outputs=self.output_names)
        return {n: (outs[n].value if outs[n].value is not None
                    else outs[n].ids).cpu().numpy()
                for n in self.output_names}
