"""SGD trainer — the event-driven training loop of
`paddle_tpu/trainer/trainer.py` on torch.

    trainer = SGD(model_conf, opt_conf, evaluators=[...])  # on the card
    trainer = SGD(model_conf, opt_conf, device="cpu")
    trainer.train(reader=batched_reader, feeder=feeder, num_passes=10,
                  event_handler=handler, test_reader=..., save_dir=...)

It fires the JAX trainer's events in its order: BeginPass; per batch
BeginIteration and EndIteration(cost, evaluator results every
`log_period` batches); then TestResult (with a `test_reader`), the
pass's checkpoint (with a `save_dir`) and EndPass(evaluator results).

Evaluators (`evaluators.py`) read the step's kept outputs (their layers
are in `TrainStep`'s `keep_outputs`) and the feed, on the host. `test()`
runs the forward in test mode over a reader and returns the cost and
the evaluators' results.

Checkpoints: `checkpoint_mode` "sync" writes `trainer/checkpoint.py`'s
pass directory at the end of each pass; "async" hands a device->host
snapshot to `trainer/async_checkpoint.py`'s writer thread. `resume()`
loads whichever is newest and complete, with the mid-pass offset of a
preemption flush; `train(skip_batches=...)` drops that many batches of
its first pass.

The watchdog (`trainer/watchdog.py`; the `watchdog` flag, or a
`WatchdogConfig`): a batch whose loss or any gradient is non-finite is
skipped on the device (`parallel/dp.py::TrainStep`); on the host the
ladder backs the LR off after a loss spike, rolls back to the last
promoted checkpoint when skips or spikes keep coming, and aborts with a
`WatchdogReport` when it runs out of rungs. With a `save_dir`, SIGTERM
is turned into a flag checked after the in-flight batch (chunk): the
loop flushes a mid-pass checkpoint and raises `Preempted` (the CLI's
exit 75).

Multi-step dispatch: with `steps_per_dispatch` K > 1 (or the flag of
that name) a pass buffers the fed batches and runs them K at a time
through `run_steps`, one `TrainStep.multi` dispatch a chunk (on the
card the replay of a CUDA graph of K steps, one graph per chunk length
and feed signature: `graphs_captured`). BeginIteration fires when a
batch is collected, EndIteration, the evaluators and the watchdog see
each batch in order after its chunk lands (the evaluators read the
chunk's stacked outputs in one host fetch); a change of the feed's
shape signature flushes the buffer early, and a chunk of one batch runs
as an eager step. The trajectory is that of K = 1. Chunk-granular
differences, as in the JAX trainer: an LR backoff takes effect on the
next chunk, preemption is checked at chunk boundaries (the buffered
batches not yet run are replayed by the deterministic reader after the
resume), a rollback stops the ladder observing the rest of its chunk,
and no per-step spans are emitted. On the card the params, slots and
layer state are the graphs' static tensors, which each replay updates
in place: a checkpoint copies their bytes before the next replay, and a
resume or a rollback lands in them (`TrainStep.settle`).

Per step a `StepTimeline` (`obs/timeline.py`) splits the wall time into
data wait, host dispatch, device and checkpoint stall, fencing the card
only on every `timeline_sample_period`-th step; sampled steps of the
K = 1 loop emit a `train.step` span tree (`obs/tracing.py`); the
`core/stat.py` timers (`train_step`, `checkpoint_save`,
`watchdog_rollback`, `preempt_flush`) are logged and reset each pass.

`Inferencer(net, params, state)` runs the forward in test mode (layer
state read, never advanced) and returns numpy outputs;
`Inferencer.from_merged(path)` loads a merged model.

The recompile guard (`analysis/recompile_guard.py`; the
`recompile_guard` flag "off", "record" or "strict"): after the first
pass the trainer arms the TrainStep's guard, so a steady-state trace or
CUDA-graph capture is recorded (`recompile_violations()`) or, strict,
raises RecompileError from the step. The eval forward has its own guard
("eval_forward", noted at the first sight of each feed signature).

The mesh (`SGD(..., mesh=..., sharding_rules=...)`, the JAX trainer's
mesh): every rank runs the same loop over the same reader and seed, so
each reads the same global batch and the train step
(`parallel/dp.py`) takes the rank's slice; parameters start whole from
the seed on every rank and are cut to the rank's shards. The
evaluators see the global batch: the kept outputs are all-gathered over
the data axis before they reach them, and `test()` runs the forward on
the whole batch with the whole parameters. Checkpoints: an async pass
is written by every rank (its shard file, the sharded leaves with their
global shape and slice) and its manifest by rank 0; a sync pass holds
whole arrays, gathered, and rank 0 writes it. A resume loads whole
arrays and cuts them to the rank's shards, so a pass saved at one world
size resumes at another. Rank 0 alone logs.

Left out: the JAX trainer's FP trap and PRNG choice are JAX
configuration, with no counterpart here.
"""

from __future__ import annotations

import logging
import time
from typing import Callable, Optional

import numpy as np
import torch

from paddle_tpu_torch.analysis.recompile_guard import RecompileGuard
from paddle_tpu_torch.core import flags as _flags
from paddle_tpu_torch.core import rng as _rng
from paddle_tpu_torch.core.config import ModelConf, OptimizationConf
from paddle_tpu_torch.core.device import resolve_device
from paddle_tpu_torch.core.mesh import DATA_AXIS
from paddle_tpu_torch.core.stat import GLOBAL_STATS
from paddle_tpu_torch.evaluators import create_evaluator
from paddle_tpu_torch.network import Network
from paddle_tpu_torch.obs import metrics as _obs
from paddle_tpu_torch.obs import tracing as _tracing
from paddle_tpu_torch.obs.timeline import StepTimeline
from paddle_tpu_torch.optimizers import create_optimizer
from paddle_tpu_torch.parallel import collectives as C
from paddle_tpu_torch.parallel.dp import (
    TrainStep,
    _arg_map,
    _tree_map,
    feed_signature,
    stack_feeds,
    stack_outs,
)
from paddle_tpu_torch.trainer import async_checkpoint as actp
from paddle_tpu_torch.trainer import checkpoint as ckpt
from paddle_tpu_torch.trainer import watchdog as wdg
from paddle_tpu_torch.trainer.events import (
    BeginIteration,
    BeginPass,
    EndIteration,
    EndPass,
    TestResult,
)
from paddle_tpu_torch.weights import (
    opt_state_from_numpy,
    params_from_numpy,
    state_from_numpy,
)

log = logging.getLogger("paddle_tpu_torch.trainer")


class _RankZero(logging.Filter):
    """On a mesh, only rank 0's trainer logs."""

    def filter(self, record) -> bool:
        import torch.distributed as dist

        return not dist.is_initialized() or dist.get_rank() == 0


log.addFilter(_RankZero())


class _NullPreemptionGuard:
    """Stand-in when there is no save_dir to flush to: SIGTERM keeps
    its process-default meaning."""

    preempted = False

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False


def _host_outs(outs: dict) -> dict:
    """Kept outputs ({name: Arg}) on the host, one copy a tensor; a half
    precision value is read as f32 (exact) for numpy."""
    def fetch(x):
        if x.dtype in (torch.bfloat16, torch.float16):
            x = x.float()
        return x.cpu()

    return {n: _arg_map(fetch, a) for n, a in outs.items()}


def _emit_step_spans(trace_id, trace_parent, tl, pass_id, batch_id,
                     global_step, t_data, t_rs):
    """Span tree for one SAMPLED training step: a `train.step` root over
    `train.data_wait` / `train.host_dispatch` / `train.device_step`
    children, stamped from the perf_counter boundaries the StepTimeline
    just accumulated (converted to wall starts through the current
    perf->wall offset)."""
    now_pc = time.perf_counter()
    now_wall = time.time()

    def wall(t_pc):
        return now_wall - (now_pc - t_pc)

    root = _tracing.new_span_id()
    _tracing.emit_span(
        "train.step", trace_id, root, trace_parent,
        dur_s=now_pc - t_data, ts=wall(t_data),
        labels={"pass_id": pass_id, "batch_id": batch_id,
                "global_step": global_step, "sampled": True},
    )
    _tracing.emit_span(
        "train.data_wait", trace_id, _tracing.new_span_id(), root,
        dur_s=tl.last["data_wait"], ts=wall(t_data),
    )
    _tracing.emit_span(
        "train.host_dispatch", trace_id, _tracing.new_span_id(), root,
        dur_s=tl.last["host_dispatch"], ts=wall(t_rs),
    )
    _tracing.emit_span(
        "train.device_step", trace_id, _tracing.new_span_id(), root,
        dur_s=tl.last["device_step"],
        ts=wall(t_rs + tl.last["host_dispatch"]),
    )


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
        evaluators: Optional[list] = None,
        mesh=None,
        sharding_rules=None,
    ):
        """`params`: {name: tensor} to start from (moved to the
        device), else drawn from `seed`. `watchdog`: None = the
        `watchdog` flag (default on); False disables; True or a
        `WatchdogConfig` enables the on-device non-finite skip and the
        host ladder with the given knobs. `steps_per_dispatch`: None =
        the flag (default 1); K > 1 trains K batches a dispatch.
        `evaluators`: evaluator config dicts (`evaluators.py`). `mesh`
        (`core/mesh.py`): train data-parallel and sharded over it, with
        the `Sharder`'s `sharding_rules`; the device is then the rank's
        unless given."""
        self.mesh = mesh
        if device is None and mesh is not None:
            device = mesh.device
        self.device = resolve_device(device)
        if watchdog is None:
            watchdog = bool(_flags.get_flag("watchdog"))
        if watchdog is True:
            watchdog = wdg.WatchdogConfig()
        self.watchdog_conf = watchdog or None
        if steps_per_dispatch is None:
            steps_per_dispatch = int(
                _flags.get_flag("steps_per_dispatch") or 1)
        if steps_per_dispatch < 1:
            raise ValueError(
                f"steps_per_dispatch must be >= 1, got {steps_per_dispatch}")
        self.steps_per_dispatch = steps_per_dispatch
        self.last_watchdog_report: Optional[wdg.WatchdogReport] = None
        self._resume_skip_batches = 0
        self._async_ckpt = None
        self.net = Network(model_conf)
        self.opt_conf = opt_conf
        self.opt = create_optimizer(opt_conf, self.net.param_confs)
        self.evaluator_confs = evaluators or []
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
                                 keep_outputs=self._eval_layers(),
                                 watchdog=self.watchdog_conf is not None,
                                 device=self.device, mesh=mesh,
                                 sharding_rules=sharding_rules)
        if mesh is not None:
            from paddle_tpu_torch.core.mesh import set_mesh

            # layers that read the mesh (moe's experts) find this one
            set_mesh(mesh)
            self.params, self.opt_state, self.state = self.step_fn.place(
                self.params, self.opt_state, self.state)
        self.global_step = 0
        self._eval_guard = RecompileGuard("eval_forward")

    def _eval_layers(self) -> set:
        return {c[k] for c in self.evaluator_confs
                for k in ("input", "label", "query_id") if k in c}

    # ---- the mesh ----
    def _whole(self, name: str, t):
        """Parameter `name`'s shard `t` (or a slot of its shape) gathered
        whole over every axis its spec splits."""
        from paddle_tpu_torch.parallel.sharding import sharded_dims

        if tuple(t.shape) != self.step_fn.local_shape(name):
            return t
        for dim, axis in sharded_dims(self.step_fn.specs.get(name, ())):
            t = C.all_gather_(self.mesh, axis, t, dim)
        return t

    def whole_params(self) -> dict:
        """The parameters whole (on a mesh: each sharded one all-gathered;
        else `params` itself)."""
        if self.mesh is None:
            return self.params
        return {k: self._whole(k, v) for k, v in self.params.items()}

    def _whole_opt_state(self) -> dict:
        if self.mesh is None:
            return self.opt_state
        return {k: {sl: self._whole(k, t) for sl, t in slots.items()}
                for k, slots in self.opt_state.items()}

    def _global_outs(self, outs: dict, dim: int = 0) -> dict:
        """Kept outputs of the rank's slice all-gathered over the data
        axis: the global batch's, which the evaluators see."""
        if self.mesh is None:
            return outs
        return {n: _arg_map(lambda x: C.all_gather_(self.mesh, DATA_AXIS, x,
                                                    dim), a)
                for n, a in outs.items()}

    def _rank0(self) -> bool:
        return self.mesh is None or self.mesh.rank == 0

    # ---- eval-only forward (no grad) ----
    def _eval_forward(self, feed):
        keep = (set(self.net.output_names) | set(self.net.cost_names)
                | self._eval_layers())
        feed = {k: a.to(self.device) for k, a in feed.items()}
        self._eval_guard.note_once(feed_signature(feed), feed)
        with torch.no_grad():
            # on a mesh every rank runs the whole batch on the whole
            # parameters
            outs, _ = self.net.forward(self.whole_params(), feed,
                                       state=self.state, train=False)
        costs = [outs[n].value for n in self.net.cost_names]
        return {k: v for k, v in outs.items() if k in keep}, costs

    def _make_evaluators(self):
        return [create_evaluator(c) for c in self.evaluator_confs]

    def _log_parameter_stats(self, pass_id: int, batch_id: int) -> None:
        """Per-parameter value statistics every
        `show_parameter_stats_period` batches (the reference's
        TrainerInternal.cpp:80-90 avg/max-abs dump; gradients live
        inside the step, so value statistics are what is observable)."""
        for name in sorted(self.params):
            v = self.params[name].detach()
            log.info(
                "param stats pass %d batch %d %s: shape=%s "
                "avg_abs=%.6f max_abs=%.6f",
                pass_id, batch_id, name, tuple(v.shape),
                float(v.abs().mean()), float(v.abs().max()),
            )

    def train_batch(self, feed) -> float:
        """One train step on an already-fed Arg dict; returns the cost
        (the TrainerInternal::trainOneBatch unit the `--job=time`
        harness times)."""
        cost, _finite, _outs = self.run_step(feed)
        return cost

    def _fence(self) -> None:
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def run_step(self, feed, lr_scale: float = 1.0, timeline=None,
                 chunk: bool = False) -> tuple:
        """One step on an already-fed Arg dict; returns (cost, finite,
        outs). With the watchdog, the step's health vector [loss,
        all_finite] comes back in ONE device->host copy, and a
        non-finite batch's update was already skipped on the device.

        `timeline`: an obs.StepTimeline splitting this step's wall time
        into host dispatch (launching the step) and device (waiting for
        the health fetch; on the timeline's sampled steps also for the
        whole update, `torch.cuda.synchronize`). `chunk`: the step is a
        chunk of one batch of `run_steps` (the recompile guard notes it as
        the JAX trainer's scan of one step)."""
        rng = _rng.split_for_step(self.step_root, self.global_step)
        t0 = time.perf_counter() if timeline is not None else 0.0
        (
            self.params,
            self.opt_state,
            self.state,
            loss,
            outs,
        ) = self.step_fn(
            self.params, self.opt_state, self.state, feed,
            self.global_step, rng, lr_scale=lr_scale, chunk=chunk,
        )
        # between graph replays the result lands in the tensors the
        # graphs read
        self.params, self.opt_state, self.state = self.step_fn.settle(
            self.params, self.opt_state, self.state)
        self.global_step += 1
        outs = self._global_outs(outs)
        t1 = time.perf_counter() if timeline is not None else 0.0
        if self.step_fn.watchdog:
            health = loss.cpu().numpy()  # the single host fetch
            result = float(health[0]), bool(health[1]), outs
        else:
            result = float(loss), True, outs
        if timeline is not None:
            timeline.add_dispatch(t1 - t0)
            if timeline.fence_now(self.global_step):
                self._fence()
            timeline.add_device(time.perf_counter() - t1)
            timeline.step_done()
        return result

    @property
    def graphs_captured(self) -> int:
        """CUDA graphs of K steps captured so far (0 off the card)."""
        return self.step_fn.graphs_captured

    def run_steps(self, feeds: list, lr_scale: float = 1.0,
                  timeline=None) -> tuple:
        """Run len(feeds) consecutive steps in ONE dispatch
        (`TrainStep.multi`); one feed runs as `run_step`. Returns (costs,
        finites, outs): per-batch cost and finiteness lists in step
        order (one device->host fetch carries all of them), and the kept
        outputs stacked [n, ...]. The trajectory is that of n calls of
        run_step. All feeds of one call share one shape signature."""
        n = len(feeds)
        if n == 1:
            cost, finite, outs = self.run_step(feeds[0], lr_scale, timeline,
                                               chunk=True)
            return [cost], [finite], stack_outs([outs])
        t0 = time.perf_counter() if timeline is not None else 0.0
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
        outs = self._global_outs(outs, dim=1)
        t1 = time.perf_counter()
        health = losses.cpu().numpy()  # the single host fetch
        if self.step_fn.watchdog:
            costs = [float(h) for h in health[:, 0]]
            finites = [bool(h) for h in health[:, 1]]
        else:
            costs, finites = [float(h) for h in health], [True] * n
        if timeline is not None:
            timeline.add_dispatch(t1 - t0)
            if timeline.fence_now(self.global_step):
                self._fence()
            timeline.add_device(time.perf_counter() - t1)
            for _ in range(n):
                timeline.step_done()
        return costs, finites, outs

    def train(
        self,
        reader: Callable,
        feeder: Callable,
        num_passes: int = 1,
        event_handler: Optional[Callable] = None,
        test_reader: Optional[Callable] = None,
        save_dir: Optional[str] = None,
        start_pass: int = 0,
        checkpoint_mode: Optional[str] = None,
        skip_batches: Optional[int] = None,
    ):
        """reader yields raw batches; feeder converts one to an Arg
        dict.

        checkpoint_mode: None = the `checkpoint_mode` flag; "sync" = a
        blocking `save_pass` each pass; "async" = overlapped writes
        (trainer/async_checkpoint.py) where only the device->host
        snapshot blocks the loop.

        skip_batches: batches of `start_pass` to skip before training
        resumes (the mid-pass preemption offset). None = the offset the
        last `resume()` recorded from a mid-pass checkpoint (0 after an
        end-of-pass one)."""
        event_handler = event_handler or (lambda e: None)
        log_period = _flags.get_flag("log_period")
        ckpt_mode = checkpoint_mode or _flags.get_flag("checkpoint_mode")
        if ckpt_mode not in ("sync", "async"):
            raise ValueError(f"unknown checkpoint_mode {ckpt_mode!r}")
        if save_dir and ckpt_mode == "async":
            self._ensure_async_ckpt(save_dir)
        if skip_batches is None:
            skip_batches = self._resume_skip_batches
        self._resume_skip_batches = 0
        wd = (wdg.Watchdog(self.watchdog_conf)
              if self.watchdog_conf is not None else None)
        if wd is not None:
            self.last_watchdog_report = wd.report
        # per-step wall-time attribution, fenced every
        # `timeline_sample_period` steps; exposed as `last_timeline`
        tl = StepTimeline(
            sample_period=_flags.get_flag("timeline_sample_period"))
        self.last_timeline = tl
        # one trace per train() call (joining the launching process's
        # when the carrier env var is set); sampled steps each emit a
        # span tree aligned with the timeline's timestamps
        with _tracing.attach_from_env():
            cur = _tracing.current()
        trace_id = cur[0] if cur else _tracing.new_trace_id()
        trace_parent = cur[1] if cur else ""
        self.last_trace_id = trace_id
        # SIGTERM -> flag, checked at batch (chunk) boundaries; only
        # when there is somewhere to flush to
        guard = (wdg.PreemptionGuard() if save_dir
                 else _NullPreemptionGuard())
        stats_period = _flags.get_flag("show_parameter_stats_period")
        ok = False
        try:
            with guard:
                for pass_id in range(start_pass, num_passes):
                    event_handler(BeginPass(pass_id))
                    evals = self._make_evaluators()
                    costs = []
                    batch_iter = iter(reader())
                    if self.steps_per_dispatch > 1:
                        self._run_pass_pipelined(
                            pass_id, start_pass, skip_batches, batch_iter,
                            feeder, event_handler, evals, costs, tl, wd,
                            guard, save_dir, ckpt_mode, log_period,
                        )
                        batch_iter = None  # drained
                    batch_id = -1
                    while batch_iter is not None:
                        t_data = time.perf_counter()
                        try:
                            raw = next(batch_iter)
                        except StopIteration:
                            break
                        batch_id += 1
                        if pass_id == start_pass and batch_id < skip_batches:
                            # trained before the preemption (their work
                            # is in the flushed checkpoint): the reader
                            # replays them, the loop drops them
                            continue
                        dt_reader = time.perf_counter() - t_data
                        event_handler(BeginIteration(pass_id, batch_id))
                        t_feed = time.perf_counter()
                        feed = feeder(raw)
                        tl.add_data_wait(
                            dt_reader + time.perf_counter() - t_feed)
                        t_rs = time.perf_counter()
                        with GLOBAL_STATS.timer("train_step"):
                            cost, finite, outs = self.run_step(
                                feed, wd.lr_scale() if wd else 1.0,
                                timeline=tl)
                        if (tl.sample_period > 0 and self.global_step
                                % tl.sample_period == 0):
                            _emit_step_spans(
                                trace_id, trace_parent, tl, pass_id,
                                batch_id, self.global_step - 1, t_data,
                                t_rs)
                        if finite:
                            costs.append(cost)
                            if evals:
                                host = _host_outs(outs)
                                for ev in evals:
                                    ev.add_batch(host, feed)
                        if wd is not None:
                            self._watchdog_act(wd, cost, finite, save_dir,
                                               ckpt_mode)
                        self._end_iteration(pass_id, batch_id, cost, costs,
                                            evals, event_handler,
                                            log_period, stats_period)
                        if guard.preempted:
                            # the in-flight batch completed and is
                            # counted in batch_id + 1
                            self._preempt_flush(save_dir, ckpt_mode,
                                                pass_id, batch_id + 1)
                            raise wdg.Preempted(pass_id, batch_id + 1,
                                                save_dir)
                    skip_batches = 0
                    results = {ev.name: ev.result() for ev in evals}
                    if test_reader is not None:
                        tr = self.test(test_reader, feeder)
                        event_handler(TestResult(pass_id, tr["cost"],
                                                 tr["evaluators"]))
                    if save_dir:
                        self._save_pass(save_dir, ckpt_mode, pass_id, tl,
                                        trace_id, trace_parent)
                        if wd is not None:
                            # a candidate only: promoted to the rollback
                            # target after `good_batches` healthy batches
                            wd.on_checkpoint(pass_id)
                    # the per-pass timer report, reset so each pass
                    # reports only itself
                    log.info("pass %d %s", pass_id, GLOBAL_STATS.report())
                    GLOBAL_STATS.reset()
                    tl.emit_pass(pass_id, self.global_step)
                    log.info("pass %d timeline %s", pass_id, tl.fractions())
                    event_handler(EndPass(pass_id, results))
                    if pass_id == start_pass:
                        # warmup over: every steady-state shape (the
                        # ragged reader tail included) has been seen
                        # once; a trace or capture from here on is a
                        # stall in the hot loop
                        mode = _flags.get_flag("recompile_guard")
                        if mode and mode != "off":
                            self.step_fn.recompile_guard.arm(
                                strict=(mode == "strict"))
            ok = True
        finally:
            # drain in-flight async writes on every exit path, so a
            # background failure surfaces here; when already unwinding,
            # a drain failure must not mask the training error. Only
            # the success path, which every rank of a mesh takes
            # together, meets the other ranks (wait); a rank unwinding
            # alone drains its own writer, never waiting in a
            # collective the others are not in
            if save_dir and ckpt_mode == "async":
                if ok:
                    self._async_ckpt.wait()
                else:
                    try:
                        self._async_ckpt.drain()
                    except Exception:
                        log.exception(
                            "async checkpoint drain failed while handling "
                            "a training error")

    def _end_iteration(self, pass_id, batch_id, cost, costs, evals,
                       event_handler, log_period, stats_period):
        """EndIteration (the evaluators' results every `log_period`
        batches), the log line and the parameter statistics."""
        logged = (batch_id + 1) % log_period == 0
        results = {ev.name: ev.result() for ev in evals} if logged else {}
        event_handler(EndIteration(pass_id, batch_id, cost, results))
        if logged:
            log.info(
                "pass %d batch %d cost %.5f %s", pass_id, batch_id,
                float(np.mean(costs[-log_period:]))
                if costs else float("nan"),
                results,
            )
        if stats_period and (batch_id + 1) % stats_period == 0:
            self._log_parameter_stats(pass_id, batch_id)

    def _save_pass(self, save_dir, ckpt_mode, pass_id, tl, trace_id,
                   trace_parent):
        t_ck = time.perf_counter()
        with GLOBAL_STATS.timer("checkpoint_save"):
            if ckpt_mode == "async":
                # only the host snapshot inside save() blocks the loop
                self._async_ckpt.save(
                    pass_id, self.params, self.opt_state, self.state,
                    meta={"global_step": self.global_step},
                    shards=self._shards())
            else:
                self._save_sync(save_dir, pass_id,
                                {"global_step": self.global_step},
                                save_only_one=_flags.get_flag(
                                    "save_only_one"))
        dt_ck = time.perf_counter() - t_ck
        tl.add_checkpoint(dt_ck)
        _tracing.emit_span(
            "train.checkpoint", trace_id, _tracing.new_span_id(),
            trace_parent, dur_s=dt_ck,
            labels={"pass_id": pass_id, "mode": ckpt_mode})

    def _run_pass_pipelined(self, pass_id, start_pass, skip_batches,
                            batch_iter, feeder, event_handler, evals,
                            costs, tl, wd, guard, save_dir, ckpt_mode,
                            log_period):
        """One pass with steps_per_dispatch > 1: batches are buffered
        and run as chunks of `run_steps`. BeginIteration fires when a
        batch is collected (before its step runs); EndIteration, the
        evaluators and the watchdog see every batch in order after its
        chunk lands. A change of the feed's shape signature flushes the
        buffer early."""
        spd = self.steps_per_dispatch
        buf = []  # (batch_id, feed)
        sig = None
        done_upto = skip_batches  # batches of this pass fully trained
        stats_period = _flags.get_flag("show_parameter_stats_period")

        def check_preempt():
            if guard.preempted:
                # buffered batches never ran: dropped here, replayed by
                # the deterministic reader after the resume, so every
                # batch still trains exactly once
                self._preempt_flush(save_dir, ckpt_mode, pass_id, done_upto)
                raise wdg.Preempted(pass_id, done_upto, save_dir)

        def flush():
            nonlocal buf, sig, done_upto
            if not buf:
                return
            with GLOBAL_STATS.timer("train_step"):
                cs, fs, outs = self.run_steps(
                    [f for _, f in buf], wd.lr_scale() if wd else 1.0, tl)
            # the chunk's kept outputs in one host fetch
            host = _host_outs(outs) if evals else None
            observe = True
            for j, (bid, feed) in enumerate(buf):
                cost, finite = cs[j], fs[j]
                if finite:
                    costs.append(cost)
                    if evals:
                        row = {n: _arg_map(lambda x: x[j], a)
                               for n, a in host.items()}
                        for ev in evals:
                            ev.add_batch(row, feed)
                if wd is not None and observe:
                    action = self._watchdog_act(wd, cost, finite, save_dir,
                                                ckpt_mode)
                    if action == wdg.ROLLBACK:
                        # the chunk's remaining batches trained on the
                        # rolled-back trajectory: their costs are
                        # discarded progress, not fed to the ladder
                        observe = False
                self._end_iteration(pass_id, bid, cost, costs, evals,
                                    event_handler, log_period,
                                    stats_period)
            done_upto = buf[-1][0] + 1
            buf, sig = [], None

        batch_id = -1
        while True:
            check_preempt()
            t_data = time.perf_counter()
            try:
                raw = next(batch_iter)
            except StopIteration:
                break
            batch_id += 1
            if pass_id == start_pass and batch_id < skip_batches:
                continue
            dt_reader = time.perf_counter() - t_data
            event_handler(BeginIteration(pass_id, batch_id))
            t_feed = time.perf_counter()
            feed = feeder(raw)
            tl.add_data_wait(dt_reader + time.perf_counter() - t_feed)
            fsig = feed_signature(feed)
            if buf and fsig != sig:
                flush()
            buf.append((batch_id, feed))
            sig = fsig
            if len(buf) >= spd:
                flush()
        flush()
        check_preempt()

    def _watchdog_act(self, wd, cost, finite, save_dir, ckpt_mode):
        """Run the ladder on one batch's (cost, finite) verdict; perform
        the rollback here (the trainer owns params and resume); returns
        the ladder's action."""
        action = wd.observe(cost, finite, self.global_step - 1)
        if action == wdg.ROLLBACK:
            target = wd.good_pass
            with GLOBAL_STATS.timer("watchdog_rollback"):
                if ckpt_mode == "async" and self._async_ckpt is not None:
                    # commit in-flight writes (and surface write errors)
                    # before reading manifests back
                    self._async_ckpt.wait()
                try:
                    self.resume(save_dir, pass_id=target)
                except (FileNotFoundError, ValueError, OSError) as e:
                    # the promoted pass can be rotated away (save_only_one
                    # / keep_last) before a rollback needs it: out of
                    # rungs, abort with the report
                    wd.report.aborted = True
                    wd.report.abort_reason = (
                        f"rollback target pass {target} unloadable "
                        f"({type(e).__name__}: {e}) — rotated away?")
                    wd.record_event("abort", self.global_step,
                                    reason=wd.report.abort_reason)
                    log.error("watchdog abort: %s", wd.report.abort_reason)
                    raise wdg.WatchdogAbort(wd.report) from e
            log.warning("watchdog: rolled back to checkpoint pass %d "
                        "(global_step %d)", target, self.global_step)
            wd.on_rollback(target, self.global_step)
        elif action == wdg.ABORT:
            log.error("watchdog abort: %s", wd.report.abort_reason)
            raise wdg.WatchdogAbort(wd.report)
        return action

    def _preempt_flush(self, save_dir, ckpt_mode, pass_id, batches_done):
        """SIGTERM landed: flush a mid-pass checkpoint covering every
        COMPLETED batch, so the respawned process resumes at
        `batches_done` with zero lost work."""
        meta = {"global_step": self.global_step, "mid_pass": True,
                "batch_in_pass": batches_done}
        with GLOBAL_STATS.timer("preempt_flush"):
            if ckpt_mode == "async":
                self._ensure_async_ckpt(save_dir)
                self._async_ckpt.save(pass_id, self.params, self.opt_state,
                                      self.state, meta=meta,
                                      shards=self._shards())
                # each rank sees the signal at its own batch boundary:
                # no meeting of the ranks here (drain, not wait)
                self._async_ckpt.drain()
            else:
                self._save_sync(save_dir, pass_id, meta)
        _obs.get_registry().counter("trainer.preemptions").inc()
        _obs.get_registry().event(
            "preempt_flush", global_step=self.global_step, pass_id=pass_id,
            batch_in_pass=batches_done)
        log.warning("preempted: flushed pass %d at batch %d to %s; exiting "
                    "for resume", pass_id, batches_done, save_dir)

    def _shards(self):
        """The sharded leaves of this rank's checkpoint tree."""
        if self.mesh is None:
            return None
        return self.step_fn.shard_layout(self.opt_state)

    def _save_sync(self, save_dir, pass_id, meta, **kw) -> None:
        """A sync pass of whole arrays (on a mesh gathered, and written
        by rank 0)."""
        params, opt_state = self.whole_params(), self._whole_opt_state()
        if self._rank0():
            ckpt.save_pass(save_dir, pass_id, params, opt_state, self.state,
                           meta=meta, **kw)
        if self.mesh is not None and self.mesh.distributed:
            import torch.distributed as dist

            dist.barrier()

    def recompile_violations(self) -> list:
        """Steady-state traces and captures recorded by the train step's
        armed recompile guard (the `recompile_guard` flag): empty means
        the hot loop never traced or captured again after warmup."""
        return list(self.step_fn.recompile_guard.violations)

    def test(self, reader: Callable, feeder: Callable) -> dict:
        """Evaluation pass (reference: trainer/Tester.h): the forward in
        test mode over `reader`; returns {"cost": mean batch cost,
        "evaluators": {name: result}}."""
        evals = self._make_evaluators()
        costs = []
        for raw in reader():
            feed = feeder(raw)
            outs, batch_costs = self._eval_forward(feed)
            costs.append(float(np.mean(
                [np.mean(c.float().cpu().numpy()) for c in batch_costs])))
            if evals:
                host = _host_outs(outs)
                for ev in evals:
                    ev.add_batch(host, feed)
        return {
            "cost": float(np.mean(costs)) if costs else float("nan"),
            "evaluators": {ev.name: ev.result() for ev in evals},
        }

    def _ensure_async_ckpt(self, save_dir: str):
        cur = self._async_ckpt
        if cur is not None and cur.save_dir == save_dir:
            return cur
        if cur is not None:
            cur.close()
        self._async_ckpt = actp.AsyncCheckpointer(
            save_dir, keep_last=1 if _flags.get_flag("save_only_one") else 0)
        return self._async_ckpt

    def resume(self, save_dir: str, pass_id: int = -1) -> int:
        """Load a checkpoint; returns the next pass id (start_pass
        semantics of trainer/ParamUtil.h). Reads whichever format is
        newest and COMPLETE: async passes (manifest-verified, torn
        shards skipped) or sync pass directories. The loaded values land
        on the device; once the train step has CUDA graphs they land in
        the graphs' static tensors (`TrainStep.settle`).

        A MID-PASS checkpoint (the preemption flush) returns its own
        pass id (the pass is unfinished) and records the number of
        batches already trained; the next `train()` skips exactly that
        many batches of its first pass."""
        self._resume_skip_batches = 0
        if pass_id >= 0:
            use_async = (pass_id in actp.list_passes(save_dir)
                         and actp.verify_pass(save_dir, pass_id)[0])
        else:
            async_latest = actp.latest_complete_pass(save_dir)
            sync_passes = ckpt.list_sync_passes(save_dir)
            use_async = async_latest >= 0 and (
                not sync_passes or async_latest >= sync_passes[-1])
        if use_async:
            # the already-resolved id: load_pass(-1) would hash every
            # pass a second time to find the latest
            tree, meta = actp.load_pass(
                save_dir, pass_id if pass_id >= 0 else async_latest)
            params = tree["params"]
            opt_state = tree.get("opt_state")
            state = tree.get("state")
        else:
            params, opt_state, state, meta = ckpt.load_pass(save_dir,
                                                            pass_id)
        params = params_from_numpy(params, self.device)
        opt_state = (opt_state_from_numpy(opt_state, self.device)
                     if opt_state is not None else self._whole_opt_state())
        state = (state_from_numpy(state, self.device) if state is not None
                 else self.state)
        if self.mesh is not None:
            # whole arrays cut to this rank's shards, at any world size
            params, opt_state, state = self.step_fn.place(params, opt_state,
                                                          state)
        self.params, self.opt_state, self.state = self.step_fn.settle(
            params, opt_state, state)
        self.global_step = meta.get("global_step", 0)
        if meta.get("mid_pass"):
            self._resume_skip_batches = int(meta.get("batch_in_pass", 0))
            return meta["pass_id"]
        return meta["pass_id"] + 1


class Inferencer:
    """Inference runner: `paddle_tpu/trainer/trainer.py::Inferencer` on
    one device. `params` and `state` ({name: tensor or array}, {layer:
    {slot: ...}}) are moved to the device; `state` defaults to the
    network's initial state. `infer(feed)` runs the forward with
    train=False under no_grad, pruned to `outputs` (default the
    network's), and returns {name: numpy array}."""

    def __init__(self, net: Network, params: dict, state=None, outputs=None,
                 device=None):
        self.device = resolve_device(device)
        self.net = net

        def on_device(x):
            if not torch.is_tensor(x):
                x = torch.from_numpy(np.array(x, copy=True))
            return x.detach().to(self.device)

        self.params = {k: on_device(v) for k, v in params.items()}
        self.state = (_tree_map(on_device, state) if state
                      else net.init_state(self.device))
        self.output_names = list(outputs or net.output_names)

    @classmethod
    def from_merged(cls, path: str, outputs=None, device=None):
        """An Inferencer of a merged model file (`checkpoint.merge_model`,
        by either package)."""
        conf, params, state = ckpt.load_merged(path)
        return cls(Network(conf), params, state, outputs, device=device)

    def infer(self, feed: dict) -> dict:
        """{name: numpy array}; a bf16 output (the bf16 flag) comes back
        as f32, its values exact (numpy has no bf16)."""
        feed = {k: a.to(self.device) for k, a in feed.items()}
        with torch.no_grad():
            outs, _ = self.net.forward(self.params, feed, state=self.state,
                                       train=False,
                                       outputs=self.output_names)

        def host(x):
            return (x.float() if x.dtype == torch.bfloat16 else x).cpu() \
                .numpy()

        return {n: host(outs[n].value if outs[n].value is not None
                        else outs[n].ids)
                for n in self.output_names}
