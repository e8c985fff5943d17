"""CUDA graphs of K train steps: how `TrainStep.multi` runs on the card.

The counterpart of the JAX step's `lax.scan` of K steps inside one jit
(`paddle_tpu/parallel/dp.py::TrainStep.multi`). One `StepGraphs` per
`TrainStep`:

- Static trees. Params, optimizer slots and layer state live in device
  tensors the runner owns, allocated outside every graph's pool. A
  graph reads them at its start and `copy_`s the K-th step's values
  back into them at its end. `adopt` copies values from elsewhere (an
  eager step's result) into them.
- One graph per (K, feed signature), as JAX compiles one program per
  stacked shape, all in one memory pool. Each graph has static inputs:
  the stacked feed [K, ...], the steps' scalars [K, S] and their keys'
  seeds [K], filled from pinned host memory before each replay.
- Capture: one warm-up step on a side stream (its results dropped: it
  leaves the static trees as they were), then `torch.cuda.graph` on the
  same stream, with the cyclic garbage collector run first and kept
  off during the capture (`no_gc`): a graph that an unreachable owner
  still held, freed by the collector mid-capture, would end the
  capture in error. A capture that fails raises; nothing falls back to
  eager steps.
- Outputs: the losses (or health rows) and the kept outputs are cloned
  out of the pool after each replay, before the next can overwrite
  them.

The kernels' Python launch counters count the warm-up step and the
capture, not the replays: which kernels a replay runs shows in the
profiler's kernel names.

Every capture is noted with the step's recompile guard
(`TrainStep.note`): armed after warmup, a capture in steady
state is a violation, and a strict guard raises before it begins.
"""

from __future__ import annotations

import contextlib
import gc

import torch

from paddle_tpu_torch.core import rng as _rng
from paddle_tpu_torch.parallel.dp import (
    ARG_FIELDS,
    _arg_map,
    _tree_map,
    feed_at,
    feed_signature,
    stack_outs,
)


def _same_layout(a, b) -> bool:
    """Whether two nested dicts of tensors have the same keys, and
    tensors of the same shape and dtype."""
    if isinstance(a, dict) != isinstance(b, dict):
        return False
    if isinstance(a, dict):
        return a.keys() == b.keys() and all(_same_layout(a[k], b[k])
                                            for k in a)
    return a.shape == b.shape and a.dtype == b.dtype


@contextlib.contextmanager
def no_gc():
    """Collect garbage now, then keep the cyclic collector off for the
    body (a CUDA graph capture): PyTorch no longer collects when a
    capture begins, and a collection inside the capture that frees
    another CUDA graph (an unreachable trainer's or decoder's) is an
    operation a capturing stream does not permit."""
    gc.collect()
    was_on = gc.isenabled()
    gc.disable()
    try:
        yield
    finally:
        if was_on:
            gc.enable()


def _fill(dst: torch.Tensor, src: torch.Tensor) -> None:
    """dst <- src without a host sync: a host tensor goes through pinned
    memory."""
    if (dst.device.type == "cuda" and src.device.type == "cpu"
            and not src.is_pinned()):
        src = src.pin_memory()
    dst.copy_(src, non_blocking=True)


class _Graph:
    """One captured chunk of K steps for one feed signature."""

    def __init__(self, owner: "StepGraphs", feeds: dict, scalars, seeds):
        self.owner = owner
        dev = owner.step.device
        self.feeds = {n: _arg_map(lambda x: torch.empty(x.shape, dtype=x.dtype,
                                                        device=dev), a)
                      for n, a in feeds.items()}
        self.scalars = torch.empty(scalars.shape, dtype=scalars.dtype,
                                   device=dev)
        self.seeds = torch.empty(seeds.shape, dtype=torch.int64, device=dev)
        self.k = scalars.shape[0]
        self.graph = torch.cuda.CUDAGraph()
        self.losses = self.outs = None

    def fill(self, feeds, scalars, seeds) -> None:
        for n, a in feeds.items():
            for f in ARG_FIELDS:
                src = getattr(a, f)
                if src is not None:
                    _fill(getattr(self.feeds[n], f), src)
        _fill(self.scalars, scalars)
        _fill(self.seeds, seeds)

    def _steps(self, n: int, write_back: bool):
        """The first n steps on the static inputs; with write_back, the
        last step's values are copied into the static trees."""
        o = self.owner
        params, opt_state, state = o.params, o.opt_state, o.state
        losses, outs = [], []
        for k in range(n):
            params, opt_state, state, loss, out = o.step.body(
                params, opt_state, state, feed_at(self.feeds, k),
                self.scalars[k], _rng.StepKey(self.seeds[k]))
            losses.append(loss)
            outs.append(out)
        if write_back:
            if not _same_layout(state, o.state):
                raise RuntimeError(
                    "a step's layer state does not have the layout of the "
                    "state it started from; it cannot be written back in "
                    "place")
            with torch.no_grad():
                _tree_map(torch.Tensor.copy_, o.params, params)
                _tree_map(torch.Tensor.copy_, o.opt_state, opt_state)
                _tree_map(torch.Tensor.copy_, o.state, state)
        return torch.stack(losses), stack_outs(outs)

    def capture(self) -> None:
        o = self.owner
        side = o.stream
        side.wait_stream(torch.cuda.current_stream())
        with torch.cuda.stream(side):
            # warm-up: lazy initialisation (library handles, kernel
            # attributes, occupancy plans) happens outside the capture
            self._steps(1, write_back=False)
        torch.cuda.current_stream().wait_stream(side)
        try:
            with no_gc(), torch.cuda.graph(self.graph, pool=o.pool,
                                           stream=side):
                self.losses, self.outs = self._steps(self.k, write_back=True)
        except Exception as e:
            raise RuntimeError(
                f"capturing {self.k} train steps in a CUDA graph failed: "
                f"{type(e).__name__}: {e}") from e

    def replay(self) -> tuple:
        self.graph.replay()
        outs = {n: _arg_map(torch.clone, a) for n, a in self.outs.items()}
        return self.losses.clone(), outs


class StepGraphs:
    """The CUDA graphs of one `TrainStep` and the static trees they
    update in place."""

    def __init__(self, step):
        self.step = step
        self.pool = torch.cuda.graph_pool_handle()
        self.stream = torch.cuda.Stream(device=step.device)
        self.graphs: dict = {}
        self.params = self.opt_state = self.state = None

    def adopt(self, params, opt_state, state) -> tuple:
        """Make the static trees hold these values (first call: copies
        of them) and return the static trees."""
        if self.params is None:
            def own(x):
                return x.detach().clone()

            self.params = _tree_map(own, params)
            self.opt_state = _tree_map(own, opt_state)
            self.state = _tree_map(own, state)
        else:
            def put(dst, src):
                if src is not dst:
                    dst.copy_(src)
                return dst

            with torch.no_grad():
                _tree_map(put, self.params, params)
                _tree_map(put, self.opt_state, opt_state)
                _tree_map(put, self.state, state)
        return self.params, self.opt_state, self.state

    def run(self, params, opt_state, state, feeds, scalars, seeds) -> tuple:
        """K steps from (params, opt_state, state) on the stacked feed:
        returns the static trees, now holding the K-th step's values,
        the losses [K] (or health [K, 2]) and the kept outputs [K, ...]."""
        self.adopt(params, opt_state, state)
        key = (scalars.shape[0], feed_signature(feeds))
        g = self.graphs.get(key)
        if g is None:
            # a capture is a trace of the JAX step's scan: the guard
            # notes it, and a strict armed guard raises before it begins
            self.step.note(("multi",) + key, params, feeds,
                           body=feed_at(feeds, 0), capture=True)
            g = _Graph(self, feeds, scalars, seeds)
            g.fill(feeds, scalars, seeds)
            g.capture()
            self.graphs[key] = g
        else:
            g.fill(feeds, scalars, seeds)
        losses, outs = g.replay()
        return self.params, self.opt_state, self.state, losses, outs

    def release(self) -> None:
        """Drop every graph and the static trees (their memory returns
        to the caching allocator)."""
        self.graphs.clear()
        self.params = self.opt_state = self.state = None

