"""The train step: `paddle_tpu/parallel/dp.py::TrainStep` on one device.

One call runs the forward, the backward (`torch.autograd.grad` over
`Network.loss_fn`) and the optimizer update. With `watchdog=True` it
also reduces the loss and every gradient to one on-device all-finite
flag and SKIPS the whole update when any value is non-finite: params,
optimizer state and layer state keep their previous values, chosen on
the device with `torch.where`, so the happy path adds no host sync.
The step then returns the 2-float health vector `[loss, all_finite]`
in place of the scalar loss, and the caller's one fetch of it carries
both.

`multi` runs K consecutive steps in one dispatch, the counterpart of
the JAX step's `lax.scan`: on the CPU one eager step after another, on
the card the replay of a CUDA graph of the K steps
(`parallel/graph.py`). Each step's scalars (the scheduled LR, the L1
shrink, the bias corrections: `Optimizer.step_scalars`) and its random
key (`core/rng.py::StepKey`) are device tensors made from the global
step on the host, so K steps of `multi` walk the trajectory of K calls
of the step.

The recompile guard (`analysis/recompile_guard.py`, label
"train_step"): the step notes the first sight of each (feed signature,
parameter names) of a single step and of each (K, feed signature) of
`multi` (two notes: the JAX scan traces its step body too), where the
JAX step traces; on the card `multi`'s notes are the CUDA-graph capture
itself (`parallel/graph.py`). The trainer arms it after warmup.

The mesh (`TrainStep(mesh=..., sharding_rules=...)`, the JAX step's
GSPMD program on torch.distributed ranks):

- The feed is the global batch; each rank takes its slice on the
  `data` axis (`shard_feed`), which must divide it: the ranks' cost
  means average to the global mean only over equal slices.
- Parameters the `Sharder` (`parallel/sharding.py`) splits are stored
  as the rank's shard only, with their optimizer slots (`place`): the
  counterpart of the pserver's block shards and of ZeRO. The body
  all-gathers each at use (but MoE experts: the layer runs its shard,
  expert-parallel, `ops/moe.py`); over `data` the gather's backward
  reduce-scatters the gradient, over another axis (whose ranks compute
  the same values) it takes the rank's slice.
- Replicated parameters' gradients are averaged over `data` in one
  all-reduce per dtype; the loss the step returns is the global mean.
- The network runs inside `core/mesh.py::batch_context`: BN takes its
  statistics over the global batch and dropout draws the global mask
  and keeps its rows (`layers/norm.py`, `layers/base.py`).
- The watchdog's all-finite flag is the minimum over every rank, so the
  ranks skip or apply an update together.
- After each step a sharded parameter that is no longer its shard's
  shape raises (`check_shards`).
- `multi` runs K steps eagerly under gloo (a gloo collective is a host
  call, which a CUDA graph cannot capture) and as a CUDA graph with its
  NCCL collectives captured under NCCL.

This computes the JAX step's function; the compute split that a
Megatron layout gives sharded weights is speed work (ROADMAP B).
Left out: AOT compilation.
"""

from __future__ import annotations

import torch

from paddle_tpu_torch.analysis.recompile_guard import RecompileGuard
from paddle_tpu_torch.core import rng as _rng
from paddle_tpu_torch.core.arg import Arg
from paddle_tpu_torch.core.device import resolve_device
from paddle_tpu_torch.core.mesh import DATA_AXIS, MODEL_AXIS, batch_context
from paddle_tpu_torch.parallel import collectives as C

ARG_FIELDS = ("value", "ids", "seq_lens", "subseq_lens")


def _tree_map(fn, tree, *others):
    """fn over the tensor leaves of nested dicts (others: the same
    nesting)."""
    if isinstance(tree, dict):
        return {k: _tree_map(fn, v, *(o[k] for o in others))
                for k, v in tree.items()}
    return fn(tree, *others)


def _arg_map(fn, *args) -> Arg:
    """The Arg whose each present field is fn over that field of
    `args`."""
    return Arg(**{f: fn(*(getattr(a, f) for a in args))
                  for f in ARG_FIELDS if getattr(args[0], f) is not None})


def loss_and_grads(net, params, feed, state, rng, gather=None):
    """(loss, grads, outs, new_state) of `net.loss_fn` in train mode:
    the gradient half of `TrainStep.body`, and of the v1 API's
    `GradientMachine`. A parameter the loss does not reach has
    gradient 0, as jax.grad gives it. `gather(name, leaf)`, where
    given, maps a parameter's local shard to the tensor the loss reads
    (a mesh's tensor-sharded parameters); the gradients are the
    shards'. Loss, outputs and layer state come back detached."""
    names = list(params)
    leaves = {k: params[k].detach().requires_grad_(True) for k in names}
    with torch.enable_grad():
        full = leaves if gather is None else {
            k: gather(k, v) for k, v in leaves.items()}
        loss, (outs, new_state) = net.loss_fn(
            full, feed, state=state, train=True, rng=rng)
        got = torch.autograd.grad(loss, [leaves[k] for k in names],
                                  allow_unused=True)
    grads = {k: torch.zeros_like(params[k]) if g is None else g
             for k, g in zip(names, got)}
    # layer state is never differentiated (the JAX step carries it as
    # aux): a running mean kept attached would chain autograd nodes
    # from step to step
    new_state = _tree_map(torch.Tensor.detach, new_state)
    outs = {n: _arg_map(torch.Tensor.detach, a) for n, a in outs.items()}
    return loss.detach(), grads, outs, new_state


def stack_feeds(feeds: list) -> dict:
    """K feeds ({name: Arg}, one shape signature) as one feed whose
    every tensor is stacked [K, ...] on a new leading axis."""
    return {name: _arg_map(lambda *xs: torch.stack(xs),
                           *(f[name] for f in feeds))
            for name in feeds[0]}


def feed_at(feeds: dict, k: int) -> dict:
    """Step k's feed of a stacked feed (views)."""
    return {name: _arg_map(lambda x: x[k], a) for name, a in feeds.items()}


def feed_signature(feed: dict) -> tuple:
    """What a graph of the step is captured for: the feed's names, and
    each tensor's field, shape and dtype."""
    return tuple(sorted(
        (name, tuple((f, tuple(getattr(a, f).shape), getattr(a, f).dtype)
                     for f in ARG_FIELDS if getattr(a, f) is not None))
        for name, a in feed.items()))


def shard_feed(feed: dict, mesh, dim: int = 0) -> dict:
    """This rank's slice on the `data` axis of a global feed's batch
    dimension `dim` (1 for a stacked feed [K, B, ...]). A batch that
    does not divide over the axis raises, as the JAX sharding does."""
    n = mesh.axis_size(DATA_AXIS)
    i = mesh.axis_index(DATA_AXIS)

    def take(x):
        if x.shape[dim] % n:
            raise ValueError(
                f"the global batch ({x.shape[dim]} rows) does not divide "
                f"over the {n} ranks of the data axis")
        return x.chunk(n, dim)[i]

    return {name: _arg_map(take, a) for name, a in feed.items()}


def stack_outs(outs: list) -> dict:
    """K steps' kept outputs ({name: Arg}) stacked [K, ...]."""
    return {name: _arg_map(lambda *xs: torch.stack(xs),
                           *(o[name] for o in outs))
            for name in outs[0]}


class TrainStep:
    """Forward + grad + optimizer update, on the device of `device`.
    Call with (params, opt_state, state, feed, step_i, rng, lr_scale);
    returns (new_params, new_opt_state, new_state, loss or health,
    kept outputs). `rng` is the step's `StepKey` (None for a net that
    draws nothing). The feed's tensors are moved to the device."""

    def __init__(self, net, opt, keep_outputs=None, watchdog=False,
                 device=None, mesh=None, sharding_rules=None):
        self.net = net
        self.opt = opt
        self.mesh = mesh
        self.specs = {}
        if mesh is not None:
            from paddle_tpu_torch.parallel.sharding import Sharder

            self.specs = Sharder(mesh, sharding_rules).param_specs(
                net.param_confs)
            if device is None and mesh.device is not None:
                device = mesh.device
        self.device = resolve_device(device)
        self.watchdog = watchdog
        # only declared outputs leave the step: returning every layer's
        # activations would keep all intermediates alive
        self.keep = set(keep_outputs or []) | set(net.output_names) | set(
            net.cost_names
        )
        # parallel/graph.py::StepGraphs, made by the first multi on the
        # card
        self.graphs = None
        # steady-state traces and captures; the trainer arms it after
        # warmup
        self.recompile_guard = RecompileGuard("train_step")

    @property
    def graphs_captured(self) -> int:
        """How many CUDA graphs `multi` has captured (one per chunk
        length and feed signature)."""
        return 0 if self.graphs is None else len(self.graphs.graphs)

    def note(self, key, params, feed, body=None, capture: bool = False):
        """Note `key` with the guard where the JAX step traces: the first
        time it is seen or, on the card, at every CUDA-graph capture of
        a chunk. A chunk is noted with the feed of its step `body` a
        second time, as the JAX scan traces the step body inside it. A
        strict armed guard raises before the key is kept, so the next
        call raises again."""
        guard = self.recompile_guard
        if guard.note_once(key, params, feed, force=capture) and \
                body is not None:
            guard.note(params, body)

    def step_tables(self, step_i: int, n: int, root_seed: int, lr_scale,
                    like) -> tuple:
        """Host tensors of steps step_i .. step_i + n - 1: their scalars
        [n, len(opt.scalar_keys)] in `like`'s dtype and their keys'
        seeds [n] int64."""
        scalars = torch.tensor(
            [self.opt.step_scalars(step_i + k, lr_scale) for k in range(n)],
            dtype=like.dtype)
        seeds = torch.tensor(
            [_rng.step_seed(root_seed, step_i + k) for k in range(n)],
            dtype=torch.int64)
        return scalars, seeds

    def body(self, params, opt_state, state, feed, scalars, rng):
        """One step on a feed already on the device, with the step's
        scalars (a device tensor) and key."""
        mesh = self.mesh
        with batch_context(mesh):
            loss, grads, outs, new_state = loss_and_grads(
                self.net, params, feed, state, rng,
                gather=None if mesh is None else self.gather_param)
        if mesh is not None:
            grads, loss = self.average(grads, loss)
        new_params, new_opt_state = self.opt.update(
            grads, params, opt_state, None, scalars=scalars)
        outs = {k: v for k, v in outs.items() if k in self.keep}
        if not self.watchdog:
            return new_params, new_opt_state, new_state, loss, outs
        with torch.no_grad():
            finite = torch.isfinite(loss)
            for g in grads.values():
                finite = finite & torch.isfinite(g).all()
            if mesh is not None:
                # one verdict for every rank: a rank that skipped while
                # the others applied would leave the replicas apart
                finite = C.all_min(mesh, finite.to(torch.int32)).bool()

            def keep(new, old):
                return torch.where(finite, new, old)

            new_params = {k: keep(new_params[k], params[k]) for k in params}
            new_opt_state = {
                k: {slot: keep(t, opt_state[k][slot])
                    for slot, t in new_opt_state[k].items()}
                for k in params
            }
            # a layer's state is a dict of slots ({"mean", "var"}): keep
            # each slot, as the JAX step's tree_map does
            new_state = {k: _tree_map(keep, new_state[k], state[k])
                         if k in state else new_state[k] for k in new_state}
            health = torch.stack([loss.float(), finite.float()])
        return new_params, new_opt_state, new_state, health, outs

    def __call__(self, params, opt_state, state, feed, step_i, rng,
                 lr_scale=None, chunk: bool = False):
        """One step. `chunk`: the step is a chunk of one batch (the
        trainer's tail of a pass with K > 1), noted as the JAX trainer's
        scan of one step is."""
        feed = {k: a.to(self.device) for k, a in feed.items()}
        if self.mesh is not None:
            feed = shard_feed(feed, self.mesh)
        sig = feed_signature(feed)
        if chunk:
            self.note(("multi", 1, sig), params, feed, body=feed)
        else:
            self.note(("step", sig, tuple(params)), params, feed)
        scalars = self.opt.scalars_tensor(step_i, lr_scale,
                                          next(iter(params.values())))
        out = self.body(params, opt_state, state, feed, scalars, rng)
        self.check_shards(out[0])
        return out

    def multi(self, params, opt_state, state, feeds, step_i, step_root,
              lr_scale=None):
        """Run K = leading-dim(feeds) consecutive steps in ONE dispatch.
        `feeds` is the per-step feed stacked on a new leading axis
        (`stack_feeds`); `step_root` is the trainer's step root (a
        torch.Generator, or its seed): step k's key is derived from
        (root, step_i + k) as `SGD.run_step` derives it, so the
        trajectory is that of K sequential calls. Returns (params,
        opt_state, state, losses, outs) with losses [K] (or [K, 2]
        health vectors with the watchdog) and the kept outputs stacked
        [K, ...].

        On the CPU the steps run eagerly. On the card they run as the
        replay of a CUDA graph, captured on the first call for each K
        and feed signature; a capture that fails raises. On the card the
        step writes the new values into the tensors it owns and returns
        those (as the JAX step donates its inputs): pass them back in,
        or a call first copies the given values into them."""
        k_steps = next(iter(feeds.values()))
        k_steps = next(getattr(k_steps, f) for f in ARG_FIELDS
                       if getattr(k_steps, f) is not None).shape[0]
        root_seed = (step_root.initial_seed()
                     if isinstance(step_root, torch.Generator)
                     else int(step_root))
        like = next(iter(params.values()))
        scalars, seeds = self.step_tables(step_i, k_steps, root_seed,
                                          lr_scale, like)
        if self.mesh is not None:
            feeds = shard_feed(feeds, self.mesh, dim=1)
        if self.device.type == "cuda" and (
                self.mesh is None or self.mesh.backend == "nccl"):
            if self.graphs is None:
                from paddle_tpu_torch.parallel.graph import StepGraphs

                self.graphs = StepGraphs(self)
            return self.graphs.run(params, opt_state, state, feeds, scalars,
                                   seeds)
        feeds = {k: a.to(self.device) for k, a in feeds.items()}
        self.note(("multi", k_steps, feed_signature(feeds)), params, feeds,
                  body=feed_at(feeds, 0))
        losses, outs = [], []
        for k in range(k_steps):
            params, opt_state, state, loss, out = self.body(
                params, opt_state, state, feed_at(feeds, k),
                scalars[k].to(like.device),
                _rng.StepKey(seeds[k].to(like.device)))
            losses.append(loss)
            outs.append(out)
        self.check_shards(params)
        return params, opt_state, state, torch.stack(losses), stack_outs(outs)

    # ---- the mesh ------------------------------------------------------

    def local_shape(self, name: str) -> tuple:
        """The shape of this rank's shard of parameter `name`."""
        from paddle_tpu_torch.parallel.sharding import shard_slices

        dims = tuple(self.net.param_confs[name].dims)
        return tuple(sl.stop - sl.start for sl in shard_slices(
            self.specs.get(name, ()), dims, self.mesh))

    def place(self, params, opt_state=None, state=None) -> tuple:
        """Full parameters, optimizer state and layer state (tensors or
        numpy) as this rank's: each sharded parameter and its slots cut
        to the rank's shard (`weights.place_on_mesh`), on the step's
        device. Without a mesh, the values on the device."""
        from paddle_tpu_torch import weights

        specs = self.specs if self.mesh is not None else {}
        p = weights.place_on_mesh(params, self.mesh, specs, self.device)
        o = None if opt_state is None else {
            k: weights.place_on_mesh(slots, self.mesh,
                                     {s: specs.get(k, ()) for s in slots},
                                     self.device)
            for k, slots in opt_state.items()}
        s = None if state is None else _tree_map(
            lambda x: torch.as_tensor(x).to(self.device), state)
        return p, o, s

    def gather_param(self, name: str, shard: torch.Tensor) -> torch.Tensor:
        """The whole parameter from this rank's shard: an all-gather over
        each axis its spec splits. Over `data` (ranks with different
        data) the backward reduce-scatters; over another axis it takes
        the rank's slice of a gradient every rank of it computed."""
        from paddle_tpu_torch.parallel.sharding import sharded_dims

        dims = sharded_dims(self.specs.get(name, ()))
        if getattr(self.net.param_confs[name], "expert_sharded", False) \
                and dims == [(0, MODEL_AXIS)]:
            # the MoE layer runs its shard of the experts (ops/moe.py)
            return shard
        x = shard
        for dim, axis in dims:
            if axis == DATA_AXIS:
                x = C.all_gather(x, self.mesh, axis, dim)
            else:
                x = C.gather(x, self.mesh, axis, dim)
        return x

    def average(self, grads: dict, loss) -> tuple:
        """Gradients and loss averaged over the data axis: one all-reduce
        per dtype for the replicated parameters' gradients (those
        gathered over `data` were reduce-scattered already)."""
        from paddle_tpu_torch.parallel.sharding import sharded_dims

        mesh = self.mesh
        n = mesh.axis_size(DATA_AXIS)
        on_data = {k for k in grads
                   if any(a == DATA_AXIS for _d, a in sharded_dims(
                       self.specs.get(k, ())))}
        out = {k: grads[k] / n for k in on_data}
        rest = [k for k in grads if k not in on_data]
        for dtype in {grads[k].dtype for k in rest}:
            ks = [k for k in rest if grads[k].dtype == dtype]
            flat = torch.cat([grads[k].reshape(-1) for k in ks]
                             + [loss.reshape(1).to(dtype)])
            flat = C.all_reduce_(mesh, DATA_AXIS, flat) / n
            off = 0
            for k in ks:
                m = grads[k].numel()
                out[k] = flat[off:off + m].view(grads[k].shape)
                off += m
            loss = flat[-1].to(loss.dtype)
        if not rest:
            loss = C.all_reduce_(mesh, DATA_AXIS, loss) / n
        return out, loss

    def shard_layout(self, opt_state=None) -> dict:
        """{tree path: (global shape, [[start, stop], ...])} of this
        rank's sharded leaves of the tree {"params": ..., "opt_state":
        ...} (a parameter's and its slots of the same shape), what a
        checkpoint records for them (`trainer/async_checkpoint.py::
        snapshot_shards`)."""
        from paddle_tpu_torch.parallel.sharding import (
            shard_slices,
            sharded_dims,
        )

        out = {}
        for k, spec in self.specs.items():
            if not sharded_dims(spec):
                continue
            dims = tuple(self.net.param_confs[k].dims)
            sig = [[sl.start, sl.stop]
                   for sl in shard_slices(spec, dims, self.mesh)]
            out[f"params/{k}"] = (dims, sig)
            for slot, t in (opt_state or {}).get(k, {}).items():
                if tuple(t.shape) == self.local_shape(k):
                    out[f"opt_state/{k}/{slot}"] = (dims, sig)
        return out

    def shard_slices_of(self, opt_state=None) -> dict:
        """{tree path: tuple of slices}: `shard_layout` as the slices a
        loader cuts from whole arrays (`checkpoint.load_sharded`)."""
        return {k: tuple(slice(a, b) for a, b in sig)
                for k, (_shape, sig) in self.shard_layout(opt_state).items()}

    def check_shards(self, params) -> None:
        """A sharded parameter that is no longer its shard's shape
        raises: its sharding was dropped."""
        for k in self.specs:
            if not any(a is not None for a in self.specs[k]):
                continue
            want = self.local_shape(k)
            if k in params and tuple(params[k].shape) != want:
                raise RuntimeError(
                    f"parameter {k!r} is {tuple(params[k].shape)} after the "
                    f"step, not its shard's {want} under "
                    f"{self.specs[k]!r}: a sharding was dropped")

    def settle(self, params, opt_state, state) -> tuple:
        """Where `multi` has captured graphs, copy these values into the
        tensors the graphs read and write, and return those; else return
        the values as they are. An eager step between two replays so
        leaves its result where the next replay starts from."""
        if self.graphs is None:
            return params, opt_state, state
        return self.graphs.adopt(params, opt_state, state)
