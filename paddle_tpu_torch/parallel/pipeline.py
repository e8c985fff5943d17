"""Pipeline parallelism: GPipe microbatch pipelining over a mesh axis,
`paddle_tpu/parallel/pipeline.py` on torch.distributed.

Every rank of the `pipe` axis holds ONE stage's parameters
(`shard_stacked_params`), microbatches stream through M + S - 1 ticks,
and activations hop stage to stage with the ring's neighbour exchange
(`parallel/collectives.py::shift`, batched isend / irecv). Autograd
does not differentiate `dist.send` / `recv`: the hop is an autograd
function whose backward sends the cotangent back to the previous
stage, which is what the JAX pipeline gets from `ppermute`'s
transpose. Backprop through `pipeline_apply` is pipelined backprop.

The program is SPMD, as the JAX one: every rank runs its stage at every
tick (stage 0 on the next microbatch, the others on what the previous
tick handed them, selected with `torch.where` so that every rank's
autograd graph has the same collectives in the same order), and only
the last stage's outputs are kept; an all-reduce over the axis (with
an identity backward: the output is then whole on every rank) hands
them to every rank.

All stages share one activation signature (same shape in and out).
"""

from __future__ import annotations

from typing import Callable

import torch

from paddle_tpu_torch.parallel import collectives as C


def _tree_map(fn, tree):
    if isinstance(tree, dict):
        return {k: _tree_map(fn, v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_tree_map(fn, v) for v in tree)
    return fn(tree)


def pipeline_apply(mesh, axis_name: str, stage_fn: Callable, stage_params,
                   xs: torch.Tensor, batch_axis: str | None = None):
    """Run the pipeline.

    stage_params: THIS rank's stage parameters (a pytree without the
    stage axis; `shard_stacked_params` cuts them from the stacked
    ones). xs: [M, micro_batch, ...] microbatches, whole on every rank.
    Returns [M, micro_batch, ...] outputs, whole on every rank.
    Differentiable end to end.

    batch_axis: a mesh data axis to split the micro_batch dim over —
    pp x dp in one program: each data rank streams its slice of every
    microbatch through the same pipe, the stage parameters' gradients
    are summed over the axis, and the outputs gathered whole.
    """
    if batch_axis is not None:
        stage_params = _tree_map(lambda p: C.copy(p, mesh, batch_axis),
                                 stage_params)
        xs = C.split(xs, mesh, batch_axis, 1)
    out = _pipeline_local(stage_fn, mesh, axis_name, stage_params, xs)
    if batch_axis is not None:
        out = C.gather(out, mesh, batch_axis, 1)
    return out


def _pipeline_local(stage_fn, mesh, axis_name, params, xs):
    """The ticks on this rank: [M, ...] outputs of the last stage,
    all-reduced over the pipe (zeros from every other stage)."""
    idx = mesh.axis_index(axis_name)
    S = mesh.axis_size(axis_name)
    M = xs.shape[0]
    first = torch.tensor(idx == 0, device=xs.device)
    last = torch.tensor(idx == S - 1, device=xs.device)
    acts = None
    outputs = []
    for t in range(M + S - 1):
        x_t = xs[min(t, M - 1)]
        inp = x_t if acts is None else torch.where(first, x_t, acts)
        y = stage_fn(params, inp)
        # hand to the next stage; the last tick's hand-off is unused on
        # every rank, so no rank differentiates it
        if t < M + S - 2:
            acts = C.shift(y, mesh, axis_name, 1)
        out_t = t - (S - 1)
        if out_t >= 0:
            outputs.append(torch.where(last, y, torch.zeros_like(y)))
    return C.reduce(torch.stack(outputs), mesh, axis_name)


def shard_stacked_params(mesh, axis_name: str, stacked_params):
    """This rank's stage of parameters stacked stage-major ([S, ...]
    leaves, numpy or tensors): the leaves' slice at the rank's index on
    `axis_name`, without the stage axis."""
    i = mesh.axis_index(axis_name)
    return _tree_map(lambda a: torch.as_tensor(a)[i].clone(), stacked_params)


def microbatch(x: torch.Tensor, n_micro: int) -> torch.Tensor:
    """[B, ...] -> [M, B/M, ...]."""
    if x.shape[0] % n_micro:
        raise ValueError(
            f"batch {x.shape[0]} not divisible into {n_micro} microbatches")
    return x.reshape((n_micro, x.shape[0] // n_micro) + tuple(x.shape[1:]))


def unmicrobatch(x: torch.Tensor) -> torch.Tensor:
    return x.reshape((-1,) + tuple(x.shape[2:]))
