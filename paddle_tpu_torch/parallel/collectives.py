"""Collectives over one mesh axis, differentiable.

The port's counterpart of what XLA inserts under GSPMD and of
`lax.psum`, `lax.all_gather`, `lax.psum_scatter`, `lax.all_to_all` and
`lax.ppermute` inside the JAX package's `shard_map`s. Each function
runs one collective over `mesh`'s process group for `axis` and is an
autograd function whose backward is the collective's transpose:

- `all_reduce`: backward all-reduce. The sum of partial values over
  ranks whose data differ (the data axis: BN's statistics over the
  global batch, the MoE balance loss), so that the gradients the ranks
  then average compose through it.
- `all_gather` / `reduce_scatter`: each other's backward (ZeRO's
  gather of a data-sharded parameter at use).
- `all_to_all`: backward the all-to-all the other way.
- `shift`: the ring's neighbour exchange (batched isend / irecv, as
  `ppermute` with i -> i + shift); backward shifts the other way.

Inside a region whose ranks compute the same values (the model, seq and
pipe axes: every rank of the axis holds the same activations), the
conjugate pairs of Megatron-LM keep the replicated gradients whole:

- `split` (forward: this rank's slice; backward: all-gather),
- `gather` (forward: all-gather; backward: this rank's slice),
- `reduce` (forward: all-reduce of partial sums; backward: identity),
- `copy` (forward: identity; backward: all-reduce).

Transport: under NCCL only device collectives run. Under gloo, a
collective that gloo does not run on CUDA tensors is staged through
pinned host memory explicitly, and the bytes are counted on the mesh
(`Mesh.host_bytes`; `Mesh.calls` counts the collectives run); a host
copy under NCCL raises. On a mesh without
process groups (a shape only) every function is the identity of the
one-rank axis. On a mesh with process groups the collectives run at
every axis size, 1 included, so a one-rank NCCL world runs (and a CUDA
graph captures) the real NCCL calls.
"""

from __future__ import annotations

import torch
import torch.distributed as dist

# the gloo collectives that take CUDA tensors, as tried on the H100's
# torch 2.11 (cu128) with two ranks sharing the card: all-reduce (sum
# and min), all-gather, reduce-scatter and all-to-all run; send / recv
# of a CUDA tensor fails in gloo's TCP transport ("writev ... Bad
# address"), so the ring's exchange is staged here
GLOO_CUDA = frozenset({"all_reduce", "all_gather", "reduce_scatter",
                       "all_to_all"})

_ag = getattr(dist, "all_gather_single", None) or dist.all_gather_into_tensor
_rs = getattr(dist, "reduce_scatter_single", None) or dist.reduce_scatter_tensor


def _staged(mesh, op: str, x: torch.Tensor) -> bool:
    """Whether `op` on `x` goes through pinned host memory."""
    if not x.is_cuda:
        return False
    if mesh.backend == "nccl":
        return False
    return op not in GLOO_CUDA


def _to_host(mesh, x: torch.Tensor) -> torch.Tensor:
    if mesh.backend == "nccl":
        raise RuntimeError(
            "a collective under NCCL staged a tensor through the host; "
            "NCCL runs device collectives only")
    h = torch.empty(x.shape, dtype=x.dtype, pin_memory=True)
    h.copy_(x)
    mesh.host_bytes += x.numel() * x.element_size()
    return h


def _to_device(mesh, h: torch.Tensor, like: torch.Tensor) -> torch.Tensor:
    mesh.host_bytes += h.numel() * h.element_size()
    return h.to(like.device)


def _solo(mesh, axis: str) -> bool:
    """Whether `axis` has no process group here: a mesh with a shape
    only, or an axis the mesh does not have (size 1)."""
    return not mesh.distributed or axis not in mesh.groups


def _run(mesh, op: str, x: torch.Tensor, out_shape, fn) -> torch.Tensor:
    """fn(out, inp) on this rank's operand `x` (contiguous), staged
    through the host where `_staged` says so."""
    x = x.detach().contiguous()
    mesh.calls += 1
    if _staged(mesh, op, x):
        h = _to_host(mesh, x)
        out = torch.empty(out_shape, dtype=x.dtype)
        fn(out, h)
        return _to_device(mesh, out, x)
    out = torch.empty(out_shape, dtype=x.dtype, device=x.device)
    fn(out, x)
    return out


# ---- the collectives, without autograd -------------------------------

def all_reduce_(mesh, axis: str, x: torch.Tensor,
                op=dist.ReduceOp.SUM) -> torch.Tensor:
    """The reduction of `x` over `axis` (a new tensor)."""
    if _solo(mesh, axis):
        return x.clone()
    g = mesh.group(axis)

    def fn(out, inp):
        out.copy_(inp)
        dist.all_reduce(out, op=op, group=g)

    return _run(mesh, "all_reduce", x, x.shape, fn)


def all_gather_(mesh, axis: str, x: torch.Tensor, dim: int) -> torch.Tensor:
    """The axis' tensors concatenated along `dim` in axis order."""
    if _solo(mesh, axis):
        return x.clone()
    n = mesh.axis_size(axis)
    g = mesh.group(axis)
    xt = x.movedim(dim, 0)
    shape = (n * xt.shape[0],) + tuple(xt.shape[1:])
    out = _run(mesh, "all_gather", xt, shape,
               lambda o, i: _ag(o, i, group=g))
    return out.movedim(0, dim)


def reduce_scatter_(mesh, axis: str, x: torch.Tensor,
                    dim: int) -> torch.Tensor:
    """This rank's slice along `dim` of the sum over `axis`."""
    if _solo(mesh, axis):
        return x.clone()
    n = mesh.axis_size(axis)
    if x.shape[dim] % n:
        raise ValueError(
            f"reduce-scatter of dim {dim} ({x.shape[dim]}) over {n} ranks")
    g = mesh.group(axis)
    xt = x.movedim(dim, 0)
    shape = (xt.shape[0] // n,) + tuple(xt.shape[1:])
    out = _run(mesh, "reduce_scatter", xt, shape,
               lambda o, i: _rs(o, i, group=g))
    return out.movedim(0, dim)


def all_to_all_(mesh, axis: str, x: torch.Tensor, split_dim: int,
                concat_dim: int) -> torch.Tensor:
    """`lax.all_to_all(tiled=True)`: x split in n chunks along
    `split_dim`, chunk i sent to the axis' rank i, and the chunks
    received concatenated along `concat_dim` in axis order."""
    if _solo(mesh, axis):
        return x.clone()
    n = mesh.axis_size(axis)
    if x.shape[split_dim] % n:
        raise ValueError(
            f"all-to-all split of dim {split_dim} ({x.shape[split_dim]}) "
            f"over {n} ranks")
    g = mesh.group(axis)
    xs = torch.stack(x.chunk(n, split_dim), 0)
    out = _run(mesh, "all_to_all", xs, xs.shape,
               lambda o, i: dist.all_to_all_single(o, i, group=g))
    return torch.cat(out.unbind(0), dim=concat_dim)


def shift_(mesh, axis: str, tensors, shift: int = 1) -> list:
    """Each tensor sent to the rank `shift` steps on along `axis` (mod
    its size), and the neighbour's received in its place: `ppermute`
    with i -> i + shift, one batch of isend / irecv."""
    tensors = [t.detach().contiguous() for t in tensors]
    n = mesh.axis_size(axis)
    if _solo(mesh, axis) or n == 1:
        return [t.clone() for t in tensors]
    mesh.calls += 1
    ranks = mesh.axis_ranks(axis)
    me = mesh.axis_index(axis)
    dst, src = ranks[(me + shift) % n], ranks[(me - shift) % n]
    staged = [_staged(mesh, "shift", t) for t in tensors]
    sends = [_to_host(mesh, t) if s else t for t, s in zip(tensors, staged)]
    recvs = [torch.empty_like(s) for s in sends]
    g = mesh.group(axis)
    ops = []
    for s, r in zip(sends, recvs):
        ops.append(dist.P2POp(dist.isend, s, dst, group=g))
        ops.append(dist.P2POp(dist.irecv, r, src, group=g))
    for w in dist.batch_isend_irecv(ops):
        w.wait()
    return [_to_device(mesh, r, t) if s else r
            for r, t, s in zip(recvs, tensors, staged)]


def all_min(mesh, flag: torch.Tensor) -> torch.Tensor:
    """The minimum of `flag` over every rank of the mesh (the
    watchdog's all-finite verdict)."""
    if not mesh.distributed:
        return flag
    out = flag
    for axis in mesh.groups:
        out = all_reduce_(mesh, axis, out, op=dist.ReduceOp.MIN)
    return out


# ---- autograd --------------------------------------------------------

class _AllReduce(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh, axis):
        ctx.mesh, ctx.axis = mesh, axis
        return all_reduce_(mesh, axis, x)

    @staticmethod
    def backward(ctx, g):
        return all_reduce_(ctx.mesh, ctx.axis, g), None, None


class _AllGather(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh, axis, dim):
        ctx.mesh, ctx.axis, ctx.dim = mesh, axis, dim
        return all_gather_(mesh, axis, x, dim)

    @staticmethod
    def backward(ctx, g):
        return (reduce_scatter_(ctx.mesh, ctx.axis, g, ctx.dim), None, None,
                None)


class _ReduceScatter(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh, axis, dim):
        ctx.mesh, ctx.axis, ctx.dim = mesh, axis, dim
        return reduce_scatter_(mesh, axis, x, dim)

    @staticmethod
    def backward(ctx, g):
        return all_gather_(ctx.mesh, ctx.axis, g, ctx.dim), None, None, None


class _AllToAll(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh, axis, split_dim, concat_dim):
        ctx.args = (mesh, axis, split_dim, concat_dim)
        return all_to_all_(mesh, axis, x, split_dim, concat_dim)

    @staticmethod
    def backward(ctx, g):
        mesh, axis, split_dim, concat_dim = ctx.args
        return (all_to_all_(mesh, axis, g, concat_dim, split_dim), None, None,
                None, None)


class _Shift(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh, axis, shift):
        ctx.args = (mesh, axis, shift)
        return shift_(mesh, axis, [x], shift)[0]

    @staticmethod
    def backward(ctx, g):
        mesh, axis, shift = ctx.args
        return shift_(mesh, axis, [g], -shift)[0], None, None, None


def _local(x, mesh, axis, dim):
    n = mesh.axis_size(axis)
    if x.shape[dim] % n:
        raise ValueError(
            f"dim {dim} of {tuple(x.shape)} does not divide over {n} "
            f"ranks of {axis!r}")
    return x.chunk(n, dim)[mesh.axis_index(axis)]


class _Split(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh, axis, dim):
        ctx.mesh, ctx.axis, ctx.dim = mesh, axis, dim
        return _local(x, mesh, axis, dim).clone()

    @staticmethod
    def backward(ctx, g):
        return all_gather_(ctx.mesh, ctx.axis, g, ctx.dim), None, None, None


class _Gather(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh, axis, dim):
        ctx.mesh, ctx.axis, ctx.dim = mesh, axis, dim
        return all_gather_(mesh, axis, x, dim)

    @staticmethod
    def backward(ctx, g):
        return (_local(g, ctx.mesh, ctx.axis, ctx.dim).contiguous(), None,
                None, None)


class _Copy(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh, axis):
        ctx.mesh, ctx.axis = mesh, axis
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return all_reduce_(ctx.mesh, ctx.axis, g), None, None


class _Reduce(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh, axis):
        return all_reduce_(mesh, axis, x)

    @staticmethod
    def backward(ctx, g):
        return g, None, None


def all_reduce(x, mesh, axis: str):
    """Sum over `axis`; backward all-reduce (ranks with different
    data)."""
    return _AllReduce.apply(x, mesh, axis)


def all_gather(x, mesh, axis: str, dim: int = 0):
    """Concatenation over `axis` along `dim`; backward reduce-scatter."""
    return _AllGather.apply(x, mesh, axis, dim)


def reduce_scatter(x, mesh, axis: str, dim: int = 0):
    """This rank's slice of the sum over `axis`; backward all-gather."""
    return _ReduceScatter.apply(x, mesh, axis, dim)


def all_to_all(x, mesh, axis: str, split_dim: int, concat_dim: int):
    """`lax.all_to_all(x, axis, split_dim, concat_dim, tiled=True)`."""
    return _AllToAll.apply(x, mesh, axis, split_dim, concat_dim)


def shift(x, mesh, axis: str, shift: int = 1):
    """`ppermute` with i -> i + shift over `axis`."""
    return _Shift.apply(x, mesh, axis, shift)


def split(x, mesh, axis: str, dim: int):
    """This rank's slice of a tensor every rank of `axis` holds whole;
    backward all-gather."""
    return _Split.apply(x, mesh, axis, dim)


def gather(x, mesh, axis: str, dim: int):
    """All-gather into a tensor every rank of `axis` then holds whole;
    backward this rank's slice."""
    return _Gather.apply(x, mesh, axis, dim)


def copy(x, mesh, axis: str):
    """Identity; backward all-reduce: a value every rank of `axis`
    holds whole, entering a region where each rank computes on its
    slice (the gradients of its uses are the ranks' partial sums)."""
    return _Copy.apply(x, mesh, axis)


def reduce(x, mesh, axis: str):
    """All-reduce of partial sums into a value every rank of `axis`
    then holds whole; backward identity."""
    return _Reduce.apply(x, mesh, axis)
