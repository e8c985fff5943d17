"""Sharding rules: parameters and activations onto the mesh,
`paddle_tpu/parallel/sharding.py` on torch.

The specs are the JAX package's: `auto_param_spec` and `Sharder` give
the same partition for the same parameter confs and mesh shape (row
sharding of `sparse_remote_update` tables, experts over `model`,
column-parallel 2-D weights, HWIO conv kernels over their output
channels). The port keeps them in its own `P`, a tuple of one axis
name (or None) per dimension, as `jax.sharding.PartitionSpec` is.

What the port does with a spec: a parameter sharded by it is stored as
each rank's slice (`shard_slices`, `local_shard`) and all-gathered where
it is used (`parallel/dp.py`). An activation's placement (`constrain`,
the per-layer `out_sharding`) is checked against the mesh and the
tensor; the port's activations are split over `data` only, and held
whole on every other axis, which computes the same function.
"""

from __future__ import annotations

import re
from typing import Optional

from paddle_tpu_torch.core.mesh import (
    DATA_AXIS,
    MODEL_AXIS,
    SEQ_AXIS,
    batch_mesh,
)


class P(tuple):
    """A partition spec: per dimension the mesh axis it is split over,
    or None (replicated); missing trailing dimensions are replicated."""

    def __new__(cls, *parts):
        return super().__new__(cls, parts)

    def __repr__(self):
        return f"P{tuple(self)!r}"


def _axis_size(mesh, axis: str) -> int:
    return mesh.shape.get(axis, 1)


def auto_param_spec(pc, mesh) -> P:
    """Default tensor-parallel placement for one parameter (the JAX
    rule, line for line):

    - row-sharded embedding tables (sparse_remote_update): rows over
      `model` (or `data` if no model axis);
    - MoE expert weights (`expert_sharded`) [E, ...]: experts over
      `model`;
    - 2-D weights [in, out]: output dim over `model` when divisible;
    - 4-D conv kernels HWIO: output channels over `model`;
    - anything else replicated.
    """
    m = _axis_size(mesh, MODEL_AXIS)
    dims = tuple(pc.dims)
    if getattr(pc, "sparse_remote_update", False) and len(dims) == 2:
        if m > 1 and dims[0] % m == 0:
            return P(MODEL_AXIS, None)
        d = _axis_size(mesh, DATA_AXIS)
        if d > 1 and dims[0] % d == 0:
            return P(DATA_AXIS, None)
        return P()
    if m <= 1:
        return P()
    if getattr(pc, "expert_sharded", False) and dims and dims[0] % m == 0:
        return P(*([MODEL_AXIS] + [None] * (len(dims) - 1)))
    if len(dims) == 2 and dims[1] % m == 0 and dims[1] >= m:
        return P(None, MODEL_AXIS)
    if len(dims) == 4 and dims[-1] % m == 0:
        return P(None, None, None, MODEL_AXIS)
    return P()


class Sharder:
    """Maps parameter names to specs. `rules` is a list of (regex,
    spec) tried in order; unmatched parameters fall back to
    `auto_param_spec`."""

    def __init__(self, mesh, rules: Optional[list] = None):
        self.mesh = mesh
        self.rules = [(re.compile(pat), P(*spec)) for pat, spec in
                      (rules or [])]

    def spec(self, name: str, pc) -> P:
        for pat, spec in self.rules:
            if pat.search(name):
                return spec
        return auto_param_spec(pc, self.mesh)

    def param_specs(self, param_confs: dict) -> dict:
        return {n: self.spec(n, pc) for n, pc in param_confs.items()}


def activation_spec(mesh, seq_sharded: bool = False) -> P:
    """Canonical activation layout: batch over `data`, optionally the
    time dim over `seq`."""
    if seq_sharded and _axis_size(mesh, SEQ_AXIS) > 1:
        return P(DATA_AXIS, SEQ_AXIS)
    return P(DATA_AXIS)


def sharded_dims(spec) -> list:
    """[(dim, axis)] of the dimensions `spec` splits."""
    out = []
    for dim, axis in enumerate(tuple(spec)):
        if axis is None:
            continue
        if not isinstance(axis, str):
            raise ValueError(
                f"spec {spec!r}: dim {dim} over several axes {axis!r} is "
                f"not supported by the port")
        out.append((dim, axis))
    return out


def shard_slices(spec, shape, mesh) -> tuple:
    """This rank's slice of a global array of `shape` under `spec`: a
    tuple of slices, one per dimension."""
    out = [slice(0, s) for s in shape]
    for dim, axis in sharded_dims(spec):
        n = mesh.axis_size(axis)
        if axis not in mesh.shape:
            raise ValueError(f"spec {spec!r} names axis {axis!r} not in "
                             f"the mesh {mesh.shape}")
        if shape[dim] % n:
            raise ValueError(
                f"spec {spec!r}: dim {dim} ({shape[dim]}) does not divide "
                f"over the {n} ranks of {axis!r}")
        k = shape[dim] // n
        i = mesh.axis_index(axis)
        out[dim] = slice(i * k, (i + 1) * k)
    return tuple(out)


def local_shard(x, spec, mesh):
    """This rank's slice of the global array `x` (numpy or tensor)."""
    return x[shard_slices(spec, tuple(x.shape), mesh)]


def constrain(x, mesh, spec):
    """The JAX `with_sharding_constraint` of a layer output, checked:
    every axis of `spec` is the mesh's, and each dimension it splits
    divides over its axis (the batch dimension over `data` in global
    rows). The value is returned as it is: the port holds activations
    whole on every axis but `data`, the same function in another
    layout."""
    spec = tuple(spec)[: x.ndim]
    for dim, axis in sharded_dims(spec):
        if axis not in mesh.shape:
            raise ValueError(f"out_sharding {spec!r} names axis {axis!r} "
                             f"not in the mesh {mesh.shape}")
        split = dim == 0 and batch_mesh() is not None
        rows = x.shape[dim] * (mesh.axis_size(DATA_AXIS) if split else 1)
        if rows % mesh.axis_size(axis):
            raise ValueError(
                f"out_sharding {spec!r}: dim {dim} ({rows}) does not "
                f"divide over the {mesh.axis_size(axis)} ranks of "
                f"{axis!r}")
    return x
