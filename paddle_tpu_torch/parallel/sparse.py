"""Row-sparse updates of embedding tables: `paddle_tpu/parallel/
sparse.py` on torch, on one device.

The reference's large-model update rule (math/SparseRowMatrix.h:204
SparsePrefetchRowCpuMatrix, trainer/RemoteParameterUpdater.h:265): only
the rows a batch touches are pulled, optimized and written back.

- `touched_rows` and `apply_rows`: the dense O(V) oracle.
- `sparse_apply`: gather-touched -> update -> scatter as plain PyTorch,
  functional (returns new tensors), with the masked-delta scatter that
  keeps an aliased row 0 bit-identical.
- `SparseUpdater`: the standalone, V-independent step. Tables are placed
  once as contiguous [V+1, 1, D] tensors (row V is the scratch row, as in
  the JAX package); each step updates the touched rows of the table and
  its optimizer-slot tables IN PLACE through B9
  (`ops/sparse_rows.py`, `csrc/sparse_rows.cu`) and returns the same
  tensors — the port's form of the JAX donation.

The JAX class's `_format`, `_salt_scratch`, `_jit_pinned`,
`_achieved_fmt` and `_relayouts` are not ported: they pin Mosaic/XLA
layouts across compiled programs, and PyTorch has no such programs — a
contiguous row-major tensor is the kernel's layout.

`embedding_lookup`: rows of a table sharded by rows over a mesh axis
(the JAX shard_map program): each rank takes the ids it owns from its
row shard, masks the rest to 0, and an all-reduce over the axis
combines the partial rows. The backward is row-sparse: each rank's
table gradient is a sparse COO tensor of the rows it owns that the ids
touch.
"""

from __future__ import annotations

import numpy as np
import torch

from paddle_tpu_torch.core.device import resolve_device
from paddle_tpu_torch.ops import sparse_rows as _rows
from paddle_tpu_torch.parallel import collectives as C


class _OwnedRows(torch.autograd.Function):
    """rows = shard[local ids] where owned, else 0; backward: a sparse
    COO gradient of the owned rows the ids touch."""

    @staticmethod
    def forward(ctx, shard, local, ok):
        safe = torch.where(ok, local, 0)
        rows = shard.index_select(0, safe.reshape(-1)).reshape(
            tuple(local.shape) + tuple(shard.shape[1:]))
        ctx.save_for_backward(local, ok)
        ctx.shard_shape = tuple(shard.shape)
        return torch.where(ok[..., None], rows, 0.0)

    @staticmethod
    def backward(ctx, g):
        local, ok = ctx.saved_tensors
        sel = ok.reshape(-1)
        idx = local.reshape(-1)[sel]
        vals = g.reshape(-1, g.shape[-1])[sel]
        grad = torch.sparse_coo_tensor(idx[None], vals, ctx.shard_shape)
        return grad.coalesce(), None, None


def embedding_lookup(table, ids, mesh, *, axis: str = "model"):
    """Rows of a row-sharded table.

    table: THIS rank's row shard [V / n, D] of a [V, D] table split over
    `axis` (n ranks; shard i holds rows [i V/n, (i+1) V/n)); ids: int
    [...], the same on every rank of the axis. Returns [..., D], whole
    on every rank."""
    rows_local = table.shape[0]
    shard = mesh.axis_index(axis)
    ids = torch.as_tensor(ids).to(device=table.device, dtype=torch.int64)
    local = ids - shard * rows_local
    ok = (local >= 0) & (local < rows_local)
    rows = _OwnedRows.apply(table, local, ok)
    return C.reduce(rows, mesh, axis)


def touched_rows(ids, vocab_size: int):
    """Boolean [V] marker of the rows referenced by this batch."""
    ids = torch.as_tensor(ids)
    out = torch.zeros((vocab_size,), dtype=torch.bool, device=ids.device)
    out[ids.reshape(-1).to(torch.int64)] = True
    return out


def apply_rows(update_fn, param, grad, touched):
    """DENSE reference: `update_fn(param, grad)` on the touched rows,
    every other row bit-identical. O(V) — the oracle of `sparse_apply`
    and `SparseUpdater`."""
    new = update_fn(param, grad)
    return torch.where(touched[:, None], new, param)


def _unique_segment_grads(flat_ids, grads, k):
    """Unique the touched ids into k sorted slots and sum the
    per-occurrence grads into them. Returns (uids [k] with -1 fills at
    the END, gsum [k, ...]). With k below the batch's unique count the k
    smallest ids survive and the dropped ids' gradients are skipped this
    step, never landing on a neighbour."""
    n = flat_ids.shape[0]
    uids, _perm, _off, slot = _rows.prepare(flat_ids.to(torch.int64), k)
    g = grads.reshape((n,) + tuple(grads.shape[1:]))
    gsum = g.new_zeros((k + 1,) + tuple(g.shape[1:])).index_add_(0, slot, g)
    return uids, gsum[:k]


def sparse_apply(update_fn, param, ids, grads, state=(), num_slots=None):
    """Gather-touched -> update -> scatter as plain PyTorch, functional:
    returns (new_param, new_state) and leaves the inputs as they were.

    param: [V, D]. ids: int [N] (occurrences, duplicates fine). grads:
    [N, D]. state: tuple of [V, ...] slot tensors. update_fn(param_rows,
    grad_rows, *state_rows) -> (new_rows, *new_state_rows), or new_rows
    when state is empty. num_slots: unique-row capacity (default N). Ids
    >= V are skipped, as the JAX scatter drops them."""
    ids = torch.as_tensor(ids, device=param.device).reshape(-1).to(
        torch.int64)
    k = num_slots or ids.shape[0]
    uids, gsum = _unique_segment_grads(ids, grads, k)
    valid = (uids >= 0) & (uids < param.shape[0])
    safe = torch.where(valid, uids, 0)
    prows = param[safe]
    srows = tuple(s[safe] for s in state)
    out = update_fn(prows, gsum, *srows)
    if state:
        new_rows, *new_srows = out
    else:
        new_rows, new_srows = out, []
    # scatter as masked DELTAS: invalid slots all alias row 0, and adding
    # zero there is order-independent (a copy with duplicate indices would
    # not be)
    vmask = valid[:, None].to(param.dtype)
    new_param = param.index_add(0, safe, (new_rows - prows) * vmask)
    new_state = tuple(
        s.index_add(0, safe, (ns - sr) * valid.reshape(
            (k,) + (1,) * (ns.dim() - 1)).to(s.dtype))
        for s, sr, ns in zip(state, srows, new_srows)
    )
    return new_param, new_state


class SparseUpdater:
    """The V-independent sparse step: B9 updates the touched rows of the
    table (and its optimizer-slot tables) IN PLACE.

        upd = SparseUpdater(momentum_row_update(0.01, 0.9))
        param = upd.place(table_2d)          # once per table
        mom = upd.place(np.zeros_like(table_2d))
        param, (mom,) = upd(param, ids, grads, (mom,))   # per step

    Layout: `place` returns a contiguous [V+1, 1, D] tensor on the card
    (or on `device`); row V is the scratch row. `unplace` returns the
    [V, D] numpy table. The returned tensors are the placed ones, updated
    in place.

    Slots: k = num_slots, or the step's number of occurrences. When the
    batch touches more than k unique rows, the k smallest ids are
    updated and the others skipped this step. Ids >= V touch no row.

    update_fn: a rule of `parallel/sparse_shard.py`
    (`sgd_row_update`, `momentum_row_update`, `adagrad_row_update`) runs
    in one kernel; any other callable `update_fn(rows, gsum,
    *slot_rows)` runs in PyTorch between a gather and a scatter kernel.
    """

    def __init__(self, update_fn, num_slots=None):
        self.update_fn = update_fn
        self.num_slots = num_slots

    # ---- table placement ----
    @staticmethod
    def place(table, device=None):
        """[V, D] (numpy or tensor) -> contiguous [V+1, 1, D] tensor on
        the device, with a zero scratch row V appended. A float64 table
        is placed as float32, as the JAX `place` does with x64 off (and
        as the kernels take)."""
        dev = resolve_device(device)
        t = table if torch.is_tensor(table) else torch.tensor(
            np.asarray(table))
        v, d = t.shape
        dtype = torch.float32 if t.dtype == torch.float64 else t.dtype
        out = torch.zeros((v + 1, 1, d), dtype=dtype, device=dev)
        out[:v, 0].copy_(t)
        return out

    @staticmethod
    def unplace(table):
        t = table.detach().cpu().numpy() if torch.is_tensor(table) else (
            np.asarray(table))
        return t.reshape(t.shape[0], t.shape[2])[:-1]  # drop scratch

    # ---- the step ----
    def _step(self, param, state, ids, grads):
        dev = param.device
        flat = torch.as_tensor(ids, device=dev).reshape(-1)
        grads = torch.as_tensor(grads, device=dev)
        k = self.num_slots or flat.shape[0]
        g = grads.reshape(flat.shape[0], param.shape[2]).contiguous()
        _rows.sparse_rows(self.update_fn, [param, *state], flat, g, k,
                          param.shape[0] - 1)

    def __call__(self, param, ids, grads, state=()):
        """One step in place; returns (param, tuple(state)), the same
        tensors."""
        state = tuple(state)
        self._step(param, state, ids, grads)
        return param, state

    def run_steps(self, param, ids_seq, grads_seq, state=()):
        """n_steps sequential updates: ids_seq [n_steps, N], grads_seq
        [n_steps, N, D]. No host sync between steps."""
        state = tuple(state)
        for i in range(ids_seq.shape[0]):
            self._step(param, state, ids_seq[i], grads_seq[i])
        return param, state
