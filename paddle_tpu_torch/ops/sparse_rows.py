"""In-place sparse-row updates of an embedding table and its optimizer
slots: the Hopper kernels, their plain version, the custom ops and the
launch counters.

Replaces the TPU kernel B9 of `paddle_tpu/parallel/sparse.py`
(`SparseUpdater._make_call` :322, kernel :330) together with the
uniquing and segment sum around it (`_unique_segment_grads` :109,
`_one_step` :371). For the N occurrence ids of a step, their gradients
[N, D] and k slots:

- the ids are uniqued into the k smallest, ascending, -1 fills at the
  end (`jnp.unique(size=k, fill_value=-1)`); the occurrences of ids
  dropped by that truncation contribute nothing (the hit mask of
  `_unique_segment_grads`: skipped, never landing on a neighbour);
- each slot's gradients are summed, the rule is applied to its table
  row and slot rows, and the rows are written back in place;
- fills and ids >= the table's rows are skipped, so every row not
  touched stays bit-identical.

`prepare` (torch ops on the tables' device, as the uniquing is XLA
outside the Pallas kernel in the JAX package): a stable `torch.sort`,
the unique ids, the offsets of each slot's run in the sorted order and
each occurrence's slot — static shapes, no host sync.

`sparse_rows(update_fn, tables, ids, grads, num_slots, num_rows)`: a
CUDA table goes through the kernels of `csrc/sparse_rows.cu` or the call
raises — never a fallback. A `RowRule` (sgd, momentum, adagrad) runs in
`sparse_row_update_kernel`; any other callable takes the generic route:
`sparse_row_gather_kernel`, the callable in PyTorch, then
`sparse_row_scatter_kernel`. The route follows the type of `update_fn`.
A CPU table goes through `sparse_rows_plain`: the same preparation,
`index_add_` for the sums, gather, `update_fn`, and `index_copy_` of the
valid rows. There is no backward: this is an optimizer step.

The routes are the custom ops `paddle_tpu_torch::sparse_row_update`
(the rule's kernel) and `sparse_row_gather` / `sparse_row_scatter` (the
generic route's kernels; `ops/_library.py`), the tables declared as
mutated: the CUDA implementations launch the kernels, the CPU ones run
the plain version.
"""

from __future__ import annotations

import ctypes

import torch

from paddle_tpu_torch.ops import _build, _library

KERNEL = "sparse_rows"
MAX_TABLES = 8      # the kernels take a table and up to 7 slot tables

# kernel launches since the last reset, one counter per kernel (the chip
# smoke zeroes them just before driving a path and reads them just after)
sparse_row_update_launches = 0
sparse_row_gather_launches = 0
sparse_row_scatter_launches = 0


class RowRule:
    """A row update rule the kernel knows. Called as `update_fn(rows,
    grads, *slot_rows)` it computes the rule in PyTorch (the plain
    version); `sparse_row_update_kernel` reads its `code`, `lr` and
    `hyper`.

        sgd       p' = p - lr*g                           (no slot)
        momentum  m' = mu*m + g;  p' = p - lr*m'          (slot m)
        adagrad   a' = a + g*g;   p' = p - lr*g / sqrt(a' + eps)   (slot a)
    """

    CODES = {"sgd": (0, 0), "momentum": (1, 1), "adagrad": (2, 1)}

    def __init__(self, name: str, lr: float, hyper: float = 0.0):
        self.name = name
        self.lr = float(lr)
        self.hyper = float(hyper)   # momentum's mu, adagrad's eps
        self.code, self.num_state = self.CODES[name]

    def __call__(self, rows, grads, *slots):
        if self.name == "sgd":
            return rows - self.lr * grads
        if self.name == "momentum":
            m = self.hyper * slots[0] + grads
            return rows - self.lr * m, m
        acc = slots[0] + grads * grads
        return rows - self.lr * grads / torch.sqrt(acc + self.hyper), acc


# ---------------------------------------------------------------- common
def prepare(flat_ids, k: int):
    """Uniquing and segment offsets of N occurrence ids into k slots.

    Returns (uids [k] int64: the k smallest unique ids ascending, -1
    fills at the end; perm [N] int64: the occurrence at each position of
    the stable sort; off [k+1] int64: slot i owns sorted positions
    off[i] .. off[i+1], and the occurrences of dropped ids lie past
    off[k]; slot [N] int64: each occurrence's slot, k where its id was
    dropped)."""
    n = flat_ids.shape[0]
    dev = flat_ids.device
    sorted_ids, perm = torch.sort(flat_ids, stable=True)
    first = torch.ones(n, dtype=torch.bool, device=dev)
    first[1:] = sorted_ids[1:] != sorted_ids[:-1]
    seg = torch.cumsum(first, 0) - 1
    # scatters into one spare entry past the end, dropped afterwards:
    # static shapes instead of a data-dependent mask
    uids = torch.full((k + 1,), -1, dtype=torch.int64, device=dev)
    uids.scatter_(0, torch.where(first & (seg < k), seg, k), sorted_ids)
    off = torch.full((k + 2,), n, dtype=torch.int64, device=dev)
    off.scatter_(0, torch.where(first & (seg <= k), seg, k + 1),
                 torch.arange(n, device=dev))
    slot = torch.empty_like(seg).scatter_(0, perm, torch.clamp(seg, max=k))
    return uids[:k], perm, off[:k + 1], slot


def _views(tables, where):
    """Each table as a [rows, D] view of its storage (a placed [V+1, 1,
    D] table or a [S, D] cache), all of one shape."""
    views = [t.view(t.shape[0], -1) if t.is_contiguous() else None
             for t in tables]
    for t, v in zip(tables, views):
        if v is None:
            raise ValueError(f"{where}: tables must be contiguous, got a "
                             f"strided {tuple(t.shape)} tensor")
    shape = views[0].shape
    if any(v.shape != shape for v in views):
        raise ValueError(f"{where}: the table and its slot tables must "
                         f"have one shape, got "
                         f"{[tuple(t.shape) for t in tables]}")
    return views


def _num_state(update_fn, n_tables, where):
    if isinstance(update_fn, RowRule) and update_fn.num_state != n_tables - 1:
        raise ValueError(f"{where}: rule {update_fn.name} reads "
                         f"{update_fn.num_state} slot tables, got "
                         f"{n_tables - 1}")


def sparse_rows_plain(update_fn, tables, ids, grads, num_slots: int,
                      num_rows: int):
    """The plain version, in place: the same preparation, `index_add_`
    for the sums, gather (zero rows for the skipped slots, as the gather
    kernel reads them), `update_fn`, `index_copy_` of the valid rows."""
    _views(tables, "sparse_rows_plain")
    _num_state(update_fn, len(tables), "sparse_rows_plain")
    uids, gsum, rows = _gather_plain(tables, ids, grads, num_slots, num_rows)
    out = update_fn(rows[0], gsum, *rows[1:])
    _scatter_plain(tables, list(out) if len(tables) > 1 else [out], uids,
                   num_rows)
    return tables


# --------------------------------------------------------------- kernels
def _bind():
    lib = _build.load(KERNEL)
    p, i, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    fns = {"sparse_rows_update": [i, f, f, p, i] + [p] * 4 + [i] * 4 + [i, p],
           "sparse_rows_gather": [p, p, i] + [p] * 5 + [i] * 4 + [i, p],
           "sparse_rows_scatter": [p, p, i, p] + [i] * 4 + [i, p]}
    for fn, argtypes in fns.items():
        c = getattr(lib, fn)
        if c.argtypes is None:
            c.argtypes = argtypes
            c.restype = ctypes.c_int
    lib.sparse_rows_error_string.argtypes = [i]
    lib.sparse_rows_error_string.restype = ctypes.c_char_p
    return lib


def _check(where, views, ids, grads):
    """Validate the kernels' inputs; returns (grads as [N, D], D)."""
    t0 = views[0]
    rows, d = t0.shape
    if t0.device.type != "cuda":
        raise ValueError(f"{where}: unsupported device {t0.device}")
    if d == 0 or rows == 0:
        raise ValueError(f"{where}: tables must be [rows >= 1, D >= 1], "
                         f"got {tuple(t0.shape)}")
    if len(views) > MAX_TABLES:
        raise ValueError(f"{where}: at most {MAX_TABLES - 1} slot tables, "
                         f"got {len(views) - 1}")
    if rows >= 2 ** 31 or ids.numel() >= 2 ** 31:
        raise ValueError(f"{where}: rows and ids must be < 2^31 (int32 "
                         f"indices), got {rows} rows, {ids.numel()} ids")
    for v in views:
        if v.dtype != torch.float32 or v.device != t0.device:
            raise ValueError(f"{where}: tables must be f32 on {t0.device}, "
                             f"got {v.dtype} on {v.device}")
    n = ids.numel()
    if (grads.dtype != torch.float32 or grads.device != t0.device
            or grads.numel() != n * d or not grads.is_contiguous()):
        raise ValueError(f"{where}: grads must be a contiguous f32 "
                         f"[{n}, {d}] tensor on {t0.device}, got "
                         f"{grads.dtype} {tuple(grads.shape)} on "
                         f"{grads.device}")
    if ids.device != t0.device or ids.dtype not in (torch.int32,
                                                    torch.int64):
        raise ValueError(f"{where}: ids must be int32/int64 on "
                         f"{t0.device}, got {ids.dtype} on {ids.device}")
    return grads.view(n, d), d


def _vec(d, *tensors):
    """4 (16-byte loads) where D % 4 == 0 and every base is 16-byte
    aligned, else 1."""
    ok = d % 4 == 0 and all(t.data_ptr() % 16 == 0 for t in tensors)
    return 4 if ok else 1


def _ptrs(tensors):
    return (ctypes.c_void_p * len(tensors))(*[t.data_ptr() for t in tensors])


def kernel_indices(ids, k: int):
    """`prepare` on the card, as the kernels read it: (uids [k], perm
    [N], off [k+1]) int32."""
    uids, perm, off, _slot = prepare(ids.reshape(-1).to(torch.int64), k)
    return tuple(x.to(torch.int32) for x in (uids, perm, off))


def update_kernel(rule, views, g, uids, perm, off, num_rows: int):
    """`sparse_row_update_kernel`: the rule applied in place to the
    valid slots of `views` ([rows, D] each, the table first)."""
    global sparse_row_update_launches
    d = views[0].shape[1]
    dev, stream = _build.device_and_stream(views[0])
    _build.launch(_bind(), "sparse_rows_update", "sparse_rows_error_string",
                  rule.code, rule.lr, rule.hyper, _ptrs(views), len(views),
                  g.data_ptr(), perm.data_ptr(), uids.data_ptr(),
                  off.data_ptr(), uids.shape[0], num_rows, d,
                  _vec(d, g, *views), dev, stream)
    sparse_row_update_launches += 1


def gather_kernel(views, g, uids, perm, off, num_rows: int):
    """`sparse_row_gather_kernel`: (gsum [k, D], [rows [k, D] of each
    table]), zero rows for the skipped slots."""
    global sparse_row_gather_launches
    k, d = uids.shape[0], views[0].shape[1]
    gsum = g.new_empty((k, d))
    rows = [g.new_empty((k, d)) for _ in views]
    dev, stream = _build.device_and_stream(views[0])
    _build.launch(_bind(), "sparse_rows_gather", "sparse_rows_error_string",
                  _ptrs(views), _ptrs(rows), len(views), gsum.data_ptr(),
                  g.data_ptr(), perm.data_ptr(), uids.data_ptr(),
                  off.data_ptr(), k, num_rows, d,
                  _vec(d, g, gsum, *rows, *views), dev, stream)
    sparse_row_gather_launches += 1
    return gsum, rows


def scatter_kernel(views, new, uids, num_rows: int):
    """`sparse_row_scatter_kernel`: the valid slots of `new` ([k, D] a
    table) written into `views` in place."""
    global sparse_row_scatter_launches
    k, d = uids.shape[0], views[0].shape[1]
    dev, stream = _build.device_and_stream(views[0])
    _build.launch(_bind(), "sparse_rows_scatter", "sparse_rows_error_string",
                  _ptrs(views), _ptrs(new), len(views), uids.data_ptr(), k,
                  num_rows, d, _vec(d, *new, *views), dev, stream)
    sparse_row_scatter_launches += 1


def sparse_rows_kernel(rule, tables, ids, grads, num_slots: int,
                       num_rows: int):
    """B9's rule kernel on the card, in place: `sparse_row_update_kernel`
    applies the `RowRule` to the touched rows (the CUDA implementation
    of the op `sparse_row_update`)."""
    where = "sparse_rows"
    views = _views(tables, where)
    _num_state(rule, len(tables), where)
    g, _d = _check(where, views, ids, grads)
    k = int(num_slots)
    if k >= 1 and g.shape[0]:
        uids, perm, off = kernel_indices(ids, k)
        update_kernel(rule, views, g, uids, perm, off, num_rows)


# ------------------------------------------------------------ custom ops
def _rule_update_cuda(tables, ids, grads, rule, lr, hyper, num_slots,
                      num_rows):
    sparse_rows_kernel(RowRule(rule, lr, hyper), tables, ids, grads,
                       num_slots, num_rows)


def _rule_update_plain(tables, ids, grads, rule, lr, hyper, num_slots,
                     num_rows):
    sparse_rows_plain(RowRule(rule, lr, hyper), tables, ids, grads,
                      num_slots, num_rows)


def _gather_cuda(tables, ids, grads, num_slots, num_rows):
    """(uids [k] int32, gsum [k, D], [rows [k, D] of each table]) by
    `sparse_row_gather_kernel`."""
    where = "sparse_row_gather"
    views = _views(tables, where)
    g, _d = _check(where, views, ids, grads)
    uids, perm, off = kernel_indices(ids, int(num_slots))
    gsum, rows = gather_kernel(views, g, uids, perm, off, num_rows)
    return uids, gsum, rows


def _gather_plain(tables, ids, grads, num_slots, num_rows):
    views = _views(tables, "sparse_row_gather")
    k = int(num_slots)
    flat = ids.reshape(-1).to(torch.int64)
    g = grads.reshape(flat.shape[0], views[0].shape[1])
    uids, _perm, _off, slot = prepare(flat, k)
    gsum = g.new_zeros((k + 1, g.shape[1])).index_add_(0, slot, g)[:k]
    valid = (uids >= 0) & (uids < num_rows)
    safe = torch.where(valid, uids, 0)
    rows = [torch.where(valid[:, None], v.index_select(0, safe), 0.0)
            for v in views]
    return uids.to(torch.int32), gsum, rows


def _gather_fake(tables, ids, grads, num_slots, num_rows):
    k, d = int(num_slots), tables[0].numel() // tables[0].shape[0]
    return (ids.new_empty((k,), dtype=torch.int32),
            grads.new_empty((k, d)), [t.new_empty((k, d)) for t in tables])


def _scatter_cuda(tables, new, uids, num_rows):
    scatter_kernel(_views(tables, "sparse_row_scatter"),
                   [x.to(torch.float32).contiguous() for x in new], uids,
                   num_rows)


def _scatter_plain(tables, new, uids, num_rows):
    uids = uids.to(torch.int64)
    valid = (uids >= 0) & (uids < num_rows)
    idx = uids[valid]
    for v, nw in zip(_views(tables, "sparse_row_scatter"), new):
        v.index_copy_(0, idx, nw[valid].to(v.dtype))


rule_update_op = _library.define(
    "sparse_row_update",
    "(Tensor(a!)[] tables, Tensor ids, Tensor grads, str rule, float lr, "
    "float hyper, int num_slots, int num_rows) -> ()",
    _rule_update_cuda, _rule_update_plain, lambda *args: None)
gather_op = _library.define(
    "sparse_row_gather",
    "(Tensor[] tables, Tensor ids, Tensor grads, int num_slots, "
    "int num_rows) -> (Tensor, Tensor, Tensor[])",
    _gather_cuda, _gather_plain, _gather_fake)
scatter_op = _library.define(
    "sparse_row_scatter",
    "(Tensor(a!)[] tables, Tensor[] new, Tensor uids, int num_rows) -> ()",
    _scatter_cuda, _scatter_plain, lambda *args: None)


def sparse_rows(update_fn, tables, ids, grads, num_slots: int,
                num_rows: int):
    """Apply `update_fn` in place to the touched rows of `tables` (the
    table, then its slot tables: contiguous, one shape, rows first) for
    occurrence ids `ids` and their gradients `grads` [N, D]; `num_slots`
    unique rows at most (the k smallest ids), rows >= `num_rows`
    skipped. Returns `tables`.

    A `RowRule` runs in the op `paddle_tpu_torch::sparse_row_update`;
    any other callable between `sparse_row_gather` and
    `sparse_row_scatter`. Each op runs the kernels on a CUDA table, the
    plain version on a CPU one (the generic route's plain gather reads
    zero rows for the skipped slots, as the gather kernel does)."""
    tables = list(tables)
    _num_state(update_fn, len(tables), "sparse_rows")
    k = int(num_slots)
    if k < 1 or ids.numel() == 0:
        return tables
    if isinstance(update_fn, RowRule):
        rule_update_op(tables, ids, grads, update_fn.name, update_fn.lr,
                       update_fn.hyper, k, int(num_rows))
        return tables
    uids, gsum, rows = gather_op(tables, ids, grads, k, int(num_rows))
    out = update_fn(rows[0], gsum, *rows[1:])
    new = list(out) if len(tables) > 1 else [out]
    d = gsum.shape[1]
    if len(new) != len(tables) or any(x.shape != (k, d) for x in new):
        raise ValueError(f"sparse_rows: update_fn must return {len(tables)} "
                         f"[{k}, {d}] tensors, got "
                         f"{[tuple(x.shape) for x in new]}")
    scatter_op(tables, new, uids, int(num_rows))
    return tables
