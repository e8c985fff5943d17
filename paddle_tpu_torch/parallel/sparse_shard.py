"""Sharded embedding tier for 100M–1B-row CTR tables:
`paddle_tpu/parallel/sparse_shard.py` on torch.

A logical table of up to 2^30 rows lives as per-shard hot caches:

- **Explicit placement.** Every logical row id has one owner shard —
  `range` (id // rows_per_shard) or `hash` (splitmix64). Ownership is
  arithmetic, not a directory.
- **Hot-cache residency.** Each shard owns `capacity` device rows (and
  as many rows of each optimizer-slot buffer). A host-side LRU map binds
  resident ids to slots; rows the traffic stops touching are evicted to
  the shard's host spill store, and rows touched again are rebuilt from
  spill (or from the deterministic init for never-touched rows). The
  device buffers and every launch depend on (capacity, dim, batch),
  never on `rows_total`.

Without a mesh the `num_shards` logical shards lie in one [num_shards ·
capacity, D] cache on one device: the same global view the JAX mesh
array has, with cache slot = shard · capacity + local slot. With a mesh
(`mesh=`, `axis=`) shard s lives on the axis' rank s mod n: each rank
holds the hot cache, the LRU maps and the spill store of its shards
only. Every rank of the axis is given the same ids; a rank looks up and
updates the rows it owns, and a lookup's rows are all-reduced over the
axis (each id has one owner, the others give 0). Owner arithmetic,
per-shard LRU, spill, and the export and restore payloads are the JAX
table's with the same number of shards; the one-batch miss check counts
the misses of every rank (an all-reduce). `update` applies the row rule
through B9 (`ops/sparse_rows.py`) on each rank's rows; lookup, pull and
push are plain indexing (`index_select` / `index_copy_`), as they are
plain XLA in the JAX package.

Checkpointing: `export_shards()` returns one payload dict per shard
(resident rows in LRU order + spill store + optimizer slots; on a mesh
every rank's, gathered), `restore_shards()` takes them back (on a mesh
each rank keeps its shards') — the JAX table's payloads too.
"""

from __future__ import annotations

from collections import OrderedDict
from dataclasses import dataclass
from math import ceil

import numpy as np
import torch

from paddle_tpu_torch.core.device import resolve_device
from paddle_tpu_torch.ops import sparse_rows as _rows
from paddle_tpu_torch.ops.sparse_rows import RowRule

_MASK64 = np.uint64(0xFFFFFFFFFFFFFFFF)


def _mix64(x):
    """splitmix64 finalizer, vectorized over uint64 numpy arrays —
    the hash behind `hash` placement and the deterministic row init.
    Stdlib-deterministic: the same id hashes the same on every
    process, every run, every platform."""
    x = np.asarray(x, np.uint64)
    with np.errstate(over="ignore"):
        x = (x + np.uint64(0x9E3779B97F4A7C15)) & _MASK64
        x = ((x ^ (x >> np.uint64(30)))
             * np.uint64(0xBF58476D1CE4E5B9)) & _MASK64
        x = ((x ^ (x >> np.uint64(27)))
             * np.uint64(0x94D049BB133111EB)) & _MASK64
        return x ^ (x >> np.uint64(31))


# Memoized by hyperparameters: two calls with the same hyperparameters
# return the SAME rule object.
_UPDATE_FNS: dict = {}


def _rule(name, lr, hyper=0.0):
    key = (name, float(lr), float(hyper))
    if key not in _UPDATE_FNS:
        _UPDATE_FNS[key] = RowRule(name, lr, hyper)
    return _UPDATE_FNS[key]


def sgd_row_update(lr: float = 0.1):
    """Plain row SGD `update_fn` (no optimizer slots): rows - lr·g."""
    return _rule("sgd", lr)


def momentum_row_update(lr: float = 0.01, mu: float = 0.9):
    """Row momentum with one slot buffer: m' = mu·m + g; rows - lr·m'
    (the rule of `bench.py`'s sparse CTR benches, given a name)."""
    return _rule("momentum", lr, mu)


def adagrad_row_update(lr: float = 0.1, eps: float = 1e-6):
    """Adagrad with one per-row accumulator slot buffer: acc' = acc +
    g²; rows - lr·g / sqrt(acc' + eps). Evict-then-touch keeps the
    accumulator (it rides in the spill store)."""
    return _rule("adagrad", lr, eps)


@dataclass(frozen=True)
class ShardedTableConfig:
    """Static shape/placement contract for one sharded table.

    rows_total: LOGICAL vocabulary (100M–1B). Costs nothing: only
        host-side owner arithmetic ever sees it.
    dim: row width D.
    capacity: HOT rows per shard (device-resident). Total device
        footprint = num_shards * capacity * dim * 4 bytes.
    num_slots: static unique-touched-rows capacity per update step.
        Must be <= capacity so one batch can always be made fully
        resident.
    placement: "range" | "hash".
    init_scale: deterministic per-(row, col) init amplitude; 0.0 =
        zero init. Never-touched rows ARE this init — there is no
        materialized cold table to read them from.
    seed: folded into the init hash stream.
    """

    rows_total: int
    dim: int
    capacity: int
    num_slots: int
    placement: str = "range"
    init_scale: float = 0.0
    seed: int = 0

    def __post_init__(self):
        if self.placement not in ("range", "hash"):
            raise ValueError(f"placement {self.placement!r}")
        if self.num_slots > self.capacity:
            raise ValueError(
                f"num_slots {self.num_slots} > capacity "
                f"{self.capacity}: a single batch could not be made "
                f"resident"
            )


class ShardedEmbeddingTable:
    """A logically huge embedding table as explicit per-shard hot caches
    on one device. The API is host-driven:

        cfg = ShardedTableConfig(rows_total=1 << 30, dim=16,
                                 capacity=4096, num_slots=256)
        table = ShardedEmbeddingTable(cfg, num_shards=8,
                                      update_fn=sgd_row_update(0.1))
        emb = table.lookup(ids)          # [..., D] — ids anywhere in [0, 1<<30)
        table.update(ids, grads)         # per-occurrence grads [N, D]
        payloads = table.export_shards() # one dict per shard
        table.restore_shards(payloads)   # resume

    The buffers live on the card unless `device="cpu"`. Thread contract:
    single-writer (the training loop); export copies.
    """

    def __init__(self, config: ShardedTableConfig, num_shards: int = 1,
                 update_fn=None, num_state: int = 0, device=None,
                 mesh=None, axis: str = "model"):
        self.config = config
        if device is None and mesh is not None and mesh.device is not None:
            device = mesh.device
        self.device = resolve_device(device)
        self.num_shards = int(num_shards)
        if self.num_shards < 1:
            raise ValueError(f"num_shards {num_shards} < 1")
        self.update_fn = (update_fn if update_fn is not None
                          else sgd_row_update(0.1))
        self.num_state = int(num_state)
        self.rows_per_shard = ceil(config.rows_total / self.num_shards)
        self.mesh, self.axis = mesh, axis
        n = mesh.axis_size(axis) if mesh is not None else 1
        r = mesh.axis_index(axis) if mesh is not None else 0
        # the shards this rank holds, and each one's block of the cache
        self.local_shards = [s for s in range(self.num_shards) if s % n == r]
        self._pos = {s: i for i, s in enumerate(self.local_shards)}
        C, D = config.capacity, config.dim
        self._S = len(self.local_shards) * C  # this rank's hot slots
        self._cache = torch.zeros((self._S, D), dtype=torch.float32,
                                  device=self.device)
        self._state = tuple(torch.zeros_like(self._cache)
                            for _ in range(self.num_state))
        # host residency maps, per shard: id -> local slot, LRU order
        # (oldest first); free slots; spill store id -> (row, *slots)
        self._slot_of = [OrderedDict() for _ in range(self.num_shards)]
        self._free = [list(range(C - 1, -1, -1))
                      for _ in range(self.num_shards)]
        self._spill = [dict() for _ in range(self.num_shards)]
        self.stats = {"hits": 0, "misses": 0, "evictions": 0,
                      "steps": 0}

    # ---- placement ----
    def owners(self, ids) -> np.ndarray:
        ids = np.asarray(ids, np.int64)
        if self.config.placement == "range":
            return ids // self.rows_per_shard
        return (_mix64(ids.astype(np.uint64))
                % np.uint64(self.num_shards)).astype(np.int64)

    # ---- deterministic init ----
    def _init_rows(self, ids) -> np.ndarray:
        D = self.config.dim
        ids = np.asarray(ids, np.int64)
        if not self.config.init_scale:
            return np.zeros((len(ids), D), np.float32)
        base = (ids.astype(np.uint64)[:, None] * np.uint64(D)
                + np.arange(D, dtype=np.uint64)[None, :]
                + np.uint64(self.config.seed) * np.uint64(0x9E37))
        u = (_mix64(base) >> np.uint64(11)).astype(np.float64) * 2.0**-53
        return ((u * 2.0 - 1.0)
                * self.config.init_scale).astype(np.float32)

    # ---- residency ----
    def _global_slot(self, shard: int, local: int) -> int:
        return self._pos[shard] * self.config.capacity + local

    def _owned(self, ids: np.ndarray) -> np.ndarray:
        """Which of `ids` this rank's shards own."""
        if self.mesh is None:
            return np.ones(len(ids), bool)
        n = self.mesh.axis_size(self.axis)
        return self.owners(ids) % n == self.mesh.axis_index(self.axis)

    def _axis_sum(self, t: torch.Tensor) -> torch.Tensor:
        if self.mesh is None:
            return t
        from paddle_tpu_torch.parallel import collectives

        return collectives.all_reduce_(self.mesh, self.axis, t)

    def ensure_resident(self, uids: np.ndarray) -> None:
        """Make every id in `uids` (unique, any order) resident,
        faulting misses in from spill/init and LRU-evicting to make
        room. Evicted rows are written back (row + optimizer slots)
        to the owner shard's spill store — an evicted row touched
        again is REBUILT, never reset."""
        uids = np.asarray(uids, np.int64)
        if len(uids) and (int(uids.min()) < 0
                          or int(uids.max()) >= self.config.rows_total):
            raise ValueError(
                f"ids must lie in [0, {self.config.rows_total}); got "
                f"range [{int(uids.min())}, {int(uids.max())}]"
            )
        uids = uids[self._owned(uids)]
        shards = self.owners(uids)
        misses = []  # (shard, id)
        for i, s in zip(uids.tolist(), shards.tolist()):
            d = self._slot_of[s]
            if i in d:
                d.move_to_end(i)
                self.stats["hits"] += 1
            else:
                misses.append((s, i))
                self.stats["misses"] += 1
        n_miss = len(misses)
        if self.mesh is not None:
            # the batch's misses on every rank: the one-table check
            n_miss = int(self._axis_sum(torch.tensor(
                [n_miss], dtype=torch.int64, device=self.device)).item())
        if not misses and n_miss == 0:
            return
        if n_miss > self.config.num_slots:
            raise ValueError(
                f"{n_miss} misses in one batch > num_slots "
                f"{self.config.num_slots}"
            )
        if not misses:
            return
        evict = []   # (shard, id, local slot)
        assign = []  # (shard, id, local slot)
        for s, i in misses:
            if self._free[s]:
                slot = self._free[s].pop()
            else:
                old_id, slot = self._slot_of[s].popitem(last=False)
                evict.append((s, old_id, slot))
                self.stats["evictions"] += 1
            assign.append((s, i, slot))
            self._slot_of[s][i] = slot  # newest; never a victim below
        if evict:
            self._write_back(evict)
        # values for the faulted-in rows: spill wins, else init
        vals = np.empty((len(assign), self.config.dim), np.float32)
        svals = [np.zeros_like(vals) for _ in range(self.num_state)]
        init_ix, init_ids = [], []
        for j, (s, i, _slot) in enumerate(assign):
            spilled = self._spill[s].pop(i, None)
            if spilled is not None:
                vals[j] = spilled[0]
                for t in range(self.num_state):
                    svals[t][j] = spilled[1 + t]
            else:
                init_ix.append(j)
                init_ids.append(i)
        if init_ix:
            vals[init_ix] = self._init_rows(init_ids)
        gslots = np.array(
            [self._global_slot(s, slot) for s, _i, slot in assign],
            np.int64,
        )
        self._push(gslots, vals, svals)

    def _write_back(self, evict) -> None:
        gslots = torch.tensor(
            [self._global_slot(s, slot) for s, _i, slot in evict],
            dtype=torch.int64).to(self.device)
        rows = self._cache.index_select(0, gslots).cpu().numpy()
        srows = [st.index_select(0, gslots).cpu().numpy()
                 for st in self._state]
        for j, (s, i, _slot) in enumerate(evict):
            self._spill[s][i] = (
                rows[j].copy(),
                *(sr[j].copy() for sr in srows),
            )

    def _push(self, gslots, vals, svals) -> None:
        idx = torch.from_numpy(gslots).to(self.device)
        self._cache.index_copy_(0, idx, torch.from_numpy(vals).to(
            self.device))
        for st, sv in zip(self._state, svals):
            st.index_copy_(0, idx, torch.from_numpy(sv).to(self.device))

    # ---- the data path ----
    def _slots_for(self, flat_ids: np.ndarray) -> np.ndarray:
        shards = self.owners(flat_ids)
        out = np.empty(len(flat_ids), np.int64)
        for j, (i, s) in enumerate(
            zip(flat_ids.tolist(), shards.tolist())
        ):
            out[j] = self._global_slot(s, self._slot_of[s][i])
        return out

    def lookup(self, ids):
        """ids: int array, any shape, values in [0, rows_total).
        Returns [*ids.shape, D] on the table's device."""
        ids = np.asarray(ids, np.int64)
        flat = ids.reshape(-1)
        uids, inv = np.unique(flat, return_inverse=True)
        self.ensure_resident(uids)
        if self.mesh is None:
            slots = torch.from_numpy(self._slots_for(uids)[inv.reshape(-1)])
            out = self._cache.index_select(0, slots.to(self.device))
            return out.reshape(ids.shape + (self.config.dim,))
        # this rank's rows, 0 for ids another rank owns, summed over the
        # axis
        own = self._owned(uids)[inv.reshape(-1)]
        out = torch.zeros((len(flat), self.config.dim), dtype=torch.float32,
                          device=self.device)
        if own.any():
            slots = torch.from_numpy(self._slots_for(flat[own]))
            out[torch.from_numpy(np.flatnonzero(own)).to(self.device)] = \
                self._cache.index_select(0, slots.to(self.device))
        out = self._axis_sum(out)
        return out.reshape(ids.shape + (self.config.dim,))

    def update(self, ids, grads):
        """One sparse optimizer step: per-occurrence grads [N, D]
        (numpy or a tensor) are summed per touched row and applied via
        `update_fn` (B9 on the card). More than `num_slots` unique rows
        in one batch raises — a sharded trainer must never silently
        drop gradient."""
        ids = np.asarray(ids, np.int64).reshape(-1)
        grads = torch.as_tensor(grads, dtype=torch.float32).to(
            self.device).reshape(len(ids), self.config.dim)
        uids, inv = np.unique(ids, return_inverse=True)
        k = self.config.num_slots
        if len(uids) > k:
            raise ValueError(
                f"{len(uids)} unique ids in one step > num_slots {k}"
            )
        self.ensure_resident(uids)
        own = self._owned(uids)[inv.reshape(-1)]
        if own.all():
            slots = torch.from_numpy(self._slots_for(uids)[inv.reshape(-1)])
        else:
            # this rank's rows: the occurrences of the ids it owns
            slots = torch.from_numpy(self._slots_for(ids[own]))
            grads = grads[torch.from_numpy(np.flatnonzero(own)).to(
                self.device)]
        if len(slots):
            _rows.sparse_rows(self.update_fn, [self._cache, *self._state],
                              slots.to(self.device), grads.contiguous(), k,
                              self._S)
        self.stats["steps"] += 1

    # ---- introspection ----
    @property
    def rows_materialized(self) -> int:
        """Distinct rows this table has ever touched (resident +
        spilled; on a mesh, this rank's shards')."""
        return sum(len(d) for d in self._slot_of) + sum(
            len(sp) for sp in self._spill
        )

    def resident_ids(self, shard: int) -> list:
        return list(self._slot_of[shard])

    # ---- checkpointing ----
    def export_shards(self) -> list:
        """One payload dict per shard, each self-contained: resident
        ids in LRU order (oldest first) with their slots + rows +
        optimizer slots, and the spill store. Bytes are COPIED. On a
        mesh every rank returns every shard's (gathered over the
        axis)."""
        local = self.export_local()
        if self.mesh is None:
            return [local[s] for s in range(self.num_shards)]
        import torch.distributed as dist

        parts = [None] * self.mesh.axis_size(self.axis)
        dist.all_gather_object(parts, local,
                               group=self.mesh.group(self.axis))
        merged = {s: p for part in parts for s, p in part.items()}
        return [merged[s] for s in range(self.num_shards)]

    def export_local(self) -> dict:
        """{shard: payload} of this rank's shards."""
        C, D = self.config.capacity, self.config.dim
        cache = self._cache.cpu().numpy().copy()
        state = [st.cpu().numpy().copy() for st in self._state]
        out = {}
        for s in self.local_shards:
            d = self._slot_of[s]
            rids = np.fromiter(d.keys(), np.int64, len(d))
            slots = np.fromiter(d.values(), np.int32, len(d))
            g = self._pos[s] * C + slots
            payload = {
                "ids": rids,
                "slots": slots,
                "rows": cache[g] if len(d) else
                np.zeros((0, D), np.float32),
            }
            for t, st in enumerate(state):
                payload[f"state{t}"] = (
                    st[g] if len(d) else np.zeros((0, D), np.float32)
                )
            sp = self._spill[s]
            sids = np.fromiter(sp.keys(), np.int64, len(sp))
            payload["spill_ids"] = sids
            payload["spill_rows"] = (
                np.stack([sp[i][0] for i in sids.tolist()])
                if len(sp) else np.zeros((0, D), np.float32)
            )
            for t in range(self.num_state):
                payload[f"spill_state{t}"] = (
                    np.stack([sp[i][1 + t] for i in sids.tolist()])
                    if len(sp) else np.zeros((0, D), np.float32)
                )
            out[s] = payload
        return out

    def table_meta(self) -> dict:
        """Config echo for a checkpoint manifest."""
        return {
            "rows_total": self.config.rows_total,
            "dim": self.config.dim,
            "capacity": self.config.capacity,
            "num_shards": self.num_shards,
            "num_state": self.num_state,
            "placement": self.config.placement,
        }

    def restore_shards(self, payloads) -> None:
        """Rebuild residency + device buffers from `export_shards`
        payloads (every shard's; on a mesh each rank keeps its own).
        LRU order, slot assignment, optimizer slots and the spill store
        all come back exactly."""
        if len(payloads) != self.num_shards:
            raise ValueError(
                f"{len(payloads)} shard payloads for "
                f"{self.num_shards} shards"
            )
        C, D = self.config.capacity, self.config.dim
        cache = np.zeros((self._S, D), np.float32)
        state = [np.zeros((self._S, D), np.float32)
                 for _ in range(self.num_state)]
        self._slot_of = [OrderedDict() for _ in range(self.num_shards)]
        self._free = [list(range(C - 1, -1, -1))
                      for _ in range(self.num_shards)]
        self._spill = [dict() for _ in range(self.num_shards)]
        for s, p in enumerate(payloads):
            if s not in self._pos:
                continue
            base = self._pos[s] * C
            rids = np.asarray(p["ids"], np.int64)
            slots = np.asarray(p["slots"], np.int32)
            rows = np.asarray(p["rows"], np.float32)
            used = set()
            for j, (i, slot) in enumerate(
                zip(rids.tolist(), slots.tolist())
            ):
                self._slot_of[s][i] = slot
                used.add(slot)
                cache[base + slot] = rows[j]
                for t in range(self.num_state):
                    state[t][base + slot] = np.asarray(
                        p[f"state{t}"], np.float32
                    )[j]
            self._free[s] = [sl for sl in range(C - 1, -1, -1)
                             if sl not in used]
            sids = np.asarray(p["spill_ids"], np.int64)
            srows = np.asarray(p["spill_rows"], np.float32)
            sstate = [
                np.asarray(p[f"spill_state{t}"], np.float32)
                for t in range(self.num_state)
            ]
            for j, i in enumerate(sids.tolist()):
                self._spill[s][i] = (
                    srows[j].copy(),
                    *(ss[j].copy() for ss in sstate),
                )
        self._cache = torch.from_numpy(cache).to(self.device)
        self._state = tuple(torch.from_numpy(st).to(self.device)
                            for st in state)
