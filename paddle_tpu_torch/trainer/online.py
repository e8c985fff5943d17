"""Online sparse-CTR training over a ShardedEmbeddingTable: the
training half of the traffic -> trainer ->
checkpoint -> `FleetRouter.rollout()` loop, plus the
commit-acknowledged ledger that makes SIGKILL elasticity exact.

The model is the smallest honest CTR learner: logistic regression
whose per-feature weight is column 0 of the feature id's embedding
row. `click logit = sum_j table[id_j][0]`. Traffic is deterministic
(splitmix64 streams keyed by seed + batch index), so every
incarnation of a killed worker regenerates byte-identical batches —
what makes "zero batches lost or retrained" a checkable ledger
property instead of a vibe.

The ledger contract (the elastic robustness core):

- A batch b counts as TRAINED only when the sharded-table generation
  recording the state AFTER b has durably committed (manifest +
  every shard sha256-verified on disk). `poll_acks()` surfaces
  commits in order; the worker appends `{"trained": b}` to its
  ledger only then.
- Generations are written asynchronously (AsyncCheckpointer
  .save_table), so at SIGKILL some batches are computed but
  unacknowledged. The respawned rank recovers via `resume()` —
  quarantine-and-rebuild to the last good generation — and re-runs
  exactly the unacknowledged suffix. Re-running unacknowledged work
  is not retraining, the same way the fleet's re-routed
  un-acknowledged request is not a lost request.
- A commit can land without its ledger line (killed between fsync
  and append). `reconcile()` closes that window: acked-but-unlogged
  batches are derived from the recovered generation's meta and
  acknowledged as `reconciled` — from the durable manifest, never
  from re-execution.

Together: across any number of SIGKILLs, the union of ledger lines
is every batch EXACTLY once.

The port of `paddle_tpu/trainer/online.py` over the port's
`ShardedEmbeddingTable` (its buffers on the card; `train_step`'s
`table.update` is B9 there) and `AsyncCheckpointer.save_table`: the
same traffic, the same payloads, the same ledger.
"""

from __future__ import annotations

from collections import deque

import numpy as np

from paddle_tpu_torch.parallel.sparse_shard import (
    ShardedEmbeddingTable, _mix64,
)
from paddle_tpu_torch.trainer import async_checkpoint as _ac


def _unit(x) -> np.ndarray:
    """uint64 hash stream -> f64 uniform in [0, 1)."""
    return (_mix64(x) >> np.uint64(11)).astype(np.float64) * 2.0**-53


def true_weight(ids, scale: float = 0.9) -> np.ndarray:
    """The ground-truth per-id CTR weight the trainer must recover:
    deterministic +-scale keyed on the id hash."""
    ids = np.asarray(ids, np.uint64)
    sign = (_mix64(ids) & np.uint64(1)).astype(np.float64) * 2.0 - 1.0
    return sign * scale


def make_batch(seed: int, batch_index: int, batch_size: int,
               feats: int, hot_ids: np.ndarray) -> tuple:
    """Deterministic CTR batch `batch_index`: ids drawn from the hot
    set, labels Bernoulli(sigmoid(sum of true weights)) with a
    deterministic uniform draw. Same (seed, index) -> same batch on
    every incarnation."""
    hot_ids = np.asarray(hot_ids, np.int64)
    base = (np.uint64(seed) * np.uint64(0x51ED2701)
            + np.uint64(batch_index) * np.uint64(batch_size * feats + 1))
    draw = _mix64(base + np.arange(batch_size * feats, dtype=np.uint64))
    ids = hot_ids[(draw % np.uint64(len(hot_ids))).astype(np.int64)]
    ids = ids.reshape(batch_size, feats)
    logits = true_weight(ids).sum(axis=1)
    u = _unit(base + np.uint64(0xC0FFEE)
              + np.arange(batch_size, dtype=np.uint64))
    labels = (u < 1.0 / (1.0 + np.exp(-logits))).astype(np.float64)
    return ids, labels


def hot_id_set(seed: int, count: int, rows_total: int) -> np.ndarray:
    """The traffic's hot vocabulary: `count` distinct ids scattered
    across the FULL [0, rows_total) space (deterministic), so a
    100M–1B-row table is exercised end to end while only the hot set
    ever materializes."""
    draw = _mix64(np.uint64(seed) * np.uint64(0xABCD1234)
                  + np.arange(count * 2, dtype=np.uint64))
    ids = np.unique((draw % np.uint64(rows_total)).astype(np.int64))
    return ids[:count]


def predict_logits(table: ShardedEmbeddingTable, ids) -> np.ndarray:
    """[B, F] ids -> [B] click logits (column 0 of each row)."""
    emb = table.lookup(ids)[..., 0].cpu().numpy()
    return emb.sum(axis=-1)


def weights_from_payloads(payloads) -> dict:
    """Flatten exported shard payloads (resident + spill) into the
    {feature id -> weight} map a serving replica scores with — the
    hot-swap artifact `FleetRouter.rollout()` points replicas at."""
    w = {}
    for p in payloads:
        for key_ids, key_rows in (("ids", "rows"),
                                  ("spill_ids", "spill_rows")):
            ids = np.asarray(p[key_ids]).tolist()
            rows = np.asarray(p[key_rows])
            for j, i in enumerate(ids):
                w[int(i)] = float(rows[j, 0])
    return w


def logloss(p: np.ndarray, y: np.ndarray) -> float:
    p = np.clip(np.asarray(p, np.float64), 1e-7, 1.0 - 1e-7)
    y = np.asarray(y, np.float64)
    return float(-(y * np.log(p) + (1 - y) * np.log(1 - p)).mean())


class OnlineCTRTrainer:
    """Glue: ShardedEmbeddingTable + async table generations + the
    commit-acknowledged ledger. Drives both the subprocess elastic
    worker (testing_faults.SHARDED_CTR_TRAINER_SRC) and the in-test
    online-learning loop."""

    def __init__(self, table: ShardedEmbeddingTable, save_dir: str,
                 checkpointer: _ac.AsyncCheckpointer = None):
        self.table = table
        self.save_dir = save_dir
        self.ckpt = checkpointer or _ac.AsyncCheckpointer(
            save_dir, queue_depth=4
        )
        self._pending = deque()  # (generation, meta) awaiting commit

    # ---- training ----
    def train_step(self, ids, labels) -> float:
        """One logistic SGD step on [B, F] ids / [B] labels; returns
        the pre-update logloss. d(loss)/d(logit) = p - y lands on
        column 0 of every occurrence's row; the table's update_fn
        owns the learning rate."""
        ids = np.asarray(ids, np.int64)
        labels = np.asarray(labels, np.float64)
        logits = predict_logits(self.table, ids)
        p = 1.0 / (1.0 + np.exp(-logits))
        g = ((p - labels) / len(labels)).astype(np.float32)
        grads = np.zeros(
            (ids.size, self.table.config.dim), np.float32
        )
        grads[:, 0] = np.repeat(g, ids.shape[1])
        self.table.update(ids.reshape(-1), grads)
        return logloss(p, labels)

    # ---- generations + ledger ----
    def save_generation(self, generation: int, next_batch: int,
                        extra_meta: dict = None) -> None:
        """Enqueue the async write of the state-after-batch
        `next_batch - 1` generation and remember it as pending (to be
        acknowledged only once committed)."""
        meta = {"next_batch": int(next_batch),
                **self.table.table_meta(), **(extra_meta or {})}
        self.ckpt.save_table(generation,
                             self.table.export_shards(), meta=meta)
        self._pending.append((generation, meta))

    def poll_acks(self) -> list:
        """Generations (in order) that have durably committed since
        the last poll — the moment their batches become TRAINED in
        the ledger. Non-blocking: in-flight writes stay pending."""
        out = []
        while self._pending:
            gen, meta = self._pending[0]
            ok, _ = _ac.verify_table_generation(self.save_dir, gen)
            if not ok:
                break
            self._pending.popleft()
            out.append((gen, meta))
        return out

    def drain(self) -> list:
        """Block until every enqueued generation committed (surface
        writer errors), then ack them all."""
        self.ckpt.wait()
        return self.poll_acks()

    def resume(self) -> tuple:
        """Quarantine-and-rebuild recovery: torn generations newer
        than the last good one are moved aside (reason names the
        shard), the table is restored from the last good generation.
        Returns (generation, meta, quarantined) — generation -1 on a
        cold start (fresh table untouched)."""
        gen, payloads, meta, quarantined = _ac.recover_table(
            self.save_dir
        )
        if gen >= 0:
            if int(meta.get("num_shards",
                            self.table.num_shards)) != \
                    self.table.num_shards:
                raise ValueError(
                    f"generation has {meta.get('num_shards')} table "
                    f"shards; this mesh has {self.table.num_shards}"
                )
            self.table.restore_shards(payloads)
        return gen, meta, quarantined

    def close(self):
        self.ckpt.close()
