"""The port's sharded embedding tier (`paddle_tpu_torch/parallel/
sparse_shard.py`) against `paddle_tpu/parallel/sparse_shard.py`, on the
CPU.

The JAX table runs on the 8-device CPU mesh (`make_mesh({MODEL_AXIS:
8})`, as `tests/test_sparse_shard.py`); the port's table holds the same
8 logical shards in one cache on one device (`device="cpu"`, the B9
plain version). On the same stream of lookups and updates (numpy seeds):

- lookups and the table after updates, range and hash placement, SGD
  and adagrad (with its slot buffer), within rtol 1e-5 / atol 1e-6;
- eviction and the rebuild from spill, with the same hits, misses and
  evictions;
- `export_shards` payloads equal array for array (ids, slots, spill ids
  exactly; rows and slots within the tolerance);
- JAX payloads restored into the port give the same lookups, and come
  back equal from the port's `export_shards`;
- the buffer shapes and the kernel launches of a step are the same at
  rows_total 2^20 and 2^30 (V-independence).
"""

import numpy as np
import pytest
import torch

try:  # the CPU parity tests need JAX
    from paddle_tpu.core.mesh import MODEL_AXIS, make_mesh
    from paddle_tpu.parallel import sparse_shard as jss
except ImportError:
    jss = None

from paddle_tpu_torch.ops import sparse_rows as rows_op
from paddle_tpu_torch.parallel import sparse_shard as tss

pytestmark = pytest.mark.skipif(jss is None, reason="needs JAX (CPU parity)")
RTOL, ATOL = 1e-5, 1e-6
SHARDS = 8


@pytest.fixture(scope="module")
def mesh():
    return make_mesh({MODEL_AXIS: SHARDS})


def _tables(mesh, rows_total=1 << 30, dim=4, capacity=16, num_slots=12,
            placement="range", init_scale=0.02, seed=3, lr=0.5,
            adagrad=False):
    kw = dict(rows_total=rows_total, dim=dim, capacity=capacity,
              num_slots=num_slots, placement=placement,
              init_scale=init_scale, seed=seed)
    n_state = 1 if adagrad else 0
    j = jss.ShardedEmbeddingTable(
        jss.ShardedTableConfig(**kw), mesh=mesh,
        update_fn=(jss.adagrad_row_update(lr) if adagrad
                   else jss.sgd_row_update(lr)), num_state=n_state)
    t = tss.ShardedEmbeddingTable(
        tss.ShardedTableConfig(**kw), num_shards=SHARDS,
        update_fn=(tss.adagrad_row_update(lr) if adagrad
                   else tss.sgd_row_update(lr)), num_state=n_state,
        device="cpu")
    return j, t


def _assert_payloads_equal(tp, jp):
    assert len(tp) == len(jp)
    for a, b in zip(tp, jp):
        assert sorted(a) == sorted(b)
        for key in ("ids", "slots", "spill_ids"):
            np.testing.assert_array_equal(a[key], np.asarray(b[key]))
        for key in a:
            if key not in ("ids", "slots", "spill_ids"):
                np.testing.assert_allclose(a[key], np.asarray(b[key]),
                                           rtol=RTOL, atol=ATOL)


def _stream(j, t, rng, vocab, steps, shape=(2, 3)):
    """Lookup then update, `steps` times; the stats counted on the way
    agree (a restored table starts its own)."""
    before = dict(j.stats)
    for _ in range(steps):
        ids = rng.choice(vocab, size=shape).astype(np.int64)
        np.testing.assert_allclose(t.lookup(ids).numpy(),
                                   np.asarray(j.lookup(ids)), rtol=RTOL,
                                   atol=ATOL)
        grads = rng.standard_normal((ids.size, j.config.dim)).astype(
            np.float32)
        j.update(ids.reshape(-1), grads)
        t.update(ids.reshape(-1), grads)
    assert t.stats == {k: j.stats[k] - before[k] for k in j.stats}


@pytest.mark.parametrize("placement", ["range", "hash"])
@pytest.mark.parametrize("adagrad", [False, True])
def test_lookup_and_update_match_jax(mesh, placement, adagrad):
    j, t = _tables(mesh, rows_total=1 << 24, placement=placement,
                   adagrad=adagrad, lr=0.5 if not adagrad else 0.1)
    rng = np.random.default_rng(0)
    vocab = rng.integers(0, 1 << 24, 32)
    _stream(j, t, rng, vocab, 6)
    _assert_payloads_equal(t.export_shards(), j.export_shards())


@pytest.mark.parametrize("adagrad", [False, True])
def test_eviction_and_rebuild_from_spill_match_jax(mesh, adagrad):
    """A 4-row cache per shard under churn: rows are evicted to spill,
    touched again and rebuilt — value and adagrad slot — as in the JAX
    table."""
    j, t = _tables(mesh, capacity=4, num_slots=4, placement="hash",
                   adagrad=adagrad, lr=1.0 if not adagrad else 0.1)
    ids = np.arange(80, dtype=np.int64) * 7919
    for a in (j, t):
        a.update(ids[:4], np.ones((4, 4), np.float32))
        for k in range(4, 80, 4):
            a.lookup(ids[k:k + 4])
    assert t.stats == j.stats and t.stats["evictions"] > 0
    _assert_payloads_equal(t.export_shards(), j.export_shards())
    for a in (j, t):
        a.update(ids[:4], np.ones((4, 4), np.float32))
    np.testing.assert_allclose(t.lookup(ids[:4]).numpy(),
                               np.asarray(j.lookup(ids[:4])), rtol=RTOL,
                               atol=ATOL)
    assert t.rows_materialized == j.rows_materialized
    assert [t.resident_ids(s) for s in range(SHARDS)] == [
        j.resident_ids(s) for s in range(SHARDS)]


def test_jax_payloads_restore_into_the_port(mesh):
    """JAX `export_shards` payloads go into the port's `restore_shards`
    and give the same lookups, and come back equal from the port's
    `export_shards`; both tables then train on alike."""
    j, t = _tables(mesh, capacity=4, num_slots=4, placement="hash",
                   adagrad=True, lr=0.1)
    rng = np.random.default_rng(4)
    vocab = rng.integers(0, 1 << 30, 40)
    for _ in range(10):
        ids = rng.choice(vocab, 4, replace=False).astype(np.int64)
        j.update(ids, rng.standard_normal((4, 4)).astype(np.float32))
    payloads = j.export_shards()
    t.restore_shards(payloads)
    _assert_payloads_equal(t.export_shards(), payloads)
    assert t.table_meta() == j.table_meta()
    _stream(j, t, rng, vocab, 5, shape=(4,))
    _assert_payloads_equal(t.export_shards(), j.export_shards())


def test_config_and_placement_match_jax(mesh):
    j, t = _tables(mesh, rows_total=1 << 30, placement="hash")
    ids = np.arange(256, dtype=np.int64) * 104729
    np.testing.assert_array_equal(t.owners(ids), j.owners(ids))
    np.testing.assert_array_equal(t._init_rows(ids), j._init_rows(ids))
    j, t = _tables(mesh, rows_total=1000)
    np.testing.assert_array_equal(t.owners(np.arange(1000)),
                                  j.owners(np.arange(1000)))
    with pytest.raises(ValueError, match="num_slots"):
        tss.ShardedTableConfig(rows_total=8, dim=2, capacity=4, num_slots=5)
    with pytest.raises(ValueError, match="ids must lie in"):
        t.lookup(np.array([1000], np.int64))
    with pytest.raises(ValueError, match="num_slots"):
        t.update(np.arange(13, dtype=np.int64), np.zeros((13, 4), np.float32))
    with pytest.raises(ValueError, match="shard"):
        t.restore_shards(t.export_shards()[:-1])


def test_buffers_and_launches_do_not_depend_on_rows_total(mesh,
                                                        monkeypatch):
    """V-independence: a 2^20-row and a 2^30-row table hold buffers of
    one shape, and a step runs the same launches (counted through the
    kernels' route, here the plain version's calls)."""
    calls = []
    plain = rows_op.sparse_rows_plain

    def counted(*args):
        calls.append(tuple(a.shape for a in args[1]))
        return plain(*args)

    monkeypatch.setattr(rows_op, "sparse_rows_plain", counted)
    shapes, launches = [], []
    ids = np.arange(6, dtype=np.int64).reshape(2, 3) * 7919
    for rows_total in (1 << 30, 1 << 20):
        _j, t = _tables(mesh, rows_total=rows_total, adagrad=True)
        calls.clear()
        t.lookup(ids)
        t.update(ids.reshape(-1), np.ones((6, 4), np.float32))
        shapes.append([tuple(t._cache.shape)]
                      + [tuple(s.shape) for s in t._state])
        launches.append(list(calls))
    assert shapes[0] == shapes[1] == [(SHARDS * 16, 4)] * 2
    assert launches[0] == launches[1] and len(launches[0]) == 1
    assert t.rows_materialized == 6


def test_rules_memoized():
    assert tss.sgd_row_update(0.5) is tss.sgd_row_update(0.5)
    assert tss.adagrad_row_update(0.1) is tss.adagrad_row_update(0.1)
    assert tss.sgd_row_update(0.5) is not tss.sgd_row_update(0.25)
    assert tss.momentum_row_update(0.01, 0.9) is not tss.momentum_row_update(
        0.01, 0.8)


def test_lookup_returns_a_tensor_on_the_table_device(mesh):
    _j, t = _tables(mesh)
    out = t.lookup(np.arange(6).reshape(2, 3))
    assert isinstance(out, torch.Tensor) and out.device.type == "cpu"
    assert tuple(out.shape) == (2, 3, 4)
