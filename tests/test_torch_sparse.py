"""The port's row-sparse updates (`paddle_tpu_torch/parallel/sparse.py`,
`ops/sparse_rows.py`) against `paddle_tpu/parallel/sparse.py`, on the
CPU.

The same numpy inputs (numpy seeds) go through the JAX functions —
`SparseUpdater` in Pallas interpret mode off a TPU, as
`test_parallel_tp_sp.py` runs it — and through the port, whose CPU
tensors take the kernels' plain version (`sparse_rows_plain`):

- `touched_rows`, `apply_rows`, `_unique_segment_grads` and
  `sparse_apply`: duplicates, a momentum slot, the row-0 alias (row 0
  bit-identical), overflow (the k smallest ids survive) and ids >= V;
- `SparseUpdater` with the SGD, momentum and adagrad rules and a lambda,
  overflow, ids >= V, `run_steps` against sequential steps, `place` /
  `unplace` round trips (a JAX-placed table carried over), and the
  placed tensors updated in place (same `data_ptr`).

Tolerance rtol 1e-5, atol 1e-6 (the JAX tests' own); untouched rows
`assert_array_equal`. `TestOnCard` (marked `cuda`) holds the B9 kernels
(`csrc/sparse_rows.cu`) against the plain version on the card; it skips
here. On a machine with an H100 and no JAX: `python -m pytest
--noconftest -m cuda tests/test_torch_sparse.py`.
"""

import numpy as np
import pytest
import torch

try:  # the CPU parity tests need JAX; the on-card tests do not
    import jax.numpy as jnp

    from paddle_tpu.parallel import sparse as jsp
    from paddle_tpu.parallel import sparse_shard as jss
except ImportError:
    jnp = None

from paddle_tpu_torch.ops import sparse_rows as rows_op
from paddle_tpu_torch.parallel import sparse as tsp
from paddle_tpu_torch.parallel import sparse_shard as tss

RTOL, ATOL = 1e-5, 1e-6
needs_jax = pytest.mark.skipif(jnp is None, reason="needs JAX (CPU parity)")


def _momentum(p, g, m):
    m2 = 0.9 * m + g
    return p - 0.01 * m2, m2


def _lambda_state(p, g, m):
    return p * 0.99 - 0.1 * (m + g), m * 0.5 + g


def _lambda(p, g):
    return p * 0.99 - 0.25 * g


# name: (JAX update_fn, port update_fn, number of slot tables)
RULES = {
    "sgd": (lambda: jss.sgd_row_update(0.5),
            lambda: tss.sgd_row_update(0.5), 0),
    "momentum": (lambda: _momentum,
                 lambda: tss.momentum_row_update(0.01, 0.9), 1),
    "adagrad": (lambda: jss.adagrad_row_update(0.1),
                lambda: tss.adagrad_row_update(0.1), 1),
    "lambda": (lambda: _lambda, lambda: _lambda, 0),
    "lambda_state": (lambda: _lambda_state, lambda: _lambda_state, 1),
}


def _inputs(seed, v, d, n, n_state, id_high=None):
    rng = np.random.default_rng(seed)
    p0 = rng.standard_normal((v, d)).astype(np.float32)
    s0 = [np.abs(rng.standard_normal((v, d))).astype(np.float32)
          for _ in range(n_state)]
    ids = rng.integers(0, id_high or v, n).astype(np.int32)
    grads = rng.standard_normal((n, d)).astype(np.float32)
    return p0, s0, ids, grads


def _assert_untouched(got, start, touched):
    rest = [i for i in range(start.shape[0]) if i not in touched]
    np.testing.assert_array_equal(got[rest], start[rest])


# ---- the functional pieces ------------------------------------------------

@needs_jax
def test_touched_rows_and_apply_rows_match_jax():
    p0, _s, ids, grads = _inputs(0, 20, 3, 12, 0)
    jt = np.asarray(jsp.touched_rows(jnp.asarray(ids), 20))
    tt = tsp.touched_rows(torch.from_numpy(ids), 20).numpy()
    np.testing.assert_array_equal(tt, jt)
    dense = np.zeros_like(p0)
    np.add.at(dense, ids, grads)
    want = jsp.apply_rows(lambda p, g: p - 0.1 * g, jnp.asarray(p0),
                          jnp.asarray(dense), jnp.asarray(jt))
    got = tsp.apply_rows(lambda p, g: p - 0.1 * g, torch.from_numpy(p0),
                         torch.from_numpy(dense), torch.from_numpy(tt))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=RTOL,
                               atol=ATOL)
    _assert_untouched(got.numpy(), p0, set(ids.tolist()))


@needs_jax
@pytest.mark.parametrize("k", [16, 9, 4, 30])
def test_unique_segment_grads_matches_jax(k):
    """Duplicates summed into sorted slots, -1 fills at the end; with k
    below the unique count the k smallest survive and the dropped ids'
    gradients land nowhere."""
    ids = np.asarray([7, 3, 7, 11, 3, 3, 40, 2, 19, 5, 7, 23, 8, 2, 31, 6],
                     np.int32)
    grads = np.random.default_rng(1).standard_normal((16, 5)).astype(
        np.float32)
    ju, jg = jsp._unique_segment_grads(jnp.asarray(ids), jnp.asarray(grads),
                                       k)
    tu, tg = tsp._unique_segment_grads(torch.from_numpy(ids),
                                       torch.from_numpy(grads), k)
    np.testing.assert_array_equal(tu.numpy(), np.asarray(ju))
    np.testing.assert_allclose(tg.numpy(), np.asarray(jg), rtol=RTOL,
                               atol=ATOL)


def test_prepare_offsets_and_slots():
    """The kernels' preparation: uids ascending with -1 fills last, each
    slot's run of the stable sort at off[i] .. off[i+1], and the dropped
    ids' occurrences past off[k]."""
    ids = torch.tensor([9, 4, 9, 1, 4, 9, 12], dtype=torch.int64)
    uids, perm, off, slot = rows_op.prepare(ids, 3)
    assert uids.tolist() == [1, 4, 9]
    assert perm.tolist() == [3, 1, 4, 0, 2, 5, 6]
    assert off.tolist() == [0, 1, 3, 6]
    assert slot.tolist() == [2, 1, 2, 0, 1, 2, 3]
    uids, _perm, off, _slot = rows_op.prepare(ids, 6)
    assert uids.tolist() == [1, 4, 9, 12, -1, -1]
    assert off.tolist() == [0, 1, 3, 6, 7, 7, 7]


SPARSE_APPLY_CASES = {
    # name: (V, ids, num_slots, number of slot tables)
    "duplicates": (50, [3, 7, 3, 49, 7, 7], None, 0),
    "momentum": (30, [5, 5, 12], None, 1),
    "row0_alias": (10, [4], 5, 0),
    "overflow": (40, [10, 20, 30, 35, 5, 15], 4, 1),
    "ids_past_v": (12, [3, 12, 15, 3, 11], None, 1),
}


@needs_jax
@pytest.mark.parametrize("case", sorted(SPARSE_APPLY_CASES))
def test_sparse_apply_matches_jax(case):
    v, ids, k, n_state = SPARSE_APPLY_CASES[case]
    d = 4
    rng = np.random.default_rng(2)
    p0 = rng.standard_normal((v, d)).astype(np.float32)
    s0 = [rng.standard_normal((v, d)).astype(np.float32)
          for _ in range(n_state)]
    ids = np.asarray(ids, np.int32)
    grads = rng.standard_normal((len(ids), d)).astype(np.float32)
    fn = _momentum if n_state else (lambda p, g: p - 0.1 * g)
    jp, js = jsp.sparse_apply(fn, jnp.asarray(p0), jnp.asarray(ids),
                              jnp.asarray(grads),
                              state=tuple(jnp.asarray(s) for s in s0),
                              num_slots=k)
    tp, ts = tsp.sparse_apply(fn, torch.from_numpy(p0),
                              torch.from_numpy(ids), torch.from_numpy(grads),
                              state=tuple(torch.from_numpy(s) for s in s0),
                              num_slots=k)
    np.testing.assert_allclose(tp.numpy(), np.asarray(jp), rtol=RTOL,
                               atol=ATOL)
    for a, b in zip(ts, js):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=RTOL,
                                   atol=ATOL)
    kept = sorted(set(ids.tolist()))[:k or len(ids)]
    touched = {i for i in kept if i < v}
    _assert_untouched(tp.numpy(), p0, touched)
    for a, s in zip(ts, s0):
        _assert_untouched(a.numpy(), s, touched)
    if case == "row0_alias":
        np.testing.assert_array_equal(tp.numpy()[0], p0[0])


def test_sparse_apply_leaves_its_inputs():
    p0, _s, ids, grads = _inputs(3, 16, 4, 10, 0)
    param = torch.from_numpy(p0.copy())
    tsp.sparse_apply(lambda p, g: p - g, param, torch.from_numpy(ids),
                     torch.from_numpy(grads))
    np.testing.assert_array_equal(param.numpy(), p0)


def test_embedding_lookup_raises_naming_a8():
    """The mesh (ROADMAP A8) is ported: the lookup no longer raises. On a
    one-rank mesh the row-sharded lookup is the table's rows (the
    multi-rank program against JAX's: tests/test_torch_mesh_sparse.py)."""
    from paddle_tpu_torch.core.mesh import make_mesh

    table = torch.arange(8.0).reshape(4, 2)
    ids = torch.tensor([3, 0, 3])
    out = tsp.embedding_lookup(table, ids, make_mesh({"model": 1}))
    assert torch.equal(out, table[ids])


# ---- SparseUpdater ------------------------------------------------------

def _jax_updater(fn, p0, s0, ids_seq, grads_seq, num_slots=None):
    u = jsp.SparseUpdater(fn, num_slots=num_slots)
    param, state = u.place(p0), tuple(u.place(s) for s in s0)
    for ids, grads in zip(ids_seq, grads_seq):
        param, state = u(param, jnp.asarray(ids), jnp.asarray(grads), state)
    return u.unplace(param), [u.unplace(s) for s in state]


def _port_updater(fn, p0, s0, ids_seq, grads_seq, num_slots=None):
    u = tsp.SparseUpdater(fn, num_slots=num_slots)
    param = u.place(p0, device="cpu")
    state = tuple(u.place(s, device="cpu") for s in s0)
    for ids, grads in zip(ids_seq, grads_seq):
        param, state = u(param, ids, grads, state)
    return u.unplace(param), [u.unplace(s) for s in state]


@needs_jax
@pytest.mark.parametrize("rule", sorted(RULES))
def test_sparse_updater_rules_match_jax(rule):
    jfn, tfn, n_state = RULES[rule]
    v, d, n, steps = 60, 8, 24, 3
    p0, s0, _ids, _g = _inputs(4, v, d, n, n_state)
    rng = np.random.default_rng(5)
    ids_seq = rng.integers(0, v, (steps, n)).astype(np.int32)
    grads_seq = rng.standard_normal((steps, n, d)).astype(np.float32)
    jp, js = _jax_updater(jfn(), p0, s0, ids_seq, grads_seq)
    tp, ts = _port_updater(tfn(), p0, s0, ids_seq, grads_seq)
    np.testing.assert_allclose(tp, jp, rtol=RTOL, atol=ATOL)
    for a, b in zip(ts, js):
        np.testing.assert_allclose(a, b, rtol=RTOL, atol=ATOL)
    touched = set(ids_seq.reshape(-1).tolist())
    _assert_untouched(tp, p0, touched)
    for a, s in zip(ts, s0):
        _assert_untouched(a, s, touched)


@needs_jax
def test_sparse_updater_overflow_matches_jax():
    """6 unique ids, 4 slots: the 4 smallest update, the others are
    skipped and every other row is untouched."""
    ids = np.asarray([[10, 20, 30, 35, 5, 15]], np.int32)
    grads = np.ones((1, 6, 4), np.float32)
    p0 = np.zeros((40, 4), np.float32)
    fn = tss.sgd_row_update(1.0)
    jp, _ = _jax_updater(jss.sgd_row_update(1.0), p0, [], ids, grads,
                         num_slots=4)
    tp, _ = _port_updater(fn, p0, [], ids, grads, num_slots=4)
    np.testing.assert_array_equal(tp, jp)
    assert {i for i in range(40) if tp[i].sum() != 0} == {5, 10, 15, 20}
    np.testing.assert_allclose(tp[[5, 10, 15, 20]], -1.0, atol=ATOL)


@needs_jax
def test_sparse_updater_ids_past_the_table():
    """Ids >= V touch no real row (the JAX kernel sends them to the
    scratch row, the port skips them)."""
    v, d = 16, 4
    p0, s0, _i, _g = _inputs(6, v, d, 8, 1)
    ids = np.asarray([[3, 16, 20, 3, 15, 40, 0, 16]], np.int32)
    grads = np.random.default_rng(7).standard_normal((1, 8, d)).astype(
        np.float32)
    jp, js = _jax_updater(_momentum, p0, s0, ids, grads)
    tp, ts = _port_updater(tss.momentum_row_update(0.01, 0.9), p0, s0, ids,
                           grads)
    np.testing.assert_allclose(tp, jp, rtol=RTOL, atol=ATOL)
    np.testing.assert_allclose(ts[0], js[0], rtol=RTOL, atol=ATOL)
    _assert_untouched(tp, p0, {0, 3, 15})
    _assert_untouched(ts[0], s0[0], {0, 3, 15})


@needs_jax
def test_run_steps_matches_sequential_and_jax():
    v, d, n, steps = 96, 8, 24, 4
    p0 = np.random.default_rng(7).standard_normal((v, d)).astype(np.float32)
    m0 = np.zeros((v, d), np.float32)
    rng = np.random.default_rng(8)
    ids_seq = rng.integers(0, v, (steps, n)).astype(np.int32)
    grads_seq = rng.standard_normal((steps, n, d)).astype(np.float32)
    rule = tss.momentum_row_update(0.01, 0.9)
    u = tsp.SparseUpdater(rule)
    pb, mb = u.place(p0, device="cpu"), u.place(m0, device="cpu")
    pb, (mb,) = u.run_steps(pb, torch.from_numpy(ids_seq),
                            torch.from_numpy(grads_seq), (mb,))
    seq_p, seq_s = _port_updater(rule, p0, [m0], ids_seq, grads_seq)
    np.testing.assert_array_equal(u.unplace(pb), seq_p)
    np.testing.assert_array_equal(u.unplace(mb), seq_s[0])
    ju = jsp.SparseUpdater(_momentum)
    jp, jm = ju.place(p0), ju.place(m0)
    jp, (jm,) = ju.run_steps(jp, jnp.asarray(ids_seq),
                             jnp.asarray(grads_seq), (jm,))
    np.testing.assert_allclose(u.unplace(pb), ju.unplace(jp), rtol=RTOL,
                               atol=ATOL)
    np.testing.assert_allclose(u.unplace(mb), ju.unplace(jm), rtol=RTOL,
                               atol=ATOL)


@needs_jax
def test_place_unplace_round_trip():
    """A JAX-placed table, unplaced to numpy, places into the port
    ([V+1, 1, D], zero scratch row V) and comes back equal."""
    p0 = np.random.default_rng(9).standard_normal((33, 5)).astype(
        np.float32)
    carried = jsp.SparseUpdater.unplace(jsp.SparseUpdater(_lambda).place(p0))
    placed = tsp.SparseUpdater.place(carried, device="cpu")
    assert placed.shape == (34, 1, 5) and placed.is_contiguous()
    assert placed.dtype == torch.float32
    np.testing.assert_array_equal(placed[33].numpy(), 0.0)
    np.testing.assert_array_equal(tsp.SparseUpdater.unplace(placed), p0)
    again = tsp.SparseUpdater.place(torch.from_numpy(p0), device="cpu")
    np.testing.assert_array_equal(tsp.SparseUpdater.unplace(again), p0)


@needs_jax
def test_place_takes_float64_as_float32_like_jax():
    """A float64 table (numpy's default) is placed as float32 in both
    packages, with equal values."""
    t64 = np.random.default_rng(12).standard_normal((9, 4))
    for table in (np.zeros((9, 4)), t64):
        jax_placed = jsp.SparseUpdater(_lambda).place(table)
        placed = tsp.SparseUpdater.place(table, device="cpu")
        assert str(jax_placed.dtype) == "float32"
        assert placed.dtype == torch.float32
        np.testing.assert_array_equal(placed.numpy(), np.asarray(jax_placed))
    again = tsp.SparseUpdater.place(torch.from_numpy(t64), device="cpu")
    assert again.dtype == torch.float32


@needs_jax
@pytest.mark.parametrize("rule", ["momentum", "lambda_state"])
def test_sparse_updater_negative_id_matches_jax(rule):
    """A negative id (a padding id) sorts into slot 0 and touches no
    row; every other id is updated (the JAX step sends it to the
    scratch row)."""
    jfn, tfn, n_state = RULES[rule]
    v, d = 24, 4
    p0, s0, _i, _g = _inputs(13, v, d, 8, n_state)
    ids = np.asarray([[5, -7, 3, 23, -7, 11, 0, 5]], np.int32)
    grads = np.random.default_rng(14).standard_normal((1, 8, d)).astype(
        np.float32)
    jp, js = _jax_updater(jfn(), p0, s0, ids, grads)
    tp, ts = _port_updater(tfn(), p0, s0, ids, grads)
    np.testing.assert_allclose(tp, jp, rtol=RTOL, atol=ATOL)
    for a, b in zip(ts, js):
        np.testing.assert_allclose(a, b, rtol=RTOL, atol=ATOL)
    touched = {0, 3, 5, 11, 23}
    assert all(not np.array_equal(tp[i], p0[i]) for i in touched)
    _assert_untouched(tp, p0, touched)
    for a, s in zip(ts, s0):
        _assert_untouched(a, s, touched)


@pytest.mark.parametrize("rule", ["momentum", "lambda_state"])
def test_updates_the_placed_tensors_in_place(rule):
    _jfn, tfn, n_state = RULES[rule]
    p0, s0, ids, grads = _inputs(10, 20, 4, 12, n_state)
    u = tsp.SparseUpdater(tfn())
    param = u.place(p0, device="cpu")
    state = tuple(u.place(s, device="cpu") for s in s0)
    ptrs = [t.data_ptr() for t in (param, *state)]
    new_p, new_s = u(param, ids, grads, state)
    assert new_p is param and all(a is b for a, b in zip(new_s, state))
    assert [t.data_ptr() for t in (new_p, *new_s)] == ptrs
    assert not np.array_equal(u.unplace(param), p0)


def test_rules_carry_their_hyperparameters():
    """Same hyperparameters, same object; the kernel reads name, lr and
    the second hyperparameter; the plain call computes the rule."""
    assert tss.momentum_row_update(0.01, 0.9) is tss.momentum_row_update(
        0.01, 0.9)
    r = tss.adagrad_row_update(0.2, 1e-3)
    assert (r.name, r.lr, r.hyper, r.num_state) == ("adagrad", 0.2, 1e-3, 1)
    p, g, a = (torch.full((2, 3), x) for x in (1.0, 2.0, 0.5))
    new_p, new_a = r(p, g, a)
    np.testing.assert_allclose(new_a.numpy(), 4.5)
    np.testing.assert_allclose(new_p.numpy(), 1 - 0.2 * 2 / np.sqrt(4.501),
                               rtol=1e-6)


def test_kernel_wrapper_refuses_what_the_kernel_does_not_take():
    t = torch.zeros(8, 4)
    ids, g = torch.zeros(3, dtype=torch.int64), torch.zeros(3, 4)
    rule = tss.sgd_row_update(0.1)
    with pytest.raises(ValueError, match="unsupported device"):
        rows_op.sparse_rows_kernel(rule, [t], ids, g, 3, 8)
    with pytest.raises(ValueError, match="contiguous"):
        rows_op.sparse_rows_plain(rule, [torch.zeros(4, 8).t()], ids, g, 3,
                                  8)
    with pytest.raises(ValueError, match="slot tables"):
        rows_op.sparse_rows_plain(tss.momentum_row_update(), [t], ids, g, 3,
                                  8)


# ---- on the card --------------------------------------------------------

ON_CARD = {
    # name: (rule, V, D, N, num_slots, id range)
    "sgd_d64": ("sgd", 4096, 64, 2048, None, 4096),
    "momentum_d64": ("momentum", 4096, 64, 2048, None, 4096),
    "adagrad_d16": ("adagrad", 1000, 16, 700, None, 1000),
    "lambda_state_d128": ("lambda_state", 500, 128, 300, None, 500),
    "lambda_d4": ("lambda", 300, 4, 200, None, 300),
    "overflow_d64": ("momentum", 2000, 64, 1500, 256, 2000),
    "heavy_dup_d64": ("momentum", 4096, 64, 16384, None, 100),
    "ids_past_v_d5": ("adagrad", 200, 5, 400, None, 260),
}


@pytest.mark.cuda
class TestOnCard:
    """B9 against its plain version on the card: max |diff| / max
    |plain| <= 1e-6 on the touched rows and slots (f32, other summation
    order), every other row bit-equal to the start, and the kernel
    bit-identical from run to run."""

    @pytest.fixture(autouse=True)
    def _card(self):
        if not torch.cuda.is_available():
            pytest.skip("needs a CUDA device: the kernels have no CPU mode")

    @pytest.mark.parametrize("case", sorted(ON_CARD))
    def test_kernel_matches_plain(self, case):
        rule, v, d, n, k, high = ON_CARD[case]
        _jfn, tfn, n_state = RULES[rule]
        p0, s0, ids, grads = _inputs(11, v, d, n, n_state, id_high=high)
        start = [torch.from_numpy(a).cuda() for a in (p0, *s0)]
        ids_t = torch.from_numpy(ids).cuda()
        g = torch.from_numpy(grads).cuda()
        slots = k or n
        outs = []
        for _ in range(2):
            tabs = [t.clone() for t in start]
            rows_op.sparse_rows(tfn(), tabs, ids_t, g, slots, v)
            outs.append(tabs)
        plain = [t.clone() for t in start]
        rows_op.sparse_rows_plain(tfn(), plain, ids_t, g, slots, v)
        torch.cuda.synchronize()
        kept = sorted(set(ids.tolist()))[:slots]
        touched = torch.zeros(v, dtype=torch.bool, device="cuda")
        touched[[i for i in kept if i < v]] = True
        for got, again, ref, s in zip(outs[0], outs[1], plain, start):
            assert torch.equal(got, again)
            assert torch.equal(got[~touched], s[~touched])
            scale = ref[touched].abs().max().clamp_min(1e-30)
            err = ((got[touched] - ref[touched]).abs().max() / scale).item()
            assert err <= 1e-6, (case, err)

    def test_negative_id_past_one_slot_a_warp(self):
        """k = N = 140 000 distinct ids, one of them negative: past
        131 072 slots a warp walks more than one slot, and the negative
        id (slot 0) must not end its walk. Momentum, D = 64."""
        v, d, n = 140_000, 64, 140_000
        p0, s0, _i, grads = _inputs(15, v, d, n, 1)
        ids = np.random.default_rng(16).permutation(v).astype(np.int32)
        ids[ids == 4321] = -7       # row 4321 is the one left untouched
        start = [torch.from_numpy(a).cuda() for a in (p0, *s0)]
        ids_t = torch.from_numpy(ids).cuda()
        g = torch.from_numpy(grads).cuda()
        rule = tss.momentum_row_update(0.01, 0.9)
        got = [t.clone() for t in start]
        rows_op.sparse_rows(rule, got, ids_t, g, n, v)
        plain = [t.clone() for t in start]
        rows_op.sparse_rows_plain(rule, plain, ids_t, g, n, v)
        torch.cuda.synchronize()
        touched = torch.ones(v, dtype=torch.bool, device="cuda")
        touched[4321] = False
        for a, ref, s in zip(got, plain, start):
            assert torch.equal(a[~touched], s[~touched])
            scale = ref[touched].abs().max().clamp_min(1e-30)
            err = ((a[touched] - ref[touched]).abs().max() / scale).item()
            assert err <= 1e-6, err
            # every valid row moved, the last slots of each warp too
            assert not (a[touched] == s[touched]).all(dim=1).any()
