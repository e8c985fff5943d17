"""The port's native C++ runtime against the JAX package's.

The port builds its own copy of the runtime's sources
(`paddle_tpu_torch/native/src`) into `paddle_tpu_torch/build/native/`;
the JAX package builds `paddle_tpu/native/src` into its own `lib/`.
Both are held to each other here, on the CPU:

- the optimizer library's steps bit-equal on the same buffers, and its
  state bytes equal and loadable across;
- recordio files byte-equal in both directions at several chunk sizes,
  each package reading the other's (whole, and sharded with
  `start_chunk` / `step_chunk`);
- `Master`'s lease, timeout requeue, failure cap and pass rotation (the
  cases of `tests/test_native.py::TestMaster`), and snapshots restored
  across the packages.
"""

import json
import os

import numpy as np
import pytest

from paddle_tpu.native import master as jmaster
from paddle_tpu.native import optimizer as joptimizer
from paddle_tpu.native import recordio as jrecordio
from paddle_tpu_torch import native as tnative
from paddle_tpu_torch.native import master as tmaster
from paddle_tpu_torch.native import optimizer as toptimizer
from paddle_tpu_torch.native import recordio as trecordio

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def test_runtime_builds_from_the_ports_own_sources():
    path = tnative.build()
    assert path == os.path.join(REPO, "paddle_tpu_torch", "build", "native",
                                "libpaddle_tpu_torch_native.so")
    assert os.path.exists(path)
    lib = tnative.load()
    assert lib._name == path
    # the port's sources are copies, never the JAX package's files
    src = os.path.join(REPO, "paddle_tpu_torch", "native", "src")
    for f in ("optimizer.cc", "recordio.cc", "master.cc",
              "master_server.cc", "common.h"):
        assert os.path.isfile(os.path.join(src, f))


def test_build_is_serialised_and_atomic():
    """Concurrent builders wait on the lock and find the library in
    place (the Makefile renames it atomically)."""
    import threading

    results, errors = [], []

    def run():
        try:
            results.append(tnative.build())
        except Exception as e:  # pragma: no cover - reported below
            errors.append(e)

    threads = [threading.Thread(target=run) for _ in range(4)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=120)
    assert not errors and len(set(results)) == 1


OPT_CASES = [
    ("sgd", {}),
    ("momentum", {"momentum": 0.9}),
    ("adagrad", {"epsilon": 1e-6}),
    ("adadelta", {"rho": 0.95, "epsilon": 1e-6}),
    ("rmsprop", {"rho": 0.9, "epsilon": 1e-6}),
    ("adam", {"beta1": 0.9, "beta2": 0.999, "epsilon": 1e-8}),
    ("sgd", {"lr_policy": "t_inv", "lr_decay_a": 0.5}),
    ("momentum", {"momentum": 0.5, "decay": 1e-3, "lr_policy": "poly",
                  "lr_decay_a": 0.1, "lr_decay_b": 0.5}),
]


@pytest.mark.parametrize("method,kw", OPT_CASES,
                         ids=[f"{m}-{i}" for i, (m, _) in
                              enumerate(OPT_CASES)])
def test_optimizer_steps_bit_equal_to_the_jax_library(method, kw):
    n = 64
    rng = np.random.default_rng(0)
    p0 = rng.standard_normal(n).astype(np.float32)
    grads = [rng.standard_normal(n).astype(np.float32) for _ in range(5)]
    t = toptimizer.NativeOptimizer(method, n, learning_rate=0.05, **kw)
    j = joptimizer.NativeOptimizer(method, n, learning_rate=0.05, **kw)
    pt, pj = p0.copy(), p0.copy()
    for i, g in enumerate(grads):
        t.update(pt, g, i)
        j.update(pj, g, i)
        assert pt.tobytes() == pj.tobytes(), i
    state = t.get_state()
    assert state == j.get_state()
    # the state crosses: the JAX library resumes from the port's bytes
    j2 = joptimizer.NativeOptimizer(method, n, learning_rate=0.05, **kw)
    j2.set_state(state)
    pa, pb = pt.copy(), pt.copy()
    t.update(pa, grads[0], 5)
    j2.update(pb, grads[0], 5)
    assert pa.tobytes() == pb.tobytes()


def test_optimizer_state_crc_rejects_corruption():
    a = toptimizer.NativeOptimizer("momentum", 8, momentum=0.9)
    s = bytearray(a.get_state())
    s[10] ^= 0xFF
    with pytest.raises(ValueError):
        a.set_state(bytes(s))
    with pytest.raises(ValueError):
        toptimizer.NativeOptimizer("nope", 4)


def _records(seed, n):
    rng = np.random.default_rng(seed)
    out = [rng.bytes(int(rng.integers(0, 900))) for _ in range(n)]
    out[3] = b""  # an empty record is a record
    return out


@pytest.mark.parametrize("chunk_bytes", [64, 1000, 4096, 1 << 20])
@pytest.mark.parametrize("writer", ["port", "jax"])
def test_recordio_files_byte_equal_and_read_across(tmp_path, writer,
                                                   chunk_bytes):
    recs = _records(chunk_bytes, 123)
    paths = {}
    for name, mod in (("port", trecordio), ("jax", jrecordio)):
        paths[name] = str(tmp_path / f"{name}.rec")
        with mod.RecordWriter(paths[name], max_chunk_bytes=chunk_bytes) as w:
            for r in recs:
                w.write(r)
    assert open(paths["port"], "rb").read() == open(paths["jax"],
                                                    "rb").read()
    path = paths[writer]
    n = trecordio.count_chunks(path)
    assert n == jrecordio.count_chunks(path)
    assert (n > 1) == (chunk_bytes < 50_000)
    for reader in (trecordio, jrecordio):
        with reader.RecordReader(path) as rd:
            assert list(rd) == recs
    # sharded: worker i of k reads chunks i, i + k, ...; the shards of
    # both packages are equal and partition the file
    k = min(3, n)
    shards = []
    for i in range(k):
        with trecordio.RecordReader(path, start_chunk=i,
                                    step_chunk=k) as rd:
            got = list(rd)
        with jrecordio.RecordReader(path, start_chunk=i,
                                    step_chunk=k) as rd:
            assert list(rd) == got
        shards.append(got)
    assert sorted(r for s in shards for r in s) == sorted(recs)


def test_recordio_multi_file_crc_and_truncation(tmp_path):
    paths = []
    for j in range(3):
        p = str(tmp_path / f"f{j}.rec")
        with trecordio.RecordWriter(p) as w:
            w.write(f"file{j}".encode())
        paths.append(p)
    with trecordio.RecordReader(paths) as rd:
        assert list(rd) == [b"file0", b"file1", b"file2"]
    path = str(tmp_path / "c.rec")
    with trecordio.RecordWriter(path) as w:
        for _ in range(10):
            w.write(b"x" * 100)
    data = bytearray(open(path, "rb").read())
    data[30] ^= 0xFF
    open(path, "wb").write(bytes(data))
    with pytest.raises(IOError):
        with trecordio.RecordReader(path) as rd:
            list(rd)
    path = str(tmp_path / "t.rec")
    with trecordio.RecordWriter(path, max_chunk_bytes=32) as w:
        for _ in range(10):
            w.write(b"x" * 40)
    data = open(path, "rb").read()
    open(path, "wb").write(data[:-20])
    with pytest.raises(IOError):
        with trecordio.RecordReader(path, start_chunk=0,
                                    step_chunk=1000) as rd:
            list(rd)


# ---- Master (tests/test_native.py::TestMaster, on the port) ---------------

def test_master_lease_done_cycle():
    m = tmaster.Master(lease_seconds=60, failure_max=3)
    for i in range(5):
        m.add_task(f"task{i}".encode())
    seen = set()
    while (t := m.get_task()) is not None:
        tid, payload = t
        seen.add(payload)
        assert m.task_done(tid)
    assert seen == {f"task{i}".encode() for i in range(5)}
    assert m.pass_finished()
    assert m.counts == {"todo": 0, "pending": 0, "done": 5, "discarded": 0}


def test_master_timeout_requeues():
    m = tmaster.Master(lease_seconds=0.0, failure_max=10)
    m.add_task(b"t")
    tid, _ = m.get_task()
    tid2, payload = m.get_task()
    assert payload == b"t"
    assert not m.task_done(tid)
    assert m.task_done(tid2)


def test_master_failure_cap_discards():
    m = tmaster.Master(lease_seconds=60, failure_max=2)
    m.add_task(b"poison")
    tid, _ = m.get_task()
    m.task_failed(tid)
    tid, _ = m.get_task()
    m.task_failed(tid)
    assert m.get_task() is None
    assert m.counts["discarded"] == 1
    assert m.pass_finished()


def test_master_pass_rotation_and_empty_payload():
    m = tmaster.Master()
    m.add_task(b"a")
    m.add_task(b"")
    for _ in range(2):
        tid, _ = m.get_task()
        m.task_done(tid)
    assert m.pass_finished()
    assert m.start_pass() == 2
    assert {m.get_task()[1], m.get_task()[1]} == {b"a", b""}


def test_master_save_election():
    m = tmaster.Master()
    assert m.request_save_model("t0", 60.0)
    assert not m.request_save_model("t1", 60.0)
    with pytest.raises(ValueError):
        m.request_save_model("", 1.0)


def _half_done(mod):
    m = mod.Master(lease_seconds=60, failure_max=3)
    for p in (b"todo1", b"leased", b"done1"):
        m.add_task(p)
    tid, p = m.get_task()
    assert p == b"todo1"
    m.task_done(tid)
    tid, p = m.get_task()
    assert p == b"leased"
    return m


@pytest.mark.parametrize("writer,reader", [
    (tmaster, jmaster), (jmaster, tmaster), (tmaster, tmaster)],
    ids=["port_to_jax", "jax_to_port", "port_to_port"])
def test_master_snapshot_restores_across_packages(tmp_path, writer, reader):
    snap = str(tmp_path / "master.snap")
    _half_done(writer).snapshot(snap)
    other = str(tmp_path / "other.snap")
    _half_done(jmaster if writer is tmaster else tmaster).snapshot(other)
    assert open(snap, "rb").read() == open(other, "rb").read()
    r = reader.Master.restore(snap)
    # the done task stays done; the pending lease does not survive
    assert r.counts == {"todo": 2, "pending": 0, "done": 1, "discarded": 0}
    assert {r.get_task()[1], r.get_task()[1]} == {b"done1", b"leased"}


def test_master_restore_rejects_corruption(tmp_path):
    snap = str(tmp_path / "m.snap")
    m = tmaster.Master()
    m.add_task(b"x")
    m.snapshot(snap)
    data = bytearray(open(snap, "rb").read())
    data[12] ^= 0xFF
    open(snap, "wb").write(bytes(data))
    with pytest.raises(IOError):
        tmaster.Master.restore(snap)


def test_master_dispatches_jax_written_chunks(tmp_path):
    """The port's master over chunk tasks of a file the JAX package
    wrote; workers read their chunks with the port's reader."""
    path = str(tmp_path / "d.rec")
    with jrecordio.RecordWriter(path, max_chunk_bytes=32) as w:
        for i in range(20):
            w.write(f"r{i:02d}".encode())
    n = trecordio.count_chunks(path)
    m = tmaster.Master()
    m.add_chunk_tasks(path, n)
    got = []
    while (t := m.get_task()) is not None:
        tid, payload = t
        task = json.loads(payload)
        assert task == {"path": path, "chunk": task["chunk"]}
        with trecordio.RecordReader(task["path"], start_chunk=task["chunk"],
                                    step_chunk=n) as rd:
            got.extend(rd)
        m.task_done(tid)
    assert sorted(got) == [f"r{i:02d}".encode() for i in range(20)]
