"""The port's data feed (`paddle_tpu_torch/data/`) against the JAX
package's, on the CPU.

- `DataFeeder`: every input type at each `seq_type` it takes (0, 1 and
  2), with the default buckets and explicit ones, gives the JAX
  feeder's arrays (ids compared after the port's int64 cast; values
  float32, lengths int32, CPU tensors), and the same `ValueError` past
  the largest bucket;
- the readers: `np_array`, `text_file`, `map_readers`, `shuffle`
  (seeded), `batched` (with and without `drop_last`), `compose` (and
  `ComposeNotAligned`), `buffered` (and an error raised inside it),
  `firstn`, `chain` and `cache` yield the JAX readers' items;
  `recordio_interop` reads the reference recordio format and refuses
  the native chunk format, which is still to port;
- `write_proto_data` -> `proto_reader` round trips agree between the
  packages, plain, gzip'd and with sequences, and their `input_types`
  feed each package's feeder to the same arrays;
- `provider` gives the same samples (shuffled per pass, cached).
"""

import gzip
import pickle
import struct
import zlib

import numpy as np
import pytest
import torch

from paddle_tpu.data import feeder as jfeeder
from paddle_tpu.data import proto_provider as jproto
from paddle_tpu.data import provider as jprovider
from paddle_tpu.data import reader as jreader
from paddle_tpu_torch.data import feeder as tfeeder
from paddle_tpu_torch.data import proto_provider as tproto
from paddle_tpu_torch.data import provider as tprovider
from paddle_tpu_torch.data import reader as treader
from paddle_tpu_torch.serving import server as tserver

DTYPES = {"value": torch.float32, "ids": torch.int64,
          "seq_lens": torch.int32, "subseq_lens": torch.int32}


def _assert_args_equal(t, j, what):
    for f, dtype in DTYPES.items():
        tv, jv = getattr(t, f), getattr(j, f)
        assert (tv is None) == (jv is None), (what, f)
        if tv is None:
            continue
        assert tv.dtype == dtype and tv.device.type == "cpu", (what, f)
        np.testing.assert_array_equal(
            tv.numpy(), np.asarray(jv).astype(tv.numpy().dtype),
            err_msg=f"{what}.{f}")


def _column(kind, seq, rng):
    """Samples of one slot: 3 rows of `kind` at sequence depth `seq`."""

    def one():
        if kind == "dense":
            return list(rng.standard_normal(4).astype(np.float32))
        if kind == "ids":
            return int(rng.integers(0, 50))
        if kind == "sparse_binary":
            return sorted(set(int(i) for i in rng.integers(0, 10, 3)))
        idx = sorted(set(int(i) for i in rng.integers(0, 10, 3)))
        return [(i, float(rng.standard_normal())) for i in idx]

    if seq == 0:
        return [one() for _ in range(3)]
    if seq == 1:
        return [[one() for _ in range(n)] for n in (3, 1, 11)]
    return [[[one() for _ in range(n)] for n in subs]
            for subs in ((2, 3), (1,), (4, 1, 2))]


def _types(mod, kind, seq):
    if kind == "dense":
        return mod.dense_vector(4, seq)
    if kind == "ids":
        return mod.integer_value(50, seq)
    if kind == "sparse_binary":
        return mod.sparse_binary_vector(10, seq)
    return mod.sparse_float_vector(10, seq)


# the JAX feeder takes sub-sequences of ids and dense vectors
CASES = [(k, s) for k in ("dense", "ids", "sparse_binary", "sparse_float")
         for s in (0, 1)] + [("ids", 2), ("dense", 2)]


@pytest.mark.parametrize("buckets", [None, (4, 16)])
@pytest.mark.parametrize("kind,seq", CASES)
def test_feeder_gives_the_jax_arrays(kind, seq, buckets):
    column = _column(kind, seq, np.random.default_rng(0))
    labels = [0, 1, 1]
    batch = list(zip(column, labels))
    feeding = {"x": 0, "label": 1}
    jf = jfeeder.DataFeeder(feeding, {"x": _types(jfeeder, kind, seq),
                                      "label": jfeeder.integer_value(2)},
                            buckets=buckets)
    tf = tfeeder.DataFeeder(feeding, {"x": _types(tfeeder, kind, seq),
                                      "label": tfeeder.integer_value(2)},
                            buckets=buckets)
    jout, tout = jf(batch), tf(batch)
    assert sorted(tout) == sorted(jout)
    for name in jout:
        _assert_args_equal(tout[name], jout[name], f"{kind}/{seq}/{name}")


def test_feeder_refuses_a_length_past_the_largest_bucket():
    batch = [([1] * 17,)]
    for mod in (jfeeder, tfeeder):
        f = mod.DataFeeder({"w": 0}, {"w": mod.integer_value_sequence(9)},
                           buckets=(4, 16))
        with pytest.raises(ValueError, match="exceeds the largest bucket 16"):
            f(batch)


def test_feeder_input_type_surface_and_buckets_agree():
    for n in (1, 7, 8, 9, 100, 128, 129, 300):
        assert tfeeder._bucket(n) == jfeeder._bucket(n)
        assert tfeeder._bucket(n, (16, 512)) == jfeeder._bucket(n, (16, 512))
    for make in ("dense_vector", "integer_value", "sparse_binary_vector",
                 "sparse_float_vector"):
        t, j = getattr(tfeeder, make)(12, 1), getattr(jfeeder, make)(12, 1)
        assert (t.dim, t.seq_type, t.type, t.size) == (j.dim, j.seq_type,
                                                       j.type, j.size)
    # the serving front end buckets with the feeder's rule, not a copy
    assert tserver._bucket is tfeeder._bucket


# ---- readers --------------------------------------------------------------

def _items(reader):
    return list(reader())


def _pairs(mod):
    return mod.np_array(np.arange(10))


@pytest.mark.parametrize("name", ["np_array", "map_readers", "shuffle",
                                  "batched", "batched_keep_last", "compose",
                                  "buffered", "firstn", "chain", "cache"])
def test_readers_yield_the_jax_items(name):
    def build(mod):
        base = _pairs(mod)
        other = mod.np_array(np.arange(10) * 10)
        return {
            "np_array": base,
            "map_readers": mod.map_readers(lambda a, b: a + b, base, other),
            "shuffle": mod.shuffle(base, 4, seed=7),
            "batched": mod.batched(base, 3),
            "batched_keep_last": mod.batched(base, 3, drop_last=False),
            "compose": mod.compose(base, other),
            "buffered": mod.buffered(base, 2),
            "firstn": mod.firstn(base, 4),
            "chain": mod.chain(base, other),
            "cache": mod.cache(mod.shuffle(base, 10, seed=3)),
        }[name]

    t, j = _items(build(treader)), _items(build(jreader))
    assert len(t) > 0
    assert repr(t) == repr(j)
    if name == "cache":
        r = build(treader)
        assert _items(r) == _items(r)


def test_compose_not_aligned_and_buffered_errors_surface():
    for mod in (treader, jreader):
        short = mod.np_array(np.arange(3))
        with pytest.raises(mod.ComposeNotAligned):
            _items(mod.compose(_pairs(mod), short))
        assert len(_items(mod.compose(_pairs(mod), short,
                                      check_alignment=False))) == 3

        def bad():
            yield 1
            raise OSError("disk gone")

        with pytest.raises(OSError, match="disk gone"):
            _items(mod.buffered(bad, 2))


def test_text_file_reader(tmp_path):
    p = tmp_path / "lines.txt"
    p.write_text("a b\nc\n\nd\n")
    assert _items(treader.text_file(str(p))) == _items(
        jreader.text_file(str(p))) == ["a b", "c", "", "d"]


def _write_recordio(path, records, compressor):
    """One chunk of the reference recordio format."""
    payload = b"".join(struct.pack("<I", len(r)) + r for r in records)
    if compressor == 2:
        payload = gzip.compress(payload)
    head = struct.pack("<IIIII", 0x01020304, zlib.crc32(payload),
                       compressor, len(payload), len(records))
    with open(path, "wb") as f:
        f.write(head + payload)


@pytest.mark.parametrize("compressor", [0, 2])
def test_recordio_reference_format(tmp_path, compressor):
    samples = [(i, [i] * i) for i in range(5)]
    p = str(tmp_path / "data.recordio")
    _write_recordio(p, [pickle.dumps(s) for s in samples], compressor)
    assert _items(treader.recordio_interop(p)) == _items(
        jreader.recordio_interop(p)) == samples


def test_recordio_native_chunks_are_still_to_port(tmp_path):
    """The native chunks read through the port's own native reader now
    (the name is from before it was ported): a file the JAX package's
    writer wrote reads equal to the JAX reader's, and a torn one raises
    as there."""
    from paddle_tpu.native.recordio import RecordWriter

    samples = [(i, [i] * i) for i in range(9)]
    good = str(tmp_path / "good.rec")
    with RecordWriter(good, max_chunk_bytes=64) as w:
        for s in samples:
            w.write(pickle.dumps(s))
    assert _items(treader.recordio_interop(good)) == _items(
        jreader.recordio_interop(good)) == samples
    p = tmp_path / "native.rec"
    p.write_bytes(b"PTRC" + bytes(32))
    for rd in (treader, jreader):
        with pytest.raises(IOError, match="bad chunk magic"):
            _items(rd.recordio_interop(str(p)))


# ---- proto data and providers ---------------------------------------------

SLOTS = [(jproto.VECTOR_DENSE, 3), (jproto.VECTOR_SPARSE_NON_VALUE, 10),
         (jproto.VECTOR_SPARSE_VALUE, 10), (jproto.INDEX, 7)]


def _proto_rows(n, rng):
    rows = []
    for _ in range(n):
        ids = sorted(set(int(i) for i in rng.integers(0, 10, 3)))
        rows.append((list(rng.standard_normal(3).astype(np.float32)
                          .astype(float)),
                     ids, (ids, list(rng.standard_normal(len(ids))
                                     .astype(np.float32).astype(float))),
                     int(rng.integers(0, 7))))
    return rows


@pytest.mark.parametrize("mode", ["plain", "gzip", "sequences"])
def test_proto_round_trip_agrees(tmp_path, mode):
    rows = _proto_rows(6, np.random.default_rng(1))
    begins = [True, False, False, True, True, False] if mode == "sequences" \
        else None
    p = str(tmp_path / "data.bin")
    tproto.write_proto_data(p, SLOTS, rows, beginnings=begins,
                            compressed=mode == "gzip")
    jp = str(tmp_path / "data_j.bin")
    jproto.write_proto_data(jp, SLOTS, rows, beginnings=begins,
                            compressed=mode == "gzip")
    assert open(p, "rb").read() == open(jp, "rb").read()
    t = _items(tproto.proto_reader(p))
    j = _items(jproto.proto_reader(p))
    assert repr(t) == repr(j) and len(t) == (3 if begins else 6)
    seq = mode == "sequences"
    tt = tproto.input_types(SLOTS, sequences=seq)
    jt = jproto.input_types(SLOTS, sequences=seq)
    feeding = {f"s{i}": i for i in range(len(SLOTS))}
    tout = tfeeder.DataFeeder(feeding, dict(zip(feeding, tt)))(t)
    jout = jfeeder.DataFeeder(feeding, dict(zip(feeding, jt)))(j)
    for name in feeding:
        _assert_args_equal(tout[name], jout[name], f"{mode}/{name}")


def test_provider_gives_the_same_samples(tmp_path):
    files = []
    for i in range(2):
        p = tmp_path / f"part{i}.txt"
        p.write_text("\n".join(f"{i} {k}" for k in range(5)))
        files.append(str(p))

    def make(mod, feeder_mod):
        @mod.provider(input_types=[feeder_mod.integer_value(10),
                                   feeder_mod.integer_value(10)],
                      cache=mod.CacheType.CACHE_PASS_IN_MEM)
        def process(settings, filename):
            with open(filename) as f:
                for line in f:
                    a, b = line.split()
                    yield int(a), int(b)

        return process(files)

    t, j = make(tprovider, tfeeder), make(jprovider, jfeeder)
    # shuffled, in another order each pass, the same in both packages
    first, second = _items(t), _items(t)
    assert first == _items(j) and second == _items(j)
    assert sorted(first) == sorted(second) and first != second
