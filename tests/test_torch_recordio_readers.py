"""The port's recordio readers and dataset converters against the JAX
package's.

- `reader.recordio` (whole files and sharded), `reader.elastic` over an
  in-process master, and `reader.recordio_interop` over the native
  chunks and the reference recordio wire format, each equal to the JAX
  reader on the same files;
- `dataset.common.convert` and every dataset module's `convert`
  (cifar, conll05, flowers, imdb, imikolov, mnist, movielens, mq2007,
  sentiment) writing files byte-equal to the JAX package's, under a
  temporary `DATA_HOME` of both packages.
"""

import os
import pickle
import struct
import zlib

import numpy as np
import pytest

from paddle_tpu.data import dataset as jds
from paddle_tpu.data import reader as JR
from paddle_tpu.data.dataset import common as jcommon
from paddle_tpu.native.master import Master as JMaster
from paddle_tpu.native.recordio import RecordWriter as JWriter
from paddle_tpu_torch.data import dataset as tds
from paddle_tpu_torch.data import reader as TR
from paddle_tpu_torch.data.dataset import common as tcommon
from paddle_tpu_torch.native.master import Master as TMaster
from paddle_tpu_torch.native.recordio import RecordWriter, count_chunks

SAMPLES = [([i, i + 1, i * 3], i % 3, np.float32(i) / 7) for i in range(90)]


def _write(path, writer, samples, chunk_bytes):
    with writer(path, max_chunk_bytes=chunk_bytes) as w:
        for s in samples:
            w.write(pickle.dumps(s))


def _same(a, b):
    assert pickle.dumps(a) == pickle.dumps(b)


@pytest.mark.parametrize("writer", [RecordWriter, JWriter],
                         ids=["port_file", "jax_file"])
@pytest.mark.parametrize("chunk_bytes", [128, 1 << 20])
def test_recordio_reader_equal_to_jax(tmp_path, writer, chunk_bytes):
    path = str(tmp_path / "s.rec")
    _write(path, writer, SAMPLES, chunk_bytes)
    _same(list(TR.recordio(path)()), list(JR.recordio(path)()))
    assert list(TR.recordio(path)()) == SAMPLES
    n = count_chunks(path)
    k = min(3, n)
    parts = []
    for i in range(k):
        got = list(TR.recordio(path, start_chunk=i, step_chunk=k)())
        _same(got, list(JR.recordio(path, start_chunk=i, step_chunk=k)()))
        parts += got
    assert sorted(p[0] for p in parts) == sorted(s[0] for s in SAMPLES)
    raw = list(TR.recordio(path, decode=bytes)())
    assert raw == [pickle.dumps(s) for s in SAMPLES]


@pytest.mark.parametrize("master", [TMaster, JMaster],
                         ids=["port_master", "jax_master"])
def test_elastic_reader_equal_to_jax(tmp_path, master):
    paths = []
    for j in range(2):
        p = str(tmp_path / f"s{j}.rec")
        _write(p, RecordWriter, SAMPLES[j * 45:(j + 1) * 45], 200)
        paths.append(p)
    got = {}
    for name, rd in (("port", TR), ("jax", JR)):
        m = master()
        for p in paths:
            m.add_chunk_tasks(p, count_chunks(p))
        got[name] = list(rd.elastic(m)())
        assert m.pass_finished()
        assert m.counts["done"] == sum(count_chunks(p) for p in paths)
    # one in-process master hands chunks out in order: the same stream
    _same(got["port"], got["jax"])
    assert got["port"] == SAMPLES


def test_elastic_reader_fails_the_task_of_a_bad_chunk(tmp_path):
    path = str(tmp_path / "bad.rec")
    _write(path, RecordWriter, SAMPLES, 200)
    data = bytearray(open(path, "rb").read())
    data[40] ^= 0xFF
    open(path, "wb").write(bytes(data))
    m = TMaster(lease_seconds=60, failure_max=1)
    m.add_chunk_tasks(path, count_chunks(path))
    with pytest.raises(IOError):
        list(TR.elastic(m)())
    assert m.counts["discarded"] == 1


def _reference_recordio(path, samples, per_chunk=7, compressor=0):
    """A file in the reference recordio wire format: [magic, crc,
    compressor, compressed length, records] + [len][bytes] records."""
    with open(path, "wb") as f:
        for c in range(0, len(samples), per_chunk):
            recs = [pickle.dumps(s) for s in samples[c:c + per_chunk]]
            payload = b"".join(struct.pack("<I", len(r)) + r for r in recs)
            if compressor == 2:
                z = zlib.compressobj(wbits=31)
                payload = z.compress(payload) + z.flush()
            f.write(struct.pack("<IIIII", 0x01020304,
                                zlib.crc32(payload) & 0xFFFFFFFF,
                                compressor, len(payload), len(recs)))
            f.write(payload)


@pytest.mark.parametrize("fmt", ["native", "reference", "reference_gzip",
                                 "both_globbed"])
def test_recordio_interop_equal_to_jax(tmp_path, fmt):
    native = str(tmp_path / "a-native.rec")
    ref = str(tmp_path / "b-ref.rec")
    _write(native, RecordWriter, SAMPLES[:50], 300)
    _reference_recordio(ref, SAMPLES[50:],
                        compressor=2 if fmt == "reference_gzip" else 0)
    paths = {"native": native, "reference": ref, "reference_gzip": ref,
             "both_globbed": str(tmp_path / "*.rec")}[fmt]
    want = {"native": SAMPLES[:50], "both_globbed": SAMPLES}.get(
        fmt, SAMPLES[50:])
    got = list(TR.recordio_interop(paths)())
    _same(got, list(JR.recordio_interop(paths)()))
    assert got == want


# ---- the dataset converters ----------------------------------------------

@pytest.fixture
def data_home(tmp_path, monkeypatch):
    home = str(tmp_path / "data_home")
    for mod in (tcommon, jcommon):
        monkeypatch.setattr(mod, "DATA_HOME", home)
    return home


def _files(d):
    return {f: open(os.path.join(d, f), "rb").read()
            for f in sorted(os.listdir(d))}


def test_common_convert_equal_to_jax(tmp_path):
    def reader():
        for s in SAMPLES:
            yield s

    tp = tcommon.convert(str(tmp_path / "t"), reader, 40, "toy")
    jp = jcommon.convert(str(tmp_path / "j"), reader, 40, "toy")
    assert [os.path.basename(p) for p in tp] == \
        [os.path.basename(p) for p in jp] == \
        ["toy-00000.recordio", "toy-00001.recordio", "toy-00002.recordio"]
    assert _files(str(tmp_path / "t")) == _files(str(tmp_path / "j"))
    assert list(TR.recordio(tp)()) == SAMPLES


DATASETS = ["cifar", "conll05", "flowers", "imdb", "imikolov", "mnist",
            "movielens", "mq2007", "sentiment"]


@pytest.mark.parametrize("name", DATASETS)
def test_dataset_convert_equal_to_jax(tmp_path, data_home, name):
    getattr(tds, name).convert(str(tmp_path / "t"))
    getattr(jds, name).convert(str(tmp_path / "j"))
    got, want = _files(str(tmp_path / "t")), _files(str(tmp_path / "j"))
    assert got and sorted(got) == sorted(want)
    assert all(f.startswith(name) and f.endswith(".recordio") for f in got)
    for f in got:
        assert got[f] == want[f], f
    # the files stream back through the port's readers as the samples
    first = sorted(got)[0]
    stream = list(TR.recordio(str(tmp_path / "t" / first))())
    jstream = list(JR.recordio(str(tmp_path / "j" / first))())
    assert len(stream) == len(jstream) > 0
    _same(stream, jstream)
