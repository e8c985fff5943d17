"""Reader creators and combinators: `paddle_tpu/data/reader.py` for
the port.

Reference: python/paddle/v2/reader/decorator.py:26-292 (map_readers,
buffered, compose, chain, shuffle, ComposeNotAligned, firstn) and
python/paddle/v2/reader/creator.py. A reader is a zero-arg callable
returning an iterator over samples; combinators wrap readers. The
double-buffer thread of the reference's C++ DataProvider
(gserver/dataproviders/DataProvider.h:249 DoubleBuffer) maps to
`buffered`, which prefetches on a background thread.

`recordio` and `elastic` read through the port's own build of the native
C++ record reader (`paddle_tpu_torch/native/recordio.py`), `elastic`
leasing chunks from an in-process `native.master.Master` or a networked
one through `data.master_client.MasterClient`; `recordio_interop` reads
both the reference recordio wire format and the native chunks.
"""

from __future__ import annotations

import itertools
import queue
import random as _random
import threading


class ComposeNotAligned(ValueError):
    pass


def np_array(x):
    """reader from an in-memory array: yields rows."""

    def reader():
        for row in x:
            yield row

    return reader


def text_file(path):
    def reader():
        with open(path) as f:
            for line in f:
                yield line.rstrip("\n")

    return reader


# ---- RecordIO reading (reader/creator.py:60 recordio) ----------------
#
# The PaddlePaddle recordio wire format (the Go master's chunk format,
# written by the `recordio` package): per chunk a 20-byte header
# [magic 0x01020304, crc32, compressor, compressed-len, num-records]
# followed by the payload — snappy FRAMING stream when compressor=1 —
# holding [len u32][bytes] records. Python-snappy isn't available, so
# the snappy framing + block formats are decoded here directly.


def _snappy_block_decode(buf: bytes) -> bytes:
    """Raw snappy block format (the framing format's COMPRESSED chunks;
    google/snappy format_description.txt)."""
    # uncompressed length varint
    n = shift = i = 0
    while True:
        b = buf[i]
        i += 1
        n |= (b & 0x7F) << shift
        if not b & 0x80:
            break
        shift += 7
    out = bytearray()
    while i < len(buf):
        tag = buf[i]
        i += 1
        kind = tag & 3
        if kind == 0:  # literal
            ln = tag >> 2
            if ln >= 60:
                nb = ln - 59
                ln = int.from_bytes(buf[i : i + nb], "little")
                i += nb
            ln += 1
            out += buf[i : i + ln]
            i += ln
            continue
        if kind == 1:  # copy, 1-byte offset
            ln = ((tag >> 2) & 0x7) + 4
            off = ((tag >> 5) << 8) | buf[i]
            i += 1
        elif kind == 2:  # copy, 2-byte offset
            ln = (tag >> 2) + 1
            off = int.from_bytes(buf[i : i + 2], "little")
            i += 2
        else:  # copy, 4-byte offset
            ln = (tag >> 2) + 1
            off = int.from_bytes(buf[i : i + 4], "little")
            i += 4
        for _ in range(ln):  # overlapping copies are the RLE trick
            out.append(out[-off])
    assert len(out) == n, f"snappy: got {len(out)} bytes, header said {n}"
    return bytes(out)


def _snappy_stream_decode(buf: bytes) -> bytes:
    """Snappy framing format (framing_format.txt): [type u8][len u24]
    chunks — 0xff stream id, 0x00 compressed (crc + block), 0x01
    uncompressed (crc + data), 0xfe padding."""
    out = bytearray()
    i = 0
    while i < len(buf):
        kind = buf[i]
        ln = int.from_bytes(buf[i + 1 : i + 4], "little")
        body = buf[i + 4 : i + 4 + ln]
        i += 4 + ln
        if kind == 0x00:
            out += _snappy_block_decode(body[4:])  # skip masked crc
        elif kind == 0x01:
            out += body[4:]
        # 0xff stream identifier / 0xfe padding / reserved: skip
    return bytes(out)


_RECORDIO_MAGIC = 0x01020304


def recordio_records(path: str):
    """Iterate raw record payloads of one recordio file."""
    import struct
    import zlib

    with open(path, "rb") as f:
        while True:
            head = f.read(20)
            if len(head) < 20:
                return
            magic, crc, comp, clen, _nrec = struct.unpack("<IIIII", head)
            if magic != _RECORDIO_MAGIC:
                raise ValueError(
                    f"{path}: bad recordio chunk magic {magic:#x}"
                )
            payload = f.read(clen)
            if comp == 1:
                data = _snappy_stream_decode(payload)
            elif comp == 2:
                data = zlib.decompress(payload, 31)  # gzip
            else:
                data = payload
            if crc and zlib.crc32(payload) & 0xFFFFFFFF != crc:
                raise ValueError(f"{path}: recordio chunk crc mismatch")
            i = 0
            while i < len(data):
                (rlen,) = struct.unpack_from("<I", data, i)
                i += 4
                yield data[i : i + rlen]
                i += rlen


def _file_records(path: str):
    """Raw records of one record file, sniffing the container: the
    reference recordio magic 0x01020304 decodes in-process; anything
    else goes through the native C++ prefetch reader (PTRC chunks)."""
    with open(path, "rb") as f:
        magic = f.read(4)
    if magic == b"\x04\x03\x02\x01":
        yield from recordio_records(path)
    else:
        from paddle_tpu_torch.native.recordio import RecordReader

        with RecordReader([path]) as rd:
            yield from rd


def recordio_interop(paths, buf_size=100):
    """Reader over pickled records in recordio files; `paths` is a
    path, a comma-separated list, or a list (glob patterns allowed) —
    the reference reader/creator.py:60 surface, reading BOTH the
    reference wire format and the native chunks."""
    import glob as _glob
    import pickle

    if isinstance(paths, str):
        paths = paths.split(",")
    files = []
    for p in paths:
        files.extend(sorted(_glob.glob(p)) or [p])

    def reader():
        for p in files:
            for rec in _file_records(p):
                yield pickle.loads(rec)

    return buffered(reader, buf_size)


def map_readers(func, *readers):
    """(decorator.py:26) new reader yielding func over outputs of readers."""

    def reader():
        rs = [r() for r in readers]
        for vals in zip(*rs):
            yield func(*vals)

    return reader


def shuffle(reader_fn, buf_size, seed=None):
    """(decorator.py:48) buffered shuffle."""

    def reader():
        rnd = _random.Random(seed)
        buf = []
        for e in reader_fn():
            buf.append(e)
            if len(buf) >= buf_size:
                rnd.shuffle(buf)
                yield from buf
                buf = []
        if buf:
            rnd.shuffle(buf)
            yield from buf

    return reader


def chain(*readers):
    """(decorator.py:83) concatenate readers."""

    def reader():
        for r in readers:
            yield from r()

    return reader


def compose(*readers, check_alignment=True):
    """(decorator.py:115) zip readers into tuple samples."""

    def make_tuple(x):
        return x if isinstance(x, tuple) else (x,)

    def reader():
        rs = [r() for r in readers]
        if check_alignment:
            for items in itertools.zip_longest(*rs):
                if any(i is None for i in items):
                    raise ComposeNotAligned(
                        "outputs of readers are not aligned"
                    )
                yield sum((make_tuple(i) for i in items), ())
        else:
            for items in zip(*rs):
                yield sum((make_tuple(i) for i in items), ())

    return reader


def buffered(reader_fn, size):
    """(decorator.py:162) background-thread prefetch — the DoubleBuffer
    equivalent (DataProvider.h:249)."""

    class _End:
        pass

    class _Raise:
        def __init__(self, exc):
            self.exc = exc

    def reader():
        q = queue.Queue(maxsize=size)

        def producer():
            try:
                for e in reader_fn():
                    q.put(e)
            except BaseException as exc:  # propagate to the consumer
                q.put(_Raise(exc))
            else:
                q.put(_End)

        t = threading.Thread(target=producer, daemon=True)
        t.start()
        while True:
            e = q.get()
            if e is _End:
                break
            if isinstance(e, _Raise):
                raise e.exc
            yield e

    return reader


def firstn(reader_fn, n):
    """(decorator.py:233) limit to first n samples."""

    def reader():
        return itertools.islice(reader_fn(), n)

    return reader


def cache(reader_fn):
    """Materialize once, then replay from memory."""
    data = []
    filled = []

    def reader():
        if not filled:
            data.extend(reader_fn())
            filled.append(True)
        return iter(data)

    return reader


def batched(reader_fn, batch_size, drop_last=True):
    """Group samples into lists (python/paddle/v2/minibatch.py)."""

    def reader():
        buf = []
        for e in reader_fn():
            buf.append(e)
            if len(buf) == batch_size:
                yield buf
                buf = []
        if buf and not drop_last:
            yield buf

    return reader


def recordio(paths, decode=None, start_chunk=0, step_chunk=1):
    """Stream records from chunked record files through the native C++
    async-prefetch reader (paddle_tpu_torch/native/recordio.py — the
    DoubleBuffer analogue, gserver/dataproviders/DataProvider.h:249).
    `decode` maps raw bytes -> sample (default: pickle.loads)."""
    import pickle

    from paddle_tpu_torch.native.recordio import RecordReader

    dec = decode if decode is not None else pickle.loads

    def reader():
        with RecordReader(
            paths, start_chunk=start_chunk, step_chunk=step_chunk
        ) as rd:
            for rec in rd:
                yield dec(rec)

    return reader


def elastic(master, decode=None):
    """Task-leased reading: pull (path, chunk) tasks from a
    `native.master.Master` or a `data.master_client.MasterClient` and
    stream those chunks — the fault-tolerant input dispatch loop of the
    reference's Go master (go/master/service.go). On reader failure the
    task lease expires and another worker re-reads the chunk."""
    import json
    import pickle

    from paddle_tpu_torch.native.recordio import RecordReader, count_chunks

    dec = decode if decode is not None else pickle.loads

    def reader():
        import time

        chunk_counts = {}
        while not master.pass_finished():
            t = master.get_task()
            if t is None:
                # nothing leasable *right now*, but a peer still holds a
                # lease — if it fails, the chunk returns to todo and we
                # must pick it up, so poll instead of exiting
                time.sleep(0.05)
                continue
            task_id, payload = t
            task = json.loads(payload)
            path = task["path"]
            if path not in chunk_counts:
                chunk_counts[path] = count_chunks(path)
            try:
                with RecordReader(
                    path,
                    start_chunk=task["chunk"],
                    step_chunk=chunk_counts[path],
                ) as rd:
                    for rec in rd:
                        yield dec(rec)
            except Exception:
                master.task_failed(task_id)
                raise
            if not master.task_done(task_id):
                # lease expired while we were yielding: the chunk was
                # requeued and will be re-read (duplicate records this
                # pass) — surface it so the operator can raise the lease
                import logging

                logging.getLogger("paddle_tpu_torch.data").warning(
                    "task %d lease expired before completion; chunk will "
                    "be re-served (raise Master lease_seconds?)",
                    task_id,
                )

    return reader
