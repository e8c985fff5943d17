"""ctypes wrappers for the chunked record format + async prefetch reader
— `paddle_tpu/native/recordio.py` for the port, over the port's own
build of `src/recordio.cc` (a copy of the JAX package's: a file either
package writes is byte-equal to the other's and reads in both).

The dataset container for the elastic input pipeline: files are written
in CRC-protected chunks, readers stream records through a C++ prefetch
thread (the DoubleBuffer analogue, DataProvider.h:249), and chunk
boundaries are the task unit the master dispatches
(go/master/service.go:280).
"""

from __future__ import annotations

import ctypes

from paddle_tpu_torch.native import load


class RecordWriter:
    def __init__(self, path: str, max_chunk_bytes: int = 1 << 20):
        self._lib = load()
        self._h = self._lib.pt_recordio_writer_open(
            path.encode(), max_chunk_bytes
        )
        if not self._h:
            raise IOError(f"cannot open {path} for writing")

    def write(self, record: bytes) -> None:
        if self._lib.pt_recordio_write(self._h, record, len(record)) != 0:
            raise IOError("record write failed")

    def close(self) -> None:
        if self._h:
            rc = self._lib.pt_recordio_writer_close(self._h)
            self._h = None
            if rc != 0:
                raise IOError("writer close/flush failed")

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()


class RecordReader:
    """Iterates records across files; `start_chunk`/`step_chunk` give
    sharded reads (worker i of k passes start_chunk=i, step_chunk=k)."""

    def __init__(
        self,
        paths,
        start_chunk: int = 0,
        step_chunk: int = 1,
        max_queued: int = 4096,
    ):
        self._lib = load()
        if isinstance(paths, str):
            paths = [paths]
        arr = (ctypes.c_char_p * len(paths))(
            *[p.encode() for p in paths]
        )
        self._h = self._lib.pt_recordio_reader_open(
            arr, len(paths), start_chunk, step_chunk, max_queued
        )
        if not self._h:
            raise IOError(f"cannot open reader for {paths}")

    def __iter__(self):
        return self

    def __next__(self) -> bytes:
        n = self._lib.pt_recordio_peek_len(self._h)
        if n == -3:  # end of data (0 is a valid empty record)
            raise StopIteration
        if n == -2:
            err = self._lib.pt_recordio_error(self._h)
            raise IOError(err.decode() if err else "read error")
        buf = ctypes.create_string_buffer(max(n, 1))
        got = self._lib.pt_recordio_next(self._h, buf, max(n, 1))
        if got != n:
            raise IOError("short read from prefetch queue")
        return buf.raw[:got]

    def close(self) -> None:
        if self._h:
            self._lib.pt_recordio_reader_close(self._h)
            self._h = None

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()


def count_chunks(path: str) -> int:
    n = load().pt_recordio_count_chunks(path.encode())
    if n < 0:
        raise IOError(f"cannot count chunks in {path} (code {n})")
    return n
