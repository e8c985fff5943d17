"""DataFeeder: python samples -> Arg batches (ragged -> dense packing),
`paddle_tpu/data/feeder.py` for the port.

Reference: python/paddle/v2/data_feeder.py + the input-type declarations of
PyDataProvider2.py:47-214 (dense_vector, integer_value, sparse_*, each ×
{no_sequence, sequence, sub_sequence}). The reference emits padding-free
flat buffers + start positions; we emit dense [B, T_bucket] + lengths
(see core/arg.py for why). Bucketing rounds T up to a bucket, so a
trainer with steps_per_dispatch > 1 captures one CUDA graph per bucket
(and batch size), not one per batch.

The arrays are the JAX feeder's, as the port's `Arg` of CPU tensors:
values float32, ids int64 (the JAX package keeps int32), `seq_lens` and
`subseq_lens` int32. The train step moves them to the card.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Optional

import numpy as np

import torch

from paddle_tpu_torch.core.arg import Arg


@dataclass(frozen=True)
class InputType:
    kind: str  # dense | ids | sparse_binary | sparse_float
    shape: tuple  # feature shape
    seq: int  # 0 = none, 1 = sequence, 2 = sub-sequence
    vocab: int = 0  # ids slots: the value range (v1 slot "dim")

    @property
    def size(self) -> int:
        """Layer width this slot feeds (reference InputType.dim: vocab
        for integer slots, feature dim otherwise)."""
        if self.kind == "ids":
            return self.vocab
        n = 1
        for d in self.shape:
            n *= d
        return n

    # --- the reference InputType attribute surface
    #     (PyDataProvider2.py:47 InputType(dim, seq_type, type)) ---
    @property
    def dim(self) -> int:
        return self.size

    @property
    def seq_type(self) -> int:
        return self.seq

    @property
    def type(self) -> int:
        """DataType enum value (PyDataProvider2.py:32)."""
        return {
            "dense": 0,  # DataType.Dense
            "sparse_binary": 1,  # DataType.SparseNonValue
            "sparse_float": 2,  # DataType.SparseValue
            "ids": 3,  # DataType.Index
        }[self.kind]


def dense_vector(dim, seq_type=0):
    dim = tuple(dim) if isinstance(dim, (tuple, list)) else (dim,)
    return InputType("dense", dim, seq_type)


def integer_value(vocab, seq_type=0):
    return InputType("ids", (1,), seq_type, vocab=vocab)


def sparse_binary_vector(dim, seq_type=0):
    return InputType("sparse_binary", (dim,), seq_type)


def sparse_float_vector(dim, seq_type=0):
    return InputType("sparse_float", (dim,), seq_type)


# sequence variants, mirroring PyDataProvider2 naming
def dense_vector_sequence(dim):
    return dense_vector(dim, 1)


def integer_value_sequence(vocab):
    return integer_value(vocab, 1)


def integer_value_sub_sequence(vocab):
    return integer_value(vocab, 2)


def _bucket(n: int, buckets=None) -> int:
    """Round up to a bucket to bound recompilation."""
    if buckets:
        for b in buckets:
            if n <= b:
                return b
        raise ValueError(
            f"sequence of length {n} exceeds the largest bucket "
            f"{buckets[-1]}; add a larger bucket or truncate upstream"
        )
    b = 8
    while b < n:
        b *= 2 if b < 128 else 1
        if b >= 128:
            b = ((n + 127) // 128) * 128
            break
    return b


def _sparse_float_row(row):
    """Normalize a sparse-float row to (indices, values). Accepts the
    reference sample format — a sequence of (col, value) pairs
    (PyDataProvider2.py sparse_float slots; DataProviderConverter's
    SparseFloatScanner) — or the internal two-tuple of parallel LISTS
    (proto_provider). A tuple of exactly two pairs is ambiguous by
    shape; the parallel form is only recognized when both halves are
    lists/arrays, so reference pair data can never be misread as
    (indices, values)."""
    if (
        isinstance(row, tuple)
        and len(row) == 2
        and all(isinstance(e, (list, np.ndarray)) for e in row)
    ):
        return row  # internal parallel (indices, values)
    if len(row) == 0:
        return (), ()
    if all(hasattr(e, "__len__") and len(e) == 2 for e in row):
        return tuple(zip(*row))  # reference (col, value) pairs
    if isinstance(row, tuple) and len(row) == 2:
        return row  # parallel form with tuple storage
    return tuple(zip(*row))


_DTYPES = {"value": np.float32, "ids": np.int64, "seq_lens": np.int32,
           "subseq_lens": np.int32}


class DataFeeder:
    """feeding maps data-layer name -> position in each sample tuple."""

    def __init__(self, feeding: dict, types: dict, buckets=None):
        self.feeding = feeding
        self.types = types
        self.buckets = buckets

    def __call__(self, batch: list) -> dict:
        return self.convert(batch)

    def convert(self, batch: list) -> dict:
        out = {}
        for name, pos in self.feeding.items():
            t = self.types[name]
            column = [sample[pos] for sample in batch]
            out[name] = self._column_to_arg(column, t)
        return out

    def _column_to_arg(self, column, t: InputType) -> Arg:
        """The column as the port's Arg of CPU tensors."""
        a = self._column_to_arrays(column, t)
        return Arg(**{f: None if x is None else torch.from_numpy(
            np.ascontiguousarray(x, _DTYPES[f])) for f, x in a.items()})

    def _column_to_arrays(self, column, t: InputType) -> dict:
        """{Arg field: numpy array} of the column, the JAX feeder's
        arrays."""
        b = len(column)
        if t.seq == 0:
            if t.kind == "dense":
                arr = np.asarray(column, np.float32)
                try:
                    v = arr.reshape((b,) + t.shape)
                except ValueError:
                    # dense_array: the declared dim is advisory — the
                    # actual sample shape wins (reference
                    # DenseScanner keeps multi-dim data as fed and
                    # only records frame height/width)
                    v = arr.reshape(b, -1)
                return dict(value=v)
            if t.kind == "ids":
                ids = np.asarray(column, np.int64).reshape(b).astype(np.int32)
                return dict(ids=ids)
            if t.kind in ("sparse_binary", "sparse_float"):
                v = np.zeros((b,) + t.shape, np.float32)
                for i, row in enumerate(column):
                    if t.kind == "sparse_binary":
                        v[i, np.asarray(row, np.int64)] = 1.0
                    else:
                        idx, vals = _sparse_float_row(row)
                        v[i, np.asarray(idx, np.int64)] = np.asarray(
                            vals, np.float32
                        )
                return dict(value=v)
        if t.seq == 1:
            lens = np.asarray([len(s) for s in column], np.int32)
            tmax = _bucket(int(lens.max()) if b else 1, self.buckets)
            if t.kind == "ids":
                ids = np.zeros((b, tmax), np.int32)
                for i, s in enumerate(column):
                    ids[i, : len(s)] = np.asarray(s, np.int64)
                return dict(ids=ids, seq_lens=lens)
            v = np.zeros((b, tmax) + t.shape, np.float32)
            if t.kind in ("sparse_binary", "sparse_float"):
                # sequence of sparse rows: each timestep is an index
                # list (or (indices, values)) — PyDataProvider2's
                # sparse_*_vector_sequence slots
                for i, s in enumerate(column):
                    for ti, row in enumerate(s):
                        if t.kind == "sparse_binary":
                            v[i, ti, np.asarray(row, np.int64)] = 1.0
                        else:
                            idx, vals = _sparse_float_row(row)
                            v[i, ti, np.asarray(idx, np.int64)] = (
                                np.asarray(vals, np.float32)
                            )
                return dict(value=v, seq_lens=lens)
            for i, s in enumerate(column):
                v[i, : len(s)] = np.asarray(s, np.float32).reshape(
                    (len(s),) + t.shape
                )
            return dict(value=v, seq_lens=lens)
        if t.seq == 2:
            # sub-sequences: sample = list of list of tokens/vectors
            sub_lens = [[len(ss) for ss in s] for s in column]
            smax = max(len(s) for s in sub_lens)
            flat_lens = np.asarray([sum(s) for s in sub_lens], np.int32)
            tmax = _bucket(int(flat_lens.max()), self.buckets)
            subl = np.zeros((b, smax), np.int32)
            for i, s in enumerate(sub_lens):
                subl[i, : len(s)] = s
            if t.kind == "ids":
                ids = np.zeros((b, tmax), np.int32)
                for i, s in enumerate(column):
                    flat = [tok for ss in s for tok in ss]
                    ids[i, : len(flat)] = flat
                return dict(ids=ids, seq_lens=flat_lens, subseq_lens=subl)
            v = np.zeros((b, tmax) + t.shape, np.float32)
            for i, s in enumerate(column):
                flat = np.asarray(
                    [tok for ss in s for tok in ss], np.float32
                ).reshape(-1, *t.shape)
                v[i, : len(flat)] = flat
            return dict(value=v, seq_lens=flat_lens, subseq_lens=subl)
        raise ValueError(f"unsupported input type {t}")
