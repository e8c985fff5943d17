"""Python side of the C inference ABI — `paddle_tpu/capi_bridge.py` for
the port.

The C library (`native/src/capi.cc`, built as
`build/native/libpaddle_tpu_torch_capi.so` by `native.build_capi`)
embeds CPython — the same trick the reference uses to run Python
config parsing inside the C++ trainer (utils/PythonUtil.h) — and calls
these functions with raw buffer addresses. All numpy/ctypes
marshaling lives here so the C side stays a thin ABI: create (load a
merged model), forward (fill caller buffers), destroy. The library
exports the JAX package's `pt_capi_*` symbols with the same header, so
a C program built for that library runs against this one unchanged.

Reference surface being reproduced: paddle/capi/gradient_machine.h:36-75
(paddle_gradient_machine_create_for_inference_with_parameters + forward)
with capi/matrix.h-style dense row-major float buffers.

The device: `create` loads the model on the card. With
`PADDLE_TPU_FORCE_CPU` set in the environment (the JAX bridge's own
contract for serving hosts without an accelerator, and the CPU tests)
it loads it on the CPU. Without a card and without that variable
`create` fails, and `pt_capi_error` gives the reason: the bridge never
falls back to the CPU, and a kernel that fails to build or launch is an
error, never a CPU retry.

Inside a C host `sys.executable` is the C program: nothing on this path
spawns it or uses `multiprocessing` (the kernels build with nvcc
subprocesses; a caller builds them before it starts a C program). Every
call holds the GIL (the C side's PyGILState_Ensure), makes its tensors
on the model's explicit device and copies the output to the caller's
buffer only once the device result is on the host.
"""

from __future__ import annotations

import ctypes
import itertools
import os

import numpy as np
import torch

from paddle_tpu_torch.core.arg import Arg, id_arg, pad_ragged, seq, sub_seq

_HANDLES: dict = {}
_NEXT = itertools.count(1)  # atomic under the GIL


class Slot(ctypes.Structure):
    """`pt_capi_slot` of `native/include/pt_capi.h`, field for field,
    for a Python caller of `pt_capi_forward_slots` through ctypes."""

    _fields_ = [("name", ctypes.c_char_p), ("kind", ctypes.c_int),
                ("buf", ctypes.c_void_p),
                ("shape", ctypes.POINTER(ctypes.c_int64)),
                ("ndims", ctypes.c_int),
                ("seq_pos", ctypes.POINTER(ctypes.c_int32)),
                ("n_seq", ctypes.c_int),
                ("subseq_pos", ctypes.POINTER(ctypes.c_int32)),
                ("n_subseq", ctypes.c_int), ("width", ctypes.c_int64),
                ("rows", ctypes.POINTER(ctypes.c_int32)),
                ("cols", ctypes.POINTER(ctypes.c_int32)),
                ("vals", ctypes.POINTER(ctypes.c_float)),
                ("height", ctypes.c_int64), ("nnz", ctypes.c_int64)]


def _device() -> str:
    return "cpu" if os.environ.get("PADDLE_TPU_FORCE_CPU") else "cuda"


def create(merged_path: str, output_layer: str = "") -> int:
    """Load a merged model file; returns an integer handle."""
    from paddle_tpu_torch.trainer.trainer import Inferencer

    inf = Inferencer.from_merged(
        merged_path, outputs=[output_layer] if output_layer else None,
        device=_device(),
    )
    h = next(_NEXT)
    _HANDLES[h] = inf
    return h


def output_dim(h: int) -> int:
    inf = _HANDLES[h]
    name = inf.output_names[0]
    spec = inf.net.specs[name]
    return int(spec.size)


def _value(a: np.ndarray) -> Arg:
    return Arg(value=torch.from_numpy(np.ascontiguousarray(a, np.float32)))


def forward(
    h: int,
    names: list,
    addrs: list,
    shapes: list,
    is_ids: list,
    out_addr: int,
    out_capacity: int,
) -> list:
    """Run inference. Inputs arrive as (name, buffer address, shape,
    is_ids) quadruples; the first output layer's value is written into
    out_addr (float32, row-major) if it fits. Returns the output shape
    as a list of ints."""
    inf = _HANDLES[h]
    feed = {}
    for name, addr, shape, ids in zip(names, addrs, shapes, is_ids):
        n = int(np.prod(shape))
        if ids:
            feed[name] = id_arg(_read_i32(addr, n).reshape(shape))
        else:
            feed[name] = _value(_read_f32(addr, n).reshape(shape))
    return _write_output(inf, feed, out_addr, out_capacity)


def _write_output(inf, feed: dict, out_addr: int,
                  out_capacity: int) -> list:
    """Run inference and copy the first output layer's value into the
    caller's float buffer; returns the output shape. Rank is capped at
    8 — the C side writes at most 8 dims into out_shape, so a larger
    rank must fail loudly rather than return dims the caller can't
    see. `Inferencer.infer` returns host arrays: the device result is
    ready before the copy."""
    outs = inf.infer(feed)
    out = np.ascontiguousarray(outs[inf.output_names[0]], np.float32)
    if out.ndim > 8:
        raise ValueError(f"output rank {out.ndim} exceeds the C ABI's 8")
    if out.size > out_capacity:
        raise ValueError(
            f"output needs {out.size} floats, caller buffer has "
            f"{out_capacity}"
        )
    dst = (ctypes.c_float * out.size).from_address(out_addr)
    ctypes.memmove(dst, out.ctypes.data, out.nbytes)
    return list(out.shape)


def _read_i32(addr: int, n: int) -> np.ndarray:
    buf = (ctypes.c_int32 * n).from_address(addr)
    return np.frombuffer(buf, np.int32).copy()


def _read_f32(addr: int, n: int) -> np.ndarray:
    buf = (ctypes.c_float * n).from_address(addr)
    return np.frombuffer(buf, np.float32).copy()


def _slot_to_arg(s: dict):
    """One pt_capi_slot (dict of addresses/sizes) -> the port's Arg of
    CPU tensors. Kinds mirror the reference input surface: dense/id
    matrices (capi/matrix.h, vector.h), sequence start positions incl.
    one nested level (capi/arguments.h:137), sparse CSR
    (capi/matrix.h:52,102-114)."""
    kind = s["kind"]
    shape = [int(d) for d in s["shape"]]
    if kind == 0:  # dense float
        n = int(np.prod(shape)) if shape else 0
        return _value(_read_f32(s["buf"], n).reshape(shape))
    if kind == 1:  # dense ids
        n = int(np.prod(shape)) if shape else 0
        return id_arg(_read_i32(s["buf"], n).reshape(shape))
    if kind in (2, 3):  # ragged sequence (ids / dense rows)
        if not s["seq_pos"] or s["n_seq"] < 2:
            raise ValueError("sequence slot needs start positions")
        pos = _read_i32(s["seq_pos"], s["n_seq"])
        total = int(pos[-1])
        if kind == 2:
            flat = _read_i32(s["buf"], total)
        else:
            w = int(s["width"])
            if w <= 0:
                raise ValueError("PT_SLOT_SEQ_DENSE needs width > 0")
            flat = _read_f32(s["buf"], total * w).reshape(total, w)
        if s["subseq_pos"] and s["n_subseq"] >= 2:
            # nested level: subseq_pos refines the same timestep axis,
            # so it must be a superset of seq_pos's boundaries — a
            # malformed refinement would silently mask real timesteps
            sub = _read_i32(s["subseq_pos"], s["n_subseq"])
            if not np.isin(pos, sub).all():
                raise ValueError(
                    "subseq start positions must include every "
                    f"sequence boundary: seq_pos={pos.tolist()}, "
                    f"subseq_pos={sub.tolist()}"
                )
            if not (np.diff(sub) > 0).all():
                raise ValueError(
                    "subseq start positions must be strictly increasing"
                )
            sub_lens = []
            for i in range(len(pos) - 1):
                cuts = sub[(sub >= pos[i]) & (sub <= pos[i + 1])]
                sub_lens.append(np.diff(cuts).astype(np.int32))
            smax = max(len(x) for x in sub_lens)
            padded_sub = np.zeros((len(sub_lens), smax), np.int32)
            for i, x in enumerate(sub_lens):
                padded_sub[i, : len(x)] = x
            # flatten each sequence's timesteps then pad (sub_seq packs
            # [B, T] with per-subsequence lengths)
            padded, _ = pad_ragged(flat, pos)
            return sub_seq(padded, padded_sub, is_ids=(kind == 2))
        padded, lens = pad_ragged(flat, pos)
        if kind == 2:
            return id_arg(padded, lens)
        return seq(padded, lens)
    if kind in (4, 5):  # sparse CSR [height, width] -> dense
        h, w, nnz = int(s["height"]), int(s["width"]), int(s["nnz"])
        if w <= 0 or h <= 0:
            raise ValueError("sparse slot needs height/width > 0")
        rows = _read_i32(s["rows"], h + 1)
        cols = _read_i32(s["cols"], nnz)
        # validate like the sequence slots do: a negative column index
        # would wrap via numpy indexing and silently scatter into the
        # wrong feature; malformed row offsets would drop/alias values
        if ((cols < 0) | (cols >= w)).any():
            raise ValueError(
                f"sparse col indices must be in [0, {w}); got "
                f"min={cols.min() if nnz else 0}, "
                f"max={cols.max() if nnz else 0}"
            )
        if (np.diff(rows) < 0).any() or rows[0] != 0 or rows[-1] != nnz:
            raise ValueError(
                "sparse row offsets must be non-decreasing with "
                f"rows[0]=0 and rows[{h}]=nnz={nnz}; got "
                f"rows[0]={int(rows[0])}, rows[-1]={int(rows[-1])}"
            )
        vals = (
            _read_f32(s["vals"], nnz)
            if kind == 5
            else np.ones(nnz, np.float32)
        )
        dense = np.zeros((h, w), np.float32)
        for i in range(h):
            sl = slice(rows[i], rows[i + 1])
            dense[i, cols[sl]] = vals[sl]
        return _value(dense)
    raise ValueError(f"unknown slot kind {kind}")


def forward_slots(h: int, slots: list, out_addr: int,
                  out_capacity: int) -> list:
    """Full-surface forward: dense, ids, ragged-sequence (with optional
    nested level) and sparse CSR input slots. Returns the first output
    layer's shape; the value is written to out_addr (float32)."""
    inf = _HANDLES[h]
    feed = {s["name"]: _slot_to_arg(s) for s in slots}
    return _write_output(inf, feed, out_addr, out_capacity)


def destroy(h: int) -> None:
    _HANDLES.pop(h, None)
