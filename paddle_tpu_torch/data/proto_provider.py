"""ProtoDataProvider binary dataset format, wire-compatible reader: a
copy of `paddle_tpu/data/proto_provider.py` onto the port's feeder
(`data/feeder.py`).

Reference: proto/DataFormat.proto + gserver/dataproviders/
ProtoDataProvider.h:48 and ProtoReader.h:30-101 — a data file is a
stream of varint32-length-delimited proto2 messages (optionally gzip),
first a DataHeader (slot type/dim declarations), then one DataSample
per sample; consecutive samples with is_beginning=false continue the
previous sample's sequence (ProtoDataProvider.cpp:223 loop).

Hand-rolled proto2 wire codec (same approach as the ParameterConfig
sidecar in trainer/checkpoint.py) — no protobuf dependency. The writer
exists so tests (and users migrating away from the format) can
round-trip files; the reader yields samples in the DataFeeder's slot
conventions, so `proto_reader(paths)` drops into the same training
pipelines as every other reader.

Slot type mapping (SlotDef.SlotType -> feeder InputType):
  VECTOR_DENSE            -> dense_vector(dim)
  VECTOR_SPARSE_NON_VALUE -> sparse_binary_vector(dim)  (ids list)
  VECTOR_SPARSE_VALUE     -> sparse_float_vector(dim)   ((ids, vals))
  INDEX                   -> integer_value(dim)
Sequences (is_beginning grouping) wrap each slot value in a list —
the *_sequence flavor of the same types. VAR_MDIM_* and STRING slots
are accepted by the parser; they have no feeder slot and surface as
raw lists for user code.
"""

from __future__ import annotations

import gzip
import io
import struct

import numpy as np

from paddle_tpu_torch.data import feeder as _feeder

# SlotDef.SlotType
VECTOR_DENSE = 0
VECTOR_SPARSE_NON_VALUE = 1
VECTOR_SPARSE_VALUE = 2
INDEX = 3
VAR_MDIM_DENSE = 4
VAR_MDIM_INDEX = 5
STRING = 6


# ---- proto2 wire primitives ----

def _read_varint(buf, i):
    v = s = 0
    while True:
        b = buf[i]
        i += 1
        v |= (b & 0x7F) << s
        if not b & 0x80:
            return v, i
        s += 7


def _varint(n: int) -> bytes:
    out = bytearray()
    while True:
        b = n & 0x7F
        n >>= 7
        if n:
            out.append(b | 0x80)
        else:
            out.append(b)
            return bytes(out)


def _fields(buf):
    """Yield (field_number, wire_type, value) over a message body."""
    i, n = 0, len(buf)
    while i < n:
        key, i = _read_varint(buf, i)
        field, wt = key >> 3, key & 7
        if wt == 0:
            v, i = _read_varint(buf, i)
        elif wt == 2:
            ln, i = _read_varint(buf, i)
            v = buf[i : i + ln]
            i += ln
        elif wt == 5:
            v = buf[i : i + 4]
            i += 4
        elif wt == 1:
            v = buf[i : i + 8]
            i += 8
        else:
            raise ValueError(f"unsupported wire type {wt}")
        yield field, wt, v


def _packed_u32(data: bytes):
    out, i = [], 0
    while i < len(data):
        v, i = _read_varint(data, i)
        out.append(v)
    return out


def _packed_f32(data: bytes):
    return list(struct.unpack(f"<{len(data) // 4}f", data))


# ---- message parsers ----

def _parse_slot_def(buf):
    t = dim = 0
    for f, wt, v in _fields(buf):
        if f == 1:
            t = v
        elif f == 2:
            dim = v
    return (t, dim)


def parse_header(buf):
    """DataHeader -> [(slot_type, dim)]."""
    return [
        _parse_slot_def(v) for f, wt, v in _fields(buf) if f == 1
    ]


def _parse_vector_slot(buf):
    values, ids, dims, strs = [], [], [], []
    for f, wt, v in _fields(buf):
        if f == 1:
            values.extend(
                _packed_f32(v) if wt == 2
                else struct.unpack("<f", v)
            )
        elif f == 2:
            ids.extend(_packed_u32(v) if wt == 2 else [v])
        elif f == 3:
            dims.extend(_packed_u32(v) if wt == 2 else [v])
        elif f == 4:
            strs.append(v.decode())
    return {"values": values, "ids": ids, "dims": dims, "strs": strs}


def _parse_sample(buf):
    s = {
        "is_beginning": True,
        "vector_slots": [],
        "id_slots": [],
        "var_id_slots": [],
        "subseq_slots": [],
    }
    for f, wt, v in _fields(buf):
        if f == 1:
            s["is_beginning"] = bool(v)
        elif f == 2:
            s["vector_slots"].append(_parse_vector_slot(v))
        elif f == 3:
            s["id_slots"].extend(
                _packed_u32(v) if wt == 2 else [v]
            )
        elif f == 4:
            s["var_id_slots"].append(_parse_vector_slot(v))
        elif f == 5:
            s["subseq_slots"].append(bytes(v))
    return s


def _iter_messages(raw: bytes):
    i = 0
    while i < len(raw):
        ln, i = _read_varint(raw, i)
        yield raw[i : i + ln]
        i += ln


def _vector_to_slot(slot_type, vs):
    if slot_type == VECTOR_DENSE:
        return np.asarray(vs["values"], np.float32)
    if slot_type == VECTOR_SPARSE_NON_VALUE:
        return list(vs["ids"])
    if slot_type == VECTOR_SPARSE_VALUE:
        return (list(vs["ids"]), list(vs["values"]))
    return vs  # VAR_MDIM/STRING: raw


def read_proto_data(path: str, compressed: bool | None = None):
    """Parse one ProtoDataProvider file.

    Returns (slot_defs, samples): slot_defs = [(type, dim)];
    samples = list of per-sample slot tuples in feeder conventions.
    Rows with is_beginning=false are returned as separate entries with
    a parallel `beginnings` bool list via the 3-tuple return of
    read_proto_data_raw; use `group_sequences` (or proto_reader) for
    the sequence-grouped view."""
    defs, rows, _ = read_proto_data_raw(path, compressed)
    return defs, rows


def read_proto_data_raw(path: str, compressed: bool | None = None,
                        skip_bad_records: int = 0):
    """`skip_bad_records=N`: up to N records that fail to parse
    (bit-flipped media, torn writes) are dropped with a counted
    warning instead of aborting the pass — the reader's half of the
    watchdog's bad-data story. A corrupted varint LENGTH can desync
    the frame stream; a desync surfaces as parse failures and is
    bounded by the same budget, so a rotten file still fails loudly
    once the budget is spent. 0 = strict (any bad record raises).
    The header must always parse — without slot types nothing after
    it is interpretable."""
    import logging

    with open(path, "rb") as f:
        raw = f.read()
    if compressed or (compressed is None and raw[:2] == b"\x1f\x8b"):
        raw = gzip.decompress(raw)
    msgs = _iter_messages(raw)
    try:
        header = parse_header(next(msgs))
    except StopIteration:
        return [], [], []
    rows, begins = [], []
    bad = 0
    while True:
        try:
            m = next(msgs)
        except StopIteration:
            break
        except Exception as e:
            # framing (varint) error: the rest of the stream is
            # unrecoverable — count it as ONE bad record and stop
            bad += 1
            if bad > skip_bad_records:
                raise ValueError(
                    f"{path}: corrupt record stream ({e}); "
                    f"{bad} bad record(s), budget {skip_bad_records}"
                ) from e
            logging.getLogger("paddle_tpu_torch.data").warning(
                "%s: frame stream desynced (%s); dropping the tail "
                "(%d/%d skips used)", path, e, bad, skip_bad_records,
            )
            break
        try:
            s = _parse_sample(m)
            slots = []
            vi = ii = 0
            for t, dim in header:
                if t == INDEX:
                    slots.append(int(s["id_slots"][ii]))
                    ii += 1
                elif t == VAR_MDIM_INDEX:
                    slots.append(list(s["var_id_slots"][vi]["ids"]))
                    vi += 1
                else:
                    slots.append(
                        _vector_to_slot(t, s["vector_slots"][vi])
                    )
                    vi += 1
        except Exception as e:
            bad += 1
            if bad > skip_bad_records:
                raise ValueError(
                    f"{path}: undecodable record ({type(e).__name__}: "
                    f"{e}); {bad} bad record(s), budget "
                    f"{skip_bad_records}"
                ) from e
            logging.getLogger("paddle_tpu_torch.data").warning(
                "%s: skipping undecodable record (%s) — %d/%d skips "
                "used", path, type(e).__name__, bad, skip_bad_records,
            )
            continue
        rows.append(tuple(slots))
        begins.append(s["is_beginning"])
    return header, rows, begins


def group_sequences(rows, begins):
    """ProtoDataProvider sequence semantics: consecutive rows with
    is_beginning=false extend the sequence opened by the last
    is_beginning=true row. Returns samples whose slots are LISTS of the
    member rows' slot values (the feeder's sequence flavor)."""
    out = []
    for row, b in zip(rows, begins):
        if b or not out:
            out.append(tuple([v] for v in row))
        else:
            for acc, v in zip(out[-1], row):
                acc.append(v)
    return out


def proto_reader(paths, compressed=None, skip_bad_records: int = 0):
    """Reader over ProtoDataProvider files (the reader-combinator
    entry): yields per-sample slot tuples; multi-row sequences arrive
    in the feeder's sequence shape. `skip_bad_records` bounds how many
    corrupt records per FILE are dropped (with a warning) before the
    pass aborts — see read_proto_data_raw."""
    if isinstance(paths, str):
        paths = [paths]

    def reader():
        for p in paths:
            _, rows, begins = read_proto_data_raw(
                p, compressed, skip_bad_records=skip_bad_records
            )
            if all(begins):
                yield from rows
            else:
                yield from group_sequences(rows, begins)

    return reader


def input_types(slot_defs, sequences=False):
    """[(type, dim)] -> feeder InputTypes (for DataFeeder wiring)."""
    seq = 1 if sequences else 0
    out = []
    for t, dim in slot_defs:
        if t == VECTOR_DENSE:
            out.append(_feeder.dense_vector(dim, seq))
        elif t == VECTOR_SPARSE_NON_VALUE:
            out.append(_feeder.sparse_binary_vector(dim, seq))
        elif t == VECTOR_SPARSE_VALUE:
            out.append(_feeder.sparse_float_vector(dim, seq))
        elif t == INDEX:
            out.append(_feeder.integer_value(dim, seq))
        else:
            raise ValueError(
                f"slot type {t} has no feeder input type"
            )
    return out


# ---- writer (round-trip tests + migration tooling) ----

def _emit_vector_slot(slot_type, value) -> bytes:
    out = bytearray()
    if slot_type == VECTOR_DENSE:
        data = struct.pack(f"<{len(value)}f", *value)
        out += b"\x0a" + _varint(len(data)) + data
    elif slot_type == VECTOR_SPARSE_NON_VALUE:
        data = b"".join(_varint(int(i)) for i in value)
        out += b"\x12" + _varint(len(data)) + data
    elif slot_type == VECTOR_SPARSE_VALUE:
        ids, vals = value
        data = struct.pack(f"<{len(vals)}f", *vals)
        out += b"\x0a" + _varint(len(data)) + data
        data = b"".join(_varint(int(i)) for i in ids)
        out += b"\x12" + _varint(len(data)) + data
    else:
        raise ValueError(f"writer does not support slot type {slot_type}")
    return bytes(out)


def write_proto_data(path, slot_defs, samples, beginnings=None,
                     compressed=False):
    """Emit a DataFormat.proto file the reference's ProtoDataProvider
    (and our reader) can load. samples: per-row slot tuples;
    beginnings: optional per-row is_beginning flags."""
    body = io.BytesIO()

    def put(msg: bytes):
        body.write(_varint(len(msg)) + msg)

    header = bytearray()
    for t, dim in slot_defs:
        sd = b"\x08" + _varint(t) + b"\x10" + _varint(dim)
        header += b"\x0a" + _varint(len(sd)) + sd
    put(bytes(header))

    for r, row in enumerate(samples):
        msg = bytearray()
        if beginnings is not None and not beginnings[r]:
            msg += b"\x08\x00"  # is_beginning = false
        for (t, dim), v in zip(slot_defs, row):
            if t == INDEX:
                msg += b"\x18" + _varint(int(v))
            else:
                vs = _emit_vector_slot(t, v)
                msg += b"\x12" + _varint(len(vs)) + vs
        put(bytes(msg))

    raw = body.getvalue()
    if compressed:
        raw = gzip.compress(raw)
    with open(path, "wb") as f:
        f.write(raw)
