"""Checkpoint save/load: the JAX package's `trainer/checkpoint.py` on
the port, writing the same files.

Reference: per-pass parameter dirs with rotation and resume
(trainer/ParamUtil.h:77-108 saveParameters/loadParameters, save_only_one,
start_pass), v2 tar format (python/paddle/v2/parameters.py:304,323
to_tar/from_tar), and model merge for deployment (trainer/MergeModel.cpp).

Format: a directory per pass (`pass-%05d/`) holding `params.npz`,
`opt_state.npz` (the flattened tree), `state.npz` and `meta.json`. A
merged single-file deployable (config JSON + weights) is `model.npz`
via `merge_model`, the MergeModel.cpp analogue. The files are the JAX
package's: the same npz keys (`_flatten`'s "a/b/c" paths), dtypes,
`meta.json` and `__config__` JSON, so a pass, a merged model, a tar or
a parameter file written by either package loads in the other, bit for
bit.

Trees hold torch tensors (on any device) or numpy arrays; they are
written from host copies, and loaders return numpy arrays. Under the
mixed-precision cast rule every saved leaf is f32 (masters, slots, BN
state): a bf16 leaf raises rather than being cast. One process writes
(the JAX package's process 0; the rank under torch.distributed comes
with the mesh).
"""

from __future__ import annotations

import json
import os
import re
import shutil

import numpy as np
import torch

_PASS_DIR_RE = re.compile(r"^pass-(\d{5})$")


def check_leaf(x, name: str = "") -> None:
    """A bf16 or f16 tensor raises: the checkpoint format holds the f32
    masters, and a leaf in a half type would be a cast nobody asked
    for."""
    if torch.is_tensor(x) and x.dtype in (torch.bfloat16, torch.float16):
        raise ValueError(
            f"checkpoint leaf {name!r} is {x.dtype}: checkpoints hold f32 "
            f"masters, slots and layer state; a half-precision leaf is "
            f"not cast on save")


def host_array(x, name: str = "") -> np.ndarray:
    """A leaf as a numpy array on the host (a copy for a tensor on the
    card, `check_leaf`'s error for a half-precision one)."""
    if torch.is_tensor(x):
        check_leaf(x, name)
        return x.detach().cpu().numpy()
    return np.asarray(x)


def _flatten(tree, prefix=""):
    out = {}
    if isinstance(tree, dict):
        for k, v in tree.items():
            out.update(_flatten(v, f"{prefix}{k}/"))
    else:
        out[prefix[:-1]] = host_array(tree, prefix[:-1])
    return out


def _unflatten(flat: dict) -> dict:
    tree: dict = {}
    for key, v in flat.items():
        parts = key.split("/")
        d = tree
        for p in parts[:-1]:
            d = d.setdefault(p, {})
        d[parts[-1]] = v
    return tree


def _save_npz(path, tree):
    np.savez(path, **_flatten(tree))


def _load_npz(path):
    with np.load(path) as z:
        return _unflatten({k: z[k] for k in z.files})


def save_pass(
    save_dir: str,
    pass_id: int,
    params: dict,
    opt_state=None,
    state=None,
    meta=None,
    save_only_one=False,
):
    """Crash-safe: everything is written into a `pass-%05d.tmp/` staging
    directory and atomically renamed into place, so a SIGKILL mid-save
    never leaves a loadable-looking partial pass directory — the reader
    either sees the previous pass or the complete new one. Re-saving an
    existing pass parks the old dir at `pass-%05d.old` for the duration
    of the swap; the loader falls back to `.old` if a crash lands
    between the two renames, so even that window never loses the only
    checkpoint."""
    d = os.path.join(save_dir, f"pass-{pass_id:05d}")
    staging, old = d + ".tmp", d + ".old"
    shutil.rmtree(staging, ignore_errors=True)  # stale crash litter
    os.makedirs(staging)
    _save_npz(os.path.join(staging, "params.npz"), params)
    if opt_state is not None:
        _save_npz(os.path.join(staging, "opt_state.npz"), opt_state)
    if state:
        _save_npz(os.path.join(staging, "state.npz"), state)
    with open(os.path.join(staging, "meta.json"), "w") as f:
        json.dump({"pass_id": pass_id, **(meta or {})}, f)
        f.flush()
        os.fsync(f.fileno())
    if os.path.isdir(d):  # re-save of the same pass: two-rename swap
        shutil.rmtree(old, ignore_errors=True)
        os.replace(d, old)
    os.replace(staging, d)
    # committed: sweep the parked old copy (also heals a stale .old
    # left by a crash mid-swap on a previous run)
    shutil.rmtree(old, ignore_errors=True)
    if save_only_one:
        for name in os.listdir(save_dir):
            base = name
            for suf in (".tmp", ".old"):
                if name.endswith(suf):
                    base = name[: -len(suf)]
            if base != f"pass-{pass_id:05d}" and _PASS_DIR_RE.match(base):
                shutil.rmtree(os.path.join(save_dir, name), ignore_errors=True)
    return d


def _resolve_pass_dir(save_dir: str, pass_id: int):
    """The directory to read pass `pass_id` from: the committed dir,
    else its `.old` sibling (crash mid re-save swap), else None."""
    d = os.path.join(save_dir, f"pass-{pass_id:05d}")
    for cand in (d, d + ".old"):
        if os.path.exists(os.path.join(cand, "meta.json")):
            return cand
    return None


def list_sync_passes(save_dir: str) -> list:
    """Completed sync pass ids, ascending — `.tmp` staging dirs from an
    interrupted save are not passes, but a `.old` dir orphaned by a
    crash mid re-save swap still counts (the loader reads it)."""
    if not os.path.isdir(save_dir):
        return []
    out = set()
    for n in os.listdir(save_dir):
        base = n[:-4] if n.endswith(".old") else n
        m = _PASS_DIR_RE.match(base)
        if m and _resolve_pass_dir(save_dir, int(m.group(1))):
            out.add(int(m.group(1)))
    return sorted(out)


def load_pass(save_dir: str, pass_id: int = -1):
    """pass_id=-1 loads the latest. Returns (params, opt_state, state, meta)."""
    if pass_id < 0:
        passes = list_sync_passes(save_dir)
        if not passes:
            raise FileNotFoundError(f"no pass-* checkpoints in {save_dir}")
        pass_id = passes[-1]
    d = _resolve_pass_dir(save_dir, pass_id) or os.path.join(
        save_dir, f"pass-{pass_id:05d}"
    )
    params = _load_npz(os.path.join(d, "params.npz"))
    opt_state = state = None
    if os.path.exists(os.path.join(d, "opt_state.npz")):
        opt_state = _load_npz(os.path.join(d, "opt_state.npz"))
    if os.path.exists(os.path.join(d, "state.npz")):
        state = _load_npz(os.path.join(d, "state.npz"))
    with open(os.path.join(d, "meta.json")) as f:
        meta = json.load(f)
    return params, opt_state, state, meta


def load_parameter_file(path: str, dims=None) -> "np.ndarray":
    """One parameter in the reference's raw binary format
    (parameter/Parameter.cpp Parameter::load: a 16-byte
    {version=0, valueSize=4, size} header + float32 payload — also the
    per-member format inside v2 tars). `dims` reshapes the flat
    vector."""
    import struct

    with open(path, "rb") as f:
        head = f.read(16)
        version, vsize, n = struct.unpack(_TAR_HEADER, head)
        if version != 0 or vsize != 4:
            raise ValueError(
                f"{path}: unsupported parameter header "
                f"version={version} valueSize={vsize}"
            )
        arr = np.frombuffer(f.read(4 * n), np.float32).copy()
    if arr.size != n:
        raise ValueError(f"{path}: truncated parameter payload")
    return arr.reshape(dims) if dims is not None else arr


def save_parameter_file(path: str, arr) -> None:
    """Write one parameter in the reference's raw binary format
    (Parameter::save: the same 16-byte header + float32 payload
    load_parameter_file reads)."""
    import struct

    arr = host_array(arr, path).astype(np.float32, copy=False)
    with open(path, "wb") as f:
        f.write(struct.pack(_TAR_HEADER, 0, 4, arr.size))
        f.write(arr.tobytes())


def load_parameter_dir(model_dir: str, param_confs: dict) -> dict:
    """A reference model directory (trainer/ParamUtil.h loadParameters:
    one raw binary file per parameter, named by parameter) -> params
    dict shaped by `param_confs`."""
    params = {}
    for name, pc in param_confs.items():
        params[name] = load_parameter_file(
            os.path.join(model_dir, name), tuple(pc.dims)
        )
    return params


def merge_model(path: str, model_conf, params: dict, state=None):
    """Single-file deployable: config JSON + weights (MergeModel.cpp /
    capi merged model analogue)."""
    flat = _flatten({"params": params, "state": state or {}})
    np.savez(path, __config__=np.frombuffer(
        model_conf.to_json().encode(), dtype=np.uint8
    ), **flat)


def load_merged(path: str):
    from paddle_tpu_torch.core.config import ModelConf

    with np.load(path) as z:
        conf = ModelConf.from_json(bytes(z["__config__"]).decode())
        tree = _unflatten({k: z[k] for k in z.files if k != "__config__"})
    return conf, tree.get("params", {}), tree.get("state", {})


# --- per-process sharded checkpoints ----------------------------------
#
# Each process saves its own shard of the state and restores it on
# restart (the Go pserver's per-shard checkpoint/recover,
# go/pserver/service.go:76-126). The snapshot/assemble machinery is
# shared with the async manifested format (trainer/async_checkpoint.py):
# the same key scheme and reassembly, without the manifest, checksums
# and rotation. On one process (the port until the mesh) the shard is
# the whole tree.


def _walk_arrays(tree, prefix=""):
    out = {}
    if isinstance(tree, dict):
        for k, v in tree.items():
            out.update(_walk_arrays(v, f"{prefix}{k}/"))
    else:
        out[prefix[:-1]] = tree
    return out


def save_sharded(save_dir: str, tree, tag: str = "ckpt") -> str:
    """Write this process's shard of a tree: atomically commits
    `{tag}.p0.npz` (keys `<name>##r0`, async_checkpoint.snapshot_shards's
    scheme)."""
    from paddle_tpu_torch.trainer import async_checkpoint as actp

    os.makedirs(save_dir, exist_ok=True)
    payload = actp.snapshot_shards(tree)
    path = os.path.join(save_dir, f"{tag}.p{actp.PROCESS_INDEX}.npz")
    tmp = path[:-4] + ".tmp"
    with open(tmp, "wb") as f:
        np.savez(f, **payload)
        f.flush()
        os.fsync(f.fileno())
    os.replace(tmp, path)
    return path


def load_sharded(save_dir: str, template=None, tag: str = "ckpt"):
    """Restore this process's shard written by `save_sharded` as a tree
    of numpy arrays; with `template` (a tree of tensors), as tensors on
    each template leaf's device."""
    from paddle_tpu_torch.trainer import async_checkpoint as actp

    path = os.path.join(save_dir, f"{tag}.p{actp.PROCESS_INDEX}.npz")
    flat, idxmeta = actp.merge_npz_shards([path])
    tree = actp.assemble_host(flat, idxmeta)
    if template is None:
        return tree
    return actp.place_like(tree, template)


# --- v2 tar checkpoint format, wire-compatible with the reference ---
#
# parameters.py:280-302 serialize/deserialize: each parameter tar member is
# a 16-byte struct.pack("IIQ", 0, 4, size) header followed by raw
# little-endian float32 bytes; parameters.py:304-321 to_tar adds a
# "<name>.protobuf" member holding the serialized ParameterConfig proto
# (ParameterConfig.proto: name=1 string, size=2 uint64, dims=9 repeated
# uint64). We hand-encode that wire format (proto2, unpacked varints) so
# tars round-trip with the reference without a protobuf dependency.

_TAR_HEADER = "<IIQ"  # version=0, elem_size=4, num_elems


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


def _encode_param_config(name: str, shape, conf=None) -> bytes:
    """ParameterConfig wire message. `conf` (a core.config.ParameterConf)
    contributes the optional scalar fields the reference persists:
    learning_rate=3, momentum=4, initial_mean=5, initial_std=6,
    decay_rate=7, decay_rate_l1=8 (doubles), is_static=18,
    sparse_update=22 (bools)."""
    import struct

    size = 1
    for d in shape:
        size *= int(d)
    out = bytearray()
    nb = name.encode()
    out += b"\x0a" + _varint(len(nb)) + nb  # field 1, string
    out += b"\x10" + _varint(size)  # field 2, uint64

    def put_double(field, v):
        out.extend(_varint(field << 3 | 1) + struct.pack("<d", float(v)))

    if conf is not None:
        for field, attr in (
            (3, "learning_rate"),
            (4, "momentum"),
            (5, "initial_mean"),
            (6, "initial_std"),
            (7, "decay_rate"),
            (8, "decay_rate_l1"),
        ):
            v = getattr(conf, attr, None)
            if v is not None:
                put_double(field, v)
    for d in shape:  # field 9, repeated uint64 (unpacked)
        out += b"\x48" + _varint(int(d))
    if conf is not None:
        if getattr(conf, "is_static", False):
            out += _varint(18 << 3) + b"\x01"
        if getattr(conf, "sparse_update", False):
            out += _varint(22 << 3) + b"\x01"
    return bytes(out)


def _decode_param_config(data: bytes):
    """Return (name, dims) from a ParameterConfig wire message, skipping
    unknown fields (learning_rate etc. are irrelevant for loading)."""
    name, dims = None, []
    i, n = 0, len(data)

    def read_varint(i):
        v = s = 0
        while True:
            b = data[i]
            i += 1
            v |= (b & 0x7F) << s
            if not b & 0x80:
                return v, i
            s += 7

    while i < n:
        tag, i = read_varint(i)
        field, wire = tag >> 3, tag & 7
        if wire == 0:
            v, i = read_varint(i)
            if field == 9:
                dims.append(v)
        elif wire == 1:
            i += 8
        elif wire == 2:
            ln, i = read_varint(i)
            if field == 1:
                name = data[i : i + ln].decode()
            i += ln
        elif wire == 5:
            i += 4
        else:
            raise ValueError(f"unsupported wire type {wire}")
    return name, dims


def to_tar(f, params: dict, param_confs: dict = None):
    """Write parameters as a reference-compatible v2 checkpoint tar
    (python/paddle/v2/parameters.py:304 to_tar): one member per parameter
    holding a 16-byte (version=0, elem_size=4, num_elems) header + raw
    little-endian float32 bytes, plus a `<name>.protobuf` member with the
    serialized ParameterConfig (name/size/dims). `f` is a writable binary
    file object or a path."""
    import io
    import struct
    import tarfile

    own = isinstance(f, (str, os.PathLike))
    fh = open(f, "wb") if own else f
    try:
        with tarfile.open(fileobj=fh, mode="w") as tar:

            def add(name, data: bytes):
                info = tarfile.TarInfo(name=name)
                info.size = len(data)
                tar.addfile(info, io.BytesIO(data))

            for name in sorted(params):
                # NOT ascontiguousarray: it promotes 0-d arrays to 1-d,
                # losing the () shape; tobytes() copies to C order anyway
                arr = host_array(params[name], name).astype(np.float32,
                                                             copy=False)
                header = struct.pack(_TAR_HEADER, 0, 4, arr.size)
                add(name, header + arr.tobytes())
                conf = (param_confs or {}).get(name)
                add(
                    name + ".protobuf",
                    _encode_param_config(name, arr.shape, conf),
                )
    finally:
        if own:
            fh.close()


def from_tar(f) -> dict:
    """Read a v2 checkpoint tar back into {name: np.ndarray}
    (parameters.py:323 from_tar). Accepts tars written by `to_tar` or by
    the reference itself: skips the 16-byte member header and reshapes by
    the dims recorded in the `<name>.protobuf` sidecar."""
    import tarfile

    own = isinstance(f, (str, os.PathLike))
    raw: dict = {}
    shapes: dict = {}
    tar = tarfile.open(f) if own else tarfile.open(fileobj=f)
    with tar:
        for member in tar.getmembers():
            if not member.isfile():
                continue
            if member.name.endswith(".conf"):
                raise ValueError(
                    "legacy paddle_tpu tar (pre-reference-format, "
                    "'.conf' JSON sidecars); re-save with to_tar"
                )
            data = tar.extractfile(member).read()
            if member.name.endswith(".protobuf"):
                pname, dims = _decode_param_config(data)
                if pname is None:
                    pname = member.name[: -len(".protobuf")]
                shapes[pname] = dims
            else:
                # copy: frombuffer over tar bytes is read-only
                raw[member.name] = np.frombuffer(
                    data[16:], np.float32
                ).copy()
    return {
        k: v.reshape(shapes[k]) if k in shapes else v
        for k, v in raw.items()
    }
