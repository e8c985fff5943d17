"""Asynchronous, overlapped sharded checkpointing: the JAX package's
`trainer/async_checkpoint.py` on the port, writing the same files.

The synchronous `checkpoint.save_pass` stalls training for the whole
device_get + serialize + write; at pod scale that stall is the
difference between elastic training and a training-time tax on every
snapshot (the reference's Go pserver checkpoints each shard from its
own goroutine for the same reason, go/pserver/service.go:76-126).
Here the only training-blocking work is the device->host snapshot;
serialization, hashing and the atomic-rename write happen on a
background thread behind a bounded queue.

On the card the snapshot copies every tensor device->host into pinned
buffers on a side stream (after the work queued on the current stream)
and the loop waits only until those copies have landed. The payload
then owns its bytes: the params, slots and layer state a CUDA graph of
train steps updates in place (`parallel/graph.py`) are overwritten by
the next replay while the writer still serializes the snapshot.

Format (`async-shard-v1`) — one directory per pass:

    save_dir/pass-00007/
        manifest.json        # {"pass_id", "num_shards", "meta", ...}
                             # written by process 0
        shard-p0.npz         # process 0's addressable shards,
                             # keys "<tree path>##<device id>"
        shard-p0.ok.json     # per-shard commit record: keys, nbytes,
                             # sha256 — written AFTER the npz rename
        shard-p1.npz ...     # one pair per process (the port runs
                             # one a rank on a mesh)

A pass is COMPLETE iff the manifest exists and every shard it names
has a matching `.ok.json` whose checksum verifies. Every file lands
via write-to-tmp + `os.replace`, so a SIGKILL at any instant leaves
either the previous complete pass or an incomplete new one — never a
loadable-looking lie. Torn or truncated shards fail the checksum and
the loader falls back to the newest older pass that verifies.

Failure contract: the background writer never lets an exception vanish
in a daemon thread. The first error is latched; the next `save()` or
`wait()` re-raises it as `AsyncCheckpointError`. Normal interpreter
exit drains every live writer via an atexit hook, so an
enqueued-but-unwritten pass survives a caller that forgets wait().
"""

from __future__ import annotations

import atexit
import hashlib
import json
import os
import queue
import random
import re
import shutil
import threading
import time
import weakref

import numpy as np
import torch

from paddle_tpu_torch.analysis.lock_order import named_lock
from paddle_tpu_torch.trainer.checkpoint import (
    _unflatten,
    _walk_arrays,
    check_leaf,
    host_array,
)

MANIFEST = "manifest.json"
FORMAT = "async-shard-v1"
_PASS_RE = re.compile(r"^pass-(\d{5})$")


def process_index() -> int:
    """This process's index among those that write a pass (the JAX
    package's `jax.process_index()`): its torch.distributed rank, 0
    without a process group."""
    import torch.distributed as dist

    return dist.get_rank() if dist.is_initialized() else 0


_rank = process_index  # write_shard's argument shadows the name


def process_count() -> int:
    """The number of processes that write a pass: the world's size."""
    import torch.distributed as dist

    return dist.get_world_size() if dist.is_initialized() else 1


# ---- sharded-table generations ---------------------------------------
# A second on-disk format for ShardedEmbeddingTable checkpoints. One
# directory per GENERATION; unlike async-shard-v1 the manifest is
# written FIRST (it names every table shard the generation will
# contain), so a writer SIGKILLed between shard N and N+1 leaves a
# manifest referencing a missing shard — exactly the torn state
# `verify_table_generation` must detect AND NAME, and
# `recover_table` must quarantine.
#
#     save_dir/gen-00012/
#         table_manifest.json   # format, generation, num_shards, meta
#         table-s0.npz          # shard 0 payload (sparse_shard
#                               # export_shards dict)
#         table-s0.ok.json      # keys, nbytes, sha256 — AFTER rename
#         table-s1.npz ...
TABLE_MANIFEST = "table_manifest.json"
TABLE_FORMAT = "sharded-table-v1"
_GEN_RE = re.compile(r"^gen-(\d{5})$")
QUARANTINE_DIR = "quarantine"


class AsyncCheckpointError(RuntimeError):
    """A background checkpoint write failed (re-raised on the caller)."""


# Every live AsyncCheckpointer; drained at interpreter exit so a pass
# that was enqueued but not yet written cannot be dropped by a normal
# `exit()` (daemon writer threads die mid-write at teardown). atexit
# runs while daemon threads are still scheduled, so q.join() drains.
# SIGKILL still loses the queue — that is what the manifest/fallback
# protocol is for.
_LIVE_CHECKPOINTERS: "weakref.WeakSet" = weakref.WeakSet()


@atexit.register
def _flush_live_checkpointers() -> None:
    import logging

    for cp in list(_LIVE_CHECKPOINTERS):
        try:
            cp.close()
        except Exception:
            logging.getLogger("paddle_tpu_torch.trainer").exception(
                "async checkpoint flush at interpreter exit failed"
            )


def _pass_dir(save_dir: str, pass_id: int) -> str:
    return os.path.join(save_dir, f"pass-{pass_id:05d}")


def _shard_name(process_index: int) -> str:
    return f"shard-p{process_index}.npz"


def _sha256(path: str) -> str:
    h = hashlib.sha256()
    with open(path, "rb") as f:
        while chunk := f.read(1 << 20):
            h.update(chunk)
    return h.hexdigest()


def _atomic_write_json(path: str, obj) -> None:
    tmp = path + ".tmp"
    with open(tmp, "w") as f:
        json.dump(obj, f)
        f.flush()
        os.fsync(f.fileno())
    os.replace(tmp, path)


INDEX_KEY = "__shard_index__"  # reserved payload entry, JSON as uint8


def _index_sig(index, shape) -> list:
    """Canonical JSON-able [[start, stop], ...] for a shard's slice
    tuple (None bounds resolved against the global shape)."""
    out = []
    for sl, dim in zip(index, shape):
        out.append([sl.start or 0,
                    dim if sl.stop is None else sl.stop])
    return out


_copy_streams: dict = {}  # device -> the side stream snapshots copy on


def snapshot_shards(tree, shards=None) -> dict:
    """Device->host snapshot of this process's shard of a tree (params /
    opt_state / state of tensors or numpy arrays) — the only part of an
    async save that blocks training. Keys `<tree path>##r<process
    index>`, the JAX package's keys for an array with one distinct
    shard on the process. `shards` ({tree path: (global shape,
    [[start, stop], ...])}, `TrainStep.shard_layout`) names the leaves
    that are this rank's slice of a mesh-sharded array: those are keyed
    `<tree path>##<rank>` (the rank in the JAX device id's place) and
    their global shape and slice recorded in the `__shard_index__`
    entry, as the JAX package records its sharded arrays, so a save at
    one world size loads at another.

    The payload owns its bytes: the caller's tensors are overwritten in
    place by the next train step (a CUDA graph's replay writes the
    static trees), while the background writer serializes the payload.
    Tensors on the card are copied into pinned host buffers on a side
    stream that first waits for the work queued on the current stream,
    and this call returns once those copies have landed."""
    pidx = process_index()
    shards = shards or {}
    idxmeta = {}

    def key(name):
        if name in shards:
            shape, sig = shards[name]
            idxmeta[name] = {"global_shape": list(shape),
                             "index": {str(pidx): [list(p) for p in sig]}}
            return f"{name}##{pidx}"
        return f"{name}##r{pidx}"

    payload = {}
    on_card = []
    for name, x in _walk_arrays(tree).items():
        if torch.is_tensor(x) and x.is_cuda:
            check_leaf(x, name)
            on_card.append((name, x))
        else:
            payload[key(name)] = np.array(host_array(x, name), copy=True)
    if on_card:
        dev = on_card[0][1].device
        side = _copy_streams.get(dev)
        if side is None:
            side = _copy_streams[dev] = torch.cuda.Stream(device=dev)
        side.wait_stream(torch.cuda.current_stream(dev))
        bufs = []
        with torch.cuda.stream(side):
            for name, x in on_card:
                buf = torch.empty(x.shape, dtype=x.dtype, pin_memory=True)
                buf.copy_(x.detach(), non_blocking=True)
                bufs.append((name, buf))
        side.synchronize()
        for name, buf in bufs:
            # the array keeps its pinned buffer alive
            payload[key(name)] = buf.numpy()
    if idxmeta:
        payload[INDEX_KEY] = np.frombuffer(
            json.dumps(idxmeta).encode(), np.uint8).copy()
    return payload


def write_shard(save_dir: str, pass_id: int, payload: dict,
                meta=None, num_shards: int = None,
                process_index: int = None) -> str:
    """Commit one process's shard of `pass_id` (atomic npz + .ok.json
    checksum sidecar); process 0 also writes the manifest. Safe to call
    from any thread/process; used by both the async writer thread and
    synchronous callers that want the manifested format."""
    pidx = _rank() if process_index is None else process_index
    nsh = process_count() if num_shards is None else num_shards
    d = _pass_dir(save_dir, pass_id)
    os.makedirs(d, exist_ok=True)
    shard = os.path.join(d, _shard_name(pidx))
    # savez appends ".npz" to a name without it; stage, fsync, rename
    tmp = shard[:-4] + ".tmp"
    with open(tmp, "wb") as f:
        np.savez(f, **payload)
        f.flush()
        os.fsync(f.fileno())
    os.replace(tmp, shard)
    _atomic_write_json(shard[:-4] + ".ok.json", {
        "keys": sorted(payload),
        "nbytes": os.path.getsize(shard),
        "sha256": _sha256(shard),
    })
    if pidx == 0:
        _atomic_write_json(os.path.join(d, MANIFEST), {
            "format": FORMAT,
            "pass_id": pass_id,
            "num_shards": nsh,
            "meta": dict(meta or {}),
        })
    return d


# ---- sharded-table generation API -----------------------------------


def _gen_dir(save_dir: str, generation: int) -> str:
    return os.path.join(save_dir, f"gen-{generation:05d}")


def _table_shard_name(shard_id: int) -> str:
    return f"table-s{shard_id}.npz"


def begin_table_generation(save_dir: str, generation: int,
                           num_shards: int, meta=None) -> str:
    """Open generation `generation`: write the manifest naming every
    shard it WILL contain. Written first on purpose — completeness is
    judged against this promise, so a writer killed mid-stride leaves
    a manifest pointing at a missing shard (detected, named, and
    quarantined by the recovery path) instead of a shorter manifest
    that lies about what the generation was meant to hold."""
    d = _gen_dir(save_dir, generation)
    os.makedirs(d, exist_ok=True)
    _atomic_write_json(os.path.join(d, TABLE_MANIFEST), {
        "format": TABLE_FORMAT,
        "generation": generation,
        "num_shards": num_shards,
        "meta": dict(meta or {}),
    })
    return d


def write_table_shard(save_dir: str, generation: int, shard_id: int,
                      payload: dict) -> str:
    """Commit one table shard: atomic npz + .ok.json sha256 sidecar
    (same tear-proof discipline as async-shard-v1)."""
    d = _gen_dir(save_dir, generation)
    shard = os.path.join(d, _table_shard_name(shard_id))
    tmp = shard[:-4] + ".tmp"
    with open(tmp, "wb") as f:
        np.savez(f, **payload)
        f.flush()
        os.fsync(f.fileno())
    os.replace(tmp, shard)
    _atomic_write_json(shard[:-4] + ".ok.json", {
        "keys": sorted(payload),
        "nbytes": os.path.getsize(shard),
        "sha256": _sha256(shard),
    })
    return shard


def write_table_generation(save_dir: str, generation: int,
                           payloads, meta=None) -> str:
    """Synchronous convenience: manifest + every shard in order. The
    async writer (`AsyncCheckpointer.save_table`) commits through the
    same two functions, so both paths tear identically under kill."""
    d = begin_table_generation(save_dir, generation, len(payloads),
                               meta=meta)
    for s, payload in enumerate(payloads):
        write_table_shard(save_dir, generation, s, payload)
    return d


def list_table_generations(save_dir: str) -> list:
    """Manifested generation ids, ascending (quarantine excluded)."""
    if not os.path.isdir(save_dir):
        return []
    out = []
    for name in os.listdir(save_dir):
        m = _GEN_RE.match(name)
        if m and os.path.exists(
            os.path.join(save_dir, name, TABLE_MANIFEST)
        ):
            out.append(int(m.group(1)))
    return sorted(out)


def verify_table_generation(save_dir: str, generation: int) -> tuple:
    """(ok, reason). Complete iff the manifest exists and EVERY shard
    it names has a matching npz + .ok.json whose size and sha256
    verify. The reason always NAMES the offending table shard — the
    operator of a 1B-row table needs 'table shard 3 of 8 torn', not
    'checkpoint bad'."""
    d = _gen_dir(save_dir, generation)
    try:
        with open(os.path.join(d, TABLE_MANIFEST)) as f:
            man = json.load(f)
    except (OSError, ValueError) as e:
        return False, f"table manifest unreadable: {e}"
    if man.get("format") != TABLE_FORMAT:
        return False, f"unknown table format {man.get('format')!r}"
    for s in range(man["num_shards"]):
        shard = os.path.join(d, _table_shard_name(s))
        ok_path = shard[:-4] + ".ok.json"
        if not os.path.exists(shard):
            return False, (
                f"table shard {s} of {man['num_shards']}: npz missing"
            )
        try:
            with open(ok_path) as f:
                ok = json.load(f)
        except (OSError, ValueError):
            return False, (
                f"table shard {s} of {man['num_shards']}: "
                f"missing/unreadable {ok_path}"
            )
        if os.path.getsize(shard) != ok["nbytes"]:
            return False, (
                f"table shard {s} of {man['num_shards']}: size "
                f"{os.path.getsize(shard)} != committed "
                f"{ok['nbytes']} (torn write)"
            )
        if _sha256(shard) != ok["sha256"]:
            return False, (
                f"table shard {s} of {man['num_shards']}: "
                f"checksum mismatch (corrupt)"
            )
    return True, "ok"


def latest_good_table_generation(save_dir: str) -> int:
    """Newest generation that verifies, or -1 (torn ones skipped with
    a warning naming the shard)."""
    import logging

    for gen in reversed(list_table_generations(save_dir)):
        ok, reason = verify_table_generation(save_dir, gen)
        if ok:
            return gen
        logging.getLogger("paddle_tpu_torch.trainer").warning(
            "table gen-%05d rejected (%s); falling back", gen, reason,
        )
    return -1


def quarantine_table_generation(save_dir: str, generation: int,
                                reason: str = "") -> str:
    """Move a torn generation aside into `quarantine/` (never delete:
    a half-written 1B-row table is evidence, and most of its shards
    are intact bytes an operator may still want). A `reason.txt`
    records why. Returns the quarantine path."""
    qdir = os.path.join(save_dir, QUARANTINE_DIR)
    os.makedirs(qdir, exist_ok=True)
    src = _gen_dir(save_dir, generation)
    dst = os.path.join(qdir, f"gen-{generation:05d}")
    n = 0
    while os.path.exists(dst):
        n += 1
        dst = os.path.join(qdir, f"gen-{generation:05d}.{n}")
    os.replace(src, dst)
    with open(os.path.join(dst, "reason.txt"), "w") as f:
        f.write(reason + "\n")
    return dst


def load_table_generation(save_dir: str, generation: int = -1) -> tuple:
    """Load one VERIFIED generation. Returns
    (generation, [shard payload dict, ...], meta). `generation=-1`
    loads the newest complete one; an explicit torn generation
    raises, naming the shard."""
    if generation < 0:
        generation = latest_good_table_generation(save_dir)
        if generation < 0:
            raise FileNotFoundError(
                f"no complete sharded-table generation in {save_dir}"
            )
    else:
        ok, reason = verify_table_generation(save_dir, generation)
        if not ok:
            raise ValueError(
                f"table gen-{generation:05d} incomplete: {reason}"
            )
    d = _gen_dir(save_dir, generation)
    with open(os.path.join(d, TABLE_MANIFEST)) as f:
        man = json.load(f)
    payloads = []
    for s in range(man["num_shards"]):
        with np.load(os.path.join(d, _table_shard_name(s))) as z:
            payloads.append({k: z[k] for k in z.files})
    return generation, payloads, man["meta"]


def recover_table(save_dir: str) -> tuple:
    """Quarantine-and-rebuild (the elastic resume entry point): every
    generation NEWER than the last good one that fails verification
    is moved to quarantine (reason names the shard), then the last
    good generation is loaded. Returns
    (generation, payloads, meta, [quarantine records]) — generation
    is -1 with empty payloads when nothing has committed yet (cold
    start)."""
    quarantined = []
    good = latest_good_table_generation(save_dir)
    for gen in list_table_generations(save_dir):
        if gen <= good:
            continue
        ok, reason = verify_table_generation(save_dir, gen)
        if not ok:
            path = quarantine_table_generation(save_dir, gen, reason)
            quarantined.append(
                {"generation": gen, "reason": reason, "path": path}
            )
    if good < 0:
        return -1, [], {}, quarantined
    gen, payloads, meta = load_table_generation(save_dir, good)
    return gen, payloads, meta, quarantined


def list_passes(save_dir: str) -> list:
    """Manifested pass ids, ascending (staging/.tmp names excluded)."""
    if not os.path.isdir(save_dir):
        return []
    out = []
    for name in os.listdir(save_dir):
        m = _PASS_RE.match(name)
        if m and os.path.exists(
            os.path.join(save_dir, name, MANIFEST)
        ):
            out.append(int(m.group(1)))
    return sorted(out)


def verify_pass(save_dir: str, pass_id: int) -> tuple:
    """(ok, reason). A pass verifies iff the manifest exists and every
    shard it names has an .ok.json whose size and sha256 match the npz
    on disk — a torn/truncated shard fails here, not at np.load."""
    d = _pass_dir(save_dir, pass_id)
    try:
        with open(os.path.join(d, MANIFEST)) as f:
            man = json.load(f)
    except (OSError, ValueError) as e:
        return False, f"manifest unreadable: {e}"
    if man.get("format") != FORMAT:
        return False, f"unknown format {man.get('format')!r}"
    for i in range(man["num_shards"]):
        shard = os.path.join(d, _shard_name(i))
        ok_path = shard[:-4] + ".ok.json"
        try:
            with open(ok_path) as f:
                ok = json.load(f)
        except (OSError, ValueError):
            return False, f"shard {i}: missing/unreadable {ok_path}"
        if not os.path.exists(shard):
            return False, f"shard {i}: npz missing"
        if os.path.getsize(shard) != ok["nbytes"]:
            return False, (
                f"shard {i}: size {os.path.getsize(shard)} != "
                f"committed {ok['nbytes']} (truncated?)"
            )
        if _sha256(shard) != ok["sha256"]:
            return False, f"shard {i}: checksum mismatch (corrupt)"
    return True, "ok"


def latest_complete_pass(save_dir: str) -> int:
    """Newest pass id that verifies, or -1. Incomplete/torn passes are
    skipped with a warning — the fall-back-to-previous-pass semantics
    of the reference's snapshot recovery (go/master/service.go:166)."""
    import logging

    for pid in reversed(list_passes(save_dir)):
        ok, reason = verify_pass(save_dir, pid)
        if ok:
            return pid
        logging.getLogger("paddle_tpu_torch.trainer").warning(
            "checkpoint pass-%05d rejected (%s); falling back",
            pid, reason,
        )
    return -1


def merge_npz_shards(paths) -> tuple:
    """Host-side merge of shard npz files. Returns
    (flat {tree key ##tag -> np}, index metadata {name -> {"global_shape",
    "index": {device id -> [[start, stop], ...]}}} unioned across
    files)."""
    flat = {}
    idxmeta: dict = {}
    for path in paths:
        with np.load(path) as z:
            for k in z.files:
                if k == INDEX_KEY:
                    meta = json.loads(bytes(z[k]).decode())
                    for name, m in meta.items():
                        cur = idxmeta.setdefault(
                            name,
                            {"global_shape": m["global_shape"],
                             "index": {}},
                        )
                        cur["index"].update(m["index"])
                else:
                    flat[k] = z[k]
    return flat, idxmeta


def _merge_shard_files(d: str, num_shards: int) -> tuple:
    return merge_npz_shards(
        os.path.join(d, _shard_name(i)) for i in range(num_shards)
    )


def _assemble_by_index(name: str, flat: dict, meta: dict):
    """Exact reassembly of one sharded array from its recorded slice
    map. Verifies full coverage — a shard map that leaves holes (e.g.
    a process count mismatch) is an error, not silent garbage."""
    shape = tuple(meta["global_shape"])
    first = flat[f"{name}##{next(iter(meta['index']))}"]
    out = np.empty(shape, first.dtype)
    covered = np.zeros(shape, bool)
    for dev, sig in meta["index"].items():
        sl = tuple(slice(a, b) for a, b in sig)
        out[sl] = flat[f"{name}##{dev}"]
        covered[sl] = True
    if not covered.all():
        raise ValueError(
            f"shard map for {name!r} does not cover the global shape "
            f"{shape} ({int(covered.sum())}/{covered.size} elements)"
        )
    return out


def assemble_host(flat: dict, idxmeta: dict) -> dict:
    """The tree of numpy arrays held by merged shard entries: per tree
    key the entries recorded with a slice map are reassembled by it;
    otherwise equal entries (replicas, or a single shard) give the
    first, and per-device entries of equal shape are concatenated along
    axis 0 in device-id order (a row sharding written without a map)."""
    by_name: dict = {}
    for k, v in flat.items():
        name, tag = k.rsplit("##", 1)
        by_name.setdefault(name, []).append((tag, v))
    out = {}
    for name, entries in by_name.items():
        if name in idxmeta:
            # exact slice map recorded at save time: reassemble any
            # sharding layout (axis 1, 2D tiles, ...) — never guess
            out[name] = _assemble_by_index(name, flat, idxmeta[name])
            continue
        arrs = [v for _, v in sorted(entries, key=lambda e: e[0])]
        same = all(a.shape == arrs[0].shape for a in arrs)
        if len(arrs) == 1 or (same and all(
            np.array_equal(a, arrs[0]) for a in arrs[1:]
        )):
            out[name] = arrs[0]  # replicated (or single shard)
        elif same and all(e[0].isdigit() for e in entries):
            arrs = [
                v for _, v in sorted(entries, key=lambda e: int(e[0]))
            ]
            out[name] = np.concatenate(arrs, axis=0)
        else:
            raise ValueError(
                f"cannot reassemble {name!r} without a slice map "
                f"(shapes {[a.shape for a in arrs]})"
            )
    return _unflatten(out)


def place_like(tree, template):
    """`tree` (numpy leaves) as tensors on the devices of `template`'s
    leaves (same nesting; each leaf's shape and dtype must match)."""
    if isinstance(template, dict):
        return {k: place_like(tree[k], t) for k, t in template.items()}
    got = torch.from_numpy(np.array(tree, copy=True))
    if got.shape != template.shape or got.dtype != template.dtype:
        raise ValueError(
            f"checkpoint leaf {tuple(got.shape)} {got.dtype} does not "
            f"match the template's {tuple(template.shape)} "
            f"{template.dtype}")
    return got.to(template.device)


def load_pass(save_dir: str, pass_id: int = -1, template=None):
    """Load an async-format pass; `pass_id=-1` = newest COMPLETE pass.
    Returns (tree, meta): numpy leaves (`assemble_host`), or with
    `template` (a tree of tensors) tensors placed like its leaves."""
    if pass_id < 0:
        pass_id = latest_complete_pass(save_dir)
        if pass_id < 0:
            raise FileNotFoundError(
                f"no complete async checkpoint pass in {save_dir}"
            )
    else:
        ok, reason = verify_pass(save_dir, pass_id)
        if not ok:
            raise ValueError(
                f"checkpoint pass-{pass_id:05d} incomplete: {reason}"
            )
    d = _pass_dir(save_dir, pass_id)
    with open(os.path.join(d, MANIFEST)) as f:
        man = json.load(f)
    man["meta"] = {"pass_id": man["pass_id"], **man["meta"]}
    flat, idxmeta = _merge_shard_files(d, man["num_shards"])
    tree = assemble_host(flat, idxmeta)
    if template is not None:
        tree = place_like(tree, template)
    return tree, man["meta"]


class AsyncCheckpointer:
    """Overlapped checkpoint writer.

    `save()` blocks only for the device->host snapshot (and for queue
    backpressure when `queue_depth` saves are already in flight), then
    returns; a single background thread serializes and commits shards.
    `wait()` drains the queue and raises the first latched write error.
    """

    def __init__(self, save_dir: str, keep_last: int = 0,
                 queue_depth: int = 2, retries: int = 3,
                 retry_base_s: float = 0.05,
                 retry_max_s: float = 0.5):
        """`keep_last=0` keeps every pass; `keep_last=n` rotates all but
        the newest n COMPLETE passes (the reference's save_only_one is
        keep_last=1, trainer/ParamUtil.h:77).

        `retries`: transient per-shard write failures (OSError from
        the background writer — NFS hiccup, momentary ENOSPC) are
        retried up to this many times with bounded jittered
        exponential backoff (`retry_base_s` doubling to
        `retry_max_s`) BEFORE latching into `last_error`. One blip
        must not poison the checkpointer; a persistent failure still
        surfaces on the next save()/wait()."""
        self.save_dir = save_dir
        self.keep_last = keep_last
        self.retries = max(0, int(retries))
        self.retry_base_s = retry_base_s
        self.retry_max_s = retry_max_s
        # instance-level write hooks: a fault-injection test wraps these
        # to fail N writes deterministically without monkeypatching the
        # module
        self._write_shard = write_shard
        self._write_table_shard = write_table_shard
        self._begin_table_generation = begin_table_generation
        self._q: queue.Queue = queue.Queue(maxsize=max(1, queue_depth))
        # known locks: instrumented under the lock-order checker
        # (analysis/lock_order.py)
        self._snap_lock = named_lock("ckpt.snapshot")
        self._err_lock = named_lock("ckpt.error")
        self._last_error: Exception | None = None
        self._verified: set = set()  # pass ids already proven complete
        # a pass enqueued on a mesh since the last wait()
        self._mesh_pass_pending = False
        self._thread = threading.Thread(
            target=self._worker, name="async-ckpt-writer", daemon=True
        )
        self._thread.start()
        self._closed = False
        _LIVE_CHECKPOINTERS.add(self)

    # ---- error contract ----
    @property
    def last_error(self) -> Exception | None:
        with self._err_lock:
            return self._last_error

    def _raise_if_failed(self):
        # surfacing CLEARS the latch: once the caller has seen the
        # error, the writer is usable again (a transient ENOSPC must
        # not poison every later run on the same trainer instance)
        with self._err_lock:
            err, self._last_error = self._last_error, None
        if err is not None:
            raise AsyncCheckpointError(
                f"background checkpoint write failed: {err!r}"
            ) from err

    # ---- producer ----
    def save(self, pass_id: int, params, opt_state=None, state=None,
             meta=None, shards=None) -> None:
        """Snapshot to host and enqueue the write. The tree layout
        mirrors `checkpoint.save_pass` (params/opt_state/state roots)
        so loaders can hand back the same triple. On a mesh every rank
        calls it, with `shards` (`TrainStep.shard_layout`) naming its
        sharded leaves; each writes its own shard file and rank 0 the
        manifest."""
        if self._closed:
            raise RuntimeError("AsyncCheckpointer is closed")
        self._raise_if_failed()
        tree = {"params": params}
        if opt_state is not None:
            tree["opt_state"] = opt_state
        if state:
            tree["state"] = state
        with self._snap_lock:
            payload = snapshot_shards(tree, shards)
        # on a mesh the pass is complete only once every rank's shard and
        # rank 0's manifest exist: wait() then meets the other ranks
        self._mesh_pass_pending |= process_count() > 1
        self._q.put(("pass", pass_id, payload, dict(meta or {})))

    def save_table(self, generation: int, payloads, meta=None) -> None:
        """Enqueue one sharded-table generation (`sharded-table-v1`):
        manifest first, then every shard payload with its sha256
        sidecar, all on the background writer. `payloads` must
        already own their bytes (ShardedEmbeddingTable.export_shards
        copies) — the table keeps training while this writes."""
        if self._closed:
            raise RuntimeError("AsyncCheckpointer is closed")
        self._raise_if_failed()
        self._q.put(("table", generation, list(payloads),
                     dict(meta or {})))

    # ---- consumer ----
    def _retrying(self, fn, *args, **kwargs):
        """Run one write, retrying TRANSIENT failures (OSError) with
        bounded jittered exponential backoff. Anything else — or an
        OSError that outlives the retry budget — propagates to the
        latch. Every file involved lands via write-to-tmp +
        os.replace, so a failed attempt never leaves a
        loadable-looking partial for the retry to trip over."""
        delay = self.retry_base_s
        for attempt in range(self.retries + 1):
            try:
                return fn(*args, **kwargs)
            except OSError:
                if attempt >= self.retries:
                    raise
                time.sleep(delay * (0.5 + random.random()))
                delay = min(delay * 2.0, self.retry_max_s)

    def _commit(self, item):
        kind = item[0]
        if kind == "pass":
            _k, pass_id, payload, meta = item
            self._retrying(self._write_shard, self.save_dir, pass_id,
                           payload, meta=meta)
            if self.keep_last and process_index() == 0:
                self._rotate(pass_id)
        else:
            _k, generation, payloads, meta = item
            self._retrying(self._begin_table_generation,
                           self.save_dir, generation, len(payloads),
                           meta=meta)
            for s, payload in enumerate(payloads):
                self._retrying(self._write_table_shard, self.save_dir,
                               generation, s, payload)

    def _worker(self):
        while True:
            item = self._q.get()
            if item is None:
                self._q.task_done()
                return
            try:
                self._commit(item)
            except Exception as e:  # latch; surface on save()/wait()
                with self._err_lock:
                    if self._last_error is None:
                        self._last_error = e
            finally:
                self._q.task_done()

    def _rotate(self, newest_pass: int):
        """Prune old passes, keeping the newest `keep_last` COMPLETE
        ones. Never removes a complete pass until enough newer complete
        ones exist — a crash mid-rotation still leaves a loadable
        checkpoint. Stale staging litter is swept too.

        Completeness verdicts are memoized: re-hashing every retained
        checkpoint on every save would make the background writer
        O(total checkpoint bytes) per save and backpressure the
        bounded queue into the training thread. (Rotation is not the
        integrity gate — load re-verifies from disk.)"""
        complete = []
        for p in list_passes(self.save_dir):
            if p not in self._verified and verify_pass(
                self.save_dir, p
            )[0]:
                self._verified.add(p)
            if p in self._verified:
                complete.append(p)
        for pid in complete[: -self.keep_last]:
            shutil.rmtree(
                _pass_dir(self.save_dir, pid), ignore_errors=True
            )
        for name in os.listdir(self.save_dir):
            if name.endswith(".tmp") and _PASS_RE.match(name[:-4]):
                shutil.rmtree(
                    os.path.join(self.save_dir, name),
                    ignore_errors=True,
                )

    # ---- draining ----
    def drain(self) -> None:
        """Block until this process's enqueued saves have committed;
        raise the first background write error if one occurred. It
        never meets the other ranks of a mesh: the drain of a rank that
        unwinds on its own (an error, a preemption) while the others
        may sit in another collective. A pass saved on a mesh may then
        still lack another rank's shard or rank 0's manifest."""
        self._q.join()
        self._raise_if_failed()

    def wait(self) -> None:
        """Block until every enqueued save has committed; raise the
        first background write error if one occurred.

        On a mesh every rank saves a pass and writes only its own shard
        (rank 0 also the manifest), so draining this rank's writer is
        not enough: after a pass was saved on more than one process,
        the ranks meet at a barrier of the world once each has drained
        its writer. Every rank then sees the pass complete
        (`latest_complete_pass`) when wait() returns. Every rank that
        saved must call wait() at the same point of its program, as it
        called save(); a rank whose write failed still meets the others
        before it raises. A rank that unwinds alone calls drain()."""
        self._q.join()
        if self._mesh_pass_pending:
            import torch.distributed as dist

            self._mesh_pass_pending = False
            dist.barrier()
        self._raise_if_failed()

    def close(self) -> None:
        """Drain, stop the writer thread, surface any error."""
        if self._closed:
            return
        _LIVE_CHECKPOINTERS.discard(self)
        self._q.join()
        self._closed = True
        self._q.put(None)
        self._thread.join(timeout=60)
        self._raise_if_failed()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()
