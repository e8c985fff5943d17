"""Inference API: the JAX package's `inference.py` front door on the
port (reference: python/paddle/v2/inference.py:9,93 — `Inference`
wrapping the network in test mode, module-level `infer(output=...,
input=...)`). The runner is `trainer.trainer.Inferencer`; a merged
model loads through `Inferencer.from_merged`.

The verified program cache (`store_verified` / `load_verified`), the
port's meaning of the JAX package's verified AOT cache: an entry holds
a `torch.export` program (`program.pt2`, inside the JAX package's
checksummed envelope, the same byte format and version byte), its
graph as JSON records (`program.graph.json`, one per node: the target
and the output's shape, dtype and device — the counterpart of
`program.hlo.txt`) and `meta.json` (sha256 over every file, the torch
version, the device, the example arguments and the audit policy). A
replica boots only from an entry whose digests match AND whose graph
passes the port's audit (`audit_graph`: `total_bytes_max`,
`host_transfer_budget`, `n_instructions_max`; any other policy key is
refused, never silently passed). Entries are published atomically (a
temp dir, then a rename), so a writer SIGKILLed mid-store leaves no
half-visible entry.

Compiled artifacts: `export_compiled(inferencer, example_feed)` exports
the Inferencer's forward, `(params, state, feed) -> {name: Arg}`, with
`torch.export` at the example feed's shapes (as the JAX export is
specialised to them) and returns the checksummed envelope around
`torch.export.save`'s bytes; `load_compiled(blob, source=...)` checks
the envelope first (a torn or corrupt blob raises CompiledArtifactError
naming `source` before `torch.export.load` sees a byte) and returns
`fn(params, state, feed) -> {name: Arg}`. The port's kernels are the
`paddle_tpu_torch::` custom ops (`ops/_library.py`), so the exported
graph holds them as nodes: loading needs their registrations (this
module imports the op modules), not the model-building code. `Arg` is a
pytree node with a stable serialized type name. The verified cache
stores such a program as well (`store_verified` takes a Network forward
as any other module).
"""

from __future__ import annotations

import torch

from paddle_tpu_torch.core.arg import Arg
# the kernels' custom ops: a loaded program's nodes need them registered
from paddle_tpu_torch.ops import (  # noqa: F401
    bn_act_conv1x1,
    flash_attention,
    rnn,
    sparse_rows,
)
from paddle_tpu_torch.trainer.trainer import Inferencer

Inference = Inferencer  # v2 name

__all__ = ["Inference", "Inferencer", "infer", "export_compiled",
           "load_compiled", "InferencerForward", "CompiledArtifactError",
           "VerifiedCacheError", "store_verified", "load_verified",
           "has_verified", "audit_graph", "VerifiedProgram",
           "CACHE_META_SCHEMA"]


class CompiledArtifactError(ValueError):
    """Typed envelope failure. `reason` is one of: truncated, corrupt,
    version, no_envelope, deserialize. Subclasses ValueError so
    `except ValueError` handlers keep catching it."""

    def __init__(self, source: str, reason: str, detail: str):
        super().__init__(
            f"compiled artifact {source!r} is {reason}: {detail}"
        )
        self.source = source
        self.reason = reason


class VerifiedCacheError(RuntimeError):
    """The verified cache refused an entry at boot (or a program at
    store). `reason` is one of: missing, meta, digest, audit."""

    def __init__(self, reason: str, detail: str):
        super().__init__(f"verified cache refused ({reason}): {detail}")
        self.reason = reason


# envelope: magic + version byte + sha256(payload) + payload — the JAX
# package's format byte for byte. The digest rejects a torn or
# bit-flipped artifact with a typed CompiledArtifactError BEFORE the
# bytes reach a deserializer. The port writes only this version, so a
# blob without its magic is refused.
_EXPORT_MAGIC = b"PTPUXP\x00"
_EXPORT_VERSION = 2
_DIGEST_LEN = 32  # sha256


def _wrap_envelope(payload: bytes) -> bytes:
    import hashlib

    return (_EXPORT_MAGIC + bytes([_EXPORT_VERSION])
            + hashlib.sha256(payload).digest() + payload)


def _unwrap_envelope(blob: bytes, source: str):
    """Return the digest-verified payload, or raise
    CompiledArtifactError."""
    import hashlib

    blob = bytes(blob)
    if not blob.startswith(_EXPORT_MAGIC):
        raise CompiledArtifactError(
            source, "corrupt",
            "no envelope magic found (corrupted header, or not "
            "an enveloped artifact)")
    vpos = len(_EXPORT_MAGIC)
    if len(blob) < vpos + 1:
        raise CompiledArtifactError(
            source, "truncated", "envelope ends before the "
            "version byte — re-run export")
    version = blob[vpos]
    if version != _EXPORT_VERSION:
        raise CompiledArtifactError(
            source, "version",
            f"envelope version {version} != {_EXPORT_VERSION} "
            f"(or a corrupted version byte)")
    head = vpos + 1
    digest = blob[head:head + _DIGEST_LEN]
    payload = blob[head + _DIGEST_LEN:]
    if len(digest) < _DIGEST_LEN or not payload:
        raise CompiledArtifactError(
            source, "truncated",
            f"{len(blob)} bytes is shorter than the envelope header "
            f"— re-run export")
    if hashlib.sha256(payload).digest() != digest:
        raise CompiledArtifactError(
            source, "corrupt",
            f"checksum mismatch over {len(payload)} payload bytes "
            f"— re-run export")
    return payload


# Arg as a pytree node torch.export carries across save and load
_ARG_TYPE_NAME = "paddle_tpu_torch.core.arg.Arg"
_ARG_REGISTERED = False


def _register_arg() -> None:
    """Register Arg as a pytree node with torch.export."""
    global _ARG_REGISTERED
    if not _ARG_REGISTERED:
        torch.export.register_dataclass(Arg,
                                        serialized_type_name=_ARG_TYPE_NAME)
        _ARG_REGISTERED = True


class InferencerForward(torch.nn.Module):
    """The Inferencer's forward as the Module torch.export takes:
    (params, state, feed) -> {name: Arg} of its outputs, in test mode."""

    def __init__(self, inferencer: Inferencer):
        super().__init__()
        self.net = inferencer.net
        self.output_names = list(inferencer.output_names)

    def forward(self, params, state, feed):
        outs, _ = self.net.forward(params, feed, state=state, train=False,
                                   outputs=self.output_names)
        return {n: outs[n] for n in self.output_names}


def export_compiled(inferencer: Inferencer, example_feed: dict) -> bytes:
    """Serialize the Inferencer's forward, specialised to
    `example_feed`'s shapes and dtypes (the feed moved to its device),
    traced under no_grad as `infer` runs it, as a checksummed
    `torch.export` artifact (bytes)."""
    import io

    feed = {k: a.to(inferencer.device) for k, a in example_feed.items()}
    with torch.no_grad():
        ep = export_program(InferencerForward(inferencer),
                            (inferencer.params, inferencer.state, feed))
    buf = io.BytesIO()
    torch.export.save(ep, buf)
    return _wrap_envelope(buf.getvalue())


def load_compiled(blob: bytes, source: str = "<compiled blob>"):
    """Rehydrate an export_compiled artifact; returns
    fn(params, state, feed) -> {name: Arg}, on the device it was
    exported on. Runs without the model-building code (config, layers):
    the graph's kernels are the custom ops this module registers.
    `source` names the artifact (e.g. its path) in error messages. A
    truncated or corrupt blob raises CompiledArtifactError (a
    ValueError) naming the artifact before any byte reaches
    `torch.export.load`."""
    import io

    payload = _unwrap_envelope(blob, source)
    _register_arg()
    try:
        ep = torch.export.load(io.BytesIO(payload))
    except Exception as e:
        raise CompiledArtifactError(
            source, "deserialize",
            f"payload failed to deserialize (truncated/corrupt or "
            f"version-skewed torch?): {type(e).__name__}: {e}") from e
    return ep.module()


def infer(output=None, parameters=None, input=None, network=None,
          feeder=None, device=None):
    """One-shot inference (v2/inference.py:93 infer()). `input` is a
    feed dict of Args (or raw arrays, wrapped as dense Args; use
    `feeder` for sequence/ids packing). Returns one ndarray for a
    single output, else a list in `output` order. Runs on the card
    unless `device="cpu"`."""
    outs = (
        None
        if output is None
        else [output] if isinstance(output, str) else list(output)
    )
    inf = Inferencer(network, parameters, outputs=outs, device=device)
    outs = inf.output_names
    feed = feeder(input) if feeder is not None else input
    feed = {
        k: (v if isinstance(v, Arg) else Arg(value=torch.as_tensor(v)))
        for k, v in feed.items()
    }
    res = inf.infer(feed)
    vals = [res[n] for n in outs]
    return vals[0] if len(vals) == 1 else vals


# ---------------------------------------------------------------------
# verified program cache
#
# Entry layout (one directory per key under cache_dir):
#     <key>/program.pt2         enveloped torch.export.save bytes
#     <key>/program.graph.json  one record per graph node (what the
#                               boot audit reads)
#     <key>/meta.json           schema + sha256 per file + the audit
#                               policy the entry was stored under
#
# Publication is atomic: everything is written into a ".tmp-*" sibling
# and renamed into place, so a SIGKILL mid-store leaves only ignored
# temp garbage, never a half-visible entry.

CACHE_META_SCHEMA = "paddle-tpu-verified-cache/v1"
_CACHE_FILES = ("program.pt2", "program.graph.json")
# the policy keys the port's graph audit gives a meaning to
AUDIT_KEYS = ("total_bytes_max", "host_transfer_budget",
              "n_instructions_max")
# graph targets that read a value back to the host
_HOST_READS = ("aten._local_scalar_dense", "aten.item")


def _sha256_file(path: str) -> str:
    import hashlib

    h = hashlib.sha256()
    with open(path, "rb") as f:
        for chunk in iter(lambda: f.read(1 << 20), b""):
            h.update(chunk)
    return h.hexdigest()


def has_verified(cache_dir: str, key: str) -> bool:
    import os

    return os.path.exists(os.path.join(cache_dir, key, "meta.json"))


def _check_policy_keys(policy: dict, key: str) -> None:
    unknown = sorted(k for k in policy if k not in AUDIT_KEYS)
    if unknown:
        raise VerifiedCacheError(
            "audit", f"policy key(s) {unknown} for {key!r} have no "
                     f"meaning in the port's graph audit (known: "
                     f"{list(AUDIT_KEYS)})")


def _graph_records(ep) -> list:
    """One record per node of an ExportedProgram's graph: op, name,
    target, the devices of its tensor inputs, and the output's shape /
    dtype / device / bytes from `node.meta["val"]` (a tuple output lists
    each of its tensors)."""

    def vals(v):
        if isinstance(v, (list, tuple)):
            return [x for y in v for x in vals(y)]
        return [v] if isinstance(v, torch.Tensor) else []

    recs = []
    for node in ep.graph.nodes:
        outs = [{"shape": list(t.shape), "dtype": str(t.dtype),
                 "device": str(t.device),
                 "bytes": t.numel() * t.element_size()}
                for t in vals(node.meta.get("val"))]
        ins = sorted({str(t.device) for a in node.all_input_nodes
                      for t in vals(a.meta.get("val"))})
        recs.append({"op": node.op, "name": node.name,
                     "target": str(node.target), "in_devices": ins,
                     "outputs": outs})
    return recs


def _to_cpu(rec: dict) -> bool:
    """A copy (`_to_copy`, `to`) whose output is on the CPU and whose
    input is not."""
    return (rec["target"].startswith(("aten._to_copy", "aten.to."))
            and any(o["device"] == "cpu" for o in rec["outputs"])
            and any(d != "cpu" for d in rec["in_devices"]))


def audit_graph(records: list, policy: dict) -> dict:
    """The port's boot gate over `program.graph.json`: `total_bytes_max`
    bounds the sum of the nodes' output bytes, `host_transfer_budget`
    the nodes that copy to the CPU or read a scalar back
    (`aten._local_scalar_dense` / `aten.item`, a `_to_copy` / `to` from
    the card to the CPU), and
    `n_instructions_max` the `call_function` nodes. Returns
    {"ok", "checks": [{"name", "ok", "detail"}], "n_instructions",
    "total_bytes", "host_transfers"}."""
    calls = [r for r in records if r["op"] == "call_function"]
    total_bytes = sum(o["bytes"] for r in calls for o in r["outputs"])
    host = sum(1 for r in calls
               if r["target"].startswith(_HOST_READS) or _to_cpu(r))
    checks = []

    def check(name, got, limit):
        ok = got <= limit
        checks.append({"name": name, "ok": ok,
                       "detail": f"{name.split('_max')[0]} {got} "
                                 f"{'<=' if ok else '>'} {limit}"})

    if "total_bytes_max" in policy:
        check("total_bytes_max", total_bytes, int(policy["total_bytes_max"]))
    if "host_transfer_budget" in policy:
        check("host_transfer_budget", host,
              int(policy["host_transfer_budget"]))
    if "n_instructions_max" in policy:
        check("n_instructions_max", len(calls),
              int(policy["n_instructions_max"]))
    return {"ok": all(c["ok"] for c in checks), "checks": checks,
            "n_instructions": len(calls), "total_bytes": total_bytes,
            "host_transfers": host}


def _audit_failure(report: dict) -> str:
    return "; ".join(f"[{c['name']}] {c['detail']}"
                     for c in report["checks"] if not c["ok"])


class _Fn(torch.nn.Module):
    """A plain function over tensors as the Module torch.export takes."""

    def __init__(self, fn):
        super().__init__()
        self.fn = fn

    def forward(self, *args):
        return self.fn(*args)


def export_program(fn, example_args: tuple):
    """`torch.export.export` of `fn` (an nn.Module or a function over
    plain tensors) at `example_args`: the program a verified entry
    stores, and what a replica's compile mode builds."""
    _register_arg()
    mod = fn if isinstance(fn, torch.nn.Module) else _Fn(fn)
    ep = torch.export.export(mod, tuple(example_args))
    # the program without its example inputs: a saved artifact then
    # holds no parameters or data, as the JAX export's StableHLO
    ep.example_inputs = None
    return ep


def store_verified(cache_dir: str, key: str, fn, example_args: tuple,
                   policy: dict = None) -> dict:
    """Export `fn` (an nn.Module or a function over plain tensors) at
    `example_args` with `torch.export`, audit its graph against
    `policy` (`audit_graph`'s keys), and publish the verified cache
    entry. Raises VerifiedCacheError("audit") — and publishes nothing —
    when the policy names a key the audit does not know or the program
    already violates it. Returns the entry's meta dict."""
    import io
    import json
    import os
    import shutil
    import tempfile
    import time

    policy = dict(policy or {})
    _check_policy_keys(policy, key)
    ep = export_program(fn, example_args)
    records = _graph_records(ep)
    report = audit_graph(records, policy)
    if not report["ok"]:
        raise VerifiedCacheError(
            "audit", f"program for key {key!r} violates the store "
                     f"policy: {_audit_failure(report)}")
    buf = io.BytesIO()
    torch.export.save(ep, buf)
    leaves = torch.utils._pytree.tree_leaves(tuple(example_args))
    devices = sorted({str(a.device) for a in leaves
                      if isinstance(a, torch.Tensor)})

    os.makedirs(cache_dir, exist_ok=True)
    tmp = tempfile.mkdtemp(prefix=f".tmp-{key}-", dir=cache_dir)
    try:
        with open(os.path.join(tmp, "program.pt2"), "wb") as f:
            f.write(_wrap_envelope(buf.getvalue()))
        with open(os.path.join(tmp, "program.graph.json"), "w") as f:
            json.dump(records, f, indent=0)
        meta = {
            "schema": CACHE_META_SCHEMA,
            "key": key,
            "created_unix": time.time(),
            "torch_version": torch.__version__,
            "device": devices[0] if len(devices) == 1 else devices,
            "policy": policy,
            "files": {
                name: _sha256_file(os.path.join(tmp, name))
                for name in _CACHE_FILES
            },
            "n_instructions": report["n_instructions"],
            "total_bytes": report["total_bytes"],
            "host_transfers": report["host_transfers"],
            "example_args": [
                {"shape": list(getattr(a, "shape", ())),
                 "dtype": str(getattr(a, "dtype", ""))}
                for a in example_args
            ],
        }
        with open(os.path.join(tmp, "meta.json"), "w") as f:
            json.dump(meta, f, indent=1, sort_keys=True)
            f.flush()
            os.fsync(f.fileno())
        final = os.path.join(cache_dir, key)
        if os.path.exists(final):
            shutil.rmtree(final)
        os.rename(tmp, final)
        return meta
    except BaseException:
        shutil.rmtree(tmp, ignore_errors=True)
        raise


class VerifiedProgram:
    """A booted cache entry: `call(*args)` runs the program (the
    exported module on the caller's device); `via` is "export"; `meta`
    is the entry's verified meta dict; `audit` the boot-gate report."""

    def __init__(self, call, via: str, meta: dict, audit: dict):
        self.call = call
        self.via = via
        self.meta = meta
        self.audit = audit

    def __call__(self, *args):
        return self.call(*args)


def load_verified(cache_dir: str, key: str, policy: dict = None,
                  device=None) -> VerifiedProgram:
    """Boot a program from the verified cache: the digests, then the
    meta schema, then the graph audit (extra `policy` keys tighten —
    merge over — the stored policy), and only then `torch.export.load`,
    its module placed on `device` (the card unless "cpu"). Raises
    VerifiedCacheError before any unverified byte reaches
    torch.export.load."""
    import hashlib
    import io
    import json
    import os

    from paddle_tpu_torch.core.device import resolve_device

    dev = resolve_device(device)
    entry = os.path.join(cache_dir, key)
    meta_path = os.path.join(entry, "meta.json")
    if not os.path.exists(meta_path):
        raise VerifiedCacheError(
            "missing", f"no entry for key {key!r} under {cache_dir}")
    try:
        with open(meta_path) as f:
            meta = json.load(f)
        if not isinstance(meta, dict):
            raise ValueError("meta.json is not a JSON object")
    except (OSError, ValueError) as e:
        raise VerifiedCacheError(
            "meta", f"{meta_path}: unreadable ({e})") from e
    files = meta.get("files") or {}
    blobs = {}
    for name in _CACHE_FILES:
        path = os.path.join(entry, name)
        want = files.get(name) if isinstance(files, dict) else None
        if not want or not os.path.exists(path):
            raise VerifiedCacheError(
                "digest", f"{name}: missing from the entry or its "
                          f"meta — torn or tampered entry")
        # the bytes are read once and digested as read: what is checked
        # is what reaches the deserializer
        with open(path, "rb") as f:
            blobs[name] = f.read()
        got = hashlib.sha256(blobs[name]).hexdigest()
        if got != want:
            raise VerifiedCacheError(
                "digest", f"{name}: sha256 {got[:12]}… != recorded "
                          f"{want[:12]}… — corrupt or tampered entry")
    if meta.get("schema") != CACHE_META_SCHEMA:
        raise VerifiedCacheError(
            "meta", f"{meta_path}: schema {meta.get('schema')!r} != "
                    f"{CACHE_META_SCHEMA!r}")
    merged = dict(meta.get("policy") or {})
    if policy:
        merged.update(policy)
    _check_policy_keys(merged, key)
    try:
        records = json.loads(blobs["program.graph.json"].decode())
        audit = audit_graph(records, merged)
    except Exception as e:
        raise VerifiedCacheError(
            "audit", f"audit could not run over program.graph.json: "
                     f"{type(e).__name__}: {e}") from e
    if not audit["ok"]:
        raise VerifiedCacheError(
            "audit", f"entry {key!r} fails the boot policy gate: "
                     f"{_audit_failure(audit)}")
    pt2 = os.path.join(entry, "program.pt2")
    payload = _unwrap_envelope(blobs["program.pt2"], pt2)
    _register_arg()
    try:
        ep = torch.export.load(io.BytesIO(payload))
    except Exception as e:
        raise CompiledArtifactError(
            pt2, "deserialize",
            f"payload failed to deserialize (version-skewed torch?): "
            f"{type(e).__name__}: {e}") from e
    module = ep.module().to(dev)
    return VerifiedProgram(module, "export", meta, audit)
