"""The port's verified program cache (`paddle_tpu_torch/inference.py`:
a `torch.export` program behind digests and the port's graph audit),
on the CPU.

- The envelope is the JAX package's byte for byte (magic, version
  byte, sha256), and each package unwraps the other's.
- The gauntlet of `tests/test_serving_fleet.py`: truncation and
  corruption at every offset refused with a typed error before any
  byte is deserialized, tampered and truncated entry files refused by
  the digest gate, a torn meta refused, the policy gate at boot and at
  store, and policy keys the port's audit has no meaning for refused.
- A SIGKILL mid-store leaves no entry, and a later store succeeds.
- The loaded program is `torch.equal` to the eager module, and within
  1e-6 of the JAX `replica_program_fn` on the same feed.
"""

import json
import os
import shutil
import subprocess
import sys

import jax
import numpy as np
import pytest
import torch

from paddle_tpu import inference as jinf
from paddle_tpu import testing_faults as jtf
from paddle_tpu_torch import inference as tinf
from paddle_tpu_torch import testing_faults as ttf

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
MAGIC = len(tinf._EXPORT_MAGIC)
HDR = MAGIC + 1 + 32


@pytest.fixture(scope="module")
def entry(tmp_path_factory):
    cache = str(tmp_path_factory.mktemp("vcache"))
    fn = ttf.replica_program_fn(4, 16)
    x = torch.ones((1, 8))
    meta = tinf.store_verified(cache, "prog", fn, (x,))
    return {"cache": cache, "key": "prog", "meta": meta, "x": x, "fn": fn}


def _file(e, name):
    return os.path.join(e["cache"], e["key"], name)


def _copy(e, tmp_path):
    dst = tmp_path / "c" / "prog"
    shutil.copytree(os.path.join(e["cache"], e["key"]), dst)
    return dst


def test_envelope_is_the_jax_format():
    payload = os.urandom(257)
    blob = tinf._wrap_envelope(payload)
    assert blob == jinf._wrap_envelope(payload)
    assert blob[MAGIC] == tinf._EXPORT_VERSION == jinf._EXPORT_VERSION
    assert tinf._unwrap_envelope(blob, "x") == payload
    assert jinf._unwrap_envelope(blob, "x", True) == payload
    # the port writes only this version: a v1 or an unenveloped blob
    # is refused
    legacy = jinf._LEGACY_MAGIC_V1 + blob[MAGIC + 1:]
    for other in (legacy, b"raw bytes"):
        with pytest.raises(tinf.CompiledArtifactError) as ei:
            tinf._unwrap_envelope(other, "x")
        assert ei.value.reason == "corrupt"


def test_truncations_raise_typed_error(entry):
    blob = open(_file(entry, "program.pt2"), "rb").read()
    for cut in (3, MAGIC, MAGIC + 1, HDR - 5, HDR):
        with pytest.raises(tinf.CompiledArtifactError,
                           match="model.pt2") as ei:
            tinf._unwrap_envelope(blob[:cut], "model.pt2")
        assert ei.value.reason in ("truncated", "corrupt")
        with pytest.raises(jinf.CompiledArtifactError) as ej:
            jinf._unwrap_envelope(blob[:cut], "model.pt2",
                                  require_envelope=True)
        assert ej.value.reason == ei.value.reason
    assert isinstance(ei.value, ValueError)


def test_corruption_at_every_offset_detected(entry, tmp_path):
    blob = open(_file(entry, "program.pt2"), "rb").read()
    for off in (0, MAGIC, MAGIC + 1, MAGIC + 10, HDR,
                HDR + (len(blob) - HDR) // 2, len(blob) - 4):
        p = tmp_path / f"model_{off}.pt2"
        p.write_bytes(blob)
        ttf.corrupt_file(str(p), offset=off, nbytes=4)
        with pytest.raises(ValueError, match="model_") as ei:
            tinf._unwrap_envelope(p.read_bytes(), p.name)
        assert isinstance(ei.value, tinf.CompiledArtifactError)
        assert ei.value.reason in ("corrupt", "version")


def test_roundtrip_equal_to_eager_and_jax(entry):
    prog = tinf.load_verified(entry["cache"], entry["key"], device="cpu")
    assert prog.via == "export"
    assert prog.audit["ok"] and prog.meta["schema"] == tinf.CACHE_META_SCHEMA
    assert prog.meta["torch_version"] == torch.__version__
    assert prog.meta["device"] == "cpu"
    assert prog.meta["example_args"] == [{"shape": [1, 8],
                                          "dtype": "torch.float32"}]
    rng = np.random.default_rng(24)
    for _ in range(3):
        x = rng.standard_normal((1, 8)).astype(np.float32)
        got = prog(torch.from_numpy(x))
        assert torch.equal(got, entry["fn"](torch.from_numpy(x)))
        want = np.asarray(jax.jit(jtf.replica_program_fn(4, 16))(x))
        np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=1e-6)


def test_entry_files_and_graph(entry):
    files = sorted(os.listdir(os.path.join(entry["cache"], entry["key"])))
    assert files == ["meta.json", "program.graph.json", "program.pt2"]
    graph = json.load(open(_file(entry, "program.graph.json")))
    calls = [r for r in graph if r["op"] == "call_function"]
    assert len(calls) == entry["meta"]["n_instructions"]
    # 4 layers of matmul + add + tanh, then the sum
    assert [r["target"] for r in calls].count("aten.tanh.default") == 4
    assert calls[-1]["outputs"] == [{"shape": [1], "dtype": "torch.float32",
                                     "device": "cpu", "bytes": 4}]
    assert entry["meta"]["total_bytes"] == sum(
        o["bytes"] for r in calls for o in r["outputs"])
    assert entry["meta"]["host_transfers"] == 0


def test_missing_entry(entry):
    with pytest.raises(tinf.VerifiedCacheError) as ei:
        tinf.load_verified(entry["cache"], "nope", device="cpu")
    assert ei.value.reason == "missing"
    assert tinf.has_verified(entry["cache"], "prog")
    assert not tinf.has_verified(entry["cache"], "nope")


@pytest.mark.parametrize("victim", ["program.pt2", "program.graph.json"])
@pytest.mark.parametrize("how", ["corrupt", "truncate", "delete"])
def test_digest_gate_refuses_tampered_file(entry, tmp_path, victim, how,
                                           monkeypatch):
    dst = _copy(entry, tmp_path)
    if how == "corrupt":
        ttf.corrupt_file(str(dst / victim), nbytes=4)
    elif how == "truncate":
        ttf.truncate_file(str(dst / victim), 0.5)
    else:
        os.remove(dst / victim)
    loads = []
    monkeypatch.setattr(torch.export, "load",
                        lambda *a, **k: loads.append(a))
    with pytest.raises(tinf.VerifiedCacheError) as ei:
        tinf.load_verified(str(tmp_path / "c"), "prog", device="cpu")
    assert ei.value.reason == "digest"
    assert victim in str(ei.value)
    assert loads == []  # no byte reached the deserializer


@pytest.mark.parametrize("meta", ["{not json", "[1, 2]", "schema"])
def test_meta_tamper_refused(entry, tmp_path, meta):
    dst = _copy(entry, tmp_path)
    if meta == "schema":
        doc = json.load(open(dst / "meta.json"))
        doc["schema"] = "paddle-tpu-verified-cache/v0"
        meta = json.dumps(doc)
    (dst / "meta.json").write_text(meta)
    with pytest.raises(tinf.VerifiedCacheError) as ei:
        tinf.load_verified(str(tmp_path / "c"), "prog", device="cpu")
    assert ei.value.reason == "meta"


@pytest.mark.parametrize("policy,what", [
    ({"total_bytes_max": 1}, "total_bytes"),
    ({"n_instructions_max": 3}, "n_instructions"),
])
def test_audit_policy_gate_at_boot(entry, policy, what):
    with pytest.raises(tinf.VerifiedCacheError) as ei:
        tinf.load_verified(entry["cache"], entry["key"], policy=policy,
                           device="cpu")
    assert ei.value.reason == "audit"
    assert what in str(ei.value)
    loose = {k: 10 ** 9 for k in policy}
    assert tinf.load_verified(entry["cache"], entry["key"], policy=loose,
                              device="cpu").audit["ok"]


def test_audit_policy_gate_at_store(tmp_path):
    fn = ttf.replica_program_fn(2, 8)
    with pytest.raises(tinf.VerifiedCacheError) as ei:
        tinf.store_verified(str(tmp_path), "bad", fn,
                            (torch.ones((1, 8)),),
                            policy={"total_bytes_max": 1})
    assert ei.value.reason == "audit"
    assert not tinf.has_verified(str(tmp_path), "bad")
    assert [f for f in os.listdir(tmp_path)
            if not f.startswith(".tmp-")] == []


def test_host_transfer_budget(tmp_path):
    """A program that reads a value back to the host is counted and
    refused under a zero budget."""
    def reads_back(x):
        return x * 2, torch.tensor(x.sum().item())

    with pytest.raises(tinf.VerifiedCacheError) as ei:
        tinf.store_verified(str(tmp_path), "rb", reads_back,
                            (torch.ones((2, 3)),),
                            policy={"host_transfer_budget": 0})
    assert ei.value.reason == "audit"
    assert "host_transfer_budget 1 > 0" in str(ei.value)
    meta = tinf.store_verified(str(tmp_path), "rb", reads_back,
                               (torch.ones((2, 3)),),
                               policy={"host_transfer_budget": 1})
    assert meta["host_transfers"] == 1


@pytest.mark.parametrize("where", ["store", "boot"])
@pytest.mark.parametrize("key", ["forbid_tt_materialization",
                                 "hbm_bytes_max"])
def test_unknown_policy_keys_refused(entry, tmp_path, where, key):
    if where == "store":
        with pytest.raises(tinf.VerifiedCacheError) as ei:
            tinf.store_verified(str(tmp_path), "k",
                                ttf.replica_program_fn(1, 8),
                                (torch.ones((1, 8)),), policy={key: 1})
        assert not tinf.has_verified(str(tmp_path), "k")
    else:
        with pytest.raises(tinf.VerifiedCacheError) as ei:
            tinf.load_verified(entry["cache"], entry["key"],
                               policy={key: 1}, device="cpu")
    assert ei.value.reason == "audit"
    assert key in str(ei.value)


def test_load_refuses_the_cpu_unless_asked(entry, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        tinf.load_verified(entry["cache"], entry["key"])


# the child blocks inside the store at a named point and says so; the
# parent SIGKILLs it there (event-driven, no sleep)
KILL_SRC = """
import sys, time
sys.path.insert(0, {repo!r})
import torch
from paddle_tpu_torch import inference, testing_faults
point = {point!r}
real = getattr(inference, point)

def blocked(*a, **k):
    out = real(*a, **k)
    print("AT", point, flush=True)
    time.sleep(120)
    return out

setattr(inference, point, blocked)
inference.store_verified({cache!r}, "k", testing_faults.replica_program_fn(8, 32),
                         (torch.zeros((1, 8)),))
"""


@pytest.mark.parametrize("point", ["_wrap_envelope", "_sha256_file"])
def test_sigkill_mid_store_leaves_no_entry(tmp_path, point):
    cache = str(tmp_path / "vcache")
    proc = subprocess.Popen(
        [sys.executable, "-c",
         KILL_SRC.format(repo=REPO, point=point, cache=cache)],
        cwd=REPO, stdout=subprocess.PIPE, text=True)
    try:
        line = proc.stdout.readline()
        assert line.startswith("AT " + point), line
    finally:
        ttf.kill_process(proc)
    assert not tinf.has_verified(cache, "k")
    assert [f for f in os.listdir(cache) if not f.startswith(".tmp-")] == []
    tinf.store_verified(cache, "k", ttf.replica_program_fn(2, 8),
                        (torch.zeros((1, 8)),))
    prog = tinf.load_verified(cache, "k", device="cpu")
    assert prog.via == "export"
