"""The port's serving stack on the CPU: server + TCP front end + CLI.

Answers served through `paddle_tpu_torch` over TCP must equal the JAX
package's `greedy_decode_recompute` on the same params and prompts, cut
at the first eos (the engine stops there; the server strips the
trailing eos). The JAX `PagedLM.generate` is not a steady oracle under
pytest (it returns other tokens in some runs, ROADMAP C1): the answers
are compared with it only in a run where its tokens equal the
recompute's. Overload sheds explicitly, drain leaves nothing pending, a
failing model is quarantined, and `python -m paddle_tpu_torch serve`
has the LISTENING / SIGTERM / DRAINED lifecycle.
"""

import json
import os
import selectors
import signal
import subprocess
import sys
import threading
import time

import numpy as np
import pytest

import jax

from paddle_tpu.decoding import kv_cache as jkv
from paddle_tpu.models import lm as jlm
from paddle_tpu_torch.decoding import kv_cache as tkv
from paddle_tpu_torch.models import lm as tlm
from paddle_tpu_torch.serving.lm_engine import PagedLMModel
from paddle_tpu_torch.serving.server import (
    InferenceServer,
    ServeConfig,
    ServeRejected,
)
from paddle_tpu_torch.serving.tcp import ServeClient, ServingTCPServer
from paddle_tpu_torch.weights import params_from_numpy

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
JSPEC = jlm.LMSpec(vocab=128, d_model=64, num_heads=2, num_layers=2,
                   attn_impl="flash")
TSPEC = tlm.LMSpec(vocab=128, d_model=64, num_heads=2, num_layers=2,
                   attn_impl="flash")
EOS = 1
MAX_NEW = 8


def _cut_at_eos(row):
    row = [int(x) for x in row]
    return row[:row.index(EOS)] if EOS in row else row


class _Blocking:
    """Stub model: run_batch blocks until released, then echoes."""

    def __init__(self):
        self.release = threading.Event()
        self.entered = threading.Event()

    def run_batch(self, ids, lens, hooks, host):
        self.entered.set()
        assert self.release.wait(30)
        return [{"tokens": [int(n)]} for n in lens]


class _Failing:
    def run_batch(self, ids, lens, hooks, host):
        raise RuntimeError("boom")


def test_tcp_answers_equal_jax_paged_generate():
    jp = jlm.lm_init_params(JSPEC, jax.random.key(0))
    tp = params_from_numpy({k: np.asarray(v) for k, v in jp.items()},
                           device="cpu")
    rng = np.random.default_rng(0)
    lens = np.asarray([11, 8, 6, 10], np.int32)
    ids = rng.integers(2, JSPEC.vocab, (4, 11)).astype(np.int32)
    jcache = jkv.PagedKVCache(JSPEC, num_pages=64, page_size=4,
                              max_pages_per_seq=16)
    ref, _ = jlm.greedy_decode_recompute(JSPEC, jp, ids, lens, MAX_NEW,
                                         EOS)
    paged, _ = jkv.PagedLM(JSPEC, jp, jcache, eos_id=EOS).generate(
        ids, lens, MAX_NEW)
    paged_steady = all(_cut_at_eos(p) == _cut_at_eos(r)
                       for p, r in zip(paged, ref))

    cache = tkv.PagedKVCache(TSPEC, num_pages=64, page_size=4,
                             max_pages_per_seq=16, device="cpu")
    model = PagedLMModel(tkv.PagedLM(TSPEC, tp, cache, eos_id=EOS),
                         slots=2, max_new=MAX_NEW)
    server = InferenceServer(ServeConfig(buckets=(16, 32, 64),
                                         default_deadline_s=60))
    server.add_model("lm", model)
    tcp = ServingTCPServer(server)
    answers = [None] * len(lens)

    def call(i):
        with ServeClient(f"127.0.0.1:{tcp.port}") as cl:
            answers[i] = cl.call("lm", ids[i, :lens[i]], timeout=60,
                                 trace=True)

    threads = [threading.Thread(target=call, args=(i,))
               for i in range(len(lens))]
    try:
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=60)
            assert not t.is_alive()
        with ServeClient(f"127.0.0.1:{tcp.port}") as cl:
            scrape = cl.metricz()
            bad = cl.call("lm", list(range(2, 80)))   # over the buckets
            unknown = cl.call("nope", [2, 3])
    finally:
        tcp.stop_accepting()
        server.shutdown(drain=True)
        tcp.stop(drain=True)
    for i, a in enumerate(answers):
        assert a["ok"] and a["path"] == "paged" and a["trace_id"]
        assert a["tokens"] == _cut_at_eos(ref[i])
        if paged_steady:
            assert a["tokens"] == _cut_at_eos(paged[i])
    assert any(EOS in list(r) for r in ref)   # eos cut is exercised
    assert scrape["ok"] and scrape["stats"]["completed"] == len(lens)
    assert bad == {"ok": False, "error": "bad_request",
                   "detail": bad["detail"]}
    assert unknown["error"] == "unknown_model"
    assert cache.free_page_count() == cache.num_pages - 1


def test_overloaded_queue_sheds_then_drains():
    model = _Blocking()
    server = InferenceServer(ServeConfig(max_queue=2,
                                         default_deadline_s=30))
    server.add_model("m", model)
    first = server.submit("m", [5, 6, 7])
    assert model.entered.wait(10)   # the worker holds `first` now
    queued = [server.submit("m", [1] * n) for n in (2, 3)]
    with pytest.raises(ServeRejected) as err:
        server.submit("m", [9])
    assert err.value.reason == "overloaded"
    assert server.stats()["shed_overload"] == 1
    model.release.set()
    server.shutdown(drain=True, timeout=30)
    for req in [first] + queued:
        assert req.state == "done"
    assert first.result(0)["tokens"] == [3]
    stats = server.stats()
    assert stats["queue_depth"] == 0 and stats["completed"] == 3
    with pytest.raises(ServeRejected) as err:
        server.submit("m", [1])
    assert err.value.reason == "shutting_down"


def test_failing_model_is_quarantined():
    server = InferenceServer(ServeConfig(breaker_threshold=2,
                                         breaker_reset_s=60))
    server.add_model("bad", _Failing())
    for _ in range(2):
        req = server.submit("bad", [1, 2])
        with pytest.raises(Exception, match="boom"):
            req.result(10)
    with pytest.raises(ServeRejected) as err:
        server.submit("bad", [1, 2])
    assert err.value.reason == "quarantined"
    server.shutdown(drain=True)
    assert server.stats()["failed"] == 2


CONF = """
import torch

from paddle_tpu_torch.decoding.kv_cache import PagedKVCache, PagedLM
from paddle_tpu_torch.models import lm
from paddle_tpu_torch.serving.lm_engine import PagedLMModel
from paddle_tpu_torch.serving.server import InferenceServer, ServeConfig


def get_server():
    spec = lm.LMSpec(vocab=128, d_model=64, num_heads=2, num_layers=2,
                     attn_impl="flash")
    params = lm.lm_init_params(spec, torch.Generator().manual_seed(0),
                               device="cpu")
    cache = PagedKVCache(spec, num_pages=64, page_size=4,
                         max_pages_per_seq=16, device="cpu")
    server = InferenceServer(ServeConfig(buckets=(16, 32, 64)))
    server.add_model("lm", PagedLMModel(PagedLM(spec, params, cache),
                                        slots=2, max_new=4))
    return server
"""


def _readline(proc, sel, deadline):
    while time.monotonic() < deadline:
        if sel.select(timeout=0.5):
            return proc.stdout.readline()
        if proc.poll() is not None:
            return proc.stdout.readline()
    raise TimeoutError("no line from the server")


def test_cli_serve_listening_sigterm_drained(tmp_path):
    conf = tmp_path / "conf.py"
    conf.write_text(CONF)
    env = dict(os.environ, PYTHONPATH=REPO)
    proc = subprocess.Popen(
        [sys.executable, "-m", "paddle_tpu_torch", "serve", "--config",
         str(conf), "--port", "0"],
        cwd=REPO, env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
        text=True,
    )
    try:
        sel = selectors.DefaultSelector()
        sel.register(proc.stdout, selectors.EVENT_READ)
        line = _readline(proc, sel, time.monotonic() + 60)
        assert line.startswith("LISTENING "), (line, proc.stderr.read())
        port = int(line.split()[1])
        with ServeClient(f"127.0.0.1:{port}") as cl:
            ans = cl.call("lm", [5, 9, 11, 2], timeout=60)
        assert ans["ok"] and 1 <= len(ans["tokens"]) <= 4
        proc.send_signal(signal.SIGTERM)
        out, err = proc.communicate(timeout=60)
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait()
    assert proc.returncode == 0, err
    drained = [ln for ln in out.splitlines() if ln.startswith("DRAINED ")]
    assert len(drained) == 1
    stats = json.loads(drained[0][len("DRAINED "):])
    assert stats["completed"] == 1 and stats["queue_depth"] == 0


class _Echo:
    def __init__(self, tag):
        self.tag = tag

    def run_batch(self, ids, lens, hooks, host):
        return [{"tokens": [self.tag]} for _ in lens]


def test_admin_swap_model_over_tcp():
    """The `{"admin": "swap_model"}` frame: the loader builds the new
    model and later requests are answered by it."""
    server = InferenceServer(ServeConfig(default_deadline_s=30))
    server.add_model("m", _Echo(1))
    tcp = ServingTCPServer(server, model_loader=lambda name, tag:
                           _Echo(int(tag)))
    try:
        with ServeClient(f"127.0.0.1:{tcp.port}") as cl:
            assert cl.call("m", [3])["tokens"] == [1]
            resp = cl._roundtrip({"admin": "swap_model", "model": "m",
                                  "tag": "7"}, timeout=10)
            assert resp == {"ok": True, "swapped": "m", "tag": "7"}
            assert cl.call("m", [3])["tokens"] == [7]
            bad = cl._roundtrip({"admin": "swap_model", "model": "x",
                                 "tag": "7"}, timeout=10)
            assert bad["error"] == "unknown_model"
    finally:
        tcp.stop_accepting()
        server.shutdown(drain=True)
        tcp.stop(drain=True)
