"""Fault-injection harness: the serving-replica and sharded-CTR-worker
subprocesses the fleet and online-learning paths are tested and driven
with, and the faults they are hit with.

The port of the fleet's part of `paddle_tpu/testing_faults.py`:

- `kill_process`: SIGKILL a replica/worker subprocess (no cleanup, no
  atexit — the honest crash).
- `FlakyProxy`: a TCP proxy in front of a server that can refuse,
  reset (RST via SO_LINGER 0), delay, cut or black-hole connections
  on command.
- `truncate_file` / `corrupt_file`: tear or bit-flip a file (a cache
  entry, a checkpoint shard); `write_torn_table_generation` the
  canonical torn sharded-table generation.
- `SERVING_REPLICA_SRC` / `start_serving_replica`: one
  `InferenceServer` behind a `ServingTCPServer` in its own process, in
  mode toy, cache (boots from the verified cache), compile (builds and
  exports the program without publishing it) or ctr (scores from the
  newest committed sharded-table generation, reloaded on every swap).
- `SHARDED_CTR_TRAINER_SRC` / `start_sharded_ctr_trainer`: the elastic
  online-CTR worker over a `ShardedEmbeddingTable` (B9 on the card)
  with the commit-acknowledged ledger.

Both sources are strings that import only `paddle_tpu_torch`. Their
`DEVICE` environment variable defaults to `cuda`: without a card a
replica or worker refuses at boot (`BOOT_REFUSED`, exit 3) unless it
is given `DEVICE=cpu`.
"""

from __future__ import annotations

import os
import signal
import socket
import struct
import subprocess
import sys
import threading


def write_torn_table_generation(save_dir: str, generation: int,
                                payloads, fail_after_shard: int,
                                meta=None, tear: str = "missing"):
    """Deterministically reproduce a sharded-table checkpoint writer
    SIGKILLed between table shard `fail_after_shard` and the next one:
    the generation manifest (written first, as
    the real writer does) names ALL len(payloads) shards, but only
    shards 0..fail_after_shard exist on disk.

    tear="missing": the next shard simply never lands (killed before
    its write began). tear="short": shard `fail_after_shard` itself
    is additionally truncated to half its bytes AFTER its .ok.json
    committed (killed mid-flush on a filesystem that reordered the
    rename) — the checksum path, not just the existence path.

    Reused by the elastic kill/resume tests and the
    quarantine-and-rebuild tests so torn-recovery is exercised
    against one canonical injury, not ad-hoc file surgery."""
    from paddle_tpu_torch.trainer import async_checkpoint as ac

    d = ac.begin_table_generation(save_dir, generation,
                                  num_shards=len(payloads), meta=meta)
    last = None
    for s in range(min(fail_after_shard + 1, len(payloads))):
        last = ac.write_table_shard(save_dir, generation, s,
                                    payloads[s])
    if tear == "short" and last is not None:
        truncate_file(last, keep_fraction=0.5)
    return d


def kill_process(proc) -> None:
    """SIGKILL a subprocess.Popen and reap it. The process gets no
    chance to flush, ack, or release leases — exactly the crash a fleet
    or an elastic trainer must absorb."""
    if proc.poll() is None:
        proc.send_signal(signal.SIGKILL)
    proc.wait()


def truncate_file(path: str, keep_fraction: float = 0.5) -> int:
    """Truncate `path` to `keep_fraction` of its size (a torn write /
    partial flush at crash). Returns the new size."""
    size = os.path.getsize(path)
    keep = int(size * keep_fraction)
    with open(path, "r+b") as f:
        f.truncate(keep)
    return keep


def corrupt_file(path: str, offset: int = None, nbytes: int = 8) -> None:
    """Flip bits in-place (silent media corruption — same size, wrong
    payload). Defaults to the middle of the file."""
    size = os.path.getsize(path)
    if offset is None:
        offset = size // 2
    with open(path, "r+b") as f:
        f.seek(offset)
        chunk = f.read(nbytes)
        f.seek(offset)
        f.write(bytes(b ^ 0xFF for b in chunk))


def _read_jsonl(path: str) -> list:
    """One JSON dict per line; missing file = empty list. The single
    parser behind both worker-record and metrics-stream readers."""
    import json

    if not os.path.exists(path):
        return []
    with open(path) as f:
        return [json.loads(ln) for ln in f if ln.strip()]


def read_worker_records(out_file: str) -> list:
    """Parse a worker's OUT_FILE (one JSON dict per line; schema
    documented on SHARDED_CTR_TRAINER_SRC), so a record-format change
    breaks in one place, loudly."""
    return _read_jsonl(out_file)


def read_metrics_records(path: str, kind: str = None,
                         event: str = None) -> list:
    """Metrics-stream variant of `read_worker_records`: parse the obs
    JSONL event stream a worker wrote when METRICS_FILE was set
    (records carry `kind` — "watchdog" / "timeline" / "preempt_flush"
    — plus their payload; watchdog records name their ladder rung in
    `event` and stamp `global_step`). Optional filters narrow by
    `kind` and, for watchdog records, by `event`. Also reads the
    rotated `<path>.1` generation first, so a stream that rotated
    mid-run still replays in order."""
    recs = _read_jsonl(path + ".1") + _read_jsonl(path)
    if kind is not None:
        recs = [r for r in recs if r.get("kind") == kind]
    if event is not None:
        recs = [r for r in recs if r.get("event") == event]
    return recs


# ---- elastic sharded-CTR trainer worker -----------------------------
#
# A REAL online-CTR trainer over a ShardedEmbeddingTable: deterministic
# traffic (trainer/online.make_batch), async sharded-table generations
# after every batch, and the commit-acknowledged ledger — a batch is
# logged `{"trained": b}` ONLY after its generation's per-shard sha256
# manifest verifies on disk. SIGKILL it mid-epoch with writes in
# flight, respawn the same command line, and the union of ledger
# lines across incarnations must be every batch EXACTLY once: zero
# lost (no gaps — committed-but-unlogged batches are reconciled from
# the recovered manifest), zero retrained (no duplicates —
# unacknowledged work re-runs without ever double-logging). The table
# lives on DEVICE (the card by default): its update is B9 there.
# OUT_FILE records:
#     {"start": true, "t": wall}                     each incarnation
#     {"resume": gen, "next_batch": nb,
#      "quarantined": [{"generation","reason"},...]} on recovery
#     {"trained": b, "gen": g, "loss": l, "t": wall} on COMMIT ack
#     {"trained": b, "reconciled": true}             ledger repair
#     {"done": true, "rows_materialized": m,
#      "rows_total": R, "evictions": e, "launches": {counter: n},
#      "device": d, "t": wall}                       on completion
# ("launches": the sparse-row kernels' counts of this incarnation.)
SHARDED_CTR_TRAINER_SRC = """
import json, os, sys, time
sys.path.insert(0, os.environ["REPO"])
import numpy as np

from paddle_tpu_torch.core.device import resolve_device
from paddle_tpu_torch.ops import sparse_rows as _rows
from paddle_tpu_torch.parallel.sparse_shard import (
    ShardedEmbeddingTable, ShardedTableConfig, sgd_row_update,
)
from paddle_tpu_torch.trainer import online

save_dir = os.environ["SAVE_DIR"]
out = open(os.environ["OUT_FILE"], "a")
shards = int(os.environ.get("SHARDS", "4"))
rows_total = int(os.environ.get("ROWS_TOTAL", str(1 << 30)))
dim = int(os.environ.get("DIM", "8"))
capacity = int(os.environ.get("CAPACITY", "64"))
num_slots = int(os.environ.get("NUM_SLOTS", "48"))
batches = int(os.environ.get("BATCHES", "24"))
bsz = int(os.environ.get("BATCH", "8"))
feats = int(os.environ.get("FEATS", "4"))
hot = int(os.environ.get("HOT", "96"))
seed = 7
lr = 0.5
batch_sleep = float(os.environ.get("BATCH_SLEEP", "0"))
device = os.environ.get("DEVICE", "cuda")

def rec(**kw):
    out.write(json.dumps(kw) + "\\n")
    out.flush()

try:
    dev = resolve_device(device)
except BaseException as e:
    print("BOOT_REFUSED " + type(e).__name__ + ": " + str(e), flush=True)
    sys.exit(3)

rec(start=True, t=time.time())

cfg = ShardedTableConfig(
    rows_total=rows_total, dim=dim, capacity=capacity,
    num_slots=num_slots, placement="range", init_scale=0.0,
    seed=seed)
table = ShardedEmbeddingTable(
    cfg, num_shards=shards, update_fn=sgd_row_update(lr), device=dev)
trainer = online.OnlineCTRTrainer(table, save_dir)
hot_ids = online.hot_id_set(seed, hot, rows_total)
losses = {}
COUNTERS = ("sparse_row_update_launches", "sparse_row_gather_launches",
            "sparse_row_scatter_launches")
for c in COUNTERS:
    setattr(_rows, c, 0)

# ---- elastic resume: quarantine-and-rebuild + ledger reconcile ----
gen, meta, quarantined = trainer.resume()
next_b = int(meta.get("next_batch", 0)) if gen >= 0 else 0
if gen >= 0 or quarantined:
    rec(resume=gen, next_batch=next_b,
        quarantined=[{"generation": q["generation"],
                      "reason": q["reason"]} for q in quarantined])
if gen >= 0:
    acked = {r["trained"] for r in
             (json.loads(ln) for ln in open(os.environ["OUT_FILE"]))
             if "trained" in r}
    for b in range(next_b):
        if b not in acked:
            # committed generation, missing ledger line (killed
            # between commit and append): acknowledge from the
            # durable manifest, never by re-running the batch
            rec(trained=b, reconciled=True)

def ack(pairs):
    for g, m in pairs:
        rec(trained=g, gen=g, loss=losses.get(g, m.get("loss")),
            t=time.time())

for b in range(next_b, batches):
    ids, labels = online.make_batch(seed, b, bsz, feats, hot_ids)
    losses[b] = trainer.train_step(ids, labels)
    # generation b = state after batch b; async, in flight while the
    # next batch trains (the kill window the elastic test aims at)
    trainer.save_generation(b, b + 1,
                            extra_meta={"loss": losses[b]})
    ack(trainer.poll_acks())
    if batch_sleep:
        time.sleep(batch_sleep)

ack(trainer.drain())
trainer.close()
rec(done=True, rows_materialized=table.rows_materialized,
    rows_total=rows_total, evictions=table.stats["evictions"],
    launches={c: getattr(_rows, c) for c in COUNTERS}, device=str(dev),
    t=time.time())
"""


def start_sharded_ctr_trainer(repo: str, save_dir: str,
                              out_file: str,
                              **env_overrides) -> subprocess.Popen:
    """Launch the elastic sharded-CTR worker above. Knobs via
    env_overrides: ROWS_TOTAL, DIM, CAPACITY, NUM_SLOTS, SHARDS,
    BATCHES, BATCH, FEATS, HOT, BATCH_SLEEP, DEVICE — all stringified.
    The rest is fixed: seed 7, SGD at lr 0.5, range placement. Respawn = call again with
    the same arguments; the worker recovers itself from SAVE_DIR."""
    env = dict(
        os.environ, REPO=repo, SAVE_DIR=save_dir, OUT_FILE=out_file,
        **{k: str(v) for k, v in env_overrides.items()},
    )
    return subprocess.Popen(
        [sys.executable, "-c", SHARDED_CTR_TRAINER_SRC], env=env,
        cwd=repo, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
        text=True,
    )


def replica_program_fn(layers: int = 16, d: int = 256):
    """The canonical serving program for the fleet and cold-start
    harnesses: a `layers`-deep tanh MLP over a [B, 8] f32 feed, layer i
    `tanh(h @ W_i + i * 1e-3)` with W_i filled with 0.01, summed over
    the last axis — the JAX package's `replica_program_fn` as an
    nn.Module (the weights are buffers, so the exported program takes
    them along and `.to(device)` moves them). Both the cache's store
    side and a replica's compile mode build it from here."""
    import torch

    class ReplicaProgram(torch.nn.Module):
        def __init__(self):
            super().__init__()
            self.layers = int(layers)
            width = 8
            for i in range(self.layers):
                self.register_buffer(
                    f"w{i}", torch.full((width, d), 0.01,
                                        dtype=torch.float32))
                width = d

        def forward(self, x):
            h = x
            for i in range(self.layers):
                h = torch.tanh(h @ getattr(self, f"w{i}") + i * 1e-3)
            return torch.sum(h, dim=-1)

    return ReplicaProgram()


SERVING_REPLICA_SRC = """
import json, os, sys, threading, time
t0 = time.monotonic()
sys.path.insert(0, os.environ["REPO"])
import numpy as np

from paddle_tpu_torch.core.device import resolve_device
from paddle_tpu_torch.serving.server import InferenceServer, ServeConfig
from paddle_tpu_torch.serving.tcp import ServingTCPServer
from paddle_tpu_torch.obs import flight_recorder as _fr

# every replica keeps a flight ring (ring-only unless
# PADDLE_FLIGHT_DIR points somewhere): the fleet router's incident
# bundles stitch replica rings over the flightz frame, so a replica
# without a ring is a blind spot in every cross-process incident
_fr.enable_flight_recorder(
    dump_dir=os.environ.get("PADDLE_FLIGHT_DIR") or None)

mode = os.environ.get("REPLICA_MODE", "toy")  # toy|cache|compile|ctr
model_name = os.environ.get("MODEL_NAME", "m")
tag = os.environ.get("MODEL_TAG", "v1")
delay = float(os.environ.get("TOY_DELAY_S", "0.005"))
max_queue = int(os.environ.get("MAX_QUEUE", "64"))
device = os.environ.get("DEVICE", "cuda")


class Toy:
    can_host = False
    engine = None
    named_hooks = {}
    def __init__(self, tag, delay_s):
        self.tag = tag
        self.delay_s = delay_s
    def run_batch(self, ids, lens, hooks, host):
        time.sleep(self.delay_s)
        return [{"tokens": [int(lens[i])], "score": 0.0,
                 "tag": self.tag} for i in range(ids.shape[0])]


class Cached:
    # an exported program is specialised to its example's shape, so
    # cache/compile replicas run with max_batch=1 + a single length
    # bucket: every dispatch is exactly the [1, 8] feed it was
    # exported for
    can_host = False
    engine = None
    named_hooks = {}
    def __init__(self, prog, tag, dev):
        self.prog = prog
        self.tag = tag
        self.dev = dev
    def run_batch(self, ids, lens, hooks, host):
        import torch
        with torch.no_grad():
            x = torch.as_tensor(ids.astype(np.float32), device=self.dev)
            y = self.prog(x).cpu().numpy()
        return [{"tokens": [int(lens[i])],
                 "score": float(np.ravel(y)[i]), "tag": self.tag}
                for i in range(ids.shape[0])]


class CTRScorer:
    # online-learning serving side: score CTR requests from the newest
    # COMMITTED sharded-table generation in MODEL_DIR. A rollout()'s
    # swap_model frame re-runs _boot_model, which re-reads the
    # directory — the hot-swap IS "load the trainer's latest
    # checkpoint". Request ids are feature ids; score = sigmoid(sum of
    # their learned weights).
    can_host = False
    engine = None
    named_hooks = {}
    def __init__(self, weights, tag, gen):
        self.w = weights
        self.tag = tag
        self.gen = gen
    def run_batch(self, ids, lens, hooks, host):
        import math
        outs = []
        for i in range(ids.shape[0]):
            feats = ids[i, : max(int(lens[i]), 0)]
            z = sum(self.w.get(int(f), 0.0) for f in feats)
            p = 1.0 / (1.0 + math.exp(-z))
            outs.append({"tokens": [int(lens[i])], "score": p,
                         "tag": self.tag, "gen": self.gen})
        return outs


def _boot_model(new_tag):
    if mode == "toy":
        return Toy(new_tag, delay)
    if mode == "ctr":
        from paddle_tpu_torch.trainer import async_checkpoint as ac
        from paddle_tpu_torch.trainer import online
        gen, payloads, _meta = ac.load_table_generation(
            os.environ["MODEL_DIR"], -1)
        return CTRScorer(online.weights_from_payloads(payloads),
                         new_tag, gen)
    import torch
    from paddle_tpu_torch import inference, testing_faults
    if mode == "cache":
        policy = json.loads(os.environ.get("CACHE_POLICY", "null"))
        prog = inference.load_verified(
            os.environ["CACHE_DIR"], os.environ["CACHE_KEY"],
            policy=policy, device=dev)
        return Cached(prog, new_tag, dev)
    if mode != "compile":
        raise ValueError("REPLICA_MODE " + repr(mode))
    # compile: build the program and export it, publishing nothing
    fn = testing_faults.replica_program_fn(
        int(os.environ.get("FN_LAYERS", "16")),
        int(os.environ.get("FN_DIM", "256"))).to(dev)
    ep = inference.export_program(
        fn, (torch.zeros((1, 8), dtype=torch.float32, device=dev),))
    return Cached(ep.module(), new_tag, dev)


try:
    # the device first: without a card a replica refuses at boot
    dev = resolve_device(device)
    model = _boot_model(tag)
except BaseException as e:
    # the verified-cache gate biting IS a supported outcome: refuse
    # loudly, exit nonzero, serve nothing
    print("BOOT_REFUSED " + type(e).__name__ + ": " + str(e),
          flush=True)
    sys.exit(3)
print("BOOT %s %.6f" % (mode, time.monotonic() - t0), flush=True)

srv = InferenceServer(ServeConfig(
    max_queue=max_queue,
    max_batch=4 if mode in ("toy", "ctr") else 1,
    default_deadline_s=30.0,
    buckets=(8, 16, 32, 64) if mode in ("toy", "ctr") else (8,),
))
srv.add_model(model_name, model)


def load_model(name, new_tag):
    return _boot_model(new_tag or "swapped")


tcp = ServingTCPServer(srv, port=0, model_loader=load_model)
print("LISTENING %d" % tcp.port, flush=True)

done = threading.Event()
import signal
signal.signal(signal.SIGTERM, lambda *a: done.set())
done.wait()
tcp.stop_accepting()
srv.shutdown(drain=True)
tcp.stop(drain=True)
print("DRAINED", flush=True)
"""


def start_serving_replica(repo: str, boot_timeout: float = 300.0,
                          **env_overrides):
    """Launch one serving replica (SERVING_REPLICA_SRC) and wait for
    its boot handshake (at most `boot_timeout` seconds). Returns
    `(proc, port)`; `port` is None when the boot was refused (verified
    cache gate, no card), the process died before listening, or the
    handshake did not come in time. The boot line ("BOOT <mode>
    <seconds>" or "BOOT_REFUSED <err>") is stashed on `proc.boot_line`.

    Knobs via env_overrides: REPLICA_MODE (toy|cache|compile|ctr),
    MODEL_NAME, MODEL_TAG, TOY_DELAY_S, MAX_QUEUE, CACHE_DIR,
    CACHE_KEY, CACHE_POLICY (JSON), FN_LAYERS, FN_DIM, DEVICE (default
    cuda), PADDLE_FLIGHT_DIR, MODEL_DIR (ctr: the sharded-table
    generation dir the scorer loads from — and reloads on every
    swap_model). The rest is fixed: max_batch 4 (1 in cache and
    compile mode), a 30 s default deadline, an ephemeral port."""
    env = dict(
        os.environ, REPO=repo,
        **{k: str(v) for k, v in env_overrides.items()},
    )
    proc = subprocess.Popen(
        [sys.executable, "-c", SERVING_REPLICA_SRC], env=env,
        cwd=repo, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
        text=True,
    )
    # the handshake is read on a thread so that a replica that hangs
    # before its boot line costs `boot_timeout`, not the caller's life
    lines = []
    got = threading.Event()

    def read():
        while True:
            line = proc.stdout.readline()
            if not line:
                break
            line = line.strip()
            lines.append(line)
            if line.startswith(("BOOT_REFUSED", "LISTENING")):
                break
        got.set()

    threading.Thread(target=read, daemon=True).start()
    got.wait(boot_timeout)
    boot = next((ln for ln in lines
                 if ln.startswith(("BOOT_REFUSED", "BOOT "))), None)
    port = next((int(ln.split()[1]) for ln in lines
                 if ln.startswith("LISTENING")), None)
    proc.boot_line = boot
    return proc, port


def replica_boot_seconds(proc) -> float:
    """Parse the boot duration off a replica's handshake line."""
    line = getattr(proc, "boot_line", None) or ""
    parts = line.split()
    if len(parts) == 3 and parts[0] == "BOOT":
        return float(parts[2])
    raise ValueError(f"no boot line on replica: {line!r}")


class FlakyProxy:
    """TCP proxy with programmable connection faults.

    Sits between a client and a real server (a serving replica):

        proxy = FlakyProxy(("127.0.0.1", replica_port))
        client = ServeClient(f"127.0.0.1:{proxy.port}")
        proxy.reset_next(3)   # next 3 connections get RST mid-call
        proxy.refuse_all()    # then: connect() succeeds, dies instantly
        proxy.heal()          # back to transparent forwarding

    Faults are applied per accepted connection, so a client with
    reconnect-and-retry semantics sees exactly N failures and then a
    clean server — the deterministic version of "the server is
    restarting"."""

    def __init__(self, target: tuple, listen_host: str = "127.0.0.1"):
        self._target = target
        self._lock = threading.Lock()
        self._reset_budget = 0  # connections to RST after the request
        self._refuse = False  # close every connection immediately
        self._delay_s = 0.0  # added latency before forwarding starts
        self._cut_after = 0  # RST after N response bytes (0 = off)
        self._black_hole = False  # accept + read, never answer
        self._conns: list = []
        self._listener = socket.socket()
        self._listener.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
        self._listener.bind((listen_host, 0))
        self._listener.listen(16)
        self.port = self._listener.getsockname()[1]
        self._stopped = False
        self._thread = threading.Thread(
            target=self._accept_loop, name="flaky-proxy", daemon=True
        )
        self._thread.start()

    # ---- fault programming ----
    def reset_next(self, n: int = 1) -> None:
        """RST the next `n` connections right after they send data."""
        with self._lock:
            self._reset_budget = n

    def refuse_all(self) -> None:
        """Kill every new connection immediately after accept — the
        observable shape of a server that is down/restarting."""
        with self._lock:
            self._refuse = True

    def delay(self, seconds: float) -> None:
        with self._lock:
            self._delay_s = seconds

    def cut_after(self, n_bytes: int) -> None:
        """RST each new connection after `n_bytes` of RESPONSE bytes
        have been relayed — the client receives a torn half-response
        (a mid-reply network cut, not a clean close)."""
        with self._lock:
            self._cut_after = n_bytes

    def black_hole(self) -> None:
        """Accept every connection and read its requests, but never
        forward or answer — the nastiest server failure mode: alive at
        the TCP layer, dead at the protocol layer. A client whose recv
        is unbounded hangs here FOREVER regardless of its retry
        deadline (what the admin frames' bounded timeout exists
        for)."""
        with self._lock:
            self._black_hole = True

    def heal(self) -> None:
        with self._lock:
            self._refuse = False
            self._reset_budget = 0
            self._delay_s = 0.0
            self._cut_after = 0
            self._black_hole = False

    def cut_existing(self) -> None:
        """RST every currently-open proxied connection (network
        partition for in-flight calls)."""
        with self._lock:
            conns, self._conns = self._conns, []
        for s in conns:
            _rst_close(s)

    # ---- plumbing ----
    def _accept_loop(self):
        while not self._stopped:
            try:
                client, _ = self._listener.accept()
            except OSError:
                return
            with self._lock:
                refuse = self._refuse
                reset = self._reset_budget > 0
                if reset:
                    self._reset_budget -= 1
                delay_s = self._delay_s
                cut_after = self._cut_after
                black_hole = self._black_hole
            if refuse:
                _rst_close(client)
                continue
            if black_hole:
                with self._lock:
                    self._conns.append(client)
                threading.Thread(
                    target=_swallow, args=(client,), daemon=True
                ).start()
                continue
            threading.Thread(
                target=self._serve,
                args=(client, reset, delay_s, cut_after),
                daemon=True,
            ).start()

    def _serve(self, client: socket.socket, reset: bool, delay_s: float,
               cut_after: int = 0):
        try:
            upstream = socket.create_connection(self._target, timeout=5)
        except OSError:
            _rst_close(client)
            return
        with self._lock:
            self._conns += [client, upstream]
        if reset:
            # let exactly one request through to the wire, then RST the
            # client before the response lands: the retried call is the
            # at-least-once duplicate the protocol must absorb
            try:
                data = client.recv(65536)
                if data:
                    upstream.sendall(data)
                    if delay_s:
                        threading.Event().wait(delay_s)
            except OSError:
                pass
            _rst_close(client)
            _rst_close(upstream)
            return
        if delay_s:
            threading.Event().wait(delay_s)
        t = threading.Thread(
            target=_pump, args=(client, upstream), daemon=True
        )
        t.start()
        _pump(upstream, client, limit=cut_after or None)
        if cut_after:
            # torn mid-response: RST both halves, no clean FIN
            _rst_close(client)
            _rst_close(upstream)

    def close(self):
        self._stopped = True
        try:
            self._listener.close()
        finally:
            self.cut_existing()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()


def _rst_close(s: socket.socket) -> None:
    """Close sending RST instead of FIN (SO_LINGER 0) — the peer's
    blocked recv fails with ECONNRESET instead of a clean EOF."""
    try:
        s.setsockopt(
            socket.SOL_SOCKET, socket.SO_LINGER, struct.pack("ii", 1, 0)
        )
    except OSError:
        pass
    try:
        # wake a relay thread blocked in recv() on this socket: the
        # socket (and its RST) goes only once no syscall holds it
        s.shutdown(socket.SHUT_RD)
    except OSError:
        pass
    try:
        s.close()
    except OSError:
        pass


def _swallow(s: socket.socket) -> None:
    """black_hole service: read and discard until the peer gives up."""
    try:
        while s.recv(65536):
            pass
    except OSError:
        pass
    finally:
        try:
            s.close()
        except OSError:
            pass


def _pump(src: socket.socket, dst: socket.socket,
          limit: int = None) -> None:
    """Relay src -> dst; with `limit`, stop (returning to the caller,
    which RSTs) once `limit` bytes have been forwarded."""
    sent = 0
    try:
        while True:
            data = src.recv(65536)
            if not data:
                break
            if limit is not None and sent + len(data) >= limit:
                dst.sendall(data[: max(limit - sent, 0)])
                return  # caller tears the connection down with RST
            dst.sendall(data)
            sent += len(data)
    except OSError:
        pass
    finally:
        if limit is None:
            try:
                dst.shutdown(socket.SHUT_WR)
            except OSError:
                pass
