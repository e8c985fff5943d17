"""The port's fleet tier (`paddle_tpu_torch/serving/fleet.py`) on the CPU,
in-process and over subprocess replicas started with `DEVICE=cpu`
(`paddle_tpu_torch/testing_faults.py`).

The port is held to the contract, not to the JAX fleet's outcome (some
JAX fleet tests are red on this machine):

- spill-before-shed: an overloaded replica's shed is a routing hint;
- zero-downtime rollout: a polling client sees no failed response and
  the tag moves v1 -> v2, each replica through drain, swap, undrain;
- `FlakyProxy` transport faults (reset, refuse, black hole) spill to a
  sibling and charge the faulty replica's breaker;
- zero admitted requests lost across a SIGKILL, the replica rotated out
  and its replacement booted from the verified cache rejoining through
  the half-open probe; the cache gate refusing a corrupt entry at boot;
- a p99 SLO breach writes exactly one stitched incident bundle that the
  bundle lint accepts and `tools/fleet_view.py` reads (in-process and
  as a subprocess);
- `fleetz` and `metrics` in subprocesses with JAX import-blocked, the
  latter equal to the JAX CLI's output on the same event stream.

Waits are event-driven (boot lines, states, files), ports ephemeral,
and every subprocess wait has its own timeout.
"""

import json
import os
import subprocess
import sys
import threading
import time

import numpy as np
import pytest
import torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.join(REPO, "tools"))

from paddle_tpu_torch import inference  # noqa: E402
from paddle_tpu_torch import testing_faults as tf  # noqa: E402
from paddle_tpu_torch.obs import aggregate as agg  # noqa: E402
from paddle_tpu_torch.obs import flight_recorder as fr  # noqa: E402
from paddle_tpu_torch.obs import metrics as om  # noqa: E402
from paddle_tpu_torch.serving.fleet import (  # noqa: E402
    FleetConfig,
    FleetRouter,
    RolloutReport,
)
from paddle_tpu_torch.serving.server import (  # noqa: E402
    InferenceServer,
    ServeConfig,
)
from paddle_tpu_torch.serving.tcp import (  # noqa: E402
    ServeClient,
    ServingTCPServer,
)

import check_bench_record as cbr  # noqa: E402
import fleet_view  # noqa: E402

pytestmark = pytest.mark.faults
CPU = {"DEVICE": "cpu"}


class ToyModel:
    can_host = False
    engine = None
    named_hooks = {}

    def __init__(self, delay_s=0.005, tag="v1"):
        self.delay_s = delay_s
        self.tag = tag

    def run_batch(self, ids, lens, hooks, host):
        time.sleep(self.delay_s)
        return [{"tokens": [int(lens[i])], "score": 0.0, "tag": self.tag}
                for i in range(ids.shape[0])]


class _Replica:
    """In-process replica: a real TCP front end over a real server."""

    def __init__(self, delay_s=0.005, max_queue=32, max_batch=4, tag="v1"):
        self.srv = InferenceServer(ServeConfig(
            max_queue=max_queue, max_batch=max_batch,
            default_deadline_s=30.0))
        self.srv.add_model("m", ToyModel(delay_s, tag=tag))

        def load_model(name, new_tag):
            return ToyModel(delay_s, tag=new_tag or "swapped")

        self.tcp = ServingTCPServer(self.srv, model_loader=load_model)
        self.addr = f"127.0.0.1:{self.tcp.port}"

    def close(self):
        self.tcp.stop()
        self.srv.shutdown(drain=False)


def _counter_total(family):
    return agg.family_total(om.get_registry().snapshot()["counters"],
                            family)


def _until(pred, timeout=10.0, step=0.01):
    deadline = time.monotonic() + timeout
    while time.monotonic() < deadline:
        if pred():
            return True
        time.sleep(step)
    return pred()


def _scraped(router, names):
    return _until(lambda: all(router.handle(n).metricz for n in names))


def _load(router, stop, workers, deadline_ms=5000, trace=False):
    """Closed-loop clients; returns (ok counter, failures list)."""
    lock = threading.Lock()
    ok, bad = [0], []

    def one():
        while not stop.is_set():
            try:
                r = router.call("m", [1, 2, 3], deadline_ms=deadline_ms,
                                trace=trace)
            except Exception as e:  # noqa: BLE001
                with lock:
                    bad.append(repr(e))
                continue
            with lock:
                if r.get("ok"):
                    ok[0] += 1
                else:
                    bad.append(r)

    ts = [threading.Thread(target=one, daemon=True) for _ in range(workers)]
    for t in ts:
        t.start()
    return ok, bad, ts


def test_spill_before_shed():
    slow = _Replica(delay_s=0.5, max_queue=1, max_batch=1)
    fast = _Replica(delay_s=0.002)
    router = FleetRouter({"slow": slow.addr, "fast": fast.addr},
                         FleetConfig(poll_interval_s=0.05, monitor=False))
    before = _counter_total("fleet.spills")
    try:
        assert _scraped(router, ("slow", "fast"))
        results = []
        lock = threading.Lock()

        def one():
            r = router.call("m", [1, 2, 3], deadline_ms=20000, trace=False)
            with lock:
                results.append(r)

        ts = [threading.Thread(target=one) for _ in range(12)]
        for t in ts:
            t.start()
        for t in ts:
            t.join(30)
        assert len(results) == 12
        assert all(r.get("ok") for r in results), results
        assert _counter_total("fleet.spills") > before
    finally:
        router.close()
        slow.close()
        fast.close()


def test_fleet_sheds_only_when_every_replica_refuses():
    reps = [_Replica(delay_s=0.3, max_queue=1, max_batch=1)
            for _ in range(2)]
    router = FleetRouter({f"r{i}": r.addr for i, r in enumerate(reps)},
                         FleetConfig(poll_interval_s=0.05, monitor=False))
    try:
        results = []
        lock = threading.Lock()

        def one():
            r = router.call("m", [1], deadline_ms=20000, trace=False)
            with lock:
                results.append(r)

        ts = [threading.Thread(target=one) for _ in range(10)]
        for t in ts:
            t.start()
        for t in ts:
            t.join(30)
        shed = [r for r in results if not r.get("ok")]
        assert shed and all(r["error"] == "overloaded" for r in shed)
        assert all(r["fleet_spills"] >= 1 for r in shed)
        assert len(results) == 10
    finally:
        router.close()
        for r in reps:
            r.close()


def test_rollout_zero_downtime():
    reps = [_Replica(delay_s=0.002), _Replica(delay_s=0.002)]
    router = FleetRouter({"r0": reps[0].addr, "r1": reps[1].addr},
                         FleetConfig(poll_interval_s=0.05, monitor=False))
    rec = fr.enable_flight_recorder(dump_dir=None, capacity=512)
    try:
        assert _scraped(router, ("r0", "r1"))
        stop = threading.Event()
        seen, failures = [], []

        def poller():
            while not stop.is_set():
                r = router.call("m", [1, 2], deadline_ms=5000, trace=False)
                (seen.append(r.get("tag")) if r.get("ok")
                 else failures.append(r))
                time.sleep(0.002)

        t = threading.Thread(target=poller)
        t.start()
        assert _until(lambda: len(seen) >= 10)
        rep = router.rollout("m", tag="v2")
        n = len(seen)
        assert _until(lambda: len(seen) >= n + 10)
        stop.set()
        t.join(10)
        assert failures == [], failures[:3]
        assert isinstance(rep, RolloutReport) and rep.ok
        assert all(r["ok"] and r["swapped"] == "m" for r in rep.values())
        assert seen[0] == "v1" and seen[-1] == "v2"
        assert "v1" not in seen[n:]
        for name in ("r0", "r1"):
            assert [p["phase"] for p in rep.phases
                    if p["replica"] == name] == [
                "drain_begin", "drain_end", "swap", "undrain"]
            assert rep.per_replica[name]["swap_s"] > 0
        evs = [e for e in rec.snapshot() if e.get("kind") == "rollout"]
        assert len(evs) == 8
        with pytest.raises(RuntimeError, match="refused"):
            router.rollout("ghost")
        assert router.states()["r0"]["draining"] is False
    finally:
        fr.disable_flight_recorder()
        router.close()
        for r in reps:
            r.close()


@pytest.mark.parametrize("fault", ["reset", "refuse", "cut"])
def test_flaky_proxy_faults_spill_to_sibling(fault):
    """Transport faults on one replica's path: every routed request is
    answered by the sibling, and the faulty replica's breaker opens."""
    bad, good = _Replica(delay_s=0.002), _Replica(delay_s=0.002)
    port = int(bad.addr.rsplit(":", 1)[1])
    proxy = tf.FlakyProxy(("127.0.0.1", port))
    router = FleetRouter(
        {"bad": f"127.0.0.1:{proxy.port}", "good": good.addr},
        FleetConfig(poll_interval_s=0.05, breaker_threshold=2,
                    breaker_reset_s=60.0, client_retries=0,
                    monitor=False))
    before = _counter_total("fleet.transport_errors")
    try:
        assert _scraped(router, ("bad", "good"))
        if fault == "reset":
            proxy.reset_next(1000)
        elif fault == "refuse":
            proxy.refuse_all()
        else:
            proxy.cut_after(2)
        proxy.cut_existing()
        out = [router.call("m", [1, 2], deadline_ms=5000, trace=False)
               for _ in range(12)]
        assert all(r.get("ok") for r in out), out
        assert _until(lambda: router.states()["bad"]["breaker"] != "closed")
        assert _counter_total("fleet.transport_errors") > before
        proxy.heal()
    finally:
        router.close()
        proxy.close()
        bad.close()
        good.close()


def test_black_holed_admin_frame_bounded():
    rep = _Replica()
    port = int(rep.addr.rsplit(":", 1)[1])
    proxy = tf.FlakyProxy(("127.0.0.1", port))
    try:
        proxy.black_hole()
        c = ServeClient(f"127.0.0.1:{proxy.port}", retries=0,
                        admin_timeout=0.3)
        t0 = time.monotonic()
        with pytest.raises(OSError):
            c.flightz()
        assert time.monotonic() - t0 < 5.0
        c.close()
    finally:
        proxy.close()
        rep.close()


def _start(n, **env):
    """Start n replicas in parallel; returns [(proc, port)]."""
    out = [None] * n

    def go(i):
        out[i] = tf.start_serving_replica(REPO, boot_timeout=120,
                                          **{**CPU, **env})

    ts = [threading.Thread(target=go, args=(i,)) for i in range(n)]
    for t in ts:
        t.start()
    for t in ts:
        t.join(150)
    return out


def _store_cache(tmp_path):
    cache = str(tmp_path / "vcache")
    inference.store_verified(cache, "fleet", tf.replica_program_fn(4, 16),
                             (torch.zeros((1, 8)),))
    return cache


def test_sigkill_zero_loss_rotation_and_cache_rejoin(tmp_path):
    cache = _store_cache(tmp_path)
    started = _start(3, REPLICA_MODE="toy", TOY_DELAY_S=0.002,
                     MODEL_TAG="v1")
    procs = {f"r{i}": p for i, (p, _) in enumerate(started)}
    try:
        assert all(port for _, port in started), [
            p.boot_line for p, _ in started]
        addrs = {f"r{i}": f"127.0.0.1:{port}"
                 for i, (_, port) in enumerate(started)}
        fcfg = FleetConfig(poll_interval_s=0.05, breaker_reset_s=0.4)
        router = FleetRouter(dict(addrs), fcfg)
        try:
            assert _scraped(router, addrs)
            stop = threading.Event()
            ok, lost, workers = _load(router, stop, 4)
            assert _until(lambda: ok[0] >= 50)
            tf.kill_process(procs["r1"])
            assert _until(
                lambda: router.states()["r1"]["breaker"] != "closed",
                timeout=fcfg.breaker_reset_s * 3)
            n = ok[0]
            assert _until(lambda: ok[0] >= n + 50)  # serving through it
            stop.set()
            for w in workers:
                w.join(10)
            assert lost == [], lost[:5]

            (p, port), = _start(1, REPLICA_MODE="cache", CACHE_DIR=cache,
                                CACHE_KEY="fleet", MODEL_TAG="v2")
            procs["r1"] = p
            assert port is not None, p.boot_line
            assert p.boot_line.startswith("BOOT cache")
            assert tf.replica_boot_seconds(p) > 0
            rejoins = _counter_total("fleet.rejoins")
            router.set_address("r1", f"127.0.0.1:{port}")
            assert _until(
                lambda: router.states()["r1"]["breaker"] == "closed")
            assert _counter_total("fleet.rejoins") == rejoins + 1
            with ServeClient(f"127.0.0.1:{port}") as c:
                out = c.call("m", [1, 2], deadline_ms=10000, timeout=30)
            want = float(tf.replica_program_fn(4, 16)(
                torch.tensor([[1.0, 2.0] + [0.0] * 6])))
            assert out["ok"] and out["tag"] == "v2"
            assert out["score"] == pytest.approx(want, abs=1e-6)
        finally:
            router.close()
    finally:
        for p in procs.values():
            tf.kill_process(p)


@pytest.mark.parametrize("fault", ["corrupt", "policy", "no_card"])
def test_replica_boot_refused(tmp_path, fault):
    cache = _store_cache(tmp_path)
    env = dict(REPLICA_MODE="cache", CACHE_DIR=cache, CACHE_KEY="fleet")
    if fault == "corrupt":
        tf.corrupt_file(os.path.join(cache, "fleet", "program.pt2"),
                        nbytes=4)
    elif fault == "policy":
        env["CACHE_POLICY"] = json.dumps({"total_bytes_max": 1})
    if fault == "no_card":
        # DEVICE=cuda (the default) on a machine without a card
        p, port = tf.start_serving_replica(
            REPO, boot_timeout=120, DEVICE="cuda", **env)
    else:
        (p, port), = _start(1, **env)
    try:
        assert port is None
        assert p.boot_line and p.boot_line.startswith("BOOT_REFUSED")
        want = {"corrupt": "digest", "policy": "audit",
                "no_card": "no CUDA device"}[fault]
        assert want in p.boot_line
        assert p.wait(timeout=30) == 3
    finally:
        tf.kill_process(p)


def test_compile_mode_boot_serves_the_same_program():
    (p, port), = _start(1, REPLICA_MODE="compile", FN_LAYERS=4, FN_DIM=16)
    try:
        assert port is not None, p.boot_line
        assert p.boot_line.startswith("BOOT compile")
        with ServeClient(f"127.0.0.1:{port}") as c:
            out = c.call("m", [3, 1], deadline_ms=10000, timeout=30)
        want = float(tf.replica_program_fn(4, 16)(
            torch.tensor([[3.0, 1.0] + [0.0] * 6])))
        assert out["ok"] and out["score"] == pytest.approx(want, abs=1e-6)
    finally:
        tf.kill_process(p)


def _bundle_files(d):
    if not os.path.isdir(d):
        return []
    return [f for f in os.listdir(d)
            if f.startswith("incident-") and f.endswith(".json")]


def test_slo_breach_writes_one_stitched_incident(tmp_path):
    incident_dir = str(tmp_path / "incidents")
    started = {}
    for name, delay in (("slow", 0.3), ("fast", 0.004)):
        (started[name],) = _start(1, REPLICA_MODE="toy", TOY_DELAY_S=delay)
    procs = {n: p for n, (p, _) in started.items()}
    try:
        assert all(port for _, port in started.values())
        addrs = {n: f"127.0.0.1:{port}" for n, (_, port) in started.items()}
        cfg = FleetConfig(
            poll_interval_s=0.05, monitor=True, slo_p99_ms=100.0,
            burn_windows=((0.9, 2.7, 14.4),), burn_min_decisions=20,
            incident_dir=incident_dir, incident_min_interval_s=3600.0,
            incident_max_bundles=4)
        fr.enable_flight_recorder(dump_dir=None, capacity=512)
        router = FleetRouter(dict(addrs), cfg)
        suppressed = _counter_total("fleet.incidents_suppressed")
        try:
            assert _scraped(router, addrs)
            stop = threading.Event()
            _ok, _bad, workers = _load(router, stop, 3, deadline_ms=20000,
                                       trace=True)
            assert _until(lambda: _bundle_files(incident_dir), timeout=30)
            # keep burning: the rate limit holds the count at one
            assert _until(lambda: _counter_total(
                "fleet.incidents_suppressed") > suppressed, timeout=10)
            stop.set()
            for w in workers:
                w.join(10)
            files = _bundle_files(incident_dir)
            assert len(files) == 1, files
            path = os.path.join(incident_dir, files[0])
            assert cbr.check_bundle(path) == []
            doc = json.load(open(path))
            assert doc["schema"] == "paddle-tpu-fleet-incident/v1"
            assert doc["reason"] == "burn_rate"
            assert any(a["alert"] == "p99_slo" for a in doc["alerts"])
            assert doc["offending"] == "slow"
            assert set(doc["replicas"]) == {"slow", "fast"}
            for name in ("slow", "fast"):
                ring = doc["replicas"][name]
                assert ring.get("enabled") is True, ring
                assert ring["pid"] == procs[name].pid
                assert any(e.get("kind") == "span" for e in ring["events"])
            assert "serving.admitted_latency_s" in str(
                doc["fleet"]["merged"]["histograms"].keys())
            assert doc["history"]
            assert router.monitor.last_incident_path == path
            assert router.monitor.state()["burn"]["alerts_total"] >= 1
            report = fleet_view.analyze(path, top=5)
            assert report["offending"] == "slow"
            cross = [t for t in report["traces"] if t["cross_process"]]
            assert cross and "router" in cross[0]["processes"]
            assert len(cross[0]["processes"]) >= 2
            r = subprocess.run(
                [sys.executable, os.path.join(REPO, "tools",
                                              "fleet_view.py"), path],
                capture_output=True, text=True, timeout=120)
            assert r.returncode == 0, r.stderr
            assert "offending=slow" in r.stdout
        finally:
            fr.disable_flight_recorder()
            router.close()
    finally:
        for p in procs.values():
            tf.kill_process(p)


def _jax_blocked_env(tmp_path):
    blocker = tmp_path / "blocker"
    blocker.mkdir(exist_ok=True)
    for mod in ("jax", "paddle_tpu"):
        (blocker / f"{mod}.py").write_text(
            f"raise ImportError('{mod} blocked for this test')\n")
    return dict(os.environ, PYTHONPATH=str(blocker) + os.pathsep + REPO)


def test_fleetz_cli_jax_blocked(tmp_path):
    reps = [_Replica(delay_s=0.002), _Replica(delay_s=0.002)]
    dead = "127.0.0.1:1"
    try:
        stop = threading.Event()

        def drive():
            with ServeClient(reps[0].addr) as c0, \
                    ServeClient(reps[1].addr) as c1:
                while not stop.is_set():
                    c0.call("m", [1], deadline_ms=5000)
                    c1.call("m", [1], deadline_ms=5000)

        t = threading.Thread(target=drive, daemon=True)
        t.start()
        env = _jax_blocked_env(tmp_path)
        r = subprocess.run(
            [sys.executable, "-m", "paddle_tpu_torch", "fleetz",
             "--addr", f"a={reps[0].addr}", "--addr", f"b={reps[1].addr}",
             "--interval", "0.4", "--json"],
            cwd=REPO, env=env, capture_output=True, text=True, timeout=120)
        down = subprocess.run(
            [sys.executable, "-m", "paddle_tpu_torch", "fleetz",
             "--addr", f"up={reps[0].addr}", "--addr", f"down={dead}",
             "--interval", "0.05", "--timeout", "0.5"],
            cwd=REPO, env=env, capture_output=True, text=True, timeout=120)
        stop.set()
        t.join(10)
        assert r.returncode == 0, r.stderr
        doc = json.loads(r.stdout)
        assert doc["fleet"]["replicas_up"] == 2
        assert doc["fleet"]["admitted_rate_rps"] > 0
        assert doc["fleet"]["p99_ms"] is not None
        rows = {x["replica"]: x for x in doc["replicas"]}
        assert set(rows) == {"a", "b"} and rows["a"]["admitted"] > 0
        assert doc["alerts"] == []
        assert down.returncode == 1, down.stdout + down.stderr
        assert "DOWN" in down.stdout and "replica_down" in down.stdout
    finally:
        for rep in reps:
            rep.close()


def _write_stream(path):
    """An event stream with spans, watchdog rungs and a timeline record,
    written by the port's EventStream."""
    rng = np.random.default_rng(24)
    s = om.EventStream(path, flush_interval_s=60.0)
    for i in range(30):
        tid = f"t{i % 7}"
        s.emit({"kind": "span", "name": ("serve.request", "serve.queued",
                                         "serve.dispatch")[i % 3],
                "trace_id": tid, "span_id": f"s{i}",
                "parent_id": "" if i % 3 == 0 else f"s{i - i % 3}",
                "dur_s": float(rng.exponential(0.01)), "status": "ok"})
    for ev in ("skip", "skip", "backoff"):
        s.emit({"kind": "watchdog", "event": ev, "global_step": 3})
    s.emit({"kind": "timeline", "pass_id": 0, "global_step": 9,
            "data_wait_frac": 0.1, "host_overhead_frac": 0.2,
            "device_frac": 0.6, "checkpoint_stall_frac": 0.1})
    s.close()


@pytest.mark.parametrize("args", [["--json"], ["--spans", "--json"],
                                  ["--spans", "--top", "3"], []])
def test_metrics_cli_equal_to_jax(tmp_path, args):
    stream = str(tmp_path / "events.jsonl")
    _write_stream(stream)
    argv = ["metrics", "--stream", stream] + args
    got = subprocess.run([sys.executable, "-m", "paddle_tpu_torch"] + argv,
                         cwd=REPO, env=_jax_blocked_env(tmp_path),
                         capture_output=True, text=True, timeout=120)
    want = subprocess.run(
        [sys.executable, "-m", "paddle_tpu"] + argv, cwd=REPO,
        env=dict(os.environ, JAX_PLATFORMS="cpu"), capture_output=True,
        text=True, timeout=120)
    assert got.returncode == want.returncode == 0, got.stderr
    assert got.stdout == want.stdout
    assert "30" in got.stdout or "span" in got.stdout
