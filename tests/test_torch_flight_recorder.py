"""The port's flight recorder (`paddle_tpu_torch/obs/flight_recorder.py`)
against the JAX package's, on the CPU.

- The same event sequence into both recorders writes bundles that are
  equal once ts, pid and paths are dropped.
- The ring bound, the rate limit (`flight.dumps_suppressed`) and the
  bounded dump dir behave as the JAX recorder's, file for file.
- The watchdog's anomaly rungs dump through the recorder in both
  packages, bundle for bundle.
- A host-fallback rescue that opens the breaker dumps `breaker_open`;
  the test waits for the final `.json` (a bundle lands as `*.json.tmp`
  first), not for a non-empty directory.
- The profiler capture writes a Chrome trace beside the bundle and its
  attribution, and the bundle lint accepts the bundle.
"""

import json
import os
import sys
import time

from paddle_tpu.obs import flight_recorder as jfr
from paddle_tpu.obs import metrics as jom
from paddle_tpu.trainer import watchdog as jwdg
from paddle_tpu_torch.core import flags as tflags
from paddle_tpu_torch.obs import flight_recorder as tfr
from paddle_tpu_torch.obs import metrics as tom
from paddle_tpu_torch.trainer import watchdog as twdg

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.join(REPO, "tools"))

import check_bench_record as cbr  # noqa: E402

# volatile per-process fields: wall-clock stamps, the pid and paths
VOLATILE = ("ts", "pid", "profile_dir", "trace", "attrib")


def _stable(obj):
    if isinstance(obj, dict):
        return {k: _stable(v) for k, v in obj.items()
                if k not in VOLATILE}
    if isinstance(obj, list):
        return [_stable(v) for v in obj]
    return obj


def _events(reg):
    reg.event("span", name="serve.request", trace_id="t1", span_id="s1",
              parent_id="", dur_s=0.25, status="ok",
              labels={"model": "m"})
    reg.event("watchdog", event="skip", global_step=3, loss="nan")
    reg.event("timeline", pass_id=0, global_step=4, device_frac=0.5)
    reg.event("serving", event="breaker_open", model="m")


def _pair(tmp_path, **kw):
    jreg, treg = jom.MetricsRegistry(), tom.MetricsRegistry()
    jrec = jfr.FlightRecorder(dump_dir=str(tmp_path / "jax"),
                              registry=jreg, **kw)
    trec = tfr.FlightRecorder(dump_dir=str(tmp_path / "torch"),
                              registry=treg, **kw)
    jreg.attach_recorder(jrec)
    treg.attach_recorder(trec)
    return (jreg, jrec), (treg, trec)


def _bundles(d):
    return sorted(f for f in os.listdir(d) if f.endswith(".json"))


def test_same_events_give_equal_bundles(tmp_path):
    (jreg, jrec), (treg, trec) = _pair(tmp_path, min_interval_s=60.0)
    for reg in (jreg, treg):
        _events(reg)
        reg.counter("serving.shed").inc(reason="overloaded")
        reg.histogram("serving.admitted_latency_s").observe(0.01,
                                                            model="m")
    jp = jrec.maybe_dump("breaker_open", model="m")
    tp = trec.maybe_dump("breaker_open", model="m")
    assert os.path.basename(jp) == os.path.basename(tp)
    got, want = json.load(open(tp)), json.load(open(jp))
    assert got["schema"] == tfr.BUNDLE_SCHEMA == jfr.BUNDLE_SCHEMA
    assert got["pid"] == os.getpid()
    assert all("ts" in e for e in got["events"])
    assert _stable(got) == _stable(want)
    assert cbr.check_bundle(tp) == []
    assert trec.last_bundle_path == tp and trec.last_bundle == got


def test_ring_only_mode_matches(tmp_path):
    """No dump dir: the trigger is counted and the bundle kept in
    memory, as in the JAX recorder."""
    jreg, treg = jom.MetricsRegistry(), tom.MetricsRegistry()
    jrec = jfr.FlightRecorder(registry=jreg, capacity=16)
    trec = tfr.FlightRecorder(registry=treg, capacity=16)
    jreg.attach_recorder(jrec)
    treg.attach_recorder(trec)
    for reg in (jreg, treg):
        for i in range(100):
            reg.event("k", i=i)
        _events(reg)
    assert _stable(trec.snapshot()) == _stable(jrec.snapshot())
    assert len(trec.snapshot()) == 16
    assert [e["name"] for e in trec.spans()] == ["serve.request"]
    assert trec.maybe_dump("slo_breach", p99_ms=3.0) is None
    assert jrec.maybe_dump("slo_breach", p99_ms=3.0) is None
    assert _stable(trec.last_bundle) == _stable(jrec.last_bundle)


def test_rate_limit_and_bounded_dir(tmp_path):
    (jreg, jrec), (treg, trec) = _pair(tmp_path, min_interval_s=60.0,
                                       max_bundles=8)
    for reg, rec in ((jreg, jrec), (treg, trec)):
        reg.event("watchdog", event="skip", global_step=3)
        assert rec.maybe_dump("watchdog_skip", global_step=3)
        for _ in range(10):
            assert rec.maybe_dump("watchdog_skip") is None
        assert reg.counter("flight.dumps_suppressed").get(
            reason="watchdog_skip") == 10
    assert _bundles(tmp_path / "torch") == _bundles(tmp_path / "jax")

    (jreg, jrec), (treg, trec) = _pair(tmp_path / "b", min_interval_s=0.0,
                                       max_bundles=3)
    for rec in (jrec, trec):
        for i in range(7):
            assert rec.maybe_dump(f"r{i}") is not None
    files = _bundles(tmp_path / "b" / "torch")
    assert files == _bundles(tmp_path / "b" / "jax")
    assert len(files) == 3 and files[-1].startswith("flight-00007")


def test_bounded_bundle_dir_alone(tmp_path):
    """The shared dump discipline (incident bundles use it too): one
    sequence number per interval, atomic writes, rotation by prefix."""
    jd = jfr.BoundedBundleDir(str(tmp_path / "j"), prefix="incident-",
                              max_bundles=2, min_interval_s=0.0)
    td = tfr.BoundedBundleDir(str(tmp_path / "t"), prefix="incident-",
                              max_bundles=2, min_interval_s=0.0)
    for d in (jd, td):
        for i in range(4):
            seq = d.try_begin()
            d.write(seq, "burn_rate", {"seq": seq})
    assert _bundles(tmp_path / "t") == _bundles(tmp_path / "j") == [
        "incident-00003-burn_rate.json", "incident-00004-burn_rate.json"]
    assert not [f for f in os.listdir(tmp_path / "t")
                if f.endswith(".tmp")]
    slow = tfr.BoundedBundleDir(None, min_interval_s=60.0)
    assert slow.try_begin() == 1 and slow.try_begin() is None
    assert slow.write(1, "x", {}) is None


def _ladder():
    out = [(1.0 + 0.01 * (i % 3), True) for i in range(8)]
    out += [(9.0, True)]                       # spike -> backoff
    out += [(1.0, True)] * 5
    out += [(float("nan"), False)] * 4         # skips -> abort
    return out


def test_watchdog_rungs_dump_as_the_jax_watchdog(tmp_path):
    cfg = dict(skip_budget=2, good_batches=2, warmup_batches=1000)
    dumps = {}
    for name, wdg, fr in (("jax", jwdg, jfr), ("torch", twdg, tfr)):
        d = str(tmp_path / name)
        fr.enable_flight_recorder(dump_dir=d, min_interval_s=0.0,
                                  max_bundles=64)
        try:
            w = wdg.Watchdog(wdg.WatchdogConfig(**cfg))
            for step, (loss, finite) in enumerate(_ladder()):
                if w.observe(loss, finite, step) == wdg.ABORT:
                    break
        finally:
            fr.disable_flight_recorder()
        dumps[name] = [json.load(open(os.path.join(d, f)))
                       for f in _bundles(d)]
    reasons = [b["reason"] for b in dumps["torch"]]
    assert reasons == [b["reason"] for b in dumps["jax"]]
    assert {"watchdog_skip", "watchdog_abort"} <= set(reasons)
    for got, want in zip(dumps["torch"], dumps["jax"]):
        assert got["context"] == want["context"]
        # the rung that tripped the dump is in its own ring
        assert got["events"][-1]["event"] == got["reason"].split("_", 1)[1]
        assert [(e["kind"], e.get("event")) for e in got["events"]] == [
            (e["kind"], e.get("event")) for e in want["events"]]


def test_watchdog_without_recorder_dumps_nothing(tmp_path):
    assert tfr.get_flight_recorder() is None
    w = twdg.Watchdog(twdg.WatchdogConfig(skip_budget=0))
    assert w.observe(float("nan"), False, 0) == twdg.ABORT
    assert tfr.maybe_dump("watchdog_abort") is None


def _wait_bundles(d, n=1, timeout=10.0):
    """Bundle files that have landed: the final `.json`, never the
    `*.json.tmp` a dump writes first."""
    deadline = time.monotonic() + timeout
    while time.monotonic() < deadline:
        files = _bundles(d) if os.path.isdir(d) else []
        if len(files) >= n:
            return files
        time.sleep(0.01)
    return _bundles(d) if os.path.isdir(d) else []


def test_host_fallback_rescue_fires_breaker_dump(tmp_path):
    """A device failure rescued by the host rung counts on the breaker;
    when that count opens it, the `breaker_open` dump fires from the
    success path."""
    from paddle_tpu_torch.serving.server import InferenceServer, ServeConfig

    d = str(tmp_path / "flight")
    tfr.enable_flight_recorder(dump_dir=d, min_interval_s=300.0)

    class DevicePoisoned:
        can_host = True
        engine = None
        named_hooks = {}

        def run_batch(self, ids, lens, hooks, host):
            if not host:
                raise RuntimeError("device program poisoned")
            return [{"tokens": [1], "score": 0.0}
                    for _ in range(ids.shape[0])]

    server = InferenceServer(ServeConfig(
        max_queue=8, max_batch=1, breaker_threshold=1,
        breaker_reset_s=60.0, host_fallback=True))
    server.add_model("dp", DevicePoisoned())
    try:
        out = server.submit("dp", [1, 2]).result(timeout=30)
        assert out["path"] == "host"
        files = _wait_bundles(d)
        assert len(files) == 1, files
        doc = json.load(open(os.path.join(d, files[0])))
        assert doc["reason"] == "breaker_open"
        assert doc["context"] == {"model": "dp"}
        assert any(e.get("event") == "breaker_open" for e in doc["events"])
        assert server.stats()["completed_host"] == 1
    finally:
        tfr.disable_flight_recorder()
        server.shutdown(drain=True)


def test_profiler_capture_writes_trace_and_attribution(tmp_path):
    reg = tom.MetricsRegistry()
    rec = tfr.FlightRecorder(dump_dir=str(tmp_path), registry=reg,
                             profiler_capture=True, min_interval_s=0.0)
    reg.attach_recorder(rec)
    reg.event("serving", event="slo_breach", p99_ms=5.0, slo_ms=1.0)
    t0 = time.perf_counter()
    path = rec.maybe_dump("slo_breach", p99_ms=5.0)
    assert time.perf_counter() - t0 >= 0.5
    doc = json.load(open(path))
    prof = doc["profile"]
    assert prof["captured"] is True
    assert os.path.exists(prof["trace"])
    assert prof["trace"].startswith(path + ".profile")
    trace = json.load(open(prof["trace"]))
    assert "traceEvents" in trace
    # no device lane on the CPU: the attribution tool has nothing to
    # attribute, and the bundle says so
    assert prof["attrib"] is None
    assert cbr.check_bundle(path) == []


def test_device_lanes_feed_the_attribution_tool(tmp_path):
    """A trace with kernel events (the card's) gets the device layout
    the attribution tool reads, and the tool attributes it."""
    import subprocess

    trace = str(tmp_path / "trace.json")
    evs = [{"ph": "M", "name": "process_name", "pid": 0,
            "args": {"name": "GPU 0"}},
           {"ph": "X", "cat": "cpu_op", "name": "aten::mm", "pid": 9,
            "tid": 9, "ts": 0, "dur": 50}]
    for i, name in enumerate(("gemm_kernel", "gru_seq_fwd", "memcpy")):
        evs.append({"ph": "X", "cat": "kernel", "name": name, "pid": 0,
                    "tid": 7, "ts": 10 + 30 * i, "dur": 20})
    json.dump({"traceEvents": evs}, open(trace, "w"))
    tfr._device_layout(trace)
    out = str(tmp_path / "a.json")
    r = subprocess.run([sys.executable,
                        os.path.join(REPO, "tools", "trace_attribution.py"),
                        trace, "--out", out], capture_output=True,
                       text=True, timeout=120)
    assert r.returncode == 0, r.stdout + r.stderr
    report = json.load(open(out))
    assert report["categories"]["gemm"]["n_ops"] == 1
    assert report["device_busy_us"] == 60.0


def test_profile_failure_records_not_captured(tmp_path, monkeypatch):
    import torch.profiler

    def broken(*a, **k):
        raise RuntimeError("profiler unavailable")

    monkeypatch.setattr(torch.profiler, "profile", broken)
    rec = tfr.FlightRecorder(dump_dir=str(tmp_path),
                             registry=tom.MetricsRegistry(),
                             profiler_capture=True)
    doc = json.load(open(rec.maybe_dump("x")))
    assert doc["profile"] == {"captured": False}


def test_flags_and_module_functions(tmp_path, monkeypatch):
    from paddle_tpu.core import flags as jflags

    for name in ("flight_ring_capacity", "flight_min_dump_interval_s",
                 "flight_max_bundles", "flight_profiler_capture",
                 "serve_p99_slo_ms", "serve_shed_rate_threshold",
                 "serve_shed_window_s"):
        assert tflags.get_flag(name) == jflags.get_flag(name), name
    rec = tfr.FlightRecorder(registry=tom.MetricsRegistry())
    assert rec.capacity == 4096 and rec.min_interval_s == 60.0
    assert rec.max_bundles == 8 and rec.profiler_capture is False
    monkeypatch.delenv("PADDLE_FLIGHT_DIR", raising=False)
    assert tfr.enable_from_env() is None
    monkeypatch.setenv("PADDLE_FLIGHT_DIR", str(tmp_path))
    try:
        rec = tfr.enable_from_env()
        assert tfr.get_flight_recorder() is rec
        assert tom.get_registry().recorder is rec
        tom.get_registry().event("watchdog", event="abort")
        assert tfr.maybe_dump("watchdog_abort", global_step=1)
        assert _bundles(str(tmp_path)) == ["flight-00001-watchdog_abort.json"]
    finally:
        tfr.disable_flight_recorder()
    assert tom.get_registry().recorder is None
    assert tfr.maybe_dump("x") is None


def test_dump_errors_never_raise(tmp_path):
    """An unwritable dump dir is counted, never raised: the recorder must
    not take down the subsystem that tripped it."""
    reg = tom.MetricsRegistry()
    rec = tfr.FlightRecorder(dump_dir=str(tmp_path), registry=reg)
    rec._dir.dump_dir = str(tmp_path / "not_a_dir")
    open(rec._dir.dump_dir, "w").close()
    assert rec.maybe_dump("x") is None
    assert reg.counter("flight.dump_errors").get() == 1
    assert reg.counter("flight.dumps").get(reason="x") == 1
