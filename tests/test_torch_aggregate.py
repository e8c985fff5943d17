"""The port's fleet aggregation (`paddle_tpu_torch/obs/aggregate.py`)
against the JAX package's, on the CPU: every function and class on the
same inputs, outputs equal exactly.

The inputs are registry snapshots the two packages' registries build
from the same seeded observations (counters, labelled gauges, bucketed
histograms), so the snapshot format itself is held too.
"""

import numpy as np
import pytest

from paddle_tpu.obs import aggregate as jagg
from paddle_tpu.obs import metrics as jom
from paddle_tpu_torch.obs import aggregate as tagg
from paddle_tpu_torch.obs import metrics as tom

BUCKETS = (0.001, 0.005, 0.01, 0.05, 0.1, 0.5)


def _snapshot(om, seed, replica, n=60, buckets=BUCKETS):
    rng = np.random.default_rng(seed)
    reg = om.MetricsRegistry()
    reg.counter("serving.admitted").inc(int(rng.integers(10, 100)),
                                        model="m")
    reg.counter("serving.shed").inc(int(rng.integers(0, 10)),
                                    reason="overloaded")
    reg.counter("serving.batches").inc(int(rng.integers(1, 20)))
    reg.gauge("serving.queue_depth").set(float(rng.integers(0, 30)))
    reg.gauge("serving.queue_depth_hwm").set(float(rng.integers(30, 64)),
                                             model="m")
    h = reg.histogram("serving.admitted_latency_s", buckets=buckets)
    for v in rng.exponential(0.02, n):
        h.observe(float(v), model="m")
    h2 = reg.histogram("serving.admitted_latency_s", buckets=buckets)
    for v in rng.exponential(0.2, n // 3):
        h2.observe(float(v), model="other")
    return reg.snapshot()


def _snaps(om, seeds=(1, 2, 3)):
    return {f"r{i}": _snapshot(om, s, f"r{i}") for i, s in enumerate(seeds)}


def test_registry_snapshots_equal():
    assert _snaps(tom) == _snaps(jom)


@pytest.mark.parametrize("seeds", [(1, 2, 3), (4,), (5, 6)])
def test_merge_snapshots(seeds):
    got = tagg.merge_snapshots(_snaps(tom, seeds))
    want = jagg.merge_snapshots(_snaps(jom, seeds))
    assert got == want
    assert "serving.admitted_latency_s{model=m}" in str(got["histograms"])


def test_merge_empty_replica_and_refusals():
    snaps = _snaps(tom)
    snaps["empty"] = {}
    jsnaps = _snaps(jom)
    jsnaps["empty"] = {}
    assert tagg.merge_snapshots(snaps) == jagg.merge_snapshots(jsnaps)
    # a kind conflict and mismatched bucket bounds refuse in both
    for agg, om in ((tagg, tom), (jagg, jom)):
        a = om.MetricsRegistry()
        a.counter("x").inc(1)
        b = om.MetricsRegistry()
        b.gauge("x").set(1)
        with pytest.raises(agg.SnapshotMergeError):
            agg.merge_snapshots({"a": a.snapshot(), "b": b.snapshot()})
        c = _snapshot(om, 1, "c", buckets=(0.1, 1.0))
        d = _snapshot(om, 1, "d", buckets=(0.2, 1.0))
        with pytest.raises(agg.SnapshotMergeError):
            agg.merge_snapshots({"c": c, "d": d})


@pytest.mark.parametrize("q", [0.0, 0.5, 0.9, 0.99, 1.0])
def test_quantile_and_family_helpers(q):
    got = tagg.merge_snapshots(_snaps(tom))
    want = jagg.merge_snapshots(_snaps(jom))
    th = tagg.family_histogram(got["histograms"],
                               "serving.admitted_latency_s")
    jh = jagg.family_histogram(want["histograms"],
                               "serving.admitted_latency_s")
    assert th == jh
    assert tagg.quantile(th, q) == jagg.quantile(jh, q)
    for name, entry in got["histograms"].items():
        assert tagg.quantile(entry, q) == jagg.quantile(
            want["histograms"][name], q)
    assert tagg.family_total(got["counters"], "serving.admitted") == \
        jagg.family_total(want["counters"], "serving.admitted")
    assert tagg.quantile(None, q) is None and jagg.quantile(None, q) is None


def test_snapshot_delta_and_rates():
    prev_t = tagg.merge_snapshots(_snaps(tom, (1, 2)))
    prev_j = jagg.merge_snapshots(_snaps(jom, (1, 2)))
    # the second scrape: more traffic, and r1 restarted (counters reset)
    cur_t = tagg.merge_snapshots(_snaps(tom, (7, 3)))
    cur_j = jagg.merge_snapshots(_snaps(jom, (7, 3)))
    dt, dj = tagg.snapshot_delta(prev_t, cur_t), jagg.snapshot_delta(
        prev_j, cur_j)
    assert dt == dj
    assert tagg.snapshot_delta(None, cur_t) == jagg.snapshot_delta(
        None, cur_j)
    for interval in (0.5, 2.0, 0.0):
        assert tagg.counter_rates(dt, interval) == jagg.counter_rates(
            dj, interval)


def test_fleet_aggregator():
    ta, ja = tagg.FleetAggregator(history=3), jagg.FleetAggregator(
        history=3)
    for k, seeds in enumerate(((1, 2), (3, 4), (5, 6), (7, 8))):
        ts = 100.0 + k
        got = ta.observe(_snaps(tom, seeds), ts=ts)
        want = ja.observe(_snaps(jom, seeds), ts=ts)
        assert got == want
        assert ta.merged == ja.merged
        assert ta.delta == ja.delta and ta.rates == ja.rates
    assert ta.history() == ja.history()
    assert len(ta.history()) == 3


def _decisions(seed, n=400):
    rng = np.random.default_rng(seed)
    out = []
    for i in range(n):
        bad = rng.random() < (0.5 if i > n // 2 else 0.01)
        rep = "slow" if rng.random() < 0.4 else "fast"
        lat = None if bad else float(
            rng.exponential(0.2 if rep == "slow" else 0.002))
        out.append((not bad, lat, rep, 60.0 + i * 0.2))
    return out


@pytest.mark.parametrize("seed", [0, 1, 2])
@pytest.mark.parametrize("slo", [0.0, 20.0])
def test_burn_rate_monitor(seed, slo):
    kw = dict(availability_target=0.9, p99_slo_ms=slo,
              windows=((10.0, 50.0, 2.0), (20.0, 80.0, 1.5)),
              min_decisions=10)
    tm = tagg.BurnRateMonitor(registry=tom.MetricsRegistry(), **kw)
    jm = jagg.BurnRateMonitor(registry=jom.MetricsRegistry(), **kw)
    for ok, lat, rep, now in _decisions(seed):
        tm.record(ok, latency_s=lat, replica=rep, now=now)
        jm.record(ok, latency_s=lat, replica=rep, now=now)
        if int(now * 5) % 25 == 0:
            assert tm.evaluate(now=now) == jm.evaluate(now=now)
    end = 60.0 + 400 * 0.2
    got, want = tm.evaluate(now=end), jm.evaluate(now=end)
    assert got == want
    assert tm.alerts_total == jm.alerts_total
    assert tm.state(now=end) == jm.state(now=end)
    assert tm._reg.snapshot() == jm._reg.snapshot()
    assert tagg.offending_replica(got) == jagg.offending_replica(want)


def test_offending_replica_and_schema():
    alerts = [{"alert": "a", "replica": "x"},
              {"alert": "b", "replica": "x"},
              {"alert": "c", "replica": "y"}]
    assert tagg.offending_replica(alerts) == jagg.offending_replica(
        alerts) == "x"
    assert tagg.offending_replica([{"alert": "a", "replica": None}]) is None
    assert tagg.offending_replica([]) == jagg.offending_replica([])
    assert tagg.INCIDENT_SCHEMA == jagg.INCIDENT_SCHEMA
