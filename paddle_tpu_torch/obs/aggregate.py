"""Fleet-wide snapshot aggregation + SLO burn-rate monitoring.

Everything per-process observability built so far — registry,
metricz, tracez, flight recorder — answers "how is THIS process
doing". This module is the fleet half: given the registry snapshots
of N replicas (scraped over the serving `metricz` frame), it produces
ONE fleet view, and given the router's stream of per-request
decisions it answers "is the fleet burning its SLO error budget, and
which replica is doing the burning".

Merging rules (`merge_snapshots`):

- counters: summed across replicas (they are monotonic totals);
- gauges: NOT summed — a queue-depth averaged across replicas is a
  lie — each series is kept, relabeled with `replica=<name>`;
- histograms: merged bucket-wise. The per-series le-bucket counts the
  registry snapshot carries (obs/metrics.py) are added slot by slot,
  so fleet p50/p99 (`quantile`) are computed from the MERGED
  distribution; exact count/sum/min/max merge exactly. Mismatched
  bucket boundaries across replicas are a schema conflict and raise
  `SnapshotMergeError`, as does a series name that is (say) a counter
  on one replica and a gauge on another.

`snapshot_delta` / `counter_rates` turn two consecutive merged
scrapes into the between-scrape view (counter deltas with restart
handling, histogram bucket deltas), and `FleetAggregator` keeps the
bounded scrape history an incident bundle stitches in.

`BurnRateMonitor` is the alerting half: multi-window burn-rate
alerting over the router's per-request decisions. An SLO with target
availability A has error budget (1 - A); the burn rate of a window is
(window error fraction) / (1 - A). An alert fires only when BOTH a
short window and its long companion burn faster than the pair's
threshold — the short window gives fast detection, the long window
refuses to page on a blip that already ended (see DESIGN.md). The
same two-window rule gates admitted-p99-over-SLO alerting.

The port of `paddle_tpu/obs/aggregate.py`, pure stdlib like it:
fleet aggregation runs in routers, CLIs and CI boxes with no device
runtime (and imports no torch).
"""

from __future__ import annotations

import collections
import math
import time
from typing import Optional

from paddle_tpu_torch.analysis.lock_order import named_lock

# the cross-process incident bundle schema (written by
# serving/fleet.py's FleetMonitor, rendered by tools/fleet_view.py,
# linted by tools/check_bench_record.py bundle)
INCIDENT_SCHEMA = "paddle-tpu-fleet-incident/v1"


class SnapshotMergeError(ValueError):
    """Replica snapshots disagree on a series' schema: same name,
    different metric kind or different histogram bucket boundaries.
    Merging would silently produce garbage, so it refuses instead."""


def _split_series(series: str):
    """'name{a=b,c=d}' -> ('name', (('a','b'), ('c','d')))."""
    if series.endswith("}") and "{" in series:
        fam, _, rest = series.partition("{")
        pairs = tuple(
            tuple(p.split("=", 1))
            for p in rest[:-1].split(",") if p
        )
        return fam, pairs
    return series, ()


def _with_label(series: str, key: str, value: str) -> str:
    fam, pairs = _split_series(series)
    pairs = tuple(sorted(pairs + ((key, str(value)),)))
    return fam + "{" + ",".join(f"{k}={v}" for k, v in pairs) + "}"


_KINDS = ("counters", "gauges", "histograms")


def merge_snapshots(snaps: dict) -> dict:
    """Merge `{replica_name: registry_snapshot}` into one fleet view.

    Returns `{"replicas": [...], "counters": {...}, "gauges": {...},
    "histograms": {...}}`. A replica with an empty (or missing-kind)
    snapshot contributes nothing and is legal — a freshly restarted
    process has recorded nothing yet."""
    # kind-conflict scan first: the same series name appearing under
    # two different kinds anywhere in the fleet poisons the merge
    kind_of: dict = {}
    for rep in sorted(snaps):
        snap = snaps[rep]
        if snap is None:
            continue
        if not isinstance(snap, dict):
            raise SnapshotMergeError(
                f"replica {rep!r}: snapshot is {type(snap).__name__}, "
                f"not a dict"
            )
        for kind in _KINDS:
            for name in (snap.get(kind) or {}):
                prev = kind_of.setdefault(name, (kind, rep))
                if prev[0] != kind:
                    raise SnapshotMergeError(
                        f"series {name!r} is a {prev[0][:-1]} on "
                        f"{prev[1]!r} but a {kind[:-1]} on {rep!r}"
                    )
    out = {"replicas": sorted(snaps), "counters": {}, "gauges": {},
           "histograms": {}}
    for rep in sorted(snaps):
        snap = snaps[rep] or {}
        for name, v in (snap.get("counters") or {}).items():
            out["counters"][name] = (
                out["counters"].get(name, 0.0) + float(v)
            )
        for name, v in (snap.get("gauges") or {}).items():
            out["gauges"][_with_label(name, "replica", rep)] = v
        for name, h in (snap.get("histograms") or {}).items():
            _merge_hist(out["histograms"], name, h, rep)
    return out


def _merge_hist(dst: dict, name: str, h: dict, rep: str) -> None:
    bounds = h.get("bounds")
    buckets = h.get("buckets")
    count = int(h.get("count", 0) or 0)
    hsum = float(h.get("sum", 0.0) or 0.0)
    hmin = h.get("min")
    hmax = h.get("max")
    cur = dst.get(name)
    if cur is None:
        dst[name] = {
            "count": count,
            "sum": hsum,
            "min": hmin,
            "max": hmax,
            "avg": hsum / count if count else 0.0,
            "bounds": list(bounds) if bounds is not None else None,
            "buckets": list(buckets) if buckets is not None else None,
        }
        return
    if bounds is not None and cur["bounds"] is not None \
            and list(bounds) != list(cur["bounds"]):
        raise SnapshotMergeError(
            f"histogram {name!r}: replica {rep!r} uses bucket "
            f"boundaries {list(bounds)[:4]}..., the fleet view was "
            f"built on {list(cur['bounds'])[:4]}... — mismatched "
            f"boundaries cannot merge bucket-wise"
        )
    cur["count"] += count
    cur["sum"] += hsum
    if hmin is not None:
        cur["min"] = hmin if cur["min"] is None else min(cur["min"],
                                                         hmin)
    if hmax is not None:
        cur["max"] = hmax if cur["max"] is None else max(cur["max"],
                                                         hmax)
    cur["avg"] = cur["sum"] / cur["count"] if cur["count"] else 0.0
    if buckets is not None and cur["buckets"] is not None \
            and len(buckets) == len(cur["buckets"]):
        cur["buckets"] = [a + b for a, b in zip(cur["buckets"],
                                                buckets)]
    elif buckets is not None and cur["buckets"] is None:
        cur["buckets"] = list(buckets)
        cur["bounds"] = list(bounds) if bounds is not None else None


def family_histogram(histograms: dict, family: str) -> Optional[dict]:
    """Fold every series of one histogram family (all label
    combinations — e.g. the per-model `serving.admitted_latency_s`
    series) into a single merged entry, so a fleet-wide quantile is
    quoted over ONE distribution. None when the family is absent."""
    out: dict = {}
    for name, h in (histograms or {}).items():
        if name.split("{", 1)[0] == family:
            _merge_hist(out, family, h, "<fold>")
    return out.get(family)


def family_total(counters: dict, family: str) -> float:
    """Sum of a counter family across all its label series."""
    return sum(
        float(v) for k, v in (counters or {}).items()
        if k == family or k.startswith(family + "{")
    )


def quantile(hist_entry: Optional[dict], q: float) -> Optional[float]:
    """Upper-bound estimate of the q-quantile from a (merged)
    histogram entry's le-buckets: the boundary of the bucket the
    target rank lands in. Observations in the +inf overflow bucket
    resolve to the tracked exact max. Returns None when the entry has
    no buckets or no observations."""
    if not hist_entry:
        return None
    buckets = hist_entry.get("buckets")
    bounds = hist_entry.get("bounds")
    if not buckets or bounds is None:
        return None
    total = sum(buckets)
    if total <= 0:
        return None
    rank = max(int(math.ceil(q * total)), 1)
    cum = 0
    for i, n in enumerate(buckets):
        cum += n
        if cum >= rank:
            if i < len(bounds):
                return float(bounds[i])
            break
    mx = hist_entry.get("max")
    return float(mx) if mx is not None else float(bounds[-1])


def snapshot_delta(prev: Optional[dict], cur: dict) -> dict:
    """The between-scrape view: counter and histogram deltas from the
    previous merged snapshot to the current one; gauges pass through
    as their current values (a gauge has no meaningful delta). A
    counter or histogram count that DECREASED means a replica
    restarted (its registry reset): the current value is taken as the
    whole delta rather than clamping the progress to zero."""
    prev = prev or {}
    out = {"replicas": list(cur.get("replicas") or []),
           "counters": {}, "gauges": dict(cur.get("gauges") or {}),
           "histograms": {}}
    pc = prev.get("counters") or {}
    for name, v in (cur.get("counters") or {}).items():
        p = float(pc.get(name, 0.0))
        v = float(v)
        out["counters"][name] = v - p if v >= p else v
    ph = prev.get("histograms") or {}
    for name, h in (cur.get("histograms") or {}).items():
        p = ph.get(name)
        if p is None or int(p.get("count", 0) or 0) > \
                int(h.get("count", 0) or 0):
            p = {}
        count = int(h.get("count", 0) or 0) - int(p.get("count", 0)
                                                  or 0)
        hsum = float(h.get("sum", 0.0) or 0.0) - float(
            p.get("sum", 0.0) or 0.0)
        buckets = h.get("buckets")
        pbuckets = p.get("buckets")
        if buckets is not None and pbuckets is not None \
                and len(buckets) == len(pbuckets):
            dbuckets = [max(a - b, 0)
                        for a, b in zip(buckets, pbuckets)]
        else:
            dbuckets = list(buckets) if buckets is not None else None
        out["histograms"][name] = {
            "count": count,
            "sum": max(hsum, 0.0),
            "min": h.get("min"),
            "max": h.get("max"),
            "bounds": h.get("bounds"),
            "buckets": dbuckets,
        }
    return out


def counter_rates(delta: dict, dt_s: float) -> dict:
    """Per-second rates from a `snapshot_delta` counters dict."""
    if dt_s <= 0:
        return {}
    return {name: v / dt_s
            for name, v in (delta.get("counters") or {}).items()}


class FleetAggregator:
    """Scrape-history keeper: feed each round of per-replica registry
    snapshots through `observe()`; it maintains the current merged
    view, the delta and per-second rates against the previous scrape,
    and a bounded history the incident bundle stitches in."""

    def __init__(self, history: int = 16):
        # a known lock: instrumented under the lock-order checker
        # (analysis/lock_order.py)
        self._lock = named_lock("obs.fleet_agg")
        self._history: collections.deque = collections.deque(
            maxlen=history)
        self.merged: Optional[dict] = None
        self.delta: Optional[dict] = None
        self.rates: Optional[dict] = None
        self._last_ts: Optional[float] = None

    def observe(self, snaps: dict, ts: float = None) -> dict:
        merged = merge_snapshots(snaps)
        now = time.time() if ts is None else ts
        with self._lock:
            prev, prev_ts = self.merged, self._last_ts
            self.merged, self._last_ts = merged, now
            self.delta = (snapshot_delta(prev, merged)
                          if prev is not None else None)
            dt = (now - prev_ts) if prev_ts is not None else 0.0
            self.rates = (counter_rates(self.delta, dt)
                          if self.delta is not None else None)
            self._history.append(
                {"ts": round(now, 6), "merged": merged,
                 "delta": self.delta}
            )
        return merged

    def history(self) -> list:
        with self._lock:
            return list(self._history)


class BurnRateMonitor:
    """Multi-window SLO burn-rate alerting over per-request decisions.

    `record(ok, latency_s=, replica=)` logs one routing decision
    (admitted success vs shed/failure); `evaluate()` returns the
    currently-active alerts and, on each activation edge, bumps the
    `fleet.alerts` counter and emits a `kind="alert"` event — so an
    alert that stays active across 100 poll rounds is counted ONCE.

    `windows` is a tuple of `(short_s, long_s, burn_threshold)`
    pairs. For each pair, an availability alert requires the burn
    rate (error fraction / error budget) to exceed the threshold in
    BOTH windows; with `p99_slo_ms > 0`, a latency alert requires the
    admitted p99 to exceed the SLO in both windows. Each alert names
    the replica contributing the most errors (availability) or the
    most over-SLO requests (latency) in the short window — the
    "which replica and why" half of the fleet question."""

    def __init__(self, availability_target: float = 0.999,
                 p99_slo_ms: float = 0.0,
                 windows=((60.0, 300.0, 14.4), (300.0, 1800.0, 6.0)),
                 min_decisions: int = 20, max_events: int = 65536,
                 registry=None):
        from paddle_tpu_torch.obs import metrics as _metrics

        self.error_budget = max(1.0 - float(availability_target),
                                1e-9)
        self.availability_target = float(availability_target)
        self.p99_slo_ms = float(p99_slo_ms or 0.0)
        self.windows = tuple(tuple(w) for w in windows)
        self.min_decisions = int(min_decisions)
        self._reg = registry or _metrics.get_registry()
        # (ts_mono, ok, latency_s or None, replica or None)
        self._events: collections.deque = collections.deque(
            maxlen=max_events)
        # a known lock
        self._lock = named_lock("obs.burn_monitor")
        self._active: set = set()
        self.alerts_total = 0

    def record(self, ok: bool, latency_s: float = None,
               replica: str = None, now: float = None) -> None:
        t = time.monotonic() if now is None else now
        with self._lock:
            self._events.append((t, bool(ok), latency_s, replica))

    def _window(self, now: float, span_s: float) -> list:
        lo = now - span_s
        return [e for e in self._events if e[0] >= lo]

    @staticmethod
    def _p99_ms(events: list) -> Optional[float]:
        lats = sorted(e[2] for e in events
                      if e[1] and e[2] is not None)
        if not lats:
            return None
        return lats[int(0.99 * (len(lats) - 1))] * 1e3

    def evaluate(self, now: float = None) -> list:
        t = time.monotonic() if now is None else now
        with self._lock:
            events = list(self._events)
        alerts = []
        fired = set()
        for short_s, long_s, threshold in self.windows:
            short = [e for e in events if e[0] >= t - short_s]
            long_ = [e for e in events if e[0] >= t - long_s]
            if len(short) < self.min_decisions \
                    or len(long_) < self.min_decisions:
                continue
            burns = []
            for win in (short, long_):
                err = sum(1 for e in win if not e[1])
                burns.append((err / len(win)) / self.error_budget)
            if all(b > threshold for b in burns):
                key = ("availability_burn", short_s, long_s)
                fired.add(key)
                errs = collections.Counter(
                    e[3] for e in short if not e[1] and e[3]
                )
                alerts.append({
                    "alert": "availability_burn",
                    "short_window_s": short_s,
                    "long_window_s": long_s,
                    "burn_threshold": threshold,
                    "burn_short": round(burns[0], 3),
                    "burn_long": round(burns[1], 3),
                    "availability_target": self.availability_target,
                    "replica": (errs.most_common(1)[0][0]
                                if errs else None),
                })
            if self.p99_slo_ms > 0:
                p99s = [self._p99_ms(short), self._p99_ms(long_)]
                if all(p is not None and p > self.p99_slo_ms
                       for p in p99s):
                    key = ("p99_slo", short_s, long_s)
                    fired.add(key)
                    slo_s = self.p99_slo_ms / 1e3
                    over = collections.Counter(
                        e[3] for e in short
                        if e[1] and e[2] is not None
                        and e[2] > slo_s and e[3]
                    )
                    alerts.append({
                        "alert": "p99_slo",
                        "short_window_s": short_s,
                        "long_window_s": long_s,
                        "p99_slo_ms": self.p99_slo_ms,
                        "p99_short_ms": round(p99s[0], 3),
                        "p99_long_ms": round(p99s[1], 3),
                        "replica": (over.most_common(1)[0][0]
                                    if over else None),
                    })
        with self._lock:
            new = fired - self._active
            self._active = fired
        for key in sorted(new, key=str):
            # rising edge only: a sustained alert is one activation,
            # not one count per poll round
            self.alerts_total += 1
            self._reg.counter("fleet.alerts").inc(alert=key[0])
            a = next(x for x in alerts
                     if (x["alert"], x["short_window_s"],
                         x["long_window_s"]) == key)
            self._reg.event("alert", **a)
        return alerts

    def state(self, now: float = None) -> dict:
        """Point-in-time monitor view for `states()`/fleetz: per
        window pair, decision count, availability and admitted p99."""
        t = time.monotonic() if now is None else now
        with self._lock:
            events = list(self._events)
        out = []
        for short_s, long_s, threshold in self.windows:
            win = [e for e in events if e[0] >= t - short_s]
            n = len(win)
            err = sum(1 for e in win if not e[1])
            p99 = self._p99_ms(win)
            out.append({
                "window_s": short_s,
                "decisions": n,
                "availability": round(1.0 - err / n, 6) if n else None,
                "p99_ms": round(p99, 3) if p99 is not None else None,
            })
        return {"windows": out, "alerts_total": self.alerts_total,
                "active": sorted(k[0] for k in self._active)}


def offending_replica(alerts: list) -> Optional[str]:
    """The replica the active alerts most implicate (majority vote
    over each alert's own attribution)."""
    votes = collections.Counter(
        a.get("replica") for a in alerts if a.get("replica")
    )
    return votes.most_common(1)[0][0] if votes else None
