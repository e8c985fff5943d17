"""Fleet tier: a replica router with spill-before-shed, breaker-gated
rotation, telemetry-driven balancing, and zero-downtime rollout.

Topology: `FleetRouter` fronts N independent replica processes, each
a full `InferenceServer` behind a `ServingTCPServer` socket. The
router holds, per replica:

- a `_Breaker` (the same class the server uses per model) tracking
  *transport* health: refused connects, resets, torn frames. A dead
  replica opens its breaker and is rotated out of candidate order;
  after `breaker_reset_s` the telemetry poller wins the half-open
  probe (`try_probe`) and a successful `metricz` scrape closes it —
  the replica rejoins rotation without any routed request having
  been gambled on it.
- a telemetry snapshot (queue depth, shed counts) scraped from the
  replica's own `metricz` endpoint by a background poller. Routing
  cost = replica queue depth + requests this router currently has in
  flight there, so a loaded or wedged replica naturally sinks in the
  candidate order even before its breaker trips.
- a client pool (one lazy TCP connection per concurrent caller).

Spill-before-shed: a request is tried on the best candidate first;
an `overloaded` response or a transport error moves it to the next
sibling instead of surfacing the shed. Only when every admitting
replica has refused does the router return `overloaded` — the fleet
sheds as a last resort, one replica shedding is just a routing hint.
A transport error mid-call additionally records a breaker failure,
so a SIGKILLed replica both loses the request to a sibling (zero
admitted requests lost) and starts accumulating toward rotation.

Rollout (`rollout(model, tag)`): replicas are swapped one at a time.
The router marks the replica draining (new requests flow to
siblings — no refused window for a polling client), waits for its
own in-flight count there to reach zero, sends the
`{"admin": "swap_model"}` frame (the server's swap is atomic behind
the admission queue; its queued requests dispatch on the new model),
then returns the replica to rotation. Zero admitted requests are
lost at either layer.

Trace propagation: every routed call runs under a `fleet.route` span,
so the client-side span, the router hop (with the chosen replica and
spill count as labels), and the replica's `serve.request` tree share
one trace_id.

Observability: the poller also feeds a `FleetMonitor` —
replica snapshots merged into one fleet view (`obs/aggregate`), a
multi-window SLO burn-rate monitor over the router's own routing
outcomes, and, on alert activation, a cross-process incident bundle:
every replica's flight ring gathered over the `flightz` frame,
stitched with the router's ring, the merged fleet view and the
per-replica breaker states into one rate-limited
`paddle-tpu-fleet-incident/v1` document (`tools/fleet_view.py` reads
it back as cross-process critical paths).

The port of `paddle_tpu/serving/fleet.py`: a router process needs no
card, and the replicas it fronts are the port's `ServingTCPServer`s
(`testing_faults.SERVING_REPLICA_SRC` starts them).
"""

from __future__ import annotations

import os
import threading
import time
from dataclasses import dataclass

from paddle_tpu_torch.core import flags as _flags
from paddle_tpu_torch.obs import aggregate as _agg
from paddle_tpu_torch.obs import flight_recorder as _flight
from paddle_tpu_torch.obs import metrics as _obs
from paddle_tpu_torch.obs import tracing as _tracing
from paddle_tpu_torch.serving.server import _Breaker
from paddle_tpu_torch.serving.tcp import ServeClient


@dataclass
class FleetConfig:
    breaker_threshold: int = 3      # consecutive transport failures
    breaker_reset_s: float = 0.5    # quarantine before half-open
    poll_interval_s: float = 0.1    # metricz scrape cadence
    connect_timeout_s: float = 2.0
    request_timeout_s: float = 30.0
    scrape_timeout_s: float = 1.0
    max_spills: int = None          # extra replicas tried; None = all
    client_retries: int = 2         # per-connect retry (ServeClient)
    # ---- fleet observability -----------------------------------
    monitor: bool = True            # run the SLO burn-rate monitor
    # None on any of these = resolved from the matching fleet_* /
    # serve_* flag at router construction
    availability_target: float = None
    slo_p99_ms: float = None        # 0 disables the p99 alert
    burn_windows: tuple = None      # ((short_s, long_s, threshold),..)
    burn_min_decisions: int = None
    incident_dir: str = None        # None = in-memory only
    incident_min_interval_s: float = None
    incident_max_bundles: int = None
    # scrape failures feeding rotation: after this many CONSECUTIVE
    # failed metricz scrapes the replica's stale telemetry is
    # discarded and its cost poisoned (None = breaker_threshold)
    scrape_breaker_failures: int = None


class ReplicaHandle:
    """Router-side state for one replica. The breaker and the client
    pool survive `set_address` (a replica restart keeps its history:
    the new process must pass the half-open probe to rejoin)."""

    def __init__(self, name: str, addr: str, cfg: FleetConfig):
        self.name = name
        self.addr = addr
        self.cfg = cfg
        self.breaker = _Breaker(cfg.breaker_threshold,
                                cfg.breaker_reset_s, model=name)
        self.draining = False
        self.telemetry: dict = {}
        self.metricz: dict = {}     # last full registry snapshot
        self.scrape_failures = 0    # CONSECUTIVE failed scrapes
        self.stale = False          # telemetry discarded as unusable
        self.inflight = 0
        self._lock = threading.Lock()
        self._pool: list = []

    def _new_client(self) -> ServeClient:
        return ServeClient(self.addr,
                           connect_timeout=self.cfg.connect_timeout_s,
                           retries=self.cfg.client_retries)

    def checkout(self) -> ServeClient:
        with self._lock:
            if self._pool:
                return self._pool.pop()
        return self._new_client()

    def checkin(self, client: ServeClient):
        with self._lock:
            self._pool.append(client)

    def discard(self, client: ServeClient):
        try:
            client.close()
        except Exception:
            pass

    def set_address(self, addr: str):
        """Point at a restarted replica. Pooled connections to the old
        process are dropped; breaker state is kept so the newcomer
        goes through probe-back-in rather than instantly absorbing
        live traffic."""
        with self._lock:
            self.addr = addr
            stale, self._pool = self._pool, []
        for c in stale:
            self.discard(c)

    def cost(self) -> float:
        """Routing cost: the replica's own reported queue depth plus
        what this router already has in flight there. A replica whose
        telemetry went stale (consecutive scrape failures) is
        poisoned to the back of the candidate order — unknown health
        must not masquerade as an empty queue."""
        depth = 0
        tel = self.telemetry
        if isinstance(tel, dict):
            depth = tel.get("queue_depth", 0) or 0
        penalty = 1e6 if self.stale else 0.0
        return float(depth) + float(self.inflight) + penalty

    def close(self):
        with self._lock:
            stale, self._pool = self._pool, []
        for c in stale:
            self.discard(c)


@dataclass
class RolloutReport:
    """Structured evidence for a rollout: per-phase events went into
    the stream as they happened; this is the caller-facing summary.
    Mapping-style access (`report["r0"]`, `.values()`, `.items()`)
    reads the per-replica swap responses, so callers written against
    the old plain-dict return keep working."""

    model: str
    tag: str
    ok: bool
    duration_s: float
    results: dict       # replica -> swap response
    phases: list        # [{"phase","replica","t_s",...}, ...]
    per_replica: dict   # replica -> {"drain_s","swap_s","total_s"}

    def values(self):
        return self.results.values()

    def items(self):
        return self.results.items()

    def keys(self):
        return self.results.keys()

    def __getitem__(self, name):
        return self.results[name]

    def __contains__(self, name):
        return name in self.results

    def __len__(self):
        return len(self.results)


class FleetMonitor:
    """The fleet half of the observability plane: owns the
    snapshot aggregator (merged fleet view + scrape history), the SLO
    burn-rate monitor fed by the router's per-request decisions, and
    the incident-bundle writer. Runs entirely on the router's poller
    thread via `on_round()`; `record()` is the only hot-path call.

    When a burn-rate alert activates, `on_round` assembles a
    cross-process incident bundle: a `flightz` ring dump from every
    reachable replica, the router's own flight ring, the merged fleet
    view + scrape history, the active alerts and the per-replica
    router states — one `paddle-tpu-fleet-incident/v1` JSON document,
    rate-limited and dir-bounded by the same BoundedBundleDir
    discipline as flight bundles."""

    def __init__(self, config: FleetConfig, registry=None):
        self.config = config
        self._reg = registry or _obs.get_registry()
        target = (config.availability_target
                  if config.availability_target is not None
                  else _flags.get_flag("fleet_availability_target"))
        slo = (config.slo_p99_ms if config.slo_p99_ms is not None
               else _flags.get_flag("serve_p99_slo_ms"))
        windows = config.burn_windows
        if windows is None:
            fast = float(_flags.get_flag("fleet_burn_fast_window_s"))
            slow = float(_flags.get_flag("fleet_burn_slow_window_s"))
            windows = (
                (fast, fast * 5.0,
                 float(_flags.get_flag("fleet_burn_fast_threshold"))),
                (slow, slow * 6.0,
                 float(_flags.get_flag("fleet_burn_slow_threshold"))),
            )
        min_dec = (config.burn_min_decisions
                   if config.burn_min_decisions is not None
                   else _flags.get_flag("fleet_burn_min_decisions"))
        self.aggregator = _agg.FleetAggregator()
        self.burn = _agg.BurnRateMonitor(
            availability_target=target, p99_slo_ms=slo,
            windows=windows, min_decisions=min_dec,
            registry=self._reg,
        )
        self._dir = _flight.BoundedBundleDir(
            config.incident_dir,
            prefix="incident-",
            max_bundles=int(
                config.incident_max_bundles
                if config.incident_max_bundles is not None
                else _flags.get_flag("fleet_incident_max_bundles")
            ),
            min_interval_s=float(
                config.incident_min_interval_s
                if config.incident_min_interval_s is not None
                else _flags.get_flag("fleet_incident_min_interval_s")
            ),
            lock_name="obs.incident_dir",
        )
        self.alerts: list = []
        self.last_incident: dict = None
        self.last_incident_path: str = None

    def record(self, ok: bool, latency_s: float = None,
               replica: str = None) -> None:
        self.burn.record(ok, latency_s=latency_s, replica=replica)

    def on_round(self, router: "FleetRouter") -> None:
        """One monitor round, after the poller scraped every replica:
        merge the fresh snapshots, evaluate the burn windows, and on
        active alerts (rate-limited) write an incident bundle."""
        snaps = {
            name: h.metricz
            for name, h in router._handles.items() if h.metricz
        }
        if snaps:
            self.aggregator.observe(snaps)
        self.alerts = self.burn.evaluate()
        if self.alerts:
            self._maybe_incident(router, self.alerts)

    def _maybe_incident(self, router, alerts) -> str:
        seq = self._dir.try_begin()
        if seq is None:
            self._reg.counter("fleet.incidents_suppressed").inc()
            return None
        try:
            return self._incident(router, alerts, seq)
        except Exception:
            # an unwritable incident dir / dead replica mid-gather
            # must not take down the poller that noticed the problem
            self._reg.counter("fleet.incident_errors").inc()
            return None

    def _incident(self, router, alerts, seq) -> str:
        self._reg.counter("fleet.incidents").inc()
        # cross-process gather: every replica's flight ring over the
        # flightz frame (answered outside the admission queue — an
        # overloaded replica is exactly the one whose ring we need)
        rings = {}
        for name, h in router._handles.items():
            client = h.checkout()
            try:
                resp = client.flightz(
                    timeout=router.config.scrape_timeout_s)
                rings[name] = (resp.get("flightz", {})
                               if isinstance(resp, dict) else {})
                h.checkin(client)
            except Exception as e:
                h.discard(client)
                rings[name] = {"ok": False,
                               "error": f"{type(e).__name__}: {e}"}
        rec = _flight.get_flight_recorder()
        offending = _agg.offending_replica(alerts)
        bundle = {
            "schema": _agg.INCIDENT_SCHEMA,
            "reason": "burn_rate",
            "ts": round(time.time(), 6),
            "pid": os.getpid(),
            "seq": seq,
            "alerts": alerts,
            "offending": offending,
            "states": router.states(),
            "fleet": {
                "merged": self.aggregator.merged,
                "delta": self.aggregator.delta,
                "rates": self.aggregator.rates,
            },
            "history": self.aggregator.history()[-8:],
            "replicas": rings,
            "events": rec.snapshot() if rec is not None else [],
        }
        path = self._dir.write(seq, "burn_rate", bundle)
        self.last_incident = bundle
        self.last_incident_path = path
        self._reg.event("incident", reason="burn_rate",
                        offending=offending, path=path,
                        alerts=len(alerts))
        return path

    def state(self) -> dict:
        """Monitor view for `fleetz` / tests: burn windows, active
        alerts, incident accounting."""
        return {
            "burn": self.burn.state(),
            "alerts": self.alerts,
            "incident_dir": self._dir.dump_dir,
            "last_incident_path": self.last_incident_path,
        }


class FleetRouter:
    """Route requests across replicas; see the module docstring for
    the full contract. `replicas` maps name -> "host:port"."""

    def __init__(self, replicas: dict, config: FleetConfig = None):
        self.config = config or FleetConfig()
        self._handles = {
            name: ReplicaHandle(name, addr, self.config)
            for name, addr in replicas.items()
        }
        self.monitor = (FleetMonitor(self.config)
                        if self.config.monitor else None)
        self._rr = 0
        self._lock = threading.Lock()
        self._stopped = False
        self._poller = threading.Thread(
            target=self._poll_loop, name="fleet-poll", daemon=True
        )
        self._poller.start()

    # ------------------------------------------------------- telemetry
    def _poll_loop(self):
        while not self._stopped:
            for h in list(self._handles.values()):
                if self._stopped:
                    return
                self._scrape(h)
            if self.monitor is not None and not self._stopped:
                try:
                    self.monitor.on_round(self)
                except Exception:
                    # the monitor must never kill telemetry polling
                    _obs.get_registry().counter(
                        "fleet.monitor_errors").inc()
            time.sleep(self.config.poll_interval_s)

    def _scrape(self, h: ReplicaHandle):
        """One metricz scrape. Doubles as the half-open liveness
        probe: for a non-closed breaker the poller must win
        `try_probe()` first, so rotation-in is decided by a cheap
        scrape, never by gambling a routed request on a replica that
        just died."""
        if h.breaker.state != "closed" and not h.breaker.try_probe():
            return
        client = h.checkout()
        try:
            resp = client.metricz(timeout=self.config.scrape_timeout_s)
            stats = resp.get("stats", {}) if isinstance(resp, dict) else {}
            h.telemetry = stats
            h.metricz = (resp.get("metricz", {})
                         if isinstance(resp, dict) else {})
            h.scrape_failures = 0
            h.stale = False
            was_open = h.breaker.state != "closed"
            h.breaker.record(True)
            if was_open:
                _obs.get_registry().counter(
                    "fleet.rejoins").inc(replica=h.name)
            h.checkin(client)
        except Exception:
            # a failed scrape is NOT silent: it is counted, it charges
            # the same breaker that transport failures charge (so N
            # consecutive failures rotate the replica out), and past
            # the threshold the stale telemetry is discarded — a
            # replica we cannot see must not keep looking cheap on its
            # last known queue depth
            h.discard(client)
            h.breaker.record(False)
            h.scrape_failures += 1
            _obs.get_registry().counter("fleet.scrape_errors").inc(
                replica=h.name)
            limit = self.config.scrape_breaker_failures
            if limit is None:
                limit = self.config.breaker_threshold
            if h.scrape_failures >= limit:
                h.telemetry = {}
                h.metricz = {}
                h.stale = True

    # --------------------------------------------------------- routing
    def _candidates(self) -> list:
        """Admitting, non-draining replicas, cheapest first; round-
        robin rotation breaks ties so equal-cost replicas share load
        instead of the dict-order replica taking everything."""
        with self._lock:
            self._rr += 1
            rr = self._rr
        handles = list(self._handles.values())
        n = len(handles)
        rotated = handles[rr % n:] + handles[: rr % n] if n else []
        live = [h for h in rotated
                if not h.draining and h.breaker.admits()]
        return sorted(live, key=lambda h: h.cost())

    def call(self, model: str, ids, deadline_ms: int = None,
             hooks: str = None, timeout: float = None,
             trace=None) -> dict:
        """Route one request. Returns the replica's response dict; a
        fleet-level shed ({"ok": False, "error": "overloaded"}) only
        after every admitting replica refused or failed."""
        t0 = time.monotonic()
        with _tracing.span("fleet.route", model=model) as sp:
            resp = self._route(model, ids, deadline_ms, hooks,
                               timeout, trace, sp)
            if isinstance(resp, dict) and not resp.get("ok", False):
                sp.status = resp.get("error", "error")
        lat = time.monotonic() - t0
        ok = isinstance(resp, dict) and bool(resp.get("ok", False))
        replica = sp.labels.get("replica") or sp.labels.get("shed_by")
        if ok:
            # the router's OWN end-to-end timing of admitted requests
            # — the independent cross-check the bench row compares
            # against the fleet p99 merged from replica histograms
            _obs.get_registry().histogram(
                "fleet.request_latency_s").observe(lat, model=model)
        if self.monitor is not None:
            self.monitor.record(ok, latency_s=lat if ok else None,
                                replica=replica)
        return resp

    def _route(self, model, ids, deadline_ms, hooks, timeout,
               trace, sp) -> dict:
        reg = _obs.get_registry()
        cands = self._candidates()
        limit = len(cands) if self.config.max_spills is None \
            else min(len(cands), self.config.max_spills + 1)
        last_shed = None
        last_blame = None
        spills = 0
        for h in cands[:limit]:
            # half-open: only one probe request at a time may test a
            # recovering replica; everyone else spills past it
            if h.breaker.state != "closed" and not h.breaker.try_probe():
                continue
            with h._lock:
                h.inflight += 1
            client = h.checkout()
            try:
                resp = client.call(
                    model, ids, deadline_ms=deadline_ms, hooks=hooks,
                    timeout=timeout or self.config.request_timeout_s,
                    trace=trace,
                )
            except Exception:
                # transport death (SIGKILL, reset, torn frame): the
                # request was NOT acknowledged — retry it on a sibling
                # and charge the breaker
                h.discard(client)
                h.breaker.record(False)
                reg.counter("fleet.transport_errors").inc(
                    replica=h.name)
                last_blame = h.name
                spills += 1
                continue
            finally:
                with h._lock:
                    h.inflight -= 1
            h.checkin(client)
            if isinstance(resp, dict) and not resp.get("ok", False) \
                    and resp.get("error") in ("overloaded",
                                              "shutting_down"):
                # replica-level shed = fleet-level routing hint
                h.breaker.record(True)  # alive, just busy
                reg.counter("fleet.spills").inc(replica=h.name)
                last_shed = resp
                last_blame = h.name
                spills += 1
                continue
            h.breaker.record(True)
            reg.counter("fleet.routed").inc(replica=h.name)
            sp.labels["replica"] = h.name
            sp.labels["spills"] = spills
            return resp
        reg.counter("fleet.shed").inc()
        if last_blame is not None:
            # shed attribution for the burn monitor: the last replica
            # that refused or failed is the best available blame
            sp.labels["shed_by"] = last_blame
        if last_shed is not None:
            return dict(last_shed, fleet_spills=spills)
        return {"ok": False, "error": "overloaded",
                "detail": "no admitting replica", "fleet_spills": spills}

    # --------------------------------------------------------- rollout
    def rollout(self, model: str, tag: str = None,
                drain_timeout_s: float = 10.0) -> RolloutReport:
        """Zero-downtime hot swap of `model` across the fleet, one
        replica at a time. Returns a RolloutReport (mapping-style
        access reads the per-replica swap responses). Raises
        RuntimeError if any replica's swap fails — the fleet is then
        mixed-version and the caller must retry or roll back.

        Every phase — drain begin/end, swap, undrain — is emitted
        into the event stream / flight ring as it happens, so the
        zero-downtime claim is evidenced per replica with durations,
        not asserted after the fact."""
        reg = _obs.get_registry()
        results = {}
        phases = []
        per_replica = {}
        t_start = time.monotonic()

        def emit(phase, replica, **extra):
            ev = {"phase": phase, "replica": replica, "model": model,
                  "t_s": round(time.monotonic() - t_start, 6), **extra}
            phases.append(ev)
            reg.event("rollout", **ev)

        for h in list(self._handles.values()):
            t_rep = time.monotonic()
            h.draining = True  # siblings absorb; no refused window
            emit("drain_begin", h.name)
            try:
                deadline = time.monotonic() + drain_timeout_s
                while time.monotonic() < deadline:
                    with h._lock:
                        if h.inflight == 0:
                            break
                    time.sleep(0.005)
                drain_s = time.monotonic() - t_rep
                emit("drain_end", h.name, dur_s=round(drain_s, 6))
                t_swap = time.monotonic()
                client = h.checkout()
                try:
                    msg = {"admin": "swap_model", "model": model}
                    if tag is not None:
                        msg["tag"] = tag
                    resp = client._roundtrip(
                        msg, timeout=self.config.request_timeout_s)
                except Exception as e:
                    h.discard(client)
                    emit("swap_failed", h.name,
                         error=f"{type(e).__name__}: {e}")
                    raise RuntimeError(
                        f"rollout: swap on {h.name} died: {e}") from e
                h.checkin(client)
                results[h.name] = resp
                swap_s = time.monotonic() - t_swap
                if not (isinstance(resp, dict) and resp.get("ok")):
                    emit("swap_failed", h.name,
                         error=str(resp.get("error")
                                   if isinstance(resp, dict) else resp))
                    raise RuntimeError(
                        f"rollout: swap on {h.name} refused: {resp}")
                emit("swap", h.name, dur_s=round(swap_s, 6), tag=tag)
                _obs.get_registry().counter("fleet.rollouts").inc(
                    replica=h.name, model=model)
                per_replica[h.name] = {
                    "drain_s": round(drain_s, 6),
                    "swap_s": round(swap_s, 6),
                    "total_s": round(time.monotonic() - t_rep, 6),
                }
            finally:
                h.draining = False
                emit("undrain", h.name)
        return RolloutReport(
            model=model, tag=tag, ok=True,
            duration_s=round(time.monotonic() - t_start, 6),
            results=results, phases=phases, per_replica=per_replica,
        )

    # ----------------------------------------------------- maintenance
    def set_address(self, name: str, addr: str):
        """Re-point a replica after a restart (keeps breaker state —
        the new process rejoins via the half-open probe)."""
        self._handles[name].set_address(addr)

    def handle(self, name: str) -> ReplicaHandle:
        return self._handles[name]

    def states(self) -> dict:
        """Per-replica router view (breaker state, cost, draining) —
        the fleet-level `metricz` complement."""
        return {
            name: {
                "addr": h.addr,
                "breaker": h.breaker.state,
                "draining": h.draining,
                "inflight": h.inflight,
                "queue_depth": (h.telemetry or {}).get("queue_depth"),
                "cost": h.cost(),
                "scrape_failures": h.scrape_failures,
                "stale": h.stale,
            }
            for name, h in self._handles.items()
        }

    def close(self):
        self._stopped = True
        self._poller.join(2.0)
        for h in self._handles.values():
            h.close()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()
