"""Training watchdog: divergence detection, rollback, preemption — the
JAX package's `trainer/watchdog.py` on the port.

The reference's Go master/pserver tier made training survive *process*
death (lease requeue go/master/service.go:313, snapshot recovery
service.go:166-207); rounds 7-8 rebuilt that for SIGKILL and torn
checkpoints. This module covers the failures that do NOT kill the
process:

- a NaN/Inf loss or gradient (bad data, fp overflow) that would
  silently poison the parameters,
- a loss spike that destroys hours of progress while every health
  check stays green,
- a preemption (SIGTERM) that would drop everything since the last
  pass boundary.

Detection is split so the happy path costs nothing extra on the host:
the all-finite reduction runs ON DEVICE inside the train step
(parallel/dp.py::TrainStep watchdog mode) and rides back in the same
2-float fetch as the loss; a non-finite batch's update is skipped
on-device (params/opt-state/state keep their old values), so by the
time the host learns about the bad batch it has already been absorbed.

The host-side `Watchdog` then runs the escalation ladder:

    skip          non-finite batch: update already skipped on device;
                  decrement the bounded skip budget (one per bad batch)
    backoff       finite loss but > EWMA spike threshold: scale LR by
                  `lr_backoff` and re-warm linearly over
                  `lr_rewarm_batches` (the PaLM-style spike response)
    rollback      skip budget exhausted, or spikes keep coming during
                  backoff: restore the last GOOD checkpoint (promoted
                  only after `good_batches` healthy batches — a
                  checkpoint saved just before divergence is never
                  trusted) via the async_checkpoint manifests
    abort         no good checkpoint to roll back to, or
                  `max_rollbacks` exceeded: raise `WatchdogAbort`
                  carrying a structured `WatchdogReport`

Preemption safety: `PreemptionGuard` turns SIGTERM into a flag the
training loop checks AFTER the in-flight batch completes; the loop
flushes a mid-pass checkpoint and raises `Preempted`, which the CLI
maps to `EXIT_PREEMPTED` (75, EX_TEMPFAIL) — the exit code a launcher
recognizes and respawns on, making `kill -TERM` lossless.

Import-light on purpose (no torch): the CLI imports the exit-code
contract without paying for a device runtime.

Telemetry: every ladder event is simultaneously (a) kept
on the structured `WatchdogReport`, (b) counted in the process
registry (`watchdog.events{kind=...}`), and (c) emitted on the JSONL
event stream with its `global_step` stamp — so NaN-detect latency and
rollback cost are computed from the stream by the bench rows instead
of grepped out of logs.
"""

from __future__ import annotations

import math
import signal
import threading
from dataclasses import dataclass, field
from typing import List, Optional

from paddle_tpu_torch.obs import metrics as _metrics

# ladder rungs that count as anomalies: each one trips a flight-recorder
# dump (`_flight_dump`) so the spans/timeline/events leading up to the
# rung survive the process. promote/rewarmed are healthy.
ANOMALY_RUNGS = frozenset(
    {"skip", "spike", "backoff", "rollback", "abort"}
)


def _flight_dump(trigger: str, /, **detail) -> None:
    """The flight recorder's dump of the JAX package
    (`obs/flight_recorder.py::maybe_dump`). The recorder is still to
    port (ROADMAP A6); until then an anomaly rung dumps nothing — its
    event is on the report, the registry and the JSONL stream."""

# EX_TEMPFAIL: "temporary failure, retry" — the one exit code in the
# sysexits range that means exactly what a preemption is. A launcher
# respawns ranks that exit with it instead of failing the job.
EXIT_PREEMPTED = 75

# observe() verdicts
OK = "ok"
SKIP = "skip"
BACKOFF = "backoff"
ROLLBACK = "rollback"
ABORT = "abort"


@dataclass
class WatchdogConfig:
    """Knobs for the escalation ladder. Defaults are deliberately
    conservative: healthy training must never trip them (a false
    rollback costs more than a late one)."""

    # non-finite handling: bad batches skipped on-device; after
    # `skip_budget` skips with no healthy batch in between the run is
    # presumed diverged and escalates to rollback
    skip_budget: int = 5
    # EWMA spike detector: loss is a spike when it exceeds
    # mean + spike_sigma * std (EWMA estimates) AND mean * spike_ratio
    # (the ratio guard keeps near-zero-variance phases from flagging
    # ordinary noise). Armed only after `warmup_batches` observations.
    ewma_alpha: float = 0.05
    spike_sigma: float = 10.0
    spike_ratio: float = 2.0
    warmup_batches: int = 20
    # backoff rung: on a spike, scale LR by `lr_backoff` and re-warm
    # linearly back to 1.0 over `lr_rewarm_batches`; `spikes_to_rollback`
    # spikes within one backoff episode escalate to rollback
    lr_backoff: float = 0.5
    lr_rewarm_batches: int = 50
    spikes_to_rollback: int = 3
    # a checkpoint is promoted to "good" (= a rollback target) only
    # after this many consecutive healthy batches follow its save
    good_batches: int = 8
    # rollbacks per run before the watchdog gives up and aborts
    max_rollbacks: int = 2


@dataclass
class WatchdogEvent:
    kind: str  # skip | spike | backoff | rewarmed | promote | rollback | abort
    global_step: int
    detail: dict = field(default_factory=dict)


@dataclass
class WatchdogReport:
    """Structured record of everything the watchdog did — attached to
    `WatchdogAbort`, exposed as `SGD.last_watchdog_report`, and the
    thing a postmortem reads instead of grepping logs."""

    skipped_batches: int = 0
    spikes: int = 0
    backoffs: int = 0
    rollbacks: int = 0
    aborted: bool = False
    abort_reason: str = ""
    last_good_pass: Optional[int] = None
    events: List[WatchdogEvent] = field(default_factory=list)

    def to_dict(self) -> dict:
        return {
            "skipped_batches": self.skipped_batches,
            "spikes": self.spikes,
            "backoffs": self.backoffs,
            "rollbacks": self.rollbacks,
            "aborted": self.aborted,
            "abort_reason": self.abort_reason,
            "last_good_pass": self.last_good_pass,
            "events": [
                {"kind": e.kind, "global_step": e.global_step,
                 **e.detail}
                for e in self.events
            ],
        }


class WatchdogAbort(RuntimeError):
    """The escalation ladder ran out of rungs. Carries the report."""

    def __init__(self, report: WatchdogReport):
        self.report = report
        super().__init__(
            f"training aborted by watchdog: {report.abort_reason} "
            f"(skipped={report.skipped_batches}, "
            f"spikes={report.spikes}, rollbacks={report.rollbacks})"
        )


class Preempted(Exception):
    """SIGTERM landed; the in-flight batch finished and a checkpoint
    was flushed. The CLI converts this to EXIT_PREEMPTED."""

    def __init__(self, pass_id: int, batches_done: int,
                 save_dir: Optional[str] = None):
        self.pass_id = pass_id
        self.batches_done = batches_done
        self.save_dir = save_dir
        super().__init__(
            f"preempted at pass {pass_id} after {batches_done} "
            f"batches; checkpoint flushed"
            + (f" to {save_dir}" if save_dir else "")
        )


class Watchdog:
    """Host-side half of the watchdog: consumes the (loss, finite)
    pair the device step already produced and answers with the next
    rung of the ladder. Pure bookkeeping — no device work."""

    def __init__(self, config: Optional[WatchdogConfig] = None):
        self.config = config or WatchdogConfig()
        self.report = WatchdogReport()
        self._reg = _metrics.get_registry()
        # EWMA loss statistics
        self._mean: Optional[float] = None
        self._var = 0.0
        self._observed = 0
        # skip bookkeeping: consecutive bad batches (a healthy batch
        # refills nothing — the budget is per divergence episode,
        # reset only by a healthy batch)
        self._consecutive_skips = 0
        # LR backoff episode
        self._scale = 1.0
        self._rewarm_left = 0
        self._episode_spikes = 0
        # checkpoint promotion
        self._candidate_pass: Optional[int] = None
        self._candidate_healthy = 0
        self._good_pass: Optional[int] = None

    # ---- telemetry ----
    def record_event(self, kind: str, global_step: int,
                     **detail) -> None:
        """One ladder event, recorded everywhere at once: the report
        (postmortems), the registry counter (metricz), and the JSONL
        event stream (latency measurement). Used by the trainer too
        (rollback-unloadable aborts) so the three records can never
        disagree."""
        self.report.events.append(
            WatchdogEvent(kind, global_step, detail)
        )
        self._reg.counter("watchdog.events").inc(kind=kind)
        self._reg.event("watchdog", event=kind,
                        global_step=global_step, **detail)
        if kind in ANOMALY_RUNGS:
            # the dump happens AFTER the event above, so the bundle's
            # ring contains the rung that tripped it
            _flight_dump(f"watchdog_{kind}", global_step=global_step,
                         **detail)

    # ---- checkpoint promotion ----
    @property
    def good_pass(self) -> Optional[int]:
        """Newest checkpoint pass proven healthy — the rollback target."""
        return self._good_pass

    def on_checkpoint(self, pass_id: int) -> None:
        """A checkpoint for `pass_id` just committed. It becomes a
        *candidate*; only `good_batches` consecutive healthy batches
        promote it (a snapshot of already-diverging params must never
        become the rollback target)."""
        self._candidate_pass = pass_id
        self._candidate_healthy = 0

    def _promote_if_ready(self, global_step: int) -> None:
        if self._candidate_pass is None:
            return
        self._candidate_healthy += 1
        if self._candidate_healthy >= self.config.good_batches:
            self._good_pass = self._candidate_pass
            self.report.last_good_pass = self._good_pass
            self.record_event("promote", global_step,
                              pass_id=self._candidate_pass)
            self._candidate_pass = None

    def _demote_candidate(self) -> None:
        # an unhealthy batch while a candidate is pending: the
        # checkpoint may hold already-poisoned params — drop it
        self._candidate_pass = None

    # ---- LR ladder ----
    def lr_scale(self) -> float:
        """Multiplier for this batch's learning rate (1.0 on the happy
        path; `lr_backoff` right after a spike, linearly re-warming)."""
        return self._scale

    def _start_backoff(self, global_step: int) -> None:
        c = self.config
        self._scale = c.lr_backoff
        self._rewarm_left = max(c.lr_rewarm_batches, 1)
        self.report.backoffs += 1
        self.record_event(
            "backoff", global_step, lr_scale=c.lr_backoff,
            rewarm_batches=self._rewarm_left,
        )

    def _advance_rewarm(self) -> None:
        if self._rewarm_left <= 0:
            return
        self._rewarm_left -= 1
        if self._rewarm_left == 0:
            self._scale = 1.0
            self._episode_spikes = 0
        else:
            c = self.config
            frac = 1.0 - self._rewarm_left / max(c.lr_rewarm_batches, 1)
            self._scale = c.lr_backoff + (1.0 - c.lr_backoff) * frac

    # ---- rollback bookkeeping ----
    def on_rollback(self, pass_id: int, global_step: int) -> None:
        """The trainer restored `pass_id`. Reset every estimator — the
        post-rollback loss distribution is the checkpoint's, not the
        diverged run's."""
        self.report.rollbacks += 1
        self.record_event("rollback", global_step, pass_id=pass_id)
        self._mean = None
        self._var = 0.0
        self._observed = 0
        self._consecutive_skips = 0
        self._scale = 1.0
        self._rewarm_left = 0
        self._episode_spikes = 0
        # the restored checkpoint is good by construction (it was
        # promoted); keep it as the target for a repeat rollback
        self._candidate_pass = None

    # ---- the ladder ----
    def observe(self, loss: float, finite: bool,
                global_step: int) -> str:
        """One batch's verdict. Returns OK / SKIP / BACKOFF /
        ROLLBACK / ABORT. SKIP means the device already dropped the
        update; ROLLBACK/ABORT are requests the trainer must act on."""
        c = self.config
        if not finite or not math.isfinite(loss):
            self._demote_candidate()
            self._consecutive_skips += 1
            self.report.skipped_batches += 1
            self.record_event(
                "skip", global_step, loss=repr(loss),
                budget_left=c.skip_budget - self._consecutive_skips,
            )
            if self._consecutive_skips > c.skip_budget:
                return self._escalate(global_step,
                                      "skip budget exhausted")
            return SKIP

        # finite batch: advance the re-warm ramp before spike checks
        self._advance_rewarm()
        self._consecutive_skips = 0

        spike = False
        if self._mean is not None and self._observed >= c.warmup_batches:
            std = math.sqrt(max(self._var, 0.0))
            spike = (
                loss > self._mean + c.spike_sigma * std
                and loss > abs(self._mean) * c.spike_ratio
            )
        if spike:
            self._demote_candidate()
            self.report.spikes += 1
            self._episode_spikes += 1
            self.record_event(
                "spike", global_step, loss=loss, ewma_mean=self._mean,
                ewma_std=math.sqrt(max(self._var, 0.0)),
            )
            # the spiking loss is NOT folded into the EWMA — it would
            # drag the threshold up and mask a follow-on spike
            if self._episode_spikes >= c.spikes_to_rollback:
                return self._escalate(global_step,
                                      "repeated loss spikes")
            self._start_backoff(global_step)
            return BACKOFF

        # healthy batch: update EWMA mean/var, promote candidates
        if self._mean is None:
            self._mean = loss
        else:
            a = c.ewma_alpha
            d = loss - self._mean
            self._mean += a * d
            self._var = (1.0 - a) * (self._var + a * d * d)
        self._observed += 1
        self._promote_if_ready(global_step)
        return OK

    def _escalate(self, global_step: int, why: str) -> str:
        if (self._good_pass is None
                or self.report.rollbacks >= self.config.max_rollbacks):
            self.report.aborted = True
            self.report.abort_reason = (
                why + (": no good checkpoint to roll back to"
                       if self._good_pass is None
                       else f": max_rollbacks={self.config.max_rollbacks}"
                            " exceeded")
            )
            self.record_event("abort", global_step,
                              reason=self.report.abort_reason)
            return ABORT
        return ROLLBACK


class PreemptionGuard:
    """Context manager that converts SIGTERM into a checked flag.

    The handler only flips a bool — the in-flight batch (or chunk)
    always completes, and the training loop performs the flush at a batch
    boundary (the only point where params/opt-state are consistent).
    Installing a handler is only legal on the main thread; elsewhere
    (e.g. a serving worker running a train loop) the guard degrades to
    an inert flag and SIGTERM keeps its process-default meaning."""

    def __init__(self, signals=(signal.SIGTERM,)):
        self._signals = signals
        self._prev: dict = {}
        self.preempted = False
        self.installed = False

    def _handler(self, signum, frame):
        self.preempted = True

    def __enter__(self):
        if threading.current_thread() is threading.main_thread():
            for s in self._signals:
                self._prev[s] = signal.signal(s, self._handler)
            self.installed = True
        return self

    def __exit__(self, *exc):
        for s, prev in self._prev.items():
            try:
                signal.signal(s, prev)
            except (ValueError, OSError):
                pass
        self._prev.clear()
        self.installed = False
        return False
