"""Per-step wall-time attribution for training hot loops.

A copy of the JAX package's `obs/timeline.py`. Every trained batch's
wall time is split into the four places it can go:

- **data_wait**        — blocking in the reader/feeder before the
                         step could be dispatched
- **host_dispatch**    — Python and launch time to *submit* the step
                         (kernel launches and graph replays return
                         before the card finishes)
- **device_step**      — time blocked waiting on the card: the health
                         fetch the loop makes anyway, plus a full
                         `torch.cuda.synchronize()` fence on sampled
                         steps only (every `sample_period` steps), so
                         the parameter-update tail is measured there
                         while the other steps stay asynchronous — a
                         fence on every step would make the step
                         host-bound again
- **checkpoint_stall** — training-thread stalls inside checkpoint
                         saves and preemption flushes

The timeline is bookkeeping only: the *trainer* owns the fencing,
`fence_now()` answers "is this a sampled step". Totals are mirrored
into the registry as counters under `<prefix>.`; `fractions()` gives
the `data_wait_frac` / `host_overhead_frac` / `device_frac` /
`checkpoint_stall_frac` fields, and `emit_pass()` writes one
`timeline` event per pass to the JSONL stream.
"""

from __future__ import annotations

from paddle_tpu_torch.obs import metrics as _metrics

PARTS = ("data_wait", "host_dispatch", "device_step", "checkpoint_stall")


class StepTimeline:
    def __init__(self, sample_period: int = 16, prefix: str = "trainer",
                 registry=None):
        """`sample_period`: fence every Nth step; 0 disables fencing
        (device_step then measures only the fetches the loop makes
        anyway)."""
        self.sample_period = int(sample_period)
        self.prefix = prefix
        self._reg = registry or _metrics.get_registry()
        self._totals = {p: 0.0 for p in PARTS}
        # the latest duration of each part: the step-span emitter reads
        # this step's split after run_step measured it
        self.last = {p: 0.0 for p in PARTS}
        self._steps = 0
        self._fenced = 0

    # ---- accumulation (trainer-side) ----
    def _add(self, part: str, dt: float) -> None:
        self._totals[part] += dt
        self.last[part] = dt
        self._reg.counter(f"{self.prefix}.{part}_s").inc(dt)

    def add_data_wait(self, dt: float) -> None:
        self._add("data_wait", dt)

    def add_dispatch(self, dt: float) -> None:
        self._add("host_dispatch", dt)

    def add_device(self, dt: float) -> None:
        self._add("device_step", dt)

    def add_checkpoint(self, dt: float) -> None:
        self._add("checkpoint_stall", dt)

    def step_done(self) -> None:
        self._steps += 1
        self._reg.counter(f"{self.prefix}.steps").inc()

    def fence_now(self, step_index: int) -> bool:
        """True on sampled steps: the trainer then waits until the whole
        step (parameter update included) has landed."""
        if self.sample_period <= 0:
            return False
        fence = step_index % self.sample_period == 0
        if fence:
            self._fenced += 1
        return fence

    # ---- export ----
    @property
    def steps(self) -> int:
        return self._steps

    def totals(self) -> dict:
        return dict(self._totals)

    def fractions(self) -> dict:
        """Shares of the measured wall (the four parts' sum). All zero
        before the first step."""
        wall = sum(self._totals.values())
        if wall <= 0.0:
            return {
                "data_wait_frac": 0.0,
                "host_overhead_frac": 0.0,
                "device_frac": 0.0,
                "checkpoint_stall_frac": 0.0,
            }
        return {
            "data_wait_frac": round(self._totals["data_wait"] / wall, 4),
            "host_overhead_frac": round(
                self._totals["host_dispatch"] / wall, 4
            ),
            "device_frac": round(self._totals["device_step"] / wall, 4),
            "checkpoint_stall_frac": round(
                self._totals["checkpoint_stall"] / wall, 4
            ),
        }

    def emit_pass(self, pass_id: int, global_step: int) -> None:
        """One `timeline` event on the JSONL stream per pass (a no-op
        without a stream)."""
        self._reg.event(
            "timeline",
            pass_id=pass_id,
            global_step=global_step,
            steps=self._steps,
            fenced_steps=self._fenced,
            sample_period=self.sample_period,
            **{f"{p}_s": round(self._totals[p], 6) for p in PARTS},
            **self.fractions(),
        )
