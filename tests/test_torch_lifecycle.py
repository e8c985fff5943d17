"""The port's training lifecycle against the JAX package's, on the CPU:
evaluators in the loop, `test()`, checkpoints, resume, preemption, the
watchdog ladder and the command line.

Models: the IMDB classifier at vocab 64, hidden 16 (its LSTMs on the
kernels' path: their plain versions on the CPU), fed by each package's
`DataFeeder` through `batched(shuffle(...))` with length buckets, with
the `classification_error` and `precision_recall` evaluators; a small
MLP whose dense input carries NaN batches for the watchdog. Both
packages start from the same numpy weights (the JAX init).

- The event stream: the port's `SGD.train` (K = 1 and K = 3, a test
  reader, sync checkpoints, log_period 2) fires the JAX trainer's
  events in the same order — BeginPass, BeginIteration, EndIteration
  with the evaluators' results every log_period batches, TestResult,
  EndPass — with costs at rtol 1e-4 and evaluator results at rtol 1e-4.
- Resume across packages: the JAX trainer trains pass 0 and saves
  (sync or async); the port resumes and trains pass 1; its params and
  adam slots are within 1e-4 of their largest entry of the JAX
  trainer's pass 1, its EndPass evaluator results at rtol 1e-4.
- Preemption: `os.kill(os.getpid(), SIGTERM)` from the event handler
  mid-pass, at K = 1 and K = 4 (sync and async checkpoints), raises
  `Preempted`; a new SGD's `resume()` and `train()` end `torch.equal`
  to an uninterrupted run. The CLI round trip in subprocesses: a run
  that SIGTERMs itself exits 75 and prints `PREEMPTED`, the relaunch
  prints `resuming ... skip N` and its final pass is bit-equal to an
  uninterrupted run's; `--job=test`, `--job=time`, `merge_model`,
  `infer --example`, `dump_config` and `version` print their lines.
- The ladder: the port's `Watchdog` and the JAX `Watchdog` on one
  cost/finite stream (skip, spike, backoff, re-warm, promotion,
  rollback, abort) give equal actions, LR scales and reports; a
  trainer run with NaN batches gives the same event kinds and global
  steps in both packages (K = 1 and K = 4).
- Rollback re-seats the graphs: with `StepGraphs`' replays run eagerly
  (the way the multi-step tests run the graph runner on the CPU), a
  rollback leaves the static trees equal to the promoted checkpoint,
  and the run ends equal to one without graphs.
- `prune_mask` and `ParameterAverager` against JAX; the stat report,
  the timeline, the profiler and the v2 `infer()`.
"""

import dataclasses
import json
import os
import signal
import subprocess
import sys

import numpy as np
import pytest
import torch

try:  # the parity tests need JAX
    import jax
    import jax.numpy as jnp

    from paddle_tpu import dsl as jdsl
    from paddle_tpu.core import arg as jarg
    from paddle_tpu.core.config import OptimizationConf as JOptConf
    from paddle_tpu.data import feeder as jfeeder
    from paddle_tpu.data import reader as jreader
    from paddle_tpu.models import text as jtext
    from paddle_tpu.network import Network as JNetwork
    from paddle_tpu.optimizers import ParameterAverager as JAverager
    from paddle_tpu.optimizers import create_optimizer as jcreate
    from paddle_tpu.optimizers import prune_mask as jprune_mask
    from paddle_tpu.trainer import watchdog as jwdg
    from paddle_tpu.trainer.trainer import SGD as JSGD
except ImportError:
    jax = None

from paddle_tpu_torch import dsl as tdsl
from paddle_tpu_torch.core import arg as targ
from paddle_tpu_torch.core import flags as tflags
from paddle_tpu_torch.core.config import OptimizationConf as TOptConf
from paddle_tpu_torch.data import feeder as tfeeder
from paddle_tpu_torch.data import reader as treader
from paddle_tpu_torch.models import text as ttext
from paddle_tpu_torch.network import Network as TNetwork
from paddle_tpu_torch.optimizers import ParameterAverager as TAverager
from paddle_tpu_torch.optimizers import create_optimizer as tcreate
from paddle_tpu_torch.optimizers import prune_mask as tprune_mask
from paddle_tpu_torch.trainer import async_checkpoint as tactp
from paddle_tpu_torch.trainer import checkpoint as tckpt
from paddle_tpu_torch.trainer import watchdog as twdg
from paddle_tpu_torch.trainer.trainer import SGD as TSGD
from paddle_tpu_torch.weights import params_from_numpy

needs_jax = pytest.mark.skipif(jax is None, reason="needs JAX (CPU parity)")

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
NET_TOL = 1e-4
OPT = dict(learning_method="adam", learning_rate=0.01)
CLS = dict(vocab_size=64, emb_dim=8, hidden=16)
EVALS = [{"type": "classification_error", "name": "error",
          "input": "output", "label": "label"},
         {"type": "precision_recall", "name": "pr", "input": "output",
          "label": "label"}]
BUCKETS = (8, 16)
# 7 batches of 5 a pass: the buckets change the feed's signature, and
# the last batch is short
SAMPLE_LENS = [3, 8, 1, 5, 7] + [12, 4, 16, 9, 2] * 5 + [10, 3, 6]
TYPES = {"words": 0, "label": 1}


@pytest.fixture(autouse=True)
def _flags():
    tflags.set_flag("use_pallas_rnn", True)
    tflags.set_flag("log_period", 2)
    if jax is not None:
        from paddle_tpu.core import flags as jflags

        jflags.set_flag("log_period", 2)
    yield
    tflags.reset_flags()
    if jax is not None:
        jflags.reset_flags()


def _samples(seed=9):
    rng = np.random.default_rng(seed)
    return [(list(rng.integers(0, 64, n)), int(rng.integers(0, 2)))
            for n in SAMPLE_LENS]


def _reader(mod, seed=9):
    samples = _samples(seed)
    return mod.batched(mod.shuffle(lambda: iter(samples), 5, seed=4), 5,
                       drop_last=False)


def _feeder(mod):
    return mod.DataFeeder(TYPES, {"words": mod.integer_value_sequence(64),
                                  "label": mod.integer_value(2)},
                          buckets=BUCKETS)


def _np_params():
    jnet = JNetwork(jtext.stacked_lstm_classifier(**CLS))
    rng = np.random.default_rng(3)
    out = {}
    for k, v in jnet.init_params(jax.random.key(3)).items():
        v = np.asarray(v)
        if v.ndim == 1:
            v = v + 0.3 * rng.standard_normal(v.shape).astype(np.float32)
        out[k] = v
    return out


def _jsgd(np_p, k=1, **kw):
    return JSGD(jtext.stacked_lstm_classifier(**CLS), JOptConf(**OPT),
                seed=1, params={n: jnp.asarray(v) for n, v in np_p.items()},
                steps_per_dispatch=k, evaluators=EVALS, **kw)


def _tsgd(np_p, k=1, **kw):
    return TSGD(ttext.stacked_lstm_classifier(**CLS), TOptConf(**OPT),
                seed=1, params=params_from_numpy(np_p, device="cpu"),
                device="cpu", steps_per_dispatch=k, evaluators=EVALS, **kw)


def _rel(got, ref):
    got, ref = np.asarray(got), np.asarray(ref)
    assert got.shape == ref.shape
    return float(np.abs(got - ref).max()) / max(float(np.abs(ref).max()),
                                                1e-30)


def _close_results(got, want, where):
    if isinstance(want, dict):
        assert got.keys() == want.keys(), where
        for k in want:
            _close_results(got[k], want[k], f"{where}.{k}")
    else:
        np.testing.assert_allclose(got, want, rtol=NET_TOL, err_msg=where)


def _events(events):
    return [(type(e).__name__, getattr(e, "pass_id", None),
             getattr(e, "batch_id", None)) for e in events]


def _assert_trees_equal(a, b, what):
    if isinstance(a, dict):
        assert a.keys() == b.keys(), what
        for k in a:
            _assert_trees_equal(a[k], b[k], f"{what}.{k}")
    else:
        assert torch.equal(a, b), what


# ---- the event stream ------------------------------------------------------


@needs_jax
@pytest.mark.parametrize("k", [1, 3])
def test_event_stream_matches_the_jax_trainer(tmp_path, k):
    np_p = _np_params()
    jt = _jsgd(np_p, k)
    jev = []
    jt.train(_reader(jreader), _feeder(jfeeder), num_passes=2,
             event_handler=jev.append, test_reader=_reader(jreader, 5),
             save_dir=str(tmp_path / "j"))
    tt = _tsgd(np_p, k)
    tev = []
    tt.train(_reader(treader), _feeder(tfeeder), num_passes=2,
             event_handler=tev.append, test_reader=_reader(treader, 5),
             save_dir=str(tmp_path / "t"))
    assert _events(tev) == _events(jev)
    names = [e[0] for e in _events(tev)]
    # per pass: the test result and the checkpoint come before EndPass
    assert names[-2:] == ["TestResult", "EndPass"]
    logged = 0
    for a, b in zip(tev, jev):
        if hasattr(b, "cost"):
            np.testing.assert_allclose(a.cost, b.cost, rtol=NET_TOL)
        if hasattr(b, "evaluator_results"):
            _close_results(a.evaluator_results, b.evaluator_results,
                           type(b).__name__)
            logged += bool(b.evaluator_results)
    # EndIteration every log_period (2) batches of 7, TestResult, EndPass
    assert logged == 2 * (3 + 2)
    assert (tckpt.list_sync_passes(str(tmp_path / "t"))
            == tckpt.list_sync_passes(str(tmp_path / "j")) == [0, 1])
    for name, v in tt.params.items():
        assert _rel(v.numpy(), jt.params[name]) <= NET_TOL, name


@needs_jax
def test_test_pass_matches_the_jax_test():
    np_p = _np_params()
    jr = _jsgd(np_p).test(_reader(jreader, 5), _feeder(jfeeder))
    tr = _tsgd(np_p).test(_reader(treader, 5), _feeder(tfeeder))
    np.testing.assert_allclose(tr["cost"], jr["cost"], rtol=1e-5)
    _close_results(tr["evaluators"], jr["evaluators"], "test")


# ---- resume across packages ------------------------------------------------


@needs_jax
@pytest.mark.parametrize("mode", ["sync", "async"])
def test_the_port_resumes_a_jax_checkpoint(tmp_path, mode):
    np_p = _np_params()
    d = str(tmp_path)
    jt = _jsgd(np_p)
    jt.train(_reader(jreader), _feeder(jfeeder), num_passes=1, save_dir=d,
             checkpoint_mode=mode)
    tt = TSGD(ttext.stacked_lstm_classifier(**CLS), TOptConf(**OPT),
              seed=7, device="cpu", evaluators=EVALS)
    assert tt.resume(d) == 1
    assert tt.global_step == jt.global_step == 7
    tev, jev = [], []
    tt.train(_reader(treader), _feeder(tfeeder), num_passes=2,
             event_handler=tev.append, start_pass=1)
    jt.train(_reader(jreader), _feeder(jfeeder), num_passes=2,
             event_handler=jev.append, start_pass=1)
    assert _events(tev) == _events(jev)
    _close_results(tev[-1].evaluator_results, jev[-1].evaluator_results,
                   "EndPass")
    for name, v in tt.params.items():
        assert _rel(v.numpy(), jt.params[name]) <= NET_TOL, name
    for name, slots in tt.opt_state.items():
        for slot, v in slots.items():
            assert _rel(v.numpy(), jt.opt_state[name][slot]) <= NET_TOL, (
                name, slot)


# ---- preemption ------------------------------------------------------------


def _tiny_np_params():
    net = TNetwork(ttext.stacked_lstm_classifier(**CLS))
    p = net.init_params(torch.Generator().manual_seed(3), device="cpu")
    return {k: v.numpy() for k, v in p.items()}


@pytest.mark.parametrize("k,mode", [(1, "sync"), (4, "sync"), (4, "async")])
def test_preempt_and_resume_ends_equal_to_an_uninterrupted_run(
        tmp_path, k, mode):
    np_p = _tiny_np_params()
    full = _tsgd(np_p, k)
    full.train(_reader(treader), _feeder(tfeeder), num_passes=3,
               save_dir=str(tmp_path / "full"), checkpoint_mode=mode)

    def kill_mid_pass(e):
        if type(e).__name__ == "EndIteration" and (e.pass_id, e.batch_id) \
                == (1, 2):
            os.kill(os.getpid(), signal.SIGTERM)

    d = str(tmp_path / "cut")
    cut = _tsgd(np_p, k)
    with pytest.raises(twdg.Preempted) as info:
        cut.train(_reader(treader), _feeder(tfeeder), num_passes=3,
                  event_handler=kill_mid_pass, save_dir=d,
                  checkpoint_mode=mode)
    # K = 1 stops after batch 2; K = 4 after the chunk holding it (the
    # first chunk of pass 1 is batch 0 alone: batch 1 changes buckets)
    assert info.value.pass_id == 1
    assert info.value.batches_done == (3 if k == 1 else 5)
    again = TSGD(ttext.stacked_lstm_classifier(**CLS), TOptConf(**OPT),
                 seed=99, device="cpu", steps_per_dispatch=k,
                 evaluators=EVALS)
    start = again.resume(d)
    assert start == 1 and again._resume_skip_batches == \
        info.value.batches_done
    events = []
    again.train(_reader(treader), _feeder(tfeeder), num_passes=3,
                event_handler=events.append, save_dir=d, start_pass=start,
                checkpoint_mode=mode)
    first = [e for e in _events(events) if e[0] == "BeginIteration"][0]
    assert first == ("BeginIteration", 1, info.value.batches_done)
    assert again.global_step == full.global_step == 21
    _assert_trees_equal(again.params, full.params, "params")
    _assert_trees_equal(again.opt_state, full.opt_state, "opt_state")


CLI_CONFIG = """
import os
import signal

import numpy as np

from paddle_tpu_torch.core import flags
from paddle_tpu_torch.core.config import OptimizationConf
from paddle_tpu_torch.data import feeder as F
from paddle_tpu_torch.data import reader as R
from paddle_tpu_torch.models.text import stacked_lstm_classifier

flags.set_flag("seed", 5)
flags.set_flag("steps_per_dispatch", 4)
flags.set_flag("use_pallas_rnn", True)

LENS = {lens}
rng = np.random.default_rng(9)
SAMPLES = [(list(rng.integers(0, 64, n)), int(rng.integers(0, 2)))
           for n in LENS]
TEST = SAMPLES[::2]
feeder = F.DataFeeder({{"words": 0, "label": 1}},
                      {{"words": F.integer_value_sequence(64),
                       "label": F.integer_value(2)}}, buckets=(8, 16))
evaluators = {evals}
MARK = os.environ.get("PREEMPT_MARK")
_calls = []


def get_config():
    return (stacked_lstm_classifier(vocab_size=64, emb_dim=8, hidden=16),
            OptimizationConf(learning_method="adam", learning_rate=0.01))


def train_reader():
    inner = R.batched(R.shuffle(lambda: iter(SAMPLES), 5, seed=4), 5,
                      drop_last=False)

    def reader():
        _calls.append(1)
        for i, b in enumerate(inner()):
            # the second pass SIGTERMs its own process once, at batch 3
            if MARK and len(_calls) == 2 and i == 3 \\
                    and not os.path.exists(MARK):
                open(MARK, "w").close()
                os.kill(os.getpid(), signal.SIGTERM)
            yield b

    return reader


def test_reader():
    return R.batched(lambda: iter(TEST), 5, drop_last=False)
"""


def _cli(args, env=None, cwd=None):
    res = subprocess.run(
        [sys.executable, "-m", "paddle_tpu_torch", *args], cwd=cwd or REPO,
        env=dict(os.environ, PYTHONPATH=REPO, **(env or {})),
        capture_output=True, text=True, timeout=300)
    return res


def test_cli_preempt_relaunch_test_time_merge_infer(tmp_path):
    conf = tmp_path / "conf.py"
    conf.write_text(CLI_CONFIG.format(lens=SAMPLE_LENS, evals=EVALS))
    base = ["train", "--config", str(conf), "--device", "cpu",
            "--num_passes", "2", "--log_period", "1"]
    full = _cli(base + ["--save_dir", str(tmp_path / "a")])
    assert full.returncode == 0, full.stderr
    mark = str(tmp_path / "mark")
    cut = _cli(base + ["--save_dir", str(tmp_path / "b")],
               env={"PREEMPT_MARK": mark})
    assert cut.returncode == twdg.EXIT_PREEMPTED == 75, cut.stderr
    # the SIGTERM lands while batch 3 of pass 1 is read: the batches of
    # the chunks that ran before it are done, the buffered ones are not
    line = [ln for ln in cut.stdout.splitlines()
            if ln.startswith("PREEMPTED")]
    assert len(line) == 1 and line[0].startswith("PREEMPTED pass 1 batch ")
    done = int(line[0].split()[-1])
    again = _cli(base + ["--save_dir", str(tmp_path / "b")],
                 env={"PREEMPT_MARK": mark})
    assert again.returncode == 0, again.stderr
    assert (f"resuming from {tmp_path / 'b'}: start pass 1, skip {done} "
            f"batches") in again.stdout
    for name in ("params.npz", "opt_state.npz"):
        with np.load(tmp_path / "a" / "pass-00001" / name) as x, \
                np.load(tmp_path / "b" / "pass-00001" / name) as y:
            assert sorted(x.files) == sorted(y.files)
            assert all(np.array_equal(x[k], y[k]) for k in x.files)

    test = _cli(["train", "--config", str(conf), "--device", "cpu",
                 "--job", "test", "--save_dir", str(tmp_path / "a")])
    assert test.returncode == 0, test.stderr
    assert test.stdout.startswith("test cost ") and "error=" in test.stdout
    timed = _cli(["train", "--config", str(conf), "--device", "cpu",
                  "--job", "time", "--time_batches", "3"])
    assert timed.returncode == 0, timed.stderr
    assert "ms/batch over 3 batches" in timed.stdout
    model = str(tmp_path / "model.npz")
    merged = _cli(["merge_model", "--config", str(conf), "--model_dir",
                   str(tmp_path / "a"), "--output", model])
    assert merged.returncode == 0, merged.stderr
    assert "-> " + model in merged.stdout
    inf = _cli(["infer", "--model", model, "--example", "--batch", "2",
                "--device", "cpu"])
    assert inf.returncode == 0, inf.stderr
    assert "outputs: ['output']" in inf.stdout
    assert "output: shape (2, 2)" in inf.stdout
    dumped = _cli(["dump_config", "--config", str(conf)])
    assert dumped.returncode == 0, dumped.stderr
    assert json.loads(dumped.stdout)["optimization"]["learning_method"] \
        == "adam"
    version = _cli(["version"])
    assert version.returncode == 0 and "paddle_tpu_torch" in version.stdout
    v1 = tmp_path / "v1.py"
    v1.write_text("settings(batch_size=4)\n")
    refused = _cli(["train", "--config", str(v1), "--device", "cpu"])
    assert refused.returncode != 0 and "A9/A12" in refused.stderr


def test_help_lists_every_command():
    res = _cli(["--help"])
    for cmd in ("train", "merge_model", "infer", "dump_config", "version",
                "serve"):
        assert cmd in res.stdout


# ---- the watchdog ladder ---------------------------------------------------

LADDER = dict(skip_budget=2, warmup_batches=5, good_batches=3,
              lr_rewarm_batches=4, spikes_to_rollback=2, max_rollbacks=1,
              spike_sigma=3.0, spike_ratio=1.5)


def _ladder_stream():
    """(loss, finite, checkpoint-after) triples: warm-up, a checkpoint
    promoted, a spike with its backoff and re-warm, a skip, a second
    episode of spikes that escalates to a rollback, and finally skips
    past the budget once no rollback is left (abort)."""
    healthy = [1.0 + 0.01 * (i % 3) for i in range(8)]
    out = [(c, True, i == 2) for i, c in enumerate(healthy)]
    out += [(9.0, True, False)]                         # spike -> backoff
    out += [(1.0, True, False)] * 5                     # re-warm
    out += [(float("nan"), False, False)]               # skip
    out += [(1.01, True, False)] * 3
    out += [(9.0, True, False), (9.5, True, False)]     # spikes -> rollback
    out += [(1.0, True, False)] * 3
    out += [(float("nan"), False, False)] * 3           # -> abort
    return out


@needs_jax
def test_the_ladder_matches_the_jax_watchdog():
    tw = twdg.Watchdog(twdg.WatchdogConfig(**LADDER))
    jw = jwdg.Watchdog(jwdg.WatchdogConfig(**LADDER))
    acts = []
    for step, (loss, finite, ckpt_after) in enumerate(_ladder_stream()):
        a, b = tw.observe(loss, finite, step), jw.observe(loss, finite, step)
        assert a == b, step
        assert tw.lr_scale() == jw.lr_scale(), step
        acts.append(a)
        if a == twdg.ROLLBACK:
            tw.on_rollback(tw.good_pass, step)
            jw.on_rollback(jw.good_pass, step)
        if ckpt_after:
            tw.on_checkpoint(0)
            jw.on_checkpoint(0)
        if a == twdg.ABORT:
            break
    assert acts[-1] == twdg.ABORT
    assert {twdg.SKIP, twdg.BACKOFF, twdg.ROLLBACK}.issubset(acts)
    got, want = tw.report.to_dict(), jw.report.to_dict()
    assert got == want
    kinds = {e["kind"] for e in got["events"]}
    assert kinds == {"promote", "spike", "backoff", "skip", "rollback",
                     "abort"}


def _mlp(dsl):
    with dsl.model() as m:
        x = dsl.data("x", dim=6)
        y = dsl.data("label", dim=(), is_ids=True)
        h = dsl.fc(x, size=16, act="relu", name="h")
        o = dsl.fc(h, size=3, name="o")
        dsl.classification_cost(o, y)
    return m.conf


MLP_WD = dict(skip_budget=1, good_batches=2, warmup_batches=1000)
# pass 0 clean; pass 1: two clean batches promote pass 0's checkpoint, a
# NaN batch is skipped, then two NaN batches in a row exhaust the budget
# and roll back to pass 0
NAN_AT = {1: (2, 4, 5)}


def _mlp_batches(pass_id):
    rng = np.random.default_rng(20 + pass_id)
    out = []
    for b in range(8):
        x = rng.standard_normal((4, 6)).astype(np.float32)
        if b in NAN_AT.get(pass_id, ()):
            x[1, 2] = np.nan
        out.append((x, rng.integers(0, 3, 4)))
    return out


class _PassReader:
    """A reader whose n-th call yields pass n's batches."""

    def __init__(self):
        self.calls = 0

    def __call__(self):
        batches = _mlp_batches(self.calls)
        self.calls += 1
        return iter(batches)


def _jmlp_feed(b):
    return {"x": jarg.non_seq(jnp.asarray(b[0])),
            "label": jarg.id_arg(b[1].astype(np.int32))}


def _tmlp_feed(b):
    return {"x": targ.non_seq(b[0]), "label": targ.id_arg(b[1])}


def _mlp_np_params():
    rng = np.random.default_rng(1)
    net = TNetwork(_mlp(tdsl))
    return {k: (0.3 * rng.standard_normal(pc.dims)).astype(np.float32)
            for k, pc in net.param_confs.items()}


def _tmlp(np_p, k, **kw):
    return TSGD(_mlp(tdsl), TOptConf(**OPT), seed=1,
                params=params_from_numpy(np_p, device="cpu"), device="cpu",
                steps_per_dispatch=k,
                watchdog=twdg.WatchdogConfig(**MLP_WD), **kw)


def _ladder_events(report):
    return [(e.kind, e.global_step, e.detail.get("pass_id"))
            for e in report.events]


@needs_jax
@pytest.mark.parametrize("k", [1, 4])
def test_nan_batches_walk_the_jax_trainers_ladder(tmp_path, k):
    np_p = _mlp_np_params()
    jt = JSGD(_mlp(jdsl), JOptConf(**OPT), seed=1,
              params={n: jnp.asarray(v) for n, v in np_p.items()},
              steps_per_dispatch=k, watchdog=jwdg.WatchdogConfig(**MLP_WD))
    jt.train(_PassReader(), _jmlp_feed, num_passes=2,
             save_dir=str(tmp_path / "j"))
    tt = _tmlp(np_p, k)
    tt.train(_PassReader(), _tmlp_feed, num_passes=2,
             save_dir=str(tmp_path / "t"))
    got = _ladder_events(tt.last_watchdog_report)
    assert got == _ladder_events(jt.last_watchdog_report)
    assert [e[0] for e in got] == ["promote", "skip", "skip", "skip",
                                   "rollback"]
    assert got[-1][2] == 0 and tt.global_step == jt.global_step
    for name, v in tt.params.items():
        assert _rel(v.numpy(), jt.params[name]) <= NET_TOL, name


def test_rollback_reseats_the_graphs_static_trees(tmp_path, monkeypatch):
    """The port's K = 4 run through `StepGraphs` with the CUDA capture
    swapped for eager execution of the captured steps: right after the
    rollback the static trees hold the promoted checkpoint's bits, and
    the run ends equal to the same run without graphs."""
    from paddle_tpu_torch.parallel import graph as tgraph

    np_p = _mlp_np_params()
    plain = _tmlp(np_p, 4)
    plain.train(_PassReader(), _tmlp_feed, num_passes=2,
                save_dir=str(tmp_path / "plain"))

    monkeypatch.setattr(tgraph.torch.cuda, "graph_pool_handle", lambda: None)
    monkeypatch.setattr(tgraph.torch.cuda, "Stream", lambda device: None)
    monkeypatch.setattr(tgraph.torch.cuda, "CUDAGraph", lambda: None)
    monkeypatch.setattr(tgraph._Graph, "capture", lambda self: None)

    def replay(self):
        self.losses, self.outs = self._steps(self.k, write_back=True)
        return (self.losses.clone(),
                {n: tgraph._arg_map(torch.clone, a)
                 for n, a in self.outs.items()})

    monkeypatch.setattr(tgraph._Graph, "replay", replay)
    sgd = _tmlp(np_p, 4)
    step = sgd.step_fn

    def graph_multi(params, opt_state, state, feeds, step_i, step_root,
                    lr_scale=None):
        n = next(iter(feeds.values())).value.shape[0]
        scalars, seeds = step.step_tables(step_i, n,
                                          step_root.initial_seed(),
                                          lr_scale,
                                          next(iter(params.values())))
        if step.graphs is None:
            step.graphs = tgraph.StepGraphs(step)
        return step.graphs.run(params, opt_state, state, feeds, scalars,
                               seeds)

    monkeypatch.setattr(step, "multi", graph_multi)
    seen = []
    real_resume = sgd.resume

    def resume(save_dir, pass_id=-1):
        out = real_resume(save_dir, pass_id)
        want, slots, _s, _m = tckpt.load_pass(save_dir, pass_id)
        g = step.graphs
        assert sgd.params is g.params and sgd.opt_state is g.opt_state
        for name, v in want.items():
            assert np.array_equal(g.params[name].numpy(), v), name
            for slot, s in slots[name].items():
                assert np.array_equal(g.opt_state[name][slot].numpy(), s)
        seen.append(pass_id)
        return out

    monkeypatch.setattr(sgd, "resume", resume)
    costs = []
    sgd.train(_PassReader(), _tmlp_feed, num_passes=2,
              save_dir=str(tmp_path / "graphs"),
              event_handler=lambda e: costs.append(e.cost)
              if type(e).__name__ == "EndIteration" else None)
    assert seen == [0] and step.graphs_captured >= 1
    assert _ladder_events(sgd.last_watchdog_report) == _ladder_events(
        plain.last_watchdog_report)
    _assert_trees_equal(sgd.params, plain.params, "params")
    _assert_trees_equal(sgd.opt_state, plain.opt_state, "opt_state")


# ---- optimizers: static pruning and averaging ------------------------------


@needs_jax
def test_prune_mask_and_a_pruned_step_match_jax():
    rng = np.random.default_rng(0)
    v = rng.standard_normal((6, 5)).astype(np.float32)
    v[0, :3] = 0.0  # ties
    for ratio in (0.3, 0.5, 0.9):
        np.testing.assert_array_equal(
            tprune_mask(torch.from_numpy(v), ratio).numpy(),
            np.asarray(jprune_mask(jnp.asarray(v), ratio)))
    conf = _mlp(tdsl)
    pcs = dict(TNetwork(conf).param_confs)
    pcs["_h.w0"] = dataclasses.replace(pcs["_h.w0"], sparsity_ratio=0.5)
    topt = tcreate(TOptConf(**OPT), pcs)
    jpcs = dict(JNetwork(_mlp(jdsl)).param_confs)
    jpcs["_h.w0"] = dataclasses.replace(jpcs["_h.w0"], sparsity_ratio=0.5)
    jopt = jcreate(JOptConf(**OPT), jpcs)
    np_p = _mlp_np_params()
    tp = params_from_numpy(np_p, device="cpu")
    jp = {k: jnp.asarray(x) for k, x in np_p.items()}
    ts, js = topt.init_state(tp), jopt.init_state(jp)
    np.testing.assert_array_equal(ts["_h.w0"]["prune_mask"].numpy(),
                                  np.asarray(js["_h.w0"]["prune_mask"]))
    g = {k: rng.standard_normal(x.shape).astype(np.float32)
         for k, x in np_p.items()}
    for step in range(3):
        tp, ts = topt.update({k: torch.from_numpy(x) for k, x in g.items()},
                             tp, ts, step)
        jp, js = jopt.update({k: jnp.asarray(x) for k, x in g.items()}, jp,
                             js, step)
    mask = ts["_h.w0"]["prune_mask"]
    assert float(mask.sum()) == mask.numel() // 2
    assert torch.all(tp["_h.w0"][mask == 0] == 0)
    for k, x in tp.items():
        assert _rel(x.numpy(), jp[k]) <= NET_TOL, k


@needs_jax
def test_parameter_averager_matches_jax():
    rng = np.random.default_rng(2)
    ta, ja = TAverager(0.5, 3), JAverager(0.5, 3)
    seq = [{"w": rng.standard_normal(4).astype(np.float32)}
           for _ in range(7)]
    ts, js = ta.init({"w": torch.zeros(4)}), ja.init({"w": jnp.zeros(4)})
    for p in seq:
        ts = ta.accumulate(ts, {"w": torch.from_numpy(p["w"])})
        js = ja.accumulate(js, {"w": jnp.asarray(p["w"])})
        assert ts.count == js.count
        np.testing.assert_allclose(
            ta.average(ts, None)["w"].numpy(),
            np.asarray(ja.average(js, None)["w"]), rtol=1e-6)


def test_a_pruned_conf_trains_with_its_mask_as_a_slot():
    sgd = TSGD(_mlp(tdsl), TOptConf(**OPT), seed=1, device="cpu")
    pcs = dict(sgd.net.param_confs)
    pcs["_h.w0"] = dataclasses.replace(pcs["_h.w0"], sparsity_ratio=0.75)
    sgd.opt = tcreate(TOptConf(**OPT), pcs)
    sgd.opt_state = sgd.opt.init_state(sgd.params)
    sgd.step_fn.opt = sgd.opt
    mask = sgd.opt_state["_h.w0"]["prune_mask"].clone()
    for b in _mlp_batches(0):
        sgd.train_batch(_tmlp_feed(b))
    assert torch.equal(sgd.opt_state["_h.w0"]["prune_mask"], mask)
    assert torch.all(sgd.params["_h.w0"][mask == 0] == 0)


# ---- stats, timeline, profiler, infer --------------------------------------


@needs_jax
def test_stat_report_and_timeline_match_the_jax_text():
    from paddle_tpu.core.stat import StatSet as JStatSet
    from paddle_tpu.obs.timeline import StepTimeline as JTimeline
    from paddle_tpu_torch.core.stat import StatSet as TStatSet
    from paddle_tpu_torch.obs.timeline import StepTimeline as TTimeline

    ts, js = TStatSet("lifecycle_test"), JStatSet("lifecycle_test")
    for s in (ts, js):
        for dt in (0.5, 0.25):
            s.stat("train_step").add(dt)
        s.stat("checkpoint_save").add(1.0)
    assert ts.report() == js.report()
    ts.reset()
    assert ts.report() == "=== StatSet[lifecycle_test] ==="
    tt, jt = TTimeline(sample_period=4), JTimeline(sample_period=4)
    for t in (tt, jt):
        for i in range(8):
            t.add_data_wait(0.1)
            t.add_dispatch(0.2)
            t.add_device(0.3 if t.fence_now(i) else 0.1)
            t.step_done()
        t.add_checkpoint(0.4)
    assert tt.fractions() == jt.fractions() and tt.totals() == jt.totals()


def test_the_trainer_records_timeline_stats_and_spans(tmp_path):
    from paddle_tpu_torch.obs import metrics

    stream = metrics.enable_event_stream(str(tmp_path / "events.jsonl"))
    try:
        tflags.set_flag("timeline_sample_period", 2)
        sgd = _tmlp(_mlp_np_params(), 1)
        sgd.train(_PassReader(), _tmlp_feed, num_passes=1,
                  save_dir=str(tmp_path / "ck"))
        stream.flush()
    finally:
        metrics.get_registry().attach_stream(None)
    tl = sgd.last_timeline
    assert tl.steps == 8 and tl.totals()["checkpoint_stall"] > 0
    recs = [json.loads(ln) for ln in
            open(tmp_path / "events.jsonl").read().splitlines()]
    spans = [r for r in recs if r.get("kind") == "span"]
    assert {s["name"] for s in spans} >= {"train.step", "train.data_wait",
                                          "train.host_dispatch",
                                          "train.device_step",
                                          "train.checkpoint"}
    assert sum(s["name"] == "train.step" for s in spans) == 4
    assert any(r.get("kind") == "timeline" for r in recs)


def test_profiler_writes_a_trace(tmp_path):
    from paddle_tpu_torch.core import profiler

    @profiler.annotate_fn("twice")
    def twice(x):
        return x * 2

    with profiler.trace(str(tmp_path)):
        with profiler.scope("lifecycle_scope"):
            twice(torch.ones(3))
    text = (tmp_path / "trace.json").read_text()
    assert "lifecycle_scope" in text and "twice" in text


def test_v2_infer_matches_the_inferencer():
    from paddle_tpu_torch.inference import Inferencer, infer

    net = TNetwork(_mlp(tdsl))
    params = params_from_numpy(_mlp_np_params(), device="cpu")
    x = np.random.default_rng(0).standard_normal((3, 6)).astype(np.float32)
    got = infer(output="o", parameters=params, input={"x": x}, network=net,
                device="cpu")
    want = Inferencer(net, params, outputs=["o"], device="cpu").infer(
        {"x": targ.non_seq(x)})["o"]
    np.testing.assert_array_equal(got, want)


@needs_jax
def test_from_merged_infers_as_the_jax_inferencer(tmp_path):
    from paddle_tpu.trainer.trainer import Inferencer as JInferencer
    from paddle_tpu_torch.trainer.trainer import Inferencer as TInferencer

    np_p = _np_params()
    path = str(tmp_path / "m.npz")
    tckpt.merge_model(path, ttext.stacked_lstm_classifier(**CLS),
                      params_from_numpy(np_p, device="cpu"))
    batch = next(iter(_reader(treader)()))
    got = TInferencer.from_merged(path, device="cpu").infer(
        _feeder(tfeeder)(batch))
    want = JInferencer.from_merged(path).infer(_feeder(jfeeder)(batch))
    assert got.keys() == want.keys()
    for k in want:
        assert _rel(got[k], want[k]) <= NET_TOL


def test_async_snapshot_is_taken_before_the_next_step(tmp_path):
    """The trainer's async save hands the writer a snapshot: the pass on
    disk holds the params of the save, not of later steps."""
    sgd = _tmlp(_mlp_np_params(), 1)
    sgd.train(_PassReader(), _tmlp_feed, num_passes=1,
              save_dir=str(tmp_path), checkpoint_mode="async")
    want = {k: v.clone() for k, v in sgd.params.items()}
    for b in _mlp_batches(0)[:2]:
        sgd.train_batch(_tmlp_feed(b))
    sgd._async_ckpt.close()
    tree, meta = tactp.load_pass(str(tmp_path), 0)
    assert meta["global_step"] == 8
    for k, v in want.items():
        assert np.array_equal(tree["params"][k], v.numpy())
