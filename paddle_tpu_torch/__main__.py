"""Command line of the port: `python -m paddle_tpu_torch <cmd> ...`, the
JAX package's CLI (reference: paddle/scripts/submit_local.sh.in:3-13,
trainer/TrainerMain.cpp and trainer/MergeModel.cpp) with the same
output lines.

    python -m paddle_tpu_torch train --config conf.py [--job train|test|time]
        [--save_dir D] [--num_passes N] [--log_period N] [--pass_id P]
        [--from_scratch] [--device cpu]
    python -m paddle_tpu_torch merge_model --config conf.py --model_dir D
        [--pass_id P] --output model.npz
    python -m paddle_tpu_torch infer --model model.npz [--example]
        [--device cpu]
    python -m paddle_tpu_torch dump_config --config conf.py [--output F]
    python -m paddle_tpu_torch version
    python -m paddle_tpu_torch serve --config conf.py [--port N]
        [--drain_timeout S]

A training config file is a Python source that defines
`get_config() -> (ModelConf, OptimizationConf)`, `train_reader()` and
`test_reader()` (batched sample readers), `feeder(batch)` (a feed dict
of Args) and optionally `evaluators` (evaluator config dicts); it may
set flags (`core/flags.py`: `steps_per_dispatch`, `checkpoint_mode`,
...). `train` auto-resumes from the newest complete checkpoint in
`--save_dir` (a mid-pass preemption flush resumes at its batch) and
prints `resuming from ...`; on SIGTERM it flushes a checkpoint, prints
`PREEMPTED pass P batch B` and exits 75; when the watchdog runs out of
rungs it prints `WATCHDOG_ABORT {report}` and exits 1. Training and
inference run on the card unless `--device cpu` is given.

A serving config defines `get_server() -> serving.server.InferenceServer`
with its models registered (and optionally `load_model(name, tag)` for
the `{"admin": "swap_model"}` frame). `serve` owns the TCP front end and
the drain-on-shutdown lifecycle: it prints `LISTENING <port>`, and on
SIGTERM/SIGINT stops admission, finishes or cleanly rejects in-flight
work, prints `DRAINED {stats}` and exits 0.

Left out, still to port: reference v1 config files (`settings()` /
`outputs()` sources without `get_config`, the compat front end of
ROADMAP A9/A12 — such a file is refused with that message), and the JAX
CLI's `master`, `metrics`, `fleetz`, `make_diagram`, `bench` and
`launch` commands.
"""

from __future__ import annotations

import argparse
import importlib.util
import json
import signal
import sys
import time


def _load_config(path: str):
    if _is_v1_config(path):
        raise SystemExit(
            f"{path} is a v1 config (it defines no get_config): the port "
            "does not read v1 configs yet — their compat front end is "
            "ROADMAP A9/A12")
    spec = importlib.util.spec_from_file_location("_paddle_config", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _is_v1_config(path: str) -> bool:
    """A config is v2-native iff its module BINDS the name `get_config`
    at top level (def / assignment / import); everything else is an
    unmodified v1 file. Decided from the AST, as the JAX CLI does."""
    import ast

    with open(path) as f:
        try:
            tree = ast.parse(f.read(), path)
        except SyntaxError:
            return True  # py2-era source: certainly a v1 config

    def target_binds(t) -> bool:
        if isinstance(t, ast.Name):
            return t.id == "get_config"
        if isinstance(t, (ast.Tuple, ast.List)):
            return any(target_binds(e) for e in t.elts)
        if isinstance(t, ast.Starred):
            return target_binds(t.value)
        return False

    # bindings anywhere at module scope count, including under try/if;
    # class/function bodies don't bind module names
    def binds(node) -> bool:
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
            return node.name == "get_config"
        if isinstance(node, ast.ClassDef):
            return False
        if isinstance(node, ast.Assign) and any(
                target_binds(t) for t in node.targets):
            return True
        if isinstance(node, (ast.AnnAssign, ast.AugAssign)) and \
                target_binds(node.target):
            return True
        if isinstance(node, (ast.With, ast.AsyncWith)) and any(
                item.optional_vars is not None
                and target_binds(item.optional_vars)
                for item in node.items):
            return True
        if isinstance(node, (ast.For, ast.AsyncFor)) and \
                target_binds(node.target):
            return True
        if isinstance(node, ast.NamedExpr) and target_binds(node.target):
            return True
        if isinstance(node, (ast.Import, ast.ImportFrom)) and any(
                (alias.asname or alias.name) == "get_config"
                for alias in node.names):
            return True
        return any(binds(c) for c in ast.iter_child_nodes(node))

    return not any(binds(node) for node in tree.body)


def cmd_version(args) -> int:
    import torch

    from paddle_tpu_torch import __version__

    print(f"paddle_tpu_torch {__version__}")
    devices = [torch.cuda.get_device_name(i)
               for i in range(torch.cuda.device_count())]
    print(f"torch {torch.__version__} (cuda {torch.version.cuda}), "
          f"devices: {devices}")
    return 0


def cmd_dump_config(args) -> int:
    mod = _load_config(args.config)
    model_conf, opt_conf = mod.get_config()
    doc = {
        "model": json.loads(model_conf.to_json()),
        "optimization": vars(opt_conf),
    }
    out = json.dumps(doc, indent=2, default=str)
    if args.output:
        with open(args.output, "w") as f:
            f.write(out)
    else:
        print(out)
    return 0


def cmd_train(args) -> int:
    from paddle_tpu_torch.trainer import events
    from paddle_tpu_torch.trainer import watchdog as wdg
    from paddle_tpu_torch.trainer.trainer import SGD

    # --job=test needs only the config's test data source; everything
    # else drives the train source
    mod = _load_config(args.config)
    model_conf, opt_conf = mod.get_config()
    if args.job == "test":
        if not hasattr(mod, "test_reader"):
            raise SystemExit(
                f"{args.config} must define test_reader() for --job=test")
        reader = mod.test_reader()
    else:
        reader = mod.train_reader()
    feeder = getattr(mod, "feeder", None)
    if feeder is None:
        raise SystemExit(f"{args.config} must define feeder(batch)")
    evaluators = getattr(mod, "evaluators", None) or []
    trainer = SGD(model_conf, opt_conf, evaluators=evaluators,
                  device=args.device)

    if args.job == "test":
        # evaluation-only pass (trainer/Tester.h), optionally on a saved
        # checkpoint (--save_dir/--pass_id)
        if args.save_dir:
            trainer.resume(args.save_dir, args.pass_id)
        res = trainer.test(reader, feeder)
        print(f"test cost {res['cost']:.6f} "
              + " ".join(f"{k}={v}" for k, v in res["evaluators"].items()))
        return 0

    if args.job == "time":
        # --job=time (trainer/TrainerBenchmark.cpp): warm up, then
        # report ms/batch over the next batches
        want = args.time_batches + 5
        batches = []
        while len(batches) < want:
            got_any = False
            for b in reader():
                got_any = True
                batches.append(b)
                if len(batches) == want:
                    break
            if not got_any:  # empty source: error out, don't spin
                raise SystemExit("data source produced no batches")
        feeds = [feeder(b) for b in batches]
        for f in feeds[:5]:  # warm-up
            trainer.train_batch(f)
        t0 = time.perf_counter()
        for f in feeds[5:]:
            trainer.train_batch(f)
        n = len(feeds) - 5
        ms = (time.perf_counter() - t0) / max(n, 1) * 1e3
        print(f"time: {ms:.3f} ms/batch over {n} batches")
        return 0

    def handler(ev):
        if isinstance(ev, events.EndIteration) and (
                ev.batch_id % args.log_period == 0):
            print(f"pass {ev.pass_id} batch {ev.batch_id} "
                  f"cost {ev.cost:.6f}", flush=True)

    # auto-resume: a respawned (preempted or crashed) worker picks up
    # from the newest complete checkpoint in save_dir, including a
    # mid-pass preemption flush (--from_scratch opts out)
    start_pass = 0
    if args.save_dir and not args.from_scratch:
        try:
            start_pass = trainer.resume(args.save_dir)
            print(f"resuming from {args.save_dir}: start pass "
                  f"{start_pass}, skip {trainer._resume_skip_batches} "
                  f"batches", flush=True)
        except (FileNotFoundError, ValueError):
            pass  # no (complete) checkpoint yet: fresh start
    try:
        trainer.train(
            reader=reader,
            feeder=feeder,
            num_passes=args.num_passes,
            event_handler=handler,
            save_dir=args.save_dir or None,
            start_pass=start_pass,
        )
    except wdg.Preempted as p:
        # checkpoint flushed: exit EXIT_PREEMPTED (75), and a respawn
        # resumes losslessly
        print(f"PREEMPTED pass {p.pass_id} batch {p.batches_done}",
              flush=True)
        return wdg.EXIT_PREEMPTED
    except wdg.WatchdogAbort as a:
        print("WATCHDOG_ABORT " + json.dumps(a.report.to_dict()),
              flush=True)
        return 1
    return 0


def cmd_merge_model(args) -> int:
    from paddle_tpu_torch.trainer import checkpoint as ckpt

    mod = _load_config(args.config)
    model_conf, _ = mod.get_config()
    params, _, state, _ = ckpt.load_pass(args.model_dir, args.pass_id)
    ckpt.merge_model(args.output, model_conf, params, state)
    print(f"merged {args.model_dir} (pass {args.pass_id}) -> {args.output}")
    return 0


def cmd_infer(args) -> int:
    import numpy as np

    from paddle_tpu_torch.core.arg import id_arg, non_seq, seq
    from paddle_tpu_torch.trainer.trainer import Inferencer

    inf = Inferencer.from_merged(args.model, device=args.device)
    print(f"outputs: {inf.output_names}")
    if args.example:
        # feed zero batches of the declared shapes as a smoke test
        feed = {}
        T = 4  # time steps for sequence inputs
        for lc in inf.net.conf.layers:
            if lc.type != "data":
                continue
            a = lc.attrs
            is_seq = a.get("is_seq", False)
            lead = (args.batch, T) if is_seq else (args.batch,)
            lens = np.full(args.batch, T, np.int32) if is_seq else None
            if a.get("is_ids"):
                feed[lc.name] = id_arg(np.zeros(lead, np.int64), lens)
            else:
                value = np.zeros(lead + tuple(a["dim"]), np.float32)
                feed[lc.name] = (seq(value, lens) if is_seq
                                 else non_seq(value))
        outs = inf.infer(feed)
        for n, v in outs.items():
            print(f"{n}: shape {v.shape}")
    return 0


def cmd_serve(args) -> int:
    from paddle_tpu_torch.serving.tcp import ServingTCPServer

    spec = importlib.util.spec_from_file_location("_serve_config",
                                                  args.config)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    if not hasattr(mod, "get_server"):
        raise SystemExit(
            f"{args.config} must define get_server() -> InferenceServer"
        )
    server = mod.get_server()
    tcp = ServingTCPServer(server, port=args.port,
                           model_loader=getattr(mod, "load_model", None))
    print(f"LISTENING {tcp.port}", flush=True)

    stopping = []
    signal.signal(signal.SIGTERM, lambda *_: stopping.append(1))
    signal.signal(signal.SIGINT, lambda *_: stopping.append(1))
    try:
        while not stopping:
            time.sleep(0.1)
    finally:
        # stop NEW connections first, drain with established clients
        # still attached (their in-flight responses must land), then
        # close what remains
        tcp.stop_accepting()
        server.shutdown(drain=True, timeout=args.drain_timeout)
        tcp.stop(drain=True)
        print("DRAINED " + json.dumps(server.stats()), flush=True)
    return 0


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(prog="python -m paddle_tpu_torch")
    sub = parser.add_subparsers(dest="cmd", required=True)

    p = sub.add_parser("train", help="train a config")
    p.add_argument("--config", required=True)
    p.add_argument("--job", choices=["train", "time", "test"],
                   default="train",
                   help="time = ms/batch harness (TrainerBenchmark.cpp); "
                        "test = evaluation pass (Tester.h)")
    p.add_argument("--time_batches", type=int, default=10)
    p.add_argument("--pass_id", type=int, default=-1,
                   help="with --job=test --save_dir: checkpoint pass")
    p.add_argument("--num_passes", type=int, default=1)
    p.add_argument("--save_dir", default="")
    p.add_argument("--log_period", type=int, default=10)
    p.add_argument("--from_scratch", action="store_true",
                   help="ignore existing checkpoints in --save_dir "
                        "instead of auto-resuming")
    p.add_argument("--device", default=None,
                   help="torch device (default: the card; 'cpu' to run "
                        "on the CPU)")
    p.set_defaults(fn=cmd_train)

    p = sub.add_parser("dump_config", help="print config as JSON")
    p.add_argument("--config", required=True)
    p.add_argument("--output", default="")
    p.set_defaults(fn=cmd_dump_config)

    p = sub.add_parser("merge_model", help="pack config+weights")
    p.add_argument("--config", required=True)
    p.add_argument("--model_dir", required=True)
    p.add_argument("--pass_id", type=int, default=-1)
    p.add_argument("--output", required=True)
    p.set_defaults(fn=cmd_merge_model)

    p = sub.add_parser("infer", help="load a merged model")
    p.add_argument("--model", required=True)
    p.add_argument("--example", action="store_true",
                   help="run a zero-batch smoke forward")
    p.add_argument("--batch", type=int, default=1)
    p.add_argument("--device", default=None,
                   help="torch device (default: the card)")
    p.set_defaults(fn=cmd_infer)

    p = sub.add_parser("serve", help="run the inference server over TCP")
    p.add_argument("--config", required=True,
                   help="python file defining get_server()")
    p.add_argument("--port", type=int, default=0,
                   help="TCP port (0 = any free port)")
    p.add_argument("--drain_timeout", type=float, default=30.0,
                   help="seconds to finish in-flight work on shutdown")
    p.set_defaults(fn=cmd_serve)

    p = sub.add_parser("version", help="print versions")
    p.set_defaults(fn=cmd_version)

    args = parser.parse_args(argv)
    return args.fn(args)


if __name__ == "__main__":
    sys.exit(main())
