"""Command line of the port: `python -m paddle_tpu_torch <cmd> ...`, the
JAX package's CLI (reference: paddle/scripts/submit_local.sh.in:3-13,
trainer/TrainerMain.cpp and trainer/MergeModel.cpp) with the same
output lines.

    python -m paddle_tpu_torch train --config conf.py [--job train|test|time]
        [--config_args a=1,b=2] [--save_dir D] [--num_passes N]
        [--log_period N] [--pass_id P] [--from_scratch] [--device cpu]
    python -m paddle_tpu_torch merge_model --config conf.py --model_dir D
        [--pass_id P] --output model.npz
    python -m paddle_tpu_torch infer --model model.npz [--example]
        [--device cpu]
    python -m paddle_tpu_torch dump_config --config conf.py [--config_args ..]
        [--output F]
    python -m paddle_tpu_torch version
    python -m paddle_tpu_torch serve --config conf.py [--port N]
        [--drain_timeout S]
    python -m paddle_tpu_torch metrics [--json] [--stream F [--spans]]
    python -m paddle_tpu_torch fleetz --addr [name=]host:port ... [--json]

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

An unmodified reference v1 config file (`settings(...)`, `from
paddle.trainer_config_helpers import *`, `define_py_data_sources2`,
`outputs(...)`; it binds no `get_config`) runs through `train` (all
three jobs) and `dump_config`: `compat/config_parser.py::parse_config`
execs it (its `paddle.*` imports resolve to the port's
`compat/v1_namespace/`), its provider module gives the reader and the
slot types, and `DataFeeder` + `batched` feed the trainer
(`_v1_setup`, the JAX CLI's).

A serving config defines `get_server() -> serving.server.InferenceServer`
with its models registered (and optionally `load_model(name, tag)` for
the `{"admin": "swap_model"}` frame). `serve` owns the TCP front end and
the drain-on-shutdown lifecycle: it prints `LISTENING <port>`, and on
SIGTERM/SIGINT stops admission, finishes or cleanly rejects in-flight
work, prints `DRAINED {stats}` and exits 0.

`metrics [--json] [--stream FILE [--spans [--top N]]]` prints this
process's registry snapshot or summarises a JSONL event stream another
process wrote; `fleetz --addr [name=]host:port ... [--json]` scrapes
live replicas' `metricz` twice and prints the merged fleet view (rc 1
while an alert is active). Neither needs a card.

`master CHUNKS... [--port P] [--snapshot F]` runs the elastic input
master (the JAX CLI's `cmd_master`) over the port's native build: one
task per recordio chunk, served over TCP to `data.master_client`
clients (it prints `LISTENING <port>`), snapshotted every 30 s and
on shutdown; restarted with an existing `--snapshot` it restores that
instead of adding the chunks again.
SIGTERM/SIGINT or a client's SHUTDOWN stops it.

Left out, still to port: the JAX CLI's `make_diagram` and `launch`
(ROADMAP A12) and `bench` (ROADMAP A10).
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
            f"{path} is a v1 config (it defines no get_config): `train` and "
            "`dump_config` read v1 configs, as the JAX CLI's do; the other "
            "commands take a get_config config (`make_diagram`, which "
            "reads v1 configs in the JAX CLI, is ROADMAP A12)")
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


def _v1_setup(config_path, config_args, which="train"):
    """(model, opt, batched reader, feeder, evaluators) from an
    unmodified v1 config: parse it once, load the data-provider module
    of the requested source (train or test), annotate the data layers'
    slot types from that provider's declaration, and wire the feeder by
    data-layer order (tuple samples) or by name (dict samples)."""
    from paddle_tpu_torch.compat.config_parser import (
        apply_data_types,
        parse_config,
    )
    from paddle_tpu_torch.data.feeder import DataFeeder
    from paddle_tpu_torch.data.reader import batched

    tc = parse_config(config_path, config_args)
    ds = tc.data_sources
    if ds is None or not getattr(ds, f"{which}_list"):
        raise SystemExit(
            f"{config_path} declares no {which} data source "
            "(define_py_data_sources2)")
    reader_creator, types = (ds.train_reader() if which == "train"
                             else ds.test_reader())
    apply_data_types(tc.model, types)
    data_names = [lc.name for lc in tc.model.layers if lc.type == "data"]
    # the config's inputs() declaration fixes the provider-slot order
    order = [n for n in (tc.model.input_layer_names or data_names)
             if n in data_names] or data_names
    if isinstance(types, dict):
        feeding = {n: n for n in types}
        type_map = dict(types)
    else:
        feeding = {n: i for i, n in enumerate(order)}
        type_map = dict(zip(order, types))
    feeder = DataFeeder(feeding, type_map)
    reader = batched(reader_creator, tc.opt.batch_size, drop_last=False)
    return tc.model, tc.opt, reader, feeder, tc.evaluators


def cmd_dump_config(args) -> int:
    if _is_v1_config(args.config):
        from paddle_tpu_torch.compat.config_parser import parse_config

        tc = parse_config(args.config, args.config_args)
        model_conf, opt_conf = tc.model, tc.opt
    else:
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
    # else drives the train source. The config is parsed once.
    which = "test" if args.job == "test" else "train"
    if _is_v1_config(args.config):
        # an unmodified v1 config: model, optimizer and data provider
        # all come from the file itself
        model_conf, opt_conf, reader, feeder, evaluators = _v1_setup(
            args.config, args.config_args, which)
    else:
        mod = _load_config(args.config)
        model_conf, opt_conf = mod.get_config()
        if which == "test":
            if not hasattr(mod, "test_reader"):
                raise SystemExit(
                    f"{args.config} must define test_reader() for "
                    "--job=test")
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


def cmd_metrics(args):
    """One-shot telemetry dump. Without arguments, prints
    the CURRENT process's registry snapshot (text or --json) — mostly
    useful from code or a REPL. With --stream FILE, summarizes a JSONL
    event stream another process wrote (enable_event_stream /
    METRICS_FILE): event counts by kind, watchdog rungs, the last
    per-pass timeline record. Needs no card: inspecting telemetry
    must not initialize a device runtime."""
    from paddle_tpu_torch.obs import metrics as om

    if args.spans:
        if not args.stream:
            raise SystemExit("--spans needs --stream FILE")
        return _metrics_spans(args)
    if args.stream:
        from paddle_tpu_torch.testing_faults import read_metrics_records

        recs = read_metrics_records(args.stream)
        kinds = {}
        for r in recs:
            kinds[r.get("kind", "?")] = kinds.get(r.get("kind", "?"), 0) + 1
        wd = {}
        for r in recs:
            if r.get("kind") == "watchdog":
                wd[r["event"]] = wd.get(r["event"], 0) + 1
        timelines = [r for r in recs if r.get("kind") == "timeline"]
        summary = {
            "stream": args.stream,
            "events": len(recs),
            "by_kind": kinds,
            "watchdog_events": wd,
            "last_timeline": timelines[-1] if timelines else None,
        }
        if args.json:
            print(json.dumps(summary, indent=2))
        else:
            print(f"event stream {args.stream}: {len(recs)} events")
            for k, n in sorted(kinds.items()):
                print(f"  {k:20s} {n}")
            if wd:
                print("watchdog ladder:")
                for k, n in sorted(wd.items()):
                    print(f"  {k:20s} {n}")
            if timelines:
                t = timelines[-1]
                print(
                    "last timeline: pass %s step %s  "
                    "data_wait=%.1f%% host=%.1f%% device=%.1f%% "
                    "ckpt=%.1f%%" % (
                        t.get("pass_id"), t.get("global_step"),
                        100 * t.get("data_wait_frac", 0),
                        100 * t.get("host_overhead_frac", 0),
                        100 * t.get("device_frac", 0),
                        100 * t.get("checkpoint_stall_frac", 0),
                    )
                )
        return 0
    reg = om.get_registry()
    if args.json:
        print(json.dumps(reg.snapshot(), indent=2))
    else:
        print(reg.render_text())
    return 0


def _metrics_spans(args):
    """`metrics --stream FILE --spans`: per-span-name count/p50/p99
    table plus the top-N slowest traces, computed from the span events
    on a JSONL stream. Needs no card — span analytics must run on any
    box the stream was copied to."""
    from paddle_tpu_torch.testing_faults import read_metrics_records

    spans = read_metrics_records(args.stream, kind="span")
    if not spans:
        print(f"event stream {args.stream}: no span events")
        return 0

    def pctl(sorted_vals, q):
        return sorted_vals[int(q * (len(sorted_vals) - 1))]

    by_name = {}
    for s in spans:
        by_name.setdefault(s.get("name", "?"), []).append(
            float(s.get("dur_s", 0.0))
        )
    rows = []
    for name, durs in by_name.items():
        durs.sort()
        rows.append({
            "name": name,
            "count": len(durs),
            "p50_ms": round(pctl(durs, 0.50) * 1e3, 3),
            "p99_ms": round(pctl(durs, 0.99) * 1e3, 3),
            "max_ms": round(durs[-1] * 1e3, 3),
        })
    rows.sort(key=lambda r: r["p99_ms"] * r["count"], reverse=True)

    # slowest traces: each trace scored by its root span (no parent
    # within the trace), falling back to its longest span. Root
    # semantics mirror tools/trace_view.py::_root_of — that file must
    # stay standalone-stdlib (copyable to any box without this
    # package), so the few lines are duplicated, not imported; change
    # both together.
    by_trace = {}
    for s in spans:
        by_trace.setdefault(s.get("trace_id", "?"), []).append(s)
    traces = []
    for tid, group in by_trace.items():
        ids = {g.get("span_id") for g in group}
        roots = [g for g in group
                 if g.get("parent_id", "") not in ids]
        root = max(roots or group,
                   key=lambda g: float(g.get("dur_s", 0.0)))
        traces.append({
            "trace_id": tid,
            "root": root.get("name"),
            "dur_ms": round(float(root.get("dur_s", 0.0)) * 1e3, 3),
            "spans": len(group),
            "status": root.get("status", "ok"),
        })
    traces.sort(key=lambda t: t["dur_ms"], reverse=True)
    traces = traces[: args.top]

    if args.json:
        print(json.dumps(
            {"stream": args.stream, "span_count": len(spans),
             "by_name": rows, "slowest_traces": traces}, indent=2,
        ))
        return 0
    print(f"event stream {args.stream}: {len(spans)} spans")
    print(f"{'span':28s} {'count':>7s} {'p50_ms':>10s} "
          f"{'p99_ms':>10s} {'max_ms':>10s}")
    for r in rows:
        print(f"{r['name']:28s} {r['count']:7d} {r['p50_ms']:10.3f} "
              f"{r['p99_ms']:10.3f} {r['max_ms']:10.3f}")
    print(f"top {len(traces)} slowest traces:")
    for t in traces:
        print(f"  {t['trace_id'][:16]:16s} {t['root'] or '?':24s} "
              f"{t['dur_ms']:10.3f} ms  {t['spans']:4d} spans  "
              f"{t['status']}")
    return 0


def cmd_fleetz(args):
    """Live fleet snapshot: scrape every replica's metricz
    twice, `--interval` apart, merge the snapshots into one fleet
    view (counters summed, histograms merged bucket-wise), and print
    a per-replica health table + fleet quantiles + active threshold
    breaches. Needs no card, like `metrics`: the operator box watching
    a fleet must not need a device runtime."""
    import time as _t

    from paddle_tpu_torch.obs import aggregate as agg
    from paddle_tpu_torch.serving.tcp import ServeClient

    replicas = {}
    for i, spec in enumerate(args.addr):
        if "=" in spec:
            name, _, a = spec.partition("=")
        else:
            name, a = f"r{i}", spec
        replicas[name] = a

    def scrape():
        snaps, stats, errors = {}, {}, {}
        for name, a in replicas.items():
            try:
                c = ServeClient(a, retries=0,
                                admin_timeout=args.timeout)
                resp = c.metricz()
                c.close()
                snaps[name] = resp.get("metricz", {})
                stats[name] = resp.get("stats", {})
            except Exception as e:
                errors[name] = f"{type(e).__name__}: {e}"
        return snaps, stats, errors

    t0 = _t.time()
    first, _, _ = scrape()
    _t.sleep(args.interval)
    second, stats, errors = scrape()
    dt = _t.time() - t0

    both = {n: s for n, s in second.items() if n in first}
    prev = agg.merge_snapshots({n: first[n] for n in both})
    cur = agg.merge_snapshots(second)
    delta = agg.snapshot_delta(prev, cur)
    rates = agg.counter_rates(delta, dt)

    family_sum = agg.family_total

    def merged_latency(histograms):
        """All serving.admitted_latency_s series (one per model)
        folded into one distribution."""
        return agg.family_histogram(histograms,
                                    "serving.admitted_latency_s")

    table = []
    for name in sorted(replicas):
        if name in errors:
            table.append({"replica": name, "up": False,
                          "error": errors[name]})
            continue
        st = stats.get(name, {}) or {}
        dsnap = agg.snapshot_delta(
            agg.merge_snapshots({name: first.get(name, {})}),
            agg.merge_snapshots({name: second.get(name, {})}),
        )
        admitted = family_sum(dsnap["counters"], "serving.admitted")
        shed = family_sum(dsnap["counters"], "serving.shed")
        total = admitted + shed
        lat = merged_latency(dsnap["histograms"])
        p99 = agg.quantile(lat, 0.99) if lat else None
        table.append({
            "replica": name,
            "up": True,
            "queue_depth": st.get("queue_depth"),
            "admitted": admitted,
            "shed": shed,
            "shed_frac": round(shed / total, 4) if total else 0.0,
            "p99_ms": round(p99 * 1e3, 3) if p99 is not None else None,
        })

    fleet_lat = merged_latency(delta["histograms"])
    fleet = {
        "replicas_up": sum(1 for r in table if r.get("up")),
        "replicas_down": sum(1 for r in table if not r.get("up")),
        "admitted_rate_rps": round(
            family_sum(rates, "serving.admitted"), 3),
        "shed_rate_rps": round(family_sum(rates, "serving.shed"), 3),
        "p50_ms": None,
        "p99_ms": None,
    }
    for q, key in ((0.50, "p50_ms"), (0.99, "p99_ms")):
        v = agg.quantile(fleet_lat, q) if fleet_lat else None
        fleet[key] = round(v * 1e3, 3) if v is not None else None

    alerts = []
    for r in table:
        if not r.get("up"):
            alerts.append({"alert": "replica_down",
                           "replica": r["replica"]})
            continue
        if args.slo_ms > 0 and r.get("p99_ms") is not None \
                and r["p99_ms"] > args.slo_ms:
            alerts.append({"alert": "p99_slo", "replica": r["replica"],
                           "p99_ms": r["p99_ms"],
                           "slo_ms": args.slo_ms})
        if r.get("shed_frac", 0.0) > args.shed_threshold:
            alerts.append({"alert": "shedding", "replica": r["replica"],
                           "shed_frac": r["shed_frac"]})

    if args.json:
        print(json.dumps({"interval_s": round(dt, 3),
                          "replicas": table, "fleet": fleet,
                          "alerts": alerts}, indent=2))
        return 1 if alerts else 0
    print(f"fleet of {len(replicas)} replicas "
          f"({fleet['replicas_up']} up), {dt:.1f}s window")
    print(f"{'replica':12s} {'state':6s} {'queue':>6s} {'adm':>8s} "
          f"{'shed':>8s} {'shed%':>7s} {'p99_ms':>9s}")
    for r in table:
        if not r.get("up"):
            print(f"{r['replica']:12s} {'DOWN':6s} {r['error']}")
            continue
        p99 = f"{r['p99_ms']:9.3f}" if r["p99_ms"] is not None \
            else f"{'-':>9s}"
        print(f"{r['replica']:12s} {'up':6s} "
              f"{str(r['queue_depth'] if r['queue_depth'] is not None else '-'):>6s} "
              f"{r['admitted']:8.0f} {r['shed']:8.0f} "
              f"{100 * r['shed_frac']:6.1f}% {p99}")
    print(f"fleet: {fleet['admitted_rate_rps']} rps admitted, "
          f"{fleet['shed_rate_rps']} rps shed, "
          f"p50={fleet['p50_ms']} ms p99={fleet['p99_ms']} ms "
          f"(merged buckets)")
    if alerts:
        print("active alerts:")
        for a in alerts:
            print("  " + json.dumps(a))
    else:
        print("no active alerts")
    return 1 if alerts else 0


def cmd_master(args) -> int:
    import os

    from paddle_tpu_torch.data.master_serve import serve_until_stopped
    from paddle_tpu_torch.native.master import Master
    from paddle_tpu_torch.native.recordio import count_chunks

    if args.snapshot and os.path.exists(args.snapshot):
        m = Master.restore(args.snapshot)
        m.set_lease(args.timeout)
        print(f"elastic master restored from {args.snapshot}: {m.counts}",
              flush=True)
    else:
        m = Master(lease_seconds=args.timeout, failure_max=args.failure_max)
        total = 0
        for path in args.chunks:
            n = count_chunks(path)
            m.add_chunk_tasks(path, n)
            total += n
        print(f"elastic master over {len(args.chunks)} files / {total} "
              f"chunk tasks", flush=True)
    # every 30 s, as the JAX command's loop
    return serve_until_stopped(m, args.port, args.snapshot, 30.0)


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(prog="python -m paddle_tpu_torch")
    sub = parser.add_subparsers(dest="cmd", required=True)

    p = sub.add_parser("train", help="train a config")
    p.add_argument("--config", required=True)
    p.add_argument("--config_args", default="",
                   help="v1 config interpolation, e.g. batch_size=64")
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
    p.add_argument("--config_args", default="")
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

    p = sub.add_parser(
        "metrics",
        help="one-shot telemetry snapshot (process registry, or "
             "--stream FILE to summarize a JSONL event stream)",
    )
    p.add_argument("--json", action="store_true",
                   help="JSON instead of text")
    p.add_argument("--stream", default="",
                   help="summarize this JSONL event-stream file "
                        "instead of the in-process registry")
    p.add_argument("--spans", action="store_true",
                   help="with --stream: per-span-name count/p50/p99 "
                        "table and the top-N slowest traces")
    p.add_argument("--top", type=int, default=10,
                   help="with --spans: slowest traces to list")
    p.set_defaults(fn=cmd_metrics)

    p = sub.add_parser(
        "fleetz",
        help="live fleet snapshot: scrape replicas' metricz, merge "
             "into one fleet view (per-replica health table, fleet "
             "p50/p99 from merged buckets, active alerts)",
    )
    p.add_argument("--addr", action="append", required=True,
                   help="replica address, repeatable: host:port or "
                        "name=host:port")
    p.add_argument("--interval", type=float, default=1.0,
                   help="seconds between the two scrapes the "
                        "delta/rate view is computed over")
    p.add_argument("--timeout", type=float, default=2.0,
                   help="per-replica scrape timeout")
    p.add_argument("--slo-ms", type=float, default=0.0,
                   dest="slo_ms",
                   help="admitted-p99 SLO in ms (0 = no p99 alert)")
    p.add_argument("--shed-threshold", type=float, default=0.5,
                   dest="shed_threshold",
                   help="per-replica shed-fraction alert threshold")
    p.add_argument("--json", action="store_true")
    p.set_defaults(fn=cmd_fleetz)

    p = sub.add_parser("master", help="run the elastic input master")
    p.add_argument("chunks", nargs="+", help="recordio files")
    p.add_argument("--timeout", type=float, default=60.0,
                   help="task lease seconds")
    p.add_argument("--failure_max", type=int, default=3)
    p.add_argument("--snapshot", default="",
                   help="snapshot file; restored on start if it exists")
    p.add_argument("--port", type=int, default=0,
                   help="TCP port (0 = ephemeral, printed as "
                        "LISTENING <port>)")
    p.set_defaults(fn=cmd_master)

    p = sub.add_parser("version", help="print versions")
    p.set_defaults(fn=cmd_version)

    args = parser.parse_args(argv)
    return args.fn(args)


if __name__ == "__main__":
    sys.exit(main())
