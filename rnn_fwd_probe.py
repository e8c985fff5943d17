#!/usr/bin/env python3
"""B5 and B7 of `paddle_tpu_torch/csrc/{lstm,gru}_seq.cu` in turns against
another revision of the same files, the serial floor of the cluster walk,
and where a call's device time goes.

    mkdir -p _archive
    for f in lstm_seq.cu gru_seq.cu rnn_common.cuh tf32_mma.cuh; do
      git show <rev>:paddle_tpu_torch/csrc/$f > _archive/$f; done
    python3 rnn_fwd_probe.py _archive          # the cluster routes
    python3 rnn_fwd_probe.py grid _archive     # B5's grid route
    python3 rnn_fwd_probe.py gru_grid _archive # B7's grid route
    git archive <rev> | tar -x -C _parent      # a whole checkout
    python3 rnn_fwd_probe.py step _parent      # phase 13's training run

Needs one CUDA card and nvcc. The other revision's entry points may take
no route (the walks only), the route alone, or the route and the route
taken (`rnn_bwd_probe.signature` tells them apart), and a scratch
pointer or none (`rnn_bwd_probe.scratch_floats`).
At the two path shapes of `chip_smoke.py`'s phase 10 (the classifier's
LSTM layer, B=64, T=100, h=256; the NMT encoder's GRU, B=256, T=32,
h=256) it prints one `case` JSON line each:
- the plan of this revision (route, rows a cluster, clusters, and the
  clusters the card holds at once; also printed first for B = 8 .. 512);
- max |diff| / max |plain| of y (and c) of both revisions;
- ms of the other revision's call, of this revision's call on the route
  its rule picks and on its other route (the grid route), of the LSTM's
  inference variant (no c), and of this
  revision built with -DRNN_SERIAL_FLOOR (the cluster walk keeps only
  its pushes of h and its cluster barriers), timed in turns (CUDA
  events, 20 calls each);
- the device ms a call of each kernel (torch.profiler over 10 calls);
  the floor build's over T is the serial floor a step;
- ms of this revision with one piece of the walk taken out or changed by
  a text substitution (`VARIANTS`; wrong results, timed only), in turns
  with this revision.
`grid` mode instead times B5 at `rnn_bwd_probe.GRID_CASES` (B=64, T=100,
h = 512 and 1280), where the rule takes the grid route: the other
revision's call (the walk, in a revision before the grid route), this
revision's with c and without (inference), and this revision built with
-DRNN_SERIAL_FLOOR (the grid walk keeps only its stores and loads of h
and its barriers), in turns; their device ms by kernel; the floor a step.
`gru_grid` mode does the same for B7 at `rnn_bwd_probe.GRU_GRID_CASES`
(B=256, T=32, h = 512 and 1280; B=80, T=50, h = 1000): the other
revision's call (the walk, in a revision before the GRU's grid route),
this revision's, and its floor (the exchanges of r * h and h and the two
barriers a step); the floor a step is over T.
`step` mode instead runs phase 13's classifier training (`chip_smoke.py`
`text_train`, the kernel arm: CLS_STEPS adam steps through SGD at B=64,
T=100, h=256, the cluster route) in another revision's checkout and in
this one, each in a process of its own, in turns (other, this, this,
other; each tree builds its kernels on its first run): ms a step (the
median, host clock), and the profile's device ms a step and idle share.
Every build runs at once (one nvcc each). The ptxas report of every build
is appended to `chiprun_out/rnn_fwd_probe.txt`, with every line printed
here.
"""

from __future__ import annotations

import ctypes
import json
import os
import subprocess
import sys

import chip_smoke as cs
import rnn_bwd_probe as bp

CASES = bp.CASES
# step mode's run, in the checkout it is started in
STEP = """
import json, torch
import chip_smoke as cs
from paddle_tpu_torch.ops import rnn
torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False
conf, _ = cs.text_confs()
feed, _ = cs.text_feeds(cs.SEED + 80, ragged=False)
cs.set_rnn_arm("kernels")
r = cs.text_train(torch, rnn, conf, feed, cs.CLS_LR, cs.CLS_STEPS,
                  cs.CLS_B * cs.CLS_T, "classifier")
print("STEP " + json.dumps(r))
"""
OUT = os.path.join("chiprun_out", "rnn_fwd_probe.txt")
# name: [(file of csrc, text, its substitute)], applied to both cells'
# sources where the text occurs
VARIANTS = {
    # the per-step products do no arithmetic (their loads neither)
    "no_product": [("rnn_common.cuh",
                    "for (int c0 = 8 * SETS * share; c0 < K;",
                    "for (int c0 = 8 * SETS * share; c0 < 0;")],
    # no cell (no exp, tanh, h, c)
    "no_cell": [(f, "for (int pr = threadIdx.x; pr < RU && !kSerialFloor; "
                 "pr += NTC) {", "for (int pr = threadIdx.x; pr < 0; "
                 "pr += NTC) {") for f in ("lstm_seq.cu", "gru_seq.cu")],
    # no exchange of h (and r * h) between the blocks
    "no_push": [("rnn_common.cuh", "e < (CL - 1) * n4;", "e < 0;")],
    # no stores of y (and c) in the walk
    "no_store": [(f, "e < RU && !kSerialFloor", "e < 0")
                 for f in ("lstm_seq.cu", "gru_seq.cu")],
    # the products in one TF32 pass (hi x hi) instead of three
    "one_pass": [("rnn_common.cuh",
                  "mma_tf32(acc[s][j], alo[s], bhi[s][j]);", ""),
                 ("rnn_common.cuh",
                  "mma_tf32(acc[s][j], ahi[s], blo[s][j]);", "")],
    # the depth of each product in one share: half the warps idle at h 256
    "one_share": [("rnn_common.cuh", "int s = (NTC / 32) / tiles;",
                   "int s = 1;")],
}


def bind(lib, cell):
    fn = getattr(lib, f"{cell}_seq_fwd")
    scratch = hasattr(lib, f"{cell}_seq_scratch_floats")
    fn.argtypes = ([ctypes.c_void_p] * (6 + scratch)
                   + bp.tail_types(lib, cell, "fwd"))
    fn.restype = ctypes.c_int
    return lib


def call(torch, lib, cell, ins, b, t, h, route, want_c=True):
    """A zero-argument call of `lib`'s forward at `route` (ignored by a
    build whose forward has no route) into fresh outputs, and the
    outputs."""
    outs = [torch.empty_like(r) for r in ins["ref"]]
    if not want_c:
        outs = outs[:1]
    ptrs = [a.data_ptr() for a in (*ins["args"], *outs)]
    if cell == "lstm" and not want_c:
        ptrs.append(None)
    floats = bp.scratch_floats(lib, cell, "fwd", b, t, h, route)
    scratch = None
    if floats is not None:
        scratch = torch.empty(max(floats, 1), device="cuda")
        ptrs.append(scratch.data_ptr())
    tail = bp.tail_args(lib, cell, "fwd", route)
    fn = getattr(lib, f"{cell}_seq_fwd")

    def run(_keep=scratch):   # the scratch lives as long as the call
        rc = fn(*ptrs, b, t, h, *tail, 0,
                torch.cuda.current_stream().cuda_stream)
        assert rc == 0, rc

    return run, outs


def grid_mode(torch, archive, cell="lstm"):
    """B5 (`cell` "lstm") at GRID_CASES or B7 ("gru") at GRU_GRID_CASES:
    the other revision (the walk, before the cell's grid route), this
    revision's grid route (B5: with c and without), and its serial floor,
    in turns (see the module docstring)."""
    from paddle_tpu_torch.ops import _build
    from paddle_tpu_torch.ops import rnn

    kern = f"{cell}_seq"
    lstm = cell == "lstm"
    out_dir = os.path.join(_build.BUILD_DIR, "grid_fwd_probe")
    os.makedirs(out_dir, exist_ok=True)
    nvcc, flags = _build._nvcc(), _build.NVCC_FLAGS
    builds = {
        "other": bp.start(nvcc, flags, os.path.join(archive, f"{kern}.cu"),
                          os.path.join(out_dir, f"{cell}_other.so")),
        "floor": bp.start(nvcc, (*flags, "-DRNN_SERIAL_FLOOR"),
                          _build.sources()[kern],
                          os.path.join(out_dir, f"{cell}_floor.so"))}
    libs = {"this": bind(_build.load(kern), cell)}
    libs.update({k: bind(bp.finish(st), cell) for k, st in builds.items()})
    gen = torch.Generator(device="cuda").manual_seed(cs.SEED + 8)
    for name, _cell, b, t, h in (bp.GRID_CASES if lstm
                                 else bp.GRU_GRID_CASES):
        x, ws, lens, _dy, _live = cs.rnn_inputs(torch, gen, cell, b, t, h,
                                                None)
        if lstm:
            w, b7 = ws
            ref = rnn.lstm_plain(x, w, *torch.split(b7, [4 * h, h, h, h]),
                                 lens, want_c=True)
            ins, names = {"args": (x, w, b7, lens), "ref": ref}, ("y", "c")
        else:
            ref = (rnn.gru_plain(x, *ws, lens),)
            ins, names = {"args": (x, *ws, lens), "ref": ref}, ("y",)
        fns, outs = {}, {}
        for k, lib in libs.items():
            fns[k], outs[k] = call(torch, lib, cell, ins, b, t, h, -1)
            fns[k]()
        order = ["other", "this", "floor"]
        if lstm:
            fns["this_infer"], outs["this_infer"] = call(
                torch, libs["this"], cell, ins, b, t, h, -1, want_c=False)
            fns["this_infer"]()
            order.insert(2, "this_infer")
        torch.cuda.synchronize()
        row = {"case": name,
               "plan": rnn.fwd_plan(kern, b, h, x.device),
               "err": {k: {n: float(f"{cs.rel_err(g, r)[0]:.3g}")
                           for n, g, r in zip(names, outs[k], ref)}
                       for k in order if k != "floor"}}
        ms = {k: [] for k in order}
        for k in order + order[::-1]:
            ms[k].append(cs.time_ms(torch, fns[k], reps=5 if k == "other"
                                    else 20))
        row["ms"] = ms
        row["kernel_ms"] = {k: bp.kernel_ms(torch, fns[k])
                            for k in ("this", "floor")}
        walk = sum(v for n, v in row["kernel_ms"]["floor"].items()
                   if "grid_kernel" in n)
        row["floor_walk_ms"] = walk
        # B5: T - 1 barriers; B7: two a step, the last step's first only
        row["floor_us_a_step"] = walk * 1e3 / (t - 1 if lstm else t)
        bp.log("grid case " + json.dumps(row))
    return 0


def step_mode(other):
    """Phase 13's classifier training run in the checkout `other` and in
    this one, in turns (see the module docstring)."""
    here = os.path.dirname(os.path.abspath(__file__))
    runs = {"other": [], "this": []}
    for k in ("other", "this", "this", "other"):
        out = subprocess.run([sys.executable, "-c", STEP],
                             cwd=other if k == "other" else here,
                             capture_output=True, text=True)
        if out.returncode != 0:
            raise RuntimeError(f"step run in {k} failed:\n{out.stdout}"
                               f"\n{out.stderr}")
        r = json.loads([ln for ln in out.stdout.splitlines()
                        if ln.startswith("STEP ")][-1][5:])
        prof = r["profile"] or {}
        runs[k].append({"ms_per_step_median": r["ms_per_step_median"],
                        "device_ms_per_step": prof.get("device_ms_per_step"),
                        "idle_share": prof.get("idle_share"),
                        "launches": r["launches"]})
        bp.log(f"step {k} " + json.dumps(runs[k][-1]))
    bp.log("step " + json.dumps({k: [x["ms_per_step_median"] for x in v]
                                 for k, v in runs.items()}))
    return 0


def main() -> int:
    import torch

    mode = sys.argv[1] if len(sys.argv) == 3 else None
    if not torch.cuda.is_available() or not (
            len(sys.argv) == 2 or mode in ("grid", "gru_grid", "step")):
        print(__doc__, file=sys.stderr)
        return 2
    from paddle_tpu_torch.ops import _build
    from paddle_tpu_torch.ops import rnn

    torch.backends.cuda.matmul.allow_tf32 = False
    os.makedirs("chiprun_out", exist_ok=True)
    bp.OUT = OUT   # the helpers of rnn_bwd_probe log into this file
    bp.log(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True).stdout.strip())
    if mode in ("grid", "gru_grid"):
        return grid_mode(torch, sys.argv[2],
                         "gru" if mode == "gru_grid" else "lstm")
    if mode == "step":
        return step_mode(os.path.abspath(sys.argv[2]))
    out_dir = os.path.join(_build.BUILD_DIR, "fwd_probe")
    os.makedirs(out_dir, exist_ok=True)
    nvcc = _build._nvcc()
    flags = _build.NVCC_FLAGS
    builds = {}
    for _name, cell, _b, _t, _h in CASES:
        kern = f"{cell}_seq"
        builds[(kern, "other")] = bp.start(
            nvcc, flags, os.path.join(sys.argv[1], f"{kern}.cu"),
            os.path.join(out_dir, f"{kern}_other.so"))
        builds[(kern, "floor")] = bp.start(
            nvcc, (*flags, "-DRNN_SERIAL_FLOOR"), _build.sources()[kern],
            os.path.join(out_dir, f"{kern}_floor.so"))
        for v, subs in VARIANTS.items():
            d = bp.variant_source(_build.SRC_DIR, out_dir, v, subs)
            builds[(kern, v)] = bp.start(
                nvcc, flags, os.path.join(d, f"{kern}.cu"),
                os.path.join(out_dir, f"{kern}_{v}.so"))
    for _n, cell, _b, _t, _h in CASES:   # this revision, meanwhile
        bind(_build.load(f"{cell}_seq"), cell)
    libs = {k: bind(bp.finish(st), k[0][:-4]) for k, st in builds.items()}
    gen = torch.Generator(device="cuda").manual_seed(cs.SEED + 6)
    dev = torch.device("cuda")
    bp.log("plans " + json.dumps({
        f"{k}_b{b}_h256": rnn.fwd_plan(f"{k}_seq", b, 256, dev)
        for k in ("lstm", "gru") for b in (8, 16, 32, 64, 128, 256, 512)}))
    for name, cell, b, t, h in CASES:
        kern = f"{cell}_seq"
        this = _build.load(kern)
        with open(bp.OUT, "a") as f:
            f.write(f"---- ptxas {kern} (this revision)\n"
                    f"{_build.build_log(kern)}")
        other, floor = libs[(kern, "other")], libs[(kern, "floor")]
        x, ws, lens, _dy, _live = cs.rnn_inputs(torch, gen, cell, b, t, h,
                                                None)
        if cell == "lstm":
            w, b7 = ws
            ref = rnn.lstm_plain(x, w, *torch.split(b7, [4 * h, h, h, h]),
                                 lens, want_c=True)
            ins = {"args": (x, w, b7, lens), "ref": ref}
            names = ("y", "c")
        else:
            w_g, w_c, bias = ws
            ins = {"args": (x, w_g, w_c, bias, lens),
                   "ref": (rnn.gru_plain(x, w_g, w_c, bias, lens),)}
            names = ("y",)
        plan = rnn.fwd_plan(kern, b, h, x.device)
        fns, outs = {}, {}
        for k, lib, route in (("other", other, -1),
                              ("this", this, -1),
                              ("this_second", this, bp.SECOND[cell]),
                              ("floor", floor, 1)):
            fns[k], outs[k] = call(torch, lib, cell, ins, b, t, h, route)
            fns[k]()
        if cell == "lstm":
            fns["this_infer"], outs["this_infer"] = call(
                torch, this, cell, ins, b, t, h, -1, want_c=False)
            fns["this_infer"]()
        torch.cuda.synchronize()
        row = {"case": name, "plan": plan, "err": {
            k: {n: float(f"{cs.rel_err(g, r)[0]:.3g}")
                for n, g, r in zip(names, outs[k], ins["ref"])}
            for k in ("other", "this", "this_second")}}
        order = ["other", "this", "this_second", "floor"]
        if cell == "lstm":
            order.insert(2, "this_infer")
        ms = {k: [] for k in order}
        for k in order + order[::-1]:
            ms[k].append(cs.time_ms(torch, fns[k]))
        row["ms"] = ms
        row["kernel_ms"] = {k: bp.kernel_ms(torch, fns[k])
                            for k in ("this", "this_second", "floor")}
        walk = [v for n, v in row["kernel_ms"]["floor"].items()
                if "cluster_kernel" in n]
        row["serial_floor_ms"] = sum(walk)
        row["serial_floor_us_a_step"] = sum(walk) * 1e3 / t
        vfns = {v: call(torch, libs[(kern, v)], cell, ins, b, t, h, 1)[0]
                for v in VARIANTS}
        vms = {v: [] for v in ("this", *VARIANTS)}
        vorder = ["this", *VARIANTS]
        for v in vorder + vorder[::-1]:
            vms[v].append(cs.time_ms(torch, fns["this"] if v == "this"
                                     else vfns[v]))
        row["variant_ms"] = vms
        bp.log("case " + json.dumps(row))
    return 0


if __name__ == "__main__":
    sys.exit(main())
