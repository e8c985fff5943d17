#!/usr/bin/env python3
"""B5 and B7 of `paddle_tpu_torch/csrc/{lstm,gru}_seq.cu` in turns against
another revision of the same files, the serial floor of the cluster walk,
and where a call's device time goes.

    mkdir -p _archive
    for f in lstm_seq.cu gru_seq.cu rnn_common.cuh tf32_mma.cuh; do
      git show <rev>:paddle_tpu_torch/csrc/$f > _archive/$f; done
    python3 rnn_fwd_probe.py _archive

Needs one CUDA card and nvcc. The other revision's entry points may take
no route (the walks only), the route alone, or the route and the route
taken (`rnn_bwd_probe.signature` tells them apart).
At the two path shapes of `chip_smoke.py`'s phase 10 (the classifier's
LSTM layer, B=64, T=100, h=256; the NMT encoder's GRU, B=256, T=32,
h=256) it prints one `case` JSON line each:
- the plan of this revision (route, rows a cluster, clusters, and the
  clusters the card holds at once; also printed first for B = 8 .. 512);
- max |diff| / max |plain| of y (and c) of both revisions;
- ms of the other revision's call, of this revision's call on the route
  its rule picks and on the walk, of the LSTM's inference variant (no
  c), and of this revision built with -DRNN_SERIAL_FLOOR (the cluster
  walk keeps only its pushes of h and its cluster barriers), timed in
  turns (CUDA events, 20 calls each);
- the device ms a call of each kernel (torch.profiler over 10 calls);
  the floor build's over T is the serial floor a step;
- ms of this revision with one piece of the walk taken out or changed by
  a text substitution (`VARIANTS`; wrong results, timed only), in turns
  with this revision.
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
    fn.argtypes = [ctypes.c_void_p] * 6 + bp.tail_types(lib, cell, "fwd")
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
    tail = bp.tail_args(lib, cell, "fwd", route)
    fn = getattr(lib, f"{cell}_seq_fwd")

    def run():
        rc = fn(*ptrs, b, t, h, *tail, 0,
                torch.cuda.current_stream().cuda_stream)
        assert rc == 0, rc

    return run, outs


def main() -> int:
    import torch

    if not torch.cuda.is_available() or len(sys.argv) != 2:
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
                              ("this", this, -1), ("this_walk", this, 0),
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
            for k in ("other", "this", "this_walk")}}
        order = ["other", "this", "this_walk", "floor"]
        if cell == "lstm":
            order.insert(2, "this_infer")
        ms = {k: [] for k in order}
        for k in order + order[::-1]:
            ms[k].append(cs.time_ms(torch, fns[k]))
        row["ms"] = ms
        row["kernel_ms"] = {k: bp.kernel_ms(torch, fns[k])
                            for k in ("this", "this_walk", "floor")}
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
