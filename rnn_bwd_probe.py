#!/usr/bin/env python3
"""B6 and B8 of `paddle_tpu_torch/csrc/{lstm,gru}_seq.cu` in turns against
another revision of the same files, the serial floor of the cluster walk,
and where a call's device time goes.

    mkdir -p _archive
    for f in lstm_seq.cu gru_seq.cu rnn_common.cuh tf32_mma.cuh; do
      git show <rev>:paddle_tpu_torch/csrc/$f > _archive/$f; done
    python3 rnn_bwd_probe.py _archive

Needs one CUDA card and nvcc. The other revision's entry points may take
no route, the route alone, or the route and the route taken
(`signature`). At the two path shapes of `chip_smoke.py`'s
phase 10 (the classifier's LSTM layer, B=64, T=100, h=256; the NMT
encoder's GRU, B=256, T=32, h=256) it prints one `case` JSON line each:
- the plan of this revision (route, rows a cluster, clusters, and the
  clusters the card holds at once; also printed first for B = 8 .. 512);
- max |diff| / max |plain| of every output of both revisions;
- ms of the other revision's call, of this revision's call on the route
  its rule picks and on the walk, and of this revision built with
  -DRNN_SERIAL_FLOOR (the walk keeps only its cluster barriers and
  exchanges), timed in turns (CUDA events, 20 calls each);
- the device ms a call of each kernel of this revision's cluster route,
  of its walk route and of the floor build (torch.profiler over 10
  calls): the hoisted products, the walk, the dW GEMMs, the sums; the
  floor build's walk kernel over T is the serial floor a step.
- ms of this revision with one piece of the walk taken out or changed
  by a text substitution (`VARIANTS`; wrong results, timed only), in
  turns with this revision.
Every build runs at once (one nvcc each). The ptxas report of every build
is appended to `chiprun_out/rnn_bwd_probe.txt`, with every line printed
here.
"""

from __future__ import annotations

import ctypes
import json
import os
import subprocess
import sys

import chip_smoke as cs

CASES = [("classifier_b64_t100_h256", "lstm", cs.CLS_B, cs.CLS_T, 256),
         ("nmt_enc_b256_t32_h256", "gru", cs.NMT_B, cs.NMT_T, 256)]
OUT = os.path.join("chiprun_out", "rnn_bwd_probe.txt")
# name: [(file of csrc, text, its substitute)], applied to both cells'
# sources where the text occurs
VARIANTS = {
    # the products of the walk do no arithmetic (their loads neither)
    "no_product": [("rnn_common.cuh",
                    "for (int c0 = 8 * SETS * share; c0 < K;",
                    "for (int c0 = 8 * SETS * share; c0 < 0;")],
    # no cell backward (no exp, tanh, dg)
    "no_cell": [(f, "for (int pr = threadIdx.x; pr < RU && !kSerialFloor; "
                 "pr += NTC) {", "for (int pr = threadIdx.x; pr < 0; "
                 "pr += NTC) {") for f in ("lstm_seq.cu", "gru_seq.cu")],
    # no stores of dx in the walk
    "no_store": [("lstm_seq.cu", "e < 4 * RU && !kSerialFloor", "e < 0"),
                 ("gru_seq.cu", "e < g1 * RU && !kSerialFloor", "e < 0")],
    # the walk's products in one TF32 pass (hi x hi) instead of three
    "one_pass": [("rnn_common.cuh",
                  "mma_tf32(acc[s][j], alo[s], bhi[s][j]);", ""),
                 ("rnn_common.cuh",
                  "mma_tf32(acc[s][j], ahi[s], blo[s][j]);", "")],
    # the weights of the walk's products taken as TF32 without a split
    "no_weight_split": [
        ("rnn_common.cuh", "inline __host__ __device__ int round8(int n)",
         "__device__ __forceinline__ void as_tf32(float x, unsigned& hi, "
         "unsigned& lo) { hi = __float_as_uint(x) & 0xffffe000u; lo = 0u; }"
         "\ninline __host__ __device__ int round8(int n)"),
        ("rnn_common.cuh", "split_tf32_alu(ap[", "as_tf32(ap[")],
    # dW split for two blocks an SM, not four
    "dw_264_blocks": [("rnn_common.cuh", "DW_TARGET_BLOCKS = 528;",
                       "DW_TARGET_BLOCKS = 264;")],
    # rows a cluster from powers of two only
    "rows_pow2": [("rnn_common.cuh",
                   "WALK_ROWS[] = {1, 2, 3, 5, 8, 12, 18, 32};",
                   "WALK_ROWS[] = {1, 2, 8, 32};")],
}


def log(line):
    print(line, flush=True)
    with open(OUT, "a") as f:
        f.write(line + "\n")


def start(nvcc, flags, src, out):
    """nvcc of `src` into `out`, started; finish() waits and loads it."""
    return out, subprocess.Popen([nvcc, *flags, "-o", out, src],
                                 stdout=subprocess.PIPE,
                                 stderr=subprocess.STDOUT, text=True)


def finish(started):
    out, proc = started
    text, _ = proc.communicate()
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed building {out}:\n{text}")
    with open(OUT, "a") as f:
        f.write(f"---- ptxas {out}\n{text}")
    return ctypes.CDLL(out)


def variant_source(src_dir, out_dir, name, subs):
    """csrc copied into out_dir/name with `subs` applied; its directory."""
    d = os.path.join(out_dir, name)
    os.makedirs(d, exist_ok=True)
    for f in os.listdir(src_dir):
        with open(os.path.join(src_dir, f)) as fh:
            text = fh.read()
        for target, old, new in subs:
            if target == f:
                assert old in text, (name, f, old)
                text = text.replace(old, new)
        with open(os.path.join(d, f), "w") as fh:
            fh.write(text)
    return d


def signature(lib, cell, kind):
    """What a build's forward or backward (`kind`) launch entry point
    takes after B, T, h: "taken" (the route asked for and an int * for
    the route taken: the revisions with the forward's plan), "route"
    (the route alone: the backward's, in the revisions with its plan
    only) or "none" (the walk only)."""
    if hasattr(lib, f"{cell}_seq_fwd_plan"):
        return "taken"
    if kind == "bwd" and hasattr(lib, f"{cell}_seq_bwd_plan"):
        return "route"
    return "none"


def tail_types(lib, cell, kind):
    """The argtypes of a launch entry point after its tensors."""
    i = ctypes.c_int
    sig = signature(lib, cell, kind)
    return ([i] * 3 + [i] * (sig != "none")
            + [ctypes.POINTER(i)] * (sig == "taken") + [i, ctypes.c_void_p])


def tail_args(lib, cell, kind, route):
    """What a launch entry point takes between h and the device: the
    route and an int * for the route taken, the route, or nothing."""
    sig = signature(lib, cell, kind)
    if sig == "none":
        return ()
    return (route, ctypes.byref(ctypes.c_int(-1))) if sig == "taken" else (
        route,)


def bind(lib, cell):
    p, i = ctypes.c_void_p, ctypes.c_int
    fn = getattr(lib, f"{cell}_seq_bwd")
    fn.argtypes = ([p] * (11 if cell == "lstm" else 12)
                   + tail_types(lib, cell, "bwd"))
    fn.restype = i
    scr = getattr(lib, f"{cell}_seq_bwd_scratch_floats")
    scr.argtypes, scr.restype = [i] * 3, ctypes.c_longlong
    return lib


def call(torch, lib, cell, ins, b, t, h, route):
    """A zero-argument call of `lib`'s backward at `route` (ignored by a
    build whose backward has no route) into fresh outputs, and the
    outputs."""
    outs = [torch.empty_like(r) for r in ins["ref"]]
    floats = getattr(lib, f"{cell}_seq_bwd_scratch_floats")(b, t, h)
    scratch = torch.empty(max(floats, 1), device="cuda")
    ptrs = [a.data_ptr() for a in (*ins["args"], *outs, scratch)]
    tail = tail_args(lib, cell, "bwd", route)
    fn = getattr(lib, f"{cell}_seq_bwd")

    def run():
        rc = fn(*ptrs, b, t, h, *tail, 0,
                torch.cuda.current_stream().cuda_stream)
        assert rc == 0, rc

    return run, outs


def kernel_ms(torch, fn, calls=10):
    """{kernel name: device ms a call} of fn() under torch.profiler."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
    cuda = torch.autograd.DeviceType.CUDA
    return {e.key[:90]: e.self_device_time_total / calls / 1e3
            for e in prof.key_averages()
            if e.device_type == cuda and e.self_device_time_total > 0}


def main() -> int:
    import torch

    if not torch.cuda.is_available() or len(sys.argv) != 2:
        print(__doc__, file=sys.stderr)
        return 2
    from paddle_tpu_torch.ops import _build
    from paddle_tpu_torch.ops import rnn

    torch.backends.cuda.matmul.allow_tf32 = False
    os.makedirs("chiprun_out", exist_ok=True)
    log(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                        "--format=csv,noheader"], capture_output=True,
                       text=True).stdout.strip())
    out_dir = os.path.join(_build.BUILD_DIR, "probe")
    os.makedirs(out_dir, exist_ok=True)
    nvcc = _build._nvcc()
    flags = _build.NVCC_FLAGS
    builds = {}
    for name, cell, b, t, h in CASES:
        kern = f"{cell}_seq"
        builds[(kern, "other")] = start(
            nvcc, flags, os.path.join(sys.argv[1], f"{kern}.cu"),
            os.path.join(out_dir, f"{kern}_other.so"))
        builds[(kern, "floor")] = start(
            nvcc, (*flags, "-DRNN_SERIAL_FLOOR"), _build.sources()[kern],
            os.path.join(out_dir, f"{kern}_floor.so"))
        for v, subs in VARIANTS.items():
            d = variant_source(_build.SRC_DIR, out_dir, v, subs)
            builds[(kern, v)] = start(nvcc, flags,
                                      os.path.join(d, f"{kern}.cu"),
                                      os.path.join(out_dir, f"{kern}_{v}.so"))
    for _n, cell, _b, _t, _h in CASES:   # this revision, meanwhile
        bind(_build.load(f"{cell}_seq"), cell)
    libs = {k: bind(finish(st), k[0][:-4])
            for k, st in builds.items()}
    gen = torch.Generator(device="cuda").manual_seed(cs.SEED + 5)
    dev = torch.device("cuda")
    log("plans " + json.dumps({
        f"{k}_b{b}_h256": rnn.bwd_plan(f"{k}_seq", b, 256, dev)
        for k in ("lstm", "gru") for b in (8, 16, 32, 64, 128, 256, 512)}))
    for name, cell, b, t, h in CASES:
        kern = f"{cell}_seq"
        this = _build.load(kern)
        with open(OUT, "a") as f:
            f.write(f"---- ptxas {kern} (this revision)\n"
                    f"{_build.build_log(kern)}")
        other, floor = libs[(kern, "other")], libs[(kern, "floor")]
        x, ws, lens, dy, _live = cs.rnn_inputs(torch, gen, cell, b, t, h,
                                               None)
        if cell == "lstm":
            w, b7 = ws
            y, c = rnn.lstm_plain(x, w, *torch.split(b7, [4 * h, h, h, h]),
                                  lens, want_c=True)
            ins = {"args": (x, w, b7, lens, y, c, dy),
                   "ref": rnn.lstm_bwd_plain(x, w, b7, lens, y, c, dy)}
            names = ("dx", "dw", "db7")
        else:
            w_g, w_c, bias = ws
            y = rnn.gru_plain(x, w_g, w_c, bias, lens)
            ins = {"args": (x, w_g, w_c, bias, lens, y, dy),
                   "ref": rnn.gru_bwd_plain(x, w_g, w_c, bias, lens, y, dy)}
            names = ("dx", "dw_g", "dw_c", "db")
        plan = rnn.bwd_plan(kern, b, h, x.device)
        fns, outs = {}, {}
        for k, lib, route in (("other", other, -1), ("this", this, -1),
                              ("this_walk", this, 0), ("floor", floor, 1)):
            fns[k], outs[k] = call(torch, lib, cell, ins, b, t, h, route)
            fns[k]()
        torch.cuda.synchronize()
        row = {"case": name, "plan": plan, "err": {
            k: {n: float(f"{cs.rel_err(g, r)[0]:.3g}")
                for n, g, r in zip(names, outs[k], ins["ref"])}
            for k in ("other", "this", "this_walk")}}
        ms = {k: [] for k in fns}
        for k in ("other", "this", "this_walk", "floor", "floor",
                  "this_walk", "this", "other"):
            ms[k].append(cs.time_ms(torch, fns[k]))
        row["ms"] = ms
        row["kernel_ms"] = {k: kernel_ms(torch, fns[k])
                            for k in ("this", "this_walk", "floor")}
        walk = [v for n, v in row["kernel_ms"]["floor"].items()
                if "cluster_kernel" in n]
        row["serial_floor_ms"] = sum(walk)
        row["serial_floor_us_a_step"] = sum(walk) * 1e3 / t
        vfns = {v: call(torch, libs[(kern, v)], cell, ins, b, t, h, 1)[0]
                for v in VARIANTS}
        vms = {v: [] for v in ("this", *VARIANTS)}
        order = ["this", *VARIANTS]
        for v in order + order[::-1]:
            vms[v].append(cs.time_ms(torch, fns["this"] if v == "this"
                                     else vfns[v]))
        row["variant_ms"] = vms
        log("case " + json.dumps(row))
    return 0


if __name__ == "__main__":
    sys.exit(main())
