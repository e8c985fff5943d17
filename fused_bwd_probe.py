#!/usr/bin/env python3
"""B1, B2 and B3 of `paddle_tpu_torch/csrc/bn_act_conv1x1.cu` in turns
against another build of the same file, in each form (f32, and bf16),
and the card's mma.sync ceiling for each form's instruction.

    mkdir -p _archive/other
    for f in bn_act_conv1x1.cu tf32_mma.cuh bf16_mma.cuh; do
        git show <rev>:paddle_tpu_torch/csrc/$f > _archive/other/$f; done
    python3 fused_bwd_probe.py _archive/other/bn_act_conv1x1.cu [f32|bf16]

(A revision before the bf16 forms has no bf16_mma.cuh.) Needs one CUDA
card and nvcc. It probes the forms named, or else every form the other
build exports (the bf16 entry points end in `_bf16`). At the nine
ResNet-50 sites of `chip_smoke.py` (f32 at phase 7's batch 64, bf16 at
phase 7b's batch 256, bench_resnet50's; no residual, act as the layers
call it) it prints one `site` JSON line each: the ms of B1 (`fwd`), B2
(`dx`) and B3 (`dw`) of both builds, timed in turns (other, this, this,
other; CUDA events, 20 calls each), and how far each build's outputs lie
from the plain versions (the f32 outputs: max |diff| / max |plain|; the
bf16 ones: the count of elements beyond one bf16 ulp plus 1e-4 of the
largest); then the sums over a step's 29 sites, and the TFLOP/s of the
form's mma.sync (m16n8k8 TF32, m16n8k16 bf16) with 16 independent
accumulators a warp (no memory traffic) at one, two and four blocks of
8 warps an SM. Every line also goes to `chiprun_out/fused_bwd_probe.txt`,
with both builds' ptxas reports.
"""

from __future__ import annotations

import ctypes
import json
import os
import subprocess
import sys

import chip_smoke as cs
import rnn_bwd_probe as bp

OUT = os.path.join("chiprun_out", "fused_bwd_probe.txt")

# form: (entry-point suffix, batch, mma shape, operand type, k, how a
# lane makes its operand registers)
FORMS = {
    "f32": ("", 64, "m16n8k8", "tf32", 8,
            "__float_as_uint(1.f + lane * 0.001f * (i + 1)) & ~0x1fffu"),
    "bf16": ("_bf16", cs.RESNET_AMP_BATCH, "m16n8k16", "bf16", 16,
             "0x3f803f80u + lane * (i + 1)"),
}

MMA_BENCH = r"""
#include <cuda_runtime.h>
__device__ __forceinline__ void mma(float (&c)[4], const unsigned (&a)[4],
                                    const unsigned (&b)[2]) {
  asm volatile(
      "mma.sync.aligned.SHAPE.row.col.f32.TYPE.TYPE.f32 {%0,%1,%2,%3}, "
      "{%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}
__global__ void __launch_bounds__(256) bench(float* out, int iters) {
  const unsigned lane = threadIdx.x & 31;
  unsigned a[4], b[2];
  for (int i = 0; i < 4; ++i) a[i] = INIT;
  b[0] = a[2];
  b[1] = a[3];
  float acc[16][4] = {};
  for (int it = 0; it < iters; ++it)
#pragma unroll
    for (int j = 0; j < 16; ++j) mma(acc[j], a, b);
  float s = 0.f;
  for (int j = 0; j < 16; ++j)
    for (int c = 0; c < 4; ++c) s += acc[j][c];
  out[blockIdx.x * blockDim.x + threadIdx.x] = s;
}
extern "C" int mma_bench(float* out, int blocks, int iters, void* stream) {
  bench<<<blocks, 256, 0, (cudaStream_t)stream>>>(out, iters);
  return (int)cudaGetLastError();
}
"""


def bind(lib, suffix):
    p, i = ctypes.c_void_p, ctypes.c_int
    for fn, n_ptrs in (("fwd", 9), ("bwd_dx", 14), ("bwd_dw", 10)):
        f = getattr(lib, f"bn_act_conv1x1_{fn}{suffix}")
        f.argtypes = [p] * n_ptrs + [i] * 5 + [p]
        f.restype = i
    f = getattr(lib, f"bn_act_conv1x1_scratch_floats{suffix}")
    f.argtypes, f.restype = [i] * 4, ctypes.c_longlong


def calls(torch, lib, suffix, u, sc, sh, w, y, dy, d1, d2, relu):
    """{kernel: call} of one build's form on one site, and their
    outputs."""
    n, cin = u.shape
    cout = w.shape[1]
    f32 = dict(device="cuda", dtype=torch.float32)

    def entry(fn):
        return getattr(lib, f"bn_act_conv1x1_{fn}{suffix}")

    def scratch(kind):
        return torch.empty(max(entry("scratch_floats")(kind, n, cin, cout),
                               1), **f32)

    out = {"fwd": (torch.empty_like(dy), torch.empty(cout, **f32),
                   torch.empty(cout, **f32), scratch(0)),
           "dx": (torch.empty_like(u), torch.empty(cin, **f32),
                  torch.empty(cin, **f32), scratch(1)),
           "dw": (torch.empty(cin, cout, **f32), scratch(2))}

    def stream():
        return torch.cuda.current_stream().cuda_stream

    def fwd():
        yo, s1, s2, scr = out["fwd"]
        assert entry("fwd")(
            u.data_ptr(), sc.data_ptr(), sh.data_ptr(), w.data_ptr(), None,
            yo.data_ptr(), s1.data_ptr(), s2.data_ptr(), scr.data_ptr(), n,
            cin, cout, relu, 0, stream()) == 0

    def dx():
        du, ds, dt, scr = out["dx"]
        assert entry("bwd_dx")(
            u.data_ptr(), sc.data_ptr(), sh.data_ptr(), w.data_ptr(), None,
            y.data_ptr(), dy.data_ptr(), d1.data_ptr(), d2.data_ptr(),
            du.data_ptr(), None, ds.data_ptr(), dt.data_ptr(), scr.data_ptr(),
            n, cin, cout, relu, 0, stream()) == 0

    def dw():
        dwo, scr = out["dw"]
        assert entry("bwd_dw")(
            u.data_ptr(), sc.data_ptr(), sh.data_ptr(), None, y.data_ptr(),
            dy.data_ptr(), d1.data_ptr(), d2.data_ptr(), dwo.data_ptr(),
            scr.data_ptr(), n, cin, cout, relu, 0, stream()) == 0

    return {"fwd": fwd, "dx": dx, "dw": dw}, out


def probe_form(torch, op, libs, form):
    """The `site` lines and the 29-site sums of one form."""
    suffix, batch = FORMS[form][:2]
    inputs = cs.fused_inputs_bf16 if form == "bf16" else cs.fused_inputs
    for lib in libs.values():
        bind(lib, suffix)
    gen = torch.Generator(device="cuda").manual_seed(cs.SEED + 5)
    total = {k: {"fwd": 0.0, "dx": 0.0, "dw": 0.0} for k in libs}
    for name, rows, cin, cout, act, count in cs.FUSED_SITES:
        n = rows * batch
        u, sc, sh, w, _r, dy, d1, d2 = inputs(torch, gen, n, cin, cout,
                                              False)
        ref = op.bn_act_conv1x1_plain(u, sc, sh, w, None, act)
        y = ref[0]
        ref += op.bn_act_conv1x1_bwd_dx_plain(u, sc, sh, w, None, y, dy, d1,
                                              d2, act)[:3]
        ref += (op.bn_act_conv1x1_bwd_dw_plain(u, sc, sh, None, y, dy, d1,
                                               d2, act),)
        row = {"form": form, "site": name, "n": n, "cin": cin, "cout": cout}
        fns = {}
        for k, lib in libs.items():
            fns[k], out = calls(torch, lib, suffix, u, sc, sh, w, y, dy, d1,
                                d2, int(act == "relu"))
            for fn in fns[k].values():
                fn()
            torch.cuda.synchronize()
            got = (*out["fwd"][:3], *out["dx"][:3], out["dw"][0])
            err = {}
            for o, g, r in zip(("y", "ssum", "ssq", "du", "dscale", "dshift",
                                "dw"), got, ref):
                if g.dtype == torch.bfloat16:
                    err[o + "_off"] = cs.bf16_off(torch, g, r)
                else:
                    err[o] = float(f"{cs.rel_err(g, r)[0]:.3g}")
            row[f"{k}_err"] = err
        for kern in ("fwd", "dx", "dw"):
            ms = {k: [] for k in libs}
            for k in ("other", "this", "this", "other"):
                ms[k].append(cs.time_ms(torch, fns[k][kern]))
            for k in libs:
                row[f"{k}_{kern}_ms"] = ms[k]
                total[k][kern] += count * sum(ms[k]) / 2
        bp.log("site " + json.dumps(row))
        del u, w, dy, y, ref, fns
        torch.cuda.empty_cache()
    bp.log(f"{form}: sum over the 29 sites at batch {batch} (ms) "
           + json.dumps(total))


def mma_ceiling(torch, nvcc, out_dir, form):
    _s, _b, shape, kind, k, init = FORMS[form]
    src = os.path.join(out_dir, f"mma_{kind}_bench.cu")
    with open(src, "w") as f:
        f.write(MMA_BENCH.replace("SHAPE", shape).replace("TYPE", kind)
                .replace("INIT", init))
    from paddle_tpu_torch.ops import _build

    mb = bp.finish(bp.start(nvcc, _build.NVCC_FLAGS, src,
                            src.replace(".cu", ".so")))
    mb.mma_bench.argtypes = [ctypes.c_void_p, ctypes.c_int, ctypes.c_int,
                             ctypes.c_void_p]
    iters = 512
    for per_sm in (1, 2, 4):
        blocks = 132 * per_sm
        out = torch.empty(blocks * 256, device="cuda")
        ms = cs.time_ms(torch, lambda: mb.mma_bench(
            out.data_ptr(), blocks, iters,
            torch.cuda.current_stream().cuda_stream), reps=5, warmup=2)
        # 8 warps x iters x 16 mma of 16 x 8 x k, 2 flops a product
        tflops = blocks * 8 * iters * 16 * 2 * 16 * 8 * k / (ms * 1e-3) / 1e12
        bp.log(f"mma.sync {shape} {kind}, {blocks} blocks of 8 warps: "
               f"{ms:.4f} ms, {tflops:.1f} TFLOP/s")


def main() -> int:
    import torch

    if (not torch.cuda.is_available() or len(sys.argv) < 2
            or not set(sys.argv[2:]) <= set(FORMS)):
        print(__doc__, file=sys.stderr)
        return 2
    from paddle_tpu_torch.ops import _build
    from paddle_tpu_torch.ops import bn_act_conv1x1 as op

    torch.backends.cuda.matmul.allow_tf32 = False
    os.makedirs("chiprun_out", exist_ok=True)
    bp.OUT = OUT   # the helpers of rnn_bwd_probe log into this file
    bp.log(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True).stdout.strip())
    out_dir = os.path.join(_build.BUILD_DIR, "probe")
    os.makedirs(out_dir, exist_ok=True)
    nvcc = _build._nvcc()
    other = bp.finish(bp.start(nvcc, _build.NVCC_FLAGS, sys.argv[1],
                               os.path.join(out_dir, "other.so")))
    libs = {"other": other, "this": _build.load(op.KERNEL)}
    with open(OUT, "a") as f:
        f.write(f"---- ptxas this\n{_build.build_log(op.KERNEL)}")
    forms = sys.argv[2:] or [
        form for form, (suffix, *_rest) in FORMS.items()
        if hasattr(other, f"bn_act_conv1x1_fwd{suffix}")]
    for form in forms:
        probe_form(torch, op, libs, form)
        mma_ceiling(torch, nvcc, out_dir, form)
    return 0


if __name__ == "__main__":
    sys.exit(main())
