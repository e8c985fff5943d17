#!/usr/bin/env python3
"""B2 and B3 of `paddle_tpu_torch/csrc/bn_act_conv1x1.cu` in turns against
another build of the same file, and the card's TF32 mma.sync ceiling.

    git show <rev>:paddle_tpu_torch/csrc/bn_act_conv1x1.cu > _archive/other.cu
    python3 fused_bwd_probe.py _archive/other.cu

Needs one CUDA card and nvcc. At the nine ResNet-50 sites of
`chip_smoke.py`'s phase 7 (batch 64, no residual) it prints one `site`
JSON line each: the ms of B2 (`dx`) and B3 (`dw`) of both builds, timed in
turns (other, this, this, other; CUDA events, 20 calls each), and max
|diff| / max |plain| of du, dscale, dshift and dw against the plain
versions; then the sums over a step's 29 sites, and the TFLOP/s of
mma.sync m16n8k8 TF32 with 16 independent accumulators a warp (no memory
traffic) at one, two and four blocks of 8 warps an SM.
"""

from __future__ import annotations

import ctypes
import json
import os
import subprocess
import sys

import chip_smoke as cs

MMA_BENCH = r"""
#include <cuda_runtime.h>
__device__ __forceinline__ void mma(float (&c)[4], const unsigned (&a)[4],
                                    const unsigned (&b)[2]) {
  asm volatile(
      "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 {%0,%1,%2,%3}, "
      "{%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}
__global__ void __launch_bounds__(256) bench(float* out, int iters) {
  const int lane = threadIdx.x & 31;
  unsigned a[4], b[2];
  for (int i = 0; i < 4; ++i)
    a[i] = __float_as_uint(1.f + lane * 0.001f * (i + 1)) & ~0x1fffu;
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


def build(nvcc_flags, nvcc, src, out):
    r = subprocess.run([nvcc, *nvcc_flags, "-o", out, src],
                       capture_output=True, text=True)
    if r.returncode != 0:
        raise RuntimeError(f"nvcc failed on {src}:\n{r.stdout}{r.stderr}")
    return ctypes.CDLL(out)


def bind(lib):
    p, i = ctypes.c_void_p, ctypes.c_int
    lib.bn_act_conv1x1_bwd_dx.argtypes = [p] * 14 + [i] * 5 + [p]
    lib.bn_act_conv1x1_bwd_dw.argtypes = [p] * 10 + [i] * 5 + [p]
    lib.bn_act_conv1x1_bwd_dx.restype = lib.bn_act_conv1x1_bwd_dw.restype = i
    lib.bn_act_conv1x1_scratch_floats.argtypes = [i] * 4
    lib.bn_act_conv1x1_scratch_floats.restype = ctypes.c_longlong
    return lib


def calls(torch, lib, u, sc, sh, w, y, dy, d1, d2, relu):
    """(B2 call, B3 call, their outputs) of one build on one site."""
    n, cin = u.shape
    cout = w.shape[1]

    def scratch(kind):
        floats = lib.bn_act_conv1x1_scratch_floats(kind, n, cin, cout)
        return torch.empty(max(floats, 1), device="cuda")

    dx_out = (torch.empty_like(u), torch.empty(cin, device="cuda"),
              torch.empty(cin, device="cuda"), scratch(1))
    dw_out = (torch.empty(cin, cout, device="cuda"), scratch(2))

    def stream():
        return torch.cuda.current_stream().cuda_stream

    def dx():
        du, ds, dt, scr = dx_out
        assert lib.bn_act_conv1x1_bwd_dx(
            u.data_ptr(), sc.data_ptr(), sh.data_ptr(), w.data_ptr(), None,
            y.data_ptr(), dy.data_ptr(), d1.data_ptr(), d2.data_ptr(),
            du.data_ptr(), None, ds.data_ptr(), dt.data_ptr(), scr.data_ptr(),
            n, cin, cout, relu, 0, stream()) == 0

    def dw():
        out, scr = dw_out
        assert lib.bn_act_conv1x1_bwd_dw(
            u.data_ptr(), sc.data_ptr(), sh.data_ptr(), None, y.data_ptr(),
            dy.data_ptr(), d1.data_ptr(), d2.data_ptr(), out.data_ptr(),
            scr.data_ptr(), n, cin, cout, relu, 0, stream()) == 0

    return dx, dw, dx_out, dw_out


def main() -> int:
    import torch

    if not torch.cuda.is_available() or len(sys.argv) != 2:
        print(__doc__, file=sys.stderr)
        return 2
    from paddle_tpu_torch.ops import _build
    from paddle_tpu_torch.ops import bn_act_conv1x1 as op

    torch.backends.cuda.matmul.allow_tf32 = False
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip(), flush=True)
    out_dir = os.path.join(_build.BUILD_DIR, "probe")
    os.makedirs(out_dir, exist_ok=True)
    nvcc = _build._nvcc()
    libs = {"other": bind(build(_build.NVCC_FLAGS, nvcc, sys.argv[1],
                                os.path.join(out_dir, "other.so"))),
            "this": bind(_build.load(op.KERNEL))}
    gen = torch.Generator(device="cuda").manual_seed(cs.SEED + 3)
    total = {k: {"dx": 0.0, "dw": 0.0} for k in libs}
    for name, rows, cin, cout, act, count in cs.FUSED_SITES:
        n = rows * 64
        u, sc, sh, w, _r, dy, d1, d2 = cs.fused_inputs(torch, gen, n, cin,
                                                       cout, False)
        y = op.bn_act_conv1x1_plain(u, sc, sh, w, None, act)[0]
        ref = op.bn_act_conv1x1_bwd_dx_plain(u, sc, sh, w, None, y, dy, d1,
                                             d2, act)[:3]
        ref += (op.bn_act_conv1x1_bwd_dw_plain(u, sc, sh, None, y, dy, d1,
                                               d2, act),)
        row = {"site": name}
        fns = {}
        for k, lib in libs.items():
            dx, dw, dx_out, dw_out = calls(torch, lib, u, sc, sh, w, y, dy,
                                           d1, d2, int(act == "relu"))
            dx()
            dw()
            torch.cuda.synchronize()
            got = (*dx_out[:3], dw_out[0])
            row[f"{k}_err"] = {
                o: float(f"{cs.rel_err(g, r)[0]:.3g}")
                for o, g, r in zip(("du", "dscale", "dshift", "dw"), got,
                                   ref)}
            fns[k] = {"dx": dx, "dw": dw}
        for kern in ("dx", "dw"):
            ms = {k: [] for k in libs}
            for k in ("other", "this", "this", "other"):
                ms[k].append(cs.time_ms(torch, fns[k][kern]))
            for k in libs:
                row[f"{k}_{kern}_ms"] = ms[k]
                total[k][kern] += count * sum(ms[k]) / 2
        print("site " + json.dumps(row), flush=True)
    print("sum over the 29 sites (ms) " + json.dumps(total), flush=True)

    src = os.path.join(out_dir, "mma_bench.cu")
    with open(src, "w") as f:
        f.write(MMA_BENCH)
    mb = build(_build.NVCC_FLAGS, nvcc, src, os.path.join(out_dir,
                                                          "mma_bench.so"))
    mb.mma_bench.argtypes = [ctypes.c_void_p, ctypes.c_int, ctypes.c_int,
                             ctypes.c_void_p]
    iters = 512
    for per_sm in (1, 2, 4):
        blocks = 132 * per_sm
        out = torch.empty(blocks * 256, device="cuda")
        ms = cs.time_ms(torch, lambda: mb.mma_bench(
            out.data_ptr(), blocks, iters,
            torch.cuda.current_stream().cuda_stream), reps=5, warmup=2)
        tflops = blocks * 8 * iters * 16 * 2 * 16 * 8 * 8 / (ms * 1e-3) / 1e12
        print(f"mma.sync m16n8k8 tf32, {blocks} blocks of 8 warps: "
              f"{ms:.4f} ms, {tflops:.1f} TFLOP/s", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
