#!/usr/bin/env python3
"""B1, B2 and B3 of `paddle_tpu_torch/csrc/bn_act_conv1x1.cu` in turns
against another build of the same file, in each form (f32, and bf16),
and the card's mma.sync ceiling for each form's instruction (and, for
bf16, wgmma's).

    mkdir -p _archive/other
    for f in bn_act_conv1x1.cu tf32_mma.cuh bf16_mma.cuh hopper_wgmma.cuh; do
        git show <rev>:paddle_tpu_torch/csrc/$f > _archive/other/$f; done
    python3 fused_bwd_probe.py _archive/other/bn_act_conv1x1.cu [f32|bf16]

    python3 fused_bwd_probe.py variants [fwd|dx|dw]

(A revision before the bf16 forms has no bf16_mma.cuh, one before the
wgmma kernels no hopper_wgmma.cuh.) Needs one CUDA
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
8 warps an SM; for bf16 also wgmma's (m64n128k16 and m64n256k16, both
operands in shared memory, two warpgroups a block, one block an SM), and
the host time of one call of the bf16 B1, B2 and B3 wrappers
(`bn_act_conv1x1_fwd` / `_bwd_dx` / `_bwd_dw`: checks, tensor maps,
scratch, launch) beside the device time at the res4b-f_a site. It
fails where either build's ptxas report says it serialised wgmma. Every
line also goes to
`chiprun_out/fused_bwd_probe.txt`, with both builds' ptxas reports.
`variants` mode instead times the bf16 B1, B2 and B3 of this revision
against `VARIANTS` of it (text substitutions that take one
piece out: wrong results, timed only; all built at once; only those of
one kernel where it is named) in turns, at `VARIANT_SITES`.
"""

from __future__ import annotations

import ctypes
import json
import os
import subprocess
import sys
import time

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

# wgmma m64nNk16 bf16, A and B from (zeroed) shared memory, K-major: two
# warpgroups a block, each issuing 8 products a commit group
WGMMA_BENCH = r"""
#include "hopper_wgmma.cuh"

template <int N>
__device__ __forceinline__ void mma_n(float (&d)[N / 2], uint64_t a,
                                      uint64_t b);
template <>
__device__ __forceinline__ void mma_n<128>(float (&d)[64], uint64_t a,
                                           uint64_t b) {
  wgmma_ss<128>(d, a, b, 1);
}
template <>
__device__ __forceinline__ void mma_n<256>(float (&d)[128], uint64_t a,
                                           uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %130, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n256k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, "
      "%15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, "
      "%28, %29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, "
      "%41, %42, %43, %44, %45, %46, %47, %48, %49, %50, %51, %52, %53, "
      "%54, %55, %56, %57, %58, %59, %60, %61, %62, %63, %64, %65, %66, "
      "%67, %68, %69, %70, %71, %72, %73, %74, %75, %76, %77, %78, %79, "
      "%80, %81, %82, %83, %84, %85, %86, %87, %88, %89, %90, %91, %92, "
      "%93, %94, %95, %96, %97, %98, %99, %100, %101, %102, %103, %104, "
      "%105, %106, %107, %108, %109, %110, %111, %112, %113, %114, %115, "
      "%116, %117, %118, %119, %120, %121, %122, %123, %124, %125, %126, "
      "%127}, %128, %129, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]),
        "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]),
        "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]), "+f"(d[49]),
        "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]),
        "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63]), "+f"(d[64]),
        "+f"(d[65]), "+f"(d[66]), "+f"(d[67]), "+f"(d[68]), "+f"(d[69]),
        "+f"(d[70]), "+f"(d[71]), "+f"(d[72]), "+f"(d[73]), "+f"(d[74]),
        "+f"(d[75]), "+f"(d[76]), "+f"(d[77]), "+f"(d[78]), "+f"(d[79]),
        "+f"(d[80]), "+f"(d[81]), "+f"(d[82]), "+f"(d[83]), "+f"(d[84]),
        "+f"(d[85]), "+f"(d[86]), "+f"(d[87]), "+f"(d[88]), "+f"(d[89]),
        "+f"(d[90]), "+f"(d[91]), "+f"(d[92]), "+f"(d[93]), "+f"(d[94]),
        "+f"(d[95]), "+f"(d[96]), "+f"(d[97]), "+f"(d[98]), "+f"(d[99]),
        "+f"(d[100]), "+f"(d[101]), "+f"(d[102]), "+f"(d[103]),
        "+f"(d[104]), "+f"(d[105]), "+f"(d[106]), "+f"(d[107]),
        "+f"(d[108]), "+f"(d[109]), "+f"(d[110]), "+f"(d[111]),
        "+f"(d[112]), "+f"(d[113]), "+f"(d[114]), "+f"(d[115]),
        "+f"(d[116]), "+f"(d[117]), "+f"(d[118]), "+f"(d[119]),
        "+f"(d[120]), "+f"(d[121]), "+f"(d[122]), "+f"(d[123]),
        "+f"(d[124]), "+f"(d[125]), "+f"(d[126]), "+f"(d[127])
      : "l"(a), "l"(b), "r"(1));
}

template <int N>
__global__ void __launch_bounds__(256, 1) wg_bench(float* out, int iters) {
  extern __shared__ __align__(1024) unsigned char smem[];
  unsigned char* sm = align1024(smem);
  for (int i = threadIdx.x; i < (64 + N) * 128 / 16; i += 256)
    reinterpret_cast<uint4*>(sm)[i] = make_uint4(0, 0, 0, 0);
  fence_async_shared();
  __syncthreads();
  const unsigned base = smem_u32(sm);
  const int wg = warp_uniform(threadIdx.x >> 7);
  float d[N / 2];
  for (int i = 0; i < N / 2; ++i) d[i] = 0.f;
  for (int it = 0; it < iters; ++it) {
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < 8; ++kk)
      mma_n<N>(d, desc_k<64>(base, 64, 0, kk & 3),
               desc_k<64>(base + 64 * 128, N, 0, kk & 3));
    wgmma_commit();
    wgmma_wait<0>();
  }
  fence_regs(d);
  float s = 0.f;
  for (int i = 0; i < N / 2; ++i) s += d[i];
  out[(blockIdx.x * 2 + wg) * 128 + (threadIdx.x & 127)] = s;
}
extern "C" int wgmma_bench(float* out, int n, int blocks, int iters,
                           void* stream) {
  const int bytes = (64 + n) * 128 + 1024;
  if (n == 128) {
    cudaFuncSetAttribute(wg_bench<128>,
                         cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
    wg_bench<128><<<blocks, 256, bytes, (cudaStream_t)stream>>>(out, iters);
  } else {
    cudaFuncSetAttribute(wg_bench<256>,
                         cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
    wg_bench<256><<<blocks, 256, bytes, (cudaStream_t)stream>>>(out, iters);
  }
  return (int)cudaGetLastError();
}
"""

SERIALISED = "wgmma.mma_async instructions are serialized"

# name: substitutions in csrc/bn_act_conv1x1.cu (each must be found); the
# prefix names the kernel timed (fwd_: B1, dx_: B2, dw_: B3)
VARIANTS = {
    # B1's A fragments as u lies (no z formula, no scale and shift loads)
    "fwd_no_z": [("          x = pack_bf16x2(z0, z1);",
                  "          x = x + 0 * pack_bf16x2(z0, z1);")],
    # B1 without its column sums (y still staged and stored)
    "fwd_no_stats": [("          ps[j][0] = __fadd_rn(ps[j][0], s0);\n"
                      "          ps[j][1] = __fadd_rn(ps[j][1], s1);\n"
                      "          pq[j][0] = fmaf(s0, s0, pq[j][0]);\n"
                      "          pq[j][1] = fmaf(s1, s1, pq[j][1]);\n", ""),
                     ("        halve<8>(sy, sq, (lane >> 2) & 1, 4);\n"
                      "        halve<4>(sy, sq, (lane >> 3) & 1, 8);\n"
                      "        halve<2>(sy, sq, (lane >> 4) & 1, 16);\n", ""),
                     ("        o = make_float2(__fadd_rn(o.x, sy[0]), "
                      "__fadd_rn(o.y, sy[1]));\n"
                      "        oq = make_float2(__fadd_rn(oq.x, sq[0]), "
                      "__fadd_rn(oq.y, sq[1]));\n", "")],
    # B1 without the TMA stores of y (staged, never written out)
    "fwd_no_store": [("      tma_store_2d_if(&ty, yb + a * ATOM_BYTES, c0 + "
                      "64 * a, row0, storer);", "      ;")],
    # B1's tiles at most 128 columns wide (no 128 x 256)
    "fwd_cols128": [("  return Cout <= 64 ? 64 : Cout >= 256 ? 256 : WG_TILE;",
                     "  return Cout <= 64 ? 64 : WG_TILE;")],
    # B1 without its products
    "fwd_no_mma": [("      wgmma_rs<BN>(acc, a[kk], desc_mn<BN>(wt, WG_BK, "
                    "kk),\n                   kt | kk);", "      ;")],
    # B3 without forming dy_eff in place (the fence and barrier stay)
    "dw_no_dy_eff": [("v[e] = __fadd_rn(__fadd_rn(v[e], a1[e]), "
                      "__fmul_rn(yv[e], a2[e]));", "v[e] = v[e];")],
    # B3's z without the affine, activation and mask
    "dw_no_z": [("          z[q] = row + q < live ? z[q] : 0.f;",
                 "          z[q] = q ? bf16_hi(uu[e]) : bf16_lo(uu[e]);")],
    # B3 without its products
    "dw_no_mma": [("      wgmma_rs<WG_TILE>(acc, a[kk], desc_mn<WG_TILE>"
                   "(dt, WG_BK, kk),\n                        keep | kk);",
                   "      ;")],
    # B2's A fragments as dy lies (no dy_eff formula)
    "dx_no_dy_eff": [("          x = pack_bf16x2(\n"
                      "              __fadd_rn(__fadd_rn(bf16_lo(x), e1.x),",
                      "          x = x + 0 * pack_bf16x2(\n"
                      "              __fadd_rn(__fadd_rn(bf16_lo(x), e1.x),")],
    # B3's formers one chunk at a time, or four
    "dw_former_unroll1": [("#pragma unroll 2\n      for (int q = f;",
                           "#pragma unroll 1\n      for (int q = f;")],
    "dw_former_unroll4": [("#pragma unroll 2\n      for (int q = f;",
                           "#pragma unroll 4\n      for (int q = f;")],
    # B3's ring three stages deep without a residual (four)
    "dw_three_stages": [("static constexpr int STAGES = RES ? 3 : 4;",
                         "static constexpr int STAGES = 3;")],
    # B2's ring two stages deep (three)
    "dx_two_stages": [("  static constexpr int STAGES = 3;\n"
                       "  static constexpr int A_BYTES",
                       "  static constexpr int STAGES = 2;\n"
                       "  static constexpr int A_BYTES")],
    # B2 without its products
    "dx_no_mma": [("      wgmma_rs_k<WG_TILE>(acc, a[kk], desc_k<WG_BK>"
                   "(wt, WG_TILE, 0, kk),\n                          "
                   "kt | kk);", "      ;")],
}
# (name, rows an image, Cin, Cout, act, sites) of cs.FUSED_SITES
VARIANT_SITES = ("res2_tail", "res3bcd_a", "res4b-f_a", "res5_tail")


def bf16_off(torch, got, ref):
    """Elements of bf16 `got` farther from `ref` than one bf16 ulp of the
    reference value plus 1e-4 of its largest entry."""
    got, ref = got.float(), ref.float()
    ulp = torch.ldexp(torch.ones_like(ref), torch.frexp(ref)[1] - 8)
    return int(((got - ref).abs() > ulp + 1e-4 * ref.abs().max()).sum())


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
                    err[o + "_off"] = bf16_off(torch, g, r)
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
        if form == "bf16" and name == "res4b-f_a":
            wrapper_host_ms(torch, op, u, sc, sh, w, y, dy, d1, d2, act)
        del u, w, dy, y, ref, fns
        torch.cuda.empty_cache()
    bp.log(f"{form}: sum over the 29 sites at batch {batch} (ms) "
           + json.dumps(total))


def wrapper_host_ms(torch, op, u, sc, sh, w, y, dy, d1, d2, act):
    """The host ms of one call of the bf16 B1, B2 and B3 wrappers (the
    checks, the tensor maps, the scratch and the launch; enqueue only),
    beside their device ms (CUDA events)."""
    calls = {
        "fwd": lambda: op.bn_act_conv1x1_fwd(u, sc, sh, w, None, act),
        "dx": lambda: op.bn_act_conv1x1_bwd_dx(u, sc, sh, w, None, y, dy, d1,
                                               d2, act),
        "dw": lambda: op.bn_act_conv1x1_bwd_dw(u, sc, sh, None, y, dy, d1,
                                               d2, act)}
    row = {}
    for k, fn in calls.items():
        fn()
        torch.cuda.synchronize()
        reps = 50
        t0 = time.perf_counter()
        for _ in range(reps):
            fn()
        host = (time.perf_counter() - t0) * 1e3 / reps
        torch.cuda.synchronize()
        row[k] = {"host_ms": host, "device_ms": cs.time_ms(torch, fn)}
    bp.log("wrapper at res4b-f_a (host enqueue vs device, ms) "
           + json.dumps(row))


def probe_variants(torch, op, nvcc, out_dir, kernel=None):
    """This revision's bf16 B1, B2 and B3 against each of VARIANTS, in turns
    (this, variant, variant, this), at VARIANT_SITES."""
    from paddle_tpu_torch.ops import _build

    started = {}
    for name, subs in VARIANTS.items():
        if kernel is not None and not name.startswith(kernel + "_"):
            continue
        d = bp.variant_source(_build.SRC_DIR, out_dir, name,
                              [(op.KERNEL + ".cu", o, n) for o, n in subs])
        started[name] = bp.start(nvcc, _build.NVCC_FLAGS,
                                 os.path.join(d, op.KERNEL + ".cu"),
                                 os.path.join(d, "variant.so"))
    this = _build.load(op.KERNEL)
    libs = {name: bp.finish(st) for name, st in started.items()}
    for lib in (this, *libs.values()):
        bind(lib, "_bf16")
    gen = torch.Generator(device="cuda").manual_seed(cs.SEED + 6)
    for site in cs.FUSED_SITES:
        name, rows, cin, cout, act, _count = site
        if name not in VARIANT_SITES:
            continue
        n = rows * cs.RESNET_AMP_BATCH
        u, sc, sh, w, _r, dy, d1, d2 = cs.fused_inputs_bf16(
            torch, gen, n, cin, cout, False)
        y = op.bn_act_conv1x1_plain(u, sc, sh, w, None, act)[0]
        relu = int(act == "relu")
        mine, _out = calls(torch, this, "_bf16", u, sc, sh, w, y, dy, d1,
                           d2, relu)
        row = {"site": name}
        for vname, lib in libs.items():
            theirs, _o = calls(torch, lib, "_bf16", u, sc, sh, w, y, dy, d1,
                               d2, relu)
            kern = vname.split("_")[0]
            ms = {"this": [], vname: []}
            for k in ("this", vname, vname, "this"):
                fn = mine[kern] if k == "this" else theirs[kern]
                ms[k].append(cs.time_ms(torch, fn))
            row[f"{vname}_ms"] = sum(ms[vname]) / 2
            row[f"this_{kern}_ms"] = sum(ms["this"]) / 2
        bp.log("variants " + json.dumps(row))
        del u, w, dy, y
        torch.cuda.empty_cache()


def wgmma_ceiling(torch, nvcc, out_dir):
    src = os.path.join(out_dir, "wgmma_bench.cu")
    with open(src, "w") as f:
        f.write(WGMMA_BENCH)
    from paddle_tpu_torch.ops import _build

    flags = (*_build.NVCC_FLAGS, "-I", _build.SRC_DIR)
    mb = bp.finish(bp.start(nvcc, flags, src, src.replace(".cu", ".so")))
    mb.wgmma_bench.argtypes = [ctypes.c_void_p, ctypes.c_int, ctypes.c_int,
                               ctypes.c_int, ctypes.c_void_p]
    iters, blocks = 256, 132
    out = torch.empty(blocks * 256, device="cuda")
    for n in (128, 256):
        ms = cs.time_ms(torch, lambda: mb.wgmma_bench(
            out.data_ptr(), n, blocks, iters,
            torch.cuda.current_stream().cuda_stream), reps=5, warmup=2)
        # 2 warpgroups x iters x 8 products of 64 x n x 16, 2 flops each
        tflops = blocks * 2 * iters * 8 * 64 * n * 16 * 2 / (ms * 1e-3) / 1e12
        bp.log(f"wgmma m64n{n}k16 bf16 (SS), {blocks} blocks of 2 "
               f"warpgroups: {ms:.4f} ms, {tflops:.1f} TFLOP/s")


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
            or (sys.argv[1] != "variants"
                and not set(sys.argv[2:]) <= set(FORMS))
            or (sys.argv[1] == "variants"
                and sys.argv[2:] not in ([], ["fwd"], ["dx"], ["dw"]))):
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
    if sys.argv[1] == "variants":
        probe_variants(torch, op, nvcc, out_dir, *sys.argv[2:])
        return 0
    started = bp.start(nvcc, _build.NVCC_FLAGS, sys.argv[1],
                       os.path.join(out_dir, "other.so"))
    libs = {"this": _build.load(op.KERNEL)}
    other_log = started[1].communicate()[0]
    with open(OUT, "a") as f:
        f.write(f"---- ptxas other\n{other_log}")
        f.write(f"---- ptxas this\n{_build.build_log(op.KERNEL)}")
    if started[1].returncode != 0:
        raise RuntimeError(f"nvcc failed building {sys.argv[1]}")
    libs["other"] = ctypes.CDLL(started[0])
    for k, log in (("other", other_log), ("this", _build.build_log(op.KERNEL))):
        bad = [line for line in log.splitlines() if SERIALISED in line]
        assert not bad, f"{k} build: ptxas serialised wgmma: {bad}"
    forms = sys.argv[2:] or [
        form for form, (suffix, *_rest) in FORMS.items()
        if hasattr(libs["other"], f"bn_act_conv1x1_fwd{suffix}")]
    for form in forms:
        probe_form(torch, op, libs, form)
        mma_ceiling(torch, nvcc, out_dir, form)
        if form == "bf16":
            wgmma_ceiling(torch, nvcc, out_dir)
    return 0


if __name__ == "__main__":
    sys.exit(main())
