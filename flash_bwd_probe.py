#!/usr/bin/env python3
"""B4b (`paddle_tpu_torch/csrc/flash_attn_bwd.cu`, the flash-attention
backward's dkv and dq kernels) in turns against another revision of the
same file, and against variants of this revision.

    mkdir -p _archive
    for f in flash_attn_bwd.cu tf32_mma.cuh; do
      git show <rev>:paddle_tpu_torch/csrc/$f > _archive/$f; done
    python3 flash_bwd_probe.py _archive

Needs one CUDA card and nvcc. Every build (the other revision's, this
revision's, one a variant) runs at once, one nvcc each, with the port's
flags; each is called through the same C entry points as the port's
build. At the two training shapes of `chip_smoke.py`'s phase 5 (LM (a):
B=32, T=128, H=4, D=64, causal; LM (b): B=8, T=1024, ragged kv_len) and
a D=128 shape it prints one `case` JSON line each:
- max |diff| / max |plain| of dq, dk and dv of the other revision and of
  this one (against `attention_bwd_plain`), and whether this one is
  bit-identical on a repeat;
- ms of each kernel of each build, timed in turns (forward, then
  backward order; CUDA events, 20 calls each), beside the kernels'
  bounds (`chip_smoke.bwd_bounds`) and SDPA's backward;
- ms of this revision with one design choice undone or one piece taken
  out by a text substitution (`VARIANTS`; a piece taken out gives wrong
  results and is timed only).
Builds, substitutions and the log are `rnn_bwd_probe`'s helpers. Every
line and every build's ptxas report (registers, spills) are appended to
`chiprun_out/flash_bwd_probe.txt`.

    mkdir -p _archive/parent
    git archive <rev> paddle_tpu_torch/csrc | tar -x -C _archive/parent \
        --strip-components=2
    python3 flash_bwd_probe.py bf16 _archive/parent

The bf16 mode does the same for the bf16 forms (`flash_attn_bwd_dkv_bf16`,
`flash_attn_bwd_dq_bf16`) of this revision, of the revision whose csrc
files are in the directory given and of this revision's `BF16_VARIANTS`,
at the long-context trainer's shape (B=4, T=4096, H=8, D=64, causal) and a
D=128 one: each build's largest distance from `attention_bwd_plain_bf16`
beyond one bf16 ulp (over the largest entry), its ms timed in turns,
TFLOP/s and share of the bound (`chip_smoke.bwd_bounds`, one bf16 pass) at
its faster turn, beside SDPA's bf16 backward (is_causal).
"""

from __future__ import annotations

import ctypes
import json
import os
import subprocess
import sys

import chip_smoke as cs
import rnn_bwd_probe as bp

OUT = os.path.join("chiprun_out", "flash_bwd_probe.txt")
KERNEL = "flash_attn_bwd.cu"

# name: ([(text, its substitute)] in this revision's flash_attn_bwd.cu,
# whether the variant still computes the backward)
VARIANTS = {
    # the splits by cvt.rna (a quarter-rate unit) instead of integer ops
    "cvt_split": ([("split_tf32_alu(", "split_tf32(")], True),
    # dkv in one group of four warps at every D: each warp sums all of
    # dK's and dV's columns (spills at D = 96 and 128)
    "one_column_group": ([("CG = D <= 64 ? 1 : 2;", "CG = 1;")], True),
    # one walk group at every walk length (the rule takes two from 3 tiles)
    "one_walk_group": ([("KG_MIN_WALK = 3;", "KG_MIN_WALK = 1 << 30;")],
                       True),
    # two walk groups at every walk length (LM (a)'s 2-tile walks too)
    "two_walk_groups": ([("KG_MIN_WALK = 3;", "KG_MIN_WALK = 0;")], True),
    # the ring's next tile waited for before this one's products: no
    # copy in flight while the block computes
    "no_overlap": ([("cp_async_wait<1>();", "cp_async_wait<0>();")], True),
    # no exp (p = s * scale - lse): the cost of the exponentials
    "no_exp": ([("expf(", "(")], False),
    # one TF32 pass (hi * hi) instead of three: the lo passes' cost
    "one_pass": ([("mma3_step<1, NT>(acc, ahi, alo, bhi, blo);",
                   "one_pass_step<1, NT>(acc, ahi, bhi);"),
                  ("mma3_step<1, DH>(acc, ahi, alo, bhi, blo);",
                   "one_pass_step<1, DH>(acc, ahi, bhi);")], False),
}
ONE_PASS_STEP = """
template <int MT, int NT>
__device__ __forceinline__ void one_pass_step(float (&acc)[MT][NT][4],
                                              const unsigned (&ahi)[MT][4],
                                              const unsigned (&bhi)[NT][2]) {
#pragma unroll
  for (int i = 0; i < MT; ++i)
#pragma unroll
    for (int j = 0; j < NT; ++j) mma_tf32(acc[i][j], ahi[i], bhi[j]);
}
"""

SHAPES = [  # (name, B, T, H, D, kv_len)
    ("train_b32_t128_h4_d64", 32, 128, 4, 64, None),
    ("train_b8_t1024_h4_d64_ragged", 8, 1024, 4, 64, list(cs.PROMPT_LENS)),
    ("b2_t1024_h4_d128_ragged", 2, 1024, 4, 128, [1024, 700]),
]


def variant_subs(name):
    """VARIANTS[name]'s substitutions as rnn_bwd_probe.variant_source
    takes them; one_pass also gets its step function."""
    subs = [(KERNEL, old, new) for old, new in VARIANTS[name][0]]
    if name == "one_pass":
        subs.append((KERNEL, '#include "tf32_mma.cuh"\n',
                     '#include "tf32_mma.cuh"\n' + ONE_PASS_STEP))
    return subs


def bind(lib):
    p, i = ctypes.c_void_p, ctypes.c_int
    lib.flash_attn_bwd_dkv.argtypes = [p] * 10 + [i] * 6 + [
        ctypes.c_float, i, p]
    lib.flash_attn_bwd_dq.argtypes = [p] * 9 + [i] * 6 + [
        ctypes.c_float, i, p]
    return lib


# bf16 mode: name -> [(text, its substitute)] in this revision's
# flash_attn_bwd.cu (a piece taken out gives wrong results: timed only)
BF16_VARIANTS = {
    # three-stage rings instead of four (dkv's query tiles, dq's key tiles)
    "stages3": [("  static constexpr int STAGES = 4;\n"
                 "  static constexpr int K_BYTES",
                 "  static constexpr int STAGES = 3;\n"
                 "  static constexpr int K_BYTES"),
                ("  static constexpr int STAGES = 4;\n"
                 "  static constexpr int Q_BYTES",
                 "  static constexpr int STAGES = 3;\n"
                 "  static constexpr int Q_BYTES")],
    # the first products' A operand from shared memory at every D
    "a_smem": [("constexpr bool A_REGS = D <= 64;",
                "constexpr bool A_REGS = false;")],
    # no exponentials (p = s * c - lse): what MUFU.EX2 costs; wrong results
    "no_ex2": [("float p = ex2(fmaf(st[e], c,", "float p = (fmaf(st[e], c,"),
               ("const float p = ex2(fmaf(sc[e], c, -lse2[r]));",
                "const float p = fmaf(sc[e], c, -lse2[r]);")],
}
BF16_RIGHT = ("this", "other", "stages3", "a_smem")
BF16_SHAPES = [  # (name, B, T, H, D)
    ("longctx_b4_t4096_h8_d64", 4, 4096, 8, 64),
    ("b2_t4096_h8_d128", 2, 4096, 8, 128),
]


def bf16_main(other_dir) -> int:
    """B4b's bf16 forms: this revision, `other_dir`'s and the variants."""
    import torch

    from paddle_tpu_torch.ops import _build
    from paddle_tpu_torch.ops import flash_attention as fa

    os.makedirs(os.path.dirname(OUT), exist_ok=True)
    bp.OUT = OUT
    bp.log(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True).stdout.strip())
    out_dir = os.path.join(_build.BUILD_DIR, "bwd_probe_bf16")
    os.makedirs(out_dir, exist_ok=True)
    nvcc, flags = _build._nvcc(), _build.NVCC_FLAGS
    builds = {
        "this": bp.start(nvcc, flags, os.path.join(_build.SRC_DIR, KERNEL),
                         os.path.join(out_dir, "this.so")),
        "other": bp.start(nvcc, flags, os.path.join(other_dir, KERNEL),
                          os.path.join(out_dir, "other.so"))}
    for n, subs in BF16_VARIANTS.items():
        d = bp.variant_source(_build.SRC_DIR, out_dir, n,
                              [(KERNEL, old, new) for old, new in subs])
        builds[n] = bp.start(nvcc, flags, os.path.join(d, KERNEL),
                             os.path.join(out_dir, f"{n}.so"))
    libs = {}
    for n, st in builds.items():
        lib = bp.finish(st)
        p, i = ctypes.c_void_p, ctypes.c_int
        lib.flash_attn_bwd_dkv_bf16.argtypes = [p] * 10 + [i] * 6 + [
            ctypes.c_float, i, p]
        lib.flash_attn_bwd_dq_bf16.argtypes = [p] * 9 + [i] * 6 + [
            ctypes.c_float, i, p]
        libs[n] = lib

    stream = torch.cuda.current_stream().cuda_stream
    gen = torch.Generator(device="cuda").manual_seed(0)
    order = list(libs)
    for name, B, T, H, D in BF16_SHAPES:
        q, k, v, do = (torch.randn((B, T, H, D), generator=gen,
                                   device="cuda").to(torch.bfloat16)
                       for _ in range(4))
        out, lse = fa.flash_attention(q, k, v, causal=True)
        ref = fa.attention_bwd_plain_bf16(q, k, v, out, lse, do,
                                          causal=True)
        delta = fa.row_delta(do, out)
        dq, dk, dv = (torch.empty_like(x) for x in (q, k, v))
        scale = 1.0 / D ** 0.5

        def dkv_call(n):
            rc = libs[n].flash_attn_bwd_dkv_bf16(
                q.data_ptr(), k.data_ptr(), v.data_ptr(), do.data_ptr(),
                lse.data_ptr(), delta.data_ptr(), dk.data_ptr(),
                dv.data_ptr(), None, None, B, T, T, H, D, 1, scale, 0,
                stream)
            assert rc == 0, (n, rc)

        def dq_call(n):
            rc = libs[n].flash_attn_bwd_dq_bf16(
                q.data_ptr(), k.data_ptr(), v.data_ptr(), do.data_ptr(),
                lse.data_ptr(), delta.data_ptr(), dq.data_ptr(), None, None,
                B, T, T, H, D, 1, scale, 0, stream)
            assert rc == 0, (n, rc)

        pairs = cs.visible_pairs(B, T, T, True, None, None)
        bounds = cs.bwd_bounds(B, T, T, H, D, pairs, 0, bf16=True)
        row = {"case": name, "dkv_bound_ms": bounds["dkv"][0],
               "dq_bound_ms": bounds["dq"][0]}
        for n in order:
            dkv_call(n)
            dq_call(n)
            torch.cuda.synchronize()
            if n in BF16_RIGHT:
                row[f"{n}_beyond_ulp"] = max(
                    cs.bf16_beyond(torch, g, r)
                    for g, r in zip((dq, dk, dv), ref))
        del ref
        for n in order + order[::-1]:
            row.setdefault(f"{n}_dkv_ms", []).append(
                cs.time_ms(torch, lambda: dkv_call(n)))
            row.setdefault(f"{n}_dq_ms", []).append(
                cs.time_ms(torch, lambda: dq_call(n)))
        for n in order:
            for part, fpp in (("dkv", 8), ("dq", 6)):
                best = min(row[f"{n}_{part}_ms"])
                row[f"{n}_{part}_tflops"] = fpp * D * H * pairs / best / 1e9
                row[f"{n}_{part}_of_bound"] = bounds[part][0] / best
            row[f"{n}_sum_ms"] = (min(row[f"{n}_dkv_ms"])
                                  + min(row[f"{n}_dq_ms"]))
        qt, kt, vt = (x.transpose(1, 2).contiguous().requires_grad_(True)
                      for x in (q, k, v))
        dot = do.transpose(1, 2).contiguous()
        sdpa = torch.nn.functional.scaled_dot_product_attention

        def sdpa_fwd():
            with torch.no_grad():
                sdpa(qt, kt, vt, is_causal=True)

        def sdpa_fwd_bwd():
            torch.autograd.grad(sdpa(qt, kt, vt, is_causal=True),
                                (qt, kt, vt), dot)

        row["sdpa_bwd_ms"] = (cs.time_ms(torch, sdpa_fwd_bwd)
                              - cs.time_ms(torch, sdpa_fwd))
        bp.log("bf16 " + json.dumps(row))
    return 0


def main() -> int:
    import torch

    if not torch.cuda.is_available() or len(sys.argv) not in (2, 3):
        print(__doc__, file=sys.stderr)
        return 2
    if sys.argv[1] == "bf16" and len(sys.argv) == 3:
        return bf16_main(sys.argv[2])
    other_dir = sys.argv[1]
    from paddle_tpu_torch.ops import _build
    from paddle_tpu_torch.ops import flash_attention as fa

    torch.backends.cuda.matmul.allow_tf32 = False
    os.makedirs(os.path.dirname(OUT), exist_ok=True)
    bp.OUT = OUT   # the helpers of rnn_bwd_probe log into this file
    bp.log(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True).stdout.strip())
    out_dir = os.path.join(_build.BUILD_DIR, "bwd_probe")
    os.makedirs(out_dir, exist_ok=True)
    nvcc = _build._nvcc()
    flags = _build.NVCC_FLAGS
    builds = {
        "other": bp.start(nvcc, flags, os.path.join(other_dir, KERNEL),
                          os.path.join(out_dir, "other.so")),
        "this": bp.start(nvcc, flags, os.path.join(_build.SRC_DIR, KERNEL),
                         os.path.join(out_dir, "this.so"))}
    for n in VARIANTS:
        d = bp.variant_source(_build.SRC_DIR, out_dir, n, variant_subs(n))
        builds[n] = bp.start(nvcc, flags, os.path.join(d, KERNEL),
                             os.path.join(out_dir, f"{n}.so"))
    libs = {n: bind(bp.finish(st)) for n, st in builds.items()}

    stream = torch.cuda.current_stream().cuda_stream
    gen = torch.Generator(device="cuda").manual_seed(0)
    order = list(libs)
    for name, B, T, H, D, kv in SHAPES:
        q, k, v, do = (torch.randn((B, T, H, D), generator=gen,
                                   device="cuda") for _ in range(4))
        kvl = (None if kv is None
               else torch.tensor(kv, dtype=torch.int32, device="cuda"))
        kw = dict(causal=True, kv_len=kvl)
        out, lse = fa.flash_attention(q, k, v, **kw)
        ref = fa.attention_bwd_plain(q, k, v, out, lse, do, **kw)
        delta = torch.einsum("bqhd,bqhd->bhq", do, out).contiguous()
        dq, dk, dv = (torch.empty_like(x) for x in (q, k, v))
        scale = 1.0 / D ** 0.5
        kvp = None if kvl is None else kvl.data_ptr()

        def dkv_call(n):
            rc = libs[n].flash_attn_bwd_dkv(
                q.data_ptr(), k.data_ptr(), v.data_ptr(), do.data_ptr(),
                lse.data_ptr(), delta.data_ptr(), dk.data_ptr(),
                dv.data_ptr(), kvp, None, B, T, T, H, D, 1, scale, 0,
                stream)
            assert rc == 0, (n, rc)

        def dq_call(n):
            rc = libs[n].flash_attn_bwd_dq(
                q.data_ptr(), k.data_ptr(), v.data_ptr(), do.data_ptr(),
                lse.data_ptr(), delta.data_ptr(), dq.data_ptr(), kvp, None,
                B, T, T, H, D, 1, scale, 0, stream)
            assert rc == 0, (n, rc)

        pairs = cs.visible_pairs(B, T, T, True, kv, None)
        bounds = cs.bwd_bounds(B, T, T, H, D, pairs, int(kv is not None))
        row = {"case": name, "dkv_bound_ms": bounds["dkv"][0],
               "dkv_bound_by": bounds["dkv"][1],
               "dq_bound_ms": bounds["dq"][0], "dq_bound_by": bounds["dq"][1]}
        for n in order:
            dkv_call(n)
            dq_call(n)
            torch.cuda.synchronize()
            right = n in ("other", "this") or VARIANTS[n][1]
            if right:
                row[f"{n}_rel_err"] = max(cs.rel_err(g, r)[0] for g, r in
                                          zip((dq, dk, dv), ref))
            if n == "this":
                first = [x.clone() for x in (dq, dk, dv)]
                dkv_call(n)
                dq_call(n)
                torch.cuda.synchronize()
                row["this_bit_identical"] = all(
                    torch.equal(a, b) for a, b in zip(first, (dq, dk, dv)))
        for n in order + order[::-1]:
            row.setdefault(f"{n}_dkv_ms", []).append(
                cs.time_ms(torch, lambda: dkv_call(n)))
            row.setdefault(f"{n}_dq_ms", []).append(
                cs.time_ms(torch, lambda: dq_call(n)))
        qt, kt, vt = (x.transpose(1, 2).contiguous().requires_grad_(True)
                      for x in (q, k, v))
        dot = do.transpose(1, 2).contiguous()
        mask = cs.sdpa_mask(torch, B, T, T, True, kvl, None)
        sdpa = torch.nn.functional.scaled_dot_product_attention

        def sdpa_fwd():
            with torch.no_grad():
                sdpa(qt, kt, vt, attn_mask=mask)

        def sdpa_fwd_bwd():
            torch.autograd.grad(sdpa(qt, kt, vt, attn_mask=mask),
                                (qt, kt, vt), dot)

        row["sdpa_bwd_ms"] = (cs.time_ms(torch, sdpa_fwd_bwd)
                              - cs.time_ms(torch, sdpa_fwd))
        bp.log("case " + json.dumps(row))
    return 0


if __name__ == "__main__":
    sys.exit(main())
