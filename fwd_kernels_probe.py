#!/usr/bin/env python3
"""Variants of the two tensor-core forward kernels (B4f
`paddle_tpu_torch/csrc/flash_attn_fwd.cu`, B1 `fwd_kernel` of
`paddle_tpu_torch/csrc/bn_act_conv1x1.cu`) timed in turns on one card;
with `bf16`, B4f's bf16 form against another revision's.

    python3 fwd_kernels_probe.py
    mkdir -p _archive/parent
    git archive <rev> paddle_tpu_torch/csrc | tar -x -C _archive/parent \
        --strip-components=2
    python3 fwd_kernels_probe.py bf16 _archive/parent

The bf16 mode builds `flash_attn_fwd_bf16` of this revision, of the
revision whose csrc files are in the directory given, and of the variants
of this revision in `BF16_VARIANTS` (all at once, one nvcc each, with the
port's flags), and at the long-context trainer's shape (B=4, T=4096, H=8,
D=64, causal) and a D=128 one prints one `bf16` JSON line each: every
build's largest distance from `attention_plain_bf16` beyond one bf16 ulp
(over the largest entry), its ms timed in turns (forward, then backward
order; CUDA events, 20 calls each), TFLOP/s and share of the bound (one
bf16 pass over 989 TFLOP/s, or the bytes over 3.35 TB/s) at its faster
turn, beside `scaled_dot_product_attention` with is_causal.

Needs one CUDA card and nvcc. Each variant is the checkout's source with
one design choice undone by a text substitution (`VARIANTS`), built with
the port's nvcc flags into a scratch directory under the build
directory, and called through the same C entry point as the port's
build. For every shape it holds each variant against the plain version
(max |diff|; B1 relative to the largest |plain|), then times the
variants in turns (forward, then backward order; CUDA events, 20 calls
each) beside the library call (`scaled_dot_product_attention`, or
`torch.matmul` of the bare GEMM with TF32 off). It prints one JSON line a
shape (B1: also each variant with a residual) and, for B1, the sums over
a ResNet-50 step's 29 sites, and appends them and every variant's build
log (ptxas registers and spills) to chiprun_out/fwd_kernels_probe.txt.
"""

from __future__ import annotations

import ctypes
import json
import os
import subprocess
import sys

import chip_smoke as cs

OUT = os.path.join("chiprun_out", "fwd_kernels_probe.txt")


def emit(line):
    print(line, flush=True)
    with open(OUT, "a") as f:
        f.write(line + "\n")

SRC = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                   "paddle_tpu_torch", "csrc")

# name: (source, [(old, new)]); an empty list is the checkout's source
VARIANTS = {
    "flash": ("flash_attn_fwd.cu", []),
    "flash_cvt_split": ("flash_attn_fwd.cu",
                        [("split_tf32_alu(", "split_tf32(")]),
    "flash_one_key_group": ("flash_attn_fwd.cu",
                            [("D <= 64 && blocks < 2 * SM_COUNT", "false")]),
    "b1": ("bn_act_conv1x1.cu", []),
    "b1_cvt_split": ("bn_act_conv1x1.cu",
                     [("split_tf32_alu(", "split_tf32(")]),
    "b1_depth16": ("bn_act_conv1x1.cu",
                   [("constexpr int FWD_BK = 32;",
                     "constexpr int FWD_BK = 16;")]),
    # the wide tile (8 warps of 32 x 64) where the deep one runs
    "b1_no_deep_tile": ("bn_act_conv1x1.cu",
                        [("} else if (N > FWD_LONG_N) {",
                          "} else if (true) {")]),
    # the deep tile (4 warps of 64 x 64) where the wide one runs
    "b1_no_wide_tile": ("bn_act_conv1x1.cu",
                        [("} else if (N > FWD_LONG_N) {",
                          "} else if (false) {")]),
}

FLASH_SHAPES = [  # (name, B, T, H, D, kv_len)
    ("served_b1_t1024_h4_d64", 1, 1024, 4, 64, [1000]),
    ("train_b8_t1024_h4_d64_ragged", 8, 1024, 4, 64, list(cs.PROMPT_LENS)),
    ("b2_t1024_h4_d128", 2, 1024, 4, 128, [1024, 700]),
    ("b2_t300_h3_d96", 2, 300, 3, 96, [300, 151]),
]


def build(name, torch_build):
    src_name, subs = VARIANTS[name]
    with open(os.path.join(SRC, src_name)) as f:
        text = f.read()
    for old, new in subs:
        assert old in text, (name, old)
        text = text.replace(old, new)
    out_dir = os.path.join(torch_build.BUILD_DIR, "probe")
    os.makedirs(out_dir, exist_ok=True)
    for hdr in os.listdir(SRC):
        if hdr.endswith(".cuh"):
            with open(os.path.join(SRC, hdr)) as f, open(
                    os.path.join(out_dir, hdr), "w") as g:
                g.write(f.read())
    path = os.path.join(out_dir, f"{name}.cu")
    with open(path, "w") as f:
        f.write(text)
    lib = os.path.join(out_dir, f"{name}.so")
    cmd = [torch_build._nvcc(), *torch_build.NVCC_FLAGS, "-o", lib, path]
    return subprocess.Popen(cmd, stdout=subprocess.PIPE,
                            stderr=subprocess.STDOUT, text=True), lib


# bf16 mode: name -> [(text, its substitute)] in this revision's
# flash_attn_fwd.cu (a piece taken out gives wrong results: timed only)
BF16_VARIANTS = {
    # a three-stage K/V ring instead of four (D <= 64)
    "stages3": [("STAGES = D <= 64 ? 4 : 3;", "STAGES = 3;")],
    # S's A operand (Q) from shared memory at every D
    "q_smem": [("constexpr bool Q_REGS = D <= 64;",
                "constexpr bool Q_REGS = false;")],
    # no exponentials (p = s * c - m): what MUFU.EX2 costs; wrong results
    "no_ex2": [("ex2(fmaf(x, c, -mc[r]))", "fmaf(x, c, -mc[r])")],
}
BF16_RIGHT = ("this", "other", "stages3", "q_smem")
BF16_SHAPES = [  # (name, B, T, H, D)
    ("longctx_b4_t4096_h8_d64", 4, 4096, 8, 64),
    ("b2_t4096_h8_d128", 2, 4096, 8, 128),
]


def bf16_main(other_dir) -> int:
    """B4f's bf16 form: this revision, `other_dir`'s and the variants."""
    import torch

    import rnn_bwd_probe as bp
    from paddle_tpu_torch.ops import _build
    from paddle_tpu_torch.ops import flash_attention as fa

    bp.OUT = OUT   # the helpers of rnn_bwd_probe log into this file
    emit(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                         "--format=csv,noheader"], capture_output=True,
                        text=True).stdout.strip())
    out_dir = os.path.join(_build.BUILD_DIR, "probe_bf16")
    os.makedirs(out_dir, exist_ok=True)
    nvcc, flags, src = _build._nvcc(), _build.NVCC_FLAGS, "flash_attn_fwd.cu"
    builds = {
        "this": bp.start(nvcc, flags, os.path.join(_build.SRC_DIR, src),
                         os.path.join(out_dir, "this.so")),
        "other": bp.start(nvcc, flags, os.path.join(other_dir, src),
                          os.path.join(out_dir, "other.so"))}
    for n, subs in BF16_VARIANTS.items():
        d = bp.variant_source(_build.SRC_DIR, out_dir, n,
                              [(src, old, new) for old, new in subs])
        builds[n] = bp.start(nvcc, flags, os.path.join(d, src),
                             os.path.join(out_dir, f"{n}.so"))
    libs = {n: bp.finish(st) for n, st in builds.items()}
    p, i = ctypes.c_void_p, ctypes.c_int
    for lib in libs.values():
        lib.flash_attn_fwd_bf16.argtypes = [p] * 7 + [i] * 6 + [
            ctypes.c_float, i, p]
    stream = torch.cuda.current_stream().cuda_stream
    gen = torch.Generator(device="cuda").manual_seed(0)
    order = list(libs)
    for name, B, T, H, D in BF16_SHAPES:
        q, k, v = (torch.randn((B, T, H, D), generator=gen, device="cuda")
                   .to(torch.bfloat16) for _ in range(3))
        out = torch.empty_like(q)
        lse = torch.empty((B, H, T), device="cuda")
        ref, _ = fa.attention_plain_bf16(q, k, v, causal=True)

        def call(n):
            rc = libs[n].flash_attn_fwd_bf16(
                q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
                lse.data_ptr(), None, None, B, T, T, H, D, 1,
                1.0 / D ** 0.5, 0, stream)
            assert rc == 0, (n, rc)

        row = {"shape": name}
        for n in order:
            call(n)
            torch.cuda.synchronize()
            if n in BF16_RIGHT:
                row[f"{n}_beyond_ulp"] = cs.bf16_beyond(torch, out, ref)
        del ref
        for n in order + order[::-1]:
            row.setdefault(f"{n}_ms", []).append(
                cs.time_ms(torch, lambda: call(n)))
        pairs = cs.visible_pairs(B, T, T, True, None, None)
        flops = 4 * D * H * pairs
        nbytes = 2 * 4 * q.numel() + 4 * lse.numel()
        bound = max(flops / cs.H100_BF16_FLOPS,
                    nbytes / cs.H100_BYTES_PER_S) * 1e3
        row["bound_ms"] = bound
        for n in order:
            best = min(row[f"{n}_ms"])
            row[f"{n}_tflops"] = flops / best / 1e9
            row[f"{n}_of_bound"] = bound / best
        qt, kt, vt = (x.transpose(1, 2).contiguous() for x in (q, k, v))
        sdpa = torch.nn.functional.scaled_dot_product_attention
        row["sdpa_ms"] = cs.time_ms(torch, lambda: sdpa(qt, kt, vt,
                                                        is_causal=True))
        emit("bf16 " + json.dumps(row))
    return 0


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("fwd_kernels_probe: no CUDA device", file=sys.stderr)
        return 2
    if len(sys.argv) == 3 and sys.argv[1] == "bf16":
        os.makedirs(os.path.dirname(OUT), exist_ok=True)
        return bf16_main(sys.argv[2])
    from paddle_tpu_torch.ops import _build
    from paddle_tpu_torch.ops import bn_act_conv1x1 as op
    from paddle_tpu_torch.ops import flash_attention as fa

    torch.backends.cuda.matmul.allow_tf32 = False
    os.makedirs(os.path.dirname(OUT), exist_ok=True)
    emit(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                         "--format=csv,noheader"], capture_output=True,
                        text=True).stdout.strip())
    procs = {n: build(n, _build) for n in VARIANTS}
    libs, logs = {}, {}
    for n, (proc, lib) in procs.items():
        logs[n] = proc.communicate()[0]
        if proc.returncode != 0:
            print(f"variant {n} failed to build:\n{logs[n]}", flush=True)
            return 1
        libs[n] = ctypes.CDLL(lib)
    p, i = ctypes.c_void_p, ctypes.c_int
    for n, lib in libs.items():
        if n.startswith("flash"):
            lib.flash_attn_fwd.argtypes = [p] * 7 + [i] * 6 + [
                ctypes.c_float, i, p]
        else:
            lib.bn_act_conv1x1_fwd.argtypes = [p] * 9 + [i] * 5 + [p]
            lib.bn_act_conv1x1_scratch_floats.argtypes = [i] * 4
            lib.bn_act_conv1x1_scratch_floats.restype = ctypes.c_longlong
    stream = torch.cuda.current_stream().cuda_stream
    gen = torch.Generator(device="cuda").manual_seed(0)

    flash = [n for n in VARIANTS if n.startswith("flash")]
    for name, B, T, H, D, kv in FLASH_SHAPES:
        q, k, v = (torch.randn((B, T, H, D), generator=gen, device="cuda")
                   for _ in range(3))
        kvl = torch.tensor(kv, dtype=torch.int32, device="cuda")
        out = torch.empty_like(q)
        lse = torch.empty((B, H, T), device="cuda")
        ref, ref_lse = fa.attention_plain(q, k, v, causal=True, kv_len=kvl)

        def call(n):
            rc = libs[n].flash_attn_fwd(
                q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
                lse.data_ptr(), kvl.data_ptr(), None, B, T, T, H, D, 1,
                1.0 / D ** 0.5, 0, stream)
            assert rc == 0, (n, rc)

        row = {"shape": name}
        for n in flash:
            call(n)
            torch.cuda.synchronize()
            row[f"{n}_err"] = max((out - ref).abs().max().item(),
                                  (lse - ref_lse).abs().max().item())
        for n in flash + flash[::-1]:
            row.setdefault(f"{n}_ms", []).append(
                cs.time_ms(torch, lambda: call(n)))
        qt, kt, vt = (x.transpose(1, 2).contiguous() for x in (q, k, v))
        mask = cs.sdpa_mask(torch, B, T, T, True, kvl, None)
        sdpa = torch.nn.functional.scaled_dot_product_attention
        row["sdpa_ms"] = cs.time_ms(torch,
                                    lambda: sdpa(qt, kt, vt, attn_mask=mask))
        emit("flash " + json.dumps(row))

    b1 = [n for n in VARIANTS if n.startswith("b1")]
    sums = {}
    for site in cs.FUSED_SITES:
        name, rows, cin, cout, act, count = site
        n_rows = rows * 64
        u, sc, sh, w, res, _dy, _d1, _d2 = cs.fused_inputs(
            torch, gen, n_rows, cin, cout, True)
        y = torch.empty((n_rows, cout), device="cuda")
        ss = torch.empty((cout,), device="cuda")
        sq = torch.empty((cout,), device="cuda")
        ref = op.bn_act_conv1x1_plain(u, sc, sh, w, None, act)
        scratch = {n: torch.empty((max(1, libs[n].bn_act_conv1x1_scratch_floats(
            0, n_rows, cin, cout)),), device="cuda") for n in b1}

        def call(n, r=None):
            rc = libs[n].bn_act_conv1x1_fwd(
                u.data_ptr(), sc.data_ptr(), sh.data_ptr(), w.data_ptr(),
                None if r is None else r.data_ptr(), y.data_ptr(),
                ss.data_ptr(), sq.data_ptr(),
                scratch[n].data_ptr(), n_rows, cin, cout,
                int(act == "relu"), 0, stream)
            assert rc == 0, (n, rc)

        row = {"site": name, "n": n_rows, "cin": cin, "cout": cout}
        for n in b1:
            call(n)
            torch.cuda.synchronize()
            row[f"{n}_err"] = max(cs.rel_err(a, b)[0]
                                  for a, b in zip((y, ss, sq), ref))
        for n in b1 + b1[::-1]:
            row.setdefault(f"{n}_ms", []).append(
                cs.time_ms(torch, lambda: call(n)))
        # with a residual (the tail sites' case on the path)
        for n in b1:
            row[f"{n}_res_ms"] = cs.time_ms(torch, lambda: call(n, res))
        z = u * sc + sh
        if act == "relu":
            z = torch.clamp_min(z, 0.0)
        row["matmul_ms"] = cs.time_ms(torch, lambda: torch.matmul(z, w))
        for key in ([f"{n}_ms" for n in b1] + [f"{n}_res_ms" for n in b1]
                    + ["matmul_ms"]):
            val = row[key]
            best = min(val) if isinstance(val, list) else val
            sums[key] = sums.get(key, 0.0) + count * best
        emit("b1 " + json.dumps(row))
    emit("b1 sums over the 29 sites (ms, the faster turn) "
         + json.dumps(sums))
    with open(OUT, "a") as f:
        for n in VARIANTS:
            f.write(f"== build log {n}\n{logs[n]}\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
