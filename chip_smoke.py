#!/usr/bin/env python3
"""Chip smoke of the PyTorch/CUDA port (`paddle_tpu_torch`).

    python3 chip_smoke.py

Needs one CUDA card (an H100: the kernels are built for sm_90a) and the
CUDA toolkit's nvcc. It drives the port only — nothing of JAX or of
`paddle_tpu` — in nineteen phases and six that run its paths or its
kernels' forms under the bf16 flag (3b, 5b, 6c, 6d, 7b, 9c, 13b), and
any failure exits non-zero:

1. the card (`nvidia-smi` name and power limit), torch and CUDA
   versions; TF32 off;
2. builds every kernel from `paddle_tpu_torch/csrc` (one nvcc per
   source, in parallel) and prints the build seconds and ptxas report;
3. holds the flash-attention kernel against its plain PyTorch version
   on the card at ten shapes, four of them the prefill shapes of phase
   4 and one LM (b)'s training forward of phase 6 (max |diff| <= 1e-4
   on out and on the lse of rows with a visible key: f32 with another
   summation order; rows with no visible key exactly out == 0 and lse
   == 1e30; bit-identical on a repeat), and times
   kernel, plain version and `scaled_dot_product_attention` (a
   yardstick only — the port never calls it);
3b. holds the kernel's bf16 form against its bf16 plain version at the
   same ten shapes, the long-context trainer's (B=4, T=4096, H=8,
   D=64, causal) and the edges of its 128-row tiles at D = 32, 64, 96
   and 128 (`BF16_EDGE_SHAPES`: T = 127, 129, 200, kv_len mid-tile,
   Tq != Tk with q_len and a kv_len = 0 row, K and V rows past kv_len
   holding NaN): out element by element within one bf16 ulp plus
   2e-3 of the largest entry, lse within 1e-4, rows with no visible key
   exactly out 0 and lse 1e30, bit-identical on a repeat, only the bf16
   form launched, and no farther from the f32 plain version on the same
   inputs than the bf16 plain version is (within an ulp); times it, the
   bf16 plain version and SDPA on bf16 with is_causal and no mask (a
   yardstick) beside the bound (bf16 bytes; one pass at 989 TFLOP/s);
4. serves the paged Transformer LM at the repo's served width
   (LMSpec(vocab=2048, d_model=256, num_heads=4, num_layers=2,
   attn_impl="flash") over PagedKVCache(num_pages=256, page_size=16,
   max_pages_per_seq=64), weights from a numpy seed) behind the TCP
   front end, sends concurrent requests through ServeClient, checks
   every answer against the port's dense full-recompute reference
   through the first eos, and checks that every prefill went through
   the kernel (one launch per layer per prefill);
5. holds the flash-attention backward kernels (dkv and dq) against
   their plain PyTorch version on the card at the training shapes of
   phase 6 (B=32, T=128 full; B=8, T=1024 ragged) and four more (D=32
   with odd T, D=128 cross-attention with q_len, a kv_len=0 row, D=96):
   max |diff| / max |plain| <= 1e-4 for dq, dk and dv, dq of rows with
   no visible key and dk, dv of keys past kv_len exactly 0, every value
   finite, bit-identical on a repeat; times the kernels (CUDA events,
   and their device time from torch.profiler, which the kernels line
   gives beside as `device_ms`), the plain version and the backward of
   `scaled_dot_product_attention` (a yardstick only: forward+backward
   minus forward) beside their bounds (three TF32 passes, as phase 3's);
5b. the same for the backward kernels' bf16 forms against their bf16
   plain version at phase 5's six shapes, the long-context one and
   `BF16_EDGE_SHAPES` (within one bf16 ulp plus 5e-3 of the largest entry), from the bf16
   forward's out and lse, with SDPA's bf16 backward as the yardstick;
6. trains the Transformer LM at the same width through the port's
   trainer (`SGD.train`, attn_impl="flash", weights from a numpy
   seed): first one train step (`TrainStep`) of the flash conf
   against the same step of the dense conf at B=32, T=128 and at B=8,
   T=1024 (loss and every gradient within 1e-4 relative; the dense step
   runs at the flash step's ReLU gates, so that a gate whose
   preactivation lies within rounding of 0 cannot open in one step and
   not the other — the free dense step's flips are printed), then
   (a) 20 steps of momentum SGD (lr 0.001, mu 0.9) at
   B=32, T=128 and (b) 300 steps of adam (lr 0.001) on one fixed batch
   at B=8, T=1024 with ragged lengths (next-token batches from a fixed
   random walk over the vocabulary); every loss finite, (b) falls to
   at most half its first value, and each flash kernel launched once
   per layer per step;
6c. trains the LM at bench.py::bench_lm_train's settings (the same
   width, B=32, T=128, dense attention, momentum 0.001 / 0.9) under the
   bf16 flag (`matmul_precision`, the AMP cast rule): one step held
   against the f32 step from the same weights (every gradient within
   2e-2 plus twice the most bf16 moves the JAX package's gradient of
   the LM at this width, capped at 0.3), then 20 steps on (a)'s batches:
   every loss finite, the last below the first, the first within 5% of
   the f32 loss, masters f32; tokens/s and profile;
6d. trains bench.py::bench_longctx's model (longctx_conf: vocab 32000,
   d 512, 8 heads, 2 layers, 512 classes; its feed, seed 0; adam 1e-3)
   under the bf16 flag, attn_impl flash against dense from one weight
   map: (a) one held step at B=4, T=4096 (losses within 5%, each
   gradient within 2e-2 plus twice the most bf16 moves the JAX
   package's gradient of this conf, in relative L2 norm); (b) 20 steps
   an arm at B=4, T=4096 and (c) 10 at B=1, T=8192 through
   SGD.train_batch, in windows of 5 taken in turns (bench.py's
   _interleaved_best): every loss finite, each arm's last below its
   first, ms/step, tokens/s, fused_speedup, peak memory and profiles;
   the flash arm launches each bf16 form once a layer a step and no
   f32 form, the dense arm none;
7. holds the fused BN->ReLU->1x1-conv kernels (B1 forward, B2 and B3
   backward, `csrc/bn_act_conv1x1.cu`) against their plain PyTorch
   versions at the nine ResNet-50 site shapes at batch 32 and four
   ragged shapes, each with act relu or linear and with or without a
   residual (max |diff| / max |plain| <= 1e-4 for y, ssum, ssq, du,
   dscale, dshift, dres and dw, with non-zero cotangents of ssum and
   ssq; all three bit-identical on a repeat), then times them at the
   sites' batch-64 shapes beside the plain versions, the bare GEMM in
   torch.matmul (a yardstick only) and their bounds (on the tensor
   cores, three TF32 passes), with each kernel's launch plan;
7b. holds the kernels' bf16 forms (the wgmma kernels B1
   `fwd_wgmma_kernel`, B2 and B3, whose build must report no
   serialised wgmma) against their bf16 plain versions at the nine
   sites at batch 32, four ragged shapes (widths multiples of 8) and
   fourteen at the edges of the tiles and stages (rows 1, 127, 129,
   255, 257; widths 8, 72, 136, 200, 2048, Cout 264, Cin 520 and 2056;
   a B3 row split whose chunk boundary falls inside a stage; three B1
   walks whose ring and y buffers wrap), act relu or
   linear, with or without a residual, non-zero
   cotangents of ssum and ssq: the f32 outputs (ssum, ssq, dscale,
   dshift, dw before its cast) within 1e-4 of the largest, the bf16
   ones (y, du, dres, dw after its cast) element by element within one
   bf16 ulp plus 1e-4 of the largest, bit-identical on a repeat, no f32
   form launched; then times them at the sites' batch-256 shapes beside
   the bf16 plain versions, torch.matmul of the bf16 GEMM (a yardstick)
   and their bounds (one bf16 pass, bf16 bytes);
8. runs ResNet-50 (224x224x3, 1000 classes, weights from a seed)
   through `Inferencer` on [8, 224, 224, 3], plain and fused from the
   same weights and running statistics (advanced by three train-mode
   forwards): logits within 1e-4 of the largest, 29 B1 launches a
   fused forward;
9. trains it through the port's trainer with momentum (lr 0.001,
   mu 0.9): (a) one fused step against one plain step at B=8 (loss
   and new BN state within 1e-4; gradients held where no ReLU gate
   between them and the loss flipped), and the same for the two-block
   net of the CPU tests, where every gradient is held (its ReLU gate
   flips are printed; none may flip); (b) 30 fused
   steps of `SGD.train` on one fixed batch at B=64: every loss
   finite, the last below the first, 29 launches of each fused kernel
   a step; then 10 plain steps for their step time; each run profiled
   for 5 more steps;
9c. trains it under the bf16 flag at bench.py::bench_resnet50's
   settings: (a) one step at B=8 three ways from one weight map, plain
   f32, plain AMP and fused AMP: the fused AMP loss, new BN state and
   each gradient within twice the plain AMP step's own distance from
   the f32 step plus 1e-3 (relative), beside a witness, the f32 step
   on weights and images rounded to bf16; (b) 20
   fused steps of `SGD.train` at B=256 on one fixed batch: every loss
   finite, the last below the first, 29 launches of each bf16 form a
   step (B1 `fwd_wgmma_kernel`, B2 and B3 the backward wgmma kernels)
   and none of an f32 form; (c) 10 plain AMP steps; images/s, ms/step,
   peak memory and the profiles, with each port kernel's device ms a
   step;
10. holds the LSTM and GRU sequence kernels (B5 forward with and
    without the cell sequence, B6 backward, `csrc/lstm_seq.cu`; B7
    forward and B8 backward, `csrc/gru_seq.cu`) against their plain
    PyTorch versions at the path shapes (the classifier's layers, B=64,
    T=100, h=256; the NMT encoder, B=256, T=32, h=256), at the bench's
    other widths h=512 and 1280, and at ragged lengths with a 0 and a 1
    (max |diff| / max |plain| <= 1e-4 for every output, exactly 0 past
    each row's length), prints each case's routes (`fwd_plan`,
    `bwd_plan`: the cluster route where the kernel's weight slice fits a
    block, h <= 320, else the walk), holds each cluster route
    bit-identical on a repeat and the walk against the plain version too
    wherever a case takes both routes, and times kernel, plain version,
    each kernel on the walk where a case takes both routes, and cuDNN's
    torch.nn.LSTM/GRU (another function: a reference point only) with
    the bounds;
11. runs the IMDB stacked-LSTM classifier (vocab 30000, emb 128, two
    layers of h=256; weights from a seed) through `Inferencer` on
    [64, 100] ids, the kernel arm against the scan arm
    (use_pallas_rnn=False): probabilities within 1e-5, two B5 launches,
    both on the cluster route;
12. one adam train step of the classifier (lr 2e-3) and of the
    attention NMT (vocab 30000, emb 512, hidden 512, GRU h=256 a
    direction; lr 1e-3), kernel arm against scan arm from one weight
    map at ragged lengths, with the scan arm in f64 as the exact
    reference: the loss within 1e-4, every gradient within 1e-4 (of its
    largest entry) plus twice the scan arm's own f32 error against f64,
    and the kernel arm as close to f64 as the scan arm, within 1e-4;
13. trains both through `SGD.train` at the bench's full lengths on one
    fixed batch — the classifier 30 steps at B=64, T=100, the NMT 20
    steps at B=256, T=32 — then 10 steps of each on the scan arm: every
    loss falls, ms/step, tokens/s, peak memory and the profile table,
    and the kernel arm launches 2 B5 + 2 B6 (classifier) or 2 B7 + 2 B8
    (NMT) a step, every one on the cluster route;
13b. one adam step of the classifier and of the NMT on the kernel arm
    under the bf16 flag (B5-B8 cast bf16 up to f32 around the kernels):
    loss finite and within 5% of the f32 step's, gradients f32 and
    each held against the f32 step's as in 6c, B5 and B6 (classifier)
    or B7 and B8 (NMT) launched twice each, on the cluster route;
14. holds the sparse-row kernels (B9, `csrc/sparse_rows.cu`: the rule
    kernel and the generic route's gather and scatter) against their
    plain PyTorch version at the two bench shapes (V = 2^20 x 64, N =
    65 536 and 16 384, momentum), SGD, adagrad, a user's function,
    overflow, 16 384 occurrences on 100 ids, D = 4/16/128, ids >= V, and
    140 000 distinct ids with one negative (past one slot a warp):
    the touched rows and slots within 1e-6 of the largest, every other
    row bit-equal to the start, the kernel bit-identical run to run;
    times kernel, torch.sort, the plain version, SGD's index_add_ (a
    yardstick only) and the bounds;
15. the standalone update as bench.py::bench_sparse_ctr: momentum
    tables of 2^20 and 2^22 x 64, 65 536 ids a step, 20 steps a
    `SparseUpdater.run_steps`, held against 20 plain steps (rtol 1e-5,
    atol 1e-6), ms a step and the V ratio; at 2^20 the bench's own
    update function through the generic route too;
16. the wide&deep large-table train step as
    bench.py::bench_ctr_widedeep_sparse (bs 256, t 64, tower 64/32/2,
    dense SGD 0.05, row momentum 0.01/0.9) at V = 2^20 and 2^22: one
    step kernel route vs plain route within 1e-6, then 5 warm and 5 x
    10 timed steps, examples/s, the V ratio and a profile;
17. the sharded embedding tier (2^30 logical rows x 64, 2^18 cached,
    adagrad) for 40 steps of 256 x 64 ids from a hot set of 2^20 ids,
    one shard, then 5 steps with 8 shards and hash placement, each held
    against the same steps of a CPU table through the export payloads;
18. the CTR models through SGD: ctr_wide_deep at its defaults, adam
    0.02, 30 steps on one batch of 256 x 64 features (the loss halves),
    and one ctr_linear step with adagrad;
19. prints the kernels' JSON line and, last, the device line.

Exits 2 without printing a result when no CUDA device is present.
"""

from __future__ import annotations

import dataclasses
import json
import os
import subprocess
import sys
import threading
import time

import numpy as np

# published peaks of one H100 SXM at its 700 W limit (NVIDIA data sheet)
H100_BYTES_PER_S = 3.35e12
H100_TF32_FLOPS = 495e12
H100_BF16_FLOPS = 989e12     # dense bf16 mma
TOL = 1e-4
SEED = 0
EOS = 1
MAX_NEW = 32
PROMPT_LENS = (990, 700, 513, 620, 850, 300, 64, 17)
# phase 6(b): adam's learning rate and the steps it needs on one batch of
# this width to halve the loss. On an H100, lr 0.01 took 30 steps of
# random labels only to 0.80x, and 200 steps of the next-token batch
# diverged (to 1.29x): a step of 0.01 is a sixth of the weights' 1/16
# scale.
LR_B = 0.001
STEPS_B = 300


T_START = time.perf_counter()


def phase(name):
    print(f"== {name} (at {time.perf_counter() - T_START:.1f} s)",
          flush=True)


def time_ms(torch, fn, reps=20, warmup=3):
    """Mean device time of fn() over `reps` back-to-back calls, from
    CUDA events (warm; inputs stay resident in L2 where they fit)."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def visible_pairs(B, Tq, Tk, causal, kv_len, q_len):
    """Number of (query, key) pairs the masks leave visible, per head."""
    n = 0
    for b in range(B):
        kl = Tk if kv_len is None else min(kv_len[b], Tk)
        ql = Tq if q_len is None else min(q_len[b], Tq)
        for i in range(ql):
            n += min(kl, i + 1) if causal else kl
    return n


def set_amp(on):
    """The port's `matmul_precision` flag: "bfloat16" (the AMP cast rule,
    as bench.py::_setup sets it for every bench row) or "default"."""
    from paddle_tpu_torch.core import flags

    flags.set_flag("matmul_precision", "bfloat16" if on else "default")


def rel_err(got, ref):
    """max |got - ref| / max |ref| (0 when both are 0), and max |diff|."""
    diff = (got - ref).abs().max().item()
    scale = ref.abs().max().item()
    return (diff / scale if scale > 0 else diff), diff


def lens_tensor(torch, x):
    return None if x is None else torch.tensor(x, dtype=torch.int32,
                                               device="cuda")


def sdpa_mask(torch, B, Tq, Tk, causal, kv_len, q_len):
    """[B, 1, Tq, Tk] bool, True = may attend (SDPA's convention)."""
    qpos = torch.arange(Tq, device="cuda")[:, None]
    kpos = torch.arange(Tk, device="cuda")[None, :]
    mask = torch.ones((B, 1, Tq, Tk), dtype=torch.bool, device="cuda")
    if kv_len is not None:
        mask &= kpos < kv_len.view(B, 1, 1, 1)
    if q_len is not None:
        mask &= qpos < q_len.view(B, 1, 1, 1)
    if causal:
        mask &= kpos <= qpos
    return mask


def check_kernel(torch, fa, case, gen):
    """Kernel vs plain version on the card at one shape; returns the
    case's numbers."""
    B, Tq, Tk, H, D = (case[k] for k in ("B", "Tq", "Tk", "H", "D"))
    dev = torch.device("cuda")
    q = torch.randn((B, Tq, H, D), generator=gen, device=dev)
    k = torch.randn((B, Tk, H, D), generator=gen, device=dev)
    v = torch.randn((B, Tk, H, D), generator=gen, device=dev)

    kv_len = lens_tensor(torch, case.get("kv_len"))
    q_len = lens_tensor(torch, case.get("q_len"))
    kw = dict(causal=case["causal"], kv_len=kv_len, q_len=q_len)
    out_k, lse_k = fa.flash_attention(q, k, v, **kw)
    again = fa.flash_attention(q, k, v, **kw)
    out_p, lse_p = fa.attention_plain(q, k, v, **kw)
    torch.cuda.synchronize()
    assert torch.equal(out_k, again[0]) and torch.equal(lse_k, again[1]), (
        f"{case['name']}: kernel not bit-identical on a repeat")
    alive = lse_p < 1e29                               # [B, H, Tq]
    dead = ~alive
    err_out = (out_k - out_p).abs().max().item()
    err_lse = (lse_k - lse_p).abs()[alive].max().item()
    dead_out = out_k.permute(0, 2, 1, 3)[dead]
    dead_ok = bool((dead_out == 0).all().item()
                   and (lse_k[dead] == 1e30).all().item())
    n_dead = int(dead.sum().item())
    if case.get("expect_dead"):
        assert n_dead > 0, f"{case['name']}: expected fully-masked rows"
    assert torch.isfinite(out_k).all().item(), case["name"]
    assert err_out <= TOL and err_lse <= TOL, (
        f"{case['name']}: kernel vs plain out {err_out:.3g} lse "
        f"{err_lse:.3g} > {TOL}"
    )
    assert dead_ok, f"{case['name']}: masked rows not exactly 0 / 1e30"

    kernel_ms = time_ms(torch, lambda: fa.flash_attention(q, k, v, **kw))
    plain_ms = time_ms(torch, lambda: fa.attention_plain(q, k, v, **kw))
    # scaled_dot_product_attention on the same inputs, [B, H, T, D]
    # layout made beforehand
    qt, kt, vt = (x.transpose(1, 2).contiguous() for x in (q, k, v))
    mask = sdpa_mask(torch, B, Tq, Tk, case["causal"], kv_len, q_len)
    sdpa = torch.nn.functional.scaled_dot_product_attention
    library_ms = time_ms(torch, lambda: sdpa(qt, kt, vt, attn_mask=mask))

    pairs = visible_pairs(B, Tq, Tk, case["causal"], case.get("kv_len"),
                          case.get("q_len"))
    flops = 4 * D * H * pairs                 # QK^T and PV, 2 per MAC
    nbytes = 4 * (q.numel() + k.numel() + v.numel() + out_k.numel()
                  + lse_k.numel()
                  + (B if kv_len is not None else 0)
                  + (B if q_len is not None else 0))
    t_bytes = nbytes / H100_BYTES_PER_S * 1e3
    # three TF32 passes on the tensor cores (hi*hi + hi*lo + lo*hi)
    t_ops = 3 * flops / H100_TF32_FLOPS * 1e3
    res = {
        "name": case["name"], "err_out": err_out, "err_lse": err_lse,
        "masked_rows": n_dead, "kernel_ms": kernel_ms,
        "plain_ms": plain_ms, "library_ms": library_ms,
        "bound_ms": max(t_bytes, t_ops),
        "bound_by": "bytes" if t_bytes >= t_ops else "operations",
        "flops": flops, "bytes": nbytes,
    }
    print(json.dumps(res), flush=True)
    return res


def random_params(spec, lm):
    rng = np.random.default_rng(SEED)
    out = {}
    for name, shape in lm.lm_param_shapes(spec).items():
        if len(shape) == 1:
            out[name] = np.zeros(shape, np.float32)
        else:
            out[name] = (rng.standard_normal(shape)
                         / np.sqrt(shape[0])).astype(np.float32)
    return out


def serve_lm(torch, fa):
    from paddle_tpu_torch.decoding.kv_cache import PagedKVCache, PagedLM
    from paddle_tpu_torch.models import lm
    from paddle_tpu_torch.serving.lm_engine import PagedLMModel
    from paddle_tpu_torch.serving.server import InferenceServer, ServeConfig
    from paddle_tpu_torch.serving.tcp import ServeClient, ServingTCPServer
    from paddle_tpu_torch.weights import params_from_numpy

    spec = lm.LMSpec(vocab=2048, d_model=256, num_heads=4, num_layers=2,
                     attn_impl="flash")
    params = params_from_numpy(random_params(spec, lm), device="cuda")
    cache = PagedKVCache(spec, num_pages=256, page_size=16,
                         max_pages_per_seq=64, device="cuda")
    assert max(PROMPT_LENS) + MAX_NEW <= cache.max_seq_len
    plm = PagedLM(spec, params, cache, eos_id=EOS)
    model = PagedLMModel(plm, slots=4, max_new=MAX_NEW)
    buckets = tuple(16 * 2 ** i for i in range(7))     # 16 .. 1024
    server = InferenceServer(ServeConfig(buckets=buckets,
                                         default_deadline_s=60))
    server.add_model("lm", model)
    tcp = ServingTCPServer(server)

    rng = np.random.default_rng(SEED + 1)
    prompts = [rng.integers(2, spec.vocab, n).astype(np.int32)
               for n in PROMPT_LENS]
    answers = [None] * len(prompts)

    def client(i):
        with ServeClient(f"127.0.0.1:{tcp.port}") as cl:
            answers[i] = cl.call("lm", prompts[i], timeout=600)

    threads = [threading.Thread(target=client, args=(i,))
               for i in range(len(prompts))]
    fa.launches = 0
    t0 = time.perf_counter()
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=900)
    wall = time.perf_counter() - t0
    launches = fa.launches
    assert not any(t.is_alive() for t in threads), "a request hung"

    tcp.stop_accepting()
    server.shutdown(drain=True, timeout=60)
    tcp.stop(drain=True)
    stats = server.stats()
    print("server stats " + json.dumps(stats), flush=True)
    for i, a in enumerate(answers):
        assert a is not None and a.get("ok"), f"request {i}: {a}"
    assert stats["completed"] == len(prompts) and stats["failed"] == 0

    eng = model.lm_engine
    n_tok = sum(len(a["tokens"]) for a in answers)
    lat = sorted(a["latency_ms"] for a in answers)
    print(f"served {len(prompts)} requests, {n_tok} tokens in "
          f"{wall:.3f} s: {n_tok / wall:.1f} tokens/s "
          f"({stats['batches']} batches); request latency ms "
          f"median {lat[len(lat) // 2]} max {lat[-1]}", flush=True)
    print("engine " + json.dumps({
        "prefills": eng.prefill_dispatches,
        "decode_steps": eng.decode_dispatches,
        "enqueue_s": eng.timeline["dispatch_s"],
        "device_s": eng.timeline["device_s"],
        "cache_hit_frac": eng.cache_hit_frac,
        "reprefilled_tokens": eng.reprefilled_tokens,
        "prefilled_tokens": cache.prefilled_tokens,
        "appended_tokens": cache.appended_tokens,
        "cached_prefix_tokens": cache.cached_prefix_tokens,
        "evictions": cache.evictions,
        "free_pages": cache.free_page_count(),
    }), flush=True)
    assert cache.free_page_count() == cache.num_pages - 1  # scratch page
    print(f"flash launches {launches} for {eng.prefill_dispatches} "
          f"prefills x {spec.num_layers} layers", flush=True)
    assert eng.prefill_dispatches >= len(prompts)
    assert launches >= spec.num_layers * eng.prefill_dispatches, (
        "the prefill did not go through the flash kernel"
    )

    # the reference: dense full recompute, plain torch, on the card
    ref_spec = dataclasses.replace(spec, attn_impl="dense")
    lens = np.asarray(PROMPT_LENS, np.int32)
    ids = np.zeros((len(prompts), lens.max()), np.int32)
    for i, p in enumerate(prompts):
        ids[i, :len(p)] = p
    ref, _ = lm.greedy_decode_recompute(ref_spec, params, ids, lens,
                                        MAX_NEW, EOS)
    for i, a in enumerate(answers):
        row = [int(x) for x in ref[i]]
        want = row[:row.index(EOS)] if EOS in row else row
        got = a["tokens"]
        if got == want:
            print(f"request {i} (len {lens[i]}): {len(got)} tokens "
                  f"equal to the reference", flush=True)
            continue
        t = next(j for j in range(min(len(got), len(want)) + 1)
                 if j >= len(got) or j >= len(want) or got[j] != want[j])
        seq = np.concatenate([prompts[i], np.asarray(want[:t], np.int32)])
        with torch.no_grad():
            logits = lm.lm_forward(
                ref_spec, params,
                torch.as_tensor(seq[None], device="cuda"),
            )
        top2 = torch.topk(lm.lm_logp(logits[0, -1]), 2).values
        margin = (top2[0] - top2[1]).item()
        print(f"request {i} (len {lens[i]}): differs at step {t}; "
              f"reference top-2 log-prob margin {margin:.3g}", flush=True)
        assert margin < 1e-4, f"request {i} disagrees with the reference"
    return launches


def bwd_bounds(B, Tq, Tk, H, D, pairs, n_lens, bf16=False):
    """{"bwd" | "dkv" | "dq": (bound ms, "bytes" | "operations")} of the
    flash backward at one shape with `pairs` visible pairs a head and
    `n_lens` int32 [B] masks: the larger of each input read once and
    each output written once over 3.35 TB/s, and its flops as three
    TF32 passes on the tensor cores (hi*hi + hi*lo + lo*hi) over 495
    TFLOP/s, or for the bf16 forms (bf16 q, k, v, out, dO, dq, dk, dv;
    lse and delta f32) one bf16 pass over 989 TFLOP/s."""
    f32 = 4
    el = 2 if bf16 else f32
    qo = B * Tq * H * D * el           # one [B, Tq, H, D] tensor
    kv = B * Tk * H * D * el           # one [B, Tk, H, D] tensor
    rows = B * H * Tq * f32            # lse or delta
    lens = f32 * B * n_lens
    passes, peak = (1, H100_BF16_FLOPS) if bf16 else (3, H100_TF32_FLOPS)

    def bound(flops_per_pair, nbytes):
        t_ops = passes * flops_per_pair * D * H * pairs / peak * 1e3
        t_bytes = nbytes / H100_BYTES_PER_S * 1e3
        return max(t_ops, t_bytes), ("bytes" if t_bytes >= t_ops
                                     else "operations")

    return {
        # the whole backward: recomputed QK^T, dV, dP, dQ, dK (2 flops
        # per MAC each); q, k, v, out, dO and lse read, dq, dk, dv written
        "bwd": bound(10, 4 * qo + 4 * kv + rows + lens),
        # dkv: QK^T, dP, dV, dK; q, k, v, dO, lse, delta read, dk, dv
        # written
        "dkv": bound(8, 2 * qo + 2 * kv + 2 * rows + 2 * kv + lens),
        # dq: QK^T, dP, dQ; q, k, v, dO, lse, delta read, dq written
        "dq": bound(6, 2 * qo + 2 * kv + 2 * rows + qo + lens),
    }


def check_backward(torch, fa, case, gen):
    """Backward kernels vs attention_bwd_plain on the card at one shape;
    returns the case's numbers."""
    B, Tq, Tk, H, D = (case[k] for k in ("B", "Tq", "Tk", "H", "D"))
    dev = torch.device("cuda")
    q = torch.randn((B, Tq, H, D), generator=gen, device=dev)
    k = torch.randn((B, Tk, H, D), generator=gen, device=dev)
    v = torch.randn((B, Tk, H, D), generator=gen, device=dev)
    do = torch.randn((B, Tq, H, D), generator=gen, device=dev)
    kv_len = lens_tensor(torch, case.get("kv_len"))
    q_len = lens_tensor(torch, case.get("q_len"))
    kw = dict(causal=case["causal"], kv_len=kv_len, q_len=q_len)
    out, lse = fa.flash_attention(q, k, v, **kw)
    got = fa.flash_attention_bwd(q, k, v, out, lse, do, **kw)
    again = fa.flash_attention_bwd(q, k, v, out, lse, do, **kw)
    ref = fa.attention_bwd_plain(q, k, v, out, lse, do, **kw)
    torch.cuda.synchronize()
    assert all(torch.equal(a, b) for a, b in zip(got, again)), (
        f"{case['name']}: backward kernels not bit-identical on a repeat")
    errs = {n: rel_err(g, r) for n, g, r in zip(("dq", "dk", "dv"), got,
                                                 ref)}
    for b, n in enumerate(case.get("kv_len") or []):
        assert bool((got[1][b, n:] == 0).all().item()
                    and (got[2][b, n:] == 0).all().item()), (
            f"{case['name']}: dk, dv of keys past kv_len not exactly 0")
    dead = (lse >= fa.LSE_MASKED).permute(0, 2, 1)          # [B, Tq, H]
    n_dead = int(dead.sum().item())
    if case.get("expect_dead"):
        assert n_dead > 0, f"{case['name']}: expected rows without keys"
    assert bool((got[0][dead] == 0).all().item()), (
        f"{case['name']}: dq of rows without keys is not exactly 0")
    for n, g in zip(("dq", "dk", "dv"), got):
        assert torch.isfinite(g).all().item(), f"{case['name']}: {n}"
        assert errs[n][0] <= TOL, (
            f"{case['name']}: kernel vs plain {n} relative error "
            f"{errs[n][0]:.3g} > {TOL}")

    delta = torch.einsum("bqhd,bqhd->bhq", do, out).contiguous()

    def dkv():
        fa.flash_attention_bwd_dkv(q, k, v, do, lse, delta, **kw)

    def dq():
        fa.flash_attention_bwd_dq(q, k, v, do, lse, delta, **kw)

    dkv_ms = time_ms(torch, dkv)
    dq_ms = time_ms(torch, dq)
    # the kernels' own device time: where a call's host work outlasts
    # its kernel (LM (a)'s shape), back-to-back calls time the host
    device_ms = {
        n: profile_fn(torch, fn, steps=20)["port_kernels_ms_per_step"][
            f"B4b flash_attn_bwd_{n}"] for n, fn in (("dkv", dkv), ("dq", dq))}
    bwd_ms = time_ms(torch, lambda: fa.flash_attention_bwd(
        q, k, v, out, lse, do, **kw))
    fwd_ms = time_ms(torch, lambda: fa.flash_attention(q, k, v, **kw))
    plain_ms = time_ms(torch, lambda: fa.attention_bwd_plain(
        q, k, v, out, lse, do, **kw))
    # SDPA's backward: forward+backward minus forward, [B, H, T, D]
    # layout made beforehand
    qt, kt, vt = (x.transpose(1, 2).contiguous().requires_grad_(True)
                  for x in (q, k, v))
    dot = do.transpose(1, 2).contiguous()
    mask = sdpa_mask(torch, B, Tq, Tk, case["causal"], kv_len, q_len)
    sdpa = torch.nn.functional.scaled_dot_product_attention

    def sdpa_fwd():
        with torch.no_grad():
            sdpa(qt, kt, vt, attn_mask=mask)

    def sdpa_fwd_bwd():
        torch.autograd.grad(sdpa(qt, kt, vt, attn_mask=mask), (qt, kt, vt),
                            dot)

    library_ms = (time_ms(torch, sdpa_fwd_bwd) - time_ms(torch, sdpa_fwd))

    pairs = visible_pairs(B, Tq, Tk, case["causal"], case.get("kv_len"),
                          case.get("q_len"))
    bounds = bwd_bounds(B, Tq, Tk, H, D, pairs,
                        (kv_len is not None) + (q_len is not None))
    bwd_bound, dkv_bound, dq_bound = (bounds[n] for n in ("bwd", "dkv",
                                                            "dq"))
    res = {
        "name": case["name"], "masked_rows": n_dead,
        "rel_err": {n: e[0] for n, e in errs.items()},
        "max_abs_err": {n: e[1] for n, e in errs.items()},
        "dkv_ms": dkv_ms, "dq_ms": dq_ms,
        "dkv_device_ms": device_ms["dkv"], "dq_device_ms": device_ms["dq"],
        "bwd_ms": bwd_ms,
        "fwd_ms": fwd_ms, "plain_ms": plain_ms, "library_ms": library_ms,
        "bound_ms": bwd_bound[0], "bound_by": bwd_bound[1],
        "dkv_bound_ms": dkv_bound[0], "dkv_bound_by": dkv_bound[1],
        "dq_bound_ms": dq_bound[0], "dq_bound_by": dq_bound[1],
        "pairs_per_head": pairs,
    }
    print(json.dumps(res), flush=True)
    return res


# ---- the bf16 forms of B4f and B4b (phases 3b, 5b) ---------------------

# Phases 3b and 5b hold each bf16 output element by element within one
# bf16 ulp of the bf16 plain version plus a fraction of its largest
# entry: the kernel rounds p against the running max, the plain version
# against the row's final one, and s, dp are summed in another order.
# tests/test_torch_attention.py and tests/test_torch_flash_bwd.py state
# these fractions from their readings (the library kernel in interpret
# mode and an emulation of the forward kernel against the plain
# versions: up to 9.8e-4 and 3.4e-3 of the largest entry beyond an ulp).
BF16_OUT_FRAC, BF16_GRAD_FRAC = 2e-3, 5e-3
# the long-context trainer's attention (phase 6d at B=4, T=4096)
LONGCTX_SHAPE = dict(name="longctx_b4_t4096_h8_d64", B=4, Tq=4096, Tk=4096,
                     H=8, D=64, causal=True)
# the edges of the bf16 kernels' tiles (128-row query and key blocks,
# 64-key and 64- or 32-query walked tiles): T one short of and one past a
# tile, a kv_len ending mid-tile, Tq != Tk with q_len and a kv_len = 0 row,
# and K, V rows past kv_len holding NaN (TMA fills only rows past T: the
# masks must keep them out), at every head dim the wrapper takes (96 runs
# padded to 128); not profiled
BF16_EDGE_SHAPES = [
    dict(name=f"edge_{name}_d{D}", D=D, edge=True, **case)
    for D in (32, 64, 96, 128)
    for name, case in (
        ("causal_t127_ragged", dict(B=2, Tq=127, Tk=127, H=2, causal=True,
                                    kv_len=[127, 70])),
        ("causal_t129", dict(B=1, Tq=129, Tk=129, H=2, causal=True)),
        ("causal_t200_kvlen_mid_tile", dict(B=2, Tq=200, Tk=200, H=2,
                                            causal=True, kv_len=[200, 150])),
        ("cross_tq129_tk200_qlen_kvlen0", dict(
            B=2, Tq=129, Tk=200, H=2, causal=False, kv_len=[0, 77],
            q_len=[129, 100], expect_dead=True)),
        ("causal_t200_nan_past_kvlen", dict(
            B=2, Tq=200, Tk=200, H=2, causal=True, kv_len=[130, 61],
            nan_past_kv_len=True)),
    )
]


def bf16_beyond(torch, got, ref):
    """The largest |got - ref| beyond one bf16 ulp of ref, over max |ref|
    (at most 0: within an ulp everywhere)."""
    got, ref = got.float(), ref.float()
    ulp = torch.ldexp(torch.ones_like(ref), torch.frexp(ref)[1] - 8)
    top = ref.abs().max().item()
    return ((got - ref).abs() - ulp).max().item() / (top if top > 0 else 1.0)


def no_farther(torch, got, plain, exact, what):
    """The witness: the kernel's output no farther from the f32 plain
    version on the same bf16 inputs than the bf16 plain version is,
    within one bf16 ulp of the largest entry. Returns both distances."""
    top = exact.abs().max()
    ulp = torch.ldexp(torch.ones_like(top), torch.frexp(top)[1] - 8).item()
    far_k = (got.float() - exact).abs().max().item()
    far_p = (plain.float() - exact).abs().max().item()
    assert far_k <= far_p + ulp, (
        f"{what}: kernel {far_k:.4g} from f32, bf16 plain {far_p:.4g} "
        f"(+ ulp {ulp:.3g})")
    return far_k, far_p


def bf16_qkv(torch, case, gen, with_dout=False):
    B, Tq, Tk, H, D = (case[k] for k in ("B", "Tq", "Tk", "H", "D"))
    shapes = [(B, Tq, H, D), (B, Tk, H, D), (B, Tk, H, D)]
    if with_dout:
        shapes.append((B, Tq, H, D))
    return [torch.randn(s, generator=gen, device="cuda").to(torch.bfloat16)
            for s in shapes]


def kernel_kv(case, k, v):
    """k and v as the kernels get them: for a `nan_past_kv_len` case,
    copies with every row at or past kv_len[b] set to NaN (no visible
    pair reads them; the references take the finite k and v)."""
    if not case.get("nan_past_kv_len"):
        return k, v
    k, v = k.clone(), v.clone()
    for b, n in enumerate(case["kv_len"]):
        k[b, n:] = float("nan")
        v[b, n:] = float("nan")
    return k, v


def check_kernel_bf16(torch, fa, case, gen):
    """Phase 3b: the bf16 form of B4f against attention_plain_bf16 on the
    card at one shape: out within one bf16 ulp + BF16_OUT_FRAC of the
    largest entry, lse within TOL where a key is visible, rows without
    one exactly out 0 and lse 1e30, bit-identical on a repeat, only the
    bf16 form launched, and the witness (`no_farther`). Times the
    kernel, the bf16 plain version and scaled_dot_product_attention on
    the bf16 [B, H, T, D] inputs with is_causal and no mask (its flash
    backend, a yardstick the port never calls: it does not apply
    kv_len or q_len) beside the bound (bf16 bytes; one bf16 pass)."""
    B, Tq, Tk, H, D = (case[k] for k in ("B", "Tq", "Tk", "H", "D"))
    q, k, v = bf16_qkv(torch, case, gen)
    kv_len = lens_tensor(torch, case.get("kv_len"))
    q_len = lens_tensor(torch, case.get("q_len"))
    kw = dict(causal=case["causal"], kv_len=kv_len, q_len=q_len)
    kk, vk = kernel_kv(case, k, v)
    before = {n: getattr(fa, n) for n in fa.COUNTERS}
    out_k, lse_k = fa.flash_attention(q, kk, vk, **kw)
    again = fa.flash_attention(q, kk, vk, **kw)
    torch.cuda.synchronize()
    ran = {n: getattr(fa, n) - c for n, c in before.items() if
           getattr(fa, n) != c}
    assert ran == {"bf16_launches": 2}, f"{case['name']}: launched {ran}"
    out_p, lse_p = fa.attention_plain_bf16(q, k, v, **kw)
    exact, _ = fa.attention_plain(q, k, v, **kw)
    torch.cuda.synchronize()
    assert torch.equal(out_k, again[0]) and torch.equal(lse_k, again[1]), (
        f"{case['name']}: bf16 kernel not bit-identical on a repeat")
    assert out_k.dtype == torch.bfloat16 and lse_k.dtype == torch.float32
    assert torch.isfinite(out_k).all().item(), case["name"]
    alive = lse_p < 1e29
    dead = ~alive
    beyond = bf16_beyond(torch, out_k, out_p)
    err_lse = (lse_k - lse_p).abs()[alive].max().item()
    assert beyond <= BF16_OUT_FRAC and err_lse <= TOL, (
        f"{case['name']}: bf16 kernel vs plain out {beyond:.3g} of the "
        f"largest beyond an ulp (> {BF16_OUT_FRAC}), lse {err_lse:.3g}")
    n_dead = int(dead.sum().item())
    if case.get("expect_dead"):
        assert n_dead > 0, f"{case['name']}: expected fully-masked rows"
    assert bool((out_k.permute(0, 2, 1, 3)[dead] == 0).all().item()
                and (lse_k[dead] == 1e30).all().item()), (
        f"{case['name']}: masked rows not exactly 0 / 1e30")
    far_k, far_p = no_farther(torch, out_k, out_p, exact, case["name"])
    del exact, again

    kernel_ms = time_ms(torch, lambda: fa.flash_attention(q, kk, vk, **kw))
    plain_ms = time_ms(torch, lambda: fa.attention_plain_bf16(q, k, v,
                                                              **kw),
                       reps=5, warmup=1)
    qt, kt, vt = (x.transpose(1, 2).contiguous() for x in (q, k, v))
    sdpa = torch.nn.functional.scaled_dot_product_attention
    library_ms = time_ms(torch, lambda: sdpa(qt, kt, vt,
                                             is_causal=case["causal"]))
    pairs = visible_pairs(B, Tq, Tk, case["causal"], case.get("kv_len"),
                          case.get("q_len"))
    flops = 4 * D * H * pairs
    nbytes = (2 * (q.numel() + k.numel() + v.numel() + out_k.numel())
              + 4 * (lse_k.numel() + B * ((kv_len is not None)
                                          + (q_len is not None))))
    t_bytes = nbytes / H100_BYTES_PER_S * 1e3
    t_ops = flops / H100_BF16_FLOPS * 1e3
    res = {
        "name": case["name"], "beyond_ulp_frac": beyond, "err_lse": err_lse,
        "max_abs_err": (out_k.float() - out_p.float()).abs().max().item(),
        "witness_kernel_vs_f32": far_k, "witness_plain_vs_f32": far_p,
        "masked_rows": n_dead, "kernel_ms": kernel_ms, "plain_ms": plain_ms,
        "library_ms": library_ms, "bound_ms": max(t_bytes, t_ops),
        "bound_by": "bytes" if t_bytes >= t_ops else "operations",
        "flops": flops, "bytes": nbytes,
    }
    print("bf16 " + json.dumps(res), flush=True)
    return res


def check_backward_bf16(torch, fa, case, gen):
    """Phase 5b: the bf16 forms of B4b against attention_bwd_plain_bf16
    on the card at one shape, from the bf16 forward's out and lse: dq,
    dk and dv within one bf16 ulp + BF16_GRAD_FRAC of the largest entry,
    dq of rows without keys and dk, dv of keys past kv_len exactly 0,
    finite, bit-identical on a repeat, only the bf16 forms launched, and
    the witness against the f32 plain backward on the same inputs. Times
    dkv and dq (CUDA events, and device time from torch.profiler), the
    bf16 plain version and SDPA's backward on bf16 with is_causal and no
    mask (forward+backward minus forward; a yardstick) beside the
    bounds (bf16 bytes; one bf16 pass)."""
    B, Tq, Tk, H, D = (case[k] for k in ("B", "Tq", "Tk", "H", "D"))
    q, k, v, do = bf16_qkv(torch, case, gen, with_dout=True)
    kv_len = lens_tensor(torch, case.get("kv_len"))
    q_len = lens_tensor(torch, case.get("q_len"))
    kw = dict(causal=case["causal"], kv_len=kv_len, q_len=q_len)
    kk, vk = kernel_kv(case, k, v)
    out, lse = fa.flash_attention(q, kk, vk, **kw)
    before = {n: getattr(fa, n) for n in fa.COUNTERS}
    got = fa.flash_attention_bwd(q, kk, vk, out, lse, do, **kw)
    again = fa.flash_attention_bwd(q, kk, vk, out, lse, do, **kw)
    torch.cuda.synchronize()
    ran = {n: getattr(fa, n) - c for n, c in before.items() if
           getattr(fa, n) != c}
    assert ran == {"bwd_dkv_bf16_launches": 2, "bwd_dq_bf16_launches": 2}, (
        f"{case['name']}: launched {ran}")
    assert all(torch.equal(a, b) for a, b in zip(got, again)), (
        f"{case['name']}: bf16 backward kernels not bit-identical")
    del again
    ref = fa.attention_bwd_plain_bf16(q, k, v, out, lse, do, **kw)
    out32, lse32 = fa.attention_plain(q, k, v, **kw)
    exact = fa.attention_bwd_plain(q, k, v, out32, lse32, do, **kw)
    del out32, lse32
    res = {"name": case["name"], "beyond_ulp_frac": {}, "max_abs_err": {},
           "witness": {}}
    for n, g, r, e in zip(("dq", "dk", "dv"), got, ref, exact):
        assert g.dtype == torch.bfloat16, f"{case['name']}: {n} {g.dtype}"
        assert torch.isfinite(g).all().item(), f"{case['name']}: {n}"
        res["beyond_ulp_frac"][n] = bf16_beyond(torch, g, r)
        res["max_abs_err"][n] = (g.float() - r.float()).abs().max().item()
        assert res["beyond_ulp_frac"][n] <= BF16_GRAD_FRAC, (
            f"{case['name']}: bf16 {n} {res['beyond_ulp_frac'][n]:.3g} of "
            f"the largest beyond an ulp (> {BF16_GRAD_FRAC})")
        res["witness"][n] = no_farther(torch, g, r, e,
                                       f"{case['name']} {n}")
    del ref, exact
    for b, n in enumerate(case.get("kv_len") or []):
        assert bool((got[1][b, n:] == 0).all().item()
                    and (got[2][b, n:] == 0).all().item()), (
            f"{case['name']}: bf16 dk, dv of keys past kv_len not 0")
    dead = (lse >= fa.LSE_MASKED).permute(0, 2, 1)
    res["masked_rows"] = int(dead.sum().item())
    if case.get("expect_dead"):
        assert res["masked_rows"] > 0, f"{case['name']}: expected dead rows"
    assert bool((got[0][dead] == 0).all().item()), (
        f"{case['name']}: bf16 dq of rows without keys is not exactly 0")

    delta = fa.row_delta(do, out)
    # the kernels' own inputs: D padded as flash_attention_bwd pads it
    d_pad = fa.kernel_head_dim(D, fa.BF16_KERNEL_HEAD_DIMS)
    qp, kp, vp, dop = (fa.pad_head_dim(x, d_pad) for x in (q, kk, vk, do))
    kwp = dict(kw, scale=1.0 / D ** 0.5)

    def dkv():
        fa.flash_attention_bwd_dkv(qp, kp, vp, dop, lse, delta, **kwp)

    def dq():
        fa.flash_attention_bwd_dq(qp, kp, vp, dop, lse, delta, **kwp)

    res["dkv_ms"], res["dq_ms"] = time_ms(torch, dkv), time_ms(torch, dq)
    for n, fn in (("dkv", dkv), ("dq", dq)):
        prof = None if case.get("edge") else profile_fn(torch, fn, steps=20)
        res[f"{n}_device_ms"] = (None if prof is None else
                                 prof["port_kernels_ms_per_step"].get(
                                     f"B4b flash_attn_bwd_{n}_bf16"))
    res["plain_ms"] = time_ms(torch, lambda: fa.attention_bwd_plain_bf16(
        q, k, v, out, lse, do, **kw), reps=5, warmup=1)
    qt, kt, vt = (x.transpose(1, 2).contiguous().requires_grad_(True)
                  for x in (q, k, v))
    dot = do.transpose(1, 2).contiguous()
    sdpa = torch.nn.functional.scaled_dot_product_attention

    def sdpa_fwd():
        with torch.no_grad():
            sdpa(qt, kt, vt, is_causal=case["causal"])

    def sdpa_fwd_bwd():
        torch.autograd.grad(sdpa(qt, kt, vt, is_causal=case["causal"]),
                            (qt, kt, vt), dot)

    res["library_ms"] = time_ms(torch, sdpa_fwd_bwd) - time_ms(torch,
                                                               sdpa_fwd)
    pairs = visible_pairs(B, Tq, Tk, case["causal"], case.get("kv_len"),
                          case.get("q_len"))
    bounds = bwd_bounds(B, Tq, Tk, H, D, pairs,
                        (kv_len is not None) + (q_len is not None),
                        bf16=True)
    for n in ("dkv", "dq"):
        res[f"{n}_bound_ms"], res[f"{n}_bound_by"] = bounds[n]
    res["pairs_per_head"] = pairs
    print("bf16 " + json.dumps(res), flush=True)
    return res


def lm_batches(rng, n, B, T, lens, vocab):
    """n next-token batches (ids, labels, lens): each row walks one
    fixed random permutation of the vocabulary from a random start and
    the label is the next token, so the target is learnable; ids and
    labels are 0 past each row's length."""
    perm = rng.permutation(vocab)
    live = np.arange(T)[None, :] < lens[:, None]
    out = []
    for _ in range(n):
        seq = np.empty((B, T + 1), np.int64)
        seq[:, 0] = rng.integers(0, vocab, B)
        for t in range(T):
            seq[:, t + 1] = perm[seq[:, t]]
        out.append(((seq[:, :-1] * live).astype(np.int32),
                    (seq[:, 1:] * live).astype(np.int32), lens))
    return out


def lm_feed(batch):
    from paddle_tpu_torch.core.arg import id_arg

    ids, lbl, lens = batch
    return {"ids": id_arg(ids, lens, device="cuda"),
            "label": id_arg(lbl, lens, device="cuda")}


# the port's kernels in a profile, by a piece of their (demangled) names:
# every template instantiation of one kernel adds to its row
PORT_KERNELS = {
    "B1 bn_act_conv1x1_fwd": "namespace)::fwd_kernel<",
    "B2 bn_act_conv1x1_bwd_dx": "bwd_dx_kernel<",
    "B3 bn_act_conv1x1_bwd_dw": "bwd_dw_kernel<",
    "B1 bn_act_conv1x1_fwd_bf16_wgmma": "namespace)::fwd_wgmma_kernel<",
    "B2 bn_act_conv1x1_bwd_dx_bf16_wgmma": "bwd_dx_wgmma_kernel<",
    "B3 bn_act_conv1x1_bwd_dw_bf16_wgmma": "bwd_dw_wgmma_kernel<",
    "B4f flash_attn_fwd": "flash_fwd_kernel<",
    "B4b flash_attn_bwd_dkv": "flash_bwd_dkv_kernel<",
    "B4b flash_attn_bwd_dq": "flash_bwd_dq_kernel<",
    "B4f flash_attn_fwd_bf16": "flash_fwd_wgmma_kernel<",
    "B4b flash_attn_bwd_dkv_bf16": "flash_bwd_dkv_wgmma_kernel<",
    "B4b flash_attn_bwd_dq_bf16": "flash_bwd_dq_wgmma_kernel<",
    "B5 lstm_seq_fwd cluster walk": "lstm_fwd_cluster_kernel<",
    "B5 lstm_seq_fwd grid route": "lstm_fwd_grid_kernel<",
    "B6 lstm_seq_bwd cluster walk": "lstm_bwd_cluster_kernel<",
    "B6 lstm_seq_bwd grid route": "lstm_bwd_grid_kernel<",
    "B6 lstm_seq_bwd grid route's db7": "lstm_bias_grad_kernel",
    "B7 gru_seq_fwd cluster walk": "gru_fwd_cluster_kernel<",
    "B7 gru_seq_fwd walk route": "gru_fwd_kernel<",
    "B8 gru_seq_bwd cluster walk": "gru_bwd_cluster_kernel<",
    "B8 gru_seq_bwd walk route": "gru_bwd_kernel<",
    # the cluster and grid routes' hoisted pre-activations and dW (B6's in
    # the classifier's step, B8's in the NMT's)
    "B6/B8 tc_kernel (hoisted products, dW)": "tc_kernel<",
}


def profile_fn(torch, fn, steps=5):
    """Where the time of fn() goes: `steps` calls under torch.profiler.
    Returns the device's kernel ms per call, the eight kernels with the
    most device time and the port's kernels' ms per call (all their
    instantiations); None when the profiler sees no device time."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(steps):
            fn()
        torch.cuda.synchronize()
    cuda = torch.autograd.DeviceType.CUDA
    kernels = [e for e in prof.key_averages()
               if e.device_type == cuda and e.self_device_time_total > 0]
    if not kernels:
        return None
    busy_us = sum(e.self_device_time_total for e in kernels)
    top = sorted(kernels, key=lambda e: -e.self_device_time_total)[:8]
    port = {}
    for label, piece in PORT_KERNELS.items():
        us = sum(e.self_device_time_total for e in kernels if piece in e.key)
        if us:
            port[label] = us / steps / 1e3
    return {
        "device_ms_per_step": busy_us / steps / 1e3,
        "kernels_per_step": sum(e.count for e in kernels) / steps,
        "port_kernels_ms_per_step": port,
        "top": [{"name": e.key[:60], "ms_per_step":
                 e.self_device_time_total / steps / 1e3,
                 "calls_per_step": e.count / steps} for e in top],
    }


def profile_steps(torch, sgd, feed, steps=5):
    """Where a train step's time goes: `steps` steps under
    torch.profiler, after the counted run (these launches are not the
    main path's)."""
    return profile_fn(torch, lambda: sgd.train_batch(feed), steps)


def train_lm(torch, fa):
    """Phase 6: the LM through the port's trainer on the card. Returns
    the numbers of both runs."""
    from paddle_tpu_torch.core.config import OptimizationConf
    from paddle_tpu_torch.models import lm
    from paddle_tpu_torch.network import Network
    from paddle_tpu_torch.optimizers import create_optimizer
    from paddle_tpu_torch.parallel.dp import TrainStep
    from paddle_tpu_torch.trainer.events import EndIteration
    from paddle_tpu_torch.trainer.trainer import SGD
    from paddle_tpu_torch.weights import params_from_numpy

    spec = lm.LMSpec(vocab=2048, d_model=256, num_heads=4, num_layers=2,
                     attn_impl="flash")
    conf = lm.transformer_lm(spec)
    np_params = random_params(spec, lm)
    rng = np.random.default_rng(SEED + 2)
    full = np.full((32,), 128, np.int32)
    ragged = np.asarray(PROMPT_LENS, np.int32)
    batches_a = lm_batches(rng, 20, 32, 128, full, spec.vocab)
    batch_b = lm_batches(rng, 1, 8, 1024, ragged, spec.vocab)[0]

    # one TrainStep of the flash conf against the same step of the dense
    # conf (plain torch): same params, same feed, momentum from a zero
    # state, so each new momentum slot is -lr * the parameter's gradient
    opt_a = OptimizationConf(learning_method="momentum",
                             learning_rate=0.001, momentum=0.9)
    # A ReLU whose preactivation lies within f32 rounding of 0 can open in
    # one step and not the other, and every gradient below it then differs
    # by that token's share (LM (b) flips one). So the dense step runs at
    # the flash step's gates: its feed-forward ReLUs become products with
    # the flash step's 0/1 masks (the same function wherever the gates
    # agree), and every gradient is held at TOL at both shapes.
    parity = {}
    for name, batch in (("b32_t128", batches_a[0]), ("b8_t1024", batch_b)):
        feed = lm_feed(batch)
        got = {}
        for impl in ("flash", "dense"):
            net = Network(lm.transformer_lm(dataclasses.replace(
                spec, attn_impl=impl)))
            params = params_from_numpy(np_params, device="cuda")
            with torch.no_grad():
                gates = [net.forward(params, feed)[0][f"lm_ff{i}"].value > 0
                         for i in range(spec.num_layers)]
            if impl == "dense":
                for i, mask in enumerate(got["flash"][2]):
                    net.layers[f"lm_ff{i}"].activation = (
                        lambda m=mask: lambda y: y * m)
            opt = create_optimizer(opt_a, net.param_confs)
            step = TrainStep(net, opt, watchdog=True, device="cuda")
            _p, mom, _s, health, _o = step(params, opt.init_state(params),
                                           {}, feed, 0, None)
            got[impl] = (health, mom, gates)
        (hf, mf, gf), (hd, md, gd) = got["flash"], got["dense"]
        loss_rel = abs(hf[0].item() - hd[0].item()) / abs(hd[0].item())
        worst = max((rel_err(mf[k]["mom"], md[k]["mom"])[0], k) for k in md)
        flips = sum(int((a != b).sum().item()) for a, b in zip(gf, gd))
        parity[name] = {"loss_flash": hf[0].item(), "loss_dense": hd[0].item(),
                        "loss_rel": loss_rel, "grad_rel": worst[0],
                        "worst_param": worst[1],
                        "relu_gate_flips_of_the_free_dense_step": flips,
                        "finite": bool(hf[1].item() and hd[1].item())}
        print("flash vs dense (at the flash gates) train step " + json.dumps(
            {name: parity[name]}), flush=True)
        assert parity[name]["finite"] and loss_rel <= TOL, (
            f"flash and dense train steps disagree at {name}: "
            f"{parity[name]}")
        assert worst[0] <= TOL, (
            f"flash and dense gradients disagree at {name}: {parity[name]}")

    runs = {}
    for name, opt, batches, ntok in (
        ("a_momentum_b32_t128",
         OptimizationConf(learning_method="momentum", learning_rate=0.001,
                          momentum=0.9),
         batches_a, int(full.sum())),
        ("b_adam_b8_t1024_ragged",
         OptimizationConf(learning_method="adam", learning_rate=LR_B),
         [batch_b] * STEPS_B, int(ragged.sum())),
    ):
        sgd = SGD(conf, opt, params=params_from_numpy(np_params, "cuda"),
                  device="cuda")
        stamps, costs = [], []

        def on_event(e):
            if isinstance(e, EndIteration):
                costs.append(e.cost)          # fetched: the step is done
                stamps.append(time.perf_counter())

        torch.cuda.synchronize()
        fa.launches = fa.bwd_dkv_launches = fa.bwd_dq_launches = 0
        t0 = time.perf_counter()
        sgd.train(reader=lambda b=batches: iter(b), feeder=lm_feed,
                  num_passes=1, event_handler=on_event)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        counts = (fa.launches, fa.bwd_dkv_launches, fa.bwd_dq_launches)
        steps = len(batches)
        steady = np.diff(stamps) * 1e3           # ms per step after the 1st
        r = {
            "steps": steps, "wall_s": wall,
            "ms_per_step_median": float(np.median(steady)),
            "ms_first_step": (stamps[0] - t0) * 1e3,
            "train_tokens_per_s": ntok / (float(np.median(steady)) / 1e3),
            "real_tokens_per_step": ntok,
            "loss_first": costs[0], "loss_last": costs[-1],
            "launches_fwd": counts[0], "launches_bwd_dkv": counts[1],
            "launches_bwd_dq": counts[2],
        }
        print(f"train {name} " + json.dumps(r), flush=True)
        assert np.isfinite(costs).all(), f"{name}: a loss is not finite"
        want = spec.num_layers * steps
        assert counts == (want, want, want), (
            f"{name}: launches {counts}, want {want} of each kernel")
        prof = profile_steps(torch, sgd, lm_feed(batches[0]))
        if prof is not None:
            # the device's idle share of an unprofiled step
            prof["idle_share"] = 1 - (prof["device_ms_per_step"]
                                      / r["ms_per_step_median"])
        print(f"profile {name} " + json.dumps(prof), flush=True)
        runs[name] = r
    b = runs["b_adam_b8_t1024_ragged"]
    assert b["loss_last"] <= 0.5 * b["loss_first"], (
        f"phase (b) loss fell only from {b['loss_first']:.4g} to "
        f"{b['loss_last']:.4g}")
    return parity, runs


# Phases 6c and 13b hold each gradient of one AMP step against the f32
# step's from the same weights. A gradient's distance is the norm of the
# difference over the norm of the f32 gradient, or over AMP_GRAD_FLOOR
# of the model's largest such norm where its own is below that (the
# NMT's attention decoder projection at init: 6e-9 of it, its bf16
# value rounding noise in either package). The norm, not the largest
# entry: a max pool's argmax or a ReLU gate that bf16 rounding flips
# moves whole rows of a gradient (the classifier's T = 100 max pool: up
# to 0.44 of the largest entry), and the norm reads them at their
# weight. The bound is 2e-2 plus twice the largest such distance bf16
# moves the JAX package's gradient of the same model at these widths
# (tests/test_torch_amp.py::test_card_amp_readings measures them on the
# CPU at a cut batch and holds these numbers), never more than 0.3 (a
# zeroed gradient reads 1, a flipped one 2). Phase 6d holds the flash
# step's gradients against the dense step's, both under the flag, to
# the bound of its conf (each is about that distance from f32).
AMP_GRAD_TOL, AMP_GRAD_CAP, AMP_GRAD_FLOOR = 2e-2, 0.3, 1e-4
JAX_BF16_GRAD_MOVE = {"lm": 0.0616, "classifier": 0.125, "nmt": 0.0452,
                      "longctx": 0.0874}


def amp_grad_distances(st_amp, st_f32, slot):
    """{parameter: distance} of one AMP optimizer step's gradients from
    the f32 step's, read from `slot` (momentum's, or adam's first moment:
    after one step from zero, a fixed multiple of the gradient)."""
    top = max(v[slot].norm().item() for v in st_f32.values())
    return {k: (st_amp[k][slot] - v[slot]).norm().item()
            / max(v[slot].norm().item(), AMP_GRAD_FLOOR * top)
            for k, v in st_f32.items()}


def amp_grads_held(name, model, st_amp, st_f32, slot):
    """Every gradient of one AMP step within min(AMP_GRAD_TOL + 2 *
    JAX_BF16_GRAD_MOVE[model], AMP_GRAD_CAP) of the f32 step's. Returns
    the largest distance."""
    bound = min(AMP_GRAD_TOL + 2 * JAX_BF16_GRAD_MOVE[model], AMP_GRAD_CAP)
    d = amp_grad_distances(st_amp, st_f32, slot)
    worst = max(d, key=d.get)
    print(f"amp gradients vs f32 {name} " + json.dumps(
        {"bound": bound, "worst": worst, "each": d}), flush=True)
    assert d[worst] <= bound, (
        f"{name}: gradient {worst} moved {d[worst]:.3g} from f32 under "
        f"the flag, bound {bound:.3g}")
    return d[worst]


def train_lm_amp(torch, fa):
    """Phase 6c: the LM at bench.py::bench_lm_train's settings (B=32,
    T=128, d 256, 4 heads, 2 layers, vocab 2048, dense attention,
    momentum 0.001 / 0.9) under the bf16 flag. First one momentum
    TrainStep in f32 and one under the flag from the same weights on
    phase 6(a)'s first batch: every gradient held (`amp_grads_held`).
    Then 20 steps of `SGD.train` on (a)'s next-token batches: every loss
    finite, the last below the first, the first within 5% of the f32
    step's loss (tests/test_amp.py's bound), and no flash kernel
    launched (dense attention). Returns the run's numbers."""
    from paddle_tpu_torch.core.config import OptimizationConf
    from paddle_tpu_torch.models import lm
    from paddle_tpu_torch.network import Network
    from paddle_tpu_torch.optimizers import create_optimizer
    from paddle_tpu_torch.parallel.dp import TrainStep
    from paddle_tpu_torch.trainer.events import EndIteration
    from paddle_tpu_torch.trainer.trainer import SGD
    from paddle_tpu_torch.weights import params_from_numpy

    spec = lm.LMSpec(vocab=2048, d_model=256, num_heads=4, num_layers=2,
                     attn_impl="dense")
    conf = lm.transformer_lm(spec)
    opt_conf = OptimizationConf(learning_method="momentum",
                                learning_rate=0.001, momentum=0.9)
    np_params = random_params(spec, lm)
    rng = np.random.default_rng(SEED + 2)     # phase 6(a)'s batches
    full = np.full((32,), 128, np.int32)
    batches = lm_batches(rng, 20, 32, 128, full, spec.vocab)
    net = Network(conf)
    held = {}
    for amp in (False, True):
        set_amp(amp)
        try:
            opt = create_optimizer(opt_conf, net.param_confs)
            p = params_from_numpy(np_params, "cuda")
            step = TrainStep(net, opt, watchdog=True, device="cuda")
            _p, mom, _s, health, _o = step(p, opt.init_state(p), {},
                                           lm_feed(batches[0]), 0, None)
            held[amp] = (health[0].item(), bool(health[1].item()), mom)
        finally:
            set_amp(False)
    loss_f32 = held[False][0]
    assert held[True][1], "lm amp: the held step is not finite"
    grad_worst = amp_grads_held("lm_amp_dense_b32_t128", "lm", held[True][2],
                                held[False][2], "mom")
    set_amp(True)
    try:
        sgd = SGD(conf, opt_conf,
                  params=params_from_numpy(np_params, "cuda"),
                  device="cuda")
        stamps, costs = [], []

        def on_event(e):
            if isinstance(e, EndIteration):
                costs.append(e.cost)          # fetched: the step is done
                stamps.append(time.perf_counter())

        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        fa.launches = fa.bwd_dkv_launches = fa.bwd_dq_launches = 0
        t0 = time.perf_counter()
        sgd.train(reader=lambda: iter(batches), feeder=lm_feed,
                  num_passes=1, event_handler=on_event)
        torch.cuda.synchronize()
        counts = (fa.launches, fa.bwd_dkv_launches, fa.bwd_dq_launches)
        steady = float(np.median(np.diff(stamps))) * 1e3
        ntok = int(full.sum())
        r = {"steps": len(batches), "wall_s": time.perf_counter() - t0,
             "ms_first_step": (stamps[0] - t0) * 1e3,
             "ms_per_step_median": steady,
             "train_tokens_per_s": ntok / (steady / 1e3),
             "loss_f32_first_batch": loss_f32,
             "held_step_loss_amp": held[True][0],
             "held_step_grad_rel_vs_f32_max": grad_worst,
             "loss_first": costs[0], "loss_last": costs[-1],
             "first_vs_f32_rel": abs(costs[0] - loss_f32) / abs(loss_f32),
             "peak_mem_gb": torch.cuda.max_memory_allocated() / 2 ** 30,
             "flash_launches": list(counts),
             "master_dtypes": sorted({str(v.dtype)
                                      for v in sgd.params.values()})}
        print("train lm_amp_dense_b32_t128 " + json.dumps(r), flush=True)
        prof = profile_steps(torch, sgd, lm_feed(batches[0]))
        if prof is not None:
            prof["idle_share"] = 1 - prof["device_ms_per_step"] / steady
        print("profile lm_amp_dense_b32_t128 " + json.dumps(prof),
              flush=True)
    finally:
        set_amp(False)
    r["profile"] = prof
    assert np.isfinite(costs).all(), "lm amp: a loss is not finite"
    assert costs[-1] < costs[0], (
        f"lm amp: loss rose from {costs[0]:.6g} to {costs[-1]:.6g}")
    assert r["first_vs_f32_rel"] <= 0.05, (
        f"lm amp: first loss {costs[0]:.6g} vs f32 {loss_f32:.6g}")
    assert counts == (0, 0, 0), f"lm amp: flash launched {counts}"
    assert r["master_dtypes"] == ["torch.float32"], r["master_dtypes"]
    return r


# ---- the long-context trainer under the bf16 flag (phase 6d) -----------

# bench.py::bench_longctx's settings (:629; its conf longctx_conf :576,
# its feed longctx_feed :602): vocab 32000, d 512, 8 heads (D = 64), 2
# layers, 512 classes, adam 1e-3; (B, T, steps an arm) of its two rows
LONGCTX = dict(d=512, heads=8, layers=2, classes=512, vocab=32000)
LONGCTX_LR = 1e-3
LONGCTX_RUNS = ((4, 4096, 20), (1, 8192, 10))
LONGCTX_WINDOW = 5                 # steps a timing window


def longctx_conf(d=512, heads=8, layers=2, classes=512, attn_impl="dense",
                 vocab=32000):
    """bench.py::longctx_conf (:576-600) in the port's DSL, on one
    device: embedding -> `layers` causal multi-head attention blocks
    with a residual fc -> a per-token classifier."""
    from paddle_tpu_torch import dsl

    with dsl.model() as m:
        ids = dsl.data("ids", dim=(), is_ids=True, is_seq=True)
        lbl = dsl.data("label", dim=(), is_ids=True, is_seq=True)
        x = dsl.embedding(ids, size=d, vocab_size=vocab)
        for _ in range(layers):
            att = dsl._add(
                "multi_head_attention", [x], size=d,
                num_heads=heads, causal=True,
                seq_parallel="none", attn_impl=attn_impl,
            )
            x = dsl.addto(att, dsl.fc(att, size=d, act="relu"))
        out = dsl.fc(x, size=classes, act="")
        dsl.classification_cost(out, lbl)
    return m.conf


def longctx_feed(bs, t, classes=512, vocab=32000, device="cuda"):
    """bench.py::longctx_feed (:602, seed 0) on `device`: random ids and
    labels, every row full length."""
    from paddle_tpu_torch.core.arg import id_arg

    rng = np.random.default_rng(0)
    lens = np.full((bs,), t, np.int32)
    return {
        "ids": id_arg(rng.integers(0, vocab, (bs, t)).astype(np.int32),
                      lens, device=device),
        "label": id_arg(rng.integers(0, classes, (bs, t)).astype(np.int32),
                        lens, device=device),
    }


def longctx_params(torch):
    """The long-context model's weights from a seed, as numpy (both arms
    and tests/test_torch_amp.py's reading start from them)."""
    from paddle_tpu_torch.network import Network
    from paddle_tpu_torch.weights import params_to_numpy

    return params_to_numpy(Network(longctx_conf(**LONGCTX)).init_params(
        torch.Generator().manual_seed(SEED + 3), device="cpu"))


def flash_launched(fa, before):
    """{counter: launches since `before`} of the counters that moved."""
    return {n: getattr(fa, n) - c for n, c in before.items()
            if getattr(fa, n) != c}


def longctx_held_step(torch, fa, np_params, feed):
    """Phase 6d (a): one adam TrainStep of the flash conf and one of the
    dense conf from one weight map, both under the bf16 flag: both
    finite, the losses within 5% (tests/test_amp.py's bound), every
    gradient (adam's first moment) held as 6c holds its own
    (`amp_grads_held`, the bound from the JAX package's bf16 distance of
    this conf), the flash step's bf16 forms launched once a layer and
    no f32 form, the dense step no flash form."""
    from paddle_tpu_torch.core.config import OptimizationConf
    from paddle_tpu_torch.network import Network
    from paddle_tpu_torch.optimizers import create_optimizer
    from paddle_tpu_torch.parallel.dp import TrainStep
    from paddle_tpu_torch.weights import params_from_numpy

    got = {}
    set_amp(True)
    try:
        for impl in ("flash", "dense"):
            net = Network(longctx_conf(attn_impl=impl, **LONGCTX))
            opt = create_optimizer(OptimizationConf(
                learning_method="adam", learning_rate=LONGCTX_LR),
                net.param_confs)
            p = params_from_numpy(np_params, "cuda")
            step = TrainStep(net, opt, watchdog=True, device="cuda")
            torch.cuda.synchronize()
            before = {n: getattr(fa, n) for n in fa.COUNTERS}
            _p, st, _s, health, _o = step(p, opt.init_state(p), {}, feed, 0,
                                          None)
            torch.cuda.synchronize()
            got[impl] = (health[0].item(), bool(health[1].item()), st,
                         flash_launched(fa, before))
            del _p, _o, p, step
    finally:
        set_amp(False)
    (lf, ff, sf, cf), (ld, fd, sd, cd) = got["flash"], got["dense"]
    layers = LONGCTX["layers"]
    r = {"loss_flash": lf, "loss_dense": ld, "rel": abs(lf - ld) / abs(ld),
         "finite": ff and fd, "launches_flash": cf, "launches_dense": cd,
         "grad_dtypes": sorted({str(v["m"].dtype) for v in sf.values()})}
    print("longctx held amp step flash vs dense " + json.dumps(r),
          flush=True)
    assert r["finite"] and r["rel"] <= 0.05, f"longctx held step: {r}"
    assert r["grad_dtypes"] == ["torch.float32"], r
    assert cf == dict.fromkeys(("bf16_launches", "bwd_dkv_bf16_launches",
                                "bwd_dq_bf16_launches"), layers), cf
    assert cd == {}, f"the dense step launched {cd}"
    r["grad_rel_max"] = amp_grads_held("longctx_flash_vs_dense_b4_t4096",
                                       "longctx", sf, sd, "m")
    return r


def longctx_train(torch, fa, np_params, B, T, steps):
    """Phase 6d (b), (c): `steps` adam steps of the flash arm and of the
    dense arm under the bf16 flag through `SGD.train_batch`, each arm its
    own SGD from one weight map on bench.py::longctx_feed's fixed batch,
    in windows of LONGCTX_WINDOW steps taken in turns as
    bench.py::_interleaved_best takes them (each arm's best window is
    its ms/step). Every loss finite and each arm's last below its first;
    the flash arm launches each bf16 form once a layer a step and no f32
    form, the dense arm no flash form. Reports ms/step, tokens/s (B*T a
    step), fused_speedup (dense ms / flash ms), the peak memory of each
    arm's windows, and each arm's profile. Returns the numbers."""
    from paddle_tpu_torch.core.config import OptimizationConf
    from paddle_tpu_torch.trainer.trainer import SGD
    from paddle_tpu_torch.weights import params_from_numpy

    feed = longctx_feed(B, T, LONGCTX["classes"], LONGCTX["vocab"])
    opt = OptimizationConf(learning_method="adam", learning_rate=LONGCTX_LR)
    set_amp(True)
    try:
        arms = {impl: SGD(longctx_conf(attn_impl=impl, **LONGCTX), opt,
                          params=params_from_numpy(np_params, "cuda"),
                          device="cuda")
                for impl in ("flash", "dense")}
        r = {impl: {"losses": [], "windows_ms": [], "launches": {},
                    "peak_mem_gb": 0.0} for impl in arms}
        torch.cuda.synchronize()
        resident = torch.cuda.memory_allocated() / 2 ** 30
        for _ in range(steps // LONGCTX_WINDOW):
            for impl, sgd in arms.items():
                a = r[impl]
                torch.cuda.synchronize()
                torch.cuda.reset_peak_memory_stats()
                before = {n: getattr(fa, n) for n in fa.COUNTERS}
                t0 = time.perf_counter()
                for _ in range(LONGCTX_WINDOW):
                    a["losses"].append(sgd.train_batch(feed))  # fetched
                a["windows_ms"].append(
                    (time.perf_counter() - t0) * 1e3 / LONGCTX_WINDOW)
                for n, c in flash_launched(fa, before).items():
                    a["launches"][n] = a["launches"].get(n, 0) + c
                a["peak_mem_gb"] = max(a["peak_mem_gb"],
                                       torch.cuda.max_memory_allocated()
                                       / 2 ** 30)
        for impl, sgd in arms.items():
            a = r[impl]
            a["ms_per_step"] = min(a["windows_ms"])
            a["tokens_per_s"] = B * T / (a["ms_per_step"] / 1e3)
            a["loss_first"], a["loss_last"] = a["losses"][0], a["losses"][-1]
            prof = profile_fn(torch, lambda s=sgd: s.train_batch(feed),
                              steps=3)
            if prof is not None:
                prof["idle_share"] = 1 - (prof["device_ms_per_step"]
                                          / a["ms_per_step"])
            print(f"profile longctx_{impl}_b{B}_t{T} " + json.dumps(prof),
                  flush=True)
            a["profile"] = prof
    finally:
        set_amp(False)
    out = {"B": B, "T": T, "steps_per_arm": steps,
           "resident_gb_before_windows": resident,
           "fused_speedup": (r["dense"]["ms_per_step"]
                             / r["flash"]["ms_per_step"]),
           **{impl: {k: v for k, v in a.items() if k != "profile"}
              for impl, a in r.items()}}
    print(f"train longctx_amp_b{B}_t{T} " + json.dumps(out), flush=True)
    want = steps * LONGCTX["layers"]
    for impl, a in r.items():
        assert np.isfinite(a["losses"]).all(), f"longctx {impl}: a loss"
        assert a["loss_last"] < a["loss_first"], (
            f"longctx {impl} B={B} T={T}: loss rose from "
            f"{a['loss_first']:.6g} to {a['loss_last']:.6g}")
    assert r["flash"]["launches"] == dict.fromkeys(
        ("bf16_launches", "bwd_dkv_bf16_launches", "bwd_dq_bf16_launches"),
        want), f"longctx flash arm launched {r['flash']['launches']}"
    assert r["dense"]["launches"] == {}, (
        f"longctx dense arm launched {r['dense']['launches']}")
    return out


def train_longctx_amp(torch, fa):
    """Phase 6d: the long-context trainer (bench.py::bench_longctx's
    conf, feed and adam) under the bf16 flag, attn_impl flash against
    dense: (a) the held step at B=4, T=4096; (b) 20 steps an arm at B=4,
    T=4096; (c) 10 an arm at B=1, T=8192. Returns ((a), [(b), (c)])."""
    np_params = longctx_params(torch)
    B, T, _steps = LONGCTX_RUNS[0]
    held = longctx_held_step(torch, fa, np_params,
                             longctx_feed(B, T, LONGCTX["classes"],
                                          LONGCTX["vocab"]))
    runs = [longctx_train(torch, fa, np_params, B, T, steps)
            for B, T, steps in LONGCTX_RUNS]
    return held, runs


# ---- ResNet-50 and the fused BN->ReLU->1x1-conv kernels (B1-B3) ---------

# the 29 fused sites of a ResNet-50 forward: (name, rows an image, Cin,
# Cout, act, sites)
FUSED_SITES = [
    ("res2a_a", 3136, 64, 64, "", 1),
    ("res2bc_a", 3136, 256, 64, "", 2),
    ("res3bcd_a", 784, 512, 128, "", 3),
    ("res4b-f_a", 196, 1024, 256, "", 5),
    ("res5bc_a", 49, 2048, 512, "", 2),
    ("res2_tail", 3136, 64, 256, "relu", 3),
    ("res3_tail", 784, 128, 512, "relu", 4),
    ("res4_tail", 196, 256, 1024, "relu", 6),
    ("res5_tail", 49, 512, 2048, "relu", 3),
]
# ragged against the 128-row tile and the 64/128-column tiles
FUSED_RAGGED = [("n100_24_16", 100, 24, 16), ("n1_24_16", 1, 24, 16),
                ("n517_70_130", 517, 70, 130), ("n300_200_72", 300, 200, 72)]
RESNET_OPT = dict(learning_method="momentum", learning_rate=0.001,
                  momentum=0.9)
RESNET_STEPS = 30
# phase 9c: bench.py::bench_resnet50's batch under the bf16 flag
RESNET_AMP_BATCH = 256
RESNET_AMP_STEPS = 20
RESNET_AMP_PLAIN_STEPS = 10


def fused_inputs(torch, gen, n, cin, cout, with_res):
    """u, scale, shift, w, residual and the cotangents dy, d1, d2 of one
    case, on the card (the scale of d2 keeps 2*y*d2 near dy's)."""
    def rnd(*shape, s=1.0):
        return torch.randn(shape, generator=gen, device="cuda") * s

    u, scale, shift = rnd(n, cin), rnd(cin), rnd(cin)
    w = rnd(cin, cout, s=(2.0 / cin) ** 0.5)
    res = rnd(n, cin) if with_res else None
    return u, scale, shift, w, res, rnd(n, cout), rnd(cout), rnd(cout, s=0.1)


def check_fused(torch, op, name, inputs, act):
    """The three fused kernels against their plain versions on one
    case's inputs: max |diff| / max |plain| <= TOL for y, ssum, ssq, du,
    dscale, dshift, dres and dw, and every output bit-identical on a
    repeat. Returns {output: (relative, absolute)}."""
    u, scale, shift, w, res, dy, d1, d2 = inputs
    got = op.bn_act_conv1x1_fwd(u, scale, shift, w, res, act)
    ref = op.bn_act_conv1x1_plain(u, scale, shift, w, res, act)
    y = ref[0]
    got += op.bn_act_conv1x1_bwd_dx(u, scale, shift, w, res, y, dy, d1, d2,
                                    act)
    ref += op.bn_act_conv1x1_bwd_dx_plain(u, scale, shift, w, res, y, dy, d1,
                                          d2, act)
    got += (op.bn_act_conv1x1_bwd_dw(u, scale, shift, res, y, dy, d1, d2,
                                     act),)
    ref += (op.bn_act_conv1x1_bwd_dw_plain(u, scale, shift, res, y, dy, d1,
                                           d2, act),)
    again = op.bn_act_conv1x1_fwd(u, scale, shift, w, res, act)
    again += op.bn_act_conv1x1_bwd_dx(u, scale, shift, w, res, y, dy, d1, d2,
                                      act)
    again += (op.bn_act_conv1x1_bwd_dw(u, scale, shift, res, y, dy, d1, d2,
                                       act),)
    torch.cuda.synchronize()
    for out, a, b in zip(("y", "ssum", "ssq", "du", "dscale", "dshift",
                          "dres", "dw"), got, again):
        assert (a is None and b is None) or torch.equal(a, b), (
            f"{name} act={act!r}: {out} not bit-identical on a repeat")
    errs = {}
    for out, g, r in zip(("y", "ssum", "ssq", "du", "dscale", "dshift",
                          "dres", "dw"), got, ref):
        if r is None:
            assert g is None, f"{name}: {out} should be None"
            continue
        assert torch.isfinite(g).all().item(), f"{name}: {out} not finite"
        errs[out] = rel_err(g, r)
        assert errs[out][0] <= TOL, (
            f"{name} act={act!r} res={res is not None}: kernel vs plain "
            f"{out} relative error {errs[out][0]:.3g} > {TOL}")
    return errs


def time_fused(torch, op, site, batch, gen):
    """Kernel, plain, GEMM-alone (torch.matmul, f32, TF32 off: a
    yardstick the port never calls) and bound ms of B1, B2 and B3 at one
    site of the path (act as the layers call it, no residual)."""
    name, rows, cin, cout, act, count = site
    n = rows * batch
    inputs = fused_inputs(torch, gen, n, cin, cout, False)
    errs = check_fused(torch, op, f"{name}_b{batch}", inputs, act)
    u, scale, shift, w, _res, dy, d1, d2 = inputs
    y = op.bn_act_conv1x1_plain(u, scale, shift, w, None, act)[0]
    z = u * scale + shift
    if act == "relu":
        z = torch.clamp_min(z, 0.0)
    f32 = 4
    flops = 2 * n * cin * cout

    def bound(nbytes):
        # on the tensor cores in three TF32 passes (hi*hi + hi*lo + lo*hi)
        t_ops = 3 * flops / H100_TF32_FLOPS * 1e3
        t_bytes = nbytes / H100_BYTES_PER_S * 1e3
        return max(t_ops, t_bytes), ("bytes" if t_bytes >= t_ops
                                     else "operations")

    nu, ny, nw = n * cin * f32, n * cout * f32, cin * cout * f32
    vin, vout = 2 * cin * f32, 2 * cout * f32
    kern = {
        # u, scale, shift, w read; y, ssum, ssq written
        "fwd": (lambda: op.bn_act_conv1x1_fwd(u, scale, shift, w, None, act),
                lambda: op.bn_act_conv1x1_plain(u, scale, shift, w, None,
                                                act),
                lambda: torch.matmul(z, w),
                bound(nu + vin + nw + ny + vout)),
        # u, scale, shift, w, y, dy, d1, d2 read; du, dscale, dshift
        # written
        "bwd_dx": (lambda: op.bn_act_conv1x1_bwd_dx(
            u, scale, shift, w, None, y, dy, d1, d2, act),
            lambda: op.bn_act_conv1x1_bwd_dx_plain(
                u, scale, shift, w, None, y, dy, d1, d2, act),
            lambda: torch.matmul(dy, w.t()),
            bound(nu + vin + nw + 2 * ny + vout + nu + vin)),
        # u, scale, shift, y, dy, d1, d2 read; dw written
        "bwd_dw": (lambda: op.bn_act_conv1x1_bwd_dw(
            u, scale, shift, None, y, dy, d1, d2, act),
            lambda: op.bn_act_conv1x1_bwd_dw_plain(
                u, scale, shift, None, y, dy, d1, d2, act),
            lambda: torch.matmul(z.t(), dy),
            bound(nu + vin + 2 * ny + vout + nw)),
    }
    res = {"site": name, "n": n, "cin": cin, "cout": cout, "act": act,
           "sites": count, "flops": flops,
           "max_abs_err": max(e[1] for e in errs.values()),
           "max_rel_err": {k: v[0] for k, v in errs.items()},
           "plan": op.launch_plan(n, cin, cout)}
    for k, (kfn, pfn, lfn, (b_ms, b_by)) in kern.items():
        res[k] = {"ms": time_ms(torch, kfn), "plain_ms": time_ms(torch, pfn),
                  "library_ms": time_ms(torch, lfn), "bound_ms": b_ms,
                  "bound_by": b_by}
    print("fused timing " + json.dumps(res), flush=True)
    return res


def fused_kernels(torch, op):
    """Phase 7: every site shape at batch 32 and the ragged shapes, each
    with act in {relu, ""} x residual in {none, given}; then times at
    the training shapes (batch 64). Returns (max abs error per kernel,
    timings)."""
    gen = torch.Generator(device="cuda").manual_seed(SEED + 3)
    worst = {"fwd": 0.0, "bwd_dx": 0.0, "bwd_dw": 0.0}
    which = {"y": "fwd", "ssum": "fwd", "ssq": "fwd", "du": "bwd_dx",
             "dscale": "bwd_dx", "dshift": "bwd_dx", "dres": "bwd_dx",
             "dw": "bwd_dw"}
    cases = [(f"{s[0]}_b32", s[1] * 32, s[2], s[3]) for s in FUSED_SITES]
    cases += FUSED_RAGGED
    n_checked = 0
    for name, n, cin, cout in cases:
        rels = {}
        for act in ("relu", ""):
            for with_res in (False, True):
                errs = check_fused(torch, op, name, fused_inputs(
                    torch, gen, n, cin, cout, with_res), act)
                n_checked += 1
                for out, (rel, ab) in errs.items():
                    worst[which[out]] = max(worst[which[out]], ab)
                    rels[out] = max(rels.get(out, 0.0), rel)
        print(f"fused {name} N={n} {cin}->{cout}: max relative error "
              + json.dumps(rels), flush=True)
    print(f"fused kernels equal their plain versions in {n_checked} cases",
          flush=True)
    timings = [time_fused(torch, op, site, 64, gen) for site in FUSED_SITES]
    per_step = {k: {m: sum(t["sites"] * t[k][m] for t in timings)
                    for m in ("ms", "plain_ms", "library_ms", "bound_ms")}
                for k in ("fwd", "bwd_dx", "bwd_dw")}
    print("fused kernels, sum over the 29 sites of one step at batch 64 "
          "(ms) " + json.dumps(per_step), flush=True)
    return worst, timings


# a B3 row split into two chunks whose boundary falls inside a 64-row
# stage (304 rows a chunk): B3's plan must split it so
FUSED_SPLIT_BF16 = ("n600_64_64_split2", 600, 64, 64)
# the bf16 forms take widths that are multiples of 8: ragged rows against
# the 128-row tile, a width past the 64/128-column tiles; then the edges of
# the wgmma kernels' 128 x 128 tiles (B1's 128 x 64 at Cout <= 64, 128 x
# 256 at Cout >= 256) and 64-row stages (rows 1, 127, 129, 255, 257; Cin
# and Cout 8, 72, 136, 200, 2048; Cout 264 past a 256-column tile; Cin 520
# and 2056 with a partial last stage), the split above, and three of B1's
# persistent walks (one a tile width) long enough that its ring and y
# buffers wrap
FUSED_RAGGED_BF16 = [("n100_24_16", 100, 24, 16), ("n1_24_16", 1, 24, 16),
                     ("n517_72_136", 517, 72, 136),
                     ("n300_200_72", 300, 200, 72),
                     ("n1_8_8", 1, 8, 8), ("n127_8_72", 127, 8, 72),
                     ("n129_72_8", 129, 72, 8),
                     ("n255_136_200", 255, 136, 200),
                     ("n257_200_136", 257, 200, 136),
                     ("n129_2048_72", 129, 2048, 72),
                     ("n257_72_2048", 257, 72, 2048), FUSED_SPLIT_BF16,
                     ("n127_64_8", 127, 64, 8), ("n129_520_64", 129, 520, 64),
                     ("n257_2056_264", 257, 2056, 264),
                     ("n4001_72_1032", 4001, 72, 1032),
                     ("n20001_72_200", 20001, 72, 200),
                     ("n118301_64_64", 118301, 64, 64)]
FUSED_OUTS = ("y", "ssum", "ssq", "du", "dscale", "dshift", "dres", "dw")


def fused_inputs_bf16(torch, gen, n, cin, cout, with_res):
    """fused_inputs with u, w, residual and dy in bf16 (scale, shift,
    d1, d2 stay f32, as the AMP rule hands them to the op)."""
    u, scale, shift, w, res, dy, d1, d2 = fused_inputs(torch, gen, n, cin,
                                                       cout, with_res)
    b = torch.bfloat16
    return (u.to(b), scale, shift, w.to(b),
            None if res is None else res.to(b), dy.to(b), d1, d2)


def check_fused_bf16(torch, op, name, inputs, act):
    """The bf16 forms of B1-B3 against their bf16 plain versions on one
    case's inputs: the f32 outputs (ssum, ssq, dscale, dshift, and dw
    before its cast) within TOL of the largest; the bf16 outputs (y, du,
    dres, and dw after its cast) element by element within one bf16 ulp
    plus TOL of the largest; every output bit-identical on a repeat; no
    f32 form launched. Returns {output: (relative, absolute)}."""
    u, scale, shift, w, res, dy, d1, d2 = inputs
    ref = op.bn_act_conv1x1_plain(u, scale, shift, w, res, act)
    y = ref[0]
    ref += op.bn_act_conv1x1_bwd_dx_plain(u, scale, shift, w, res, y, dy, d1,
                                          d2, act)
    ref += (op.bn_act_conv1x1_bwd_dw_plain(u, scale, shift, res, y, dy, d1,
                                           d2, act),)
    f32_before = (op.fwd_launches, op.bwd_dx_launches, op.bwd_dw_launches)

    def run():
        return (op.bn_act_conv1x1_fwd(u, scale, shift, w, res, act)
                + op.bn_act_conv1x1_bwd_dx(u, scale, shift, w, res, y, dy,
                                           d1, d2, act)
                + (op.bn_act_conv1x1_bwd_dw(u, scale, shift, res, y, dy, d1,
                                            d2, act),))

    got, again = run(), run()
    torch.cuda.synchronize()
    assert (op.fwd_launches, op.bwd_dx_launches,
            op.bwd_dw_launches) == f32_before, f"{name}: an f32 form ran"
    where = f"{name} act={act!r} res={res is not None}"
    errs = {}
    for out, g, g2, r in zip(FUSED_OUTS, got, again, ref):
        if r is None:
            assert g is None and g2 is None, f"{name}: {out} should be None"
            continue
        assert torch.equal(g, g2), f"{where}: {out} not bit-identical"
        assert g.dtype == r.dtype, f"{where}: {out} is {g.dtype}"
        assert torch.isfinite(g).all().item(), f"{where}: {out} not finite"
        errs[out] = rel_err(g.float(), r.float())
        if g.dtype == torch.bfloat16:
            # where the kernel's and the plain version's f32 accumulators
            # straddle a rounding boundary, that single flip is all the
            # bound admits
            off = bf16_beyond(torch, g, r)
            assert off <= TOL, (f"{where}: {out} {off:.3g} of the largest "
                                f"beyond one bf16 ulp (> {TOL})")
        else:
            assert errs[out][0] <= TOL, (
                f"{where}: kernel vs plain {out} relative error "
                f"{errs[out][0]:.3g} > {TOL}")
    b = torch.bfloat16          # dw as the Function returns it to a bf16 w
    off = bf16_beyond(torch, got[-1].to(b), ref[-1].to(b))
    assert off <= TOL, f"{where}: bf16 dw {off:.3g} beyond the bound"
    errs["dw_bf16"] = rel_err(got[-1].to(b).float(), ref[-1].to(b).float())
    return errs


def time_fused_bf16(torch, op, site, batch, gen):
    """The bf16 forms' kernel, plain, GEMM-alone (torch.matmul of the
    bf16 operands: a yardstick the port never calls) and bound ms at one
    site of the path (act as the layers call it, no residual). The
    bound: bf16 u, w, y, dy, du in bytes, f32 vectors and dw (B3 writes
    it in f32), and one bf16 pass on the tensor cores."""
    name, rows, cin, cout, act, count = site
    n = rows * batch
    inputs = fused_inputs_bf16(torch, gen, n, cin, cout, False)
    errs = check_fused_bf16(torch, op, f"{name}_b{batch}", inputs, act)
    u, scale, shift, w, _res, dy, d1, d2 = inputs
    y = op.bn_act_conv1x1_plain(u, scale, shift, w, None, act)[0]
    z = u.float() * scale + shift
    if act == "relu":
        z = torch.clamp_min(z, 0.0)
    z = z.to(torch.bfloat16)
    flops = 2 * n * cin * cout

    def bound(nbytes):
        t_ops = flops / H100_BF16_FLOPS * 1e3
        t_bytes = nbytes / H100_BYTES_PER_S * 1e3
        return max(t_ops, t_bytes), ("bytes" if t_bytes >= t_ops
                                     else "operations")

    nu, ny, nw = 2 * n * cin, 2 * n * cout, 2 * cin * cout
    vin, vout = 2 * cin * 4, 2 * cout * 4
    kern = {
        # u, scale, shift, w read; y, ssum, ssq written
        "fwd": (lambda: op.bn_act_conv1x1_fwd(u, scale, shift, w, None, act),
                lambda: op.bn_act_conv1x1_plain(u, scale, shift, w, None,
                                                act),
                lambda: torch.matmul(z, w),
                bound(nu + vin + nw + ny + vout)),
        # u, scale, shift, w, y, dy, d1, d2 read; du, dscale, dshift
        # written
        "bwd_dx": (lambda: op.bn_act_conv1x1_bwd_dx(
            u, scale, shift, w, None, y, dy, d1, d2, act),
            lambda: op.bn_act_conv1x1_bwd_dx_plain(
                u, scale, shift, w, None, y, dy, d1, d2, act),
            lambda: torch.matmul(dy, w.t()),
            bound(nu + vin + nw + 2 * ny + vout + nu + vin)),
        # u, scale, shift, y, dy, d1, d2 read; dw (f32) written
        "bwd_dw": (lambda: op.bn_act_conv1x1_bwd_dw(
            u, scale, shift, None, y, dy, d1, d2, act),
            lambda: op.bn_act_conv1x1_bwd_dw_plain(
                u, scale, shift, None, y, dy, d1, d2, act),
            lambda: torch.matmul(z.t(), dy),
            bound(nu + vin + 2 * ny + vout + 2 * nw)),
    }
    res = {"site": name, "n": n, "cin": cin, "cout": cout, "act": act,
           "sites": count, "flops": flops,
           "max_abs_err": max(e[1] for e in errs.values()),
           "max_rel_err": {k: v[0] for k, v in errs.items()},
           "plan": op.launch_plan(n, cin, cout, dtype=torch.bfloat16)}
    for k, (kfn, pfn, lfn, (b_ms, b_by)) in kern.items():
        res[k] = {"ms": time_ms(torch, kfn), "plain_ms": time_ms(torch, pfn),
                  "library_ms": time_ms(torch, lfn), "bound_ms": b_ms,
                  "bound_by": b_by}
    print("fused bf16 timing " + json.dumps(res), flush=True)
    return res


def fused_kernels_bf16(torch, op):
    """Phase 7b: the bf16 forms at every site shape at batch 32 and the
    bf16 ragged shapes, each with act in {relu, ""} x residual in {none,
    given}; then times at the bench's training shapes (batch 256).
    Returns (max abs error per kernel, timings)."""
    gen = torch.Generator(device="cuda").manual_seed(SEED + 4)
    worst = {"fwd": 0.0, "bwd_dx": 0.0, "bwd_dw": 0.0}
    # the kernels' own outputs (dw_bf16, the Function's cast of B3's f32
    # dw, is held by check_fused_bf16 and printed, not a kernel's error)
    which = {"y": "fwd", "ssum": "fwd", "ssq": "fwd", "du": "bwd_dx",
             "dscale": "bwd_dx", "dshift": "bwd_dx", "dres": "bwd_dx",
             "dw": "bwd_dw"}
    cases = [(f"{s[0]}_b32", s[1] * 32, s[2], s[3]) for s in FUSED_SITES]
    cases += FUSED_RAGGED_BF16
    split = op.launch_plan(*FUSED_SPLIT_BF16[1:],
                           dtype=torch.bfloat16)["bwd_dw"]
    assert (split["blocks"] == 2 and split["chunk"] % 64
            and split["chunk"] < FUSED_SPLIT_BF16[1]), (
        f"{FUSED_SPLIT_BF16[0]}: B3's rows not split mid-stage: {split}")
    n_checked = 0
    for name, n, cin, cout in cases:
        rels = {}
        for act in ("relu", ""):
            for with_res in (False, True):
                errs = check_fused_bf16(torch, op, name, fused_inputs_bf16(
                    torch, gen, n, cin, cout, with_res), act)
                n_checked += 1
                for out, (rel, ab) in errs.items():
                    if out in which:
                        worst[which[out]] = max(worst[which[out]], ab)
                    rels[out] = max(rels.get(out, 0.0), rel)
        print(f"fused bf16 {name} N={n} {cin}->{cout}: max relative error "
              + json.dumps(rels), flush=True)
    print(f"fused bf16 forms meet their bounds in {n_checked} cases",
          flush=True)
    timings = [time_fused_bf16(torch, op, site, RESNET_AMP_BATCH, gen)
               for site in FUSED_SITES]
    per_step = {k: {m: sum(t["sites"] * t[k][m] for t in timings)
                    for m in ("ms", "plain_ms", "library_ms", "bound_ms")}
                for k in ("fwd", "bwd_dx", "bwd_dw")}
    print(f"fused bf16 forms, sum over the 29 sites of one step at batch "
          f"{RESNET_AMP_BATCH} (ms) " + json.dumps(per_step), flush=True)
    return worst, timings


def image_feed(batch, seed):
    """bench.py::_image_feed on the card: N(0, 1) images, random labels."""
    from paddle_tpu_torch.core.arg import id_arg, non_seq

    rng = np.random.default_rng(seed)
    image = rng.standard_normal((batch, 224, 224, 3)).astype(np.float32)
    label = rng.integers(0, 1000, batch).astype(np.int32)
    return {"image": non_seq(image, device="cuda"),
            "label": id_arg(label, device="cuda")}


def resnet_nets(torch):
    """The plain and fused ResNet-50 networks, the plain weights from a
    seed, and the plain state advanced by three train-mode forwards (so
    the running statistics are not their initial values)."""
    from paddle_tpu_torch.models.image import resnet
    from paddle_tpu_torch.network import Network

    plain = Network(resnet(50, (224, 224, 3), 1000, fused=False))
    fused = Network(resnet(50, (224, 224, 3), 1000, fused=True))
    params = plain.init_params(torch.Generator().manual_seed(SEED),
                               device="cuda")
    state = plain.init_state("cuda")
    with torch.no_grad():
        for i in range(3):
            feed = image_feed(8, SEED + 10 + i)
            _o, state = plain.forward(params, feed, state=state, train=True,
                                      outputs=["output"])
    return plain, fused, params, state


def resnet_infer(torch, op, plain, fused, params, state):
    """Phase 8: the [8, 224, 224, 3] forward of __graft_entry__.entry()
    through Inferencer, plain and fused from mapped weights and state;
    logits within TOL of the largest, 29 B1 launches a fused forward."""
    from paddle_tpu_torch.trainer.trainer import Inferencer
    from paddle_tpu_torch.weights import fused_resnet_from_plain

    fparams, fstate = fused_resnet_from_plain(fused, params, state)
    feed = {"image": image_feed(8, SEED + 20)["image"]}
    out = {}
    for name, net, p, st in (("plain", plain, params, state),
                             ("fused", fused, fparams, fstate)):
        inf = Inferencer(net, p, st, outputs=["output"], device="cuda")
        inf.infer(feed)                       # warm: cuDNN picks its algos
        torch.cuda.synchronize()
        op.fwd_launches = 0
        t0 = time.perf_counter()
        logits = inf.infer(feed)["output"]
        ms = (time.perf_counter() - t0) * 1e3
        out[name] = (logits, ms, op.fwd_launches)
    (lp, ms_p, _), (lf, ms_f, launches) = out["plain"], out["fused"]
    rel = float(np.abs(lf - lp).max() / np.abs(lp).max())
    r = {"shape": list(lp.shape), "finite": bool(np.isfinite(lf).all()),
         "logits_rel": rel, "plain_ms": ms_p, "fused_ms": ms_f,
         "fused_images_per_s": 8 / (ms_f / 1e3), "b1_launches": launches}
    print("resnet50 inference " + json.dumps(r), flush=True)
    assert r["shape"] == [8, 1000] and r["finite"]
    assert rel <= TOL, f"fused and plain logits differ by {rel:.3g}"
    assert launches == 29, f"{launches} B1 launches in a fused forward"
    return r


def relu_gates(torch, plain, fused, params, fparams, state, fstate, feed):
    """ReLU gate flips between the two graphs on one train-mode forward,
    per gate site of the fused graph: {fused layer: flips}. The tail's
    in-gate is recomputed from its input as the layer computes it."""
    from paddle_tpu_torch.layers.norm import bn_affine, moments

    with torch.no_grad():
        po, _ = plain.forward(params, feed, state=state, train=True)
        fo, _ = fused.forward(fparams, feed, state=fstate, train=True)
        flips = {}
        for name in fused.order:
            lc = fused.conf.layer(name)
            if lc.type == "batch_norm" and lc.active_type == "relu":
                pairs = [(fo[name].value, po[name].value)]
            elif lc.type == "fused_conv1x1_bn":
                pairs = [(fo[name].value, po[f"{name}_bn"].value)]
            elif lc.type == "fused_bottleneck_tail":
                blk = name[:-len("_tail")]
                x = fo[lc.input_names()[0]].value
                g = fparams[f"_{name}.bnig"], fparams[f"_{name}.bnib"]
                scale, shift = bn_affine(*g, *moments(x), 1e-5)
                pairs = [(fo[name].value, po[f"{blk}_add"].value),
                         (x * scale + shift, po[f"{blk}_b_bn"].value)]
            else:
                continue
            flips[name] = sum(int(((a > 0) != (b > 0)).sum().item())
                              for a, b in pairs)
    return flips


def held_step(torch, plain, fused, params, state, feed, name):
    """One momentum TrainStep of the fused graph against the plain graph
    from mapped weights and state: loss, the new BN state and every
    gradient (from the new momentum, -lr * grad) within TOL of the
    largest entry. A flipped ReLU gate moves every gradient below it
    (PR 2's lesson), so a gradient is held only when its layer comes
    after every gate that flipped."""
    from paddle_tpu_torch.core.config import OptimizationConf
    from paddle_tpu_torch.optimizers import create_optimizer
    from paddle_tpu_torch.parallel.dp import TrainStep
    from paddle_tpu_torch.weights import fused_resnet_from_plain, \
        fused_resnet_map

    fparams, fstate = fused_resnet_from_plain(fused, params, state)
    pmap, smap = fused_resnet_map(fused)
    got = {}
    for arm, net, p, st in (("plain", plain, params, state),
                            ("fused", fused, fparams, fstate)):
        opt = create_optimizer(OptimizationConf(**RESNET_OPT),
                               net.param_confs)
        step = TrainStep(net, opt, watchdog=True, device="cuda")
        _p, mom, new_state, health, _o = step(p, opt.init_state(p), st, feed,
                                              0, None)
        got[arm] = (health, mom, new_state)
    (hp, mp, sp), (hf, mf, sf) = got["plain"], got["fused"]
    loss_rel = abs(hf[0].item() - hp[0].item()) / abs(hp[0].item())
    flips = relu_gates(torch, plain, fused, params, fparams, state, fstate,
                       feed)
    index = {n: i for i, n in enumerate(fused.order)}
    highest_flip = max((index[n] for n, f in flips.items() if f),
                       default=-1)
    owner = {g: layer for layer, slots in fused.layer_params.items()
             for g in slots.values()}
    held, free = {}, {}
    for k, src in pmap.items():
        e = rel_err(mf[k]["mom"].reshape(mp[src]["mom"].shape),
                    mp[src]["mom"])[0]
        (held if index[owner[k]] > highest_flip else free)[k] = e
    state_rel = max(rel_err(sf[layer][s], sp[pl][ps])[0]
                    for layer, slots in smap.items()
                    for s, (pl, ps) in slots.items())
    r = {"loss_plain": hp[0].item(), "loss_fused": hf[0].item(),
         "loss_rel": loss_rel, "finite": bool(hp[1].item() and hf[1].item()),
         "relu_gate_flips": sum(flips.values()),
         "flips_by_site": {n: f for n, f in flips.items() if f},
         "grads_held": len(held), "grads_total": len(pmap),
         "grad_rel_held_max": max(held.values(), default=0.0),
         "grad_rel_unheld_max": max(free.values(), default=0.0),
         "state_rel_max": state_rel}
    print(f"fused vs plain train step {name} " + json.dumps(r), flush=True)
    assert r["finite"] and loss_rel <= TOL, f"{name}: losses disagree: {r}"
    assert state_rel <= TOL, f"{name}: the new BN state disagrees: {r}"
    assert r["grad_rel_held_max"] <= TOL, f"{name}: gradients disagree: {r}"
    return r


def tiny_resnet(fused):
    """test_layers_extras.py::TestFusedBottleneck's two-block net: few
    enough ReLU gates that none flips, so every gradient is held."""
    from paddle_tpu_torch import dsl
    from paddle_tpu_torch.models.image import _bottleneck
    from paddle_tpu_torch.network import Network

    with dsl.model() as g:
        img = dsl.data("image", (8, 8, 16))
        lbl = dsl.data("label", (1,), is_ids=True)
        h = _bottleneck("blk_a", img, 4, 1, project=True, fused=fused)
        h = _bottleneck("blk_b", h, 4, 1, project=False, fused=fused)
        h = dsl.pool(h, 8, 1, pool_type="avg")
        out = dsl.fc(h, size=3, name="output", act="softmax")
        dsl.classification_cost(out, lbl, name="cost")
    return Network(g.conf)


FUSED_COUNTERS = ("fwd_launches", "bwd_dx_launches", "bwd_dw_launches",
                  "fwd_bf16_launches", "bwd_dx_bf16_launches",
                  "bwd_dw_bf16_launches")


def resnet_train(torch, op, conf, batch, steps, name, amp=False):
    """Phase 9(b) and 9c: SGD.train (momentum 0.001 / 0.9) on one fixed
    batch, under the bf16 flag with `amp`; returns the run's numbers
    (every fused kernel's launch count, f32 and bf16 forms, read just
    after)."""
    from paddle_tpu_torch.core.config import OptimizationConf
    from paddle_tpu_torch.trainer.events import EndIteration
    from paddle_tpu_torch.trainer.trainer import SGD

    set_amp(amp)
    try:
        sgd = SGD(conf, OptimizationConf(**RESNET_OPT), seed=SEED + 1,
                  device="cuda")
        feed = image_feed(batch, SEED + 40)
        stamps, costs = [], []

        def on_event(e):
            if isinstance(e, EndIteration):
                costs.append(e.cost)          # fetched: the step is done
                stamps.append(time.perf_counter())

        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        for c in FUSED_COUNTERS:
            setattr(op, c, 0)
        t0 = time.perf_counter()
        sgd.train(reader=lambda: iter([feed] * steps), feeder=lambda b: b,
                  num_passes=1, event_handler=on_event)
        torch.cuda.synchronize()
        counts = {c: getattr(op, c) for c in FUSED_COUNTERS}
        steady = float(np.median(np.diff(stamps))) * 1e3
        r = {"steps": steps, "batch": batch, "amp": amp,
             "wall_s": time.perf_counter() - t0,
             "ms_first_step": (stamps[0] - t0) * 1e3,
             "ms_per_step_median": steady,
             "images_per_s": batch / (steady / 1e3),
             "loss_first": costs[0], "loss_last": costs[-1],
             "peak_mem_gb": torch.cuda.max_memory_allocated() / 2 ** 30,
             "launches_fwd": counts["fwd_launches"],
             "launches_bwd_dx": counts["bwd_dx_launches"],
             "launches_bwd_dw": counts["bwd_dw_launches"],
             "launches_bf16": {c: v for c, v in counts.items()
                               if "bf16" in c}}
        print(f"train {name} " + json.dumps(r), flush=True)
        assert np.isfinite(costs).all(), f"{name}: a loss is not finite"
        prof = profile_steps(torch, sgd, feed)
    finally:
        set_amp(False)
    if prof is not None:
        prof["idle_share"] = 1 - prof["device_ms_per_step"] / steady
    print(f"profile {name} " + json.dumps(prof), flush=True)
    r["profile"] = prof
    return r


def held_amp_step(torch, plain, fused, params, state, feed):
    """Phase 9c(a): one momentum TrainStep at B=8 three ways from one
    weight map: plain f32, plain under the bf16 flag and fused under the
    flag. The fused-AMP step's loss, new BN state and each gradient are
    held against the plain f32 step's within twice the plain-AMP step's
    own distance from it plus 1e-3 (relative; the state over all its
    slots). A fourth arm, the witness, takes the plain f32 step on the
    weights and images rounded to bf16 (a perturbation of 2^-9 of each
    entry, no bf16 arithmetic): how far its gradients move from the f32
    step's is how far this net at this batch carries bf16's rounding of
    its inputs alone, and is printed beside the AMP arms' distances."""
    from paddle_tpu_torch.core.config import OptimizationConf
    from paddle_tpu_torch.optimizers import create_optimizer
    from paddle_tpu_torch.parallel.dp import TrainStep
    from paddle_tpu_torch.weights import fused_resnet_from_plain, \
        fused_resnet_map

    def rounded(t):
        return t.to(torch.bfloat16).float() if t.is_floating_point() else t

    fparams, fstate = fused_resnet_from_plain(fused, params, state)
    pmap, smap = fused_resnet_map(fused)
    rparams = {k: rounded(v) for k, v in params.items()}
    rfeed = {k: a if a.value is None else
             dataclasses.replace(a, value=rounded(a.value))
             for k, a in feed.items()}
    got = {}
    for arm, net, p, st, f, amp in (
            ("plain_f32", plain, params, state, feed, False),
            ("plain_amp", plain, params, state, feed, True),
            ("fused_amp", fused, fparams, fstate, feed, True),
            ("witness_f32_rounded_inputs", plain, rparams, state, rfeed,
             False)):
        set_amp(amp)
        try:
            opt = create_optimizer(OptimizationConf(**RESNET_OPT),
                                   net.param_confs)
            step = TrainStep(net, opt, watchdog=True, device="cuda")
            _p, mom, new_state, health, _o = step(p, opt.init_state(p), st,
                                                  f, 0, None)
        finally:
            set_amp(False)
        got[arm] = (health, mom, new_state)
    (h32, m32, s32), (hp, mp, sp), (hf, mf, sf), (hw, mw, _sw) = (
        got["plain_f32"], got["plain_amp"], got["fused_amp"],
        got["witness_f32_rounded_inputs"])
    ref = h32[0].item()
    loss = {"plain_amp": abs(hp[0].item() - ref) / abs(ref),
            "fused_amp": abs(hf[0].item() - ref) / abs(ref),
            "witness": abs(hw[0].item() - ref) / abs(ref)}
    st = {"plain_amp": max(rel_err(sp[pl][ps], s32[pl][ps])[0]
                           for slots in smap.values()
                           for (pl, ps) in slots.values()),
          "fused_amp": max(rel_err(sf[layer][s], s32[pl][ps])[0]
                           for layer, slots in smap.items()
                           for s, (pl, ps) in slots.items())}
    grads, outside = {}, []
    for k, src in pmap.items():
        g = {"fused_amp": rel_err(mf[k]["mom"].reshape(m32[src]["mom"].shape),
                                  m32[src]["mom"])[0],
             "plain_amp": rel_err(mp[src]["mom"], m32[src]["mom"])[0],
             "witness": rel_err(mw[src]["mom"], m32[src]["mom"])[0]}
        grads[k] = g
        if g["fused_amp"] > 2 * g["plain_amp"] + 1e-3:
            outside.append(k)

    def spread(arm):
        v = np.sort([g[arm] for g in grads.values()])
        return {"min": float(v[0]), "median": float(np.median(v)),
                "max": float(v[-1])}

    r = {"loss_f32": ref, "loss_plain_amp": hp[0].item(),
         "loss_fused_amp": hf[0].item(), "loss_witness": hw[0].item(),
         "loss_rel_vs_f32": loss, "state_rel_vs_f32": st,
         "finite": bool(h32[1].item() and hp[1].item() and hf[1].item()),
         "grads_outside_the_bound": outside, "grads_total": len(pmap),
         "grad_rel_vs_f32": {a: spread(a) for a in
                             ("fused_amp", "plain_amp", "witness")},
         "output_fc_grad_rel_vs_f32": {k: grads[k] for k in
                                       ("_output.w0", "_output.wbias")},
         "master_dtypes": sorted({str(v["mom"].dtype) for v in mf.values()})}
    print("amp train step resnet50_b8 " + json.dumps(r), flush=True)
    print("amp train step resnet50_b8 gradients vs f32 " + json.dumps(grads),
          flush=True)
    assert r["finite"], r
    assert loss["fused_amp"] <= 2 * loss["plain_amp"] + 1e-3, r
    assert st["fused_amp"] <= 2 * st["plain_amp"] + 1e-3, r
    assert not outside, f"gradients outside the bound: {outside}"
    assert r["master_dtypes"] == ["torch.float32"], r
    return r


def resnet_training_amp(torch, op, plain, fused, params, state):
    """Phase 9c: ResNet-50 under the bf16 flag at bench_resnet50's
    settings. (a) the held B=8 step three ways; (b) 20 fused steps at
    B=256 (each bf16 form 29 launches a step, no f32 form); (c) 10 plain
    steps at B=256."""
    held = held_amp_step(torch, plain, fused, params, state,
                         image_feed(8, SEED + 30))
    b = resnet_train(torch, op, fused.conf, RESNET_AMP_BATCH,
                     RESNET_AMP_STEPS,
                     f"resnet50_fused_amp_b{RESNET_AMP_BATCH}", amp=True)
    assert b["loss_last"] < b["loss_first"], (
        f"loss rose from {b['loss_first']:.4g} to {b['loss_last']:.4g}")
    want = 29 * RESNET_AMP_STEPS
    assert b["launches_bf16"] == dict.fromkeys(
        ("fwd_bf16_launches", "bwd_dx_bf16_launches",
         "bwd_dw_bf16_launches"), want), (
        f"bf16 launches {b['launches_bf16']}, want {want} of each")
    assert (b["launches_fwd"], b["launches_bwd_dx"],
            b["launches_bwd_dw"]) == (0, 0, 0), "an f32 form launched"
    p = resnet_train(torch, op, plain.conf, RESNET_AMP_BATCH,
                     RESNET_AMP_PLAIN_STEPS,
                     f"resnet50_plain_amp_b{RESNET_AMP_BATCH}", amp=True)
    assert p["loss_last"] < p["loss_first"], (
        f"plain amp loss rose from {p['loss_first']:.4g} to "
        f"{p['loss_last']:.4g}")
    assert p["launches_fwd"] == 0 and not any(p["launches_bf16"].values())
    return held, b, p


def resnet_training(torch, op, plain, fused, params, state):
    """Phase 9: (a) the held step: ResNet-50 at B=8, and the two-block
    net of the CPU tests, where every gradient is held; (b) 30 steps of
    the fused graph at B=64 (and 10 of the plain graph, for its step
    time)."""
    from paddle_tpu_torch.core.arg import id_arg, non_seq

    held = held_step(torch, plain, fused, params, state,
                     image_feed(8, SEED + 30), "resnet50_b8")
    tp, tf = tiny_resnet(False), tiny_resnet(True)
    rng = np.random.default_rng(SEED + 31)
    tiny = held_step(
        torch, tp, tf,
        tp.init_params(torch.Generator().manual_seed(SEED), device="cuda"),
        tp.init_state("cuda"),
        {"image": non_seq(rng.standard_normal((4, 8, 8, 16)).astype(
            np.float32), device="cuda"),
         "label": id_arg(rng.integers(0, 3, 4).astype(np.int32),
                         device="cuda")}, "two_blocks_b4")
    print(f"two-block held step: {tiny['relu_gate_flips']} ReLU gates "
          f"flipped", flush=True)
    assert tiny["relu_gate_flips"] == 0 and (
        tiny["grads_held"] == tiny["grads_total"]), (
        "the two-block held step needs a feed whose ReLU gates agree")
    b = resnet_train(torch, op, fused.conf, 64, RESNET_STEPS,
                     "resnet50_fused_b64")
    assert b["loss_last"] < b["loss_first"], (
        f"loss rose from {b['loss_first']:.4g} to {b['loss_last']:.4g}")
    want = 29 * RESNET_STEPS
    got = (b["launches_fwd"], b["launches_bwd_dx"], b["launches_bwd_dw"])
    assert got == (want, want, want), (
        f"launches {got}, want {want} of each fused kernel")
    assert not any(b["launches_bf16"].values()), "a bf16 form launched"
    p = resnet_train(torch, op, plain.conf, 64, 10, "resnet50_plain_b64")
    assert p["launches_fwd"] == 0
    return (held, tiny), b, p


# ---- the sequence slice: LSTM/GRU kernels (B5-B8), classifier, NMT -------

# the bench rows at their published widths (bench.py bench_lstm, bench_nmt)
CLS = dict(vocab_size=30000, emb_dim=128, hidden=256, num_layers=2,
           num_classes=2)
CLS_B, CLS_T, CLS_STEPS, CLS_LR = 64, 100, 30, 2e-3
NMT = dict(src_vocab=30000, trg_vocab=30000, emb_dim=512, hidden=512)
NMT_B, NMT_T, NMT_STEPS, NMT_LR = 256, 32, 20, 1e-3
SCAN_STEPS = 10
# (name, cell, B, T, h, lens or None for full): the path shapes (both
# classifier layers; the NMT encoder, h = 512 / 2 a direction), the bench's
# other LSTM widths, and ragged cases with a zero length and a length of 1
RAGGED = [37, 0, 1, 20, 36, 5, 37, 2, 11]
RNN_CASES = [
    ("classifier_b64_t100_h256", "lstm", CLS_B, CLS_T, 256, None),
    ("nmt_enc_b256_t32_h256", "gru", NMT_B, NMT_T, 256, None),
    ("lstm_b64_t100_h512", "lstm", CLS_B, CLS_T, 512, None),
    ("lstm_b64_t100_h1280", "lstm", CLS_B, CLS_T, 1280, None),
    ("gru_b256_t32_h512", "gru", NMT_B, NMT_T, 512, None),
    ("gru_b256_t32_h1280", "gru", NMT_B, NMT_T, 1280, None),
    ("lstm_ragged_b9_t37_h256", "lstm", 9, 37, 256, RAGGED),
    ("gru_ragged_b9_t37_h256", "gru", 9, 37, 256, RAGGED),
]
RNN_COUNTERS = ("lstm_fwd_launches", "lstm_fwd_cluster_launches",
                "lstm_fwd_grid_launches", "lstm_fwd_infer_launches",
                "lstm_fwd_infer_cluster_launches",
                "lstm_fwd_infer_grid_launches", "lstm_bwd_launches",
                "lstm_bwd_cluster_launches", "lstm_bwd_grid_launches",
                "gru_fwd_launches", "gru_fwd_cluster_launches",
                "gru_bwd_launches", "gru_bwd_cluster_launches")


def zero_rnn_counts(rnn):
    for c in RNN_COUNTERS:
        setattr(rnn, c, 0)


def rnn_counts(rnn):
    return {c: getattr(rnn, c) for c in RNN_COUNTERS}


def rnn_inputs(torch, gen, cell, b, t, h, lens):
    """x, the weights at the layers' init scale (1/sqrt(h)), biases, lens
    and dy of one case, on the card."""
    def rnd(*shape, s=1.0):
        return torch.randn(shape, generator=gen, device="cuda") * s

    live = np.full(b, t) if lens is None else np.asarray(lens)
    lens_t = torch.as_tensor(live, dtype=torch.int32, device="cuda")
    if cell == "lstm":
        ws = (rnd(h, 4 * h, s=h ** -0.5), rnd(7 * h, s=0.1))
        x = rnd(b, t, 4 * h)
    else:
        ws = (rnd(h, 2 * h, s=h ** -0.5), rnd(h, h, s=h ** -0.5),
              rnd(3 * h, s=0.1))
        x = rnd(b, t, 3 * h)
    return x, ws, lens_t, rnd(b, t, h), int(live.sum())


def check_rnn(torch, rnn, case, gen):
    """B5 (both variants) and B6, or B7 and B8, against their plain
    versions at one case: max |diff| / max |plain| <= TOL for every
    output, exactly 0 past each row's length; each kernel on the route
    of its rule (`rnn.fwd_plan`, `rnn.bwd_plan`), bit-identical on a
    repeat where that is the cluster or the grid route, and, where it is
    the cluster route, on the cell's other route too (the LSTM's grid
    route, the GRU's walk); then kernel, plain, other route and cuDNN
    (torch.nn.LSTM/GRU: another function — no peepholes, its own input
    GEMM, no masks; a reference point only) times and the bounds.
    Returns the case's numbers."""
    name, cell, b, t, h, lens = case
    x, ws, lens_t, dy, live = rnn_inputs(torch, gen, cell, b, t, h, lens)
    dead = torch.arange(t, device="cuda")[None, :] >= lens_t[:, None]
    f32 = 4
    second = "grid" if cell == "lstm" else "walk"   # beside the cluster route
    if cell == "lstm":
        w, b7 = ws
        parts = torch.split(b7, [4 * h, h, h, h])
        y, c = rnn.lstm_seq_fwd(x, w, b7, lens_t, want_c=True)
        y_noc, _ = rnn.lstm_seq_fwd(x, w, b7, lens_t, want_c=False)
        yp, cp = rnn.lstm_plain(x, w, *parts, lens_t, want_c=True)
        got = (y, c) + rnn.lstm_seq_bwd(x, w, b7, lens_t, yp, cp, dy)
        ref = (yp, cp) + rnn.lstm_bwd_plain(x, w, b7, lens_t, yp, cp, dy)
        names = ("y", "c", "dx", "dw", "db7")
        which = {"y": "fwd", "c": "fwd", "dx": "bwd", "dw": "bwd",
                 "db7": "bwd"}
        kern = {
            "fwd": lambda: rnn.lstm_seq_fwd(x, w, b7, lens_t, want_c=True),
            "fwd_infer": lambda: rnn.lstm_seq_fwd(x, w, b7, lens_t,
                                                  want_c=False),
            "bwd": lambda: rnn.lstm_seq_bwd(x, w, b7, lens_t, yp, cp, dy)}
        fwd_second = {
            "fwd": lambda: rnn.lstm_seq_fwd(x, w, b7, lens_t, want_c=True,
                                            route=second),
            "fwd_infer": lambda: rnn.lstm_seq_fwd(x, w, b7, lens_t,
                                                  want_c=False,
                                                  route=second)}

        def bwd_second():
            return rnn.lstm_seq_bwd(x, w, b7, lens_t, yp, cp, dy,
                                    route=second)

        plain = {
            "fwd": lambda: rnn.lstm_plain(x, w, *parts, lens_t, want_c=True),
            "fwd_infer": lambda: rnn.lstm_plain(x, w, *parts, lens_t),
            "bwd": lambda: rnn.lstm_bwd_plain(x, w, b7, lens_t, yp, cp, dy)}
        mac = live * h * 4 * h           # one [h] @ [h, 4h] a live step
        seq = b * t * h * f32
        io = x.numel() * f32 + (w.numel() + b7.numel() + b) * f32
        # fwd: x, w, b7, lens read, y (and c) written; bwd: + y, c, dy
        # read, dx, dw, db7 written; 2 flops a MAC: fwd one product a
        # step, bwd three (the recomputed gates, dh = dg w^T, dW)
        work = {"fwd": (2 * mac, io + 2 * seq),
                "fwd_infer": (2 * mac, io + seq),
                "bwd": (6 * mac, io + 3 * seq + x.numel() * f32
                        + (w.numel() + b7.numel()) * f32)}
        cudnn = torch.nn.LSTM(h, h, batch_first=True).cuda()
        assert bool(torch.equal(y, y_noc)), f"{name}: the variants differ"
    else:
        w_g, w_c, bias = ws
        y = rnn.gru_seq_fwd(x, w_g, w_c, bias, lens_t)
        yp = rnn.gru_plain(x, w_g, w_c, bias, lens_t)
        got = (y,) + rnn.gru_seq_bwd(x, w_g, w_c, bias, lens_t, yp, dy)
        ref = (yp,) + rnn.gru_bwd_plain(x, w_g, w_c, bias, lens_t, yp, dy)
        names = ("y", "dx", "dw_g", "dw_c", "db")
        which = {"y": "fwd", "dx": "bwd", "dw_g": "bwd", "dw_c": "bwd",
                 "db": "bwd"}
        kern = {"fwd": lambda: (rnn.gru_seq_fwd(x, w_g, w_c, bias, lens_t),),
                "bwd": lambda: rnn.gru_seq_bwd(x, w_g, w_c, bias, lens_t, yp,
                                               dy)}
        fwd_second = {"fwd": lambda: (rnn.gru_seq_fwd(x, w_g, w_c, bias,
                                                      lens_t, route=second),)}

        def bwd_second():
            return rnn.gru_seq_bwd(x, w_g, w_c, bias, lens_t, yp, dy,
                                   route=second)

        plain = {"fwd": lambda: rnn.gru_plain(x, w_g, w_c, bias, lens_t),
                 "bwd": lambda: rnn.gru_bwd_plain(x, w_g, w_c, bias, lens_t,
                                                  yp, dy)}
        mac = live * h * h               # [h] @ [h, h] a live step
        seq = b * t * h * f32
        wts = (w_g.numel() + w_c.numel() + bias.numel()) * f32
        io = x.numel() * f32 + wts + b * f32
        # fwd: 3 h^2 MACs a step (u, r and c); bwd: 9 (the recomputed
        # gates 3, d(rh) 1, dh 2, dW_g 2, dW_c 1)
        work = {"fwd": (6 * mac, io + seq),
                "bwd": (18 * mac, io + 2 * seq + x.numel() * f32 + wts)}
        cudnn = torch.nn.GRU(h, h, batch_first=True).cuda()
    torch.cuda.synchronize()
    errs = {}
    for n, g, r in zip(names, got, ref):
        assert torch.isfinite(g).all().item(), f"{name}: {n} not finite"
        errs[n] = rel_err(g, r)
        assert errs[n][0] <= TOL, (
            f"{name}: kernel vs plain {n} relative error {errs[n][0]:.3g} "
            f"> {TOL}")
    assert bool((got[0][dead] == 0).all().item()), f"{name}: y past len"
    dx = got[2] if cell == "lstm" else got[1]
    assert bool((dx[dead] == 0).all().item()), f"{name}: dx past len"
    kernel = rnn.LSTM_KERNEL if cell == "lstm" else rnn.GRU_KERNEL
    plan = rnn.bwd_plan(kernel, b, h, x.device)
    fplan = rnn.fwd_plan(kernel, b, h, x.device)
    both = plan["route"] == "cluster"
    fboth = fplan["route"] == "cluster"
    first = 2 if cell == "lstm" else 1           # B6/B8's outputs in got
    # B5/B7 and B6/B8: bit-identical on a repeat on the cluster and grid
    # routes (the inference variant too)
    for kind, route, outs in (("fwd", fplan["route"], got[:first]),
                              ("fwd_infer", fplan["route"], (y_noc,)
                               if cell == "lstm" else None),
                              ("bwd", plan["route"], got[first:])):
        if route == "walk" or outs is None:
            continue
        again = kern[kind]()
        torch.cuda.synchronize()
        for n, g, a in zip(names if kind == "fwd_infer" else
                           names[:first] if kind == "fwd" else names[first:],
                           outs, again):
            assert bool(torch.equal(g, a)), (
                f"{name}: {kind} {n} differs on a repeat")
    second_err = {}
    if fboth:   # B5/B7 on the cluster route: the other route holds too
        by_second = fwd_second["fwd"]()
        seconds = [by_second]
        if cell == "lstm":
            seconds.append(fwd_second["fwd_infer"]())
        torch.cuda.synchronize()
        for n, sk, r in zip(names[:first], by_second, ref):
            second_err[n] = rel_err(sk, r)[0]
            assert second_err[n] <= TOL, (
                f"{name}: {second} route vs plain {n} relative error "
                f"{second_err[n]:.3g} > {TOL}")
        for sk in seconds:
            assert bool((sk[0][dead] == 0).all().item()), (
                f"{name}: {second} route y past len")
            assert bool(torch.equal(sk[0], by_second[0])), (
                f"{name}: the {second} route's variants differ")
    if both:                 # the other route holds too
        by_second = bwd_second()
        torch.cuda.synchronize()
        for n, sk, r in zip(names[first:], by_second, ref[first:]):
            second_err[n] = rel_err(sk, r)[0]
            assert second_err[n] <= TOL, (
                f"{name}: {second} route vs plain {n} relative error "
                f"{second_err[n]:.3g} > {TOL}")
        assert bool((by_second[0][dead] == 0).all().item()), (
            f"{name}: {second} route dx past len")

    slow = h >= 1280
    res = {"name": name, "cell": cell, "B": b, "T": t, "h": h,
           "live_steps": live, "fwd_plan": fplan, "bwd_plan": plan,
           "rel_err": {n: e[0] for n, e in errs.items()},
           "second_route": second, "second_rel_err": second_err}
    for k in kern:
        flops, nbytes = work[k]
        # the card's f32-accurate peak whichever route runs: three TF32
        # passes on the tensor cores (hi*hi + hi*lo + lo*hi), as the
        # cluster routes compute their products
        t_ops = 3 * flops / H100_TF32_FLOPS * 1e3
        t_bytes = nbytes / H100_BYTES_PER_S * 1e3
        res[k] = {
            "ms": time_ms(torch, kern[k], reps=5 if slow else 20),
            "plain_ms": time_ms(torch, plain[k], reps=3 if slow else 5,
                                warmup=1),
            "bound_ms": max(t_ops, t_bytes),
            "bound_by": "bytes" if t_bytes >= t_ops else "operations",
            "flops": flops, "bytes": nbytes,
            "max_abs_err": max((e[1] for n, e in errs.items()
                                if which[n] == k[:3]), default=0.0),
        }
    if fboth:   # the same functions on the other route
        for k, fn in fwd_second.items():
            res[f"{k}_{second}_ms"] = time_ms(torch, fn)
    if both:
        res[f"bwd_{second}_ms"] = time_ms(torch, bwd_second)
    # cuDNN's LSTM/GRU over [B, T, h] (its input GEMM included): forward,
    # and forward+backward minus forward
    xin = torch.randn((b, t, h), generator=gen, device="cuda",
                      requires_grad=True)

    def cudnn_fwd():
        with torch.no_grad():
            cudnn(xin)

    def cudnn_fwd_bwd():
        out, _ = cudnn(xin)
        out.backward(dy)

    res["cudnn_fwd_ms"] = time_ms(torch, cudnn_fwd)
    res["cudnn_bwd_ms"] = time_ms(torch, cudnn_fwd_bwd) - res["cudnn_fwd_ms"]
    print("rnn kernel " + json.dumps(res), flush=True)
    return res


def rnn_kernels(torch, rnn):
    """Phase 10: every case of RNN_CASES. Returns the results by name."""
    gen = torch.Generator(device="cuda").manual_seed(SEED + 50)
    out = {case[0]: check_rnn(torch, rnn, case, gen) for case in RNN_CASES}
    print(f"rnn kernels equal their plain versions in {len(out)} cases",
          flush=True)
    return out


def text_feeds(seed, ragged):
    """The classifier's and the NMT's feeds, bench.py's (random ids, full
    lengths) or with ragged lengths (1 .. T, so that no row is empty)."""
    from paddle_tpu_torch.core.arg import id_arg

    rng = np.random.default_rng(seed)
    cl = (rng.integers(1, CLS_T + 1, CLS_B) if ragged
          else np.full(CLS_B, CLS_T)).astype(np.int32)
    nl = (rng.integers(1, NMT_T + 1, NMT_B) if ragged
          else np.full(NMT_B, NMT_T)).astype(np.int32)
    cls = {"words": id_arg(rng.integers(0, CLS["vocab_size"], (CLS_B, CLS_T))
                           .astype(np.int32), cl, device="cuda"),
           "label": id_arg(rng.integers(0, 2, CLS_B).astype(np.int32),
                           device="cuda")}
    nmt = {k: id_arg(rng.integers(2, NMT["src_vocab"], (NMT_B, NMT_T))
                     .astype(np.int32), nl, device="cuda")
           for k in ("src", "trg_in", "trg_out")}
    return cls, nmt


def set_rnn_arm(arm):
    """"kernels": the default policy (None: the kernels on the card);
    "scan": use_pallas_rnn = False."""
    from paddle_tpu_torch.core import flags

    flags.set_flag("use_pallas_rnn", None if arm == "kernels" else False)


def classifier_infer(torch, rnn):
    """Phase 11: the classifier through Inferencer at [64, 100] ids, the
    kernel arm (B5 without c) against the scan arm from the same weights:
    probabilities within 1e-5; two B5 launches a forward."""
    from paddle_tpu_torch.models.text import stacked_lstm_classifier
    from paddle_tpu_torch.network import Network
    from paddle_tpu_torch.trainer.trainer import Inferencer

    net = Network(stacked_lstm_classifier(**CLS))
    params = net.init_params(torch.Generator().manual_seed(SEED),
                             device="cuda")
    cls, _nmt = text_feeds(SEED + 60, ragged=True)
    feed = {"words": cls["words"]}
    out = {}
    for arm in ("kernels", "scan"):
        set_rnn_arm(arm)
        inf = Inferencer(net, params, outputs=["output"], device="cuda")
        inf.infer(feed)
        torch.cuda.synchronize()
        zero_rnn_counts(rnn)
        t0 = time.perf_counter()
        logits = inf.infer(feed)["output"]
        ms = (time.perf_counter() - t0) * 1e3
        out[arm] = (logits, ms, rnn_counts(rnn))
    set_rnn_arm("kernels")
    (lk, ms_k, counts), (ls, ms_s, counts_s) = out["kernels"], out["scan"]

    def probs(z):
        e = np.exp(z - z.max(axis=1, keepdims=True))
        return e / e.sum(axis=1, keepdims=True)

    diff = float(np.abs(probs(lk) - probs(ls)).max())
    r = {"shape": list(lk.shape), "finite": bool(np.isfinite(lk).all()),
         "prob_max_abs_diff": diff, "kernel_ms": ms_k, "scan_ms": ms_s,
         "kernel_sequences_per_s": CLS_B / (ms_k / 1e3),
         "b5_infer_launches": counts["lstm_fwd_infer_launches"],
         "launches": counts, "scan_launches": counts_s}
    print("classifier inference " + json.dumps(r), flush=True)
    assert r["shape"] == [CLS_B, 2] and r["finite"]
    assert diff <= 1e-5, f"kernel and scan probabilities differ by {diff:.3g}"
    assert counts["lstm_fwd_infer_launches"] == 2, counts
    assert counts["lstm_fwd_infer_cluster_launches"] == 2, counts
    assert sum(counts_s.values()) == 0, counts_s
    return r


def text_confs():
    from paddle_tpu_torch.models.text import seq2seq_attention, \
        stacked_lstm_classifier

    return stacked_lstm_classifier(**CLS), seq2seq_attention(**NMT)


def held_text_step(torch, conf, feed, lr, name, fixed_pool=False):
    """One adam TrainStep of the kernel arm against the scan arm from one
    weight map, and of the scan arm in f64 (the exact reference): the
    loss within TOL, and every gradient (from the new first moment,
    (1 - beta1) * grad) within TOL + 2 * noise of the scan arm's, noise
    being the scan arm's own f32 error against f64. Where a gradient is
    well conditioned the noise is ~1e-6 and the bound is TOL; where
    f32 rounding alone moves it (a sum that cancels to a small
    remainder: the attention's score path at init), the bound widens by
    what f32 arithmetic itself gives there. The kernel arm must also be
    as close to the f64 gradient as the scan arm, within TOL.

    `fixed_pool`: every max pool over time takes, in all three arms, the
    step the f64 arm's forward takes (a gather at its argmax; the same
    value away from ties). At init the wide classifier's LSTM outputs
    barely move over time, and a pool's top two steps can lie within
    f32 rounding of each other (5.5e-9 apart at h = 1280): an arm that
    breaks such a tie the other way routes that feature's whole gradient
    to another step, which moves every gradient below the pool by ~1e-2,
    a discontinuity and not a difference of the function. The count of
    decisions each f32 arm would have taken otherwise is reported; every
    max pool of the conf must have been recorded once and pinned once in
    each arm."""
    from paddle_tpu_torch.core.config import OptimizationConf
    from paddle_tpu_torch.layers.sequence import SequencePoolLayer
    from paddle_tpu_torch.network import Network
    from paddle_tpu_torch.ops import sequence_ops as sops
    from paddle_tpu_torch.optimizers import create_optimizer
    from paddle_tpu_torch.parallel.dp import TrainStep

    net = Network(conf)
    params = net.init_params(torch.Generator().manual_seed(SEED + 1),
                             device="cuda")
    pool_ops = SequencePoolLayer._OPS
    real_max = pool_ops["max"]
    argmax, flips = [], {}
    # the conf's max pools (SequencePoolLayer.forward's choice of kind)
    max_pools = sum(
        isinstance(l, SequencePoolLayer) and l.conf.attrs.get(
            "pool_type", l.conf.type if l.conf.type in ("average", "max")
            else "sum") == "max"
        for l in net.layers.values())

    def masked(x, lens):
        keep = sops._mask(lens, x.shape[1], x.dtype) > 0
        return torch.where(keep[..., None], x, torch.full_like(x, -1e30))

    def record_max(x, lens):       # the f64 arm's steps, pool by pool
        argmax.append(masked(x, lens).argmax(1))
        return real_max(x, lens)

    def fixed_max(x, lens, arm):   # the recorded steps, in pool order
        i = len(flips[arm])
        assert i < len(argmax), f"{name}: max pool {i} was not recorded"
        idx = argmax[i]
        flips[arm].append(int((masked(x.detach(), lens).argmax(1)
                               != idx).sum().item()))
        return x.gather(1, idx[:, None, :]).squeeze(1)

    if fixed_pool:
        set_rnn_arm("scan")
        pool_ops["max"] = record_max
        try:
            with torch.no_grad():
                net.loss_fn({k: v.double() for k, v in params.items()},
                            feed)
        finally:
            pool_ops["max"] = real_max
        assert max_pools > 0 and len(argmax) == max_pools, (
            f"{name}: {len(argmax)} max pools recorded, the conf has "
            f"{max_pools}")
    got = {}
    for arm, dtype in (("kernels", torch.float32), ("scan", torch.float32),
                       ("f64", torch.float64)):
        set_rnn_arm("kernels" if arm == "kernels" else "scan")
        p = {k: v.to(dtype) for k, v in params.items()}
        opt = create_optimizer(OptimizationConf(learning_method="adam",
                                                learning_rate=lr),
                               net.param_confs)
        step = TrainStep(net, opt, watchdog=True, device="cuda")
        flips[arm] = []
        if fixed_pool:
            pool_ops["max"] = lambda x, lens, arm=arm: fixed_max(x, lens, arm)
        try:
            _p, st, _s, health, _o = step(p, opt.init_state(p), {}, feed, 0,
                                          None)
        finally:
            pool_ops["max"] = real_max
        assert not fixed_pool or len(flips[arm]) == max_pools, (
            f"{name}: {len(flips[arm])} max pools pinned in the {arm} arm, "
            f"the conf has {max_pools}")
        got[arm] = (health, st)
    set_rnn_arm("kernels")
    (hk, sk), (hs, ss), (_h64, s64) = (got["kernels"], got["scan"],
                                       got["f64"])
    loss_rel = abs(hk[0].item() - hs[0].item()) / abs(hs[0].item())
    per = {}
    for k in ss:
        ref = s64[k]["m"]
        per[k] = {"kernels_vs_scan": rel_err(sk[k]["m"], ss[k]["m"])[0],
                  "kernels_vs_f64": rel_err(sk[k]["m"].double(), ref)[0],
                  "scan_vs_f64": rel_err(ss[k]["m"].double(), ref)[0]}
    bad = {k: e for k, e in per.items()
           if e["kernels_vs_scan"] > TOL + 2 * e["scan_vs_f64"]
           or e["kernels_vs_f64"] > TOL + e["scan_vs_f64"]}
    noisy = {k: e for k, e in per.items() if e["scan_vs_f64"] > TOL / 10}
    r = {"loss_kernels": hk[0].item(), "loss_scan": hs[0].item(),
         "loss_rel": loss_rel, "finite": bool(hk[1].item() and hs[1].item()),
         "grads": len(per),
         "kernels_vs_scan_max": max(e["kernels_vs_scan"]
                                    for e in per.values()),
         "kernels_vs_scan_max_where_f32_noise_below_1e-5": max(
             (e["kernels_vs_scan"] for k, e in per.items()
              if k not in noisy), default=0.0),
         "kernels_vs_f64_max": max(e["kernels_vs_f64"] for e in per.values()),
         "scan_vs_f64_max": max(e["scan_vs_f64"] for e in per.values()),
         "f32_noisy_grads": noisy, "failing": bad,
         "pool_steps_fixed": fixed_pool,
         "pool_decisions_off_the_f64_arms": {a: f for a, f in flips.items()
                                             if a != "f64"}}
    print(f"kernel vs scan train step {name} " + json.dumps(r), flush=True)
    assert r["finite"] and loss_rel <= TOL, f"{name}: losses disagree: {r}"
    assert not bad, f"{name}: gradients disagree: {bad}"
    return r


def text_train(torch, rnn, conf, feed, lr, steps, tokens, name):
    """SGD.train (adam) on one fixed batch; returns the run's numbers
    (launch counts read just after the run, before the profile)."""
    from paddle_tpu_torch.core.config import OptimizationConf
    from paddle_tpu_torch.trainer.events import EndIteration
    from paddle_tpu_torch.trainer.trainer import SGD

    sgd = SGD(conf, OptimizationConf(learning_method="adam",
                                     learning_rate=lr),
              seed=SEED + 1, device="cuda")
    stamps, costs = [], []

    def on_event(e):
        if isinstance(e, EndIteration):
            costs.append(e.cost)          # fetched: the step is done
            stamps.append(time.perf_counter())

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    zero_rnn_counts(rnn)
    t0 = time.perf_counter()
    sgd.train(reader=lambda: iter([feed] * steps), feeder=lambda b: b,
              num_passes=1, event_handler=on_event)
    torch.cuda.synchronize()
    counts = rnn_counts(rnn)
    steady = float(np.median(np.diff(stamps))) * 1e3
    r = {"steps": steps, "wall_s": time.perf_counter() - t0,
         "ms_first_step": (stamps[0] - t0) * 1e3,
         "ms_per_step_median": steady,
         "tokens_per_step": tokens,
         "tokens_per_s": tokens / (steady / 1e3),
         "loss_first": costs[0], "loss_last": costs[-1],
         "peak_mem_gb": torch.cuda.max_memory_allocated() / 2 ** 30,
         "launches": counts}
    print(f"train {name} " + json.dumps(r), flush=True)
    assert np.isfinite(costs).all(), f"{name}: a loss is not finite"
    prof = profile_steps(torch, sgd, feed)
    if prof is not None:
        prof["idle_share"] = 1 - prof["device_ms_per_step"] / steady
    print(f"profile {name} " + json.dumps(prof), flush=True)
    r["profile"] = prof
    return r


def amp_text_step(torch, rnn, conf, feed, lr, name, want):
    """Phase 13b: one adam TrainStep of the kernel arm in f32 and under
    the bf16 flag from one weight map (B5-B8 cast the bf16 inputs up to
    f32 around the kernels, as the JAX wrappers do): the AMP loss finite
    and within 5% of the f32 step's (tests/test_amp.py's bound), the
    gradients f32 and each held against the f32 step's from adam's first
    moment (`amp_grads_held`), and the AMP step's launches `want` (counts
    read just after it), every one on the cluster route."""
    from paddle_tpu_torch.core.config import OptimizationConf
    from paddle_tpu_torch.network import Network
    from paddle_tpu_torch.optimizers import create_optimizer
    from paddle_tpu_torch.parallel.dp import TrainStep

    net = Network(conf)
    params = net.init_params(torch.Generator().manual_seed(SEED + 1),
                             device="cuda")
    set_rnn_arm("kernels")
    got = {}
    for amp in (False, True):
        set_amp(amp)
        try:
            opt = create_optimizer(OptimizationConf(learning_method="adam",
                                                    learning_rate=lr),
                                   net.param_confs)
            step = TrainStep(net, opt, watchdog=True, device="cuda")
            torch.cuda.synchronize()
            zero_rnn_counts(rnn)
            _p, st, _s, health, _o = step(params, opt.init_state(params), {},
                                          feed, 0, None)
            torch.cuda.synchronize()
            got[amp] = (health, st, rnn_counts(rnn))
        finally:
            set_amp(False)
    (h32, s32, _c32), (h16, s16, counts) = got[False], got[True]
    r = {"loss_f32": h32[0].item(), "loss_amp": h16[0].item(),
         "rel": abs(h16[0].item() - h32[0].item()) / abs(h32[0].item()),
         "finite": bool(h16[1].item()),
         "grad_dtypes": sorted({str(v["m"].dtype) for v in s16.values()}),
         "launches": counts}
    print(f"amp train step {name} " + json.dumps(r), flush=True)
    assert r["finite"] and r["rel"] <= 0.05, f"{name}: {r}"
    assert r["grad_dtypes"] == ["torch.float32"], r
    r["grad_rel_vs_f32_max"] = amp_grads_held(name, name, s16, s32, "m")
    expect = dict.fromkeys(RNN_COUNTERS, 0)
    expect.update(want)
    assert counts == expect, f"{name}: launches {counts}, want {expect}"
    return r


# phase 13c: the classifier at bench_lstm's wider widths (bench.py's
# lstm_bs*_h512 and lstm_bs*_h1280 rows), where B5 and B6 take the grid
# route
CLS_WIDE = (512, 1280)
CLS_WIDE_STEPS, CLS_WIDE_SCAN_STEPS = 10, 3


def wide_infer(torch, rnn, conf, name):
    """One Inferencer forward of `conf` at [64, 100] ragged ids, the kernel
    arm (B5's inference variant, twice on the grid route) against the scan
    arm from the same weights: probabilities within 1e-5."""
    from paddle_tpu_torch.network import Network
    from paddle_tpu_torch.trainer.trainer import Inferencer

    net = Network(conf)
    params = net.init_params(torch.Generator().manual_seed(SEED),
                             device="cuda")
    cls, _nmt = text_feeds(SEED + 60, ragged=True)
    feed = {"words": cls["words"]}
    out = {}
    for arm in ("kernels", "scan"):
        set_rnn_arm(arm)
        inf = Inferencer(net, params, outputs=["output"], device="cuda")
        torch.cuda.synchronize()
        zero_rnn_counts(rnn)
        t0 = time.perf_counter()
        logits = inf.infer(feed)["output"]
        ms = (time.perf_counter() - t0) * 1e3
        out[arm] = (logits, ms, rnn_counts(rnn))
    set_rnn_arm("kernels")
    (lk, ms_k, counts), (ls, ms_s, counts_s) = out["kernels"], out["scan"]
    pk, ps = (np.exp(z - z.max(axis=1, keepdims=True)) for z in (lk, ls))
    diff = float(np.abs(pk / pk.sum(axis=1, keepdims=True)
                        - ps / ps.sum(axis=1, keepdims=True)).max())
    r = {"shape": list(lk.shape), "finite": bool(np.isfinite(lk).all()),
         "prob_max_abs_diff": diff, "kernel_ms": ms_k, "scan_ms": ms_s,
         "launches": counts}
    print(f"inference {name} " + json.dumps(r), flush=True)
    assert r["shape"] == [CLS_B, 2] and r["finite"], r
    assert diff <= 1e-5, f"{name}: probabilities differ by {diff:.3g}"
    want = dict.fromkeys(RNN_COUNTERS, 0)
    want.update(lstm_fwd_infer_launches=2, lstm_fwd_infer_grid_launches=2)
    assert counts == want, f"{name}: launches {counts}, want {want}"
    assert sum(counts_s.values()) == 0, counts_s
    return r


def wide_classifier(torch, rnn):
    """Phase 13c: bench_lstm's classifier (vocab 30000, emb 128, 2 LSTM
    layers, B=64, T=100, adam 2e-3), f32, at h = 512 and 1280, where B5
    and B6 take the grid route: the held adam step (`held_text_step`,
    its max pool at the f64 arm's steps) at ragged lengths;
    CLS_WIDE_STEPS kernel-arm and CLS_WIDE_SCAN_STEPS
    scan-arm steps through SGD at full lengths with profiles, the loss
    falling in both, the kernel arm launching 2 B5 + 2 B6 a step, every
    one on the grid route (counts read just after the run); then one
    inference forward (`wide_infer`). Returns the numbers by width."""
    from paddle_tpu_torch.models.text import stacked_lstm_classifier

    cls_r, _nmt = text_feeds(SEED + 90, ragged=True)
    cls_f, _nmt = text_feeds(SEED + 91, ragged=False)
    out = {}
    for h in CLS_WIDE:
        conf = stacked_lstm_classifier(**dict(CLS, hidden=h))
        name = f"classifier_h{h}"
        held = held_text_step(torch, conf, cls_r, CLS_LR, name,
                              fixed_pool=True)
        runs = {}
        for arm, steps in (("kernels", CLS_WIDE_STEPS),
                           ("scan", CLS_WIDE_SCAN_STEPS)):
            set_rnn_arm(arm)
            runs[arm] = text_train(torch, rnn, conf, cls_f, CLS_LR, steps,
                                   CLS_B * CLS_T,
                                   f"{name}_{arm}_b{CLS_B}_t{CLS_T}")
        set_rnn_arm("kernels")
        for arm, r in runs.items():
            assert r["loss_last"] < r["loss_first"], (
                f"{name} {arm}: loss rose from {r['loss_first']:.4g} to "
                f"{r['loss_last']:.4g}")
        want = dict.fromkeys(RNN_COUNTERS, 0)
        n = 2 * CLS_WIDE_STEPS
        want.update(lstm_fwd_launches=n, lstm_fwd_grid_launches=n,
                    lstm_bwd_launches=n, lstm_bwd_grid_launches=n)
        got = runs["kernels"]["launches"]
        assert got == want, f"{name} launches {got}, want {want}"
        assert sum(runs["scan"]["launches"].values()) == 0, runs["scan"]
        out[h] = {"held": held, "runs": runs,
                  "infer": wide_infer(torch, rnn, conf, name)}
    return out


def text_training(torch, rnn):
    """Phases 12, 13 and 13c: the held steps at ragged lengths, then the
    training runs at the bench's full lengths, kernel arm then scan arm.
    Each kernel arm launches 2 B5 + 2 B6 (classifier) or 2 B7 + 2 B8
    (NMT) a step, every one on the cluster route (13c's classifier at
    h = 512 and 1280: on the grid route), and its loss falls."""
    cls_conf, nmt_conf = text_confs()
    cls_r, nmt_r = text_feeds(SEED + 70, ragged=True)
    held = (held_text_step(torch, cls_conf, cls_r, CLS_LR, "classifier"),
            held_text_step(torch, nmt_conf, nmt_r, NMT_LR, "nmt"))
    phase("13. train the classifier and the NMT through SGD")
    cls_f, nmt_f = text_feeds(SEED + 80, ragged=False)
    cls_tok = CLS_B * CLS_T
    nmt_tok = NMT_B * NMT_T                # target tokens, as bench_nmt
    runs = {}
    for arm in ("kernels", "scan"):
        set_rnn_arm(arm)
        n_cls = CLS_STEPS if arm == "kernels" else SCAN_STEPS
        n_nmt = NMT_STEPS if arm == "kernels" else SCAN_STEPS
        runs[f"classifier_{arm}"] = text_train(
            torch, rnn, cls_conf, cls_f, CLS_LR, n_cls, cls_tok,
            f"classifier_{arm}_b{CLS_B}_t{CLS_T}")
        runs[f"nmt_{arm}"] = text_train(
            torch, rnn, nmt_conf, nmt_f, NMT_LR, n_nmt, nmt_tok,
            f"nmt_{arm}_b{NMT_B}_t{NMT_T}")
    set_rnn_arm("kernels")
    for name, r in runs.items():
        assert r["loss_last"] < r["loss_first"], (
            f"{name}: loss rose from {r['loss_first']:.4g} to "
            f"{r['loss_last']:.4g}")
    c, n = runs["classifier_kernels"]["launches"], runs["nmt_kernels"][
        "launches"]
    want_c = dict.fromkeys(RNN_COUNTERS, 0)
    want_c.update(lstm_fwd_launches=2 * CLS_STEPS,
                  lstm_fwd_cluster_launches=2 * CLS_STEPS,
                  lstm_bwd_launches=2 * CLS_STEPS,
                  lstm_bwd_cluster_launches=2 * CLS_STEPS)
    want_n = dict.fromkeys(RNN_COUNTERS, 0)
    want_n.update(gru_fwd_launches=2 * NMT_STEPS,
                  gru_fwd_cluster_launches=2 * NMT_STEPS,
                  gru_bwd_launches=2 * NMT_STEPS,
                  gru_bwd_cluster_launches=2 * NMT_STEPS)
    assert c == want_c, f"classifier launches {c}, want {want_c}"
    assert n == want_n, f"nmt launches {n}, want {want_n}"
    for arm in ("classifier_scan", "nmt_scan"):
        assert sum(runs[arm]["launches"].values()) == 0, runs[arm]
    phase("13c. the classifier at bench_lstm's h = 512 and 1280 through "
          "SGD (the grid route)")
    wide = wide_classifier(torch, rnn)
    phase("13b. classifier and NMT adam steps under the bf16 flag")
    amp = (amp_text_step(torch, rnn, cls_conf, cls_f, CLS_LR, "classifier",
                         dict(lstm_fwd_launches=2,
                              lstm_fwd_cluster_launches=2,
                              lstm_bwd_launches=2,
                              lstm_bwd_cluster_launches=2)),
           amp_text_step(torch, rnn, nmt_conf, nmt_f, NMT_LR, "nmt",
                         dict(gru_fwd_launches=2, gru_fwd_cluster_launches=2,
                              gru_bwd_launches=2,
                              gru_bwd_cluster_launches=2)))
    return held, runs, amp, wide


# ---- the sparse CTR slice: B9, SparseUpdater, the sharded tier, CTR ------

# bench.py::bench_sparse_ctr (:771) and bench_ctr_widedeep_sparse (:835)
SP_D = 64
SP_TOUCHED = 65536
SP_INNER = 20
SP_V = (1 << 20, 1 << 22)
SP_LR, SP_MU = 0.01, 0.9
WD_BS, WD_T, WD_H1, WD_H2 = 256, 64, 64, 32
WD_DENSE_LR = 0.05
WD_WARM, WD_WINDOWS, WD_INNER = 5, 5, 10
WD_DENSE = ("w1", "b1", "w2", "b2", "wo")
# the sharded tier (phase 17)
TIER = dict(rows_total=1 << 30, dim=64, capacity=1 << 18, num_slots=16384)
TIER_HOT, TIER_STEPS, TIER_SHARDED_STEPS = 1 << 20, 40, 5
# the CTR models (phase 18): models/ctr.py's defaults, adam 0.02 as
# tests/test_compat_ctr.py; a label is 1 when a feature id < CTR_CLICK,
# which makes about half of the 64-feature examples 1
CTR_B, CTR_F, CTR_STEPS, CTR_CLICK = 256, 64, 30, 1080
SPARSE_TOL = 1e-6
SPARSE_COUNTERS = ("sparse_row_update_launches",
                   "sparse_row_gather_launches",
                   "sparse_row_scatter_launches")


def zero_sparse_counts(sr):
    for name in SPARSE_COUNTERS:
        setattr(sr, name, 0)


def sparse_counts(sr):
    return {name: getattr(sr, name) for name in SPARSE_COUNTERS}


def momentum_upd(p, g, m):
    """bench.py's `upd` (:790-792) as a user's function: the generic
    route."""
    m2 = 0.9 * m + g
    return p - 0.01 * m2, m2


def sparse_rules(tss):
    return {"sgd": (tss.sgd_row_update(0.5), 0),
            "momentum": (tss.momentum_row_update(SP_LR, SP_MU), 1),
            "adagrad": (tss.adagrad_row_update(0.1), 1),
            "lambda_state": (momentum_upd, 1),
            "lambda": (lambda p, g: p * 0.99 - 0.25 * g, 0)}


# (name, rule, V, D, N, num_slots or None, id range or None for V,
#  number of distinct ids or None): the two bench shapes, every rule and
# route, overflow, heavy duplication, D of 4/16/128 and ids >= V
SPARSE_CASES = [
    ("bench_momentum_v1m_d64_n65536", "momentum", 1 << 20, 64, 65536, None,
     None, None),
    ("widedeep_momentum_v1m_d64_n16384", "momentum", 1 << 20, 64, 16384,
     None, None, None),
    ("bench_sgd_v1m_d64_n65536", "sgd", 1 << 20, 64, 65536, None, None,
     None),
    ("adagrad_v1m_d64_n16384", "adagrad", 1 << 20, 64, 16384, None, None,
     None),
    ("bench_lambda_state_v1m_d64_n65536", "lambda_state", 1 << 20, 64,
     65536, None, None, None),
    ("lambda_v100k_d16_n4096", "lambda", 100000, 16, 4096, None, None,
     None),
    ("overflow_momentum_v64k_d64_n8192_k1024", "momentum", 1 << 16, 64,
     8192, 1024, None, None),
    ("heavy_dup_momentum_v1m_d64_n16384_100ids", "momentum", 1 << 20, 64,
     16384, None, None, 100),
    ("sgd_v64k_d4_n8192", "sgd", 1 << 16, 4, 8192, None, None, None),
    ("adagrad_v64k_d16_n8192", "adagrad", 1 << 16, 16, 8192, None, None,
     None),
    ("momentum_v64k_d128_n8192", "momentum", 1 << 16, 128, 8192, None,
     None, None),
    ("ids_past_v_adagrad_v1000_d5_n4000", "adagrad", 1000, 5, 4000, None,
     1300, None),
]


def sparse_inputs(torch, gen, v, d, n, n_state, high, distinct):
    dev = torch.device("cuda")
    p = torch.randn((v, d), generator=gen, device=dev)
    # adagrad's accumulator is never negative
    s = [torch.rand((v, d), generator=gen, device=dev)
         for _ in range(n_state)]
    if distinct:
        pick = torch.randperm(v, generator=gen, device=dev)[:distinct]
        ids = pick[torch.randint(0, distinct, (n,), generator=gen,
                                 device=dev)]
    else:
        ids = torch.randint(0, high or v, (n,), generator=gen, device=dev)
    g = torch.randn((n, d), generator=gen, device=dev)
    return [p, *s], ids.to(torch.int32), g


def sparse_bytes(n, k, kv, d, n_tables):
    """Bytes a B9 step must move: the N gradient rows, the int32
    perm/uids/off once, each valid touched row of each table read and
    written once."""
    return n * d * 4 + (n + 2 * k + 1) * 4 + 2 * n_tables * kv * d * 4


def check_sparse(torch, sr, tss, case, gen):
    """Kernel route vs plain version on the card at one case: the touched
    rows within SPARSE_TOL of the largest, every other row bit-equal to
    the start, the kernel bit-identical over two runs."""
    name, rule_name, v, d, n, k, high, distinct = case
    fn, n_state = sparse_rules(tss)[rule_name]
    start, ids, g = sparse_inputs(torch, gen, v, d, n, n_state, high,
                                  distinct)
    return hold_sparse(torch, sr, name, rule_name, fn, start, ids, g,
                       k or n, v)


def hold_sparse(torch, sr, name, rule_name, fn, start, ids, g, k, v):
    """check_sparse's comparison on given tables, ids and gradients."""
    d, n = start[0].shape[1], ids.numel()
    runs = []
    for _ in range(2):
        tabs = [t.clone() for t in start]
        sr.sparse_rows(fn, tabs, ids, g, k, v)
        runs.append(tabs)
    plain = [t.clone() for t in start]
    sr.sparse_rows_plain(fn, plain, ids, g, k, v)
    torch.cuda.synchronize()
    uids, _perm, _off = sr.kernel_indices(ids, k)
    valid = uids[(uids >= 0) & (uids < v)].long()
    touched = torch.zeros(v, dtype=torch.bool, device="cuda")
    touched[valid] = True
    errs, diffs = [], []
    for got, again, ref, s in zip(runs[0], runs[1], plain, start):
        assert torch.equal(got, again), f"{name}: not bit-identical run to run"
        assert torch.equal(got[~touched], s[~touched]), (
            f"{name}: a row not touched changed")
        rel, diff = rel_err(got[touched], ref[touched])
        assert np.isfinite(rel) and rel <= SPARSE_TOL, (
            f"{name}: {rel:.3g} > {SPARSE_TOL}")
        errs.append(rel)
        diffs.append(diff)
    r = {"case": name, "rule": rule_name, "V": v, "D": d, "N": n, "k": k,
         "touched": int(valid.numel()), "rel_err": max(errs),
         "max_abs_err": max(diffs)}
    print("sparse " + json.dumps(r), flush=True)
    return r


def time_sparse(torch, sr, tss, case, gen):
    """Times at one shape: the B9 launch alone (kernel_indices done
    once), torch.sort alone, the whole preparation, the plain version,
    and — for SGD — `index_add_` (the one PyTorch call computing the
    same function); for the generic route the gather and scatter
    kernels. Warm, CUDA events, the same inputs every rep."""
    name, rule_name, v, d, n, k, high, distinct = case
    fn, n_state = sparse_rules(tss)[rule_name]
    tabs, ids, g = sparse_inputs(torch, gen, v, d, n, n_state, high,
                                 distinct)
    k = k or n
    uids, perm, off = sr.kernel_indices(ids, k)
    kv = int(((uids >= 0) & (uids < v)).sum())
    flat = ids.long()
    r = {"case": name, "V": v, "D": d, "N": n, "k": k, "touched": kv,
         "sort_ms": time_ms(torch, lambda: torch.sort(flat, stable=True)),
         "prep_ms": time_ms(torch, lambda: sr.kernel_indices(ids, k)),
         "plain_ms": time_ms(torch, lambda: sr.sparse_rows_plain(
             fn, tabs, ids, g, k, v), reps=5)}
    if isinstance(fn, sr.RowRule):
        r["ms"] = time_ms(torch, lambda: sr.update_kernel(
            fn, tabs, g, uids, perm, off, v))
        r["wrapper_ms"] = time_ms(torch, lambda: sr.sparse_rows(
            fn, tabs, ids, g, k, v))
        nbytes = sparse_bytes(n, k, kv, d, len(tabs))
        if rule_name == "sgd":
            r["library_ms"] = time_ms(torch, lambda: tabs[0].index_add_(
                0, flat, g, alpha=-fn.lr))
    else:
        gsum, rows = sr.gather_kernel(tabs, g, uids, perm, off, v)
        r["gather_ms"] = time_ms(torch, lambda: sr.gather_kernel(
            tabs, g, uids, perm, off, v))
        r["scatter_ms"] = time_ms(torch, lambda: sr.scatter_kernel(
            tabs, rows, uids, v))
        r["wrapper_ms"] = time_ms(torch, lambda: sr.sparse_rows(
            fn, tabs, ids, g, k, v))
        # gather: grads, indices, table rows read; gsum and rows written
        gb = (n * d * 4 + (n + 2 * k + 1) * 4
              + len(tabs) * (kv + k) * d * 4 + k * d * 4)
        # scatter: uids and rows read, table rows written
        sb = k * 4 + len(tabs) * (k + kv) * d * 4
        r["gather_bound_ms"] = gb / H100_BYTES_PER_S * 1e3
        r["scatter_bound_ms"] = sb / H100_BYTES_PER_S * 1e3
        nbytes = gb + sb
    r["bound_ms"] = nbytes / H100_BYTES_PER_S * 1e3
    r["bound_by"] = "bytes"
    print("sparse_time " + json.dumps(r), flush=True)
    return r


def check_negative_id(torch, sr, tss, gen):
    """A negative id past one slot a warp: k = N = 140 000 distinct ids
    (momentum, D = 64), one of them -7. It sorts into slot 0; above
    131 072 slots a warp walks more than one, and the id must not end
    that walk (a fault of the first B9, repaired since)."""
    v = n = 140_000
    fn, _n_state = sparse_rules(tss)["momentum"]
    start, _ids, g = sparse_inputs(torch, gen, v, SP_D, n, 1, None, None)
    ids = torch.randperm(v, generator=gen, device="cuda").to(torch.int32)
    ids[ids == 4321] = -7
    r = hold_sparse(torch, sr, "negative_id_momentum_v140k_d64_k140000",
                    "momentum", fn, start, ids, g, n, v)
    assert r["touched"] == v - 1, r
    return r


def sparse_kernels(torch, sr, tss):
    """Phase 14: every case held (and the negative id past one slot a
    warp), then the times at the bench shapes."""
    gen = torch.Generator(device="cuda").manual_seed(SEED + 140)
    checks = [check_sparse(torch, sr, tss, c, gen) for c in SPARSE_CASES]
    checks.append(check_negative_id(torch, sr, tss, gen))
    times = {c[0]: time_sparse(torch, sr, tss, c, gen)
             for c in SPARSE_CASES if c[0].startswith(("bench_",
                                                       "widedeep_"))}
    return checks, times


def sparse_standalone(torch, sr, tsp, tss):
    """Phase 15, as bench_sparse_ctr: momentum tables at V = 2^20 and
    2^22 x 64, 65 536 touched ids a step, 20 steps a `run_steps`; the
    first run counted and held against 20 plain steps from the same
    start; at 2^20 also the bench's own `upd` as a user function (the
    generic route). Then the step times, in turns 2^20, 2^22, 2^22,
    2^20 (2 warm + best of 5 runs each), with the host's enqueue time
    apart from the wait for the device."""
    gen = torch.Generator(device="cuda").manual_seed(SEED + 150)
    dev = torch.device("cuda")
    rule = tss.momentum_row_update(SP_LR, SP_MU)
    res, state, launches = {}, {}, dict.fromkeys(SPARSE_COUNTERS, 0)
    for v in SP_V:
        upd = tsp.SparseUpdater(rule)
        param = upd.place(torch.zeros((v, SP_D), device=dev))
        mom = upd.place(torch.zeros((v, SP_D), device=dev))
        ids_seq = torch.randint(0, v, (SP_INNER, SP_TOUCHED), generator=gen,
                                device=dev, dtype=torch.int32)
        grads_seq = torch.randn((SP_INNER, SP_TOUCHED, SP_D), generator=gen,
                                device=dev)
        start = (param.clone(), mom.clone())
        torch.cuda.synchronize()
        zero_sparse_counts(sr)
        t0 = time.perf_counter()
        param, (mom,) = upd.run_steps(param, ids_seq, grads_seq, (mom,))
        torch.cuda.synchronize()
        first_ms = (time.perf_counter() - t0) * 1e3 / SP_INNER
        counts = sparse_counts(sr)
        assert counts["sparse_row_update_launches"] == SP_INNER, counts
        for key in SPARSE_COUNTERS:
            launches[key] += counts[key]
        ref = [t.clone() for t in start]
        for i in range(SP_INNER):
            sr.sparse_rows_plain(rule, ref, ids_seq[i], grads_seq[i],
                                 SP_TOUCHED, v)
        for got, want in zip((param, mom), ref):
            assert torch.allclose(got, want, rtol=1e-5, atol=1e-6), (
                f"V={v}: 20 kernel steps differ from 20 plain steps by "
                f"{(got - want).abs().max().item():.3g}")
        held = max((got - want).abs().max().item()
                   for got, want in zip((param, mom), ref))
        del ref
        res[v] = {"V": v, "first_run_ms_per_step": first_ms,
                  "held_max_abs_diff": held, "launches": counts}
        if v == SP_V[0]:
            gp, gm = (t.clone() for t in start)
            generic = tsp.SparseUpdater(momentum_upd)
            zero_sparse_counts(sr)
            gp, (gm,) = generic.run_steps(gp, ids_seq, grads_seq, (gm,))
            torch.cuda.synchronize()
            gcounts = sparse_counts(sr)
            assert gcounts == {"sparse_row_update_launches": 0,
                               "sparse_row_gather_launches": SP_INNER,
                               "sparse_row_scatter_launches": SP_INNER}, (
                gcounts)
            for key in SPARSE_COUNTERS:
                launches[key] += gcounts[key]
            for got, want in zip((gp, gm), (param, mom)):
                assert torch.allclose(got, want, rtol=1e-5, atol=1e-6), (
                    "generic route differs from the momentum rule")
            res[v].update(
                generic_bit_equal=bool(torch.equal(gp, param)
                                       and torch.equal(gm, mom)),
                generic_ms_per_step=best_run_ms(
                    torch, lambda: generic.run_steps(
                        gp, ids_seq, grads_seq, (gm,)))[0] / SP_INNER,
                generic_launches=gcounts)
            del gp, gm
        del start
        # the device's share: B9 alone on step 0's indices, and the
        # kernel time of one profiled run_steps
        uids, perm, off = sr.kernel_indices(ids_seq[0], SP_TOUCHED)
        views = [param.view(-1, SP_D), mom.view(-1, SP_D)]
        res[v]["kernel_ms"] = time_ms(torch, lambda: sr.update_kernel(
            rule, views, grads_seq[0], uids, perm, off, v))
        prof = profile_fn(torch, lambda: upd.run_steps(
            param, ids_seq, grads_seq, (mom,)), steps=1)
        res[v]["device_ms_per_step"] = (prof["device_ms_per_step"]
                                        / SP_INNER if prof else None)
        state[v] = (upd, param, mom, ids_seq, grads_seq)
    # the host's clock moves between moments on a shared host: time the
    # two tables in turns
    for v in (SP_V[0], SP_V[1], SP_V[1], SP_V[0]):
        upd, param, mom, ids_seq, grads_seq = state[v]
        total, enqueue = best_run_ms(torch, lambda: upd.run_steps(
            param, ids_seq, grads_seq, (mom,)))
        res[v].setdefault("turns_ms_per_step", []).append(total / SP_INNER)
        res[v].setdefault("turns_enqueue_ms_per_step", []).append(
            enqueue / SP_INNER)
    for v in SP_V:
        res[v]["ms_per_step"] = float(np.mean(res[v]["turns_ms_per_step"]))
        print("standalone " + json.dumps(res[v]), flush=True)
    del state
    torch.cuda.empty_cache()
    ratio = res[SP_V[1]]["ms_per_step"] / res[SP_V[0]]["ms_per_step"]
    print(f"standalone time(2^22)/time(2^20) = {ratio:.4f}", flush=True)
    return {"runs": res, "ratio": ratio, "launches": launches}


def best_run_ms(torch, fn, warm=2, reps=5):
    """(best host-clock ms of fn() followed by a synchronize, the ms
    that run took to return from fn(): the host's enqueue), after warm
    calls."""
    for _ in range(warm):
        fn()
    torch.cuda.synchronize()
    best = (float("inf"), None)
    for _ in range(reps):
        t0 = time.perf_counter()
        fn()
        t1 = time.perf_counter()
        torch.cuda.synchronize()
        best = min(best, ((time.perf_counter() - t0) * 1e3,
                          (t1 - t0) * 1e3))
    return best


def widedeep_step(torch, dense, table, ids, labels, apply_rows):
    """One wide&deep train step as bench_ctr_widedeep_sparse: rows
    gathered from the placed table, the dense tower (mean pool, 64 -> 64
    -> 32 -> 2, relu) forward and backward through autograd, SGD 0.05 on
    the dense weights, then the per-occurrence row gradients applied by
    `apply_rows(flat ids, grads [N, D])`. Returns the loss."""
    flat = ids.reshape(-1)
    rows = table.view(-1, SP_D).index_select(0, flat).view(
        WD_BS, WD_T, SP_D).requires_grad_(True)
    params = [dense[k].requires_grad_(True) for k in WD_DENSE]
    w1, b1, w2, b2, wo = params
    h = torch.relu(rows.mean(1) @ w1 + b1)
    h = torch.relu(h @ w2 + b2)
    logp = torch.log_softmax(h @ wo, dim=-1)
    loss = -logp.gather(1, labels[:, None]).mean()
    grads = torch.autograd.grad(loss, [rows, *params])
    with torch.no_grad():
        for key, g in zip(WD_DENSE, grads[1:]):
            dense[key] = dense[key].detach() - WD_DENSE_LR * g
    apply_rows(flat, grads[0].reshape(-1, SP_D))
    return loss.detach()


def widedeep(torch, sr, tsp, tss):
    """Phase 16, as bench_ctr_widedeep_sparse at V = 2^20 and 2^22: a
    held step (kernel route vs plain route) at 2^20, then 5 warm steps
    and 5 windows of 10 timed steps (sync on the table at each window's
    end), counted, and a profile of 5 more steps."""
    dev = torch.device("cuda")
    rule = tss.momentum_row_update(SP_LR, SP_MU)
    n = WD_BS * WD_T
    res, launches, held = {}, 0, None
    for v in SP_V:
        gen = torch.Generator(device="cuda").manual_seed(SEED + 160)
        upd = tsp.SparseUpdater(rule)
        table = upd.place(torch.randn((v, SP_D), generator=gen, device=dev)
                          * 0.01)
        mom = upd.place(torch.zeros((v, SP_D), device=dev))
        dense = {
            "w1": torch.randn((SP_D, WD_H1), generator=gen, device=dev) * 0.05,
            "b1": torch.zeros(WD_H1, device=dev),
            "w2": torch.randn((WD_H1, WD_H2), generator=gen, device=dev)
            * 0.05,
            "b2": torch.zeros(WD_H2, device=dev),
            "wo": torch.randn((WD_H2, 2), generator=gen, device=dev) * 0.05,
        }
        ids = torch.randint(0, v, (WD_BS, WD_T), generator=gen, device=dev,
                            dtype=torch.int32)
        labels = torch.randint(0, 2, (WD_BS,), generator=gen, device=dev)

        def kernel_rows(flat, g, table=table, mom=mom, upd=upd):
            upd(table, flat, g, (mom,))

        if v == SP_V[0]:
            start = (table.clone(), mom.clone(), dict(dense))
            pt, pm, pd = start[0].clone(), start[1].clone(), dict(start[2])
            kt, km, kd = start[0].clone(), start[1].clone(), dict(start[2])
            lp = widedeep_step(torch, pd, pt, ids, labels, lambda f, g:
                               sr.sparse_rows_plain(rule, [pt, pm], f, g, n,
                                                    v))
            lk = widedeep_step(torch, kd, kt, ids, labels, lambda f, g:
                               upd(kt, f, g, (km,)))
            torch.cuda.synchronize()
            rel_loss = abs(lk.item() - lp.item()) / abs(lp.item())
            errs = [rel_err(a, b)[0] for a, b in ((kt, pt), (km, pm))]
            errs += [rel_err(kd[key], pd[key])[0] for key in WD_DENSE]
            held = {"loss": lk.item(), "loss_rel_err": rel_loss,
                    "table_rel_err": errs[0], "mom_rel_err": errs[1],
                    "dense_rel_err": max(errs[2:])}
            print("widedeep_held " + json.dumps(held), flush=True)
            assert rel_loss <= SPARSE_TOL and max(errs) <= SPARSE_TOL, held
            del start, pt, pm, pd, kt, km, kd
        torch.cuda.synchronize()
        zero_sparse_counts(sr)
        losses = [widedeep_step(torch, dense, table, ids, labels, kernel_rows)
                  for _ in range(WD_WARM)]
        best = float("inf")
        for _ in range(WD_WINDOWS):
            t0 = time.perf_counter()
            for _ in range(WD_INNER):
                losses.append(widedeep_step(torch, dense, table, ids, labels,
                                            kernel_rows))
            table[0].sum().item()      # the window ends when the table does
            best = min(best, (time.perf_counter() - t0) * 1e3 / WD_INNER)
        counts = sparse_counts(sr)
        want = WD_WARM + WD_WINDOWS * WD_INNER
        assert counts["sparse_row_update_launches"] == want, counts
        launches += want
        losses = torch.stack(losses).cpu().numpy()
        assert np.isfinite(losses).all(), "a wide&deep loss is not finite"
        prof = profile_fn(torch, lambda: widedeep_step(
            torch, dense, table, ids, labels, kernel_rows))
        if prof is not None:
            prof["idle_share"] = 1 - prof["device_ms_per_step"] / best
        res[v] = {"V": v, "ms_per_step": best,
                  "examples_per_s": WD_BS / (best / 1e3),
                  "loss_first": float(losses[0]),
                  "loss_last": float(losses[-1]), "launches": counts,
                  "profile": prof}
        print("widedeep " + json.dumps(res[v]), flush=True)
        del table, mom, upd
        torch.cuda.empty_cache()
    ratio = res[SP_V[1]]["ms_per_step"] / res[SP_V[0]]["ms_per_step"]
    print(f"widedeep time(2^22)/time(2^20) = {ratio:.4f}", flush=True)
    return {"runs": res, "ratio": ratio, "held": held, "launches": launches}


def tier_steps(seed, steps):
    """`steps` batches of 256 x 64 ids from a fixed hot set of ~2^20 ids
    of the 2^30-row table, with their gradients (numpy seed)."""
    rng = np.random.default_rng(seed)
    hot = np.unique(rng.integers(0, TIER["rows_total"], TIER_HOT))
    return [(hot[rng.integers(0, len(hot), (WD_BS, WD_T))],
             rng.standard_normal((WD_BS * WD_T, TIER["dim"]))
             .astype(np.float32)) for _ in range(steps)]


def drive_tier(torch, table, batches, timed):
    """lookup + update per batch; with `timed`, the host clock of each
    step (synchronized) and of its residency work (`ensure_resident`:
    the host maps and the spill copies)."""
    host = [0.0]
    resident = table.ensure_resident

    def timed_resident(uids):
        t0 = time.perf_counter()
        resident(uids)
        host[0] += time.perf_counter() - t0

    if timed:
        table.ensure_resident = timed_resident
    steps_ms = []
    try:
        for ids, grads in batches:
            t0 = time.perf_counter()
            table.lookup(ids)
            table.update(ids, grads)
            if timed:
                torch.cuda.synchronize()
            steps_ms.append((time.perf_counter() - t0) * 1e3)
    finally:
        table.ensure_resident = resident
    return steps_ms, host[0] * 1e3


def payloads_close(got, want, what):
    """Export payloads: ids, slots and spill ids equal, every row and
    slot within 1e-5 of the largest entry. Returns the largest error."""
    worst = 0.0
    assert len(got) == len(want), what
    for a, b in zip(got, want):
        assert sorted(a) == sorted(b), what
        for key in ("ids", "slots", "spill_ids"):
            assert np.array_equal(a[key], b[key]), f"{what}: {key} differ"
        for key in a:
            if key not in ("ids", "slots", "spill_ids") and len(b[key]):
                scale = max(float(np.abs(b[key]).max()), 1e-30)
                err = float(np.abs(a[key] - b[key]).max()) / scale
                assert err <= 1e-5, f"{what}: {key} {err:.3g}"
                worst = max(worst, err)
    return worst


def sharded_tier(torch, sr, tss):
    """Phase 17: the 2^30-row tier on the card, one shard, adagrad — 40
    steps timed and counted, held against the same steps of a CPU table
    through the export payloads; then 5 steps with 8 shards and hash
    placement, held the same way."""
    rule = tss.adagrad_row_update(0.1)
    out = {}
    for name, shards, placement, steps in (
            ("one_shard_range", 1, "range", TIER_STEPS),
            ("eight_shards_hash", 8, "hash", TIER_SHARDED_STEPS)):
        cfg = tss.ShardedTableConfig(placement=placement, **TIER)
        batches = tier_steps(SEED + 170, steps)
        card = tss.ShardedEmbeddingTable(cfg, num_shards=shards,
                                         update_fn=rule, num_state=1,
                                         device="cuda")
        torch.cuda.synchronize()
        zero_sparse_counts(sr)
        t0 = time.perf_counter()
        steps_ms, host_ms = drive_tier(torch, card, batches[:-3], True)
        prof = profile_fn(torch, lambda it=iter(batches[-3:]): drive_tier(
            torch, card, [next(it)], False), steps=2)
        wall = time.perf_counter() - t0
        counts = sparse_counts(sr)
        assert counts["sparse_row_update_launches"] == steps, counts
        cpu = tss.ShardedEmbeddingTable(cfg, num_shards=shards,
                                        update_fn=rule, num_state=1,
                                        device="cpu")
        drive_tier(torch, cpu, batches, False)
        assert card.stats == cpu.stats, (card.stats, cpu.stats)
        err = payloads_close(card.export_shards(), cpu.export_shards(), name)
        n = len(steps_ms)
        r = {"shards": shards, "placement": placement, "steps": steps,
             "wall_s": wall, "ms_per_step_median":
             float(np.median(steps_ms[1:])) if n > 1 else steps_ms[0],
             "residency_host_ms_per_step": host_ms / n,
             "stats": card.stats, "rows_materialized":
             card.rows_materialized, "cache_rows": card._S,
             "export_max_rel_err": err, "launches": counts,
             "profile": prof}
        if prof is not None:
            r["device_ms_per_step"] = prof["device_ms_per_step"]
        print("tier " + json.dumps(r), flush=True)
        if shards == 1:
            assert card.stats["evictions"] > 0, "the cache never evicted"
        out[name] = r
        del card, cpu
        torch.cuda.empty_cache()
    return out


def ctr_models(torch):
    """Phase 18: ctr_wide_deep at models/ctr.py's defaults through SGD
    (adam 0.02) on one fixed batch for 30 steps — the loss falls below
    half its first value — and one step of ctr_linear with adagrad."""
    from paddle_tpu_torch.core.arg import id_arg
    from paddle_tpu_torch.core.config import OptimizationConf
    from paddle_tpu_torch.models import ctr
    from paddle_tpu_torch.trainer.events import EndIteration
    from paddle_tpu_torch.trainer.trainer import SGD

    rng = np.random.default_rng(SEED + 180)
    feats = rng.integers(0, 100000, (CTR_B, CTR_F)).astype(np.int32)
    label = (feats < CTR_CLICK).any(axis=1).astype(np.int32)
    feed = {"features": id_arg(feats, np.full(CTR_B, CTR_F, np.int32),
                               device="cuda"),
            "label": id_arg(label, device="cuda")}
    out = {"label_mean": float(label.mean())}
    for name, conf, method, lr, steps in (
            ("wide_deep_adam", ctr.ctr_wide_deep(), "adam", 0.02,
             CTR_STEPS),
            ("linear_adagrad", ctr.ctr_linear(), "adagrad", 0.1, 1)):
        sgd = SGD(conf, OptimizationConf(learning_method=method,
                                         learning_rate=lr),
                  seed=SEED + 181, device="cuda")
        stamps, costs = [], []

        def on_event(e):
            if isinstance(e, EndIteration):
                costs.append(e.cost)
                stamps.append(time.perf_counter())

        torch.cuda.synchronize()
        t0 = time.perf_counter()
        sgd.train(reader=lambda: iter([feed] * steps), feeder=lambda b: b,
                  num_passes=1, event_handler=on_event)
        assert np.isfinite(costs).all(), f"{name}: a loss is not finite"
        ms = (float(np.median(np.diff(stamps))) * 1e3 if steps > 1
              else (stamps[0] - t0) * 1e3)
        out[name] = {"steps": steps, "loss_first": costs[0],
                     "loss_last": costs[-1], "ms_per_step": ms,
                     "examples_per_s": CTR_B / (ms / 1e3)}
        print(f"ctr {name} " + json.dumps(out[name]), flush=True)
    wd = out["wide_deep_adam"]
    assert wd["loss_last"] < 0.5 * wd["loss_first"], (
        f"wide&deep loss fell only from {wd['loss_first']:.4g} to "
        f"{wd['loss_last']:.4g}")
    return out


def sparse_kernel_rows(checks, times, standalone, wide_deep, tier):
    """The B9 kernels' rows of the kernels line, at the standalone bench
    shape (V = 2^20, D = 64, N = 65 536): the rule kernel with momentum
    (no single PyTorch call computes a momentum row update; SGD's
    index_add_ is printed in phase 14) and the generic route's kernels
    with the bench's own update function. Launches: phases 15-17."""
    bench = times["bench_momentum_v1m_d64_n65536"]
    generic = times["bench_lambda_state_v1m_d64_n65536"]
    launches = standalone["launches"]
    update = (launches["sparse_row_update_launches"] + wide_deep["launches"]
              + sum(r["launches"]["sparse_row_update_launches"]
                    for r in tier.values()))

    def row(name, at, ms, bound, launched, rules):
        return {
            "name": name,
            "route": "cuda",
            "source": "paddle_tpu_torch/csrc/sparse_rows.cu",
            "replaces": "paddle_tpu/parallel/sparse.py:330",
            "launches": launched,
            "max_abs_err": max(r["max_abs_err"] for r in checks
                               if r["rule"] in rules),
            "ms": at[ms], "plain_ms": at["plain_ms"],
            "bound_ms": at[bound], "bound_by": "bytes",
            "library_ms": None,
        }

    rules, generic_rules = ("sgd", "momentum", "adagrad"), ("lambda",
                                                           "lambda_state")
    return [
        row("sparse_row_update", bench, "ms", "bound_ms", update, rules),
        row("sparse_row_gather", generic, "gather_ms", "gather_bound_ms",
            launches["sparse_row_gather_launches"], generic_rules),
        row("sparse_row_scatter", generic, "scatter_ms", "scatter_bound_ms",
            launches["sparse_row_scatter_launches"], generic_rules),
    ]


def no_serialised_wgmma(log, name):
    """Fail where ptxas serialised a kernel's wgmma (a wgmma on a path it
    cannot prove warp-uniform: every product then waits for the last)."""
    bad = [line for line in log.splitlines()
           if "wgmma.mma_async instructions are serialized" in line]
    assert not bad, f"{name}: ptxas serialised wgmma:\n" + "\n".join(bad)


def ptxas_report(log):
    """One line a kernel of an nvcc -Xptxas -v log: its name, registers,
    shared memory and spills."""
    import re

    name = None
    for line in log.splitlines():
        m = re.search(r"Compiling entry function '(\S+)'", line)
        if m:
            k = re.search(r"\d+([a-z_]+_kernel)", m.group(1))
            # the template's int arguments (a Tile<...>'s among them)
            ints = re.findall(r"Li(\d+)E", m.group(1))
            name = (k.group(1) + (f"<{','.join(ints)}>" if ints else "")
                    if k else m.group(1))
        elif name and ("registers" in line or "spill" in line):
            print(f"ptxas {name}: {line.split(':')[-1].strip()}", flush=True)


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device available", file=sys.stderr)
        return 2
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    from paddle_tpu_torch.core.device import resolve_device
    from paddle_tpu_torch.ops import _build
    from paddle_tpu_torch.ops import bn_act_conv1x1 as fop
    from paddle_tpu_torch.ops import flash_attention as fa
    from paddle_tpu_torch.ops import rnn
    from paddle_tpu_torch.ops import sparse_rows as sr
    from paddle_tpu_torch.parallel import sparse as tsp
    from paddle_tpu_torch.parallel import sparse_shard as tss

    phase("1. card")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip().splitlines()[0]
    print(smi, flush=True)
    print(f"torch {torch.__version__} cuda {torch.version.cuda} "
          f"python {sys.version.split()[0]}", flush=True)
    resolve_device("cuda")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    phase("2. build")
    t0 = time.perf_counter()
    libs = _build.build_all()
    print(f"built {sorted(libs)} in {time.perf_counter() - t0:.2f} s",
          flush=True)
    for line in _build.build_log(fa.KERNEL).splitlines():
        if "registers" in line or "spill" in line:
            print("ptxas: " + line.strip(), flush=True)

    phase("3. flash kernel vs plain version")
    gen = torch.Generator(device="cuda").manual_seed(SEED)
    # the first four are prefill shapes of phase 4 (B=1, a bucket T,
    # kv_len = the prompt length); the others cover batch, odd T, the
    # other head dims, q_len and an empty row
    cases = [
        dict(name="served_b1_t1024_h4_d64", B=1, Tq=1024, Tk=1024, H=4,
             D=64, causal=True, kv_len=[1000]),
        dict(name="served_b1_t512_h4_d64", B=1, Tq=512, Tk=512, H=4,
             D=64, causal=True, kv_len=[300]),
        dict(name="served_b1_t64_h4_d64", B=1, Tq=64, Tk=64, H=4, D=64,
             causal=True, kv_len=[64]),
        dict(name="served_b1_t32_h4_d64", B=1, Tq=32, Tk=32, H=4, D=64,
             causal=True, kv_len=[17]),
        dict(name="b4_t1024_h4_d64_ragged", B=4, Tq=1024, Tk=1024, H=4,
             D=64, causal=True, kv_len=[1024, 700, 333, 1]),
        dict(name="b2_t48_h2_d32", B=2, Tq=48, Tk=48, H=2, D=32,
             causal=True),
        dict(name="b2_tq64_tk200_h4_d128_cross", B=2, Tq=64, Tk=200, H=4,
             D=128, causal=False, kv_len=[200, 123], q_len=[50, 64],
             expect_dead=True),
        dict(name="b2_t64_h2_d64_kvlen0", B=2, Tq=64, Tk=64, H=2, D=64,
             causal=True, kv_len=[0, 64], expect_dead=True),
        # LM (b)'s training forward (phase 6)
        dict(name="train_b8_t1024_h4_d64_ragged", B=8, Tq=1024, Tk=1024,
             H=4, D=64, causal=True, kv_len=list(PROMPT_LENS)),
        # a head dim the kernel instantiates beyond 32/64/128
        dict(name="b2_t300_h3_d96_ragged", B=2, Tq=300, Tk=300, H=3, D=96,
             causal=True, kv_len=[300, 151]),
    ]
    results = [check_kernel(torch, fa, c, gen) for c in cases]

    phase("3b. the flash kernel's bf16 form vs its bf16 plain version")
    results_bf16 = [check_kernel_bf16(torch, fa, c, gen)
                    for c in cases + [LONGCTX_SHAPE] + BF16_EDGE_SHAPES]

    phase("4. serve the paged LM through the port")
    launches = serve_lm(torch, fa)

    phase("5. flash backward kernels vs plain version")
    for line in _build.build_log(fa.BWD_KERNEL).splitlines():
        if "registers" in line or "spill" in line:
            print("ptxas: " + line.strip(), flush=True)
    # the first two are the training shapes of phase 6; the others
    # cover the other head dims, odd T, q_len and an empty row
    bwd_cases = [
        dict(name="train_b32_t128_h4_d64", B=32, Tq=128, Tk=128, H=4,
             D=64, causal=True),
        dict(name="train_b8_t1024_h4_d64_ragged", B=8, Tq=1024, Tk=1024,
             H=4, D=64, causal=True, kv_len=list(PROMPT_LENS)),
        dict(name="b2_t77_h3_d32", B=2, Tq=77, Tk=77, H=3, D=32,
             causal=True, kv_len=[77, 40]),
        dict(name="b2_tq64_tk200_h4_d128_cross", B=2, Tq=64, Tk=200, H=4,
             D=128, causal=False, kv_len=[200, 123], q_len=[50, 64],
             expect_dead=True),
        dict(name="b2_t64_h2_d64_kvlen0", B=2, Tq=64, Tk=64, H=2, D=64,
             causal=True, kv_len=[0, 64], expect_dead=True),
        dict(name="b2_t300_h3_d96_ragged", B=2, Tq=300, Tk=300, H=3, D=96,
             causal=True, kv_len=[300, 151]),
    ]
    bwd = [check_backward(torch, fa, c, gen) for c in bwd_cases]

    phase("5b. the flash backward kernels' bf16 forms vs their bf16 plain "
          "version")
    bwd_bf16 = [check_backward_bf16(torch, fa, c, gen)
                for c in bwd_cases + [LONGCTX_SHAPE] + BF16_EDGE_SHAPES]

    phase("6. train the LM through SGD")
    _parity, runs = train_lm(torch, fa)
    train_fwd = sum(r["launches_fwd"] for r in runs.values())

    phase("6c. train the LM at bench_lm_train's settings under the bf16 "
          "flag")
    train_lm_amp(torch, fa)

    phase("6d. the long-context trainer at bench_longctx's settings under "
          "the bf16 flag, flash vs dense")
    _held_longctx, longctx_runs = train_longctx_amp(torch, fa)

    phase("7. fused BN-ReLU-1x1 kernels vs plain version")
    ptxas_report(_build.build_log(fop.KERNEL))
    no_serialised_wgmma(_build.build_log(fop.KERNEL), fop.KERNEL)
    fused_err, fused_times = fused_kernels(torch, fop)

    phase("7b. the fused kernels' bf16 forms vs their bf16 plain versions")
    fused_err_bf16, fused_times_bf16 = fused_kernels_bf16(torch, fop)

    phase("8. ResNet-50 inference through Inferencer")
    plain, fused, rparams, rstate = resnet_nets(torch)
    infer = resnet_infer(torch, fop, plain, fused, rparams, rstate)

    phase("9. ResNet-50 training through SGD")
    _held, train_b, _train_plain = resnet_training(torch, fop, plain, fused,
                                                   rparams, rstate)

    phase("9c. ResNet-50 training under the bf16 flag at bench_resnet50's "
          "settings")
    _held_amp, train_amp, _train_plain_amp = resnet_training_amp(
        torch, fop, plain, fused, rparams, rstate)
    del plain, fused, rparams, rstate

    phase("10. LSTM/GRU sequence kernels vs plain version")
    for kernel in (rnn.LSTM_KERNEL, rnn.GRU_KERNEL):
        ptxas_report(_build.build_log(kernel))
    rnn_res = rnn_kernels(torch, rnn)

    phase("11. IMDB classifier inference through Inferencer")
    cls_infer = classifier_infer(torch, rnn)

    phase("12. held classifier and NMT train steps, kernels vs scan")
    _held_text, text_runs, _amp_text, wide = text_training(torch, rnn)

    phase("14. sparse-row kernels (B9) vs plain version")
    ptxas_report(_build.build_log(sr.KERNEL))
    sparse_checks, sparse_times = sparse_kernels(torch, sr, tss)

    phase("15. standalone sparse update through SparseUpdater.run_steps")
    standalone = sparse_standalone(torch, sr, tsp, tss)

    phase("16. the wide&deep large-table train step")
    wide_deep = widedeep(torch, sr, tsp, tss)

    phase("17. the sharded embedding tier, 2^30 logical rows")
    tier = sharded_tier(torch, sr, tss)

    phase("18. the CTR models through SGD")
    ctr_models(torch)

    phase("19. result")
    served = results[0]
    train = bwd[0]
    print(f"flash_attn_fwd launches: serving {launches}, training "
          f"{train_fwd}", flush=True)

    def bwd_row(kernel, key):
        return {
            "name": f"flash_attn_bwd_{kernel}",
            "route": "cuda",
            "source": "paddle_tpu_torch/csrc/flash_attn_bwd.cu",
            "replaces": "paddle_tpu/parallel/ring.py:265",
            "launches": sum(r[f"launches_bwd_{kernel}"]
                            for r in runs.values()),
            "max_abs_err": max(r["max_abs_err"][n] for r in bwd
                               for n in key),
            "ms": train[f"{kernel}_ms"],
            # the kernel's own time from torch.profiler (ms, like every
            # row's, is CUDA events over calls through the wrapper)
            "device_ms": train[f"{kernel}_device_ms"],
            "plain_ms": train["plain_ms"],
            "bound_ms": train[f"{kernel}_bound_ms"],
            "bound_by": train[f"{kernel}_bound_by"],
            "library_ms": train["library_ms"],
        }

    # the bf16 forms' numbers at the long-context trainer's shape; their
    # launches are phase 6d's flash arms' (the main path under the flag)
    long_fwd = next(r for r in results_bf16
                    if r["name"] == LONGCTX_SHAPE["name"])
    long_bwd = next(r for r in bwd_bf16
                    if r["name"] == LONGCTX_SHAPE["name"])

    def bf16_launched(counter):
        return sum(r["flash"]["launches"][counter] for r in longctx_runs)

    def bwd_bf16_row(kernel, key):
        return {
            "name": f"flash_attn_bwd_{kernel}_bf16",
            "route": "cuda",
            "source": "paddle_tpu_torch/csrc/flash_attn_bwd.cu",
            "replaces": "paddle_tpu/parallel/ring.py:265",
            "launches": bf16_launched(f"bwd_{kernel}_bf16_launches"),
            "max_abs_err": max(r["max_abs_err"][n] for r in bwd_bf16
                               for n in key),
            "ms": long_bwd[f"{kernel}_ms"],
            "device_ms": long_bwd[f"{kernel}_device_ms"],
            "plain_ms": long_bwd["plain_ms"],
            "bound_ms": long_bwd[f"{kernel}_bound_ms"],
            "bound_by": long_bwd[f"{kernel}_bound_by"],
            "library_ms": long_bwd["library_ms"],
        }

    # the fused kernels' numbers at the res2 tail site at batch 64 (the
    # largest N of the training path)
    tail = next(t for t in fused_times if t["site"] == "res2_tail")

    # the bf16 forms' at the same site at batch 256 (bench_resnet50's)
    tail_bf16 = next(t for t in fused_times_bf16 if t["site"] == "res2_tail")

    def fused_row(kernel, tpu_line, launched, bf16=False):
        # the bf16 B1, B2 and B3 are the wgmma kernels (fwd_wgmma_kernel,
        # bwd_*_wgmma_kernel)
        return {
            "name": f"bn_act_conv1x1_{kernel}"
                    + ("_bf16_wgmma" if bf16 else ""),
            "route": "cuda",
            "source": "paddle_tpu_torch/csrc/bn_act_conv1x1.cu",
            "replaces": f"paddle_tpu/ops/pallas_fused.py:{tpu_line}",
            "launches": launched,
            "max_abs_err": (fused_err_bf16 if bf16 else fused_err)[kernel],
            **(tail_bf16 if bf16 else tail)[kernel],
        }

    # the sequence kernels' numbers at the path shapes (classifier layers,
    # NMT encoder); max_abs_err over every case of phase 10
    path = {"lstm": rnn_res["classifier_b64_t100_h256"],
            "gru": rnn_res["nmt_enc_b256_t32_h256"]}
    cls_launches = text_runs["classifier_kernels"]["launches"]
    nmt_launches = text_runs["nmt_kernels"]["launches"]

    # the grid route's numbers at bench_lstm's widest width (phase 10's
    # lstm_b64_t100_h1280), its launches phase 13c's kernel arms' (both
    # widths); max_abs_err over phase 10's LSTM cases on the grid route
    grid_at = rnn_res["lstm_b64_t100_h1280"]
    assert grid_at["fwd_plan"]["route"] == "grid", grid_at["fwd_plan"]
    assert grid_at["bwd_plan"]["route"] == "grid", grid_at["bwd_plan"]

    def wide_launched(counter, part="runs"):
        if part == "runs":
            return sum(w["runs"]["kernels"]["launches"][counter]
                       for w in wide.values())
        return sum(w["infer"]["launches"][counter] for w in wide.values())

    def grid_row(name, tpu_line, kind, launched):
        at = grid_at[kind]
        plan = "bwd_plan" if kind == "bwd" else "fwd_plan"
        return {
            "name": name,
            "route": "cuda",
            "source": "paddle_tpu_torch/csrc/lstm_seq.cu",
            "replaces": f"paddle_tpu/ops/pallas_rnn.py:{tpu_line}",
            "launches": launched,
            "max_abs_err": max(r[kind]["max_abs_err"]
                               for r in rnn_res.values()
                               if r["cell"] == "lstm"
                               and r[plan]["route"] == "grid"),
            "ms": at["ms"], "plain_ms": at["plain_ms"],
            "bound_ms": at["bound_ms"], "bound_by": at["bound_by"],
            # as the rnn rows': cuDNN's LSTM is another function
            "library_ms": None,
        }

    def rnn_row(name, cell, tpu_line, kind, launched):
        at = path[cell][kind]
        return {
            "name": name,
            "route": "cuda",
            "source": f"paddle_tpu_torch/csrc/{cell}_seq.cu",
            "replaces": f"paddle_tpu/ops/pallas_rnn.py:{tpu_line}",
            "launches": launched,
            "max_abs_err": max(r[kind]["max_abs_err"]
                               for r in rnn_res.values()
                               if r["cell"] == cell),
            "ms": at["ms"], "plain_ms": at["plain_ms"],
            "bound_ms": at["bound_ms"], "bound_by": at["bound_by"],
            # no single PyTorch call computes these functions (peepholes,
            # the reset before the candidate product, masked carry);
            # cuDNN's LSTM/GRU time is printed in phase 10 as a
            # reference point of another function
            "library_ms": None,
        }

    print(json.dumps({"kernels": [{
        "name": "flash_attn_fwd",
        "route": "cuda",
        "source": "paddle_tpu_torch/csrc/flash_attn_fwd.cu",
        "replaces": "paddle_tpu/parallel/ring.py:265",
        "launches": launches + train_fwd,
        "max_abs_err": max(max(r["err_out"], r["err_lse"])
                           for r in results),
        "ms": served["kernel_ms"],
        "plain_ms": served["plain_ms"],
        "bound_ms": served["bound_ms"],
        "bound_by": served["bound_by"],
        "library_ms": served["library_ms"],
    }, bwd_row("dkv", ("dk", "dv")), bwd_row("dq", ("dq",)), {
        "name": "flash_attn_fwd_bf16",
        "route": "cuda",
        "source": "paddle_tpu_torch/csrc/flash_attn_fwd.cu",
        "replaces": "paddle_tpu/parallel/ring.py:265",
        "launches": bf16_launched("bf16_launches"),
        "max_abs_err": max(r["max_abs_err"] for r in results_bf16),
        "ms": long_fwd["kernel_ms"],
        "plain_ms": long_fwd["plain_ms"],
        "bound_ms": long_fwd["bound_ms"],
        "bound_by": long_fwd["bound_by"],
        "library_ms": long_fwd["library_ms"],
    }, bwd_bf16_row("dkv", ("dk", "dv")), bwd_bf16_row("dq", ("dq",)),
        fused_row("fwd", 71, infer["b1_launches"] + train_b["launches_fwd"]),
        fused_row("bwd_dx", 155, train_b["launches_bwd_dx"]),
        fused_row("bwd_dw", 203, train_b["launches_bwd_dw"]),
        fused_row("fwd", 71, train_amp["launches_bf16"]["fwd_bf16_launches"],
                  bf16=True),
        fused_row("bwd_dx", 155,
                  train_amp["launches_bf16"]["bwd_dx_bf16_launches"],
                  bf16=True),
        fused_row("bwd_dw", 203,
                  train_amp["launches_bf16"]["bwd_dw_bf16_launches"],
                  bf16=True),
        rnn_row("lstm_seq_fwd", "lstm", 311, "fwd",
                cls_launches["lstm_fwd_launches"]),
        rnn_row("lstm_seq_fwd_infer", "lstm", 311, "fwd_infer",
                cls_infer["launches"]["lstm_fwd_infer_launches"]),
        rnn_row("lstm_seq_bwd", "lstm", 358, "bwd",
                cls_launches["lstm_bwd_launches"]),
        grid_row("lstm_seq_fwd_grid", 311, "fwd",
                 wide_launched("lstm_fwd_grid_launches")),
        grid_row("lstm_seq_fwd_infer_grid", 311, "fwd_infer",
                 wide_launched("lstm_fwd_infer_grid_launches", "infer")),
        grid_row("lstm_seq_bwd_grid", 358, "bwd",
                 wide_launched("lstm_bwd_grid_launches")),
        rnn_row("gru_seq_fwd", "gru", 724, "fwd",
                nmt_launches["gru_fwd_launches"]),
        rnn_row("gru_seq_bwd", "gru", 657, "bwd",
                nmt_launches["gru_bwd_launches"]),
        *sparse_kernel_rows(sparse_checks, sparse_times, standalone,
                            wide_deep, tier)]}),
        flush=True)
    print(smi, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
