#!/usr/bin/env python3
"""Chip smoke of the PyTorch/CUDA port (`paddle_tpu_torch`).

    python3 chip_smoke.py

Needs one CUDA card (an H100: the kernels are built for sm_90a) and the
CUDA toolkit's nvcc. It drives the port only — nothing of JAX or of
`paddle_tpu` — in seven phases, and any failure exits non-zero:

1. the card (`nvidia-smi` name and power limit), torch and CUDA
   versions; TF32 off;
2. builds every kernel from `paddle_tpu_torch/csrc` (one nvcc per
   source, in parallel) and prints the build seconds and ptxas report;
3. holds the flash-attention kernel against its plain PyTorch version
   on the card at eight shapes, four of them the prefill shapes of
   phase 4 (max |diff| <= 1e-4 on out and on the lse
   of rows with a visible key: f32 with another summation order; rows
   with no visible key exactly out == 0 and lse == 1e30), and times
   kernel, plain version and `scaled_dot_product_attention` (a
   yardstick only — the port never calls it);
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
   phase 6 (B=32, T=128 full; B=8, T=1024 ragged) and three more (D=32
   with odd T, D=128 cross-attention with q_len, a kv_len=0 row):
   max |diff| / max |plain| <= 1e-4 for dq, dk and dv, dq of rows with
   no visible key exactly 0, every value finite; times the kernels, the
   plain version and the backward of `scaled_dot_product_attention` (a
   yardstick only: forward+backward minus forward);
6. trains the Transformer LM at the same width through the port's
   trainer (`SGD.train`, attn_impl="flash", weights from a numpy
   seed): first one train step (`TrainStep`) of the flash conf
   against the same step of the dense conf at B=32, T=128 (loss and
   every gradient within 1e-4 relative; also reported at B=8, T=1024,
   where a ReLU gate at a preactivation within rounding of 0 may flip
   between the two, and the gradients are then held only when no gate
   flipped), then (a) 20 steps of momentum SGD (lr 0.001, mu 0.9) at
   B=32, T=128 and (b) 300 steps of adam (lr 0.001) on one fixed batch
   at B=8, T=1024 with ragged lengths (next-token batches from a fixed
   random walk over the vocabulary); every loss finite, (b) falls to
   at most half its first value, and each flash kernel launched once
   per layer per step;
7. prints the kernels' JSON line and, last, the device line.

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
H100_F32_FLOPS = 67e12
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


def phase(name):
    print(f"== {name}", flush=True)


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
    out_p, lse_p = fa.attention_plain(q, k, v, **kw)
    torch.cuda.synchronize()
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
    t_ops = flops / H100_F32_FLOPS * 1e3
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
    ref = fa.attention_bwd_plain(q, k, v, out, lse, do, **kw)
    torch.cuda.synchronize()
    errs = {n: rel_err(g, r) for n, g, r in zip(("dq", "dk", "dv"), got,
                                                 ref)}
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
    dkv_ms = time_ms(torch, lambda: fa.flash_attention_bwd_dkv(
        q, k, v, do, lse, delta, **kw))
    dq_ms = time_ms(torch, lambda: fa.flash_attention_bwd_dq(
        q, k, v, do, lse, delta, **kw))
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
    f32 = 4
    qo = B * Tq * H * D * f32          # one [B, Tq, H, D] tensor
    kv = B * Tk * H * D * f32          # one [B, Tk, H, D] tensor
    rows = B * H * Tq * f32            # lse or delta
    lens = f32 * B * ((kv_len is not None) + (q_len is not None))

    def bound(flops_per_pair, nbytes):
        t_ops = flops_per_pair * D * H * pairs / H100_F32_FLOPS * 1e3
        t_bytes = nbytes / H100_BYTES_PER_S * 1e3
        return max(t_ops, t_bytes), ("bytes" if t_bytes >= t_ops
                                     else "operations")

    # the whole backward: recomputed QK^T, dV, dP, dQ, dK (2 flops per
    # MAC each); q, k, v, out, dO and lse read, dq, dk, dv written
    bwd_bound = bound(10, 4 * qo + 4 * kv + rows + lens)
    # dkv: QK^T, dP, dV, dK; q, k, v, dO, lse, delta read, dk, dv written
    dkv_bound = bound(8, 2 * qo + 2 * kv + 2 * rows + 2 * kv + lens)
    # dq: QK^T, dP, dQ; q, k, v, dO, lse, delta read, dq written
    dq_bound = bound(6, 2 * qo + 2 * kv + 2 * rows + qo + lens)
    res = {
        "name": case["name"], "masked_rows": n_dead,
        "rel_err": {n: e[0] for n, e in errs.items()},
        "max_abs_err": {n: e[1] for n, e in errs.items()},
        "dkv_ms": dkv_ms, "dq_ms": dq_ms, "bwd_ms": bwd_ms,
        "fwd_ms": fwd_ms, "plain_ms": plain_ms, "library_ms": library_ms,
        "bound_ms": bwd_bound[0], "bound_by": bwd_bound[1],
        "dkv_bound_ms": dkv_bound[0], "dkv_bound_by": dkv_bound[1],
        "dq_bound_ms": dq_bound[0], "dq_bound_by": dq_bound[1],
        "pairs_per_head": pairs,
    }
    print(json.dumps(res), flush=True)
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


def profile_steps(torch, sgd, feed, steps=5):
    """Where a train step's time goes: `steps` steps under
    torch.profiler, after the counted run (these launches are not the
    main path's). Returns the device's kernel ms per step and the eight
    kernels with the most device time; None when the profiler sees no
    device time."""
    from torch.profiler import ProfilerActivity, profile

    sgd.train_batch(feed)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(steps):
            sgd.train_batch(feed)
        torch.cuda.synchronize()
    cuda = torch.autograd.DeviceType.CUDA
    kernels = [e for e in prof.key_averages()
               if e.device_type == cuda and e.self_device_time_total > 0]
    if not kernels:
        return None
    busy_us = sum(e.self_device_time_total for e in kernels)
    top = sorted(kernels, key=lambda e: -e.self_device_time_total)[:8]
    return {
        "device_ms_per_step": busy_us / steps / 1e3,
        "kernels_per_step": sum(e.count for e in kernels) / steps,
        "top": [{"name": e.key[:60], "ms_per_step":
                 e.self_device_time_total / steps / 1e3,
                 "calls_per_step": e.count / steps} for e in top],
    }


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
    parity = {}
    for name, batch in (("b32_t128", batches_a[0]), ("b8_t1024", batch_b)):
        feed = lm_feed(batch)
        got = {}
        for impl in ("flash", "dense"):
            net = Network(lm.transformer_lm(dataclasses.replace(
                spec, attn_impl=impl)))
            opt = create_optimizer(opt_a, net.param_confs)
            step = TrainStep(net, opt, watchdog=True, device="cuda")
            params = params_from_numpy(np_params, device="cuda")
            _p, mom, _s, health, _o = step(params, opt.init_state(params),
                                           {}, feed, 0, None)
            with torch.no_grad():
                gates = [net.forward(params, feed)[0][f"lm_ff{i}"].value > 0
                         for i in range(spec.num_layers)]
            got[impl] = (health, mom, gates)
        (hf, mf, gf), (hd, md, gd) = got["flash"], got["dense"]
        loss_rel = abs(hf[0].item() - hd[0].item()) / abs(hd[0].item())
        worst = max((rel_err(mf[k]["mom"], md[k]["mom"])[0], k) for k in md)
        # a ReLU whose preactivation lies within f32 rounding of 0 can
        # open in one step and not the other; every gradient below it
        # then differs by that token's share
        flips = sum(int((a != b).sum().item()) for a, b in zip(gf, gd))
        parity[name] = {"loss_flash": hf[0].item(), "loss_dense": hd[0].item(),
                        "loss_rel": loss_rel, "grad_rel": worst[0],
                        "worst_param": worst[1], "relu_gate_flips": flips,
                        "finite": bool(hf[1].item() and hd[1].item())}
        print("flash vs dense train step " + json.dumps(
            {name: parity[name]}), flush=True)
        assert parity[name]["finite"] and loss_rel <= TOL, (
            f"flash and dense train steps disagree at {name}: "
            f"{parity[name]}")
        if flips == 0:
            assert worst[0] <= TOL, (
                f"flash and dense gradients disagree at {name}: "
                f"{parity[name]}")
    assert parity["b32_t128"]["relu_gate_flips"] == 0, (
        "the held train step needs a feed whose ReLU gates agree")

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


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device available", file=sys.stderr)
        return 2
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    from paddle_tpu_torch.core.device import resolve_device
    from paddle_tpu_torch.ops import _build
    from paddle_tpu_torch.ops import flash_attention as fa

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
    ]
    results = [check_kernel(torch, fa, c, gen) for c in cases]

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
    ]
    bwd = [check_backward(torch, fa, c, gen) for c in bwd_cases]

    phase("6. train the LM through SGD")
    _parity, runs = train_lm(torch, fa)
    train_fwd = sum(r["launches_fwd"] for r in runs.values())

    phase("7. result")
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
            "plain_ms": train["plain_ms"],
            "bound_ms": train[f"{kernel}_bound_ms"],
            "bound_by": train[f"{kernel}_bound_by"],
            "library_ms": train["library_ms"],
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
    }, bwd_row("dkv", ("dk", "dv")), bwd_row("dq", ("dq",))]}),
        flush=True)
    print(smi, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
