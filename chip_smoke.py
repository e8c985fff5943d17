#!/usr/bin/env python3
"""Chip smoke of the PyTorch/CUDA port (`paddle_tpu_torch`).

    python3 chip_smoke.py

Needs one CUDA card (an H100: the kernels are built for sm_90a) and the
CUDA toolkit's nvcc. It drives the port only — nothing of JAX or of
`paddle_tpu` — in five phases, and any failure exits non-zero:

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
5. prints the kernels' JSON line and, last, the device line.

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


def check_kernel(torch, fa, case, gen):
    """Kernel vs plain version on the card at one shape; returns the
    case's numbers."""
    B, Tq, Tk, H, D = (case[k] for k in ("B", "Tq", "Tk", "H", "D"))
    dev = torch.device("cuda")
    q = torch.randn((B, Tq, H, D), generator=gen, device=dev)
    k = torch.randn((B, Tk, H, D), generator=gen, device=dev)
    v = torch.randn((B, Tk, H, D), generator=gen, device=dev)

    def lens(name):
        x = case.get(name)
        return None if x is None else torch.tensor(
            x, dtype=torch.int32, device=dev)

    kv_len, q_len = lens("kv_len"), lens("q_len")
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
    # layout made beforehand; True in the mask = may attend
    qt, kt, vt = (x.transpose(1, 2).contiguous() for x in (q, k, v))
    qpos = torch.arange(Tq, device=dev)[:, None]
    kpos = torch.arange(Tk, device=dev)[None, :]
    mask = torch.ones((B, 1, Tq, Tk), dtype=torch.bool, device=dev)
    if kv_len is not None:
        mask &= kpos < kv_len.view(B, 1, 1, 1)
    if q_len is not None:
        mask &= qpos < q_len.view(B, 1, 1, 1)
    if case["causal"]:
        mask &= kpos <= qpos
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

    phase("5. result")
    served = results[0]
    print(json.dumps({"kernels": [{
        "name": "flash_attn_fwd",
        "route": "cuda",
        "source": "paddle_tpu_torch/csrc/flash_attn_fwd.cu",
        "replaces": "paddle_tpu/parallel/ring.py:265",
        "launches": launches,
        "max_abs_err": max(max(r["err_out"], r["err_lse"])
                           for r in results),
        "ms": served["kernel_ms"],
        "plain_ms": served["plain_ms"],
        "bound_ms": served["bound_ms"],
        "bound_by": served["bound_by"],
        "library_ms": served["library_ms"],
    }]}), flush=True)
    print(smi, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
