"""Decoder-only Transformer LM: the math of `paddle_tpu/models/lm.py`.

The same pure functions over the same flat parameter dict (`_lm_emb.w0`,
`_lm_att{i}.wq`, ...), on torch tensors:

- `lm_forward(..., with_kv=True)` — full causal forward returning the
  per-layer K/V for the prefill to page out. With
  `spec.attn_impl == "flash"` the attention is the Hopper flash kernel
  on the card (`parallel/ring.py::flash_dense_attention`).
- `lm_decode_chunk` — n new tokens against a gathered cache context
  (slot s of the context is absolute position s).
- `beam_init_select` / `beam_step_select` — the beam expansion rule,
  shared by the paged and the full-recompute paths, so the tests
  between them compare only the logits' source (cache or recompute).
  Equal scores order by the lower flat index, as `lax.top_k` does
  (`beam_search._top_k_stable`).
- `greedy_decode_recompute` / `beam_decode_recompute` — the
  full-recompute references: every new token re-runs the whole prefix
  through `lm_forward`.
- `lm_prefix_recompute_bytes_saved` — the bytes a recompute decode
  would have streamed for the prefix tokens the page pool served.
- `transformer_lm` — the train conf, through the port's copy of the
  DSL: the same ModelConf the JAX package builds, run by the port's
  `Network` and `trainer.SGD`.

All of it is f32. The projections are plain `torch.matmul`, as the JAX
package left them to XLA; TF32 is off on the card (core/device.py).
`lm_init_params` draws through `Network(transformer_lm(spec))`, so the
functional paths and the trainer share one flat parameter dict:
weights normal with std 1/sqrt(fan_in), biases zero.
"""

from __future__ import annotations

import dataclasses
import math

import numpy as np
import torch

from paddle_tpu_torch import dsl
from paddle_tpu_torch.beam_search import _top_k_stable
from paddle_tpu_torch.core.config import ModelConf
from paddle_tpu_torch.network import Network
from paddle_tpu_torch.parallel import ring


@dataclasses.dataclass(frozen=True)
class LMSpec:
    """Static LM architecture. attn_impl applies to the FULL-sequence
    paths (prefill / recompute reference); the per-token decode step
    always attends densely over the gathered page context."""

    vocab: int = 2048
    d_model: int = 128
    num_heads: int = 4
    num_layers: int = 2
    attn_impl: str = "dense"

    @property
    def head_dim(self) -> int:
        assert self.d_model % self.num_heads == 0
        return self.d_model // self.num_heads


def lm_param_shapes(spec: LMSpec) -> dict:
    """{global param name: shape} of the LM, in the JAX package's
    naming."""
    d, v = spec.d_model, spec.vocab
    shapes = {"_lm_emb.w0": (v, d)}
    for i in range(spec.num_layers):
        for w in ("wq", "wk", "wv", "wo"):
            shapes[f"_lm_att{i}.{w}"] = (d, d)
        shapes[f"_lm_att{i}.wbias"] = (d,)
        shapes[f"_lm_ff{i}.w0"] = (d, d)
        shapes[f"_lm_ff{i}.wbias"] = (d,)
    shapes["_lm_head.w0"] = (d, v)
    shapes["_lm_head.wbias"] = (v,)
    return shapes


def transformer_lm(spec: LMSpec) -> ModelConf:
    """Trainer config from the DSL layer inventory. Teacher forcing:
    `ids` is the BOS-prefixed input, `label` the next-token target; the
    causal mask keeps position t blind to t+1 exactly like the
    generation programs."""
    d, h = spec.d_model, spec.num_heads
    with dsl.model() as g:
        ids = dsl.data("ids", dim=(), is_ids=True, is_seq=True)
        lbl = dsl.data("label", dim=(), is_ids=True, is_seq=True)
        x = dsl.embedding(ids, size=d, vocab_size=spec.vocab,
                          name="lm_emb")
        for i in range(spec.num_layers):
            att = dsl._add(
                "multi_head_attention", [x], size=d, num_heads=h,
                causal=True, attn_impl=spec.attn_impl,
                name=f"lm_att{i}",
            )
            x = dsl.addto(att, dsl.fc(att, size=d, act="relu",
                                      name=f"lm_ff{i}"),
                          name=f"lm_blk{i}")
        out = dsl.fc(x, size=spec.vocab, act="", name="lm_head")
        dsl.classification_cost(out, lbl, name="lm_cost")
        g.conf.output_layer_names.append("lm_head")
    return g.conf


def lm_init_params(spec: LMSpec, generator: torch.Generator = None,
                   device=None) -> dict:
    """Random f32 params through the DSL graph's own initializer
    (sorted names from one generator): 2-D weights ~ N(0, 1/fan_in),
    1-D zeros."""
    gen = generator if generator is not None else torch.Generator()
    return Network(transformer_lm(spec)).init_params(gen, device)


# ---- functional forward (same params, same math) -------------------

def _heads(spec: LMSpec, x):
    return x.reshape(x.shape[0], x.shape[1], spec.num_heads,
                     spec.head_dim)


def _block_tail(spec: LMSpec, params, i: int, att):
    """Post-attention half of block i: wo projection + bias, then the
    addto(att, relu-fc(att)) residual."""
    att = att.reshape(att.shape[0], att.shape[1], spec.d_model)
    att = torch.matmul(att, params[f"_lm_att{i}.wo"])
    att = att + params[f"_lm_att{i}.wbias"]
    ff = torch.matmul(att, params[f"_lm_ff{i}.w0"])
    ff = torch.relu(ff + params[f"_lm_ff{i}.wbias"])
    return att + ff


def _head_logits(params, x):
    return torch.matmul(x, params["_lm_head.w0"]) + params["_lm_head.wbias"]


def lm_forward(spec: LMSpec, params: dict, ids, lens=None,
               with_kv: bool = False):
    """Full causal forward: ids [B, T] int -> logits [B, T, vocab].
    with_kv=True additionally returns the per-layer K/V stacks
    [L, B, T, H, hd] — what the prefill pages out."""
    x = params["_lm_emb.w0"][ids.long()]
    if lens is not None:
        pos = torch.arange(ids.shape[1], device=ids.device)[None, :]
        x = torch.where((pos < lens[:, None])[..., None], x, 0.0)
    ks, vs = [], []
    for i in range(spec.num_layers):
        q = _heads(spec, torch.matmul(x, params[f"_lm_att{i}.wq"]))
        k = _heads(spec, torch.matmul(x, params[f"_lm_att{i}.wk"]))
        v = _heads(spec, torch.matmul(x, params[f"_lm_att{i}.wv"]))
        if with_kv:
            ks.append(k)
            vs.append(v)
        if spec.attn_impl == "flash":
            att = ring.flash_dense_attention(q, k, v, causal=True,
                                             kv_len=lens)
        else:
            att = ring.dense_attention(q, k, v, causal=True, kv_len=lens)
        x = _block_tail(spec, params, i, att)
    logits = _head_logits(params, x)
    if with_kv:
        return logits, torch.stack(ks), torch.stack(vs)
    return logits


def chunk_attention(q, ctx_k, ctx_v, start):
    """Attention for a chunk of n NEW tokens at absolute positions
    start[b]..start[b]+n-1 over a gathered cache context whose slot s
    is absolute position s (the chunk's own K/V already scattered in).
    q [B, n, H, hd], ctx [B, S, H, hd], start [B]. Query j may see
    slots s <= start[b] + j; everything else is masked to NEG_INF —
    ring.dense_attention's conventions, so the paged path is
    token-identical to the full recompute."""
    hd = q.shape[-1]
    scale = 1.0 / math.sqrt(hd)
    s = torch.einsum("bqhd,bkhd->bhqk", q, ctx_k) * scale
    qpos = (start.to(q.device).long()[:, None]
            + torch.arange(q.shape[1], device=q.device)[None, :])
    kpos = torch.arange(ctx_k.shape[1], device=q.device)
    bad = kpos[None, None, :] > qpos[:, :, None]  # [B, n, S]
    s = s + torch.where(bad[:, None, :, :], ring.NEG_INF, 0.0)
    p = torch.softmax(s, dim=-1)
    return torch.einsum("bhqk,bkhd->bqhd", p, ctx_v)


def lm_decode_chunk(spec: LMSpec, params: dict, toks, start,
                    ctx_k, ctx_v):
    """Forward n new tokens against a gathered cache context. toks
    [B, n] int, start [B] (absolute position of toks[:, 0]), ctx
    [L, B, S, H, hd] gathered from the page pool BEFORE this chunk's
    writes. Returns (logits [B, n, vocab], new_k [L, B, n, H, hd],
    new_v) — the caller writes new_k/new_v into the pool at the same
    slots.

    ctx_k and ctx_v are written IN PLACE (the chunk's K/V at slots
    start..start+n-1), where the JAX function builds a new array: the
    decode step's context is already a private copy (advanced
    indexing gathered it from the pool), so writing it costs nothing
    and touches nobody else's memory."""
    b, n = toks.shape
    x = params["_lm_emb.w0"][toks.long()]
    start = start.to(x.device).long()
    idx = start[:, None] + torch.arange(n, device=x.device)[None, :]
    rows = torch.arange(b, device=x.device)[:, None]
    new_ks, new_vs = [], []
    for i in range(spec.num_layers):
        q = _heads(spec, torch.matmul(x, params[f"_lm_att{i}.wq"]))
        kn = _heads(spec, torch.matmul(x, params[f"_lm_att{i}.wk"]))
        vn = _heads(spec, torch.matmul(x, params[f"_lm_att{i}.wv"]))
        new_ks.append(kn)
        new_vs.append(vn)
        ctx_k[i][rows, idx] = kn
        ctx_v[i][rows, idx] = vn
        att = chunk_attention(q, ctx_k[i], ctx_v[i], start)
        x = _block_tail(spec, params, i, att)
    logits = _head_logits(params, x)
    return logits, torch.stack(new_ks), torch.stack(new_vs)


def lm_logp(logits):
    """f32 log-softmax — score math stays f32."""
    return torch.log_softmax(logits.float(), dim=-1)


# ---- beam expansion rule (shared by paged + recompute paths) -------

def beam_init_select(logp0, k: int):
    """First expansion from the prompt's next-token distribution:
    logp0 [B, vocab] -> (scores [B, k], tokens [B, k] int32)."""
    scores, tokens = _top_k_stable(logp0, k)
    return scores, tokens.to(torch.int32)


def beam_step_select(scores, logp, finished, eos_id: int):
    """One beam expansion: scores [B, K] f32, logp [B, K, vocab] f32,
    finished [B, K] bool -> (scores, parent, token, finished), each
    [B, K]. A finished beam contributes exactly one candidate — eos at
    its frozen score — so it survives top-k without growing."""
    b, k, v = logp.shape
    live = scores[..., None] + logp
    eos = torch.arange(v, device=logp.device) == eos_id
    fin = torch.where(eos, scores[..., None],
                      torch.full_like(logp, ring.NEG_INF))
    cand = torch.where(finished[..., None], fin, live)
    top, idx = _top_k_stable(cand.reshape(b, k * v), k)
    parent = (idx // v).to(torch.int32)
    token = (idx % v).to(torch.int32)
    was_fin = torch.gather(finished, 1, parent.long())
    return top, parent, token, was_fin | (token == eos_id)


# ---- full-recompute references (what the pins compare against) ------

def _last_logp(spec, params, buf, lens):
    logits = lm_forward(spec, params, buf, lens=lens)
    last = logits[torch.arange(buf.shape[0], device=buf.device),
                  lens.long() - 1]
    return lm_logp(last)


@torch.no_grad()
def greedy_decode_recompute(spec: LMSpec, params: dict, ids, lens,
                            max_new: int, eos_id: int):
    """Every new token re-runs the FULL prefix through lm_forward, on
    the params' device. ids [B, T0] int (padded, numpy or tensor),
    lens [B]. Returns (tokens [B, max_new] int32, scores [B] f32) as
    numpy — the token-for-token reference for the paged path."""
    dev = next(iter(params.values())).device
    ids = np.asarray(ids.cpu() if torch.is_tensor(ids) else ids)
    b, t0 = ids.shape
    buf = np.zeros((b, t0 + max_new), np.int32)
    buf[:, :t0] = ids
    lens = np.asarray(lens).astype(np.int32).copy()
    out = np.zeros((b, max_new), np.int32)
    scores = np.zeros((b,), np.float32)
    finished = np.zeros((b,), bool)
    for t in range(max_new):
        logp = _last_logp(
            spec, params, torch.as_tensor(buf, device=dev),
            torch.as_tensor(lens, device=dev),
        ).cpu().numpy()
        tok = logp.argmax(axis=-1).astype(np.int32)
        tok = np.where(finished, eos_id, tok)
        scores = np.where(
            finished, scores, scores + logp[np.arange(b), tok],
        ).astype(np.float32)
        out[:, t] = tok
        buf[np.arange(b), lens] = tok
        lens += 1
        finished |= tok == eos_id
    return out, scores


@torch.no_grad()
def beam_decode_recompute(spec: LMSpec, params: dict, ids, lens,
                          beam_k: int, max_new: int, eos_id: int):
    """Full-recompute beam search under the shared expansion rule, on
    the params' device. Returns (tokens [B, K, max_new] int32, scores
    [B, K] f32) as numpy."""
    dev = next(iter(params.values())).device
    ids_np = np.asarray(ids.cpu() if torch.is_tensor(ids) else ids)
    b, t0 = ids_np.shape
    k = beam_k
    lens_np = np.asarray(lens).astype(np.int32)

    def last_logp(buf, ln):
        return _last_logp(spec, params, torch.as_tensor(buf, device=dev),
                          torch.as_tensor(ln, device=dev))

    sc, tok = beam_init_select(last_logp(ids_np, lens_np), k)
    scores = sc
    hist = np.zeros((b, k, max_new), np.int32)
    hist[:, :, 0] = tok.cpu().numpy()
    finished = torch.as_tensor(hist[:, :, 0] == eos_id, device=dev)

    buf = np.zeros((b, k, t0 + max_new), np.int32)
    buf[:, :, :t0] = ids_np[:, None, :]
    rows = np.arange(b)[:, None], np.arange(k)[None, :]
    buf[rows[0], rows[1], lens_np[:, None]] = hist[:, :, 0]
    blens = np.broadcast_to(lens_np[:, None] + 1, (b, k)).copy()
    gi = np.arange(b)[:, None]
    for t in range(1, max_new):
        logp = last_logp(buf.reshape(b * k, -1),
                         blens.reshape(b * k)).reshape(b, k, -1)
        scores, parent, tok, finished = beam_step_select(
            scores, logp, finished, eos_id)
        parent_np = parent.cpu().numpy()
        tok_np = tok.cpu().numpy()
        hist = hist[gi, parent_np]
        buf = buf[gi, parent_np]
        blens = blens[gi, parent_np]
        hist[:, :, t] = tok_np
        buf[rows[0], rows[1], blens] = tok_np
        blens += 1
    return hist, scores.cpu().numpy().astype(np.float32)


# ---- analytic accounting -------------------------------------------

def lm_prefix_token_recompute_bytes(spec: LMSpec,
                                    dtype_bytes: int = 4) -> int:
    """Device-memory bytes a full-recompute decode streams PER PREFIX
    TOKEN per step that the paged cache avoids: re-embedding plus the
    per-layer activation round trips (x in, q/k/v/att/ff out-and-in)
    of pushing one already-seen token back through every block.
    Weight streaming is excluded — both paths read the weights once
    per step, so it cancels in the saved-bytes accounting."""
    d, l = spec.d_model, spec.num_layers
    per_layer = 8 * d * dtype_bytes      # x,q,k,v,att,wo-out,ff,res
    return d * dtype_bytes + l * per_layer


def lm_prefix_recompute_bytes_saved(spec: LMSpec,
                                    cached_prefix_tokens: int,
                                    dtype_bytes: int = 4) -> int:
    """Turn the cache's MEASURED counter (sum over decode steps of the
    prefix tokens served from the page pool) into the bytes a recompute
    decode would have streamed for those same tokens."""
    return int(cached_prefix_tokens) * lm_prefix_token_recompute_bytes(
        spec, dtype_bytes)


def lm_train_flops_per_batch(spec: LMSpec, bs: int, t: int) -> int:
    """Model FLOPs per optimizer step (2/MAC, train ~ 3x fwd): per layer
    the QKVO projections + the [T,T] score/value matmuls (full square)
    + the d->d relu fc, plus the vocab head."""
    d, l = spec.d_model, spec.num_layers
    per_layer = (
        4 * 2 * bs * t * d * d          # wq/wk/wv/wo
        + 2 * 2 * bs * t * t * d        # QK^T and attn@V
        + 2 * bs * t * d * d            # residual fc
    )
    head = 2 * bs * t * d * spec.vocab
    return 3 * (l * per_layer + head)


def lm_param_bytes(spec: LMSpec, dtype_bytes: int = 4) -> int:
    d, l, v = spec.d_model, spec.num_layers, spec.vocab
    n = v * d                            # embedding
    n += l * (4 * d * d + d)             # attention (+ bias)
    n += l * (d * d + d)                 # residual fc
    n += d * v + v                       # head
    return n * dtype_bytes
