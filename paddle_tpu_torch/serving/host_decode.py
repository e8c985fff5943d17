"""Host-stepped beam decode, the serving rung for hooks:
`paddle_tpu/serving/host_decode.py` on torch.

The step net runs on the device, one forward a token; the beam
expansion, the hook calls and the bookkeeping run in numpy on the host
between steps. The semantics are the decoder's own (finished-beam eos
extension, parent-conditioned memory carry, drop truncation with
NEG_INF, the stop short-circuit, ties broken toward the lower flat
index), so the two rungs are interchangeable and differ in dispatch
cost only. The log of the probabilities is taken in numpy here and in
torch on the device rung: the two may differ by an ulp, so near a tie
a token may differ (the serving rule: tokens equal unless the
reference's top-2 margin at the first differing step is below 1e-4).

Chunked dispatch: with `tokens_per_dispatch` K > 1 and no host
callbacks (adjust/drop/stop all None; a `logprob_fn` is a device
function and fine), the rung dispatches one chunk of K guarded
substeps at a time, the decoder's own unit (`BeamSearchDecoder.
_chunk_program`; a CUDA graph on the card), and brings only the
chunk's (word, parent) trace and the `live` flag to the host. Per-token
`decode.token` spans become per-chunk `decode.chunk` spans with a
`tokens` label. Both paths record their dispatch count on
`dec.last_chain_depth`, and on `dec.last_timeline` the host's time
blocked on the device's results (`device_s`: the probabilities' or the
`live` flag's fetch) against the rest (`dispatch_s`: launches and the
host's bookkeeping).

Ported whole (ROADMAP A3a).
"""

from __future__ import annotations

import time

import numpy as np
import torch

from paddle_tpu_torch.beam_search import NEG_INF, BeamHooks
from paddle_tpu_torch.core.arg import Arg
from paddle_tpu_torch.obs import tracing as _tracing


def _step_fn(dec, b):
    """The step net's forward for batch b on the parameters' device:
    (params, static_feed, mems {layer: [B*K, size]}, words [B, K]) ->
    (prob [B*K, V], new mems), numpy or tensors in, tensors out."""
    net, k = dec._net, dec.k

    def step(params, static_feed, mems, words):
        dev = next(iter(params.values())).device
        feed = dict(static_feed)
        feed["@word"] = Arg(ids=torch.as_tensor(words).to(
            device=dev, dtype=torch.int64).reshape(b * k))
        for m in dec.memories:
            feed[m["link"]] = Arg(value=torch.as_tensor(
                mems[m["layer"]]).to(dev))
        with torch.no_grad():
            outs, _ = net.forward(params, feed, train=False)
        return (outs[dec.out_name].value,
                {m["layer"]: outs[m["layer"]].value for m in dec.memories})

    return step


def _np(x) -> np.ndarray:
    return x.detach().cpu().numpy() if torch.is_tensor(x) else np.asarray(x)


def _top_k_stable(flat: np.ndarray, k: int):
    """Row-wise top-k, ties broken toward the LOWER index — the
    `lax.top_k` contract the device rung keeps too. The JAX rung
    argsorts whole rows; this one sorts only each row's entries at or
    above its k-th largest value (`np.partition`), the same order at a
    fraction of the cost over [B, K*V] candidates."""
    n = flat.shape[1]
    kth = np.partition(flat, n - k, axis=1)[:, n - k]
    order = np.empty((flat.shape[0], k), np.int64)
    for r in range(flat.shape[0]):
        idx = np.flatnonzero(flat[r] >= kth[r])
        order[r] = idx[np.argsort(-flat[r, idx], kind="stable")[:k]]
    return np.take_along_axis(flat, order, axis=1), order


def _lengths(seqs: np.ndarray, eos: int, t_max: int) -> np.ndarray:
    is_eos = seqs == eos
    return np.where(np.any(is_eos, axis=-1),
                    np.argmax(is_eos, axis=-1) + 1, t_max).astype(np.int32)


def _chunked_generate(dec, params, static_feed, mems, b, n_chunk):
    """Hook-free chunked host decode: one chunk of guarded substeps a
    dispatch, the beam bookkeeping inside it; only the chunk's
    (word, parent) trace and the `live` flag come to the host, which
    replays the parent reorder on its copy of the sequences. Substeps
    past all-finished leave (eos, identity) in the trace, which replays
    as a no-op."""
    k, t_max, eos = dec.k, dec.max_length, dec.eos_id
    prog = dec._chunk_program(n_chunk)
    seqs = np.full((b, k, t_max), eos, np.int32)
    rows = np.arange(b)[:, None]
    traced = _tracing.current() is not None
    wait, start = 0.0, time.perf_counter()

    def run_chunk(st):
        nonlocal wait
        st, live = prog.chunk(params, static_feed, st, b)
        t1 = time.perf_counter()
        live = bool(live)
        wait += time.perf_counter() - t1
        return st, live

    with torch.no_grad():
        st = prog.begin(params, static_feed, mems, b)
        t0 = dispatches = 0
        while t0 < t_max:
            n = min(n_chunk, t_max - t0)  # ragged tail: a shorter chunk
            if traced:
                with _tracing.span("decode.chunk", t=t0, tokens=n,
                                   batch=b):
                    st, live = run_chunk(st)
            else:
                st, live = run_chunk(st)
            dispatches += 1
            ws, ps = _np(st["ws"][t0:t0 + n]), _np(st["ps"][t0:t0 + n])
            for j in range(n):
                seqs = seqs[rows, ps[j]]  # reorder history by parent
                seqs[:, :, t0 + j] = ws[j]
            t0 += n
            if not live:
                break
        scores = _np(st["scores"]).copy()
    dec.last_chain_depth = dispatches
    dec.last_steps = t0
    dec.last_timeline = {"dispatch_s": time.perf_counter() - start - wait,
                         "device_s": wait}
    return seqs, _lengths(seqs, eos, t_max), scores


def host_generate(dec, params, statics=None, boots=None, batch_size=None,
                  hooks: BeamHooks = None, tokens_per_dispatch=None):
    """Decode with the inputs and outputs of `dec.generate`, stepping
    the loop from the host so that `hooks` run as plain Python. Returns
    numpy (seqs [B, K, max_length] int32, lens [B, K] int32, scores
    [B, K] f32), beams sorted best-first; unwritten steps hold eos.

    `tokens_per_dispatch` (default: the decoder's own) takes the
    chunked path when > 1 and no host callbacks are given."""
    statics = statics or []
    hooks = hooks if hooks is not None else dec.hooks
    dev = next(iter(params.values())).device
    static_feed, mems, b = dec.prepare(statics, boots, batch_size,
                                       device=dev)
    k, t_max, eos = dec.k, dec.max_length, dec.eos_id
    n_chunk = (tokens_per_dispatch if tokens_per_dispatch is not None
               else dec.tokens_per_dispatch)
    if n_chunk > 1 and not hooks.any:
        return _chunked_generate(dec, params, static_feed, mems, b,
                                 min(n_chunk, t_max))

    step = _step_fn(dec, b)
    words = np.full((b, k), dec.bos_id, np.int32)
    scores = np.full((b, k), NEG_INF, np.float32)
    scores[:, 0] = 0.0
    finished = np.zeros((b, k), bool)
    seqs = np.full((b, k, t_max), eos, np.int32)
    rows = np.arange(b)[:, None]
    # one span a token when a trace context is attached (the serving
    # scheduler attaches its dispatch span around this call)
    traced = _tracing.current() is not None

    wait, start = 0.0, time.perf_counter()

    def run_step():
        nonlocal wait
        prob, new_mems = step(params, static_feed, mems, words)
        t1 = time.perf_counter()
        prob = _np(prob)
        wait += time.perf_counter() - t1
        return prob, new_mems

    dispatches = 0
    for t in range(t_max):
        if traced:
            with _tracing.span("decode.token", t=t, batch=b):
                prob, new_mems = run_step()
        else:
            prob, new_mems = run_step()
        dispatches += 1
        v = prob.shape[-1]
        logp = np.log(np.maximum(prob, 1e-20)).reshape(b, k, v).astype(
            np.float32)
        if dec.logprob_fn is not None:
            logp = _np(dec.logprob_fn(torch.from_numpy(logp),
                                      torch.tensor(t))).astype(np.float32)
        if hooks.adjust is not None:
            logp = np.asarray(hooks.adjust(logp, t), np.float32)
        # finished beams only extend with eos, at no cost
        fin_row = np.full((v,), NEG_INF, np.float32)
        fin_row[eos] = 0.0
        logp = np.where(finished[..., None], fin_row[None, None, :], logp)
        cand = scores[..., None] + logp
        top_scores, top_idx = _top_k_stable(cand.reshape(b, k * v), k)
        parent = top_idx // v
        word = (top_idx % v).astype(np.int32)
        was_fin = finished[rows, parent]
        # parent-conditioned memory carry: a finished parent's state
        # rides through unchanged
        sel_mems = {}
        for m in dec.memories:
            name = m["layer"]
            new = _np(new_mems[name]).reshape(b, k, -1)
            prev = _np(mems[name]).reshape(b, k, -1)
            sel = np.where(was_fin[..., None], prev[rows, parent],
                           new[rows, parent])
            sel_mems[name] = sel.reshape(b * k, -1)
        mems = sel_mems
        seqs = seqs[rows, parent]  # reorder history by parent beam
        seqs[:, :, t] = word
        new_fin = was_fin | (word == eos)
        scores = top_scores.astype(np.float32)
        if hooks.drop is not None:
            s2, drop_mask = hooks.drop(word.copy(), scores.copy(), t)
            drop_mask = np.asarray(drop_mask, bool)
            scores = np.where(drop_mask, NEG_INF,
                              np.asarray(s2, np.float32)).astype(np.float32)
            new_fin = new_fin | drop_mask
        finished = new_fin
        words = word
        if hooks.stop is not None and bool(
                hooks.stop(finished.copy(), scores.copy(), t)):
            break
        if finished.all():
            break
    dec.last_chain_depth = dispatches
    dec.last_steps = dispatches
    dec.last_timeline = {"dispatch_s": time.perf_counter() - start - wait,
                         "device_s": wait}
    return seqs, _lengths(seqs, eos, t_max), scores
