"""Continuous-batching LM engine over the paged KV pool.

`LMEngine` owns a fixed number of decode SLOTS — the width of the
decode step it runs per emitted token — and a queue of admitted
requests. Between any two decode steps it can:

- **admit** a queued request into a free slot: one bucketed prefill
  fills the request's pages and emits its first token;
- **evict** a live request mid-generation: its pages go back to the
  pool free list and the tokens it has emitted stay on the host, so
  the pool can serve someone else *now*;
- **readmit** an evicted request: its prompt + already-emitted tokens
  re-prefill as one sequence, which re-derives exactly the pool state
  the evicted chain had — the continuation is byte-identical to never
  having been evicted.

Inactive slots ride along in the decode step as finished rows pointing
at a reserved scratch page; the step's `finished` lane forces their
lanes to eos and freezes their scores, so slot occupancy can change
between steps while every step has the same width.

The measured cache story: `cached_prefix_tokens` counts prefix tokens
READ from pages by decode steps (each one a full-prefix recompute the
baseline would have paid — `prefix_recompute_bytes_saved` prices them
via `models.lm.lm_prefix_token_recompute_bytes`); `reprefilled_tokens`
counts tokens a readmission had to recompute because eviction threw
its pages away. `cache_hit_frac = cached / (cached + reprefilled)`.

The port of `paddle_tpu/serving/lm_engine.py`. The device work happens
inside `decoding.kv_cache.PagedLM`; the blocking fetch of each step's
token lane (`.cpu()`) is the engine's device-time window, so
`timeline` splits host enqueue time from device time.
"""

from __future__ import annotations

import time
from collections import deque
from typing import Dict, List, Optional

import numpy as np

from paddle_tpu_torch.decoding.kv_cache import PagedLM, PoolExhausted

__all__ = ["LMEngine", "PagedLMModel"]


class _Seq:
    __slots__ = ("req_id", "prompt", "out", "score", "finished",
                 "pos", "pages", "slot", "evicted", "max_new",
                 "pending", "prefills")

    def __init__(self, req_id, prompt, max_new):
        self.req_id = req_id
        self.prompt = np.asarray(prompt, np.int32).ravel()
        self.out: List[int] = []
        self.score = 0.0
        self.finished = False
        self.pos = 0
        self.pages: List[int] = []
        self.slot: Optional[int] = None
        self.evicted = False
        self.max_new = int(max_new)
        self.pending = 0
        self.prefills = 0


class LMEngine:
    """slots: decode-step width (live requests per step).
    auto_evict: on pool exhaustion, evict the live request with the
    fewest emitted tokens (cheapest to re-prefill) back to the queue
    instead of failing the admission."""

    def __init__(self, plm: PagedLM, slots: int = 4,
                 max_new: int = 32, auto_evict: bool = True):
        assert slots >= 1
        self.plm = plm
        self.cache = plm.cache
        self.num_slots = int(slots)
        self.max_new = int(max_new)
        self.auto_evict = auto_evict
        self.seqs: Dict[object, _Seq] = {}
        self.slots: List[Optional[object]] = [None] * self.num_slots
        self.queue = deque()
        self._scratch = self.cache.alloc(1)
        self.reprefilled_tokens = 0
        self.prefill_dispatches = 0
        self.decode_dispatches = 0
        self.timeline = {"dispatch_s": 0.0, "device_s": 0.0}
        self._req_counter = 0

    # -- measured cache story ---------------------------------------
    @property
    def cache_hit_frac(self) -> float:
        hits = self.cache.cached_prefix_tokens
        miss = self.reprefilled_tokens
        return hits / (hits + miss) if (hits + miss) else 1.0

    @property
    def prefix_recompute_bytes_saved(self) -> int:
        from paddle_tpu_torch.models.lm import (
            lm_prefix_token_recompute_bytes,
        )

        per_tok = lm_prefix_token_recompute_bytes(self.plm.spec)
        return self.cache.cached_prefix_tokens * per_tok

    # -- request lifecycle ------------------------------------------
    def submit(self, prompt, max_new: Optional[int] = None,
               req_id=None):
        """Queue a request; it enters a slot (one prefill) as soon as
        one is free. Returns the request id."""
        if req_id is None:
            self._req_counter += 1
            req_id = f"r{self._req_counter}"
        assert req_id not in self.seqs, req_id
        self.seqs[req_id] = _Seq(
            req_id, prompt, max_new or self.max_new
        )
        self.queue.append(req_id)
        self.fill_slots()
        return req_id

    def evict(self, req_id, requeue: bool = True):
        """Drop a live request's pages back to the pool; its emitted
        tokens stay on the host. With requeue it re-prefills when a
        slot frees up; otherwise it parks until readmit()."""
        seq = self.seqs[req_id]
        assert seq.slot is not None and not seq.finished, req_id
        self.slots[seq.slot] = None
        seq.slot = None
        self.cache.free(seq.pages)
        seq.pages = []
        seq.evicted = True
        self.cache.evictions += 1
        if requeue:
            self.queue.append(req_id)

    def readmit(self, req_id):
        seq = self.seqs[req_id]
        assert seq.evicted and seq.slot is None, req_id
        self.queue.append(req_id)
        self.fill_slots()

    def fill_slots(self):
        """Admit queued requests into free slots — runs between any
        two decode steps (continuous batching)."""
        while self.queue and None in self.slots:
            req_id = self.queue[0]
            try:
                self._enter_slot(self.seqs[req_id])
            except PoolExhausted:
                if not (self.auto_evict and self._evict_cheapest()):
                    return
                continue
            self.queue.popleft()

    def _evict_cheapest(self) -> bool:
        live = [self.seqs[r] for r in self.slots if r is not None]
        if not live:
            return False
        victim = min(live, key=lambda s: len(s.out))
        self.evict(victim.req_id, requeue=True)
        return True

    def _enter_slot(self, seq: _Seq):
        slot = self.slots.index(None)
        toks = np.concatenate(
            [seq.prompt, np.asarray(seq.out, np.int32)]
        )
        bucket = self.cache.bucket_for(len(toks))
        ps = self.cache.page_size
        pages = self.cache.alloc(bucket // ps)
        padded = np.zeros((1, bucket), np.int32)
        padded[0, :len(toks)] = toks
        lens = np.asarray([len(toks)], np.int32)
        t0 = time.perf_counter()
        tok_d, sc_d = self.plm.prefill(padded, lens, [pages])
        t1 = time.perf_counter()
        tok = int(tok_d.cpu().numpy()[0])
        sc = float(sc_d.cpu().numpy()[0])
        t2 = time.perf_counter()
        self.timeline["dispatch_s"] += t1 - t0
        self.timeline["device_s"] += t2 - t1
        self.prefill_dispatches += 1
        keep = self.cache.pages_for_len(len(toks))
        if len(pages) > keep:
            self.cache.free(pages[keep:])
            del pages[keep:]
        if seq.prefills > 0:
            self.reprefilled_tokens += int(len(toks))
        seq.prefills += 1
        seq.evicted = False
        seq.pages = pages
        seq.pos = len(toks)
        seq.pending = tok
        seq.score += sc
        seq.out.append(tok)
        if tok == self.plm.eos_id or len(seq.out) >= seq.max_new:
            seq.finished = True
            self.cache.free(seq.pages)
            seq.pages = []
            return
        self.slots[slot] = seq.req_id
        seq.slot = slot

    # -- the per-token dispatch -------------------------------------
    def step(self) -> int:
        """One decode step across all slots. Returns the
        number of live rows it served (0 = nothing to do)."""
        # capacity pass FIRST: growing a row may evict another, so no
        # step lane may be built until slot occupancy is
        # final (a stale lane would scatter into freed pages)
        for req_id in list(self.slots):
            if req_id is None:
                continue
            seq = self.seqs[req_id]
            if seq.slot is None:
                continue  # evicted by an earlier row's growth
            while True:
                try:
                    self.plm._grow([seq.pages], [seq.pos])
                    break
                except PoolExhausted:
                    if not (self.auto_evict
                            and self._evict_cheapest()):
                        self.evict(req_id, requeue=True)
                        break
                    if seq.slot is None:
                        break  # this row was the cheapest victim
        if not any(r is not None for r in self.slots):
            return 0
        r = self.num_slots
        eos = self.plm.eos_id
        tok = np.full((r,), eos, np.int32)
        pos = np.zeros((r,), np.int32)
        scores = np.zeros((r,), np.float32)
        finished = np.ones((r,), bool)
        page_lists = [list(self._scratch) for _ in range(r)]
        for i, req_id in enumerate(self.slots):
            if req_id is None:
                continue
            seq = self.seqs[req_id]
            tok[i] = seq.pending
            pos[i] = seq.pos
            scores[i] = seq.score
            finished[i] = False
            page_lists[i] = seq.pages
        t0 = time.perf_counter()
        nxt_d, sc_d, _fin_d = self.plm.decode_step(
            tok, pos, page_lists, scores, finished
        )
        t1 = time.perf_counter()
        nxt = nxt_d.cpu().numpy()
        sc = sc_d.cpu().numpy()
        t2 = time.perf_counter()
        self.timeline["dispatch_s"] += t1 - t0
        self.timeline["device_s"] += t2 - t1
        self.decode_dispatches += 1
        served = 0
        for i, req_id in enumerate(self.slots):
            if req_id is None:
                continue
            served += 1
            seq = self.seqs[req_id]
            seq.pos += 1
            seq.pending = int(nxt[i])
            seq.score = float(sc[i])
            seq.out.append(seq.pending)
            if seq.pending == eos or len(seq.out) >= seq.max_new:
                seq.finished = True
                self.slots[i] = None
                seq.slot = None
                self.cache.free(seq.pages)
                seq.pages = []
        self.fill_slots()
        return served

    def run(self, max_steps: Optional[int] = None):
        """Decode until every submitted request finishes."""
        budget = max_steps if max_steps is not None else (
            sum(s.max_new for s in self.seqs.values()) * 2
            + 16 * len(self.seqs)
        )
        steps = 0
        while self.step():
            steps += 1
            assert steps <= budget, "engine failed to converge"
        assert not self.queue, "queued requests never got a slot"
        return steps

    def result(self, req_id):
        seq = self.seqs[req_id]
        return {
            "tokens": list(seq.out),
            "score": float(seq.score),
            "finished": seq.finished,
            "prefills": seq.prefills,
        }

    def pop(self, req_id):
        out = self.result(req_id)
        del self.seqs[req_id]
        return out


class PagedLMModel:
    """Server-facing wrapper (the server's `run_batch` contract): packs
    each batch row through the continuous-batching engine so mid-call
    admissions/evictions happen between decode steps, not around
    whole requests."""

    can_host = False
    engine = None

    def __init__(self, plm: PagedLM, slots: int = 4,
                 max_new: int = 32):
        self.plm = plm
        self.lm_engine = LMEngine(plm, slots=slots, max_new=max_new)
        self.named_hooks = {}

    @property
    def tokens_per_dispatch(self):
        return 1

    @property
    def recompile_guards(self):
        return tuple(self.plm.recompile_guards)

    def run_batch(self, ids, lens, hooks, host: bool):
        assert hooks is None, "paged LM serving has no hook rung"
        eng = self.lm_engine
        b = ids.shape[0]
        req_ids = [
            eng.submit(ids[i, :int(lens[i])]) for i in range(b)
        ]
        eng.run()
        rows = []
        for rid in req_ids:
            res = eng.pop(rid)
            toks = res["tokens"]
            if toks and toks[-1] == self.plm.eos_id:
                toks = toks[:-1]
            rows.append({
                "tokens": toks,
                "score": res["score"],
                "path": "paged",
            })
        return rows
