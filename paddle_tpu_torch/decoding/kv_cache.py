"""Paged KV-cache pool + prefill/decode disaggregation.

The port of `paddle_tpu/decoding/kv_cache.py` (greedy path). Generation
splits into two steps over a pool of fixed-size KV pages:

- **prefill** (one per admission, at a page-aligned power-of-two
  bucket length): full causal forward over the prompt — through the
  Hopper flash kernel when `spec.attn_impl == "flash"` — per-layer K/V
  written into the sequence's pages, and the first next-token
  selection (argmax + score).
- **decode** (one per emitted token, across a fixed number of rows):
  gathers the page context, runs the new token through every block,
  appends its K/V into the pool, selects the next token and updates
  the running score.

Where the JAX programs donate the pool buffers to get an in-place
update, the port simply writes the pool in place (`pool_k[:, pages] =
...`). PyTorch runs eagerly, so there are no compiled programs to
cache and no recompile guards; the returned tokens and scores stay on
the device, unfetched, so callers can chain steps without a host
round trip.

Pages are a host-side free list; a sequence holds
`ceil(len/page_size)` pages (+1 as it grows), so the serving engine
(`serving/lm_engine.py`) can evict a request mid-generation and
re-prefill it later byte-identically.

Beam search over pages (`beam_generate`, ROADMAP A5): the prefill of B
rows (row 0 of each group, through the flash kernel where the spec asks
for it) selects the first K expansions in the same call; each later
step (1) lets every beam row adopt its parent's cache by copying page
contents, (2) appends the pending tokens and (3) selects the next
expansion (`models.lm.beam_step_select`). The copy takes only the
slots a row owns: every source page is gathered before any write, and
a row that keeps its own parent copies nothing. The JAX program copies
the whole padded page table, whose unused slots point at page 0, so it
writes stale contents into page 0 (ROADMAP C4); the port does not.

`SpeculativePagedLM` (ROADMAP A5) runs the draft-proposes /
target-verifies scheme through the pools: the draft proposes n tokens,
one `lm_decode_chunk` a substep appending to the draft's own pool; the
target verifies all n positions in one `lm_decode_chunk` of n tokens,
appending to its own pool; the host accepts the longest agreeing
prefix plus the target's corrected token. Both run eagerly;
`last_chain_depth` counts the dispatches the JAX programs count (2
prefills + 2 a round), not kernel launches.
"""

from __future__ import annotations

import threading
import time
from typing import Optional

import numpy as np
import torch

from paddle_tpu_torch.core.device import resolve_device
from paddle_tpu_torch.models import lm as lmm

__all__ = [
    "PoolExhausted", "PagedKVCache", "PagedLM", "SpeculativePagedLM",
]


class PoolExhausted(RuntimeError):
    """The page free list cannot satisfy an allocation — the serving
    engine's cue to evict (or shed) before retrying."""


class PagedKVCache:
    """Fixed-size-page KV pool for one LM: the K/V tensors
    ([L, num_pages, page_size, H, hd] f32 each, on `device`), a
    host-side page free list, and measured counters.

    Slot addressing: absolute position p of a sequence lives in its
    `pages[p // page_size]` at offset `p % page_size`; a gathered
    page-table context therefore has slot s == absolute position s,
    which is what `models.lm.lm_decode_chunk` assumes.
    """

    def __init__(self, spec, num_pages: int, page_size: int = 16,
                 max_pages_per_seq: Optional[int] = None, device=None):
        assert page_size >= 1 and num_pages >= 1
        self.spec = spec
        self.device = resolve_device(device)
        self.page_size = int(page_size)
        self.num_pages = int(num_pages)
        self.max_pages_per_seq = int(max_pages_per_seq or num_pages)
        self._lock = threading.Lock()
        self._free = list(range(self.num_pages))
        self.pool = None  # (pool_k, pool_v), allocated at first use
        # measured counters
        self.appended_tokens = 0        # tokens written by decode
        self.prefilled_tokens = 0       # tokens written by prefill
        self.cached_prefix_tokens = 0   # sum of prefix lengths served
        self.evictions = 0

    @property
    def max_seq_len(self) -> int:
        return self.max_pages_per_seq * self.page_size

    def bucket_for(self, length: int) -> int:
        """Smallest page-aligned power-of-two-pages bucket >= length."""
        assert 1 <= length <= self.max_seq_len, (
            f"length {length} outside pool capacity {self.max_seq_len}"
        )
        pages = 1
        while pages * self.page_size < length:
            pages *= 2
        return min(pages, self.max_pages_per_seq) * self.page_size

    def ensure_pool(self):
        if self.pool is None:
            s = self.spec
            shape = (s.num_layers, self.num_pages, self.page_size,
                     s.num_heads, s.head_dim)
            self.pool = (
                torch.zeros(shape, dtype=torch.float32, device=self.device),
                torch.zeros(shape, dtype=torch.float32, device=self.device),
            )
        return self.pool

    def free_page_count(self) -> int:
        with self._lock:
            return len(self._free)

    def alloc(self, n: int) -> list:
        with self._lock:
            if n > len(self._free):
                raise PoolExhausted(
                    f"need {n} pages, {len(self._free)} free"
                )
            pages, self._free = self._free[:n], self._free[n:]
            return pages

    def free(self, pages) -> None:
        with self._lock:
            self._free.extend(pages)

    def pages_for_len(self, length: int) -> int:
        """Pages a sequence of `length` tokens holds, plus the page
        its NEXT append lands in (decode writes at pos == length)."""
        return min(length // self.page_size + 1,
                   self.max_pages_per_seq)


def _page_table(page_lists, maxp):
    """Stack ragged per-row page lists into the [rows, maxp] table the
    decode step takes; unused slots point at page 0 but are never read
    (position mask) nor written (host capacity invariant)."""
    tbl = np.zeros((len(page_lists), maxp), np.int64)
    for r, pages in enumerate(page_lists):
        tbl[r, :len(pages)] = pages
    return tbl


class PagedLM:
    """Prefill + decode steps for one LM over one PagedKVCache.
    `generate()` is the whole-call host loop; the serving engine
    drives `prefill()`/`decode_step()` itself to interleave admissions
    and evictions between steps. `last_timeline` splits a generate
    into enqueue-vs-device seconds: the enqueue window is host work,
    the blocking fetch of the selected tokens is device time."""

    def __init__(self, spec, params, cache: PagedKVCache,
                 eos_id: int = 1):
        assert cache.spec == spec
        self.spec = spec
        self.params = params
        self.cache = cache
        self.eos_id = int(eos_id)
        self.last_chain_depth: Optional[int] = None
        self.last_timeline: Optional[dict] = None
        # bytes the last beam_generate's parent copies moved (read and
        # written, over its max_new - 1 steps)
        self.last_copy_bytes: Optional[int] = None

    def _dev(self, x, dtype):
        return torch.as_tensor(x, dtype=dtype, device=self.cache.device)

    def _append_chunk(self, toks, start, tbl):
        """Run toks [R, n] at absolute positions start[r] .. start[r]+n-1
        against the pages of tbl [R, maxp] (all on the device) and
        append their K/V to the pool at those positions: logits
        [R, n, vocab]. The context is a gathered copy of the pool, taken
        before the append."""
        spec = self.spec
        ps = self.cache.page_size
        r, n = toks.shape
        pool_k, pool_v = self.cache.ensure_pool()
        shp = (spec.num_layers, r, tbl.shape[1] * ps, spec.num_heads,
               spec.head_dim)
        ctx_k = pool_k[:, tbl].reshape(shp)
        ctx_v = pool_v[:, tbl].reshape(shp)
        logits, nk, nv = lmm.lm_decode_chunk(spec, self.params, toks, start,
                                             ctx_k, ctx_v)
        idx = start[:, None] + torch.arange(n, device=start.device)[None, :]
        pp = tbl.gather(1, idx // ps)
        pool_k[:, pp, idx % ps] = nk
        pool_v[:, pp, idx % ps] = nv
        return logits

    @torch.no_grad()
    def prefill(self, ids, lens, page_lists, beam_k: int = 0):
        """Bucketed prefill for rows whose pages are already allocated
        (page_lists[r] must hold >= bucket//page_size pages). ids
        [B, bucket] int. Writes the pool in place and returns (toks,
        scores) as UNFETCHED device tensors: [B] int32 / [B] f32 greedy,
        or with beam_k > 0 the first expansion `beam_init_select`
        gives, [B, K] each."""
        spec = self.spec
        b, t = ids.shape
        ps = self.cache.page_size
        assert t % ps == 0 and t >= int(np.max(lens))
        n_pages = t // ps
        pages = self._dev([p[:n_pages] for p in page_lists], torch.long)
        lens_d = self._dev(lens, torch.int32)
        pool_k, pool_v = self.cache.ensure_pool()
        logits, ks, vs = lmm.lm_forward(
            spec, self.params, self._dev(ids, torch.long), lens=lens_d,
            with_kv=True,
        )
        shp = (spec.num_layers, b, n_pages, ps, spec.num_heads,
               spec.head_dim)
        pool_k[:, pages] = ks.reshape(shp)
        pool_v[:, pages] = vs.reshape(shp)
        last = logits[torch.arange(b, device=logits.device),
                      lens_d.long() - 1]
        logp = lmm.lm_logp(last)
        self.cache.prefilled_tokens += int(np.sum(lens))
        if beam_k:
            scores, toks = lmm.beam_init_select(logp, beam_k)
            return toks, scores
        toks = torch.argmax(logp, dim=-1)
        scores = logp.gather(1, toks[:, None])[:, 0]
        return toks.to(torch.int32), scores

    @torch.no_grad()
    def decode_step(self, tok, pos, page_lists, scores, finished):
        """One decode step: append `tok` (the pending token at absolute
        position pos[r]) and select the next. `pos` and `page_lists`
        are host-side; tok/scores/finished may be unfetched device
        tensors. Returns (next_tok, scores, finished) device tensors."""
        b = len(tok)
        tbl = self._dev(_page_table(page_lists,
                                    self.cache.max_pages_per_seq), torch.long)
        tok = self._dev(tok, torch.long)
        scores = self._dev(scores, torch.float32)
        finished = self._dev(finished, torch.bool)
        logits = self._append_chunk(tok[:, None], self._dev(pos, torch.long),
                                    tbl)
        logp = lmm.lm_logp(logits[:, 0])
        nxt = torch.argmax(logp, dim=-1)
        nxt = torch.where(finished, self.eos_id, nxt)
        sc = torch.where(
            finished, scores, scores + logp.gather(1, nxt[:, None])[:, 0],
        )
        fin = finished | (nxt == self.eos_id)
        self.cache.appended_tokens += b
        self.cache.cached_prefix_tokens += int(np.sum(pos))
        return nxt.to(torch.int32), sc, fin

    def _grow(self, page_lists, pos):
        """Allocate the next page for any row whose append position
        crossed its last page boundary."""
        need = 0
        ps = self.cache.page_size
        for r, p in enumerate(page_lists):
            while len(p) * ps <= int(pos[r]):
                p.extend(self.cache.alloc(1))
                need += 1
        return need

    def generate(self, ids, lens, max_new: int):
        """Greedy paged generation: bucketed prefill + max_new-1
        decode steps. Returns (tokens [B, max_new] int32, scores [B]
        f32) as numpy — token-for-token equal to
        models.lm.greedy_decode_recompute."""
        b = ids.shape[0]
        lens = np.asarray(lens, np.int32)
        bucket = self.cache.bucket_for(int(lens.max()))
        ps = self.cache.page_size
        padded = np.zeros((b, bucket), np.int32)
        padded[:, :min(bucket, ids.shape[1])] = ids[:, :bucket]
        page_lists = [self.cache.alloc(bucket // ps) for _ in range(b)]
        t0 = time.perf_counter()
        toks, scores = self.prefill(padded, lens, page_lists)
        chain = 1
        self._trim(page_lists, lens)
        # the chain runs without a host round trip: each step takes
        # the previous step's unfetched tokens; the one blocking fetch
        # at the end is the device-time window
        finished = toks == self.eos_id
        step_toks = [toks]
        pos = lens.copy()
        for _ in range(1, max_new):
            self._grow(page_lists, pos)
            toks, scores, finished = self.decode_step(
                toks, pos, page_lists, scores, finished
            )
            chain += 1
            step_toks.append(toks)
            pos += 1
        t1 = time.perf_counter()
        out = torch.stack(step_toks, dim=1).cpu().numpy()
        scores = scores.cpu().numpy().astype(np.float32)
        t2 = time.perf_counter()
        self.last_chain_depth = chain
        self.last_timeline = {"dispatch_s": t1 - t0, "device_s": t2 - t1}
        for p in page_lists:
            self.cache.free(p)
        return out.astype(np.int32), scores

    def _trim(self, page_lists, lens):
        """Keep the pages each row's live prefix (and its next append)
        occupies; return the bucket's tail pages to the pool."""
        for r, p in enumerate(page_lists):
            keep = self.cache.pages_for_len(int(lens[r]))
            if len(p) > keep:
                self.cache.free(p[keep:])
                del p[keep:]

    def beam_generate(self, ids, lens, beam_k: int, max_new: int):
        """Paged beam search. Returns (tokens [B, K, max_new] int32,
        scores [B, K] f32) as numpy — the beams of
        models.lm.beam_decode_recompute under the shared expansion
        rule. Each step fetches the parents (the host reorders the
        emitted history and plans the next step's page copies): that
        fetch is the device-time window of `last_timeline`."""
        b = ids.shape[0]
        k = int(beam_k)
        lens = np.asarray(lens, np.int32)
        bucket = self.cache.bucket_for(int(lens.max()))
        ps = self.cache.page_size
        padded = np.zeros((b, bucket), np.int32)
        padded[:, :min(bucket, ids.shape[1])] = ids[:, :bucket]
        # beam row (g, j) owns its own pages; the prefill fills row j=0,
        # the first step's copy from parent 0 fans the prefix out
        rows = [[self.cache.alloc(bucket // ps) for _ in range(k)]
                for _ in range(b)]
        disp_s = dev_s = 0.0
        t0 = time.perf_counter()
        toks_d, scores = self.prefill(padded, lens, [r[0] for r in rows],
                                      beam_k=k)
        t1 = time.perf_counter()
        toks = toks_d.cpu().numpy()
        t2 = time.perf_counter()
        disp_s += t1 - t0
        dev_s += t2 - t1
        chain = 1
        for g in range(b):
            self._trim(rows[g], np.full(k, lens[g]))
        hist = np.zeros((b, k, max_new), np.int32)
        hist[:, :, 0] = toks
        finished = torch.as_tensor(toks == self.eos_id,
                                   device=self.cache.device)
        parent = np.zeros((b, k), np.int64)
        pos = lens.copy()
        gi = np.arange(b)[:, None]
        copy_bytes = 0
        for t in range(1, max_new):
            flat = [p for g in rows for p in g]
            self._grow(flat, np.repeat(pos, k))
            t0 = time.perf_counter()
            toks_d, par_d, scores, finished, moved = self._beam_step(
                toks, parent, pos, rows, scores, finished)
            t1 = time.perf_counter()
            toks = toks_d.cpu().numpy()
            parent = par_d.cpu().numpy().astype(np.int64)
            t2 = time.perf_counter()
            disp_s += t1 - t0
            dev_s += t2 - t1
            copy_bytes += moved
            chain += 1
            hist = hist[gi, parent]
            hist[:, :, t] = toks
            pos += 1
        self.last_chain_depth = chain
        self.last_timeline = {"dispatch_s": disp_s, "device_s": dev_s}
        self.last_copy_bytes = copy_bytes
        for g in rows:
            for p in g:
                self.cache.free(p)
        return hist, scores.cpu().numpy().astype(np.float32)

    def _parent_copy(self, parent, rows):
        """Every beam row adopts its parent's cache: the contents of the
        parent's pages land in the row's own pages, slot by slot, over
        the slots the row owns (rows of a group own equally many: they
        share one position). Every source is gathered before any write;
        a row whose parent is itself copies nothing. Returns the bytes
        moved (read and written, K and V)."""
        src, dst = [], []
        for g, group in enumerate(rows):
            for j, own in enumerate(group):
                par = int(parent[g, j])
                if par != j:
                    assert len(group[par]) == len(own)
                    src.extend(group[par])
                    dst.extend(own)
        if not dst:
            return 0
        pool_k, pool_v = self.cache.ensure_pool()
        src = self._dev(src, torch.long)
        dst = self._dev(dst, torch.long)
        for pool in (pool_k, pool_v):
            pool[:, dst] = pool[:, src]   # the gather is a copy
        return 2 * 2 * len(dst) * pool_k[:, 0].numel() * 4

    @torch.no_grad()
    def _beam_step(self, toks, parent, pos, rows, scores, finished):
        """One beam step over B groups of K rows: (1) the parent copy,
        (2) append `toks` [B, K] (host) at pos[g] (host), (3) select the
        next expansion. scores and finished stay on the device. Returns
        (tok, parent, scores, finished) device tensors [B, K] and the
        copy's bytes."""
        b, k = toks.shape
        moved = self._parent_copy(parent, rows)
        tbl = self._dev(_page_table([p for g in rows for p in g],
                                    self.cache.max_pages_per_seq), torch.long)
        logits = self._append_chunk(
            self._dev(toks.reshape(b * k, 1), torch.long),
            self._dev(np.repeat(pos, k), torch.long), tbl)
        logp = lmm.lm_logp(logits[:, 0]).reshape(b, k, -1)
        sc, par, tok, fin = lmm.beam_step_select(scores, logp, finished,
                                                 self.eos_id)
        self.cache.appended_tokens += b * k
        self.cache.cached_prefix_tokens += int(np.sum(pos)) * k
        return tok, par, sc, fin, moved


class SpeculativePagedLM:
    """Draft-proposes / target-verifies speculation through the paged
    pools: the draft's n-token proposal appends to the draft's own
    pages, one `lm_decode_chunk` a substep; the target verifies all n
    positions in one `lm_decode_chunk` of n tokens, appending to its own
    pages. The host accepts the longest agreeing prefix + the target's
    corrected token, so the output is token for token the target's
    greedy paged output no matter how bad the draft is. Stale cache
    entries past an accept point are never read (position mask) and
    are overwritten by the next round's appends."""

    def __init__(self, target: PagedLM, draft: PagedLM,
                 propose_k: int = 4):
        assert propose_k >= 1
        assert target.eos_id == draft.eos_id
        self.target, self.draft = target, draft
        self.propose_k = int(propose_k)
        self.last_chain_depth: Optional[int] = None
        self.last_accept_rate: Optional[float] = None

    def _propose(self, first, pos, page_tbl, n: int):
        """The draft's n greedy tokens from `first` [B] at pos [B], each
        appended to the draft's pool before the next: [n, B] on the
        device."""
        w, props = first, []
        for j in range(n):
            logits = self.draft._append_chunk(w[:, None], pos + j, page_tbl)
            w = torch.argmax(lmm.lm_logp(logits[:, 0]), dim=-1)
            props.append(w)
        return torch.stack(props)

    def _verify(self, words, pos, page_tbl):
        """The target over all n positions of words [B, n] in one chunk,
        appended to its pool: greedy tokens and their log-probs, [B, n]
        each, on the device."""
        logp = lmm.lm_logp(self.target._append_chunk(words, pos, page_tbl))
        gs = torch.argmax(logp, dim=-1)
        return gs, logp.gather(2, gs[..., None])[..., 0]

    @torch.no_grad()
    def generate(self, ids, lens, max_new: int):
        """Speculative greedy paged generation. Returns (tokens
        [B, max_new] int32, scores [B] f32) as numpy — token for token
        the target PagedLM.generate output."""
        tgt, drf, kp = self.target, self.draft, self.propose_k
        b = ids.shape[0]
        lens = np.asarray(lens, np.int32)
        eos = tgt.eos_id

        def _prefill(plm):
            bucket = plm.cache.bucket_for(int(lens.max()))
            padded = np.zeros((b, bucket), np.int32)
            padded[:, :min(bucket, ids.shape[1])] = ids[:, :bucket]
            pages = [plm.cache.alloc(bucket // plm.cache.page_size)
                     for _ in range(b)]
            toks, scores = plm.prefill(padded, lens, pages)
            plm._trim(pages, lens)
            return pages, toks, scores

        t_pages, pending, scores = _prefill(tgt)
        d_pages, _d_toks, _d_sc = _prefill(drf)
        pending = pending.cpu().numpy().astype(np.int32)
        scores = scores.cpu().numpy().astype(np.float32)
        dispatches = 2
        proposed = accepted = 0

        out = np.zeros((b, max_new), np.int32)
        out[:, 0] = pending
        emitted = np.ones((b,), np.int64)
        finished = pending == eos
        pos = lens.astype(np.int64).copy()
        rows = np.arange(b)
        dev = tgt.cache.device

        while not (finished | (emitted >= max_new)).all():
            live = ~(finished | (emitted >= max_new))
            rem = int((max_new - emitted[live]).max())
            cap = min(tgt.cache.max_seq_len,
                      drf.cache.max_seq_len) - int(pos.max())
            n = max(1, min(kp, rem, cap))
            # grow both pools to cover pos .. pos+n-1
            grow_to = pos + n - 1
            tgt._grow(t_pages, grow_to)
            drf._grow(d_pages, grow_to)
            d_tbl = drf._dev(_page_table(d_pages,
                                         drf.cache.max_pages_per_seq),
                             torch.long)
            t_tbl = tgt._dev(_page_table(t_pages,
                                         tgt.cache.max_pages_per_seq),
                             torch.long)
            pos_d = torch.as_tensor(pos, dtype=torch.long, device=dev)
            first = torch.as_tensor(pending, dtype=torch.long, device=dev)
            # the draft proposes n tokens, appending to its own pool
            props = self._propose(first, pos_d, d_tbl, n)
            dispatches += 1
            # the target verifies all n positions as one chunk,
            # appending to its pool: position j consumes
            # [pending, props[:n-1]][j]
            words = torch.cat([first[None, :], props[:n - 1]], 0).T
            gs, glp = self._verify(words.contiguous(), pos_d, t_tbl)
            tgt.cache.appended_tokens += b * n
            tgt.cache.cached_prefix_tokens += int(pos.sum())
            dispatches += 1
            props_np = props.cpu().numpy()   # [n, B]
            gs_np = gs.cpu().numpy()         # [B, n]
            glp_np = glp.cpu().numpy()       # [B, n]

            proposed += n * int(live.sum())
            for r in rows[live]:
                agree = gs_np[r, :n - 1] == props_np[:n - 1, r]
                mism = np.nonzero(~agree)[0]
                n_acc = int(mism[0]) + 1 if mism.size else n
                take = int(min(n_acc, max_new - emitted[r]))
                for j in range(take):
                    t = gs_np[r, j]
                    if finished[r]:
                        t = eos
                    else:
                        scores[r] += glp_np[r, j]
                    out[r, emitted[r]] = t
                    emitted[r] += 1
                    if t == eos:
                        finished[r] = True
                accepted += take
                pos[r] += n_acc
                pending[r] = gs_np[r, n_acc - 1]

        self.last_chain_depth = dispatches
        self.last_accept_rate = (
            accepted / proposed if proposed else None)
        for p in t_pages:
            tgt.cache.free(p)
        for p in d_pages:
            drf.cache.free(p)
        # rows that hit eos stop emitting; the greedy reference keeps
        # emitting eos to max_new, so pad the tails to match it
        for r in rows:
            out[r, emitted[r]:] = eos
        return out, np.asarray(scores, np.float32)
