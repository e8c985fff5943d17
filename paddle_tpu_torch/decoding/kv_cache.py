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

Left out, still to port (ROADMAP A5): beam decode over pages
(`_beam_decode_program`, `beam_generate`) and `SpeculativePagedLM`.
"""

from __future__ import annotations

import threading
import time
from typing import Optional

import numpy as np
import torch

from paddle_tpu_torch.core.device import resolve_device
from paddle_tpu_torch.models import lm as lmm

__all__ = ["PoolExhausted", "PagedKVCache", "PagedLM"]


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

    def _dev(self, x, dtype):
        return torch.as_tensor(x, dtype=dtype, device=self.cache.device)

    @torch.no_grad()
    def prefill(self, ids, lens, page_lists):
        """Bucketed prefill for rows whose pages are already allocated
        (page_lists[r] must hold >= bucket//page_size pages). ids
        [B, bucket] int. Writes the pool in place and returns (toks
        [B] int32, scores [B] f32) as UNFETCHED device tensors."""
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
        toks = torch.argmax(logp, dim=-1)
        scores = logp.gather(1, toks[:, None])[:, 0]
        self.cache.prefilled_tokens += int(np.sum(lens))
        return toks.to(torch.int32), scores

    @torch.no_grad()
    def decode_step(self, tok, pos, page_lists, scores, finished):
        """One decode step: append `tok` (the pending token at absolute
        position pos[r]) and select the next. `pos` and `page_lists`
        are host-side; tok/scores/finished may be unfetched device
        tensors. Returns (next_tok, scores, finished) device tensors."""
        spec = self.spec
        b = len(tok)
        ps = self.cache.page_size
        maxp = self.cache.max_pages_per_seq
        tbl = self._dev(_page_table(page_lists, maxp), torch.long)
        pos_d = self._dev(pos, torch.long)
        tok = self._dev(tok, torch.long)
        scores = self._dev(scores, torch.float32)
        finished = self._dev(finished, torch.bool)
        pool_k, pool_v = self.cache.ensure_pool()
        s = maxp * ps
        shp = (spec.num_layers, b, s, spec.num_heads, spec.head_dim)
        ctx_k = pool_k[:, tbl].reshape(shp)   # gathered copies
        ctx_v = pool_v[:, tbl].reshape(shp)
        logits, nk, nv = lmm.lm_decode_chunk(
            spec, self.params, tok[:, None], pos_d, ctx_k, ctx_v
        )
        pp = tbl.gather(1, (pos_d // ps)[:, None])[:, 0]
        pool_k[:, pp, pos_d % ps] = nk[:, :, 0]
        pool_v[:, pp, pos_d % ps] = nv[:, :, 0]
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
        # keep the pages the live prefix (and the next append) occupies,
        # return the bucket's tail pages to the pool
        for r, p in enumerate(page_lists):
            keep = self.cache.pages_for_len(int(lens[r]))
            if len(p) > keep:
                self.cache.free(p[keep:])
                del p[keep:]
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
