"""Beam-search sequence generation: `paddle_tpu/beam_search.py` on torch.

Generation keeps a fixed [B, K] beam layout and advances it to
max_length with finished-beam masking, as the JAX decoder does. The
step net is authored with the DSL, as a recurrent_group's is: a data
layer for the previous word id, static links (encoder outputs) and
memories (decoder state); its output layer gives a distribution
[*, V] (a softmax).

The JAX decoder runs the whole decode as one jitted while-loop. Here
the loop is on the host, and one turn of it (a chunk) advances
`tokens_per_dispatch` = K guarded substeps:

- A substep whose carried `done` flag (stop, or t >= max_length, or
  every beam finished) is set leaves every carry and trace buffer as it
  was: `torch.where` selects on the device, no host branch. Output at
  every K is therefore the K = 1 output bit for bit, ragged tails and
  early finishes included.
- The host reads `done` once a chunk; `last_chain_depth` counts the
  chunks that ran, `last_steps` the steps.
- On a CUDA device a hook-free `generate()` replays one CUDA graph a
  chunk, one graph per (batch, static-feed signature) of each cached
  program (`_DecodeGraph`, the pattern of `parallel/graph.py`): static
  inputs (the step net's parameters, the tiled feed, the boot
  memories), one memory pool, the garbage collector off during the
  capture (`parallel/graph.py::no_gc`), a capture that fails raises. With
  `use_graphs = False`, or on the CPU, the same chunks run eagerly.
- A decode with host hooks (`BeamHooks`) runs eagerly, one substep a
  token, checking `done` on the host before each, and calls the hooks
  as plain Python on numpy where the JAX decoder's `pure_callback`s
  sit: `logprob_fn`, then `adjust` before the eos-row mask, `drop`
  after top-k, `stop` after `drop`. A substep that would be done calls
  nothing, so the hooks see the JAX decoder's `t` sequence.

Top-k orders equal scores by the lower flat index, as `lax.top_k`
does (`_top_k_stable`: `torch.topk` over an int64 key composed of the
score's order-preserving bits and the reversed index, so no two keys
tie). Scores are f32 whatever the matmul precision.

`logprob_fn(logp [B, K, V] f32 tensor, t 0-d int64 tensor) -> tensor`
is a torch function on the device (the JAX decoder's is a JAX one).

Ported: `NEG_INF`, `BeamHooks`, `BeamSearchDecoder` (the step
sub-model, `static_sizes`, `tokens_per_dispatch`, `param_confs`,
`prepare`, `generate` with `last_steps`, `last_chain_depth` and
`last_timeline`, `_expand_step`, the decode semantics) (ROADMAP A3a).
The JAX decoder's `_chunk_step_program` is the chunk here, shared by
`generate` and `serving/host_decode.py`. The JAX cache key holds a
`RecompileGuard`, which reads XLA programs (not to port, ROADMAP A12):
the port has none.
"""

from __future__ import annotations

import time
from dataclasses import dataclass
from typing import Callable, Optional

import numpy as np
import torch

from paddle_tpu_torch.core.arg import Arg
from paddle_tpu_torch.core.config import LayerConf, ModelConf
from paddle_tpu_torch.core.device import resolve_device
from paddle_tpu_torch.network import Network
from paddle_tpu_torch.parallel.dp import ARG_FIELDS, _arg_map, feed_signature
from paddle_tpu_torch.parallel.graph import _fill, no_gc

NEG_INF = -1e30
CACHE_ENTRIES = 8


@dataclass
class BeamHooks:
    """Host-side beam-search control callbacks
    (RecurrentGradientMachine.h:92-152). All optional plain-Python
    functions of numpy arrays:

    - adjust(logp [B,K,V] f32, t int) -> [B,K,V] f32: rewrite the
      step's candidate log-probs before expansion.
    - drop(words [B,K] i32, scores [B,K] f32, t int) -> (scores [B,K]
      f32, drop_mask [B,K] bool): renormalise the selected beams and/or
      mark beams to truncate (they finish at this step with NEG_INF).
    - stop(finished [B,K] bool, scores [B,K] f32, t int) -> bool: end
      the whole generation now.
    """

    adjust: Optional[Callable] = None
    drop: Optional[Callable] = None
    stop: Optional[Callable] = None

    @property
    def any(self) -> bool:
        return (self.adjust is not None or self.drop is not None
                or self.stop is not None)


def _top_k_stable(flat: torch.Tensor, k: int):
    """Row-wise top-k of [R, N] f32, equal scores ordered by the lower
    index (the `lax.top_k` contract). The key is the score's bits mapped
    to an order-preserving int32 (negative floats' magnitude bits
    flipped; -0.0 added to 0.0 first, so that the two are equal) above
    N - 1 - index: every key is distinct, and `torch.topk` of it is
    deterministic on any device."""
    bits = (flat.float() + 0.0).view(torch.int32)
    ordered = torch.where(bits < 0, bits ^ 0x7FFFFFFF, bits)
    rev = torch.arange(flat.shape[1] - 1, -1, -1, device=flat.device)
    key = ordered.to(torch.int64) * (1 << 32) + rev
    idx = torch.topk(key, k, dim=1).indices
    return torch.gather(flat, 1, idx), idx


def _to_np(x: torch.Tensor) -> np.ndarray:
    return x.detach().cpu().numpy()


class BeamSearchDecoder:
    """Built from DSL pieces:

        def step(word, enc):
            emb = dsl.embedding(word, size=E, vocab_size=V, param=...)
            prev = dsl.memory("s", size=H, boot_layer=enc_last)
            s = dsl.fc(emb, prev, size=H, act="tanh", name="s")
            return dsl.fc(s, size=V, act="softmax", name="prob")

        dec = BeamSearchDecoder(step, n_static=1, bos_id=0, eos_id=1,
                                beam_size=4, max_length=20)
        seqs, lens, scores = dec.generate(params, statics=[enc_arg],
                                          boots={"s": enc_last_value})
    """

    def __init__(
        self,
        step: Callable,
        n_static: int,
        bos_id: int,
        eos_id: int,
        beam_size: int,
        max_length: int,
        logprob_fn: Optional[Callable] = None,
        static_sizes: Optional[list] = None,
        hooks: Optional[BeamHooks] = None,
        tokens_per_dispatch: int = 1,
    ):
        """`static_sizes` (one int per static input) stamps the static
        stubs' sizes, so that size-dependent config helpers
        (dsl.simple_attention) work inside `step` as they do inside a
        training recurrent_group."""
        from paddle_tpu_torch import dsl

        assert static_sizes is None or len(static_sizes) == n_static, (
            f"static_sizes needs one entry per static input "
            f"({len(static_sizes)} given, n_static={n_static})")
        assert tokens_per_dispatch >= 1, (
            f"tokens_per_dispatch must be >= 1, got {tokens_per_dispatch}")
        self.bos_id, self.eos_id = bos_id, eos_id
        self.k = beam_size
        self.max_length = max_length
        self.logprob_fn = logprob_fn
        self.hooks = hooks or BeamHooks()
        self.tokens_per_dispatch = int(tokens_per_dispatch)
        # on a CUDA device, replay hook-free decodes from CUDA graphs
        self.use_graphs = True
        # measured readings of the last decode: the chunks that ran (the
        # host's dispatch chain), the token steps they covered, and the
        # host's time issuing work against its time waiting on the card
        self.last_chain_depth: Optional[int] = None
        self.last_steps: Optional[int] = None
        self.last_timeline: Optional[dict] = None

        with dsl.model() as sub:
            word = sub.add(LayerConf(
                name="@word", type="data", size=1,
                attrs={"dim": (1,), "is_seq": False, "is_ids": True}))
            statics = []
            for i in range(n_static):
                sz = (static_sizes or [0] * n_static)[i]
                statics.append(sub.add(LayerConf(
                    name=f"@static_{i}", type="data", size=sz,
                    attrs={"dim": (sz,), "is_seq": False,
                           "is_ids": False})))
            out = step(word, *statics)
        self.step_conf: ModelConf = sub.conf
        self.memories = sub.memories
        self.out_name = out.name
        self.static_links = [f"@static_{i}" for i in range(n_static)]
        self._net: Optional[Network] = None
        self._decode_cache: dict = {}
        self._chunk_cache: dict = {}
        # the CUDA graphs' shared pieces: one pool, one capture stream
        # and the static parameter tree every graph reads
        self._graph_pool = self._graph_stream = self._graph_params = None

    def _build(self, statics: list):
        for i, a in enumerate(statics):
            lc = self.step_conf.layer(self.static_links[i])
            v = a.value if a.value is not None else a.ids
            lc.attrs["dim"] = tuple(v.shape[2:] if a.is_seq
                                    else v.shape[1:]) or (1,)
            lc.attrs["is_seq"] = a.is_seq
            lc.attrs["is_ids"] = a.ids is not None
        self._net = Network(self.step_conf)
        return self._net

    def param_confs(self, statics: list):
        """Parameter table of the step net (names shared with
        training)."""
        return self._build(statics).param_confs

    def prepare(self, statics: list, boots: dict = None,
                batch_size: int = None, device=None):
        """(static_feed, init_carry_mem, b): the K-tiled feed and the
        boot memories both decode rungs start from (`generate` and
        `serving/host_decode.py`), on `device` (default: the statics'
        or the boots' device, else the card)."""
        if self._net is None:
            self._build(statics)
        k = self.k
        boots = boots or {}
        if batch_size is not None:
            b = batch_size
        elif statics:
            a0 = statics[0]
            b = (a0.value if a0.value is not None else a0.ids).shape[0]
        elif boots:
            b = next(iter(boots.values())).shape[0]
        else:
            raise ValueError(
                "generate() needs statics, boots, or batch_size")
        if device is None:
            first = next((getattr(a, f) for a in statics for f in ARG_FIELDS
                          if getattr(a, f) is not None), None)
            if first is None and boots:
                first = next(iter(boots.values()))
            device = first.device if first is not None else None
        dev = resolve_device(device)

        def tile(x):
            # [B, ...] -> [B*K, ...]
            return torch.as_tensor(x).to(dev).repeat_interleave(k, dim=0)

        static_feed = {self.static_links[i]: _arg_map(tile, a)
                       for i, a in enumerate(statics)}
        init_carry_mem = {}
        for m in self.memories:
            if m["layer"] in boots:
                init_carry_mem[m["layer"]] = tile(boots[m["layer"]])
            elif m.get("boot_layer"):
                raise ValueError(
                    f"memory {m['layer']!r} declares boot_layer="
                    f"{m['boot_layer']!r}, but generate() cannot compute "
                    f"parent layers — pass boots={{{m['layer']!r}: value}} "
                    f"with that layer's [B, {m['size']}] output")
            else:
                init_carry_mem[m["layer"]] = torch.full(
                    (b * k, m["size"]), float(m.get("boot_value", 0.0)),
                    dtype=torch.float32, device=dev)
        return static_feed, init_carry_mem, b

    def generate(self, params: dict, statics: list, boots: dict = None,
                 batch_size: int = None):
        """statics: list[Arg] (batch-major, B rows). boots: memory layer
        name -> [B, size] boot value. Returns (seqs [B, K, max_length]
        int32, lens [B, K] int32, scores [B, K] f32) on the parameters'
        device, beams sorted best-first."""
        dev = next(iter(params.values())).device if params else None
        static_feed, init_carry_mem, b = self.prepare(
            statics, boots, batch_size, device=dev)
        with torch.no_grad():
            return self._decode_program().run(params, static_feed,
                                              init_carry_mem, b)

    def _decode_program(self) -> "_DecodeProgram":
        """The decode of this configuration, cached on the decoder:
        keyed on everything the decode closes over (the hooks, the
        logprob function and the scalar config), so that a decoder
        mutated after its first generate() never reuses a stale
        program's graphs. At most CACHE_ENTRIES entries (the oldest
        goes first: fresh hook lambdas a call would otherwise grow it
        without bound)."""
        hk = (self.hooks.adjust, self.hooks.drop, self.hooks.stop,
              self.logprob_fn, self.k, self.max_length, self.eos_id,
              self.bos_id, self.tokens_per_dispatch)
        cache = self._decode_cache
        if hk not in cache:
            if len(cache) >= CACHE_ENTRIES:
                cache.pop(next(iter(cache)))
            cache[hk] = _DecodeProgram(self, self.hooks)
        return cache[hk]

    def _chunk_program(self, n_steps: int) -> "_DecodeProgram":
        """The hook-free decode in chunks of `n_steps`: the serving host
        rung's dispatch unit (`serving/host_decode.py`), cached as
        `_decode_program` is, keyed on what it closes over."""
        key = (n_steps, self.logprob_fn, self.k, self.max_length,
               self.eos_id, self.bos_id)
        cache = self._chunk_cache
        if key not in cache:
            if len(cache) >= CACHE_ENTRIES:
                cache.pop(next(iter(cache)))
            cache[key] = _DecodeProgram(self, BeamHooks(), k_tok=n_steps)
        return cache[key]

    # ---- one step, one substep, one chunk ---------------------------

    def _expand_step(self, params, static_feed, mems, words, scores,
                     finished, t, b, hooks: Optional[BeamHooks] = None,
                     t_host: Optional[int] = None):
        """One beam expansion: step-net forward, candidate scoring,
        finished-beam eos extension, top-k, parent-conditioned memory
        carry. With `hooks`, their adjust and drop run on the host at
        step `t_host`."""
        net, k = self._net, self.k
        feed = dict(static_feed)
        feed["@word"] = Arg(ids=words.reshape(b * k))
        for m in self.memories:
            feed[m["link"]] = Arg(value=mems[m["layer"]])
        outs, _ = net.forward(params, feed, train=False)
        prob = outs[self.out_name].value  # [B*K, V]
        v = prob.shape[-1]
        # score math is f32 whatever the matmul precision
        logp = torch.log(torch.clamp_min(prob, 1e-20)).reshape(
            b, k, v).float()
        if self.logprob_fn is not None:
            logp = self.logprob_fn(logp, t)
        if hooks is not None and hooks.adjust is not None:
            logp = torch.from_numpy(np.asarray(
                hooks.adjust(_to_np(logp), t_host), np.float32)).to(
                logp.device)
        # finished beams only extend with eos, at no cost (built on the
        # device: a host scalar stored into it would be a host-to-device
        # copy, which a CUDA graph cannot capture)
        fin_row = torch.where(
            torch.arange(v, device=logp.device) == self.eos_id, 0.0,
            NEG_INF).to(torch.float32)
        logp = torch.where(finished[..., None], fin_row, logp)
        cand = scores[..., None] + logp  # [B,K,V]
        top_scores, top_idx = _top_k_stable(cand.reshape(b, k * v), k)
        parent = top_idx // v
        word = top_idx % v
        was_fin = torch.gather(finished, 1, parent)
        new_mems = {}
        for m in self.memories:
            prev = mems[m["layer"]].reshape(b, k, -1)
            new = outs[m["layer"]].value.reshape(b, k, -1).to(prev.dtype)
            pidx = parent[..., None].expand(-1, -1, prev.shape[-1])
            new_mems[m["layer"]] = torch.where(
                was_fin[..., None], torch.gather(prev, 1, pidx),
                torch.gather(new, 1, pidx)).reshape(b * k, -1)
        new_fin = was_fin | (word == self.eos_id)
        if hooks is not None and hooks.drop is not None:
            s2, drop_mask = hooks.drop(_to_np(word).astype(np.int32),
                                       _to_np(top_scores), t_host)
            s2 = torch.from_numpy(np.asarray(s2, np.float32)).to(
                top_scores.device)
            drop_mask = torch.from_numpy(np.asarray(drop_mask, bool)).to(
                top_scores.device)
            top_scores = torch.where(drop_mask, NEG_INF, s2)
            new_fin = new_fin | drop_mask
        return new_mems, word, parent, top_scores, new_fin

    def _init_state(self, mems: dict, b: int, device) -> dict:
        """The decode's carry at t = 0. The trace buffers ws/ps
        [max_length, B, K] hold (eos, identity parent) where no step
        wrote, which backtraces benignly."""
        k, t_max = self.k, self.max_length
        scores = torch.full((b, k), NEG_INF, dtype=torch.float32,
                            device=device)
        scores[:, 0] = 0.0
        idk = torch.arange(k, device=device).expand(b, k)
        return {
            "mems": {n: v.clone() for n, v in mems.items()},
            "words": torch.full((b, k), self.bos_id, dtype=torch.int64,
                                device=device),
            "scores": scores,
            "finished": torch.zeros((b, k), dtype=torch.bool, device=device),
            "t": torch.zeros((), dtype=torch.int64, device=device),
            "stop": torch.zeros((), dtype=torch.bool, device=device),
            "ws": torch.full((t_max, b, k), self.eos_id, dtype=torch.int64,
                             device=device),
            "ps": idk.expand(t_max, b, k).clone(),
        }

    def _done(self, st: dict) -> torch.Tensor:
        return st["stop"] | (st["t"] >= self.max_length) | torch.all(
            st["finished"])

    def _substep(self, params, static_feed, st: dict, b: int,
                 hooks: Optional[BeamHooks] = None,
                 t_host: Optional[int] = None) -> dict:
        """One guarded step: a new carry, equal to `st` where the carried
        done flag is set (nothing is written at t, which may be past
        the trace buffers' end), else `st` advanced one token. No host
        reads unless `hooks` are given (then the caller has read that
        the step is live, and `t_host` is its t)."""
        done = self._done(st)
        new_mems, word, parent, top_scores, new_fin = self._expand_step(
            params, static_feed, st["mems"], st["words"], st["scores"],
            st["finished"], st["t"], b, hooks=hooks, t_host=t_host)
        stop = st["stop"]
        if hooks is not None and hooks.stop is not None:
            stop = torch.as_tensor(bool(hooks.stop(
                _to_np(new_fin), _to_np(top_scores), t_host)),
                device=stop.device)
        ti = torch.clamp(st["t"], max=self.max_length - 1).reshape(1)

        def keep(old, new):
            return torch.where(done, old, new.to(old.dtype))

        def written(buf, val):
            return buf.index_copy(0, ti, keep(buf.index_select(0, ti),
                                              val[None]))

        return {
            "mems": {n: keep(v, new_mems[n]) for n, v in st["mems"].items()},
            "words": keep(st["words"], word),
            "scores": keep(st["scores"], top_scores),
            "finished": keep(st["finished"], new_fin),
            "t": st["t"] + (~done).to(torch.int64),
            "stop": keep(st["stop"], stop),
            "ws": written(st["ws"], word),
            "ps": written(st["ps"], parent),
        }

    def _chunk(self, params, static_feed, st: dict, b: int, n: int) -> dict:
        """n guarded substeps: one dispatch unit (a CUDA graph on the
        card), with no host read inside."""
        for _ in range(n):
            st = self._substep(params, static_feed, st, b)
        return st

    def _finish(self, ws, ps, b: int):
        """Backtrace the beams' parents into sequences; a beam's length
        is the position of its first eos + 1 (else max_length)."""
        nxt = torch.arange(self.k, device=ws.device).expand(b, self.k)
        rev = []
        for t in range(self.max_length - 1, -1, -1):
            rev.append(torch.gather(ws[t], 1, nxt))
            nxt = torch.gather(ps[t], 1, nxt)
        seqs = torch.stack(rev[::-1], dim=-1).to(torch.int32)  # [B,K,T]
        is_eos = seqs == self.eos_id
        first_eos = torch.argmax(is_eos.to(torch.int32), dim=-1)
        lens = torch.where(is_eos.any(dim=-1), first_eos + 1,
                           self.max_length).to(torch.int32)
        return seqs, lens


class _DecodeProgram:
    """The decode of one cached configuration: hook-bearing substeps,
    or chunks of `k_tok` guarded substeps, run eagerly or replayed from
    CUDA graphs, one graph per (batch, static-feed signature)."""

    def __init__(self, dec: BeamSearchDecoder, hooks: BeamHooks,
                 k_tok: Optional[int] = None):
        self.dec = dec
        self.hooks = hooks
        self.k_tok = min(k_tok or dec.tokens_per_dispatch,
                         max(dec.max_length, 1))
        self.graphs: dict = {}
        self._g = None

    def begin(self, params, static_feed, init_carry_mem, b) -> dict:
        """The carry at t = 0: in a graph's static state where the chunks
        replay (hook-free, on a CUDA device, `use_graphs`), else fresh."""
        dec = self.dec
        dev = next(iter(params.values())).device
        self._g = None
        if self._graphed(dev):
            self._g = self._graph(params, static_feed, init_carry_mem, b)
            self._g.start(params, static_feed, init_carry_mem)
            return self._g.state
        return dec._init_state(init_carry_mem, b, dev)

    def _graphed(self, dev) -> bool:
        return (self.dec.use_graphs and not self.hooks.any
                and dev.type == "cuda")

    def chunk(self, params, static_feed, st: dict, b: int):
        """One chunk of guarded substeps, no host read: (the carry after
        it, the device flag `live` the host reads next)."""
        if self._g is not None:
            self._g.replay()
            return self._g.state, self._g.live
        st = self.dec._chunk(params, static_feed, st, b, self.k_tok)
        return st, ~self.dec._done(st)

    def run(self, params, static_feed, init_carry_mem, b):
        dec = self.dec
        wait = 0.0

        def read(x):
            # a host read of a device value: the time it blocks is the
            # device's
            nonlocal wait
            t1 = time.perf_counter()
            out = x.item()
            wait += time.perf_counter() - t1
            return out

        t0 = time.perf_counter()
        st = self.begin(params, static_feed, init_carry_mem, b)
        chunks = steps = 0
        live = dec.max_length > 0
        while live:
            if self.hooks.any:
                # one substep a token, `done` read on the host before
                # each: a done substep calls no hook
                for _ in range(self.k_tok):
                    if read(dec._done(st)):
                        break
                    st = dec._substep(params, static_feed, st, b,
                                      hooks=self.hooks, t_host=steps)
                    steps += 1
                live = not read(dec._done(st))
            else:
                st, flag = self.chunk(params, static_feed, st, b)
                live = read(flag)
            chunks += 1
        seqs, lens = dec._finish(st["ws"], st["ps"], b)
        scores = st["scores"].clone()
        dec.last_steps = read(st["t"])
        dec.last_chain_depth = chunks
        # the host's time issuing work (set-up, the chunks' launches or
        # replays, the backtrace) against its time blocked on the device
        # (the `done` reads and the final fetch)
        dec.last_timeline = {"dispatch_s": time.perf_counter() - t0 - wait,
                             "device_s": wait}
        return seqs, lens, scores

    def _graph(self, params, static_feed, mems, b) -> "_DecodeGraph":
        key = (b, feed_signature(static_feed), tuple(
            (n, tuple(v.shape), v.dtype) for n, v in sorted(mems.items())))
        g = self.graphs.get(key)
        if g is None:
            g = self.graphs[key] = _DecodeGraph(self, params, static_feed,
                                                mems, b)
        return g


class _DecodeGraph:
    """One captured chunk of K guarded substeps for one (batch, feed
    signature). Static inputs: the step net's parameters (the decoder's
    static tree, shared by its graphs), the tiled feed and the boot
    memories; static state: the carry the chunk advances in place, and
    `live`, the flag the host reads after each replay."""

    def __init__(self, prog: _DecodeProgram, params, static_feed, mems, b):
        dec = prog.dec
        self.prog, self.b = prog, b
        dev = next(iter(params.values())).device
        if dec._graph_pool is None:
            dec._graph_pool = torch.cuda.graph_pool_handle()
            dec._graph_stream = torch.cuda.Stream(device=dev)
        if dec._graph_params is None:
            dec._graph_params = {n: torch.empty_like(params[n])
                                 for n in dec._net.param_confs}
        self.feed = {n: _arg_map(torch.empty_like, a)
                     for n, a in static_feed.items()}
        self.mems0 = {n: torch.empty_like(v) for n, v in mems.items()}
        self.state = dec._init_state(self.mems0, b, dev)
        self.live = torch.zeros((), dtype=torch.bool, device=dev)
        self.graph = torch.cuda.CUDAGraph()
        self.captured = False

    def start(self, params, static_feed, mems) -> None:
        """Fill the static inputs and reset the carry to t = 0; the first
        start captures the graph."""
        dec = self.prog.dec
        with torch.no_grad():
            for n, dst in dec._graph_params.items():
                _fill(dst, params[n])
            for n, a in static_feed.items():
                for f in ARG_FIELDS:
                    src = getattr(a, f)
                    if src is not None:
                        _fill(getattr(self.feed[n], f), src)
            for n, v in mems.items():
                _fill(self.mems0[n], v)
            fresh = dec._init_state(self.mems0, self.b, self.live.device)
            self._write(fresh)
        if not self.captured:
            self.capture()

    def _write(self, st: dict) -> None:
        for f in ("words", "scores", "finished", "t", "stop", "ws", "ps"):
            self.state[f].copy_(st[f])
        for n, v in st["mems"].items():
            self.state["mems"][n].copy_(v)

    def _chunk(self, write_back: bool) -> None:
        dec = self.prog.dec
        st = dict(self.state, mems=dict(self.state["mems"]))
        st = dec._chunk(dec._graph_params, self.feed, st, self.b,
                        self.prog.k_tok)
        if write_back:
            self._write(st)
            self.live.copy_(~dec._done(st))

    def capture(self) -> None:
        dec = self.prog.dec
        side = dec._graph_stream
        side.wait_stream(torch.cuda.current_stream())
        with torch.cuda.stream(side):
            # warm-up outside the capture (library handles, workspaces);
            # its results are dropped, the carry stays at t = 0
            self._chunk(write_back=False)
        torch.cuda.current_stream().wait_stream(side)
        try:
            with no_gc(), torch.cuda.graph(self.graph, pool=dec._graph_pool,
                                           stream=side):
                self._chunk(write_back=True)
        except Exception as e:
            raise RuntimeError(
                f"capturing a decode chunk of {self.prog.k_tok} tokens in "
                f"a CUDA graph failed: {type(e).__name__}: {e}") from e
        self.captured = True

    def replay(self) -> None:
        self.graph.replay()
