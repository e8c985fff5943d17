"""Speculative greedy decoding: `paddle_tpu/decoding/speculative.py` on
torch (ROADMAP A5).

Leviathan et al.'s draft-proposes / target-verifies scheme, greedy
variant: a small draft model proposes n tokens autoregressively, then
the target model verifies all n positions (every position's input is
already known, so its n steps need no host round trip between them).
The host accepts the longest agreeing prefix plus the target's one
corrected token, so every round emits >= 1 token for 2 dispatches and
the OUTPUT IS EXACTLY THE TARGET'S GREEDY OUTPUT, token for token, no
matter how bad the draft is (a worthless draft only costs speed).

The JAX package compiles each side's n steps into one scan program.
Here each side runs n eager substeps of its step net (`_substeps`),
whose greedy tokens, log-probs and memories are stacked into [n, B,
...] tensors on the device; the host fetches the tokens and log-probs
once a round, and the roll of both nets' memories to each row's
accepted prefix is a gather on the device. `last_chain_depth` counts
the dispatches the JAX programs count (2 a round), not kernel
launches.

Per-round bookkeeping is numpy on the host: rows advance at different
rates.

Both nets are plain `BeamSearchDecoder`s with beam_size=1 —
`make_draft_decoder` builds one from the same DSL layer inventory the
target uses.

Caveat: a `logprob_fn` must be position-independent (ignore its `t`
argument) to compose with speculative decoding — rows progress at
per-row rates, while one round stamps a single base `t0` (here
`logprob_fn(logp [B, 1, V] f32 tensor, t 0-d int64 tensor)`, with
t = t0 + j at substep j, as the port's decoder calls it).

Ported: `make_draft_decoder`, `SpeculativeGreedyDecoder` (`generate`,
`last_chain_depth`, `last_steps`, `last_accept_rate`,
`recompile_guards`). The recompile guard (label "spec_decode") notes
the first sight of each scan-program key the JAX decoder compiles —
(role, B, n, self_feed, logprob_fn, eos_id), at most 16 kept, the
oldest dropped first — with the static feed and memories.
"""

from __future__ import annotations

from typing import Callable, Optional

import numpy as np
import torch

from paddle_tpu_torch.analysis.recompile_guard import RecompileGuard
from paddle_tpu_torch.core.arg import Arg


def make_draft_decoder(step: Callable, n_static: int, bos_id: int,
                       eos_id: int, max_length: int,
                       logprob_fn: Optional[Callable] = None,
                       static_sizes: Optional[list] = None):
    """Build a draft model from the existing DSL layer inventory: the
    same `step(word, *statics)` authoring contract as the target
    decoder, forced to beam_size=1 (speculative verification is
    greedy). Keep the draft's layer/param NAMES distinct from the
    target's — the two nets carry separate param dicts."""
    from paddle_tpu_torch.beam_search import BeamSearchDecoder

    return BeamSearchDecoder(
        step, n_static, bos_id=bos_id, eos_id=eos_id, beam_size=1,
        max_length=max_length, logprob_fn=logprob_fn,
        static_sizes=static_sizes,
    )


class SpeculativeGreedyDecoder:
    """Draft/target speculative wrapper around two beam_size=1
    decoders.

        spec = SpeculativeGreedyDecoder(target_dec, draft_dec,
                                        propose_k=4)
        seqs, lens, scores = spec.generate(params, draft_params,
                                           statics=[...], boots={...})

    Outputs match `target_dec.generate(...)` (greedy reference)
    token-for-token; shapes are the decoder's [B, 1, max_length] /
    [B, 1] contract, as numpy, so the serving batcher can swap it in
    unchanged.
    """

    def __init__(self, target, draft, propose_k: int = 4):
        assert target.k == 1 and draft.k == 1, (
            "speculative decoding verifies greedily: both target and "
            f"draft need beam_size=1 (got {target.k}/{draft.k})"
        )
        assert propose_k >= 1
        assert target.bos_id == draft.bos_id, "bos_id mismatch"
        assert target.eos_id == draft.eos_id, "eos_id mismatch"
        self.target, self.draft = target, draft
        self.propose_k = int(propose_k)
        # measured diagnostics of the last generate(): sequential
        # dispatches issued, the steps, and the proposal accept rate
        self.last_chain_depth: Optional[int] = None
        self.last_steps: Optional[int] = None
        self.last_accept_rate: Optional[float] = None
        self._recompile_guard = RecompileGuard("spec_decode")

    @property
    def recompile_guards(self):
        return [self._recompile_guard]

    def _note(self, role: str, dec, static_feed, mems, b: int, n: int,
              self_feed: bool) -> None:
        """The first sight of a scan-program key of the JAX decoder."""
        self._recompile_guard.note_once(
            (role, b, n, self_feed, dec.logprob_fn, dec.eos_id), static_feed,
            mems, limit=16, b=b, n=n, role=role)

    @staticmethod
    def _substeps(dec, params, static_feed, mems, first_word, words,
                  t0: int, n: int, self_feed: bool):
        """n decode steps of `dec`'s step net: (greedy [n, B],
        greedy_logp [n, B], mems_stack {name: [n, B, size]}) on the
        device.

        self_feed=True (draft propose): each step consumes the previous
        step's own argmax, starting from first_word. False (target
        verify): step j consumes words[j] — all inputs known up front."""
        net, out_name, lpf = dec._net, dec.out_name, dec.logprob_fn
        b = first_word.shape[0]
        word = first_word
        gs, glps = [], []
        stack = {m["layer"]: [] for m in dec.memories}
        for j in range(n):
            w = word if self_feed else words[j]
            feed = dict(static_feed)
            feed["@word"] = Arg(ids=w)
            for m in dec.memories:
                feed[m["link"]] = Arg(value=mems[m["layer"]])
            outs, _ = net.forward(params, feed, train=False)
            prob = outs[out_name].value  # [B, V]
            # f32 score math whatever the matmul precision
            logp = torch.log(torch.clamp_min(prob, 1e-20)).reshape(
                b, 1, -1).float()
            if lpf is not None:
                logp = lpf(logp, torch.tensor(t0 + j, dtype=torch.int64,
                                              device=logp.device))
            logp = logp[:, 0, :]
            # argmax picks the first max — the same lower-index
            # tie-break as lax.top_k(k=1)
            word = torch.argmax(logp, dim=-1)
            gs.append(word)
            glps.append(torch.max(logp, dim=-1).values)
            mems = {m["layer"]: outs[m["layer"]].value for m in dec.memories}
            for name, v in mems.items():
                stack[name].append(v)
        return (torch.stack(gs), torch.stack(glps),
                {name: torch.stack(v) for name, v in stack.items()})

    @torch.no_grad()
    def generate(self, params: dict, draft_params: dict,
                 statics: list = None, boots: dict = None,
                 batch_size: int = None, draft_statics: list = None,
                 draft_boots: dict = None):
        """Greedy-decode with draft/target speculation. `params` /
        `statics` / `boots` condition the target exactly like
        `target.generate`; the draft gets its own param dict and
        (optionally) its own conditioning. Returns (seqs [B, 1,
        max_length] int32, lens [B, 1] int32, scores [B, 1] float32) as
        numpy — token-for-token the target's greedy output."""
        tgt, drf, kp = self.target, self.draft, self.propose_k
        t_max, eos, bos = tgt.max_length, tgt.eos_id, tgt.bos_id
        dev = next(iter(params.values())).device
        t_feed, t_mems, b = tgt.prepare(statics or [], boots, batch_size,
                                        device=dev)
        d_feed, d_mems, _ = drf.prepare(draft_statics or [], draft_boots,
                                        batch_size=b, device=dev)

        seqs = np.full((b, 1, t_max), eos, np.int32)
        scores = np.zeros((b,), np.float32)
        last = np.full((b,), bos, np.int32)
        pos = np.zeros((b,), np.int64)
        finished = np.zeros((b,), bool)
        rows = np.arange(b)
        rows_d = torch.arange(b, device=dev)
        dispatches = proposed = accepted = 0

        while not finished.all():
            base = int(pos[~finished].min())
            n = min(kp, t_max - base)
            last_d = torch.as_tensor(last, dtype=torch.long, device=dev)
            # the draft proposes n tokens autoregressively
            self._note("draft", drf, d_feed, d_mems, b, n, True)
            props, _, d_stack = self._substeps(
                drf, draft_params, d_feed, d_mems, last_d, None, base, n,
                True)
            dispatches += 1
            # the target verifies all n positions — position j consumes
            # [last, props[:-1]][j]
            vwords = torch.cat([last_d[None, :], props[:-1]], 0)
            self._note("target", tgt, t_feed, t_mems, b, n, False)
            gs, glps, t_stack = self._substeps(
                tgt, params, t_feed, t_mems, last_d, vwords, base, n,
                False)
            dispatches += 1
            props_np = props.cpu().numpy()  # [n, B]
            gs = gs.cpu().numpy()           # [n, B] the target's greedy
            glps = glps.cpu().numpy()

            # host accept: longest agreeing prefix + the target's one
            # corrected token. Since agreed positions have g == p, the
            # accepted tokens are exactly gs[:n_acc] — the target's
            # own greedy continuation.
            agree = gs == props_np
            live = ~finished
            proposed += n * int(live.sum())
            roll_idx = np.zeros((b,), np.int64)
            for r in rows[live]:
                mism = np.nonzero(~agree[:, r])[0]
                n_acc = int(mism[0]) + 1 if mism.size else n
                roll_idx[r] = n_acc - 1
                n_app = min(n_acc, t_max - int(pos[r]))
                toks = gs[:n_app, r]
                hit = np.nonzero(toks == eos)[0]
                if hit.size:
                    n_app = int(hit[0]) + 1
                    toks = toks[:n_app]
                    finished[r] = True
                seqs[r, 0, pos[r]:pos[r] + n_app] = toks
                scores[r] += glps[:n_app, r].sum()
                pos[r] += n_app
                accepted += n_app
                if pos[r] >= t_max:
                    finished[r] = True
                last[r] = toks[-1]
            # roll both nets' states to the per-row accepted prefix:
            # stack index i holds the state after consuming
            # [last, props[:i]] — identical feeds on both nets, so the
            # same index applies to each
            roll = torch.as_tensor(roll_idx, device=dev)
            t_mems = {name: st[roll, rows_d] for name, st in t_stack.items()}
            d_mems = {name: st[roll, rows_d] for name, st in d_stack.items()}

        self.last_chain_depth = dispatches
        self.last_steps = int(pos.max())
        self.last_accept_rate = (
            accepted / proposed if proposed else None
        )

        is_eos = seqs == eos
        any_eos = np.any(is_eos, axis=-1)
        first_eos = np.argmax(is_eos, axis=-1)
        lens = np.where(any_eos, first_eos + 1, t_max).astype(np.int32)
        return seqs, lens, scores[:, None].copy()
