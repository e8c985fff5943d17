"""Served-model wrappers: what the scheduler dispatches to —
`paddle_tpu/serving/models.py` on torch.

`GenerationModel` is beam-search generation over a `BeamSearchDecoder`.
Its device rung is the decoder's own `generate` (CUDA graphs of
K-token chunks on the card, `beam_search.py`); its host rung is
`host_decode.py` (per token when hooks are present, so hook-bearing
requests are served with their hooks as plain Python; per K-token chunk
when the decoder carries `tokens_per_dispatch` > 1), taken for a
request that names a hook or asks for the host. An optional `encode`
callable turns the packed source ids into the decoder's statics and
boots (the seq2seq encoder's forward). `tokens_per_dispatch` is part of
the server's dispatch-key accounting, as the length and batch buckets
are.

An optional speculative rung (`speculative=` a
`decoding.SpeculativeGreedyDecoder` over the served decoder, with
`draft_params` and an optional `draft_encode`) serves hook-free
requests that do not ask for the host draft-first, token for token
equal to the target's greedy output (path "spec"). It has no fallback:
a failing speculative decode raises, it never serves
`decoder.generate()` instead.

Ported: `GenerationModel` (`encode`, `named_hooks`,
`tokens_per_dispatch`, `can_host`, `run_batch`) (ROADMAP A3a) and its
speculative rung (ROADMAP A5). Left out: `MultiForwardHost`, which
needs `multi_network.merge_confs` (ROADMAP A6, A12).
"""

from __future__ import annotations

from typing import Callable, Dict, Optional

import numpy as np


class GenerationModel:
    """`decoder`: a BeamSearchDecoder (or a models.text factory's).
    `encode(ids [B,T] i32, lens [B] i32) -> (statics list[Arg], boots
    dict)` builds the decoder's conditioning; None means an
    unconditioned decoder (statics=[], batch_size=B). `named_hooks`
    maps wire-addressable hook names to BeamHooks: the TCP front end
    cannot ship callables, so a hook-bearing request names a hook the
    model registered when it was built."""

    can_host = True
    engine = None

    def __init__(self, decoder, params, encode: Optional[Callable] = None,
                 named_hooks: Optional[Dict] = None, speculative=None,
                 draft_params=None, draft_encode: Optional[Callable] = None):
        self.decoder = decoder
        self.params = params
        self.encode = encode
        self.named_hooks = named_hooks or {}
        self.speculative = speculative
        self.draft_params = draft_params
        self.draft_encode = draft_encode
        if speculative is not None:
            assert draft_params is not None, (
                "speculative serving needs draft_params"
            )
            assert speculative.target is decoder, (
                "speculative.target must be the served decoder — "
                "anything else would serve a different model's tokens"
            )

    @property
    def tokens_per_dispatch(self):
        """K of the decode's multi-token dispatch: part of the server's
        dispatch-key accounting (a K change is a new family of graphs,
        as a new length bucket is)."""
        return self.decoder.tokens_per_dispatch

    @property
    def recompile_guards(self):
        """Empty: the JAX decoder's guard tracks XLA retraces, which the
        port does not have (`analysis/recompile_guard.py` is not to
        port). A new (batch, feed signature) captures a new CUDA graph,
        counted on the decoder's programs (`_decode_cache[...].graphs`)."""
        return ()

    def run_batch(self, ids, lens, hooks, host: bool):
        from paddle_tpu_torch.serving.host_decode import host_generate

        dec = self.decoder
        b = ids.shape[0]
        if self.encode is not None:
            statics, boots = self.encode(ids, lens)
            bs = None
        else:
            statics, boots, bs = [], None, b
        if host or hooks is not None:
            seqs, out_lens, scores = host_generate(
                dec, self.params, statics=statics, boots=boots,
                batch_size=bs, hooks=hooks)
            path = "host"
        elif self.speculative is not None:
            if self.draft_encode is not None:
                d_statics, d_boots = self.draft_encode(ids, lens)
            else:
                d_statics, d_boots = None, None
            seqs, out_lens, scores = self.speculative.generate(
                self.params, self.draft_params, statics=statics,
                boots=boots, batch_size=bs, draft_statics=d_statics,
                draft_boots=d_boots)
            path = "spec"
        else:
            seqs, out_lens, scores = (
                x.cpu().numpy() for x in dec.generate(
                    self.params, statics=statics, boots=boots,
                    batch_size=bs))
            path = "jit"
        scores = np.asarray(scores, np.float32)
        rows = []
        for i in range(b):
            n = int(out_lens[i, 0])
            rows.append({
                "tokens": seqs[i, 0, :n].tolist(),
                "score": float(scores[i, 0]),
                "path": path,
            })
        return rows
