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

`MultiForwardHost` co-dispatches several single-ids-input scorers in
one forward: their confs are merged (`multi_network.merge_confs`) into
one `Network`, each submodel is served through its `sub(name)` face,
and the server's co-dispatch (`server.py`) pulls sibling batches into
one `run_group`. The merged forward runs the port's `Network` eagerly
under `torch.no_grad()` (the LSTM layers launch B5's inference form on
the card); no program cache is keyed by shape, but its recompile guard
("serve_forward") notes the first sight of each feed signature, where
the JAX host's jitted forward traces, so a server armed after warmup
sees a cold bucket.

Every model answers `recompile_guards` with the guards of what it runs
(`analysis/recompile_guard.py`), which `InferenceServer.
arm_recompile_guard` arms.
"""

from __future__ import annotations

from typing import Callable, Dict, Optional

import numpy as np
import torch

from paddle_tpu_torch.analysis.recompile_guard import RecompileGuard
from paddle_tpu_torch.parallel.dp import feed_signature


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
        """The decoder's recompile guard (`beam_search.py`: a new (batch,
        feed signature) is noted, and on the card captures a new CUDA
        graph), and the speculative rung's, surfaced so
        InferenceServer.arm_recompile_guard can arm every served model's
        guards after warmup."""
        out = (self.decoder._recompile_guard,)
        if self.speculative is not None:
            out = out + tuple(self.speculative.recompile_guards)
        return out

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


class _ForwardSub:
    """One submodel's face toward the server: run_batch packs this
    submodel alone; the scheduler upgrades to run_group when siblings
    have pending work."""

    can_host = False

    def __init__(self, host: "MultiForwardHost", name: str):
        self.engine = host
        self.name = name
        self.named_hooks = {}

    @property
    def recompile_guards(self):
        return self.engine.recompile_guards

    def run_batch(self, ids, lens, hooks, host: bool):
        out = self.engine.run_group({self.name: (ids, lens)})
        return out[self.name]


class MultiForwardHost:
    """confs: {name: ModelConf}; every submodel is a single-ids-input
    scorer (data layer `input_name`, output layer `output_name`).
    Parameters with explicit shared names alias across submodels
    exactly as MultiNetwork shared them. `params` (a trained merged
    dict) or `init_params` from `generator` provides the weights for
    the MERGED conf. Runs on the card unless `device="cpu"`."""

    def __init__(self, confs: Dict[str, object], params=None,
                 input_names: Dict[str, str] = None,
                 output_names: Dict[str, str] = None,
                 generator: Optional[torch.Generator] = None,
                 device=None):
        from paddle_tpu_torch.core.device import resolve_device
        from paddle_tpu_torch.multi_network import merge_confs
        from paddle_tpu_torch.network import Network

        self.device = resolve_device(device)
        self.confs = dict(confs)
        self.names = tuple(self.confs)
        self.input_names = input_names or {}
        self.output_names = output_names or {}
        self.merged = merge_confs(self.confs)
        self.net = Network(self.merged)
        if params is None:
            if generator is None:
                raise ValueError(
                    "MultiForwardHost needs params or a torch.Generator "
                    "to draw them from")
            params = self.net.init_params(generator, device=self.device)
        self.params = params
        # the merged forward's guard: the first sight of each (output
        # set, feed signature), where the JAX host's jitted forward
        # traces
        self._recompile_guard = RecompileGuard("serve_forward")

    @property
    def recompile_guards(self):
        return (self._recompile_guard,)

    def sub(self, name: str) -> _ForwardSub:
        assert name in self.confs, name
        return _ForwardSub(self, name)

    def _io(self, name):
        conf = self.confs[name]
        inp = self.input_names.get(name) or next(
            lc.name for lc in conf.layers if lc.type == "data"
        )
        out = self.output_names.get(name) or (
            conf.output_layer_names[-1] if conf.output_layer_names
            else conf.layers[-1].name
        )
        return inp, out

    def run_group(self, packed: Dict[str, tuple]) -> Dict[str, list]:
        """packed: {name: (ids [B,T] i32, lens [B] i32)} for the models
        with pending work. Absent submodels get a 1-row zero feed (the
        merged network needs every data layer); their outputs are
        discarded. One merged forward serves every present model."""
        from paddle_tpu_torch.core.arg import Arg
        from paddle_tpu_torch.multi_network import prefix_feed

        dev = self.device
        feed = {}
        want = []
        for name in self.names:
            inp, out = self._io(name)
            if name in packed:
                ids, lens = packed[name]
                sub_feed = {inp: Arg(
                    ids=torch.as_tensor(np.asarray(ids, np.int32),
                                        device=dev),
                    seq_lens=torch.as_tensor(np.asarray(lens, np.int32),
                                             device=dev),
                )}
            else:
                sub_feed = {inp: Arg(
                    ids=torch.zeros((1, 1), dtype=torch.int32, device=dev),
                    seq_lens=torch.ones((1,), dtype=torch.int32,
                                        device=dev),
                )}
            feed.update(prefix_feed(name, sub_feed))
            want.append(f"{name}/{out}")
        self._recompile_guard.note_once(
            (tuple(want), feed_signature(feed)), feed)
        with torch.no_grad():
            outs, _ = self.net.forward(self.params, feed, outputs=want,
                                       train=False)
        results = {}
        for name in packed:
            _, out = self._io(name)
            val = outs[f"{name}/{out}"].value.float().cpu().numpy()
            results[name] = [
                {"scores": val[i].ravel().tolist(), "path": "device"}
                for i in range(val.shape[0])
            ]
        return results
