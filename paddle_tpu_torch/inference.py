"""Inference API: the JAX package's `inference.py` front door on the
port (reference: python/paddle/v2/inference.py:9,93 — `Inference`
wrapping the network in test mode, module-level `infer(output=...,
input=...)`). The runner is `trainer.trainer.Inferencer`; a merged
model loads through `Inferencer.from_merged`.

Not ported: `export_compiled` / `load_compiled` (a serialized StableHLO
program) and the verified program cache (`store_verified` /
`load_verified`): both are XLA programs, with no counterpart here.
"""

from __future__ import annotations

import torch

from paddle_tpu_torch.core.arg import Arg
from paddle_tpu_torch.trainer.trainer import Inferencer

Inference = Inferencer  # v2 name

__all__ = ["Inference", "Inferencer", "infer"]


def infer(output=None, parameters=None, input=None, network=None,
          feeder=None, device=None):
    """One-shot inference (v2/inference.py:93 infer()). `input` is a
    feed dict of Args (or raw arrays, wrapped as dense Args; use
    `feeder` for sequence/ids packing). Returns one ndarray for a
    single output, else a list in `output` order. Runs on the card
    unless `device="cpu"`."""
    outs = (
        None
        if output is None
        else [output] if isinstance(output, str) else list(output)
    )
    inf = Inferencer(network, parameters, outputs=outs, device=device)
    outs = inf.output_names
    feed = feeder(input) if feeder is not None else input
    feed = {
        k: (v if isinstance(v, Arg) else Arg(value=torch.as_tensor(v)))
        for k, v in feed.items()
    }
    res = inf.infer(feed)
    vals = [res[n] for n in outs]
    return vals[0] if len(vals) == 1 else vals
