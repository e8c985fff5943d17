"""Multi-head attention layer: `paddle_tpu/layers/attention.py` on
torch. attrs:
  num_heads     — head count (must divide size)
  causal        — bool, autoregressive mask
  attn_impl     — "dense" (materializes [B,H,T,T] scores, the reference
                  path) | "flash" (the Hopper flash kernels forward and
                  backward on the card, their plain versions on the CPU;
                  parallel/ring.py::flash_dense_attention). Applies to
                  seq_parallel "none" and "ulysses" (the local per-head-
                  group attention); "ring" is flash-class by
                  construction.
  seq_parallel  — "none" | "ring" | "ulysses": ring and Ulysses split
                  the time dim over the `seq` axis of the mesh
                  `core/mesh.py::set_mesh` set (parallel/ring.py).
Inputs: one sequence Arg (self-attention) or (query, keyvalue).
"""

from __future__ import annotations

import torch

from paddle_tpu_torch.core.arg import Arg
from paddle_tpu_torch.core.mesh import get_mesh
from paddle_tpu_torch.core.registry import LAYERS
from paddle_tpu_torch.layers.base import Ctx, Layer, Spec
from paddle_tpu_torch.parallel import ring


@LAYERS.register("multi_head_attention", "attention")
class MultiHeadAttentionLayer(Layer):
    def build(self, in_specs):
        d = self.conf.size
        h = self.conf.attrs.get("num_heads", 1)
        assert d % h == 0, f"size {d} not divisible by num_heads {h}"
        mode = self.conf.attrs.get("seq_parallel", "none")
        if mode not in ("none", "ring", "ulysses"):
            raise ValueError(f"{self.name}: seq_parallel={mode!r}")
        sq = in_specs[0]
        skv = in_specs[-1]
        assert sq.is_seq and skv.is_seq, "attention needs sequence inputs"
        # distinct names per projection — weight_conf(idx) keys on the
        # input edge, which would alias all four for self-attention
        pcs = {}
        for slot, idx, dims in (
            ("wq", 0, (sq.size, d)),
            ("wk", len(in_specs) - 1, (skv.size, d)),
            ("wv", len(in_specs) - 1, (skv.size, d)),
            ("wo", 0, (d, d)),
        ):
            pc = self.weight_conf(idx, dims)
            pc.name = f"_{self.name}.{slot}"
            pcs[slot] = pc
        b = self.bias_conf((d,))
        if b is not None:
            pcs["b"] = b
        return Spec(dim=(d,), is_seq=True), pcs

    def forward(self, params, inputs, ctx: Ctx):
        qa = inputs[0]
        kva = inputs[-1]
        h = self.conf.attrs.get("num_heads", 1)
        causal = bool(self.conf.attrs.get("causal", False))
        d = self.conf.size
        hd = d // h

        def split_heads(x):
            return x.reshape(x.shape[0], x.shape[1], h, hd)

        q = split_heads(torch.matmul(qa.value, params["wq"]))
        k = split_heads(torch.matmul(kva.value, params["wk"]))
        v = split_heads(torch.matmul(kva.value, params["wv"]))
        mode = self.conf.attrs.get("seq_parallel", "none")
        impl = self.conf.attrs.get("attn_impl", "dense")
        if mode == "ring":
            out = ring.ring_attention(q, k, v, get_mesh(), causal=causal,
                                      kv_lens=kva.seq_lens)
        elif mode == "ulysses":
            out = ring.ulysses_attention(q, k, v, get_mesh(), causal=causal,
                                         kv_lens=kva.seq_lens,
                                         attn_impl=impl)
        elif impl == "flash":
            out = ring.flash_dense_attention(
                q, k, v, causal=causal, kv_len=kva.seq_lens,
                # cross-attention masks query padding on its own; in
                # self-attention padded query rows see the valid keys
                # and are zeroed below
                q_len=qa.seq_lens if qa is not kva else None,
            )
        else:
            out = ring.dense_attention(q, k, v, causal=causal,
                                       kv_len=kva.seq_lens)
        out = out.reshape(out.shape[0], out.shape[1], d)
        y = torch.matmul(out, params["wo"])
        if "b" in params:
            y = y + params["b"]
        y = self.apply_activation_and_dropout(y, ctx, qa.seq_lens)
        # zero padded query positions so downstream seq reductions stay
        # exact
        if qa.seq_lens is not None:
            y = torch.where(qa.bool_mask()[..., None], y, 0.0)
        return Arg(value=y, seq_lens=qa.seq_lens)
