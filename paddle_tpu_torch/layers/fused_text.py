"""The attention decoder's recurrence as one layer:
`paddle_tpu/layers/fused_text.py` on torch.

`seq2seq_attention(fused_decoder=True)` runs the decoder this way; the
generic arm runs the same step net through `recurrent_group`. The math
is the unfused step's (additive attention over the encoder, then a tanh
fc of the target embedding, the previous state and the context), with
the loop-invariant work hoisted out of the loop over time and the two
products of the previous state merged:

- the input projection emb_t @ W0 + b runs once for all steps, one
  [B*T, E] @ [E, H] GEMM (teacher forcing gives every target embedding
  up front);
- the context projection moves across the attention sum by linearity:
  ctx @ W2 = sum_j a_j (enc_j @ W2), so enc @ W2 is computed once and
  the step's [B, H] @ [H, H] product goes;
- the attention query (`_att_dec_proj`) and the cell's recurrence
  (`_dec_state.w1`) are one [B, H] @ [H, 2H] GEMM a step.

The parameter names and shapes are the unfused graph's
(`_dec_state.w0/w1/w2/wbias`, `_att_dec_proj.w0`, `_att_score.w0`), so
the generation decoder (`models/text.py::seq2seq_attention_decoder`,
which runs the unfused step) takes the trained weights as they are.
The backward is autograd over these ops. Ported whole (ROADMAP A3a):
the products stay `torch.matmul`, as no TPU kernel runs them.
"""

from __future__ import annotations

import torch

from paddle_tpu_torch.core.arg import Arg
from paddle_tpu_torch.core.config import ParameterConf
from paddle_tpu_torch.core.registry import LAYERS
from paddle_tpu_torch.layers.base import Layer, Spec
from paddle_tpu_torch.ops.sequence_ops import NEG_INF


@LAYERS.register("fused_att_decoder")
class FusedAttDecoderLayer(Layer):
    """inputs: [trg_emb (B,T,E) seq, enc (B,S,H) seq, boot (B,H)];
    output: the decoder states (B,T,H) seq (the projection to the
    vocabulary runs outside, as in seq2seq_attention)."""

    def build(self, in_specs):
        se, sc, sb = in_specs
        h = self.conf.size or sc.size
        assert sc.size == h and sb.size == h, (
            f"fused_att_decoder: enc/boot width must equal size={h}, "
            f"got {sc.size}/{sb.size}")
        e = se.size
        prefix = self.conf.attrs.get("param_prefix", "dec_state")
        att = self.conf.attrs.get("att_prefix", "att")

        def pc(name, dims):
            return ParameterConf(name=name, dims=tuple(dims))

        pcs = {
            "w_emb": pc(f"_{prefix}.w0", (e, h)),
            "w_prev": pc(f"_{prefix}.w1", (h, h)),
            "w_ctx": pc(f"_{prefix}.w2", (h, h)),
            "w_att": pc(f"_{att}_dec_proj.w0", (h, h)),
            "v": pc(f"_{att}_score.w0", (h, 1)),
        }
        if self.conf.bias:
            pcs["b"] = pc(f"_{prefix}.wbias", (h,))
        self._h = h
        return Spec(dim=(h,), is_seq=True), pcs

    def forward(self, params, inputs, ctx):
        emb, enc, boot = inputs
        h = self._h
        x, encv = emb.value, enc.value  # [B,T,E], [B,S,H]
        # hoisted: the input projection of every step, one GEMM
        xp = torch.matmul(x, params["w_emb"])
        if "b" in params:
            xp = xp + params["b"]
        # hoisted: the context projection, moved across the attention sum
        enc_w2 = torch.matmul(encv, params["w_ctx"])
        # one merged product of the previous state: [cell | query]
        wp = torch.cat([params["w_prev"], params["w_att"]], dim=1)
        v = params["v"][:, 0]
        smask = (enc.bool_mask() if enc.seq_lens is not None
                 else torch.ones(encv.shape[:2], dtype=torch.bool,
                                 device=encv.device))
        prev, ys = boot.value, []
        for t in range(x.shape[1]):
            ph = torch.matmul(prev, wp)  # [B, 2H]
            e = torch.matmul(torch.tanh(encv + ph[:, None, h:]), v)
            e = torch.where(smask, e, torch.full_like(e, NEG_INF))
            a = torch.softmax(e, dim=-1)
            ctx_w2 = torch.matmul(a[:, None, :], enc_w2)[:, 0]
            prev = torch.tanh(xp[:, t] + ph[:, :h] + ctx_w2)
            ys.append(prev)
        return Arg(value=torch.stack(ys, dim=1), seq_lens=emb.seq_lens)
