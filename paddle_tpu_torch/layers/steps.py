"""Single-step recurrent cells for custom recurrences inside groups:
`paddle_tpu/layers/steps.py` on torch.

`gru_step` and `lstm_step` are the cell math of the GRU and LSTM
sequence layers (`layers/recurrent.py`) for one timestep, so that a
recurrent_group step net can build its own recurrence (the seqToseq
demo's decoder). Their parameter layouts are the sequence layers', so
weights transfer. `lstm_step` emits its cell state as the extra output
`<name>@state` (the Network's extra outputs).

Ported whole (ROADMAP A3a); plain tensor ops, no kernels: a step's
products are [B, h] @ [h, 2h..4h] GEMMs.
"""

from __future__ import annotations

import torch

from paddle_tpu_torch.core.arg import Arg
from paddle_tpu_torch.core.registry import LAYERS
from paddle_tpu_torch.layers.base import Layer, Spec
from paddle_tpu_torch.ops import activations


@LAYERS.register("gru_step", "gru_step_naive")
class GruStepLayer(Layer):
    """inputs: [xg (B, 3h: update|reset|candidate pre-projection),
    prev_out (B, h)]; output h_t (GruStepLayer.cpp)."""

    def build(self, in_specs):
        sx, sp = in_specs
        h = self.conf.size or sp.size
        assert sx.size == 3 * h, (
            f"gru_step input must be 3*size, got {sx.size} vs h={h}")
        pcs = {"w0": self.weight_conf(0, (h, 2 * h)),
               "w_c": self.weight_conf(0, (h, h))}
        pcs["w_c"].name = f"_{self.name}.wc"
        b = self.bias_conf((3 * h,))
        if b is not None:
            pcs["b"] = b
        self._h = h
        return Spec(dim=(h,)), pcs

    def forward(self, params, inputs, ctx):
        xg, prev = inputs
        h = self._h
        act = activations.get(self.conf.active_type or "tanh")
        gate_act = activations.get(
            self.conf.attrs.get("active_gate_type", "sigmoid"))
        x, p = xg.value, prev.value
        b = params["b"] if "b" in params else x.new_zeros(3 * h)
        gur = torch.matmul(p, params["w0"])  # [B, 2h]
        u = gate_act(x[:, :h] + gur[:, :h] + b[:h])
        r = gate_act(x[:, h:2 * h] + gur[:, h:] + b[h:2 * h])
        c = act(x[:, 2 * h:] + torch.matmul(r * p, params["w_c"])
                + b[2 * h:])
        return Arg(value=u * p + (1.0 - u) * c)


@LAYERS.register("lstm_step")
class LstmStepLayer(Layer):
    """inputs: [x4 (B, 4h gate pre-projection), prev_h (B, h), prev_c
    (B, h)]; output h_t, extra output `<name>@state` = c_t
    (LstmStepLayer.cpp; the cell math of LstmLayer)."""

    def build(self, in_specs):
        sx = in_specs[0]
        h = self.conf.size or in_specs[1].size
        assert sx.size == 4 * h, (
            f"lstm_step input must be 4*size, got {sx.size} vs h={h}")
        pcs = {"w0": self.weight_conf(0, (h, 4 * h))}
        b = self.bias_conf((7 * h,))  # 4h gate biases + 3h peepholes
        if b is not None:
            pcs["b"] = b
        self._h = h
        return Spec(dim=(h,)), pcs

    def extra_output_specs(self):
        return {f"{self.name}@state": Spec(dim=(self._h,))}

    def forward(self, params, inputs, ctx):
        x4, prev_h, prev_c = inputs
        h = self._h
        act = activations.get(self.conf.active_type or "tanh")
        gate_act = activations.get(
            self.conf.attrs.get("active_gate_type", "sigmoid"))
        state_act = activations.get(
            self.conf.attrs.get("active_state_type", "tanh"))
        b = (params["b"] if "b" in params
             else x4.value.new_zeros(7 * h))
        gb, wci, wcf, wco = torch.split(b, [4 * h, h, h, h])
        g = x4.value + torch.matmul(prev_h.value, params["w0"]) + gb
        gi, gf, gg, go = torch.split(g, h, dim=-1)
        c_prev = prev_c.value
        i = gate_act(gi + wci * c_prev)
        f = gate_act(gf + wcf * c_prev)
        c = f * c_prev + i * act(gg)
        o = gate_act(go + wco * c)
        self._extra_outs = {f"{self.name}@state": Arg(value=c)}
        return Arg(value=o * state_act(c))
