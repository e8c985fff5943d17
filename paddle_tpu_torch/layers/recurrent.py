"""Recurrent layers: simple RNN, LSTM and GRU over packed [B,T,*]
batches — `paddle_tpu/layers/recurrent.py` on torch.

Variable lengths are handled by masked state carry: at a padded
timestep the hidden/cell state carries through unchanged and the
output is zeroed (the SequenceToBatch contract). The input projection
x @ W (size -> 4h / 3h) is done by the preceding layer, as in the
reference; here only the recurrent product h @ W_rec runs. Gate order:
LSTM [i, f, g, o], GRU [u, r, c]; the LSTM bias holds 4h gate biases
and 3h peepholes (Wci, Wcf, Wco), 7h in all.

Two paths, chosen by the `use_pallas_rnn` flag (its JAX name, so a
script that sets it works in both packages):

- the sequence kernels (`ops/rnn.py`: `lstm_fused`, `gru_fused`; the
  hand-written B5-B8 on a CUDA tensor, their plain versions on a CPU
  one), for the default activations only;
- the generic masked scan (`_scan_rnn`), a Python loop over time that
  autograd differentiates.

The policy differs from the JAX layer's. There `None` means the scan
everywhere: the TPU kernels lost to XLA's scan in the v5e A/Bs and were
retired. Those measurements do not carry over to an H100, where the
scan is one small kernel launch per op per step; here `None` takes the
kernels for a CUDA input with the default activations (the accelerator
rule of `pallas_rnn.use_fused_default`) and the scan for a CPU input.
`True` takes the kernels' path on either device; `False` always takes
the scan, the A/B arm of the chip smoke.

`mdlstm` (the 2-D multi-dimensional LSTM) walks its grid by
anti-diagonals: every cell of one anti-diagonal depends only on cells
of the one before, so gh + gw - 1 steps replace the JAX layer's gh x gw
(a row scan around a column scan); it has no kernel of its own.
"""

from __future__ import annotations

import torch

from paddle_tpu_torch.core import flags as _flags
from paddle_tpu_torch.core.arg import Arg
from paddle_tpu_torch.core.registry import LAYERS
from paddle_tpu_torch.layers.base import Layer, Spec
from paddle_tpu_torch.ops import activations
from paddle_tpu_torch.ops import rnn
from paddle_tpu_torch.ops import sequence_ops as sops


def _use_kernels(x: torch.Tensor) -> bool:
    v = _flags.get_flag("use_pallas_rnn")
    if v is None:
        return x.device.type == "cuda"
    return bool(v)


def _scan_rnn(step, x_btd, seq_lens, init_carry, reverse=False):
    """Run `step(carry, x_t) -> (carry, y_t)` over time with masked
    carry; the carry is a tensor or a tuple of them. x_btd: [B,T,D].
    Returns y: [B,T,H]."""
    if reverse:
        x_btd = sops.reverse_seq(x_btd, seq_lens)
    mask = sops._mask(seq_lens, x_btd.shape[1], x_btd.dtype)
    carry, ys = init_carry, []
    for t in range(x_btd.shape[1]):
        new_carry, y_t = step(carry, x_btd[:, t])
        m = mask[:, t, None]
        if isinstance(carry, tuple):
            carry = tuple(m * n + (1.0 - m) * o
                          for n, o in zip(new_carry, carry))
        else:
            carry = m * new_carry + (1.0 - m) * carry
        ys.append(y_t * m)
    y = torch.stack(ys, dim=1)
    if reverse:
        y = sops.reverse_seq(y, seq_lens)
    return y


def _kernel_seq(fn, arg: Arg, reverse: bool, *weights):
    """A sequence kernel over arg, reversed per sequence when asked."""
    x = arg.value
    if reverse:
        x = sops.reverse_seq(x, arg.seq_lens)
    y = fn(x, *weights, arg.seq_lens)
    if reverse:
        y = sops.reverse_seq(y, arg.seq_lens)
    return Arg(value=y, seq_lens=arg.seq_lens)


@LAYERS.register("recurrent")
class RecurrentLayer(Layer):
    """h_t = act(x_t + h_{t-1} @ W) (gserver/layers/RecurrentLayer.cpp).
    attrs: reversed."""

    def build(self, in_specs):
        (s,) = in_specs
        h = self.conf.size
        if not h:
            h = self.conf.size = s.size
        assert s.size == h, "recurrent layer input must equal size"
        pcs = {"w0": self.weight_conf(0, (h, h))}
        b = self.bias_conf((h,))
        if b is not None:
            pcs["b"] = b
        return Spec(dim=(h,), is_seq=True), pcs

    def forward(self, params, inputs, ctx):
        (arg,) = inputs
        act = self.activation() if self.conf.active_type else torch.tanh
        w = params["w0"]
        b = params.get("b", 0.0)

        def step(h_prev, x_t):
            h = act(x_t + h_prev @ w + b)
            return h, h

        h0 = arg.value.new_zeros((arg.value.shape[0], self.conf.size))
        y = _scan_rnn(step, arg.value, arg.seq_lens, h0,
                      self.conf.attrs.get("reversed", False))
        return Arg(value=y, seq_lens=arg.seq_lens)


@LAYERS.register("lstmemory", "lstm")
class LstmLayer(Layer):
    """LSTM with peepholes (gserver/layers/LstmLayer.cpp). Input
    [B,T,4h] pre-projected. Params: W_rec [h,4h], bias [7h] = gate
    biases [4h] + peepholes Wci/Wcf/Wco [3h]. attrs: reversed,
    active_gate_type (sigmoid), active_state_type (tanh);
    conf.active_type is the candidate/output activation (tanh)."""

    def build(self, in_specs):
        (s,) = in_specs
        h = self.conf.size
        assert s.size == 4 * h, f"lstmemory input must be 4*size, got {s.size}"
        pcs = {"w0": self.weight_conf(0, (h, 4 * h))}
        b = self.bias_conf((7 * h,))
        if b is not None:
            pcs["b"] = b
        return Spec(dim=(h,), is_seq=True), pcs

    def forward(self, params, inputs, ctx):
        (arg,) = inputs
        h = self.conf.size
        a = self.conf.attrs
        act_name = self.conf.active_type or "tanh"
        gate_name = a.get("active_gate_type", "sigmoid")
        state_name = a.get("active_state_type", "tanh")
        w = params["w0"]
        if "b" in params:
            gb, wci, wcf, wco = torch.split(params["b"], [4 * h, h, h, h])
        else:
            gb = arg.value.new_zeros(4 * h)
            wci = wcf = wco = arg.value.new_zeros(h)
        rev = a.get("reversed", False)
        default_acts = (act_name, gate_name, state_name) == (
            "tanh", "sigmoid", "tanh")
        if default_acts and _use_kernels(arg.value):
            return _kernel_seq(rnn.lstm_fused, arg, rev, w, gb, wci, wcf, wco)

        act = activations.get(act_name)
        gate_act = activations.get(gate_name)
        state_act = activations.get(state_name)

        def step(carry, x_t):
            h_prev, c_prev = carry
            g = x_t + h_prev @ w + gb
            gi, gf, gg, go = torch.split(g, h, dim=-1)
            i = gate_act(gi + wci * c_prev)
            f = gate_act(gf + wcf * c_prev)
            cand = act(gg)
            c = f * c_prev + i * cand
            o = gate_act(go + wco * c)
            out = o * state_act(c)
            return (out, c), out

        zeros = arg.value.new_zeros((arg.value.shape[0], h))
        y = _scan_rnn(step, arg.value, arg.seq_lens, (zeros, zeros), rev)
        return Arg(value=y, seq_lens=arg.seq_lens)


@LAYERS.register("gated_recurrent", "grumemory", "gru")
class GruLayer(Layer):
    """GRU (gserver/layers/GatedRecurrentLayer.cpp). Input [B,T,3h]
    pre-projected as [update, reset, candidate]; h_t = u * h_{t-1} +
    (1-u) * c_t. Params: w0 [h,2h] (update and reset), `_{name}.wc`
    [h,h] (candidate), bias [3h]. attrs: reversed, active_gate_type."""

    def build(self, in_specs):
        (s,) = in_specs
        h = self.conf.size
        assert s.size == 3 * h, f"grumemory input must be 3*size, got {s.size}"
        pcs = {"w0": self.weight_conf(0, (h, 2 * h)),
               "w_c": self.weight_conf(0, (h, h))}
        pcs["w_c"].name = f"_{self.name}.wc"
        b = self.bias_conf((3 * h,))
        if b is not None:
            pcs["b"] = b
        return Spec(dim=(h,), is_seq=True), pcs

    def forward(self, params, inputs, ctx):
        (arg,) = inputs
        h = self.conf.size
        act_name = self.conf.active_type or "tanh"
        gate_name = self.conf.attrs.get("active_gate_type", "sigmoid")
        w_g, w_c = params["w0"], params["w_c"]
        b = params["b"] if "b" in params else arg.value.new_zeros(3 * h)
        rev = self.conf.attrs.get("reversed", False)
        if (act_name, gate_name) == ("tanh", "sigmoid") and _use_kernels(
                arg.value):
            return _kernel_seq(rnn.gru_fused, arg, rev, w_g, w_c, b)

        act = activations.get(act_name)
        gate_act = activations.get(gate_name)

        def step(h_prev, x_t):
            xu, xr, xc = torch.split(x_t + b, h, dim=-1)
            gur = h_prev @ w_g
            u = gate_act(xu + gur[..., :h])
            r = gate_act(xr + gur[..., h:])
            c = act(xc + (r * h_prev) @ w_c)
            out = u * h_prev + (1.0 - u) * c
            return out, out

        h0 = arg.value.new_zeros((arg.value.shape[0], h))
        y = _scan_rnn(step, arg.value, arg.seq_lens, h0, rev)
        return Arg(value=y, seq_lens=arg.seq_lens)


@LAYERS.register("mdlstm", "mdlstmemory")
class MDLstmLayer(Layer):
    """2-D multi-dimensional LSTM (MDLstmLayer.cpp): each grid cell
    takes the hidden and cell states of its row and column
    predecessors, with one shared recurrent weight applied to the sum
    of the two hidden states and a forget gate per dimension.

    Input [B, H, W, 5h] pre-projected (gates [i | f_row | f_col | g |
    o]); output [B, H, W, h]. Missing neighbours at the grid's edges
    are zero states. attrs: directions = (bool, bool), True = ascending;
    active_gate_type / active_state_type as in lstmemory. Params: w0
    [h, 5h]; bias [5h gates + h wci + 2h wcf + h wco = 9h].

    The walk: step d computes the cells (i, d - i) of anti-diagonal d
    for every row i at once (cells off the grid are computed and
    zeroed), from step d-1's states: the top neighbour is row i-1 of
    step d-1, the left one row i."""

    def build(self, in_specs):
        (s,) = in_specs
        h = self.conf.size
        gh, gw, gc = s.dim
        assert gc == 5 * h, (
            f"mdlstm input must be (3+2)*size wide, got {gc} != {5 * h}")
        self._grid = (gh, gw)
        pcs = {"w0": self.weight_conf(0, (h, 5 * h))}
        b = self.bias_conf((9 * h,))
        if b is not None:
            pcs["b"] = b
        return Spec(dim=(gh, gw, h), is_seq=s.is_seq), pcs

    def forward(self, params, inputs, ctx):
        (arg,) = inputs
        h = self.conf.size
        gh, gw = self._grid
        act = activations.get(self.conf.active_type or "tanh")
        gate_act = activations.get(
            self.conf.attrs.get("active_gate_type", "sigmoid"))
        state_act = activations.get(
            self.conf.attrs.get("active_state_type", "tanh"))
        dirs = self.conf.attrs.get("directions", (True, True))
        x = arg.value.reshape((arg.value.shape[0], gh, gw, 5 * h))
        w = params["w0"]
        if "b" in params:
            gb, wci, wcf_r, wcf_c, wco = torch.split(
                params["b"], [5 * h, h, h, h, h])
        else:
            gb = torch.zeros(5 * h, dtype=x.dtype, device=x.device)
            wci = wcf_r = wcf_c = wco = gb[:h]
        # descending directions walk the flipped grid
        flip = [ax for ax, up in ((1, dirs[0]), (2, dirs[1])) if not up]
        if flip:
            x = torch.flip(x, dims=flip)
        bsz, n_diag = x.shape[0], gh + gw - 1
        rows = torch.arange(gh, device=x.device)
        cols = torch.arange(n_diag, device=x.device)[:, None] - rows[None, :]
        on_grid = (cols >= 0) & (cols < gw)               # [n_diag, gh]
        cols = torch.clamp(cols, 0, gw - 1)
        zero = torch.zeros((bsz, 1, h), dtype=x.dtype, device=x.device)
        h_prev = c_prev = torch.zeros((bsz, gh, h), dtype=x.dtype,
                                      device=x.device)
        outs = []
        for d in range(n_diag):
            x_d = x[:, rows, cols[d]]                     # [B, gh, 5h]
            h_top = torch.cat([zero, h_prev[:, :-1]], dim=1)
            c_top = torch.cat([zero, c_prev[:, :-1]], dim=1)
            pre = x_d + torch.matmul(h_top + h_prev, w) + gb
            ig = gate_act(pre[..., :h] + (c_top + c_prev) * wci)
            f_r = gate_act(pre[..., h:2 * h] + c_top * wcf_r)
            f_c = gate_act(pre[..., 2 * h:3 * h] + c_prev * wcf_c)
            g = act(pre[..., 3 * h:4 * h])
            c = f_r * c_top + f_c * c_prev + ig * g
            o = gate_act(pre[..., 4 * h:] + c * wco)
            keep = on_grid[d][None, :, None]
            h_prev = torch.where(keep, o * state_act(c), 0.0)
            c_prev = torch.where(keep, c, 0.0)
            outs.append(h_prev)
        # cell (i, j) is row i of step i + j
        diag = torch.stack(outs, dim=1)                   # [B, n_diag, gh, h]
        jj = torch.arange(gw, device=x.device)
        y = diag[:, rows[:, None] + jj[None, :], rows[:, None]]
        if flip:
            y = torch.flip(y, dims=flip)
        return Arg(value=y, seq_lens=arg.seq_lens)
