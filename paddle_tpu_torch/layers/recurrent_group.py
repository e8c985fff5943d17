"""Recurrent group: a user-defined step network run over time —
`paddle_tpu/layers/recurrent_group.py` on torch.

The step net is built ONCE as a sub-`Network`; a Python loop over time
(the JAX package's `lax.scan`) feeds it one time slice of each in-link
per step, the whole of each static link (read-only per-sequence inputs,
such as the encoder sequence for attention) and the memories: the
values the memory layers had at t-1 (a boot layer's value, or a boot
constant, at t = 0), carried through unchanged at padded steps. The
step net runs with the parent's train flag and generator. Autograd
differentiates the loop.

Group layer conf:
  inputs: [in_links..., static_links..., boot_layers...]
  attrs:
    step_conf    — nested ModelConf (JSON dict) of the step net
    in_links     — step data-layer name per sliced sequence input
    static_links — step data-layer name per static input
    memories     — [{"layer": producer-in-step, "link": step data name,
                    "boot_layer": parent input name | None,
                    "boot_value": float, "size": int}]
    out_links    — step layer names to emit as sequences
    reversed     — run right-to-left

Left out, still to port: secondary out_links (they wait for the
Network's extra outputs, ROADMAP A1) and nested sequences (the
hierarchical walk over sub-sequences, ROADMAP A3).
"""

from __future__ import annotations

import torch

from paddle_tpu_torch.core.arg import Arg
from paddle_tpu_torch.core.config import ModelConf, _model_from_dict
from paddle_tpu_torch.core.registry import LAYERS
from paddle_tpu_torch.layers.base import Layer, Spec
from paddle_tpu_torch.ops import sequence_ops as sops


@LAYERS.register("recurrent_group", "recurrent_layer_group")
class RecurrentGroupLayer(Layer):
    def build(self, in_specs):
        from paddle_tpu_torch.network import Network  # cycle-free late import

        a = self.conf.attrs
        step_conf = a["step_conf"]
        if isinstance(step_conf, dict):
            step_conf = _model_from_dict(step_conf)
        assert isinstance(step_conf, ModelConf)
        self.in_links = list(a.get("in_links", []))
        self.static_links = list(a.get("static_links", []))
        self.memories = list(a.get("memories", []))
        self.out_links = list(a.get("out_links", []))
        self.reversed = a.get("reversed", False)
        if len(self.out_links) > 1:
            raise NotImplementedError(
                f"recurrent_group {self.name}: secondary out_links "
                f"{self.out_links[1:]} need the Network's extra outputs, "
                f"not ported yet (ROADMAP A1)")
        if in_specs and in_specs[0].has_subseq:
            raise NotImplementedError(
                f"recurrent_group {self.name}: nested sequences are not "
                f"ported yet (ROADMAP A3)")

        n_in = len(self.in_links)
        self._in_specs = in_specs
        # fill step-net data layer dims from parent specs
        for i, link in enumerate(self.in_links):
            lc = step_conf.layer(link)
            lc.attrs["dim"] = tuple(in_specs[i].dim)
            lc.attrs["is_seq"] = False
            lc.attrs["is_ids"] = in_specs[i].is_ids
        for i, link in enumerate(self.static_links):
            s = in_specs[n_in + i]
            lc = step_conf.layer(link)
            lc.attrs["dim"] = tuple(s.dim)
            lc.attrs["is_seq"] = s.is_seq
            lc.attrs["is_ids"] = s.is_ids
        for m in self.memories:
            lc = step_conf.layer(m["link"])
            lc.attrs["dim"] = (m["size"],)
            lc.attrs["is_seq"] = False

        self.step_net = Network(step_conf)
        # The step net's params are this layer's: names merge into the
        # parent table (sharing by name, as in the reference). Params of
        # AUTO-named step layers (`___fc_0__` style) take the group
        # name as a prefix, so they never collide with an unnamed
        # parent layer of the same shape.
        renames = {
            old: f"_{self.name}.{old}"
            for old in self.step_net.param_confs
            if old.startswith("___")
        }
        for old, new in renames.items():
            pc = self.step_net.param_confs.pop(old)
            pc.name = new
            self.step_net.param_confs[new] = pc
        for slot_map in self.step_net.layer_params.values():
            for slot, g in list(slot_map.items()):
                if g in renames:
                    slot_map[slot] = renames[g]
        out_spec = self.step_net.specs[self.out_links[0]]
        return (Spec(dim=out_spec.dim, is_seq=True, is_ids=out_spec.is_ids),
                dict(self.step_net.param_confs))

    def _boot(self, m, inputs, bsz, device):
        first = len(self.in_links) + len(self.static_links)
        if m.get("boot_layer"):
            # the boot layer is one of the trailing parent inputs
            names = [ic.name for ic in self.conf.inputs[first:]]
            return inputs[first + names.index(m["boot_layer"])].value
        return torch.full((bsz, m["size"]), float(m.get("boot_value", 0.0)),
                          dtype=torch.float32, device=device)

    def forward(self, params, inputs, ctx):
        n_in = len(self.in_links)
        seq_arg = inputs[0]
        assert seq_arg.is_seq, "recurrent_group first in_link must be a sequence"
        seq_lens = seq_arg.seq_lens
        bsz, t_max = seq_lens.shape[0], seq_arg.max_len
        device = seq_lens.device

        xs = []
        for a in inputs[:n_in]:
            v = a.ids if a.ids is not None else a.value
            xs.append(sops.reverse_seq(v, seq_lens) if self.reversed else v)
        mask = sops._mask(seq_lens, t_max, torch.float32)
        static_feed = {link: inputs[n_in + i]
                       for i, link in enumerate(self.static_links)}
        carry = {m["layer"]: self._boot(m, inputs, bsz, device)
                 for m in self.memories}
        out_name = self.out_links[0]
        ys = []
        for t in range(t_max):
            feed = dict(static_feed)
            for i, link in enumerate(self.in_links):
                x_t = xs[i][:, t]
                feed[link] = (Arg(ids=x_t) if self._in_specs[i].is_ids
                              else Arg(value=x_t))
            for m in self.memories:
                feed[m["link"]] = Arg(value=carry[m["layer"]])
            outs, _ = self.step_net.forward(params, feed, train=ctx.train,
                                            rng=ctx.rng)
            m_t = mask[:, t, None]
            # each carry keeps its dtype across steps (under the AMP rule
            # a bf16 step output must not turn an f32 carry into bf16,
            # nor the f32 mask a bf16 carry into f32), as the JAX scan
            carry = {
                m["layer"]: (m_t * outs[m["layer"]].value
                             + (1.0 - m_t) * carry[m["layer"]]
                             ).to(carry[m["layer"]].dtype)
                for m in self.memories
            }
            out = outs[out_name]
            y = out.ids if out.ids is not None else out.value
            if y.is_floating_point():
                y = y * mask[:, t].reshape(
                    (bsz,) + (1,) * (y.ndim - 1)).to(y.dtype)
            ys.append(y)
        y = torch.stack(ys, dim=1)
        if self.reversed:
            y = sops.reverse_seq(y, seq_lens)
        if self.step_net.specs[out_name].is_ids:
            return Arg(ids=y, seq_lens=seq_lens)
        return Arg(value=y, seq_lens=seq_lens)
