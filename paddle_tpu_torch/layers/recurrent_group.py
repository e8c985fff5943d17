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

Nested sequences (the in-links carry `subseq_lens`): the walk is over
SUB-sequences, each step feeds the step net one sub-sequence as a plain
sequence [B, L, ...] with its own lengths, memories carry across
sub-sequences (masked through empty ones), and sequence-valued outputs
are packed back into the flat nested layout. Every length the loop
reads is a tensor on the device and every trip count a shape, so the
walk never synchronises with the host.

Group layer conf:
  inputs: [in_links..., static_links..., boot_layers...]
  attrs:
    step_conf    — nested ModelConf (JSON dict) of the step net
    in_links     — step data-layer name per sliced sequence input
    static_links — step data-layer name per static input
    memories     — [{"layer": producer-in-step, "link": step data name,
                    "boot_layer": parent input name | None,
                    "boot_value": float, "size": int}]
    out_links    — step layer names to emit as sequences; the first is
                   the group's output, the others extra outputs under
                   their step-layer names
    reversed     — run right-to-left (nested: over the sub-sequences)
    max_subseq_len — nested: the longest sub-sequence a step sees
                   (default T); longer ones are truncated
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
        # two-level sequences: the walk is over sub-sequences and each
        # step sees one sub-sequence as a plain sequence
        self.nested = bool(in_specs) and in_specs[0].has_subseq

        n_in = len(self.in_links)
        self._in_specs = in_specs
        # fill step-net data layer dims from parent specs
        for i, link in enumerate(self.in_links):
            lc = step_conf.layer(link)
            lc.attrs["dim"] = tuple(in_specs[i].dim)
            lc.attrs["is_seq"] = self.nested
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
        self._out_specs = [self.step_net.specs[o] for o in self.out_links]
        return (self._group_spec(self._out_specs[0]),
                dict(self.step_net.param_confs))

    def _group_spec(self, s):
        """A step output's spec in the parent: a sequence over time, or,
        nested, a nested sequence (sequence-valued step output) or a
        plain sequence over the sub-sequences."""
        return Spec(dim=s.dim, is_seq=True, is_ids=s.is_ids,
                    has_subseq=self.nested and s.is_seq)

    def extra_output_specs(self):
        """Secondary out_links, which the Network registers under their
        step-net layer names."""
        return {o: self._group_spec(s)
                for o, s in zip(self.out_links[1:], self._out_specs[1:])}

    def _boot(self, m, inputs, params, bsz, device):
        """A memory's value at the first step: its boot layer's, or the
        boot constant in f32 (f64 where the parameters are: the port runs
        a network in f64 when given f64 parameters)."""
        first = len(self.in_links) + len(self.static_links)
        if m.get("boot_layer"):
            # the boot layer is one of the trailing parent inputs
            names = [ic.name for ic in self.conf.inputs[first:]]
            return inputs[first + names.index(m["boot_layer"])].value
        f64 = any(v.dtype == torch.float64 for v in params.values())
        return torch.full((bsz, m["size"]), float(m.get("boot_value", 0.0)),
                          dtype=torch.float64 if f64 else torch.float32,
                          device=device)

    def _step(self, params, ctx, feed, carry, m, bsz, lens=None):
        """One run of the step net: (new carry, [output per out_link]).
        `m` [B, 1] is 1 where the row takes this step; elsewhere the
        carry goes through unchanged and float outputs are zero. Each
        carry keeps its dtype (under the AMP rule a bf16 step output must
        not turn an f32 carry into bf16, nor the f32 mask a bf16 carry
        into f32), as the JAX scan. `lens`: the nested walk's lengths of
        this sub-sequence."""
        for mem in self.memories:
            feed[mem["link"]] = Arg(value=carry[mem["layer"]])
        outs, _ = self.step_net.forward(params, feed, train=ctx.train,
                                        rng=ctx.rng)
        new_carry = {}
        for mem in self.memories:
            prev = carry[mem["layer"]]
            v = outs[mem["layer"]].value
            if v.ndim == prev.ndim + 1:
                # nested: a per-timestep memory source carries its last
                # valid frame of this sub-sequence
                last = torch.clamp_min(lens.long() - 1, 0)
                v = v[torch.arange(bsz, device=v.device), last]
            new_carry[mem["layer"]] = (m * v + (1.0 - m) * prev).to(
                prev.dtype)
        ys = []
        for o in self.out_links:
            out = outs[o]
            y = out.ids if out.ids is not None else out.value
            if y.is_floating_point():
                y = y * m.reshape((bsz,) + (1,) * (y.ndim - 1)).to(y.dtype)
            ys.append(y)
        return new_carry, ys

    def _wrap(self, i, y, **lens):
        if self._out_specs[i].is_ids:
            return Arg(ids=y, **lens)
        return Arg(value=y, **lens)

    def _emit(self, outs):
        """The group's output; the others become its extra outputs."""
        self._extra_outs = dict(zip(self.out_links[1:], outs[1:]))
        return outs[0]

    def forward(self, params, inputs, ctx):
        if self.nested:
            return self._forward_nested(params, inputs, ctx)
        n_in = len(self.in_links)
        seq_arg = inputs[0]
        assert seq_arg.is_seq, "recurrent_group first in_link must be a sequence"
        seq_lens = seq_arg.seq_lens
        bsz, t_max = seq_arg.batch, seq_arg.max_len
        device = seq_lens.device

        xs = []
        for a in inputs[:n_in]:
            v = a.ids if a.ids is not None else a.value
            xs.append(sops.reverse_seq(v, seq_lens) if self.reversed else v)
        mask = sops._mask(seq_lens, t_max, torch.float32)
        static_feed = {link: inputs[n_in + i]
                       for i, link in enumerate(self.static_links)}
        carry = {m["layer"]: self._boot(m, inputs, params, bsz, device)
                 for m in self.memories}
        ys = []
        for t in range(t_max):
            feed = dict(static_feed)
            for i, link in enumerate(self.in_links):
                x_t = xs[i][:, t]
                feed[link] = (Arg(ids=x_t) if self._in_specs[i].is_ids
                              else Arg(value=x_t))
            carry, y_t = self._step(params, ctx, feed, carry,
                                    mask[:, t, None], bsz)
            ys.append(y_t)
        outs = []
        for i in range(len(self.out_links)):
            y = torch.stack([y_t[i] for y_t in ys], dim=1)
            if self.reversed:
                y = sops.reverse_seq(y, seq_lens)
            outs.append(self._wrap(i, y, seq_lens=seq_lens))
        return self._emit(outs)

    # ---- nested (two-level) sequences --------------------------------

    def _forward_nested(self, params, inputs, ctx):
        """The walk over SUB-sequences. A nested Arg is flat-packed
        [B, T, ...] with subseq_lens [B, S]; the in-links are unpacked
        once into [B, S, L, ...] (L = min(max_subseq_len or T, T)), the
        loop runs over S (right to left when reversed: the order of the
        sub-sequences, not the time inside each), and sequence-valued
        outputs are scattered back into the flat layout."""
        n_in = len(self.in_links)
        seq_arg = inputs[0]
        bsz, t = seq_arg.batch, seq_arg.max_len
        device = seq_arg.seq_lens.device
        s_max = seq_arg.subseq_lens.shape[1]
        l = min(self.conf.attrs.get("max_subseq_len") or t, t)
        # the flat offset of each sub-sequence, from the ORIGINAL lengths
        # (they define the flat layout); a sub-sequence longer than l is
        # truncated to l steps, and every feed, mask and output length
        # uses the clamped lengths
        orig = seq_arg.subseq_lens.long()
        offsets = torch.cumsum(orig, dim=1) - orig
        sub_lens = torch.clamp_max(seq_arg.subseq_lens, l)
        pos = torch.arange(l, device=device)
        idx = offsets[:, :, None] + pos  # [B, S, L]
        valid = pos < sub_lens[:, :, None]
        idx = torch.clamp(idx, 0, t - 1).reshape(bsz, s_max * l)

        xs = []
        for a in inputs[:n_in]:
            v = a.ids if a.ids is not None else a.value
            xs.append(sops._gather_time(v, idx).reshape(
                (bsz, s_max, l) + tuple(v.shape[2:])))
        static_feed = {link: inputs[n_in + i]
                       for i, link in enumerate(self.static_links)}
        carry = {m["layer"]: self._boot(m, inputs, params, bsz, device)
                 for m in self.memories}
        order = range(s_max - 1, -1, -1) if self.reversed else range(s_max)
        ys = [None] * s_max
        for s in order:
            lens_s = sub_lens[:, s]
            feed = dict(static_feed)
            for i, link in enumerate(self.in_links):
                x_s = xs[i][:, s]
                feed[link] = (Arg(ids=x_s, seq_lens=lens_s)
                              if self._in_specs[i].is_ids
                              else Arg(value=x_s, seq_lens=lens_s))
            m_s = (lens_s > 0).to(torch.float32)[:, None]
            carry, ys[s] = self._step(params, ctx, feed, carry, m_s, bsz,
                                      lens_s)

        n_subseq = torch.sum(sub_lens > 0, dim=1, dtype=torch.int32)
        outs = []
        for i in range(len(self.out_links)):
            y = torch.stack([y_s[i] for y_s in ys], dim=1)  # [B, S, ...]
            if not self._out_specs[i].is_seq:
                outs.append(self._wrap(i, y, seq_lens=n_subseq))
                continue
            # back into the flat layout: positions past a sub-sequence's
            # (clamped) length are zeroed and their clipped indices may
            # land on another sub-sequence's frame, so the scatter ADDS
            # (an overwrite would let a zero replace a real frame)
            d = tuple(y.shape[3:])
            y = y * valid.reshape(valid.shape + (1,) * len(d)).to(y.dtype)
            y = y.reshape((bsz, s_max * l) + d)
            at = idx.reshape(idx.shape + (1,) * len(d)).expand(y.shape)
            flat = y.new_zeros((bsz, t) + d).scatter_add(1, at, y)
            outs.append(self._wrap(i, flat, seq_lens=seq_arg.seq_lens,
                                   subseq_lens=sub_lens))
        return self._emit(outs)
