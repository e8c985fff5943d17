"""Network: config -> executable functions, `paddle_tpu/network.py` on
torch.

Layers are built from a ModelConf in topological order and walked in
that order for the forward. There is no hand-written backward walk:
`loss_fn` is differentiated by autograd (`parallel/dp.py::TrainStep`).
Parameters are a flat {global name: tensor} dict, the JAX package's
names, so one numpy dict feeds both packages (`weights.py`).

Layer state (BatchNorm's running statistics) is a {layer: {slot:
tensor}} dict beside the parameters: `init_state` makes it on a device,
`forward` returns the new one, and it is never differentiated.

Left out, still to port: the mixed-precision cast rule (the
`matmul_precision` flag asking for bf16 raises here), per-layer
`out_sharding` placement, and extra outputs of layer groups.
"""

from __future__ import annotations

from typing import Optional

import torch

from paddle_tpu_torch.core import flags as _flags
from paddle_tpu_torch.core.arg import Arg
from paddle_tpu_torch.core.config import ModelConf, ParameterConf
from paddle_tpu_torch.core.device import resolve_device
from paddle_tpu_torch.layers.base import Ctx, create_layer, init_parameter

# ensure all layer types are registered
import paddle_tpu_torch.layers  # noqa: E402,F401


class Network:
    def __init__(self, conf: ModelConf):
        self.conf = conf
        self.layers = {}
        self.specs = {}
        self.param_confs: dict[str, ParameterConf] = {}  # global name -> conf
        self.layer_params: dict[str, dict] = {}  # layer -> {slot: global name}
        self._stateful: dict[str, object] = {}
        order = []
        for lc in conf.layers:
            layer = create_layer(lc, conf)
            self.layers[lc.name] = layer
            for n in lc.input_names():
                if n not in self.specs:
                    raise KeyError(
                        f"layer {lc.name!r} input {n!r} is not defined above it "
                        f"(layers must be in topological order)"
                    )
            in_specs = [self.specs[n] for n in lc.input_names()]
            spec, pcs = layer.build(in_specs)
            self.specs[lc.name] = spec
            slot_map = {}
            for slot, pc in pcs.items():
                if pc is None:
                    continue
                if pc.name in self.param_confs:
                    # shared parameter: dims must agree
                    prev = self.param_confs[pc.name]
                    assert tuple(prev.dims) == tuple(pc.dims), (
                        f"shared param {pc.name} dim mismatch"
                    )
                else:
                    self.param_confs[pc.name] = pc
                slot_map[slot] = pc.name
            self.layer_params[lc.name] = slot_map
            if hasattr(layer, "init_state"):
                self._stateful[lc.name] = layer
            order.append(lc.name)
        self.order = order
        self.output_names = list(conf.output_layer_names) or (
            [order[-1]] if order else []
        )
        self.cost_names = [
            n for n in order if getattr(self.layers[n], "is_cost", False)
        ]
        # Declared outputs built FROM cost layers by layer arithmetic are
        # the training objective themselves: such an output replaces its
        # cost-layer ancestors in the loss.
        derived = []
        absorbed = set()
        for out_name in self.output_names:
            if getattr(self.layers.get(out_name), "is_cost", False):
                continue
            cost_anc = [c for c in self.cost_names
                        if c in self._ancestors([out_name])]
            if cost_anc:
                derived.append(out_name)
                absorbed.update(cost_anc)
        if derived:
            self.cost_names = [
                n for n in self.cost_names if n not in absorbed
            ] + derived
        self.input_names = list(conf.input_layer_names) or [
            lc.name for lc in conf.layers if lc.type == "data"
        ]

    def _ancestors(self, names) -> set:
        """The layers `names` depend on, themselves included."""
        run = set()
        frontier = list(names)
        while frontier:
            n = frontier.pop()
            if n in run:
                continue
            run.add(n)
            frontier.extend(self.conf.layer(n).input_names())
        return run

    # ---- parameters & state ----
    def init_params(self, generator: torch.Generator, device=None,
                    dtype=torch.float32) -> dict:
        """{global name: tensor on `device`}, drawn from `generator` in
        sorted-name order (on the generator's device, then moved)."""
        dev = resolve_device(device)
        return {
            name: init_parameter(generator, self.param_confs[name],
                                 dtype).to(dev)
            for name in sorted(self.param_confs)
        }

    def init_state(self, device=None) -> dict:
        """{stateful layer: {slot: tensor on `device`}} — BatchNorm's
        running mean and variance, resolved as `init_params` resolves
        its device."""
        dev = resolve_device(device)
        return {name: layer.init_state(dev)
                for name, layer in self._stateful.items()}

    def _layer_param_view(self, name: str, params: dict) -> dict:
        return {slot: params[g] for slot, g in self.layer_params[name].items()}

    # ---- execution ----
    def forward(
        self,
        params: dict,
        feed: dict,
        *,
        state: Optional[dict] = None,
        train: bool = False,
        rng: Optional[torch.Generator] = None,
        outputs: Optional[list] = None,
    ):
        """Run the layers. Returns (outputs: {layer_name: Arg},
        new_state). `feed` maps data-layer names to Arg. With `outputs`,
        only their ancestors run (inference prunes cost layers and
        their label inputs)."""
        if _flags.get_flag("matmul_precision") in ("bfloat16", "bf16"):
            raise NotImplementedError(
                "the port's Network runs f32 only: the bf16 mixed-"
                "precision cast rule is not ported yet (set the "
                "matmul_precision flag to 'default')"
            )
        if state is None:
            # a stateful layer has parameters: its state starts on their
            # device
            state = (self.init_state(next(iter(params.values())).device)
                     if self._stateful else {})
        ctx = Ctx(train=train, rng=rng, state=state)
        outs: dict[str, Arg] = {}
        if outputs is not None:
            run = self._ancestors(outputs)
            order = [n for n in self.order if n in run]
        else:
            order = self.order
        needed = {
            n for ln in order for n in self.conf.layer(ln).input_names()
        }
        for name in order:
            lc = self.conf.layer(name)
            if lc.type == "data":
                if name in feed:
                    outs[name] = feed[name]
                elif name in needed:
                    raise KeyError(
                        f"data layer {name!r} is consumed by the network but "
                        f"missing from feed (fed: {sorted(feed)})"
                    )
                continue
            inputs = [outs[n] for n in lc.input_names()]
            layer = self.layers[name]
            try:
                outs[name] = layer.forward(
                    self._layer_param_view(name, params), inputs, ctx)
            except Exception as e:
                e.add_note(
                    f"  while running layer {name!r} "
                    f"(type={lc.type!r}, inputs={lc.input_names()})"
                )
                raise
        new_state = {**ctx.state, **ctx.updated_state}
        return outs, new_state

    def loss_fn(self, params, feed, state=None, train=True, rng=None):
        """Scalar sum over the cost layers of each one's batch mean.
        Returns (loss, (outputs, new_state))."""
        outs, new_state = self.forward(
            params, feed, state=state, train=train, rng=rng
        )
        assert self.cost_names, "network has no cost layer"
        total = 0.0
        for n in self.cost_names:
            total = total + torch.mean(outs[n].value)
        return total, (outs, new_state)
