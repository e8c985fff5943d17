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

Mixed precision (the `matmul_precision` flag at "bfloat16" or "bf16"),
the JAX package's cast rule: master parameters stay f32; on each
consuming edge a compute layer gets bf16 operands and bf16 views of its
parameters, and a cost layer gets f32 ones, so targets and the loss
math keep full precision. The casts are `.to()` on the autograd graph,
so gradients reach the f32 masters in f32.

Extra outputs: a layer with `extra_output_specs()` emits more values
than its own, each under a name of its own (`lstm_step`'s cell state
`<name>@state`), which a later layer or an `outputs=` list can read;
the layer leaves them in `_extra_outs` after its forward.

Left out, still to port: per-layer `out_sharding` placement (ROADMAP
A8).
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

_FLOATS = (torch.float32, torch.bfloat16)


def _cast_arg(a: Arg, dtype) -> Arg:
    """An Arg with its float value cast to `dtype` (ids and lens as
    they are)."""
    if a.value is None or a.value.dtype not in _FLOATS or (
            a.value.dtype == dtype):
        return a
    return a.with_value(a.value.to(dtype))


class Network:
    def __init__(self, conf: ModelConf):
        self.conf = conf
        self.layers = {}
        self.specs = {}
        self._extra_producer: dict[str, str] = {}  # extra output -> layer
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
            if hasattr(layer, "extra_output_specs"):
                for xname, xspec in layer.extra_output_specs().items():
                    if xname in self.specs:
                        raise KeyError(
                            f"extra output {xname!r} of layer {lc.name!r} "
                            f"collides with an existing layer name"
                        )
                    self.specs[xname] = xspec
                    self._extra_producer[xname] = lc.name
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
            out_name = self._extra_producer.get(out_name, out_name)
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
        """The layers `names` depend on, themselves included (an extra
        output stands for the layer that emits it)."""
        run = set()
        frontier = list(names)
        while frontier:
            n = frontier.pop()
            n = self._extra_producer.get(n, n)
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
        rng=None,
        outputs: Optional[list] = None,
    ):
        """Run the layers. Returns (outputs: {layer_name: Arg},
        new_state). `feed` maps data-layer names to Arg. With `outputs`,
        only their ancestors run (inference prunes cost layers and
        their label inputs)."""
        amp = _flags.get_flag("matmul_precision") in ("bfloat16", "bf16")
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
            layer_params = self._layer_param_view(name, params)
            if amp:
                # per consuming edge: a cost layer sees f32 (a target
                # straight from the feed keeps full precision even where
                # the same data layer feeds compute layers), every other
                # layer computes in bf16
                to = (torch.float32 if getattr(layer, "is_cost", False)
                      else torch.bfloat16)
                inputs = [_cast_arg(a, to) for a in inputs]
                layer_params = {
                    k: v.to(to) if v.dtype in _FLOATS else v
                    for k, v in layer_params.items()}
            try:
                outs[name] = layer.forward(layer_params, inputs, ctx)
            except Exception as e:
                e.add_note(
                    f"  while running layer {name!r} "
                    f"(type={lc.type!r}, inputs={lc.input_names()})"
                )
                raise
            extra = getattr(layer, "_extra_outs", None)
            if extra:
                outs.update(extra)
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
