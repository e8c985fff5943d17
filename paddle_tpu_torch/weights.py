"""Parameter and optimizer-state dicts between numpy (or the JAX
package) and torch.

The port keeps the JAX package's flat parameter names — the global
names `Network.param_confs` gives (`_lm_emb.w0`, `_lm_att0.wq`, ...)
— so one numpy dict feeds both implementations. Values keep their
dtype and bits: the round trip numpy -> torch -> numpy is exact.
"""

from __future__ import annotations

import numpy as np
import torch

from paddle_tpu_torch.core.device import resolve_device


def params_from_numpy(np_params: dict, device=None) -> dict:
    """{name: array-like} -> {name: tensor on `device`}. Accepts numpy
    arrays and anything `np.asarray` reads (JAX arrays included)."""
    dev = resolve_device(device)
    return {
        name: torch.from_numpy(np.array(value, copy=True)).to(dev)
        for name, value in np_params.items()
    }


def params_to_numpy(params: dict) -> dict:
    """{name: tensor} -> {name: numpy array} on the host."""
    return {name: t.detach().cpu().numpy() for name, t in params.items()}


def opt_state_from_numpy(np_state: dict, device=None) -> dict:
    """{param name: {slot: array-like}} -> the same nesting of tensors
    on `device` — an optimizer state (`Optimizer.init_state`'s shape),
    e.g. the JAX package's, carried across bit for bit."""
    dev = resolve_device(device)
    return {name: params_from_numpy(slots, device=dev)
            for name, slots in np_state.items()}


def opt_state_to_numpy(state: dict) -> dict:
    """{param name: {slot: tensor}} -> numpy on the host."""
    return {name: params_to_numpy(slots) for name, slots in state.items()}


def state_from_numpy(np_state: dict, device=None) -> dict:
    """{layer: {slot: array-like}} -> the same nesting of tensors on
    `device` — a network's layer state (`Network.init_state`'s shape:
    BatchNorm's running mean and var), e.g. the JAX package's, carried
    across bit for bit."""
    return opt_state_from_numpy(np_state, device=device)


def state_to_numpy(state: dict) -> dict:
    """{layer: {slot: tensor}} -> numpy on the host."""
    return opt_state_to_numpy(state)


def fused_resnet_map(fused_net) -> tuple:
    """Where each parameter and state slot of a fused ResNet graph
    (`models/image.py::resnet(fused=True)`) lives in the plain graph of
    the same depth: ({fused param: plain param}, {fused layer: {slot:
    (plain layer, slot)}}). `_bottleneck` names the plain chain a block
    replaces: `fused_conv1x1_bn` X = conv X + batch_norm X_bn;
    `fused_bottleneck_tail` B_tail = batch_norm B_b_bn (in) + conv B_c +
    batch_norm B_c_bn (out). Everything else keeps its name."""
    bn = ("mean", "var")
    pmap, smap = {}, {}
    for name, layer in fused_net.layers.items():
        slots = fused_net.layer_params[name]
        kind = fused_net.conf.layer(name).type
        if kind == "fused_conv1x1_bn":
            src = {"w0": f"_{name}.w0", "g": f"_{name}_bn.w0",
                   "b": f"_{name}_bn.wbias"}
            smap[name] = {s: (f"{name}_bn", s) for s in bn}
        elif kind == "fused_bottleneck_tail":
            blk = name[:-len("_tail")]
            src = {"w0": f"_{blk}_c.w0", "gi": f"_{blk}_b_bn.w0",
                   "bi": f"_{blk}_b_bn.wbias", "go": f"_{blk}_c_bn.w0",
                   "bo": f"_{blk}_c_bn.wbias"}
            smap[name] = {f"{io}_{s}": (f"{blk}_{c}_bn", s)
                          for io, c in (("in", "b"), ("out", "c"))
                          for s in bn}
        else:
            src = dict(slots)
            if hasattr(layer, "init_state"):
                smap[name] = {s: (name, s) for s in bn}
        for slot, g in slots.items():
            pmap[g] = src[slot]
    return pmap, smap


def fused_resnet_from_plain(fused_net, params: dict, state=None) -> tuple:
    """(params, state) of a fused ResNet graph from the plain graph's
    (tensors or numpy arrays; see `fused_resnet_map`). A plain 1x1 conv
    weight [1, 1, Cin, Cout] becomes the fused [Cin, Cout]."""
    pmap, smap = fused_resnet_map(fused_net)
    new_params = {k: params[src].reshape(fused_net.param_confs[k].dims)
                  for k, src in pmap.items()}
    if state is None:
        return new_params, None
    return new_params, {layer: {s: state[pl][ps]
                                for s, (pl, ps) in slots.items()}
                        for layer, slots in smap.items()}


def place_on_mesh(np_params: dict, mesh, specs: dict, device=None) -> dict:
    """Full parameters ({name: numpy array or tensor}, e.g. the JAX
    package's) onto a mesh: each rank keeps its slice of every
    parameter `specs` ({name: partition spec}, a `Sharder`'s) splits,
    and the whole of the rest, as tensors on `device`. Without a mesh,
    the whole of each."""
    from paddle_tpu_torch.parallel.sharding import local_shard

    dev = resolve_device(device)
    out = {}
    for name, value in np_params.items():
        x = (value.detach() if torch.is_tensor(value)
             else torch.from_numpy(np.array(value, copy=True)))
        spec = specs.get(name, ())
        if mesh is not None and any(a is not None for a in spec):
            x = local_shard(x, spec, mesh)
        out[name] = x.contiguous().clone().to(dev)
    return out
