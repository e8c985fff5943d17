"""Layer base class and spec plumbing: `paddle_tpu/layers/base.py` on
torch.

A layer is a pure function module, as in the JAX package: `build`
declares the output spec and parameter confs from the input specs;
`forward` maps (params, inputs) -> Arg. The backward is autograd over
the whole network.

Randomness: `Ctx.rng` is a torch.Generator and `Ctx.split(name)` a
generator seeded from (rng, crc32(name)) — the rule of the JAX
package's `jax.random.fold_in`, with other numbers. A dropout mask
therefore cannot equal the JAX package's bit for bit; the LM has no
dropout, and parity tests keep `drop_rate = 0`.
"""

from __future__ import annotations

import dataclasses
import zlib
from dataclasses import dataclass, field
from typing import Optional

import torch

from paddle_tpu_torch.core import rng as _rng
from paddle_tpu_torch.core.config import LayerConf, ModelConf, ParameterConf
from paddle_tpu_torch.core.registry import LAYERS
from paddle_tpu_torch.ops import activations


@dataclass(frozen=True)
class Spec:
    """Static description of a layer output (per-example feature shape,
    sequence-ness, dtype)."""

    dim: tuple = ()  # per-timestep feature shape, e.g. (784,)
    is_seq: bool = False
    has_subseq: bool = False
    is_ids: bool = False
    dtype: object = torch.float32

    @property
    def size(self) -> int:
        n = 1
        for d in self.dim:
            n *= d
        return n


@dataclass
class Ctx:
    """Per-call context: train/test phase + RNG (for dropout)."""

    train: bool = False
    rng: Optional[torch.Generator] = None
    # non-parameter persistent state: layers read ctx.state[layer_name]
    # and write ctx.updated_state[layer_name]
    state: dict = field(default_factory=dict)
    updated_state: dict = field(default_factory=dict)

    def split(self, name: str) -> torch.Generator:
        assert self.rng is not None, "layer needs rng but Ctx.rng is None"
        return _rng.generator(
            _rng.fold_in(self.rng.initial_seed(), zlib.crc32(name.encode())),
            self.rng.device,
        )


class Layer:
    """Base layer. Subclasses set `type_names` via @LAYERS.register and
    implement build() and forward()."""

    def __init__(self, conf: LayerConf, model: ModelConf):
        self.conf = conf
        self.name = conf.name

    def build(self, in_specs: list) -> tuple:
        """Return (out_spec, param_confs) where param_confs maps *local*
        param slot -> ParameterConf (with dims filled in)."""
        raise NotImplementedError

    def forward(self, params: dict, inputs: list, ctx: Ctx):
        raise NotImplementedError

    def activation(self):
        return activations.get(self.conf.active_type)

    def apply_activation_and_dropout(self, y, ctx: Ctx, seq_lens=None):
        if self.conf.active_type == "sequence_softmax":
            assert seq_lens is not None, "sequence_softmax needs sequence input"
            sq = y.shape[-1] == 1
            y2 = y[..., 0] if sq else y
            y2 = activations.masked_softmax(y2, seq_lens)
            y = y2[..., None] if sq else y2
        else:
            y = self.activation()(y)
        rate = self.conf.drop_rate
        if rate > 0.0 and ctx.train:
            keep = 1.0 - rate
            u = torch.rand(y.shape, generator=ctx.split(self.name + "/drop"),
                           device=y.device)
            y = torch.where(u < keep, y / keep, 0.0)
        return y

    def weight_conf(self, idx: int, dims: tuple) -> ParameterConf:
        """A ParameterConf for input edge `idx` with dims. Returns a
        copy — never mutates the user's InputConf.parameter, so sharing
        stays by name, not by aliased object."""
        ic = self.conf.inputs[idx]
        pc = (
            dataclasses.replace(ic.parameter)
            if ic.parameter is not None
            else ParameterConf()
        )
        if not pc.name:
            pc.name = f"_{self.name}.w{idx}"
        pc.dims = tuple(dims)
        return pc

    def bias_conf(self, dims: tuple) -> Optional[ParameterConf]:
        if not self.conf.bias:
            return None
        pc = (
            dataclasses.replace(self.conf.bias_parameter)
            if self.conf.bias_parameter is not None
            else ParameterConf()
        )
        if not pc.name:
            pc.name = f"_{self.name}.wbias"
        pc.dims = tuple(dims)
        return pc


def init_parameter(gen: torch.Generator, pc: ParameterConf,
                   dtype=torch.float32) -> torch.Tensor:
    """Initialize one parameter per its config, on gen's device: normal
    with std 1/sqrt(fan_in) for weights, zeros (initial_mean) for 1-D
    unless initial_std is set — the JAX package's rule."""
    dims = tuple(pc.dims)
    dev = gen.device
    if pc.initializer is not None:
        return torch.as_tensor(pc.initializer(pc.name), dtype=dtype,
                               device=dev).reshape(dims)
    if pc.initial_strategy == "zero":
        return torch.zeros(dims, dtype=dtype, device=dev)
    if pc.initial_strategy == "constant":
        return torch.full(dims, pc.initial_value, dtype=dtype, device=dev)
    std = pc.initial_std
    if std is None:
        if len(dims) == 1:
            return torch.full(dims, pc.initial_mean, dtype=dtype, device=dev)
        fan_in = dims[0] if len(dims) == 2 else int(torch.tensor(dims[:-1]).prod())
        std = 1.0 / (fan_in ** 0.5)
    if pc.initial_strategy == "uniform":
        u = torch.rand(dims, generator=gen, dtype=dtype, device=dev) * 2 - 1
        return pc.initial_mean + std * u
    return pc.initial_mean + std * torch.randn(dims, generator=gen,
                                               dtype=dtype, device=dev)


def create_layer(conf: LayerConf, model: ModelConf) -> Layer:
    return LAYERS.get(conf.type)(conf, model)
