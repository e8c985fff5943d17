"""OperatorBase, op registry, grad-op builders, NetOp and `net_to_fn`:
the JAX package's `framework/op.py` on the port.

Reference: framework/operator.h:63 (OperatorBase: type + named input/output
var lists + attrs, Run(scope, ctx)), framework/op_registry.h (registration
+ CreateOp), framework/grad_op_builder.cc (forward op -> grad op with
I/O wired by @GRAD-suffix convention), operators/net_op.h (composite op
running children in order, CompleteAddOp output inference).

A kernel is a plain function of torch tensors. `run` executes it
eagerly on the op's device: its `device` attribute, else its scope's
(None: the card, which raises where there is none; a CPU run is asked
for with `device="cpu"`). A numpy input in the scope becomes a tensor
there first (float64 as float32, as the JAX package's arrays are
without x64), a tensor stays where it lies. `net_to_fn` closes a whole
net over a feed list into a plain function of tensors: autograd
differentiates it, and on the card a caller may capture it as a CUDA
graph (the JAX package jit-compiles it).
"""

from __future__ import annotations

from typing import Any, Callable, Dict, List, Optional, Sequence

import numpy as np
import torch

from paddle_tpu_torch.core.device import resolve_device
from paddle_tpu_torch.framework.scope import Scope

GRAD_SUFFIX = "@GRAD"  # framework: kGradVarSuffix
EMPTY_VAR = "@EMPTY@"  # framework: kEmptyVarName

VarMap = Dict[str, List[str]]

_OPS: Dict[str, type] = {}
_GRAD_BUILDERS: Dict[str, Callable] = {}


def register_op(name: str):
    def deco(cls):
        cls.type = name
        _OPS[name] = cls
        return cls

    return deco


def register_grad(name: str):
    """Register fn(fwd_op) -> list[OperatorBase] building the grad op(s)."""

    def deco(fn):
        _GRAD_BUILDERS[name] = fn
        return fn

    return deco


def _as_varmap(m) -> VarMap:
    out: VarMap = {}
    for k, v in (m or {}).items():
        out[k] = [v] if isinstance(v, str) else list(v)
    return out


class OperatorBase:
    """type + named input/output variable lists + attrs
    (framework/operator.h:63,90)."""

    type: str = "base"
    # OpProto-style slot signature (framework/op_registry.h OpProto):
    # declared per registered op via set_signature; introspected by the
    # v2 Operator facade and the generic op-test harness.
    INPUT_SLOTS: tuple = ()
    OUTPUT_SLOTS: tuple = ()
    ATTR_NAMES: tuple = ()

    def __init__(self, inputs=None, outputs=None, attrs=None):
        self.inputs: VarMap = _as_varmap(inputs)
        self.outputs: VarMap = _as_varmap(outputs)
        self.attrs: Dict[str, Any] = dict(attrs or {})

    # -- slot helpers (operator.h Input/Inputs/Output) --
    def input(self, slot: str) -> str:
        names = self.inputs[slot]
        assert len(names) == 1, f"{self.type}.{slot} is a list slot"
        return names[0]

    def output(self, slot: str) -> str:
        names = self.outputs[slot]
        assert len(names) == 1, f"{self.type}.{slot} is a list slot"
        return names[0]

    def input_vars(self) -> List[str]:
        return [n for ns in self.inputs.values() for n in ns]

    def output_vars(self) -> List[str]:
        return [n for ns in self.outputs.values() for n in ns]

    # -- execution --
    def kernel(self, ins: Dict[str, Any], attrs: Dict[str, Any]):
        """Pure function: slot->tensor(s) in, slot->tensor(s) out."""
        raise NotImplementedError(self.type)

    def run(self, scope: Scope) -> None:
        device = self.attrs.get("device") or scope.device
        ins = {}
        for slot, names in self.inputs.items():
            vals = [
                None if n == EMPTY_VAR else as_tensor(scope.get(n), device)
                for n in names
            ]
            ins[slot] = vals[0] if len(vals) == 1 else vals
        outs = self.kernel(ins, dict(self.attrs, device=device))
        for slot, names in self.outputs.items():
            vals = outs[slot]
            if len(names) == 1:
                vals = [vals]
            for n, v in zip(names, vals):
                if n != EMPTY_VAR:
                    scope.set(n, v)

    def __repr__(self):
        return (
            f"Op({self.type}, inputs={self.inputs}, "
            f"outputs={self.outputs})"
        )


def as_tensor(value, device=None):
    """A numpy array or scalar as a tensor on `device` (None: the card;
    float64 as float32, as the JAX package's arrays without x64);
    anything else as it is."""
    if isinstance(value, (np.ndarray, np.generic)):
        a = np.asarray(value)
        if a.dtype == np.float64:
            a = a.astype(np.float32)
        return torch.from_numpy(np.array(a, copy=True)).to(
            resolve_device(device))
    return value


def create_op(type_name: str, inputs=None, outputs=None, attrs=None):
    """OpRegistry::CreateOp (framework/op_registry.h)."""
    if type_name not in _OPS:
        known = ", ".join(sorted(_OPS))
        raise KeyError(f"unknown op type {type_name!r}; registered: {known}")
    return _OPS[type_name](inputs=inputs, outputs=outputs, attrs=attrs)


def set_signature(type_name: str, input_slots, output_slots,
                  attr_names=()):
    """Attach the OpProto slot signature to a registered op."""
    cls = _OPS[type_name]
    cls.INPUT_SLOTS = tuple(input_slots)
    cls.OUTPUT_SLOTS = tuple(output_slots)
    cls.ATTR_NAMES = tuple(attr_names)


def op_types() -> List[str]:
    """All registered op type names (OpRegistry enumeration)."""
    return sorted(_OPS)


def op_signature(type_name: str):
    """(input_slots, output_slots, attr_names) of a registered op —
    the role of the reference's OpProto / get_all_op_protos()."""
    if type_name not in _OPS:
        raise KeyError(f"unknown op type {type_name!r}")
    cls = _OPS[type_name]
    return cls.INPUT_SLOTS, cls.OUTPUT_SLOTS, cls.ATTR_NAMES


def grad_op_for(op: OperatorBase) -> List[OperatorBase]:
    """Build the grad op(s) of a forward op
    (framework/grad_op_builder.cc)."""
    if op.type not in _GRAD_BUILDERS:
        raise KeyError(f"op {op.type!r} has no registered grad builder")
    ops = _GRAD_BUILDERS[op.type](op)
    return ops if isinstance(ops, list) else [ops]


class NetOp(OperatorBase):
    """Composite op: children run in insertion order
    (operators/net_op.h)."""

    type = "net"

    def __init__(self, inputs=None, outputs=None, attrs=None):
        super().__init__(inputs, outputs, attrs)
        self.ops: List[OperatorBase] = []

    def append_op(self, op: OperatorBase) -> OperatorBase:
        self.ops.append(op)
        return op

    def add_op(self, type_name, inputs=None, outputs=None, attrs=None):
        return self.append_op(create_op(type_name, inputs, outputs, attrs))

    def complete_add_op(self) -> None:
        """Infer net-level inputs (consumed before produced) and outputs
        (produced by any child) — net_op.h CompleteAddOp."""
        produced, needed = set(), []
        outs = []
        for op in self.ops:
            for n in op.input_vars():
                if n not in produced and n != EMPTY_VAR:
                    needed.append(n)
            for n in op.output_vars():
                if n != EMPTY_VAR:
                    produced.add(n)
                    outs.append(n)
        seen = set()
        self.inputs = {
            "X": [n for n in needed if not (n in seen or seen.add(n))]
        }
        seen = set()
        self.outputs = {
            "Out": [n for n in outs if not (n in seen or seen.add(n))]
        }

    def run(self, scope: Scope) -> None:
        for op in self.ops:
            op.run(scope)


def net_to_fn(
    net: OperatorBase,
    feed_names: Sequence[str],
    fetch_names: Sequence[str],
    const_scope: Optional[Scope] = None,
) -> Callable:
    """Close a net over (feeds -> fetches) as a plain function of
    tensors, which autograd differentiates and a caller on the card may
    capture as a CUDA graph (the JAX package jit-compiles it).
    `const_scope` supplies non-differentiated constants visible via
    parent lookup.
    """

    def fn(*feed_values):
        scope = Scope(parent=const_scope)
        for name, val in zip(feed_names, feed_values):
            scope.set(name, val)
        net.run(scope)
        return tuple(scope.get(n) for n in fetch_names)

    return fn
