"""paddle.v2.framework.core on the port — the engine-object module.

Reference: the pybind module `core` (paddle/framework/pybind.cc) exposing
Scope, places and Operator.backward. The port keeps values as tensors
(or numpy arrays, made tensors when an op reads them) inside its
framework's Scopes, so tensors need no set_dims/alloc choreography —
`new_var` + `set`/numpy round-trips cover the same test surface. A
scope's `device` is where its ops run (None: the card); a place names
one (`Scope(device=place.device)`).
"""

from __future__ import annotations

import torch

from paddle_tpu_torch.framework.backward import backward as _build_backward
from paddle_tpu_torch.framework.scope import Variable  # noqa: F401
from paddle_tpu_torch.framework.scope import Scope as _Scope


class Scope(_Scope):
    """Reference core.Scope surface (framework/scope.h:36):
    new_var/find_var/new_scope/drop_kids."""

    def new_var(self, name: str) -> Variable:
        return self.var(name)

    def drop_kids(self) -> None:
        # child scopes are plain Python objects; dropping the
        # references is the whole job (scope.h DropKids frees C++ kids)
        self._kids.clear()


class CPUPlace:
    """The host (platform/place.h)."""

    device = "cpu"

    def __repr__(self) -> str:  # pragma: no cover
        return "CPUPlace"


class GPUPlace:
    """Card `index` (platform/place.h)."""

    def __init__(self, index: int = 0):
        self.device = f"cuda:{index}"

    def __repr__(self) -> str:  # pragma: no cover
        return f"GPUPlace({self.device[5:]})"


def is_compile_gpu() -> bool:
    """The reference gates its GPUPlace test arms on this: true where
    the port has a card, so the op-test harness runs each op on the
    CPU and on the card."""
    return torch.cuda.is_available()


class Operator:
    """core.Operator static surface used by tests:
    Operator.backward(fwd_op, no_grad_set) -> backward net."""

    @staticmethod
    def backward(forward_op, no_grad_set=frozenset()):
        from paddle_tpu_torch.framework.op import EMPTY_VAR

        # reference pybind semantics: the CALLER seeds the forward
        # outputs' gradients in the scope before running the net, so
        # they must not be zero-filled by the builder
        seeded = {
            n
            for ns in forward_op.outputs.values()
            for n in ns
            if n != EMPTY_VAR
        }
        return _build_backward(
            forward_op, set(no_grad_set), seeded=seeded
        )
