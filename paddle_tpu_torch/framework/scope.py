"""Variable and hierarchical Scope: the JAX package's
`framework/scope.py`, pure Python.

Reference: framework/variable.h:24 (type-erased holder), framework/scope.h:36
(name->Variable map with parent lookup chain, scope.h:52-59 NewScope/parent).
A Variable holds a tensor, a numpy array or any Python object (e.g. the
step-scope list a RecurrentOp stores in its parent scope,
operators/recurrent_op.h:49-52).

A scope also names the device its ops put what they make: the numpy
values they read and the random ops' draws (`device`, inherited by its
kid scopes; None: the card, as every entry point of the port).
"""

from __future__ import annotations

from typing import Any, Dict, List, Optional


class Variable:
    __slots__ = ("name", "value")

    def __init__(self, name: str, value: Any = None):
        self.name = name
        self.value = value

    def is_initialized(self) -> bool:
        return self.value is not None


class Scope:
    """Hierarchical variable store. Lookup walks to the parent
    (scope.h:52-59); creation is always local."""

    def __init__(self, parent: Optional["Scope"] = None, device=None):
        self.parent = parent
        self._device = device
        self._vars: Dict[str, Variable] = {}
        self._kids: List["Scope"] = []

    @property
    def device(self):
        """This scope's device, else its parent's (None: the card)."""
        if self._device is not None or self.parent is None:
            return self._device
        return self.parent.device

    def new_scope(self) -> "Scope":
        kid = type(self)(parent=self)  # subclass-preserving (core.Scope)
        self._kids.append(kid)
        return kid

    def var(self, name: str) -> Variable:
        """Find-or-create in THIS scope (scope.h Var())."""
        v = self._vars.get(name)
        if v is None:
            v = self._vars[name] = Variable(name)
        return v

    def find_var(self, name: str) -> Optional[Variable]:
        v = self._vars.get(name)
        if v is not None:
            return v
        return self.parent.find_var(name) if self.parent else None

    def get(self, name: str) -> Any:
        v = self.find_var(name)
        if v is None:
            raise KeyError(f"variable {name!r} not found in scope")
        return v.value

    def set(self, name: str, value: Any) -> None:
        self.var(name).value = value

    def local_names(self) -> List[str]:
        return list(self._vars)

    def __contains__(self, name: str) -> bool:
        return self.find_var(name) is not None
