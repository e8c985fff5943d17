"""Class registries keyed by type name.

Equivalent in spirit to the reference's ClassRegistrar
(paddle/utils/ClassRegistrar.h) and the REGISTER_LAYER /
REGISTER_EVALUATOR macros (paddle/gserver/layers/Layer.h:30-37,
paddle/gserver/evaluators/Evaluator.cpp), but a plain decorator-based
Python registry: TPU-side compute is jit-compiled functions, so there is
no need for per-device kernel registration.
"""

from __future__ import annotations


class Registry:
    def __init__(self, kind: str):
        self.kind = kind
        self._table: dict[str, type] = {}

    def register(self, *names):
        def deco(cls):
            for n in names:
                if n in self._table:
                    raise KeyError(f"duplicate {self.kind} type {n!r}")
                self._table[n] = cls
            cls.type_names = tuple(names)
            return cls

        return deco

    def get(self, name: str) -> type:
        try:
            return self._table[name]
        except KeyError:
            known = ", ".join(sorted(self._table))
            raise KeyError(
                f"unknown {self.kind} type {name!r}; registered: {known}"
            ) from None

    def __contains__(self, name: str) -> bool:
        return name in self._table

    def names(self):
        return sorted(self._table)


LAYERS = Registry("layer")
ACTIVATIONS = Registry("activation")
EVALUATORS = Registry("evaluator")
OPTIMIZERS = Registry("optimizer")
LR_SCHEDULERS = Registry("lr_scheduler")
PROJECTIONS = Registry("projection")
OPERATORS = Registry("operator")
DATA_PROVIDERS = Registry("data_provider")
