"""paddle.v2.framework.op on the port — the Operator factory.

Reference: python/paddle/v2/framework/op.py (OperatorFactory over
get_all_op_protos(): `Operator(type, SlotName="var", ..., attr=value)`
builds an op wiring slot names to scope variable names). Slot
signatures come from the engine registry's OpProto declarations
(`paddle_tpu_torch.framework.op.op_signature`).
"""

from __future__ import annotations

from paddle_tpu_torch.framework.op import (
    EMPTY_VAR,
    create_op,
    op_signature,
    op_types,
)

# reference spellings kept importable (add_op.cc REGISTER_OP(add_two))
_ALIASES = {"add_two": "add"}


def _resolve(type_name: str) -> str:
    return _ALIASES.get(type_name, type_name)


class _OperatorFactory:
    """Operator(type, **kwargs): slot-name kwargs select variable names,
    attr-name kwargs set attributes (reference op.py __impl__)."""

    def __call__(self, type_name: str, **kwargs):
        t = _resolve(type_name)
        in_slots, out_slots, attr_names = op_signature(t)
        inputs, outputs, attrs = {}, {}, {}
        for k, v in kwargs.items():
            if k in in_slots:
                inputs[k] = v
            elif k in out_slots:
                outputs[k] = v
            elif k in attr_names:
                attrs[k] = v
            else:
                raise ValueError(
                    f"{type_name}: {k!r} is not an input/output/attr "
                    f"(inputs {in_slots}, outputs {out_slots}, "
                    f"attrs {attr_names})"
                )
        for slot in in_slots:
            inputs.setdefault(slot, EMPTY_VAR)
        for slot in out_slots:
            outputs.setdefault(slot, EMPTY_VAR)
        return create_op(t, inputs, outputs, attrs)

    @staticmethod
    def get_op_input_names(type_name: str):
        return list(op_signature(_resolve(type_name))[0])

    @staticmethod
    def get_op_output_names(type_name: str):
        return list(op_signature(_resolve(type_name))[1])

    @staticmethod
    def get_op_attr_names(type_name: str):
        return list(op_signature(_resolve(type_name))[2])

    @staticmethod
    def types():
        return op_types()


Operator = _OperatorFactory()
