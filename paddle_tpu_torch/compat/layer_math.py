"""trainer_config_helpers.layer_math — arithmetic on layer handles.

Reference: python/paddle/trainer_config_helpers/layer_math.py — unary
math ops (exp/log/abs/sigmoid/tanh/square/relu/sqrt/reciprocal) as
identity-projection mixed layers, plus +,-,* operators patched onto
LayerOutput: layer+scalar -> slope_intercept(intercept), layer+layer ->
sum of identity projections (with size-1 broadcast via repeat),
layer*scalar -> slope_intercept(slope), layer*size-1-layer ->
scaling_layer. Importing this module applies the same operators to
paddle_tpu_torch's LayerRef (the reference patches its LayerOutput the same
way, layer_math.py:72-127).
"""

from __future__ import annotations

import numbers

from paddle_tpu_torch import dsl
from paddle_tpu_torch.compat import layers_v1 as _v1

__all__ = []


def _register_unary(op_name, act_name):
    def op(input, name=None):
        return dsl.mixed(
            0, [_v1.identity_projection(_v1._one(input))],
            name=name, act=act_name, bias=False,
        )

    op.__name__ = op_name
    globals()[op_name] = op
    __all__.append(op_name)


_register_unary("exp", "exponential")
_register_unary("log", "log")
_register_unary("abs", "abs")
_register_unary("sigmoid", "sigmoid")
_register_unary("tanh", "tanh")
_register_unary("square", "square")
_register_unary("relu", "relu")
_register_unary("sqrt", "sqrt")
_register_unary("reciprocal", "reciprocal")


def _size(ref):
    return ref.builder.conf.layer(ref.name).size


def _as_ref(x):
    """Unwrap the mixed-layer builder proxy to its LayerRef."""
    return x._ref if isinstance(x, _v1._MixedLayerBuilder) else x


def _add_op(layeroutput, other):
    layeroutput, other = _as_ref(layeroutput), _as_ref(other)
    if isinstance(other, numbers.Number):
        return dsl.slope_intercept(layeroutput, intercept=float(other))
    a, b = layeroutput, other
    if _size(a) != _size(b):
        if _size(b) == 1:
            b = dsl.repeat(b, _size(a))
        elif _size(a) == 1:
            a, b = b, dsl.repeat(a, _size(b))
        else:
            raise ValueError(
                "layers can be added only with equal sizes or one "
                f"size-1 operand (got {_size(a)} and {_size(b)})"
            )
    return dsl.addto(a, b)


def _sub_op(layeroutput, other):
    layeroutput, other = _as_ref(layeroutput), _as_ref(other)
    if isinstance(other, numbers.Number):
        return dsl.slope_intercept(layeroutput, intercept=-float(other))
    return _add_op(layeroutput, dsl.slope_intercept(other, slope=-1.0))


def _rsub_op(layeroutput, other):
    return _add_op(dsl.slope_intercept(_as_ref(layeroutput), slope=-1.0),
                   other)


def _mul_op(layeroutput, other):
    layeroutput, other = _as_ref(layeroutput), _as_ref(other)
    if isinstance(other, numbers.Number):
        return dsl.slope_intercept(layeroutput, slope=float(other))
    if _size(layeroutput) == 1:
        return dsl.scaling(layeroutput, other)
    if _size(other) == 1:
        return dsl.scaling(other, layeroutput)
    raise ValueError(
        "'*' needs a number or a size-1 layer operand (use "
        "dotmul_operator for elementwise products)"
    )


dsl.LayerRef.__add__ = _add_op
dsl.LayerRef.__radd__ = _add_op
dsl.LayerRef.__sub__ = _sub_op
dsl.LayerRef.__rsub__ = _rsub_op
dsl.LayerRef.__mul__ = _mul_op
dsl.LayerRef.__rmul__ = _mul_op
