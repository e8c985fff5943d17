"""Generic numeric gradient checking for framework ops, on the port.

Reference: python/paddle/v2/framework/tests/gradient_checker.py — a
reusable, per-op harness: `get_numeric_gradient` central-differences any
op's input against the sum of one output; `GradientChecker.check_grad`
runs the registered backward op and compares, with the reference's
relative-error rule (abs error where the analytic grad is ~0).

Kernels are plain functions of tensors, so the numeric probe perturbs a
host numpy copy and re-runs the eager kernel on the CPU — no tensor
set_dims/alloc choreography — and the analytic side comes from the
op-transposition backward net (`paddle_tpu_torch.framework.backward`),
run at every place: the CPU, and the card where there is one (the
reference's CPUPlace / GPUPlace arms; `only_cpu` keeps the CPU's).
"""

from __future__ import annotations

import unittest

import numpy as np
import torch

from paddle_tpu_torch.compat.v2_framework import core
from paddle_tpu_torch.compat.v2_framework.op import Operator
from paddle_tpu_torch.framework.backward import backward as _build_backward
from paddle_tpu_torch.framework.op import EMPTY_VAR, GRAD_SUFFIX

__all__ = ["get_numeric_gradient", "GradientChecker", "create_op",
           "grad_var_name"]


def grad_var_name(var_name: str) -> str:
    return var_name + GRAD_SUFFIX


def create_op(op_type: str):
    """Op with every slot wired to its own name (reference
    gradient_checker.create_op)."""
    kwargs = {}
    for name in Operator.get_op_input_names(op_type):
        kwargs[name] = name
    for name in Operator.get_op_output_names(op_type):
        kwargs[name] = name
    return Operator(op_type, **kwargs)


def _run_forward(op, input_values: dict, device="cpu") -> core.Scope:
    scope = core.Scope(device=device)
    for name, value in input_values.items():
        # made f32 tensors on the scope's device as the op reads them;
        # integer index arrays keep their dtype
        scope.set(name, np.asarray(value))
    op.run(scope)
    return scope


def _host(value) -> np.ndarray:
    if isinstance(value, torch.Tensor):
        return value.cpu().numpy()
    return np.asarray(value)


def get_numeric_gradient(op, input_values: dict, output_name: str,
                         input_to_check: str, delta: float = 0.005):
    """d(sum(output_name)) / d(input_to_check) by central differences.
    Perturbs one element at a time, exactly the reference's method."""
    base = {}
    for k, v in input_values.items():
        a = np.asarray(v)
        # float inputs get float64 probes; integer inputs (indices,
        # labels) keep their dtype
        base[k] = (
            a.astype(np.float64)
            if np.issubdtype(a.dtype, np.floating)
            else a.copy()
        )
    x = base[input_to_check]
    grad = np.zeros(x.size, np.float64)

    def out_sum() -> float:
        return float(np.sum(_host(_run_forward(op, base).get(
            output_name))))

    flat = x.reshape(-1)
    for i in range(x.size):
        origin = flat[i]
        flat[i] = origin + delta
        y_pos = out_sum()
        flat[i] = origin - delta
        y_neg = out_sum()
        flat[i] = origin
        grad[i] = (y_pos - y_neg) / (2.0 * delta)
    return grad.reshape(x.shape).astype(np.float32)


class GradientChecker(unittest.TestCase):
    """Reusable base class: subclass and call check_grad with any
    registered op (reference GradientChecker.check_grad)."""

    def assert_is_close(self, numeric_grads: dict, scope: core.Scope,
                        max_relative_error: float, msg_prefix: str):
        for name, a in numeric_grads.items():
            b = _host(scope.get(grad_var_name(name)))
            abs_a = np.abs(a)
            # near-zero analytic entries use absolute error (reference
            # rule: relative error blows up around 0)
            abs_a[abs_a < 1e-3] = 1.0
            diff = np.abs(a - b) / abs_a
            max_diff = float(np.max(diff))
            self.assertLessEqual(
                max_diff, max_relative_error,
                f"{msg_prefix} variable {name}: max gradient diff "
                f"{max_diff} over limit {max_relative_error}",
            )

    def check_grad(self, forward_op, input_vars: dict,
                   inputs_to_check, output_name: str,
                   no_grad_set=None, max_relative_error: float = 0.005,
                   only_cpu: bool = False):
        no_grad_set = set(no_grad_set or ())
        in_names = forward_op.input_vars()
        for no_grad in no_grad_set:
            if no_grad not in in_names:
                raise ValueError(f"no_grad {no_grad!r} not an op input")

        # numeric side
        numeric = {
            name: get_numeric_gradient(
                forward_op, input_vars, output_name, name
            )
            for name in inputs_to_check
        }

        # analytic side, at every place: forward once, seed
        # d(output)=ones, run the transposed net
        backward_op = _build_backward(
            forward_op, no_grad_set, seeded={output_name}
        )
        places = [core.CPUPlace()]
        if not only_cpu and core.is_compile_gpu():
            places.append(core.GPUPlace(0))
        for place in places:
            scope = _run_forward(forward_op, input_vars, place.device)
            for names in forward_op.outputs.values():
                for n in names:
                    if n != EMPTY_VAR:
                        shape = tuple(scope.get(n).shape)
                        scope.set(
                            grad_var_name(n),
                            np.ones(shape, np.float32)
                            if n == output_name
                            else np.zeros(shape, np.float32),
                        )
            backward_op.run(scope)
            self.assert_is_close(
                numeric, scope, max_relative_error,
                f"gradient check at {place}:"
            )
