"""The port's kernels as `torch.library` custom ops.

Every hand-written kernel entry point (B1-B9) is an op of the namespace
`paddle_tpu_torch` (`torch.ops.paddle_tpu_torch.<name>`), so that
PyTorch's own tracing (`torch.export`, fake tensors) sees it as one
node. Each op has

- a CUDA implementation: the kernel's wrapper, which launches the
  kernel and counts the launch, or raises;
- a CPU implementation: the kernel's plain version;
- a fake implementation: the outputs' shapes and dtypes from the inputs
  alone, allocating nothing on a device.

A tensor on any other device finds no implementation and raises. The
forward ops register their autograd formulas (`register_autograd`),
which call the backward ops.

The ops are defined through a `torch.library.Library` and its `impl`,
not `torch.library.custom_op`: custom_op wraps every implementation in
`torch._disable_dynamo`, whose first call imports `torch._dynamo`
(seconds in each process that launches a kernel), and checks its
outputs' aliasing on every call. The outputs alias no input (the tests'
`opcheck` holds every op to that).
"""

from __future__ import annotations

import torch

NAMESPACE = "paddle_tpu_torch"
# the names of the namespace's ops, as the kernel modules register them
OPS: list = []
_LIB = torch.library.Library(NAMESPACE, "DEF")


def define(name: str, schema: str, cuda, cpu, fake):
    """The op `NAMESPACE::name` with `schema` (its arguments and
    returns), `cuda` for CUDA tensors, `cpu` for CPU tensors and `fake`
    for fake ones; returns its OpOverload."""
    _LIB.define(name + schema)
    _LIB.impl(name, cuda, "CUDA")
    _LIB.impl(name, cpu, "CPU")
    torch.library.register_fake(f"{NAMESPACE}::{name}", fake, lib=_LIB)
    OPS.append(name)
    return getattr(getattr(torch.ops, NAMESPACE), name).default


def register_autograd(op, backward, setup_context) -> None:
    """`op`'s autograd formula: `setup_context(ctx, inputs, output)`
    saves what `backward(ctx, *grads)` needs.

    Registered as the op's Autograd kernel: where gradients are enabled
    and an input needs one, an autograd Function around the op run below
    autograd; else the op below autograd. `torch.library.
    register_autograd` does the same through pytree flattening and
    default filling in Python on every call: ~75 µs a call more on the
    host of an H100 machine (`op_host_probe.py`)."""
    below = torch._C._AutoDispatchBelowAutograd
    # the dispatcher leaves trailing arguments at their defaults out
    defaults = tuple(a.default_value for a in op._schema.arguments)

    class Formula(torch.autograd.Function):
        @staticmethod
        def forward(ctx, *args):
            with below():
                out = op(*args)
            setup_context(ctx, args, out)
            return out

        @staticmethod
        def backward(ctx, *grads):
            return backward(ctx, *grads)

    def kernel(*args):
        args = args + defaults[len(args):]
        if torch.is_grad_enabled() and any(
                isinstance(a, torch.Tensor) and a.requires_grad
                for a in args):
            return Formula.apply(*args)
        with below():
            return op(*args)

    _LIB.impl(op._schema.name.split("::")[1], kernel, "Autograd")
