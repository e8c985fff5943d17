"""The op framework — imperative op graphs over Scopes, on the port.

The JAX package's `framework/` (its module docstring names the
reference: Variable/Scope, OperatorBase + registry, autodiff by
op-level transposition, NetOp, the RecurrentOp with per-step scopes)
with the ops' kernels written as plain functions of torch tensors. The
same graph runs eagerly op by op (`run(scope)`), or `net_to_fn` closes
it over a feed list into a plain function of tensors, which a caller
on the card may capture as a CUDA graph (the JAX package jit-compiles
it). `RecurrentOp.scan_fn` walks T in a Python loop that autograd
differentiates (torch has no `lax.scan`).

Same exported names as the JAX package. An op runs on its device: its
`device` attribute, else its scope's (`Scope(device=...)`, inherited by
kid scopes); None is the card, as at every entry point of the port, and
a CPU run is asked for with `device="cpu"`. A numpy value an op reads
becomes a tensor there, a tensor stays where it lies; the random ops
draw there from a torch.Generator seeded from their `seed` attribute
(their values are not the JAX package's; their shape, dtype and
moments are).
"""

from paddle_tpu_torch.framework.scope import Scope, Variable  # noqa: F401
from paddle_tpu_torch.framework.op import (  # noqa: F401
    GRAD_SUFFIX,
    NetOp,
    OperatorBase,
    create_op,
    grad_op_for,
    net_to_fn,
    register_grad,
    register_op,
)
from paddle_tpu_torch.framework import ops  # noqa: F401
from paddle_tpu_torch.framework.backward import backward  # noqa: F401
from paddle_tpu_torch.framework.recurrent import (  # noqa: F401
    MemoryAttr,
    RecurrentGradientOp,
    RecurrentOp,
)
