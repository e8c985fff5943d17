"""Autodiff by op-level transposition: the JAX package's
`framework/backward.py` on the port (pure Python over ops).

Reference: framework/backward.cc:65-109 — walk the forward net in reverse,
emit each op's registered grad op; when a forward variable feeds several
ops its gradient has several producers, so each producer is renamed to
X@GRAD@RENAME@<uid> and an accumulation op is inserted
(backward.cc:117-140); outputs whose base variables are in the no-grad
set become @EMPTY@ (grad_op_builder semantics); forward outputs that are
never consumed get fill_zeros_like seeds; RecurrentOp recurses into its
stepnet (backward.cc:193).

The caller seeds the gradient of the root outputs (the pybind/test
convention: ones for the loss). torch.autograd over `net_to_fn` gives
the same derivatives by recording the ops' tensor calls — the
transposition path is the explicit backward graph of the reference.
"""

from __future__ import annotations

import itertools
from typing import List, Set

from paddle_tpu_torch.framework.op import (
    EMPTY_VAR,
    GRAD_SUFFIX,
    NetOp,
    OperatorBase,
    create_op,
    grad_op_for,
)

_uid = itertools.count()


def _collect_grad_ops(op: OperatorBase, out: List[OperatorBase]) -> None:
    from paddle_tpu_torch.framework.recurrent import RecurrentOp

    if isinstance(op, RecurrentOp):
        out.append(op.build_grad_op())
    elif isinstance(op, NetOp):
        for child in reversed(op.ops):
            _collect_grad_ops(child, out)
    else:
        out.extend(grad_op_for(op))


def backward(
    forward_op: OperatorBase,
    no_grad: Set[str] = frozenset(),
    seeded: Set[str] = frozenset(),
) -> NetOp:
    """Build the backward NetOp of a forward op/net.

    `seeded`: forward vars whose gradients the caller feeds into the
    scope before running the backward net (the loss: ones). Every other
    gradient consumed before being produced gets a fill_zeros_like seed
    — the reference's treatment of unused forward outputs.
    """
    no_grad_g = {n + GRAD_SUFFIX for n in no_grad}
    grad_ops: List[OperatorBase] = []
    _collect_grad_ops(forward_op, grad_ops)

    # no-grad outputs -> @EMPTY@; drop fully-empty ops (backward.cc NOP)
    kept: List[OperatorBase] = []
    for gop in grad_ops:
        empty = True
        for slot, names in gop.outputs.items():
            names[:] = [
                EMPTY_VAR if n in no_grad_g else n for n in names
            ]
            empty = empty and all(n == EMPTY_VAR for n in names)
        if not empty:
            kept.append(gop)
    grad_ops = kept

    # fan-out accumulation: rename duplicate producers, insert sum
    producers: dict = {}
    for i, gop in enumerate(grad_ops):
        for names in gop.outputs.values():
            for n in names:
                if n != EMPTY_VAR and n.endswith(GRAD_SUFFIX):
                    producers.setdefault(n, []).append(i)
    net = NetOp()
    root_seeded = {n + GRAD_SUFFIX for n in seeded}
    inserted_after: dict = {}
    for name, idxs in producers.items():
        ext_seed = name in root_seeded  # caller-fed grad also a summand
        if len(idxs) > 1 or (ext_seed and idxs):
            renamed = []
            for i in idxs:
                new = f"{name}@RENAME@{next(_uid)}"
                for names in grad_ops[i].outputs.values():
                    names[:] = [new if n == name else n for n in names]
                renamed.append(new)
            summands = ([name] if ext_seed else []) + renamed
            inserted_after.setdefault(idxs[-1], []).append(
                create_op("sum", {"X": summands}, {"Out": name})
            )

    ordered: List[OperatorBase] = []
    for i, gop in enumerate(grad_ops):
        ordered.append(gop)
        ordered.extend(inserted_after.get(i, []))

    # unseeded @GRAD inputs (unused forward outputs) -> fill_zeros_like
    produced: Set[str] = set()
    final: List[OperatorBase] = []
    for gop in ordered:
        for names in gop.inputs.values():
            for n in names:
                if (
                    n.endswith(GRAD_SUFFIX)
                    and "@RENAME@" not in n
                    and n not in produced
                    and n not in root_seeded
                    and n != EMPTY_VAR
                ):
                    src = n[: -len(GRAD_SUFFIX)]
                    final.append(
                        create_op(
                            "fill_zeros_like", {"Src": src}, {"Dst": n}
                        )
                    )
                    produced.add(n)
        final.append(gop)
        produced.update(
            n for ns in gop.outputs.values() for n in ns if n != EMPTY_VAR
        )

    for gop in final:
        net.append_op(gop)
    net.complete_add_op()
    return net
