"""RecurrentOp — a step net run over time with per-step scopes: the
JAX package's `framework/recurrent.py` on the port.

Reference: operators/recurrent_op.h:44-121 (RecurrentAlgorithm: step-scope
list stored in the parent scope, SegmentInputs/ConcatOutputs over [T,...]
sequence vars, memories linked pre_var(t) <- var(t-1) with boot_var init —
rnn/recurrent_op_utils.h MemoryAttr/Link) and RecurrentGradientAlgorithm
(reverse-time walk of the backward stepnet with LinkBootMemoryGradients).

Two execution modes:
- `run(scope)`: eager, literal per-step scopes — the reference semantics,
  inspectable step state.
- `scan_fn(...)`: the stepnet closed into a plain function of tensors
  (`net_to_fn`) and driven by a Python loop over T (torch has no
  `lax.scan`); torch.autograd over it differentiates the recurrence
  without the explicit grad op, and on the card a caller may capture
  the whole loop as a CUDA graph.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Dict, List

import torch

from paddle_tpu_torch.framework.op import (
    GRAD_SUFFIX,
    NetOp,
    OperatorBase,
    as_tensor,
    net_to_fn,
)
from paddle_tpu_torch.framework.scope import Scope


@dataclass
class MemoryAttr:
    """rnn::MemoryAttr (rnn/recurrent_op_utils.h): step state `var`,
    read in-step as `pre_var`, initialized from parent-scope
    `boot_var`."""

    var: str
    pre_var: str
    boot_var: str


class RecurrentOp(OperatorBase):
    type = "recurrent"

    def __init__(
        self,
        stepnet: NetOp,
        inlinks: List[str],
        outlinks: List[str],
        memories: List[MemoryAttr],
        inputs=None,
        outputs=None,
        attrs=None,
    ):
        super().__init__(
            inputs or {"inlinks": inlinks},
            outputs or {"outlinks": outlinks},
            attrs,
        )
        self.stepnet = stepnet
        self.inlinks = list(inlinks)
        self.outlinks = list(outlinks)
        self.memories = list(memories)

    # -- eager reference semantics ------------------------------------
    def run(self, scope: Scope) -> None:
        T = None
        for name in self.inlinks:
            seq = as_tensor(scope.get(name), scope.device)
            T = seq.shape[0] if T is None else T
            assert seq.shape[0] == T, "inlink sequence lengths differ"
        step_scopes = self._create_scopes(scope, T)
        for t in range(T):
            st = step_scopes[t]
            for name in self.inlinks:  # SegmentInputs
                st.set(name, as_tensor(scope.get(name), scope.device)[t])
            for m in self.memories:  # InitMemories / link pre <- prev
                if t == 0:
                    st.set(m.pre_var,
                           as_tensor(scope.get(m.boot_var), scope.device))
                else:
                    st.set(m.pre_var, step_scopes[t - 1].get(m.var))
            self.stepnet.run(st)
        for name in self.outlinks:  # ConcatOutputs
            scope.set(
                name,
                torch.stack([step_scopes[t].get(name) for t in range(T)]),
            )

    def _create_scopes(self, scope: Scope, T: int) -> List[Scope]:
        holder = scope.var(self._scopes_name())
        if holder.value is None:
            holder.value = []
        while len(holder.value) < T:  # reuse + expand (recurrent_op.h:53)
            holder.value.append(scope.new_scope())
        return holder.value

    def _scopes_name(self) -> str:
        return f"@step_scopes@{id(self)}"

    # -- the scan path ------------------------------------------------
    def scan_fn(self, extern_names: List[str]):
        """Plain fn(extern_vals, boot_vals, inlink_seqs) ->
        outlink_seqs: the stepnet run once a step of a loop over T, the
        memories carried (the JAX package's `lax.scan`). `extern_names`
        are the parent-scope vars the stepnet reads (weights)."""
        feed = (
            list(extern_names)
            + [m.pre_var for m in self.memories]
            + self.inlinks
        )
        fetch = [m.var for m in self.memories] + self.outlinks
        step = net_to_fn(self.stepnet, feed, fetch)
        n_mem = len(self.memories)

        def fn(extern_vals, boot_vals, inlink_seqs):
            carry, ys = tuple(boot_vals), []
            for t in range(inlink_seqs[0].shape[0]):
                outs = step(*extern_vals, *carry,
                            *(x[t] for x in inlink_seqs))
                carry = tuple(outs[:n_mem])
                ys.append(outs[n_mem:])
            return tuple(torch.stack([y[i] for y in ys])
                         for i in range(len(ys[0])))

        return fn

    def extern_names(self) -> List[str]:
        """Stepnet inputs resolved from the parent scope (weights): not
        inlinks, not memories' pre_vars, not produced in-step."""
        produced = set()
        local = set(self.inlinks) | {m.pre_var for m in self.memories}
        ext: List[str] = []
        for op in self.stepnet.ops:
            for n in op.input_vars():
                if (
                    n not in local
                    and n not in produced
                    and n not in ext
                ):
                    ext.append(n)
            produced.update(op.output_vars())
        return ext

    def build_grad_op(self) -> "RecurrentGradientOp":
        return RecurrentGradientOp(self)


class RecurrentGradientOp(OperatorBase):
    """Reverse-time backward pass (RecurrentGradientAlgorithm).

    Consumes outlink grads from the parent scope, walks steps T-1..0
    running the backward stepnet in each step scope, carries the memory
    gradient pre_var@GRAD(t+1) into var@GRAD(t) (LinkBootMemoryGradients),
    stacks inlink grads, sums extern (weight) grads across steps, and
    writes boot_var@GRAD.
    """

    type = "recurrent_grad"

    def __init__(self, fwd: RecurrentOp):
        extern = fwd.extern_names()
        super().__init__(
            {"outlinks_grad": [n + GRAD_SUFFIX for n in fwd.outlinks]},
            {
                "inlinks_grad": [n + GRAD_SUFFIX for n in fwd.inlinks],
                "extern_grad": [n + GRAD_SUFFIX for n in extern],
                "boot_grad": [
                    m.boot_var + GRAD_SUFFIX for m in fwd.memories
                ],
            },
        )
        self.fwd = fwd
        self._extern = extern
        from paddle_tpu_torch.framework.backward import backward

        # per-step seeds: outlink grads (sliced from the parent) and
        # memory-var grads (the carry from step t+1)
        self.grad_stepnet = backward(
            fwd.stepnet,
            seeded=set(fwd.outlinks) | {m.var for m in fwd.memories},
        )

    def run(self, scope: Scope) -> None:
        # all writes go through the DECLARED output names so backward()'s
        # @RENAME@ fan-out rewriting and @EMPTY@/no-grad substitution on
        # this op's outputs take effect (grad_op_builder semantics)
        from paddle_tpu_torch.framework.op import EMPTY_VAR

        fwd = self.fwd
        step_scopes: List[Scope] = scope.get(fwd._scopes_name())
        T = scope.get(self.inputs["outlinks_grad"][0]).shape[0]
        extern = self._extern
        extern_acc: Dict[str, Any] = {}
        mem_carry: Dict[str, Any] = {}

        for t in reversed(range(T)):
            st = step_scopes[t]
            for name, src in zip(fwd.outlinks, self.inputs["outlinks_grad"]):
                g = as_tensor(scope.get(src), scope.device)[t]
                carried = mem_carry.pop(name, None)
                st.set(name + GRAD_SUFFIX, g if carried is None else g + carried)
            for m in self.fwd.memories:
                if m.var not in fwd.outlinks:
                    carried = mem_carry.pop(m.var, None)
                    st.set(
                        m.var + GRAD_SUFFIX,
                        torch.zeros_like(st.get(m.var))
                        if carried is None
                        else carried,
                    )
            self.grad_stepnet.run(st)
            for m, boot_tgt in zip(fwd.memories, self.outputs["boot_grad"]):
                g = st.find_var(m.pre_var + GRAD_SUFFIX)
                if g is not None and g.value is not None:
                    mem_carry[m.var] = g.value
                    if t == 0 and boot_tgt != EMPTY_VAR:
                        scope.set(boot_tgt, g.value)
            for n in extern:
                g = st.find_var(n + GRAD_SUFFIX)
                if g is not None and g.value is not None:
                    prev = extern_acc.get(n)
                    extern_acc[n] = (
                        g.value if prev is None else prev + g.value
                    )

        for name, target in zip(fwd.inlinks, self.outputs["inlinks_grad"]):
            if target != EMPTY_VAR:
                scope.set(
                    target,
                    torch.stack(
                        [
                            step_scopes[t].get(name + GRAD_SUFFIX)
                            for t in range(T)
                        ]
                    ),
                )
        for n, target in zip(extern, self.outputs["extern_grad"]):
            if target != EMPTY_VAR and n in extern_acc:
                scope.set(target, extern_acc[n])
