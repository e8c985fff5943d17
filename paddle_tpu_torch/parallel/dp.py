"""The train step: `paddle_tpu/parallel/dp.py::TrainStep` on one device.

One call runs the forward, the backward (`torch.autograd.grad` over
`Network.loss_fn`) and the optimizer update. With `watchdog=True` it
also reduces the loss and every gradient to one on-device all-finite
flag and SKIPS the whole update when any value is non-finite: params,
optimizer state and layer state keep their previous values, chosen on
the device with `torch.where`, so the happy path adds no host sync.
The step then returns the 2-float health vector `[loss, all_finite]`
in place of the scalar loss, and the caller's one fetch of it carries
both.

Left out, still to port: the mesh (data-parallel and sharded state,
ROADMAP A8), the multi-step scan dispatch and AOT compilation (PyTorch
runs eagerly; a CUDA graph is the analogue), the recompile guard.
"""

from __future__ import annotations

import torch

from paddle_tpu_torch.core.device import resolve_device


def _tree_map(fn, tree, *others):
    """fn over the tensor leaves of nested dicts (others: the same
    nesting)."""
    if isinstance(tree, dict):
        return {k: _tree_map(fn, v, *(o[k] for o in others))
                for k, v in tree.items()}
    return fn(tree, *others)


class TrainStep:
    """Forward + grad + optimizer update, on the device of `device`.
    Call with (params, opt_state, state, feed, step_i, rng, lr_scale);
    returns (new_params, new_opt_state, new_state, loss or health,
    kept outputs). The feed's tensors are moved to the device."""

    def __init__(self, net, opt, keep_outputs=None, watchdog=False,
                 device=None):
        self.net = net
        self.opt = opt
        self.device = resolve_device(device)
        self.watchdog = watchdog
        # only declared outputs leave the step: returning every layer's
        # activations would keep all intermediates alive
        self.keep = set(keep_outputs or []) | set(net.output_names) | set(
            net.cost_names
        )

    def __call__(self, params, opt_state, state, feed, step_i, rng,
                 lr_scale=None):
        feed = {k: a.to(self.device) for k, a in feed.items()}
        names = list(params)
        leaves = {k: params[k].detach().requires_grad_(True) for k in names}
        with torch.enable_grad():
            loss, (outs, new_state) = self.net.loss_fn(
                leaves, feed, state=state, train=True, rng=rng)
            got = torch.autograd.grad(loss, [leaves[k] for k in names],
                                      allow_unused=True)
        # a parameter the loss does not reach has gradient 0, as jax.grad
        # gives it
        grads = {k: torch.zeros_like(params[k]) if g is None else g
                 for k, g in zip(names, got)}
        loss = loss.detach()
        # layer state is never differentiated (the JAX step carries it
        # as aux): a running mean kept attached would chain autograd
        # nodes from step to step
        new_state = _tree_map(torch.Tensor.detach, new_state)
        new_params, new_opt_state = self.opt.update(
            grads, params, opt_state, step_i,
            lr_scale=None if lr_scale is None else float(lr_scale),
        )
        outs = {k: v for k, v in outs.items() if k in self.keep}
        if not self.watchdog:
            return new_params, new_opt_state, new_state, loss, outs
        with torch.no_grad():
            finite = torch.isfinite(loss)
            for g in grads.values():
                finite = finite & torch.isfinite(g).all()

            def keep(new, old):
                return torch.where(finite, new, old)

            new_params = {k: keep(new_params[k], params[k]) for k in names}
            new_opt_state = {
                k: {slot: keep(t, opt_state[k][slot])
                    for slot, t in new_opt_state[k].items()}
                for k in names
            }
            # a layer's state is a dict of slots ({"mean", "var"}): keep
            # each slot, as the JAX step's tree_map does
            new_state = {k: _tree_map(keep, new_state[k], state[k])
                         if k in state else new_state[k] for k in new_state}
            health = torch.stack([loss.float(), finite.float()])
        return new_params, new_opt_state, new_state, health, outs
