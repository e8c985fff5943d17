"""Mixture-of-Experts routing and the expert FFN:
`paddle_tpu/ops/moe.py` on torch.

Switch-style fixed-capacity top-1 routing: the token -> expert
assignment becomes dense dispatch and combine tensors (static shapes).
Tokens route within fixed-size groups (GShard's [G, S, ...] layout), so
the dispatch tensors stay O(N * group_size) instead of O(N^2). The aux
load-balancing loss is GShard/Switch's eq. 4. The JAX package runs this
as dense einsums with no Pallas kernel; so does the port.

Expert parallelism (the `expert_sharded` placement of
`parallel/sharding.py`, which the JAX package leaves to GSPMD): with
the rank's shard of the experts ([E / m, ...] over the mesh's `model`
axis of m ranks), the routing and the dispatch tensor run on every rank
of the axis (they hold the same tokens), each rank takes its slice of
every expert's capacity slots, an all-to-all sends each expert's slots
to the rank that owns it, the rank runs its experts over every slot, an
all-to-all sends the results back, and an all-gather makes the
combine's input whole (`parallel/collectives.py`: split, all_to_all,
gather). A capacity that does not divide over the axis is padded with
empty slots, which the combine weights with 0.

Inside a data-parallel step (`core/mesh.py::batch_context`) tokens
route in the groups of the global batch (a rank's tokens must be whole
groups) and the balance loss is the global batch's, its sums
all-reduced over the data axis.
"""

from __future__ import annotations

import torch


def _one_hot(idx, n: int):
    """[..., n] f32 one-hot of int `idx`; an index outside [0, n) gives
    a zero row (as `jax.nn.one_hot`)."""
    return (idx[..., None] == torch.arange(n, device=idx.device)).float()


def _route(gate_logits, capacity: int, token_mask=None):
    """top1_routing over gate_logits [..., N, E] (leading dims: groups),
    token_mask [..., N]: (dispatch, combine [..., N, E, C], aux [...])."""
    n, e = gate_logits.shape[-2:]
    probs = torch.softmax(gate_logits, dim=-1)
    gate, expert = torch.max(probs, dim=-1)   # the first max, as argmax
    # rank accounting in f32 whatever the activation dtype: a bf16
    # cumsum loses integer exactness past 256 and collides capacity
    # slots under AMP
    onehot = _one_hot(expert, e)                          # [..., N, E]
    if token_mask is not None:
        onehot = onehot * token_mask.float()[..., None]
    # rank of each token within its expert (0-based arrival order)
    pos = torch.cumsum(onehot, dim=-2) - onehot
    pos_in_expert = (pos * onehot).sum(-1).to(torch.int32)  # [..., N]
    keep = pos_in_expert < capacity
    if token_mask is not None:
        keep = keep & (token_mask > 0)
    gate = gate * keep
    dispatch = (onehot[..., :, None] * _one_hot(pos_in_expert, capacity)
                [..., None, :] * keep[..., None, None]).to(probs.dtype)
    combine = dispatch * gate[..., None, None]
    # load balance (Switch eq. 4): E * sum_e f_e * p_e over real tokens
    if token_mask is None:
        denom = float(n)
        probs_sum = probs.sum(dim=-2)
    else:
        denom = torch.clamp_min(token_mask.sum(-1), 1.0)[..., None]
        probs_sum = (probs * token_mask[..., None]).sum(dim=-2)
    frac_tokens = onehot.sum(dim=-2) / denom
    frac_probs = probs_sum / denom
    aux = e * (frac_tokens * frac_probs).sum(-1)
    return dispatch, combine, aux


def top1_routing(gate_logits, capacity: int, token_mask=None):
    """gate_logits [N, E] -> (dispatch [N, E, C] one-hot, combine
    [N, E, C] prob-weighted, aux_loss scalar).

    Tokens beyond an expert's capacity C are dropped (Switch); a
    token's slot in its expert's buffer is its rank among the tokens
    routed there. `token_mask` [N] (1 = real) excludes padded tokens
    before the rank cumsum, so padding never consumes expert capacity or
    skews the balance statistics."""
    return _route(gate_logits, capacity, token_mask)


def _experts(xin, w_in, w_out, activation, mesh, axis):
    """yout [G, E, C, D] of the experts over their input buffers xin
    [G, E, C, D]; with a shard of the experts, expert-parallel over
    `axis`."""
    e, e_local = xin.shape[1], w_in.shape[0]
    if e_local == e:
        h = activation(torch.einsum("gecd,edh->gech", xin, w_in))
        return torch.einsum("gech,ehd->gecd", h, w_out)
    from paddle_tpu_torch.parallel import collectives as C

    m = mesh.axis_size(axis) if mesh is not None else 1
    if m * e_local != e:
        raise ValueError(
            f"{e_local} local experts of {e} need a {axis!r} axis of "
            f"{e // e_local} ranks (mesh {getattr(mesh, 'shape', None)})")
    c = xin.shape[2]
    pad = -c % m
    if pad:
        xin = torch.nn.functional.pad(xin, (0, 0, 0, pad))
    # this rank's slice of every expert's slots, then each expert's
    # slots to its owner: [G, E/m, C, D]
    xe = C.all_to_all(C.split(xin, mesh, axis, 2), mesh, axis, 1, 2)
    h = activation(torch.einsum("gecd,edh->gech", xe, w_in))
    ye = torch.einsum("gech,ehd->gecd", h, w_out)
    # back to the slots' ranks [G, E, C/m, D], whole again [G, E, C, D]
    yout = C.gather(C.all_to_all(ye, mesh, axis, 2, 1), mesh, axis, 2)
    return yout[:, :, :c]


def moe_ffn(x, router_w, w_in, w_out, capacity_factor: float = 1.25,
            activation=torch.relu, token_mask=None, group_size: int = 1024,
            mesh=None, axis: str = "model"):
    """x [N, D]; router_w [D, E]; w_in [E, D, H]; w_out [E, H, D].
    Returns (y [N, D], aux_loss). token_mask [N] excludes padding from
    routing entirely.

    Tokens route within groups of S = min(group_size, N); N is padded
    up to a multiple of S with masked tokens (a prime N must not
    collapse to one-token groups, which would disable the capacity
    discipline), so dispatch and combine are [G, S, E, C] with C =
    cf * S / E.

    w_in / w_out may be this rank's shard of the experts over `axis` of
    `mesh` (expert parallelism, see the module's docstring)."""
    from paddle_tpu_torch.core.mesh import DATA_AXIS, batch_mesh

    n = x.shape[0]
    e = router_w.shape[1]
    bm = batch_mesh()
    ranks = bm.axis_size(DATA_AXIS) if bm is not None else 1
    s = min(group_size, n * ranks)
    if ranks > 1 and n % s:
        raise ValueError(
            f"{n} tokens a rank are not whole routing groups of {s} (the "
            f"global batch's {n * ranks} tokens in groups of "
            f"{group_size}); each data rank must hold whole groups")
    g = -(-n // s)
    pad = g * s - n
    mask = (token_mask.float() if token_mask is not None
            else x.new_ones((n,), dtype=torch.float32))
    if pad:
        x = torch.cat([x, x.new_zeros((pad,) + tuple(x.shape[1:]))])
        mask = torch.cat([mask, mask.new_zeros((pad,))])
    capacity = max(int(capacity_factor * s / e), 1)
    logits = (x @ router_w).reshape(g, s, e)
    xg = x.reshape(g, s, -1)
    mg = mask.reshape(g, s)
    dispatch, combine, aux = _route(logits, capacity, mg)
    # [G, E, C, D]: each group's expert input buffers
    xin = torch.einsum("gsd,gsec->gecd", xg, dispatch)
    yout = _experts(xin, w_in, w_out, activation, mesh, axis)
    y = torch.einsum("gecd,gsec->gsd", yout, combine)
    # aux weighted by each group's real tokens: an all-padding group adds
    # nothing, as the ungrouped loss
    real_g = mg.sum(1)
    num, den = (aux * real_g).sum(), real_g.sum()
    if ranks > 1:
        from paddle_tpu_torch.parallel import collectives as C

        num, den = C.all_reduce(torch.stack([num, den.to(num.dtype)]), bm,
                                DATA_AXIS).unbind(0)
    aux = num / torch.clamp_min(den, 1.0)
    return y.reshape(g * s, -1)[:n], aux
