"""Mixture-of-Experts routing and the expert FFN:
`paddle_tpu/ops/moe.py` on torch, on one device.

Switch-style fixed-capacity top-1 routing: the token -> expert
assignment becomes dense dispatch and combine tensors (static shapes).
Tokens route within fixed-size groups (GShard's [G, S, ...] layout), so
the dispatch tensors stay O(N * group_size) instead of O(N^2). The aux
load-balancing loss is GShard/Switch's eq. 4. The JAX package runs this
as dense einsums with no Pallas kernel; so does the port.

The expert sharding of the JAX package (the `expert_sharded`
placement, through `parallel/sharding.py`) needs a mesh (ROADMAP A8).
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


def moe_ffn(x, router_w, w_in, w_out, capacity_factor: float = 1.25,
            activation=torch.relu, token_mask=None, group_size: int = 1024):
    """x [N, D]; router_w [D, E]; w_in [E, D, H]; w_out [E, H, D].
    Returns (y [N, D], aux_loss). token_mask [N] excludes padding from
    routing entirely.

    Tokens route within groups of S = min(group_size, N); N is padded
    up to a multiple of S with masked tokens (a prime N must not
    collapse to one-token groups, which would disable the capacity
    discipline), so dispatch and combine are [G, S, E, C] with C =
    cf * S / E."""
    n = x.shape[0]
    e = router_w.shape[1]
    s = min(group_size, n)
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
    h = activation(torch.einsum("gecd,edh->gech", xin, w_in))
    yout = torch.einsum("gech,ehd->gecd", h, w_out)
    y = torch.einsum("gecd,gsec->gsd", yout, combine)
    # aux weighted by each group's real tokens: an all-padding group adds
    # nothing, as the ungrouped loss
    real_g = mg.sum(1)
    aux = (aux * real_g).sum() / torch.clamp_min(real_g.sum(), 1.0)
    return y.reshape(g * s, -1)[:n], aux
