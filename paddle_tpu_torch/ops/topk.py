"""Top-k with `lax.top_k`'s order of ties, on any device.

`torch.topk` on CUDA does not promise which of two equal scores comes
first; `lax.top_k` takes the lower index. The beam decoders, the
`kmax_seq_score` layer and the detection heads' NMS and `keep_top_k`
all select through `top_k_stable`.
"""

from __future__ import annotations

import torch


def top_k_stable(flat: torch.Tensor, k: int):
    """Row-wise top-k of [R, N] f32, equal scores ordered by the lower
    index (the `lax.top_k` contract). The key is the score's bits mapped
    to an order-preserving int32 (negative floats' magnitude bits
    flipped; -0.0 added to 0.0 first, so that the two are equal) above
    N - 1 - index: every key is distinct, and `torch.topk` of it is
    deterministic on any device."""
    bits = (flat.float() + 0.0).view(torch.int32)
    ordered = torch.where(bits < 0, bits ^ 0x7FFFFFFF, bits)
    rev = torch.arange(flat.shape[1] - 1, -1, -1, device=flat.device)
    key = ordered.to(torch.int64) * (1 << 32) + rev
    idx = torch.topk(key, k, dim=1).indices
    return torch.gather(flat, 1, idx), idx
