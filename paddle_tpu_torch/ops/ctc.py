"""CTC best-path decoding: `ctc_greedy_decode` of the JAX package's
`ops/ctc.py`, as a plain argmax-and-collapse.

The CTC loss and the rest of that module are still to port (ROADMAP
A9); the `ctc_edit_distance` evaluator needs only the decode.
"""

from __future__ import annotations

import torch


def ctc_greedy_decode(log_probs, input_lens, blank=0):
    """Best-path decode: argmax per step, collapse repeats, drop blanks.
    `log_probs` [B, T, C], `input_lens` [B] (tensors or array-likes).
    Returns (paths [B, T] int32 padded with blank, lens [B] int32), the
    kept tokens of each row moved to its front in time order."""
    lp = torch.as_tensor(log_probs)
    pred = lp.argmax(dim=-1).to(torch.int32)  # [B, T]
    bsz, t = pred.shape
    lens_in = torch.as_tensor(input_lens, device=pred.device)
    pos = torch.arange(t, device=pred.device)[None, :]
    valid = pos < lens_in[:, None]
    prev = torch.cat([torch.full((bsz, 1), -1, dtype=torch.int32,
                                 device=pred.device), pred[:, :-1]], dim=1)
    keep = valid & (pred != blank) & (pred != prev)
    # compact the kept tokens to the left, in order
    order = torch.argsort(torch.where(keep, pos, t + pos), dim=1,
                          stable=True)
    gathered = torch.gather(pred, 1, order)
    lens = keep.sum(dim=1).to(torch.int32)
    out = torch.where(pos < lens[:, None], gathered,
                      torch.full_like(gathered, blank))
    return out, lens
