"""Arg — the inter-layer data packet, on torch tensors.

The counterpart of `paddle_tpu/core/arg.py`: a dense value plus
optional integer ids and sequence metadata. Sequences are dense-packed
as there: value [B, T, ...] padded to the batch's length, `seq_lens`
[B] int32, masks derived on demand.

Dtypes: `ids` are int64, the index type `torch.gather` and advanced
indexing take (the JAX package keeps int32); `seq_lens` and
`subseq_lens` stay int32, the type the flash kernels read.
"""

from __future__ import annotations

from dataclasses import dataclass, replace
from typing import Optional

import torch


@dataclass(frozen=True)
class Arg:
    # dense value: [B, ...] (non-seq) or [B, T, ...] (seq)
    value: Optional[torch.Tensor] = None
    # integer ids, same leading shape as value (sparse/index inputs)
    ids: Optional[torch.Tensor] = None
    # [B] int32 lengths; None => not a sequence
    seq_lens: Optional[torch.Tensor] = None
    # [B, S] int32 sub-sequence lengths (nested sequences); zero-padded
    subseq_lens: Optional[torch.Tensor] = None

    @property
    def is_seq(self) -> bool:
        return self.seq_lens is not None

    @property
    def max_len(self) -> int:
        a = self.value if self.value is not None else self.ids
        return a.shape[1]

    def bool_mask(self) -> torch.Tensor:
        """[B, T] True where a timestep is real, False where padding."""
        assert self.is_seq
        pos = torch.arange(self.max_len, device=self.seq_lens.device)
        return pos[None, :] < self.seq_lens[:, None]

    def mask(self, dtype=torch.float32) -> torch.Tensor:
        """[B, T] 1.0 where a timestep is real, 0.0 where padding."""
        return self.bool_mask().to(dtype)

    def with_value(self, value: torch.Tensor) -> "Arg":
        return replace(self, value=value)

    def to(self, device) -> "Arg":
        """The same Arg with every tensor on `device`."""
        def mv(x):
            return None if x is None else x.to(device)

        return Arg(value=mv(self.value), ids=mv(self.ids),
                   seq_lens=mv(self.seq_lens),
                   subseq_lens=mv(self.subseq_lens))


def _tensor(x, dtype, device=None):
    if x is None:
        return None
    if torch.is_tensor(x):
        return x.to(dtype=dtype, device=device or x.device)
    return torch.as_tensor(x, dtype=dtype, device=device)


def non_seq(value, device=None) -> Arg:
    return Arg(value=_tensor(value, torch.float32, device))


def seq(value, seq_lens, device=None) -> Arg:
    return Arg(value=_tensor(value, torch.float32, device),
               seq_lens=_tensor(seq_lens, torch.int32, device))


def id_arg(ids, seq_lens=None, device=None) -> Arg:
    """Ids (numpy or tensor) -> Arg with int64 ids and int32 lengths.
    A numpy input lands on `device` (default the CPU); the train step
    moves the feed to the parameters' device."""
    return Arg(ids=_tensor(ids, torch.int64, device),
               seq_lens=_tensor(seq_lens, torch.int32, device))
