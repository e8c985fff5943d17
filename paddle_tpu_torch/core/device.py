"""Device selection: the card unless the caller asks for the CPU.

Every entry point of the port takes a `device` argument and resolves
it here. `None` means `"cuda"`. On a machine with no CUDA device a
`None` or CUDA device raises instead of continuing quietly on the
CPU: a CPU run must be asked for (`device="cpu"`), as the tests do.
"""

from __future__ import annotations

import torch


def resolve_device(device=None) -> torch.device:
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                "no CUDA device is available; pass device='cpu' to run "
                "on the CPU"
            )
        # everything on the port's paths is f32, as in the JAX
        # package: full-precision matmuls, never TF32 (which keeps
        # ~3 decimal digits and would break parity with the
        # reference)
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
    return dev
