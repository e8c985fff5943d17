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


def host_to_device(t: torch.Tensor, device) -> torch.Tensor:
    """Host tensor `t` on `device`. To a CUDA device it goes through
    pinned memory with an asynchronous copy, so the host does not wait
    for the work already queued on the stream (a copy from pageable
    memory would). PyTorch's pinned-memory cache keeps the staging
    buffer until the copy has run."""
    device = torch.device(device)
    if device.type != "cuda" or t.device.type == "cuda":
        return t.to(device)
    return t.pin_memory().to(device, non_blocking=True)
