"""ctypes wrapper over the native C++ optimizer library —
`paddle_tpu/native/optimizer.py` for the port, over the port's own
build of `src/optimizer.cc`.

Host-side optimizer with portable serialized state — the paddle/optimizer
capability (SURVEY.md §2 row 9). The training path applies optimizers on
the card (paddle_tpu_torch/optimizers/); this one serves host-resident
parameters (e.g. CPU-offloaded embedding shards) and state round-trips.
Its state bytes are the JAX package's library's: the same source.
"""

from __future__ import annotations

import ctypes

import numpy as np

from paddle_tpu_torch.native import load


class NativeOptimizer:
    def __init__(
        self,
        method: str,
        n: int,
        learning_rate: float = 0.01,
        momentum: float = 0.0,
        epsilon: float = 1e-6,
        rho: float = 0.95,
        beta1: float = 0.9,
        beta2: float = 0.999,
        decay: float = 0.0,
        lr_policy: str = "const",
        lr_decay_a: float = 0.0,
        lr_decay_b: float = 0.0,
    ):
        self._lib = load()
        self._n = int(n)
        self._h = self._lib.pt_optimizer_create(
            method.encode(), self._n, learning_rate, momentum, epsilon,
            rho, beta1, beta2, decay, lr_policy.encode(),
            lr_decay_a, lr_decay_b,
        )
        if not self._h:
            raise ValueError(f"unknown method/policy: {method}/{lr_policy}")

    def update(self, param: np.ndarray, grad: np.ndarray, step: int) -> None:
        """In-place update of `param` (float32, C-contiguous)."""
        assert param.dtype == np.float32 and param.flags["C_CONTIGUOUS"]
        assert param.size == self._n and grad.size == self._n
        grad = np.ascontiguousarray(grad, np.float32)
        fp = ctypes.POINTER(ctypes.c_float)
        self._lib.pt_optimizer_update(
            self._h,
            param.ctypes.data_as(fp),
            grad.ctypes.data_as(fp),
            self._n,
            step,
        )

    def get_state(self) -> bytes:
        size = self._lib.pt_optimizer_state_size(self._h)
        buf = ctypes.create_string_buffer(size)
        got = self._lib.pt_optimizer_get_state(self._h, buf, size)
        if got < 0:
            raise RuntimeError("optimizer state serialization failed")
        return buf.raw[:got]

    def set_state(self, state: bytes) -> None:
        rc = self._lib.pt_optimizer_set_state(self._h, state, len(state))
        if rc != 0:
            raise ValueError(f"bad optimizer state (code {rc})")

    def __del__(self):
        h = getattr(self, "_h", None)
        if h:
            self._lib.pt_optimizer_destroy(h)
            self._h = None
