"""RNG plumbing: explicit torch.Generators.

The counterpart of `paddle_tpu/core/rng.py`. JAX keys are split
functionally; a torch.Generator is a stateful stream, so the port
derives a fresh generator from a 64-bit seed wherever the JAX package
folds a key: the trainer owns a root seed, a step's generator is
seeded from (root, step), and a layer's from (step generator, name)
(`layers/base.py::Ctx.split`). The numbers differ from `jax.random`'s
for the same seed: parity tests feed both packages the same numpy
parameters, and run without dropout.
"""

from __future__ import annotations

import os

import torch

_MASK64 = (1 << 64) - 1


def _mix(x: int) -> int:
    """splitmix64 finalizer: a well-spread 64-bit value from x."""
    x = (x + 0x9E3779B97F4A7C15) & _MASK64
    x = ((x ^ (x >> 30)) * 0xBF58476D1CE4E5B9) & _MASK64
    x = ((x ^ (x >> 27)) * 0x94D049BB133111EB) & _MASK64
    return x ^ (x >> 31)


def fold_in(seed: int, data: int) -> int:
    """A new seed from (seed, data) — what jax.random.fold_in does to
    a key, on plain integers. Kept below 2**63 (manual_seed's range)."""
    return _mix(seed ^ _mix(data & _MASK64)) >> 1


def generator(seed: int, device="cpu") -> torch.Generator:
    g = torch.Generator(device=device)
    g.manual_seed(seed)
    return g


def root_generator(seed: int = 0, device="cpu") -> torch.Generator:
    """The trainer's root generator; seed 0 draws one from the OS, as
    the JAX package's root_key does."""
    if seed == 0:
        seed = int.from_bytes(os.urandom(4), "little")
    return generator(seed, device)


def split_for_step(root: torch.Generator, step: int) -> torch.Generator:
    """The generator of global step `step`, on root's device; O(1)
    state, independent of how many steps ran before."""
    return generator(fold_in(root.initial_seed(), step), root.device)
