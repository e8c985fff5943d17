"""RNG plumbing: explicit torch.Generators.

The counterpart of `paddle_tpu/core/rng.py`. JAX keys are split
functionally; a torch.Generator is a stateful stream, so the port
derives a fresh generator from a 64-bit seed wherever the JAX package
folds a key: the trainer owns a root seed, a step's key is seeded
from (root, step), and a layer's from (step key, name)
(`layers/base.py::Ctx.split`). The numbers differ from `jax.random`'s
for the same seed: parity tests feed both packages the same numpy
parameters, and run without dropout.

A step's key (`StepKey`) is a 0-dim int64 seed tensor on the device
the draws land on, and its draws (`StepKey.uniform`) are a
counter-based splitmix64 stream computed there with integer tensor
ops. Nothing of it is read on the host, so a step captured in a CUDA
graph draws, at each replay, from the seed its replay was given: the
same numbers the eager step at that global step draws.
"""

from __future__ import annotations

import os

import torch

from paddle_tpu_torch.core.device import host_to_device

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


def _signed(x: int) -> int:
    """x (0 <= x < 2**64) as the int64 with the same bits."""
    return x - (1 << 64) if x >= 1 << 63 else x


def _srl(x: torch.Tensor, s: int) -> torch.Tensor:
    """Logical right shift of an int64 tensor (>> is arithmetic)."""
    return (x >> s) & ((1 << (64 - s)) - 1)


def _mix_t(x: torch.Tensor) -> torch.Tensor:
    """`_mix` on an int64 tensor, element by element (the products wrap
    as the 64-bit ones do)."""
    x = x + _signed(0x9E3779B97F4A7C15)
    x = (x ^ _srl(x, 30)) * _signed(0xBF58476D1CE4E5B9)
    x = (x ^ _srl(x, 27)) * _signed(0x94D049BB133111EB)
    return x ^ _srl(x, 31)


class StepKey:
    """A step's (or a layer's) random key: `seed`, a 0-dim int64 tensor
    on the device its draws land on."""

    __slots__ = ("seed",)

    def __init__(self, seed: torch.Tensor):
        self.seed = seed

    def fold_in(self, data: int) -> "StepKey":
        """`fold_in(seed, data)`, computed on the device."""
        return StepKey(_srl(_mix_t(self.seed ^ _signed(_mix(data & _MASK64))),
                            1))

    def uniform(self, shape, dtype=torch.float32,
                offset: int = 0) -> torch.Tensor:
        """Uniform [0, 1) draws of `shape` on the key's device: element i
        takes the top 24 bits of splitmix64's (offset + i)-th output
        from the seed (an offset: a slice of a larger draw)."""
        n = 1
        for d in shape:
            n *= int(d)
        i = torch.arange(offset, offset + n, dtype=torch.int64,
                         device=self.seed.device)
        x = _mix_t(self.seed + i * _signed(0x9E3779B97F4A7C15))
        return (_srl(x, 40).to(dtype) * (1.0 / (1 << 24))).reshape(shape)


def step_seed(root_seed: int, step: int) -> int:
    """The seed of global step `step`'s key under a trainer's root
    seed."""
    return fold_in(root_seed, step)


def split_for_step(root: torch.Generator, step: int) -> StepKey:
    """The key of global step `step`, on root's device; O(1) state,
    independent of how many steps ran before."""
    return StepKey(host_to_device(
        torch.tensor(step_seed(root.initial_seed(), step), dtype=torch.int64),
        root.device))
