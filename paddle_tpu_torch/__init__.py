"""paddle_tpu_torch — the PyTorch/CUDA port of `paddle_tpu`.

The JAX package `paddle_tpu/` is the reference; this package keeps its
module layout and names so each file's counterpart is easy to find,
and runs on an NVIDIA H100 (`sm_90a`). Plain tensor code is PyTorch;
every kernel the JAX package wrote in Pallas for the TPU becomes a
kernel written by hand for Hopper under `csrc/`, with a plain PyTorch
version of the same function beside its wrapper.

Entry points run on the card unless the caller passes `device="cpu"`
(`core/device.py`); on a machine without a CUDA device they raise
instead of continuing on the CPU.

Importing the package imports nothing else: submodules are imported
by path (`paddle_tpu_torch.serving.server`, ...).
"""
