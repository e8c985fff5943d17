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

Importing the package imports nothing else. The top-level API is the
JAX package's (`paddle_tpu/__init__.py`, ROADMAP A13): `init(**flags)`
sets the port's own flags (`core/flags.py`), and the names below
resolve lazily, on first use:

    import paddle_tpu_torch as paddle
    paddle.init(log_period=10)
    reader = paddle.reader.batched(paddle.dataset.imdb.train(), 64)

`Arg`, `Network`, `SGD`, `infer`, `dataset`, `reader`, `dsl`, `layers`,
`models`, `optimizers`, `evaluators` and `inference` are the port's
modules. `api`, `plot`, `image` and `framework` are not ported yet and
raise naming ROADMAP A12; `get_mesh` and `set_mesh` raise naming
ROADMAP A8.
"""

__version__ = "0.1.0"


def init(**flags):
    """Process-level init, analogous to paddle.init / initMain
    (reference: paddle/trainer/TrainerMain.cpp:32,
    paddle/utils/Flags.cpp): keyword flags stored in the port's global
    flag registry."""
    from paddle_tpu_torch.core import flags as _flags

    for k, v in flags.items():
        _flags.set_flag(k, v)


_LAZY = {
    "dsl": "paddle_tpu_torch.dsl",
    "layers": "paddle_tpu_torch.layers",
    "models": "paddle_tpu_torch.models",
    "optimizers": "paddle_tpu_torch.optimizers",
    "evaluators": "paddle_tpu_torch.evaluators",
    "inference": "paddle_tpu_torch.inference",
    "dataset": "paddle_tpu_torch.data.dataset",
    "reader": "paddle_tpu_torch.data.reader",
}


class NotPorted(NotImplementedError, AttributeError):
    """A name of the JAX package's top-level API that the port does not
    have yet. An AttributeError too, so `hasattr` answers False."""


# the JAX package's names the port does not have yet, and the ROADMAP
# item that ports each
_NOT_PORTED = {
    "api": "A12",
    "plot": "A12",
    "image": "A12",
    "framework": "A12",
    "get_mesh": "A8",
    "set_mesh": "A8",
}


def __getattr__(name):
    """Lazy submodule access (keeps `import paddle_tpu_torch` light):
    paddle_tpu_torch.dsl, paddle_tpu_torch.dataset.mnist,
    paddle_tpu_torch.infer, ..."""
    if name == "Arg":
        from paddle_tpu_torch.core.arg import Arg

        return Arg
    if name == "Network":
        from paddle_tpu_torch.network import Network

        return Network
    if name == "SGD":
        from paddle_tpu_torch.trainer import SGD

        return SGD
    if name == "infer":
        from paddle_tpu_torch.inference import infer

        return infer
    if name in _LAZY:
        import importlib

        return importlib.import_module(_LAZY[name])
    if name in _NOT_PORTED:
        raise NotPorted(
            f"paddle_tpu_torch.{name} is not ported yet "
            f"(ROADMAP {_NOT_PORTED[name]})")
    raise AttributeError(
        f"module 'paddle_tpu_torch' has no attribute {name!r}")
