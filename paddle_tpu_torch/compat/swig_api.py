"""The `py_paddle.swig_paddle` API surface on the port —
`paddle_tpu/compat/swig_api.py` for PyTorch.

Reference: paddle/api/PaddleAPI.h:103,244,402 + paddle/api/Paddle.i
(the SWIG module the reference's API-driven demo drivers import:
v1_api_demo/quick_start/api_train.py:17, gan/gan_trainer.py:24,
vae/vae_train.py:24). Slot-indexed Arguments of Matrix/IVector wrap
numpy on the host; GradientMachine/Trainer run the port's Network and
TrainStep on the card (the sequence kernels B5-B8 where the model has
them) instead of the C++ gserver stack.

Ported: initPaddle, isGpuVersion / isUsingGpu / setUseGpu,
Matrix/SparseMatrix/Vector/IVector numpy bridges, Arguments with
value/id slots and sequence start positions, Parameter /
ParameterBuffer (PARAMETER_VALUE buffers with write-through copyFrom
and the toNumpyArrayInplace mirrors; PARAMETER_GRADIENT), Evaluator,
GradientMachine.createFromConfigProto / forward / forwardTest /
backward / forwardBackward / loadParameters / randParameters,
ParameterUpdater, Trainer (startTrain/startTrainPass/trainOneDataBatch/
finishTrainPass/startTestPeriod/testOneDataBatch/finishTestPeriod),
TrainerConfig, OptimizationConfig and ParameterOptimizer.

Left out: `Parameter.getConfig().toProto()`, which builds a
`paddle.proto` message through the repo-root `paddle` shim of the JAX
package; `getConfig()` itself answers the ParameterConf's fields.

The device: a GradientMachine runs on the card unless the caller asks
for the CPU — `device="cpu"`, or the reference's own flags
`initPaddle("--use_gpu=0")` / `setUseGpu(False)` (the JAX package
accepts and ignores them). Without a card a machine on the default
device raises. `isGpuVersion()` answers True; `isUsingGpu()` follows
the choice.

Host <-> device traffic, kept as the JAX package's semantics are:
`_sync_views` writes every registered `toNumpyArrayInplace` mirror into
its parameter before each run (host -> device) and `_refresh_views`
copies fresh values back after updates (device -> host); `copyFrom`
writes through; `forwardBackward` returns `float(loss)`, one sync a
call. Each machine counts those bytes in `mirror_bytes`. Unlike the
JAX package's, `ParameterUpdater.finishBatch` refreshes the mirrors
after its update: there a registered mirror's stale values overwrite
the update at the next run.
"""

from __future__ import annotations

import logging
import os

import numpy as np
import torch

from paddle_tpu_torch.core import flags as _flags
from paddle_tpu_torch.core import rng as _rng
from paddle_tpu_torch.core.arg import Arg, pad_ragged
from paddle_tpu_torch.core.device import resolve_device
from paddle_tpu_torch.network import Network
from paddle_tpu_torch.optimizers import create_optimizer
from paddle_tpu_torch.parallel.dp import TrainStep, loss_and_grads

log = logging.getLogger("paddle_tpu_torch.api")

# --- constants (api/PaddleAPI.h enums) ---
PARAMETER_VALUE = 0
PARAMETER_GRADIENT = 1
PARAMETER_MOMENTUM = 2
PASS_TRAIN = 0
PASS_TEST = 1
PASS_GC = 2
CREATE_MODE_NORMAL = 0
CREATE_MODE_SGD_SPARSE_CPU_TRAINING = 3
NO_SPARSE_ID = -1

# the reference's use_gpu flag: machines made without `device` run on
# the card while it is True
_use_gpu = True


def _flag_bool(v: str) -> bool:
    return v.strip().lower() not in ("0", "false", "no", "")


def initPaddle(*args):
    """api.initPaddle('--use_gpu=0', ...) — gflags-style strings
    (api/Paddle.i initPaddle). `use_gpu` picks the default device of
    the machines made after it; flags with a port equivalent are
    applied; the rest are accepted and ignored."""
    mapped = {
        "seed": ("seed", int),
        "log_period": ("log_period", int),
        "show_parameter_stats_period": ("show_parameter_stats_period", int),
        "beam_size": ("beam_size", int),
        "start_pass": ("start_pass", int),
    }
    for a in args:
        if not a.startswith("--"):
            continue
        k, _, v = a[2:].partition("=")
        if k == "use_gpu":
            setUseGpu(_flag_bool(v))
        elif k in mapped:
            name, cast = mapped[k]
            _flags.set_flag(name, cast(v))


def isGpuVersion() -> bool:
    """api.isGpuVersion — this build runs on a CUDA card."""
    return True


def isUsingGpu() -> bool:
    """api.isUsingGpu — the use_gpu choice (initPaddle / setUseGpu)."""
    return _use_gpu


def setUseGpu(flag: bool) -> None:
    """api.setUseGpu — the default device of machines made after it:
    the card (True) or the CPU (False)."""
    global _use_gpu
    _use_gpu = bool(flag)


def _default_device():
    return None if _use_gpu else "cpu"


class RangeError(Exception):
    """api Matrix/Vector out-of-range access (Paddle.i RangeError)."""


# sparse enums (Paddle.i / matrix.h)
SPARSE_NON_VALUE = 0
SPARSE_VALUE = 1
SPARSE_CSR = 0
SPARSE_CSC = 1


def _as2d(a: np.ndarray) -> np.ndarray:
    a = np.asarray(a)
    return a.reshape(a.shape[0], -1) if a.ndim != 2 else a


def _host(t) -> np.ndarray:
    """A tensor's values as a host numpy array (bf16 as f32)."""
    t = t.detach()
    if t.dtype == torch.bfloat16:
        t = t.float()
    return t.cpu().numpy()


class Matrix:
    """Dense host matrix (api/PaddleAPI.h:103 Matrix; numpy bridge
    api/Paddle.i:142-165)."""

    def __init__(self, array):
        self._a = _as2d(np.asarray(array, np.float32))

    @classmethod
    def createDenseFromNumpy(cls, a, copy=True):
        return cls(np.array(a, np.float32, copy=copy))

    @classmethod
    def createCpuDenseFromNumpy(cls, a, copy=True):
        """copy=False SHARES memory with the numpy matrix
        (api/Paddle.i:142 zero-copy bridge)."""
        a = np.asarray(a)
        if not copy and a.dtype == np.float32 and a.ndim == 2:
            m = cls.__new__(cls)
            m._a = a
            return m
        return cls(np.array(a, np.float32))

    @classmethod
    def createGpuDenseFromNumpy(cls, a):
        return cls(np.array(a, np.float32))

    @classmethod
    def createDense(cls, data, height, width):
        a = np.asarray(data, np.float32)
        if a.size != height * width:
            # a short LAST batch: the reference's api loaders pass the
            # nominal batch height with fewer samples' data
            # (api/test/util.py loadMNISTTrainData's StopIteration
            # break); the rows that exist win — anything else is a
            # caller bug and must not be silently reshaped
            if a.size > height * width or a.size % width:
                raise ValueError(
                    f"createDense: {a.size} values do not form "
                    f"<= {height} rows of width {width}"
                )
            height = a.size // width
        return cls(a.reshape(height, width))

    @classmethod
    def createZero(cls, height, width):
        return cls(np.zeros((height, width), np.float32))

    @classmethod
    def createSparse(cls, height, width, nnz, non_value=True,
                     trans=False, useGpu=False):
        """CSR sparse matrix filled by sparseCopyFrom
        (api Matrix::createSparse + sparseCopyFrom)."""
        return SparseMatrix(
            [[] for _ in range(height)], width,
            with_values=not non_value,
        )

    def copyToNumpyMat(self) -> np.ndarray:
        return np.array(self._a)

    toNumpyMat = copyToNumpyMat

    def toNumpyMatInplace(self) -> np.ndarray:
        """The live buffer — mutations write through (Paddle.i
        toNumpyMatInplace shared-memory view)."""
        return self._a

    def copyFromNumpyMat(self, a):
        np.copyto(self._a, np.asarray(a, np.float32).reshape(self._a.shape))

    def get(self, x, y):
        """Reference api Matrix::get addressing: flat offset
        x*width + y, bounds-checked on the flat index."""
        h, w = self._a.shape
        flat = x * w + y
        if x < 0 or y < 0 or flat >= h * w:
            raise RangeError(f"get({x}, {y}) out of {h}x{w}")
        return float(self._a[flat // w, flat % w])

    def set(self, x, y, v):
        h, w = self._a.shape
        flat = x * w + y
        if x < 0 or y < 0 or flat >= h * w:
            raise RangeError(f"set({x}, {y}) out of {h}x{w}")
        self._a[flat // w, flat % w] = v

    def isGpu(self):
        return False

    def getData(self):
        return self._a.ravel()

    def getHeight(self):
        return self._a.shape[0]

    def getWidth(self):
        return self._a.shape[1]

    def isSparse(self):
        return False


class SparseMatrix(Matrix):
    """Row-sparse host matrix (api/Paddle.i createSparse;
    Matrix::getSparseRowCols). Built from per-row column-index lists
    (binary) or (col, value) pair lists (float); densifies lazily for
    the dense Matrix surface."""

    def __init__(self, rows, width, with_values=False):
        self._rows = [list(r) for r in rows]
        self._w = int(width)
        self._with_values = with_values
        self._dense = None

    @property
    def _a(self):
        if self._dense is None:
            d = np.zeros((len(self._rows), self._w), np.float32)
            for i, row in enumerate(self._rows):
                for e in row:
                    if self._with_values:
                        d[i, int(e[0])] = float(e[1])
                    else:
                        d[i, int(e)] = 1.0
            self._dense = d
        return self._dense

    def isSparse(self):
        return True

    def getSparseValueType(self):
        return SPARSE_VALUE if self._with_values else SPARSE_NON_VALUE

    def getSparseFormat(self):
        return SPARSE_CSR

    def sparseCopyFrom(self, rows, cols, values=()):
        """CSR triples -> row lists (api Matrix::sparseCopyFrom:
        `rows` are per-row offsets into cols/values)."""
        new_rows = []
        for i in range(len(rows) - 1):
            b, e = int(rows[i]), int(rows[i + 1])
            if self._with_values:
                new_rows.append(
                    [(int(c), float(v))
                     for c, v in zip(cols[b:e], values[b:e])]
                )
            else:
                new_rows.append([int(c) for c in cols[b:e]])
        self._rows = new_rows
        self._dense = None

    def getSparseRowCols(self, i):
        if self._with_values:
            return [int(c) for c, _ in self._rows[i]]
        return [int(c) for c in self._rows[i]]

    def getSparseRowColsVal(self, i):
        if self._with_values:
            return [(int(c), float(v)) for c, v in self._rows[i]]
        return [(int(c), 1.0) for c in self._rows[i]]


class _VectorBase:
    _dtype = np.float32

    def __init__(self, array):
        self._a = np.asarray(array, self._dtype).ravel()

    @classmethod
    def createVectorFromNumpy(cls, a, copy=True):
        return cls(np.array(a, cls._dtype, copy=copy))

    @classmethod
    def createCpuVectorFromNumpy(cls, a, copy=True):
        """copy=False SHARES memory with the numpy array."""
        a = np.asarray(a)
        if not copy and a.dtype == cls._dtype and a.ndim == 1:
            v = cls.__new__(cls)
            v._a = a
            return v
        return cls(np.array(a, cls._dtype))

    @classmethod
    def createGpuVectorFromNumpy(cls, a):
        return cls(np.array(a, cls._dtype))

    @classmethod
    def create(cls, data, useGpu=False):
        try:
            return cls(np.asarray(data, cls._dtype))
        except TypeError:  # generator input
            return cls(np.asarray(list(data), cls._dtype))

    @classmethod
    def createZero(cls, n, useGpu=False):
        return cls(np.zeros(n, cls._dtype))

    def copyToNumpyArray(self) -> np.ndarray:
        return np.array(self._a)

    toNumpyArray = copyToNumpyArray

    def toNumpyArrayInplace(self) -> np.ndarray:
        return self._a

    def getData(self) -> list:
        return self._a.tolist()

    def isGpu(self):
        return False

    def __getitem__(self, i):
        if i < 0 or i >= self._a.size:
            raise RangeError(f"index {i} out of {self._a.size}")
        v = self._a[i]
        return int(v) if self._dtype == np.int32 else float(v)

    def __setitem__(self, i, v):
        if i < 0 or i >= self._a.size:
            raise RangeError(f"index {i} out of {self._a.size}")
        self._a[i] = v

    def __iter__(self):
        return iter(self.getData())

    def __len__(self):
        return int(self._a.size)

    def copyFrom(self, other):
        self._a = np.array(other._a if isinstance(other, _VectorBase)
                           else other, self._dtype).ravel()

    def copyFromNumpyArray(self, a):
        self.copyFrom(np.asarray(a))


class Vector(_VectorBase):
    _dtype = np.float32


class IVector(_VectorBase):
    _dtype = np.int32


def _ids_arg(ids, lens=None) -> Arg:
    return Arg(ids=torch.from_numpy(np.asarray(ids, np.int64)),
               seq_lens=None if lens is None
               else torch.from_numpy(np.asarray(lens, np.int32)))


def _value_arg(value, lens=None) -> Arg:
    return Arg(value=torch.from_numpy(np.ascontiguousarray(value,
                                                           np.float32)),
               seq_lens=None if lens is None
               else torch.from_numpy(np.asarray(lens, np.int32)))


class Arguments:
    """Slot-indexed in/out arguments (api/PaddleAPI.h:244 Arguments,
    parameter/Argument.h:29). A slot is a dense Matrix, an id IVector,
    or a prepared port Arg of CPU tensors (what DataProviderConverter
    emits); sequence slots carry start positions exactly like the
    reference (Argument.sequenceStartPositions)."""

    def __init__(self, n_slots: int = 0):
        self._slots = [dict() for _ in range(n_slots)]

    @classmethod
    def createArguments(cls, n):
        return cls(n)

    def resize(self, n):
        while len(self._slots) < n:
            self._slots.append({})
        del self._slots[n:]

    def getSlotNum(self):
        return len(self._slots)

    def _slot(self, i):
        if i >= len(self._slots):
            self.resize(i + 1)
        return self._slots[i]

    # --- setters ---
    def setSlotValue(self, i, m: Matrix):
        self._slot(i)["value"] = m

    def setSlotIds(self, i, v: IVector):
        self._slot(i)["ids"] = v

    def setSlotSequenceStartPositions(self, i, v: IVector):
        self._slot(i)["seq_starts"] = v

    def setSlotSubSequenceStartPositions(self, i, v: IVector):
        self._slot(i)["subseq_starts"] = v

    def setSlotFrameHeight(self, i, h: int):
        self._slot(i)["frame_h"] = int(h)

    def setSlotFrameWidth(self, i, w: int):
        self._slot(i)["frame_w"] = int(w)

    def getSlotFrameHeight(self, i=0) -> int:
        return self._slots[i].get("frame_h", 0)

    def getSlotFrameWidth(self, i=0) -> int:
        return self._slots[i].get("frame_w", 0)

    def _setSlotArg(self, i, arg: Arg):
        self._slot(i)["arg"] = arg

    # --- getters ---
    def getSlotValue(self, i) -> Matrix:
        s = self._slots[i]
        if "value" in s:
            return s["value"]
        return Matrix(_flatten_arg_value(s["arg"]))

    def getSlotIds(self, i) -> IVector:
        s = self._slots[i]
        if "ids" in s:
            return s["ids"]
        return IVector(_flatten_arg_ids(s["arg"]))

    def getSlotSequenceStartPositions(self, i) -> IVector:
        s = self._slots[i]
        if "seq_starts" in s:
            return s["seq_starts"]
        lens = _host(s["arg"].seq_lens)
        return IVector(np.concatenate([[0], np.cumsum(lens)]))

    def sum(self) -> float:
        """Total of slot 0's values (api Arguments::sum — the cost
        accumulator the v2 loop divides by batch size)."""
        return float(np.sum(self.getSlotValue(0).copyToNumpyMat()))

    # --- feed conversion (internal) ---
    def _to_arg(self, i) -> Arg:
        s = self._slots[i]
        if "arg" in s:
            return s["arg"]
        starts = s.get("seq_starts")
        if "ids" in s:
            ids = s["ids"].copyToNumpyArray()
            if starts is None:
                return _ids_arg(ids)
            return _ids_arg(*pad_ragged(ids, starts.copyToNumpyArray()))
        v = s["value"].copyToNumpyMat()
        if starts is None:
            return _value_arg(v)
        return _value_arg(*pad_ragged(v, starts.copyToNumpyArray()))

    def _feed(self, names) -> dict:
        if len(names) < len(self._slots):
            raise ValueError(
                f"{len(self._slots)} slots fed but the network declares "
                f"only data layers {names}"
            )
        return {
            name: self._to_arg(i)
            for i, name in enumerate(names[: len(self._slots)])
        }


def _flatten_arg_value(a: Arg) -> np.ndarray:
    v = _host(a.value)
    if a.seq_lens is None:
        return v.reshape(v.shape[0], -1)
    # sequence output: the reference layout is the padding-free
    # [sum(T_i), D] stack (Argument.h:84)
    lens = _host(a.seq_lens)
    rows = [v[i, : lens[i]].reshape(lens[i], -1) for i in range(len(lens))]
    return np.concatenate(rows, axis=0) if rows else v.reshape(0, -1)


def _flatten_arg_ids(a: Arg) -> np.ndarray:
    ids = _host(a.ids).astype(np.int32)
    if a.seq_lens is None or ids.ndim == 1:
        return ids.ravel()
    lens = _host(a.seq_lens)
    return np.concatenate([ids[i, : lens[i]] for i in range(len(lens))])


class ParameterBuffer(Vector):
    """A live view of one parameter buffer (api Vector over
    Parameter::getBuf). copyFrom writes THROUGH to the owning machine —
    the GAN driver's copy_shared_parameters depends on that.
    toNumpyArrayInplace returns a registered host mirror whose
    mutations the machine syncs back before the next run (the
    testTrain init_params idiom: mutate the inplace view, then
    forward)."""

    def __init__(self, gm: "GradientMachine", name: str, kind: int):
        self._gm = gm
        self._name = name
        self._kind = kind

    def _read(self) -> np.ndarray:
        if self._kind == PARAMETER_GRADIENT:
            g = self._gm._grads.get(self._name)
            return np.zeros(self._len(), np.float32) if g is None \
                else self._gm._to_host(g).ravel()
        view = self._gm._inplace_views.get(self._name)
        if view is not None:
            return view
        return self._gm._to_host(self._gm.params[self._name]).ravel()

    @property
    def _a(self) -> np.ndarray:  # the Vector surface reads live
        return self._read()

    def _len(self):
        return int(np.prod(self._gm.net.param_confs[self._name].dims))

    def __len__(self):
        return self._len()

    def copyToNumpyArray(self):
        return np.array(self._read(), np.float32)

    def toNumpyArrayInplace(self) -> np.ndarray:
        if self._kind != PARAMETER_VALUE:
            return self._read()
        views = self._gm._inplace_views
        if self._name not in views:
            views[self._name] = np.array(
                self._gm._to_host(self._gm.params[self._name]).ravel(),
                np.float32,
            )
        return views[self._name]

    def __setitem__(self, i, v):
        if self._kind != PARAMETER_VALUE:
            raise ValueError("only PARAMETER_VALUE buffers are writable")
        if i < 0 or i >= self._len():
            raise RangeError(f"index {i} out of {self._len()}")
        self.toNumpyArrayInplace()[i] = v

    def copyFrom(self, other):
        src = other._read() if isinstance(other, ParameterBuffer) else (
            other._a if isinstance(other, _VectorBase) else np.asarray(other)
        )
        if self._kind != PARAMETER_VALUE:
            raise ValueError("only PARAMETER_VALUE buffers are writable")
        self._gm._set_param(self._name, src)
        self._gm._refresh_views(self._name)

    def copyFromNumpyArray(self, a):
        self.copyFrom(np.asarray(a, np.float32))


class _ParamConfView:
    """What Parameter.getConfig() returns: the ParameterConf's fields
    (api Parameter::getConfig). `toProto` is left out (module
    docstring)."""

    def __init__(self, pc):
        self._pc = pc

    def __getattr__(self, name):
        return getattr(self._pc, name)


class Parameter:
    def __init__(self, gm: "GradientMachine", name: str):
        self._gm = gm
        self._name = name

    def getName(self):
        return self._name

    def getID(self):
        """Position in the machine's parameter order (api
        Parameter::getID)."""
        return self._gm._param_names.index(self._name)

    def getSize(self):
        return int(np.prod(self._gm.net.param_confs[self._name].dims))

    def getBuf(self, kind):
        return ParameterBuffer(self._gm, self._name, kind)

    def getBufs(self):
        """(value, gradient) buffers — what the api update callback
        hands the optimizer (Parameter::getBufs)."""
        return (
            ParameterBuffer(self._gm, self._name, PARAMETER_VALUE),
            ParameterBuffer(self._gm, self._name, PARAMETER_GRADIENT),
        )

    def save(self, filename) -> bool:
        """Write the reference raw binary format
        (Parameter::save)."""
        from paddle_tpu_torch.trainer.checkpoint import save_parameter_file

        self._gm._sync_views()
        save_parameter_file(
            filename, self._gm._to_host(self._gm.params[self._name])
        )
        return True

    def load(self, filename) -> bool:
        """Read the reference raw binary format (Parameter::load)."""
        from paddle_tpu_torch.trainer.checkpoint import load_parameter_file

        self._gm._set_param(self._name, load_parameter_file(filename))
        self._gm._refresh_views(self._name)
        return True

    def setValueUpdated(self):
        pass  # the device copy already happened in ParameterBuffer.copyFrom

    def __len__(self):
        return self.getSize()

    def getConfig(self):
        return _ParamConfView(self._gm.net.param_confs[self._name])


class Evaluator:
    """api.Evaluator over the machine's implied metric set: the
    reference auto-attaches classification_error to every
    classification_cost (trainer_config_helpers layers.py
    classification_cost's evaluator default); eval() accumulates from
    the machine's last forward."""

    def __init__(self, confs):
        from paddle_tpu_torch.evaluators import create_evaluator

        self._evals = [create_evaluator(c) for c in confs]
        self._started = False

    def start(self):
        for ev in self._evals:
            ev.start()
        self._started = True

    def finish(self):
        self._started = False

    def _add(self, outs, feed):
        for ev in self._evals:
            ev.add_batch(outs, feed)

    def getNames(self):
        return [ev.name for ev in self._evals]

    def getValue(self, name):
        for ev in self._evals:
            if ev.name == name:
                return ev.result()
        raise KeyError(name)

    def __repr__(self):
        return " ".join(
            f"{ev.name}={ev.result()}" for ev in self._evals
        ) or "<no evaluators>"


class GradientMachine:
    """api/PaddleAPI.h:402 GradientMachine over the port's Network.

    seed=None defers to the global 'seed' flag (whose 0 means a fresh
    OS-entropy seed); an explicit seed — including 0 — is honored
    exactly and governs BOTH parameter init and the dropout stream
    (the port's generator: the numbers differ from the JAX package's).
    `device`: None = the use_gpu choice (the card by default)."""

    def __init__(self, conf, seed: int | None = None, device=None):
        self.conf = conf
        self.device = resolve_device(
            device if device is not None else _default_device())
        root = (_rng.generator(seed) if seed is not None
                else _rng.root_generator(_flags.get_flag("seed")))
        init_gen = _rng.generator(_rng.step_seed(root.initial_seed(), -1))
        # the step keys live on the device dropout draws on
        self._step_root = _rng.generator(root.initial_seed(), self.device)
        self.net = Network(conf)
        self.params = self.net.init_params(init_gen, self.device)
        self.state = self.net.init_state(self.device)
        self._grads: dict = {}
        self._last_rng = None  # rng of the latest forward (backward reuses)
        self._inplace_views: dict = {}  # name -> mutable host mirror
        self._param_names = sorted(self.net.param_confs)
        self._last = None  # (outs, feed) of the latest forward
        self._rng_step = 0
        # host <-> device bytes of the mirrors, copyFrom and loads
        self.mirror_bytes = {"h2d": 0, "d2h": 0}
        # implied evaluators (classification_error per classification
        # cost), what the reference's makeEvaluator materializes
        self._eval_confs = []
        for lc in conf.layers:
            if lc.type == "classification_cost" and len(lc.inputs) >= 2:
                self._eval_confs.append({
                    "type": "classification_error",
                    "name": "classification_error",
                    "input": lc.inputs[0].name,
                    "label": lc.inputs[1].name,
                })
        self._keep = set(self.net.output_names) | {
            c["input"] for c in self._eval_confs
        }

    # ---- host <-> device ----
    def _to_host(self, t) -> np.ndarray:
        if t.device.type != "cpu":
            self.mirror_bytes["d2h"] += t.numel() * t.element_size()
        return _host(t)

    def _to_device(self, a, shape) -> torch.Tensor:
        t = torch.from_numpy(np.array(a, np.float32).reshape(shape))
        if self.device.type != "cpu":
            self.mirror_bytes["h2d"] += t.numel() * t.element_size()
        return t.to(self.device)

    def _set_param(self, name, value):
        self.params[name] = self._to_device(value, self.params[name].shape)

    def _sync_views(self):
        """Flush registered toNumpyArrayInplace mirrors into params
        (mutate-then-run semantics of the inplace api)."""
        for name, v in self._inplace_views.items():
            self._set_param(name, v)

    def _refresh_views(self, name=None):
        """After params change OUTSIDE the mirrors (training step,
        load, copyFrom), copy the fresh values INTO any registered
        mirrors so user-held inplace arrays stay live (the reference's
        inplace view IS the parameter memory)."""
        names = [name] if name is not None else list(self._inplace_views)
        for n in names:
            v = self._inplace_views.get(n)
            if v is not None:
                np.copyto(v, self._to_host(self.params[n]).ravel())

    def makeEvaluator(self) -> Evaluator:
        return Evaluator(self._eval_confs)

    def eval(self, evaluator: Evaluator):
        assert self._last is not None, "eval() before any forward"
        evaluator._add(*self._last)

    @classmethod
    def createFromConfigProto(cls, conf, mode=CREATE_MODE_NORMAL,
                              enable_types=None):
        return cls(conf)

    # api GradientMachine::createByModelConfig — same constructor, the
    # mode/parameter-type hints are the reference's buffer plumbing
    createByModelConfig = None  # bound after class body

    # --- parameters ---
    def getParameterSize(self):
        return len(self._param_names)

    def getParameter(self, i: int) -> Parameter:
        return Parameter(self, self._param_names[i])

    def getParameters(self):
        return [Parameter(self, n) for n in self._param_names]

    def getParameterNames(self):
        return list(self._param_names)

    def getNonStaticParameters(self):
        return [
            Parameter(self, n)
            for n in self._param_names
            if not getattr(self.net.param_confs[n], "is_static", False)
        ]

    def randParameters(self, seed: int = 0):
        self.params = self.net.init_params(_rng.generator(seed),
                                           self.device)
        self._refresh_views()

    def loadParameters(self, path: str):
        """Load from a checkpoint of either package: a save_dir with
        pass-* subdirs, one pass dir, or a merged model file
        (trainer/ParamUtil.h:77-93 loadParameters)."""
        from paddle_tpu_torch.trainer import checkpoint as ckpt

        if os.path.isfile(path):
            _, params, state = ckpt.load_merged(path)
        elif any(n.startswith("pass-") for n in os.listdir(path)):
            # a save_dir of pass-* checkpoints: latest wins
            params, _, state, _ = ckpt.load_pass(path, -1)
        elif os.path.exists(os.path.join(path, "params.npz")):
            # a single pass-XXXXX dir given directly
            parent, leaf = os.path.split(path.rstrip("/"))
            params, _, state, _ = ckpt.load_pass(
                parent, int(leaf.split("-")[1])
            )
        else:
            raise FileNotFoundError(
                f"no checkpoint (pass-* dir or merged file) at {path!r}"
            )
        for k, v in params.items():
            self._set_param(k, v)
        if state:
            self.state = {
                layer: {s: self._to_device(v, np.shape(v))
                        for s, v in slots.items()}
                for layer, slots in state.items()}
        self._refresh_views()

    # --- execution ---
    def _next_rng(self):
        self._rng_step += 1
        self._last_rng = _rng.split_for_step(self._step_root,
                                             self._rng_step)
        return self._last_rng

    def _device_feed(self, inArgs: Arguments) -> dict:
        feed = inArgs._feed(self.net.input_names)
        return {k: a.to(self.device) for k, a in feed.items()}

    def _kept(self, outs: dict) -> dict:
        return {n: outs[n] for n in self._keep if n in outs}

    def forward(self, inArgs: Arguments, outArgs: Arguments, passType=None):
        self._sync_views()
        train = passType == PASS_TRAIN
        feed = self._device_feed(inArgs)
        with torch.no_grad():
            outs, new_state = self.net.forward(
                self.params, feed, state=self.state, train=train,
                rng=self._next_rng())
        outs = self._kept(outs)
        if train:
            # train-mode forward advances batch-norm running stats,
            # exactly like the reference GradientMachine
            self.state = new_state
        self._last = (outs, feed)
        outArgs.resize(len(self.net.output_names))
        for i, n in enumerate(self.net.output_names):
            a = outs[n]
            if a.ids is not None and a.value is None:
                outArgs.setSlotIds(i, IVector(_flatten_arg_ids(a)))
            else:
                outArgs.setSlotValue(i, Matrix(_flatten_arg_value(a)))
            outArgs._slot(i)["arg"] = a

    def forwardTest(self, inArgs: Arguments):
        """Reference api: returns [{'id': ids, 'value': values}] per
        output layer (py_paddle util swig_paddle.py forwardTest)."""
        self._sync_views()
        feed = self._device_feed(inArgs)
        with torch.no_grad():
            outs, _ = self.net.forward(self.params, feed, state=self.state,
                                       train=False, rng=self._next_rng())
        outs = self._kept(outs)
        self._last = (outs, feed)
        res = []
        for n in self.net.output_names:
            a = outs[n]
            d = {}
            if a.value is not None:
                v = _flatten_arg_value(a)
                d["value"] = v
                d["id"] = np.argmax(v, axis=-1)
            if a.ids is not None:
                d["id"] = _flatten_arg_ids(a)
            res.append(d)
        return res

    def backward(self, callback=None):
        """Gradient pass over the LAST forward's batch, then the
        per-parameter UpdateCallback (GradientMachine.h:72 backward;
        the api test drives forward + backward separately). As in the
        JAX package it recomputes: `loss_fn` in TRAIN mode on that feed
        with that forward's rng, even after a test-mode forward, and
        leaves the layer state as it is."""
        assert self._last is not None, "backward() before forward()"
        self._sync_views()
        _, feed = self._last
        # the rng the preceding forward used — gradients must belong to
        # the activations the caller saw (same dropout masks), as the
        # reference backprops stored activations
        rng = self._last_rng if self._last_rng is not None \
            else self._next_rng()
        _, self._grads, _, _ = loss_and_grads(self.net, self.params, feed,
                                              self.state, rng)
        if callback is not None:
            for n in self._param_names:
                callback(Parameter(self, n))

    def forwardBackward(self, inArgs: Arguments, outArgs: Arguments,
                        passType=None, callback=None):
        self._sync_views()
        feed = self._device_feed(inArgs)
        loss, self._grads, outs, self.state = loss_and_grads(
            self.net, self.params, feed, self.state, self._next_rng())
        outs = self._kept(outs)
        self._last = (outs, feed)
        outArgs.resize(len(self.net.output_names))
        for i, n in enumerate(self.net.output_names):
            outArgs.setSlotValue(i, Matrix(_flatten_arg_value(outs[n])))
        if callback is not None:
            # the per-parameter UpdateCallback (GradientMachine.h:72
            # backward(callback)): invoked once per parameter after
            # its gradient exists
            for n in self._param_names:
                callback(Parameter(self, n))
        return float(loss)

    def start(self):
        pass

    def finish(self):
        pass


class ParameterUpdater:
    """api/ParameterUpdater.cpp local updater: init(gm), then per batch
    startBatch -> (gm.forwardBackward) -> update(param)* ->
    finishBatch. The per-parameter update() calls mark parameters; the
    optimizer applies once to all marked ones (the same observable
    result), then the machine's mirrors are refreshed.
    apply/restore/catchUpWith are the parameter-averaging window hooks
    (ThreadParameterUpdater.h:71)."""

    def __init__(self, opt_conf):
        self._opt_conf = opt_conf
        self._gm = None
        self.global_step = 0

    @classmethod
    def createLocalUpdater(cls, opt_conf):
        return cls(opt_conf)

    def init(self, gradient_machine: "GradientMachine"):
        self._gm = gradient_machine
        self._opt = create_optimizer(
            self._opt_conf, gradient_machine.net.param_confs
        )
        self._opt_state = self._opt.init_state(gradient_machine.params)
        self._marked = set()

    def startPass(self):
        pass

    def finishPass(self):
        pass

    def startBatch(self, batch_size: int):
        self._marked = set()
        return PASS_TRAIN

    def update(self, param: "Parameter"):
        self._marked.add(param.getName())

    def finishBatch(self, cost: float = 0.0):
        gm = self._gm
        if self._marked and gm._grads:
            # unmarked parameters are simply absent from the grads dict:
            # the optimizer leaves them (and their momentum/decay/LR
            # state) untouched, matching the reference local updater
            # for drivers that skip update() on frozen params
            grads = {
                k: v for k, v in gm._grads.items() if k in self._marked
            }
            gm.params, self._opt_state = self._opt.update(
                grads, gm.params, self._opt_state, self.global_step
            )
            self.global_step += 1
            gm._refresh_views()

    # parameter-averaging window hooks — the averager is folded into
    # the optimizer state here; the explicit swap is a no-op
    def apply(self):
        pass

    def restore(self):
        pass

    def catchUpWith(self):
        pass

    def getParametersRemote(self, *a, **k):
        pass


class Trainer:
    """api/PaddleAPI.h Trainer: the startTrain/startTrainPass/
    trainOneDataBatch loop over a TrainerConfig + GradientMachine
    (trainer/Trainer.cpp:261 semantics), each batch one `TrainStep` on
    the machine's device. A batch first syncs the machine's mirrors in
    (the JAX package's Trainer does not read them) and refreshes them
    after."""

    def __init__(self, config, gm: GradientMachine):
        self.config = config
        self.gm = gm
        self.opt = create_optimizer(config.opt, gm.net.param_confs)
        self.opt_state = self.opt.init_state(gm.params)
        self.step_fn = TrainStep(gm.net, self.opt, device=gm.device)
        self.global_step = 0
        self._pass = 0
        self._batch = 0
        self._test_costs: list = []
        root = _rng.root_generator(_flags.get_flag("seed"))
        self._key = _rng.generator(root.initial_seed(), gm.device)

    @classmethod
    def create(cls, config, gm) -> "Trainer":
        return cls(config, gm)

    @classmethod
    def createByCommandLine(cls):
        raise NotImplementedError(
            "use Trainer.create(config, gradient_machine)"
        )

    def startTrain(self):
        pass

    def finishTrain(self):
        pass

    def startTrainPass(self):
        self._batch = 0

    def finishTrainPass(self):
        log.info("pass %d finished (%d batches)", self._pass, self._batch)
        self._pass += 1

    def trainOneDataBatch(self, size: int, args: Arguments):
        self.gm._sync_views()
        feed = args._feed(self.gm.net.input_names)
        rng = _rng.split_for_step(self._key, self.global_step)
        (
            self.gm.params,
            self.opt_state,
            self.gm.state,
            loss,
            _,
        ) = self.step_fn(
            self.gm.params, self.opt_state, self.gm.state, feed,
            self.global_step, rng,
        )
        self.global_step += 1
        self.gm._refresh_views()  # keep user-held inplace arrays live
        self._batch += 1
        self._last_cost = float(loss)
        self._last_outs = [
            {"value": np.asarray([self._last_cost * size])}
        ]
        if self._batch % _flags.get_flag("log_period") == 0:
            log.info("pass %d batch %d cost %.5f",
                     self._pass, self._batch, self._last_cost)
        return self._last_cost

    def getForwardOutput(self):
        """Latest forward outputs as [{'value': ndarray}] — the
        reference returns the out-args' value matrices; the train/test
        batch paths record the cost output (api Trainer::
        getForwardOutput)."""
        return getattr(self, "_last_outs", [])

    # --- test period (api Trainer::startTestPeriod) ---
    def startTestPeriod(self):
        self._test_costs = []

    def testOneDataBatch(self, size: int, args: Arguments):
        out = Arguments.createArguments(0)
        self.gm.forward(args, out, PASS_TEST)
        self._last_outs = [
            {"value": out.getSlotValue(i).copyToNumpyMat().ravel()}
            for i in range(out.getSlotNum())
        ]
        self._test_costs.append(out.sum() / max(size, 1))
        return self._test_costs[-1]

    def finishTestPeriod(self):
        if self._test_costs:
            log.info("test cost %.5f", float(np.mean(self._test_costs)))


# ---- raw-api config / optimizer surface (testGradientMachine.py,
#      testTrain.py, testTrainer.py) ---------------------------------


class TrainerConfig:
    """api TrainerConfig (api/Trainer.cpp createFromTrainerConfigFile):
    parse a config file, expose the model/optimization halves."""

    def __init__(self, tc):
        self._tc = tc

    @classmethod
    def createFromTrainerConfigFile(cls, path):
        from paddle_tpu_torch.compat.config_parser import parse_config

        return cls(parse_config(path))

    def getModelConfig(self):
        return self._tc.model_config

    def getOptimizationConfig(self):
        return self._tc.opt_config

    def __getattr__(self, name):
        return getattr(self._tc, name)


class OptimizationConfig:
    """api OptimizationConfig — a pass-through over the framework's
    OptimizationConf (createFromProto accepts it directly)."""

    @staticmethod
    def createFromProto(opt_conf):
        return opt_conf


class ParameterOptimizer:
    """The api-level LOCAL optimizer the raw training loop drives per
    parameter (api/ParameterOptimizer.cpp: create/init/startPass/
    startBatch/update(bufs, config)/finishBatch/finishPass). Applies
    the config's learning rate as a plain first-order step on the
    (value, gradient) buffers — the in-place equivalent of the
    reference's per-parameter optimizer chain."""

    def __init__(self, opt_conf):
        self.conf = opt_conf

    @classmethod
    def create(cls, opt_conf):
        return cls(opt_conf)

    def getParameterTypes(self):
        return [PARAMETER_VALUE, PARAMETER_GRADIENT]

    def init(self, num_rows, param_config):
        pass

    def startPass(self):
        pass

    def finishPass(self):
        pass

    def startBatch(self, batch_size):
        self._batch_size = batch_size

    def finishBatch(self):
        pass

    def update(self, vecs, param_config, sparse_id=NO_SPARSE_ID):
        value, grad = vecs[0], vecs[1]
        lr = float(getattr(self.conf, "learning_rate", 0.01)) * float(
            getattr(param_config, "learning_rate", 1.0)
        )
        value.copyFrom(
            value.copyToNumpyArray() - lr * grad.copyToNumpyArray()
        )

    def needSpecialTraversal(self, param_config):
        return None


GradientMachine.createByModelConfig = classmethod(
    lambda cls, conf, mode=CREATE_MODE_NORMAL, enable_types=None:
    cls(conf)
)
