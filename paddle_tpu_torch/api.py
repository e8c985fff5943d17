"""Compatibility surface mirroring the SWIG `swig_paddle` module —
`paddle_tpu/api.py` for the port.

Reference: paddle/api/PaddleAPI.h:103,244,402 and paddle/py_paddle —
Matrix/Vector/IVector with numpy round trips (api/Paddle.i:142-165),
Arguments, GradientMachine (createFromConfigProto, forward/backward),
ParameterUpdater, SequenceGenerator (api/SequenceGenerator.cpp). These
are thin views over the port's Network / optimizers /
BeamSearchDecoder, kept for users porting v1-era scripts; new code
should use those modules directly. The slot-indexed `py_paddle`
surface itself is `compat/swig_api.py`.

`GradientMachine` and `SequenceGenerator` run on the card unless the
caller passes `device="cpu"`; without a card they raise.
"""

from __future__ import annotations

import dataclasses
from typing import Sequence

import numpy as np
import torch

from paddle_tpu_torch.core import rng as _rng
from paddle_tpu_torch.core.arg import Arg
from paddle_tpu_torch.core.config import ModelConf, OptimizationConf
from paddle_tpu_torch.core.device import resolve_device
from paddle_tpu_torch.network import Network
from paddle_tpu_torch.optimizers import create_optimizer
from paddle_tpu_torch.parallel.dp import loss_and_grads

__all__ = [
    "Matrix",
    "IVector",
    "Arguments",
    "GradientMachine",
    "ParameterUpdater",
    "SequenceGenerator",
    "create_config_generator",
]


class Matrix:
    """Dense float matrix with numpy round-trip (api/Matrix.cpp;
    createDenseFromNumpy / toNumpyMat)."""

    def __init__(self, array):
        self._a = np.asarray(array, np.float32)
        assert self._a.ndim == 2, "Matrix is 2-D"

    @classmethod
    def createDenseFromNumpy(cls, a):
        return cls(a)

    def toNumpyMat(self) -> np.ndarray:
        return self._a

    def getHeight(self):
        return self._a.shape[0]

    def getWidth(self):
        return self._a.shape[1]


class IVector:
    """Integer id vector (api/Vector.cpp)."""

    def __init__(self, array):
        self._a = np.asarray(array, np.int32).reshape(-1)

    @classmethod
    def createVectorFromNumpy(cls, a):
        return cls(a)

    def toNumpyArray(self) -> np.ndarray:
        return self._a


class Arguments:
    """Slot-indexed value/id holder (api/Arguments.cpp; the Argument
    bridging used by py_paddle.dataprovider_converter), of CPU
    tensors."""

    def __init__(self, n_slots: int = 0):
        self._args = [Arg() for _ in range(n_slots)]

    @classmethod
    def createArguments(cls, n):
        return cls(n)

    def getSlotNum(self):
        return len(self._args)

    def setSlotValue(self, i: int, m: Matrix):
        self._args[i] = dataclasses.replace(
            self._args[i], value=torch.from_numpy(np.array(m.toNumpyMat()))
        )

    def setSlotIds(self, i: int, v: IVector):
        self._args[i] = dataclasses.replace(
            self._args[i],
            ids=torch.from_numpy(v.toNumpyArray().astype(np.int64))
        )

    def getSlotValue(self, i: int) -> Matrix:
        return Matrix(self._args[i].value.detach().cpu().numpy())

    def getSlotIds(self, i: int) -> IVector:
        return IVector(self._args[i].ids.detach().cpu().numpy())

    def slots(self):
        return self._args


def _place(tree, device):
    """{name: array or tensor} (or one level deeper) on `device`."""
    def one(x):
        if isinstance(x, dict):
            return {k: one(v) for k, v in x.items()}
        if not torch.is_tensor(x):
            x = torch.from_numpy(np.array(x, copy=True))
        return x.detach().to(device)

    return {k: one(v) for k, v in tree.items()}


_ARG_DTYPES = {"value": torch.float32, "ids": torch.int64,
               "seq_lens": torch.int32, "subseq_lens": torch.int32}


def _arg_on(a: Arg, device) -> Arg:
    """An Arg of numpy arrays or tensors as the port's Arg on
    `device`."""
    def one(f):
        x = getattr(a, f)
        if x is None:
            return None
        if torch.is_tensor(x):
            return x.to(device)
        return torch.as_tensor(np.array(x), dtype=_ARG_DTYPES[f],
                               device=device)

    return Arg(**{f: one(f) for f in _ARG_DTYPES})


class GradientMachine:
    """Stateful wrapper over Network — createFromConfigProto +
    forward/backward/forwardBackward (api/GradientMachine.cpp;
    GradientMachine.h:72). Holds mutable params the way the SWIG object
    owned its Parameters, on `device` (default the card). `seed` draws
    them with the port's generator (not the JAX package's numbers)."""

    def __init__(self, conf: ModelConf, seed: int = 0, device=None):
        self.device = resolve_device(device)
        self.net = Network(conf)
        self.params = self.net.init_params(_rng.generator(seed),
                                           self.device)
        self.state = self.net.init_state(self.device)
        self._grads = None

    @classmethod
    def createFromConfigProto(cls, conf: ModelConf, device=None
                              ) -> "GradientMachine":
        return cls(conf, device=device)

    def getParameterNames(self):
        return sorted(self.params)

    def getParameter(self, name: str) -> np.ndarray:
        return self.params[name].detach().cpu().numpy()

    def setParameter(self, name: str, value) -> None:
        self.params[name] = _place({name: value}, self.device)[name]

    def _feed(self, feed: dict) -> dict:
        return {k: a.to(self.device) for k, a in feed.items()}

    def forward(self, feed: dict, outputs=None) -> dict:
        with torch.no_grad():
            outs, self.state = self.net.forward(
                self.params, self._feed(feed), state=self.state,
                train=False, outputs=outputs,
            )
        return outs

    def forwardBackward(self, feed: dict, rng=None):
        """Returns (the scalar cost, the outputs); gradients
        retrievable via getGradient (the UpdateCallback analogue)."""
        loss, self._grads, outs, self.state = loss_and_grads(
            self.net, self.params, self._feed(feed), self.state, rng)
        return float(loss), outs

    def getGradient(self, name: str) -> np.ndarray:
        assert self._grads is not None, "call forwardBackward first"
        return self._grads[name].detach().cpu().numpy()


class ParameterUpdater:
    """Local updater (api/ParameterUpdater.cpp createLocalUpdater):
    applies the configured optimizer to a GradientMachine's params."""

    def __init__(self, opt_conf: OptimizationConf, gm: GradientMachine):
        self.gm = gm
        self.opt = create_optimizer(opt_conf, gm.net.param_confs)
        self.opt_state = self.opt.init_state(gm.params)
        self.step = 0

    @classmethod
    def createLocalUpdater(cls, opt_conf, gm):
        return cls(opt_conf, gm)

    def update(self) -> None:
        assert self.gm._grads is not None, "no gradients pending"
        self.gm.params, self.opt_state = self.opt.update(
            self.gm._grads, self.gm.params, self.opt_state, self.step
        )
        self.gm._grads = None
        self.step += 1


class SequenceGenerator:
    """Beam-search generation front-end (api/SequenceGenerator.cpp):
    wraps the port's BeamSearchDecoder, returning id sequences per
    input. `params` (numpy or tensors; settable later, as the JAX
    package's drivers do) are placed on `device` (default the card);
    `last_result` keeps the decoder's (seqs, lens, scores) of the
    latest generate."""

    def __init__(self, decoder, params: dict, dict_list=None,
                 num_results=None, device=None):
        self.decoder = decoder
        self.device = resolve_device(device)
        self.params = params
        self.dict_list = dict_list
        # beams returned per sample (v1 num_results_per_sample;
        # None = all beam_size beams)
        self.num_results = num_results
        self.last_result = None

    @property
    def params(self):
        return self._params

    @params.setter
    def params(self, params):
        self._params = None if params is None else _place(params,
                                                          self.device)

    def setBeamSize(self, k: int):
        self.decoder.k = k

    def registerBeamSearchControlCallbacks(
        self, adjust=None, drop=None, stop=None
    ):
        """User beam-control hooks, executed host-side each step
        (RecurrentGradientMachine.h:143-152
        registerBeamSearchControlCallbacks; see
        beam_search.BeamHooks for the signatures)."""
        from paddle_tpu_torch.beam_search import BeamHooks

        self.decoder.hooks = BeamHooks(
            adjust=adjust, drop=drop, stop=stop
        )

    def removeBeamSearchControlCallbacks(self):
        """(RecurrentGradientMachine.h:155) back to plain beam search."""
        from paddle_tpu_torch.beam_search import BeamHooks

        self.decoder.hooks = BeamHooks()

    def generate(self, statics: Sequence[Arg], boots=None):
        statics = [_arg_on(a, self.device) for a in statics]
        if boots:
            boots = _place(boots, self.device)
        self.last_result = self.decoder.generate(self.params, statics,
                                                 boots=boots)
        seqs, lens, _ = self.last_result
        seqs, lens = seqs.cpu().numpy(), lens.cpu().numpy()
        out = []
        n_keep = self.num_results or seqs.shape[1]
        for b in range(seqs.shape[0]):
            beams = []
            for k in range(min(n_keep, seqs.shape[1])):
                ids = seqs[b, k, : lens[b, k]].tolist()
                if self.dict_list is not None:
                    beams.append(
                        " ".join(self.dict_list[i] for i in ids)
                    )
                else:
                    beams.append(ids)
            out.append(beams)
        return out


def create_config_generator(model_conf, params, group_name=None,
                            device=None):
    """SequenceGenerator for a GENERATING v1 config — the
    `beam_search(...)` declaration parsed into a
    SubModelConf(is_generating=True) (trainer_config_helpers
    beam_search:3893; executed upstream by
    RecurrentGradientMachine::generateSequence,
    RecurrentGradientMachine.h:307). The user step runs per decode
    step; the GeneratedInput position receives the `embedding_name`
    lookup of the previously generated word. Returns (generator,
    static layer names, the group's attrs)."""
    from paddle_tpu_torch import dsl
    from paddle_tpu_torch.beam_search import BeamSearchDecoder
    from paddle_tpu_torch.core.config import ParameterConf

    def _find(conf):
        for sm in conf.sub_models:
            if sm.is_generating and (
                group_name is None or sm.name == group_name
            ):
                return sm, conf
        # a beam_search nested inside an outer recurrent_group's step
        # (the nested-generation form, sample_trainer_nest_rnn_gen:
        # each outer subsequence step generates one sequence) — its
        # statics are per-outer-step values, so the flat decoder runs
        # with batch = number of outer steps
        for lc in conf.layers:
            if lc.type == "recurrent_group":
                sub = lc.attrs.get("step_conf")
                if sub is not None:
                    found = _find(sub)
                    if found:
                        return found
        return None

    found = _find(model_conf)
    if not found:
        raise ValueError("config declares no generating beam_search group")
    gen_sm, host_conf = found
    a = gen_sm.attrs
    static_names = list(a["static_layer_names"])
    by_name = {lc.name: lc for lc in host_conf.layers}
    static_sizes = [by_name[n].size for n in static_names]

    def adapted_step(word, *statics):
        emb = dsl.embedding(
            word,
            size=a["embedding_size"],
            vocab_size=a["gen_size"],
            param=ParameterConf(name=a["embedding_name"]),
        )
        args = list(statics)
        args.insert(a["gen_pos"], emb)
        return a["step"](*args)

    dec = BeamSearchDecoder(
        adapted_step,
        n_static=len(static_names),
        bos_id=a["bos_id"],
        eos_id=a["eos_id"],
        beam_size=a["beam_size"],
        max_length=a["max_length"],
        static_sizes=static_sizes,
    )
    return (
        SequenceGenerator(dec, params, num_results=a["num_results"],
                          device=device),
        static_names,
        a,
    )
