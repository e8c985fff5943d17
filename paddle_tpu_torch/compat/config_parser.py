"""Execute unmodified reference v1 config files:
`paddle_tpu/compat/config_parser.py` for the port.

The counterpart of python/paddle/trainer/config_parser.py:3724
`parse_config(config_file, config_arg_str)`: a config file written
against `paddle.trainer_config_helpers` (the 2017 authoring surface) is
exec'd as-is and yields a `TrainerConfig` holding the port's `ModelConf`
+ `OptimizationConf` + data-source declarations.

The config's own imports: the JAX parser lets `from
paddle.trainer_config_helpers import *` (and a provider's `from
paddle.trainer.PyDataProvider2 import *`) resolve to the repo-root
`paddle` package, which imports the JAX package. The port neither
touches that package nor replaces `paddle` in `sys.modules` (both
packages may live in one process): `parse_config` and
`load_provider_module` exec with an `__import__` of their own in the
namespace's `__builtins__` (`v1_builtins`), which maps
`paddle.trainer_config_helpers`, `paddle.trainer.PyDataProvider2` and
`paddle.trainer.config_parser` to the port's
`compat/v1_namespace/` modules, `paddle.v2.framework[.x]` (the
reference's op-test namespace) to `compat/v2_framework/`, and refuses
any other `paddle` module; every other name goes to the builtin import.

Python-2-era configs are supported: `xrange` is injected into the exec
namespace, and `load_provider_module` execs provider modules the same
way so `@provider` generators using xrange run unmodified.
"""

from __future__ import annotations

import builtins
import importlib
import os
import types
from dataclasses import dataclass, field
from typing import Optional

from paddle_tpu_torch.core.config import ModelConf, OptimizationConf

__all__ = [
    "get_config_arg",
    "settings",
    "define_py_data_sources2",
    "TrainData",
    "TestData",
    "SimpleData",
    "ProtoData",
    "read_simple_data",
    "outputs",
    "inputs",
    "default_device",
    "Settings",
    "Inputs",
    "Outputs",
    "default_momentum",
    "default_decay_rate",
    "default_initial_std",
    "default_initial_mean",
    "parse_config",
    "load_provider_module",
    "TrainerConfig",
    "apply_data_types",
    "DataSources",
    # optimizer settings (trainer_config_helpers/optimizers.py)
    "MomentumOptimizer",
    "AdamOptimizer",
    "AdamaxOptimizer",
    "AdaGradOptimizer",
    "DecayedAdaGradOptimizer",
    "AdaDeltaOptimizer",
    "RMSPropOptimizer",
    "L1Regularization",
    "L2Regularization",
    # attrs / poolings (trainer_config_helpers/{attrs,poolings}.py)
    "ExtraAttr",
    "ExtraLayerAttribute",
    "ModelAverage",
    # evaluator declarations (trainer_config_helpers/evaluators.py)
    "classification_error_evaluator",
    "sum_evaluator",
    "column_sum_evaluator",
    "chunk_evaluator",
    "ctc_error_evaluator",
    "precision_recall_evaluator",
    "auc_evaluator",
    "pnpair_evaluator",
    "value_printer_evaluator",
    "gradient_printer_evaluator",
    "maxid_printer_evaluator",
    "maxframe_printer_evaluator",
    "seqtext_printer_evaluator",
    "classification_error_printer_evaluator",
    "MaxPooling",
    "AvgPooling",
    "SumPooling",
    "SqrtAvgPooling",
    "CudnnMaxPooling",
    "CudnnAvgPooling",
]


# ---- the config's own imports ---------------------------------------------

# what a v1 config or provider imports by name -> the port's module
V1_MODULES = {
    "paddle.trainer_config_helpers":
        "paddle_tpu_torch.compat.v1_namespace.trainer_config_helpers",
    "paddle.trainer.PyDataProvider2":
        "paddle_tpu_torch.compat.v1_namespace.PyDataProvider2",
    "paddle.trainer.config_parser":
        "paddle_tpu_torch.compat.v1_namespace.config_parser",
    **{"paddle.v2.framework" + sub:
       "paddle_tpu_torch.compat.v2_framework" + sub
       for sub in ("", ".core", ".op", ".default_scope_funcs",
                   ".gradient_checker", ".op_test_util", ".tests",
                   ".tests.gradient_checker", ".tests.op_test_util")},
}
# the packages above the mapped modules: an import binds stand-ins for
# them (`paddle.v2` only on the way to `paddle.v2.framework`, which
# refuses the rest of the v2 API)
V1_PACKAGES = ("paddle", "paddle.trainer", "paddle.v2")


def _v1_package(name: str) -> types.ModuleType:
    """A stand-in for the package `name` (one of V1_PACKAGES)
    whose attributes are the mapped modules under it."""
    pkg = types.ModuleType(name)
    for full, target in V1_MODULES.items():
        head, _, leaf = full.rpartition(".")
        if head == name:
            setattr(pkg, leaf, importlib.import_module(target))
    for sub in V1_PACKAGES:
        head, _, leaf = sub.rpartition(".")
        if head == name:
            setattr(pkg, leaf, _v1_package(sub))
    return pkg


PY_PADDLE = "paddle_tpu_torch.compat.py_paddle"


def _v1_import(name, globals=None, locals=None, fromlist=(), level=0):
    """`__import__` for exec'd v1 sources: the mapped `paddle` modules
    are the port's; another `paddle` module raises ImportError (the JAX
    package's shim is never imported); `py_paddle[.x]` is the port's
    namespace `compat/py_paddle`; any other name is the builtin
    import."""
    if not level and (name == "py_paddle" or name.startswith("py_paddle.")):
        mod = importlib.import_module(PY_PADDLE + name[len("py_paddle"):])
        # `import py_paddle.x [as y]` binds the top package
        return mod if fromlist else importlib.import_module(PY_PADDLE)
    if level or not (name == "paddle" or name.startswith("paddle.")):
        return builtins.__import__(name, globals, locals, fromlist, level)
    if name not in V1_MODULES and name not in ("paddle", "paddle.trainer"):
        raise ImportError(
            f"a v1 config imported {name!r}: the port's v1 front end "
            f"provides only {sorted(V1_MODULES)}")
    if not fromlist:
        # `import paddle.x.y [as z]` binds the top package
        return _v1_package("paddle")
    if name in V1_MODULES:
        return importlib.import_module(V1_MODULES[name])
    return _v1_package(name)


def v1_builtins() -> dict:
    """The builtins of an exec'd v1 config or provider: the builtin
    ones with `__import__` = `_v1_import`."""
    return {**vars(builtins), "__import__": _v1_import}


# ---- parse context -------------------------------------------------------

class _ParseCtx:
    def __init__(self, args: dict):
        self.args = args
        self.opt = OptimizationConf()
        self.data_sources: Optional[DataSources] = None
        self.train_data: Optional[dict] = None
        self.test_data: Optional[dict] = None
        self.outputs: list = []
        self.inputs: list = []
        self.evaluators: list = []


_stack: list = []  # innermost parse context last


def _ctx() -> Optional[_ParseCtx]:
    return _stack[-1] if _stack else None


def get_config_arg(name, type_=str, default=None):
    """--config_args interpolation (config_parser.py get_config_arg):
    values arrive as strings and are cast with `type_`."""
    ctx = _ctx()
    if ctx is None or name not in ctx.args:
        return default
    v = ctx.args[name]
    if type_ is bool:
        if isinstance(v, str):
            return v.strip().lower() not in ("", "0", "false", "no")
        return bool(v)
    return type_(v)


# ---- optimizer / regularization settings objects -------------------------

class _OptSetting:
    """Maps onto OptimizationConf fields."""

    fields: dict = {}


class MomentumOptimizer(_OptSetting):
    def __init__(self, momentum=0.9, sparse=False):
        self.fields = {"learning_method": "momentum", "momentum": momentum}


class AdamOptimizer(_OptSetting):
    def __init__(self, beta1=0.9, beta2=0.999, epsilon=1e-8):
        self.fields = {
            "learning_method": "adam",
            "adam_beta1": beta1,
            "adam_beta2": beta2,
            "adam_epsilon": epsilon,
        }


class AdamaxOptimizer(_OptSetting):
    def __init__(self, beta1=0.9, beta2=0.999):
        self.fields = {
            "learning_method": "adamax",
            "adam_beta1": beta1,
            "adam_beta2": beta2,
        }


class AdaGradOptimizer(_OptSetting):
    def __init__(self, epsilon=1e-6):
        self.fields = {"learning_method": "adagrad", "ada_epsilon": epsilon}


class DecayedAdaGradOptimizer(_OptSetting):
    def __init__(self, rou=0.95, epsilon=1e-6):
        self.fields = {
            "learning_method": "decayed_adagrad",
            "ada_rou": rou,
            "ada_epsilon": epsilon,
        }


class AdaDeltaOptimizer(_OptSetting):
    def __init__(self, rou=0.95, epsilon=1e-6):
        self.fields = {
            "learning_method": "adadelta",
            "ada_rou": rou,
            "ada_epsilon": epsilon,
        }


class RMSPropOptimizer(_OptSetting):
    def __init__(self, rou=0.95, epsilon=1e-6):
        self.fields = {
            "learning_method": "rmsprop",
            "ada_rou": rou,
            "ada_epsilon": epsilon,
        }


class L2Regularization(_OptSetting):
    def __init__(self, rate):
        self.fields = {"l2_rate": rate}


class L1Regularization(_OptSetting):
    def __init__(self, rate):
        self.fields = {"l1_rate": rate}


class ModelAverage(_OptSetting):
    """settings(model_average=ModelAverage(...)) — the AverageOptimizer
    window (trainer_config_helpers/optimizers.py ModelAverage)."""

    def __init__(self, average_window, max_average_window=0,
                 do_average_in_cpu=False):
        self.fields = {
            "average_window": average_window,
            "max_average_window": max_average_window,
        }


def settings(batch_size=256, learning_rate=0.01, learning_method=None,
             regularization=None, gradient_clipping_threshold=None,
             learning_rate_decay_a=0.0, learning_rate_decay_b=0.0,
             learning_rate_schedule=None, learning_rate_args="",
             average_window=0, max_average_window=0,
             model_average=None, **_):
    """trainer_config_helpers `settings(...)` -> OptimizationConf
    (config_parser.py:3576 Settings)."""
    ctx = _ctx()
    assert ctx is not None, "settings() outside parse_config"
    o = ctx.opt
    o.batch_size = batch_size
    o.learning_rate = learning_rate
    o.learning_rate_decay_a = learning_rate_decay_a
    o.learning_rate_decay_b = learning_rate_decay_b
    if learning_rate_schedule:
        o.learning_rate_schedule = learning_rate_schedule
    o.learning_rate_args = learning_rate_args
    o.average_window = average_window
    o.max_average_window = max_average_window
    if gradient_clipping_threshold is not None:
        o.gradient_clipping_threshold = gradient_clipping_threshold
    for setting in (learning_method, regularization, model_average):
        if setting is not None:
            for k, v in setting.fields.items():
                setattr(o, k, v)
    return o


# ---- attrs / poolings ----------------------------------------------------

class ExtraLayerAttribute:
    """(trainer_config_helpers/attrs.py ExtraLayerAttribute)."""

    def __init__(self, error_clipping_threshold=None, drop_rate=None,
                 device=None, **_):
        self.error_clipping_threshold = error_clipping_threshold
        self.drop_rate = drop_rate
        self.device = device


ExtraAttr = ExtraLayerAttribute


class _Pooling:
    name = ""

    def __init__(self, output_max_index=False, **_):
        self.output_max_index = output_max_index


class MaxPooling(_Pooling):
    name = "max"


class AvgPooling(_Pooling):
    name = "avg"


class SumPooling(_Pooling):
    name = "sum"


class SqrtAvgPooling(_Pooling):
    name = "sqrt_average"


# cudnn-tagged spellings (poolings.py CudnnMaxPooling/CudnnAvgPooling);
# the device-specific implementation distinction is XLA's business
class CudnnMaxPooling(_Pooling):
    name = "cudnn_max"


class CudnnAvgPooling(_Pooling):
    name = "cudnn_avg"


# ---- data sources --------------------------------------------------------

@dataclass
class DataSources:
    """define_py_data_sources2 declaration
    (trainer_config_helpers/data_sources.py)."""

    train_list: Optional[str] = None
    test_list: Optional[str] = None
    module: str = ""
    obj: str = ""
    args: dict = field(default_factory=dict)
    search_dir: str = ""  # config file's directory: providers live there

    def _reader(self, file_list, obj=None):
        import paddle_tpu_torch.data.reader as R

        mod = load_provider_module(self.module, self.search_dir)
        provider = getattr(mod, obj or self.obj)
        files = [
            ln.strip()
            for ln in open(file_list).read().splitlines()
            if ln.strip()
        ]
        return provider(files, **self.args), provider.input_types

    def train_reader(self):
        """(reader_creator, input_types) for the train list."""
        return self._reader(self.train_list)

    def test_reader(self):
        return self._reader(self.test_list)


# ---- v1 data declarations (config_parser.py TrainData/TestData;
#      SimpleData:986, ProtoData — the trainer-test configs' forms) ----

def SimpleData(files=None, feat_dim=None, context_len=None,
               buffer_capacity=None, **_):
    """Text samples 'label f1 .. fD' listed by a file-list
    (SimpleDataProvider, gserver/dataproviders/DataProvider.cpp:395)."""
    return {"type": "simple", "files": files, "feat_dim": feat_dim,
            "context_len": context_len or 0}


def ProtoData(files=None, type=None, **kw):
    """DataFormat.proto binary sample files listed by a file-list
    (ProtoDataProvider); decoded by data/proto_provider.py."""
    return {"type": type or "proto", "files": files, **kw}


def TrainData(decl, async_load_data=None, **_):
    ctx = _ctx()
    assert ctx is not None, "TrainData() outside parse_config"
    ctx.train_data = decl


def TestData(decl, async_load_data=None, **_):
    ctx = _ctx()
    assert ctx is not None, "TestData() outside parse_config"
    ctx.test_data = decl


def read_simple_data(filelist: str, feat_dim: int, context_len: int = 0):
    """Load every file in a SimpleData file-list: returns
    (features [N, feat_dim] float32, labels [N] int32). Line format is
    'label f1 .. fD' (DataProvider.cpp:404: label first). Context
    windows (context_len > 0) are not implemented — fail loudly rather
    than train on un-contextualized features."""
    import numpy as np

    if context_len:
        raise NotImplementedError(
            "SimpleData context_len > 0 (context-window expansion) is "
            "not supported; expand windows in the provider instead"
        )

    feats, labels = [], []
    for path in open(filelist).read().splitlines():
        path = path.strip()
        if not path:
            continue
        for line in open(path).read().splitlines():
            pieces = line.split()
            if len(pieces) != feat_dim + 1:
                raise ValueError(
                    f"{path}: got {len(pieces) - 1} features, "
                    f"config says {feat_dim}"
                )
            labels.append(int(pieces[0]))
            feats.append([float(p) for p in pieces[1:]])
    return (
        np.asarray(feats, np.float32),
        np.asarray(labels, np.int32),
    )


def define_py_data_sources2(train_list=None, test_list=None, module="",
                            obj="", args=None, **_):
    ctx = _ctx()
    assert ctx is not None, "define_py_data_sources2 outside parse_config"
    ctx.data_sources = DataSources(
        train_list=train_list,
        test_list=test_list,
        module=module,
        obj=obj,
        args=dict(args or {}),
    )
    return ctx.data_sources


# ---- evaluator declarations (trainer_config_helpers/evaluators.py) --

def _declare_evaluator(type_, input=None, label=None, name=None, **kw):
    ctx = _ctx()
    assert ctx is not None, "evaluator declared outside parse_config"
    if isinstance(input, (list, tuple)):
        # printer-style evaluators accept several inputs: one conf each
        return [
            _declare_evaluator(
                type_, x, label,
                f"{name}_{i}" if name and i else name, **kw
            )
            for i, x in enumerate(input)
        ]
    conf = {"type": type_}
    if name:
        conf["name"] = name
    if input is not None:
        conf["input"] = getattr(input, "name", input)
    if label is not None:
        conf["label"] = getattr(label, "name", label)
    for k, v in kw.items():
        if v is not None:
            conf[k] = v
    ctx.evaluators.append(conf)
    return conf


def classification_error_evaluator(input, label, name=None, **kw):
    return _declare_evaluator(
        "classification_error", input, label, name, **kw
    )


def sum_evaluator(input, name=None, **kw):
    return _declare_evaluator("sum", input, None, name, **kw)


def column_sum_evaluator(input, name=None, **kw):
    return _declare_evaluator("column_sum", input, None, name, **kw)


def chunk_evaluator(input, label, chunk_scheme, num_chunk_types,
                    name=None, excluded_chunk_types=None, **kw):
    return _declare_evaluator(
        "chunk", input, label, name, chunk_scheme=chunk_scheme,
        num_chunk_types=num_chunk_types,
        excluded_chunk_types=excluded_chunk_types, **kw
    )


def ctc_error_evaluator(input, label, name=None, **kw):
    return _declare_evaluator(
        "ctc_edit_distance", input, label, name, **kw
    )


def precision_recall_evaluator(input, label, name=None, **kw):
    return _declare_evaluator(
        "precision_recall", input, label, name, **kw
    )


def auc_evaluator(input, label, name=None, **kw):
    return _declare_evaluator("rankauc", input, label, name, **kw)


def pnpair_evaluator(input, label, info=None, query_id=None, name=None,
                     **kw):
    """The reference names the query-id slot `info`
    (trainer_config_helpers/evaluators.py pnpair_evaluator); accept
    both spellings."""
    q = info if info is not None else query_id
    assert q is not None, "pnpair_evaluator needs info= (query ids)"
    return _declare_evaluator(
        "pnpair", input, label, name,
        query_id=getattr(q, "name", q), **kw
    )


def value_printer_evaluator(input, name=None, **kw):
    return _declare_evaluator("value_printer", input, None, name, **kw)


def gradient_printer_evaluator(input, name=None, **kw):
    return _declare_evaluator(
        "gradient_printer", input, None, name, **kw
    )


def maxid_printer_evaluator(input, name=None, **kw):
    return _declare_evaluator("max_id_printer", input, None, name, **kw)


def maxframe_printer_evaluator(input, name=None, **kw):
    return _declare_evaluator(
        "max_frame_printer", input, None, name, **kw
    )


def seqtext_printer_evaluator(input, name=None, **kw):
    return _declare_evaluator(
        "seq_text_printer", input, None, name, **kw
    )


def classification_error_printer_evaluator(input, label, name=None, **kw):
    return _declare_evaluator(
        "classification_error_printer", input, label, name, **kw
    )


def outputs(*layer_refs):
    """Mark output/cost layers (trainer_config_helpers `outputs`)."""
    ctx = _ctx()
    assert ctx is not None, "outputs() outside parse_config"
    flat = []
    for r in layer_refs:
        flat += list(r) if isinstance(r, (list, tuple)) else [r]
    ctx.outputs = [getattr(r, "name", r) for r in flat]


def Settings(algorithm="sgd", batch_size=256, learning_rate=0.01,
             learning_method=None, learning_rate_decay_a=0.0,
             learning_rate_decay_b=0.0, learning_rate_schedule=None,
             **kw):
    """The raw config_parser `Settings(...)` spelling
    (config_parser.py:3576): like settings() but learning_method is a
    STRING and `algorithm` is accepted ('sgd' — async modes are out of
    scope, PARITY.md)."""
    ctx = _ctx()
    assert ctx is not None, "Settings() outside parse_config"
    o = ctx.opt
    o.batch_size = batch_size
    o.learning_rate = learning_rate
    if learning_method:
        o.learning_method = learning_method
    o.learning_rate_decay_a = learning_rate_decay_a
    o.learning_rate_decay_b = learning_rate_decay_b
    if learning_rate_schedule:
        o.learning_rate_schedule = learning_rate_schedule
    for k, v in kw.items():
        if hasattr(o, k) and v is not None:
            setattr(o, k, v)
    return o


def default_momentum(v: float) -> None:
    """config_parser default_momentum: the momentum used where no
    per-parameter momentum is configured."""
    ctx = _ctx()
    assert ctx is not None
    ctx.opt.momentum = v


def default_decay_rate(v: float) -> None:
    """config_parser default_decay_rate (L2)."""
    ctx = _ctx()
    assert ctx is not None
    ctx.opt.l2_rate = v


def default_initial_std(v: float) -> None:
    """config_parser default_initial_std. NOT threaded into implicit
    parameter creation: the framework's default init is already the
    reference's 'smart' 1/sqrt(fan_in); use per-param
    ParamAttr(initial_std=...) for exact control. Logged so silent
    divergence is visible."""
    import logging

    logging.getLogger("paddle_tpu_torch.compat").info(
        "default_initial_std(%s): framework keeps smart init; set "
        "ParamAttr(initial_std=...) per parameter for exact parity", v,
    )


def default_initial_mean(v: float) -> None:
    """See default_initial_std — logged, not applied implicitly."""
    import logging

    if v:
        logging.getLogger("paddle_tpu_torch.compat").warning(
            "default_initial_mean(%s) is not applied to implicitly "
            "created parameters; use ParamAttr(initial_mean=...)", v,
        )


def default_device(device: int) -> None:
    """v1 per-layer device placement default (config_parser.py
    default_device, consumed by ParallelNeuralNetwork). Devices are a
    mesh concern here (per-layer `out_sharding` GSPMD hints); the
    global default is a no-op under one compiled program."""
    ctx = _ctx()
    assert ctx is not None, "default_device() outside parse_config"


def inputs(*layer_refs):
    """Declare the network's input layers and their FEED ORDER
    (trainer_config_helpers `inputs`) — the order data-provider slots
    map onto data layers. Accepts refs or names (the raw config_parser
    `Inputs(...)` spelling)."""
    ctx = _ctx()
    assert ctx is not None, "inputs() outside parse_config"
    flat = []
    for r in layer_refs:
        flat += list(r) if isinstance(r, (list, tuple)) else [r]
    ctx.inputs = [getattr(r, "name", r) for r in flat]


# ---- the parser ----------------------------------------------------------

@dataclass
class TrainerConfig:
    """What parse_config returns: everything the trainer needs."""

    model: ModelConf
    opt: OptimizationConf
    data_sources: Optional[DataSources]
    args: dict
    evaluators: list = field(default_factory=list)
    # v1 TrainData/TestData declarations (SimpleData/ProtoData dicts)
    train_data: Optional[dict] = None
    test_data: Optional[dict] = None

    # -- the reference TrainerConfig proto surface the api drivers use
    #    (proto/TrainerConfig.proto; v1_api_demo/quick_start/api_train.py:80-84)
    @property
    def model_config(self):
        return self.model

    @property
    def opt_config(self):
        return self.opt

    def ClearField(self, name: str):
        if name in ("data_config", "test_data_config"):
            self.data_sources = None
        elif hasattr(self, name):
            setattr(self, name, None)

    def SerializeToString(self) -> bytes:
        """Deterministic wire form (the reference returns the
        TrainerConfig proto's SerializeToString,
        config_parser.py:3760). Dataclass reprs are deterministic, so
        equal configs serialize equal — the property
        parse_config_and_serialize callers rely on."""
        return repr(self).encode()


def _parse_args(config_args) -> dict:
    if not config_args:
        return {}
    if isinstance(config_args, dict):
        return dict(config_args)
    out = {}
    for pair in str(config_args).split(","):
        if not pair.strip():
            continue
        k, _, v = pair.partition("=")
        out[k.strip()] = v.strip()
    return out


def _raw_namespace() -> dict:
    """The exec namespace the reference injects into raw config files
    (everything this module exports + the raw Layer/Projection API +
    the helper-layer surface)."""
    import paddle_tpu_torch.compat.layers_v1 as _l1
    import paddle_tpu_torch.compat.raw_config as _raw

    import sys

    me = sys.modules[__name__]
    ns = {n: getattr(me, n) for n in __all__}
    ns.update({n: getattr(_l1, n) for n in _l1.__all__})
    ns.update({n: getattr(_raw, n) for n in _raw.__all__})
    return ns


def parse_config(config_file, config_args="") -> TrainerConfig:
    """Exec a v1 config file (config_parser.py:3724 parse_config).

    `config_file` may also be a callable (the reference parse_config
    accepts a function and calls it inside the parse scope —
    config_parser.py:3732 `if hasattr(trainer_config, '__call__')`;
    that is how config_parser_utils.parse_network_config drives it).
    `config_args` is the CLI `--config_args` string ("a=1,b=2") or a
    dict; values reach the config via `get_config_arg`. The file's own
    `from paddle.trainer_config_helpers import *` resolves through
    `v1_builtins` to the port's modules. Relative paths in the config (dict
    files, data lists) resolve against the CURRENT working directory,
    exactly as `paddle train` resolved them."""
    from paddle_tpu_torch import dsl

    ctx = _ParseCtx(_parse_args(config_args))
    _stack.append(ctx)
    # a config error inside an open raw RecurrentLayerGroupBegin scope
    # must not leak its sub-builder / group frame into later parses
    from paddle_tpu_torch.compat import raw_config as _raw_mod

    dsl_depth = len(dsl._stack)
    group_depth = len(_raw_mod._group_stack)
    try:
        if callable(config_file):
            with dsl.model() as g:
                config_file()
        else:
            with open(config_file) as f:
                code = compile(f.read(), config_file, "exec")
            ns = {
                "__file__": os.path.abspath(config_file),
                "__name__": "__paddle_config__",
                "__builtins__": v1_builtins(),
                "xrange": range,  # py2-era configs
            }
            # RAW configs (no imports) run inside the reference
            # parser's own namespace — seed the same surface; a
            # config's own `from ... import *` still shadows it
            ns.update(_raw_namespace())
            with dsl.model() as g:
                exec(code, ns)
        conf = g.conf
    finally:
        _stack.pop()
        # close leaked group scopes FIRST (each __exit__ pops its own
        # sub-builder; merely dropping the references would run the
        # suspended context managers' finally at GC time, popping
        # builders that are no longer top-of-stack)
        while len(_raw_mod._group_stack) > group_depth:
            _gname, _cm, *_rest = _raw_mod._group_stack.pop()
            try:
                _cm.__exit__(None, None, None)
            except Exception:
                pass
        del dsl._stack[dsl_depth:]
    if ctx.outputs:
        for name in ctx.outputs:
            if name not in conf.output_layer_names:
                conf.output_layer_names.append(name)
    if ctx.inputs:
        # inputs() fixes the data-layer FEED ORDER
        conf.input_layer_names = list(ctx.inputs)
    if ctx.data_sources is not None and not callable(config_file):
        ctx.data_sources.search_dir = os.path.dirname(
            os.path.abspath(config_file)
        )
    return TrainerConfig(
        model=conf, opt=ctx.opt, data_sources=ctx.data_sources,
        args=ctx.args, evaluators=ctx.evaluators,
        train_data=ctx.train_data, test_data=ctx.test_data,
    )


def apply_data_types(model: ModelConf, input_types) -> None:
    """Annotate the model's data layers from a provider's input_types —
    in v1 the slot type (dense/ids/sparse × seq level) came from the
    data-provider declaration (PyDataProvider2.py:47-214), not from the
    config's data_layer calls. `input_types` is a dict name->InputType
    or a list in SLOT order — which is the config's inputs()
    declaration (model.input_layer_names) when present, else data-layer
    declaration order."""
    data_layers = {
        lc.name: lc for lc in model.layers if lc.type == "data"
    }
    if isinstance(input_types, dict):
        pairs = [
            (data_layers[n], t)
            for n, t in input_types.items()
            if n in data_layers
        ]
    else:
        order = [
            n for n in (model.input_layer_names or data_layers)
            if n in data_layers
        ] or list(data_layers)
        pairs = [
            (data_layers[n], t) for n, t in zip(order, input_types)
        ]
    for lc, t in pairs:
        lc.attrs["is_ids"] = t.kind == "ids"
        lc.attrs["is_seq"] = t.seq >= 1
        lc.attrs["has_subseq"] = t.seq == 2


def load_provider_module(name_or_path: str, search_dir: str = ""):
    """Import a data-provider module the way the embedded interpreter
    did (PyDataProvider2.cpp loads the module by name with the config
    dir on sys.path) — but exec'd with `xrange` injected so py2-era
    providers run unmodified, and with `v1_builtins`, so that its
    `from paddle.trainer.PyDataProvider2 import *` is the port's."""
    path = name_or_path
    if not path.endswith(".py"):
        path = os.path.join(search_dir, name_or_path + ".py")
    if not os.path.exists(path):
        raise FileNotFoundError(f"provider module not found: {path}")
    mod = types.ModuleType(os.path.basename(path)[:-3])
    mod.__file__ = path
    mod.__dict__["xrange"] = range
    mod.__dict__["__builtins__"] = v1_builtins()
    with open(path) as f:
        code = compile(f.read(), path, "exec")
    exec(code, mod.__dict__)
    return mod


# raw config_parser spellings (config_parser.py Inputs/Outputs take
# layer NAMES)
Inputs = inputs
Outputs = outputs
