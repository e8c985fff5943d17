"""Config-building DSL — the user-facing layer functions.

Reference: python/paddle/trainer_config_helpers/layers.py (6212 LoC of
`*_layer` functions emitting LayerConfig protos) and
python/paddle/v2/layer.py. Same programming model: each function appends a
LayerConf to an ambient graph under construction and returns a handle
usable as an input to later calls.

    with model() as m:
        img = data("image", dim=(28, 28, 1))
        lbl = data("label", dim=(1,), is_ids=True)
        h = fc(img, size=128, act="tanh")
        out = fc(h, size=10)
        classification_cost(out, lbl)
    net = Network(m.conf)
"""

from __future__ import annotations

import contextlib
from dataclasses import dataclass, field
from typing import Optional

import numpy as np

from paddle_tpu_torch.core.config import (
    InputConf,
    LayerConf,
    ModelConf,
    ParameterConf,
    SubModelConf,
)


@dataclass
class GraphBuilder:
    conf: ModelConf = field(default_factory=ModelConf)
    _counts: dict = field(default_factory=dict)
    memories: list = field(default_factory=list)  # recurrent-group steps

    def uniq(self, prefix: str) -> str:
        n = self._counts.get(prefix, 0)
        self._counts[prefix] = n + 1
        return f"__{prefix}_{n}__"

    def add(self, lc: LayerConf) -> "LayerRef":
        self.conf.layers.append(lc)
        return LayerRef(lc.name, self)


@dataclass(frozen=True)
class LayerRef:
    name: str
    builder: GraphBuilder

    @property
    def size(self) -> int:
        """Output width (the reference LayerOutput.size)."""
        return self.builder.conf.layer(self.name).size

    def __add__(self, other: "LayerRef") -> "LayerRef":
        return addto(self, other)


_stack: list = []

# layer types whose output width equals input `idx`'s width — stamped
# onto LayerConf.size at DSL time (see _add)
# layer types whose LayerConf.size is NOT the flat output width at
# DSL time (it holds num_filters; spatial dims resolve at build)
_SIZE_AT_BUILD_ONLY = {
    "exconv", "exconvt", "conv", "cudnn_conv", "conv_operator",
    "pool", "spp", "maxout", "blockexpand", "fused_conv1x1_bn",
    "fused_bottleneck_tail",
}

_SIZE_PRESERVING = {
    "addto": 0,
    "slope_intercept": 0,
    "eltmul": 0,
    "clip": 0,
    "print": 0,
    "interpolation": 1,
    "scaling": 1,
    "power": 1,
}


def current() -> GraphBuilder:
    if not _stack:
        raise RuntimeError("no model() context active")
    return _stack[-1]


def _cost_name() -> str:
    """Default cost-layer name: plain "cost" for the first cost in the
    graph (what configs and evaluators reference), unique thereafter —
    multi-cost models (e.g. the VAE's reconstruct + KL terms) must not
    silently collide."""
    g = current()
    if all(lc.name != "cost" for lc in g.conf.layers):
        return "cost"
    return g.uniq("cost")


@contextlib.contextmanager
def model():
    g = GraphBuilder()
    _stack.append(g)
    try:
        yield g
    finally:
        _stack.pop()


def _in(x) -> InputConf:
    if isinstance(x, InputConf):
        return x
    # anything with a .name is a layer handle (LayerRef or the v1
    # compat mixed-layer builder); bare strings are layer names
    return InputConf(name=getattr(x, "name", x))


def _add(type_, inputs, name=None, size=0, act="", bias=True, param=None,
         bias_param=None, drop_rate=0.0, **attrs):
    g = current()
    name = name or g.uniq(type_)
    ins = []
    for i, x in enumerate(inputs):
        ic = _in(x)
        if param is not None and i == 0 and ic.parameter is None:
            ic.parameter = param
        ins.append(ic)
    if not size and type_ in _SIZE_PRESERVING and ins:
        # stamp the width at DSL time (the reference's LayerOutput.size
        # is always populated; layer arithmetic reads it immediately)
        idx = min(_SIZE_PRESERVING[type_], len(ins) - 1)
        try:
            size = g.conf.layer(ins[idx].name).size
        except KeyError:
            pass  # extra-output refs ('x@state') resolve at build time
    lc = LayerConf(
        name=name, type=type_, size=size, inputs=ins, active_type=act,
        bias=bias, bias_parameter=bias_param, drop_rate=drop_rate, attrs=attrs,
    )
    return g.add(lc)


# ---- inputs ----

def data(name, dim, is_seq=False, is_ids=False, has_subseq=False):
    dim = tuple(dim) if isinstance(dim, (tuple, list)) else (dim,)
    g = current()
    lc = LayerConf(
        name=name, type="data", size=int(np.prod(dim)),
        attrs={"dim": dim, "is_seq": is_seq, "is_ids": is_ids,
               "has_subseq": has_subseq},
    )
    g.conf.input_layer_names.append(name)
    return g.add(lc)


# ---- dense / basic ----

def fc(*inputs, size, name=None, act="", bias=True, param=None,
       bias_param=None, drop_rate=0.0):
    return _add("fc", inputs, name=name, size=size, act=act, bias=bias,
                param=param, bias_param=bias_param, drop_rate=drop_rate)


def embedding(ids, size, vocab_size, name=None, param=None, sharded=False):
    """sharded=True marks the table for row-sharding across the mesh — the
    pserver-sharded large-embedding analogue (SURVEY.md 'MP sparse')."""
    return _add("embedding", [ids], name=name, size=size, bias=False,
                param=param, vocab_size=vocab_size, sharded=sharded)


def addto(*inputs, name=None, act="", bias=False):
    return _add("addto", inputs, name=name, act=act, bias=bias)


def concat(*inputs, name=None, act="", bias=False):
    # bias defaults OFF (reference concat_layer bias_attr=False); the
    # v1 façade enables it for ConcatenateLayer2-style biased concats
    return _add("concat", inputs, name=name, act=act, bias=bias)


def cos_sim(a, b, scale=1.0, size=1, name=None):
    """size=k > 1: b packs k vectors of a's width; output [B, k]
    similarities (layers.py cos_sim size param)."""
    return _add("cos", [a, b], name=name, size=size, scale=scale)


def scaling(weight, x, name=None):
    """Per-row scalar weight times vector x (ScalingLayer)."""
    return _add("scaling", [weight, x], name=name)


def dropout(x, rate, name=None):
    return _add("addto", [x], name=name, bias=False, drop_rate=rate)


def mixed(size, inputs, name=None, act="", bias=True):
    """inputs: list of (layer, proj, extra_attrs) or InputConf. An
    extra-attrs key "param" becomes the edge's ParameterConf (v1
    projections carry param_attr, e.g. dotmul_projection)."""
    ins = []
    for item in inputs:
        if isinstance(item, tuple):
            layer, proj, *rest = item
            attrs = {"proj": proj}
            if rest:
                attrs.update(rest[0])
            param = attrs.pop("param", None)
            ins.append(
                InputConf(name=layer.name, attrs=attrs, parameter=param)
            )
        else:
            ins.append(_in(item))
    if not size:
        # infer at DSL time from size-preserving projections so layer
        # arithmetic right after this call sees the real width
        # (reference layers.py mixed_layer size=None inference);
        # extra-output refs ('x@state') defer to MixedLayer.build
        g = current()
        for ic in ins:
            # an edge may carry its own declared width (a projection's
            # size=, or conv_operator's parse-time output size) — that
            # wins over source-layer inference
            inferred = ic.attrs.get("proj_size")
            if not inferred:
                try:
                    src_lc = g.conf.layer(ic.name)
                except KeyError:
                    continue
                if src_lc.type in _SIZE_AT_BUILD_ONLY:
                    # conv/pool-family LayerConf.size holds
                    # num_filters, not the flat width — only their
                    # build() knows the real size; leave 0 for
                    # MixedLayer.build to resolve
                    continue
                inferred = mixed_proj_size(
                    ic.attrs.get("proj", "full_matrix"), src_lc.size,
                    ic.attrs
                )
            if inferred:
                size = inferred
                break
    # a projection's declared size must agree with the layer width —
    # the reference config parser rejects the mismatch at parse time,
    # and silently coercing would build different dimensions than the
    # config author wrote
    for ic in ins:
        ps = ic.attrs.get("proj_size")
        if ps and size and ps != size:
            raise ValueError(
                f"mixed layer {name or '?'}: projection on "
                f"{ic.name!r} declares size {ps} but the layer is "
                f"{size} wide"
            )
    return _add("mixed", ins, name=name, size=size, act=act, bias=bias)


def mixed_proj_size(proj, in_size, attrs):
    """Output width a size-preserving mixed-layer projection implies,
    or None when the projection doesn't determine it (full_matrix et
    al.). The single source of truth for DSL-time inference above and
    MixedLayer.build."""
    if proj in ("identity", "dotmul"):
        return in_size
    if proj == "slice":
        return sum(e - b for b, e in attrs["slices"])
    if proj == "context":
        return in_size * attrs["context_length"]
    if proj in ("full_matrix", "trans_full_matrix", "table"):
        # a projection may declare its own output width
        # (full_matrix_projection(size=...) / table_projection(size=...)
        # under a sizeless mixed)
        return attrs.get("proj_size") or None
    return None


# ---- image ----

def conv(x, num_filters, filter_size, stride=1, padding=0, groups=1,
         dilation=1, name=None, act="relu", bias=True, param=None,
         num_channels=None):
    kw = {"num_channels": num_channels} if num_channels else {}
    return _add("exconv", [x], name=name, size=num_filters, act=act, bias=bias,
                param=param, num_filters=num_filters, filter_size=filter_size,
                stride=stride, padding=padding, groups=groups,
                dilation=dilation, **kw)


def fused_conv1x1_bn(x, num_filters, act="relu", name=None,
                     use_global_stats=False,
                     moving_average_fraction=0.9, epsilon=1e-5):
    """1x1 conv + batch norm with epilogue stats (layers/fused.py —
    the ResNet bottleneck MFU lever). BN kwargs mirror batch_norm."""
    return _add("fused_conv1x1_bn", [x], name=name, size=num_filters,
                act=act, bias=False, use_global_stats=use_global_stats,
                moving_average_fraction=moving_average_fraction,
                epsilon=epsilon)


def fused_bottleneck_tail(x, num_filters, residual=None, act="relu",
                          name=None, use_global_stats=False,
                          moving_average_fraction=0.9, epsilon=1e-5):
    """BN+ReLU -> 1x1 conv -> BN [+ residual] -> act as one fused layer
    (layers/fused.py). BN kwargs mirror batch_norm."""
    ins = [x] if residual is None else [x, residual]
    return _add("fused_bottleneck_tail", ins, name=name,
                size=num_filters, act=act, bias=False,
                use_global_stats=use_global_stats,
                moving_average_fraction=moving_average_fraction,
                epsilon=epsilon)


def conv_trans(x, num_filters, filter_size, stride=1, padding=0, name=None,
               act="relu", bias=True, param=None, bias_param=None,
               num_channels=None):
    kw = {"num_channels": num_channels} if num_channels else {}
    return _add("exconvt", [x], name=name, size=num_filters, act=act,
                bias=bias, param=param, bias_param=bias_param,
                num_filters=num_filters, filter_size=filter_size,
                stride=stride, padding=padding, **kw)


def pool(x, pool_size, stride=None, padding=0, pool_type="max", name=None):
    return _add("pool", [x], name=name, pool_type=pool_type,
                pool_size=pool_size, stride=stride or pool_size,
                padding=padding)


def batch_norm(x, name=None, act="", use_global_stats=False,
               moving_average_fraction=0.9, epsilon=1e-5):
    return _add("batch_norm", [x], name=name, act=act,
                use_global_stats=use_global_stats,
                moving_average_fraction=moving_average_fraction,
                epsilon=epsilon)


def lrn(x, size=5, scale=1e-4, power=0.75, name=None):
    return _add("norm", [x], name=name, size=size, scale=scale, pow=power)


def maxout(x, groups, name=None):
    return _add("maxout", [x], name=name, groups=groups)


def spp(x, pyramid_height=3, pool_type="max", name=None):
    return _add("spp", [x], name=name, pyramid_height=pyramid_height,
                pool_type=pool_type)


def block_expand(x, block, stride=None, padding=0, name=None):
    return _add("blockexpand", [x], name=name, block=block,
                stride=stride or block, padding=padding)


# ---- recurrence ----

def recurrent(x, size, name=None, act="tanh", reversed=False, bias=True):
    return _add("recurrent", [x], name=name, size=size, act=act,
                bias=bias, reversed=reversed)


def lstmemory(x, size, name=None, act="tanh", gate_act="sigmoid",
              state_act="tanh", reversed=False, bias=True, param=None):
    return _add("lstmemory", [x], name=name, size=size, act=act, bias=bias,
                param=param, active_gate_type=gate_act,
                active_state_type=state_act, reversed=reversed)


def mdlstm(x, size, name=None, act="tanh", gate_act="sigmoid",
           state_act="tanh", directions=(True, True), bias=True,
           param=None):
    """2-D multi-dimensional LSTM over a [H, W, 5*size] grid
    (gserver/layers/MDLstmLayer.cpp)."""
    return _add("mdlstm", [x], name=name, size=size, act=act, bias=bias,
                param=param, active_gate_type=gate_act,
                active_state_type=state_act,
                directions=tuple(directions))


def grumemory(x, size, name=None, act="tanh", gate_act="sigmoid",
              reversed=False, bias=True, param=None):
    return _add("grumemory", [x], name=name, size=size, act=act, bias=bias,
                param=param, active_gate_type=gate_act, reversed=reversed)


def simple_lstm(x, size, name=None, act="tanh", reversed=False):
    """fc(4h) + lstmemory — the networks.py simple_lstm
    (trainer_config_helpers/networks.py:548)."""
    proj = fc(x, size=size * 4, name=(name or "lstm") + "_proj", bias=True)
    return lstmemory(proj, size=size, name=name, act=act, reversed=reversed)


def simple_gru(x, size, name=None, act="tanh", gate_act="sigmoid",
               reversed=False):
    """(networks.py:975 simple_gru)."""
    proj = fc(x, size=size * 3, name=(name or "gru") + "_proj", bias=True)
    return grumemory(proj, size=size, name=name, act=act,
                     gate_act=gate_act, reversed=reversed)


def bidirectional_lstm(x, size, name=None, return_concat=True):
    """(networks.py:1207 bidirectional_lstm)."""
    fwd = simple_lstm(x, size, name=(name or "bilstm") + "_fwd")
    bwd = simple_lstm(x, size, name=(name or "bilstm") + "_bwd", reversed=True)
    return concat(fwd, bwd) if return_concat else (fwd, bwd)


# ---- step-level rnn units/groups (networks.py:633-1122) ----
# The 2017-era building blocks seq2seq configs compose inside
# recurrent_group: one-timestep cells over memory() links, and their
# prebuilt recurrent_group wrappers. Cell math lives in layers/steps.py
# (lstm_step/gru_step); here is only the wiring.

def lstmemory_unit(x, size=None, name=None, out_memory=None, act="tanh",
                   gate_act="sigmoid", state_act="tanh", param=None,
                   bias=True, bias_param=None):
    """One LSTM timestep inside a recurrent_group step
    (networks.py:633 lstmemory_unit). `x` must already carry the
    input-to-hidden projection (width 4*size — the reference's
    convention of hoisting W_x*x out of the unit). Unlike the
    reference, the hidden-to-hidden projection lives INSIDE lstm_step
    (its `w0`, layout-compatible with lstmemory so weights transfer) —
    no `%s_input_recurrent` mixed layer is needed. A `{name}_state`
    layer exposes c_t so the state memory links to it."""
    if size is None:
        assert x.size % 4 == 0, f"lstmemory_unit input {x.size} % 4 != 0"
        size = x.size // 4
    name = name or current().uniq("lstmemory_unit")
    out_mem = out_memory if out_memory is not None else memory(
        name, size=size
    )
    state_mem = memory(f"{name}_state", size=size)
    lstm_out = _add("lstm_step", [x, out_mem, state_mem], name=name,
                    size=size, act=act, bias=bias, param=param,
                    bias_param=bias_param,
                    active_gate_type=gate_act,
                    active_state_type=state_act)
    get_output(lstm_out, "state", name=f"{name}_state")
    return lstm_out


def lstmemory_group(x, size=None, name=None, out_memory=None,
                    reversed=False, act="tanh", gate_act="sigmoid",
                    state_act="tanh", param=None, bias=True,
                    bias_param=None):
    """recurrent_group-built LSTM over a sequence already projected to
    4*size (networks.py:744 lstmemory_group) — same math as lstmemory,
    with every step's hidden/cell state addressable by step-net layer
    name (the attention-model use case)."""
    if size is None:
        assert x.size % 4 == 0, f"lstmemory_group input {x.size} % 4 != 0"
        size = x.size // 4
    name = name or current().uniq("lstm_group")

    def step(ipt):
        return lstmemory_unit(
            ipt, size=size, name=name, out_memory=out_memory, act=act,
            gate_act=gate_act, state_act=state_act, param=param,
            bias=bias, bias_param=bias_param,
        )

    return recurrent_group(step, [x], name=f"{name}_recurrent_group",
                           reversed=reversed)


def gru_unit(x, size=None, name=None, memory_boot=None, act="tanh",
             gate_act="sigmoid", param=None, bias=True,
             bias_param=None, naive=False):
    """One GRU timestep inside a recurrent_group step (networks.py:840
    gru_unit). `x` must already be the 3*size gate pre-projection."""
    if size is None:
        assert x.size % 3 == 0, f"gru_unit input {x.size} % 3 != 0"
        size = x.size // 3
    name = name or current().uniq("gru_unit")
    out_mem = memory(name, size=size, boot_layer=memory_boot)
    return _add("gru_step_naive" if naive else "gru_step", [x, out_mem],
                name=name, size=size, act=act, bias=bias, param=param,
                bias_param=bias_param, active_gate_type=gate_act)


def gru_group(x, size=None, name=None, memory_boot=None, reversed=False,
              act="tanh", gate_act="sigmoid", param=None, bias=True,
              bias_param=None, naive=False):
    """recurrent_group-built GRU over a 3*size-projected sequence
    (networks.py:902 gru_group) — grumemory math with per-step hidden
    states addressable inside the group."""
    if size is None:
        assert x.size % 3 == 0, f"gru_group input {x.size} % 3 != 0"
        size = x.size // 3
    name = name or current().uniq("gru_group")

    def step(ipt):
        return gru_unit(ipt, size=size, name=name,
                        memory_boot=memory_boot, act=act,
                        gate_act=gate_act, param=param, bias=bias,
                        bias_param=bias_param, naive=naive)

    return recurrent_group(step, [x], name=f"{name}_recurrent_group",
                           reversed=reversed)


def simple_gru2(x, size, name=None, act="tanh", gate_act="sigmoid",
                reversed=False):
    """fc(3h) + grumemory (networks.py:1061 simple_gru2 — the faster
    formulation of simple_gru; here both lower to the same scanned
    cell, the distinction is per-step state addressability only)."""
    name = name or current().uniq("gru2")
    proj = fc(x, size=size * 3, name=f"{name}_transform", bias=True)
    return grumemory(proj, size=size, name=name, act=act,
                     gate_act=gate_act, reversed=reversed)


def bidirectional_gru(x, size, name=None, return_seq=False, act="tanh",
                      gate_act="sigmoid"):
    """(networks.py:1122 bidirectional_gru). return_seq=False concats
    the forward last / backward first frames; True concats the full
    output sequences."""
    name = name or current().uniq("bigru")
    fwd = simple_gru2(x, size, name=f"{name}_fw", act=act,
                      gate_act=gate_act)
    bwd = simple_gru2(x, size, name=f"{name}_bw", act=act,
                      gate_act=gate_act, reversed=True)
    if return_seq:
        return concat(fwd, bwd, name=name)
    return concat(last_seq(fwd), first_seq(bwd), name=name)


def img_conv_bn_pool(x, filter_size, num_filters, pool_size, name=None,
                     pool_type="max", act="relu", groups=1,
                     conv_stride=1, conv_padding=0, num_channel=None,
                     conv_param=None, pool_stride=1, pool_padding=0):
    """conv -> batch_norm(act) -> pool (networks.py:232
    img_conv_bn_pool)."""
    name = name or current().uniq("conv_bn_pool")
    c = conv(x, num_filters, filter_size, stride=conv_stride,
             padding=conv_padding, groups=groups, act="",
             param=conv_param, num_channels=num_channel,
             name=f"{name}_conv")
    bn = batch_norm(c, act=act, name=f"{name}_bn")
    return pool(bn, pool_size, pool_stride, padding=pool_padding,
                pool_type=pool_type, name=f"{name}_pool")


# ---- sequence structure ----

def seq_pool(x, pool_type="sum", level="seq", name=None, stride=0,
             output_max_index=False):
    """stride>0 pools each stride-window to one frame (output stays a
    sequence); output_max_index with max pooling emits the argmax
    timestep per feature instead of the value (both from
    SequencePoolLayer.cpp / MaxLayer.cpp)."""
    return _add("seqpool", [x], name=name, pool_type=pool_type,
                level=level, stride=stride,
                output_max_index=output_max_index)


def last_seq(x, name=None, stride=0, level="seq"):
    """level="subseq": one frame per subsequence of a nested input
    (AggregateLevel.TO_SEQUENCE); stride>0: one frame per
    stride-window (both from SequenceLastInstanceLayer.cpp)."""
    return _add("seqlastins", [x], name=name, stride=stride,
                level=level)


def first_seq(x, name=None, stride=0, level="seq"):
    return _add("seqlastins", [x], name=name, select_first=True,
                stride=stride, level=level)


def expand(x, ref, name=None, level="non-seq"):
    """level="seq" (ExpandLevel.FROM_SEQUENCE): x is a sequence with
    one frame per SUB-sequence of the nested ref; each frame repeats
    over its subsequence's timesteps."""
    return _add("expand", [x, ref], name=name, expand_level=level)


def seq_concat(a, b, name=None):
    return _add("seqconcat", [a, b], name=name)


def sub_seq(x, offset, size, name=None):
    """Dynamic per-example sub-span of a sequence (layers.py
    sub_seq_layer; SubSequenceLayer.cpp). offset/size: [B] id layers."""
    return _add("subseq", [x, offset, size], name=name, bias=False)


def seq_reverse(x, name=None):
    return _add("seqreverse", [x], name=name)


# ---- recurrent groups (trainer_config_helpers/layers.py memory:3160,
# recurrent_group:3610; executor in layers/recurrent_group.py) ----


class StaticInput:
    """Read-only per-sequence input to a recurrent group — the reference's
    StaticInput: a non-sliced value visible whole at every step (e.g. the
    encoder sequence for attention)."""

    def __init__(self, ref):
        self.ref = ref


class MemoryRef(LayerRef):
    """LayerRef for a memory link that also carries the memory record,
    so the reference's deferred-binding idiom works: `m = memory(
    name=None, size=...); ... ; m.set_input(layer)` (layers.py memory
    set_input — used by e.g. the reference test_rnn_group config)."""

    def __init__(self, name, builder, record):
        super().__init__(name, builder)
        object.__setattr__(self, "_record", record)

    def set_input(self, layer):
        self._record["layer"] = layer.name
        return self


def memory(name, size, boot_layer=None, boot_value=0.0):
    """Inside a recurrent_group step: the value the step-layer `name` had
    at t-1 (boot at t=0). Mirrors trainer_config_helpers memory().
    `name=None` defers the producing-layer binding to a later
    `.set_input(layer)` call on the returned ref."""
    g = current()
    link = f"@mem_{name}" if name is not None else g.uniq("@mem_anon")
    g.add(
        LayerConf(
            name=link, type="data", size=size,
            attrs={"dim": (size,), "is_seq": False, "is_ids": False},
        )
    )
    record = {
        "layer": name,
        "link": link,
        "boot_layer": boot_layer.name if boot_layer is not None else None,
        "boot_value": boot_value,
        "size": size,
    }
    g.memories.append(record)
    return MemoryRef(link, g, record)


def group_layer_conf(name, sub, *, parent_inputs, in_links, static_links,
                     out_links, reversed=False):
    """The scan-executor LayerConf for a recurrent group — the ONE
    place the contract lives (consumed by layers/recurrent_group.py);
    both recurrent_group below and the raw
    RecurrentLayerGroupBegin/End API build through it."""
    boot_layers = [
        m["boot_layer"] for m in sub.memories
        if m["boot_layer"] is not None
    ]
    return LayerConf(
        name=name,
        type="recurrent_group",
        size=0,
        inputs=[InputConf(n) for n in parent_inputs]
        + [InputConf(n) for n in boot_layers],
        attrs={
            "step_conf": sub.conf,
            "in_links": list(in_links),
            "static_links": list(static_links),
            "memories": sub.memories,
            "out_links": list(out_links),
            "reversed": reversed,
        },
    )


def recurrent_group(step, inputs, name=None, reversed=False):
    """Build a scanned step network. `inputs`: LayerRefs (sequence
    in-links, sliced per step) and/or StaticInput(ref). `step` receives
    one LayerRef per input (in order) and returns the output LayerRef
    (or tuple; first is the group's output)."""
    parent = current()
    name = name or parent.uniq("recurrent_group")
    seq_ins = [x for x in inputs if not isinstance(x, StaticInput)]
    stat_ins = [x.ref for x in inputs if isinstance(x, StaticInput)]
    # share the parent's name counters so auto-named step layers can never
    # collide with auto-named parent layers (one config namespace, as in
    # the reference where group layers live inside the global ModelConfig)
    with model() as sub:
        sub._counts = parent._counts
        step_args = []
        in_links, static_links = [], []

        def _parent_size(ref):
            try:
                return parent.conf.layer(ref.name).size
            except KeyError:
                return 0

        # stubs carry the parent layer's SIZE so size-dependent config
        # helpers (simple_attention's proj width) work on step args;
        # the group layer re-stamps dim/is_ids from the real inputs at
        # build time
        for i, r in enumerate(seq_ins):
            ln = f"@in_{i}"
            sz = _parent_size(r)
            sub.add(LayerConf(name=ln, type="data", size=sz,
                              attrs={"dim": (sz,), "is_seq": False,
                                     "is_ids": False}))
            in_links.append(ln)
        for i, r in enumerate(stat_ins):
            ln = f"@static_{i}"
            sz = _parent_size(r)
            sub.add(LayerConf(name=ln, type="data", size=sz,
                              attrs={"dim": (sz,), "is_seq": False,
                                     "is_ids": False}))
            static_links.append(ln)
        it_seq = iter(in_links)
        it_static = iter(static_links)
        for x in inputs:
            ln = next(it_static) if isinstance(x, StaticInput) else next(it_seq)
            step_args.append(LayerRef(ln, sub))
        out = step(*step_args)
    outs = list(out) if isinstance(out, (tuple, list)) else [out]
    lc = group_layer_conf(
        name, sub,
        parent_inputs=[r.name for r in seq_ins]
        + [r.name for r in stat_ins],
        in_links=in_links, static_links=static_links,
        out_links=[o.name for o in outs], reversed=reversed,
    )
    ref = parent.add(lc)
    if isinstance(out, (tuple, list)):
        # secondary out_links surface under their step-layer names
        return (ref,) + tuple(LayerRef(o.name, parent) for o in outs[1:])
    return ref


# ---- costs ----

def classification_cost(logits, label, name=None, coeff=1.0,
                        weight=None):
    ins = [logits, label] + ([weight] if weight is not None else [])
    return _add("classification_cost", ins, name=name or _cost_name(),
                bias=False, coeff=coeff)


def cross_entropy(prob, label, name=None, coeff=1.0, weight=None):
    ins = [prob, label] + ([weight] if weight is not None else [])
    return _add("multi-class-cross-entropy", ins,
                name=name or _cost_name(), bias=False, coeff=coeff)


def square_error(x, y, name=None, coeff=1.0, weight=None):
    ins = [x, y] + ([weight] if weight is not None else [])
    return _add("square_error", ins, name=name or _cost_name(),
                bias=False, coeff=coeff)


def rank_cost(a, b, label, name=None, coeff=1.0):
    return _add("rank-cost", [a, b, label], name=name or _cost_name(), bias=False,
                coeff=coeff)


def multibox_loss(priorbox_ref, gt_box, gt_label, loc_pred, conf_pred,
                  num_classes, name=None, overlap_threshold=0.5,
                  neg_pos_ratio=3.0, neg_overlap=0.5, background_id=0):
    """(trainer_config_helpers/layers.py multibox_loss_layer; gserver
    MultiBoxLossLayer.cpp). loc_pred/conf_pred may be lists of per-scale
    feature outputs — they are concatenated like the reference's
    multi-input wiring."""
    if isinstance(loc_pred, (tuple, list)):
        loc_pred = concat(*loc_pred)
    if isinstance(conf_pred, (tuple, list)):
        conf_pred = concat(*conf_pred)
    return _add("multibox_loss",
                [priorbox_ref, gt_box, gt_label, loc_pred, conf_pred],
                name=name, bias=False,
                num_classes=num_classes,
                overlap_threshold=overlap_threshold,
                neg_pos_ratio=neg_pos_ratio, neg_overlap=neg_overlap,
                background_id=background_id)


def moe(x, num_experts, hidden=None, name=None, capacity_factor=1.25,
        expert_act="relu", aux_loss_coeff=0.01):
    """Sparsely-activated mixture-of-experts FFN (layers/moe.py). Wires
    the layer's load-balancing aux output into a sum_cost so the
    trainer applies it alongside the task loss."""
    ref = _add("moe", [x], name=name, bias=False, num_experts=num_experts,
               hidden=hidden or 0, capacity_factor=capacity_factor,
               expert_act=expert_act)
    if aux_loss_coeff:
        sum_cost(LayerRef(f"{ref.name}@aux", current()),
                 name=f"{ref.name}@aux_cost", coeff=aux_loss_coeff)
    return ref


def dot_mul(a, b, name=None, act=""):
    """Elementwise product of two same-size layers (DotMulOperator)."""
    return _add("dot_mul", [a, b], name=name, bias=False, act=act)


def slope_intercept(x, slope=1.0, intercept=0.0, name=None):
    return _add("slope_intercept", [x], name=name, bias=False,
                slope=slope, intercept=intercept)


def interpolation(weight, a, b, name=None):
    return _add("interpolation", [weight, a, b], name=name, bias=False)


def soft_binary_cross_entropy(prob, label, name=None, coeff=1.0):
    """Elementwise binary CE with soft labels (layers.py
    cross_entropy_with_selfnorm family; CostLayer.cpp
    SoftBinaryClassCrossEntropy)."""
    return _add("soft_binary_class_cross_entropy", [prob, label],
                name=name or _cost_name(), bias=False, coeff=coeff)


def sum_cost(x, name=None, coeff=1.0):
    """(trainer_config_helpers sum_cost): cost = sum of the input."""
    return _add("sum_cost", [x], name=name or _cost_name(), bias=False,
                coeff=coeff)


def multi_binary_label_cross_entropy(prob, label, name=None, coeff=1.0):
    """Multi-label binary CE (CostLayer.cpp
    MultiBinaryLabelCrossEntropy); label is a dense 0/1 matrix."""
    return _add("multi_binary_label_cross_entropy", [prob, label],
                name=name or _cost_name(), bias=False, coeff=coeff)


def eltmul(a, b, scale=1.0, name=None):
    """Elementwise product (the reference mixed-layer DotMulOperator,
    config_parser.py DotMulOperator)."""
    return _add("eltmul", [a, b], name=name, bias=False, scale=scale)


def crf(emission, label, num_tags, name=None, param=None, coeff=1.0):
    """(layers.py crf_layer)."""
    return _add("crf", [emission, label], name=name or _cost_name(), size=num_tags,
                bias=False, param=param, coeff=coeff)


def crf_decoding(emission, num_tags, label=None, name=None, param=None):
    ins = [emission] if label is None else [emission, label]
    return _add("crf_decoding", ins, name=name, size=num_tags, bias=False,
                param=param)


# ---- long-tail layers (layers/extras.py) ----

def selective_fc(x, select=None, *, size, name=None, act="", bias=True,
                 param=None):
    """(layers.py selective_fc_layer). `select` is a dense 0/1 mask layer
    [B, size]; omitted -> plain fc behavior."""
    ins = [x] if select is None else [x, select]
    return _add("selective_fc", ins, name=name, size=size, act=act,
                bias=bias, param=param)


def conv_shift(a, b, name=None):
    """Circular convolution (layers.py conv_shift_layer, NTM)."""
    return _add("conv_shift", [a, b], name=name, bias=False)


def bilinear_interp(x, out_size_x, out_size_y, name=None):
    return _add("bilinear_interp", [x], name=name, bias=False,
                out_size_x=out_size_x, out_size_y=out_size_y)


def linear_comb(weights, vectors, size, name=None):
    """(layers.py linear_comb_layer / convex_comb_layer)."""
    return _add("convex_comb", [weights, vectors], name=name, size=size,
                bias=False)


def eos_id(x, eos_id, name=None):
    return _add("eos_id", [x], name=name, bias=False, eos_id=eos_id)


def power(weight, x, name=None):
    return _add("power", [weight, x], name=name, bias=False)


def clip(x, min=-1.0, max=1.0, name=None):
    return _add("clip", [x], name=name, bias=False, min=min, max=max)


def row_conv(x, context_length, name=None, param=None):
    """Lookahead convolution (layers.py row_conv_layer, DS2)."""
    return _add("row_conv", [x], name=name, bias=False, param=param,
                context_length=context_length)


def featmap_expand(x, num_filters, name=None):
    return _add("featmap_expand", [x], name=name, bias=False,
                num_filters=num_filters)


def context_projection(x, context_length, context_start=None):
    """A mixed()-input edge concatenating neighboring timesteps
    (ContextProjection.h). Usage:
    mixed(size=D*L, inputs=[context_projection(x, L, start)])."""
    return (x, "context", {
        "context_length": context_length,
        "context_start": (
            context_start if context_start is not None
            else -(context_length // 2)
        ),
    })


# ---- detection (SSD) ----

def priorbox(feature, image, min_size, max_size=(), aspect_ratio=(),
             variance=(0.1, 0.1, 0.2, 0.2), flip=True, clip=True,
             name=None):
    """(layers.py priorbox_layer; gserver PriorBox.cpp)."""
    return _add("priorbox", [feature, image], name=name, bias=False,
                min_size=tuple(min_size), max_size=tuple(max_size),
                aspect_ratio=tuple(aspect_ratio), variance=tuple(variance),
                flip=flip, clip=clip)


def detection_output(priorbox_ref, loc_pred, conf_pred, num_classes,
                     name=None, nms_threshold=0.45, nms_top_k=400,
                     keep_top_k=200, confidence_threshold=0.01,
                     background_id=0):
    """(layers.py detection_output_layer; DetectionOutputLayer.cpp)."""
    if isinstance(loc_pred, (tuple, list)):
        loc_pred = concat(*loc_pred)
    if isinstance(conf_pred, (tuple, list)):
        conf_pred = concat(*conf_pred)
    return _add("detection_output", [priorbox_ref, loc_pred, conf_pred],
                name=name, bias=False, num_classes=num_classes,
                nms_threshold=nms_threshold, nms_top_k=nms_top_k,
                keep_top_k=keep_top_k,
                confidence_threshold=confidence_threshold,
                background_id=background_id)


# ---- prebuilt networks (trainer_config_helpers/networks.py) ----

def simple_img_conv_pool(x, num_filters, filter_size, pool_size, pool_stride,
                         act="relu", name=None, padding=0):
    """(networks.py:145 simple_img_conv_pool)."""
    c = conv(x, num_filters, filter_size, padding=padding, act=act,
             name=(name or "convpool") + "_conv")
    return pool(c, pool_size, pool_stride, name=(name or "convpool") + "_pool")


def img_conv_group(x, conv_num_filter, conv_filter_size,
                   pool_size, pool_stride, conv_act="relu",
                   conv_with_batchnorm=False, pool_type="max"):
    """A VGG block (networks.py:333 img_conv_group)."""
    h = x
    for i, nf in enumerate(conv_num_filter):
        h = conv(h, nf, conv_filter_size, padding=(conv_filter_size - 1) // 2,
                 act="" if conv_with_batchnorm else conv_act)
        if conv_with_batchnorm:
            h = batch_norm(h, act=conv_act)
    return pool(h, pool_size, pool_stride, pool_type=pool_type)


def simple_attention(encoded_sequence, encoded_proj, decoder_state,
                     name=None, weight_act="tanh", transform_param=None,
                     softmax_param=None, size=None):
    """Bahdanau additive attention (networks.py:1298 simple_attention):
    e_j = v·f(W s + U h_j), a = seq_softmax(e), c = sum_j a_j h_j.
    `encoded_proj` carries U h_j precomputed once over the encoder;
    call inside a recurrent_group step with `decoder_state` a memory
    (stubs inherit the parent layer's size there). Inside a
    BeamSearchDecoder step, pass `static_sizes=` to the decoder (or
    `size=` here) — its standalone stubs have no parent to inherit
    from."""
    name = name or current().uniq("simple_attention")
    proj_size = size or current().conf.layer(encoded_proj.name).size
    assert proj_size, (
        "simple_attention: encoded_proj has no size here — inside a "
        "BeamSearchDecoder step pass static_sizes= to the decoder, or "
        "size= to this call"
    )
    proj_s = fc(decoder_state, size=proj_size, bias=False,
                param=transform_param, name=f"{name}_dec_proj")
    expanded = expand(proj_s, encoded_proj, name=f"{name}_expand")
    mix = addto(encoded_proj, expanded, act=weight_act,
                name=f"{name}_mix")
    scores = fc(mix, size=1, bias=False, act="sequence_softmax",
                param=softmax_param, name=f"{name}_score")
    weighted = scaling(scores, encoded_sequence, name=f"{name}_weighted")
    return seq_pool(weighted, pool_type="sum", name=f"{name}_context")


def prelu(x, name=None, partial_sum=0, param=None):
    return _add("prelu", [x], name=name, bias=False, param=param,
                partial_sum=partial_sum)


def gated_unit(x, size, act="", name=None, bias=True):
    return _add("gated_unit", [x], name=name, size=size, act=act,
                bias=bias)


def repeat(x, num_repeats, name=None):
    return _add("repeat", [x], name=name, bias=False,
                num_repeats=num_repeats)


def kmax_seq_score(scores, beam_size=1, name=None):
    return _add("kmax_seq_score", [scores], name=name, bias=False,
                beam_size=beam_size)


def sub_nested_seq(x, selected_indices, name=None):
    """(layers.py:6098 sub_nested_seq_layer)."""
    return _add("sub_nested_seq", [x, selected_indices], name=name,
                bias=False)


def get_output(layer, arg_name, name=None):
    """Reference get_output_layer: reference a layer's named extra
    output (e.g. lstm_step's cell state). Extra outputs are addressable
    directly as '<layer>@<arg>' input names; with `name` given, an
    identity layer is materialized under that name so by-name lookups
    (outputs, evaluators, boot links) resolve."""
    ref = LayerRef(f"{layer.name}@{arg_name}", current())
    if name:
        return _add("addto", [ref], name=name, bias=False)
    return ref
