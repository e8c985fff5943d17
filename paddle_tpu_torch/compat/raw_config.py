"""The reference's RAW config API — the functions `config_parser.py`
injects into a config's exec namespace (no imports in the file; the
2015-era authoring surface under trainer_config_helpers):

    Layer(name=..., type="mixed", size=..., inputs=[
        FullMatrixProjection("src", parameter_name="w"), ...])
    Memory(name=..., size=...)
    RecurrentLayerGroupBegin/End(...)
    Evaluator(name=..., type="sum", inputs=...)

Reference: python/paddle/trainer/config_parser.py — @config_layer
classes (Layer dispatch :2910 MixedLayer et al.), Input/Projection
configs, Memory (:299-386 RNN groups), RecurrentLayerGroupBegin/End
(:368,:386), Evaluator (:1466). Layer `type` strings map 1:1 onto the
framework registry (the REGISTER_LAYER names test_registry_parity
sweeps), so the dispatch is a thin LayerConf constructor.

Exec'd configs receive these via parse_config's namespace seeding
(compat/config_parser.py), exactly as the reference execs configs
inside its own module namespace.
"""

from __future__ import annotations

from paddle_tpu_torch import dsl
from paddle_tpu_torch.core.config import InputConf, LayerConf, ParameterConf

__all__ = [
    "Layer",
    "Input",
    "Bias",
    "Memory",
    "FullMatrixProjection",
    "TransposedFullMatrixProjection",
    "TableProjection",
    "IdentityProjection",
    "DotMulProjection",
    "ContextProjection",
    "RecurrentLayerGroupBegin",
    "RecurrentLayerGroupEnd",
    "Evaluator",
    "model_type",
]


def _param(parameter_name=None, initial_std=None, initial_mean=0.0,
           learning_rate=1.0, decay_rate=None, decay_rate_l1=None,
           sparse_update=False, sparse_remote_update=False,
           initial_smart=False, is_static=False, **_):
    """Inline parameter attrs -> ParameterConf (config_parser Input's
    parameter fields). initial_smart = std 1/sqrt(fan_in), which is
    this framework's default when initial_std is unset."""
    if parameter_name is None and initial_std is None and not (
        sparse_update or sparse_remote_update or is_static
        or decay_rate is not None or decay_rate_l1 is not None
        or learning_rate != 1.0 or initial_mean
    ):
        return None
    return ParameterConf(
        name=parameter_name or "",
        initial_std=initial_std,
        initial_mean=initial_mean,
        learning_rate=learning_rate,
        decay_rate=decay_rate,
        decay_rate_l1=decay_rate_l1,
        sparse_update=bool(sparse_update),
        sparse_remote_update=bool(sparse_remote_update),
        is_static=bool(is_static),
    )


def Input(input_layer_name, **kw):
    return InputConf(name=input_layer_name, parameter=_param(**kw))


def Bias(**kw):
    """Layer(bias=Bias(parameter_name=...)) — a named/parametrized
    bias (shared across layers by name, like the rnn1.bias idiom)."""
    return _param(**kw) or ParameterConf(name="")


def _proj(kind):
    def proj(input_layer_name, size=0, **kw):
        attrs = {"proj": kind}
        if size:
            attrs["proj_size"] = size
        return InputConf(
            name=input_layer_name, parameter=_param(**kw), attrs=attrs
        )

    proj.__name__ = kind
    return proj


FullMatrixProjection = _proj("full_matrix")
TransposedFullMatrixProjection = _proj("trans_full_matrix")
IdentityProjection = _proj("identity")
DotMulProjection = _proj("dotmul")


def TableProjection(input_layer_name, size=0, **kw):
    g = dsl.current()
    src = g.conf.layer(input_layer_name)
    # an id slot feeding a lookup table (same annotation
    # table_projection applies on the helper surface)
    if src.type == "data" and not src.attrs.get("is_ids"):
        src.attrs["is_ids"] = True
        src.attrs["is_seq"] = True
    attrs = {"proj": "table", "vocab_size": src.size}
    if size:
        attrs["proj_size"] = size
    return InputConf(
        name=input_layer_name, parameter=_param(**kw), attrs=attrs
    )


def ContextProjection(input_layer_name, context_length, context_start=None,
                      **kw):
    return InputConf(
        name=input_layer_name,
        parameter=_param(**kw),
        attrs={
            "proj": "context",
            "context_length": context_length,
            "context_start": context_start,
        },
    )




def Layer(name=None, type=None, size=0, active_type="", bias=True,
          inputs=(), device=None, **attrs):
    """Raw layer constructor: `type` is the registry name (REGISTER_LAYER
    spelling); `inputs` are layer-name strings, Input(...)s, or
    projection edges; `bias` is True/False or Bias(...)."""
    assert name and type, "Layer() needs name= and type="
    g = dsl.current()
    if not isinstance(inputs, (list, tuple)):
        inputs = [inputs]
    ics = [dsl._in(x) for x in inputs]
    bias_param = None
    bias_flag = bool(bias)
    if isinstance(bias, ParameterConf):
        bias_param, bias_flag = bias, True
    if type == "data":
        lc = LayerConf(
            name=name, type="data", size=size,
            attrs={"dim": (size,), "is_seq": False, "is_ids": False,
                   "has_subseq": False},
        )
        return g.add(lc)
    lc = LayerConf(
        name=name, type=type, size=size, inputs=ics,
        active_type=active_type, bias=bias_flag,
        bias_parameter=bias_param, device=device,
        attrs={k: v for k, v in attrs.items() if v is not None},
    )
    return g.add(lc)


def Memory(name, size, boot_bias=None, boot_bias_active_type="",
           boot_with_const_id=None, **_):
    """Raw memory declaration inside a recurrent layer group
    (config_parser.py Memory) — returns the LINK NAME projections
    reference (the reference returns '<name>+delay1'; layers must use
    the returned handle, not the literal)."""
    if boot_bias is not None or boot_with_const_id is not None:
        raise NotImplementedError(
            "raw Memory boot_bias/boot_with_const_id are not "
            "supported; boot via the helper-surface memory(boot_layer=)"
        )
    ref = dsl.memory(name, size)
    return ref.name


_group_stack: list = []


def RecurrentLayerGroupBegin(name, in_links, out_links, seq_reversed=False,
                             **_):
    """Open a recurrent layer group scope (config_parser.py:368
    RecurrentLayerGroupBegin): subsequent Layer() calls build the STEP
    network; in-link names resolve to per-step slices of the parent
    layers of the same name (the reference's ScatterAgent wiring)."""
    parent = dsl.current()
    cm = dsl.model()
    sub = cm.__enter__()
    sub._counts = parent._counts
    for ln in list(in_links):
        sz = parent.conf.layer(ln).size
        sub.add(
            LayerConf(name=ln, type="data", size=sz,
                      attrs={"dim": (sz,), "is_seq": False,
                             "is_ids": False})
        )
    _group_stack.append(
        (name, cm, sub, parent, list(in_links), list(out_links),
         bool(seq_reversed))
    )


def RecurrentLayerGroupEnd(name):
    """Close the group scope and materialize the scan layer under the
    out-link's name (so downstream raw layers referencing the out-link
    resolve), through the same group_layer_conf contract
    dsl.recurrent_group uses."""
    gname, cm, sub, parent, in_links, out_links, rev = _group_stack.pop()
    assert name == gname, f"group end {name!r} != begin {gname!r}"
    cm.__exit__(None, None, None)
    if len(out_links) != 1:
        raise NotImplementedError(
            "raw RecurrentLayerGroup supports exactly one out_link "
            f"(got {out_links}); secondary out-links are a "
            "recurrent_group(step) feature"
        )
    lc = dsl.group_layer_conf(
        out_links[0], sub, parent_inputs=in_links,
        in_links=in_links, static_links=[], out_links=out_links,
        reversed=rev,
    )
    return parent.add(lc)


def Evaluator(name=None, type=None, inputs=(), **kw):
    """Raw evaluator declaration (config_parser.py Evaluator) — the
    registry spelling of `type` matches REGISTER_EVALUATOR names."""
    from paddle_tpu_torch.compat.config_parser import _declare_evaluator

    if not isinstance(inputs, (list, tuple)):
        inputs = [inputs]
    input_ = inputs[0] if inputs else None
    label = inputs[1] if len(inputs) > 1 else None
    return _declare_evaluator(type, input_, label, name, **kw)


def model_type(name):
    """model_type("nn"/"recurrent_nn") — executor choice is implicit
    here (one jit program either way); accepted for source parity."""
