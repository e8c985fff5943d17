"""trainer_config_helpers-style layer functions.

Reference: python/paddle/trainer_config_helpers/layers.py — `*_layer`
functions taking `input=` keyword (single ref or list) plus attrs like
`act=SomeActivation()`, `param_attr=ParamAttr(...)`. This module maps
that surface onto paddle_tpu_torch.dsl so v1-era config scripts run with
minimal edits:

    from paddle_tpu_torch.compat.layers_v1 import *
    with model_scope() as m:
        img = data_layer(name="pixel", size=784)
        hidden = fc_layer(input=img, size=128, act=ReluActivation())
        out = fc_layer(input=hidden, size=10, act=SoftmaxActivation())
        cost = classification_cost(
            input=out, label=data_layer(name="label", size=10)
        )

Activation/ParamAttr objects mirror the reference's
trainer_config_helpers.activations/attrs classes.
"""

from __future__ import annotations

from paddle_tpu_torch import dsl
from paddle_tpu_torch.core.config import ParameterConf

model_scope = dsl.model

__all__ = [
    "model_scope",
    "ParamAttr",
    "data_layer",
    "fc_layer",
    "embedding_layer",
    "addto_layer",
    "concat_layer",
    "dropout_layer",
    "img_conv_layer",
    "img_pool_layer",
    "img_cmrnorm_layer",
    "batch_norm_layer",
    "maxout_layer",
    "spp_layer",
    "block_expand_layer",
    "recurrent_layer",
    "lstmemory",
    "grumemory",
    "pooling_layer",
    "last_seq",
    "first_seq",
    "expand_layer",
    "seq_concat_layer",
    "seq_reshape_layer",
    "sub_seq_layer",
    "mixed_layer",
    "dotmul_operator",
    "multi_binary_label_cross_entropy",
    "full_matrix_projection",
    "trans_full_matrix_projection",
    "identity_projection",
    "slice_projection",
    "dotmul_projection",
    "scaling_projection",
    "table_projection",
    "context_projection",
    "tensor_layer",
    "cos_sim",
    "scaling_layer",
    "slope_intercept_layer",
    "interpolation_layer",
    "linear_comb_layer",
    "power_layer",
    "clip_layer",
    "row_conv_layer",
    "conv_shift_layer",
    "bilinear_interp_layer",
    "selective_fc_layer",
    "maxid_layer",
    "sampling_id_layer",
    "multiplex_layer",
    "nce_layer",
    "hsigmoid",
    "crf_layer",
    "crf_decoding_layer",
    "ctc_layer",
    "eos_layer",
    "priorbox_layer",
    "multibox_loss_layer",
    "detection_output_layer",
    "classification_cost",
    "cross_entropy",
    "square_error_cost",
    "mse_cost",
    "regression_cost",
    "rank_cost",
    "sum_cost",
    "prelu_layer",
    "gated_unit_layer",
    "repeat_layer",
    "kmax_sequence_score_layer",
    "simple_attention",
    "simple_lstm",
    "simple_gru",
    "simple_gru2",
    "bidirectional_lstm",
    "bidirectional_gru",
    "lstmemory_unit",
    "lstmemory_group",
    "gru_unit",
    "gru_group",
    "img_conv_bn_pool",
    "text_conv_pool",
    "sequence_conv_pool",
    "simple_img_conv_pool",
    "img_conv_group",
    "small_vgg",
    "vgg_16_network",
    "sub_nested_seq_layer",
    "warp_ctc_layer",
    "lambda_cost",
    "huber_cost",
    "cross_entropy_with_selfnorm",
    "smooth_l1_cost",
    "print_layer",
    "printer_layer",
    "pad_layer",
    "crop_layer",
    "trans_layer",
    "rotate_layer",
    "out_prod_layer",
    "row_l2_norm_layer",
    "sum_to_one_norm_layer",
    "conv_operator",
    "conv_projection",
    "AggregateLevel",
    "ExpandLevel",
    "IdentityActivation",
    "get_output_layer",
    "memory",
    "StaticInput",
    "SubsequenceInput",
    "recurrent_group",
    "beam_search",
    "GeneratedInput",
    "BaseGeneratedInput",
    # activations (attrs-style classes)
    "LinearActivation",
    "ReluActivation",
    "SigmoidActivation",
    "SoftmaxActivation",
    "TanhActivation",
    "STanhActivation",
    "BReluActivation",
    "SoftReluActivation",
    "AbsActivation",
    "SquareActivation",
    "ExpActivation",
]


# ---- activations (trainer_config_helpers/activations.py) ----

class _Act:
    name = ""

    def __init__(self):
        pass


def _make_act(cls_name, act_name):
    return type(cls_name, (_Act,), {"name": act_name})


LinearActivation = _make_act("LinearActivation", "")
ReluActivation = _make_act("ReluActivation", "relu")
SigmoidActivation = _make_act("SigmoidActivation", "sigmoid")
SoftmaxActivation = _make_act("SoftmaxActivation", "softmax")
TanhActivation = _make_act("TanhActivation", "tanh")
STanhActivation = _make_act("STanhActivation", "stanh")
BReluActivation = _make_act("BReluActivation", "brelu")
SoftReluActivation = _make_act("SoftReluActivation", "softrelu")
AbsActivation = _make_act("AbsActivation", "abs")
SquareActivation = _make_act("SquareActivation", "square")
ExpActivation = _make_act("ExpActivation", "exponential")
IdentityActivation = LinearActivation  # reference alias


class AggregateLevel:
    """(layers.py:253) TO_NO_SEQUENCE aggregates a (nested) sequence to
    one vector; TO_SEQUENCE aggregates each SUB-sequence to one
    timestep. String values match the reference proto ('non-seq' /
    'seq'); legacy aliases kept."""

    TO_NO_SEQUENCE = "non-seq"
    TO_SEQUENCE = "seq"
    EACH_TIMESTEP = TO_NO_SEQUENCE
    EACH_SEQUENCE = TO_SEQUENCE


class ExpandLevel:
    """(layers.py:1709)."""

    FROM_NO_SEQUENCE = AggregateLevel.TO_NO_SEQUENCE
    FROM_SEQUENCE = AggregateLevel.TO_SEQUENCE
    FROM_TIMESTEP = FROM_NO_SEQUENCE


def _agg_to_level(agg_level):
    """Map the v1 AggregateLevel to the internal level attr: TO_SEQUENCE
    ('seq') acts per SUB-sequence -> internal 'subseq'."""
    return "subseq" if agg_level == AggregateLevel.TO_SEQUENCE else "seq"


def _act(a) -> str:
    if a is None:
        return ""
    if isinstance(a, str):
        return a
    return a.name


def _act_or(a, default: str) -> str:
    """Default only when act was OMITTED: an explicit
    LinearActivation() (name "") must stay linear — the standard
    pre-batch-norm pattern depends on it."""
    return default if a is None else _act(a)


def ParamAttr(name=None, initial_std=None, initial_mean=0.0,
              learning_rate=1.0, l1_rate=None, l2_rate=None,
              is_static=False, sparse_update=False, initializer=None,
              **_):
    """(trainer_config_helpers/attrs.py ParamAttr; `initializer` is the
    v2 extension — a name -> ndarray callback, v2/attr.py)."""
    return ParameterConf(
        name=name or "",
        initial_std=initial_std,
        initial_mean=initial_mean,
        learning_rate=learning_rate,
        decay_rate_l1=l1_rate,
        decay_rate=l2_rate,
        is_static=is_static,
        sparse_update=sparse_update,
        initializer=initializer,
    )


def _one(input):
    assert not isinstance(input, (list, tuple)), (
        "this layer takes a single input"
    )
    return input


def _many(input):
    return list(input) if isinstance(input, (list, tuple)) else [input]


def _layer_size(ref):
    return ref.builder.conf.layer(ref.name).size


def _pool_type(obj, default="max"):
    """Map a v1 pooling-type object/string to a pool kind."""
    if obj is None:
        return default
    pn = getattr(obj, "name", str(obj)).lower()
    for cand, mapped in (
        ("sqrt", "sqrt_average"),
        ("avg", "avg"),
        ("max", "max"),
        ("sum", "sum"),
    ):
        if cand in pn:
            return mapped
    return default


# ---- layers ----

def data_layer(name, size, height=None, width=None, depth=None,
               is_ids=False, is_seq=False, has_subseq=False, **_):
    """v1 data_layer; `is_ids`/`is_seq` are compat extensions (in v1 the
    slot type came from the data provider declaration, which this
    framework expresses on the data layer itself)."""
    if height and width:
        dim = (height, width, (depth or size // (height * width)))
    else:
        dim = size
    return dsl.data(name, dim, is_seq=is_seq, is_ids=is_ids,
                    has_subseq=has_subseq)



def _bias(bias_attr):
    """bias_attr may be bool or a ParamAttr/ParameterConf carrying a
    shared name + initializer (the VAE config names every bias so
    copy_shared_parameters can match them across machines)."""
    if isinstance(bias_attr, ParameterConf):
        return True, bias_attr
    return bool(bias_attr), None


def fc_layer(input, size, act=None, name=None, bias_attr=True,
             param_attr=None, layer_attr=None, **_):
    # reference default activation for fc is tanh (layers.py:949
    # wrap_act_default); an explicit LinearActivation() stays linear
    b, bp = _bias(bias_attr)
    ins = _many(input)
    if isinstance(param_attr, (list, tuple)):
        # per-input param attrs (layers.py fc_layer accepts one per
        # edge; shared_lstm shares one softmax_param across both) —
        # attach each to its edge directly
        from paddle_tpu_torch.core.config import InputConf

        assert len(param_attr) == len(ins), (
            f"fc_layer: {len(ins)} inputs but {len(param_attr)} "
            "param_attr entries (the reference requires one per edge)"
        )
        ins = [InputConf(name=x.name, parameter=p)
               for x, p in zip(ins, param_attr)]
        param_attr = None
    out = dsl.fc(*ins, size=size, name=name,
                 act=_act_or(act, "tanh"),
                 bias=b, bias_param=bp, param=param_attr)
    return _apply_layer_attr(out, layer_attr)


def _apply_layer_attr(out, layer_attr):
    """ExtraLayerAttribute(drop_rate=...) applies dropout on the layer
    output (config_parser's drop_rate semantics)."""
    rate = getattr(layer_attr, "drop_rate", None)
    if rate:
        return dsl.dropout(out, rate)
    return out


def embedding_layer(input, size, name=None, param_attr=None, **kw):
    # v1 derives the vocabulary from the input layer's size — never
    # guess a default (a too-small table silently corrupts training)
    x = _one(input)
    vocab = kw.get("vocab_size") or kw.get("dict_size")
    if not vocab:
        vocab = x.builder.conf.layer(x.name).size
    assert vocab, "embedding_layer: set the word data_layer's size"
    # in v1 the slot type (ids, sequence) came from the data-provider
    # declaration, not the config; a data layer fed into an embedding is
    # an id sequence, so annotate it retroactively (the provider's
    # input_types, when available, refine this via apply_data_types)
    lc = x.builder.conf.layer(x.name)
    if lc.type == "data" and not lc.attrs.get("is_ids"):
        lc.attrs["is_ids"] = True
        lc.attrs["is_seq"] = True
    return dsl.embedding(x, size=size, vocab_size=vocab,
                         name=name, param=param_attr)


def addto_layer(input, act=None, name=None, bias_attr=False, **_):
    return dsl.addto(*_many(input), name=name, act=_act(act),
                     bias=bool(bias_attr))


def concat_layer(input, act=None, bias_attr=False, name=None, **_):
    # v1 concat also accepts PROJECTIONS as inputs (layers.py
    # concat_layer); materialize each as a one-term sizeless mixed
    ins = [
        dsl.mixed(0, [x], bias=False) if isinstance(x, tuple) else x
        for x in _edges(input)
    ]
    return dsl.concat(*ins, name=name, act=_act(act),
                      bias=bool(bias_attr))


def dropout_layer(input, dropout_rate, name=None, **_):
    return dsl.dropout(_one(input), dropout_rate, name=name)


def img_conv_layer(input, filter_size, num_filters, stride=1, padding=0,
                   groups=1, dilation=1, act=None, name=None,
                   num_channels=None, bias_attr=True, param_attr=None,
                   trans=False, **_):
    if trans:
        # deconvolution (layers.py img_conv_layer trans=True -> exconvt,
        # the GAN generator's upsampling path)
        assert groups == 1 and dilation == 1, (
            "exconvt compat supports groups=1, dilation=1"
        )
        b, bp = _bias(bias_attr)
        out = dsl.conv_trans(_one(input), num_filters, filter_size,
                             stride=stride, padding=padding, name=name,
                             act=_act_or(act, "relu"), bias=b,
                             bias_param=bp, param=param_attr)
        if num_channels:
            lc = out.builder.conf.layer(out.name)
            lc.attrs["num_channels"] = num_channels
        return out
    return dsl.conv(_one(input), num_filters, filter_size, stride=stride,
                    padding=padding, groups=groups, dilation=dilation,
                    name=name, act=_act_or(act, "relu"),
                    num_channels=num_channels,
                    bias=bool(bias_attr), param=param_attr)


def img_pool_layer(input, pool_size, stride=None, padding=0,
                   pool_type=None, name=None, **_):
    return dsl.pool(_one(input), pool_size, stride=stride,
                    padding=padding, pool_type=_pool_type(pool_type),
                    name=name)


def img_cmrnorm_layer(input, size=5, scale=1e-4, power=0.75, name=None,
                      **_):
    return dsl.lrn(_one(input), size=size, scale=scale, power=power,
                   name=name)


def batch_norm_layer(input, act=None, name=None,
                     use_global_stats=False,
                     moving_average_fraction=0.9, **_):
    return dsl.batch_norm(
        _one(input), name=name, act=_act(act),
        use_global_stats=use_global_stats,
        moving_average_fraction=moving_average_fraction,
    )


def maxout_layer(input, groups, name=None, **_):
    return dsl.maxout(_one(input), groups, name=name)


def spp_layer(input, pyramid_height=3, pool_type=None, name=None, **_):
    return dsl.spp(_one(input), pyramid_height=pyramid_height,
                   pool_type=_pool_type(pool_type), name=name)


def block_expand_layer(input, block_x=1, block_y=1, stride_x=None,
                       stride_y=None, padding_x=0, padding_y=0,
                       name=None, **_):
    return dsl.block_expand(
        _one(input), (block_y, block_x),
        stride=(stride_y or block_y, stride_x or block_x),
        padding=(padding_y, padding_x), name=name,
    )


def recurrent_layer(input, size=None, act=None, reverse=False, name=None,
                    bias_attr=True, **_):
    x = _one(input)
    size = size or _layer_size(x)  # v1 infers from the input
    return dsl.recurrent(x, size, name=name,
                         act=_act_or(act, "tanh"), reversed=reverse,
                         bias=bool(bias_attr))


def lstmemory(input, size=None, act=None, gate_act=None, state_act=None,
              reverse=False, name=None, bias_attr=True, param_attr=None,
              **_):
    x = _one(input)
    size = size or _layer_size(x) // 4  # v1: input is the 4h projection
    return dsl.lstmemory(
        x, size, name=name, act=_act_or(act, "tanh"),
        gate_act=_act_or(gate_act, "sigmoid"),
        state_act=_act_or(state_act, "tanh"), reversed=reverse,
        bias=bool(bias_attr), param=param_attr,
    )


def grumemory(input, size=None, act=None, gate_act=None, reverse=False,
              name=None, bias_attr=True, param_attr=None, **_):
    x = _one(input)
    size = size or _layer_size(x) // 3  # v1: input is the 3h projection
    return dsl.grumemory(
        x, size, name=name, act=_act_or(act, "tanh"),
        gate_act=_act_or(gate_act, "sigmoid"), reversed=reverse,
        bias=bool(bias_attr), param=param_attr,
    )


def pooling_layer(input, pooling_type=None, name=None,
                  agg_level=AggregateLevel.TO_NO_SEQUENCE, stride=-1,
                  **_):
    # v1 default is MaxPooling (trainer_config_helpers pooling_layer)
    extra = {}
    if getattr(pooling_type, "output_max_index", False):
        assert not (stride and stride > 0), (
            "pooling_layer: output_max_index with stride is not "
            "supported (ambiguous output shape)"
        )
        extra["output_max_index"] = True
    if stride and stride > 0:
        extra["stride"] = stride
    return dsl.seq_pool(_one(input), pool_type=_pool_type(pooling_type),
                        level=_agg_to_level(agg_level), name=name,
                        **extra)


def last_seq(input, name=None,
             agg_level=AggregateLevel.TO_NO_SEQUENCE, stride=-1, **_):
    return dsl.last_seq(_one(input), name=name,
                        stride=max(stride, 0),
                        level=_agg_to_level(agg_level))


def first_seq(input, name=None,
              agg_level=AggregateLevel.TO_NO_SEQUENCE, stride=-1, **_):
    return dsl.first_seq(_one(input), name=name,
                         stride=max(stride, 0),
                         level=_agg_to_level(agg_level))


def expand_layer(input, expand_as, name=None,
                 expand_level=ExpandLevel.FROM_NO_SEQUENCE, **_):
    return dsl.expand(_one(input), expand_as, name=name,
                      level=("seq"
                             if expand_level == ExpandLevel.FROM_SEQUENCE
                             else "non-seq"))


def seq_concat_layer(a, b, name=None, **_):
    return dsl.seq_concat(a, b, name=name)


def seq_reshape_layer(input, reshape_size, name=None, **_):
    return dsl._add("seqreshape", [_one(input)], name=name, bias=False,
                    size=reshape_size)


def sub_seq_layer(input, offsets, sizes, name=None, **_):
    return dsl.sub_seq(_one(input), offsets, sizes, name=name)


class _MixedLayerBuilder:
    """`with mixed_layer() as m: m += projection` — the v1 helper's
    context-manager form (layers.py mixed_layer docstring). Terms are
    collected via `+=` and the real mixed layer is materialized on
    exit; afterwards the builder proxies the finished LayerRef (its
    .name), so it is usable anywhere a layer handle is."""

    def __init__(self, size, act, name, bias_attr):
        self._spec = (size, act, name, bias_attr)
        self._terms = []
        self._ref = None

    def __iadd__(self, term):
        self._terms.append(term)
        return self

    def __enter__(self):
        return self

    def __exit__(self, exc_type, exc, tb):
        if exc_type is not None:
            return False
        size, act, name, bias_attr = self._spec
        self._ref = dsl.mixed(size, self._terms, name=name, act=_act(act),
                              bias=bool(bias_attr))
        return False

    @property
    def name(self):
        assert self._ref is not None, "mixed_layer context not exited yet"
        return self._ref.name

    @property
    def builder(self):
        return self._ref.builder

    @property
    def size(self):
        """Width of the finished layer (LayerOutput.size) — the group
        helpers infer their cell size from it (shared_lstm passes a
        mixed builder straight into lstmemory_group)."""
        assert self._ref is not None, "mixed_layer context not exited yet"
        return self._ref.size

    # arithmetic works like any layer handle (layer_math patches these
    # onto LayerRef; delegate to the finished ref)
    def __add__(self, other):
        return self._ref + other

    def __radd__(self, other):
        return self._ref.__radd__(other)

    def __sub__(self, other):
        return self._ref - other

    def __rsub__(self, other):
        return self._ref.__rsub__(other)

    def __mul__(self, other):
        return self._ref * other

    def __rmul__(self, other):
        return self._ref.__rmul__(other)


def _edges(input):
    """Mixed-layer input normalization: a single projection/operator
    edge is a (layer, proj[, extra]) tuple — don't let _many flatten
    it into bogus separate inputs (mixed_layer(input=table_projection(
    ...)) is the reference idiom, layers.py MixedLayerType)."""
    if (
        isinstance(input, tuple)
        and len(input) >= 2
        and isinstance(input[1], str)
    ):
        return [input]
    return _many(input)


def mixed_layer(size=0, input=None, act=None, name=None, bias_attr=False, **_):
    if input is None:
        return _MixedLayerBuilder(size, act, name, bias_attr)
    return dsl.mixed(size, _edges(input), name=name, act=_act(act),
                     bias=bool(bias_attr))


def dotmul_operator(a, b=None, scale=1.0, **_):
    """Mixed-layer elementwise-product operator (layers.py
    dotmul_operator; DotMulOperator.cpp). An operator term is a plain
    summand, so it materializes as an eltmul layer fed back through an
    identity projection."""
    x = dsl.eltmul(_one(a), _one(b if b is not None else a), scale=scale)
    return (x, "identity")


def multi_binary_label_cross_entropy(input, label, name=None, coeff=1.0, **_):
    return dsl.multi_binary_label_cross_entropy(
        _one(input), _one(label), name=name, coeff=coeff
    )


# ---- projections for mixed_layer (trainer_config_helpers/layers.py
# full_matrix_projection:552 etc.) — each returns the (layer, proj kind)
# edge spec dsl.mixed consumes ----

def full_matrix_projection(input, size=0, param_attr=None, **_):
    # the projection's own size/param ride the edge: a sizeless
    # mixed_layer infers its width from the projection's declared size
    # (reference mixed_layer(size=None) idiom), and a named param_attr
    # shares the projection weight across mixed layers (shared_lstm)
    extra = {}
    if param_attr is not None:
        extra["param"] = param_attr
    if size:
        extra["proj_size"] = size
    return (_one(input), "full_matrix", extra)


def trans_full_matrix_projection(input, size=0, param_attr=None, **_):
    extra = {}
    if param_attr is not None:
        extra["param"] = param_attr
    if size:
        extra["proj_size"] = size
    return (_one(input), "trans_full_matrix", extra)


def identity_projection(input, offset=None, size=None, **_):
    if offset is not None:
        # IdentityOffsetProjection (layers.py identity_projection
        # offset=): a single [offset, offset+size) slice
        end = offset + (size or (_layer_size(input) - offset))
        return (_one(input), "slice", {"slices": ((offset, end),)})
    return (_one(input), "identity")


def slice_projection(input, slices, **_):
    """(layers.py slice_projection; SliceProjection.cpp) — concat of
    [start, end) feature slices of the input."""
    for s, e in slices:
        assert 0 <= s < e, f"bad slice ({s}, {e})"
    return (_one(input), "slice",
            {"slices": tuple((int(s), int(e)) for s, e in slices)})


def dotmul_projection(input, param_attr=None, **_):
    if param_attr is not None:
        return (_one(input), "dotmul", {"param": param_attr})
    return (_one(input), "dotmul")


def scaling_projection(input, param_attr=None, **_):
    return (_one(input), "scaling")


def table_projection(input, size=0, param_attr=None, **_):
    x = _one(input)
    lc = x.builder.conf.layer(x.name)
    # ids slot feeding a lookup table: annotate a raw data layer the
    # same way embedding_layer does (v1 slot types came from the
    # provider declaration)
    if lc.type == "data" and not lc.attrs.get("is_ids"):
        lc.attrs["is_ids"] = True
        lc.attrs["is_seq"] = True
    extra = {"vocab_size": lc.size}
    if size:
        # a declared projection size fixes a sizeless host mixed
        # (table_projection(size=...) under concat, concat_table_b)
        extra["proj_size"] = size
    if param_attr is not None:
        extra["param"] = param_attr
    return (x, "table", extra)


def context_projection(input, context_len, context_start=None, **_):
    start = (-(context_len // 2)) if context_start is None else context_start
    return (_one(input), "context",
            {"context_length": context_len, "context_start": start})


def tensor_layer(a, b, size, act=None, name=None, bias_attr=True, **_):
    return dsl._add("tensor", [a, b], name=name, size=size,
                    act=_act(act), bias=bool(bias_attr))


def cos_sim(a, b, scale=1.0, size=1, name=None, **_):
    return dsl.cos_sim(a, b, scale=scale, size=size, name=name)


def scaling_layer(input, weight, name=None, **_):
    return dsl.scaling(weight, _one(input), name=name)


def slope_intercept_layer(input, slope=1.0, intercept=0.0, name=None, **_):
    return dsl.slope_intercept(_one(input), slope, intercept, name=name)


def interpolation_layer(input, weight, name=None, **_):
    a, b = _many(input)
    return dsl.interpolation(weight, a, b, name=name)


def linear_comb_layer(weights, vectors, size=None, name=None, **_):
    # v1 infers size = vectors.size / weights.size when omitted
    size = size or _layer_size(vectors) // max(_layer_size(weights), 1)
    return dsl.linear_comb(weights, vectors, size, name=name)


def power_layer(input, weight, name=None, **_):
    return dsl.power(weight, _one(input), name=name)


def clip_layer(input, min, max, name=None, **_):
    return dsl.clip(_one(input), min=min, max=max, name=name)


def row_conv_layer(input, context_len, name=None, param_attr=None, **_):
    return dsl.row_conv(_one(input), context_len, name=name,
                        param=param_attr)


def conv_shift_layer(a, b, name=None, **_):
    return dsl.conv_shift(a, b, name=name)


def bilinear_interp_layer(input, out_size_x, out_size_y, name=None, **_):
    return dsl.bilinear_interp(_one(input), out_size_x, out_size_y,
                               name=name)


def selective_fc_layer(input, size, select=None, act=None, name=None,
                       bias_attr=True, param_attr=None, **_):
    return dsl.selective_fc(_one(input), select, size=size,
                            act=_act(act), name=name,
                            bias=bool(bias_attr), param=param_attr)


def maxid_layer(input, name=None, **_):
    return dsl._add("max_id", [_one(input)], name=name, bias=False)


def sampling_id_layer(input, name=None, **_):
    return dsl._add("sampling_id", [_one(input)], name=name, bias=False)


def multiplex_layer(input, name=None, **_):
    return dsl._add("multiplex", _many(input), name=name, bias=False)


def nce_layer(input, label, num_classes=None, num_neg_samples=10,
              name=None, param_attr=None, bias_attr=True,
              neg_distribution=None, weight=None, **_):
    # v1 derives num_classes from the label layer's width when omitted
    num_classes = num_classes or _layer_size(label)
    return dsl._add("nce", [*_many(input), label], name=name,
                    size=num_classes, bias=bool(bias_attr),
                    param=param_attr, num_classes=num_classes,
                    num_neg_samples=num_neg_samples,
                    neg_distribution=neg_distribution)


def hsigmoid(input, label, num_classes=None, name=None, param_attr=None,
             bias_attr=True, **_):
    num_classes = num_classes or _layer_size(label)
    return dsl._add("hsigmoid", [*_many(input), label], name=name,
                    size=num_classes, bias=bool(bias_attr),
                    param=param_attr, num_classes=num_classes)


def crf_layer(input, label, size=None, param_attr=None, name=None, **_):
    # v1 infers size from the input's width when omitted
    # (trainer_config_helpers/layers.py crf_layer)
    size = size or _layer_size(_one(input))
    return dsl.crf(input, label, num_tags=size, name=name,
                   param=param_attr)


def crf_decoding_layer(input, size, label=None, param_attr=None,
                       name=None, **_):
    return dsl.crf_decoding(input, num_tags=size, label=label,
                            name=name, param=param_attr)


def ctc_layer(input, label, size=None, blank=0, norm_by_times=False,
              name=None, **_):
    size = size or _layer_size(_one(input))
    # v1 CTC consumes an already-softmaxed input (the config applies
    # SoftmaxActivation on the fc) — do NOT softmax again. name=None
    # auto-uniquifies (a fixed "cost" would collide across layers).
    return dsl._add("ctc", [input, label], name=name,
                    size=size, bias=False, blank=blank,
                    norm_by_times=norm_by_times, apply_softmax=False)


def eos_layer(input, eos_id, name=None, **_):
    return dsl.eos_id(_one(input), eos_id, name=name)


def warp_ctc_layer(input, label, size=None, blank=0,
                   norm_by_times=False, name=None, **_):
    """(layers.py warp_ctc_layer) — same lowering as ctc_layer; the
    warp-ctc/builtin split is a GPU-kernel distinction with no XLA
    analogue."""
    size = size or _layer_size(_one(input))
    # unlike ctc_layer, the warp-ctc contract integrates the softmax:
    # the config feeds LINEAR logits (reference layers.py
    # warp_ctc_layer doc), so the layer applies it
    return dsl._add("warp_ctc", [input, label], name=name, size=size,
                    bias=False, blank=blank,
                    norm_by_times=norm_by_times, apply_softmax=True)


def lambda_cost(input, score, NDCG_num=5, max_sort_size=-1, name=None,
                **_):
    """(layers.py lambda_cost; CostLayer.cpp LambdaCost)."""
    return dsl._add("lambda_cost", [_one(input), _one(score)],
                    name=name, bias=False, NDCG_num=NDCG_num,
                    max_sort_size=max_sort_size)


def huber_cost(input, label, name=None, coeff=1.0, **_):
    """(layers.py huber_cost — two-class Huber classification)."""
    return dsl._add("huber_classification", [_one(input), _one(label)],
                    name=name, bias=False, coeff=coeff)


def cross_entropy_with_selfnorm(input, label, name=None, coeff=1.0,
                                softmax_selfnorm_alpha=0.1, **_):
    return dsl._add(
        "multi_class_cross_entropy_with_selfnorm",
        [_one(input), _one(label)], name=name, bias=False, coeff=coeff,
        softmax_selfnorm_alpha=softmax_selfnorm_alpha,
    )


def smooth_l1_cost(input, label, name=None, coeff=1.0, **_):
    return dsl._add("smooth_l1", [_one(input), _one(label)],
                    name=name, bias=False, coeff=coeff)


def print_layer(input, format=None, name=None, **_):
    """(layers.py print_layer; PrintLayer.cpp) — identity that prints
    as it runs (on the host; inside a CUDA-graph capture it raises)."""
    for x in _many(input):
        dsl._add("print", [x], name=name, bias=False)
    # the reference returns None (print is a side effect)


# the primary spelling upstream (layers.py:1023 printer_layer;
# print_layer kept for v1 compat, :1046-1051) — v2 renames it `printer`
printer_layer = print_layer


def pad_layer(input, pad_c=None, pad_h=None, pad_w=None, name=None,
              **_):
    return dsl._add("pad", [_one(input)], name=name, bias=False,
                    pad_c=tuple(pad_c or (0, 0)),
                    pad_h=tuple(pad_h or (0, 0)),
                    pad_w=tuple(pad_w or (0, 0)))


def crop_layer(input, offset=None, axis=2, shape=None, name=None, **_):
    """(layers.py crop_layer) — crop input[0] to input[1]'s spatial
    shape (or explicit offset/shape)."""
    ins = _many(input)
    attrs = {}
    if offset is not None and shape is not None:
        attrs = {"crop_h": (offset[0], shape[0]),
                 "crop_w": (offset[1], shape[1])}
    return dsl._add("crop", ins, name=name, bias=False, **attrs)


def trans_layer(input, name=None, **_):
    # height/width resolve at build: the layer reads the input spec's
    # (H, W) dims when present, else infers a square from the width
    return dsl._add("trans", [_one(input)], name=name, bias=False)


def rotate_layer(input, height, width, name=None, **_):
    """(layers.py rotate_layer; RotateLayer.cpp) — rotate each
    height x width channel plane 90 degrees clockwise."""
    return dsl._add("rotate", [_one(input)], name=name, bias=False,
                    height=height, width=width)


def out_prod_layer(input1, input2, name=None, **_):
    """(layers.py out_prod_layer; OuterProdLayer.cpp) — flattened
    outer product of two vectors."""
    return dsl._add("out_prod", [_one(input1), _one(input2)],
                    name=name, bias=False)


def row_l2_norm_layer(input, name=None, **_):
    return dsl._add("row_l2_norm", [_one(input)], name=name, bias=False)


def sum_to_one_norm_layer(input, name=None, **_):
    return dsl._add("sum_to_one_norm", [_one(input)], name=name,
                    bias=False)


def conv_operator(img, filter, filter_size, num_filters,
                  num_channels=1, stride=1, padding=0, trans=False,
                  filter_size_y=None, stride_y=None, padding_y=None,
                  **_):
    """(layers.py conv_operator) — a mixed-layer term whose FILTER
    comes from the graph (per-example dynamic filters); materializes
    the conv_operator layer and feeds it back through an identity
    projection, like dotmul_operator."""
    ref = dsl._add(
        "conv_operator", [_one(img), _one(filter)], bias=False,
        num_filters=num_filters, num_channels=num_channels,
        filter_size=filter_size, stride=stride, padding=padding,
        trans=bool(trans),
    )
    # parse-time output size so a sizeless mixed_layer knows its width
    # immediately (reference ConvOperator computes it in the config
    # parser: num_filters * out_x * out_y over the square image)
    out_size = 0
    if not trans:
        import math

        pixels = _layer_size(img) // max(num_channels, 1)
        side = int(math.isqrt(pixels))
        if side * side == pixels:
            fy = filter_size_y or filter_size
            sy = stride_y or stride
            py = padding if padding_y is None else padding_y
            ox = (side + 2 * padding - filter_size) // stride + 1
            oy = (side + 2 * py - fy) // sy + 1
            if ox > 0 and oy > 0:
                out_size = num_filters * ox * oy
    if out_size:
        return (ref, "identity", {"proj_size": out_size})
    return (ref, "identity")


def conv_projection(input, filter_size, num_filters, num_channels=1,
                    stride=1, padding=0, groups=1, trans=False,
                    param_attr=None, **_):
    """(layers.py conv_projection) — learned-weight conv as a mixed
    term; materializes a conv (or conv-transpose) layer."""
    f = dsl.conv_trans if trans else dsl.conv
    kw = {} if trans else {"groups": groups}
    ref = f(_one(input), num_filters, filter_size, stride=stride,
            padding=padding, act="", bias=False, param=param_attr,
            num_channels=num_channels, **kw)
    # a projection has no bias of its own; the host mixed layer's bias
    # is SHARED per filter for conv projections (config_parser.py:2984
    # shared_biases=True, bias_size=sum(calc_bias_size))
    return (ref, "identity", {"conv_bias": num_filters})


def priorbox_layer(input, image, min_size, max_size=(), aspect_ratio=(),
                   variance=(0.1, 0.1, 0.2, 0.2), name=None, **_):
    return dsl.priorbox(_one(input), image, min_size, max_size,
                        aspect_ratio, variance, name=name)


def multibox_loss_layer(input_loc, input_conf, priorbox, label,
                        num_classes, overlap_threshold=0.5,
                        neg_pos_ratio=3.0, neg_overlap=0.5, name=None,
                        **kw):
    """Two forms: pass `gt_label=` (class-id layer) with `label` the
    [B,G,4] boxes (the explicit two-feed form), or the reference's
    single PACKED label layer (per box [label, x1, y1, x2, y2,
    difficult] — width a multiple of 6), which the layer splits on
    device (`packed_label` attr)."""
    gt_label = kw.get("gt_label")
    if gt_label is None:
        if isinstance(input_loc, (list, tuple)):
            input_loc = dsl.concat(*input_loc)
        if isinstance(input_conf, (list, tuple)):
            input_conf = dsl.concat(*input_conf)
        return dsl._add(
            "multibox_loss",
            [priorbox, label, label, input_loc, input_conf],
            name=name, bias=False, num_classes=num_classes,
            overlap_threshold=overlap_threshold,
            neg_pos_ratio=neg_pos_ratio, neg_overlap=neg_overlap,
            background_id=kw.get("background_id", 0),
            packed_label=True,
        )
    return dsl.multibox_loss(priorbox, label, gt_label, input_loc,
                             input_conf, num_classes, name=name,
                             overlap_threshold=overlap_threshold,
                             neg_pos_ratio=neg_pos_ratio,
                             neg_overlap=neg_overlap)


def detection_output_layer(input_loc, input_conf, priorbox, num_classes,
                           nms_threshold=0.45, nms_top_k=400,
                           keep_top_k=200, confidence_threshold=0.01,
                           name=None, **_):
    return dsl.detection_output(priorbox, input_loc, input_conf,
                                num_classes, name=name,
                                nms_threshold=nms_threshold,
                                nms_top_k=nms_top_k,
                                keep_top_k=keep_top_k,
                                confidence_threshold=confidence_threshold)


# ---- costs ----

def _effective_act(conf, name, depth=8):
    """The activation the values flowing out of `name` went through,
    traced through pass-through wrappers: single-input addto/dropout
    forwards its input's activation when itself linear, and a
    recurrent_group's output carries its step-net out-link's
    activation. Depth-capped; unknown -> ""."""
    while depth > 0:
        depth -= 1
        try:
            lc = conf.layer(name)
        except Exception:
            return ""
        if lc.active_type:
            return lc.active_type
        if lc.type == "recurrent_group":
            conf = lc.attrs["step_conf"]
            name = lc.attrs["out_links"][0]
            continue
        if (
            lc.type in ("addto", "seqlastins", "seqreverse")
            and len(lc.inputs) == 1
        ):
            # value-preserving wrappers: dropout/identity addto and
            # frame selectors (last_seq/first_seq/seq_reverse) carry
            # their input's distribution through unchanged
            name = lc.inputs[0].name
            continue
        return ""
    return ""


def classification_cost(input, label, name=None, coeff=1.0,
                        weight=None, **_):
    """Reference classification_cost = multi-class CE on the input
    DISTRIBUTION (the v1 idiom puts act=Softmax on the input fc;
    CostLayer.cpp MultiClassCrossEntropy reads probabilities). Route a
    softmax-activated input to the prob-CE layer — mapping it onto the
    fused logits-CE would double-softmax and floor the loss at
    -ln(sigmoid(max_margin)). A non-softmax input keeps the fused
    softmax+CE composite (same math the reference composes)."""
    x = _one(input)
    if _effective_act(x.builder.conf, x.name) == "softmax":
        return dsl.cross_entropy(x, label, name=name, coeff=coeff,
                                 weight=weight)
    return dsl.classification_cost(x, label, name=name, coeff=coeff,
                                   weight=weight)


def cross_entropy(input, label, name=None, coeff=1.0, **_):
    return dsl.cross_entropy(input, label, name=name, coeff=coeff)


def square_error_cost(input, label, name=None, coeff=1.0, **_):
    return dsl.square_error(input, label, name=name, coeff=coeff)


# reference layers.py:4042 mse_cost with alias regression_cost (:4077)
mse_cost = square_error_cost
regression_cost = square_error_cost


def rank_cost(left, right, label, name=None, coeff=1.0, **_):
    return dsl.rank_cost(left, right, label, name=name, coeff=coeff)


def sum_cost(input, name=None, coeff=1.0, **_):
    return dsl.sum_cost(_one(input), name=name, coeff=coeff)


def prelu_layer(input, partial_sum=0, name=None, param_attr=None, **_):
    return dsl.prelu(_one(input), name=name, partial_sum=partial_sum,
                     param=param_attr)


def gated_unit_layer(input, size, act=None, name=None, bias_attr=True,
                     **_):
    return dsl.gated_unit(_one(input), size, act=_act(act), name=name,
                          bias=bool(bias_attr))


def repeat_layer(input, num_repeats, name=None, **_):
    return dsl.repeat(_one(input), num_repeats, name=name)


def kmax_sequence_score_layer(input, beam_size=1, name=None, **_):
    return dsl.kmax_seq_score(_one(input), beam_size=beam_size,
                              name=name)


# ---- prebuilt networks, keyword style (networks.py) ----

def simple_lstm(input, size, name=None, act=None, reverse=False,
                lstm_cell_attr=None, **_):
    """(networks.py:548 simple_lstm)."""
    out = dsl.simple_lstm(_one(input), size, name=name,
                          act=_act_or(act, "tanh"), reversed=reverse)
    return _apply_layer_attr(out, lstm_cell_attr)


def simple_gru(input, size, name=None, act=None, gate_act=None,
               reverse=False, gru_cell_attr=None, **_):
    """(networks.py:975 simple_gru)."""
    out = dsl.simple_gru(_one(input), size, name=name,
                         act=_act_or(act, "tanh"),
                         gate_act=_act_or(gate_act, "sigmoid"),
                         reversed=reverse)
    return _apply_layer_attr(out, gru_cell_attr)


def lstmemory_unit(input, out_memory=None, name=None, size=None,
                   param_attr=None, act=None, gate_act=None,
                   state_act=None, lstm_bias_attr=True, **_):
    """(networks.py:633 lstmemory_unit) — one LSTM timestep for use
    inside recurrent_group steps; input is the 4h pre-projection.
    lstm_bias_attr may be a ParamAttr carrying a SHARED bias name
    (the reference shared_lstm config)."""
    b, bp = _bias(lstm_bias_attr)
    return dsl.lstmemory_unit(
        _one(input), size=size, name=name, out_memory=out_memory,
        act=_act_or(act, "tanh"), gate_act=_act_or(gate_act, "sigmoid"),
        state_act=_act_or(state_act, "tanh"), param=param_attr,
        bias=b, bias_param=bp,
    )


def lstmemory_group(input, size=None, name=None, out_memory=None,
                    reverse=False, param_attr=None, act=None,
                    gate_act=None, state_act=None, lstm_bias_attr=True,
                    **_):
    """(networks.py:744 lstmemory_group)."""
    b, bp = _bias(lstm_bias_attr)
    return dsl.lstmemory_group(
        _one(input), size=size, name=name, out_memory=out_memory,
        reversed=reverse, act=_act_or(act, "tanh"),
        gate_act=_act_or(gate_act, "sigmoid"),
        state_act=_act_or(state_act, "tanh"), param=param_attr,
        bias=b, bias_param=bp,
    )


def gru_unit(input, memory_boot=None, size=None, name=None,
             gru_bias_attr=True, gru_param_attr=None, act=None,
             gate_act=None, naive=False, **_):
    """(networks.py:840 gru_unit) — one GRU timestep for
    recurrent_group steps; input is the 3h pre-projection."""
    b, bp = _bias(gru_bias_attr)
    return dsl.gru_unit(
        _one(input), size=size, name=name, memory_boot=memory_boot,
        act=_act_or(act, "tanh"), gate_act=_act_or(gate_act, "sigmoid"),
        param=gru_param_attr, bias=b, bias_param=bp, naive=naive,
    )


def gru_group(input, memory_boot=None, size=None, name=None,
              reverse=False, gru_bias_attr=True, gru_param_attr=None,
              act=None, gate_act=None, naive=False, **_):
    """(networks.py:902 gru_group)."""
    b, bp = _bias(gru_bias_attr)
    return dsl.gru_group(
        _one(input), size=size, name=name, memory_boot=memory_boot,
        reversed=reverse, act=_act_or(act, "tanh"),
        gate_act=_act_or(gate_act, "sigmoid"), param=gru_param_attr,
        bias=b, bias_param=bp, naive=naive,
    )


def simple_gru2(input, size, name=None, reverse=False, act=None,
                gate_act=None, **_):
    """(networks.py:1061 simple_gru2)."""
    return dsl.simple_gru2(_one(input), size, name=name,
                           act=_act_or(act, "tanh"),
                           gate_act=_act_or(gate_act, "sigmoid"),
                           reversed=reverse)


def bidirectional_gru(input, size, name=None, return_seq=False,
                      fwd_act=None, fwd_gate_act=None, **_):
    """(networks.py:1122 bidirectional_gru). The fwd_* activations
    apply to both directions (the reference defaults both directions
    to the same activations unless overridden per side)."""
    return dsl.bidirectional_gru(_one(input), size, name=name,
                                 return_seq=return_seq,
                                 act=_act_or(fwd_act, "tanh"),
                                 gate_act=_act_or(fwd_gate_act,
                                                  "sigmoid"))


def img_conv_bn_pool(input, filter_size, num_filters, pool_size,
                     name=None, pool_type=None, act=None, groups=1,
                     conv_stride=1, conv_padding=0, num_channel=None,
                     conv_param_attr=None, pool_stride=1,
                     pool_padding=0, **_):
    """(networks.py:232 img_conv_bn_pool)."""
    return dsl.img_conv_bn_pool(
        _one(input), filter_size, num_filters, pool_size, name=name,
        pool_type=_pool_type(pool_type), act=_act_or(act, "relu"),
        groups=groups, conv_stride=conv_stride,
        conv_padding=conv_padding, num_channel=num_channel,
        conv_param=conv_param_attr, pool_stride=pool_stride,
        pool_padding=pool_padding,
    )


def text_conv_pool(input, context_len, hidden_size, name=None, **kw):
    """(networks.py:41 text_conv_pool = sequence_conv_pool alias)."""
    return sequence_conv_pool(input, context_len, hidden_size,
                              name=name, **kw)


def bidirectional_lstm(input, size, name=None, return_seq=False, **_):
    """(networks.py:1207 bidirectional_lstm). return_seq=False pools
    each direction's last frame, True concats the full sequences."""
    x = _one(input)
    if return_seq:
        return dsl.bidirectional_lstm(x, size, name=name)
    fwd = dsl.simple_lstm(x, size, name=(name or "bilstm") + "_fwd")
    bwd = dsl.simple_lstm(x, size, name=(name or "bilstm") + "_bwd",
                          reversed=True)
    return dsl.concat(dsl.last_seq(fwd), dsl.first_seq(bwd), name=name)


def sequence_conv_pool(input, context_len, hidden_size, name=None,
                       context_start=None, pool_type=None,
                       context_proj_layer_name=None,
                       context_proj_param_attr=False,
                       fc_layer_name=None, fc_param_attr=None,
                       fc_bias_attr=None, fc_act=None,
                       pool_bias_attr=None, **_):
    """Text conv-pool: context projection -> fc -> sequence pooling
    (networks.py:41 sequence_conv_pool — the quick_start CNN)."""
    x = _one(input)
    context_proj_layer_name = (
        context_proj_layer_name or f"{name}_conv_proj"
    )
    with mixed_layer(
        name=context_proj_layer_name,
        size=x.size * context_len,
        act=LinearActivation(),
    ) as m:
        m += context_projection(
            x, context_len=context_len, context_start=context_start
        )
    fl = fc_layer(
        name=fc_layer_name or f"{name}_conv_fc",
        input=m,
        size=hidden_size,
        act=fc_act or TanhActivation(),
        param_attr=fc_param_attr,
        bias_attr=fc_bias_attr if fc_bias_attr is not None else True,
    )
    return pooling_layer(name=name, input=fl, pooling_type=pool_type)


def simple_img_conv_pool(input, filter_size, num_filters, pool_size,
                         pool_stride=1, act=None, name=None, padding=0,
                         num_channel=None, **_):
    """(networks.py:145 simple_img_conv_pool)."""
    c = dsl.conv(_one(input), num_filters, filter_size, padding=padding,
                 act=_act_or(act, "relu"), num_channels=num_channel,
                 name=(name or "convpool") + "_conv")
    return dsl.pool(c, pool_size, pool_stride,
                    name=(name or "convpool") + "_pool")


def img_conv_group(input, conv_num_filter, conv_filter_size, pool_size,
                   pool_stride, conv_act=None, conv_with_batchnorm=False,
                   conv_batchnorm_drop_rate=None, pool_type=None,
                   num_channels=None, conv_padding=None, **_):
    """A VGG block (networks.py:333 img_conv_group)."""
    h = _one(input)
    n = len(conv_num_filter)
    fss = (conv_filter_size if isinstance(conv_filter_size, (list, tuple))
           else [conv_filter_size] * n)
    bns = (conv_with_batchnorm
           if isinstance(conv_with_batchnorm, (list, tuple))
           else [conv_with_batchnorm] * n)
    drops = (conv_batchnorm_drop_rate
             if isinstance(conv_batchnorm_drop_rate, (list, tuple))
             else [conv_batchnorm_drop_rate] * n)
    act = _act_or(conv_act, "relu")
    for i, (nf, fs, bn) in enumerate(zip(conv_num_filter, fss, bns)):
        pad = (conv_padding[i]
               if isinstance(conv_padding, (list, tuple))
               else conv_padding)
        if pad is None:
            pad = (fs - 1) // 2
        h = dsl.conv(h, nf, fs, padding=pad, act="" if bn else act,
                     num_channels=num_channels if i == 0 else None)
        if bn:
            h = dsl.batch_norm(h, act=act)
            if drops[i]:
                h = dsl.dropout(h, drops[i])
    return dsl.pool(h, pool_size, pool_stride,
                    pool_type=_pool_type(pool_type))


def simple_attention(encoded_sequence, encoded_proj, decoder_state,
                     transform_param_attr=None, softmax_param_attr=None,
                     weight_act=None, name=None, size=None, **_):
    return dsl.simple_attention(
        encoded_sequence, encoded_proj, decoder_state, name=name,
        weight_act=_act_or(weight_act, "tanh"),
        transform_param=transform_param_attr,
        softmax_param=softmax_param_attr, size=size,
    )


def sub_nested_seq_layer(input, selected_indices, name=None, **_):
    return dsl.sub_nested_seq(_one(input), selected_indices, name=name)


def get_output_layer(input, arg_name, name=None, **_):
    return dsl.get_output(_one(input), arg_name, name=name)


# ---- recurrence ----

def memory(name, size, boot_layer=None, **_):
    return dsl.memory(name, size=size, boot_layer=boot_layer)


class SubsequenceInput:
    """(layers.py SubsequenceInput) — marks a recurrent_group in-link
    whose OUTER iteration walks subsequences. The scan executor keys
    off the input spec's has_subseq (layers/recurrent_group.py), so
    this unwraps to the underlying layer at group-build time."""

    def __init__(self, input):
        self.input = _one(input)


def StaticInput(input, is_seq=False, size=None, **_):
    """(layers.py StaticInput) — whole-sequence read-only in-link."""
    return dsl.StaticInput(_one(input))


def recurrent_group(step, input, name=None, reverse=False, **_):
    ins = [x.input if isinstance(x, SubsequenceInput) else x
           for x in _many(input)]
    return dsl.recurrent_group(step, ins, name=name,
                               reversed=reverse)


class BaseGeneratedInput:
    """(layers.py BaseGeneratedInput)."""


class GeneratedInput(BaseGeneratedInput):
    """(layers.py:3744 GeneratedInput) — the beam_search in-link whose
    value at step t is the `embedding_name` embedding of the word the
    beam generated at t-1 (bos at t=0)."""

    def __init__(self, size, embedding_name, embedding_size, **_):
        self.size = size
        self.embedding_name = embedding_name
        self.embedding_size = embedding_size


def beam_search(step, input, bos_id, eos_id, beam_size=1,
                max_length=500, name=None,
                num_results_per_sample=None, **_):
    """(layers.py:3893 beam_search) — declare a GENERATING recurrent
    group: `step` runs per decode step over beam candidates; the
    GeneratedInput position receives the embedded previously-generated
    word; other inputs are per-sequence statics. Recorded as a
    SubModelConf(is_generating=True) executed by
    api.SequenceGenerator (RecurrentGradientMachine.h:307
    generateSequence + beamSearch)."""
    from paddle_tpu_torch.core.config import InputConf, LayerConf, SubModelConf

    ins = _many(input)
    gen_pos = [
        i for i, x in enumerate(ins)
        if isinstance(x, BaseGeneratedInput)
    ]
    assert len(gen_pos) == 1, (
        "beam_search needs exactly one GeneratedInput among its inputs"
    )
    gi = ins[gen_pos[0]]
    statics = []
    for i, x in enumerate(ins):
        if i == gen_pos[0]:
            continue
        # unwrap the v1/dsl StaticInput wrappers to the layer ref
        x = getattr(x, "input", x)
        x = getattr(x, "ref", x)
        statics.append(_one(x))
    g = dsl.current()
    gname = name or g.uniq("beam_search")
    out = g.add(
        LayerConf(
            name="__beam_search_predict__", type="gen_output",
            size=gi.size,
            inputs=[InputConf(name=s.name) for s in statics],
            attrs={"dim": (1,), "is_seq": True, "is_ids": True},
        )
    )
    g.conf.sub_models.append(
        SubModelConf(
            name=gname,
            layer_names=["__beam_search_predict__"],
            is_generating=True,
            attrs={
                "step": step,
                "gen_pos": gen_pos[0],
                "gen_size": gi.size,
                "embedding_name": gi.embedding_name,
                "embedding_size": gi.embedding_size,
                "static_layer_names": [s.name for s in statics],
                "bos_id": bos_id,
                "eos_id": eos_id,
                "beam_size": beam_size,
                "max_length": max_length,
                "num_results": num_results_per_sample or beam_size,
                "out_layer": "__beam_search_predict__",
            },
        )
    )
    return out


def small_vgg(input_image, num_channels, num_classes, **_):
    """(networks.py:435 small_vgg): 4 VGG blocks with batch-norm +
    per-conv dropout, pool, dropout, fc(512)+bn+relu, softmax fc."""

    def block(ipt, num_filter, times, dropouts, num_channels_=None):
        return img_conv_group(
            input=ipt,
            num_channels=num_channels_,
            pool_size=2,
            pool_stride=2,
            conv_num_filter=[num_filter] * times,
            conv_filter_size=3,
            conv_act=ReluActivation(),
            conv_with_batchnorm=True,
            conv_batchnorm_drop_rate=dropouts,
            pool_type="max",
        )

    tmp = block(input_image, 64, 2, [0.3, 0], num_channels)
    tmp = block(tmp, 128, 2, [0.4, 0])
    tmp = block(tmp, 256, 3, [0.4, 0.4, 0])
    tmp = block(tmp, 512, 3, [0.4, 0.4, 0])
    tmp = img_pool_layer(input=tmp, stride=2, pool_size=2)
    tmp = dropout_layer(input=tmp, dropout_rate=0.5)
    tmp = fc_layer(input=tmp, size=512, act=LinearActivation())
    tmp = dropout_layer(input=tmp, dropout_rate=0.5)
    tmp = batch_norm_layer(input=tmp, act=ReluActivation())
    return fc_layer(input=tmp, size=num_classes,
                    act=SoftmaxActivation())


def vgg_16_network(input_image, num_channels, num_classes=1000, **_):
    """(networks.py:465 vgg_16_network)."""

    def block(ipt, num_filter, times, num_channels_=None):
        return img_conv_group(
            input=ipt,
            num_channels=num_channels_,
            pool_size=2,
            pool_stride=2,
            conv_num_filter=[num_filter] * times,
            conv_filter_size=3,
            conv_act=ReluActivation(),
            pool_type="max",
        )

    tmp = block(input_image, 64, 2, num_channels)
    tmp = block(tmp, 128, 2)
    tmp = block(tmp, 256, 3)
    tmp = block(tmp, 512, 3)
    tmp = block(tmp, 512, 3)
    tmp = fc_layer(input=tmp, size=4096, act=ReluActivation())
    tmp = dropout_layer(input=tmp, dropout_rate=0.5)
    tmp = fc_layer(input=tmp, size=4096, act=ReluActivation())
    tmp = dropout_layer(input=tmp, dropout_rate=0.5)
    return fc_layer(input=tmp, size=num_classes,
                    act=SoftmaxActivation())
