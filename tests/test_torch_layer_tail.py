"""The layer tail against the JAX package, on the CPU.

Every layer type the port gained with the tail of the layer library —
the other `basic.py` and `cost.py` types, `extras.py`, `maxout` / `spp`
/ `blockexpand`, `conv_trans` and `conv_operator`, `mdlstm`,
`sampling.py` and the detection heads — is built once through
`paddle_tpu.dsl` and once through the port's copy. Both run on the same
seeded numpy feed and parameters (the JAX init, then every parameter
redrawn from a seed so that no weight is a constant). The output, and
the gradient of a seeded random projection of it with respect to every
parameter and float input, agree within 1e-5 of max(1, the largest
entry); ids and lengths exactly. Where the JAX layer itself gives -inf
or NaN (an spp bin wholly in padding), the port gives the same.

Random layers are held otherwise: `nce` through `nce_cost` on the
negatives the JAX layer itself draws in eval mode, `sampling_id` and
the NCE sampler through seeded frequency tests. `kmax_seq_score` and
`detection_output` run on inputs with ties; `mdlstm` in all four
directions. ROADMAP C5: the JAX `conv_operator(trans=True)` returns
another shape than it declares at a padding other than (f-1)/2; the
port raises there.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from paddle_tpu import dsl as jdsl
from paddle_tpu.core import arg as jarg
from paddle_tpu.core.registry import LAYERS as JLAYERS
from paddle_tpu.layers.base import Ctx as JCtx
from paddle_tpu.network import Network as JNetwork
from paddle_tpu_torch import dsl as tdsl
from paddle_tpu_torch.core import arg as targ
from paddle_tpu_torch.core import rng as trng
from paddle_tpu_torch.core.registry import LAYERS
from paddle_tpu_torch.layers import sampling as tsampling
from paddle_tpu_torch.layers.base import Ctx as TCtx
from paddle_tpu_torch.network import Network as TNetwork

TOL = 1e-5
B, T, D = 4, 8, 6
LENS = np.asarray([8, 0, 3, 5], np.int32)
IMG = (6, 5, 4)
MD_H = 3


def _feeds(seed=0):
    """{name: (kind, value, lens)} numpy inputs."""
    rng = np.random.default_rng(seed)

    def normal(*shape):
        return rng.standard_normal(shape).astype(np.float32)

    def seqv(d, lens=LENS):
        return normal(B, T, d) * (np.arange(T)[None, :, None]
                                  < lens[:, None, None])

    # scores with ties (kmax_seq_score, lambda_cost): multiples of 0.5
    tied = (rng.integers(-2, 3, (B, T, 1)) * 0.5).astype(np.float32)
    tied *= (np.arange(T)[None, :, None] < LENS[:, None, None])
    rel = rng.integers(0, 4, (B, T, 1)).astype(np.float32)
    rel *= (np.arange(T)[None, :, None] < LENS[:, None, None])
    prob = 1.0 / (1.0 + np.exp(-normal(B, D)))
    # ground truth for the detection heads: 3 slots, counts 3 / 1 / 0 / 2
    lo = rng.uniform(0.0, 0.6, (B, 3, 2))
    hi = lo + rng.uniform(0.1, 0.4, (B, 3, 2))
    gt = np.concatenate([lo, hi], -1).astype(np.float32)
    gt_lens = np.asarray([3, 1, 0, 2], np.int32)
    return {
        "a": ("nonseq", normal(B, D), None),
        "b": ("nonseq", normal(B, D), None),
        "c": ("nonseq", normal(B, D), None),
        "w1": ("nonseq", rng.uniform(0.1, 0.9, (B, 1)).astype(np.float32),
               None),
        "b18": ("nonseq", normal(B, 3 * D), None),
        "pos": ("nonseq", rng.uniform(0.5, 2.0, (B, D)).astype(np.float32),
                None),
        "prob": ("nonseq", prob.astype(np.float32), None),
        "soft": ("nonseq", rng.uniform(0, 1, (B, D)).astype(np.float32),
                 None),
        "bin": ("nonseq", rng.integers(0, 2, (B, D)).astype(np.float32),
                None),
        "sel": ("nonseq", rng.integers(0, 2, (B, 5)).astype(np.float32),
                None),
        "s1": ("nonseq", normal(B, 1), None),
        "s2": ("nonseq", normal(B, 1), None),
        "t": ("nonseq", rng.uniform(0, 1, (B, 1)).astype(np.float32), None),
        "lab": ("ids", rng.integers(0, D, B).astype(np.int32), None),
        "lab7": ("ids", rng.integers(0, 7, B).astype(np.int32), None),
        "lab2": ("ids", rng.integers(0, 2, B).astype(np.int32), None),
        "pick": ("ids", rng.integers(0, 3, B).astype(np.int32), None),
        "x": ("seq", seqv(D), LENS),
        "tied": ("seq", tied, LENS),
        "rel": ("seq", rel, LENS),
        "tok": ("ids_seq", rng.integers(0, 4, (B, T)).astype(np.int32),
                LENS),
        "img": ("nonseq", normal(B, *IMG), None),
        "sq": ("nonseq", normal(B, 4, 4, 2), None),
        "flt": ("nonseq", normal(B, 3 * 3 * 2 * 3), None),
        "grid": ("nonseq", normal(B, 3, 4, 5 * MD_H), None),
        "x4": ("nonseq", normal(B, 4 * 3), None),
        "h": ("nonseq", normal(B, 3), None),
        "cst": ("nonseq", normal(B, 3), None),
        "fmap": ("nonseq", normal(B, 3, 3, 2), None),
        "image": ("nonseq", normal(B, 12, 12, 3), None),
        "gt": ("seq", gt, gt_lens),
        "gt_lab": ("ids_seq", rng.integers(1, 4, (B, 3)).astype(np.int32),
                   gt_lens),
        "loc": ("nonseq", 0.5 * normal(B, 36 * 4), None),
        "conf": ("nonseq", normal(B, 36 * 4), None),
        # confidences with ties: two levels over a few priors and classes
        "conf_tied": ("nonseq", (rng.integers(0, 2, (B, 36 * 4)) * 1.5)
                      .astype(np.float32), None),
    }


def _jarg(kind, v, lens):
    if kind == "seq":
        return jarg.seq(jnp.asarray(v), jnp.asarray(lens))
    if kind == "nonseq":
        return jarg.non_seq(jnp.asarray(v))
    return jarg.id_arg(jnp.asarray(v),
                       None if lens is None else jnp.asarray(lens))


def _targ(kind, v, lens):
    if kind == "seq":
        return targ.seq(v, lens)
    if kind == "nonseq":
        return targ.non_seq(v)
    return targ.id_arg(v, lens)


def _data(dsl, name):
    kind, v, _ = _feeds()[name]
    if kind == "nonseq":
        return dsl.data(name, v.shape[1:])
    if kind in ("ids", "ids_seq"):
        return dsl.data(name, 1, is_ids=True, is_seq=kind == "ids_seq")
    return dsl.data(name, v.shape[2:], is_seq=True)


def _out(dsl, type_, inputs, size=0, act="", bias=False, **attrs):
    return dsl._add(type_, inputs, name="out", size=size, act=act,
                    bias=bias, **attrs)


def _get_output(d, x4, h, c):
    ls = d._add("lstm_step", [x4, h, c], name="ls", size=3)
    ref = _out(d, "get_output", [ls])
    d.current().conf.layer("out").inputs[0].attrs[
        "input_layer_argument"] = "state"
    return ref


def _priorbox(d, fmap, image):
    return d.priorbox(fmap, image, min_size=[4.0], max_size=[8.0],
                      aspect_ratio=[2.0], name="pb")


def _multibox(d, fmap, image, gt, gt_lab, loc, conf):
    pb = _priorbox(d, fmap, image)
    return _out(d, "multibox_loss", [pb, gt, gt_lab, loc, conf],
                num_classes=4, overlap_threshold=0.3, neg_pos_ratio=2.0,
                neg_overlap=0.5)


def _detout(d, fmap, image, loc, conf):
    pb = _priorbox(d, fmap, image)
    return _out(d, "detection_output", [pb, loc, conf], num_classes=4,
                nms_threshold=0.3, nms_top_k=10, keep_top_k=12,
                confidence_threshold=0.01)


# case -> (inputs, build(dsl, *refs) making the layer "out")
CASES = {
    # basic.py
    "cos": (("a", "b"), lambda d, a, b: _out(d, "cos", [a, b], scale=2.0)),
    "cos_k3": (("a", "b18"), lambda d, a, b: _out(d, "cos", [a, b], size=3)),
    "interpolation": (("w1", "a", "b"), lambda d, w, a, b: _out(
        d, "interpolation", [w, a, b])),
    "dot_mul": (("a", "b"), lambda d, a, b: _out(d, "dot_mul", [a, b],
                                                 act="tanh")),
    "slope_intercept": (("a",), lambda d, a: _out(
        d, "slope_intercept", [a], slope=-1.5, intercept=0.25)),
    "tensor": (("a", "b"), lambda d, a, b: _out(d, "tensor", [a, b], size=4,
                                                act="tanh", bias=True)),
    **{t: (("a", "w1"), lambda d, a, w, t=t: _out(d, t, [a, w]))
       for t in ("outer_prod", "out_prod")},
    "sum_to_one_norm": (("pos",), lambda d, a: _out(d, "sum_to_one_norm",
                                                    [a])),
    "trans": (("b18",), lambda d, a: _out(d, "trans", [a], height=3,
                                          width=6)),
    "trans_seq": (("x",), lambda d, a: _out(d, "trans", [a], height=2,
                                            width=3)),
    "resize": (("img",), lambda d, a: _out(d, "resize", [a], size=120)),
    # cost.py
    "smooth_l1": (("a", "b"), lambda d, a, b: _out(d, "smooth_l1", [a, b])),
    "sum_cost": (("x",), lambda d, x: _out(d, "sum_cost", [x], coeff=0.5)),
    "soft_binary_class_cross_entropy": (("prob", "soft"), lambda d, p, s:
                                        _out(d, "soft_binary_class_cross_"
                                             "entropy", [p, s])),
    "multi_binary_label_cross_entropy": (("prob", "bin"), lambda d, p, s:
                                         _out(d, "multi_binary_label_cross_"
                                              "entropy", [p, s])),
    "rank-cost": (("s1", "s2", "t"), lambda d, a, b, t: _out(
        d, "rank-cost", [a, b, t])),
    "rank-cost_ids": (("s1", "s2", "lab2"), lambda d, a, b, t: _out(
        d, "rank-cost", [a, b, t])),
    **{t: (("s1", "lab2"), lambda d, s, lab, t=t: _out(d, t, [s, lab]))
       for t in ("huber", "huber-two-class", "huber_classification")},
    "lambda_cost": (("tied", "rel"), lambda d, s, r: _out(
        d, "lambda_cost", [s, r], NDCG_num=3)),
    "softmax": (("a",), lambda d, a: _out(d, "softmax", [a])),
    "multi_class_cross_entropy_with_selfnorm": (
        ("pos", "lab"), lambda d, p, lab: _out(
            d, "multi_class_cross_entropy_with_selfnorm", [p, lab],
            softmax_selfnorm_alpha=0.3)),
    # extras.py
    "selective_fc": (("a",), lambda d, a: _out(d, "selective_fc", [a],
                                               size=5, bias=True)),
    "selective_fc_softmax": (("a", "sel"), lambda d, a, s: _out(
        d, "selective_fc", [a, s], size=5, act="softmax", bias=True)),
    "conv_shift": (("a", "w1"), lambda d, a, w: d.conv_shift(
        a, d.fc(a, size=3, name="filt"), name="out")),
    "bilinear_interp": (("img",), lambda d, i: _out(
        d, "bilinear_interp", [i], out_size_x=7, out_size_y=4)),
    **{t: (("w1", "b18"), lambda d, w, x, t=t: _out(
        d, t, [d.fc(w, size=3, name="wts"), x], size=D))
       for t in ("convex_comb", "linear_comb")},
    "eos_id": (("tok",), lambda d, t: _out(d, "eos_id", [t], eos_id=2)),
    "power": (("w1", "pos"), lambda d, w, x: _out(d, "power", [w, x])),
    "clip": (("a",), lambda d, a: _out(d, "clip", [a], min=-0.5, max=0.7)),
    "row_conv": (("x",), lambda d, x: _out(d, "row_conv", [x],
                                           context_length=3)),
    "featmap_expand": (("a",), lambda d, a: _out(d, "featmap_expand", [a],
                                                 num_filters=3)),
    "prelu": (("a",), lambda d, a: _out(d, "prelu", [a], partial_sum=2)),
    "prelu_image": (("img",), lambda d, a: _out(d, "prelu", [a],
                                                partial_sum=30)),
    "gated_unit": (("a",), lambda d, a: _out(d, "gated_unit", [a], size=4,
                                             act="tanh", bias=True)),
    "repeat": (("x",), lambda d, x: _out(d, "repeat", [x], num_repeats=3)),
    "kmax_seq_score": (("tied",), lambda d, s: _out(d, "kmax_seq_score", [s],
                                                    beam_size=4)),
    "cos_vm": (("a", "b18"), lambda d, v, m: _out(d, "cos_vm", [v, m],
                                                  size=3, scale=1.5)),
    **{f"data_norm_{s}": (("a",), lambda d, a, s=s: _out(
        d, "data_norm", [a], data_norm_strategy=s))
       for s in ("z-score", "min-max", "decimal-scaling")},
    "print": (("a",), lambda d, a: _out(d, "print", [a])),
    "get_output": (("x4", "h", "cst"), _get_output),
    "eltmul": (("a", "b"), lambda d, a, b: _out(d, "eltmul", [a, b],
                                                scale=0.5)),
    # pool.py
    "maxout": (("img",), lambda d, i: _out(d, "maxout", [i], groups=2)),
    **{f"spp_{p}": (("img",), lambda d, i, p=p: _out(
        d, "spp", [i], pyramid_height=3, pool_type=p))
       for p in ("max", "avg")},
    "blockexpand": (("img",), lambda d, i: _out(
        d, "blockexpand", [i], block=(2, 3), stride=(2, 1), padding=1)),
    "block_expand": (("img",), lambda d, i: _out(d, "block_expand", [i],
                                                 block=2)),
    # conv.py: even and odd strides and paddings
    **{f"{t}_f{f}_s{s}_p{p}": (("img",), lambda d, i, t=t, f=f, s=s, p=p:
                              _out(d, t, [i], size=3, bias=True,
                                   act="tanh", num_filters=3,
                                   filter_size=f, stride=s, padding=p))
       for t, f, s, p in (("exconvt", 3, 1, 0), ("conv_trans", 3, 2, 1),
                          ("cudnn_convt", 4, 3, 2), ("exconvt", 2, 2, 0),
                          ("conv_trans", 5, 1, 2))},
    **{f"conv_operator_s{s}_p{p}": (("sq", "flt"), lambda d, i, f, s=s, p=p:
                                   _out(d, "conv_operator", [i, f],
                                        num_filters=3, num_channels=2,
                                        filter_size=3, stride=s, padding=p))
       for s, p in ((1, 0), (2, 1), (1, 2))},
    **{f"conv_operator_trans_s{s}": (("sq", "flt"), lambda d, i, f, s=s:
                                    _out(d, "conv_operator", [i, f],
                                         num_filters=3, num_channels=2,
                                         filter_size=3, stride=s, padding=1,
                                         trans=True))
       for s in (1, 2)},
    # recurrent.py: every direction
    **{f"{t}_{int(r)}{int(c)}": (("grid",), lambda d, g, t=t, r=r, c=c: _out(
        d, t, [g], size=MD_H, bias=True, act="tanh", directions=(r, c)))
       for t, r, c in (("mdlstm", True, True), ("mdlstm", False, True),
                       ("mdlstmemory", True, False),
                       ("mdlstmemory", False, False))},
    # sampling.py (the deterministic types)
    "hsigmoid": (("a", "b", "lab7"), lambda d, a, b, lab: _out(
        d, "hsigmoid", [a, b, lab], bias=True, num_classes=7)),
    **{t: (("a",), lambda d, a, t=t: _out(d, t, [a]))
       for t in ("max_id", "maxid")},
    "max_id_seq": (("x",), lambda d, x: _out(d, "max_id", [x])),
    "multiplex": (("pick", "a", "b", "c"), lambda d, s, a, b, c: _out(
        d, "multiplex", [s, a, b, c])),
    # detection
    "priorbox": (("fmap", "image"), lambda d, f, i: _out(
        d, "priorbox", [f, i], min_size=[4.0], max_size=[8.0],
        aspect_ratio=[2.0])),
    "multibox_loss": (("fmap", "image", "gt", "gt_lab", "loc", "conf"),
                      _multibox),
    "detection_output": (("fmap", "image", "loc", "conf"), _detout),
    "detection_output_ties": (("fmap", "image", "loc", "conf_tied"),
                              _detout),
}


def _conf(dsl, case):
    names, build = CASES[case]
    with dsl.model() as g:
        build(dsl, *[_data(dsl, n) for n in names])
    return g.conf


def _params(jnet, seed, case=""):
    """The JAX init, every parameter then redrawn from a seed (so that
    data_norm's statistics and prelu's slopes are not constants), with
    two zero statistics for data_norm (its identity rule)."""
    p = {k: np.asarray(v) for k, v in jnet.init_params(
        jax.random.key(seed)).items()}
    rng = np.random.default_rng(seed + 7)
    out = {}
    for k, v in sorted(p.items()):
        out[k] = (0.5 * rng.standard_normal(v.shape)).astype(v.dtype)
    if case.startswith("data_norm"):
        out["_out.w0"][:, :2] = 0.0
    return out


def _run(case, seed=0):
    """(JAX out, port out, JAX grads, port grads): the output Args and
    the gradients of sum(out * R) for a seeded R, with respect to every
    parameter and float input."""
    names, _ = CASES[case]
    feeds = {n: _feeds(seed)[n] for n in names}
    jnet, tnet = JNetwork(_conf(jdsl, case)), TNetwork(_conf(tdsl, case))
    params = _params(jnet, seed, case)
    floats = [n for n in names if feeds[n][0] in ("seq", "nonseq")]

    def jout(p, vals):
        feed = {n: _jarg(*feeds[n]) for n in names}
        for n in floats:
            feed[n] = feed[n].with_value(vals[n])
        return jnet.forward(p, feed, outputs=["out"])[0]["out"]

    jp = {k: jnp.asarray(v) for k, v in params.items()}
    jvals = {n: jnp.asarray(feeds[n][1]) for n in floats}
    jo = jout(jp, jvals)
    tp = {k: torch.tensor(v, requires_grad=True) for k, v in params.items()}
    tvals = {n: torch.tensor(feeds[n][1], requires_grad=True)
             for n in floats}
    tfeed = {n: _targ(*feeds[n]) for n in names}
    for n in floats:
        tfeed[n] = tfeed[n].with_value(tvals[n])
    to = tnet.forward(tp, tfeed, outputs=["out"])[0]["out"]
    jgrads = tgrads = None
    if jo.value is not None and to.value.requires_grad:
        r = np.random.default_rng(seed + 1).standard_normal(
            jo.value.shape).astype(np.float32)
        jgrads = jax.grad(lambda p, v: jnp.sum(jout(p, v).value * r),
                          argnums=(0, 1))(jp, jvals)
        jgrads = {**{f"param {k}": g for k, g in jgrads[0].items()},
                  **{f"input {k}": g for k, g in jgrads[1].items()}}
        (to.value * torch.from_numpy(r)).sum().backward()
        tgrads = {**{f"param {k}": v.grad for k, v in tp.items()},
                  **{f"input {k}": v.grad for k, v in tvals.items()}}
        # a tensor the output does not depend on has no torch gradient,
        # a zero JAX one
        tgrads = {k: np.zeros(jgrads[k].shape, np.float32) if g is None
                  else g.numpy() for k, g in tgrads.items()}
    return jo, to, jgrads, tgrads


def _close(got, want, what=""):
    """Within TOL of max(1, the largest finite entry); a non-finite entry
    of the JAX layer's (an spp bin wholly in padding: -inf for max, NaN
    for avg) must be the same in the port."""
    want = np.asarray(want)
    assert got.shape == want.shape, (what, got.shape, want.shape)
    fin = np.isfinite(want)
    np.testing.assert_array_equal(got[~fin], want[~fin], err_msg=what)
    np.testing.assert_allclose(
        got[fin], want[fin], rtol=0, atol=TOL * max(1.0, float(np.abs(
            want[fin]).max(initial=0.0))), err_msg=what)


@pytest.mark.parametrize("case", sorted(CASES))
def test_layer_matches_jax(case):
    jo, to, jgrads, tgrads = _run(case)
    for field in ("seq_lens", "subseq_lens"):
        jv, tv = getattr(jo, field), getattr(to, field)
        assert (jv is None) == (tv is None), field
        if jv is not None:
            np.testing.assert_array_equal(tv.numpy(), np.asarray(jv))
    if jo.ids is not None:
        np.testing.assert_array_equal(to.ids.numpy(), np.asarray(jo.ids))
        return
    _close(to.value.detach().numpy(), jo.value, "out")
    if jgrads is not None:
        assert sorted(jgrads) == sorted(tgrads)
        for k in jgrads:
            _close(tgrads[k], jgrads[k], k)


NEW_TYPES = sorted(set(JLAYERS.names()) - {"moe"} - {
    # the registry before the layer tail
    "addto", "attention", "average", "batch_norm", "classification_cost",
    "concat", "concat2", "conv", "cross_entropy", "cudnn_batch_norm",
    "cudnn_conv", "cudnn_pool", "data", "embedding", "exconv", "expand",
    "fc", "fused_att_decoder", "fused_bottleneck_tail", "fused_conv1x1_bn",
    "gated_recurrent", "gru", "gru_step", "gru_step_naive", "grumemory",
    "last_seq", "lstm", "lstm_step", "lstmemory", "max", "mixed", "mse",
    "multi-class-cross-entropy", "multi_head_attention", "pool",
    "recurrent", "recurrent_group", "recurrent_layer_group", "scaling",
    "seqlastins", "seqpool", "sequence_pool", "softmax_with_cross_entropy",
    "square_error", "sum_of_squares", "cmrnorm-projection", "crf",
    "crf_decoding", "crop", "ctc", "gen_output", "norm", "pad", "padding",
    "rotate", "row_l2_norm", "seq_slice", "seqconcat", "seqreshape",
    "seqreverse", "sequence_reverse", "slice", "sub_nested_seq", "sub_seq",
    "subseq", "warp_ctc"})


def test_every_new_type_is_reached():
    """The 59 names of the tail: each registered in the port and built by
    a case above (nce and sampling_id by the tests below)."""
    assert len(NEW_TYPES) == 59
    reached = {"nce", "sampling_id"}
    for case in CASES:
        reached |= {lc.type for lc in _conf(tdsl, case).layers}
    assert set(NEW_TYPES) <= reached
    assert set(NEW_TYPES) <= set(LAYERS.names())


def test_kmax_and_detection_ties_are_real():
    """The tie cases hold ties: kmax's scores repeat within a row, and
    detection_output's kept rows include equal scores."""
    _jo, to, _jg, _tg = _run("kmax_seq_score")
    tied = _feeds()["tied"][1][0, :, 0]
    assert len(set(tied.tolist())) < len(tied)
    assert (to.ids.numpy()[1] == -1).all()      # the empty row
    _jo, to, _jg, _tg = _run("detection_output_ties")
    rows = to.value.detach().numpy().reshape(B, 12, 6)
    scores = rows[..., 1][rows[..., 1] > 0]
    assert len(scores) > len(set(scores.tolist()))


def test_mdlstm_walks_every_cell_as_the_jax_scan():
    """A one-row grid and a one-column grid (the walk's degenerate
    diagonals) equal the JAX layer too."""
    for shape in ((1, 5), (4, 1)):
        feeds = np.random.default_rng(3).standard_normal(
            (2,) + shape + (5 * MD_H,)).astype(np.float32)

        def conf(d):
            with d.model() as g:
                x = d.data("g", shape + (5 * MD_H,))
                _out(d, "mdlstm", [x], size=MD_H, bias=True, act="tanh")
            return g.conf

        jnet, tnet = JNetwork(conf(jdsl)), TNetwork(conf(tdsl))
        params = _params(jnet, 1)
        jo = jnet.forward({k: jnp.asarray(v) for k, v in params.items()},
                          {"g": jarg.non_seq(jnp.asarray(feeds))},
                          outputs=["out"])[0]["out"]
        to = tnet.forward({k: torch.tensor(v) for k, v in params.items()},
                          {"g": targ.non_seq(feeds)},
                          outputs=["out"])[0]["out"]
        _close(to.value.numpy(), jo.value, str(shape))


def test_conv_operator_trans_c5():
    """ROADMAP C5: at padding 0 the JAX layer declares 9 x 9 x 2 (162)
    and returns 5 x 5 x 2; the port refuses to build it, naming C5, and
    at padding (f-1)/2 = 1 both give 7 x 7 x 2."""
    def conf(d, pad):
        with d.model() as g:
            img = d.data("img", (4, 4, 1))
            flt = d.data("flt", 3 * 3 * 1 * 2)
            _out(d, "conv_operator", [img, flt], num_filters=2,
                 num_channels=1, filter_size=3, stride=2, padding=pad,
                 trans=True)
        return g.conf

    rng = np.random.default_rng(0)
    iv = rng.standard_normal((2, 4, 4, 1)).astype(np.float32)
    fv = rng.standard_normal((2, 18)).astype(np.float32)
    jnet = JNetwork(conf(jdsl, 0))
    assert jnet.specs["out"].dim == (9, 9, 2)
    jo = jnet.forward({}, {"img": jarg.non_seq(jnp.asarray(iv)),
                           "flt": jarg.non_seq(jnp.asarray(fv))},
                      outputs=["out"])[0]["out"]
    assert jo.value.shape == (2, 5, 5, 2)
    with pytest.raises(ValueError, match="C5"):
        TNetwork(conf(tdsl, 0))
    jnet, tnet = JNetwork(conf(jdsl, 1)), TNetwork(conf(tdsl, 1))
    assert jnet.specs["out"].dim == tnet.specs["out"].dim == (7, 7, 2)
    jo = jnet.forward({}, {"img": jarg.non_seq(jnp.asarray(iv)),
                           "flt": jarg.non_seq(jnp.asarray(fv))},
                      outputs=["out"])[0]["out"]
    to = tnet.forward({}, {"img": targ.non_seq(iv), "flt": targ.non_seq(fv)},
                      outputs=["out"])[0]["out"]
    assert to.value.shape == jo.value.shape == (2, 7, 7, 2)
    _close(to.value.numpy(), jo.value)


def _nce_conf(dsl, neg_dist):
    with dsl.model() as g:
        a, b = dsl.data("a", D), dsl.data("b", D)
        lab = dsl.data("lab7", 1, is_ids=True)
        _out(dsl, "nce", [a, b, lab], bias=True, num_classes=7,
             num_neg_samples=5, neg_distribution=neg_dist)
    return g.conf


@pytest.mark.parametrize("neg_dist", [None, [0.3, 0.1, 0.1, 0.2, 0.1, 0.1,
                                             0.1]])
def test_nce_cost_on_jax_negatives(neg_dist):
    """The JAX layer's eval-mode cost equals the port's `nce_cost` on the
    negatives `jax.random.categorical(jax.random.key(0), ...)` draws
    (the JAX layer's own eval draw), and so do the gradients."""
    feeds = _feeds()
    jnet = JNetwork(_nce_conf(jdsl, neg_dist))
    params = _params(jnet, 2)
    layer = TNetwork(_nce_conf(tdsl, neg_dist)).layers["out"]
    logq_t = tsampling.nce_logq(layer.conf.attrs)
    neg = np.asarray(jax.random.categorical(
        jax.random.key(0), jnp.asarray(logq_t.numpy()), shape=(B, 5)))
    jp = {k: jnp.asarray(v) for k, v in params.items()}

    def jcost(p):
        feed = {n: _jarg(*feeds[n]) for n in ("a", "b", "lab7")}
        return jnet.forward(p, feed, outputs=["out"])[0]["out"].value

    jo = jcost(jp)
    r = np.random.default_rng(5).standard_normal(B).astype(np.float32)
    jg = jax.grad(lambda p: jnp.sum(jcost(p) * r))(jp)
    tp = {k: torch.tensor(v, requires_grad=True) for k, v in params.items()}
    names = layer.conf.inputs
    ws = [tp[f"_out.w{i}"] for i in range(2)]
    assert [ic.name for ic in names] == ["a", "b", "lab7"]
    to = tsampling.nce_cost(
        [torch.tensor(feeds["a"][1]), torch.tensor(feeds["b"][1])],
        torch.tensor(feeds["lab7"][1]), ws, tp["_out.wbias"],
        torch.tensor(neg), logq_t)
    _close(to.detach().numpy(), jo, "cost")
    (to * torch.from_numpy(r)).sum().backward()
    for k, g in jg.items():
        _close(tp[k].grad.numpy(), g, k)


def test_nce_layer_draws_its_eval_negatives_from_a_fixed_key():
    """Eval mode: the same cost twice (the fixed key); training: the cost
    depends on the (step, layer) key and repeats for the same key."""
    feeds = _feeds()
    net = TNetwork(_nce_conf(tdsl, None))
    params = {k: torch.tensor(v) for k, v in _params(
        JNetwork(_nce_conf(jdsl, None)), 2).items()}
    feed = {n: _targ(*feeds[n]) for n in ("a", "b", "lab7")}

    def cost(train, seed=None):
        key = None if seed is None else trng.StepKey(torch.tensor(seed))
        return net.forward(params, feed, train=train, rng=key,
                           outputs=["out"])[0]["out"].value

    assert torch.equal(cost(False), cost(False))
    assert torch.equal(cost(True, 11), cost(True, 11))
    assert not torch.equal(cost(True, 11), cost(True, 12))


def test_nce_sampler_frequencies():
    """20 000 x 5 draws from the port's sampler against neg_distribution
    (and the uniform one): every class within 5 standard errors; the same
    draws for the same (step, layer) key."""
    q = np.asarray([0.3, 0.05, 0.1, 0.25, 0.1, 0.1, 0.1])
    for attrs, want in (({"num_classes": 7, "neg_distribution": q}, q),
                        ({"num_classes": 7}, np.full(7, 1 / 7))):
        logq = tsampling.nce_logq(attrs)
        key = TCtx(train=True, rng=trng.StepKey(torch.tensor(5))).split("n")
        neg = tsampling.nce_sample(key, logq, 20000, 5)
        again = tsampling.nce_sample(
            TCtx(train=True, rng=trng.StepKey(torch.tensor(5))).split("n"),
            logq, 20000, 5)
        assert torch.equal(neg, again)
        n = neg.numel()
        freq = np.bincount(neg.numpy().ravel(), minlength=7) / n
        se = np.sqrt(want * (1 - want) / n)
        assert (np.abs(freq - want) < 5 * se).all(), (freq, want)


def test_sampling_id_frequencies():
    """sampling_id on 4 rows of 20 000 timesteps: each row's id
    frequencies within 5 standard errors of its probabilities (the
    layer clamps at 1e-20 and renormalises, as the JAX layer's log)."""
    rng = np.random.default_rng(9)
    p = rng.dirichlet(np.ones(D), 4).astype(np.float32)
    p[0, 2] = 0.0
    n = 20000
    value = np.broadcast_to(p[:, None, :], (4, n, D)).copy()

    def conf(d):
        with d.model() as g:
            x = d.data("p", D, is_seq=True)
            _out(d, "sampling_id", [x])
        return g.conf

    net = TNetwork(conf(tdsl))
    key = trng.StepKey(torch.tensor(3))
    feed = {"p": targ.seq(value, np.full(4, n, np.int32))}
    ids = net.forward({}, feed, rng=key, outputs=["out"])[0]["out"].ids
    assert ids.shape == (4, n)
    again = net.forward({}, feed, rng=key, outputs=["out"])[0]["out"].ids
    assert torch.equal(ids, again)
    for row in range(4):
        want = p[row] / p[row].sum()
        freq = np.bincount(ids[row].numpy(), minlength=D) / n
        se = np.sqrt(want * (1 - want) / n) + 1e-12
        assert (np.abs(freq - want) <= 5 * se).all(), (row, freq, want)
    assert (ids[0] != 2).all()
    # the JAX layer needs a key too, and gives ids of the same shape
    jo = JNetwork(conf(jdsl)).forward(
        {}, {"p": jarg.seq(jnp.asarray(value[:, :5]),
                           jnp.full(4, 5, jnp.int32))},
        rng=jax.random.key(0), outputs=["out"])[0]["out"]
    assert jo.ids.shape == (4, 5)


def test_print_prints_and_refuses_a_capture(capsys, monkeypatch):
    """The print layer prints `<name>: <value>` eagerly; on a CUDA tensor
    inside a capture it raises, naming itself (the capture is faked: no
    card here)."""
    _run("print")
    assert "out: [[" in capsys.readouterr().out
    layer = TNetwork(_conf(tdsl, "print")).layers["out"]

    class OnCard:
        is_cuda = True

    monkeypatch.setattr(torch.cuda, "is_current_stream_capturing",
                        lambda: True)
    with pytest.raises(RuntimeError, match="print layer 'out'.*capture"):
        layer.forward({}, [targ.Arg(value=OnCard())], TCtx())
    assert capsys.readouterr().out == ""


def test_jax_ctx_split_names_the_layer():
    """The sampling layers split their key by layer name in both packages
    (the JAX Ctx needs a key in training, as the port's)."""
    with pytest.raises(AssertionError):
        JCtx(train=True).split("x")
    with pytest.raises(AssertionError):
        TCtx(train=True).split("x")
