"""The port's sequence-structure layers against the JAX package's, on
the CPU.

Every type and level `layers/sequence.py` gained with nested sequences
— seqpool strided, at the sub-sequence level (nested and plain) and
with `output_max_index`; seqlastins strided and per sub-sequence;
expand over a nested reference; seqconcat, seqreshape, seqreverse,
slice, padding, crop, rotate, subseq and sub_nested_seq under every
registered name — is built once through `paddle_tpu.dsl` and once
through the port's copy, and both run on the same numpy feed (seeded;
lengths with a 0, a 1, a row at the full T, a zero-length
sub-sequence mid-row and an all-zero `subseq_lens` column). The output
within 1e-5 (atol), lengths and ids exactly, and the gradient of a
seeded random projection of the output with respect to every float
input within 1e-5. The edge cases the JAX docstrings name have cases
of their own: an offset at or past the end (subseq), -1 sentinels and
selections past the selection's length (sub_nested_seq).

`seqpool` at the sub-sequence level with `first` reads a padded
sub-sequence that starts at T: the JAX gather fills NaN there, the port
reads step T-1. Only real sub-sequences are compared in that case.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from paddle_tpu import dsl as jdsl
from paddle_tpu.core import arg as jarg
from paddle_tpu.network import Network as JNetwork
from paddle_tpu_torch import dsl as tdsl
from paddle_tpu_torch.core import arg as targ
from paddle_tpu_torch.core.registry import LAYERS
from paddle_tpu_torch.network import Network as TNetwork

TOL = 1e-5
B, T, D, S = 4, 12, 4, 5
LENS = np.asarray([12, 0, 1, 7], np.int32)
# a zero-length sub-sequence mid-row, a row that fills T (its last
# sub-sequence ends at T-1), an empty row, and an all-zero last column
SUB = np.asarray([[3, 0, 2, 4, 0],
                  [1, 4, 2, 5, 0],
                  [2, 2, 0, 0, 0],
                  [0, 0, 0, 0, 0]], np.int32)
IMG = (5, 6, 3)


def _feeds(seed=0):
    """{name: (kind, value, lens)} numpy inputs, padding zeroed."""
    rng = np.random.default_rng(seed)

    def seq(t, lens, d=D):
        v = rng.standard_normal((B, t, d)).astype(np.float32)
        return v * (np.arange(t)[None, :, None] < lens[:, None, None])

    other_lens = np.asarray([3, 5, 0, 2], np.int32)
    n_sub = (SUB > 0).sum(axis=1).astype(np.int32)
    return {
        "x": ("seq", seq(T, LENS), LENS),
        "y": ("seq", seq(6, other_lens), other_lens),
        "n": ("nested", seq(T, SUB.sum(axis=1)), SUB),
        # one frame per sub-sequence slot of n (expand's source)
        "v": ("seq", seq(S, n_sub), n_sub),
        "img": ("nonseq", rng.standard_normal((B,) + IMG).astype(
            np.float32), None),
        "img_small": ("nonseq", rng.standard_normal((B, 3, 4, 3)).astype(
            np.float32), None),
        "flat": ("nonseq", rng.standard_normal((B, 24)).astype(np.float32),
                 None),
        # subseq: an offset inside, one on an empty row, one at the end
        # of its row, one whose size runs past the end
        "off": ("ids", np.asarray([2, 0, 1, 5], np.int32), None),
        "size": ("ids", np.asarray([4, 3, 2, 9], np.int32), None),
        # sub_nested_seq: -1 sentinels and slots past the selection's
        # own length select nothing
        "sel": ("ids_seq", np.asarray([[2, 0, -1], [3, 1, 0], [1, -1, 4],
                                       [0, 0, 0]], np.int32),
                np.asarray([2, 3, 3, 1], np.int32)),
    }


def _jarg(kind, v, lens):
    if kind == "seq":
        return jarg.seq(jnp.asarray(v), lens)
    if kind == "nested":
        return jarg.sub_seq(jnp.asarray(v), lens)
    if kind == "nonseq":
        return jarg.non_seq(jnp.asarray(v))
    return jarg.id_arg(jnp.asarray(v), lens)


def _targ(kind, v, lens):
    if kind == "seq":
        return targ.seq(v, lens)
    if kind == "nested":
        return targ.sub_seq(v, lens)
    if kind == "nonseq":
        return targ.non_seq(v)
    return targ.id_arg(v, lens)


def _data(dsl, name):
    kind, v, _ = _feeds()[name]
    if kind == "nonseq":
        return dsl.data(name, v.shape[1:])
    if kind in ("ids", "ids_seq"):
        return dsl.data(name, 1, is_ids=True, is_seq=kind == "ids_seq")
    return dsl.data(name, v.shape[2:], is_seq=True,
                    has_subseq=kind == "nested")


def _window(dsl, type_, x):
    """A static slice of 5 steps from step 2 (`size` is an attr here,
    not the conf's width)."""
    ref = dsl._add(type_, [x], name="out", begin=2)
    dsl.current().conf.layer("out").attrs["size"] = 5
    return ref


POOLS = ("sum", "average", "sqrt_average", "max")
# case -> (inputs, build(dsl, *refs)) making the layer "out"
CASES = {
    **{f"seqpool_stride3_{p}": (
        ("x",), lambda d, x, p=p: d.seq_pool(x, p, stride=3, name="out"))
       for p in POOLS},
    **{f"seqpool_subseq_{p}": (
        ("n",), lambda d, n, p=p: d.seq_pool(n, p, level="subseq",
                                             name="out"))
       for p in POOLS + ("last", "first")},
    **{f"seqpool_subseq_plain_{p}": (
        ("x",), lambda d, x, p=p: d.seq_pool(x, p, level="subseq",
                                             name="out"))
       for p in POOLS},
    "seqpool_max_index": (
        ("x",), lambda d, x: d.seq_pool(x, "max", output_max_index=True,
                                        name="out")),
    "last_seq_stride3": (
        ("x",), lambda d, x: d.last_seq(x, stride=3, name="out")),
    "first_seq_stride3": (
        ("x",), lambda d, x: d.first_seq(x, stride=3, name="out")),
    "last_seq_subseq": (
        ("n",), lambda d, n: d.last_seq(n, level="subseq", name="out")),
    "first_seq_subseq": (
        ("n",), lambda d, n: d.first_seq(n, level="subseq", name="out")),
    "expand_nested": (
        ("v", "n"), lambda d, v, n: d.expand(v, n, level="seq",
                                             name="out")),
    "seqconcat": (("x", "y"), lambda d, x, y: d.seq_concat(x, y,
                                                           name="out")),
    "seqreshape": (
        ("x",), lambda d, x: d._add("seqreshape", [x], name="out", size=2)),
    **{t: (("x",), lambda d, x, t=t: d._add(t, [x], name="out"))
       for t in ("seqreverse", "sequence_reverse")},
    **{t: (("x",), lambda d, x, t=t: _window(d, t, x))
       for t in ("slice", "seq_slice")},
    **{t: (("img",), lambda d, i, t=t: d._add(
        t, [i], name="out", pad_c=(1, 2), pad_h=(0, 1), pad_w=(2, 0)))
       for t in ("padding", "pad")},
    "crop": (("img",), lambda d, i: d._add("crop", [i], name="out",
                                           crop_h=(1, 3), crop_w=(2, 4))),
    "crop_to_reference": (
        ("img", "img_small"), lambda d, i, r: d._add("crop", [i, r],
                                                     name="out")),
    "rotate": (("flat",), lambda d, f: d._add("rotate", [f], name="out",
                                              height=3, width=4)),
    **{t: (("x", "off", "size"), lambda d, x, o, s, t=t: d._add(
        t, [x, o, s], name="out", bias=False))
       for t in ("subseq", "sub_seq")},
    "sub_nested_seq": (("n", "sel"), lambda d, n, s: d.sub_nested_seq(
        n, s, name="out")),
}
# the new registry names, each reached by a case above (gen_output by
# its own test)
NEW_TYPES = {"seqconcat", "seqreshape", "seqreverse", "sequence_reverse",
             "slice", "seq_slice", "padding", "pad", "crop", "rotate",
             "gen_output", "subseq", "sub_seq", "sub_nested_seq"}


def _conf(dsl, case):
    names, build = CASES[case]
    with dsl.model() as g:
        build(dsl, *[_data(dsl, n) for n in names])
    return g.conf


def _only_real(case, out):
    """The positions compared: all, but for the padded sub-sequences of
    the `first` pool (module docstring)."""
    if case != "seqpool_subseq_first":
        return None
    return (SUB > 0)[..., None] & np.ones(out.shape, bool)


def _run(case, seed=0):
    """(JAX out, port out, JAX grads, port grads) of `case`: the output
    Args and the gradients of sum(out * R) for a seeded R."""
    names, _ = CASES[case]
    feeds = {n: _feeds(seed)[n] for n in names}
    jnet, tnet = JNetwork(_conf(jdsl, case)), TNetwork(_conf(tdsl, case))
    floats = [n for n in names if feeds[n][0] in ("seq", "nested",
                                                  "nonseq")]

    def jout(vals):
        feed = {n: _jarg(*feeds[n]) for n in names}
        for n in floats:
            feed[n] = feed[n].with_value(vals[n])
        return jnet.forward({}, feed, outputs=["out"])[0]["out"]

    jvals = {n: jnp.asarray(feeds[n][1]) for n in floats}
    jo = jout(jvals)
    tvals = {n: torch.tensor(feeds[n][1], requires_grad=True)
             for n in floats}
    tfeed = {n: _targ(*feeds[n]) for n in names}
    for n in floats:
        tfeed[n] = tfeed[n].with_value(tvals[n])
    to = tnet.forward({}, tfeed, outputs=["out"])[0]["out"]
    jgrads = tgrads = None
    if jo.value is not None and to.value.requires_grad:
        real = _only_real(case, np.asarray(jo.value))
        r = np.random.default_rng(seed + 1).standard_normal(
            jo.value.shape).astype(np.float32)
        if real is not None:
            r = r * real
        jgrads = jax.grad(lambda v: jnp.sum(jnp.where(
            r != 0, jout(v).value, 0.0) * r))(jvals)
        (to.value * torch.from_numpy(r)).sum().backward()
        # an input the output does not depend on (crop's reference) has
        # no torch gradient, a zero JAX one
        tgrads = {n: torch.zeros_like(tvals[n]) if tvals[n].grad is None
                  else tvals[n].grad for n in floats}
    return jo, to, jgrads, tgrads


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
    got, want = to.value.detach().numpy(), np.asarray(jo.value)
    assert got.shape == want.shape
    real = _only_real(case, want)
    assert np.isfinite(got).all()
    if real is not None:
        got, want = got[real], want[real]
    np.testing.assert_allclose(got, want, rtol=TOL, atol=TOL)
    if jgrads is not None:
        for n, g in jgrads.items():
            np.testing.assert_allclose(tgrads[n].numpy(), np.asarray(g),
                                       rtol=TOL, atol=TOL, err_msg=n)


def test_every_new_type_is_registered_and_reached():
    reached = set()
    for case in CASES:
        reached |= {lc.type for lc in _conf(tdsl, case).layers}
    assert NEW_TYPES - {"gen_output"} <= reached
    assert NEW_TYPES <= set(LAYERS.names())


def test_edge_cases_read_as_the_docstrings_say():
    """subseq: the empty row and the offset at the end give empty
    sequences, the long size is clamped; sub_nested_seq: the -1 and the
    slot past the selection's length select nothing; strided pooling
    gives ceil(len / 3) frames."""
    _jo, to, _jg, _tg = _run("subseq")
    np.testing.assert_array_equal(to.seq_lens.numpy(), [4, 0, 0, 2])
    _jo, to, _jg, _tg = _run("sub_nested_seq")
    np.testing.assert_array_equal(to.subseq_lens.numpy(),
                                  [[2, 3, 0], [5, 4, 1], [2, 0, 0],
                                   [0, 0, 0]])
    _jo, to, _jg, _tg = _run("seqpool_stride3_max")
    np.testing.assert_array_equal(to.seq_lens.numpy(), [4, 0, 1, 3])
    assert to.value.shape == (B, 4, D)
    _jo, to, _jg, _tg = _run("seqpool_max_index")
    idx = to.value.numpy()
    assert idx.shape == (B, D) and (idx < np.maximum(LENS, 1)[:, None]).all()


def test_gen_output_forward_raises_in_both():
    def conf(dsl):
        with dsl.model() as g:
            x = dsl.data("x", D, is_seq=True)
            dsl._add("gen_output", [x], name="out")
        return g.conf

    feeds = _feeds()
    with pytest.raises(RuntimeError, match="beam"):
        JNetwork(conf(jdsl)).forward({}, {"x": _jarg(*feeds["x"])})
    tnet = TNetwork(conf(tdsl))
    assert tnet.specs["out"].is_ids and tnet.specs["out"].is_seq
    with pytest.raises(RuntimeError, match="beam"):
        tnet.forward({}, {"x": _targ(*feeds["x"])})


def test_sub_seq_arg_matches_jax():
    v = _feeds()["n"][1]
    ja, ta = jarg.sub_seq(jnp.asarray(v), SUB), targ.sub_seq(v, SUB)
    assert ta.has_subseq and ta.batch == B and ta.max_len == T
    assert ta.subseq_lens.dtype == torch.int32
    np.testing.assert_array_equal(ta.seq_lens.numpy(), np.asarray(ja.seq_lens))
    ids = targ.sub_seq(np.zeros((B, T), np.int32), SUB, is_ids=True)
    assert ids.ids.dtype == torch.int64 and ids.value is None
