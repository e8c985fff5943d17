"""The port's evaluators (`paddle_tpu_torch/evaluators.py`) against the
JAX package's, on the CPU.

Every registered type is fed the same numpy outputs and feed (made from
a seed) through the JAX evaluator (JAX arrays in JAX Args) and the
port's (torch tensors in port Args) over 3 batches. Their results agree
to rtol 1e-6, and exactly where both count integers (classification
errors, precision/recall counts, edit distances, chunk counts). The
printers emit the same lines. Both registries hold the same 16 names.
"""

import numpy as np
import pytest
import torch

try:  # the parity tests need JAX
    import jax.numpy as jnp

    from paddle_tpu import evaluators as jev
    from paddle_tpu.core import arg as jarg
    from paddle_tpu.core.registry import EVALUATORS as JEVALUATORS
except ImportError:
    jnp = None

from paddle_tpu_torch import evaluators as tev
from paddle_tpu_torch.core import arg as targ
from paddle_tpu_torch.core.registry import EVALUATORS as TEVALUATORS
from paddle_tpu_torch.ops.ctc import ctc_greedy_decode

pytestmark = pytest.mark.skipif(jnp is None, reason="needs JAX (CPU parity)")

RTOL = 1e-6
N_BATCHES = 3
B, T, C = 6, 7, 5


def _jarg(d):
    return jarg.Arg(**{k: None if v is None else jnp.asarray(v)
                       for k, v in d.items()})


def _targ(d):
    return targ.Arg(**{k: None if v is None else torch.from_numpy(v)
                       for k, v in d.items()})


def _lens(rng, b=B, t=T, low=1):
    return rng.integers(low, t + 1, b).astype(np.int32)


def _chunk_labels(rng, b, t):
    # IOB over 3 chunk types: tags 0..5, the "other" label 6
    return rng.integers(0, 7, (b, t)).astype(np.int32)


def _batch(kind, rng):
    """(outs, feed) of numpy field dicts for evaluator `kind`."""
    if kind in ("classification_error", "precision_recall",
                "classification_error_printer", "max_id_printer"):
        return ({"pred": {"value": rng.standard_normal((B, C))
                          .astype(np.float32)}},
                {"label": {"ids": rng.integers(0, C, B).astype(np.int32)}})
    if kind in ("seq_classification_error", "seq_classification_error_pr",
                "max_frame_printer", "sum_seq"):
        lens = _lens(rng)
        return ({"pred": {"value": rng.standard_normal((B, T, C))
                          .astype(np.float32), "seq_lens": lens}},
                {"label": {"ids": rng.integers(0, C, (B, T))
                           .astype(np.int32), "seq_lens": lens}})
    if kind in ("sum", "column_sum", "value_printer", "gradient_printer"):
        return ({"pred": {"value": rng.standard_normal((B, C))
                          .astype(np.float32)}}, {})
    if kind == "pnpair":
        return ({"pred": {"value": rng.standard_normal((B, 1))
                          .astype(np.float32)}},
                {"label": {"ids": rng.integers(0, 3, B).astype(np.int32)},
                 "qid": {"ids": rng.integers(0, 2, B).astype(np.int32)}})
    if kind == "rankauc":
        return ({"pred": {"value": rng.random((B, 2)).astype(np.float32)}},
                {"label": {"ids": rng.integers(0, 2, B).astype(np.int32)}})
    if kind == "chunk":
        lens = _lens(rng)
        return ({"pred": {"ids": _chunk_labels(rng, B, T),
                          "seq_lens": lens}},
                {"label": {"ids": _chunk_labels(rng, B, T),
                           "seq_lens": lens}})
    if kind == "ctc_edit_distance":
        lens = _lens(rng, low=2)
        llens = rng.integers(0, 4, B).astype(np.int32)
        return ({"pred": {"value": rng.standard_normal((B, T, C))
                          .astype(np.float32), "seq_lens": lens}},
                {"label": {"ids": rng.integers(1, C, (B, 4))
                           .astype(np.int32), "seq_lens": llens}})
    if kind == "seq_text_printer":
        lens = _lens(rng)
        return ({"pred": {"ids": rng.integers(0, 4, (B, T))
                          .astype(np.int32), "seq_lens": lens}}, {})
    if kind == "detection_map":
        g = 3
        boxes = rng.random((B, g, 4)).astype(np.float32)
        boxes[..., 2:] = boxes[..., :2] + 0.3
        det = np.zeros((B, 4, 6), np.float32)
        det[..., 0] = rng.integers(1, 3, (B, 4))
        det[..., 1] = rng.random((B, 4)) * (rng.random((B, 4)) > 0.2)
        det[..., 2:4] = boxes[:, [0, 1, 2, 0], :2] + 0.05 * rng.standard_normal(
            (B, 4, 2))
        det[..., 4:] = det[..., 2:4] + 0.3
        return ({"pred": {"value": det.reshape(B, -1)}},
                {"label": {"value": boxes,
                           "seq_lens": rng.integers(1, g + 1, B)
                           .astype(np.int32)},
                 "glabel": {"ids": rng.integers(1, 3, (B, g))
                            .astype(np.int32)}})
    raise KeyError(kind)


# (registered type, conf beyond type/name, which batch maker)
CASES = [
    ("classification_error", {"input": "pred", "label": "label"},
     "classification_error"),
    ("classification_error", {"input": "pred", "label": "label",
                              "top_k": 2}, "classification_error"),
    ("classification_error", {"input": "pred", "label": "label"},
     "seq_classification_error"),
    ("sum", {"input": "pred"}, "sum"),
    ("sum", {"input": "pred"}, "sum_seq"),
    ("column_sum", {"input": "pred"}, "column_sum"),
    ("precision_recall", {"input": "pred", "label": "label"},
     "precision_recall"),
    ("precision_recall", {"input": "pred", "label": "label",
                          "positive_label": 1}, "precision_recall"),
    ("precision_recall", {"input": "pred", "label": "label"},
     "seq_classification_error"),
    ("pnpair", {"input": "pred", "label": "label", "query_id": "qid"},
     "pnpair"),
    ("rankauc", {"input": "pred", "label": "label"}, "rankauc"),
    ("seq_classification_error", {"input": "pred", "label": "label"},
     "seq_classification_error"),
    ("chunk", {"input": "pred", "label": "label", "chunk_scheme": "IOB",
               "num_chunk_types": 3}, "chunk"),
    ("chunk", {"input": "pred", "label": "label", "chunk_scheme": "IOB",
               "num_chunk_types": 3, "excluded_chunk_types": [1]}, "chunk"),
    ("ctc_edit_distance", {"input": "pred", "label": "label"},
     "ctc_edit_distance"),
    ("detection_map", {"input": "pred", "label": "label",
                       "label_ids": "glabel"}, "detection_map"),
    ("detection_map", {"input": "pred", "label": "label",
                       "label_ids": "glabel", "ap_type": "integral"},
     "detection_map"),
    ("value_printer", {"input": "pred"}, "value_printer"),
    ("gradient_printer", {"input": "pred"}, "gradient_printer"),
    ("max_id_printer", {"input": "pred"}, "max_id_printer"),
    ("max_frame_printer", {"input": "pred"}, "max_frame_printer"),
    ("seq_text_printer", {"input": "pred"}, "seq_text_printer"),
    ("classification_error_printer", {"input": "pred", "label": "label"},
     "classification_error_printer"),
]


def _assert_same(got, want, where):
    if isinstance(want, dict):
        assert got.keys() == want.keys(), where
        for k in want:
            _assert_same(got[k], want[k], f"{where}.{k}")
    elif want is None:
        assert got is None, where
    elif isinstance(want, (int, np.integer)) and not isinstance(want, bool):
        assert got == want, where
    else:
        np.testing.assert_allclose(np.asarray(got, np.float64),
                                   np.asarray(want, np.float64), rtol=RTOL,
                                   atol=0, err_msg=where)


def test_both_registries_hold_the_same_types():
    assert TEVALUATORS.names() == JEVALUATORS.names()
    assert len(TEVALUATORS.names()) == 16
    assert {c[0] for c in CASES} == set(TEVALUATORS.names())


@pytest.mark.parametrize("case", range(len(CASES)),
                         ids=[f"{c[0]}-{c[2]}-{i}" for i, c in
                              enumerate(CASES)])
def test_port_evaluator_matches_jax(case):
    kind, extra, maker = CASES[case]
    lines = {"jax": [], "port": []}
    conf = {"type": kind, "name": f"ev_{case}", **extra}
    jconf = {**conf, "printer": lines["jax"].append}
    tconf = {**conf, "printer": lines["port"].append}
    je, te = jev.create_evaluator(jconf), tev.create_evaluator(tconf)
    assert type(te).__name__ == type(je).__name__
    rng = np.random.default_rng(100 + case)
    for _ in range(N_BATCHES):
        outs, feed = _batch(maker, rng)
        je.add_batch({k: _jarg(v) for k, v in outs.items()},
                     {k: _jarg(v) for k, v in feed.items()})
        te.add_batch({k: _targ(v) for k, v in outs.items()},
                     {k: _targ(v) for k, v in feed.items()})
    want, got = je.result(), te.result()
    _assert_same(got, want, kind)
    assert lines["port"] == lines["jax"]
    if kind.endswith("printer"):
        assert len(lines["port"]) >= N_BATCHES


def test_integer_counts_are_exact():
    """Where both packages count integers the counters agree exactly."""
    rng = np.random.default_rng(7)
    conf = {"type": "precision_recall", "input": "pred", "label": "label"}
    je, te = jev.create_evaluator(conf), tev.create_evaluator(conf)
    ce = {"type": "classification_error", "input": "pred", "label": "label"}
    jc, tc = jev.create_evaluator(ce), tev.create_evaluator(ce)
    for _ in range(N_BATCHES):
        outs, feed = _batch("seq_classification_error", rng)
        for e, mk in ((je, _jarg), (te, _targ), (jc, _jarg), (tc, _targ)):
            e.add_batch({k: mk(v) for k, v in outs.items()},
                        {k: mk(v) for k, v in feed.items()})
    assert (te.tp, te.fp, te.fn) == (je.tp, je.fp, je.fn)
    assert (tc.wrong, tc.total) == (jc.wrong, jc.total)


def test_the_evaluators_read_tensors_of_the_trainers_outputs():
    """A port evaluator reads the tensors the train step keeps (torch,
    int64 ids, bf16 values under the cast rule read as f32) and numpy
    alike."""
    rng = np.random.default_rng(3)
    outs, feed = _batch("classification_error", rng)
    conf = {"type": "classification_error", "input": "pred",
            "label": "label"}
    a, b = tev.create_evaluator(conf), tev.create_evaluator(conf)
    a.add_batch({"pred": targ.Arg(value=torch.from_numpy(
        outs["pred"]["value"]))},
        {"label": targ.id_arg(feed["label"]["ids"])})
    b.add_batch({"pred": targ.Arg(value=outs["pred"]["value"])},
                {"label": targ.Arg(ids=feed["label"]["ids"])})
    assert a.result() == b.result()


@pytest.mark.parametrize("blank", [0, C - 1])
def test_ctc_greedy_decode_matches_jax(blank):
    from paddle_tpu.ops.ctc import ctc_greedy_decode as jdecode

    rng = np.random.default_rng(blank)
    lp = rng.standard_normal((B, T, C)).astype(np.float32)
    # repeats and blanks on purpose
    lp[:, 1] = lp[:, 0]
    lp[:, 3, blank] = 10.0
    lens = np.asarray([7, 1, 0, 4, 6, 7], np.int32)
    jp, jl = jdecode(jnp.asarray(lp), jnp.asarray(lens), blank=blank)
    tp, tl = ctc_greedy_decode(torch.from_numpy(lp), torch.from_numpy(lens),
                               blank=blank)
    assert tp.dtype == torch.int32 and tl.dtype == torch.int32
    np.testing.assert_array_equal(tp.numpy(), np.asarray(jp))
    np.testing.assert_array_equal(tl.numpy(), np.asarray(jl))
