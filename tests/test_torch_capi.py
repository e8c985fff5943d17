"""The port's C inference ABI (`native/src/capi.cc` +
`capi_bridge.py`, built as `libpaddle_tpu_torch_capi.so`) against the
JAX package's (`libpaddle_tpu_capi.so`), on the CPU.

- The port's library builds from the port's own sources and exports
  the JAX library's `pt_capi_*` symbols.
- The four example programs (dense, sequence, sparse_binary,
  multi_thread), built with cc from the port's copy, run with
  `PADDLE_TPU_FORCE_CPU=1` on the same merged models (written by the
  JAX package) against both libraries: outputs equal at the printed
  `%.6f` (atol 1e-6). The JAX package's own copy of an example runs
  against the port's library unchanged.
- In-process use through `ctypes` (`pt_capi_init` reuses the running
  interpreter), the error text for a bad path and for a missing card.
- The `_slot_to_arg` unit cases of `tests/test_serving_cli.py`.

Every C program is joined with its own timeout.
"""

import ctypes
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from paddle_tpu import dsl as jdsl
from paddle_tpu.core.arg import id_arg as jid_arg
from paddle_tpu.core.arg import non_seq as jnon_seq
from paddle_tpu.models.text import stacked_lstm_classifier
from paddle_tpu.network import Network as JNetwork
from paddle_tpu.trainer import checkpoint as jckpt
from paddle_tpu.trainer.trainer import Inferencer as JInferencer
from paddle_tpu_torch import capi_bridge as cb
from paddle_tpu_torch import native

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
JAX_NATIVE = os.path.join(REPO, "paddle_tpu", "native")
PROC_TIMEOUT = 180
EXAMPLES = ("dense", "sequence", "sparse_binary", "multi_thread")


def _jax_lib():
    lib = os.path.join(JAX_NATIVE, "lib", "libpaddle_tpu_capi.so")
    if not os.path.exists(lib):
        r = subprocess.run(["make", "-C", JAX_NATIVE, "capi"],
                           capture_output=True, text=True,
                           timeout=PROC_TIMEOUT)
        assert r.returncode == 0, r.stderr
    return lib


def _dense_model(path):
    with jdsl.model() as g:
        x = jdsl.data("x", 8)
        y = jdsl.data("y", 1, is_ids=True)
        h = jdsl.fc(x, size=16, act="tanh")
        out = jdsl.fc(h, size=3, name="output")
        jdsl.classification_cost(out, y, name="cost")
    net = JNetwork(g.conf)
    params = net.init_params(jax.random.key(3))
    jckpt.merge_model(path, g.conf, params)
    return net, params


def _sequence_model(path):
    conf = stacked_lstm_classifier(vocab_size=20, emb_dim=8, hidden=8,
                                   num_layers=1, num_classes=2)
    net = JNetwork(conf)
    params = net.init_params(jax.random.key(5))
    jckpt.merge_model(path, conf, params)
    return net, params


@pytest.fixture(scope="module")
def models(tmp_path_factory):
    d = tmp_path_factory.mktemp("capi_models")
    dense, seq = str(d / "dense.npz"), str(d / "lstm.npz")
    return {"dense": (dense, *_dense_model(dense)),
            "sequence": (seq, *_sequence_model(seq))}


def _build(src, exe):
    r = subprocess.run(["cc", src, "-o", exe, "-ldl", "-lpthread"],
                       capture_output=True, text=True, timeout=PROC_TIMEOUT)
    assert r.returncode == 0, r.stderr
    return exe


def _run_all(cmds):
    """Start every command at once, each joined with its own timeout;
    returns their stdout. A hung program is killed and fails the test
    with its stderr."""
    env = dict(os.environ, PADDLE_TPU_FORCE_CPU="1")
    env.pop("JAX_PLATFORMS", None)
    procs = [subprocess.Popen(c, stdout=subprocess.PIPE,
                              stderr=subprocess.PIPE, text=True, env=env)
             for c in cmds]
    outs = []
    try:
        for c, p in zip(cmds, procs):
            try:
                out, err = p.communicate(timeout=PROC_TIMEOUT)
            except subprocess.TimeoutExpired:
                p.kill()
                out, err = p.communicate()
                pytest.fail(f"{c} hung:\n{err[-3000:]}")
            assert p.returncode == 0, (c, out, err[-3000:])
            outs.append(out)
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    return outs


def test_port_library_builds_from_its_own_sources():
    lib = native.build_capi()
    assert lib == os.path.join(REPO, "paddle_tpu_torch", "build", "native",
                               "libpaddle_tpu_torch_capi.so")
    nm = subprocess.run(["nm", "-D", "--defined-only", lib],
                        capture_output=True, text=True, timeout=60).stdout
    syms = {ln.split()[-1] for ln in nm.splitlines()
            if ln.split()[-1].startswith("pt_capi_")}
    assert syms == {"pt_capi_init", "pt_capi_create", "pt_capi_output_dim",
                    "pt_capi_forward", "pt_capi_forward_slots",
                    "pt_capi_destroy", "pt_capi_error"}
    src = open(os.path.join(REPO, "paddle_tpu_torch", "native", "src",
                            "capi.cc")).read()
    assert '"paddle_tpu_torch.capi_bridge"' in src


def _floats(out):
    return np.asarray([float(x) for x in out.split()], np.float64)


@pytest.mark.parametrize("name", EXAMPLES)
def test_example_equal_across_the_two_libraries(tmp_path, models, name):
    exe = _build(os.path.join(native.EXAMPLES_DIR, name, "main.c"),
                 str(tmp_path / f"ex_{name}"))
    model = models["sequence" if name == "sequence" else "dense"]
    args = [model[0], "output"] + (["8"] if name == "sparse_binary" else [])
    port, jax_ = _run_all([[exe, native.build_capi(), REPO, *args],
                           [exe, _jax_lib(), REPO, *args]])
    if name == "multi_thread":
        assert port.strip() == jax_.strip() == "OK"
        return
    got, want = _floats(port), _floats(jax_)
    assert got.size == want.size > 0
    np.testing.assert_allclose(got, want, atol=1e-6, rtol=0)
    # and against the JAX Inferencer on the same feed
    net, params = model[1], model[2]
    inf = JInferencer(net, params, outputs=["output"])
    if name == "sequence":
        ids = np.zeros((2, 5), np.int32)
        ids[0] = [13, 8, 2, 14, 9]
        ids[1, :4] = [7, 3, 14, 5]
        feed = {"words": jid_arg(ids, np.asarray([5, 4], np.int32))}
    else:
        x = (np.arange(16, dtype=np.float32) / 16.0).reshape(2, 8)
        if name == "sparse_binary":
            x = np.zeros((2, 8), np.float32)
            x[0, [1, 3]] = 1.0
            x[1, [0, 5, 6]] = 1.0
        feed = {"x": jnon_seq(jnp.asarray(x))}
    ref = np.asarray(inf.infer(feed)["output"]).ravel()
    np.testing.assert_allclose(got, ref, atol=1e-5)


def test_jax_built_program_runs_against_the_port_library(tmp_path, models):
    exe = _build(os.path.join(JAX_NATIVE, "examples", "model_inference",
                              "dense", "main.c"), str(tmp_path / "jax_dense"))
    (port,) = _run_all([[exe, native.build_capi(), REPO, models["dense"][0],
                         "output"]])
    x = (np.arange(16, dtype=np.float32) / 16.0).reshape(2, 8)
    net, params = models["dense"][1], models["dense"][2]
    ref = np.asarray(JInferencer(net, params, outputs=["output"]).infer(
        {"x": jnon_seq(jnp.asarray(x))})["output"]).ravel()
    np.testing.assert_allclose(_floats(port), ref, atol=1e-5)


@pytest.fixture(scope="module")
def so():
    lib = ctypes.CDLL(native.build_capi())
    lib.pt_capi_init.argtypes = [ctypes.c_char_p]
    lib.pt_capi_create.restype = ctypes.c_int64
    lib.pt_capi_create.argtypes = [ctypes.c_char_p, ctypes.c_char_p]
    lib.pt_capi_output_dim.restype = ctypes.c_int64
    lib.pt_capi_output_dim.argtypes = [ctypes.c_int64]
    lib.pt_capi_error.restype = ctypes.c_char_p
    lib.pt_capi_forward_slots.argtypes = [
        ctypes.c_int64, ctypes.c_void_p, ctypes.c_int,
        ctypes.POINTER(ctypes.c_float), ctypes.c_int64,
        ctypes.POINTER(ctypes.c_int64)]
    lib.pt_capi_destroy.argtypes = [ctypes.c_int64]
    assert lib.pt_capi_init(REPO.encode()) == 0, lib.pt_capi_error()
    return lib


def test_in_process_through_ctypes(so, models, monkeypatch):
    monkeypatch.setenv("PADDLE_TPU_FORCE_CPU", "1")
    h = so.pt_capi_create(models["sequence"][0].encode(), b"output")
    assert h > 0, so.pt_capi_error()
    assert so.pt_capi_output_dim(h) == 2
    flat = np.ascontiguousarray([13, 8, 2, 14, 9, 7, 3, 14, 5], np.int32)
    pos = np.ascontiguousarray([0, 5, 9], np.int32)
    s = cb.Slot(name=b"words", kind=2,
             buf=flat.ctypes.data_as(ctypes.c_void_p),
             seq_pos=pos.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
             n_seq=3)
    out = (ctypes.c_float * 64)()
    oshape = (ctypes.c_int64 * 8)()
    assert so.pt_capi_forward_slots(h, ctypes.byref(s), 1, out, 64,
                                    oshape) == 2
    assert list(oshape[:2]) == [2, 2]
    # the handle lives in this interpreter's bridge: the same Inferencer
    inf = cb._HANDLES[h]
    assert inf.device.type == "cpu"
    ids = np.zeros((2, 5), np.int32)
    ids[0] = [13, 8, 2, 14, 9]
    ids[1, :4] = [7, 3, 14, 5]
    from paddle_tpu_torch.core.arg import id_arg

    want = inf.infer({"words": id_arg(ids, np.asarray([5, 4]))})["output"]
    np.testing.assert_array_equal(np.asarray(out[:4]), want.ravel())
    # a buffer too small is an error, not a partial write
    assert so.pt_capi_forward_slots(h, ctypes.byref(s), 1, out, 3,
                                    oshape) == -1
    assert "caller buffer has 3" in so.pt_capi_error().decode()
    so.pt_capi_destroy(h)
    assert h not in cb._HANDLES


def test_error_text_for_a_bad_path_and_no_card(so, models, monkeypatch):
    monkeypatch.setenv("PADDLE_TPU_FORCE_CPU", "1")
    assert so.pt_capi_create(b"/nonexistent/model.npz", b"output") == 0
    msg = so.pt_capi_error().decode()
    assert msg.startswith("create failed") and "nonexistent" in msg
    # no PADDLE_TPU_FORCE_CPU: the model goes to the card, and without
    # one create fails naming why — never a quiet CPU
    monkeypatch.delenv("PADDLE_TPU_FORCE_CPU")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    assert so.pt_capi_create(models["dense"][0].encode(), b"output") == 0
    assert "no CUDA device" in so.pt_capi_error().decode()


# ---- _slot_to_arg (tests/test_serving_cli.py::TestBridgeSlots) ------------

def _addr(a):
    return a.ctypes.data


def _slot(**kw):
    base = dict(name="x", kind=0, buf=0, shape=[], seq_pos=0, n_seq=0,
                subseq_pos=0, n_subseq=0, width=0, rows=0, cols=0, vals=0,
                height=0, nnz=0)
    base.update(kw)
    return base


def test_nested_sequence_slot():
    ids = np.asarray([1, 2, 3, 4, 5, 6, 7], np.int32)
    pos = np.asarray([0, 4, 7], np.int32)
    sub = np.asarray([0, 2, 4, 7], np.int32)
    arg = cb._slot_to_arg(_slot(kind=2, buf=_addr(ids), seq_pos=_addr(pos),
                                n_seq=3, subseq_pos=_addr(sub), n_subseq=4))
    assert arg.has_subseq
    np.testing.assert_array_equal(arg.subseq_lens.numpy(), [[2, 2], [3, 0]])
    np.testing.assert_array_equal(arg.seq_lens.numpy(), [4, 3])
    np.testing.assert_array_equal(arg.ids.numpy(),
                                  [[1, 2, 3, 4], [5, 6, 7, 0]])
    assert arg.ids.dtype == torch.int64


def test_malformed_subseq_rejected():
    ids = np.asarray([1, 2, 3, 4, 5, 6, 7], np.int32)
    pos = np.asarray([0, 4, 7], np.int32)
    sub = np.asarray([0, 2, 7], np.int32)
    with pytest.raises(ValueError, match="sequence boundary"):
        cb._slot_to_arg(_slot(kind=2, buf=_addr(ids), seq_pos=_addr(pos),
                              n_seq=3, subseq_pos=_addr(sub), n_subseq=3))


def test_sparse_float_slot():
    rows = np.asarray([0, 2, 3], np.int32)
    cols = np.asarray([1, 4, 0], np.int32)
    vals = np.asarray([0.5, -2.0, 3.0], np.float32)
    arg = cb._slot_to_arg(_slot(kind=5, rows=_addr(rows), cols=_addr(cols),
                                vals=_addr(vals), height=2, width=6, nnz=3))
    want = np.zeros((2, 6), np.float32)
    want[0, 1], want[0, 4], want[1, 0] = 0.5, -2.0, 3.0
    np.testing.assert_array_equal(arg.value.numpy(), want)


@pytest.mark.parametrize("bad", [[1, -1, 0], [1, 6, 0]])
def test_sparse_bad_cols_rejected(bad):
    rows = np.asarray([0, 2, 3], np.int32)
    vals = np.asarray([1.0, 2.0, 3.0], np.float32)
    cols = np.asarray(bad, np.int32)
    with pytest.raises(ValueError, match="col indices"):
        cb._slot_to_arg(_slot(kind=5, rows=_addr(rows), cols=_addr(cols),
                              vals=_addr(vals), height=2, width=6, nnz=3))


@pytest.mark.parametrize("bad", [[0, 3, 2], [0, 2, 2], [1, 2, 3]])
def test_sparse_bad_rows_rejected(bad):
    cols = np.asarray([1, 4, 0], np.int32)
    vals = np.asarray([1.0, 2.0, 3.0], np.float32)
    rows = np.asarray(bad, np.int32)
    with pytest.raises(ValueError, match="row offsets"):
        cb._slot_to_arg(_slot(kind=5, rows=_addr(rows), cols=_addr(cols),
                              vals=_addr(vals), height=2, width=6, nnz=3))


def test_seq_dense_slot():
    flat = np.arange(10, dtype=np.float32).reshape(5, 2)
    pos = np.asarray([0, 3, 5], np.int32)
    arg = cb._slot_to_arg(_slot(kind=3, buf=_addr(flat), seq_pos=_addr(pos),
                                n_seq=3, width=2))
    assert tuple(arg.value.shape) == (2, 3, 2)
    np.testing.assert_array_equal(arg.seq_lens.numpy(), [3, 2])
    np.testing.assert_array_equal(arg.value[1].numpy(),
                                  [[6, 7], [8, 9], [0, 0]])


def test_dense_ids_and_bad_kind_slots():
    ids = np.asarray([[3, 1], [4, 1]], np.int32)
    arg = cb._slot_to_arg(_slot(kind=1, buf=_addr(ids), shape=[2, 2]))
    np.testing.assert_array_equal(arg.ids.numpy(), ids)
    x = np.arange(6, dtype=np.float32)
    arg = cb._slot_to_arg(_slot(kind=0, buf=_addr(x), shape=[2, 3]))
    np.testing.assert_array_equal(arg.value.numpy(), x.reshape(2, 3))
    with pytest.raises(ValueError, match="unknown slot kind"):
        cb._slot_to_arg(_slot(kind=9))
    with pytest.raises(ValueError, match="start positions"):
        cb._slot_to_arg(_slot(kind=2))
    assert sys.modules["paddle_tpu_torch.capi_bridge"] is cb
