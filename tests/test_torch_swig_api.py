"""The port's `py_paddle.swig_paddle` surface (`compat/swig_api.py`) and
`api.py` against the JAX package's, on the CPU.

- The Matrix / Vector / IVector / Arguments surface, case by case as
  the reference's api tests drive it (testMatrix, testVector,
  testArguments), each answer equal to the JAX package's.
- On a small LSTM classifier and a BN conv net, the JAX machine's
  parameters set into the port: `forward` in test and train mode,
  `backward` after a test-mode forward (train-mode gradients, the BN
  state left as it is), `forwardBackward` with the callback's order,
  the `ParameterBuffer` mirrors and write-through, `loadParameters` on
  files the JAX package wrote, three steps of `ParameterUpdater` and
  of `Trainer.trainOneDataBatch`, each against the JAX package's
  (rtol 1e-4, or 1e-4 of the largest entry).
- `DataProviderConverter` round trips against the JAX one.
- `api.GradientMachine`, `api.ParameterUpdater` and
  `api.SequenceGenerator` (a small attention NMT) against the JAX
  package's, and `api.create_config_generator` on a generating v1
  config (tokens exact).
- `initPaddle("--use_gpu=0")` and `setUseGpu(False)` select the CPU; a
  machine on the default device raises without a card.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from paddle_tpu import api as japi
from paddle_tpu import dsl as jdsl
from paddle_tpu.compat import swig_api as jswig
from paddle_tpu.compat.config_parser import parse_config as jparse
from paddle_tpu.core import arg as jarg
from paddle_tpu.core.config import OptimizationConf as JOpt
from paddle_tpu.data import feeder as jfeeder
from paddle_tpu.models import text as jtext
from paddle_tpu.network import Network as JNetwork
from paddle_tpu.trainer import checkpoint as jckpt
from paddle_tpu_torch import api as tapi
from paddle_tpu_torch import dsl as tdsl
from paddle_tpu_torch.compat import swig_api as tswig
from paddle_tpu_torch.compat.config_parser import parse_config as tparse
from paddle_tpu_torch.compat.py_paddle import DataProviderConverter
from paddle_tpu_torch.core import arg as targ
from paddle_tpu_torch.core.config import OptimizationConf as TOpt
from paddle_tpu_torch.data import feeder as tfeeder
from paddle_tpu_torch.models import text as ttext
from paddle_tpu_torch.weights import params_from_numpy, state_from_numpy
from py_paddle.dataprovider_converter import (
    DataProviderConverter as JConverter,
)

VOCAB, B = 30, 6


@pytest.fixture(autouse=True)
def cpu_default():
    """The port's machines default to the card: the tests here ask for
    the CPU through the reference's own flag, and put it back."""
    tswig.setUseGpu(False)
    yield
    tswig.setUseGpu(True)


def close(got, want, what=""):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert got.shape == want.shape, (what, got.shape, want.shape)
    tol = 1e-4 * max(1.0, float(np.abs(want).max(initial=0.0)))
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=tol, err_msg=what)


# ---- the host surface (the reference api tests' cases) -------------------

SURFACE = {
    "matrix_create_get_set": lambda api: (
        lambda m: (m.set(1, 0, 9.5), m.get(1, 0), m.getHeight(), m.getWidth(),
                   m.copyToNumpyMat().tolist(), m.isSparse(), m.isGpu()))(
        api.Matrix.createDense([1, 2, 3, 4, 5, 6], 2, 3)),
    "matrix_short_last_batch": lambda api: api.Matrix.createDense(
        [1, 2, 3], 4, 3).copyToNumpyMat().tolist(),
    "matrix_zero_and_numpy_copy": lambda api: (
        lambda m: (m.copyFromNumpyMat(np.arange(6).reshape(2, 3)),
                   m.toNumpyMat().tolist()))(api.Matrix.createZero(2, 3)),
    "matrix_inplace_shares": lambda api: (
        lambda a: (api.Matrix.createCpuDenseFromNumpy(a, copy=False)
                   .set(0, 1, 7.0), a.tolist()))(
        np.zeros((2, 2), np.float32)),
    "matrix_range_error": lambda api: _raises(
        lambda: api.Matrix.createZero(2, 2).get(2, 0), api.RangeError),
    "sparse_csr": lambda api: (
        lambda m: (m.sparseCopyFrom([0, 2, 3], [1, 3, 0], [0.5, 2.0, -1.0]),
                   m.getSparseRowCols(0), m.getSparseRowColsVal(1),
                   m.copyToNumpyMat().tolist(), m.getSparseValueType()))(
        api.Matrix.createSparse(2, 4, 3, non_value=False)),
    "sparse_binary": lambda api: (
        lambda m: (m.sparseCopyFrom([0, 1, 3], [2, 0, 3]),
                   m.getSparseRowColsVal(1), m.copyToNumpyMat().tolist()))(
        api.Matrix.createSparse(2, 4, 3)),
    "vector_create_index": lambda api: (
        lambda v: (v.__setitem__(1, 4.5), v[1], len(v), v.getData(),
                   list(iter(v)), v.isGpu()))(api.Vector.create([1, 2, 3])),
    "vector_generator_and_zero": lambda api: (
        api.Vector.create(x * 0.5 for x in range(4)).getData(),
        api.Vector.createZero(3).toNumpyArray().tolist()),
    "vector_copy_from": lambda api: (
        lambda v: (v.copyFromNumpyArray(np.asarray([7.0, 8.0])),
                   v.copyToNumpyArray().tolist()))(api.Vector.createZero(2)),
    "vector_inplace_shares": lambda api: (
        lambda a: (api.Vector.createCpuVectorFromNumpy(a, copy=False)
                   .__setitem__(0, 3.0), a.tolist()))(
        np.zeros(2, np.float32)),
    "ivector": lambda api: (
        lambda v: (v[2], v.getData(), type(v[0]).__name__))(
        api.IVector.create([5, 6, 7])),
    "vector_range_error": lambda api: _raises(
        lambda: api.IVector.create([1])[1], api.RangeError),
    "arguments_slots": lambda api: (
        lambda a: (a.setSlotValue(0, api.Matrix.createDense([1, 2, 3, 4],
                                                            2, 2)),
                   a.setSlotIds(1, api.IVector.create([3, 1, 4])),
                   a.setSlotSequenceStartPositions(
                       1, api.IVector.create([0, 1, 3])),
                   a.setSlotFrameHeight(0, 5), a.setSlotFrameWidth(0, 6),
                   a.getSlotNum(), a.getSlotFrameHeight(0),
                   a.getSlotFrameWidth(0), a.sum(),
                   a.getSlotIds(1).getData(),
                   a.getSlotSequenceStartPositions(1).getData()))(
        api.Arguments.createArguments(2)),
    "arguments_resize": lambda api: (
        lambda a: (a.resize(4), a.getSlotNum(), a.resize(1),
                   a.getSlotNum()))(api.Arguments.createArguments(2)),
    "flags_and_enums": lambda api: (
        api.PASS_TRAIN, api.PASS_TEST, api.PARAMETER_VALUE,
        api.PARAMETER_GRADIENT, api.SPARSE_CSR, api.NO_SPARSE_ID),
}


def _raises(fn, exc):
    try:
        fn()
    except exc:
        return "raised"
    return "no raise"


@pytest.mark.parametrize("case", sorted(SURFACE))
def test_host_surface_equal_to_jax(case):
    assert SURFACE[case](tswig) == SURFACE[case](jswig)


def test_device_queries():
    from paddle_tpu_torch.core import flags

    assert tswig.isGpuVersion() is True and jswig.isGpuVersion() is False
    assert tswig.isUsingGpu() is False  # the fixture's setUseGpu(False)
    tswig.setUseGpu(True)
    assert tswig.isUsingGpu() is True
    old = flags.get_flag("log_period")
    try:
        tswig.initPaddle("--use_gpu=0", "--log_period=3", "--unknown=1")
        assert tswig.isUsingGpu() is False
        assert flags.get_flag("log_period") == 3
    finally:
        flags.set_flag("log_period", old)


def test_default_device_raises_without_a_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    conf = ttext.stacked_lstm_classifier(vocab_size=VOCAB, emb_dim=4,
                                         hidden=4, num_layers=1)
    tswig.initPaddle("--use_gpu=1")
    for make in (lambda: tswig.GradientMachine.createFromConfigProto(conf),
                 lambda: tswig.GradientMachine(conf, seed=0),
                 lambda: tapi.GradientMachine(conf),
                 lambda: tapi.SequenceGenerator(None, None)):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            make()
    tswig.initPaddle("--use_gpu=0")
    gm = tswig.GradientMachine.createFromConfigProto(conf)
    assert gm.device.type == "cpu"
    tswig.setUseGpu(True)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tswig.GradientMachine(conf)
    assert tswig.GradientMachine(conf, device="cpu").device.type == "cpu"


# ---- the two models --------------------------------------------------------

def lstm_confs():
    kw = dict(vocab_size=VOCAB, emb_dim=8, hidden=8, num_layers=2)
    return jtext.stacked_lstm_classifier(**kw), \
        ttext.stacked_lstm_classifier(**kw)


def _bn_net(dsl):
    with dsl.model() as g:
        x = dsl.data("image", (6, 6, 2))
        y = dsl.data("label", 1, is_ids=True)
        h = dsl.img_conv_bn_pool(x, filter_size=3, num_filters=4,
                                 pool_size=2, conv_padding=1,
                                 num_channel=2)
        out = dsl.fc(h, size=3, name="output")
        dsl.classification_cost(out, y)
        g.conf.output_layer_names.append("output")
    return g.conf


def bn_confs():
    return _bn_net(jdsl), _bn_net(tdsl)


MODELS = {"lstm": lstm_confs, "bn_conv": bn_confs}


def batches(model, n, seed=0):
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(n):
        if model == "lstm":
            out.append([(rng.integers(0, VOCAB, int(rng.integers(2, 9)))
                         .tolist(), int(rng.integers(0, 2)))
                        for _ in range(B)])
        else:
            out.append([(rng.standard_normal(72).astype(np.float32),
                         int(rng.integers(0, 3))) for _ in range(B)])
    return out


def converters(model):
    if model == "lstm":
        types = ((jfeeder.integer_value_sequence(VOCAB),
                  jfeeder.integer_value(2)),
                 (tfeeder.integer_value_sequence(VOCAB),
                  tfeeder.integer_value(2)))
    else:
        types = ((jfeeder.dense_vector((6, 6, 2)), jfeeder.integer_value(3)),
                 (tfeeder.dense_vector((6, 6, 2)), tfeeder.integer_value(3)))
    return JConverter(list(types[0])), DataProviderConverter(list(types[1]))


def machines(model, seed=1):
    """(JAX machine, port machine) with the JAX machine's parameters
    and state set into the port."""
    jconf, tconf = MODELS[model]()
    jgm = jswig.GradientMachine.createFromConfigProto(jconf)
    jgm.randParameters(seed)
    tgm = tswig.GradientMachine.createFromConfigProto(tconf)
    tgm.params = params_from_numpy(
        {k: np.asarray(v) for k, v in jgm.params.items()}, device="cpu")
    tgm.state = state_from_numpy(jax.tree_util.tree_map(np.asarray,
                                                        jgm.state),
                                 device="cpu")
    assert tgm.getParameterNames() == jgm.getParameterNames()
    return jgm, tgm


def same_params(jgm, tgm):
    for k in jgm.getParameterNames():
        close(tgm.params[k].numpy(), np.asarray(jgm.params[k]), k)


def same_state(jgm, tgm):
    for layer, slots in jgm.state.items():
        for s, v in slots.items():
            close(tgm.state[layer][s].numpy(), np.asarray(v), f"{layer}.{s}")


@pytest.mark.parametrize("model", sorted(MODELS))
@pytest.mark.parametrize("pass_type", ["test", "train"])
def test_forward_equal_to_jax(model, pass_type):
    jgm, tgm = machines(model)
    jc, tc = converters(model)
    data = batches(model, 1)[0]
    pt = jswig.PASS_TEST if pass_type == "test" else jswig.PASS_TRAIN
    jout, tout = jswig.Arguments.createArguments(0), \
        tswig.Arguments.createArguments(0)
    jgm.forward(jc(data), jout, pt)
    tgm.forward(tc(data), tout, pt)
    assert tout.getSlotNum() == jout.getSlotNum() >= 1
    for i in range(jout.getSlotNum()):
        close(tout.getSlotValue(i).copyToNumpyMat(),
              jout.getSlotValue(i).copyToNumpyMat(), f"slot {i}")
    # a train-mode forward advances the BN state; a test-mode one not
    same_state(jgm, tgm)
    jt, tt = jgm.forwardTest(jc(data)), tgm.forwardTest(tc(data))
    assert len(jt) == len(tt)
    for a, b in zip(jt, tt):
        assert sorted(a) == sorted(b)
        close(b["value"], a["value"])
        np.testing.assert_array_equal(b["id"], a["id"])


@pytest.mark.parametrize("model", sorted(MODELS))
def test_backward_after_a_test_mode_forward(model):
    """backward() differentiates loss_fn in TRAIN mode on the last
    forward's feed, even when that forward ran in test mode, and does
    not advance the BN state."""
    jgm, tgm = machines(model)
    jc, tc = converters(model)
    data = batches(model, 1, seed=3)[0]
    state0 = {k: {s: t.clone() for s, t in v.items()}
              for k, v in tgm.state.items()}
    jgm.forward(jc(data), jswig.Arguments.createArguments(0),
                jswig.PASS_TEST)
    tgm.forward(tc(data), tswig.Arguments.createArguments(0),
                tswig.PASS_TEST)
    jorder, torder = [], []
    jgm.backward(lambda p: jorder.append(p.getName()))
    tgm.backward(lambda p: torder.append(p.getName()))
    assert torder == jorder == jgm.getParameterNames()
    for p in tgm.getParameters():
        g = p.getBuf(tswig.PARAMETER_GRADIENT).copyToNumpyArray()
        close(g, np.asarray(jgm._grads[p.getName()]).ravel(), p.getName())
    for k, v in tgm.state.items():
        for s, t in v.items():
            assert torch.equal(t, state0[k][s])


@pytest.mark.parametrize("model", sorted(MODELS))
def test_forward_backward_and_callback_order(model):
    jgm, tgm = machines(model)
    jc, tc = converters(model)
    for data in batches(model, 2, seed=5):
        jorder, torder = [], []
        jl = jgm.forwardBackward(jc(data), jswig.Arguments.createArguments(0),
                                 jswig.PASS_TRAIN,
                                 lambda p: jorder.append(p.getID()))
        tl = tgm.forwardBackward(tc(data), tswig.Arguments.createArguments(0),
                                 tswig.PASS_TRAIN,
                                 lambda p: torder.append(p.getID()))
        assert isinstance(tl, float)
        close(tl, jl, "loss")
        assert torder == jorder == list(range(len(jorder)))
        for n in jgm.getParameterNames():
            close(tgm._grads[n].numpy(), np.asarray(jgm._grads[n]), n)
        same_state(jgm, tgm)


def test_parameter_buffers_mirrors_and_write_through():
    jgm, tgm = machines("lstm")
    jc, tc = converters("lstm")
    data = batches("lstm", 1, seed=7)[0]
    rng = np.random.default_rng(2)
    for jp, tp in zip(jgm.getParameters(), tgm.getParameters()):
        assert (tp.getName(), tp.getSize(), tp.getID()) == \
            (jp.getName(), jp.getSize(), jp.getID())
        # the testTrain idiom: mutate the inplace view, then run
        new = rng.standard_normal(jp.getSize()).astype(np.float32) * 0.1
        jp.getBuf(jswig.PARAMETER_VALUE).toNumpyArrayInplace()[:] = new
        tview = tp.getBuf(tswig.PARAMETER_VALUE).toNumpyArrayInplace()
        tview[:] = new
        assert tp.getBuf(tswig.PARAMETER_VALUE).toNumpyArrayInplace() \
            is tview
    jt, tt = jgm.forwardTest(jc(data)), tgm.forwardTest(tc(data))
    close(tt[0]["value"], jt[0]["value"])
    same_params(jgm, tgm)
    # copyFrom writes through and refreshes the mirror
    name = tgm.getParameterNames()[0]
    tbuf = tgm.getParameter(0).getBuf(tswig.PARAMETER_VALUE)
    tbuf.copyFrom(tswig.Vector.create(np.full(len(tbuf), 0.25)))
    assert (tgm.params[name].numpy() == 0.25).all()
    assert (tbuf.toNumpyArrayInplace() == 0.25).all()
    tbuf[3] = 1.5
    assert tbuf.copyToNumpyArray()[3] == 1.5
    with pytest.raises(ValueError):
        tgm.getParameter(0).getBuf(tswig.PARAMETER_GRADIENT).copyFrom(
            np.zeros(len(tbuf)))
    # the GAN driver's copy_shared_parameters: one machine's buffer into
    # another's
    _, other = machines("lstm", seed=4)
    ob = other.getParameter(0).getBuf(tswig.PARAMETER_VALUE)
    ob.copyFrom(tbuf)
    assert ob.copyToNumpyArray()[3] == 1.5
    # on the CPU nothing crosses a bus
    assert tgm.mirror_bytes == {"h2d": 0, "d2h": 0}


@pytest.mark.parametrize("kind", ["merged", "save_dir", "pass_dir",
                                  "param_file"])
def test_load_parameters_written_by_jax(tmp_path, kind):
    jgm, _ = machines("bn_conv", seed=9)
    jgm.forward(converters("bn_conv")[0](batches("bn_conv", 1)[0]),
                jswig.Arguments.createArguments(0), jswig.PASS_TRAIN)
    params = {k: np.asarray(v) for k, v in jgm.params.items()}
    state = jax.tree_util.tree_map(np.asarray, jgm.state)
    _, tconf = bn_confs()
    tgm = tswig.GradientMachine(tconf, seed=0)
    if kind == "param_file":
        for p in jgm.getParameters():
            p.save(str(tmp_path / p.getName()))
        for p in tgm.getParameters():
            assert p.load(str(tmp_path / p.getName()))
        same_params(jgm, tgm)
        return
    if kind == "merged":
        path = str(tmp_path / "model.npz")
        jckpt.merge_model(path, bn_confs()[0], params, state)
    else:
        jckpt.save_pass(str(tmp_path), 0, params, state=state)
        path = str(tmp_path) if kind == "save_dir" else \
            str(tmp_path / "pass-00000")
    mirror = tgm.getParameter(0).getBuf(
        tswig.PARAMETER_VALUE).toNumpyArrayInplace()
    tgm.loadParameters(path)
    same_params(jgm, tgm)
    same_state(jgm, tgm)
    np.testing.assert_array_equal(
        mirror, params[tgm.getParameterNames()[0]].ravel())


@pytest.mark.parametrize("model", sorted(MODELS))
def test_three_updater_steps_equal_to_jax(model):
    jgm, tgm = machines(model)
    jc, tc = converters(model)
    # the conv bias before the BN has a gradient of zero up to rounding:
    # adam would step by the sign of that noise, so the BN net takes
    # momentum
    conf = dict(learning_method="adam", learning_rate=1e-2) \
        if model == "lstm" else \
        dict(learning_method="momentum", learning_rate=5e-2, momentum=0.9)
    jup = jswig.ParameterUpdater.createLocalUpdater(JOpt(**conf))
    tup = tswig.ParameterUpdater.createLocalUpdater(TOpt(**conf))
    jup.init(jgm)
    tup.init(tgm)
    for data in batches(model, 3, seed=11):
        losses = []
        for gm, up, cv, api in ((jgm, jup, jc, jswig),
                                (tgm, tup, tc, tswig)):
            up.startBatch(len(data))
            loss = gm.forwardBackward(cv(data),
                                      api.Arguments.createArguments(0),
                                      api.PASS_TRAIN)
            for p in gm.getParameters():
                up.update(p)
            up.finishBatch(loss)
            losses.append(loss)
        close(losses[1], losses[0], "loss")
        same_params(jgm, tgm)
    assert tup.global_step == jup.global_step == 3


def test_updater_leaves_unmarked_params_untouched():
    jgm, tgm = machines("lstm")
    _, tc = converters("lstm")
    up = tswig.ParameterUpdater.createLocalUpdater(
        TOpt(learning_method="momentum", learning_rate=0.1, momentum=0.9,
             l2_rate=0.05))
    up.init(tgm)
    frozen = tgm.getParameterNames()[0]
    before = tgm.params[frozen].clone()
    up.startBatch(B)
    tgm.forwardBackward(tc(batches("lstm", 1)[0]),
                        tswig.Arguments.createArguments(0))
    for p in tgm.getParameters():
        if p.getName() != frozen:
            up.update(p)
    up.finishBatch()
    assert torch.equal(tgm.params[frozen], before)


@pytest.mark.parametrize("model", sorted(MODELS))
def test_three_trainer_steps_equal_to_jax(model):
    jgm, tgm = machines(model)
    jc, tc = converters(model)
    opt = dict(learning_method="momentum", learning_rate=5e-2, momentum=0.9)

    class TC:
        pass

    jcfg, tcfg = TC(), TC()
    jcfg.opt, tcfg.opt = JOpt(**opt), TOpt(**opt)
    jt = jswig.Trainer.create(jcfg, jgm)
    tt = tswig.Trainer.create(tcfg, tgm)
    # a registered mirror stays live through the steps
    mirror = tgm.getParameter(1).getBuf(
        tswig.PARAMETER_VALUE).toNumpyArrayInplace()
    for t in (jt, tt):
        t.startTrain()
        t.startTrainPass()
    for data in batches(model, 3, seed=13):
        jl = jt.trainOneDataBatch(len(data), jc(data))
        tl = tt.trainOneDataBatch(len(data), tc(data))
        close(tl, jl, "loss")
        same_params(jgm, tgm)
        close(tt.getForwardOutput()[0]["value"],
              jt.getForwardOutput()[0]["value"])
    same_state(jgm, tgm)
    np.testing.assert_array_equal(
        mirror, tgm.params[tgm.getParameterNames()[1]].numpy().ravel())
    for t in (jt, tt):
        t.finishTrainPass()
        t.startTestPeriod()
    data = batches(model, 1, seed=14)[0]
    close(tt.testOneDataBatch(len(data), tc(data)),
          jt.testOneDataBatch(len(data), jc(data)), "test cost")
    tt.finishTestPeriod()


def test_evaluator_equal_to_jax():
    jgm, tgm = machines("bn_conv")
    jc, tc = converters("bn_conv")
    je, te = jgm.makeEvaluator(), tgm.makeEvaluator()
    je.start()
    te.start()
    for data in batches("bn_conv", 2, seed=15):
        jgm.forward(jc(data), jswig.Arguments.createArguments(0),
                    jswig.PASS_TEST)
        tgm.forward(tc(data), tswig.Arguments.createArguments(0),
                    tswig.PASS_TEST)
        jgm.eval(je)
        tgm.eval(te)
    assert te.getNames() == je.getNames() == ["classification_error"]
    close(te.getValue("classification_error"),
          je.getValue("classification_error"))


CONVERTER_SAMPLES = [
    ([0.5, 1.0, -1.0], [1, 2, 3], 0, [[1, 2], [3]]),
    ([0.0, 2.0, 4.0], [4, 5], 1, [[4], [5, 6], [7]]),
    ([1.5, -2.0, 0.25], [6], 1, [[8, 9, 1]]),
]


def test_data_provider_converter_equal_to_jax():
    jconv = JConverter([jfeeder.dense_vector(3),
                        jfeeder.integer_value_sequence(10),
                        jfeeder.integer_value(2),
                        jfeeder.integer_value_sub_sequence(10)])
    tconv = DataProviderConverter([tfeeder.dense_vector(3),
                                   tfeeder.integer_value_sequence(10),
                                   tfeeder.integer_value(2),
                                   tfeeder.integer_value_sub_sequence(10)])
    ja, ta = jconv(CONVERTER_SAMPLES), tconv(CONVERTER_SAMPLES)
    assert ta.getSlotNum() == ja.getSlotNum() == 4
    np.testing.assert_array_equal(ta.getSlotValue(0).copyToNumpyMat(),
                                  ja.getSlotValue(0).copyToNumpyMat())
    for i in (1, 2):
        assert ta.getSlotIds(i).getData() == ja.getSlotIds(i).getData()
    assert ta.getSlotSequenceStartPositions(1).getData() == \
        ja.getSlotSequenceStartPositions(1).getData() == [0, 3, 5, 6]
    for i in range(4):
        jarg_, targ_ = ja._to_arg(i), ta._to_arg(i)
        for f in ("value", "ids", "seq_lens", "subseq_lens"):
            a, b = getattr(jarg_, f), getattr(targ_, f)
            assert (a is None) == (b is None), (i, f)
            if a is not None:
                np.testing.assert_array_equal(b.numpy(), np.asarray(a))
    # convert into a given Arguments, and with a wrong type
    given = tswig.Arguments.createArguments(1)
    assert tconv.convert(CONVERTER_SAMPLES, given) is given
    assert given.getSlotNum() == 4
    with pytest.raises(TypeError):
        DataProviderConverter([3])


def test_ragged_slots_pad_like_jax():
    """Arguments set from an IVector / Matrix with start positions pad
    with `pad_ragged`, as the JAX package's."""
    pos = [0, 2, 5, 6]
    flat = np.arange(6 * 2, dtype=np.float32).reshape(6, 2)
    for api in (jswig, tswig):
        a = api.Arguments.createArguments(2)
        a.setSlotIds(0, api.IVector.create([3, 1, 4, 1, 5, 9]))
        a.setSlotSequenceStartPositions(0, api.IVector.create(pos))
        a.setSlotValue(1, api.Matrix.createDense(flat.ravel(), 6, 2))
        a.setSlotSequenceStartPositions(1, api.IVector.create(pos))
        if api is jswig:
            want = [a._to_arg(i) for i in range(2)]
        else:
            got = [a._to_arg(i) for i in range(2)]
    np.testing.assert_array_equal(got[0].ids.numpy(), np.asarray(want[0].ids))
    np.testing.assert_array_equal(got[1].value.numpy(),
                                  np.asarray(want[1].value))
    np.testing.assert_array_equal(got[0].seq_lens.numpy(), [2, 3, 1])
    out, lens = targ.pad_ragged(flat, pos)
    jout, jlens = jarg.pad_ragged(flat, pos)
    np.testing.assert_array_equal(out, jout)
    np.testing.assert_array_equal(lens, jlens)
    assert lens.dtype == np.int32


# ---- api.py ---------------------------------------------------------------

def test_api_gradient_machine_and_updater_equal_to_jax():
    jconf, tconf = lstm_confs()
    jgm = japi.GradientMachine.createFromConfigProto(jconf)
    tgm = tapi.GradientMachine.createFromConfigProto(tconf, device="cpu")
    for n in jgm.getParameterNames():
        tgm.setParameter(n, jgm.getParameter(n))
    assert tgm.getParameterNames() == jgm.getParameterNames()
    rng = np.random.default_rng(0)
    ids = rng.integers(0, VOCAB, (B, 7)).astype(np.int32)
    lens = rng.integers(1, 8, B).astype(np.int32)
    lab = rng.integers(0, 2, B).astype(np.int32)
    jfeed = {"words": jarg.id_arg(ids, lens), "label": jarg.id_arg(lab)}
    tfeed = {"words": targ.id_arg(ids, lens), "label": targ.id_arg(lab)}
    jo = jgm.forward(jfeed, outputs=["output"])
    to = tgm.forward(tfeed, outputs=["output"])
    close(to["output"].value.numpy(), np.asarray(jo["output"].value))
    conf = dict(learning_method="adam", learning_rate=1e-2)
    jup = japi.ParameterUpdater.createLocalUpdater(JOpt(**conf), jgm)
    tup = tapi.ParameterUpdater.createLocalUpdater(TOpt(**conf), tgm)
    for _ in range(3):
        jl, _ = jgm.forwardBackward(jfeed)
        tl, _ = tgm.forwardBackward(tfeed)
        close(tl, jl, "loss")
        for n in jgm.getParameterNames():
            close(tgm.getGradient(n), jgm.getGradient(n), n)
        jup.update()
        tup.update()
    for n in jgm.getParameterNames():
        close(tgm.getParameter(n), jgm.getParameter(n), n)
    a = tapi.Arguments.createArguments(2)
    a.setSlotValue(0, tapi.Matrix.createDenseFromNumpy(np.eye(2)))
    a.setSlotIds(1, tapi.IVector.createVectorFromNumpy([4, 2]))
    np.testing.assert_array_equal(a.getSlotValue(0).toNumpyMat(), np.eye(2))
    assert a.getSlotIds(1).toNumpyArray().tolist() == [4, 2]
    assert a.getSlotNum() == len(a.slots()) == 2


def test_api_sequence_generator_equal_to_jax():
    """The small attention NMT's decoder behind api.SequenceGenerator:
    tokens and lengths equal to the JAX generator's, scores within
    1e-5, and `last_result` the port decoder's own generate."""
    vocab, emb, hidden = 32, 8, 8
    jnet = JNetwork(jtext.seq2seq_attention(src_vocab=vocab, trg_vocab=vocab,
                                            emb_dim=emb, hidden=hidden))
    p = {k: np.asarray(v) for k, v in
         jnet.init_params(jax.random.key(0)).items()}
    src = np.asarray([[2, 3, 4, 5, 6], [6, 7, 8, 9, 0]], np.int32)
    lens = np.asarray([5, 3], np.int32)
    jo, _ = jnet.forward({k: jnp.asarray(v) for k, v in p.items()},
                         {"src": jarg.id_arg(src, lens)},
                         outputs=["enc", "dec_boot"])
    kw = dict(trg_vocab=vocab, emb_dim=emb, hidden=hidden, bos_id=0,
              eos_id=1, beam_size=4, max_length=10)
    jgen = japi.SequenceGenerator(jtext.seq2seq_attention_decoder(**kw),
                                  {k: jnp.asarray(v) for k, v in p.items()},
                                  num_results=2)
    tgen = tapi.SequenceGenerator(ttext.seq2seq_attention_decoder(**kw), p,
                                  num_results=2, device="cpu")
    enc = np.asarray(jo["enc"].value)
    boot = np.asarray(jo["dec_boot"].value)
    tstatic = targ.Arg(value=enc, seq_lens=lens)
    jres = jgen.generate([jo["enc"]], boots={"dec_state": jo["dec_boot"].value})
    tres = tgen.generate([tstatic], boots={"dec_state": boot})
    assert tres == jres and len(tres) == 2 and len(tres[0]) == 2
    seqs, tl, scores = tgen.last_result
    js, jl, jsc = (np.asarray(x) for x in jgen.decoder.generate(
        jgen.params, [jo["enc"]], boots={"dec_state": jo["dec_boot"].value}))
    np.testing.assert_array_equal(seqs.numpy(), js)
    np.testing.assert_array_equal(tl.numpy(), jl)
    np.testing.assert_allclose(scores.numpy(), jsc, atol=1e-5)
    words = [f"w{i}" for i in range(vocab)]
    tgen.dict_list = words
    jgen.dict_list = words
    assert tgen.generate([tstatic], boots={"dec_state": boot}) == \
        jgen.generate([jo["enc"]], boots={"dec_state": jo["dec_boot"].value})
    calls = []
    tgen.registerBeamSearchControlCallbacks(
        stop=lambda fin, sc, t: calls.append(t) or False)
    tgen.generate([tstatic], boots={"dec_state": boot})
    assert calls and calls[0] == 0
    tgen.removeBeamSearchControlCallbacks()
    tgen.setBeamSize(2)
    assert tgen.decoder.k == 2


GEN_CONF = '''\
from paddle.trainer_config_helpers import *

settings(batch_size=15, learning_rate=0)
num_words = 5
beam_flag = get_config_arg('beam_search', bool, False)

sent_id = data_layer(name="sent_id", size=1)
dummy_data = data_layer(name="dummy_data_input", size=2)

gen_inputs = [StaticInput(input=dummy_data, size=2),
              GeneratedInput(size=num_words, embedding_name="wordvec",
                             embedding_size=num_words)]


def step(dummy_memory, predict_word):
    with mixed_layer(size=num_words) as layer:
        layer += full_matrix_projection(
            input=predict_word, param_attr=ParamAttr(name="transtable"))
    with mixed_layer(size=num_words, act=ExpActivation()) as out:
        out += identity_projection(input=layer)
    return out


beam_gen = beam_search(name="rnn_gen", step=step, input=gen_inputs,
                       bos_id=0, eos_id=num_words - 1,
                       beam_size=2 if beam_flag else 1,
                       num_results_per_sample=2 if beam_flag else 1,
                       max_length=10)
outputs(beam_gen)
'''


@pytest.mark.parametrize("beam", ["", "1"], ids=["nobeam", "beam"])
def test_create_config_generator_equal_to_jax(tmp_path, beam):
    """A generating v1 config (the shape of the reference's
    sample_trainer_rnn_gen.conf) through both packages' parser and
    create_config_generator: the same group, the same tokens."""
    path = tmp_path / "gen.conf"
    path.write_text(GEN_CONF)
    jg, jn, ja = japi.create_config_generator(
        jparse(str(path), {"beam_search": beam}).model, None)
    tg, tn, ta = tapi.create_config_generator(
        tparse(str(path), {"beam_search": beam}).model, None, device="cpu")
    assert tn == jn == ["dummy_data_input"]
    assert (ta["beam_size"], ta["num_results"]) == \
        (ja["beam_size"], ja["num_results"]) == ((2, 2) if beam else (1, 1))
    assert sorted(tg.decoder.param_confs(
        [targ.Arg(value=torch.zeros((1, 2)))])) == ["transtable", "wordvec"]
    rng = np.random.default_rng(6)
    p = {"wordvec": rng.standard_normal((5, 5)).astype(np.float32),
         "transtable": rng.standard_normal((5, 5)).astype(np.float32)}
    jg.params, tg.params = p, p
    got = tg.generate([targ.Arg(value=torch.zeros((4, 2)))])
    want = jg.generate([jarg.Arg(value=np.zeros((4, 2), np.float32))])
    assert got == want
    assert len(set(got[0][0])) > 1  # not a constant stream
    with pytest.raises(ValueError, match="no generating"):
        tapi.create_config_generator(lstm_confs()[1], None, device="cpu")
