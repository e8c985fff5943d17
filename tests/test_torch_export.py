"""`export_compiled` / `load_compiled` on the port, on the CPU.

- A round trip of three forwards whose graphs hold the kernels' custom
  ops: the fused two-block net of TestFusedBottleneck (B1), a small
  LSTM classifier on the kernels' path (B5) and a small LM with flash
  attention (B4f). The loaded program's outputs equal
  `Inferencer.infer` within 1e-6 and the JAX `Inferencer` at rtol 1e-5;
  its graph holds the `paddle_tpu_torch::` nodes and no host read; the
  call runs without the model-building code.
- The envelope is the JAX package's byte for byte, both ways.
- A torn or corrupt blob raises CompiledArtifactError naming its source
  before `torch.export.load` sees a byte (as `tests/
  test_serving_robustness.py::TestLoadCompiledFaults` and `tests/
  test_serving_cli.py::TestInferenceAPI` ask of JAX).
- The verified cache stores and boots an exported Network forward; the
  audit counts the custom-op nodes as any other call.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from paddle_tpu import dsl as jdsl
from paddle_tpu import inference as jinf
from paddle_tpu.core import arg as jarg
from paddle_tpu.models import image as jimage
from paddle_tpu.models import lm as jlm
from paddle_tpu.models import text as jtext
from paddle_tpu.network import Network as JNetwork
from paddle_tpu.trainer.trainer import Inferencer as JInferencer
from paddle_tpu_torch import dsl as tdsl
from paddle_tpu_torch import inference as tinf
from paddle_tpu_torch.core import arg as targ
from paddle_tpu_torch.core import flags as tflags
from paddle_tpu_torch.models import image as timage
from paddle_tpu_torch.models import lm as tlm
from paddle_tpu_torch.models import text as ttext
from paddle_tpu_torch.network import Network as TNetwork
from paddle_tpu_torch.testing_faults import corrupt_file, truncate_file
from paddle_tpu_torch.weights import (
    fused_resnet_from_plain,
    params_from_numpy,
    state_from_numpy,
)

RTOL = 1e-5


@pytest.fixture(autouse=True)
def _kernels_path():
    # the classifier's LSTMs on the kernels' path (the op's plain version
    # on the CPU), as on the card
    tflags.set_flag("use_pallas_rnn", True)
    yield
    tflags.reset_flags()


def _tiny(dsl, image, fused):
    with dsl.model() as g:
        img = dsl.data("image", (8, 8, 16))
        h = image._bottleneck("blk_a", img, 4, 1, project=True, fused=fused)
        h = image._bottleneck("blk_b", h, 4, 1, project=False, fused=fused)
        h = dsl.pool(h, 8, 1, pool_type="avg")
        dsl.fc(h, size=3, name="output", act="softmax")
        g.conf.output_layer_names.append("output")
    return g.conf


def _bottleneck():
    """(JAX Inferencer, port Inferencer, JAX feed, port feed, op): the
    fused two-block net on the JAX init mapped onto the fused graph, a
    running state away from its initial value."""
    jplain = JNetwork(_tiny(jdsl, jimage, False))
    rng = np.random.default_rng(0)
    np_p = {k: np.asarray(v) + (0.3 * rng.standard_normal(v.shape).astype(
        np.float32) if v.ndim == 1 else 0) for k, v in
        jplain.init_params(jax.random.key(0)).items()}
    np_s = {layer: {s: (np.asarray(v) + 0.2 * np.abs(rng.standard_normal(
        v.shape))).astype(np.float32) for s, v in slots.items()}
        for layer, slots in jplain.init_state().items()}
    tnet = TNetwork(_tiny(tdsl, timage, True))
    fp, fs = fused_resnet_from_plain(tnet, np_p, np_s)
    jnet = JNetwork(_tiny(jdsl, jimage, True))
    ji = JInferencer(jnet, {k: jnp.asarray(v) for k, v in fp.items()},
                     jax.tree_util.tree_map(jnp.asarray, fs))
    ti = tinf.Inferencer(tnet, params_from_numpy(fp, device="cpu"),
                         state_from_numpy(fs, device="cpu"), device="cpu")
    x = rng.standard_normal((4, 8, 8, 16)).astype(np.float32)
    return (ji, ti, {"image": jarg.non_seq(jnp.asarray(x))},
            {"image": targ.non_seq(x)}, "bn_act_conv1x1_fwd")


def _classifier():
    kw = dict(vocab_size=50, emb_dim=8, hidden=16, num_layers=2)
    jnet = JNetwork(jtext.stacked_lstm_classifier(**kw))
    p = {k: np.asarray(v) for k, v in jnet.init_params(
        jax.random.key(1)).items()}
    rng = np.random.default_rng(1)
    ids = rng.integers(0, 50, (4, 9)).astype(np.int32)
    lens = np.array([9, 3, 6, 1], np.int32)
    ji = JInferencer(jnet, {k: jnp.asarray(v) for k, v in p.items()})
    ti = tinf.Inferencer(TNetwork(ttext.stacked_lstm_classifier(**kw)),
                         params_from_numpy(p, device="cpu"), device="cpu")
    return (ji, ti, {"words": jarg.id_arg(jnp.asarray(ids), lens)},
            {"words": targ.id_arg(ids, lens)}, "lstm_seq_fwd")


def _lm():
    kw = dict(vocab=64, d_model=32, num_heads=2, num_layers=2,
              attn_impl="flash")
    jnet = JNetwork(jlm.transformer_lm(jlm.LMSpec(**kw)))
    p = {k: np.asarray(v) for k, v in jnet.init_params(
        jax.random.key(2)).items()}
    rng = np.random.default_rng(2)
    ids = rng.integers(0, 64, (2, 12)).astype(np.int32)
    lens = np.array([12, 7], np.int32)
    ji = JInferencer(jnet, {k: jnp.asarray(v) for k, v in p.items()})
    ti = tinf.Inferencer(TNetwork(tlm.transformer_lm(tlm.LMSpec(**kw))),
                         params_from_numpy(p, device="cpu"), device="cpu")
    return (ji, ti, {"ids": jarg.id_arg(jnp.asarray(ids), lens)},
            {"ids": targ.id_arg(ids, lens)}, "flash_attention_fwd")


MODELS = {"fused_bottleneck": _bottleneck, "lstm_classifier": _classifier,
          "lm_flash": _lm}


def _value(a):
    return (a.value if a.value is not None else a.ids).numpy()


@pytest.mark.parametrize("name", sorted(MODELS))
def test_round_trip_matches_infer_and_jax(name, monkeypatch):
    ji, ti, jfeed, tfeed, op = MODELS[name]()
    blob = tinf.export_compiled(ti, tfeed)
    assert isinstance(blob, bytes) and blob.startswith(tinf._EXPORT_MAGIC)
    fn = tinf.load_compiled(blob, source=f"{name}.pt2")
    targets = [str(n.target) for n in fn.graph.nodes
               if n.op == "call_function"]
    assert any(t.startswith(f"paddle_tpu_torch.{op}") for t in targets)
    records = [{"op": n.op, "target": str(n.target), "outputs": [],
                "in_devices": []} for n in fn.graph.nodes]
    assert tinf.audit_graph(records, {})["host_transfers"] == 0
    eager = ti.infer(tfeed)
    want = ji.infer(jfeed)

    def no_model_code(*_a, **_k):
        raise AssertionError("the loaded program ran the model code")

    monkeypatch.setattr(TNetwork, "forward", no_model_code)
    out = fn(ti.params, ti.state, tfeed)
    assert sorted(out) == sorted(eager) == sorted(ti.output_names)
    for n in eager:
        assert isinstance(out[n], targ.Arg)
        got = _value(out[n])
        np.testing.assert_allclose(got, eager[n], rtol=0, atol=1e-6 * max(
            1.0, float(np.abs(eager[n]).max())), err_msg=n)
        np.testing.assert_allclose(got, want[n], rtol=RTOL, atol=RTOL * max(
            1e-3, float(np.abs(want[n]).max())), err_msg=n)


def test_envelope_is_the_jax_packages():
    payload = bytes(range(256)) * 3
    blob = tinf._wrap_envelope(payload)
    assert blob == jinf._wrap_envelope(payload)
    assert jinf._unwrap_envelope(blob, "x") == payload
    assert tinf._unwrap_envelope(jinf._wrap_envelope(payload), "x") == payload


def test_torn_and_corrupt_blobs_raise_before_load(tmp_path, monkeypatch):
    """TestLoadCompiledFaults on the port: a truncated or bit-flipped
    artifact raises CompiledArtifactError (a ValueError) naming it, and
    `torch.export.load` never sees its bytes."""
    with tdsl.model() as g:
        x = tdsl.data("x", 4)
        tdsl.fc(x, size=2, name="out")
    net = TNetwork(g.conf)
    inf = tinf.Inferencer(
        net, net.init_params(torch.Generator().manual_seed(0), device="cpu"),
        outputs=["out"], device="cpu")
    feed = {"x": targ.non_seq(np.ones((2, 4), np.float32))}
    blob = tinf.export_compiled(inf, feed)
    out = tinf.load_compiled(blob)(inf.params, inf.state, feed)
    assert out["out"].value.shape == (2, 2)
    np.testing.assert_allclose(out["out"].value.numpy(),
                               inf.infer(feed)["out"], rtol=1e-6)

    loads = []
    real_load = torch.export.load
    monkeypatch.setattr(torch.export, "load",
                        lambda *a, **k: loads.append(1) or real_load(*a, **k))
    path = str(tmp_path / "model.pt2")
    for damage, reason in ((lambda: truncate_file(path, keep_fraction=0.5),
                            "corrupt"),
                           (lambda: corrupt_file(path), "corrupt"),
                           (lambda: truncate_file(path, keep_fraction=0.001),
                            "truncated")):
        with open(path, "wb") as f:
            f.write(blob)
        damage()
        with pytest.raises(tinf.CompiledArtifactError,
                           match="model.pt2") as e:
            tinf.load_compiled(open(path, "rb").read(), source=path)
        assert isinstance(e.value, ValueError)
        assert e.value.reason == reason and e.value.source == path
    assert loads == []
    with pytest.raises(tinf.CompiledArtifactError, match="no envelope"):
        tinf.load_compiled(b"not an artifact", source="raw")
    assert loads == []


def test_verified_cache_stores_an_exported_network_forward(tmp_path):
    """`store_verified` over the classifier's Inferencer forward (B5's op
    in its graph): the audit counts the op nodes with every other call,
    a policy under that count refuses the entry, and the booted program
    equals `infer`."""
    _ji, ti, _jf, tfeed, op = _classifier()
    args = (ti.params, ti.state, tfeed)
    meta = tinf.store_verified(str(tmp_path), "cls",
                               tinf.InferencerForward(ti), args,
                               policy={"host_transfer_budget": 0})
    ep = tinf.export_program(tinf.InferencerForward(ti), args)
    calls = [n for n in ep.graph.nodes if n.op == "call_function"]
    assert meta["n_instructions"] == len(calls)
    assert sum(str(n.target).startswith(f"paddle_tpu_torch.{op}")
               for n in calls) == 2   # one a layer
    assert meta["device"] == "cpu"
    prog = tinf.load_verified(str(tmp_path), "cls", device="cpu")
    out = prog(*args)
    want = ti.infer(tfeed)
    np.testing.assert_allclose(out["output"].value.numpy(), want["output"],
                               rtol=0, atol=1e-6)
    with pytest.raises(tinf.VerifiedCacheError, match="n_instructions"):
        tinf.load_verified(str(tmp_path), "cls", device="cpu",
                           policy={"n_instructions_max": len(calls) - 1})


def test_infer_and_the_loaded_program_under_the_bf16_flag():
    """Under the bf16 flag a forward's output is bf16: `infer` returns it
    as f32 (numpy has no bf16; values exact) and the loaded program,
    exported under the flag, returns the same bf16 values."""
    _ji, ti, _jf, tfeed, _op = _classifier()
    tflags.set_flag("matmul_precision", "bfloat16")
    eager = ti.infer(tfeed)
    fn = tinf.load_compiled(tinf.export_compiled(ti, tfeed))
    tflags.set_flag("matmul_precision", "default")
    out = fn(ti.params, ti.state, tfeed)["output"].value
    assert out.dtype == torch.bfloat16 and eager["output"].dtype == np.float32
    assert np.array_equal(out.float().numpy(), eager["output"])
