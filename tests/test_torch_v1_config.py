"""The v1 config front end and the CLI's v1 path, against the JAX
package, on the CPU.

- `compat/layers_v1.py`, `raw_config.py` and `layer_math.py` are the
  JAX package's text with the package renamed (and one docstring line
  each of layers_v1 and layer_math that names what the port does).
- `parse_config` of the port and of the JAX package give equal
  `ModelConf`, `OptimizationConf`, evaluators and data sources (as
  dicts) for inline v1 configs: the smoke's quick_start-style LSTM
  classifier, an MLP, a raw `RecurrentLayerGroupBegin` config, the
  `layer_math` operators, `conv_operator` and some tail layers.
- The config's own `paddle.*` imports resolve to the port's modules: a
  config importing another `paddle` module is refused; a config naming
  `moe` fails to build, naming ROADMAP A8.
- `python -m paddle_tpu_torch train --device cpu --config=<v1 file>`
  runs a pass, `--job=test` and `--job=time` run, and `dump_config`
  prints what the JAX CLI prints.
"""

import dataclasses
import json
import os
import subprocess
import sys

import pytest

import chip_smoke
from paddle_tpu.compat import config_parser as jcp
from paddle_tpu_torch.compat import config_parser as tcp
from paddle_tpu_torch.network import Network as TNetwork

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

MLP = """\
from paddle.trainer_config_helpers import *

settings(batch_size=32, learning_rate=1e-3 / 32,
         learning_method=MomentumOptimizer(0.9),
         regularization=L2Regularization(5e-4),
         gradient_clipping_threshold=10)
img = data_layer(name="pixel", size=784)
h1 = fc_layer(input=img, size=128, act=ReluActivation())
h2 = fc_layer(input=h1, size=64, act=TanhActivation(),
              layer_attr=ExtraAttr(drop_rate=0.5))
out = fc_layer(input=h2, size=10, act=SoftmaxActivation())
lbl = data_layer(name="label", size=10)
cost = classification_cost(input=out, label=lbl)
classification_error_evaluator(input=out, label=lbl, name="err")
outputs(cost)
"""

RAW_GROUP = """\
Settings(algorithm="sgd", batch_size=16, learning_rate=1e-3)
Layer(name="word", type="data", size=20)
Layer(name="emb", type="mixed", size=8, bias=False,
      inputs=[TableProjection("word", parameter_name="emb_w")])
RecurrentLayerGroupBegin("rnn_group", in_links=["emb"],
                         out_links=["rnn_out"])
mem = Memory(name="rnn_out", size=8)
Layer(name="rnn_out", type="mixed", size=8, active_type="tanh",
      bias=Bias(parameter_name="rnn_b"),
      inputs=[FullMatrixProjection("emb", parameter_name="w_in"),
              FullMatrixProjection(mem, parameter_name="w_rec")])
RecurrentLayerGroupEnd("rnn_group")
Layer(name="last", type="seqlastins", inputs=["rnn_out"])
Layer(name="out", type="fc", size=3, active_type="softmax",
      inputs=["last"])
Layer(name="label", type="data", size=3)
Layer(name="cost", type="multi-class-cross-entropy",
      inputs=["out", "label"])
Evaluator(name="err", type="classification_error", inputs=["out", "label"])
Outputs("cost")
"""

LAYER_MATH = """\
from paddle.trainer_config_helpers import *

settings(batch_size=8, learning_rate=0.01,
         learning_method=AdamOptimizer())
a = data_layer(name="a", size=6)
b = data_layer(name="b", size=6)
w = data_layer(name="w", size=1)
c = a + b
d = c * 0.5 + 1.0
e = layer_math.exp(d) - b
f = d * w
g = layer_math.tanh(e) + 2
out = fc_layer(input=[g, f], size=2, act=SoftmaxActivation())
lbl = data_layer(name="label", size=2)
outputs(classification_cost(input=out, label=lbl))
"""

CONV_OPERATOR = """\
from paddle.trainer_config_helpers import *

settings(batch_size=4, learning_rate=0.01)
img = data_layer(name="img", size=16 * 16 * 2, height=16, width=16)
src = data_layer(name="fsrc", size=8)
flt = fc_layer(input=src, size=3 * 3 * 2 * 4)
conv = mixed_layer(input=[conv_operator(img=img, filter=flt, filter_size=3,
                                        num_filters=4, num_channels=2,
                                        padding=1)],
                   bias_attr=False)
up = mixed_layer(input=[conv_operator(img=img, filter=flt, filter_size=3,
                                      num_filters=4, num_channels=2,
                                      stride=2, padding=1, trans=True)],
                 bias_attr=False)
out = fc_layer(input=[conv, up], size=10, act=SoftmaxActivation())
lbl = data_layer(name="label", size=10)
outputs(classification_cost(input=out, label=lbl))
"""

TAIL = """\
from paddle.trainer_config_helpers import *

settings(batch_size=8, learning_rate=0.01)
img = data_layer(name="img", size=8 * 8 * 4, height=8, width=8)
mo = maxout_layer(input=img, groups=2, num_channels=4)
sp = spp_layer(input=mo, pyramid_height=2, num_channels=2)
a = data_layer(name="a", size=6)
b = data_layer(name="b", size=6)
cs = cos_sim(a=a, b=b, scale=2)
si = slope_intercept_layer(input=a, slope=2.0, intercept=-1.0)
t = tensor_layer(a=a, b=b, size=3)
pr = prelu_layer(input=si)
gu = gated_unit_layer(input=pr, size=4, act=TanhActivation())
out = fc_layer(input=[sp, cs, t, gu], size=5, act=SoftmaxActivation())
lbl = data_layer(name="label", size=5)
outputs(classification_cost(input=out, label=lbl),
        huber_cost(input=fc_layer(input=a, size=1), label=lbl))
"""

CONFIGS = {"quick_start_lstm": chip_smoke.V1_LSTM_CONFIG, "mlp": MLP,
           "raw_group": RAW_GROUP, "layer_math": LAYER_MATH,
           "conv_operator": CONV_OPERATOR, "tail": TAIL}


# each copy's lines that name what the port does, beyond the rename
COPY_EDITS = {
    "layers_v1.py": [("during execution (jax.debug.print under jit).",
                      "as it runs (on the host; inside a CUDA-graph "
                      "capture it raises).")],
    "raw_config.py": [],
    "layer_math.py": [("paddle_tpu's LayerRef", "paddle_tpu_torch's LayerRef")],
}


@pytest.mark.parametrize("name", sorted(COPY_EDITS))
def test_compat_copy_equals_original_with_package_renamed(name):
    with open(os.path.join(REPO, "paddle_tpu", "compat", name)) as f:
        want = f.read().replace("paddle_tpu.", "paddle_tpu_torch.").replace(
            "from paddle_tpu import", "from paddle_tpu_torch import")
    for old, new in COPY_EDITS[name]:
        assert old in want
        want = want.replace(old, new)
    with open(os.path.join(REPO, "paddle_tpu_torch", "compat", name)) as f:
        assert f.read() == want


def _parse(cp, path, args=""):
    tc = cp.parse_config(str(path), args)
    ds = tc.data_sources
    return {
        "model": json.loads(tc.model.to_json()),
        "layers": [dataclasses.asdict(lc) for lc in tc.model.layers],
        "opt": dataclasses.asdict(tc.opt),
        "evaluators": tc.evaluators,
        "data": None if ds is None else (ds.train_list, ds.test_list,
                                         ds.module, ds.obj, ds.args),
    }


@pytest.mark.parametrize("name", sorted(CONFIGS))
def test_parse_config_matches_jax(name, tmp_path):
    path = tmp_path / f"{name}.py"
    path.write_text(CONFIGS[name])
    got, want = _parse(tcp, path), _parse(jcp, path)
    assert got == want
    assert got["model"]["layers"]
    if name == "quick_start_lstm":
        got = _parse(tcp, path, "vocab=50,hidden=8,emb=4")
        assert got == _parse(jcp, path, "vocab=50,hidden=8,emb=4")
        assert got["data"][4] == {"vocab": 50, "n": 512, "seed": 0}


def test_parsed_confs_build_in_the_port(tmp_path):
    """Every config above builds a port `Network` (layer types, specs
    and parameters)."""
    for name, text in CONFIGS.items():
        path = tmp_path / f"{name}.py"
        path.write_text(text)
        net = TNetwork(tcp.parse_config(str(path)).model)
        assert net.param_confs, name


def test_config_imports_resolve_to_the_port(tmp_path):
    """The config's `paddle.*` names are the port's (the config asserts
    it); `import paddle.x as y` and `from paddle.trainer import
    PyDataProvider2` work; any other `paddle` module is refused."""
    path = tmp_path / "c.py"
    path.write_text(
        "import paddle.trainer_config_helpers as tch\n"
        "from paddle.trainer import PyDataProvider2 as pdp\n"
        "from paddle.trainer.config_parser import get_config_arg\n"
        "assert tch.fc_layer.__module__ == "
        "'paddle_tpu_torch.compat.layers_v1'\n"
        "assert pdp.provider.__module__ == 'paddle_tpu_torch.data.provider'\n"
        "x = tch.data_layer(name='x', size=get_config_arg('w', int, 3))\n"
        "tch.outputs(tch.fc_layer(input=x, size=2))\n")
    tc = tcp.parse_config(str(path), "w=5")
    assert tc.model.layer("x").size == 5
    path.write_text("import paddle.v2 as paddle\n")
    with pytest.raises(ImportError, match="paddle.v2"):
        tcp.parse_config(str(path))


def test_provider_module_uses_the_port(tmp_path):
    chip_smoke.write_v1_config(str(tmp_path))
    mod = tcp.load_provider_module("imdb_like_provider", str(tmp_path))
    from paddle_tpu_torch.data.provider import DataProvider

    assert isinstance(mod.process, DataProvider)
    reader = mod.process(["train-0"], vocab=40, n=3, seed=1)
    samples = list(reader())
    assert len(samples) == 3 and all(10 <= len(s[0]) <= 100
                                     for s in samples)


def test_moe_in_a_v1_config_names_roadmap_a8(tmp_path):
    path = tmp_path / "moe.py"
    path.write_text(
        'Layer(name="x", type="data", size=8)\n'
        'Layer(name="m", type="moe", size=8, inputs=["x"], num_experts=2)\n')
    conf = tcp.parse_config(str(path)).model
    assert conf.to_json() == jcp.parse_config(str(path)).model.to_json()
    # the layer runs on one card since the moe port; the expert weights
    # carry the `expert_sharded` mark that ROADMAP A8's mesh placement
    # reads
    net = TNetwork(conf)
    pcs = net.param_confs
    assert sorted(pcs) == ["_m.w0", "_m.w0_in", "_m.w0_out"]
    assert pcs["_m.w0_in"].expert_sharded and pcs["_m.w0_out"].expert_sharded
    assert not pcs["_m.w0"].expert_sharded


def _cli(pkg, args, cwd, timeout=300):
    env = dict(os.environ, JAX_PLATFORMS="cpu", PYTHONPATH=REPO)
    res = subprocess.run([sys.executable, "-m", pkg] + args, cwd=cwd,
                         env=env, capture_output=True, text=True,
                         timeout=timeout)
    assert res.returncode == 0, res.stderr[-3000:]
    return res.stdout


def test_cli_trains_tests_and_times_a_v1_config(tmp_path):
    path, args = chip_smoke.write_v1_config(
        str(tmp_path), vocab=60, hidden=8, emb=4, n=24, batch_size=8)
    out = _cli("paddle_tpu_torch",
               ["train", "--device", "cpu", f"--config={path}",
                f"--config_args={args}", "--log_period", "1",
                "--save_dir", str(tmp_path / "ckpt")], tmp_path)
    costs = [float(ln.split()[-1]) for ln in out.splitlines()
             if ln.startswith("pass 0 batch")]
    assert len(costs) == 3 and all(c == c for c in costs), out
    out = _cli("paddle_tpu_torch",
               ["train", "--device", "cpu", f"--config={path}",
                f"--config_args={args}", "--job=test",
                "--save_dir", str(tmp_path / "ckpt")], tmp_path)
    (line,) = [ln for ln in out.splitlines() if ln.startswith("test cost")]
    assert "err=" in line
    out = _cli("paddle_tpu_torch",
               ["train", "--device", "cpu", f"--config={path}",
                f"--config_args={args}", "--job=time",
                "--time_batches", "2"], tmp_path)
    assert any(ln.startswith("time: ") for ln in out.splitlines())


def test_dump_config_matches_the_jax_cli(tmp_path):
    path, args = chip_smoke.write_v1_config(str(tmp_path), vocab=60)
    got = _cli("paddle_tpu_torch", ["dump_config", f"--config={path}",
                                    f"--config_args={args}"], tmp_path)
    want = _cli("paddle_tpu", ["dump_config", f"--config={path}",
                               f"--config_args={args}"], tmp_path)
    assert json.loads(got) == json.loads(want)
    assert json.loads(got)["model"]["layers"]


def test_merge_model_refuses_a_v1_config(tmp_path):
    path, _ = chip_smoke.write_v1_config(str(tmp_path))
    env = dict(os.environ, PYTHONPATH=REPO)
    res = subprocess.run(
        [sys.executable, "-m", "paddle_tpu_torch", "merge_model",
         f"--config={path}", "--model_dir", str(tmp_path),
         "--output", str(tmp_path / "m.npz")], cwd=tmp_path, env=env,
        capture_output=True, text=True, timeout=120)
    assert res.returncode != 0 and "v1 config" in res.stderr
    assert "A12" in res.stderr
