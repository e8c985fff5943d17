"""The port stands alone: no JAX, nothing of `paddle_tpu`, no quiet CPU.

- An AST scan proves no file of `paddle_tpu_torch/` (nor
  `chip_smoke.py`) imports `jax`, `jaxlib` or `paddle_tpu`.
- A subprocess with those import-blocked imports every port module.
- An entry point (serving and training: params, caches, `Network`
  init, `TrainStep`, `SGD`; the sparse CTR slice: `SparseUpdater.place`,
  `ShardedEmbeddingTable`) called without `device` on a machine
  without CUDA raises instead of running on the CPU.
- `chip_smoke.py` fails without a card and alone in a directory.
"""

import ast
import os
import shutil
import subprocess
import sys

import numpy as np
import pytest
import torch

from paddle_tpu_torch.core import device as tdevice
from paddle_tpu_torch.core.config import OptimizationConf
from paddle_tpu_torch.decoding.kv_cache import PagedKVCache
from paddle_tpu_torch.models import lm as tlm
from paddle_tpu_torch.network import Network
from paddle_tpu_torch.optimizers import create_optimizer
from paddle_tpu_torch.parallel.dp import TrainStep
from paddle_tpu_torch.parallel.sparse import SparseUpdater
from paddle_tpu_torch.parallel.sparse_shard import (
    ShardedEmbeddingTable,
    ShardedTableConfig,
)
from paddle_tpu_torch.inference import infer
from paddle_tpu_torch.trainer.trainer import SGD, Inferencer
from paddle_tpu_torch.weights import opt_state_from_numpy, params_from_numpy

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PKG = os.path.join(REPO, "paddle_tpu_torch")
FORBIDDEN = ("jax", "jaxlib", "paddle_tpu")


def _port_files():
    files = [os.path.join(REPO, "chip_smoke.py")]
    for root, _dirs, names in os.walk(PKG):
        files += [os.path.join(root, n) for n in names if n.endswith(".py")]
    return files


def _imported_roots(path):
    tree = ast.parse(open(path).read(), path)
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for a in node.names:
                yield a.name.split(".")[0]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module.split(".")[0]


def test_no_port_file_imports_jax_or_the_jax_package():
    files = _port_files()
    assert len(files) > 15
    bad = [(os.path.relpath(f, REPO), m) for f in files
           for m in _imported_roots(f) if m in FORBIDDEN]
    assert bad == []


BLOCKED_IMPORT = """
import importlib, pkgutil, sys

class Block:
    def find_spec(self, name, path=None, target=None):
        if name.split(".")[0] in {forbidden!r}:
            raise ImportError("blocked: " + name)
        return None

sys.meta_path.insert(0, Block())
import paddle_tpu_torch
mods = []
for info in pkgutil.walk_packages(paddle_tpu_torch.__path__,
                                  "paddle_tpu_torch."):
    mods.append(info.name)
for m in mods:
    importlib.import_module(m)
assert not any(k.split(".")[0] in {forbidden!r} for k in sys.modules)
print("IMPORTED", len(mods))
"""


def test_every_port_module_imports_with_jax_blocked():
    code = BLOCKED_IMPORT.format(forbidden=set(FORBIDDEN))
    res = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                         env=dict(os.environ, PYTHONPATH=REPO),
                         capture_output=True, text=True, timeout=120)
    assert res.returncode == 0, res.stderr
    n = int(res.stdout.split()[-1])
    # every .py file but the package's own __init__ is one module
    assert n == len(_port_files()) - 2


def test_entry_points_refuse_the_cpu_unless_asked(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    spec = tlm.LMSpec(vocab=16, d_model=8, num_heads=2, num_layers=1)
    params = {"w": np.zeros((2, 2), np.float32)}
    conf = tlm.transformer_lm(spec)
    net = Network(conf)
    opt_conf = OptimizationConf(learning_method="adam")
    sparse_conf = ShardedTableConfig(rows_total=1 << 30, dim=4, capacity=8,
                                     num_slots=4)
    for call in (
        lambda: tdevice.resolve_device(None),
        lambda: tdevice.resolve_device("cuda"),
        lambda: params_from_numpy(params),
        lambda: opt_state_from_numpy({"w": params}),
        lambda: tlm.lm_init_params(spec),
        lambda: PagedKVCache(spec, num_pages=4),
        lambda: net.init_params(torch.Generator()),
        lambda: TrainStep(net, create_optimizer(opt_conf, net.param_confs)),
        lambda: SGD(conf, opt_conf, seed=1),
        lambda: SGD(conf, opt_conf, seed=1, steps_per_dispatch=4),
        lambda: SGD(conf, opt_conf, seed=1, evaluators=[
            {"type": "classification_error", "input": "x", "label": "y"}]),
        lambda: Inferencer(net, params),
        lambda: infer(output="x", parameters=params, input={}, network=net),
        lambda: SparseUpdater.place(np.zeros((4, 2), np.float32)),
        lambda: ShardedEmbeddingTable(sparse_conf),
        lambda: ShardedEmbeddingTable(sparse_conf, num_shards=8,
                                      device="cuda"),
    ):
        with pytest.raises(RuntimeError, match="device='cpu'"):
            call()
    assert tdevice.resolve_device("cpu") == torch.device("cpu")
    assert params_from_numpy(params, device="cpu")["w"].device.type == "cpu"
    assert SGD(conf, opt_conf, seed=1, device="cpu").device.type == "cpu"
    assert SparseUpdater.place(np.zeros((4, 2), np.float32),
                               device="cpu").shape == (5, 1, 2)
    table = ShardedEmbeddingTable(sparse_conf, device="cpu")
    assert table.lookup(np.arange(3)).device.type == "cpu"


def test_sparse_slice_modules_import_with_jax_blocked():
    """The sparse CTR slice's modules by name (the walk above covers them
    too): the B9 wrapper, the updater, the tier and the CTR confs."""
    code = BLOCKED_IMPORT.replace(
        "for m in mods:", "mods = {names!r}\nfor m in mods:").format(
        forbidden=set(FORBIDDEN),
        names=["paddle_tpu_torch.ops.sparse_rows",
               "paddle_tpu_torch.parallel.sparse",
               "paddle_tpu_torch.parallel.sparse_shard",
               "paddle_tpu_torch.models.ctr",
               "paddle_tpu_torch.optimizers"])
    res = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                         env=dict(os.environ, PYTHONPATH=REPO),
                         capture_output=True, text=True, timeout=120)
    assert res.returncode == 0, res.stderr
    assert res.stdout.split()[-1] == "5"


def test_data_and_dispatch_modules_import_with_jax_blocked():
    """The data feed and the multi-step dispatch by name (the walk above
    covers them too): the feeder, the readers, the providers, the train
    step and its graph runner, the trainer."""
    names = ["paddle_tpu_torch.data.feeder", "paddle_tpu_torch.data.reader",
             "paddle_tpu_torch.data.provider",
             "paddle_tpu_torch.data.proto_provider",
             "paddle_tpu_torch.parallel.dp",
             "paddle_tpu_torch.parallel.graph",
             "paddle_tpu_torch.trainer.trainer"]
    assert all(os.path.join(PKG, *n.split(".")[1:]) + ".py" in _port_files()
               for n in names)
    code = BLOCKED_IMPORT.replace(
        "for m in mods:", "mods = {names!r}\nfor m in mods:").format(
        forbidden=set(FORBIDDEN), names=names)
    res = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                         env=dict(os.environ, PYTHONPATH=REPO),
                         capture_output=True, text=True, timeout=120)
    assert res.returncode == 0, res.stderr
    assert res.stdout.split()[-1] == str(len(names))


def test_lifecycle_modules_import_with_jax_blocked():
    """The training lifecycle by name (the walk above covers them too):
    the evaluators and their CTC decode, sync and async checkpoints, the
    watchdog, the timers, the timeline, the profiler, the trainer's
    exports, the v2 inference front door and the command line."""
    names = ["paddle_tpu_torch.evaluators", "paddle_tpu_torch.ops.ctc",
             "paddle_tpu_torch.trainer.checkpoint",
             "paddle_tpu_torch.trainer.async_checkpoint",
             "paddle_tpu_torch.trainer.watchdog",
             "paddle_tpu_torch.trainer.events",
             "paddle_tpu_torch.trainer.trainer",
             "paddle_tpu_torch.core.stat", "paddle_tpu_torch.core.profiler",
             "paddle_tpu_torch.obs.timeline", "paddle_tpu_torch.inference",
             "paddle_tpu_torch.__main__"]
    assert all(os.path.join(PKG, *n.split(".")[1:]) + ".py" in _port_files()
               for n in names)
    code = BLOCKED_IMPORT.replace(
        "for m in mods:", "mods = {names!r}\nfor m in mods:").format(
        forbidden=set(FORBIDDEN), names=names)
    res = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                         env=dict(os.environ, PYTHONPATH=REPO),
                         capture_output=True, text=True, timeout=120)
    assert res.returncode == 0, res.stderr
    assert res.stdout.split()[-1] == str(len(names))


def test_chip_smoke_fails_without_card_and_without_the_repo(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("this machine has a CUDA device")
    res = subprocess.run([sys.executable, "chip_smoke.py"], cwd=REPO,
                         capture_output=True, text=True, timeout=120)
    assert res.returncode != 0 and '"ok"' not in res.stdout
    shutil.copy(os.path.join(REPO, "chip_smoke.py"), tmp_path)
    res = subprocess.run([sys.executable, "chip_smoke.py"], cwd=tmp_path,
                         capture_output=True, text=True, timeout=120)
    assert res.returncode != 0 and '"ok"' not in res.stdout


def test_generation_modules_import_with_jax_blocked():
    """Beam-search generation and NMT serving by name (the walk above
    covers them too): the decoder, the host rung, the served model, the
    serving package's lazy exports, mixed, the step cells and the fused
    attention decoder."""
    names = ["paddle_tpu_torch.beam_search",
             "paddle_tpu_torch.serving.host_decode",
             "paddle_tpu_torch.serving.models",
             "paddle_tpu_torch.serving",
             "paddle_tpu_torch.layers.basic",
             "paddle_tpu_torch.layers.steps",
             "paddle_tpu_torch.layers.fused_text"]
    code = BLOCKED_IMPORT.replace(
        "for m in mods:", "mods = {names!r}\nfor m in mods:").format(
        forbidden=set(FORBIDDEN), names=names)
    code += ("from paddle_tpu_torch.serving import GenerationModel, "
             "host_generate\nprint('IMPORTED', len(mods))\n")
    res = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                         env=dict(os.environ, PYTHONPATH=REPO),
                         capture_output=True, text=True, timeout=120)
    assert res.returncode == 0, res.stderr
    assert res.stdout.split()[-1] == str(len(names))


def test_decoding_datasets_and_api_import_with_jax_blocked():
    """Beam and speculative decode over the page pool, speculative greedy
    decoding, the datasets and the top-level API's lazy names by name
    (the walk above covers the modules too)."""
    datasets = ["cifar", "common", "conll05", "flowers", "imdb", "imikolov",
                "mnist", "movielens", "mq2007", "sentiment", "uci_housing",
                "voc2012", "wmt14"]
    names = (["paddle_tpu_torch.decoding",
              "paddle_tpu_torch.decoding.kv_cache",
              "paddle_tpu_torch.decoding.speculative",
              "paddle_tpu_torch.serving.models",
              "paddle_tpu_torch.data.dataset"]
             + [f"paddle_tpu_torch.data.dataset.{d}" for d in datasets])
    assert all(os.path.join(PKG, *n.split(".")[1:]) + ".py" in _port_files()
               for n in names if n.count(".") > 1
               and not n.endswith(("decoding", "dataset")))
    code = BLOCKED_IMPORT.replace(
        "for m in mods:", "mods = {names!r}\nfor m in mods:").format(
        forbidden=set(FORBIDDEN), names=names)
    code += ("import paddle_tpu_torch as p\n"
             "for n in ('Arg', 'Network', 'SGD', 'infer', 'dataset', "
             "'reader', 'dsl', 'layers', 'models', 'optimizers', "
             "'evaluators', 'inference'):\n"
             "    getattr(p, n)\n"
             "p.dataset.imdb.word_dict()\n"
             "assert not any(k.split('.')[0] in {forbidden!r} "
             "for k in sys.modules)\n"
             "print('IMPORTED', len(mods))\n").format(
                 forbidden=set(FORBIDDEN))
    res = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                         env=dict(os.environ, PYTHONPATH=REPO),
                         capture_output=True, text=True, timeout=120)
    assert res.returncode == 0, res.stderr
    assert res.stdout.split()[-1] == str(len(names))


def test_paged_decoders_refuse_the_cpu_unless_asked(monkeypatch):
    """The beam and speculative paths go through a PagedKVCache, which
    takes the card unless the caller asks for the CPU."""
    from paddle_tpu_torch.decoding.kv_cache import PagedLM

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    spec = tlm.LMSpec(vocab=16, d_model=8, num_heads=2, num_layers=1)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        PagedKVCache(spec, num_pages=8)
    params = tlm.lm_init_params(spec, device="cpu")
    plm = PagedLM(spec, params, PagedKVCache(spec, num_pages=8,
                                             page_size=4, device="cpu"))
    toks, scores = plm.beam_generate(np.full((1, 3), 2, np.int32),
                                     np.asarray([3]), 2, 3)
    assert toks.shape == (1, 2, 3) and np.isfinite(scores).all()


def test_layer_tail_and_v1_front_end_import_with_jax_blocked():
    """The layer tail, the VAE and GAN confs and the v1 front end by name
    (the walk above covers them too)."""
    names = ["paddle_tpu_torch.layers.basic", "paddle_tpu_torch.layers.cost",
             "paddle_tpu_torch.layers.extras", "paddle_tpu_torch.layers.pool",
             "paddle_tpu_torch.layers.conv",
             "paddle_tpu_torch.layers.recurrent",
             "paddle_tpu_torch.layers.sampling",
             "paddle_tpu_torch.layers.detection",
             "paddle_tpu_torch.ops.detection", "paddle_tpu_torch.ops.topk",
             "paddle_tpu_torch.models.vae", "paddle_tpu_torch.models.gan",
             "paddle_tpu_torch.compat", "paddle_tpu_torch.compat.layers_v1",
             "paddle_tpu_torch.compat.layer_math",
             "paddle_tpu_torch.compat.raw_config",
             "paddle_tpu_torch.compat.config_parser",
             "paddle_tpu_torch.compat.v1_namespace",
             "paddle_tpu_torch.compat.v1_namespace.trainer_config_helpers",
             "paddle_tpu_torch.compat.v1_namespace.PyDataProvider2",
             "paddle_tpu_torch.compat.v1_namespace.config_parser"]
    files = _port_files()
    assert all(os.path.join(PKG, *n.split(".")[1:]) + ".py" in files
               or os.path.join(PKG, *n.split(".")[1:], "__init__.py") in files
               for n in names)
    code = BLOCKED_IMPORT.replace(
        "for m in mods:", "mods = {names!r}\nfor m in mods:").format(
        forbidden=set(FORBIDDEN), names=names)
    res = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                         env=dict(os.environ, PYTHONPATH=REPO),
                         capture_output=True, text=True, timeout=120)
    assert res.returncode == 0, res.stderr
    assert res.stdout.split()[-1] == str(len(names))


V1_PARSE = """
import os, sys
import chip_smoke
from paddle_tpu_torch.compat import config_parser as cp
from paddle_tpu_torch.network import Network

path, args = chip_smoke.write_v1_config({work!r}, vocab=40, hidden=4, emb=4)
tc = cp.parse_config(path, args)
net = Network(tc.model)
reader, types = tc.data_sources.train_reader()
sample = next(iter(reader()))
assert len(sample) == 2 and types[0].seq == 1
bad = [k for k in sys.modules
       if k.split(".")[0] in ("paddle", "paddle_tpu", "jax", "jaxlib")]
assert not bad, bad
print("PARSED", len(tc.model.layers))
"""


def test_v1_config_and_provider_parse_with_jax_and_the_shim_blocked(tmp_path):
    """A v1 config (`from paddle.trainer_config_helpers import *`) and its
    provider (`from paddle.trainer.PyDataProvider2 import *`) parse and
    load through the port in a process where jax, the JAX package and
    the repo-root `paddle` package cannot be imported; none of them is
    in sys.modules after."""
    block = BLOCKED_IMPORT.split("import paddle_tpu_torch")[0].format(
        forbidden=set(FORBIDDEN) | {"paddle"})
    code = block + V1_PARSE.format(work=str(tmp_path))
    res = subprocess.run([sys.executable, "-c", code], cwd=tmp_path,
                         env=dict(os.environ, PYTHONPATH=REPO),
                         capture_output=True, text=True, timeout=120)
    assert res.returncode == 0, res.stderr
    assert res.stdout.split()[-2] == "PARSED"


def test_flight_recorder_and_fleet_modules_import_with_jax_blocked():
    """The flight recorder and the fleet by name (the walk above covers
    them too): the recorder and the aggregation, the server's A6 parts,
    the fleet router, the merged-conf host, the verified cache, the
    online trainer and the replica/worker harness."""
    names = ["paddle_tpu_torch.obs", "paddle_tpu_torch.obs.flight_recorder",
             "paddle_tpu_torch.obs.aggregate",
             "paddle_tpu_torch.serving.server",
             "paddle_tpu_torch.serving.tcp",
             "paddle_tpu_torch.serving.fleet",
             "paddle_tpu_torch.serving.models",
             "paddle_tpu_torch.multi_network", "paddle_tpu_torch.inference",
             "paddle_tpu_torch.trainer.online",
             "paddle_tpu_torch.testing_faults"]
    files = _port_files()
    assert all(os.path.join(PKG, *n.split(".")[1:]) + ".py" in files
               or os.path.join(PKG, *n.split(".")[1:], "__init__.py") in files
               for n in names)
    code = BLOCKED_IMPORT.replace(
        "for m in mods:", "mods = {names!r}\nfor m in mods:").format(
        forbidden=set(FORBIDDEN), names=names)
    res = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                         env=dict(os.environ, PYTHONPATH=REPO),
                         capture_output=True, text=True, timeout=120)
    assert res.returncode == 0, res.stderr
    assert res.stdout.split()[-1] == str(len(names))


def test_custom_ops_guard_export_and_moe_modules_import_with_jax_blocked():
    """The custom ops, the recompile guard, export / load and the moe
    layer by name (the walk above covers them too); with jax and the JAX
    package blocked every kernel's op registers, and a compiled artifact
    exports and loads."""
    names = ["paddle_tpu_torch.ops._library",
             "paddle_tpu_torch.ops.bn_act_conv1x1",
             "paddle_tpu_torch.ops.flash_attention",
             "paddle_tpu_torch.ops.rnn", "paddle_tpu_torch.ops.sparse_rows",
             "paddle_tpu_torch.analysis.recompile_guard",
             "paddle_tpu_torch.ops.moe", "paddle_tpu_torch.layers.moe",
             "paddle_tpu_torch.inference"]
    files = _port_files()
    assert all(os.path.join(PKG, *n.split(".")[1:]) + ".py" in files
               for n in names)
    code = BLOCKED_IMPORT.replace(
        "for m in mods:", "mods = {names!r}\nfor m in mods:").format(
        forbidden=set(FORBIDDEN), names=names) + """
import torch
from paddle_tpu_torch import dsl, inference
from paddle_tpu_torch.core.arg import non_seq
from paddle_tpu_torch.network import Network
from paddle_tpu_torch.ops import _library
assert len(_library.OPS) == 13
for op in _library.OPS:
    getattr(torch.ops.paddle_tpu_torch, op)
with dsl.model() as g:
    dsl.moe(dsl.data("x", 8), num_experts=2, hidden=8, name="m")
    g.conf.output_layer_names.append("m")
net = Network(g.conf)
inf = inference.Inferencer(net, net.init_params(
    torch.Generator().manual_seed(0), device="cpu"), device="cpu")
feed = {"x": non_seq(torch.ones((4, 8)))}
out = inference.load_compiled(inference.export_compiled(inf, feed))(
    inf.params, inf.state, feed)
assert out["m"].value.shape == (4, 8)
assert not any(k.split(".")[0] in FORBIDDEN for k in sys.modules)
print("EXPORTED", len(mods))
""".replace("FORBIDDEN", repr(set(FORBIDDEN)))
    res = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                         env=dict(os.environ, PYTHONPATH=REPO),
                         capture_output=True, text=True, timeout=120)
    assert res.returncode == 0, res.stderr
    assert res.stdout.split()[-1] == str(len(names))


@pytest.mark.parametrize("src", ["SERVING_REPLICA_SRC",
                                 "SHARDED_CTR_TRAINER_SRC"])
def test_harness_sources_import_only_the_port(src):
    """The replica and worker sources are strings the harness runs in a
    subprocess: they import the port, the stdlib and numpy only."""
    from paddle_tpu_torch import testing_faults

    roots = set()
    for node in ast.walk(ast.parse(getattr(testing_faults, src))):
        if isinstance(node, ast.Import):
            roots |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            roots.add(node.module.split(".")[0])
    assert "paddle_tpu_torch" in roots
    assert not roots & set(FORBIDDEN)
    assert roots <= {"paddle_tpu_torch", "numpy", "torch", "json", "os",
                     "sys", "time", "threading", "math", "signal"}


def test_fleet_entry_points_refuse_the_cpu_unless_asked(monkeypatch):
    from paddle_tpu_torch import inference
    from paddle_tpu_torch.serving.models import MultiForwardHost

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    spec = tlm.LMSpec(vocab=16, d_model=8, num_heads=2, num_layers=1)
    conf = tlm.transformer_lm(spec)
    for call in (
        lambda: MultiForwardHost({"a": conf}, generator=torch.Generator()),
        lambda: inference.load_verified("/nonexistent", "k"),
    ):
        with pytest.raises(RuntimeError, match="device='cpu'"):
            call()


def test_mesh_modules_import_and_run_with_jax_blocked(tmp_path):
    """The mesh slice's modules by name (the walk above covers them too);
    with jax and the JAX package blocked, a one-rank gloo world on a
    FileStore builds its mesh and runs a data-parallel step, the ring,
    Ulysses, the pipeline and the row-sharded lookup."""
    names = ["paddle_tpu_torch.core.mesh",
             "paddle_tpu_torch.parallel.collectives",
             "paddle_tpu_torch.parallel.sharding",
             "paddle_tpu_torch.parallel.pipeline",
             "paddle_tpu_torch.parallel.world",
             "paddle_tpu_torch.parallel.ring",
             "paddle_tpu_torch.parallel.dp",
             "paddle_tpu_torch.parallel.sparse",
             "paddle_tpu_torch.parallel.sparse_shard"]
    files = _port_files()
    assert all(os.path.join(PKG, *n.split(".")[1:]) + ".py" in files
               for n in names)
    code = BLOCKED_IMPORT.replace(
        "for m in mods:", "mods = {names!r}\nfor m in mods:").format(
        forbidden=set(FORBIDDEN), names=names) + """
import torch
import torch.distributed as dist
from paddle_tpu_torch import dsl
from paddle_tpu_torch.core import mesh
from paddle_tpu_torch.core.arg import id_arg, non_seq
from paddle_tpu_torch.core.config import OptimizationConf
from paddle_tpu_torch.network import Network
from paddle_tpu_torch.optimizers import create_optimizer
from paddle_tpu_torch.parallel import pipeline, ring, sparse
from paddle_tpu_torch.parallel.dp import TrainStep

mesh.distributed_init(num_processes=1, process_id=0, device="cpu",
                      store=dist.FileStore(STORE, 1))
m = mesh.make_mesh({"data": 1, "seq": 1, "pipe": 1, "model": 1})
assert m.distributed and m.backend == "gloo"
with dsl.model() as g:
    y = dsl.fc(dsl.data("x", 4), size=2, act="softmax", name="y")
    dsl.classification_cost(y, dsl.data("l", 1, is_ids=True))
net = Network(g.conf)
opt = create_optimizer(OptimizationConf(learning_method="sgd"),
                       net.param_confs)
step = TrainStep(net, opt, mesh=m, device="cpu")
p = net.init_params(torch.Generator().manual_seed(0), device="cpu")
p, o, s = step.place(p, opt.init_state(p), {})
feed = {"x": non_seq(torch.ones((2, 4))), "l": id_arg(torch.tensor([0, 1]))}
p, o, s, loss, _ = step(p, o, s, feed, 0, None)
assert torch.isfinite(loss)
q = torch.randn(1, 8, 2, 4)
for f in (ring.ring_attention, ring.ulysses_attention):
    out = f(q, q, q, m, causal=True)
    assert torch.allclose(out, ring.dense_attention(q, q, q, causal=True),
                          atol=1e-5)
xs = torch.randn(3, 2, 4)
out = pipeline.pipeline_apply(m, "pipe", lambda w, x: x @ w, torch.eye(4),
                              xs)
assert torch.allclose(out, xs)
t = torch.randn(6, 3)
assert torch.equal(sparse.embedding_lookup(t, torch.tensor([5, 0]), m),
                   t[[5, 0]])
dist.destroy_process_group()
assert not any(k.split(".")[0] in FORBIDDEN for k in sys.modules)
print("MESH", len(mods))
""".replace("FORBIDDEN", repr(set(FORBIDDEN))).replace(
        "STORE", repr(str(tmp_path / "store")))
    res = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                         env=dict(os.environ, PYTHONPATH=REPO),
                         capture_output=True, text=True, timeout=120)
    assert res.returncode == 0, res.stderr
    assert res.stdout.split()[-1] == str(len(names))


def test_mesh_entry_points_refuse_the_cpu_unless_asked(monkeypatch,
                                                       tmp_path):
    from paddle_tpu_torch.core import mesh as tmesh

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for call in (
        lambda: tmesh.rank_device(None),
        lambda: tmesh.distributed_init(num_processes=2, process_id=0,
                                       store=object()),
    ):
        with pytest.raises(RuntimeError, match="device='cpu'"):
            call()
    assert tmesh.rank_device("cpu") == torch.device("cpu")


V1_RUNTIME_MODULES = [
    "paddle_tpu_torch.native", "paddle_tpu_torch.native.recordio",
    "paddle_tpu_torch.native.master", "paddle_tpu_torch.native.optimizer",
    "paddle_tpu_torch.data.master_client",
    "paddle_tpu_torch.data.master_serve", "paddle_tpu_torch.data.reader",
    "paddle_tpu_torch.compat.swig_api", "paddle_tpu_torch.compat.py2run",
    "paddle_tpu_torch.compat.py_paddle",
    "paddle_tpu_torch.compat.py_paddle.swig_paddle",
    "paddle_tpu_torch.compat.py_paddle.dataprovider_converter",
    "paddle_tpu_torch.api", "paddle_tpu_torch.capi_bridge"]


def test_v1_runtime_modules_import_with_jax_blocked():
    """The v1-era runtime by name (the walk above covers them too): the
    native loader and its wrappers, the networked master's client and
    server, the readers, the SWIG surface, py2run, the py_paddle
    namespace, api and the C ABI's bridge. Importing them builds
    nothing."""
    for n in V1_RUNTIME_MODULES:
        rel = os.path.join(PKG, *n.split(".")[1:])
        assert rel + ".py" in _port_files() or \
            os.path.join(rel, "__init__.py") in _port_files(), n
    code = BLOCKED_IMPORT.replace(
        "for m in mods:", "mods = {names!r}\nfor m in mods:").format(
        forbidden=set(FORBIDDEN), names=V1_RUNTIME_MODULES)
    code += ("from paddle_tpu_torch import native\n"
             "assert native._lib is None\n")
    res = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                         env=dict(os.environ, PYTHONPATH=REPO),
                         capture_output=True, text=True, timeout=120)
    assert res.returncode == 0, res.stderr
    assert res.stdout.split()[-1] == str(len(V1_RUNTIME_MODULES))


def test_port_native_sources_name_only_the_port():
    """The port's C/C++ sources, header, Makefile and examples name no
    `paddle_tpu.` / `paddle_tpu/` (only `paddle_tpu_torch`), and no port
    file builds or loads the JAX package's `native/lib`."""
    import re

    native_dir = os.path.join(PKG, "native")
    sources = [os.path.join(root, n) for root, _d, names in
               os.walk(native_dir) for n in names
               if n.endswith((".cc", ".h", ".c")) or n == "Makefile"]
    assert len(sources) >= 12
    jax_name = re.compile(r"\bpaddle_tpu[./]")
    bad = [(os.path.relpath(f, REPO), i + 1, line.strip())
           for f in sources for i, line in enumerate(open(f))
           if jax_name.search(line)]
    assert bad == []
    capi = open(os.path.join(native_dir, "src", "capi.cc")).read()
    assert 'PyImport_ImportModule("paddle_tpu_torch.capi_bridge")' in capi
    lib_refs = [(os.path.relpath(f, REPO), i + 1)
                for f in _port_files() + sources
                for i, line in enumerate(open(f))
                if "native/lib/" in line or "libpaddle_tpu_native" in line
                or "libpaddle_tpu_capi" in line]
    assert lib_refs == []
    from paddle_tpu_torch import native

    build = os.path.join(PKG, "build", "native")
    assert os.path.dirname(native.LIB_PATH) == build
    assert os.path.dirname(native.CAPI_PATH) == build
    assert native.EXAMPLES_DIR.startswith(native_dir)


def test_v1_entry_points_refuse_the_cpu_unless_asked(monkeypatch, tmp_path):
    from paddle_tpu_torch import api, capi_bridge
    from paddle_tpu_torch.compat import swig_api
    from paddle_tpu_torch.models.text import stacked_lstm_classifier
    from paddle_tpu_torch.trainer import checkpoint as ckpt

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    monkeypatch.delenv("PADDLE_TPU_FORCE_CPU", raising=False)
    conf = stacked_lstm_classifier(vocab_size=10, emb_dim=4, hidden=4,
                                   num_layers=1)
    net = Network(conf)
    merged = str(tmp_path / "m.npz")
    ckpt.merge_model(merged, conf, {
        k: v.numpy() for k, v in net.init_params(torch.Generator(),
                                                 device="cpu").items()})
    assert swig_api.isUsingGpu()
    for call in (
        lambda: swig_api.GradientMachine(conf),
        lambda: swig_api.GradientMachine.createFromConfigProto(conf),
        lambda: api.GradientMachine(conf),
        lambda: api.SequenceGenerator(None, None),
        lambda: capi_bridge.create(merged, "output"),
    ):
        with pytest.raises(RuntimeError, match="device='cpu'"):
            call()
    monkeypatch.setenv("PADDLE_TPU_FORCE_CPU", "1")
    h = capi_bridge.create(merged, "output")
    assert capi_bridge._HANDLES[h].device.type == "cpu"
    capi_bridge.destroy(h)
    assert swig_api.GradientMachine(conf, device="cpu").device.type == "cpu"


FRAMEWORK_MODULES = [
    "paddle_tpu_torch.framework", "paddle_tpu_torch.framework.scope",
    "paddle_tpu_torch.framework.op", "paddle_tpu_torch.framework.ops",
    "paddle_tpu_torch.framework.backward",
    "paddle_tpu_torch.framework.recurrent",
    "paddle_tpu_torch.compat.v2_framework",
    "paddle_tpu_torch.compat.v2_framework.core",
    "paddle_tpu_torch.compat.v2_framework.op",
    "paddle_tpu_torch.compat.v2_framework.default_scope_funcs",
    "paddle_tpu_torch.compat.v2_framework.gradient_checker",
    "paddle_tpu_torch.compat.v2_framework.op_test_util",
    "paddle_tpu_torch.compat.v2_framework.tests",
    "paddle_tpu_torch.compat.v2_framework.tests.gradient_checker",
    "paddle_tpu_torch.compat.v2_framework.tests.op_test_util"]


def test_op_framework_modules_import_with_jax_and_the_shim_blocked():
    """The op framework and the port's `paddle.v2.framework` by name,
    with jax, `paddle_tpu` and the repo-root `paddle` import-blocked: they
    import, `paddle_tpu_torch.framework` resolves, an op net runs, and a
    reference-style import through `v1_builtins` reaches the port's
    namespace."""
    for n in FRAMEWORK_MODULES:
        rel = os.path.join(PKG, *n.split(".")[1:])
        assert rel + ".py" in _port_files() or \
            os.path.join(rel, "__init__.py") in _port_files(), n
    blocked = set(FORBIDDEN) | {"paddle"}
    code = BLOCKED_IMPORT.replace(
        "for m in mods:", "mods = {names!r}\nfor m in mods:").format(
        forbidden=blocked, names=FRAMEWORK_MODULES)
    code += (
        "import numpy as np\n"
        "from paddle_tpu_torch.compat.config_parser import v1_builtins\n"
        "ns = {'__builtins__': v1_builtins()}\n"
        "exec('from paddle.v2.framework.op import Operator\\n'\n"
        "     'import paddle.v2.framework.core as core', ns)\n"
        "s = ns['core'].Scope(device='cpu')\n"
        "s.set('x', np.ones((2, 3), np.float32))\n"
        "ns['Operator']('scale', X='x', Out='y', scale=2.0).run(s)\n"
        "assert float(s.get('y').sum()) == 12.0\n"
        "assert paddle_tpu_torch.framework.NetOp\n"
        f"assert not any(k.split('.')[0] in {blocked!r} "
        "for k in sys.modules)\n")
    res = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                         env=dict(os.environ, PYTHONPATH=REPO),
                         capture_output=True, text=True, timeout=120)
    assert res.returncode == 0, res.stderr
    assert res.stdout.split()[-1] == str(len(FRAMEWORK_MODULES))
