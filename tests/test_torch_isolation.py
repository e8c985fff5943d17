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
