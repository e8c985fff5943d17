"""The port stands alone: no JAX, nothing of `paddle_tpu`, no quiet CPU.

- An AST scan proves no file of `paddle_tpu_torch/` (nor
  `chip_smoke.py`) imports `jax`, `jaxlib` or `paddle_tpu`.
- A subprocess with those import-blocked imports every port module.
- An entry point (serving and training: params, caches, `Network`
  init, `TrainStep`, `SGD`) called without `device` on a machine
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
from paddle_tpu_torch.trainer.trainer import SGD
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
    ):
        with pytest.raises(RuntimeError, match="device='cpu'"):
            call()
    assert tdevice.resolve_device("cpu") == torch.device("cpu")
    assert params_from_numpy(params, device="cpu")["w"].device.type == "cpu"
    assert SGD(conf, opt_conf, seed=1, device="cpu").device.type == "cpu"


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
