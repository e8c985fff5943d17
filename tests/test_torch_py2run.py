"""The port's `compat/py2run.py` against the JAX package's.

- `to_py3` gives the JAX package's output on a set of python-2 sources
  (print statements, xrange, cPickle, dict.has_key, except ..., ...);
  where lib2to3 is absent (it is on the card's machine) the port's own
  conversion runs them to the same output and namespace.
- A python-2 API driver in the shape of v1_api_demo/quick_start/
  api_train.py (`chip_smoke.PY2_DRIVER`: `from py_paddle import
  swig_paddle`, print statements, xrange, cPickle,
  DataProviderConverter, GradientMachine.createFromConfigProto,
  forwardBackward, ParameterUpdater) trains the v1 classifier config
  (`chip_smoke.V1_CLS_CONFIG`, at a small width) through both packages'
  `run_py2_script` from one merged model the JAX package wrote: the
  losses equal at 1e-4. In the port's run `py_paddle` resolves to
  `paddle_tpu_torch/compat/py_paddle` and `paddle.*` to the port's v1
  namespace, and the run leaves `sys.modules` unchanged.
"""

import os
import pickle
import sys

import numpy as np
import pytest

import chip_smoke as cs
from paddle_tpu.compat import py2run as jpy2run
from paddle_tpu.compat import swig_api as jswig
from paddle_tpu.compat.config_parser import parse_config as jparse
from paddle_tpu.trainer import checkpoint as jckpt
from paddle_tpu_torch.compat import py2run as tpy2run
from paddle_tpu_torch.compat import swig_api as tswig

PY2_SOURCES = {
    "print_statements": 'print "a", 1\nprint\nprint "x %d" % 3,\n',
    "xrange_and_dict": (
        "d = {}\nfor i in xrange(3):\n    d[i] = i\n"
        "if d.has_key(1):\n    print d.keys()\n"),
    "except_and_raise": (
        "try:\n    x = 1\nexcept ValueError, e:\n    raise KeyError, 'k'\n"),
    "imports": "import cPickle\nimport cStringIO\nimport Queue\n",
    "iterators": (
        "it = iter([1])\nv = it.next()\nm = map(str, [1])\n"
        "f = filter(None, [0, 1])\nz = zip([1], [2])\n"),
    "literals": "n = 10L\nu = u'x'\nb = basestring\nx = 0777\n",
    "already_py3": "print('fine')\nx = [i for i in range(3)]\n",
    "funcattrs_ne_reduce": (
        "def f(): pass\nc = f.func_name\nok = 1 <> 2\n"
        "s = reduce(lambda a, b: a + b, [1, 2])\n"),
    "redirect_and_views": (
        "import sys\nprint >>sys.stdout, 'x', 2,\nprint\n"
        "d = {'a': 1, 'b': 2}\nks = d.keys()\nks.sort()\n"
        "for k, v in sorted(d.iteritems()): print k, v\n"
        "first = d.values()[0] if d.has_key('a') else None\n"),
    "nested_and_compound": (
        "import cPickle, os.path as osp, Queue\n"
        "from cStringIO import StringIO\n"
        "q = Queue.Queue()\nbuf = StringIO()\n"
        "data = cPickle.loads(cPickle.dumps(map(str, xrange(3))))\n"
        "if len(filter(None, [0, 1, 2])) == 2: print 'two'; n = 3L\n"
        "pairs = zip(map(int, data), data)\n"
        "try:\n    raise ValueError, 'bad'\n"
        "except ValueError, err:\n    msg = str(err)\n"),
}


@pytest.mark.parametrize("name", sorted(PY2_SOURCES))
def test_to_py3_equal_to_jax(name):
    src = PY2_SOURCES[name]
    got = tpy2run.to_py3(src, name)
    assert got == jpy2run.to_py3(src, name)
    compile(got, name, "exec")
    assert tpy2run.to_py3(src, name, force=True) == \
        jpy2run.to_py3(src, name, force=True)


def _run(code):
    import contextlib
    import io

    out = io.StringIO()
    g = {"xrange": range}
    with contextlib.redirect_stdout(out):
        exec(compile(code, "<py2>", "exec"), g)
    plain = (int, float, str, bool, list, tuple, dict, type(None))
    return out.getvalue(), {k: v for k, v in g.items()
                            if isinstance(v, plain) and k != "__builtins__"}


@pytest.mark.parametrize("name", sorted(PY2_SOURCES))
def test_conversion_without_lib2to3_runs_alike(name):
    """The port's own conversion (used where lib2to3 cannot be imported)
    runs each source to lib2to3's conversion's stdout and namespace."""
    src = PY2_SOURCES[name]
    ours = tpy2run._to_py3_tokens(src)
    theirs = tpy2run.to_py3(src, name, force=True)
    assert _run(ours) == _run(theirs)
    # idempotent: a second conversion changes nothing
    assert tpy2run._to_py3_tokens(ours) == ours


def test_to_py3_falls_back_when_lib2to3_is_missing(monkeypatch):
    src = PY2_SOURCES["print_statements"]
    for m in ("lib2to3", "lib2to3.refactor"):
        monkeypatch.setitem(sys.modules, m, None)
    assert tpy2run.to_py3(src) == tpy2run._to_py3_tokens(src)
    assert tpy2run.to_py3("print('py3')\n") == "print('py3')\n"


SMALL = dict(vocab=40, emb=8, hidden=8, layers=2, batch_size=6)
STEPS = 4


def _batches(n, seed=0):
    rng = np.random.default_rng(seed)
    return [[(rng.integers(0, SMALL["vocab"], int(rng.integers(3, 12)))
              .tolist(), int(rng.integers(0, 2)), i)
             for i in range(SMALL["batch_size"])] for _ in range(n)]


@pytest.fixture
def driver_files(tmp_path):
    config, config_args = cs.write_v1_cls(str(tmp_path), **SMALL)
    driver = tmp_path / "api_train.py"
    driver.write_text(cs.PY2_DRIVER)
    data = tmp_path / "batches.pkl"
    with open(data, "wb") as f:
        pickle.dump(_batches(3), f, 2)
    # one model for both packages, written by the JAX package
    tc = jparse(config, config_args)
    gm = jswig.GradientMachine(tc.model_config, seed=3)
    merged = str(tmp_path / "model.npz")
    jckpt.merge_model(merged, tc.model_config,
                      {k: np.asarray(v) for k, v in gm.params.items()})
    return [config, config_args, merged, str(data), str(STEPS), "0"], driver


def test_py2_driver_trains_equal_through_both_packages(driver_files,
                                                       capsys):
    argv, driver = driver_files
    from paddle_tpu_torch.compat import py_paddle
    from paddle_tpu_torch.compat.py_paddle import DataProviderConverter

    # the port's run first: nothing of the JAX package's shims loaded
    # for it, and nothing new under those names after it
    before = dict(sys.modules)
    try:
        g = tpy2run.run_py2_script(str(driver), argv=argv)
    finally:
        tswig.setUseGpu(True)
    new = set(sys.modules) - set(before)
    assert not any(m.split(".")[0] in ("py_paddle", "paddle") for m in new)
    assert all(sys.modules[k] is v for k, v in before.items())
    assert g["swig_paddle"] is py_paddle.swig_paddle
    assert g["DataProviderConverter"] is DataProviderConverter
    assert g["parse_config"].__module__.startswith("paddle_tpu_torch.")
    out = capsys.readouterr().out
    assert out.count("cost") == STEPS
    # a second run imports nothing
    names = set(sys.modules)
    g2 = tpy2run.run_py2_script(str(driver), argv=argv)
    tswig.setUseGpu(True)
    assert set(sys.modules) == names
    assert g2["LOSSES"] == g["LOSSES"]
    jg = jpy2run.run_py2_script(str(driver), argv=argv)
    assert jg["swig_paddle"].__name__ == "py_paddle.swig_paddle"
    got, want = np.asarray(g["LOSSES"]), np.asarray(jg["LOSSES"])
    assert len(got) == len(want) == STEPS
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-4)
    assert got[-1] != got[0]


def test_py2_driver_without_lib2to3(driver_files, monkeypatch):
    """The API script through the port's own conversion trains to the same
    losses as through lib2to3's."""
    argv, driver = driver_files
    want = tpy2run.run_py2_script(str(driver), argv=argv)["LOSSES"]
    for m in ("lib2to3", "lib2to3.refactor"):
        monkeypatch.setitem(sys.modules, m, None)
    try:
        got = tpy2run.run_py2_script(str(driver), argv=argv)["LOSSES"]
    finally:
        tswig.setUseGpu(True)
    assert got == want and len(got) == STEPS


def test_py2_driver_refuses_the_cpu_unless_asked(driver_files,
                                                 monkeypatch):
    """use_gpu=1 (the script's own flag) on a machine without a card
    raises instead of running on the CPU."""
    import torch

    argv, driver = driver_files
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tpy2run.run_py2_script(str(driver), argv=argv[:-1] + ["1"])
    assert tswig.isUsingGpu()


def test_load_py2_module_with_v1_builtins(tmp_path):
    helper = tmp_path / "helper_util.py"
    helper.write_text(
        "from py_paddle import swig_paddle\n"
        "def twice(xs):\n    return [2 * x for x in xrange(xs)]\n"
        "def gpu():\n    print 'gpu', swig_paddle.isGpuVersion()\n"
        "    return swig_paddle.isGpuVersion()\n")
    try:
        mod = tpy2run.load_py2_module(str(helper), "helper_util")
        assert mod.twice(3) == [0, 2, 4]
        assert mod.gpu() is True
        assert sys.modules["helper_util"] is mod
    finally:
        sys.modules.pop("helper_util", None)
    assert "py_paddle" not in sys.modules or \
        sys.modules["py_paddle"].__file__.startswith(
            os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
