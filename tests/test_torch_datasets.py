"""The port's datasets (`paddle_tpu_torch/data/dataset/`) and top-level API
(`paddle_tpu_torch/__init__.py`) against the JAX package's.

- Every module's synthetic train and test streams (the fallback when no
  file is cached) equal the JAX module's, sample by sample, for the
  first N samples; the dictionaries and embeddings too.
- Cached files built here (mnist's idx gz, cifar's pickled batches in a
  tar, imdb's review tar, uci_housing's table) under a temporary
  `DATA_HOME` of both packages: the same parsed streams. `split` and
  `cluster_files_reader` round trip as the JAX tests do them;
  `common.convert` and the modules' `convert` write files byte-equal to
  the JAX package's.
- `init(**flags)` sets the port's flags, the lazy attributes resolve to
  the port's modules, the names not ported raise naming their ROADMAP
  item, and `import paddle_tpu_torch` imports no submodule.
"""

import gzip
import io
import os
import pickle
import struct
import subprocess
import sys
import tarfile

import numpy as np
import pytest

from paddle_tpu.data import reader as JR
from paddle_tpu.data import dataset as jds
from paddle_tpu.data.dataset import common as jcommon
from paddle_tpu_torch.data import reader as TR
from paddle_tpu_torch.data import dataset as tds
from paddle_tpu_torch.data.dataset import common as tcommon

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
N = 40


def take(reader, n=N):
    out = []
    for i, s in enumerate(reader()):
        if i >= n:
            break
        out.append(s)
    return out


def _same_sample(a, b):
    assert type(a) is type(b) or (isinstance(a, np.ndarray)
                                  and isinstance(b, np.ndarray))
    if isinstance(a, np.ndarray):
        assert a.dtype == b.dtype and a.shape == b.shape
        np.testing.assert_array_equal(a, b)
    elif isinstance(a, (tuple, list)):
        assert len(a) == len(b)
        for x, y in zip(a, b):
            _same_sample(x, y)
    else:
        assert a == b


def _same_stream(t_reader, j_reader, n=N):
    got, want = take(t_reader, n), take(j_reader, n)
    assert len(got) == len(want) > 0
    for a, b in zip(got, want):
        _same_sample(a, b)


def _readers(pkg):
    """{name: reader} of every module's streams."""
    d = pkg
    imdb_dict = d.imdb.word_dict()
    imik = d.imikolov.build_dict(min_word_freq=2)
    return {
        "mnist_train": d.mnist.train(), "mnist_test": d.mnist.test(),
        "cifar_train10": d.cifar.train10(), "cifar_test10": d.cifar.test10(),
        "cifar_train100": d.cifar.train100(),
        "cifar_test100": d.cifar.test100(),
        "uci_train": d.uci_housing.train(), "uci_test": d.uci_housing.test(),
        "imdb_train": d.imdb.train(imdb_dict),
        "imdb_test": d.imdb.test(imdb_dict),
        "imikolov_ngram": d.imikolov.train(imik, 4),
        "imikolov_seq": d.imikolov.test(imik, 0, d.imikolov.DataType.SEQ),
        "wmt14_train": d.wmt14.train(30), "wmt14_test": d.wmt14.test(30),
        "movielens_train": d.movielens.train(),
        "movielens_test": d.movielens.test(),
        "conll05_test": d.conll05.test(),
        "sentiment_train": d.sentiment.train(),
        "sentiment_test": d.sentiment.test(),
        "mq2007_pointwise": d.mq2007.train("pointwise"),
        "mq2007_pairwise": d.mq2007.train("pairwise"),
        "mq2007_listwise": d.mq2007.test("listwise"),
        "flowers_train": d.flowers.train(), "flowers_test": d.flowers.test(),
        "flowers_valid": d.flowers.valid(),
        "voc_train": d.voc2012.train(), "voc_test": d.voc2012.test(),
        "voc_val": d.voc2012.val(),
    }


STREAMS = sorted(_readers(tds))


@pytest.mark.parametrize("name", STREAMS)
def test_synthetic_stream_equals_jax(name):
    _same_stream(_readers(tds)[name], _readers(jds)[name])


def test_dictionaries_and_tables_equal_jax():
    assert tds.imdb.word_dict() == jds.imdb.word_dict()
    assert tds.imikolov.build_dict(2) == jds.imikolov.build_dict(2)
    assert tds.sentiment.get_word_dict() == jds.sentiment.get_word_dict()
    for a, b in zip(tds.conll05.get_dict(), jds.conll05.get_dict()):
        assert a == b
    np.testing.assert_array_equal(tds.conll05.get_embedding(16),
                                  jds.conll05.get_embedding(16))
    assert tds.wmt14.get_dict(30) == jds.wmt14.get_dict(30)
    for fn in ("movie_categories", "get_movie_title_dict", "max_user_id",
               "max_movie_id", "max_job_id"):
        assert getattr(tds.movielens, fn)() == getattr(jds.movielens, fn)()
    assert tds.mq2007.FEATURE_DIM == jds.mq2007.FEATURE_DIM
    assert tds.__all__ == jds.__all__
    assert tcommon.DATA_HOME == jcommon.DATA_HOME


def test_require_real_data_turns_the_fallback_into_an_error():
    tcommon.require_real_data(True)
    try:
        with pytest.raises(FileNotFoundError):
            take(tds.mnist.train(), 1)
    finally:
        tcommon.require_real_data(False)
    assert take(tds.mnist.train(), 1)


# ---- cached files ----------------------------------------------------------

@pytest.fixture
def data_home(tmp_path, monkeypatch):
    """One temporary DATA_HOME for both packages, uci_housing's cached
    table reset in both."""
    for common in (tcommon, jcommon):
        monkeypatch.setattr(common, "DATA_HOME", str(tmp_path))
    for mod in (tds.uci_housing, jds.uci_housing):
        for g in ("UCI_TRAIN_DATA", "UCI_TEST_DATA", "_RANGES"):
            monkeypatch.setattr(mod, g, None)
    return tmp_path


def _cache(home, module, url, data: bytes):
    d = os.path.join(str(home), module)
    os.makedirs(d, exist_ok=True)
    with open(os.path.join(d, url.split("/")[-1]), "wb") as f:
        f.write(data)


def _tar(members: dict) -> bytes:
    buf = io.BytesIO()
    with tarfile.open(fileobj=buf, mode="w:gz") as t:
        for name, data in members.items():
            info = tarfile.TarInfo(name)
            info.size = len(data)
            t.addfile(info, io.BytesIO(data))
    return buf.getvalue()


def test_cached_mnist_idx_files(data_home):
    rng = np.random.default_rng(0)
    n = 7
    images = rng.integers(0, 256, (n, 784)).astype(np.uint8)
    labels = rng.integers(0, 10, n).astype(np.uint8)
    m = tds.mnist
    for img_url, lbl_url in ((m.TRAIN_IMAGE_URL, m.TRAIN_LABEL_URL),
                             (m.TEST_IMAGE_URL, m.TEST_LABEL_URL)):
        _cache(data_home, "mnist", img_url, gzip.compress(
            struct.pack(">IIII", 2051, n, 28, 28) + images.tobytes()))
        _cache(data_home, "mnist", lbl_url, gzip.compress(
            struct.pack(">II", 2049, n) + labels.tobytes()))
    got = take(tds.mnist.train())
    assert len(got) == n and got[3][1] == int(labels[3])
    _same_stream(tds.mnist.train(), jds.mnist.train())
    _same_stream(tds.mnist.test(), jds.mnist.test())


def test_cached_cifar_tar(data_home):
    rng = np.random.default_rng(1)
    batch = {b"data": rng.integers(0, 256, (5, 3072)).astype(np.uint8),
             b"labels": [3, 1, 4, 1, 5]}
    _cache(data_home, "cifar", tds.cifar.CIFAR10_URL, _tar({
        "cifar-10-batches-py/data_batch_1": pickle.dumps(batch),
        "cifar-10-batches-py/test_batch": pickle.dumps(batch)}))
    got = take(tds.cifar.train10())
    assert [s[1] for s in got] == [3, 1, 4, 1, 5]
    _same_stream(tds.cifar.train10(), jds.cifar.train10())
    _same_stream(tds.cifar.test10(), jds.cifar.test10())


def test_cached_imdb_tar(data_home):
    docs = {"aclImdb/train/pos/0_9.txt": b"A fine film, a FINE cast!",
            "aclImdb/train/neg/1_2.txt": b"Dull; dull and long.",
            "aclImdb/test/pos/2_8.txt": b"fine fine film",
            "aclImdb/test/neg/3_1.txt": b"long and dull",
            "aclImdb/train/unsup/4_0.txt": b"never counted"}
    _cache(data_home, "imdb", tds.imdb.URL, _tar(docs))
    d = tds.imdb.word_dict(cutoff=2)
    assert d == jds.imdb.word_dict(cutoff=2) and "never" not in d
    _same_stream(tds.imdb.train(d), jds.imdb.train(d))
    _same_stream(tds.imdb.test(d), jds.imdb.test(d))
    assert [s[1] for s in take(tds.imdb.train(d))] == [0, 1]


def test_cached_uci_housing_table(data_home):
    rng = np.random.default_rng(2)
    table = rng.uniform(0, 50, (30, 14))
    _cache(data_home, "uci_housing", tds.uci_housing.URL,
           "\n".join(" ".join(f"{x:.4f}" for x in row)
                     for row in table).encode())
    _same_stream(tds.uci_housing.train(), jds.uci_housing.train())
    _same_stream(tds.uci_housing.test(), jds.uci_housing.test())
    assert len(take(tds.uci_housing.train(), 100)) == 24
    for a, b in zip(tds.uci_housing.feature_range(),
                    jds.uci_housing.feature_range()):
        np.testing.assert_array_equal(a, b)


def test_split_and_cluster_files_reader(tmp_path):
    rd = tds.uci_housing.test()
    files = tcommon.split(rd, 25, suffix=str(tmp_path / "h-%05d.pickle"))
    assert len(files) > 1
    got = []
    for tid in range(2):
        got += list(tcommon.cluster_files_reader(
            str(tmp_path / "h-*.pickle"), trainer_count=2,
            trainer_id=tid)())
    want = list(jds.uci_housing.test()())
    assert len(got) == len(want)
    j_files = jcommon.split(jds.uci_housing.test(), 25,
                            suffix=str(tmp_path / "j-%05d.pickle"))
    for a, b in zip(files, j_files):
        with open(a, "rb") as fa, open(b, "rb") as fb:
            assert fa.read() == fb.read()


def test_convert_writes_files_equal_to_jax(tmp_path):
    def files(d):
        return {f: open(os.path.join(d, f), "rb").read()
                for f in sorted(os.listdir(d))}

    rows = [(i, [i, 2 * i]) for i in range(9)]
    assert len(tcommon.convert(str(tmp_path / "t"), lambda: iter(rows), 4,
                               "toy")) == 3
    jcommon.convert(str(tmp_path / "j"), lambda: iter(rows), 4, "toy")
    for name in ("mnist", "uci_housing", "imdb"):
        getattr(tds, name).convert(str(tmp_path / "t"))
        getattr(jds, name).convert(str(tmp_path / "j"))
    got, want = files(str(tmp_path / "t")), files(str(tmp_path / "j"))
    assert len(got) == 3 + 3 + 2 + 2 and got == want
    assert list(TR.recordio(str(tmp_path / "t" / "toy-00002.recordio"))()) \
        == [(8, [8, 16])]


def test_streams_through_the_port_readers():
    """The JAX test's combinator case: buffered(shuffle(...)) over the
    test stream, and batched in the port equal to batched in JAX."""
    rd = TR.buffered(TR.shuffle(tds.mnist.test(), 64), 32)
    assert sum(1 for _ in rd()) == 256
    got = list(TR.batched(tds.imdb.train(tds.imdb.word_dict()), 64)())
    want = list(JR.batched(jds.imdb.train(jds.imdb.word_dict()), 64)())
    assert len(got) == len(want) == 4
    for a, b in zip(got, want):
        _same_sample(a, b)


# ---- the top-level API -----------------------------------------------------

def test_init_sets_the_ports_flags():
    import paddle_tpu_torch as paddle
    from paddle_tpu_torch.core import flags

    old = flags.get_flag("log_period")
    try:
        paddle.init(log_period=7, seed=3)
        assert flags.get_flag("log_period") == 7
        assert flags.get_flag("seed") == 3
    finally:
        flags.set_flag("log_period", old)
        flags.set_flag("seed", 0)


LAZY = {
    "dsl": "paddle_tpu_torch.dsl",
    "layers": "paddle_tpu_torch.layers",
    "models": "paddle_tpu_torch.models",
    "optimizers": "paddle_tpu_torch.optimizers",
    "evaluators": "paddle_tpu_torch.evaluators",
    "inference": "paddle_tpu_torch.inference",
    "dataset": "paddle_tpu_torch.data.dataset",
    "reader": "paddle_tpu_torch.data.reader",
}


@pytest.mark.parametrize("name", sorted(LAZY))
def test_lazy_modules_resolve_to_the_port(name):
    import paddle_tpu
    import paddle_tpu_torch as paddle

    mod = getattr(paddle, name)
    assert mod.__name__ == LAZY[name]
    # the same name resolves in the JAX package, to its counterpart
    assert getattr(paddle_tpu, name).__name__ == LAZY[name].replace(
        "paddle_tpu_torch", "paddle_tpu")


def test_lazy_classes_and_functions():
    import paddle_tpu_torch as paddle
    from paddle_tpu_torch.core.arg import Arg
    from paddle_tpu_torch.inference import infer
    from paddle_tpu_torch.network import Network
    from paddle_tpu_torch.trainer.trainer import SGD

    assert paddle.Arg is Arg and paddle.Network is Network
    assert paddle.SGD is SGD and paddle.infer is infer
    assert paddle.dataset.imdb is tds.imdb
    with pytest.raises(AttributeError, match="no attribute 'nope'"):
        paddle.nope


def test_api_resolves_to_the_ports_api_module():
    import paddle_tpu_torch as paddle
    from paddle_tpu_torch import api

    assert paddle.api is api and hasattr(paddle, "api")
    assert api.__name__ == "paddle_tpu_torch.api"
    assert api.SequenceGenerator.__module__ == "paddle_tpu_torch.api"


def test_framework_resolves_to_the_ports_op_framework():
    import paddle_tpu_torch as paddle
    from paddle_tpu_torch import framework

    assert paddle.framework is framework and hasattr(paddle, "framework")
    assert framework.NetOp.__module__ == "paddle_tpu_torch.framework.op"


@pytest.mark.parametrize("name,item", [("plot", "A12"), ("image", "A12")])
def test_names_not_ported_raise_naming_their_item(name, item):
    import paddle_tpu_torch as paddle

    with pytest.raises(NotImplementedError, match=f"ROADMAP {item}"):
        getattr(paddle, name)
    assert not hasattr(paddle, name)


@pytest.mark.parametrize("name", ["get_mesh", "set_mesh"])
def test_mesh_names_resolve_to_the_port_mesh(name):
    import paddle_tpu_torch as paddle
    from paddle_tpu_torch.core import mesh

    assert getattr(paddle, name) is getattr(mesh, name)
    assert hasattr(paddle, name)


def test_import_loads_no_submodule():
    code = ("import sys, paddle_tpu_torch\n"
            "print(sorted(m for m in sys.modules "
            "if m.startswith('paddle_tpu_torch.')))\n"
            "print('torch' in sys.modules)\n")
    res = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                         env=dict(os.environ, PYTHONPATH=REPO),
                         capture_output=True, text=True, timeout=120)
    assert res.returncode == 0, res.stderr
    assert res.stdout.split("\n")[:2] == ["[]", "False"]
