"""Dataset cache plumbing.

Reference: python/paddle/v2/dataset/common.py (DATA_HOME, download with
md5 verification, split, cluster_files_reader, convert-to-recordio).

This environment has no network egress, so `download` only resolves
already-cached files; when a dataset file is absent the dataset modules
fall back to a DETERMINISTIC synthetic sample stream with the exact
reference schema (shapes, dtypes, vocabulary behavior) so pipelines,
trainers and tests exercise the same code paths. Set
`require_real_data(True)` to turn the fallback into an error instead.

The port's copy of `paddle_tpu/data/dataset/common.py`: the same cache
directory (`PADDLE_TPU_DATA_HOME`, default
`~/.cache/paddle_tpu/dataset`), the same synthetic streams. `convert`
writes through the port's own build of the native recordio writer
(`paddle_tpu_torch/native/recordio.py`), byte-equal to the JAX
package's files.
"""

from __future__ import annotations

import hashlib
import os
import pickle

import numpy as np

__all__ = [
    "DATA_HOME",
    "cached_path",
    "download",
    "md5file",
    "split",
    "cluster_files_reader",
    "convert",
    "require_real_data",
    "synthetic_rng",
]

DATA_HOME = os.path.expanduser(
    os.environ.get("PADDLE_TPU_DATA_HOME", "~/.cache/paddle_tpu/dataset")
)

_REQUIRE_REAL = False


def require_real_data(flag: bool = True) -> None:
    global _REQUIRE_REAL
    _REQUIRE_REAL = flag


def md5file(fname: str) -> str:
    h = hashlib.md5()
    with open(fname, "rb") as f:
        for chunk in iter(lambda: f.read(1 << 16), b""):
            h.update(chunk)
    return h.hexdigest()


def cached_path(url: str, module_name: str, md5sum: str = None):
    """Path where `download` would store this url's file."""
    d = os.path.join(DATA_HOME, module_name)
    return os.path.join(d, url.split("/")[-1])


def download(url: str, module_name: str, md5sum: str = None) -> str:
    """Return the cached file for `url`, verifying md5 when given.
    No egress: if the file is not already in DATA_HOME, raises (caller
    modules catch this and emit synthetic data unless
    require_real_data(True))."""
    path = cached_path(url, module_name)
    if os.path.exists(path):
        if md5sum and md5file(path) != md5sum:
            raise IOError(f"md5 mismatch for cached {path}")
        return path
    raise FileNotFoundError(
        f"{path} not cached and downloads are disabled; place the file "
        f"there manually or rely on the synthetic fallback"
    )


def synthetic_rng(module_name: str, split_name: str) -> np.random.Generator:
    """Deterministic per-(dataset, split) generator for the fallback."""
    if _REQUIRE_REAL:
        raise FileNotFoundError(
            f"real data for {module_name}/{split_name} not cached and "
            f"require_real_data(True) is set"
        )
    seed = int.from_bytes(
        hashlib.md5(f"{module_name}:{split_name}".encode()).digest()[:4],
        "little",
    )
    return np.random.default_rng(seed)


def split(reader, line_count: int, suffix: str = "%05d.pickle",
          dumper=None):
    """Split a reader's samples into pickled chunk files
    (common.py split)."""
    dumper = dumper or (lambda obj, f: pickle.dump(obj, f, 2))
    buf, index = [], 0
    out = []
    for sample in reader():
        buf.append(sample)
        if len(buf) == line_count:
            fname = suffix % index
            with open(fname, "wb") as f:
                dumper(buf, f)
            out.append(fname)
            buf, index = [], index + 1
    if buf:
        fname = suffix % index
        with open(fname, "wb") as f:
            dumper(buf, f)
        out.append(fname)
    return out


def cluster_files_reader(files_pattern: str, trainer_count: int,
                         trainer_id: int, loader=None):
    """Round-robin shard chunk files across trainers
    (common.py cluster_files_reader)."""
    import glob

    loader = loader or (lambda f: pickle.load(f))

    def reader():
        file_list = sorted(glob.glob(files_pattern))
        my_files = [
            f
            for i, f in enumerate(file_list)
            if i % trainer_count == trainer_id
        ]
        for fn in my_files:
            with open(fn, "rb") as f:
                for sample in loader(f):
                    yield sample

    return reader


def convert(output_path: str, reader, line_count: int, name_prefix: str):
    """Serialize a reader into chunked recordio files for the elastic
    master (common.py convert; go/master RecordIO tasks) using the
    port's native chunked record writer: `line_count` samples a file,
    each pickled with protocol 2, the files byte-equal to the JAX
    package's. Returns the paths written."""
    from paddle_tpu_torch.native.recordio import RecordWriter

    os.makedirs(output_path, exist_ok=True)
    buf, index = [], 0
    paths = []

    def flush(buf, index):
        path = os.path.join(
            output_path, f"{name_prefix}-{index:05d}.recordio"
        )
        w = RecordWriter(path)
        for sample in buf:
            w.write(pickle.dumps(sample, 2))
        w.close()
        paths.append(path)

    for sample in reader():
        buf.append(sample)
        if len(buf) == line_count:
            flush(buf, index)
            buf, index = [], index + 1
    if buf:
        flush(buf, index)
    return paths
