"""CIFAR-10/100 (python/paddle/v2/dataset/cifar.py): samples are
(float32[3072] pixels scaled to [0, 1], int label); parses the cached
python-version tarballs when present (pickled batches under
cifar-10-batches-py / cifar-100-python), else synthetic."""

from __future__ import annotations

import pickle
import tarfile

import numpy as np

from paddle_tpu_torch.data.dataset import common

__all__ = ["convert", "train10", "test10", "train100", "test100"]

CIFAR10_URL = "https://www.cs.toronto.edu/~kriz/cifar-10-python.tar.gz"
CIFAR100_URL = "https://www.cs.toronto.edu/~kriz/cifar-100-python.tar.gz"


def _tar_reader(url, sub_name, label_key):
    path = common.download(url, "cifar")

    def reader():
        with tarfile.open(path, mode="r") as f:
            names = [
                n for n in f.getnames() if sub_name in n.split("/")[-1]
            ]
            for name in names:
                batch = pickle.load(f.extractfile(name), encoding="bytes")
                data = batch[b"data"]
                labels = batch.get(label_key)
                for i in range(len(labels)):
                    yield (
                        (data[i] / 255.0).astype(np.float32),
                        int(labels[i]),
                    )

    return reader


def _synth_reader(split_name, num_classes, n):
    def reader():
        rng = common.synthetic_rng("cifar", split_name)
        labels = rng.integers(0, num_classes, n)
        for i in range(n):
            x = rng.uniform(0, 1, 3072).astype(np.float32)
            c = int(labels[i])
            x[c * 30 : c * 30 + 20] += 0.8
            yield np.clip(x, 0, 1), c

    return reader


def _creator(url, sub_name, label_key, split_name, num_classes, n_synth):
    def reader():
        try:
            inner = _tar_reader(url, sub_name, label_key)
        except FileNotFoundError:
            inner = _synth_reader(split_name, num_classes, n_synth)
        yield from inner()

    return reader


def train10():
    return _creator(CIFAR10_URL, "data_batch", b"labels", "train10", 10, 512)


def test10():
    return _creator(CIFAR10_URL, "test_batch", b"labels", "test10", 10, 128)


def train100():
    return _creator(CIFAR100_URL, "train", b"fine_labels", "train100", 100,
                    512)


def test100():
    return _creator(CIFAR100_URL, "test", b"fine_labels", "test100", 100,
                    128)


def convert(path):
    """Write the dataset as chunked recordio files for the cloud/
    elastic-master input path (reference cifar.py convert;
    common.convert -> go/master RecordIO tasks).
    """
    common.convert(path, train100(), 1000, "cifar_train100")
    common.convert(path, test100(), 1000, "cifar_test100")
    common.convert(path, train10(), 1000, "cifar_train10")
    common.convert(path, test10(), 1000, "cifar_test10")
