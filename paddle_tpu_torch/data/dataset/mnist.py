"""MNIST (python/paddle/v2/dataset/mnist.py): samples are
(float32[784] pixels scaled to [-1, 1], int label 0-9); train 60k /
test 10k. Parses the cached idx-format gz files when present; otherwise
deterministic synthetic digits with the same schema."""

from __future__ import annotations

import gzip
import struct

import numpy as np

from paddle_tpu_torch.data.dataset import common

__all__ = ["convert", "train", "test"]

TRAIN_IMAGE_URL = (
    "http://yann.lecun.com/exdb/mnist/train-images-idx3-ubyte.gz"
)
TRAIN_LABEL_URL = (
    "http://yann.lecun.com/exdb/mnist/train-labels-idx1-ubyte.gz"
)
TEST_IMAGE_URL = "http://yann.lecun.com/exdb/mnist/t10k-images-idx3-ubyte.gz"
TEST_LABEL_URL = "http://yann.lecun.com/exdb/mnist/t10k-labels-idx1-ubyte.gz"


def _parse_idx(image_path, label_path):
    with gzip.open(image_path, "rb") as f:
        magic, n, rows, cols = struct.unpack(">IIII", f.read(16))
        assert magic == 2051, "bad idx image magic"
        images = np.frombuffer(f.read(n * rows * cols), np.uint8)
        images = images.reshape(n, rows * cols).astype(np.float32)
        images = images / 255.0 * 2.0 - 1.0  # mnist.py:66 scaling
    with gzip.open(label_path, "rb") as f:
        magic, n = struct.unpack(">II", f.read(8))
        assert magic == 2049, "bad idx label magic"
        labels = np.frombuffer(f.read(n), np.uint8).astype(np.int64)
    return images, labels


def _reader_creator(image_url, label_url, split_name, n_synth):
    def reader():
        try:
            images, labels = _parse_idx(
                common.download(image_url, "mnist"),
                common.download(label_url, "mnist"),
            )
        except FileNotFoundError:
            rng = common.synthetic_rng("mnist", split_name)
            labels = rng.integers(0, 10, n_synth)
            images = rng.uniform(-1, 1, (n_synth, 784)).astype(np.float32)
            # make classes linearly separable-ish so training can learn
            for c in range(10):
                images[labels == c, c * 70 : c * 70 + 40] += 1.5
            images = np.clip(images, -1.0, 1.0)
        for i in range(len(labels)):
            yield images[i], int(labels[i])

    return reader


def train():
    return _reader_creator(
        TRAIN_IMAGE_URL, TRAIN_LABEL_URL, "train", n_synth=1024
    )


def test():
    return _reader_creator(
        TEST_IMAGE_URL, TEST_LABEL_URL, "test", n_synth=256
    )


def convert(path):
    """Write the dataset as chunked recordio files for the cloud/
    elastic-master input path (reference mnist.py convert;
    common.convert -> go/master RecordIO tasks).
    """
    common.convert(path, train(), 1000, "mnist_train")
    common.convert(path, test(), 1000, "mnist_test")
