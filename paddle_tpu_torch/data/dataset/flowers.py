"""Oxford-102 flowers (python/paddle/v2/dataset/flowers.py): train/
test/valid readers yield (float32 CHW image flattened, label 0..101)
(flowers.py:119 yields label-1). Synthetic fallback: small 3x32x32
class-tinted images."""

from __future__ import annotations

import numpy as np

from paddle_tpu_torch.data.dataset import common

__all__ = ["convert", "train", "test", "valid"]

_CLASSES = 102
_SHAPE = (3, 32, 32)


def _creator(split_name, n):
    def reader():
        rng = common.synthetic_rng("flowers", split_name)
        for _ in range(n):
            label = int(rng.integers(0, _CLASSES))
            img = rng.uniform(0, 1, _SHAPE).astype(np.float32)
            img[label % 3] += (label / _CLASSES) * 0.5
            yield np.clip(img, 0, 1).flatten(), label

    return reader


def train(mapper=None, buffered_size=1024, use_xmap=False):
    return _creator("train", 408)


def test(mapper=None, buffered_size=1024, use_xmap=False):
    return _creator("test", 102)


def valid(mapper=None, buffered_size=1024, use_xmap=False):
    return _creator("valid", 102)


def convert(path):
    """Write the dataset as chunked recordio files for the cloud/
    elastic-master input path (no reference convert for this module; added so every dataset
    feeds the cloud input path uniformly; common.convert -> go/master
    RecordIO tasks).
    """
    common.convert(path, train(), 200, "flowers_train")
    common.convert(path, valid(), 200, "flowers_valid")
    common.convert(path, test(), 200, "flowers_test")
