"""PASCAL VOC2012 segmentation (python/paddle/v2/dataset/voc2012.py):
train/test/val readers yield (float32 CHW image, int32 HW label map)
(voc2012.py:62). Synthetic fallback: blocky two-object scenes over 21
classes (20 + background)."""

from __future__ import annotations

import numpy as np

from paddle_tpu_torch.data.dataset import common

__all__ = ["convert", "train", "test", "val"]

_CLASSES = 21
_HW = 32


def _creator(split_name, n):
    def reader():
        rng = common.synthetic_rng("voc2012", split_name)
        for _ in range(n):
            img = rng.uniform(0, 1, (3, _HW, _HW)).astype(np.float32)
            lbl = np.zeros((_HW, _HW), np.int32)
            for _ in range(int(rng.integers(1, 3))):
                c = int(rng.integers(1, _CLASSES))
                x, y = rng.integers(0, _HW - 8, 2)
                w, h = rng.integers(6, 12, 2)
                lbl[y : y + h, x : x + w] = c
                img[:, y : y + h, x : x + w] += c / _CLASSES
            yield np.clip(img, 0, 1.5), lbl

    return reader


def train():
    return _creator("train", 128)


def test():
    return _creator("test", 32)


def val():
    return _creator("val", 32)


def convert(path):
    """Write the dataset as chunked recordio files for the cloud/
    elastic-master input path (no reference convert for this module; added so every dataset
    feeds the cloud input path uniformly; common.convert -> go/master
    RecordIO tasks).
    """
    common.convert(path, train(), 200, "voc2012_train")
    common.convert(path, val(), 200, "voc2012_val")
    common.convert(path, test(), 200, "voc2012_test")
