"""UCI housing (python/paddle/v2/dataset/uci_housing.py): samples are
(float32[13] normalized features, float32[1] price). 80/20 train/test
split of the 506-row table, features normalized (x-avg)/(max-min) —
uci_housing.py:57-69."""

from __future__ import annotations

import numpy as np

from paddle_tpu_torch.data.dataset import common

__all__ = ["convert", "train", "test", "feature_range"]

URL = (
    "https://archive.ics.uci.edu/ml/machine-learning-databases/housing/"
    "housing.data"
)
FEATURE_NUM = 14

UCI_TRAIN_DATA = None
UCI_TEST_DATA = None
_RANGES = None


def feature_range():
    return _RANGES


def _load():
    global UCI_TRAIN_DATA, UCI_TEST_DATA, _RANGES
    if UCI_TRAIN_DATA is not None:
        return
    try:
        path = common.download(URL, "uci_housing")
        data = np.fromfile(path, sep=" ")
        data = data.reshape(-1, FEATURE_NUM)
    except FileNotFoundError:
        rng = common.synthetic_rng("uci_housing", "all")
        x = rng.uniform(0, 100, (506, FEATURE_NUM - 1))
        w = rng.standard_normal(FEATURE_NUM - 1)
        y = x @ w / 50.0 + rng.normal(0, 1, 506)
        data = np.concatenate([x, y[:, None]], axis=1)
    mx, mn, avg = data.max(0), data.min(0), data.mean(0)
    _RANGES = (mn[:-1], mx[:-1])
    for i in range(FEATURE_NUM - 1):
        data[:, i] = (data[:, i] - avg[i]) / (mx[i] - mn[i])
    offset = int(data.shape[0] * 0.8)
    UCI_TRAIN_DATA = data[:offset].astype(np.float32)
    UCI_TEST_DATA = data[offset:].astype(np.float32)


def train():
    def reader():
        _load()
        for d in UCI_TRAIN_DATA:
            yield d[:-1], d[-1:]

    return reader


def test():
    def reader():
        _load()
        for d in UCI_TEST_DATA:
            yield d[:-1], d[-1:]

    return reader


def convert(path):
    """Write the dataset as chunked recordio files for the cloud/
    elastic-master input path (reference uci_housing.py convert;
    common.convert -> go/master RecordIO tasks).
    """
    common.convert(path, train(), 1000, "uci_housing_train")
    common.convert(path, test(), 1000, "uci_housing_test")
