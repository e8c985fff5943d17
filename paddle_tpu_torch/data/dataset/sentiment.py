"""NLTK movie-reviews sentiment (python/paddle/v2/dataset/sentiment.py):
get_word_dict() -> token->id; train()/test() yield ([word ids],
label 0=neg 1=pos), 9:1 split."""

from __future__ import annotations

from paddle_tpu_torch.data.dataset import common

__all__ = ["convert", "get_word_dict", "train", "test"]

_VOCAB = 180


def get_word_dict():
    d = {f"w{i}": i for i in range(_VOCAB)}
    return d


def _creator(split_name, n):
    def reader():
        rng = common.synthetic_rng("sentiment", split_name)
        for _ in range(n):
            label = int(rng.integers(0, 2))
            lean_lo = 20 if label else 100
            ln = int(rng.integers(6, 30))
            ids = [
                int(rng.integers(lean_lo, lean_lo + 40))
                if rng.random() < 0.6
                else int(rng.integers(0, _VOCAB))
                for _ in range(ln)
            ]
            yield ids, label

    return reader


def train():
    return _creator("train", 450)


def test():
    return _creator("test", 50)


def convert(path):
    """Write the dataset as chunked recordio files for the cloud/
    elastic-master input path (reference sentiment.py convert;
    common.convert -> go/master RecordIO tasks).
    """
    common.convert(path, train(), 1000, "sentiment_train")
    common.convert(path, test(), 1000, "sentiment_test")
