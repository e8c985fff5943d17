"""IMDB sentiment (python/paddle/v2/dataset/imdb.py): word_dict() maps
token -> id sorted by frequency; train/test readers yield
([word ids], label 0/1). Parses the cached aclImdb tarball when present,
else a synthetic corpus with a class-informative vocabulary."""

from __future__ import annotations

import re
import string
import tarfile

from paddle_tpu_torch.data.dataset import common

__all__ = ["convert", "word_dict", "train", "test"]

URL = (
    "http://ai.stanford.edu/%7Eamaas/data/sentiment/aclImdb_v1.tar.gz"
)

_VOCAB = 200
_POS_WORDS = list(range(10, 60))  # synthetic positive-leaning ids
_NEG_WORDS = list(range(60, 110))


def tokenize(s: str):
    return re.sub(
        f"[{string.punctuation}]", "", s.lower()
    ).split()


def _real_docs(pattern):
    path = common.download(URL, "imdb")
    qs = re.compile(pattern)
    with tarfile.open(path) as t:
        for member in t.getmembers():
            if qs.match(member.name):
                yield tokenize(t.extractfile(member).read().decode())


def _synth_docs(split_name, n=256):
    rng = common.synthetic_rng("imdb", split_name)
    for i in range(n):
        label = int(rng.integers(0, 2))
        # label convention matches the real path below: positive=0
        lean = _POS_WORDS if label == 0 else _NEG_WORDS
        ln = int(rng.integers(8, 40))
        words = [
            f"w{rng.choice(lean)}"
            if rng.random() < 0.6
            else f"w{rng.integers(0, _VOCAB)}"
            for _ in range(ln)
        ]
        yield words, label


def word_dict(cutoff: int = 150):
    """token -> id, most frequent first, from the LABELED train+test
    pos/neg docs with a frequency cutoff (imdb.py word_dict: build_dict
    over train|test/pos|neg, cutoff 150 — NOT train/unsup or the
    urls_*.txt index files). The synthetic corpus skips the cutoff (it
    is far smaller than the real 25k-review corpus)."""
    from collections import Counter

    cnt = Counter()
    try:
        for doc in _real_docs(
            "aclImdb/(train|test)/(pos|neg)/.*\\.txt$"
        ):
            cnt.update(doc)
        cnt = Counter(
            {w: c for w, c in cnt.items() if c >= cutoff}
        )
    except FileNotFoundError:
        for words, _ in _synth_docs("train"):
            cnt.update(words)
    items = sorted(cnt.items(), key=lambda kv: (-kv[1], kv[0]))
    d = {w: i for i, (w, _) in enumerate(items)}
    d["<unk>"] = len(d)
    return d


def _creator(split_name, pos_pattern, neg_pattern, word_idx):
    unk = word_idx.get("<unk>", len(word_idx) - 1)

    def reader():
        try:
            for doc in _real_docs(pos_pattern):
                yield [word_idx.get(w, unk) for w in doc], 0
            for doc in _real_docs(neg_pattern):
                yield [word_idx.get(w, unk) for w in doc], 1
        except FileNotFoundError:
            for words, label in _synth_docs(split_name):
                yield [word_idx.get(w, unk) for w in words], label

    return reader


def train(word_idx):
    return _creator(
        "train",
        "aclImdb/train/pos/.*\\.txt$",
        "aclImdb/train/neg/.*\\.txt$",
        word_idx,
    )


def test(word_idx):
    return _creator(
        "test",
        "aclImdb/test/pos/.*\\.txt$",
        "aclImdb/test/neg/.*\\.txt$",
        word_idx,
    )


def convert(path):
    """Write the dataset as chunked recordio files for the cloud/
    elastic-master input path (reference imdb.py convert;
    common.convert -> go/master RecordIO tasks).
    """
    w = word_dict()
    common.convert(path, train(w), 1000, "imdb_train")
    common.convert(path, test(w), 1000, "imdb_test")
