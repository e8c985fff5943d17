"""PTB language modeling (python/paddle/v2/dataset/imikolov.py):
build_dict(min_word_freq) -> token->id with <s>, <e>, <unk>;
train/test(word_idx, n, data_type) yields either n-gram id tuples
(DataType.NGRAM) or (src_seq, trg_seq) next-word pairs (DataType.SEQ)."""

from __future__ import annotations

import tarfile

from paddle_tpu_torch.data.dataset import common

__all__ = ["convert", "build_dict", "train", "test", "DataType"]

URL = "http://www.fit.vutbr.cz/~imikolov/rnnlm/simple-examples.tgz"
_SYN_VOCAB = 120


class DataType:
    NGRAM = 1
    SEQ = 2


def _real_lines(file_name):
    path = common.download(URL, "imikolov")
    with tarfile.open(path) as t:
        for line in t.extractfile(file_name):
            yield line.decode().split()


def _synth_lines(split_name, n=400):
    rng = common.synthetic_rng("imikolov", split_name)
    for _ in range(n):
        ln = int(rng.integers(4, 20))
        # zipf-ish draw so min_word_freq filtering is meaningful
        yield [f"w{int(rng.zipf(1.3)) % _SYN_VOCAB}" for _ in range(ln)]


def _lines(split_name):
    fn = (
        "./simple-examples/data/ptb.train.txt"
        if split_name == "train"
        else "./simple-examples/data/ptb.valid.txt"
    )
    try:
        yield from _real_lines(fn)
    except FileNotFoundError:
        yield from _synth_lines(split_name)


def build_dict(min_word_freq: int = 50):
    from collections import Counter

    cnt = Counter()
    for words in _lines("train"):
        cnt.update(words)
    cnt = {k: v for k, v in cnt.items() if v >= min_word_freq}
    items = sorted(cnt.items(), key=lambda kv: (-kv[1], kv[0]))
    word_idx = {w: i for i, (w, _) in enumerate(items)}
    word_idx["<s>"] = len(word_idx)
    word_idx["<e>"] = len(word_idx)
    word_idx["<unk>"] = len(word_idx)
    return word_idx


def _creator(split_name, word_idx, n, data_type):
    unk = word_idx["<unk>"]

    def reader():
        for words in _lines(split_name):
            if data_type == DataType.NGRAM:
                assert n > -1, "ngram needs n > 0"
                l = (
                    [word_idx["<s>"]]
                    + [word_idx.get(w, unk) for w in words]
                    + [word_idx["<e>"]]
                )
                if len(l) >= n:
                    for i in range(n, len(l) + 1):
                        yield tuple(l[i - n : i])
            elif data_type == DataType.SEQ:
                l = [word_idx.get(w, unk) for w in words]
                src = [word_idx["<s>"]] + l
                trg = l + [word_idx["<e>"]]
                yield src, trg
            else:
                raise AssertionError("unknown data type")

    return reader


def train(word_idx, n, data_type=DataType.NGRAM):
    return _creator("train", word_idx, n, data_type)


def test(word_idx, n, data_type=DataType.NGRAM):
    return _creator("test", word_idx, n, data_type)


def convert(path):
    """Write the dataset as chunked recordio files for the cloud/
    elastic-master input path (reference imikolov.py convert;
    common.convert -> go/master RecordIO tasks).
    """
    n = 5
    w = build_dict()
    common.convert(path, train(w, n), 1000, "imikolov_train")
    common.convert(path, test(w, n), 1000, "imikolov_test")
