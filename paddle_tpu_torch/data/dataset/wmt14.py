"""WMT14 en-fr translation (python/paddle/v2/dataset/wmt14.py): train/
test(dict_size) readers yield (src_ids, trg_ids, trg_ids_next) with
<s>=0, <e>=1, <unk>=2 (wmt14.py:39-42,87-101). Synthetic fallback emits
an invertible toy translation task (target = reversed source over a
disjoint vocab half)."""

from __future__ import annotations

from paddle_tpu_torch.data.dataset import common

__all__ = ["convert", "train", "test", "get_dict"]

START_ID, END_ID, UNK_IDX = 0, 1, 2


def get_dict(dict_size: int):
    """(src_dict, trg_dict): id -> token."""
    src = {0: "<s>", 1: "<e>", 2: "<unk>"}
    trg = dict(src)
    for i in range(3, dict_size):
        src[i] = f"src{i}"
        trg[i] = f"trg{i}"
    return src, trg


def _creator(split_name, dict_size, n):
    def reader():
        rng = common.synthetic_rng("wmt14", split_name)
        for _ in range(n):
            ln = int(rng.integers(3, 12))
            body = rng.integers(3, dict_size, ln).tolist()
            src_ids = [START_ID] + body + [END_ID]
            trg_body = list(reversed(body))
            trg_ids = [START_ID] + trg_body
            trg_ids_next = trg_body + [END_ID]
            yield src_ids, trg_ids, trg_ids_next

    return reader


def train(dict_size: int):
    return _creator("train", dict_size, n=512)


def test(dict_size: int):
    return _creator("test", dict_size, n=128)


def convert(path):
    """Write the dataset as chunked recordio files for the cloud/
    elastic-master input path (reference wmt14.py convert;
    common.convert -> go/master RecordIO tasks).
    """
    dict_size = 30000
    common.convert(path, train(dict_size), 1000, "wmt14_train")
    common.convert(path, test(dict_size), 1000, "wmt14_test")
