"""CoNLL-2005 semantic role labeling
(python/paddle/v2/dataset/conll05.py): test() yields 9 slots per
predicate instance — (word_ids, predicate_id, ctx_n2, ctx_n1, ctx_0,
ctx_p1, ctx_p2, mark, label_ids) (conll05.py:175). get_dict() returns
(word_dict, verb_dict, label_dict); get_embedding() the pretrained
emb matrix (synthetic here)."""

from __future__ import annotations

import numpy as np

from paddle_tpu_torch.data.dataset import common

__all__ = ["convert", "get_dict", "get_embedding", "test"]

_WORDS = 150
_VERBS = 20
_LABELS = ["O", "B-A0", "I-A0", "B-A1", "I-A1", "B-V", "I-V"]


def get_dict():
    word_dict = {f"w{i}": i for i in range(_WORDS)}
    verb_dict = {f"v{i}": i for i in range(_VERBS)}
    label_dict = {l: i for i, l in enumerate(_LABELS)}
    return word_dict, verb_dict, label_dict


def get_embedding(emb_dim: int = 32):
    rng = common.synthetic_rng("conll05", "emb")
    return rng.standard_normal((_WORDS, emb_dim)).astype(np.float32)


def test():
    word_dict, verb_dict, label_dict = get_dict()

    def reader():
        rng = common.synthetic_rng("conll05", "test")
        for _ in range(200):
            ln = int(rng.integers(5, 18))
            words = rng.integers(0, _WORDS, ln).tolist()
            vpos = int(rng.integers(0, ln))
            verb = int(rng.integers(0, _VERBS))

            def ctx(off):
                p = vpos + off
                return words[p] if 0 <= p < ln else 0

            mark = [1 if i == vpos else 0 for i in range(ln)]
            labels = []
            for i in range(ln):
                if i == vpos:
                    labels.append(label_dict["B-V"])
                elif i == vpos - 1 and i >= 0:
                    labels.append(label_dict["B-A0"])
                elif i == vpos + 1 and i < ln:
                    labels.append(label_dict["B-A1"])
                else:
                    labels.append(label_dict["O"])
            yield (
                words,
                verb,
                ctx(-2),
                ctx(-1),
                ctx(0),
                ctx(1),
                ctx(2),
                mark,
                labels,
            )

    return reader


def convert(path):
    """Write the dataset as chunked recordio files for the cloud/
    elastic-master input path (reference conll05.py convert;
    common.convert -> go/master RecordIO tasks).
    """
    # like the reference, only the test split is publicly
    # distributable; it feeds both prefixes
    common.convert(path, test(), 1000, "conll05_train")
    common.convert(path, test(), 1000, "conll05_test")
