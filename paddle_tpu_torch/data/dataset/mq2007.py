"""MQ2007 LETOR learning-to-rank (python/paddle/v2/dataset/mq2007.py):
three formats — "pointwise" yields (relevance, feature[46]);
"pairwise" yields (label, better_feature, worse_feature);
"listwise" yields (relevance_list, feature_list) per query
(mq2007.py:164,184,227,247). Real files use the LETOR
`label qid:<id> 1:<v> 2:<v> ...` text format."""

from __future__ import annotations

import numpy as np

from paddle_tpu_torch.data.dataset import common

__all__ = ["convert", "train", "test", "FEATURE_DIM"]

URL = (
    "http://research.microsoft.com/en-us/um/beijing/projects/letor/"
    "LETOR4.0/Data/MQ2007.rar"
)
FEATURE_DIM = 46


def _parse_letor(path):
    from collections import defaultdict

    by_q = defaultdict(list)
    with open(path) as f:
        for line in f:
            body = line.split("#")[0].split()
            if not body:
                continue
            rel = int(body[0])
            qid = body[1].split(":")[1]
            feats = np.zeros(FEATURE_DIM, np.float32)
            for kv in body[2:]:
                k, v = kv.split(":")
                feats[int(k) - 1] = float(v)
            by_q[qid].append((rel, feats))
    return by_q


def _synth_queries(split_name, n_queries):
    rng = common.synthetic_rng("mq2007", split_name)
    by_q = {}
    w = rng.standard_normal(FEATURE_DIM)
    for q in range(n_queries):
        docs = []
        for _ in range(int(rng.integers(4, 12))):
            f = rng.standard_normal(FEATURE_DIM).astype(np.float32)
            rel = int(np.clip(round(f @ w / 8.0 + 1), 0, 2))
            docs.append((rel, f))
        by_q[str(q)] = docs
    return by_q


def _queries(split_name):
    fn = "train.txt" if split_name == "train" else "test.txt"
    try:
        return _parse_letor(
            common.download(URL + "/" + fn, "mq2007")
        )
    except FileNotFoundError:
        return _synth_queries(split_name, 60 if split_name == "train" else 20)


def _creator(split_name, format):
    def reader():
        by_q = _queries(split_name)
        for qid in sorted(by_q):
            docs = by_q[qid]
            if format == "pointwise":
                for rel, f in docs:
                    yield rel, f
            elif format == "pairwise":
                for i, (ri, fi) in enumerate(docs):
                    for rj, fj in docs[i + 1 :]:
                        if ri == rj:
                            continue
                        hi, lo = (fi, fj) if ri > rj else (fj, fi)
                        yield np.asarray([1.0]), hi, lo
            elif format == "listwise":
                yield (
                    np.asarray([d[0] for d in docs], np.float32),
                    np.stack([d[1] for d in docs]),
                )
            else:
                raise ValueError(f"unknown format {format!r}")

    return reader


def train(format="pairwise"):
    return _creator("train", format)


def test(format="pairwise"):
    return _creator("test", format)


def convert(path):
    """Write the dataset as chunked recordio files for the cloud/
    elastic-master input path (no reference convert for this module; added so every dataset
    feeds the cloud input path uniformly; common.convert -> go/master
    RecordIO tasks).
    """
    common.convert(path, train(), 1000, "mq2007_train")
    common.convert(path, test(), 1000, "mq2007_test")
