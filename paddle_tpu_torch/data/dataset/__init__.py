"""Dataset package (reference: python/paddle/v2/dataset/__init__.py —
13 auto-downloading datasets). Zero-egress build: loaders parse cached
files under common.DATA_HOME when present and otherwise emit
deterministic synthetic streams with the reference schemas.

The port's copy of `paddle_tpu/data/dataset/` (ROADMAP A13): the same
modules, numpy and the standard library only, the same streams. Left
out: `common.convert` and the modules' `convert` writers, which need the
native recordio writer (ROADMAP A12)."""

from paddle_tpu_torch.data.dataset import (  # noqa: F401
    cifar,
    common,
    conll05,
    flowers,
    imdb,
    imikolov,
    mnist,
    movielens,
    mq2007,
    sentiment,
    uci_housing,
    voc2012,
    wmt14,
)

__all__ = [
    "cifar",
    "common",
    "conll05",
    "flowers",
    "imdb",
    "imikolov",
    "mnist",
    "movielens",
    "mq2007",
    "sentiment",
    "uci_housing",
    "voc2012",
    "wmt14",
]
