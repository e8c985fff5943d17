"""CTR models: wide-sparse logistic regression and wide&deep.

Reference workload: the BASELINE config list's "CTR wide-sparse logistic
regression (high-dim sparse updater)" — the pserver-era sparse training
story (SURVEY §2 'MP sparse'): a huge per-feature weight table touched
sparsely per batch. TPU-first: features arrive as an id SEQUENCE
(variable number of active features per example); the weight table is an
embedding with sparse/sharded updates (parallel/sparse.py), pooled by
sum — exactly w.x for binary features.
"""

from __future__ import annotations

from paddle_tpu_torch import dsl
from paddle_tpu_torch.core.config import ModelConf, ParameterConf


def ctr_linear(feature_dim=100000, sharded=False) -> ModelConf:
    """Wide sparse LR: sigmoid(sum_i w[f_i] + b)."""
    with dsl.model() as g:
        feats = dsl.data("features", (1,), is_seq=True, is_ids=True)
        label = dsl.data("label", (1,), is_ids=True)
        w = dsl.embedding(
            feats, size=1, vocab_size=feature_dim, sharded=sharded,
            param=ParameterConf(name="wide_w", sparse_update=True),
        )
        s = dsl.seq_pool(w, pool_type="sum")
        logit = dsl.fc(s, size=2, name="output")
        dsl.classification_cost(logit, label, name="cost")
        g.conf.output_layer_names.append("output")
    return g.conf


def ctr_wide_deep(
    feature_dim=100000, emb_dim=16, hidden=(64, 32), sharded=False
) -> ModelConf:
    """Wide & deep: the wide sum above plus an embedding MLP tower."""
    with dsl.model() as g:
        feats = dsl.data("features", (1,), is_seq=True, is_ids=True)
        label = dsl.data("label", (1,), is_ids=True)
        wide = dsl.seq_pool(
            dsl.embedding(
                feats, size=1, vocab_size=feature_dim, sharded=sharded,
                param=ParameterConf(name="wide_w", sparse_update=True),
            ),
            pool_type="sum",
        )
        deep = dsl.seq_pool(
            dsl.embedding(
                feats, size=emb_dim, vocab_size=feature_dim,
                sharded=sharded,
                param=ParameterConf(name="deep_emb", sparse_update=True),
            ),
            pool_type="avg",
        )
        h = deep
        for i, n in enumerate(hidden):
            h = dsl.fc(h, size=n, act="relu", name=f"deep_h{i}")
        logit = dsl.fc(dsl.concat(wide, h), size=2, name="output")
        dsl.classification_cost(logit, label, name="cost")
        g.conf.output_layer_names.append("output")
    return g.conf
