"""The port's copies of the JAX package's framework-free modules.

The port imports nothing of `paddle_tpu`, so it keeps its own copy of
the DSL, the config IR, the registries and the trainer events. Each
copy must equal the original's text with the package name rewritten
(`paddle_tpu.` -> `paddle_tpu_torch.`), and the DSL must build the
same ModelConf in both packages.
"""

import dataclasses
import os

import pytest

from paddle_tpu.core import registry as jregistry
from paddle_tpu.models import lm as jlm
from paddle_tpu_torch.core import registry as tregistry
from paddle_tpu_torch.models import lm as tlm

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
COPIES = ["core/config.py", "dsl.py", "core/registry.py",
          "trainer/events.py"]


@pytest.mark.parametrize("rel", COPIES)
def test_copy_equals_original_with_package_renamed(rel):
    with open(os.path.join(REPO, "paddle_tpu", rel)) as f:
        original = f.read()
    with open(os.path.join(REPO, "paddle_tpu_torch", rel)) as f:
        copy = f.read()
    assert copy == original.replace("paddle_tpu.", "paddle_tpu_torch.")


@pytest.mark.parametrize("impl", ["dense", "flash"])
def test_transformer_lm_conf_is_the_same(impl):
    kw = dict(vocab=2048, d_model=256, num_heads=4, num_layers=2,
              attn_impl=impl)
    jconf = jlm.transformer_lm(jlm.LMSpec(**kw))
    tconf = tlm.transformer_lm(tlm.LMSpec(**kw))
    assert tconf.to_json() == jconf.to_json()
    assert [dataclasses.asdict(lc) for lc in tconf.layers] == [
        dataclasses.asdict(lc) for lc in jconf.layers]


def test_port_has_its_own_registries():
    import paddle_tpu_torch.layers  # noqa: F401
    import paddle_tpu_torch.optimizers  # noqa: F401

    for name in ("LAYERS", "ACTIVATIONS", "OPTIMIZERS", "LR_SCHEDULERS"):
        assert getattr(tregistry, name) is not getattr(jregistry, name)
    assert tregistry.LAYERS.names() == sorted([
        "addto", "attention", "classification_cost", "cross_entropy",
        "data", "embedding", "fc", "mse", "multi-class-cross-entropy",
        "multi_head_attention", "softmax_with_cross_entropy",
        "square_error", "sum_of_squares"])
    assert tregistry.OPTIMIZERS.names() == ["adam", "momentum", "sgd"]
    assert tregistry.LR_SCHEDULERS.names() == jregistry.LR_SCHEDULERS.names()
    assert tregistry.ACTIVATIONS.names() == jregistry.ACTIVATIONS.names()
