"""The port's copies of the JAX package's framework-free modules.

The port imports nothing of `paddle_tpu`, so it keeps its own copy of
the DSL, the config IR, the registries and the trainer events. Each
copy must equal the original's text with the package name rewritten
(`paddle_tpu.` -> `paddle_tpu_torch.`, `from paddle_tpu import` ->
`from paddle_tpu_torch import`), and the DSL must build the same
ModelConf in both packages.
"""

import dataclasses
import os

import pytest

from paddle_tpu.core import registry as jregistry
from paddle_tpu.models import ctr as jctr
from paddle_tpu.models import lm as jlm
from paddle_tpu.models import text as jtext
from paddle_tpu_torch.core import registry as tregistry
from paddle_tpu_torch.models import ctr as tctr
from paddle_tpu_torch.models import lm as tlm
from paddle_tpu_torch.models import text as ttext

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
COPIES = ["core/config.py", "dsl.py", "core/registry.py",
          "trainer/events.py", "models/image.py", "models/text.py",
          "models/ctr.py", "models/vae.py"]


@pytest.mark.parametrize("rel", COPIES)
def test_copy_equals_original_with_package_renamed(rel):
    with open(os.path.join(REPO, "paddle_tpu", rel)) as f:
        original = f.read()
    with open(os.path.join(REPO, "paddle_tpu_torch", rel)) as f:
        copy = f.read()
    assert copy == original.replace("paddle_tpu.", "paddle_tpu_torch.").replace(
        "from paddle_tpu import", "from paddle_tpu_torch import")


@pytest.mark.parametrize("impl", ["dense", "flash"])
def test_transformer_lm_conf_is_the_same(impl):
    kw = dict(vocab=2048, d_model=256, num_heads=4, num_layers=2,
              attn_impl=impl)
    jconf = jlm.transformer_lm(jlm.LMSpec(**kw))
    tconf = tlm.transformer_lm(tlm.LMSpec(**kw))
    assert tconf.to_json() == jconf.to_json()
    assert [dataclasses.asdict(lc) for lc in tconf.layers] == [
        dataclasses.asdict(lc) for lc in jconf.layers]


# the two bench confs at their published widths (bench.py bench_lstm,
# bench_nmt), and the tagger the sequence slice runs too
TEXT_CONFS = {
    "classifier_h256": ("stacked_lstm_classifier",
                        dict(vocab_size=30000, emb_dim=128, hidden=256)),
    "classifier_h1280": ("stacked_lstm_classifier",
                         dict(vocab_size=30000, emb_dim=128, hidden=1280)),
    "nmt": ("seq2seq_attention", dict(src_vocab=30000, trg_vocab=30000,
                                      emb_dim=512, hidden=512)),
    "tagger": ("bidi_lstm_tagger", {}),
}


@pytest.mark.parametrize("name", sorted(TEXT_CONFS))
def test_text_conf_is_the_same(name):
    fn, kw = TEXT_CONFS[name]
    jconf = getattr(jtext, fn)(**kw)
    tconf = getattr(ttext, fn)(**kw)
    assert tconf.to_json() == jconf.to_json()
    assert [dataclasses.asdict(lc) for lc in tconf.layers] == [
        dataclasses.asdict(lc) for lc in jconf.layers]


# the CTR confs at models/ctr.py's defaults, and narrow and sharded
CTR_CONFS = {
    "linear": ("ctr_linear", {}),
    "linear_sharded": ("ctr_linear", dict(feature_dim=1024, sharded=True)),
    "wide_deep": ("ctr_wide_deep", {}),
    "wide_deep_narrow": ("ctr_wide_deep", dict(feature_dim=1000, emb_dim=8,
                                               hidden=(16,))),
}


@pytest.mark.parametrize("name", sorted(CTR_CONFS))
def test_ctr_conf_is_the_same(name):
    fn, kw = CTR_CONFS[name]
    jconf = getattr(jctr, fn)(**kw)
    tconf = getattr(tctr, fn)(**kw)
    assert tconf.to_json() == jconf.to_json()
    assert [dataclasses.asdict(lc) for lc in tconf.layers] == [
        dataclasses.asdict(lc) for lc in jconf.layers]


def test_port_has_its_own_registries():
    import paddle_tpu_torch.layers  # noqa: F401
    import paddle_tpu_torch.optimizers  # noqa: F401

    for name in ("LAYERS", "ACTIVATIONS", "OPTIMIZERS", "LR_SCHEDULERS"):
        assert getattr(tregistry, name) is not getattr(jregistry, name)
    # every layer type of the JAX package (moe since its port)
    assert tregistry.LAYERS.names() == jregistry.LAYERS.names()
    assert len(tregistry.LAYERS.names()) == 126
    assert tregistry.OPTIMIZERS.names() == [
        "adadelta", "adagrad", "adam", "adamax", "decayed_adagrad",
        "momentum", "rmsprop", "sgd"]
    assert tregistry.LR_SCHEDULERS.names() == jregistry.LR_SCHEDULERS.names()
    assert tregistry.ACTIVATIONS.names() == jregistry.ACTIVATIONS.names()
