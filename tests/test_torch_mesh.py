"""The port's mesh and sharding rules against the JAX package's, with no
process spawned.

- `make_mesh`: the shapes (the -1 rule, the default all-`data` mesh) and
  the errors of the JAX `make_mesh` over the same device count.
- `Sharder`: every parameter's spec equal to the JAX Sharder's for the
  small LM, the two-block fused ResNet, the moe conf and the wide&deep
  CTR conf with sharded (`sparse_remote_update`) tables, on meshes
  {data: 8}, {data: 2, model: 4}, {data: 1, model: 8} and {data: 4,
  seq: 2}, with and without a regex rule.
- `activation_spec`, a mesh's coordinates and its ranks along an axis
  (the JAX mesh's device layout), the one-rank default of `get_mesh`,
  the per-layer `out_sharding` check, and the shard slices a rank keeps.
"""

import jax
import numpy as np
import pytest
from jax.sharding import Mesh as JMesh
from jax.sharding import PartitionSpec as JP

from paddle_tpu import dsl as jdsl
from paddle_tpu.core import mesh as jmesh
from paddle_tpu.models import ctr as jctr
from paddle_tpu.models import image as jimage
from paddle_tpu.models import lm as jlm
from paddle_tpu.network import Network as JNetwork
from paddle_tpu.parallel import sharding as jsharding

from paddle_tpu_torch import dsl as tdsl
from paddle_tpu_torch.core import mesh as tmesh
from paddle_tpu_torch.core.arg import non_seq
from paddle_tpu_torch.models import ctr as tctr
from paddle_tpu_torch.models import image as timage
from paddle_tpu_torch.models import lm as tlm
from paddle_tpu_torch.network import Network as TNetwork
from paddle_tpu_torch.parallel import sharding as tsharding

MESHES = [{"data": 8}, {"data": 2, "model": 4}, {"data": 1, "model": 8},
          {"data": 4, "seq": 2}]


def _tiny_resnet(dsl, image):
    with dsl.model() as g:
        img = dsl.data("image", (8, 8, 16))
        lbl = dsl.data("label", (1,), is_ids=True)
        h = image._bottleneck("blk_a", img, 4, 1, project=True, fused=True)
        h = image._bottleneck("blk_b", h, 4, 1, project=False, fused=True)
        h = dsl.pool(h, 8, 1, pool_type="avg")
        out = dsl.fc(h, size=3, name="output", act="softmax")
        dsl.classification_cost(out, lbl, name="cost")
    return g.conf


def _moe(dsl):
    with dsl.model() as g:
        x = dsl.data("x", 8)
        y = dsl.data("y", 1, is_ids=True)
        h = dsl.fc(x, size=16, act="relu")
        m = dsl.moe(h, num_experts=8, hidden=32, name="moe")
        out = dsl.fc(m, size=3, name="out")
        dsl.classification_cost(out, y, name="cost")
    return g.conf


def _confs(name):
    if name == "lm":
        kw = dict(vocab=64, d_model=32, num_heads=2, num_layers=2)
        return (jlm.transformer_lm(jlm.LMSpec(**kw)),
                tlm.transformer_lm(tlm.LMSpec(**kw)))
    if name == "resnet":
        return _tiny_resnet(jdsl, jimage), _tiny_resnet(tdsl, timage)
    if name == "moe":
        return _moe(jdsl), _moe(tdsl)
    return (jctr.ctr_wide_deep(feature_dim=4096, emb_dim=8, hidden=(16, 8),
                               sharded=True),
            tctr.ctr_wide_deep(feature_dim=4096, emb_dim=8, hidden=(16, 8),
                               sharded=True))


def _jax_mesh(shape):
    return jmesh.make_mesh(shape)


@pytest.mark.parametrize("shape,n", [
    (None, 8), ({"data": -1}, 8), ({"data": 2, "model": -1}, 8),
    ({"data": 2, "model": 4}, 8), ({"data": -1, "seq": 2}, 8),
    ({"pipe": 2, "data": -1}, 4), ({"data": 1, "model": 8}, 8)])
def test_make_mesh_shapes_match_jax(shape, n):
    jm = jmesh.make_mesh(shape, devices=jax.devices()[:n])
    tm = tmesh.make_mesh(shape, devices=n)
    assert tm.shape == dict(jm.shape)
    assert tm.axis_names == tuple(jm.axis_names)
    assert not tm.distributed and tm.rank == 0


@pytest.mark.parametrize("shape,n", [
    ({"data": -1, "model": 3}, 8), ({"data": 4, "model": 4}, 8),
    ({"data": 16}, 8)])
def test_make_mesh_errors_match_jax(shape, n):
    with pytest.raises(ValueError) as jerr:
        jmesh.make_mesh(shape, devices=jax.devices()[:n])
    with pytest.raises(ValueError) as terr:
        tmesh.make_mesh(shape, devices=n)
    assert str(terr.value) == str(jerr.value)


def test_mesh_coordinates_follow_the_jax_device_layout():
    shape = {"data": 2, "model": 2, "seq": 2}
    jm = jmesh.make_mesh(shape)
    ids = np.vectorize(lambda d: d.id)(jm.devices)
    for rank in range(8):
        tm = tmesh.Mesh(shape, rank=rank)
        c = tm.coords
        assert ids[c["data"], c["model"], c["seq"]] == rank
        for axis in shape:
            got = tm.axis_ranks(axis)
            idx = [c["data"], c["model"], c["seq"]]
            want = []
            for i in range(shape[axis]):
                idx[list(shape).index(axis)] = i
                want.append(int(ids[tuple(idx)]))
            assert got == want


def test_get_mesh_without_a_process_group_is_one_rank():
    tmesh.set_mesh(None)
    m = tmesh.get_mesh()
    assert m.shape == {"data": 1} and m.size == 1 and not m.distributed
    tmesh.set_mesh(None)


def test_distributed_init_refuses_nccl_ranks_sharing_a_card(monkeypatch):
    import torch

    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    with pytest.raises(ValueError, match="NCCL refuses two ranks on one "
                                         "device"):
        tmesh.distributed_init(num_processes=2, process_id=0,
                               store=object(), device="cuda",
                               backend="nccl")


@pytest.mark.parametrize("shape", MESHES, ids=lambda s: "_".join(
    f"{k}{v}" for k, v in s.items()))
@pytest.mark.parametrize("name", ["lm", "resnet", "moe", "ctr"])
def test_every_spec_matches_the_jax_sharder(name, shape):
    jconf, tconf = _confs(name)
    jnet, tnet = JNetwork(jconf), TNetwork(tconf)
    assert set(jnet.param_confs) == set(tnet.param_confs)
    jm = _jax_mesh(shape)
    tm = tmesh.make_mesh(shape, devices=8)
    rules = [(r"_output\.w0|_lm_head\.w0|_out\.w0", ("model", None))]
    for rs in (None, rules):
        js = jsharding.Sharder(jm, rules=[(p, JP(*s)) for p, s in rs or []])
        ts = tsharding.Sharder(tm, rules=rs)
        for k, pc in jnet.param_confs.items():
            assert tuple(ts.spec(k, tnet.param_confs[k])) == tuple(
                js.spec(k, pc)), (name, shape, k)
    if name == "moe" and "model" in shape and shape["model"] > 1:
        assert ts.spec("_moe.w0_in", tnet.param_confs["_moe.w0_in"]) == \
            tsharding.P("model", None, None)
    if name == "ctr" and shape.get("model", 1) > 1:
        assert ts.spec("deep_emb", tnet.param_confs["deep_emb"]) == \
            tsharding.P("model", None)


@pytest.mark.parametrize("shape", MESHES, ids=str)
@pytest.mark.parametrize("seq_sharded", [False, True])
def test_activation_spec_matches_jax(shape, seq_sharded):
    jspec = jsharding.activation_spec(_jax_mesh(shape), seq_sharded)
    tspec = tsharding.activation_spec(tmesh.make_mesh(shape, devices=8),
                                      seq_sharded)
    assert tuple(tspec) == tuple(jspec)


def test_shard_slices_are_the_rank_blocks():
    shape = {"data": 2, "model": 4}
    w = np.arange(16 * 8).reshape(16, 8)
    for rank in range(8):
        m = tmesh.Mesh(shape, rank=rank)
        part = tsharding.local_shard(w, tsharding.P(None, "model"), m)
        j = m.axis_index("model")
        np.testing.assert_array_equal(part, w[:, 2 * j:2 * j + 2])
        rows = tsharding.local_shard(w, tsharding.P("data", None), m)
        i = m.axis_index("data")
        np.testing.assert_array_equal(rows, w[8 * i:8 * i + 8])
    with pytest.raises(ValueError, match="does not divide"):
        tsharding.shard_slices(tsharding.P("model"), (6,),
                               tmesh.Mesh(shape))


def test_out_sharding_is_checked_against_the_mesh():
    import torch

    def conf(spec):
        with tdsl.model() as g:
            x = tdsl.data("x", 8)
            h = tdsl.fc(x, size=8, name="h")
            g.conf.layer("h").attrs["out_sharding"] = spec
            g.conf.output_layer_names.append("h")
        return g.conf

    feed = {"x": non_seq(torch.ones((4, 8)))}
    tmesh.set_mesh(tmesh.make_mesh({"data": 2, "model": 4}, devices=8))
    try:
        net = TNetwork(conf(("data", "model")))
        p = net.init_params(torch.Generator().manual_seed(0), device="cpu")
        out, _ = net.forward(p, feed)
        plain = TNetwork(conf(None)).forward(p, feed)[0]
        assert torch.equal(out["h"].value, plain["h"].value)
        with pytest.raises(ValueError, match="not in the mesh"):
            TNetwork(conf(("data", "seq"))).forward(p, feed)
        with pytest.raises(ValueError, match="does not divide"):
            TNetwork(conf((None, "model"))).forward(
                {"_h.w0": torch.ones((8, 6)), "_h.wbias": torch.ones(6)},
                feed)
    finally:
        tmesh.set_mesh(None)
