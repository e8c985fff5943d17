"""Sparse tables and sharded checkpoints on the port's mesh against the
JAX package, on the CPU.

The JAX side runs on `tests/conftest.py`'s 8-device CPU mesh; the port
side runs as spawned gloo ranks (one world of 2 for the module):

- `embedding_lookup` over a table sharded by rows on `model`: the rows
  against the JAX program's, and the row-sparse backward (each rank's
  gradient a sparse COO tensor of its own touched rows) against the
  JAX gradient's rows of that shard; untouched rows get no entry;
- the sharded tier with one shard a rank (2 ranks) against the JAX
  tier with 2 shards on the same stream of lookups and updates: the
  lookups, the stats, and the export payloads (ids, slots and spill
  ids exactly, rows and slots within rtol 1e-5 / atol 1e-6), under
  eviction to spill, range and hash placement;
- an `async-shard-v1` pass saved by 2 port ranks after a data-parallel
  step with a table sharded over `data` (ZeRO-style: gathered at use,
  its gradient reduce-scattered), loaded by the JAX loader and by one
  port process: the whole arrays the ranks hold, bit for bit, and the
  step itself within 1e-4 of the JAX mesh step's;
- a JAX `save_sharded` over 8 devices, loaded by 2 port ranks, each
  keeping its slice.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import NamedSharding
from jax.sharding import PartitionSpec as JP

from paddle_tpu import dsl as jdsl
from paddle_tpu.core import arg as jarg
from paddle_tpu.core import mesh as jmesh
from paddle_tpu.core.config import OptimizationConf as JOptConf
from paddle_tpu.network import Network as JNetwork
from paddle_tpu.optimizers import create_optimizer as jcreate
from paddle_tpu.parallel import sparse as jsparse
from paddle_tpu.parallel import sparse_shard as jss
from paddle_tpu.parallel.dp import TrainStep as JTrainStep
from paddle_tpu.trainer import async_checkpoint as jactp
from paddle_tpu.trainer import checkpoint as jckpt

from paddle_tpu_torch import dsl as tdsl
from paddle_tpu_torch.core import arg as targ
from paddle_tpu_torch.core import mesh as tmesh
from paddle_tpu_torch.core.config import OptimizationConf as TOptConf
from paddle_tpu_torch.network import Network as TNetwork
from paddle_tpu_torch.optimizers import create_optimizer as tcreate
from paddle_tpu_torch.parallel import collectives as C
from paddle_tpu_torch.parallel import sparse as tsparse
from paddle_tpu_torch.parallel import sparse_shard as tss
from paddle_tpu_torch.parallel.dp import TrainStep as TTrainStep
from paddle_tpu_torch.parallel.world import World
from paddle_tpu_torch.trainer import async_checkpoint as tactp
from paddle_tpu_torch.trainer import checkpoint as tckpt

RTOL, ATOL = 1e-5, 1e-6
TABLE = dict(rows_total=1 << 24, dim=4, capacity=6, num_slots=6,
             init_scale=0.02, seed=3)


def _jmesh(shape):
    n = int(np.prod(list(shape.values())))
    return jmesh.make_mesh(shape, devices=jax.devices()[:n])


# ---- rank-side cases -------------------------------------------------------

def rank_lookup(table, ids, g):
    mesh = tmesh.make_mesh({"model": -1})
    n, r = mesh.axis_size("model"), mesh.axis_index("model")
    rows = table.shape[0] // n
    shard = torch.from_numpy(table[r * rows:(r + 1) * rows].copy())
    shard.requires_grad_(True)
    out = tsparse.embedding_lookup(shard, torch.from_numpy(ids), mesh)
    (grad,) = torch.autograd.grad(out, [shard], torch.from_numpy(g))
    return {"out": out.detach().numpy(), "is_sparse": grad.is_sparse,
            "touched": grad.coalesce().indices()[0].numpy(),
            "grad": grad.to_dense().numpy(), "first": r * rows}


def rank_tier(placement, stream, lr):
    mesh = tmesh.make_mesh({"model": -1})
    t = tss.ShardedEmbeddingTable(
        tss.ShardedTableConfig(placement=placement, **TABLE),
        num_shards=mesh.axis_size("model"),
        update_fn=tss.sgd_row_update(lr), device="cpu", mesh=mesh,
        axis="model")
    looks = []
    for ids, grads in stream:
        looks.append(t.lookup(ids).numpy())
        t.update(ids.reshape(-1), grads)
    return {"looks": looks, "stats": dict(t.stats),
            "payloads": t.export_shards(), "local": t.local_shards,
            "cache_rows": t._S}


def _emb_conf(dsl):
    with dsl.model() as m:
        x = dsl.data("x", dim=(16,))
        ids = dsl.data("ids", dim=(), is_ids=True)
        emb = dsl.embedding(ids, size=8, vocab_size=32, sharded=True)
        h = dsl.fc(x, emb, size=16, act="relu", name="h")
        out = dsl.fc(h, size=4, act="softmax", name="out")
        lbl = dsl.data("label", dim=(), is_ids=True)
        dsl.classification_cost(out, lbl)
    return m.conf


def _emb_batch():
    rng = np.random.default_rng(0)
    return {"x": (rng.standard_normal((8, 16)).astype(np.float32), None),
            "ids": (rng.integers(0, 32, 8), None),
            "label": (rng.integers(0, 4, 8), None)}


OPT = dict(learning_method="momentum", learning_rate=0.1, momentum=0.9)


def rank_save_pass(params, batch, save_dir):
    mesh = tmesh.make_mesh({"data": -1})
    net = TNetwork(_emb_conf(tdsl))
    opt = tcreate(TOptConf(**OPT), net.param_confs)
    step = TTrainStep(net, opt, mesh=mesh, device="cpu")
    full = {k: torch.from_numpy(v) for k, v in params.items()}
    p, o, s = step.place(params, opt.init_state(full), {})
    feed = {k: targ.non_seq(torch.from_numpy(x)) if x.dtype == np.float32
            else targ.id_arg(x) for k, (x, _l) in batch.items()}
    p, o, s, loss, _ = step(p, o, s, feed, 0, None)
    with tactp.AsyncCheckpointer(save_dir) as ck:
        ck.save(0, p, o, s, meta={"loss": float(loss)},
                shards=step.shard_layout(o))
    whole = {}
    for k, v in p.items():
        for dim, axis in [(d, a) for d, a in enumerate(step.specs[k])
                          if a is not None]:
            v = C.all_gather_(mesh, axis, v, dim)
        whole[k] = v.numpy()
    return {"params": whole, "local": {k: tuple(v.shape)
                                       for k, v in p.items()},
            "loss": float(loss)}


def rank_load_sharded(save_dir, spec_rows):
    mesh = tmesh.make_mesh({"model": -1})
    n, r = mesh.axis_size("model"), mesh.axis_index("model")
    k = spec_rows // n
    tree = tckpt.load_sharded(save_dir, slices={
        "params/emb": (slice(r * k, (r + 1) * k), slice(None))})
    return {"emb": tree["params"]["emb"], "w": tree["params"]["w"]}


# ---- the tests ---------------------------------------------------------------

@pytest.fixture(scope="module")
def world2(tmp_path_factory):
    with World(2, str(tmp_path_factory.mktemp("sparse2"))) as w:
        yield w


def test_row_sharded_lookup_and_its_sparse_backward(world2):
    rng = np.random.default_rng(0)
    V, D = 16, 3
    table = rng.standard_normal((V, D)).astype(np.float32)
    ids = np.asarray([[1, 3, 3], [9, 15, 0]], np.int32)
    g = rng.standard_normal((2, 3, D)).astype(np.float32)
    mesh = _jmesh({"model": 2})
    out, vjp = jax.vjp(lambda t: jsparse.embedding_lookup(
        t, jnp.asarray(ids), mesh), jnp.asarray(table))
    (jg,) = vjp(jnp.asarray(g))
    for r in world2.run(rank_lookup, table, ids.astype(np.int64), g):
        np.testing.assert_allclose(r["out"], np.asarray(out), atol=1e-6)
        assert r["is_sparse"]
        rows = slice(r["first"], r["first"] + V // 2)
        np.testing.assert_allclose(r["grad"], np.asarray(jg)[rows],
                                   atol=1e-6)
        owned = sorted({int(i) - r["first"] for i in ids.reshape(-1)
                        if r["first"] <= i < r["first"] + V // 2})
        assert r["touched"].tolist() == owned


def _assert_payloads_equal(tp, jp):
    assert len(tp) == len(jp)
    for a, b in zip(tp, jp):
        assert sorted(a) == sorted(b)
        for key in ("ids", "slots", "spill_ids"):
            np.testing.assert_array_equal(a[key], np.asarray(b[key]))
        for key in a:
            if key not in ("ids", "slots", "spill_ids"):
                np.testing.assert_allclose(a[key], np.asarray(b[key]),
                                           rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize("placement", ["range", "hash"])
def test_tier_over_two_ranks_matches_the_jax_tier(placement, world2):
    rng = np.random.default_rng(1)
    vocab = rng.integers(0, 1 << 24, 24)
    stream = []
    for _ in range(8):
        ids = rng.choice(vocab, size=(2, 3)).astype(np.int64)
        stream.append((ids, rng.standard_normal((6, 4)).astype(
            np.float32)))
    j = jss.ShardedEmbeddingTable(
        jss.ShardedTableConfig(placement=placement, **TABLE),
        mesh=_jmesh({"model": 2}), update_fn=jss.sgd_row_update(0.5))
    looks = []
    for ids, grads in stream:
        looks.append(np.asarray(j.lookup(ids)))
        j.update(ids.reshape(-1), grads)
    assert j.stats["evictions"] > 0
    ranks = world2.run(rank_tier, placement, stream, 0.5)
    for r, got in enumerate(ranks):
        assert got["local"] == [r] and got["cache_rows"] == TABLE["capacity"]
        for a, b in zip(got["looks"], looks):
            np.testing.assert_allclose(a, b, rtol=RTOL, atol=ATOL)
        _assert_payloads_equal(got["payloads"], j.export_shards())
    # each rank counted its own shard's traffic: together the JAX table's
    for key in ("hits", "misses", "evictions"):
        assert sum(g["stats"][key] for g in ranks) == j.stats[key]


def test_pass_saved_by_two_ranks_loads_in_jax_and_one_port_process(
        world2, tmp_path):
    jnet = JNetwork(_emb_conf(jdsl))
    params = {k: np.asarray(v)
              for k, v in jnet.init_params(jax.random.key(2)).items()}
    batch = _emb_batch()
    d = str(tmp_path / "ckpt")
    ranks = world2.run(rank_save_pass, params, batch, d)
    table = next(k for k in params if params[k].shape == (32, 8))
    assert ranks[0]["local"][table] == (16, 8)  # rows over data
    # the JAX mesh step at {data: 2} with the same table sharding
    jopt = jcreate(JOptConf(**OPT), jnet.param_confs)
    step = JTrainStep(jnet, jopt, mesh=_jmesh({"data": 2}), donate=False)
    p = {k: jnp.asarray(v) for k, v in params.items()}
    p, o, s = step.place(p, jopt.init_state(p), {})
    feed = {k: jarg.non_seq(jnp.asarray(x)) if x.dtype == np.float32
            else jarg.id_arg(x.astype(np.int32)) for k, (x, _l) in
            batch.items()}
    jp, _o, _s, jloss, _ = step(p, o, s, feed, 0, jax.random.key(0))
    np.testing.assert_allclose(ranks[0]["loss"], float(jloss), rtol=1e-4)
    for k, v in jp.items():
        v = np.asarray(v)
        err = np.max(np.abs(ranks[0]["params"][k] - v))
        assert err <= 1e-4 * np.max(np.abs(v)), k
    jtree, jmeta = jactp.load_pass(d)
    ttree, tmeta = tactp.load_pass(d)
    assert jmeta["loss"] == tmeta["loss"] == ranks[0]["loss"]
    for k, v in ranks[0]["params"].items():
        np.testing.assert_array_equal(np.asarray(jtree["params"][k]), v)
        np.testing.assert_array_equal(ttree["params"][k], v)
        np.testing.assert_array_equal(ranks[1]["params"][k], v)
    for k in ttree["opt_state"]:
        for slot, v in ttree["opt_state"][k].items():
            np.testing.assert_array_equal(
                np.asarray(jtree["opt_state"][k][slot]), v)
            assert v.shape == params[k].shape


def test_jax_save_sharded_over_8_devices_loads_on_two_ranks(world2,
                                                            tmp_path):
    mesh = jmesh.make_mesh({"model": 8})
    rng = np.random.default_rng(4)
    emb = rng.standard_normal((32, 4)).astype(np.float32)
    w = rng.standard_normal((4, 3)).astype(np.float32)
    tree = {"params": {
        "emb": jax.device_put(jnp.asarray(emb),
                              NamedSharding(mesh, JP("model", None))),
        "w": jnp.asarray(w)}}
    d = str(tmp_path / "sharded")
    jckpt.save_sharded(d, tree)
    for r, got in enumerate(world2.run(rank_load_sharded, d, 32)):
        np.testing.assert_array_equal(got["emb"], emb[16 * r:16 * (r + 1)])
        np.testing.assert_array_equal(got["w"], w)
