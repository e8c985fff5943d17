"""Sequence parallelism on the port's mesh against the JAX mesh, on the
CPU.

The JAX side runs `ring_attention` / `ulysses_attention` on
`tests/conftest.py`'s 8-device CPU mesh ({seq: n}); the port side runs
as spawned gloo ranks (one world of 2 and one of 4 for the module),
each given q, k, v whole (as the attention layer holds them) and
attending its slice of T:

- ring, Ulysses dense and Ulysses flash (the flash kernels' plain
  versions on the CPU), causal with kv_lens and neither: the
  outputs and the gradients of q, k and v (under one random cotangent,
  `jax.vjp` on the JAX side) within 1e-4 of the largest entry; the
  ring also at a K/V shard longer than `RING_BLOCK_K` (tiles inside a
  ring step, the block patched small);
- the attention layer's three modes (`seq_parallel` "none", "ring",
  "ulysses") agree on a {data: 2, seq: 2} mesh, as the JAX
  `TestAttentionLayer` holds them, each rank on its data rows;
- Ulysses with heads that do not divide the axis raises.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import Mesh as JMesh

from paddle_tpu.parallel import ring as jring

from paddle_tpu_torch.core import mesh as tmesh
from paddle_tpu_torch.core.arg import seq as tseq
from paddle_tpu_torch.core.config import InputConf, LayerConf, ModelConf
from paddle_tpu_torch.network import Network as TNetwork
from paddle_tpu_torch.parallel import ring as tring
from paddle_tpu_torch.parallel.world import World

TOL = 1e-4
B, T, H, D = 2, 16, 4, 8
LENS = np.asarray([16, 9], np.int32)


def _inputs(seed):
    rng = np.random.default_rng(seed)
    q, k, v, g = (rng.standard_normal((B, T, H, D)).astype(np.float32)
                  for _ in range(4))
    return q, k, v, g


def _jax(mode, n, causal, lens, q, k, v, g, impl="dense"):
    mesh = JMesh(np.asarray(jax.devices()[:n]), ("seq",))
    kl = None if lens is None else jnp.asarray(lens)

    def f(q, k, v):
        if mode == "ring":
            return jring.ring_attention(q, k, v, mesh, causal=causal,
                                        kv_lens=kl)
        return jring.ulysses_attention(q, k, v, mesh, causal=causal,
                                       kv_lens=kl, attn_impl=impl)

    out, vjp = jax.vjp(f, jnp.asarray(q), jnp.asarray(k), jnp.asarray(v))
    return [np.asarray(out)] + [np.asarray(x) for x in vjp(jnp.asarray(g))]


# ---- rank-side cases -----------------------------------------------------

def rank_attention(mode, causal, lens, q, k, v, g, impl="dense",
                   block=None):
    mesh = tmesh.make_mesh({"seq": -1})
    qt, kt, vt = (torch.from_numpy(x).requires_grad_(True)
                  for x in (q, k, v))
    kl = None if lens is None else torch.from_numpy(lens)
    saved = tring.RING_BLOCK_K
    tring.RING_BLOCK_K = block or saved
    try:
        if mode == "ring":
            out = tring.ring_attention(qt, kt, vt, mesh, causal=causal,
                                       kv_lens=kl)
        else:
            out = tring.ulysses_attention(qt, kt, vt, mesh, causal=causal,
                                          kv_lens=kl, attn_impl=impl)
        grads = torch.autograd.grad(out, (qt, kt, vt), torch.from_numpy(g))
    finally:
        tring.RING_BLOCK_K = saved
    return [out.detach().numpy()] + [x.numpy() for x in grads]


def rank_layer(mode, x, lens):
    mesh = tmesh.make_mesh({"data": 2, "seq": -1})
    tmesh.set_mesh(mesh)
    conf = ModelConf(layers=[
        LayerConf(name="x", type="data", attrs={"dim": (16,),
                                                 "is_seq": True}),
        LayerConf(name="att", type="multi_head_attention", size=16,
                  bias=False, inputs=[InputConf(name="x")],
                  attrs={"num_heads": 4, "causal": True,
                         "seq_parallel": mode}),
    ])
    net = TNetwork(conf)
    p = net.init_params(torch.Generator().manual_seed(0), device="cpu")
    i = mesh.axis_index("data")
    rows = slice(2 * i, 2 * i + 2)
    outs, _ = net.forward(p, {"x": tseq(torch.from_numpy(x[rows]),
                                        lens[rows])}, outputs=["att"])
    return outs["att"].value.detach().numpy()


def rank_ulysses_heads():
    mesh = tmesh.make_mesh({"seq": -1})
    q = torch.zeros((1, 8, 3, 4))
    try:
        tring.ulysses_attention(q, q, q, mesh)
    except ValueError as e:
        return str(e)
    return None


# ---- the tests -------------------------------------------------------------

@pytest.fixture(scope="module")
def world2(tmp_path_factory):
    with World(2, str(tmp_path_factory.mktemp("seq2"))) as w:
        yield w


@pytest.fixture(scope="module")
def world4(tmp_path_factory):
    with World(4, str(tmp_path_factory.mktemp("seq4"))) as w:
        yield w


def _close(got, want, what):
    scale = max(float(np.max(np.abs(want))), 1e-30)
    err = float(np.max(np.abs(got - want)))
    assert err <= TOL * scale, (what, err, scale)


@pytest.mark.parametrize("causal,lens", [(False, None), (True, LENS)],
                         ids=["full", "causal_kv_lens"])
@pytest.mark.parametrize("mode,impl", [("ring", "dense"),
                                       ("ulysses", "dense"),
                                       ("ulysses", "flash")])
@pytest.mark.parametrize("n", [2, 4])
def test_matches_the_jax_mesh(n, mode, impl, causal, lens, world2, world4):
    world = world2 if n == 2 else world4
    q, k, v, g = _inputs(n)
    want = _jax(mode, n, causal, lens, q, k, v, g, impl)
    for r, got in enumerate(world.run(rank_attention, mode, causal, lens,
                                      q, k, v, g, impl)):
        for what, a, b in zip(("out", "dq", "dk", "dv"), got, want):
            _close(a, b, (r, what))


def test_ring_tiles_inside_a_step(world2):
    q, k, v, g = _inputs(7)
    want = _jax("ring", 2, True, LENS, q, k, v, g)
    for got in world2.run(rank_attention, "ring", True, LENS, q, k, v, g,
                          "dense", 4):
        for what, a, b in zip(("out", "dq", "dk", "dv"), got, want):
            _close(a, b, what)


def test_layer_modes_agree(world4):
    x = np.random.default_rng(1).standard_normal((4, 8, 16)).astype(
        np.float32)
    lens = np.asarray([8, 8, 5, 2], np.int32)
    ref = world4.run(rank_layer, "none", x, lens)
    for mode in ("ring", "ulysses"):
        for r, got in enumerate(world4.run(rank_layer, mode, x, lens)):
            np.testing.assert_allclose(got, ref[r], atol=1e-5,
                                       err_msg=f"{mode} rank {r}")


def test_ulysses_heads_must_divide_the_axis(world2):
    for msg in world2.run(rank_ulysses_heads):
        assert msg == "heads 3 not divisible by seq shards 2"
