"""GPipe over the port's mesh against the JAX pipeline, on the CPU.

The JAX side runs `pipeline_apply` on `tests/conftest.py`'s 8-device
CPU mesh; the port side runs as spawned gloo ranks (one world of 2 and
one of 4 for the module), one stage a rank, the activations hopping
stage to stage by the ring's isend / irecv (an autograd function whose
backward sends the cotangent back):

- the outputs against JAX's and against the sequential stack, and the
  gradients of every stage's parameters and of the microbatches (under
  one random cotangent) against JAX's, within 1e-4 of the largest
  entry, at 2 and 4 stages;
- pipe x data ({pipe: 2, data: 2}, `batch_axis`): each data rank
  streams its slice of every microbatch, the stage gradients summed
  over the data axis;
- the microbatch round trip and its error.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import Mesh as JMesh

from paddle_tpu.parallel import pipeline as jpipe

from paddle_tpu_torch.core import mesh as tmesh
from paddle_tpu_torch.parallel import pipeline as tpipe
from paddle_tpu_torch.parallel.world import World

TOL = 1e-4
D, M, MB = 8, 4, 4


def _stacked(s, seed=0):
    rng = np.random.default_rng(seed)
    return {"w": (rng.standard_normal((s, D, D)) / np.sqrt(D)).astype(
        np.float32),
        "b": (0.1 * rng.standard_normal((s, D))).astype(np.float32)}


def _data(seed=1):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((M, MB, D)).astype(np.float32),
            rng.standard_normal((M, MB, D)).astype(np.float32))


def _jstage(p, x):
    return jnp.tanh(x @ p["w"] + p["b"])


def _tstage(p, x):
    return torch.tanh(x @ p["w"] + p["b"])


def _jax(shape, params, xs, g, batch_axis=None):
    n = int(np.prod(list(shape.values())))
    mesh = JMesh(np.asarray(jax.devices()[:n]).reshape(
        tuple(shape.values())), tuple(shape))
    p = jpipe.shard_stacked_params(
        mesh, "pipe", {k: jnp.asarray(v) for k, v in params.items()})

    def f(p, xs):
        return jpipe.pipeline_apply(mesh, "pipe", _jstage, p, xs,
                                    batch_axis=batch_axis)

    out, vjp = jax.vjp(f, p, jnp.asarray(xs))
    dp, dx = vjp(jnp.asarray(g))
    return (np.asarray(out), {k: np.asarray(v) for k, v in dp.items()},
            np.asarray(dx))


# ---- rank-side case ---------------------------------------------------

def rank_pipeline(shape, params, xs, g, batch_axis=None):
    mesh = tmesh.make_mesh(shape)
    p = tpipe.shard_stacked_params(mesh, "pipe", params)
    p = {k: v.requires_grad_(True) for k, v in p.items()}
    x = torch.from_numpy(xs).requires_grad_(True)
    out = tpipe.pipeline_apply(mesh, "pipe", _tstage, p, x,
                               batch_axis=batch_axis)
    grads = torch.autograd.grad(out, [p["w"], p["b"], x],
                                torch.from_numpy(g))
    return {"stage": mesh.axis_index("pipe"), "out": out.detach().numpy(),
            "dw": grads[0].numpy(), "db": grads[1].numpy(),
            "dx": grads[2].numpy()}


# ---- the tests ---------------------------------------------------------

@pytest.fixture(scope="module")
def world2(tmp_path_factory):
    with World(2, str(tmp_path_factory.mktemp("pipe2"))) as w:
        yield w


@pytest.fixture(scope="module")
def world4(tmp_path_factory):
    with World(4, str(tmp_path_factory.mktemp("pipe4"))) as w:
        yield w


def _close(got, want, what):
    scale = max(float(np.max(np.abs(want))), 1e-30)
    err = float(np.max(np.abs(got - want)))
    assert err <= TOL * scale, (what, err, scale)


def _sequential(params, xs):
    h = torch.from_numpy(xs)
    for s in range(params["w"].shape[0]):
        h = _tstage({k: torch.from_numpy(v[s]) for k, v in params.items()},
                    h)
    return h.numpy()


def _held(ranks, want, params, xs):
    out, dp, dx = want
    seq = _sequential(params, xs)
    for r in ranks:
        _close(r["out"], out, "out")
        _close(r["out"], seq, "out vs sequential")
        _close(r["dw"], dp["w"][r["stage"]], ("dw", r["stage"]))
        _close(r["db"], dp["b"][r["stage"]], ("db", r["stage"]))
    # dx reaches only stage 0's inputs, whole on the ranks of stage 0
    for r in ranks:
        if r["stage"] == 0:
            _close(r["dx"], dx, "dx")


@pytest.mark.parametrize("n", [2, 4])
def test_pipeline_matches_jax_and_the_stack(n, world2, world4):
    world = world2 if n == 2 else world4
    params = _stacked(n)
    xs, g = _data()
    want = _jax({"pipe": n}, params, xs, g)
    _held(world.run(rank_pipeline, {"pipe": n}, params, xs, g), want,
          params, xs)


def test_pipe_by_data(world4):
    params = _stacked(2, seed=5)
    xs, g = _data(seed=6)
    shape = {"pipe": 2, "data": 2}
    want = _jax(shape, params, xs, g, batch_axis="data")
    _held(world4.run(rank_pipeline, shape, params, xs, g, "data"), want,
          params, xs)


def test_microbatch_round_trip():
    x = torch.arange(24.0).reshape(12, 2)
    mb = tpipe.microbatch(x, 3)
    assert mb.shape == (3, 4, 2)
    np.testing.assert_array_equal(
        mb.numpy(), np.asarray(jpipe.microbatch(jnp.asarray(x.numpy()), 3)))
    assert torch.equal(tpipe.unmicrobatch(mb), x)
    with pytest.raises(ValueError, match="not divisible into 5"):
        tpipe.microbatch(x, 5)
