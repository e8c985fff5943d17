"""Data-parallel and sharded training on the port's mesh against the
JAX mesh, on the CPU.

The JAX side runs `TrainStep(mesh=...)` on `tests/conftest.py`'s
8-device CPU mesh; the port side runs as spawned gloo ranks
(`paddle_tpu_torch/parallel/world.py`: one world of 2 and one of 4 for
the module, a `FileStore` under the test's tmp dir, each case joined
within its own timeout). Both start from the same numpy weights and
take the same global batches:

- three adam steps at {data: n} for the small LM, the two-block fused
  ResNet (BN over the global batch: B1's column sums and the in-BN's
  all-reduced; the plain B1-B3 on the CPU) and the classifier with
  ragged lengths (its LSTMs on the kernels' path), n = 2 and 4: the
  losses within rtol 1e-4, every parameter and BN running statistic
  within 1e-4 of its largest entry, on every rank;
- {data: 2, model: 2} at `test_dp_model_mesh_matches_single_device`'s
  setting (a row-sharded embedding, column-sharded fc weights stored as
  shards, gathered at use);
- moe expert-sharded at `test_moe_sharded_step_runs`'s conf (8 experts
  over model = 4, the dispatch an all-to-all) against the JAX step;
- a NaN in one rank's slice of the batch makes every rank skip the
  update (the watchdog's flag is the minimum over the ranks);
- a DP step with dropout against the port's one-rank step at the global
  batch (each rank draws its rows of the global mask);
- a batch that does not divide over the data axis raises, and a
  parameter that lost its shard's shape raises;
- every collective of `parallel/collectives.py`, forward and backward,
  against the sums and slices it stands for, over 2 and 4 ranks;
- `SGD(mesh=...)` over 2 ranks against the JAX trainer on a {data: 2}
  mesh: the same costs, an evaluator's results over the global batch,
  an async pass written by both ranks (rank 0's manifest) that one
  process loads whole, and a resume of it on the ranks.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import Mesh as JMesh

from paddle_tpu import dsl as jdsl
from paddle_tpu.core import arg as jarg
from paddle_tpu.core.config import OptimizationConf as JOptConf
from paddle_tpu.models import image as jimage
from paddle_tpu.models import lm as jlm
from paddle_tpu.models import text as jtext
from paddle_tpu.network import Network as JNetwork
from paddle_tpu.optimizers import create_optimizer as jcreate
from paddle_tpu.parallel.dp import TrainStep as JTrainStep
from paddle_tpu.trainer.events import EndIteration as JEndIteration
from paddle_tpu.trainer.events import EndPass as JEndPass
from paddle_tpu.trainer.trainer import SGD as JSGD

from paddle_tpu_torch import dsl as tdsl
from paddle_tpu_torch.core import arg as targ
from paddle_tpu_torch.core import flags as tflags
from paddle_tpu_torch.core import rng as trng
from paddle_tpu_torch.core.config import OptimizationConf as TOptConf
from paddle_tpu_torch.models import image as timage
from paddle_tpu_torch.models import lm as tlm
from paddle_tpu_torch.models import text as ttext
from paddle_tpu_torch.network import Network as TNetwork
from paddle_tpu_torch.optimizers import create_optimizer as tcreate
from paddle_tpu_torch.parallel import collectives as C
from paddle_tpu_torch.parallel.dp import TrainStep as TTrainStep
from paddle_tpu_torch.parallel.world import RankFailed, World
from paddle_tpu_torch.trainer import async_checkpoint as tactp
from paddle_tpu_torch.trainer.events import EndIteration, EndPass
from paddle_tpu_torch.trainer.trainer import SGD as TSGD

STEPS = 3
TOL = 1e-4
OPT = dict(learning_method="adam", learning_rate=0.01)
CLS = dict(vocab_size=50, emb_dim=8, hidden=16)
LM = dict(vocab=64, d_model=32, num_heads=2, num_layers=2)


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


def _tp_conf(dsl):
    """test_dp_model_mesh_matches_single_device's model."""
    with dsl.model() as m:
        x = dsl.data("x", dim=(16,))
        ids = dsl.data("ids", dim=(), is_ids=True)
        emb = dsl.embedding(ids, size=8, vocab_size=32, sharded=True)
        h = dsl.fc(x, emb, size=16, act="relu", name="h")
        out = dsl.fc(h, size=4, act="softmax", name="out")
        lbl = dsl.data("label", dim=(), is_ids=True)
        dsl.classification_cost(out, lbl)
    return m.conf


def _moe_conf(dsl):
    """test_moe_sharded_step_runs's model (8 experts)."""
    with dsl.model() as g:
        x = dsl.data("x", 8)
        y = dsl.data("y", 1, is_ids=True)
        h = dsl.fc(x, size=16, act="relu")
        m = dsl.moe(h, num_experts=8, hidden=32, name="moe")
        out = dsl.fc(m, size=3, name="out")
        dsl.classification_cost(out, y, name="cost")
    return g.conf


def _drop_conf(dsl, rate=0.5):
    with dsl.model() as g:
        x = dsl.data("x", 8)
        y = dsl.data("y", 1, is_ids=True)
        h = dsl.fc(x, size=16, act="relu", name="h", drop_rate=rate)
        out = dsl.fc(h, size=3, act="softmax", name="out")
        dsl.classification_cost(out, y, name="cost")
    return g.conf


def _conf(name, port):
    dsl = tdsl if port else jdsl
    if name == "classifier":
        return (ttext if port else jtext).stacked_lstm_classifier(**CLS)
    if name == "resnet":
        return _tiny_resnet(dsl, timage if port else jimage)
    if name == "lm":
        m = tlm if port else jlm
        return m.transformer_lm(m.LMSpec(**LM))
    if name == "tp":
        return _tp_conf(dsl)
    if name == "moe":
        return _moe_conf(dsl)
    return _drop_conf(dsl, 0.0 if name == "mlp" else 0.5)


def _batches(name, batch, seed=0):
    """STEPS global numpy batches {input: (array, lens)}."""
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(STEPS):
        if name == "classifier":
            lens = rng.integers(1, 14, batch).astype(np.int32)
            b = {"words": (rng.integers(0, 50, (batch, 13)), lens),
                 "label": (rng.integers(0, 2, batch), None)}
        elif name == "resnet":
            b = {"image": (rng.standard_normal((batch, 8, 8, 16)).astype(
                np.float32), None),
                "label": (rng.integers(0, 3, batch), None)}
        elif name == "lm":
            lens = rng.integers(5, 21, batch).astype(np.int32)
            b = {k: (rng.integers(2, LM["vocab"], (batch, 20)), lens)
                 for k in ("ids", "label")}
        elif name == "tp":
            b = {"x": (rng.standard_normal((batch, 16)).astype(np.float32),
                       None),
                 "ids": (rng.integers(0, 32, batch), None),
                 "label": (rng.integers(0, 4, batch), None)}
        else:
            b = {"x": (rng.standard_normal((batch, 8)).astype(np.float32),
                       None),
                 "y": (rng.integers(0, 3, batch), None)}
        out.append(b)
    return out


def _jfeed(b):
    return {k: jarg.non_seq(jnp.asarray(x)) if x.dtype == np.float32
            else jarg.id_arg(x.astype(np.int32), lens)
            for k, (x, lens) in b.items()}


def _tfeed(b):
    return {k: targ.non_seq(torch.from_numpy(x)) if x.dtype == np.float32
            else targ.id_arg(x, lens) for k, (x, lens) in b.items()}


def _np_weights(name):
    jnet = JNetwork(_conf(name, port=False))
    rng = np.random.default_rng(3)
    params = {}
    for k, v in jnet.init_params(jax.random.key(3)).items():
        v = np.asarray(v)
        if v.ndim == 1:
            v = v + 0.3 * rng.standard_normal(v.shape).astype(np.float32)
        params[k] = v
    state = jax.tree_util.tree_map(np.asarray, jnet.init_state())
    return params, state


def _jax_run(name, shape, params, state, batches, opt=OPT):
    """The JAX mesh step over the batches: (losses, params, state)."""
    net = JNetwork(_conf(name, port=False))
    jopt = jcreate(JOptConf(**opt), net.param_confs)
    n = int(np.prod(list(shape.values())))
    mesh = JMesh(np.asarray(jax.devices()[:n]).reshape(
        tuple(shape.values())), tuple(shape))
    step = JTrainStep(net, jopt, mesh=mesh, donate=False)
    p = {k: jnp.asarray(v) for k, v in params.items()}
    s = jax.tree_util.tree_map(jnp.asarray, state)
    o = jopt.init_state(p)
    p, o, s = step.place(p, o, s)
    losses = []
    for i, b in enumerate(batches):
        p, o, s, loss, _ = step(p, o, s, _jfeed(b), i,
                                jax.random.key(9))
        losses.append(float(loss))
    return (losses, {k: np.asarray(v) for k, v in p.items()},
            jax.tree_util.tree_map(np.asarray, s))


# ---- rank-side cases (run in the spawned ranks) ------------------------

def _full(step, p):
    """Every parameter whole: shards all-gathered over their axes."""
    from paddle_tpu_torch.parallel.sharding import sharded_dims

    out = {}
    for k, v in p.items():
        for dim, axis in sharded_dims(step.specs.get(k, ())):
            v = C.all_gather_(step.mesh, axis, v, dim)
        out[k] = v.detach().numpy()
    return out


def rank_dp_steps(name, shape, params, state, batches, opt=OPT,
                  watchdog=False, rules=None, trace=False):
    from paddle_tpu_torch.core import mesh as tmesh

    if name == "classifier":
        tflags.set_flag("use_pallas_rnn", True)
    mesh = tmesh.make_mesh(shape)
    tmesh.set_mesh(mesh)
    net = TNetwork(_conf(name, port=True))
    topt = tcreate(TOptConf(**opt), net.param_confs)
    step = TTrainStep(net, topt, mesh=mesh, sharding_rules=rules,
                      watchdog=watchdog, device="cpu")
    full_opt = topt.init_state({k: torch.from_numpy(v)
                                for k, v in params.items()})
    p, o, s = step.place(params, full_opt, state)
    losses, steps = [], []
    root = trng.generator(5)
    for i, b in enumerate(batches):
        p, o, s, loss, _ = step(p, o, s, _tfeed(b), i,
                                trng.split_for_step(root, i))
        losses.append(loss.numpy().tolist())
        if trace:
            steps.append(_full(step, p))
    local = {k: tuple(v.shape) for k, v in p.items()}
    return {"losses": losses, "params": _full(step, p), "local": local,
            "trace": steps,
            "state": {k: {sl: t.numpy() for sl, t in v.items()}
                      for k, v in s.items()},
            "host_bytes": mesh.host_bytes}


def rank_one_step(name, params, state, batches, opt=OPT):
    """The port's one-rank step at the global batch (no mesh)."""
    net = TNetwork(_conf(name, port=True))
    topt = tcreate(TOptConf(**opt), net.param_confs)
    step = TTrainStep(net, topt, device="cpu")
    p = {k: torch.from_numpy(v.copy()) for k, v in params.items()}
    o = topt.init_state(p)
    s = {k: {sl: torch.from_numpy(t.copy()) for sl, t in v.items()}
         for k, v in state.items()}
    losses = []
    root = trng.generator(5)
    for i, b in enumerate(batches):
        p, o, s, loss, _ = step(p, o, s, _tfeed(b), i,
                                trng.split_for_step(root, i))
        losses.append(float(loss))
    return {"losses": losses,
            "params": {k: v.numpy() for k, v in p.items()}}


def rank_bad_batch(shape):
    from paddle_tpu_torch.core import mesh as tmesh

    mesh = tmesh.make_mesh(shape)
    net = TNetwork(_conf("drop", port=True))
    topt = tcreate(TOptConf(**OPT), net.param_confs)
    step = TTrainStep(net, topt, mesh=mesh, device="cpu")
    params, _ = _np_weights_port("drop")
    p, o, s = step.place(params, topt.init_state(
        {k: torch.from_numpy(v) for k, v in params.items()}), {})
    b = _batches("drop", 5)[0]
    try:
        step(p, o, s, _tfeed(b), 0, None)
    except ValueError as e:
        msg = str(e)
    else:
        msg = None
    p2 = dict(p)
    k = next(iter(step.specs))
    step.specs[k] = ("data",) + (None,) * (len(p[k].shape) - 1)
    try:
        step.check_shards(p2)
    except RuntimeError as e:
        return msg, str(e)
    return msg, None


def _np_weights_port(name):
    net = TNetwork(_conf(name, port=True))
    p = net.init_params(torch.Generator().manual_seed(4), device="cpu")
    return {k: v.numpy() for k, v in p.items()}, {}


# ---- the tests ---------------------------------------------------------

@pytest.fixture(scope="module")
def world2(tmp_path_factory):
    with World(2, str(tmp_path_factory.mktemp("world2"))) as w:
        yield w


@pytest.fixture(scope="module")
def world4(tmp_path_factory):
    with World(4, str(tmp_path_factory.mktemp("world4"))) as w:
        yield w


def _close(got, want, what):
    scale = max(float(np.max(np.abs(want))), 1e-30)
    err = float(np.max(np.abs(np.asarray(got) - want)))
    assert err <= TOL * scale, (what, err, scale)


def _held(ranks, losses, params, state=None):
    for r, out in enumerate(ranks):
        np.testing.assert_allclose(out["losses"], losses, rtol=TOL,
                                   err_msg=f"rank {r}")
        for k, v in params.items():
            _close(out["params"][k], v, (r, k))
        for layer, slots in (state or {}).items():
            for sl, v in slots.items():
                _close(out["state"][layer][sl], v, (r, layer, sl))


@pytest.mark.parametrize("name", ["lm", "resnet", "classifier"])
@pytest.mark.parametrize("n", [2, 4])
def test_dp_steps_match_the_jax_mesh(name, n, world2, world4):
    world = world2 if n == 2 else world4
    params, state = _np_weights(name)
    batches = _batches(name, 8)
    losses, jp, js = _jax_run(name, {"data": n}, params, state, batches)
    ranks = world.run(rank_dp_steps, name, {"data": n}, params, state,
                      batches)
    _held(ranks, losses, jp, js)


def test_dp_model_mesh_matches_jax(world4):
    params, state = _np_weights("tp")
    opt = dict(learning_method="sgd", learning_rate=0.1)
    batches = _batches("tp", 8)
    shape = {"data": 2, "model": 2}
    losses, jp, _ = _jax_run("tp", shape, params, state, batches, opt)
    ranks = world4.run(rank_dp_steps, "tp", shape, params, state, batches,
                       opt)
    _held(ranks, losses, jp)
    # the sharded weights are stored as the rank's shard only
    local = ranks[0]["local"]
    assert local["_h.w0"] == (16, 8) and local["_out.w0"] == (16, 2)


def test_moe_expert_sharded_step_matches_jax(world4):
    params, state = _np_weights("moe")
    batches = _batches("moe", 16, seed=1)
    shape = {"data": 1, "model": 4}
    losses, jp, _ = _jax_run("moe", shape, params, state, batches)
    ranks = world4.run(rank_dp_steps, "moe", shape, params, state, batches)
    _held(ranks, losses, jp)
    assert ranks[0]["local"]["_moe.w0_in"] == (2, 16, 32)


def test_nan_on_one_rank_skips_every_rank(world2):
    params, _ = _np_weights_port("drop")
    batches = _batches("drop", 8)
    batches[1]["x"][0][6, 3] = np.nan  # row 6: rank 1's slice
    ranks = world2.run(rank_dp_steps, "drop", {"data": 2}, params, {},
                       batches, OPT, True, None, True)
    healths = [np.asarray(r["losses"]) for r in ranks]
    for h in healths:
        assert h[:, 1].tolist() == [1.0, 0.0, 1.0]
    for k in params:
        for r in ranks:
            # the skipped step left every rank's parameters as they were
            np.testing.assert_array_equal(r["trace"][1][k],
                                          r["trace"][0][k])
            assert not np.array_equal(r["trace"][2][k], r["trace"][1][k])
        np.testing.assert_array_equal(ranks[0]["params"][k],
                                      ranks[1]["params"][k])


def test_dp_dropout_matches_the_one_rank_step(world2):
    params, _ = _np_weights_port("drop")
    batches = _batches("drop", 8)
    ranks = world2.run(rank_dp_steps, "drop", {"data": 2}, params, {},
                       batches)
    (one,) = [world2.run(rank_one_step, "drop", params, {}, batches)[0]]
    _held(ranks, one["losses"], one["params"])


def test_bad_batch_and_dropped_shard_raise(world2):
    for msg, shard_msg in world2.run(rank_bad_batch, {"data": 2}):
        assert "does not divide over the 2 ranks" in msg
        assert "a sharding was dropped" in shard_msg


def test_a_failing_rank_fails_the_case_with_its_traceback(tmp_path):
    with World(2, str(tmp_path), timeout=60) as w:
        with pytest.raises(RankFailed, match="ZeroDivisionError"):
            w.run(_divide, 1, 0)
        # the next case runs on a new world
        assert w.run(_divide, 6, 3) == [2.0, 2.0]


def _divide(a, b):
    return a / b


def _x(r, shape=(4, 8)):
    return torch.arange(32, dtype=torch.float64).reshape(shape) * (r + 1)


def _g(r, shape=(4, 8)):
    return torch.ones(shape, dtype=torch.float64) * (r + 2) + torch.arange(
        shape[-1], dtype=torch.float64)


def rank_collectives():
    """Each autograd collective on rank r's input _x(r) and cotangent
    _g(r) (of the output's shape) against what it stands for, computed
    from every rank's inputs; the largest error of each."""
    from paddle_tpu_torch.core import mesh as tmesh

    mesh = tmesh.make_mesh({"data": -1})
    n, r = mesh.axis_size("data"), mesh.axis_index("data")
    xs = [_x(i) for i in range(n)]
    err = {}

    def run(name, fn, x, want, g, want_grad):
        x = x.clone().requires_grad_(True)
        y = fn(x)
        (dx,) = torch.autograd.grad(y, [x], g)
        err[name] = max(float((y.detach() - want).abs().max()),
                        float((dx - want_grad).abs().max()))

    total = sum(xs)
    gs = [_g(i) for i in range(n)]
    run("all_reduce", lambda x: C.all_reduce(x, mesh, "data"), xs[r], total,
        gs[r], sum(gs))
    gcat = [_g(i, (4 * n, 8)) for i in range(n)]
    run("all_gather", lambda x: C.all_gather(x, mesh, "data", 0), xs[r],
        torch.cat(xs), gcat[r], sum(gcat)[4 * r:4 * r + 4])
    gsl = [_g(i, (4 // n, 8)) for i in range(n)]
    run("reduce_scatter", lambda x: C.reduce_scatter(x, mesh, "data", 0),
        xs[r], total.chunk(n, 0)[r], gsl[r], torch.cat(gsl))
    ga = [_g(i, (4 * n, 8 // n)) for i in range(n)]
    run("all_to_all", lambda x: C.all_to_all(x, mesh, "data", 1, 0), xs[r],
        torch.cat([x.chunk(n, 1)[r] for x in xs]), ga[r],
        torch.cat([g.chunk(n, 0)[r] for g in ga], 1))
    run("shift", lambda x: C.shift(x, mesh, "data", 1), xs[r],
        xs[(r - 1) % n], gs[r], gs[(r + 1) % n])
    run("split", lambda x: C.split(x, mesh, "data", 0), xs[0],
        xs[0].chunk(n, 0)[r], gsl[r], torch.cat(gsl))
    run("gather", lambda x: C.gather(x, mesh, "data", 0), xs[r],
        torch.cat(xs), gcat[r], gcat[r][4 * r:4 * r + 4])
    run("reduce", lambda x: C.reduce(x, mesh, "data"), xs[r], total, gs[r],
        gs[r])
    run("copy", lambda x: C.copy(x, mesh, "data"), xs[r], xs[r], gs[r],
        sum(gs))
    return err


@pytest.mark.parametrize("n", [2, 4])
def test_every_collective_and_its_backward(n, world2, world4):
    world = world2 if n == 2 else world4
    for r, err in enumerate(world.run(rank_collectives)):
        assert sorted(err) == sorted(
            ["all_reduce", "all_gather", "reduce_scatter", "all_to_all",
             "shift", "split", "gather", "reduce", "copy"])
        assert all(e == 0.0 for e in err.values()), (r, err)


EVALS = [{"type": "classification_error", "input": "out", "label": "y",
          "name": "err"}]


def _reader(batches):
    def read():
        for b in batches:
            yield b
    return read


def _tfeeder(b):
    return _tfeed(b)


def rank_sgd(params, batches, save_dir):
    from paddle_tpu_torch.core import mesh as tmesh

    mesh = tmesh.make_mesh({"data": -1})
    sgd = TSGD(_conf("mlp", port=True), TOptConf(**OPT),
               params={k: torch.from_numpy(v) for k, v in params.items()},
               device="cpu", watchdog=False, evaluators=EVALS, mesh=mesh)
    events = []

    def on(e):
        if isinstance(e, EndIteration):
            events.append(("iter", e.cost))
        elif isinstance(e, EndPass):
            events.append(("pass", e.evaluator_results))

    sgd.train(_reader(batches), _tfeeder, num_passes=1, event_handler=on,
              save_dir=save_dir, checkpoint_mode="async")
    sgd._async_ckpt.wait()
    whole = {k: v.numpy() for k, v in sgd.whole_params().items()}
    again = TSGD(_conf("mlp", port=True), TOptConf(**OPT), device="cpu",
                 watchdog=False, mesh=mesh)
    nxt = again.resume(save_dir)
    resumed = {k: v.numpy() for k, v in again.whole_params().items()}
    return {"events": events, "params": whole, "resumed": resumed,
            "next": nxt, "global_step": again.global_step}


def test_sgd_on_a_mesh_matches_the_jax_trainer(world2, tmp_path):
    jnet = JNetwork(_conf("mlp", port=False))
    params = {k: np.asarray(v) for k, v in
              jnet.init_params(jax.random.key(1)).items()}
    batches = _batches("mlp", 8, seed=4)
    jmesh = JMesh(np.asarray(jax.devices()[:2]), ("data",))
    jt = JSGD(_conf("mlp", port=False), JOptConf(**OPT), mesh=jmesh,
              watchdog=False,
              params={k: jnp.asarray(v) for k, v in params.items()},
              evaluators=EVALS)
    jev = []
    jt.train(_reader(batches), _jfeed, num_passes=1,
             event_handler=lambda e: jev.append(
                 ("iter", e.cost) if isinstance(e, JEndIteration) else
                 ("pass", e.evaluator_results) if isinstance(e, JEndPass)
                 else None))
    jev = [e for e in jev if e is not None]
    d = str(tmp_path / "ckpt")
    ranks = world2.run(rank_sgd, params, batches, d)
    for r in ranks:
        assert [e[0] for e in r["events"]] == [e[0] for e in jev]
        for (kind, a), (_k, b) in zip(r["events"], jev):
            if kind == "iter":
                np.testing.assert_allclose(a, b, rtol=TOL)
            else:
                assert a.keys() == b.keys()
                for key in a:
                    np.testing.assert_allclose(a[key], b[key], rtol=TOL)
        for k, v in jt.params.items():
            _close(r["params"][k], np.asarray(v), k)
            np.testing.assert_array_equal(r["resumed"][k], r["params"][k])
        assert r["next"] == 1 and r["global_step"] == len(batches)
    # both ranks wrote their shard file, rank 0 the manifest; one
    # process loads the pass whole
    tree, meta = tactp.load_pass(d)
    assert meta["global_step"] == len(batches)
    for k, v in ranks[0]["params"].items():
        np.testing.assert_array_equal(tree["params"][k], v)


HOLD_S = 3.0  # how long rank 0 holds its commit back at most


def rank_async_wait_sees_the_pass(save_dir):
    """Each rank saves pass 0 asynchronously and waits. Rank 0's writer
    holds its shard and manifest back until rank 1 says its wait() has
    returned (a marker file), or HOLD_S has passed. If wait() returned
    on rank 1 before the pass was complete, rank 1 reads it incomplete;
    with the ranks meeting after their writers drain, rank 1's wait()
    cannot return while rank 0 holds, so rank 0 always runs out its
    hold and rank 1 reads the pass complete."""
    import os
    import time

    import torch.distributed as dist

    rank = dist.get_rank()
    marker = os.path.join(save_dir, "rank1-returned")
    ck = tactp.AsyncCheckpointer(save_dir)
    held = {}
    if rank == 0:
        write = ck._write_shard

        def held_write(*a, **kw):
            end = time.monotonic() + HOLD_S
            while not os.path.exists(marker) and time.monotonic() < end:
                time.sleep(0.01)
            held["rank1_returned_first"] = os.path.exists(marker)
            return write(*a, **kw)

        ck._write_shard = held_write
    w = {"w": torch.ones(4, 3)}
    ck.save(0, w, meta={"global_step": 1}, shards={})
    ck.wait()
    seen = tactp.latest_complete_pass(save_dir)
    if rank == 1:
        with open(marker, "w"):
            pass
    ck.wait()  # nothing enqueued since: no second meeting
    ck.close()
    return {"seen": seen, **held}


def test_async_wait_on_a_mesh_returns_with_the_pass_complete(world2,
                                                            tmp_path):
    d = str(tmp_path / "ckpt")
    import os

    os.makedirs(d)
    r0, r1 = world2.run(rank_async_wait_sees_the_pass, d)
    assert r1["seen"] == 0, "rank 1's wait() returned before the pass was "\
        "complete"
    assert r0["seen"] == 0
    assert r0["rank1_returned_first"] is False
    tree, meta = tactp.load_pass(d)
    assert meta["global_step"] == 1


RAISE_WAIT_S = 10.0  # how long rank 0 waits for rank 1 to have raised


class _Fault(Exception):
    """A fault inside a training pass, on one rank."""


def rank_raises_after_an_async_save(batches, save_dir):
    """Pass 0 is saved asynchronously on both ranks; in pass 1 rank 1's
    event handler raises after the first batch. Rank 0's, at the same
    batch, waits for rank 1's train() to have raised (a marker file)
    up to RAISE_WAIT_S, then raises too: meanwhile rank 0 sits in no
    collective, as a rank still at work would not be in the one rank 1
    calls. A rank that met the others on its way out would wait there
    for rank 0 (RAISE_WAIT_S); one that drains its own writer raises at
    once."""
    import os
    import time

    import torch.distributed as dist

    from paddle_tpu_torch.core import mesh as tmesh

    rank = dist.get_rank()
    marker = os.path.join(save_dir, "rank1-raised")
    sgd = TSGD(_conf("mlp", port=True), TOptConf(**OPT), device="cpu",
               watchdog=False, mesh=tmesh.make_mesh({"data": -1}))
    out = {}

    def on(e):
        if not (isinstance(e, EndIteration) and e.pass_id == 1):
            return
        if rank == 1:
            out["t_fault"] = time.monotonic()
            raise _Fault("rank 1")
        end = time.monotonic() + RAISE_WAIT_S
        while not os.path.exists(marker) and time.monotonic() < end:
            time.sleep(0.01)
        out["saw_rank1_raise"] = os.path.exists(marker)
        raise _Fault("rank 0")

    try:
        sgd.train(_reader(batches), _tfeeder, num_passes=2,
                  event_handler=on, save_dir=save_dir,
                  checkpoint_mode="async")
    except _Fault:
        if rank == 1:
            out["raised_after_s"] = time.monotonic() - out["t_fault"]
            with open(marker, "w"):
                pass
    return out


def test_a_rank_failing_after_an_async_save_raises_at_once(world2,
                                                           tmp_path):
    """A rank that fails mid-pass drains its own checkpoint writer and
    raises; it does not wait at a barrier for ranks that are elsewhere
    (on NCCL such a barrier can pair with another collective)."""
    d = str(tmp_path / "ckpt")
    r0, r1 = world2.run(rank_raises_after_an_async_save,
                        _batches("mlp", 8, seed=5), d)
    assert r1["raised_after_s"] < RAISE_WAIT_S / 2, r1
    assert r0["saw_rank1_raise"], r0
    assert tactp.latest_complete_pass(d) == 0
