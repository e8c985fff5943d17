"""The moe layer and its op against the JAX package, on the CPU.

Mirrors `tests/test_pipeline_moe.py`'s TestMoEOps, TestMoEGrouping,
TestMoELayer (all but the two expert-sharding tests, which need the
mesh of ROADMAP A8) and TestMoEPrimeN on the port, and holds the port
against the JAX op and layer on the same numpy inputs: routing tensors,
outputs, the aux loss and every gradient at rtol 1e-5 (atol 1e-6 of
the largest entry). Also: the port's LAYERS holds every JAX layer type
name, and nothing is left in NOT_PORTED.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from paddle_tpu import dsl as jdsl
from paddle_tpu.core import arg as jarg
from paddle_tpu.core.registry import LAYERS as JLAYERS
from paddle_tpu.network import Network as JNetwork
from paddle_tpu.ops import moe as jmoe
from paddle_tpu_torch import dsl as tdsl
from paddle_tpu_torch.core import arg as targ
from paddle_tpu_torch.core.config import OptimizationConf
from paddle_tpu_torch.core.registry import LAYERS as TLAYERS
from paddle_tpu_torch.layers import base as tbase
from paddle_tpu_torch.network import Network as TNetwork
from paddle_tpu_torch.optimizers import create_optimizer
from paddle_tpu_torch.ops import moe as tmoe

RTOL = 1e-5


def _close(got, want, what=""):
    got = got.detach().numpy() if torch.is_tensor(got) else np.asarray(got)
    want = np.asarray(want)
    assert got.shape == want.shape, (what, got.shape, want.shape)
    np.testing.assert_allclose(got, want, rtol=RTOL, atol=1e-6 * max(
        1.0, float(np.abs(want).max())), err_msg=what)


def _t(x):
    return torch.from_numpy(np.asarray(x))


# ---- the ops, as the JAX tests state them ---------------------------------
class TestMoEOps:
    def test_top1_routing_capacity(self):
        logits = torch.tensor([[5.0, 0.0], [4.0, 0.0], [3.0, 0.0],
                               [0.0, 2.0]])
        dispatch, combine, aux = tmoe.top1_routing(logits, capacity=2)
        d = dispatch.numpy()
        # tokens 0, 1 fill expert 0; token 2 overflows (dropped)
        assert d[0, 0].sum() == 1 and d[1, 0].sum() == 1
        assert d[2].sum() == 0
        assert d[3, 1].sum() == 1
        # distinct buffer slots
        assert d[0, 0, 0] == 1 and d[1, 0, 1] == 1
        assert float(aux) > 0

    def test_moe_matches_dense_single_expert(self):
        # E = 1 with ample capacity is a plain FFN scaled by the
        # (constant) gate prob 1.0
        rng = np.random.default_rng(0)
        d, h, n = 6, 12, 10
        x = _t(rng.standard_normal((n, d)).astype(np.float32))
        w_in = _t((rng.standard_normal((1, d, h)) * 0.3).astype(np.float32))
        w_out = _t((rng.standard_normal((1, h, d)) * 0.3).astype(np.float32))
        y, aux = tmoe.moe_ffn(x, torch.zeros((d, 1)), w_in, w_out,
                              capacity_factor=2.0)
        want = torch.relu(x @ w_in[0]) @ w_out[0]
        np.testing.assert_allclose(y.numpy(), want.numpy(), rtol=1e-5,
                                   atol=1e-6)
        np.testing.assert_allclose(float(aux), 1.0, rtol=1e-5)


class TestMoEGrouping:
    def test_grouped_matches_manual_groups(self):
        rng = np.random.default_rng(0)
        d, h, e, n = 4, 8, 2, 8
        x = _t(rng.standard_normal((n, d)).astype(np.float32))
        router = _t(rng.standard_normal((d, e)).astype(np.float32))
        w_in = _t((rng.standard_normal((e, d, h)) * 0.3).astype(np.float32))
        w_out = _t((rng.standard_normal((e, h, d)) * 0.3).astype(np.float32))
        y, _ = tmoe.moe_ffn(x, router, w_in, w_out, capacity_factor=4.0,
                            group_size=4)
        halves = [tmoe.moe_ffn(x[i:i + 4], router, w_in, w_out,
                               capacity_factor=4.0, group_size=4)[0]
                  for i in (0, 4)]
        np.testing.assert_allclose(y.numpy(), torch.cat(halves).numpy(),
                                   rtol=1e-5, atol=1e-6)

    def test_bf16_rank_exactness(self):
        # > 256 tokens on one expert: ranks stay exact under bf16
        # activations (f32 rank math inside routing)
        n, e = 400, 2
        logits = torch.zeros((n, e), dtype=torch.bfloat16)
        logits[:, 0] = 1.0
        dispatch, _, _ = tmoe.top1_routing(logits, capacity=n)
        d = dispatch.float().numpy()
        slots = d[:, 0, :].argmax(-1)
        assert len(set(slots.tolist())) == n
        assert d.sum() == n


class TestMoEPrimeN:
    def test_prime_token_count_keeps_capacity_discipline(self):
        # N = 7 (prime), group_size 4: padded to 8, two groups of 4,
        # capacity enforced within groups
        rng = np.random.default_rng(0)
        d, e, n = 4, 2, 7
        x = _t(rng.standard_normal((n, d)).astype(np.float32))
        w_in = _t((rng.standard_normal((e, d, 8)) * 0.3).astype(np.float32))
        w_out = _t((rng.standard_normal((e, 8, d)) * 0.3).astype(np.float32))
        y, aux = tmoe.moe_ffn(x, torch.zeros((d, e)), w_in, w_out,
                              capacity_factor=1.0, group_size=4)
        assert y.shape == (n, d)
        # capacity 1.0 * 4 / 2 = 2 a group -> at most 4 of 7 tokens
        # produce a non-zero output
        assert int((y.abs().sum(-1) > 1e-7).sum()) <= 4
        assert np.isfinite(float(aux))


# ---- the op against the JAX op --------------------------------------------
@pytest.mark.parametrize("masked", [False, True])
def test_top1_routing_matches_jax(masked):
    rng = np.random.default_rng(3)
    logits = rng.standard_normal((37, 5)).astype(np.float32)
    mask = (rng.random(37) > 0.3).astype(np.float32) if masked else None
    want = jmoe.top1_routing(jnp.asarray(logits), 6, token_mask=None
                             if mask is None else jnp.asarray(mask))
    got = tmoe.top1_routing(_t(logits), 6, None if mask is None
                            else _t(mask))
    for name, g, w in zip(("dispatch", "combine", "aux"), got, want):
        _close(g, w, name)


@pytest.mark.parametrize("n,group,cf,masked", [
    (64, 16, 1.25, False),   # four full groups, drops
    (61, 16, 1.25, True),    # padded last group, masked tokens
    (23, 1024, 2.0, False),  # one group of all tokens
])
def test_moe_ffn_matches_jax_with_gradients(n, group, cf, masked):
    rng = np.random.default_rng(n)
    d, h, e = 8, 16, 4
    args = [rng.standard_normal((n, d)), rng.standard_normal((d, e)),
            rng.standard_normal((e, d, h)) * 0.3,
            rng.standard_normal((e, h, d)) * 0.3]
    args = [a.astype(np.float32) for a in args]
    mask = (rng.random(n) > 0.25).astype(np.float32) if masked else None
    dy = rng.standard_normal((n, d)).astype(np.float32)

    def jloss(*a):
        y, aux = jmoe.moe_ffn(*a, capacity_factor=cf, group_size=group,
                              token_mask=None if mask is None
                              else jnp.asarray(mask))
        return jnp.sum(y * dy) + 3.0 * aux, (y, aux)

    (_, (jy, jaux)), jg = jax.value_and_grad(
        jloss, argnums=(0, 1, 2, 3), has_aux=True)(
            *(jnp.asarray(a) for a in args))
    leaves = [_t(a).requires_grad_(True) for a in args]
    ty, taux = tmoe.moe_ffn(*leaves, capacity_factor=cf, group_size=group,
                            token_mask=None if mask is None else _t(mask))
    ((ty * _t(dy)).sum() + 3.0 * taux).backward()
    _close(ty, jy, "y")
    _close(taux, jaux, "aux")
    for name, leaf, g in zip(("x", "router", "w_in", "w_out"), leaves, jg):
        _close(leaf.grad, g, name)


# ---- the layer --------------------------------------------------------------
def _conf(dsl, e=4, seq=False):
    with dsl.model() as g:
        if seq:
            x = dsl.data("x", 8, is_seq=True)
        else:
            x = dsl.data("x", 8)
        y = dsl.data("y", 1, is_ids=True)
        h = dsl.fc(x, size=16, act="relu")
        m = dsl.moe(h, num_experts=e, hidden=32, name="moe")
        if seq:
            m = dsl.seq_pool(m, pool_type="average")
        out = dsl.fc(m, size=3, name="out")
        dsl.classification_cost(out, y, name="cost")
    return g.conf


@pytest.mark.parametrize("seq", [False, True])
def test_moe_layer_matches_jax(seq):
    """Loss, the aux output and every gradient of the layer in a small
    net equal the JAX Network's on the same parameters and feed; a
    sequence input routes only its real tokens."""
    jconf, tconf = _conf(jdsl, seq=seq), _conf(tdsl, seq=seq)
    jnet, tnet = JNetwork(jconf), TNetwork(tconf)
    params = {k: np.asarray(v) for k, v in jnet.init_params(
        jax.random.key(0)).items()}
    rng = np.random.default_rng(5)
    if seq:
        lens = np.array([5, 2, 7, 1], np.int32)
        xv = rng.standard_normal((4, 7, 8)).astype(np.float32)
        jx = jarg.seq(jnp.asarray(xv), jnp.asarray(lens))
        tx = targ.seq(xv, lens)
    else:
        xv = rng.standard_normal((32, 8)).astype(np.float32)
        jx, tx = jarg.non_seq(jnp.asarray(xv)), targ.non_seq(xv)
    yv = rng.integers(0, 3, xv.shape[0]).astype(np.int32)
    jfeed = {"x": jx, "y": jarg.id_arg(jnp.asarray(yv))}
    tfeed = {"x": tx, "y": targ.id_arg(yv)}
    (jl, (jouts, _)), jg = jax.value_and_grad(jnet.loss_fn, has_aux=True)(
        {k: jnp.asarray(v) for k, v in params.items()}, jfeed)
    tp = {k: torch.tensor(v, requires_grad=True) for k, v in params.items()}
    tl, (touts, _) = tnet.loss_fn(tp, tfeed)
    tl.backward()
    assert "moe@aux_cost" in tnet.cost_names
    _close(tl, jl, "loss")
    _close(touts["moe@aux"].value, jouts["moe@aux"].value, "aux")
    _close(touts["moe"].value, jouts["moe"].value, "moe")
    assert sorted(tp) == sorted(jg)
    for k, g in jg.items():
        _close(tp[k].grad, g, k)


class TestMoELayer:
    def test_moe_trains_with_aux_loss(self):
        net = TNetwork(_conf(tdsl))
        assert "moe@aux_cost" in net.cost_names
        params = net.init_params(torch.Generator().manual_seed(0),
                                 device="cpu")
        assert params["_moe.w0_in"].shape == (4, 16, 32)
        opt = create_optimizer(
            OptimizationConf(learning_method="adam", learning_rate=0.01),
            net.param_confs)
        st = opt.init_state(params)
        rng = np.random.default_rng(0)
        feed = {"x": targ.non_seq(rng.standard_normal((32, 8)).astype(
                    np.float32)),
                "y": targ.id_arg(rng.integers(0, 3, 32).astype(np.int32))}
        first = loss = None
        for i in range(50):
            leaves = {k: v.detach().requires_grad_(True)
                      for k, v in params.items()}
            loss, _ = net.loss_fn(leaves, feed)
            grads = dict(zip(leaves, torch.autograd.grad(
                loss, list(leaves.values()))))
            params, st = opt.update(grads, params, st, i)
            if i == 0:
                first = float(loss.detach())
        assert float(loss.detach()) < first * 0.7, (first, float(loss))

    def test_padding_excluded_from_routing(self):
        # padded tokens do not consume expert capacity: with the mask a
        # late real token keeps its slot even when padding floods the
        # same expert
        n, e = 8, 2
        logits = torch.zeros((n, e))
        logits[:, 0] = 1.0
        mask = torch.tensor([1, 0, 0, 0, 0, 0, 0, 1], dtype=torch.float32)
        d = tmoe.top1_routing(logits, capacity=2, token_mask=mask)[0].numpy()
        assert d[0, 0].sum() == 1
        assert d[7, 0].sum() == 1   # rank 1, not 7
        assert d[1:7].sum() == 0
        # unmasked, the last real token would overflow and be dropped
        assert tmoe.top1_routing(logits, capacity=2)[0].numpy()[7].sum() == 0

    def test_expert_init_uses_per_expert_fanin(self):
        net = TNetwork(_conf(tdsl, e=8))
        pc = net.param_confs["_moe.w0_in"]
        assert pc.initial_std == pytest.approx(1.0 / 4.0)   # 1/sqrt(16)
        assert pc.expert_sharded and net.param_confs[
            "_moe.w0_out"].expert_sharded
        assert not net.param_confs["_moe.w0"].expert_sharded

    def test_merged_submodels_with_moe(self):
        from paddle_tpu_torch.multi_network import merge_confs, prefix_feed

        merged = merge_confs({"a": _conf(tdsl), "b": _conf(tdsl)},
                             share_params=False)
        net = TNetwork(merged)
        assert "a/moe@aux_cost" in net.cost_names
        params = net.init_params(torch.Generator().manual_seed(0),
                                 device="cpu")
        rng = np.random.default_rng(0)
        feed = {}
        for sub in ("a", "b"):
            feed.update(prefix_feed(sub, {
                "x": targ.non_seq(rng.standard_normal((8, 8)).astype(
                    np.float32)),
                "y": targ.id_arg(rng.integers(0, 3, 8).astype(np.int32)),
            }))
        loss, _ = net.loss_fn(params, feed)
        assert np.isfinite(float(loss))


def test_every_jax_layer_type_is_ported():
    jax_types = set(JLAYERS.names())
    assert len(jax_types) == 126
    assert jax_types <= set(TLAYERS.names())
    assert tbase.NOT_PORTED == {}
