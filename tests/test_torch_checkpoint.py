"""The port's checkpoint files (`paddle_tpu_torch/trainer/checkpoint.py`,
`trainer/async_checkpoint.py`) against the JAX package's, on the CPU.

Files cross both ways, bit for bit: a sync pass, an async (manifested)
pass, a merged model, a v2 tar, a raw parameter file and directory, a
per-process sharded checkpoint and a sharded-table generation, each
written by one package and loaded by the other, every leaf
`np.array_equal` to what was saved with the same dtype (the JAX
`verify_pass` accepts the port's manifests and the port's accepts
JAX's). The states are the tiny classifier's (vocab 64, hidden 16)
parameters with adam slots and a BatchNorm-shaped layer state, from a
seed, and a JAX adam step's real state. Also: the port's own contracts — the
`.old` fallback of a crashed re-save, `save_only_one`, a torn shard
skipped by `latest_complete_pass`, `keep_last` rotation, retried and
latched write errors, and a bf16 leaf refused.
"""

import json
import os

import numpy as np
import pytest
import torch

try:  # the cross-package tests need JAX
    import jax
    import jax.numpy as jnp

    from paddle_tpu.core.config import OptimizationConf as JOptConf
    from paddle_tpu.models import text as jtext
    from paddle_tpu.network import Network as JNetwork
    from paddle_tpu.optimizers import create_optimizer as jcreate
    from paddle_tpu.trainer import async_checkpoint as jactp
    from paddle_tpu.trainer import checkpoint as jckpt
except ImportError:
    jax = None

from paddle_tpu_torch.core.config import OptimizationConf as TOptConf
from paddle_tpu_torch.models import text as ttext
from paddle_tpu_torch.network import Network as TNetwork
from paddle_tpu_torch.optimizers import create_optimizer as tcreate
from paddle_tpu_torch.trainer import async_checkpoint as tactp
from paddle_tpu_torch.trainer import checkpoint as tckpt
from paddle_tpu_torch.weights import opt_state_from_numpy, params_from_numpy

needs_jax = pytest.mark.skipif(jax is None, reason="needs JAX (CPU parity)")

CLS = dict(vocab_size=64, emb_dim=8, hidden=16)


def _leaves(tree, prefix=""):
    if isinstance(tree, dict):
        out = {}
        for k, v in tree.items():
            out.update(_leaves(v, f"{prefix}{k}/"))
        return out
    return {prefix.rstrip("/"): tree}


def _np(x):
    if torch.is_tensor(x):
        return x.detach().cpu().numpy()
    return np.asarray(x)


def _assert_bit_equal(got, want, what=""):
    g, w = _leaves(got), _leaves(want)
    assert g.keys() == w.keys(), what
    for k in w:
        a, b = _np(g[k]), _np(w[k])
        assert a.dtype == b.dtype, (what, k, a.dtype, b.dtype)
        assert a.shape == b.shape, (what, k)
        assert np.array_equal(a, b), (what, k)


def _np_state():
    """(params, adam slots, BN-like state) as numpy, from a seed: the
    classifier's parameter names and adam's slot names."""
    rng = np.random.default_rng(0)
    net = TNetwork(ttext.stacked_lstm_classifier(**CLS))
    params = {k: rng.standard_normal(pc.dims).astype(np.float32)
              for k, pc in net.param_confs.items()}
    slots = {k: {"m": rng.standard_normal(v.shape).astype(np.float32),
                 "v": rng.random(v.shape).astype(np.float32)}
             for k, v in params.items()}
    state = {"bn": {"mean": rng.standard_normal(4).astype(np.float32),
                    "var": rng.random(4).astype(np.float32)}}
    return params, slots, state


def _torch_tree(tree):
    return {k: _torch_tree(v) if isinstance(v, dict)
            else torch.from_numpy(np.array(v)) for k, v in tree.items()}


def _jax_tree(tree):
    return jax.tree_util.tree_map(jnp.asarray, tree)


# ---- sync passes -----------------------------------------------------------


@needs_jax
@pytest.mark.parametrize("writer", ["jax", "port"])
def test_sync_pass_crosses_both_ways(tmp_path, writer):
    params, slots, state = _np_state()
    meta = {"global_step": 17}
    if writer == "jax":
        jckpt.save_pass(str(tmp_path), 3, _jax_tree(params),
                        _jax_tree(slots), _jax_tree(state), meta=meta)
    else:
        tckpt.save_pass(str(tmp_path), 3, _torch_tree(params),
                        _torch_tree(slots), _torch_tree(state), meta=meta)
    for load in (jckpt.load_pass, tckpt.load_pass):
        p, o, s, m = load(str(tmp_path), -1)
        _assert_bit_equal(p, params, "params")
        _assert_bit_equal(o, slots, "opt_state")
        _assert_bit_equal(s, state, "state")
        assert m == {"pass_id": 3, **meta}
    assert (tckpt.list_sync_passes(str(tmp_path))
            == jckpt.list_sync_passes(str(tmp_path)) == [3])


@needs_jax
def test_sync_pass_files_hold_the_same_keys_and_bytes(tmp_path):
    params, slots, state = _np_state()
    jd, td = tmp_path / "jax", tmp_path / "port"
    jckpt.save_pass(str(jd), 0, _jax_tree(params), _jax_tree(slots),
                    _jax_tree(state), meta={"global_step": 1})
    tckpt.save_pass(str(td), 0, _torch_tree(params), _torch_tree(slots),
                    _torch_tree(state), meta={"global_step": 1})
    for name in ("params.npz", "opt_state.npz", "state.npz"):
        with np.load(jd / "pass-00000" / name) as a, \
                np.load(td / "pass-00000" / name) as b:
            assert sorted(a.files) == sorted(b.files)
            for k in a.files:
                assert a[k].dtype == b[k].dtype
                assert np.array_equal(a[k], b[k])
    assert (json.loads((jd / "pass-00000" / "meta.json").read_text())
            == json.loads((td / "pass-00000" / "meta.json").read_text()))


def test_sync_resave_falls_back_to_old_and_save_only_one(tmp_path):
    params, slots, state = _np_state()
    d = str(tmp_path)
    for pid in (0, 1, 2):
        tckpt.save_pass(d, pid, _torch_tree(params), meta={"global_step": pid})
    # a crash between the two renames of a re-save of pass 2: only the
    # parked .old copy is left
    os.replace(os.path.join(d, "pass-00002"), os.path.join(d, "pass-00002.old"))
    os.makedirs(os.path.join(d, "pass-00003.tmp"))  # staging litter
    assert tckpt.list_sync_passes(d) == [0, 1, 2]
    p, _o, _s, meta = tckpt.load_pass(d)
    assert meta["pass_id"] == 2
    _assert_bit_equal(p, params)
    tckpt.save_pass(d, 4, _torch_tree(params), save_only_one=True)
    assert sorted(os.listdir(d)) == ["pass-00004"]


def test_a_bf16_leaf_is_refused(tmp_path):
    params = {"w": torch.ones(3, 2, dtype=torch.bfloat16)}
    with pytest.raises(ValueError, match="bfloat16"):
        tckpt.save_pass(str(tmp_path), 0, params)
    with pytest.raises(ValueError, match="bfloat16"):
        tactp.snapshot_shards({"params": params})


# ---- async (manifested) passes ---------------------------------------------


@needs_jax
@pytest.mark.parametrize("writer", ["jax", "port"])
def test_async_pass_crosses_both_ways(tmp_path, writer):
    params, slots, state = _np_state()
    d = str(tmp_path)
    if writer == "jax":
        cp = jactp.AsyncCheckpointer(d)
        cp.save(2, _jax_tree(params), _jax_tree(slots), _jax_tree(state),
                meta={"global_step": 9, "mid_pass": True,
                      "batch_in_pass": 4})
    else:
        cp = tactp.AsyncCheckpointer(d)
        cp.save(2, _torch_tree(params), _torch_tree(slots),
                _torch_tree(state),
                meta={"global_step": 9, "mid_pass": True,
                      "batch_in_pass": 4})
    cp.close()
    assert jactp.verify_pass(d, 2) == (True, "ok")
    assert tactp.verify_pass(d, 2) == (True, "ok")
    with np.load(tmp_path / "pass-00002" / "shard-p0.npz") as z:
        keys = sorted(z.files)
    assert all(k.endswith("##r0") for k in keys)
    for load in (jactp.load_pass, tactp.load_pass):
        tree, meta = load(d, -1)
        _assert_bit_equal(tree["params"], params, "params")
        _assert_bit_equal(tree["opt_state"], slots, "opt_state")
        _assert_bit_equal(tree["state"], state, "state")
        assert meta == {"pass_id": 2, "global_step": 9, "mid_pass": True,
                        "batch_in_pass": 4}


@needs_jax
def test_a_torn_shard_is_skipped_by_both(tmp_path):
    params, _slots, _state = _np_state()
    d = str(tmp_path)
    cp = tactp.AsyncCheckpointer(d)
    for pid in (0, 1):
        cp.save(pid, _torch_tree(params), meta={"global_step": pid})
    cp.wait()
    shard = tmp_path / "pass-00001" / "shard-p0.npz"
    with open(shard, "r+b") as f:
        f.truncate(shard.stat().st_size // 2)
    ok, reason = tactp.verify_pass(d, 1)
    assert not ok and "truncated" in reason
    assert jactp.verify_pass(d, 1)[0] is False
    assert tactp.latest_complete_pass(d) == jactp.latest_complete_pass(d) == 0
    tree, meta = tactp.load_pass(d)
    assert meta["pass_id"] == 0
    with pytest.raises(ValueError, match="incomplete"):
        tactp.load_pass(d, 1)
    cp.close()


def test_keep_last_rotates_and_the_snapshot_owns_its_bytes(tmp_path):
    d = str(tmp_path)
    cp = tactp.AsyncCheckpointer(d, keep_last=2)
    w = torch.zeros(4, 3)
    for pid in range(4):
        w.fill_(pid)
        cp.save(pid, {"w": w}, meta={"global_step": pid})
        # the caller overwrites its tensor in place right away (as a
        # graph replay does): the saved pass keeps the snapshot's bytes
        w.fill_(-1)
    cp.close()
    assert tactp.list_passes(d) == [2, 3]
    for pid in (2, 3):
        tree, _ = tactp.load_pass(d, pid)
        assert np.array_equal(tree["params"]["w"], np.full((4, 3), pid,
                                                           np.float32))


def test_write_errors_retry_then_latch(tmp_path):
    d = str(tmp_path)
    cp = tactp.AsyncCheckpointer(d, retries=2, retry_base_s=0.001)
    real = cp._write_shard
    fails = {"n": 2}

    def flaky(*a, **kw):
        if fails["n"]:
            fails["n"] -= 1
            raise OSError("transient")
        return real(*a, **kw)

    cp._write_shard = flaky
    cp.save(0, {"w": torch.ones(2)})
    cp.wait()  # two failures, retried
    assert tactp.verify_pass(d, 0)[0]
    fails["n"] = 10
    cp.save(1, {"w": torch.ones(2)})
    with pytest.raises(tactp.AsyncCheckpointError):
        cp.wait()
    cp._write_shard = real
    cp.save(2, {"w": torch.ones(2)})  # the latch was surfaced and cleared
    cp.close()
    assert tactp.latest_complete_pass(d) == 2


@needs_jax
@pytest.mark.parametrize("writer", ["jax", "port"])
def test_sharded_checkpoint_crosses_both_ways(tmp_path, writer):
    params, slots, _state = _np_state()
    tree = {"params": params, "opt_state": slots}
    if writer == "jax":
        jckpt.save_sharded(str(tmp_path), _jax_tree(tree), tag="t")
    else:
        tckpt.save_sharded(str(tmp_path), _torch_tree(tree), tag="t")
    _assert_bit_equal(tckpt.load_sharded(str(tmp_path), tag="t"), tree)
    placed = tckpt.load_sharded(str(tmp_path), _torch_tree(tree), tag="t")
    _assert_bit_equal(placed, tree)
    assert isinstance(placed["params"]["_output.w0"], torch.Tensor)
    template = jax.tree_util.tree_map(jnp.asarray, tree)
    _assert_bit_equal(jckpt.load_sharded(str(tmp_path), template, tag="t"),
                      tree)


@needs_jax
@pytest.mark.parametrize("writer", ["jax", "port"])
def test_table_generations_cross_both_ways(tmp_path, writer):
    rng = np.random.default_rng(1)
    payloads = [{"rows": rng.standard_normal((5, 3)).astype(np.float32),
                 "ids": np.arange(5, dtype=np.int64) + 5 * s}
                for s in range(3)]
    d = str(tmp_path)
    mod = jactp if writer == "jax" else tactp
    mod.write_table_generation(d, 0, payloads, meta={"step": 1})
    mod.write_table_generation(d, 1, payloads, meta={"step": 2})
    # generation 1's shard 2 is torn
    (tmp_path / "gen-00001" / "table-s2.npz").write_bytes(b"torn")
    for m in (jactp, tactp):
        ok, reason = m.verify_table_generation(d, 1)
        assert not ok and "table shard 2 of 3" in reason
        assert m.latest_good_table_generation(d) == 0
    gen, got, meta, quarantined = tactp.recover_table(d)
    assert gen == 0 and meta == {"step": 1}
    assert [q["generation"] for q in quarantined] == [1]
    for g, w in zip(got, payloads):
        _assert_bit_equal(g, w)
    assert jactp.list_table_generations(d) == [0]


def test_async_table_generation(tmp_path):
    d = str(tmp_path)
    cp = tactp.AsyncCheckpointer(d)
    cp.save_table(3, [{"rows": np.ones((2, 2), np.float32)}], meta={"a": 1})
    cp.close()
    gen, payloads, meta = tactp.load_table_generation(d)
    assert gen == 3 and meta == {"a": 1}
    assert np.array_equal(payloads[0]["rows"], np.ones((2, 2), np.float32))


# ---- merged models, tars, parameter files ----------------------------------


@needs_jax
@pytest.mark.parametrize("writer", ["jax", "port"])
def test_merged_model_crosses_both_ways(tmp_path, writer):
    jconf = jtext.stacked_lstm_classifier(**CLS)
    tconf = ttext.stacked_lstm_classifier(**CLS)
    assert jconf.to_json() == tconf.to_json()
    params, _slots, state = _np_state()
    path = str(tmp_path / "model.npz")
    if writer == "jax":
        jckpt.merge_model(path, jconf, _jax_tree(params), _jax_tree(state))
    else:
        tckpt.merge_model(path, tconf, _torch_tree(params),
                          _torch_tree(state))
    for load in (jckpt.load_merged, tckpt.load_merged):
        conf, p, s = load(path)
        assert conf.to_json() == tconf.to_json()
        _assert_bit_equal(p, params, "params")
        _assert_bit_equal(s, state, "state")


@needs_jax
@pytest.mark.parametrize("writer", ["jax", "port"])
def test_tar_crosses_both_ways(tmp_path, writer):
    params, _slots, _state = _np_state()
    params["scalar"] = np.array(2.5, np.float32)
    jnet = JNetwork(jtext.stacked_lstm_classifier(**CLS))
    path = str(tmp_path / "params.tar")
    if writer == "jax":
        jckpt.to_tar(path, _jax_tree(params), jnet.param_confs)
    else:
        tckpt.to_tar(path, _torch_tree(params), jnet.param_confs)
    for load in (jckpt.from_tar, tckpt.from_tar):
        _assert_bit_equal(load(path), params)
    other = str(tmp_path / "other.tar")
    (jckpt if writer == "port" else tckpt).to_tar(
        other, params, jnet.param_confs)
    assert open(path, "rb").read() == open(other, "rb").read()


@needs_jax
@pytest.mark.parametrize("writer", ["jax", "port"])
def test_parameter_files_cross_both_ways(tmp_path, writer):
    params, _slots, _state = _np_state()
    tnet = TNetwork(ttext.stacked_lstm_classifier(**CLS))
    mod = jckpt if writer == "jax" else tckpt
    for name, v in params.items():
        mod.save_parameter_file(str(tmp_path / name),
                                v if writer == "jax"
                                else torch.from_numpy(v))
    for load in (jckpt.load_parameter_dir, tckpt.load_parameter_dir):
        _assert_bit_equal(load(str(tmp_path), tnet.param_confs), params)
    name = next(iter(params))
    got = tckpt.load_parameter_file(str(tmp_path / name))
    assert got.dtype == np.float32 and got.ndim == 1
    assert np.array_equal(got, params[name].ravel())


@needs_jax
def test_the_trainers_states_cross_through_a_sync_pass(tmp_path):
    """A JAX trainer's real adam state (one step of the classifier) saved
    by the JAX package loads into the port's tensors bit for bit, and the
    port's save of those tensors is byte-equal per npz key."""
    jconf = jtext.stacked_lstm_classifier(**CLS)
    jnet = JNetwork(jconf)
    jopt = jcreate(JOptConf(learning_method="adam"), jnet.param_confs)
    jp = jnet.init_params(jax.random.key(0))
    jo = jopt.init_state(jp)
    g = jax.tree_util.tree_map(lambda x: jnp.full_like(x, 0.1), jp)
    jp, jo = jopt.update(g, jp, jo, 0)
    jckpt.save_pass(str(tmp_path / "j"), 0, jax.device_get(jp),
                    jax.device_get(jo), meta={"global_step": 1})
    p, o, _s, _m = tckpt.load_pass(str(tmp_path / "j"))
    tp = params_from_numpy(p, device="cpu")
    to = opt_state_from_numpy(o, device="cpu")
    topt = tcreate(TOptConf(learning_method="adam"),
                   TNetwork(ttext.stacked_lstm_classifier(**CLS))
                   .param_confs)
    assert _leaves(topt.init_state(tp)).keys() == _leaves(to).keys()
    tckpt.save_pass(str(tmp_path / "t"), 0, tp, to, meta={"global_step": 1})
    for name in ("params.npz", "opt_state.npz"):
        with np.load(tmp_path / "j" / "pass-00000" / name) as a, \
                np.load(tmp_path / "t" / "pass-00000" / name) as b:
            assert sorted(a.files) == sorted(b.files)
            assert all(np.array_equal(a[k], b[k]) and a[k].dtype == b[k].dtype
                       for k in a.files)
