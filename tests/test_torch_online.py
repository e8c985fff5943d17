"""The port's online-learning loop (`paddle_tpu_torch/trainer/online.py`,
the CTR worker and the ctr replicas of `testing_faults.py`) against the
JAX package, on the CPU.

- `make_batch`, `hot_id_set`, `true_weight` bit-equal to JAX's.
- `OnlineCTRTrainer.train_step` losses within 1e-6 of the JAX trainer's
  over the same table config (the port's 8 logical shards, the JAX
  8-device CPU mesh), and the exported payloads equal.
- Table generations written by either package read by the other.
- The elastic worker (`DEVICE=cpu`): SIGKILLed mid-epoch and respawned,
  its ledger holds every batch exactly once, and the acknowledged
  losses equal an uninterrupted run's.
- The online-loop contract: traffic scored by two ctr replicas through
  the router, a `rollout()` every 10 batches onto the newest committed
  generation, zero requests lost and the served logloss improving.
"""

import os
import time

import jax.numpy as jnp
import numpy as np
import pytest

from paddle_tpu.core.mesh import MODEL_AXIS, make_mesh
from paddle_tpu.parallel import sparse_shard as jss
from paddle_tpu.trainer import async_checkpoint as jac
from paddle_tpu.trainer import online as jon
from paddle_tpu_torch import testing_faults as tf
from paddle_tpu_torch.parallel import sparse_shard as tss
from paddle_tpu_torch.serving.fleet import FleetConfig, FleetRouter
from paddle_tpu_torch.trainer import async_checkpoint as tac
from paddle_tpu_torch.trainer import online as ton

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SEED = 11
pytestmark = pytest.mark.faults


@pytest.mark.parametrize("seed", [0, 7, SEED])
def test_traffic_bit_equal(seed):
    for rows in (1 << 20, 1 << 30):
        th = ton.hot_id_set(seed, 96, rows)
        jh = jon.hot_id_set(seed, 96, rows)
        np.testing.assert_array_equal(th, jh)
        assert th.dtype == jh.dtype
    for b in (0, 5, 31):
        ti, tl = ton.make_batch(seed, b, 16, 4, th)
        ji, jl = jon.make_batch(seed, b, 16, 4, jh)
        np.testing.assert_array_equal(ti, ji)
        np.testing.assert_array_equal(tl, jl)
        tw, jw = ton.true_weight(ti), jon.true_weight(ji)
        assert tw.dtype == jw.dtype and np.array_equal(tw, jw)
    p = np.random.default_rng(seed).random(50)
    y = (p > 0.5).astype(np.float64)
    assert ton.logloss(p, y) == jon.logloss(p, y)


def _cfg(mod, adagrad=False):
    return mod.ShardedTableConfig(rows_total=1 << 30, dim=8, capacity=64,
                                  num_slots=48, placement="range",
                                  seed=SEED)


def _tables(adagrad=False, lr=0.5):
    rule = "adagrad_row_update" if adagrad else "sgd_row_update"
    n_state = 1 if adagrad else 0
    tt = tss.ShardedEmbeddingTable(_cfg(tss), num_shards=8,
                                   update_fn=getattr(tss, rule)(lr),
                                   num_state=n_state, device="cpu")
    jt = jss.ShardedEmbeddingTable(_cfg(jss), mesh=make_mesh(
        {MODEL_AXIS: 8}), update_fn=getattr(jss, rule)(lr),
        num_state=n_state)
    return tt, jt


def _payloads_equal(got, want, atol=0.0):
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert set(g) == set(w)
        for k in g:
            gv, wv = np.asarray(g[k]), np.asarray(w[k])
            if np.issubdtype(wv.dtype, np.floating):
                np.testing.assert_allclose(gv, wv, rtol=0, atol=atol,
                                           err_msg=k)
            else:
                np.testing.assert_array_equal(gv, wv, err_msg=k)


@pytest.mark.parametrize("adagrad", [False, True])
def test_train_step_equal_to_jax(tmp_path, adagrad):
    tt, jt = _tables(adagrad)
    ttr = ton.OnlineCTRTrainer(tt, str(tmp_path / "t"))
    jtr = jon.OnlineCTRTrainer(jt, str(tmp_path / "j"))
    try:
        hot = ton.hot_id_set(SEED, 96, 1 << 30)
        for b in range(12):
            ids, labels = ton.make_batch(SEED, b, 8, 4, hot)
            tl, jl = ttr.train_step(ids, labels), jtr.train_step(ids, labels)
            assert abs(tl - jl) <= 1e-6, (b, tl, jl)
        probe = hot[:10].reshape(5, 2)
        np.testing.assert_allclose(ton.predict_logits(tt, probe),
                                   jon.predict_logits(jt, probe),
                                   rtol=0, atol=1e-6)
        _payloads_equal(tt.export_shards(), jt.export_shards(), atol=1e-6)
        assert tt.table_meta() == jt.table_meta()
        assert ton.weights_from_payloads(tt.export_shards()).keys() == \
            jon.weights_from_payloads(jt.export_shards()).keys()
    finally:
        ttr.close()
        jtr.close()


@pytest.mark.parametrize("writer", ["torch", "jax"])
def test_generations_cross_both_ways(tmp_path, writer):
    """A generation one package writes (through its trainer and async
    checkpointer) verifies, loads and restores in the other."""
    tt, jt = _tables()
    save = str(tmp_path / "gens")
    hot = ton.hot_id_set(SEED, 96, 1 << 30)
    w_table, r_table = (tt, jt) if writer == "torch" else (jt, tt)
    w_mod, r_ac = (ton, jac) if writer == "torch" else (jon, tac)
    trainer = w_mod.OnlineCTRTrainer(w_table, save)
    try:
        for b in range(6):
            trainer.train_step(*ton.make_batch(SEED, b, 8, 4, hot))
            trainer.save_generation(b, b + 1, extra_meta={"loss": 0.5})
        acks = trainer.drain()
        assert [g for g, _ in acks] == list(range(6))
    finally:
        trainer.close()
    ok, why = r_ac.verify_table_generation(save, 5)
    assert ok, why
    gen, payloads, meta = r_ac.load_table_generation(save, -1)
    assert gen == 5 and meta["next_batch"] == 6
    _payloads_equal(payloads, w_table.export_shards())
    r_table.restore_shards(payloads)
    probe = hot[:12].reshape(4, 3)
    np.testing.assert_allclose(
        np.asarray(ton.predict_logits(tt, probe)),
        np.asarray(jon.predict_logits(jt, probe)), rtol=0, atol=0)
    # the resume path of the reading package's trainer
    r_mod = jon if writer == "torch" else ton
    reader = r_mod.OnlineCTRTrainer(r_table, save)
    try:
        g, m, quarantined = reader.resume()
        assert g == 5 and quarantined == [] and m["next_batch"] == 6
    finally:
        reader.close()


def test_torn_generation_skipped_by_both(tmp_path):
    tt, jt = _tables()
    save = str(tmp_path / "gens")
    trainer = ton.OnlineCTRTrainer(tt, save)
    hot = ton.hot_id_set(SEED, 16, 1 << 30)
    tt.lookup(hot.reshape(-1, 1))
    trainer.save_generation(0, 0)
    trainer.train_step(*ton.make_batch(SEED, 0, 16, 4, hot))
    trainer.save_generation(3, 1)
    trainer.drain()
    tf.write_torn_table_generation(save, 5, tt.export_shards(),
                                   fail_after_shard=2, tear="missing")
    trainer.close()
    assert tac.load_table_generation(save, -1)[0] == 3
    assert jac.load_table_generation(save, -1)[0] == 3


WORKER = dict(SHARDS=4, BATCHES=16, BATCH=8, FEATS=4, HOT=96, CAPACITY=64,
              NUM_SLOTS=48, BATCH_SLEEP=0.05, DEVICE="cpu")


def _ledger(out_file):
    recs = tf.read_worker_records(out_file)
    return recs, [r["trained"] for r in recs if "trained" in r]


def _uninterrupted_losses(batches):
    table = tss.ShardedEmbeddingTable(
        tss.ShardedTableConfig(rows_total=1 << 30, dim=8, capacity=64,
                               num_slots=48, seed=7),
        num_shards=4, update_fn=tss.sgd_row_update(0.5), device="cpu")
    hot = ton.hot_id_set(7, 96, 1 << 30)
    tr = ton.OnlineCTRTrainer.__new__(ton.OnlineCTRTrainer)
    tr.table = table
    return [tr.train_step(*ton.make_batch(7, b, 8, 4, hot))
            for b in range(batches)]


def test_elastic_worker_exactly_once_across_sigkill(tmp_path):
    save = str(tmp_path / "ckpt")
    os.makedirs(save)
    out = str(tmp_path / "ledger.jsonl")
    p = tf.start_sharded_ctr_trainer(REPO, save, out, **WORKER)
    try:
        deadline = time.monotonic() + 120
        while len(_ledger(out)[1]) < 3:
            assert p.poll() is None, p.communicate(timeout=30)
            assert time.monotonic() < deadline, "no acks within deadline"
            time.sleep(0.02)
    finally:
        tf.kill_process(p)
    killed_after = len(_ledger(out)[1])
    assert killed_after < WORKER["BATCHES"], "kill landed after the epoch"
    t_kill = time.monotonic()
    p2 = tf.start_sharded_ctr_trainer(REPO, save, out, **WORKER)
    try:
        _out, err = p2.communicate(timeout=180)
    finally:
        tf.kill_process(p2)
    assert p2.returncode == 0, err
    kill_recover_s = time.monotonic() - t_kill
    recs, trained = _ledger(out)
    resume = [r for r in recs if "resume" in r]
    assert resume and resume[-1]["resume"] >= 0
    assert sorted(trained) == list(range(WORKER["BATCHES"]))
    assert len(trained) == len(set(trained))  # nothing retrained
    done = [r for r in recs if r.get("done")]
    assert done and done[-1]["rows_total"] == 1 << 30
    assert done[-1]["device"] == "cpu"
    # the CPU runs B9's plain version: no kernel launch is counted
    assert done[-1]["launches"]["sparse_row_update_launches"] == 0
    assert done[-1]["rows_materialized"] / done[-1]["rows_total"] < 1e-6
    assert kill_recover_s < 120
    want = _uninterrupted_losses(WORKER["BATCHES"])
    for r in recs:
        if "loss" in r and r.get("loss") is not None:
            assert abs(r["loss"] - want[r["trained"]]) <= 1e-6, r


def test_worker_refuses_without_a_card(tmp_path):
    out = str(tmp_path / "ledger.jsonl")
    p = tf.start_sharded_ctr_trainer(REPO, str(tmp_path), out,
                                     **{**WORKER, "DEVICE": "cuda"})
    try:
        stdout, _err = p.communicate(timeout=120)
    finally:
        tf.kill_process(p)
    assert p.returncode == 3
    assert stdout.startswith("BOOT_REFUSED") and "no CUDA device" in stdout
    assert tf.read_worker_records(out) == []


def test_online_loop_improves_with_zero_lost(tmp_path):
    """40 traffic batches scored by the fleet before being learned
    from; a rollout() every 10 batches deploys the newest committed
    generation. Served logloss over the last 10 batches beats the
    first 10, every request is answered, and the replicas end on the
    last generation."""
    save = str(tmp_path / "gens")
    os.makedirs(save)
    table = tss.ShardedEmbeddingTable(
        tss.ShardedTableConfig(rows_total=1 << 30, dim=8, capacity=64,
                               num_slots=48, placement="range", seed=SEED),
        num_shards=8, update_fn=tss.sgd_row_update(1.0), device="cpu")
    trainer = ton.OnlineCTRTrainer(table, save)
    hot = ton.hot_id_set(SEED, 32, 1 << 30)
    table.lookup(hot.reshape(-1, 1))
    trainer.save_generation(0, 0)
    trainer.drain()
    procs, router = [], None
    try:
        replicas = {}
        for i in range(2):
            p, port = tf.start_serving_replica(
                REPO, boot_timeout=120, REPLICA_MODE="ctr",
                MODEL_NAME="ctr", MODEL_TAG="gen0", MODEL_DIR=save,
                DEVICE="cpu")
            procs.append(p)
            assert port, p.boot_line
            replicas[f"r{i}"] = f"127.0.0.1:{port}"
        router = FleetRouter(replicas, FleetConfig(monitor=False))
        served, lost, swaps = [], 0, []
        for b in range(40):
            ids, labels = ton.make_batch(SEED, b, 32, 4, hot)
            ps = []
            for r in range(32):
                resp = router.call("ctr", ids[r].tolist(),
                                   deadline_ms=10_000)
                if not resp.get("ok"):
                    lost += 1
                    ps.append(0.5)
                else:
                    ps.append(float(resp["score"]))
            served.append(ton.logloss(np.array(ps), labels))
            trainer.train_step(ids, labels)
            if b % 10 == 9:
                gen = b // 10 + 1
                trainer.save_generation(gen, b + 1)
                trainer.drain()
                report = router.rollout("ctr", tag=f"gen{gen}")
                swaps.append(report.per_replica)
                assert all(report[n].get("tag") == f"gen{gen}"
                           for n in replicas)
        first, last = np.mean(served[:10]), np.mean(served[-10:])
        assert lost == 0
        assert len(swaps) == 4
        assert first > 0.68
        assert last < first - 0.05, (first, last)
        resp = router.call("ctr", ids[0].tolist(), deadline_ms=10_000)
        assert resp["ok"] and resp["gen"] == 4 and resp["tag"] == "gen4"
        # the served score is the generation's weights, exactly
        w = ton.weights_from_payloads(tac.load_table_generation(save, 4)[1])
        z = sum(w.get(int(f), 0.0) for f in ids[0])
        assert resp["score"] == pytest.approx(1 / (1 + np.exp(-z)), abs=1e-12)
    finally:
        if router is not None:
            router.close()
        for p in procs:
            tf.kill_process(p)
        trainer.close()


def test_jax_trainer_generation_served_by_the_port(tmp_path):
    """A ctr replica of the port boots from a generation the JAX
    trainer wrote and scores with its weights."""
    save = str(tmp_path / "gens")
    os.makedirs(save)
    _tt, jt = _tables(lr=1.0)
    trainer = jon.OnlineCTRTrainer(jt, save)
    hot = jon.hot_id_set(SEED, 16, 1 << 30)
    for b in range(3):
        trainer.train_step(*jon.make_batch(SEED, b, 16, 4, hot))
    trainer.save_generation(2, 3)
    trainer.drain()
    trainer.close()
    p, port = tf.start_serving_replica(
        REPO, boot_timeout=120, REPLICA_MODE="ctr", MODEL_NAME="ctr",
        MODEL_DIR=save, DEVICE="cpu")
    try:
        assert port, p.boot_line
        from paddle_tpu_torch.serving.tcp import ServeClient

        with ServeClient(f"127.0.0.1:{port}") as c:
            resp = c.call("ctr", hot[:4].tolist(), deadline_ms=10_000)
        w = jon.weights_from_payloads(jt.export_shards())
        z = sum(w.get(int(f), 0.0) for f in hot[:4])
        assert resp["ok"] and resp["gen"] == 2
        assert resp["score"] == pytest.approx(1 / (1 + np.exp(-z)), abs=1e-12)
        assert jnp.isfinite(z)
    finally:
        tf.kill_process(p)
