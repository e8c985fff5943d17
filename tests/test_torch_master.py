"""The port's networked elastic master and its client, against the JAX
package's.

- `paddle_tpu_torch.data.master_serve` as a subprocess, with the port's
  `MasterClient` against it;
- the port's client against the JAX package's server, and the JAX
  client against the port's server (the frames are one protocol);
- `reader.elastic` over the network, two readers splitting a pass with
  every record read once;
- a master SIGKILLed mid-pass and restarted from its snapshot
  (`python -m paddle_tpu_torch master`), every chunk read exactly once;
- the retry, jitter, black-hole and protocol-error cases of
  `tests/test_elastic_faults.py::TestMasterClientRetries`, through the
  port's own `FlakyProxy`.

Every subprocess (`chip_smoke.SmokeProc`) is waited on with its own
timeout; a hung one is killed and the test fails with its stderr.
"""

import json
import pickle
import signal
import socket
import struct
import sys
import threading
import time

import pytest

from chip_smoke import SmokeProc as Proc

from paddle_tpu.data.master_client import MasterClient as JClient
from paddle_tpu_torch.data import reader as TR
from paddle_tpu_torch.data.master_client import (
    MasterClient,
    MasterProtocolError,
    MasterRetryTimeout,
)
from paddle_tpu_torch.native.recordio import RecordWriter, count_chunks
from paddle_tpu_torch.testing_faults import FlakyProxy

PROC_TIMEOUT = 120


def start_server(pkg="paddle_tpu_torch", lease=30.0, snapshot=None,
                 port=0):
    cmd = [sys.executable, "-m", f"{pkg}.data.master_serve",
           "--port", str(port), "--lease-seconds", str(lease)]
    if snapshot:
        cmd += ["--snapshot", snapshot, "--snapshot-every", "0.2"]
    proc = Proc(cmd)
    return proc, int(proc.wait_line("LISTENING", PROC_TIMEOUT).split()[1])


def stop(proc, port):
    MasterClient(f"127.0.0.1:{port}", retry_seconds=1).shutdown()
    assert proc.join(PROC_TIMEOUT) == 0


def test_port_server_and_client():
    proc, port = start_server()
    try:
        c = MasterClient(f"127.0.0.1:{port}")
        assert c.ping()
        for i in range(4):
            assert c.add_task(f"t{i}".encode()) >= 0
        seen = set()
        while (t := c.get_task()) is not None:
            seen.add(t[1])
            assert c.task_done(t[0])
        assert seen == {f"t{i}".encode() for i in range(4)}
        assert c.pass_finished()
        assert c.counts == {"todo": 0, "pending": 0, "done": 4,
                            "discarded": 0}
        assert c.start_pass() == 4
    finally:
        stop(proc, port)


@pytest.mark.parametrize("server,client", [
    ("paddle_tpu", MasterClient), ("paddle_tpu_torch", JClient)],
    ids=["port_client_jax_server", "jax_client_port_server"])
def test_clients_and_servers_cross_packages(tmp_path, server, client):
    snap = str(tmp_path / "m.snap")
    proc, port = start_server(server, snapshot=snap)
    try:
        c = client(f"127.0.0.1:{port}")
        for i in range(5):
            c.add_task(json.dumps({"chunk": i}).encode())
        t = c.get_task()
        assert json.loads(t[1]) == {"chunk": 0}
        assert c.task_done(t[0]) and not c.task_done(t[0])
        t = c.get_task()
        assert c.task_failed(t[0])
        c.set_lease(60.0)
        assert c.request_save_model("trainer-0", 5.0)
        assert not c.request_save_model("trainer-1", 5.0)
        c.snapshot()
        assert c.counts == {"todo": 4, "pending": 0, "done": 1,
                            "discarded": 0}
        assert not c.pass_finished()
    finally:
        stop(proc, port)
    # the server's snapshot restores in the other package
    from paddle_tpu.native.master import Master as JMaster
    from paddle_tpu_torch.native.master import Master as TMaster

    other = JMaster if server == "paddle_tpu_torch" else TMaster
    assert other.restore(snap).counts["done"] == 1


def _write_chunks(path, n, chunk_bytes=256):
    with RecordWriter(path, max_chunk_bytes=chunk_bytes) as w:
        for i in range(n):
            w.write(pickle.dumps({"i": i}))
    return count_chunks(path)


def test_two_elastic_readers_split_a_pass_over_the_network(tmp_path):
    path = str(tmp_path / "data.rec")
    n_chunks = _write_chunks(path, 200)
    assert n_chunks >= 8
    proc, port = start_server()
    addr = f"127.0.0.1:{port}"
    try:
        MasterClient(addr).add_chunk_tasks(path, n_chunks)
        got = {0: [], 1: []}
        errors = []

        def run(k):
            try:
                for r in TR.elastic(MasterClient(addr))():
                    got[k].append(r["i"])
                    time.sleep(0.001)
            except Exception as e:  # pragma: no cover - reported below
                errors.append(e)

        threads = [threading.Thread(target=run, args=(k,)) for k in got]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=PROC_TIMEOUT)
        assert not errors and not any(t.is_alive() for t in threads)
        assert got[0] and got[1]  # both readers took chunks
        assert sorted(got[0] + got[1]) == list(range(200))
        assert MasterClient(addr).pass_finished()
    finally:
        stop(proc, port)


def test_elastic_reader_reads_jax_written_chunks(tmp_path):
    """The port's elastic reader over the port's in-process master, on
    chunks the JAX package wrote (and its recordio reader)."""
    from paddle_tpu.native.recordio import RecordWriter as JWriter
    from paddle_tpu_torch.native.master import Master

    path = str(tmp_path / "j.rec")
    with JWriter(path, max_chunk_bytes=64) as w:
        for s in range(40):
            w.write(pickle.dumps(s))
    m = Master()
    m.add_chunk_tasks(path, count_chunks(path))
    assert sorted(TR.elastic(m)()) == list(range(40))
    assert m.pass_finished()
    assert list(TR.recordio(path)()) == list(range(40))


class SnapshottingClient(MasterClient):
    """Snapshots the master after every ack (a deterministic snapshot
    point) and logs the acked chunks; `on_done(n)` runs after the n-th
    ack."""

    def __init__(self, addr, on_done, **kw):
        super().__init__(addr, **kw)
        self.acked = []
        self._leases = {}
        self._on_done = on_done

    def get_task(self):
        t = super().get_task()
        if t is not None:
            self._leases[t[0]] = json.loads(t[1])["chunk"]
        return t

    def task_done(self, task_id):
        ok = super().task_done(task_id)
        assert ok, task_id
        self.acked.append(self._leases[task_id])
        self.snapshot()
        self._on_done(len(self.acked))
        return ok


def test_cli_master_sigkilled_mid_pass_restarts_from_its_snapshot(tmp_path):
    path = str(tmp_path / "data.rec")
    n_chunks = _write_chunks(path, 120)
    snap = str(tmp_path / "master.snap")
    cmd = [sys.executable, "-m", "paddle_tpu_torch", "master", path,
           "--timeout", "60", "--snapshot", snap]
    procs = [Proc(cmd)]
    first = procs[0].wait_line("elastic master over")
    assert f"1 files / {n_chunks} chunk tasks" in first
    port = int(procs[0].wait_line("LISTENING").split()[1])

    def on_done(n):
        if n == n_chunks // 2:
            procs[-1].p.send_signal(signal.SIGKILL)
            procs[-1].join()
            procs.append(Proc(cmd + ["--port", str(port)]))
            assert "restored from" in procs[-1].wait_line("elastic master")
            procs[-1].wait_line("LISTENING")

    try:
        client = SnapshottingClient(f"127.0.0.1:{port}", on_done,
                                    retry_seconds=60)
        got = [r["i"] for r in TR.elastic(client)()]
        assert len(procs) == 2
        assert sorted(client.acked) == list(range(n_chunks))
        assert sorted(got) == list(range(120))
        assert client.pass_finished()
        # SIGTERM: a final snapshot, exit 0
        procs[-1].p.send_signal(signal.SIGTERM)
        assert procs[-1].join() == 0
    finally:
        for p in procs:
            p.stop()
    from paddle_tpu_torch.native.master import Master

    assert Master.restore(snap).counts["done"] == n_chunks


# ---- the client's retries (TestMasterClientRetries, on the port) ---------

def test_retries_through_connection_resets():
    proc, port = start_server()
    try:
        with FlakyProxy(("127.0.0.1", port)) as proxy:
            c = MasterClient(f"127.0.0.1:{proxy.port}", retry_seconds=20)
            proxy.reset_next(2)
            t0 = time.monotonic()
            c.add_task(b"payload-0")
            assert time.monotonic() - t0 < 10
            assert c.get_task() is not None
    finally:
        stop(proc, port)


def test_timeout_raises_clear_exception():
    with FlakyProxy(("127.0.0.1", 1)) as proxy:
        proxy.refuse_all()
        c = MasterClient(f"127.0.0.1:{proxy.port}", retry_seconds=1.2)
        t0 = time.monotonic()
        with pytest.raises(MasterRetryTimeout) as ei:
            c.add_task(b"x")
        elapsed = time.monotonic() - t0
        msg = str(ei.value)
        assert "unreachable" in msg and "attempts" in msg
        assert 1.0 <= elapsed < 8
        assert isinstance(ei.value, ConnectionError)


def test_session_survives_midsession_cut_and_delay():
    proc, port = start_server()
    try:
        with FlakyProxy(("127.0.0.1", port)) as proxy:
            c = MasterClient(f"127.0.0.1:{proxy.port}", retry_seconds=20)
            for i in range(6):
                c.add_task(f"task-{i}".encode())
            t1 = c.get_task()
            t2 = c.get_task()
            proxy.cut_existing()
            assert c.task_done(t1[0])
            proxy.reset_next(1)
            c.close()
            c.task_done(t2[0])
            proxy.delay(0.2)
            done = {t1[1], t2[1]}
            while (t := c.get_task()) is not None:
                assert c.task_done(t[0])
                done.add(t[1])
            proxy.heal()
            assert done == {f"task-{i}".encode() for i in range(6)}
            assert c.pass_finished()
            counts = c.counts
            assert counts["done"] >= 6 and counts["pending"] == 0
    finally:
        stop(proc, port)


def test_black_hole_master_trips_retry_deadline():
    with FlakyProxy(("127.0.0.1", 1)) as proxy:
        proxy.black_hole()
        c = MasterClient(f"127.0.0.1:{proxy.port}", retry_seconds=1.5,
                         connect_timeout=0.5)
        t0 = time.monotonic()
        with pytest.raises(MasterRetryTimeout):
            c.add_task(b"x")
        assert 1.0 <= time.monotonic() - t0 < 8


def test_jitter_spreads_the_backoff(monkeypatch):
    """Full jitter: each delay is drawn from U(0, min(cap, base * 2^k))
    and counted in the port's registry."""
    from paddle_tpu_torch.data import master_client as mc
    from paddle_tpu_torch.obs import metrics

    draws = []
    real = mc.random.uniform
    monkeypatch.setattr(mc.random, "uniform",
                        lambda a, b: draws.append((a, b)) or real(a, b))
    before = metrics.get_registry().counter(
        "master_client.retries").snapshot()
    with FlakyProxy(("127.0.0.1", 1)) as proxy:
        proxy.refuse_all()
        c = MasterClient(f"127.0.0.1:{proxy.port}", retry_seconds=1.0)
        with pytest.raises(MasterRetryTimeout):
            c.ping() or c.add_task(b"x")
    assert len(draws) >= 3
    for k, (lo, hi) in enumerate(draws):
        assert lo == 0 and hi == min(mc._BACKOFF_CAP,
                                     mc._BACKOFF_BASE * 2 ** k)
    after = metrics.get_registry().counter("master_client.retries").snapshot()
    assert after != before


def test_protocol_error_fails_fast():
    srv = socket.socket()
    srv.bind(("127.0.0.1", 0))
    srv.listen(1)
    port = srv.getsockname()[1]

    def garbage_server():
        conn, _ = srv.accept()
        conn.recv(65536)
        conn.sendall(struct.pack("<I", 4) + b"junk")
        conn.close()

    t = threading.Thread(target=garbage_server, daemon=True)
    t.start()
    try:
        c = MasterClient(f"127.0.0.1:{port}", retry_seconds=30)
        t0 = time.monotonic()
        with pytest.raises(MasterProtocolError, match="malformed"):
            c.add_task(b"x")
        assert time.monotonic() - t0 < 2
    finally:
        srv.close()
