"""ctypes wrapper for the elastic task-queue master —
`paddle_tpu/native/master.py` for the port, over the port's own build of
`src/master.cc` and `src/master_server.cc` (copies of the JAX package's:
snapshots restore across the packages and the TCP frames are the same).

Fault-tolerant input dispatch (go/master/service.go capability): chunk
tasks leased to workers, timeout requeue, failure cap, pass rotation,
snapshot/restore. Typical use: the coordinator host owns a Master over
(file, chunk) tasks; trainer processes lease tasks, read those chunks via
RecordReader(start_chunk=..., step_chunk=...), and report done/failed.
"""

from __future__ import annotations

import ctypes
import json
from typing import Optional

from paddle_tpu_torch.native import load

_CAP = 1 << 20


class Master:
    def __init__(
        self,
        lease_seconds: float = 60.0,
        failure_max: int = 3,
        _handle=None,
    ):
        self._lib = load()
        self._h = (
            _handle
            if _handle is not None
            else self._lib.pt_master_create(lease_seconds, failure_max)
        )

    # ---- task lifecycle ----
    def add_task(self, payload: bytes) -> int:
        if isinstance(payload, str):
            payload = payload.encode()
        return self._lib.pt_master_add_task(self._h, payload, len(payload))

    def add_chunk_tasks(self, path: str, num_chunks: int) -> None:
        """One task per chunk of a record file (the Go master's dataset
        partitioning, service.go:280)."""
        for i in range(num_chunks):
            self.add_task(json.dumps({"path": path, "chunk": i}).encode())

    def get_task(self) -> Optional[tuple]:
        """Lease a task: (task_id, payload), or None when nothing is
        leasable right now (empty payloads are valid tasks)."""
        cap = _CAP
        while True:
            buf = ctypes.create_string_buffer(cap)
            tid = ctypes.c_int64(0)
            n = self._lib.pt_master_get_task(
                self._h, buf, cap, ctypes.byref(tid)
            )
            if n == -3:
                return None
            if n == -1:  # buffer too small; tid holds the required size
                cap = tid.value
                continue
            if n < 0:
                raise RuntimeError(f"get_task failed (code {n})")
            return tid.value, buf.raw[:n]

    def task_done(self, task_id: int) -> bool:
        """False if the lease had already expired (task was requeued)."""
        return self._lib.pt_master_task_done(self._h, task_id) == 0

    def task_failed(self, task_id: int) -> bool:
        return self._lib.pt_master_task_failed(self._h, task_id) == 0

    # ---- pass control ----
    def pass_finished(self) -> bool:
        return self._lib.pt_master_pass_finished(self._h) == 1

    def start_pass(self) -> int:
        """Rotate done tasks back into todo; returns todo count."""
        return self._lib.pt_master_start_pass(self._h)

    # ---- introspection ----
    @property
    def counts(self) -> dict:
        c = self._lib.pt_master_count
        return {
            "todo": c(self._h, 0),
            "pending": c(self._h, 1),
            "done": c(self._h, 2),
            "discarded": c(self._h, 3),
        }

    def set_lease(self, seconds: float) -> None:
        self._lib.pt_master_set_lease(self._h, seconds)

    def request_save_model(
        self, trainer_id: str, block_seconds: float = 60.0
    ) -> bool:
        """Save-model election (go/master/service.go:467-495): True iff
        this trainer should save; the grant blocks other trainers for
        `block_seconds`."""
        r = self._lib.pt_master_request_save(
            self._h, trainer_id.encode(), block_seconds
        )
        if r < 0:
            raise ValueError("trainer_id must be non-empty")
        return r == 1

    # ---- serving (networked master; see data/master_client.py) ----
    def serve(
        self,
        port: int = 0,
        snapshot_path: Optional[str] = None,
        snapshot_every: float = 0.0,
    ) -> "MasterServer":
        """Expose this master over TCP (master_server.cc) so trainer
        processes on other hosts can lease tasks — the Go master's RPC
        service (go/master/service.go:89). Returns the running server."""
        h = self._lib.pt_master_server_start(
            self._h,
            port,
            snapshot_path.encode() if snapshot_path else None,
            snapshot_every,
        )
        if not h:
            raise OSError(f"cannot serve master on port {port}")
        return MasterServer(self._lib, h, self)

    # ---- durability ----
    def snapshot(self, path: str) -> None:
        if self._lib.pt_master_snapshot(self._h, path.encode()) != 0:
            raise IOError(f"snapshot to {path} failed")

    @classmethod
    def restore(cls, path: str) -> "Master":
        h = load().pt_master_restore(path.encode())
        if not h:
            raise IOError(f"cannot restore master from {path}")
        return cls(_handle=h)

    def __del__(self):
        h = getattr(self, "_h", None)
        if h:
            self._lib.pt_master_destroy(h)
            self._h = None


class MasterServer:
    """Handle for a running networked master (pt_master_server_*)."""

    def __init__(self, lib, handle, master: "Master"):
        self._lib = lib
        self._h = handle
        self.master = master  # keep the Master alive while serving

    @property
    def port(self) -> int:
        return self._lib.pt_master_server_port(self._h)

    @property
    def stopped(self) -> bool:
        """True once a client sent SHUTDOWN."""
        return self._lib.pt_master_server_stopped(self._h) == 1

    def stop(self) -> None:
        if self._h:
            self._lib.pt_master_server_stop(self._h)
            self._h = None
