"""A world of ranks in spawned processes, driven case by case.

`World(n, workdir)` spawns n processes (the spawn context), each of
which joins a torch.distributed world through a `FileStore` under
`workdir` (no TCP port to race for) and then waits for cases. `run(fn,
*args)` sends one case to every rank: each calls `fn(*args)` (a
module-level function, pickled by reference) and the results come back
in rank order. A rank that raises fails the case with its traceback; a
case that does not end within its timeout kills the world and fails
with the tail of every rank's stderr. Either way the world is closed,
and the next `run` spawns a new one. A world serves many cases, so the
ranks pay the import and the rendezvous once.

`device="cpu"` runs gloo ranks on the CPU (the tests); "cuda" puts the
ranks on the card (`core/mesh.py::distributed_init`: gloo when they
share it).
"""

from __future__ import annotations

import os
import queue
import time
import traceback


class RankFailed(RuntimeError):
    """A case failed or hung on a rank of a `World`."""


def _rank_main(rank, n, store_path, device, inq, outq, err_path):
    fd = os.open(err_path, os.O_WRONLY | os.O_CREAT | os.O_TRUNC, 0o644)
    os.dup2(fd, 2)
    import torch
    import torch.distributed as dist

    torch.set_num_threads(1)
    from paddle_tpu_torch.core import mesh as _mesh

    _mesh.distributed_init(num_processes=n, process_id=rank,
                           store=dist.FileStore(store_path, n),
                           device=device, local_rank=rank)
    while True:
        task = inq.get()
        if task is None:
            break
        fn, args = task
        _mesh.set_mesh(None)
        try:
            outq.put((rank, True, fn(*args)))
        except BaseException:  # reported to the parent, which fails the case
            outq.put((rank, False, traceback.format_exc()))
    dist.destroy_process_group()


class World:
    """n spawned ranks joined in one torch.distributed world."""

    def __init__(self, n: int, workdir: str, device: str = "cpu",
                 timeout: float = 120.0):
        self.n, self.workdir, self.device = n, workdir, device
        self.timeout = timeout
        self.procs = []
        self._gen = 0

    def _spawn(self):
        import multiprocessing as mp

        ctx = mp.get_context("spawn")
        self._gen += 1
        d = os.path.join(self.workdir, f"world{self._gen}")
        os.makedirs(d, exist_ok=True)
        self.errs = [os.path.join(d, f"rank{r}.err") for r in range(self.n)]
        self.inq = [ctx.Queue() for _ in range(self.n)]
        self.outq = ctx.Queue()
        old = os.environ.get("OMP_NUM_THREADS")
        os.environ["OMP_NUM_THREADS"] = "1"
        try:
            self.procs = [ctx.Process(
                target=_rank_main, daemon=True,
                args=(r, self.n, os.path.join(d, "store"), self.device,
                      self.inq[r], self.outq, self.errs[r]))
                for r in range(self.n)]
            for p in self.procs:
                p.start()
        finally:
            if old is None:
                os.environ.pop("OMP_NUM_THREADS", None)
            else:
                os.environ["OMP_NUM_THREADS"] = old

    def _stderr(self) -> str:
        out = []
        for r, path in enumerate(self.errs):
            try:
                with open(path) as f:
                    tail = f.read()[-3000:]
            except OSError:
                tail = ""
            out.append(f"--- rank {r} stderr ---\n{tail}")
        return "\n".join(out)

    def run(self, fn, *args, timeout=None) -> list:
        """fn(*args) on every rank; the results in rank order."""
        if not self.procs:
            self._spawn()
        for q in self.inq:
            q.put((fn, args))
        got = {}
        deadline = time.monotonic() + (timeout or self.timeout)
        while len(got) < self.n:
            left = deadline - time.monotonic()
            try:
                rank, ok, val = self.outq.get(timeout=max(left, 0.01))
            except queue.Empty:
                dead = [r for r, p in enumerate(self.procs)
                        if not p.is_alive()]
                self.close(kill=True)
                raise RankFailed(
                    f"{getattr(fn, '__name__', fn)} did not end on ranks "
                    f"{sorted(set(range(self.n)) - set(got))} within "
                    f"{timeout or self.timeout} s (exited: {dead})\n"
                    f"{self._stderr()}") from None
            if not ok:
                self.close(kill=True)
                raise RankFailed(
                    f"{getattr(fn, '__name__', fn)} failed on rank {rank}:\n"
                    f"{val}\n{self._stderr()}")
            got[rank] = val
        return [got[r] for r in range(self.n)]

    def close(self, kill: bool = False) -> None:
        """Stop every rank (kill: at once) and wait for them."""
        for p, q in zip(self.procs, getattr(self, "inq", [])):
            if kill:
                p.kill()
            elif p.is_alive():
                q.put(None)
        for p in self.procs:
            p.join(timeout=30)
            if p.is_alive():
                p.kill()
                p.join(timeout=10)
        self.procs = []

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close(kill=exc[0] is not None)
