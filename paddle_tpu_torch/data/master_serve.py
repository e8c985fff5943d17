"""Standalone networked-master process: `python -m
paddle_tpu_torch.data.master_serve --port 8090 --snapshot /path/m.snap`
— `paddle_tpu/data/master_serve.py` for the port, over the port's own
build of the native master.

The counterpart of the reference's master daemon
(go/cmd/master/master.go:36): owns the task queues, serves trainers over
TCP (native/src/master_server.cc), snapshots periodically and on
shutdown, and restores from its snapshot on restart so a master crash
does not lose the pass (go/master/service.go:166-207).

Prints `LISTENING <port>` on stdout once ready (ephemeral ports:
--port 0). Stops on SIGTERM/SIGINT or a client SHUTDOWN op.
"""

from __future__ import annotations

import argparse
import os
import signal
import sys
import time


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--port", type=int, default=0)
    ap.add_argument("--lease-seconds", type=float, default=60.0)
    ap.add_argument("--failure-max", type=int, default=3)
    ap.add_argument("--snapshot", default=None,
                    help="snapshot file; restored on start if it exists")
    ap.add_argument("--snapshot-every", type=float, default=10.0)
    args = ap.parse_args(argv)

    from paddle_tpu_torch.native.master import Master

    if args.snapshot and os.path.exists(args.snapshot):
        master = Master.restore(args.snapshot)
        master.set_lease(args.lease_seconds)
        print(f"restored from {args.snapshot}: {master.counts}",
              file=sys.stderr, flush=True)
    else:
        master = Master(args.lease_seconds, args.failure_max)

    return serve_until_stopped(master, args.port, args.snapshot,
                               args.snapshot_every)


def serve_until_stopped(master, port: int, snapshot=None,
                        snapshot_every: float = 10.0) -> int:
    """Serve `master` over TCP on `port` until SIGTERM/SIGINT or a
    client's SHUTDOWN: prints `LISTENING <port>`, snapshots to
    `snapshot` (when given) every `snapshot_every` seconds and on the
    way out. The one serve loop of both this module's `main` and the
    CLI's `master` command."""
    server = master.serve(
        port=port,
        snapshot_path=snapshot or None,
        snapshot_every=snapshot_every if snapshot else 0.0,
    )
    print(f"LISTENING {server.port}", flush=True)

    stopping = []
    signal.signal(signal.SIGTERM, lambda *_: stopping.append(1))
    signal.signal(signal.SIGINT, lambda *_: stopping.append(1))
    while not stopping and not server.stopped:
        time.sleep(0.1)
    server.stop()  # joins service threads; final snapshot if configured
    return 0

if __name__ == "__main__":
    sys.exit(main())
