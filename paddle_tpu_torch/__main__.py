"""Command line of the port: `python -m paddle_tpu_torch serve ...`.

    python -m paddle_tpu_torch serve --config conf.py [--port N]
                                     [--drain_timeout S]

The config file defines `get_server() -> serving.server.InferenceServer`
with its models registered (and optionally `load_model(name, tag)` for
the `{"admin": "swap_model"}` frame). The command owns the TCP front
end and the drain-on-shutdown lifecycle: it prints `LISTENING <port>`,
and on SIGTERM/SIGINT stops admission, finishes or cleanly rejects
in-flight work, prints `DRAINED {stats}` and exits 0.
"""

from __future__ import annotations

import argparse
import importlib.util
import json
import signal
import sys
import time


def cmd_serve(args) -> int:
    from paddle_tpu_torch.serving.tcp import ServingTCPServer

    spec = importlib.util.spec_from_file_location("_serve_config",
                                                  args.config)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    if not hasattr(mod, "get_server"):
        raise SystemExit(
            f"{args.config} must define get_server() -> InferenceServer"
        )
    server = mod.get_server()
    tcp = ServingTCPServer(server, port=args.port,
                           model_loader=getattr(mod, "load_model", None))
    print(f"LISTENING {tcp.port}", flush=True)

    stopping = []
    signal.signal(signal.SIGTERM, lambda *_: stopping.append(1))
    signal.signal(signal.SIGINT, lambda *_: stopping.append(1))
    try:
        while not stopping:
            time.sleep(0.1)
    finally:
        # stop NEW connections first, drain with established clients
        # still attached (their in-flight responses must land), then
        # close what remains
        tcp.stop_accepting()
        server.shutdown(drain=True, timeout=args.drain_timeout)
        tcp.stop(drain=True)
        print("DRAINED " + json.dumps(server.stats()), flush=True)
    return 0


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(prog="python -m paddle_tpu_torch")
    sub = parser.add_subparsers(dest="cmd", required=True)
    p = sub.add_parser("serve", help="run the inference server over TCP")
    p.add_argument("--config", required=True,
                   help="python file defining get_server()")
    p.add_argument("--port", type=int, default=0,
                   help="TCP port (0 = any free port)")
    p.add_argument("--drain_timeout", type=float, default=30.0,
                   help="seconds to finish in-flight work on shutdown")
    args = parser.parse_args(argv)
    return cmd_serve(args)


if __name__ == "__main__":
    sys.exit(main())
