"""Server main.

    python -m jubatus_tpu_torch.server nearest_neighbor \\
        -f config/nearest_neighbor/lsh.json -p 9199 [--device cpu]
    python -m jubatus_tpu_torch.server <engine> -f config/<engine>/<name>.json
        (any of the eleven engines: anomaly, bandit, burst, classifier,
        clustering, graph, nearest_neighbor, recommender, regression, stat,
        weight)
    python -m jubatus_tpu_torch.server nearest_neighbor --config-test -f conf.json

SIGTERM and SIGINT stop the server: it stops accepting, shuts its open
connections down and exits at once, through ``os._exit`` after flushing
stdout and stderr. The interpreter's own teardown (freeing the modules of
torch, the libraries' exit handlers) is skipped: the server holds nothing
that needs it, and under a loaded CPU that teardown alone can take seconds.
A fatal signal (SIGABRT, SIGSEGV) prints every thread's stack to stderr.
"""

from __future__ import annotations

import faulthandler
import os
import signal
import sys

from jubatus_tpu_torch.server.args import parse_server_args
from jubatus_tpu_torch.server.base import EngineServer


def main(argv=None) -> int:
    args = parse_server_args(argv)
    try:
        server = EngineServer.from_args(args)
    except Exception as e:  # broad-ok — report any config/device error and exit
        print(f"config error: {e}", file=sys.stderr)
        return 1
    if args.config_test:
        print("config ok")
        return 0
    signal.signal(signal.SIGTERM, lambda *_: server.stop())
    signal.signal(signal.SIGINT, lambda *_: server.stop())
    port = server.start()
    print(f"jubatus_tpu_torch {args.engine} serving on port {port} "
          f"({server.driver.device})", flush=True)
    server.join()
    return 0


if __name__ == "__main__":
    faulthandler.enable()
    code = main()
    sys.stdout.flush()
    sys.stderr.flush()
    os._exit(code)
