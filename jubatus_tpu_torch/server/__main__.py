"""Server main.

    python -m jubatus_tpu_torch.server nearest_neighbor \\
        -f config/nearest_neighbor/lsh.json -p 9199 [--device cpu]
    python -m jubatus_tpu_torch.server <engine> -f config/<engine>/<name>.json
        (any of the eleven engines: anomaly, bandit, burst, classifier,
        clustering, graph, nearest_neighbor, recommender, regression, stat,
        weight)
    python -m jubatus_tpu_torch.server nearest_neighbor --config-test -f conf.json
    python -m jubatus_tpu_torch.server classifier -f conf.json -z file://dir \
        -n c1 -x collective_mixer --jax-processes 2 --jax-process-id 0 \
        --jax-coordinator 127.0.0.1:8476     # one rank of a collective fleet

With ``--jax-processes N > 1`` the server first joins the process world of
the collective mixer (parallel/multihost.py) — the rendezvous at
``--jax-coordinator``, or the address process 0 published in the
coordinator — and only then builds its model. ``--config-test`` never
joins it.

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
    coord = None
    if args.jax_processes > 1 and not args.config_test:
        # the coordinator session stays open and goes to the server:
        # process 0's published endpoint is an ephemeral owned by it
        from jubatus_tpu_torch.coord import create_coordinator
        from jubatus_tpu_torch.framework.collective_mixer import \
            collective_timeout
        from jubatus_tpu_torch.parallel import multihost

        try:
            coord = (create_coordinator(args.coordinator)
                     if not args.is_standalone else None)
            multihost.initialize(
                coordinator_address=args.jax_coordinator or None,
                num_processes=args.jax_processes,
                process_id=args.jax_process_id,
                coord=coord, device=args.device,
                timeout=collective_timeout(args.interconnect_timeout))
        except Exception as e:  # broad-ok — report and exit
            print(f"process world error: {e}", file=sys.stderr)
            return 1
    try:
        server = EngineServer.from_args(args, coord=coord)
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
