"""Server command-line flags (lean counterpart of ``jubatus_tpu/server/args.py``).

The reference's flag names for what a standalone server uses, plus
``--device``. No coordinator, mixer, mesh or observability flags yet.
"""

from __future__ import annotations

import argparse
import dataclasses
from typing import Any, Dict, List, Optional


@dataclasses.dataclass
class ServerArgs:
    engine: str = ""
    rpc_port: int = 9199                # -p
    listen_addr: str = ""               # -b
    thread: int = 2                     # -c (RPC worker threads)
    configpath: str = ""                # -f
    name: str = ""                      # -n cluster name
    config_test: bool = False
    #: "cuda" (default) or "cpu"; never falls back on its own
    device: str = "cuda"
    #: most examples one coalesced train flush takes; 0 = the direct
    #: per-RPC path (server/microbatch.py)
    microbatch_max: int = 8192

    def flags_status(self) -> Dict[str, Any]:
        """Flag dump for get_status."""
        return {f"argv.{f.name}": getattr(self, f.name)
                for f in dataclasses.fields(self)}


def build_parser(prog: str = "jubatus_tpu_torch.server") -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog=prog, description="jubatus_tpu_torch engine server")
    p.add_argument("engine", help="engine type (anomaly, bandit, burst, "
                                  "classifier, clustering, graph, "
                                  "nearest_neighbor, recommender, "
                                  "regression, stat, weight)")
    p.add_argument("-p", "--rpc-port", type=int, default=9199)
    p.add_argument("-b", "--listen-addr", default="")
    p.add_argument("-c", "--thread", type=int, default=2)
    p.add_argument("-f", "--configpath", default="")
    p.add_argument("-n", "--name", default="")
    p.add_argument("--config-test", action="store_true")
    p.add_argument("--device", default="cuda", choices=("cuda", "cpu"),
                   help="device the model runs on; cuda unless cpu is asked "
                        "for (no fallback)")
    p.add_argument("--microbatch-max", type=int, default=8192,
                   help="most examples one coalesced train flush takes "
                        "(classifier, regression); 0 trains per RPC")
    return p


def parse_server_args(argv: Optional[List[str]] = None) -> ServerArgs:
    ns = build_parser().parse_args(argv)
    args = ServerArgs(**{f.name: getattr(ns, f.name)
                         for f in dataclasses.fields(ServerArgs)})
    if args.thread < 1:
        raise SystemExit("--thread must be >= 1")
    if args.rpc_port < 0 or args.rpc_port > 65535:
        raise SystemExit("--rpc-port out of range")
    if args.microbatch_max < 0:
        raise SystemExit("--microbatch-max must be >= 0")
    if not args.configpath:
        raise SystemExit("-f/--configpath is required")
    return args
