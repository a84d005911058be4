"""Server command-line flags (lean counterpart of ``jubatus_tpu/server/args.py``).

The reference's flag names and defaults for what the port's server uses:
the standalone flags, save/load (``-d/--datadir``, ``-m/--model-file``),
and the RPC linear mix with its coordinator (``-z/--coordinator``,
``-x/--mixer``, ``-s/--interval-sec``, ``-i/--interval-count``,
``--interconnect-timeout``, ``--coordinator-timeout``, ``--mix-quorum``,
``--mix-guard``, ``--mix-norm-bound``), plus ``--device``. ``--mixer``
takes the JAX package's names, but only ``linear_mixer`` is ported: any
other raises ``NotYetPorted``, as does ``--mix-guard quarantine``, whose
rollback needs the model snapshot ring. No flag is accepted and then
ignored.
"""

from __future__ import annotations

import argparse
import dataclasses
import socket
from typing import Any, Dict, List, Optional

from jubatus_tpu_torch import NotYetPorted

#: the JAX package's --mixer names; the port has the first
MIXERS = ("linear_mixer", "collective_mixer", "random_mixer",
          "broadcast_mixer", "skip_mixer", "dummy_mixer")


@dataclasses.dataclass
class ServerArgs:
    engine: str = ""
    rpc_port: int = 9199                # -p
    listen_addr: str = ""               # -b
    thread: int = 2                     # -c (RPC worker threads)
    datadir: str = "/tmp"               # -d
    configpath: str = ""                # -f
    model_file: str = ""                # -m
    config_test: bool = False
    coordinator: str = ""               # -z; "" = standalone
    name: str = ""                      # -n cluster name
    mixer: str = "linear_mixer"         # -x
    interval_sec: float = 16.0          # -s (server_util.cpp:223-225)
    interval_count: int = 512           # -i (server_util.cpp:226-228)
    #: --zookeeper_timeout: a ZooKeeper session's timeout; the file and
    #: memory coordinators have no session to time out (in both packages)
    coordinator_timeout: float = 10.0
    interconnect_timeout: float = 10.0
    #: minimum fraction of members whose diffs must arrive for a master
    #: round to proceed (framework/linear_mixer.py)
    mix_quorum: float = 0.5
    #: mix admission guard (framework/model_guard.py): off or warn
    mix_guard: str = "warn"
    #: norm-outlier multiplier of the mix guard
    mix_norm_bound: float = 10.0
    #: "cuda" (default) or "cpu"; never falls back on its own
    device: str = "cuda"
    #: most examples one coalesced train flush takes; 0 = the direct
    #: per-RPC path (server/microbatch.py)
    microbatch_max: int = 8192

    @property
    def is_standalone(self) -> bool:
        return self.coordinator == ""

    @property
    def bind_host(self) -> str:
        return self.listen_addr or "0.0.0.0"

    @property
    def eth(self) -> str:
        """Our address as seen by peers (reference common/network get_ip).
        The UDP connect only picks the outgoing interface; it sends
        nothing."""
        if self.listen_addr and self.listen_addr != "0.0.0.0":
            return self.listen_addr
        try:
            s = socket.socket(socket.AF_INET, socket.SOCK_DGRAM)
            s.connect(("10.255.255.255", 1))
            ip = s.getsockname()[0]
            s.close()
            return ip
        except OSError:
            return "127.0.0.1"

    def check_ported(self) -> None:
        """Raise ``NotYetPorted`` for a flag value whose plane the port
        lacks."""
        if self.mixer != "linear_mixer":
            raise NotYetPorted(
                f"--mixer {self.mixer}: only linear_mixer is ported")
        if self.mix_guard == "quarantine":
            raise NotYetPorted(
                "--mix-guard quarantine: its rollback needs the model "
                "snapshot ring, which is not yet ported")

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
    p.add_argument("-d", "--datadir", default="/tmp",
                   help="directory save/load use for model files")
    p.add_argument("-f", "--configpath", default="")
    p.add_argument("-m", "--model-file", default="",
                   help="model file to load at start")
    p.add_argument("--config-test", action="store_true")
    p.add_argument("-z", "--coordinator", default="",
                   help="coordination backend: a shared directory path "
                        "(or file://path) or 'memory'; empty = standalone")
    p.add_argument("-n", "--name", default="")
    p.add_argument("-x", "--mixer", default="linear_mixer", choices=MIXERS,
                   help="mix strategy; only linear_mixer is ported")
    p.add_argument("-s", "--interval-sec", type=float, default=16.0)
    p.add_argument("-i", "--interval-count", type=int, default=512)
    p.add_argument("--coordinator-timeout", "--zookeeper-timeout",
                   dest="coordinator_timeout", type=float, default=10.0)
    p.add_argument("--interconnect-timeout", type=float, default=10.0)
    p.add_argument("--mix-quorum", type=float, default=0.5,
                   help="minimum fraction of members whose diffs must "
                        "arrive for a mix round to proceed")
    p.add_argument("--mix-guard", default="warn",
                   choices=["off", "warn", "quarantine"],
                   help="mix admission guard: off = no screening; warn = "
                        "count + emit, fold anyway (quarantine is not yet "
                        "ported)")
    p.add_argument("--mix-norm-bound", type=float, default=10.0,
                   help="norm-outlier multiplier for the mix guard")
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
    if args.mix_norm_bound <= 0:
        raise SystemExit("--mix-norm-bound must be > 0")
    if args.is_standalone and not args.configpath:
        raise SystemExit("standalone mode requires -f/--configpath")
    if not args.is_standalone and not args.name:
        raise SystemExit("distributed mode (-z) requires --name")
    return args
