"""Server command-line flags (lean counterpart of ``jubatus_tpu/server/args.py``).

The reference's flag names and defaults for what the port's server uses:
the standalone flags, save/load (``-d/--datadir``, ``-m/--model-file``),
the mix plane with its coordinator (``-z/--coordinator``, ``-x/--mixer``,
``-s/--interval-sec``, ``-i/--interval-count``, ``--interconnect-timeout``,
``--coordinator-timeout``, ``--mix-quorum``, ``--mix-async``,
``--mix-staleness-bound``, ``--mix-guard``, ``--mix-norm-bound``), the
collective mix plane's process world and wire (``--jax-coordinator``,
``--jax-processes``, ``--jax-process-id``, ``--mix-compress``, the
deprecated ``--mix-bf16``, ``--mix-topology``: the JAX package's names,
kept although the runtime is ``torch.distributed``), the
snapshot ring (``--model-snapshot-interval``), elastic membership
(``--no-auto-rebalance``, ``--drain-grace``), sharded serving
(``--shard-devices``, ``--shard-features``) and the IVF tier (``--ann``,
``--ann-cells``, ``--ann-nprobe``), the model store
(``--store-dir``, ``--store-interval``, ``--store-compact-every``,
``--store-compress``, ``--no-store-warmboot``), the chaos drills'
``--fault`` rules, plus ``--device``, with
the JAX package's defaults and checks. ``--mixer`` takes the JAX
package's names. No flag is accepted and then ignored.
"""

from __future__ import annotations

import argparse
import dataclasses
import socket
from typing import Any, Dict, List, Optional

from jubatus_tpu_torch.utils.faults import parse_rule

#: the JAX package's --mixer names
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
    #: the process world of --mixer collective_mixer
    #: (parallel/multihost.py): every replica process joins one
    #: torch.distributed world so the mix's reduce spans them. Process 0's
    #: host:port is the rendezvous; peers may omit it when the
    #: coordination store publishes it.
    jax_coordinator: str = ""       # host:port of process 0
    jax_processes: int = 0          # world size; 0 = no distributed init
    jax_process_id: int = -1
    #: --mix-compress: the collective mixer's wire mode (off, bf16, int8
    #: with error feedback); all members must agree or the round falls
    #: back to the RPC mix
    mix_compress: str = "off"
    #: --mix-bf16: deprecated alias for --mix-compress bf16
    mix_bf16: bool = False
    #: --mix-topology: the collective mixer's tier shape ("" flat, auto,
    #: HxM); the resolved NxM rides the prepare signature
    mix_topology: str = ""
    #: minimum fraction of members whose diffs must arrive for a master
    #: round to proceed (framework/linear_mixer.py)
    mix_quorum: float = 0.5
    #: stream mix rounds asynchronously (framework/async_mixer.py;
    #: linear_mixer only)
    mix_async: bool = False
    #: rounds-stale past which an async submission is dropped
    mix_staleness_bound: int = 8
    #: mix admission guard (framework/model_guard.py): off, warn or
    #: quarantine
    mix_guard: str = "warn"
    #: norm-outlier multiplier of the mix guard
    mix_norm_bound: float = 10.0
    #: seconds between in-process model snapshots into the rollback ring
    #: (0 = none; take_snapshot still works)
    model_snapshot_interval: float = 0.0
    #: pull my owned rows from the current owners on join
    auto_rebalance: bool = True
    #: seconds a drain waits for in-flight work before the handoff
    drain_grace: float = 1.0
    #: root of the shared model store; "" = node-local durability only
    store_dir: str = ""
    #: seconds between background store uploads (0 = no uploader)
    store_interval: float = 0.0
    #: diff records per chain before a fresh full record
    store_compact_every: int = 8
    #: diff-record encoding: off (lossless) or int8
    store_compress: str = "off"
    #: boot from the store's freshest snapshot when --store-dir is set
    store_warmboot: bool = True
    #: fault-injection rules armed at boot (utils/faults.py grammar)
    fault: List[str] = dataclasses.field(default_factory=list)
    #: "cuda" (default) or "cpu"; never falls back on its own
    device: str = "cuda"
    #: most examples one coalesced train flush takes; 0 = the direct
    #: per-RPC path (server/microbatch.py)
    microbatch_max: int = 8192
    #: span the model over this many local devices (0/1 = one device)
    shard_devices: int = 0
    #: linear engines: the per-device feature budget (shard count =
    #: feature dim / shard_features); exclusive with shard_devices
    shard_features: int = 0
    #: approximate-NN tier of the instance engines: off or ivf
    ann: str = "off"
    #: IVF cell count (0 = auto, a power of two near sqrt(rows))
    ann_cells: int = 0
    #: IVF cells probed per query
    ann_nprobe: int = 8

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
                        "(or file://path), the coordination service "
                        "(tcp://host:port or host:port) or 'memory'; "
                        "empty = standalone")
    p.add_argument("-n", "--name", default="")
    p.add_argument("-x", "--mixer", default="linear_mixer", choices=MIXERS,
                   help="mix strategy: linear_mixer, collective_mixer, a "
                        "push strategy (random_mixer, broadcast_mixer, "
                        "skip_mixer) or dummy_mixer")
    p.add_argument("-s", "--interval-sec", type=float, default=16.0)
    p.add_argument("-i", "--interval-count", type=int, default=512)
    p.add_argument("--coordinator-timeout", "--zookeeper-timeout",
                   dest="coordinator_timeout", type=float, default=10.0)
    p.add_argument("--interconnect-timeout", type=float, default=10.0)
    p.add_argument("--jax-coordinator", default="",
                   help="jax.distributed coordinator host:port (process "
                        "0's reachable address) for --mixer "
                        "collective_mixer")
    p.add_argument("--jax-processes", type=int, default=0,
                   help="jax.distributed world size (replica process "
                        "count); 0 disables distributed jax init")
    p.add_argument("--jax-process-id", type=int, default=-1,
                   help="this process's rank in the jax world")
    p.add_argument("--mix-compress", default="off",
                   choices=["off", "bf16", "int8"],
                   help="collective mixer wire mode: off = native "
                        "dtypes; bf16 = cast f32 diffs to bf16 on "
                        "device (half the bytes per round); int8 = "
                        "block-quantized collective (~4x fewer wire "
                        "bytes, one f32 scale per 256 elements) with an "
                        "error-feedback residual carried between rounds "
                        "so averaged weights stay unbiased. All members "
                        "must agree or the round falls back to the RPC "
                        "mix")
    p.add_argument("--mix-bf16", action="store_true",
                   help="deprecated alias for --mix-compress bf16 (an "
                        "explicit --mix-compress wins when both are "
                        "given)")
    p.add_argument("--mix-topology", default="",
                   help="hierarchical mix tier shape (collective mixer): "
                        "'' = flat single-tier psum; 'auto' = derive N "
                        "hosts x M local devices from the runtime and go "
                        "hierarchical when M > 1; explicit 'HxM' groups "
                        "the process world (co-located processes per "
                        "host). Intra-host reduce first, one chunk copy "
                        "per host on the inter-host wire; the resolved "
                        "NxM rides the prepare signature so mismatched "
                        "fleets fall back to the RPC mix")
    p.add_argument("--mix-quorum", type=float, default=0.5,
                   help="minimum fraction of members whose diffs must "
                        "arrive for a mix round to proceed")
    p.add_argument("--mix-async", action="store_true",
                   help="stream mix rounds asynchronously (linear mixer "
                        "only): members push diffs to the master's inbox "
                        "and the master folds what arrived with "
                        "bounded-staleness weights")
    p.add_argument("--mix-staleness-bound", type=int, default=8,
                   help="rounds-stale past which a submitted diff is "
                        "dropped from the async fold (its weight decays "
                        "2**-staleness up to the bound)")
    p.add_argument("--mix-guard", default="warn",
                   choices=["off", "warn", "quarantine"],
                   help="mix admission guard: off = no screening; warn = "
                        "count + emit, fold anyway; quarantine = drop "
                        "screened-out contributions and roll back on a "
                        "non-finite folded total")
    p.add_argument("--mix-norm-bound", type=float, default=10.0,
                   help="norm-outlier multiplier for the mix guard")
    p.add_argument("--model-snapshot-interval", type=float, default=0.0,
                   help="seconds between in-process model snapshots into "
                        "the bounded rollback ring (save_load envelope, "
                        "CRC-checked on restore); 0 = none")
    p.add_argument("--no-auto-rebalance", dest="auto_rebalance",
                   action="store_false",
                   help="do NOT pull owned rows from the current owners "
                        "on join; repair later with the rebalance RPC")
    p.add_argument("--drain-grace", type=float, default=1.0,
                   help="seconds a drain waits for in-flight work after "
                        "new effectful calls start being rejected, before "
                        "handing rows to their new ring owners")
    p.add_argument("--store-dir", default="",
                   help="root of the shared model store: warm boot, "
                        "background uploads (--store-interval), store:<key> "
                        "ids in save/load, store_restore; empty = "
                        "node-local durability only")
    p.add_argument("--store-interval", type=float, default=0.0,
                   help="seconds between background uploads to "
                        "--store-dir (a full record, then diff records); "
                        "0 = no uploader")
    p.add_argument("--store-compact-every", type=int, default=8,
                   help="diff records per chain before the uploader "
                        "re-anchors with a full record and the store folds "
                        "the chain")
    p.add_argument("--store-compress", default="off",
                   choices=["off", "int8"],
                   help="diff-record encoding: off = bit-exact replay; "
                        "int8 = block-quantized deltas with error feedback")
    p.add_argument("--no-store-warmboot", dest="store_warmboot",
                   action="store_false",
                   help="boot cold even when --store-dir is set")
    p.add_argument("--fault", action="append", default=[],
                   help="arm a fault-injection rule at boot (repeatable; "
                        "site:action[:arg], e.g. mix.diff.poison*:nan) — "
                        "for chaos drills, never in production")
    p.add_argument("--device", default="cuda", choices=("cuda", "cpu"),
                   help="device the model runs on; cuda unless cpu is asked "
                        "for (no fallback)")
    p.add_argument("--microbatch-max", type=int, default=8192,
                   help="most examples one coalesced train flush takes "
                        "(classifier, regression); 0 trains per RPC")
    p.add_argument("--shard-devices", type=int, default=0,
                   help="span the model over this many local devices (0/1 = "
                        "single device): feature-sharded tables for linear "
                        "classifier/regression (per-device weight state is "
                        "D/N; one cross-shard sum of the logits a step), "
                        "row-sharded arenas + signature tables for "
                        "NN/recommender/anomaly hash methods (rows land in "
                        "their CHT-owned shard; per-shard top-k merged on "
                        "the first device)")
    p.add_argument("--shard-features", type=int, default=0,
                   metavar="D_PER_SHARD",
                   help="feature-shard the linear engines by per-device "
                        "budget instead of device count: shard count = "
                        "feature dim / D_PER_SHARD (must divide; needs "
                        "that many local devices). Mutually exclusive with "
                        "--shard-devices")
    p.add_argument("--ann", choices=("off", "ivf"), default="off",
                   help="approximate-NN tier for the instance engines "
                        "(nearest_neighbor/recommender/anomaly): 'off' "
                        "(default) keeps every query on the exact "
                        "brute-force scan; 'ivf' partitions rows into "
                        "k-means cells and answers queries by probing "
                        "the nearest cells + an exact rescore of only "
                        "their rows. LOF density scans and anomaly scores "
                        "stay exact either way")
    p.add_argument("--ann-cells", type=int, default=0, metavar="K",
                   help="IVF cell count for --ann ivf; 0 (default) "
                        "auto-sizes to a power of two near sqrt(rows)")
    p.add_argument("--ann-nprobe", type=int, default=8, metavar="P",
                   help="cells probed per query for --ann ivf — the "
                        "recall/latency dial: each probed cell adds "
                        "~rows/cells candidates to the exact rescore; "
                        "raise toward the cell count to converge on "
                        "the exact result")
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
    if args.shard_devices < 0:
        raise SystemExit("--shard-devices must be >= 0")
    if args.shard_features < 0:
        raise SystemExit("--shard-features must be >= 0")
    if args.shard_features and args.shard_devices:
        raise SystemExit(
            "--shard-features and --shard-devices are mutually exclusive "
            "(the former derives the device count from the per-device "
            "feature budget)")
    if args.ann_cells < 0:
        raise SystemExit("--ann-cells must be >= 0 (0 = auto)")
    if args.ann_nprobe < 1:
        raise SystemExit("--ann-nprobe must be >= 1")
    if args.ann_cells and args.ann_nprobe > args.ann_cells:
        raise SystemExit("--ann-nprobe cannot exceed --ann-cells")
    if args.mix_norm_bound <= 0:
        raise SystemExit("--mix-norm-bound must be > 0")
    if args.mix_staleness_bound < 0:
        raise SystemExit("--mix-staleness-bound must be >= 0")
    if args.model_snapshot_interval < 0:
        raise SystemExit("--model-snapshot-interval must be >= 0")
    if args.mix_async and args.mixer != "linear_mixer":
        raise SystemExit(
            "--mix-async requires -x linear_mixer (push mixers are "
            "already leaderless; the collective is a barrier by "
            "construction)")
    if args.store_interval < 0:
        raise SystemExit("--store-interval must be >= 0")
    if args.store_compact_every < 1:
        raise SystemExit("--store-compact-every must be >= 1")
    if args.store_interval > 0 and not args.store_dir:
        raise SystemExit("--store-interval requires --store-dir")
    for rule in args.fault:
        try:  # reject bad grammar at argv time, not at first firing
            parse_rule(rule)
        except ValueError as e:
            raise SystemExit(str(e))
    if args.mix_bf16 and args.mix_compress == "off":
        args.mix_compress = "bf16"  # deprecated alias resolves here
    if args.is_standalone and not args.configpath:
        raise SystemExit("standalone mode requires -f/--configpath")
    if not args.is_standalone and not args.name:
        raise SystemExit("distributed mode (-z) requires --name")
    return args
