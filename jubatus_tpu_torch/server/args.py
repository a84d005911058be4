"""Server command-line flags (lean counterpart of ``jubatus_tpu/server/args.py``).

The reference's flag names and defaults for what the port's server uses:
the standalone flags (with ``-t/--timeout``, ``-l/--logdir``,
``-g/--log-config`` and ``-D/--daemon``, which is parsed and changes
nothing, as in the JAX server), save/load (``-d/--datadir``, ``-m/--model-file``),
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
``--fault`` rules, the forensics plane (``--metrics-port``,
``--slowlog-capacity``, ``--slowlog-quantile``, ``--slowlog-min-count``,
``--telemetry-interval``, ``--profile-hz``, ``--profile-dir``,
``--profile-trigger-breaches``, ``--profile-trigger-window``), the
converter's memo caches (``--fv-cache-size``), the model-health plane
(``--timeseries-capacity``, ``--slo``, ``--slo-fast-window``,
``--slo-slow-window``, ``--slo-burn-threshold``), the event plane and its
incident bundles (``--event-capacity``, ``--incident-dir``,
``--incident-window``), the data-quality plane (``--quality-sample``,
``--quality-window``, ``--quality-ref-windows``) and the usage ledger
(``--usage-top``, ``--usage-gauge-principals``), the perf tuner
(``--auto-tune``, ``--tune-interval-floor``, ``--tune-interval-ceiling``)
and the legacy wire (``--legacy-wire``, ``--modern-wire``), plus
``--device``, with the JAX package's defaults and checks: every flag of
the JAX server parses here. ``--mixer`` takes the JAX package's names.
"""

from __future__ import annotations

import argparse
import dataclasses
import socket
from typing import Any, Dict, List, Optional

from jubatus_tpu_torch.utils.faults import parse_rule
from jubatus_tpu_torch.utils.slo import parse_slo

#: the JAX package's --mixer names
MIXERS = ("linear_mixer", "collective_mixer", "random_mixer",
          "broadcast_mixer", "skip_mixer", "dummy_mixer")


@dataclasses.dataclass
class ServerArgs:
    engine: str = ""
    rpc_port: int = 9199                # -p
    listen_addr: str = ""               # -b
    thread: int = 2                     # -c (RPC worker threads)
    #: -t: the RPC timeout; a coalesced train waits 6x it for its flush
    #: (0 = no timeout)
    timeout: float = 10.0
    datadir: str = "/tmp"               # -d
    logdir: str = ""                    # -l
    log_config: str = ""                # -g (server_util.cpp:70-127)
    configpath: str = ""                # -f
    model_file: str = ""                # -m
    daemon: bool = False                # -D (parsed; changes nothing)
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
    #: --auto-tune: the self-tuning performance plane
    #: (coord/perf_tuner.py). ``off`` = no tuner; ``observe`` = run every
    #: tuner core off the telemetry tick and journal dry-run
    #: recommendations (``jubactl -c tune``) without touching a knob;
    #: ``on`` = actuate — wire mode + chunk size through the re-signed
    #: prepare plan, microbatch depth via Little's law, and the async-mix
    #: cadence within the floor/ceiling below.
    auto_tune: str = "off"
    #: --tune-interval-floor/-ceiling: operator bounds (seconds) the
    #: cadence tuner must stay inside when retargeting the mix interval
    tune_interval_floor: float = 1.0
    tune_interval_ceiling: float = 120.0
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
    #: Prometheus /metrics + /healthz + /slowlog HTTP port
    #: (utils/metrics_http.py): -1 = off, 0 = ephemeral (the bound port
    #: lands in get_status)
    metrics_port: int = -1
    #: tail-based slow-request capture (utils/slowlog.py): an RPC at/above
    #: this quantile of its own span histogram lands in a bounded ring;
    #: capacity 0 disables capture; no capture below min_count samples
    slowlog_capacity: int = 256
    slowlog_quantile: float = 0.99
    slowlog_min_count: int = 64
    #: runtime telemetry sampler period (utils/runtime_telemetry.py);
    #: 0 disables the thread
    telemetry_interval: float = 10.0
    #: always-on stack sampling rate (utils/profiler.py); 0 = no sampler
    profile_hz: float = 67.0
    #: artifacts directory of profile_device captures; "" =
    #: <datadir>/jubatus_profile_<engine>_<port>
    profile_dir: str = ""
    #: slow-log captures of one span inside the window that take a
    #: sampling-profile snapshot (once per window; 0 = no tail trigger)
    profile_trigger_breaches: int = 3
    profile_trigger_window: float = 10.0
    #: --fv-cache-size: bound (entries) of the converter's filter, token
    #: and name memo caches; 0 disables memoization
    fv_cache_size: int = 65536
    #: --slo (repeatable): declarative SLOs evaluated as multi-window
    #: burn rates over the time-series ring (utils/slo.py)
    slo: List[str] = dataclasses.field(default_factory=list)
    #: the multi-window burn-rate pair (seconds) and the threshold both
    #: windows must reach for an alert to fire
    slo_fast_window: float = 300.0
    slo_slow_window: float = 3600.0
    slo_burn_threshold: float = 2.0
    #: points retained in the metric time-series ring, one a telemetry
    #: tick (0 disables the ring, the SLOs and get_timeseries)
    timeseries_capacity: int = 360
    #: events retained in the cluster event journal (0 disables emission)
    event_capacity: int = 2048
    #: debounce window (seconds) of automatic incident bundles
    #: (utils/incidents.py; 0 disables auto-capture)
    incident_window: float = 300.0
    #: capped artifacts dir of incident bundles; "" =
    #: <datadir>/jubatus_incidents_<engine>_<port>
    incident_dir: str = ""
    #: fraction of train / convert batches the data-quality plane
    #: (utils/quality.py) records and scores prequentially; 0 disarms it
    quality_sample: float = 0.05
    #: seconds a quality window; completed windows pinned as reference
    quality_window: float = 60.0
    quality_ref_windows: int = 2
    #: principals the usage ledger (utils/usage.py) tracks exactly before
    #: the tail folds into (other); 0 disarms the ledger
    usage_top: int = 64
    #: top-demand principals published as usage.<principal>.* gauges
    usage_gauge_principals: int = 8
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
    #: FORCE every response into the pre-str8/bin msgpack format deployed
    #: jubatus clients require; mixer internals keep the modern format
    #: (rpc/legacy.py). Without it the server autodetects per connection
    #: from the requests' type bytes — unmodified old clients just work.
    legacy_wire: bool = False
    #: disable the per-connection legacy-wire autodetection
    modern_wire: bool = False

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
    p.add_argument("-t", "--timeout", type=float, default=10.0,
                   help="RPC timeout in seconds; a coalesced train waits "
                        "six times it for its flush (0 = no timeout)")
    p.add_argument("-d", "--datadir", default="/tmp",
                   help="directory save/load use for model files")
    p.add_argument("-l", "--logdir", default="",
                   help="write the log to <logdir>/juba<engine>.log "
                        "instead of stderr")
    p.add_argument("-g", "--log-config", default="",
                   help="logging dictConfig JSON; hot-reloaded on SIGHUP")
    p.add_argument("-f", "--configpath", default="")
    p.add_argument("-m", "--model-file", default="",
                   help="model file to load at start")
    p.add_argument("-D", "--daemon", action="store_true",
                   help="accepted for the reference's command lines; "
                        "the server stays in the foreground")
    p.add_argument("--config-test", action="store_true")
    p.add_argument("-z", "--coordinator", default="",
                   help="coordination backend: a shared directory path "
                        "(or file://path), the coordination service "
                        "(tcp://host:port or host:port), a ZooKeeper "
                        "ensemble (zk://host:port[,host:port...]) or "
                        "'memory'; empty = standalone")
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
    p.add_argument("--auto-tune", default="off",
                   choices=["off", "observe", "on"],
                   help="self-tuning performance plane "
                        "(coord/perf_tuner.py): off = static flags only; "
                        "observe = journal dry-run recommendations "
                        "(jubactl -c tune) without touching anything; "
                        "on = actuate — mix wire mode + chunk size, "
                        "microbatch depth (Little's-law residency "
                        "target) and the async-mix cadence")
    p.add_argument("--tune-interval-floor", type=float, default=1.0,
                   help="cadence tuner floor (seconds): auto-tune "
                        "never quickens the mix interval below this")
    p.add_argument("--tune-interval-ceiling", type=float, default=120.0,
                   help="cadence tuner ceiling (seconds): auto-tune "
                        "never relaxes the mix interval above this")
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
    p.add_argument("--fault", action="append", default=None,
                   help="arm a fault-injection rule at boot (repeatable; "
                        "site:action[:arg], e.g. mix.diff.poison*:nan) — "
                        "for chaos drills, never in production")
    p.add_argument("--metrics-port", type=int, default=-1,
                   help="serve Prometheus /metrics + /healthz on this "
                        "HTTP port (0 = ephemeral; default off)")
    p.add_argument("--slowlog-capacity", type=int, default=256,
                   help="slow-request ring size (tail-based capture of "
                        "RPCs at/above --slowlog-quantile of their own "
                        "latency histogram; 0 disables)")
    p.add_argument("--slowlog-quantile", type=float, default=0.99,
                   help="per-span histogram quantile at/above which a "
                        "request is captured in the slow log (and "
                        "exemplar-stamped on /metrics)")
    p.add_argument("--slowlog-min-count", type=int, default=64,
                   help="samples a span needs before slow-log "
                        "thresholding starts (early on, everything "
                        "is 'p99')")
    p.add_argument("--telemetry-interval", type=float, default=10.0,
                   help="runtime telemetry sampling period in seconds "
                        "(RSS/FDs/threads/GC + the card's allocator, "
                        "memory and kernel builds into get_status, "
                        "/metrics, /healthz; 0 disables the sampler "
                        "thread)")
    p.add_argument("--profile-hz", type=float, default=67.0,
                   help="always-on stack sampling rate (Hz): a daemon "
                        "thread folds every thread's stack into a "
                        "bounded windowed store served by get_profile "
                        "and jubadump --profile; 0 disables the sampler "
                        "thread entirely")
    p.add_argument("--profile-dir", default="",
                   help="artifacts directory for on-demand device "
                        "captures (profile_device RPC wrapping "
                        "torch.profiler); empty = under --datadir. Old "
                        "captures are pruned past a fixed cap")
    p.add_argument("--profile-trigger-breaches", type=int, default=3,
                   help="slow-log captures of the SAME span inside "
                        "--profile-trigger-window that auto-capture a "
                        "short sampling-profile snapshot stamped with "
                        "the breaching trace_ids (once per window; "
                        "0 disables the tail trigger)")
    p.add_argument("--profile-trigger-window", type=float, default=10.0,
                   help="breach-counting window (seconds) for the "
                        "tail-triggered profile snapshot")
    p.add_argument("--fv-cache-size", type=int, default=65536,
                   help="entry bound for the feature pipeline's "
                        "tokenization/filter/name memo caches (repeated "
                        "hot strings skip re-splitting and re-hashing); "
                        "0 disables memoization")
    p.add_argument("--slo", action="append", default=None, metavar="SPEC",
                   help="declarative SLO evaluated as a multi-window "
                        "burn rate (repeatable). SPEC is "
                        "latency:<span>:p<QQ>:<threshold_ms>[:<objective>]"
                        " (e.g. latency:rpc.classify:p99:50), "
                        "error_rate:<span|*>:<objective> "
                        "(e.g. error_rate:*:0.01), or "
                        "gauge:<key>:<ceiling>; an optional name= prefix "
                        "names the alert. Firing alerts surface as "
                        "slo.* gauges on /metrics, degrade /healthz, and "
                        "list under get_alerts")
    p.add_argument("--slo-fast-window", type=float, default=300.0,
                   help="fast burn-rate window in seconds (proves the "
                        "burn is current; clears alerts after recovery)")
    p.add_argument("--slo-slow-window", type=float, default=3600.0,
                   help="slow burn-rate window in seconds (proves the "
                        "burn is significant, not one blip)")
    p.add_argument("--slo-burn-threshold", type=float, default=2.0,
                   help="fire an alert when BOTH windows burn error "
                        "budget at/above this multiple of the "
                        "sustainable rate")
    p.add_argument("--timeseries-capacity", type=int, default=360,
                   help="points retained in the metric time-series ring "
                        "(one per telemetry tick; default = 1 h at the "
                        "10 s interval). 0 disables the ring, SLO "
                        "evaluation, and get_timeseries")
    p.add_argument("--event-capacity", type=int, default=2048,
                   help="events retained in the cluster event journal "
                        "(typed, HLC-stamped state-transition events "
                        "served by get_events); 0 disables emission "
                        "entirely")
    p.add_argument("--incident-window", type=float, default=300.0,
                   help="debounce window (seconds) for automatic "
                        "incident forensics bundles: an SLO firing, "
                        "/healthz going degraded or a rollback captures "
                        "ONE correlated snapshot (event window, "
                        "timeseries, slow log, flight records, profiler "
                        "tail) per window; 0 disables auto-capture")
    p.add_argument("--incident-dir", default="",
                   help="capped artifacts dir for incident bundles "
                        "(oldest pruned past a fixed cap; get_incidents "
                        "lists and returns them); empty = under "
                        "--datadir")
    p.add_argument("--quality-sample", type=float, default=0.05,
                   help="fraction of train/FV batches the data-quality "
                        "plane records into its drift sketches and "
                        "scores prequentially (test-then-train); "
                        "0 disarms the plane")
    p.add_argument("--quality-window", type=float, default=60.0,
                   help="seconds per data-quality window: the live "
                        "sketches roll into the reference-vs-live ring "
                        "at this cadence and PSI drift is recomputed "
                        "against the pinned reference")
    p.add_argument("--quality-ref-windows", type=int, default=2,
                   help="completed windows merged into the pinned "
                        "reference before drift scoring starts")
    p.add_argument("--usage-top", type=int, default=64,
                   help="principals (tenant ids) the usage ledger "
                        "tracks exactly before the long tail folds "
                        "into (other); the heavy-hitter sketch still "
                        "ranks everyone. 0 disarms per-tenant "
                        "attribution entirely")
    p.add_argument("--usage-gauge-principals", type=int, default=8,
                   help="top-demand principals published as "
                        "usage.<principal>.* gauges per telemetry "
                        "tick (bounds the gauge namespace under high "
                        "tenant cardinality)")
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
    p.add_argument("--legacy-wire", action="store_true",
                   help="FORCE all RPC responses into the pre-str8/bin "
                        "msgpack format legacy jubatus clients (vendored "
                        "pre-2013 msgpack) parse; without it the server "
                        "autodetects per connection from the requests' "
                        "type bytes")
    p.add_argument("--modern-wire", action="store_true",
                   help="disable the per-connection legacy-wire "
                        "autodetection: always answer in modern msgpack "
                        "(str8/bin) unless --legacy-wire forces otherwise")
    return p


def parse_server_args(argv: Optional[List[str]] = None) -> ServerArgs:
    ns = build_parser().parse_args(argv)
    ns.slo = ns.slo or []  # argparse's append default stays None (a
    ns.fault = ns.fault or []  # shared mutable [] would leak across parses)
    args = ServerArgs(**{f.name: getattr(ns, f.name)
                         for f in dataclasses.fields(ServerArgs)})
    if args.thread < 1:
        raise SystemExit("--thread must be >= 1")
    if args.rpc_port < 0 or args.rpc_port > 65535:
        raise SystemExit("--rpc-port out of range")
    if args.microbatch_max < 0:
        raise SystemExit("--microbatch-max must be >= 0")
    if args.metrics_port > 65535:
        raise SystemExit("--metrics-port out of range")
    if args.slowlog_capacity < 0:
        raise SystemExit("--slowlog-capacity must be >= 0")
    if not 0.0 < args.slowlog_quantile <= 1.0:
        raise SystemExit("--slowlog-quantile must be in (0, 1]")
    if args.telemetry_interval < 0:
        raise SystemExit("--telemetry-interval must be >= 0")
    if args.fv_cache_size < 0:
        raise SystemExit("--fv-cache-size must be >= 0")
    if args.timeseries_capacity < 0:
        raise SystemExit("--timeseries-capacity must be >= 0")
    if args.slo_fast_window <= 0 or args.slo_slow_window <= 0:
        raise SystemExit("--slo-*-window must be > 0")
    if args.slo_burn_threshold <= 0:
        raise SystemExit("--slo-burn-threshold must be > 0")
    if args.profile_hz < 0 or args.profile_hz > 1000:
        raise SystemExit("--profile-hz must be in [0, 1000]")
    if args.profile_trigger_breaches < 0:
        raise SystemExit("--profile-trigger-breaches must be >= 0")
    if args.profile_trigger_window <= 0:
        raise SystemExit("--profile-trigger-window must be > 0")
    if args.event_capacity < 0:
        raise SystemExit("--event-capacity must be >= 0")
    if args.incident_window < 0:
        raise SystemExit("--incident-window must be >= 0")
    if not 0.0 <= args.quality_sample <= 1.0:
        raise SystemExit("--quality-sample must be in [0, 1]")
    if args.quality_window <= 0:
        raise SystemExit("--quality-window must be > 0")
    if args.quality_ref_windows < 1:
        raise SystemExit("--quality-ref-windows must be >= 1")
    if args.usage_top < 0:
        raise SystemExit("--usage-top must be >= 0")
    if args.usage_gauge_principals < 1:
        raise SystemExit("--usage-gauge-principals must be >= 1")
    for spec in args.slo:
        try:  # reject bad grammar at argv time, not at first tick
            parse_slo(spec)
        except ValueError as e:
            raise SystemExit(str(e))
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
    if args.tune_interval_floor <= 0:
        raise SystemExit("--tune-interval-floor must be > 0")
    if args.tune_interval_floor > args.tune_interval_ceiling:
        raise SystemExit("--tune-interval-floor must not exceed "
                         "--tune-interval-ceiling")
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
