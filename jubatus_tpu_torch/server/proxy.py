"""Query-routing proxy tier (trimmed copy of ``jubatus_tpu/server/proxy.py``;
≙ framework/proxy.{hpp,cpp} + proxy_common.{hpp,cpp}).

    python -m jubatus_tpu_torch.server.proxy <engine> -z tcp://host:2199 [-p PORT]

The reference's ``juba<engine>_proxy`` binaries are RPC servers whose
methods are registered by routing class — random (1 active node), broadcast
(all actives + reducer fold), cht (N ring successors of the key + reducer)
(proxy.hpp:64-186,229-286) — with built-ins save/load/get_status/
get_proxy_status (proxy.cpp:43-66). Member lookup reads the coordination
store's ``actives`` list through a watch-invalidated cache (proxy_common.cpp:
73-114, cached_zk). Sessions to backend servers live in a pool with expiry
(proxy.hpp:502-593).

One ``Proxy`` class serves any engine: the routing/aggregator table comes
from ``framework.idl.SERVICES``; ``#@internal`` methods are never exposed.
The wire is the JAX proxy's — same method names, same leading cluster-name
param, same reducer semantics, per-host failures tolerated as long as one
backend answers — so a port proxy routes to JAX servers, port servers or a
mix of both, and a JAX proxy routes to port servers.

Beyond the reference, as in the JAX proxy:

- **per-backend circuit breakers** (rpc/breaker.py): an OPEN backend is
  skipped by random/cht routing and re-admitted via half-open probes;
- **idempotent failover**: random-routed reads that hit a transport
  failure fail over to the next active replica (retry-budget-gated);
  effectful calls propagate their first failure;
- **deadline-aware fan-out**: the broadcast collects against ONE shared
  deadline derived from the caller's remaining budget, abandoning
  stragglers (``proxy.fanout_timeouts``); every forward re-ships the
  caller's remaining deadline, its principal and its trace on the
  envelope;
- **elastic membership**: a ring cache rebuilt only when the member list
  changes, with a handoff window after a change during which CHT-routed
  effectful calls go to the union of old and new owners; a backend's
  ``NodeDraining`` / ``EpochMismatch`` refusal refreshes the member view
  and re-routes the call once (nothing was applied);
- **the zero-decode raw relay**: random-routed methods forward the raw
  params span to one backend and splice its raw result span into the
  response, so train/classify payloads never materialize as Python
  objects here; anything irregular declines to the generic path;
- **the C++ relay** (the native transport, rpc/native_server.py, the
  default): a cluster first seen on the Python path enters the C++
  routing table at the refresher's next 1 s tick, and its random-routed
  requests are then forwarded in C++ without entering Python (no proxy
  span, slow-log record, breaker probe or fault site sees them). The
  table withholds backends whose breaker is open, keeps a cluster's last
  routing when its lookup fails, and drops a cluster that stays empty
  for 60 s. ``get_proxy_status`` folds the relay's counts into
  ``forward_count``, ``request.<method>`` and ``relay_count``, and its
  synthesized backend-loss answers into ``forward_errors``.

The observability planes at the proxy hop, as in the JAX proxy (one
telemetry thread ticks them, started and stopped with the listener):

- **forensics**: the slow-request ring (``--slowlog-*``), the runtime
  telemetry sampler (``--telemetry-interval``), the always-on stack
  sampler (``--profile-hz``) with the slow log's tail trigger
  (``--profile-trigger-*``), and ``/metrics`` + ``/healthz`` on
  ``--metrics-port``;
- **model health**: the time-series ring and the SLO engine
  (``--timeseries-capacity``, ``--slo*``) over the proxy's own dispatch
  and per-backend client-call spans;
- **events and incidents**: the event journal (``--event-capacity``;
  breaker transitions, SLO edges) and incident bundles on a firing SLO or
  a degraded ``/healthz`` (``--incident-*``);
- **usage**: the proxy's own per-tenant ledger (``--usage-*``): both
  forward paths, the decoded one and the raw relay, bill the caller's
  principal, the dispatch's CPU-seconds and the request and response
  bytes.

The forensics RPCs (``get_spans``, ``get_slow_log``, ``get_timeseries``,
``get_alerts``, ``get_quality``, ``get_usage``, ``get_profile``,
``get_events``, ``get_incidents``) broadcast to the backends and fold the
proxy's own record in, keyed by node, so one call against the proxy
returns the cluster's view; ``get_metrics`` and ``profile_device`` are
plain broadcasts, and ``get_proxy_*`` answer for the proxy alone. No plane
touches the card: the proxy never creates a CUDA context.

The legacy wire (rpc/legacy.py): the proxy fingerprints each client
connection as the engine servers do and answers a legacy client in the
pre-2013 msgpack format (a relayed span is decoded and re-packed old-raw);
``--legacy-wire`` forces that format on every connection, ``--modern-wire``
turns the detection off. Python relays to the backends stay modern
(``call_raw`` sends the method name as str8); the C++ relay forwards a
legacy client's frames verbatim on a pipe of that client's own, so its
backend answers it legacy.
"""

from __future__ import annotations

import dataclasses
import logging
import os
import random
import threading
import time
from concurrent.futures import ThreadPoolExecutor, wait as futures_wait
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple

from jubatus_tpu_torch import __version__
from jubatus_tpu_torch.coord import create_coordinator, membership
from jubatus_tpu_torch.coord.base import Coordinator, NodeInfo
from jubatus_tpu_torch.coord.cht import CHT, ring_key
from jubatus_tpu_torch.framework.idl import (INTERNAL, get_service,
                                             idempotent_methods)
from jubatus_tpu_torch.rpc import aggregators
from jubatus_tpu_torch.rpc import deadline as deadlines
from jubatus_tpu_torch.rpc import principal as principals
from jubatus_tpu_torch.rpc.breaker import BreakerBoard
from jubatus_tpu_torch.rpc.client import RpcClient
from jubatus_tpu_torch.rpc.errors import (
    DeadlineExceeded,
    EpochMismatch,
    HostError,
    MultiRpcError,
    NodeDraining,
    RpcIoError,
    RpcNoClient,
    RpcNoResult,
    RpcTimeoutError,
)
from jubatus_tpu_torch.rpc.retry import RetryBudget
from jubatus_tpu_torch.rpc.native_server import (NativeRpcServer,
                                                 create_rpc_server)
from jubatus_tpu_torch.rpc.server import RAW_FALLBACK, RawResult
from jubatus_tpu_torch.utils import events, faults, tracing
from jubatus_tpu_torch.utils import usage as usage_mod
from jubatus_tpu_torch.utils.incidents import IncidentManager
from jubatus_tpu_torch.utils.profiler import SamplingProfiler
from jubatus_tpu_torch.utils.runtime_telemetry import RuntimeTelemetry
from jubatus_tpu_torch.utils.slo import SloEngine, parse_slo
from jubatus_tpu_torch.utils.timeseries import TimeSeriesRing

log = logging.getLogger(__name__)

#: transport-level failures (a breaker's evidence; failover triggers)
_TRANSPORT_ERRORS = (RpcIoError, RpcTimeoutError, faults.FaultInjected)

#: membership-protocol rejections: the backend refused BEFORE applying
#: anything (draining, or a ring-epoch disagreement). Safe to re-route
#: even for EFFECTFUL calls — the fix is a membership refresh, not a
#: backoff
_MEMBERSHIP_ERRORS = (NodeDraining, EpochMismatch)


def _membership_rejection(exc: BaseException) -> bool:
    """True when ``exc`` is (or a fan-out whose every failure is) a
    membership-protocol rejection — the caller should refresh its ring
    and re-route."""
    if isinstance(exc, _MEMBERSHIP_ERRORS):
        return True
    if isinstance(exc, MultiRpcError) and exc.errors:
        return all(isinstance(e.cause, _MEMBERSHIP_ERRORS)
                   for e in exc.errors)
    return False


class _RingCache:
    """CHT snapshots per cluster, rebuilt ONLY when the member list
    changes (no per-request ``CHT(actives)`` rebuild).

    Each entry remembers the PREVIOUS ring and when the swap happened:
    for ``handoff_window`` seconds after a membership change the proxy
    double-dispatches CHT-routed effectful calls to the union of old and
    new owners, so no key ever has zero owners while rows migrate."""

    def __init__(self, handoff_window: float = 15.0) -> None:
        self.handoff_window = float(handoff_window)
        self._lock = threading.Lock()
        #: name -> (ring_key, ring, prev_ring_or_None, swap_monotonic)
        self._entries: Dict[str, Tuple[Tuple[str, ...], CHT,
                                       Optional[CHT], float]] = {}
        self.builds = 0
        self.hits = 0

    def get(self, name: str, actives: Sequence[NodeInfo]
            ) -> Tuple[CHT, Optional[CHT]]:
        """(current ring, previous ring while inside the handoff
        window — else None)."""
        key = ring_key(actives)
        now = time.monotonic()
        with self._lock:
            e = self._entries.get(name)
            if e is not None and e[0] == key:
                self.hits += 1
                ring, prev, swapped = e[1], e[2], e[3]
                if prev is not None and now - swapped > self.handoff_window:
                    # window over: forget the old ring
                    self._entries[name] = (key, ring, None, swapped)
                    prev = None
                return ring, prev
        ring = CHT(actives)
        with self._lock:
            e = self._entries.get(name)
            prev = e[1] if (e is not None and e[0] != key
                            and e[1].members) else None
            self._entries[name] = (key, ring, prev, now)
            self.builds += 1
        return ring, prev

    def stats(self) -> Dict[str, int]:
        with self._lock:
            return {"builds": self.builds, "hits": self.hits,
                    "clusters": len(self._entries),
                    "in_handoff": sum(1 for e in self._entries.values()
                                      if e[2] is not None)}


@dataclasses.dataclass
class ProxyArgs:
    """≙ proxy_argv (server_util.cpp:440-557), with the JAX proxy's plane
    flags and defaults: 4 worker threads vs the server's 2, 10 s
    timeouts, session-pool knobs."""

    engine: str = ""
    rpc_port: int = 9199
    listen_addr: str = ""
    thread: int = 4
    timeout: float = 10.0
    coordinator: str = ""
    coordinator_timeout: float = 10.0
    interconnect_timeout: float = 10.0
    session_pool_expire: float = 60.0   # --pool-expire
    session_pool_size: int = 0          # --pool-size, 0 = unbounded
    #: -D/--daemon: parsed by the reference's proxy_argv and shown in
    #: get_proxy_status; changes nothing, as in the JAX proxy
    daemon: bool = False
    legacy_wire: bool = False           # --legacy-wire (rpc/legacy.py)
    modern_wire: bool = False           # --modern-wire: no autodetection
    #: Prometheus /metrics + /healthz HTTP port: -1 = off, 0 = ephemeral
    metrics_port: int = -1
    #: circuit breaker tuning (rpc/breaker.py): this many transport
    #: failures to one backend inside the window open its breaker for
    #: the cooldown; half-open probes re-admit it
    breaker_failures: int = 5
    breaker_window: float = 30.0
    breaker_cooldown: float = 5.0
    #: retry budget: failover retries per first-attempt forward
    retry_budget_ratio: float = 0.1
    #: --slowlog-*: tail-based slow-request capture at the proxy hop
    #: (utils/slowlog.py), the servers' semantics
    slowlog_capacity: int = 256
    slowlog_quantile: float = 0.99
    slowlog_min_count: int = 64
    #: runtime telemetry sampler period (0 disables the thread)
    telemetry_interval: float = 10.0
    #: --slo et al.: SLOs over the proxy's own spans, the servers'
    #: grammar (utils/slo.py)
    slo: List[str] = dataclasses.field(default_factory=list)
    slo_fast_window: float = 300.0
    slo_slow_window: float = 3600.0
    slo_burn_threshold: float = 2.0
    #: metric time-series ring depth (0 disables ring + SLO evaluation)
    timeseries_capacity: int = 360
    #: --profile-hz: the always-on stack sampler at the proxy hop; its
    #: routing and fan-out stacks fold into the cluster profile beside
    #: the backends'; 0 = off
    profile_hz: float = 67.0
    #: --profile-trigger-*: slow-log breach trigger for the proxy's spans
    profile_trigger_breaches: int = 3
    profile_trigger_window: float = 10.0
    #: --handoff-window: seconds after a membership change during which
    #: CHT-routed EFFECTFUL calls double-dispatch to the union of old
    #: and new ring owners; idempotent reads fail over new->old instead
    handoff_window: float = 15.0
    #: --event-capacity: event journal depth at the proxy hop (breaker
    #: transitions, SLO edges); 0 disables emission
    event_capacity: int = 2048
    #: --incident-window: debounce window (seconds) of the automatic
    #: incident bundles at the proxy hop (0 disables auto-capture)
    incident_window: float = 300.0
    #: --incident-dir: capped bundle artifacts dir; empty = under /tmp
    #: keyed by the bound port, as the JAX proxy's
    incident_dir: str = ""
    #: --usage-top: exact per-principal ledger rows at the proxy hop
    #: (utils/usage.py); 0 disables the ledger
    usage_top: int = 64
    #: --usage-gauge-principals: top-N principals published as
    #: usage.<principal>.* gauges each telemetry tick
    usage_gauge_principals: int = 8

    @property
    def bind_host(self) -> str:
        return self.listen_addr or "0.0.0.0"

    def flags_status(self) -> Dict[str, Any]:
        return {f"argv.{f.name}": getattr(self, f.name)
                for f in dataclasses.fields(self)}


class MemberCache:
    """Watch-invalidated actives cache (≙ cached_zk, common/cached_zk.hpp:
    31-59): one entry per cluster name, cleared when the coordinator signals
    a child change, with a TTL backstop for coordinators whose watches are
    best-effort. ``on_invalidate``, when set, is called after each
    clearing (the proxy's relay refresher wakes on it)."""

    def __init__(self, coord: Coordinator, engine: str, ttl: float = 2.0) -> None:
        self._coord = coord
        self._engine = engine
        self._ttl = ttl
        self._lock = threading.Lock()
        self._cache: Dict[str, Tuple[float, List[NodeInfo]]] = {}
        self._watched: set = set()
        self.on_invalidate: Optional[Callable[[], None]] = None

    def actives(self, name: str) -> List[NodeInfo]:
        now = time.monotonic()
        with self._lock:
            hit = self._cache.get(name)
            if hit is not None and now - hit[0] < self._ttl:
                return hit[1]
        nodes = membership.get_all_actives(self._coord, self._engine, name)
        with self._lock:
            self._cache[name] = (now, nodes)
            need_watch = name not in self._watched
            if need_watch:
                self._watched.add(name)
        if need_watch:  # outside the lock: watchers may fire synchronously
            path = f"{membership.actor_path(self._engine, name)}/actives"
            try:
                self._coord.watch_children(path, lambda _p, n=name: self.invalidate(n))
            except NotImplementedError:
                pass
        return nodes

    def invalidate(self, name: str) -> None:
        with self._lock:
            self._cache.pop(name, None)
        if self.on_invalidate is not None:
            self.on_invalidate()


def _peek_cluster_name(raw_params: bytes) -> Optional[str]:
    """First element of the params array when it is a string — WITHOUT
    feeding the (possibly multi-megabyte) span through an unpacker copy.
    None for any other wire shape."""
    try:
        t = raw_params[0]
        if 0x90 <= t <= 0x9F:
            if t == 0x90:
                return None
            i = 1
        elif t == 0xDC:
            if int.from_bytes(raw_params[1:3], "big") < 1:
                return None
            i = 3
        elif t == 0xDD:
            if int.from_bytes(raw_params[1:5], "big") < 1:
                return None
            i = 5
        else:
            return None
        t = raw_params[i]
        if 0xA0 <= t <= 0xBF:
            n, i = t & 0x1F, i + 1
        elif t == 0xD9:
            n, i = raw_params[i + 1], i + 2
        elif t == 0xDA:
            n, i = int.from_bytes(raw_params[i + 1:i + 3], "big"), i + 3
        else:
            return None
        return raw_params[i:i + n].decode("utf-8", "surrogateescape")
    except (IndexError, ValueError):
        return None


class _Session:
    __slots__ = ("client", "last_used")

    def __init__(self, client: RpcClient) -> None:
        self.client = client
        self.last_used = time.monotonic()


class Proxy:
    """One engine's routing proxy. start → join → stop, like the servers."""

    def __init__(self, args: ProxyArgs, coord: Optional[Coordinator] = None) -> None:
        if not args.engine:
            raise ValueError("ProxyArgs.engine required")
        self.args = args
        self.engine = args.engine
        self.coord = coord or create_coordinator(args.coordinator)
        self.members = MemberCache(self.coord, self.engine)
        # the engine servers' transport: the C++ front-end unless
        # JUBATUS_TPU_NATIVE_RPC=0 (a failed build raises here)
        self.rpc = create_rpc_server(legacy_wire=args.legacy_wire,
                                     wire_detect=not args.modern_wire)
        self.start_time = time.time()  # wall-clock
        self._pool: Dict[Tuple[str, int], List[_Session]] = {}
        self._pool_lock = threading.Lock()
        self._last_expiry = 0.0
        self._executor = ThreadPoolExecutor(
            max_workers=max(8, args.thread * 4), thread_name_prefix="proxy-fanout"
        )
        self._stop_event = threading.Event()
        # counters (proxy_common.cpp:126-182)
        self._counters_lock = threading.Lock()
        self.request_counts: Dict[str, int] = {}
        self.forward_count = 0
        self.forward_errors = 0
        #: per-backend breakers + the failover retry budget; transitions
        #: count into the proxy's own registry (proxy.breaker_open /
        #: proxy.breaker_close)
        self.breakers = BreakerBoard(
            window_sec=args.breaker_window,
            failure_threshold=args.breaker_failures,
            cooldown_sec=args.breaker_cooldown,
            registry=self.rpc.trace, counter_prefix="proxy.breaker")
        self.retry_budget = RetryBudget(ratio=args.retry_budget_ratio)
        self._idempotent = idempotent_methods(self.engine)
        #: member-list-keyed ring cache + the double-dispatch window
        self.rings = _RingCache(handoff_window=args.handoff_window)
        #: the C++ relay plane (native transport only): the random-routed
        #: methods it forwards, and the clusters seen on the Python path
        #: (cluster -> when it last had actives); the refresher thread
        #: keeps the C++ routing table to their current actives
        self._relay_methods: List[str] = []
        self._relay_seen: Dict[str, float] = {}
        self._relay_lock = threading.Lock()
        #: set when a cluster's actives change: the refresher pushes the
        #: new table then, not only on its 1 s tick
        self._relay_wake = threading.Event()
        self.members.on_invalidate = self._relay_wake.set
        #: the /metrics + /healthz endpoint, with --metrics-port >= 0
        self.metrics = None
        self._init_planes()
        self._register_methods()

    def _init_planes(self) -> None:
        """The observability planes at the proxy hop, from their flags
        (jubatus_tpu/server/proxy.py:366-447): the slow-request ring, the
        runtime telemetry sampler, the stack sampler and its tail
        trigger, the time series and SLOs, the event journal and incident
        bundles, the usage ledger. None reads the card: the proxy has no
        device work, and no capture is made here."""
        args = self.args
        self.rpc.trace.slowlog.configure(capacity=args.slowlog_capacity,
                                         quantile=args.slowlog_quantile,
                                         min_count=args.slowlog_min_count)
        self.telemetry = RuntimeTelemetry(
            self.rpc.trace, interval_sec=args.telemetry_interval)
        self.profiler = SamplingProfiler(self.rpc.trace, hz=args.profile_hz)
        if args.profile_trigger_breaches > 0 and self.profiler.enabled:
            self.rpc.trace.slowlog.set_trigger(
                self.profiler.tail_snapshot,
                breaches=args.profile_trigger_breaches,
                window_s=args.profile_trigger_window)
        interval = self.telemetry.interval_sec
        self.timeseries: Optional[TimeSeriesRing] = None
        self.slo: Optional[SloEngine] = None
        if args.timeseries_capacity > 0:
            self.timeseries = TimeSeriesRing(
                capacity=args.timeseries_capacity,
                min_spacing_s=min(1.0, interval / 2) if interval > 0
                else 0.0)
            self.slo = SloEngine(
                [parse_slo(spec) for spec in args.slo or []],
                self.timeseries, self.rpc.trace,
                fast_window_s=args.slo_fast_window,
                slow_window_s=args.slo_slow_window,
                burn_threshold=args.slo_burn_threshold)
            self.telemetry.hooks.append(self._model_health_tick)
        self.rpc.trace.events.set_capacity(args.event_capacity)
        self.incidents = IncidentManager(
            self.rpc.trace, self._incident_state, self._incident_dir,
            window_s=args.incident_window, journal=self.rpc.trace.events)
        if self.slo is not None:
            self.slo.on_fire = self._on_slo_fire
        # the proxy is in the request path: its own ledger bills each
        # forward's dispatch span and bytes to the caller's principal
        # (the RPC server accounts the raw relay and the decoded path
        # alike), and jubactl -c usage folds it with the backends'
        self.usage: Optional[usage_mod.UsageLedger] = None
        if args.usage_top > 0:
            self.usage = usage_mod.UsageLedger(
                top=args.usage_top,
                gauge_principals=args.usage_gauge_principals,
                registry=self.rpc.trace)
            self.rpc.usage_recorder = self.usage
            self.rpc.trace.usage_sink = self.usage.span_sink
            usage_mod.attach(self.usage)
        self._was_degraded = False
        #: the incident collector reads _health(), whose telemetry.status()
        #: may run the sampler hooks again: the tick must not recurse
        self._in_health_tick = False

    # -- session pool (proxy.hpp:502-593) ------------------------------------
    # Borrow/return: each in-flight forward owns a connection, so N
    # concurrent client calls ride N parallel backend connections instead
    # of serializing their round trips through one socket. ``self._pool``
    # holds IDLE sessions.
    def _checkout(self, node: NodeInfo) -> _Session:
        key = (node.host, node.port)
        with self._pool_lock:
            lst = self._pool.get(key)
            if lst:
                return lst.pop()
        # the proxy's backend clients do NOT retry at the client layer:
        # the proxy owns failover ACROSS replicas (same budget, better
        # spread) — stacked same-host retries would multiply tail latency
        return _Session(RpcClient(node.host, node.port,
                                  timeout=self.args.interconnect_timeout,
                                  retry_methods=frozenset(),
                                  registry=self.rpc.trace))

    def _checkin(self, node: NodeInfo, sess: _Session) -> None:
        sess.last_used = time.monotonic()
        with self._pool_lock:
            self._pool.setdefault((node.host, node.port), []).append(sess)

    def _expire_sessions(self) -> None:
        # throttled: expiry precision is seconds (pool_expire defaults to
        # 60 s); walking the pool under its lock on EVERY forward is pure
        # hot-path tax
        now = time.monotonic()
        if now - self._last_expiry < 1.0:
            return
        self._last_expiry = now
        horizon = now - self.args.session_pool_expire
        dead: List[_Session] = []
        with self._pool_lock:
            for key, lst in list(self._pool.items()):
                keep = [s for s in lst if s.last_used >= horizon]
                dead.extend(s for s in lst if s.last_used < horizon)
                if keep:
                    self._pool[key] = keep
                else:
                    del self._pool[key]
            if self.args.session_pool_size > 0:
                flat = sorted(
                    ((s.last_used, key, s)
                     for key, lst in self._pool.items() for s in lst),
                    key=lambda e: e[0])
                excess = len(flat) - self.args.session_pool_size
                for _, key, s in flat[:max(0, excess)]:
                    self._pool[key].remove(s)
                    dead.append(s)
                for key in [k for k, v in self._pool.items() if not v]:
                    del self._pool[key]
        for s in dead:
            s.client.close()

    def _drop_sessions(self, node: NodeInfo) -> None:
        """A backend failed: close its idle sessions (in-flight ones die
        with their own errors)."""
        with self._pool_lock:
            lst = self._pool.pop((node.host, node.port), [])
        for s in lst:
            s.client.close()

    # -- fan-out core (async_task, proxy.hpp:296-495) ------------------------
    def _fan(
        self,
        nodes: Sequence[NodeInfo],
        method: str,
        args: Sequence[Any],
        reducer: Callable[[Any, Any], Any],
    ) -> Any:
        """Call all nodes in parallel; fold successes left-to-right through
        the reducer; per-host errors are tolerated unless every host fails
        (proxy.hpp:325-392). The whole collection runs against ONE shared
        deadline — a single hung backend costs the broadcast one budget,
        not N serial budgets; stragglers are abandoned and counted."""
        if not nodes:
            raise RpcNoClient(f"no active {self.engine} servers")
        with self._counters_lock:
            self.forward_count += len(nodes)
        if len(nodes) == 1:
            return self._one(nodes[0], method, args)
        # the fan-out hops threads: carry this request's trace context,
        # deadline AND principal into the executor so each backend call
        # ships the same trace id, derives its timeout from the remaining
        # budget, and bills the same tenant
        ctx = tracing.current_trace()
        dl = deadlines.current()
        pr = principals.current()

        def call(n: NodeInfo) -> Any:
            with tracing.use_trace(ctx), deadlines.use(dl), \
                    principals.use(pr):
                return self._one(n, method, args)

        futs: Dict[Any, NodeInfo] = {
            self._executor.submit(call, n): n for n in nodes}
        budget = self.args.timeout + 1.0
        rem = deadlines.remaining()
        if rem is not None:
            budget = min(budget, max(rem, 0.0))
        done, pending = futures_wait(futs, timeout=budget)
        results: List[Any] = []
        errors: List[HostError] = []
        # iterate in submission order (dict preserves it): the reducer
        # fold stays deterministic even though completion order isn't
        for fut, n in futs.items():
            if fut in pending:
                fut.cancel()  # abandon: result (if any) is discarded
                errors.append(HostError(
                    n.host, n.port,
                    RpcTimeoutError(f"{method} @ {n.host}:{n.port}: "
                                    "fanout deadline")))
                continue
            try:
                results.append(fut.result())
            except Exception as e:  # broad-ok — per-host failure is data
                errors.append(HostError(n.host, n.port, e))
        if pending:
            self.rpc.trace.count("proxy.fanout_timeouts", len(pending))
        if errors:
            with self._counters_lock:
                self.forward_errors += len(errors)
        if not results:
            raise MultiRpcError(errors) if errors else RpcNoResult(method)
        acc = results[0]
        for r in results[1:]:
            acc = reducer(acc, r)
        return acc

    def _one(self, node: NodeInfo, method: str, args: Sequence[Any]) -> Any:
        """One forwarded call, feeding the backend's breaker: transport
        failures tear the node's sessions down and count against it;
        application errors prove the backend alive."""
        key = (node.host, node.port)
        sess = self._checkout(node)
        try:
            result = sess.client.call(method, *args)
        except _TRANSPORT_ERRORS:
            # dead/unreachable backend: close this session, drop its idle
            # siblings, feed the breaker, and let the caller decide
            sess.client.close()
            self._drop_sessions(node)
            self.breakers.record(key, False)
            raise
        except DeadlineExceeded:
            # the CALLER's budget ran out — no evidence about the backend
            sess.client.close()
            raise
        except Exception:  # broad-ok — app error from a healthy backend
            self._checkin(node, sess)
            self.breakers.record(key, True)
            raise
        self._checkin(node, sess)
        self.breakers.record(key, True)
        return result

    # -- routing handlers (register_async_{random,broadcast,cht}) -------------
    def _count(self, method: str) -> None:
        with self._counters_lock:
            self.request_counts[method] = self.request_counts.get(method, 0) + 1

    def _route_candidates(self, nodes: Sequence[NodeInfo]) -> List[NodeInfo]:
        """Breaker-aware filter (peek only — the probe slot is claimed by
        ``allow`` on the node actually called): open backends drop out of
        routing; if EVERY candidate is open, fail static (route anyway —
        refusing all traffic would turn a breaker bug into an outage)."""
        allowed = [n for n in nodes
                   if self.breakers.available((n.host, n.port))]
        if allowed:
            return allowed
        if nodes:
            self.rpc.trace.count("proxy.breaker_fail_static")
        return list(nodes)

    def _call_random(self, name: str, actives: Sequence[NodeInfo],
                     params: Sequence[Any]) -> Any:
        """Random routing with breaker-aware selection and idempotent
        failover: a read that hits a transport failure moves to the next
        active replica (budget-gated); an effectful call propagates its
        first failure — re-forwarding could double-apply."""
        if not actives:
            raise RpcNoClient(f"no active {self.engine} servers")
        candidates = self._route_candidates(actives)
        random.shuffle(candidates)
        idem = name in self._idempotent
        last: Optional[BaseException] = None
        tried = 0
        for node in candidates:
            if not self.breakers.allow((node.host, node.port)):
                continue  # half-open probe slot already taken
            tried += 1
            with self._counters_lock:
                self.forward_count += 1
            try:
                return self._one(node, name, params)
            except _MEMBERSHIP_ERRORS as e:
                # pre-apply rejection (draining backend): move to the
                # next replica regardless of idempotency — nothing was
                # applied. Refresh so the NEXT request routes clean.
                self._refresh_members(str(params[0]))
                last = e
                continue
            except _TRANSPORT_ERRORS as e:
                with self._counters_lock:
                    self.forward_errors += 1
                last = e
                if not idem:
                    raise
                rem = deadlines.remaining()
                if rem is not None and rem <= 0:
                    raise
                if not self.retry_budget.try_withdraw():
                    self.rpc.trace.count("rpc.retry_budget_exhausted")
                    raise
                self.rpc.trace.count("rpc.retries")
                continue
        if last is not None:
            raise last
        if not tried:
            # every candidate refused (all half-open with a probe in
            # flight): force one attempt rather than failing closed
            node = random.choice(list(candidates))
            with self._counters_lock:
                self.forward_count += 1
            try:
                return self._one(node, name, params)
            except _TRANSPORT_ERRORS:
                with self._counters_lock:
                    self.forward_errors += 1
                raise
        raise RpcNoClient(f"no active {self.engine} servers")

    #: clusters with no actives for this long fall out of the relay table
    #: and the seen-set: client-supplied names must not grow state without
    #: bound (a mistyped cluster costs one window, not forever)
    _RELAY_SEEN_TTL = 60.0
    _RELAY_SEEN_CAP = 1024

    def _note_cluster(self, cluster: str) -> None:
        """A cluster seen on the Python path enters the relay table at the
        refresher's next tick; after that its random-routed traffic is
        forwarded in C++."""
        with self._relay_lock:
            if cluster not in self._relay_seen and \
                    len(self._relay_seen) >= self._RELAY_SEEN_CAP:
                return  # a flood of bogus names relays nothing anyway
            self._relay_seen.setdefault(cluster, time.monotonic())

    def _relay_refresher(self) -> None:
        """Every second, and at once when a cluster's actives change (the
        member cache's watch), push the current actives of every cluster
        seen to the C++ relay, replacing the table wholesale (a
        de-registered backend's pipes retire with the table's generation).
        The JAX proxy pushes on its tick alone; waking on the watch drops
        a draining member from the table within the watch's latency,
        before its handoff ends and it exits. A cluster whose lookup FAILS
        keeps its last routing (a coordinator hiccup must not bounce
        traffic to the Python path); one that stays EMPTY past the TTL is
        dropped. Backends with an OPEN breaker are withheld, as the Python
        path skips them (all open: route anyway, fail static)."""
        last_table: Dict[str, List[Tuple[str, int]]] = {}
        while not self._stop_event.is_set():
            self._relay_wake.wait(1.0)
            self._relay_wake.clear()
            if self._stop_event.is_set():
                return
            with self._relay_lock:
                seen = dict(self._relay_seen)
            if not seen:
                continue
            now = time.monotonic()
            table: Dict[str, List[Tuple[str, int]]] = {}
            expired = []
            for cluster, last_live in seen.items():
                try:
                    nodes = [(n.host, n.port)
                             for n in self.members.actives(cluster)]
                except Exception:  # broad-ok — carry the last known
                    log.debug("relay refresh failed for %s", cluster,
                              exc_info=True)
                    nodes = last_table.get(cluster, [])
                if nodes:
                    healthy = [k for k in nodes
                               if self.breakers.available(k)]
                    table[cluster] = healthy or nodes
                    with self._relay_lock:
                        if cluster in self._relay_seen:
                            self._relay_seen[cluster] = now
                elif now - last_live > self._RELAY_SEEN_TTL:
                    expired.append(cluster)
            if expired:
                with self._relay_lock:
                    for cluster in expired:
                        self._relay_seen.pop(cluster, None)
            last_table = table
            try:
                self.rpc.relay_config(
                    self._relay_methods, table,
                    timeout=self.args.interconnect_timeout,
                    idle_expire=self.args.session_pool_expire)
            except Exception:  # broad-ok — the next tick retries
                log.debug("relay config push failed", exc_info=True)

    def _route_cht(self, name: str, cht_n: int,
                   reducer: Callable[[Any, Any], Any],
                   cluster: str, actives: Sequence[NodeInfo],
                   params: Sequence[Any]) -> Any:
        """CHT routing over the CACHED ring (rebuilt only on membership
        change). Inside the handoff window after a change:

        - EFFECTFUL calls double-dispatch to the UNION of old and new
          owners — no key has zero owners while rows migrate (the
          per-host-failure tolerance of ``_fan`` means one dead old
          owner cannot fail the call);
        - IDEMPOTENT reads try new owners first and fail over to the
          old ones — whichever actually holds the row answers (a row
          not yet migrated raises an app error on the new owner)."""
        key = str(params[1])
        ring, prev = self.rings.get(cluster, actives)
        nodes = ring.find(key, cht_n)
        if prev is None:
            return self._fan(self._route_candidates(nodes), name, params,
                             reducer)
        old_nodes = prev.find(key, cht_n)
        seen = {n.name for n in nodes}
        extra = [n for n in old_nodes if n.name not in seen]
        if name in self._idempotent:
            # reads: first owner (new ring first, then old) that answers
            last: Optional[BaseException] = None
            for node in list(nodes) + extra:
                with self._counters_lock:
                    self.forward_count += 1
                try:
                    return self._one(node, name, params)
                except Exception as e:  # broad-ok — try the next owner
                    last = e
            if last is not None:
                raise last
            raise RpcNoClient(f"no active {self.engine} servers")
        if extra:
            self.rpc.trace.count("proxy.double_dispatch")
        return self._fan(self._route_candidates(list(nodes) + extra),
                         name, params, reducer)

    def _handler(self, name: str, routing: str, cht_n: int,
                 reducer: Callable[[Any, Any], Any]) -> Callable[..., Any]:
        def handle_once(*params: Any) -> Any:
            actives = self.members.actives(str(params[0]))
            if routing == "broadcast":
                # writes must reach every member: breakers observe but
                # never skip a broadcast (a success even self-heals an
                # open breaker — proof of life)
                return self._fan(actives, name, params, reducer)
            if routing == "cht":
                if len(params) < 2:
                    raise TypeError(f"{name}: cht routing needs a key param")
                return self._route_cht(name, cht_n, reducer,
                                       str(params[0]), actives, params)
            # random (proxy.hpp:229-247) + breaker skip + idempotent
            # failover
            return self._call_random(name, actives, params)

        def handle(*params: Any) -> Any:
            if params and isinstance(params[0], (str, bytes)):
                self._note_cluster(_text(params[0]))
            self._count(name)
            self._expire_sessions()
            try:
                return handle_once(*params)
            except Exception as e:  # broad-ok — refined below, re-raised
                if not _membership_rejection(e):
                    raise
                # the backend(s) rejected BEFORE applying (draining /
                # stale ring): refresh the membership view and re-route
                # once — safe for effectful calls too
                self._refresh_members(str(params[0]))
                return handle_once(*params)

        return handle

    def _refresh_members(self, cluster: str) -> None:
        """A membership-protocol rejection means this proxy's ring view
        is stale: drop the actives cache (the ring cache revalidates by
        member-list key on the next lookup) and count the event."""
        self.members.invalidate(cluster)
        self.rpc.trace.count("proxy.ring_refresh")

    def _raw_handler(self, name: str) -> Callable[[bytes], Any]:
        """Zero-decode relay for RANDOM-routed methods: forward the raw
        params span to one backend and splice its raw result span into the
        response (rpc/server.py RawResult) — the multi-megabyte train/
        classify payloads never materialize as Python objects at the
        proxy, matching the reference proxy's C++ forwarding cost shape
        (proxy.hpp:64-186). Anything irregular (no actives, undecodable
        name) declines to the generic path, which owns the error taxonomy.
        Breaker-aware like the generic path: open backends are skipped,
        and IDEMPOTENT methods fail over to the next replica on a
        transport failure."""
        idem = name in self._idempotent

        def handle(raw_params: bytes) -> Any:
            cluster = _peek_cluster_name(raw_params)
            if cluster is None:
                return RAW_FALLBACK  # odd wire: generic path decides
            self._note_cluster(cluster)
            self._expire_sessions()
            actives = self.members.actives(cluster)
            if not actives:
                return RAW_FALLBACK  # generic path raises RpcNoClient
            # counted only once we own the request: every RAW_FALLBACK
            # re-enters the generic handler, which counts it there
            self._count(name)
            candidates = self._route_candidates(actives)
            random.shuffle(candidates)
            last: Optional[BaseException] = None
            tried = 0
            for node in candidates:
                key = (node.host, node.port)
                if not self.breakers.allow(key):
                    continue
                tried += 1
                with self._counters_lock:
                    self.forward_count += 1
                sess = self._checkout(node)
                try:
                    span = sess.client.call_raw(name, raw_params)
                except _TRANSPORT_ERRORS as e:
                    # transport failure AFTER the request may have reached
                    # the backend: for an EFFECTFUL method a silent
                    # re-forward would double-apply a train batch, so
                    # propagate — reads fail over to the next replica.
                    # Tear the node's sessions down either way.
                    sess.client.close()
                    self._drop_sessions(node)
                    self.breakers.record(key, False)
                    with self._counters_lock:
                        self.forward_errors += 1
                    if not idem:
                        raise
                    rem = deadlines.remaining()
                    if rem is not None and rem <= 0:
                        raise
                    if not self.retry_budget.try_withdraw():
                        self.rpc.trace.count("rpc.retry_budget_exhausted")
                        raise
                    self.rpc.trace.count("rpc.retries")
                    last = e
                    continue
                except DeadlineExceeded:
                    sess.client.close()
                    raise
                except _MEMBERSHIP_ERRORS as e:
                    # the backend refused BEFORE applying (draining):
                    # healthy connection, so pool it — then move to the
                    # next replica regardless of idempotency
                    self._checkin(node, sess)
                    self.breakers.record(key, True)
                    self._refresh_members(cluster)
                    last = e
                    continue
                except Exception:  # broad-ok — app error: backend alive
                    # application error from a HEALTHY backend (non-nil
                    # error span): the connection read the full response —
                    # return it to the pool and relay the error as-is
                    self._checkin(node, sess)
                    self.breakers.record(key, True)
                    raise
                self._checkin(node, sess)
                self.breakers.record(key, True)
                return RawResult(span)
            if last is not None:
                raise last
            if not tried:
                return RAW_FALLBACK  # all probes busy: generic path decides
            raise RpcNoClient(f"no active {self.engine} servers")

        return handle

    def _register(self, name: str, arity: int, routing: str,
                  reducer: Callable[[Any, Any], Any], cht_n: int = 2) -> None:
        self.rpc.register(name, self._handler(name, routing, cht_n, reducer),
                          arity=arity)
        if routing == "random":
            self.rpc.register_raw(name, self._raw_handler(name))
            self._relay_methods.append(name)

    def _register_methods(self) -> None:
        for m in get_service(self.engine):
            if m.routing == INTERNAL:
                continue  # create_node_here etc. are server↔server only
            self._register(m.name, len(m.args) + 1, m.routing,
                           aggregators.BY_NAME.get(m.aggregator, aggregators.pass_),
                           m.cht_n)
        # built-ins (proxy.cpp:43-66; get_config routes like any analysis call)
        self._register("get_config", 1, "random", aggregators.pass_)
        self._register("save", 2, "broadcast", aggregators.merge)
        self._register("load", 2, "broadcast", aggregators.all_and)
        self._register("get_status", 1, "broadcast", aggregators.merge)
        self._register("get_metrics", 1, "broadcast", aggregators.merge)
        self._register("get_mix_history", 1, "broadcast", aggregators.concat)
        # the forensics views: broadcast, then the proxy's own record
        # folded in, so one call returns every hop (name, own, arity)
        for name, own, arity in (
                ("get_spans", self.get_proxy_spans, 2),
                ("get_slow_log", self.get_proxy_slow_log, 1),
                ("get_timeseries", self.get_proxy_timeseries, 1),
                ("get_alerts", self.get_proxy_alerts, 1),
                ("get_quality", self.get_proxy_quality, 1),
                ("get_usage", self.get_proxy_usage, 1),
                ("get_profile", self.get_proxy_profile, 2),
                ("get_events", self.get_proxy_events, 3),
                ("get_incidents", self.get_proxy_incidents, 2)):
            self.rpc.register(name, self._forensics_handler(name, own),
                              arity=arity)
            self.rpc.register(name.replace("get_", "get_proxy_", 1), own,
                              arity=arity)
        # a device capture on every backend (jubactl -c profile --device)
        self._register("profile_device", 2, "broadcast", aggregators.merge)
        self._register("do_mix", 1, "random", aggregators.pass_)
        # ring-version probe routes like any read (all backends agree
        # modulo watch latency)
        self._register("get_epoch", 1, "random", aggregators.pass_)
        self.rpc.register("get_proxy_status", self.get_proxy_status, arity=1)
        self.rpc.register("get_proxy_metrics", self.get_metrics, arity=1)
        self.rpc.register("get_breakers", self.get_breakers, arity=1)

    def _forensics_handler(self, name: str,
                           own_fn: Callable[..., Dict[str, Any]]
                           ) -> Callable[..., Dict[str, Any]]:
        """Broadcast ``name`` to the backends and fold the proxy's own
        record in. Backend failures (no actives, a partial cluster)
        degrade to whatever answered plus the proxy's view: a forensics
        query against a sick cluster is when partial data matters most."""
        fan = self._handler(name, "broadcast", 2, aggregators.merge)

        def handle(*params: Any) -> Dict[str, Any]:
            out: Dict[str, Any] = {}
            try:
                folded = fan(*params)
                if isinstance(folded, dict):
                    out.update(folded)
            except Exception:  # broad-ok — partial forensics beat none
                log.debug("%s backend broadcast failed", name,
                          exc_info=True)
            out.update(own_fn(*params))
            return out

        return handle

    # -- own status (proxy_common::get_status) --------------------------------
    def _node(self) -> NodeInfo:
        return NodeInfo(self.args.bind_host, self.rpc.port or self.args.rpc_port)

    def get_proxy_spans(self, _name: str = "",
                        trace_id: str = "") -> Dict[str, Any]:
        """This proxy's own span records of one trace (its dispatch and
        per-backend client-call spans), keyed by proxy node name."""
        return {self._node().name: self.rpc.trace.get_spans(_text(trace_id))}

    def get_proxy_slow_log(self, _name: str = "") -> Dict[str, Any]:
        """This proxy's slow-request ring."""
        return {self._node().name: self.rpc.trace.slowlog.snapshot()}

    def get_proxy_timeseries(self, _name: str = "") -> Dict[str, Any]:
        """This proxy's metric time-series ring: its stats and points."""
        if self.timeseries is None:
            return {self._node().name: {"stats": {}, "points": []}}
        return {self._node().name: {"stats": self.timeseries.stats(),
                                    "points": self.timeseries.points()}}

    def get_proxy_alerts(self, _name: str = "") -> Dict[str, Any]:
        """This proxy's SLO state: firing alerts and burn rates."""
        if self.slo is None:
            return {self._node().name: {"alerts": [], "slos": []}}
        return {self._node().name: {"alerts": self.slo.alerts(),
                                    "slos": self.slo.status()}}

    def get_proxy_quality(self, _name: str = "") -> Dict[str, Any]:
        """The proxy hop has no train path, so no quality doc of its
        own: the routed ``get_quality`` is the backends' fold alone."""
        return {}

    def get_proxy_usage(self, _name: str = "") -> Dict[str, Any]:
        """This proxy's per-tenant ledger doc (every forward dispatches
        here, so the hop has real cost to report)."""
        if self.usage is None:
            return {self._node().name: {}}
        return {self._node().name: self.usage.snapshot()}

    def get_proxy_profile(self, _name: str = "",
                          seconds: float = 0.0) -> Dict[str, Any]:
        """This proxy's folded stack profile over the last ``seconds``."""
        return {self._node().name: self.profiler.profile(
            float(seconds or 0.0))}

    def get_proxy_events(self, _name: str = "", since: int = 0,
                         grep: str = "") -> Dict[str, Any]:
        """This proxy's event journal (breaker transitions, SLO edges)
        merged with the process default journal, after the HLC ``since``
        and filtered by ``grep``."""
        since = int(since or 0)
        grep = _text(grep) if grep else ""
        recs = events.merge_events([
            self.rpc.trace.events.snapshot(since=since, grep=grep),
            events.default_journal().snapshot(since=since, grep=grep)])
        return {self._node().name: {"events": recs,
                                    "hlc_now": events.hlc_now(),
                                    "stats": self.rpc.trace.events.stats()}}

    def get_proxy_incidents(self, _name: str = "",
                            incident_id: str = "") -> Dict[str, Any]:
        """This proxy's incident bundles: an empty id lists them, an id
        returns that bundle's document."""
        incident_id = _text(incident_id) if incident_id else ""
        if incident_id:
            return {self._node().name: self.incidents.get(incident_id)}
        return {self._node().name: self.incidents.list()}

    def get_metrics(self, _name: str = "") -> Dict[str, Dict[str, Any]]:
        """This proxy's own mergeable metrics snapshot (the routed
        ``get_metrics`` broadcasts to the backends instead)."""
        return {self._node().name: self.rpc.trace.snapshot()}

    # -- model health, events and incidents at the proxy hop ------------------
    def _model_health_tick(self) -> None:
        """One telemetry tick: the usage demand (capacity 0: a proxy has
        no device plane), a ring sample, the SLOs, and an incident when
        /healthz goes from ok to degraded."""
        if self.timeseries is None or self._in_health_tick:
            return
        self._in_health_tick = True
        try:
            if self.usage is not None:
                self.usage.tick(0.0)
            self.timeseries.sample(self.rpc.trace.snapshot())
            if self.slo is not None:
                self.slo.evaluate()
            degraded = bool(self._health().get("degraded_reasons"))
            if degraded and not self._was_degraded:
                self.incidents.trigger("healthz_degraded")
            self._was_degraded = degraded
        finally:
            self._in_health_tick = False

    def _incident_dir(self) -> str:
        return self.args.incident_dir or os.path.join(
            "/tmp", f"jubatus_incidents_{self.engine}_proxy_"
            f"{self.rpc.port or self.args.rpc_port}")

    def _on_slo_fire(self, name: str, _state: Dict[str, Any]) -> None:
        """An SLO went to firing: one bundle, seeded with the breaching
        trace ids of the slow log."""
        ids = [r.get("trace_id", "")
               for r in self.rpc.trace.slowlog.snapshot(last=16)]
        self.incidents.trigger(f"slo_firing:{name}",
                               trace_ids=[t for t in ids if t][-8:])

    def _incident_state(self) -> Dict[str, Any]:
        """What one proxy bundle holds: events, the slow log, the
        per-backend breakers, the health verdict, the usage slice, the
        time-series window and the profiler's tail."""
        doc: Dict[str, Any] = {
            "node": self._node().name,
            "events": events.merge_events([
                self.rpc.trace.events.snapshot(limit=256),
                events.default_journal().snapshot(limit=64)]),
            "slow_log": self.rpc.trace.slowlog.snapshot(last=64),
            "breakers": self.breakers.snapshot(),
            "health": self._health(),
        }
        if self.usage is not None:
            doc["usage"] = self.usage.incident_doc()
        if self.timeseries is not None:
            doc["timeseries"] = self.timeseries.points(last=60)
        try:
            prof = self.profiler.profile(30.0)
            folded = prof.get("folded") or {}
            top = dict(sorted(folded.items(), key=lambda kv: -kv[1])[:50])
            doc["profile"] = {"folded_top": top,
                              "snapshots": prof.get("snapshots") or [],
                              "stats": prof.get("stats") or {}}
        except Exception:  # broad-ok — a sick profiler must not block capture
            log.debug("incident profile fold failed", exc_info=True)
        return doc

    def _health(self) -> Dict[str, Any]:
        """The /healthz document: open backend breakers and firing SLOs
        as structured degraded reasons, the servers' shape."""
        with self._counters_lock:
            fwd, errs = self.forward_count, self.forward_errors
        breakers = self.breakers.snapshot()
        reasons: List[Dict[str, Any]] = []
        open_backends = sorted(
            str(k) for k, b in breakers.items() if b["state"] == "open")
        if open_backends:
            reasons.append({"kind": "breaker_open",
                            "count": len(open_backends),
                            "backends": open_backends})
        if self.slo is not None:
            for a in self.slo.alerts():
                reasons.append({"kind": "slo_firing", "name": a["name"],
                                "burn_fast": a.get("burn_fast"),
                                "burn_slow": a.get("burn_slow")})
        doc = {"engine": f"{self.engine}_proxy",
               "status": "degraded" if reasons else "ok",
               "degraded_reasons": reasons,
               "uptime_s": int(time.time() - self.start_time),  # wall-clock
               "rpc_port": self.rpc.port or self.args.rpc_port,
               "forward_count": fwd, "forward_errors": errs,
               "breaker_open": len(open_backends)}
        pstats = self.profiler.stats()
        doc["profiler_hz"] = pstats["hz"]
        doc["profiler_samples"] = pstats["samples"]
        rt = self.telemetry.status()
        for k in ("rss_bytes", "open_fds", "threads", "slowlog_depth"):
            if k in rt:
                doc[k] = rt[k]
        return doc

    def get_breakers(self, _name: str = "") -> Dict[str, Dict[str, Any]]:
        """Breaker + retry-budget state, keyed by proxy node name — the
        ``jubactl -c breakers`` view."""
        return {self._node().name: {
            "breakers": self.breakers.snapshot(),
            "retry_budget": self.retry_budget.status(),
        }}

    def get_proxy_status(self, _name: str = "") -> Dict[str, Dict[str, Any]]:
        """This proxy's counters (the JAX proxy's keys): requests per
        method, forwards and forward errors, the requests the C++ relay
        served (``relay_count``, also folded into ``forward_count``,
        ``request.<method>`` and, for its synthesized backend-loss
        answers, ``forward_errors``; 0 on the Python transport, whose raw
        relay counts as a forward), the session pool, the breakers, the
        ring cache, the retry budget, the flags, the dispatch spans and
        counters of its registry, and the planes' ``runtime.*``,
        ``slowlog.*``, ``profiler.*``, ``events.*``, ``incident.*`` and
        ``usage.*`` rows."""
        relayed: Dict[str, int] = {}
        if isinstance(self.rpc, NativeRpcServer):
            try:
                relayed = self.rpc.relay_stats()
            except Exception:  # broad-ok — status must never fail
                log.debug("relay stats fetch failed", exc_info=True)
        relay_errors = relayed.pop("__errors__", 0)
        n_relayed = sum(relayed.values())
        breakers = self.breakers.snapshot()
        with self._counters_lock, self._pool_lock:
            st: Dict[str, Any] = {
                "timestamp": int(time.time()),  # wall-clock
                "uptime": int(time.time() - self.start_time),  # wall-clock
                "type": f"{self.engine}_proxy",
                "version": __version__,
                "forward_count": self.forward_count + n_relayed,
                "forward_errors": self.forward_errors + relay_errors,
                "relay_count": n_relayed,
                "session_pool_size": sum(
                    len(v) for v in self._pool.values()),
            }
            counts = dict(self.request_counts)
            for m, c in relayed.items():
                counts[m] = counts.get(m, 0) + c
            st.update({f"request.{k}": v for k, v in counts.items()})
        st["breaker_backends"] = len(breakers)
        st["breaker_open"] = sum(
            1 for b in breakers.values() if b["state"] == "open")
        st["breaker_opened_total"] = sum(
            b["opened_total"] for b in breakers.values())
        for k, v in self.rings.stats().items():
            st[f"ring.{k}"] = v
        for k, v in self.retry_budget.status().items():
            st[f"retry_budget.{k}"] = v
        st.update(self.args.flags_status())
        st.update(self.rpc.trace.trace_status())
        for prefix, rows in (
                ("runtime", self.telemetry.status()),
                ("slowlog", self.rpc.trace.slowlog.stats()),
                ("profiler", self.profiler.stats()),
                ("events", self.rpc.trace.events.stats()),
                ("incident", self.incidents.stats()),
                ("usage", self.usage.stats() if self.usage is not None
                 else {})):
            st.update({f"{prefix}.{k}": v for k, v in rows.items()})
        return {self._node().name: st}

    # -- lifecycle ------------------------------------------------------------
    def start(self, port: Optional[int] = None) -> int:
        actual = self.rpc.serve_background(
            port if port is not None else self.args.rpc_port,
            nthreads=self.args.thread,
            host=self.args.bind_host,
        )
        self.args.rpc_port = actual
        # events carry this proxy's bound node name
        self.rpc.trace.events.node = NodeInfo(self.args.bind_host,
                                              actual).name
        self.telemetry.start()
        self.profiler.start()
        if isinstance(self.rpc, NativeRpcServer):
            threading.Thread(target=self._relay_refresher, daemon=True,
                             name="proxy-relay-refresh").start()
        if self.args.metrics_port >= 0:
            from jubatus_tpu_torch.utils.metrics_http import MetricsServer

            self.metrics = MetricsServer(
                self.rpc.trace,
                labels={"engine": f"{self.engine}_proxy",
                        "node": f"{self.args.bind_host}_{actual}"},
                health_fn=self._health, host=self.args.bind_host,
                port=self.args.metrics_port)
            self.args.metrics_port = self.metrics.start()
            log.info("proxy metrics endpoint on %s:%d", self.args.bind_host,
                     self.args.metrics_port)
        try:
            membership.register_proxy(self.coord, self.args.bind_host, actual)
        except Exception:  # broad-ok — registry is informational for proxies
            log.debug("proxy registration failed", exc_info=True)
        log.info("%s proxy listening on %s:%d", self.engine, self.args.bind_host, actual)
        return actual

    def join(self, timeout: Optional[float] = None) -> bool:
        return self._stop_event.wait(timeout)

    def stop(self) -> None:
        if self.usage is not None:
            usage_mod.detach(self.usage)
        self.rpc.stop()
        self.telemetry.stop()
        self.profiler.stop()
        if self.metrics is not None:
            try:
                self.metrics.stop()
            except Exception:  # broad-ok — teardown must finish
                log.debug("metrics endpoint stop failed", exc_info=True)
        with self._pool_lock:
            sessions = [s for lst in self._pool.values() for s in lst]
            self._pool.clear()
        for sess in sessions:
            sess.client.close()
        self._executor.shutdown(wait=False)
        self.coord.close()
        self._stop_event.set()
        self._relay_wake.set()


def _text(x: Any) -> str:
    return x.decode() if isinstance(x, bytes) else str(x)


def main(argv: Optional[List[str]] = None) -> int:
    """``python -m jubatus_tpu_torch.server.proxy <engine> -z <coord>
    [-p PORT]`` (≙ juba<engine>_proxy binaries)."""
    import argparse
    import signal
    import sys

    p = argparse.ArgumentParser(prog="jubatus_tpu_torch.server.proxy")
    p.add_argument("engine")
    p.add_argument("-p", "--rpc-port", type=int, default=9199)
    p.add_argument("-b", "--listen-addr", default="")
    p.add_argument("-c", "--thread", type=int, default=4)
    p.add_argument("-t", "--timeout", type=float, default=10.0)
    p.add_argument("-z", "--coordinator", required=True)
    p.add_argument("--interconnect-timeout", type=float, default=10.0)
    p.add_argument("--pool-expire", dest="session_pool_expire", type=float, default=60.0)
    p.add_argument("--pool-size", dest="session_pool_size", type=int, default=0)
    p.add_argument("--legacy-wire", action="store_true",
                   help="FORCE responses into the pre-str8/bin msgpack "
                        "format for unmodified legacy jubatus clients "
                        "(otherwise autodetected per connection)")
    p.add_argument("--modern-wire", action="store_true",
                   help="disable per-connection legacy-wire autodetection")
    p.add_argument("--metrics-port", type=int, default=-1,
                   help="serve Prometheus /metrics + /healthz on this "
                        "HTTP port (0 = ephemeral; default off)")
    p.add_argument("--breaker-failures", type=int, default=5,
                   help="transport failures within --breaker-window that "
                        "open a backend's circuit breaker")
    p.add_argument("--breaker-window", type=float, default=30.0)
    p.add_argument("--breaker-cooldown", type=float, default=5.0,
                   help="seconds an open breaker refuses traffic before "
                        "admitting a half-open probe")
    p.add_argument("--retry-budget-ratio", type=float, default=0.1,
                   help="failover retries allowed per first-attempt "
                        "forward (token bucket; 0 disables failover)")
    p.add_argument("--slowlog-capacity", type=int, default=256,
                   help="slow-request ring size at the proxy hop "
                        "(0 disables tail-based capture)")
    p.add_argument("--slowlog-quantile", type=float, default=0.99,
                   help="per-span histogram quantile at/above which a "
                        "forwarded request is captured in the slow log")
    p.add_argument("--slowlog-min-count", type=int, default=64,
                   help="samples a span needs before slow-log "
                        "thresholding starts")
    p.add_argument("--telemetry-interval", type=float, default=10.0,
                   help="runtime telemetry sampling period in seconds "
                        "(0 disables the sampler thread)")
    p.add_argument("--slo", action="append", default=None, metavar="SPEC",
                   help="declarative SLO at the proxy hop, evaluated as "
                        "a multi-window burn rate (repeatable; the "
                        "servers' grammar: latency:<span>:p<QQ>:"
                        "<threshold_ms>[:<objective>], error_rate:"
                        "<span|*>:<objective>, gauge:<key>:<ceiling>)")
    p.add_argument("--slo-fast-window", type=float, default=300.0,
                   help="fast burn-rate window in seconds")
    p.add_argument("--slo-slow-window", type=float, default=3600.0,
                   help="slow burn-rate window in seconds")
    p.add_argument("--slo-burn-threshold", type=float, default=2.0,
                   help="fire when BOTH windows burn at/above this "
                        "multiple of the sustainable budget spend")
    p.add_argument("--timeseries-capacity", type=int, default=360,
                   help="metric time-series ring depth (points; 0 "
                        "disables the ring and SLO evaluation)")
    p.add_argument("--profile-hz", type=float, default=67.0,
                   help="always-on stack sampling rate at the proxy hop "
                        "(Hz); the proxy's samples fold into jubactl -c "
                        "profile next to the backends'; 0 disables")
    p.add_argument("--profile-trigger-breaches", type=int, default=3,
                   help="slow-log captures of the SAME span inside "
                        "--profile-trigger-window that auto-capture a "
                        "profile snapshot (once per window; 0 disables)")
    p.add_argument("--profile-trigger-window", type=float, default=10.0,
                   help="breach-counting window (seconds) for the "
                        "tail-triggered profile snapshot")
    p.add_argument("--handoff-window", type=float, default=15.0,
                   help="seconds after a membership change during which "
                        "CHT-routed effectful calls double-dispatch to "
                        "the union of old and new ring owners (no key "
                        "has zero owners while rows migrate); idempotent "
                        "reads fail over new->old instead")
    p.add_argument("--event-capacity", type=int, default=2048,
                   help="event journal depth at the proxy hop (breaker "
                        "transitions, proxy SLO edges; served by "
                        "get_events / jubactl -c timeline); 0 disables "
                        "emission")
    p.add_argument("--incident-window", type=float, default=300.0,
                   help="debounce window (seconds) for automatic "
                        "incident bundles at the proxy hop: a firing "
                        "proxy SLO or degraded /healthz captures ONE "
                        "correlated snapshot per window; 0 disables")
    p.add_argument("--incident-dir", default="",
                   help="capped incident-bundle artifacts dir (oldest "
                        "pruned); empty = under /tmp keyed by the "
                        "bound port")
    p.add_argument("--usage-top", type=int, default=64,
                   help="exact per-principal usage-ledger rows at the "
                        "proxy hop (overflow folds into the '(other)' "
                        "row backed by a heavy-hitter sketch; 0 "
                        "disables the ledger)")
    p.add_argument("--usage-gauge-principals", type=int, default=8,
                   help="top-N principals published as "
                        "usage.<principal>.* gauges each telemetry tick")
    ns = p.parse_args(argv)
    ns.slo = ns.slo or []
    for spec in ns.slo:
        try:  # bad grammar is refused at argv time
            parse_slo(spec)
        except ValueError as e:
            raise SystemExit(str(e))
    args = ProxyArgs(**{f.name: getattr(ns, f.name)
                        for f in dataclasses.fields(ProxyArgs)
                        if hasattr(ns, f.name)})
    logging.basicConfig(
        level=logging.INFO,
        format=f"%(asctime)s %(levelname)s [{args.engine}_proxy:{args.rpc_port}] %(message)s",
    )
    proxy = Proxy(args)
    signal.signal(signal.SIGTERM, lambda *_: proxy.stop())
    signal.signal(signal.SIGINT, lambda *_: proxy.stop())
    port = proxy.start()
    print(f"jubatus_tpu_torch {args.engine} proxy serving on port {port}",
          flush=True)
    proxy.join()
    return 0


if __name__ == "__main__":
    import sys

    sys.exit(main())
