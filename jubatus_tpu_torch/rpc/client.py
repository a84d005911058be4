"""MessagePack-RPC clients (trimmed counterpart of ``jubatus_tpu/rpc/client.py``).

``RpcClient`` — one connection, one call at a time under a lock, responses
matched by msgid (a stale response to a timed-out call is dropped). As in
the JAX package's client:

- the envelope carries the OPTIONAL trace (5th), deadline (6th, the
  remaining budget in seconds) and principal (7th) elements, each only
  when this thread has one, earlier absent slots nil-padded, so a request
  is byte-for-byte the JAX client's for the same call and msgid;
- an active deadline caps each attempt's socket timeout at the remaining
  budget, and a call whose budget is gone raises ``DeadlineExceeded``
  before it is sent;
- IDEMPOTENT calls (framework/idl.py's tables) retry on transport failures
  with capped exponential backoff and full jitter, gated by a per-client
  retry budget (rpc/retry.py); effectful calls propagate their first
  failure;
- ``call_raw`` forwards an already-encoded params span and returns the
  response's raw result span (the proxy's zero-decode relay);
- a call made under a trace context is a span of its own in the client's
  registry, ``rpc.client.<method>`` under the child span id it ships, on
  both paths, so an assembled trace shows each hop's wire and queue time
  between the caller's dispatch and the callee's.

``RpcMClient`` fans one call out to N hosts in parallel, carrying the
caller's trace context, deadline and principal into its executor. One
client class per engine (``NearestNeighborClient``, ``RecommenderClient``,
``AnomalyClient``, ``ClassifierClient``, ``RegressionClient``,
``ClusteringClient``, ``GraphClient``, ``StatClient``, ``BanditClient``,
``BurstClient``, ``WeightClient``) wraps its engine's methods, and the
built-ins get_config, get_status, save, load and do_mix, with the cluster
name every jubatus call carries first. A retried attempt is billed to the
caller's principal in every usage ledger of the process
(``utils/usage.py`` ``note_retry``). Not carried over: ``notify`` and the
reducer fold of ``RpcMClient``.
"""

from __future__ import annotations

import contextlib
import socket
import threading
import time
from concurrent.futures import ThreadPoolExecutor
from typing import Any, Callable, FrozenSet, List, Optional, Sequence, Tuple

import msgpack

from jubatus_tpu_torch.framework.idl import CLIENT_SAFE_RETRY
from jubatus_tpu_torch.rpc import deadline as deadlines
from jubatus_tpu_torch.rpc import principal as principals
from jubatus_tpu_torch.rpc.breaker import BreakerBoard
from jubatus_tpu_torch.rpc.errors import (
    BreakerOpen,
    DeadlineExceeded,
    HostError,
    RpcIoError,
    RpcNoClient,
    RpcTimeoutError,
    is_retryable,
    wire_to_error,
)
from jubatus_tpu_torch.rpc.retry import DEFAULT_POLICY, RetryBudget, RetryPolicy
from jubatus_tpu_torch.rpc.server import (
    REQUEST,
    RESPONSE,
    _parse_response_envelope,
    _to_wire,
    msgpack_span_end,
)
from jubatus_tpu_torch.utils import faults, tracing, usage

#: transport-level failures an idempotent call may retry (FaultInjected
#: included: injected faults stand in for the IO errors they model)
_RETRYABLE = (RpcIoError, RpcTimeoutError, faults.FaultInjected)


class RpcClient:
    def __init__(self, host: str, port: int, timeout: float = 10.0, *,
                 retry_policy: Optional[RetryPolicy] = None,
                 retry_budget: Optional[RetryBudget] = None,
                 retry_methods: Optional[FrozenSet[str]] = None,
                 registry: Optional[tracing.Registry] = None) -> None:
        self.host = host
        self.port = port
        self.timeout = timeout
        #: retry plane: which methods are idempotent (the engine-agnostic
        #: conservative table by default), how to back off, and the token
        #: bucket bounding retry amplification; retry_methods=frozenset()
        #: disables retries
        self.retry_policy = retry_policy or DEFAULT_POLICY
        self.retry_budget = retry_budget or RetryBudget()
        self.retry_methods = (CLIENT_SAFE_RETRY if retry_methods is None
                              else retry_methods)
        self._registry = registry or tracing.default_registry()
        self._sock: Optional[socket.socket] = None
        self._unpacker: Optional[msgpack.Unpacker] = None
        self._msgid = 0
        # RLock: a call holds it and calls close() on failure paths
        self._lock = threading.RLock()

    def _connect(self) -> socket.socket:
        if self._sock is None:
            try:
                # an injected connect fault takes the path a refused
                # connection would
                if faults.is_armed():
                    faults.fire(f"rpc.connect.{self.host}:{self.port}")
                s = socket.create_connection((self.host, self.port),
                                             timeout=self.timeout)
            except (OSError, faults.FaultInjected) as e:
                raise RpcIoError(f"connect {self.host}:{self.port}: {e}") from e
            s.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
            self._sock = s
            self._unpacker = msgpack.Unpacker(
                raw=False, strict_map_key=False,
                unicode_errors="surrogateescape")
        return self._sock

    def close(self) -> None:
        with self._lock:
            if self._sock is not None:
                try:
                    self._sock.close()
                except OSError:
                    pass
                self._sock = None
                self._unpacker = None

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()

    # -- retry plane ---------------------------------------------------------
    def _with_retries(self, method: str, once: Callable[[], Any]) -> Any:
        """Run ``once`` with the retry loop: idempotent methods retry on
        transport failures (budget-gated, jittered backoff, bounded by
        the remaining deadline); everything else propagates its first
        error — a duplicate of an effectful call could double-apply."""
        retryable_method = method in self.retry_methods
        if retryable_method:
            self.retry_budget.deposit()
        attempt = 0
        while True:
            try:
                return once()
            except _RETRYABLE:
                attempt += 1
                if not retryable_method or \
                        attempt >= self.retry_policy.max_attempts:
                    raise
                rem = deadlines.remaining()
                if rem is not None and rem <= 0:
                    raise
                if not self.retry_budget.try_withdraw():
                    self._registry.count("rpc.retry_budget_exhausted")
                    raise
                self._registry.count("rpc.retries")
                # the server sees another request; only the client knows
                # this attempt is amplification, so bill it here
                usage.note_retry(method)
                sleep = self.retry_policy.sleep_for(attempt, rem)
                if sleep > 0:
                    time.sleep(sleep)

    def _effective_timeout(self, method: str) -> float:
        """Per-attempt socket timeout: the flat client timeout, tightened
        to the remaining deadline budget when one is active. Raises
        DeadlineExceeded before sending when the budget is already gone."""
        rem = deadlines.remaining()
        if rem is None:
            return self.timeout
        if rem <= 0:
            self._registry.count("rpc.deadline_expired")
            raise DeadlineExceeded(
                f"{method} @ {self.host}:{self.port}: "
                "deadline expired before send")
        return min(self.timeout, rem)

    def _timeout_error(self, method: str) -> Exception:
        """socket.timeout -> taxonomy: a timeout caused by the DEADLINE
        (not the flat client timeout) is the budget running out —
        DeadlineExceeded, not a retryable RpcTimeoutError."""
        if deadlines.expired():
            self._registry.count("rpc.deadline_expired")
            return DeadlineExceeded(
                f"{method} @ {self.host}:{self.port}: deadline expired")
        return RpcTimeoutError(f"{method} @ {self.host}:{self.port}: timed out")

    @contextlib.contextmanager
    def _hop_span(self, child: Optional[tracing.TraceContext], method: str):
        """The send and the read of one attempt as ``rpc.client.<method>``
        under the child id the envelope ships (nothing without a trace)."""
        if child is None:
            yield
            return
        with tracing.use_trace(child), \
                self._registry.span(f"rpc.client.{method}"):
            yield

    # -- calls ---------------------------------------------------------------
    def call(self, method: str, *args: Any) -> Any:
        return self._with_retries(method, lambda: self._call_once(method, args))

    def _call_once(self, method: str, args: Sequence[Any]) -> Any:
        # fired per ATTEMPT, so @N fault rules interact with retries the
        # way real transient failures would
        if faults.is_armed():
            faults.fire(f"rpc.call.{method}.{self.host}:{self.port}")
        # the call ships a fresh CHILD span id of this thread's trace
        ctx = tracing.current_trace()
        child = tracing.child_of(ctx) if ctx is not None else None
        eff_timeout = self._effective_timeout(method)
        dl = deadlines.to_wire()
        pr = principals.to_wire()
        with self._lock:
            self._msgid = (self._msgid + 1) & 0xFFFFFFFF
            msgid = self._msgid
            env: list = [REQUEST, msgid, method, list(args)]
            # nil-pad earlier absent slots: the elements are positional,
            # so a tagged-but-untraced call ships [.., None, None, pr]
            if child is not None or dl is not None or pr is not None:
                env.append(tracing.to_wire(child)
                           if child is not None else None)
            if dl is not None or pr is not None:
                env.append(dl)
            if pr is not None:
                env.append(pr)
            payload = msgpack.packb(env, default=_to_wire,
                                    unicode_errors="surrogateescape")
            sock = self._connect()
            try:
                with self._hop_span(child, method):
                    sock.settimeout(eff_timeout)
                    sock.sendall(payload)
                    msg = self._read_response(sock, msgid)
            except socket.timeout as e:
                self.close()
                raise self._timeout_error(method) from e
            except OSError as e:
                self.close()
                raise RpcIoError(f"{method} @ {self.host}:{self.port}: {e}") from e
        _, _, error, result = msg
        if error is not None:
            raise wire_to_error(error, method)
        return result

    def call_raw(self, method: str, raw_params: bytes) -> bytes:
        """Forward ``raw_params`` (an already-encoded msgpack params
        object) and return the response's raw RESULT span — the proxy's
        zero-decode relay. A non-nil error in the response raises the
        usual taxonomy."""
        return self._with_retries(
            method, lambda: self._call_raw_once(method, raw_params))

    def _call_raw_once(self, method: str, raw_params: bytes) -> bytes:
        if faults.is_armed():
            faults.fire(f"rpc.call.{method}.{self.host}:{self.port}")
        ctx = tracing.current_trace()
        child = tracing.child_of(ctx) if ctx is not None else None
        eff_timeout = self._effective_timeout(method)
        dl = deadlines.to_wire()
        pr = principals.to_wire()
        with self._lock:
            self._msgid = (self._msgid + 1) & 0xFFFFFFFF
            msgid = self._msgid
            # the method name as str8 (valid modern msgpack even for
            # short names), as the JAX client sends it
            mb = method.encode()
            # trailing elements: trace, deadline, principal, earlier
            # absent slots nil
            n_extra = 3 if pr is not None else \
                (2 if dl is not None else (1 if child is not None else 0))
            head = (bytes([0x94 + n_extra]) + b"\x00" + msgpack.packb(msgid)
                    + b"\xd9" + bytes([len(mb)]) + mb)
            bufs = [head, raw_params]
            if n_extra >= 1:
                bufs.append(msgpack.packb(tracing.to_wire(child))
                            if child is not None else b"\xc0")
            if n_extra >= 2:
                bufs.append(msgpack.packb(float(dl))
                            if dl is not None else b"\xc0")
            if n_extra == 3:
                bufs.append(msgpack.packb(pr))
            sock = self._connect()
            try:
                with self._hop_span(child, method):
                    sock.settimeout(eff_timeout)
                    # scatter-gather: no concat copy of a possibly large
                    # span (sendmsg may write short — finish with sendall)
                    sent = sock.sendmsg(bufs)
                    if sent < sum(len(b) for b in bufs):
                        off = sent
                        for b in bufs:
                            if off >= len(b):
                                off -= len(b)
                                continue
                            sock.sendall(memoryview(b)[off:])
                            off = 0
                    frame = self._read_raw_response(sock)
            except socket.timeout as e:
                self.close()
                raise self._timeout_error(method) from e
            except OSError as e:
                self.close()
                raise RpcIoError(f"{method} @ {self.host}:{self.port}: {e}") from e
        # frame = [1, msgid, error, result]; locate the error span
        off = _parse_response_envelope(frame)
        err_end = msgpack_span_end(frame, off)
        if frame[off:err_end] != b"\xc0":
            error = msgpack.unpackb(frame[off:err_end], raw=False,
                                    unicode_errors="surrogateescape")
            raise wire_to_error(error, method)
        return frame[err_end:]

    def _read_raw_response(self, sock: socket.socket) -> bytes:
        """Read one complete response frame as BYTES (no payload decode),
        delimited with the unpacker's skip. Exactly one request is in
        flight (the lock is held), and a timed-out call closes the
        connection, so the next frame is this call's."""
        framer = msgpack.Unpacker()
        buf = bytearray()
        while True:
            try:
                framer.skip()
                return bytes(buf[:framer.tell()])
            except msgpack.OutOfData:
                pass
            data = sock.recv(65536)
            if not data:
                raise OSError("connection closed by peer")
            framer.feed(data)
            buf += data

    def _read_response(self, sock: socket.socket, msgid: int) -> Any:
        unpacker = self._unpacker
        while True:
            for msg in unpacker:
                if (isinstance(msg, (list, tuple)) and len(msg) == 4
                        and msg[0] == RESPONSE and msg[1] == msgid):
                    return msg
            data = sock.recv(65536)
            if not data:
                raise OSError("connection closed by peer")
            unpacker.feed(data)


class RpcMClient:
    """Parallel fan-out (copy of the JAX package's ``RpcMClient``, without
    the reducer fold; ≙ rpc_mclient).

    Keeps one persistent connection per host across calls (the reference's
    session_pool) — call ``close()`` when done, or use as a context manager.
    ``set_hosts`` reshapes the pool on membership change without dropping
    still-valid sessions. An optional ``breakers`` board short-circuits
    hosts whose circuit is open (their slot in the fan-out becomes an
    instant ``BreakerOpen`` host error) and re-admits them via half-open
    probes.
    """

    def __init__(
        self, hosts: Sequence[Tuple[str, int]], timeout: float = 10.0,
        breakers: Optional[BreakerBoard] = None,
    ) -> None:
        self.timeout = timeout
        self.breakers = breakers
        self._pool: dict = {}
        self.hosts: List[Tuple[str, int]] = []
        self._executor = ThreadPoolExecutor(
            max_workers=64, thread_name_prefix="rpc-fanout"
        )
        self.set_hosts(hosts)

    def set_hosts(self, hosts: Sequence[Tuple[str, int]]) -> None:
        if not hosts:
            raise RpcNoClient("empty host list")
        hosts = [tuple(h) for h in hosts]
        for hp in list(self._pool):
            if hp not in hosts:
                self._pool.pop(hp).close()
        self.hosts = list(hosts)

    def close(self) -> None:
        for c in self._pool.values():
            c.close()
        self._pool.clear()
        self._executor.shutdown(wait=False)

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()

    def _client(self, hp: Tuple[str, int]) -> RpcClient:
        c = self._pool.get(hp)
        if c is None:
            c = self._pool[hp] = RpcClient(hp[0], hp[1], self.timeout)
        return c

    def _fan_out(self, method: str, args: Sequence[Any]):
        results: List[Tuple[Tuple[str, int], Any]] = []
        errors: List[HostError] = []
        # the fan-out hops threads: carry the caller's trace context,
        # deadline AND principal into the executor, so every per-host
        # call ships the same trace id, derives its timeout from the
        # shared budget and bills the same tenant
        ctx = tracing.current_trace()
        dl = deadlines.current()
        pr = principals.current()

        def one(hp: Tuple[str, int]):
            with tracing.use_trace(ctx), deadlines.use(dl), \
                    principals.use(pr):
                return self._client(hp).call(method, *args)

        futs = {}
        for hp in self.hosts:
            if self.breakers is not None and not self.breakers.allow(hp):
                # open circuit: instant failure, no timeout burned — the
                # caller's skip/abort semantics see it like a dead host
                errors.append(HostError(
                    hp[0], hp[1], BreakerOpen(f"{hp[0]}:{hp[1]}")))
                continue
            futs[self._executor.submit(one, hp)] = hp
        for fut, hp in futs.items():
            try:
                results.append((hp, fut.result()))
                if self.breakers is not None:
                    self.breakers.record(hp, True)
            except Exception as e:  # broad-ok — per-host failure is data
                errors.append(HostError(hp[0], hp[1], e))
                if self.breakers is not None:
                    # only transport failures count against the breaker:
                    # an application error proves the backend is alive
                    self.breakers.record(hp, not is_retryable(e))
        return results, errors

    def call_collect(self, method: str, *args: Any):
        """Raw per-host results + errors (≙ rpc_result_object)."""
        return self._fan_out(method, args)


class _ServiceClient:
    """One engine's service methods (``METHODS``) plus the built-ins, each
    call prefixed with the cluster ``name``: ``get_config()``,
    ``get_status()`` (one map per node), ``save(model_id)`` (node → path,
    plus ``store:<node>`` → store key with a model store),
    ``load(model_id)`` (True; ``store:<key>`` ids too) and ``do_mix()``
    (True when a round ran); the elastic plane's ``get_epoch()``,
    ``drain(stop_after)``, ``drain_status()``, ``rebalance()``,
    ``migrate_range(epoch, target, cursor, limit)``, ``put_rows(rows)``
    and ``get_row_count()``; ``rollback(reason)``; and the store's
    ``store_restore(at_hlc)`` and ``get_store_status()``, with the JAX
    server's wire shapes."""

    METHODS: tuple = ()
    BUILTINS = ("get_config", "get_status", "save", "load", "do_mix",
                "get_epoch", "drain", "drain_status", "rebalance",
                "migrate_range", "put_rows", "get_row_count", "rollback",
                "store_restore", "get_store_status", "get_proxy_status",
                "get_breakers")

    def __init__(self, host: str, port: int, name: str,
                 timeout: float = 10.0) -> None:
        self.name = name
        self.client = RpcClient(host, port, timeout)

    def __getattr__(self, method: str):
        if method not in self.METHODS and method not in self.BUILTINS:
            raise AttributeError(method)
        return lambda *args: self.client.call(method, self.name, *args)

    def close(self) -> None:
        self.client.close()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()


class NearestNeighborClient(_ServiceClient):
    METHODS = ("clear", "set_row", "neighbor_row_from_id",
               "neighbor_row_from_datum", "similar_row_from_id",
               "similar_row_from_datum", "get_all_rows")


class RecommenderClient(_ServiceClient):
    METHODS = ("clear_row", "update_row", "clear", "complete_row_from_id",
               "complete_row_from_datum", "similar_row_from_id",
               "similar_row_from_datum", "decode_row", "get_all_rows",
               "calc_similarity", "calc_l2norm")


class AnomalyClient(_ServiceClient):
    METHODS = ("clear_row", "add", "update", "overwrite", "clear",
               "calc_score", "get_all_rows")


class ClassifierClient(_ServiceClient):
    METHODS = ("train", "classify", "get_labels", "set_label",
               "delete_label", "clear")


class RegressionClient(_ServiceClient):
    METHODS = ("train", "estimate", "clear")


class ClusteringClient(_ServiceClient):
    METHODS = ("push", "get_revision", "get_core_members",
               "get_core_members_light", "get_k_center",
               "get_nearest_center", "get_nearest_members",
               "get_nearest_members_light", "clear")


class GraphClient(_ServiceClient):
    METHODS = ("create_node", "remove_node", "update_node", "create_edge",
               "update_edge", "remove_edge", "get_centrality",
               "add_centrality_query", "add_shortest_path_query",
               "remove_centrality_query", "remove_shortest_path_query",
               "get_shortest_path", "update_index", "clear", "get_node",
               "get_edge", "create_node_here", "remove_global_node",
               "create_edge_here")


class StatClient(_ServiceClient):
    METHODS = ("push", "sum", "stddev", "max", "min", "entropy", "moment",
               "clear")


class BanditClient(_ServiceClient):
    METHODS = ("register_arm", "delete_arm", "select_arm",
               "register_reward", "get_arm_info", "reset", "clear")


class BurstClient(_ServiceClient):
    METHODS = ("add_documents", "get_result", "get_result_at",
               "get_all_bursted_results", "get_all_bursted_results_at",
               "get_all_keywords", "add_keyword", "remove_keyword",
               "remove_all_keywords", "clear")


class WeightClient(_ServiceClient):
    METHODS = ("update", "calc_weight", "clear")
