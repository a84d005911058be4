"""MessagePack-RPC client (trimmed counterpart of ``jubatus_tpu/rpc/client.py``).

One connection, one call at a time under a lock, responses matched by msgid
(a stale response to a timed-out call is dropped). No retries, trace
context, deadlines or principals. ``RpcMClient`` fans one call out to N
hosts in parallel, as the mix plane's master does. One client class per
engine
(``NearestNeighborClient``, ``RecommenderClient``, ``AnomalyClient``,
``ClassifierClient``, ``RegressionClient``, ``ClusteringClient``,
``GraphClient``, ``StatClient``, ``BanditClient``, ``BurstClient``,
``WeightClient``) wraps its engine's methods, and the built-ins get_config,
get_status, save, load and do_mix, with the cluster name every jubatus
call carries first.
"""

from __future__ import annotations

import socket
import threading
from concurrent.futures import ThreadPoolExecutor
from typing import Any, List, Optional, Sequence, Tuple

import msgpack

from jubatus_tpu_torch.rpc.breaker import BreakerBoard
from jubatus_tpu_torch.rpc.errors import (
    BreakerOpen,
    HostError,
    RpcIoError,
    RpcNoClient,
    RpcTimeoutError,
    is_retryable,
    wire_to_error,
)
from jubatus_tpu_torch.rpc.server import REQUEST, RESPONSE, _to_wire


class RpcClient:
    def __init__(self, host: str, port: int, timeout: float = 10.0) -> None:
        self.host = host
        self.port = port
        self.timeout = timeout
        self._sock: Optional[socket.socket] = None
        self._unpacker: Optional[msgpack.Unpacker] = None
        self._msgid = 0
        self._lock = threading.RLock()

    def _connect(self) -> socket.socket:
        if self._sock is None:
            try:
                s = socket.create_connection((self.host, self.port),
                                             timeout=self.timeout)
            except OSError as e:
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

    def call(self, method: str, *args: Any) -> Any:
        with self._lock:
            self._msgid = (self._msgid + 1) & 0xFFFFFFFF
            msgid = self._msgid
            payload = msgpack.packb([REQUEST, msgid, method, list(args)],
                                    default=_to_wire,
                                    unicode_errors="surrogateescape")
            sock = self._connect()
            try:
                sock.settimeout(self.timeout)
                sock.sendall(payload)
                msg = self._read_response(sock, msgid)
            except socket.timeout as e:
                self.close()
                raise RpcTimeoutError(
                    f"{method} @ {self.host}:{self.port}: timed out") from e
            except OSError as e:
                self.close()
                raise RpcIoError(f"{method} @ {self.host}:{self.port}: {e}") from e
        _, _, error, result = msg
        if error is not None:
            raise wire_to_error(error, method)
        return result

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
    the reducer fold, trace context, deadlines and principals;
    ≙ rpc_mclient).

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
        futs = {}
        for hp in self.hosts:
            if self.breakers is not None and not self.breakers.allow(hp):
                # open circuit: instant failure, no timeout burned — the
                # caller's skip/abort semantics see it like a dead host
                errors.append(HostError(
                    hp[0], hp[1], BreakerOpen(f"{hp[0]}:{hp[1]}")))
                continue
            futs[self._executor.submit(self._client(hp).call, method,
                                       *args)] = hp
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
                "store_restore", "get_store_status")

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
