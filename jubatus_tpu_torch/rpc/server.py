"""Threaded MessagePack-RPC server (trimmed counterpart of
``jubatus_tpu/rpc/server.py``).

A TCP accept loop + per-connection reader threads over a shared bounded
worker pool. Same envelope as the JAX package's server: a request is
``[0, msgid, method, params]``, optionally followed by the trace, deadline
and principal elements (accepted and ignored here), and answers are
correlated by msgid, so a client may pipeline calls on one connection.
A wrong parameter count answers ARGUMENT_ERROR, an unknown method
NO_METHOD_ERROR. ``dispatch_gate``, when set, is called with the method
name before every dispatch, and raising there refuses the request before
any state change (the drain plane refuses effectful calls with the
retryable ``NodeDraining``). Not carried over: tracing, fault injection,
deadlines, principals, the legacy-wire scan and the raw fast path.

``stop()`` waits on nothing: it shuts the listening socket and every open
connection down (which wakes a reader blocked in ``recv`` and a worker
blocked in ``sendall`` to a peer that does not read), drops the requests
still queued, and leaves the workers, daemon threads, to finish or die
with the process. A request already running finishes, but nothing joins it.
"""

from __future__ import annotations

import inspect
import logging
import queue
import socket
import threading
from typing import Any, Callable, Dict, List, Optional, Set

import msgpack

from jubatus_tpu_torch.rpc.errors import RpcMethodNotFound, error_to_wire

log = logging.getLogger(__name__)

REQUEST, RESPONSE, NOTIFY = 0, 1, 2


def _arity(fn: Callable[..., Any]) -> Optional[int]:
    """Required positional parameter count, or None for *args handlers."""
    try:
        params = inspect.signature(fn).parameters.values()
    except (TypeError, ValueError):
        return None
    if any(p.kind in (p.VAR_POSITIONAL, p.VAR_KEYWORD) for p in params):
        return None
    return len([p for p in params if p.default is p.empty
                and p.kind in (p.POSITIONAL_ONLY, p.POSITIONAL_OR_KEYWORD)])


class RpcServer:
    """Dispatcher + listener: register(), then serve_background(), then stop()."""

    def __init__(self) -> None:
        self._methods: Dict[str, Callable[..., Any]] = {}
        self._arity: Dict[str, Optional[int]] = {}
        self._sock: Optional[socket.socket] = None
        #: requests for the workers: (fn, args), or None to end a worker
        self._work: "queue.SimpleQueue[Optional[tuple]]" = queue.SimpleQueue()
        self._workers: List[threading.Thread] = []
        self._conns: Set[socket.socket] = set()
        self._conns_lock = threading.Lock()
        self._running = False
        self.port: Optional[int] = None
        #: elastic-membership gate: called with the method name before
        #: every dispatch; raising rejects the request BEFORE any state
        #: change (the drain plane rejects effectful methods with the
        #: retryable NodeDraining so callers re-route)
        self.dispatch_gate: Optional[Callable[[str], None]] = None

    def register(self, name: str, fn: Callable[..., Any],
                 arity: Optional[int] = None) -> None:
        self._methods[name] = fn
        self._arity[name] = _arity(fn) if arity is None else arity

    # -- lifecycle -----------------------------------------------------------
    def serve_background(self, port: int = 0, nthreads: int = 2,
                         host: str = "0.0.0.0") -> int:
        sock = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
        sock.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
        sock.bind((host, port))
        sock.listen(128)
        self._sock = sock
        self.port = sock.getsockname()[1]
        self._running = True
        self._workers = [threading.Thread(target=self._worker, daemon=True,
                                          name=f"rpc-worker-{i}")
                         for i in range(max(2, nthreads))]
        for t in self._workers:
            t.start()
        threading.Thread(target=self._accept_loop, args=(sock,), daemon=True,
                         name="rpc-accept").start()
        return self.port

    def stop(self) -> None:
        self._running = False
        sock, self._sock = self._sock, None
        if sock is not None:
            _shutdown(sock)  # wakes the accept loop
            sock.close()
        with self._conns_lock:
            conns, self._conns = self._conns, set()
        for conn in conns:
            _shutdown(conn)  # its reader closes it
        for _ in self._workers:
            self._work.put(None)
        self._workers = []

    def _worker(self) -> None:
        while True:
            item = self._work.get()
            if item is None:
                return
            if self._running:  # a request queued before stop() is dropped
                fn, args = item
                fn(*args)

    # -- wire loop -----------------------------------------------------------
    def _accept_loop(self, sock: socket.socket) -> None:
        while self._running:
            try:
                conn, _addr = sock.accept()
            except OSError:
                return
            conn.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
            with self._conns_lock:
                if not self._running:
                    conn.close()
                    return
                self._conns.add(conn)
            threading.Thread(target=self._conn_loop, args=(conn,),
                             daemon=True, name="rpc-conn").start()

    def _conn_loop(self, conn: socket.socket) -> None:
        unpacker = msgpack.Unpacker(raw=False, strict_map_key=False,
                                    use_list=True,
                                    unicode_errors="surrogateescape")
        wlock = threading.Lock()
        try:
            while self._running:
                data = conn.recv(65536)
                if not data:
                    return
                unpacker.feed(data)
                for msg in unpacker:
                    self._handle(conn, wlock, msg)
        except (OSError, ValueError):
            pass
        finally:
            with self._conns_lock:
                self._conns.discard(conn)
            try:
                conn.close()
            except OSError:
                pass

    def _handle(self, conn: socket.socket, wlock: threading.Lock,
                msg: Any) -> None:
        if not isinstance(msg, (list, tuple)) or not msg:
            return
        if msg[0] == REQUEST and 4 <= len(msg) <= 7:
            _, msgid, method, params = msg[:4]
            self._work.put((self._dispatch, (conn, wlock, msgid, method,
                                             params)))
        elif msg[0] == NOTIFY and len(msg) == 3:
            self._work.put((self._invoke_silent, (msg[1], msg[2])))

    def _dispatch(self, conn, wlock, msgid, method, params) -> None:
        error, result = None, None
        try:
            result = self._invoke(method, params)
        except Exception as e:  # broad-ok — every failure must answer
            if not isinstance(e, RpcMethodNotFound):
                log.debug("rpc method %s raised", method, exc_info=True)
            error = error_to_wire(e)
        payload = build_response(msgid, error, result)
        try:
            with wlock:
                conn.sendall(payload)
        except OSError:
            pass

    def _invoke(self, method: str, params: Any) -> Any:
        fn = self._methods.get(method)
        if fn is None:
            raise RpcMethodNotFound(method)
        params = list(params) if isinstance(params, (list, tuple)) else [params]
        want = self._arity.get(method)
        if want is not None and len(params) != want:
            raise TypeError(f"{method}: expected {want} params, got {len(params)}")
        gate = self.dispatch_gate
        if gate is not None:
            gate(method)
        return fn(*params)

    def _invoke_silent(self, method: str, params: Any) -> None:
        try:
            self._invoke(method, params)
        except Exception:  # broad-ok — a notify has no one to answer
            log.debug("rpc notify %s raised", method, exc_info=True)


def _shutdown(sock: socket.socket) -> None:
    try:
        sock.shutdown(socket.SHUT_RDWR)
    except OSError:  # not connected, or already shut
        pass


def build_response(msgid: int, error: Any, result: Any) -> bytes:
    """Pack one msgpack-rpc response message."""
    return msgpack.packb([RESPONSE, msgid, error, result], default=_to_wire,
                         unicode_errors="surrogateescape")


def _to_wire(obj: Any) -> Any:
    """msgpack fallback: datum-like objects → wire tuples; numpy and torch
    scalars → Python scalars; arrays → lists."""
    if hasattr(obj, "to_msgpack"):
        return obj.to_msgpack()
    if hasattr(obj, "tolist"):
        return obj.tolist()
    raise TypeError(f"cannot msgpack {type(obj)!r}")
