"""Threaded MessagePack-RPC server (trimmed counterpart of
``jubatus_tpu/rpc/server.py``).

A TCP accept loop + per-connection reader threads over a shared bounded
worker pool. Same envelope as the JAX package's server: a request is
``[0, msgid, method, params]``, optionally followed by the trace, deadline
and principal elements (``[..., trace]``, ``[..., trace, deadline]``,
``[..., trace, deadline, principal]``, earlier absent slots nil), and
answers are correlated by msgid, so a client may pipeline calls on one
connection. A wrong parameter count answers ARGUMENT_ERROR, an unknown
method NO_METHOD_ERROR.

For the length of a dispatch the worker adopts the caller's trace context
(or roots a fresh one), its deadline (the remaining budget, re-anchored on
this host's monotonic clock) and its principal, so every call the handler
makes onward carries them. A request whose deadline has already expired
is refused before dispatch with ``DeadlineExceeded`` and counted as
``rpc.deadline_rejected``. Each dispatch is a span ``rpc.<method>`` in the
server's registry, each failure a count ``rpc.<method>.errors``.
``dispatch_gate``, when set, is called with the method name before every
dispatch, and raising there refuses the request before any state change
(the drain plane refuses effectful calls with the retryable
``NodeDraining``).

``register_raw`` gives a method a fast path that receives the request's
params as raw msgpack bytes, never decoded here, and may answer with a
``RawResult`` (an already-encoded result span, spliced into the response
frame) or decline with ``RAW_FALLBACK`` (the request is then decoded and
served by the method's registered handler). The proxy's zero-decode relay
uses it. ``usage_recorder``, when set (a ``utils/usage.py`` ledger),
is told each dispatch's bytes in and out and each failure, billed to the
request's principal; the ledger's CPU-seconds come from the registry's
``usage_sink``. Not carried over: fault sites other than the dispatch's.

The legacy wire (``rpc/legacy.py``): with ``legacy_wire`` every answer
goes out in the pre-2013 msgpack format (no str8/bin bytes) that the
reference's deployed clients parse; with ``wire_detect`` each connection
is fingerprinted from its requests (``wire_is_legacy``, a budget-capped
type-byte scan) and answered in the format its client speaks. A legacy
verdict is provisional and re-checked; a modern one latches. Methods
registered with ``binary=True`` (model bytes, mixer internals) always
answer in the modern format.

A handler may answer with a ``concurrent.futures.Future`` (``deferred``
wraps one that runs on a thread of its own): the worker returns to the
pool at once and the response goes out when the future resolves, from the
thread that resolves it, with its result or its exception as the error.
A long operator call (``profile_device``) so holds no worker; its span
``rpc.<method>`` covers the hand-off only.

The transport ends at ``_dispatch``, which serves one request and hands
the packed answer to a writer the transport gives it: the native
transport (rpc/native_server.py) shares the whole dispatch and answer
path.

``stop()`` waits on nothing: it shuts the listening socket and every open
connection down (which wakes a reader blocked in ``recv`` and a worker
blocked in ``sendall`` to a peer that does not read), drops the requests
still queued, and leaves the workers, daemon threads, to finish or die
with the process. A request already running finishes, but nothing joins it.
"""

from __future__ import annotations

import concurrent.futures
import inspect
import logging
import queue
import socket
import threading
from typing import Any, Callable, Dict, List, Optional, Set

import msgpack

from jubatus_tpu_torch.rpc import deadline as deadlines
from jubatus_tpu_torch.rpc import legacy as _legacy
from jubatus_tpu_torch.rpc import principal as principals
from jubatus_tpu_torch.rpc.errors import (
    DeadlineExceeded,
    RpcMethodNotFound,
    error_to_wire,
)
from jubatus_tpu_torch.utils import faults, tracing
from jubatus_tpu_torch.utils.tracing import Registry

log = logging.getLogger(__name__)

REQUEST, RESPONSE, NOTIFY = 0, 1, 2

#: sentinel a raw-registered handler returns to decline the fast path —
#: the request is then decoded generically and served by the normal handler
RAW_FALLBACK = object()

#: payload widths of fixed-size msgpack types
_MP_SCALAR_WIDTH = {0xC0: 0, 0xC2: 0, 0xC3: 0, 0xCA: 4, 0xCB: 8, 0xCC: 1,
                    0xCD: 2, 0xCE: 4, 0xCF: 8, 0xD0: 1, 0xD1: 2, 0xD2: 4,
                    0xD3: 8, 0xD4: 2, 0xD5: 3, 0xD6: 5, 0xD7: 9, 0xD8: 17}


def msgpack_span_end(buf: bytes, i: int = 0) -> int:
    """End offset of the msgpack object starting at ``buf[i]`` — a type-
    byte walk that builds no values (the raw relay path needs to split an
    envelope into spans without decoding multi-megabyte payloads).
    Raises ValueError on truncated/unknown bytes."""
    n = len(buf)
    remaining = 1
    while remaining:
        if i >= n:
            raise ValueError("truncated msgpack object")
        t = buf[i]
        i += 1
        remaining -= 1
        if t <= 0x7F or t >= 0xE0:
            continue
        if 0x80 <= t <= 0x8F:
            remaining += (t & 0x0F) * 2
        elif 0x90 <= t <= 0x9F:
            remaining += t & 0x0F
        elif 0xA0 <= t <= 0xBF:
            i += t & 0x1F
        elif t in _MP_SCALAR_WIDTH:
            i += _MP_SCALAR_WIDTH[t]
        elif t in (0xC4, 0xC7, 0xD9):     # bin8/ext8/str8
            if i >= n:
                raise ValueError("truncated msgpack object")
            i += 1 + buf[i] + (1 if t == 0xC7 else 0)
        elif t in (0xC5, 0xC8, 0xDA):     # bin16/ext16/str16
            if i + 2 > n:
                raise ValueError("truncated msgpack object")
            i += 2 + int.from_bytes(buf[i:i + 2], "big") + \
                (1 if t == 0xC8 else 0)
        elif t in (0xC6, 0xC9, 0xDB):     # bin32/ext32/str32
            if i + 4 > n:
                raise ValueError("truncated msgpack object")
            i += 4 + int.from_bytes(buf[i:i + 4], "big") + \
                (1 if t == 0xC9 else 0)
        elif t in (0xDC, 0xDD, 0xDE, 0xDF):
            w = 2 if t in (0xDC, 0xDE) else 4
            if i + w > n:
                raise ValueError("truncated msgpack object")
            count = int.from_bytes(buf[i:i + w], "big")
            if count > n - i:
                raise ValueError("impossible msgpack length")
            i += w
            remaining += count * (2 if t in (0xDE, 0xDF) else 1)
        else:
            raise ValueError(f"unknown msgpack type byte 0x{t:02x}")
    if i > n:
        raise ValueError("truncated msgpack object")
    return i


class RawResult:
    """A handler result that is ALREADY msgpack-encoded (a relayed
    backend response span): build_response splices it into the response
    frame without a decode/encode round trip."""

    __slots__ = ("span",)

    def __init__(self, span: bytes) -> None:
        self.span = span


def _parse_response_envelope(raw: bytes) -> int:
    """Offset of the ERROR object in a response frame
    ``[1, msgid, error, result]``; ValueError on anything else."""
    if len(raw) < 3 or raw[0] != 0x94 or raw[1] != 0x01:
        raise ValueError("not a msgpack-rpc response frame")
    t = raw[2]
    if t <= 0x7F:
        return 3
    if t == 0xCC:
        return 4
    if t == 0xCD:
        return 5
    if t == 0xCE:
        return 7
    raise ValueError("unexpected msgid encoding")


def _parse_envelope(raw: bytes):
    """Request envelope without decoding params: ``[0, msgid, method,
    params]`` or its 5-, 6- and 7-element variants -> (msgid, method,
    params_offset, n_extra), or None for anything else (notify, malformed,
    exotic headers) — those take the generic decode path."""
    try:
        if raw[0] not in (0x94, 0x95, 0x96, 0x97) or raw[1] != 0x00:
            return None
        n_extra = raw[0] - 0x94
        i = 2
        t = raw[i]
        if t <= 0x7F:
            msgid, i = t, i + 1
        elif t == 0xCC:
            msgid, i = raw[i + 1], i + 2
        elif t == 0xCD:
            msgid, i = int.from_bytes(raw[i + 1:i + 3], "big"), i + 3
        elif t == 0xCE:
            msgid, i = int.from_bytes(raw[i + 1:i + 5], "big"), i + 5
        else:
            return None
        t = raw[i]
        if 0xA0 <= t <= 0xBF:  # fixstr
            n, i = t & 0x1F, i + 1
        elif t == 0xD9:        # str8
            n, i = raw[i + 1], i + 2
        elif t == 0xDA:        # str16
            n, i = int.from_bytes(raw[i + 1:i + 3], "big"), i + 3
        else:
            return None
        method = raw[i:i + n].decode("utf-8", "surrogateescape")
        return msgid, method, i + n, n_extra
    except IndexError:
        return None


def split_extras(raw: bytes, off: int):
    """Split a request's params span from its OPTIONAL trailing envelope
    elements (trace, then deadline, then principal). Returns
    (params_span, trace_wire, deadline_wire, principal_wire); a malformed
    tail degrades to (everything, None, None, None) — a bad extra element
    must not fail the request."""
    try:
        pend = msgpack_span_end(raw, off)
        trace_w = dl_w = pr_w = None
        if pend < len(raw):
            tend = msgpack_span_end(raw, pend)
            trace_w = msgpack.unpackb(raw[pend:tend], raw=False)
            if tend < len(raw):
                dend = msgpack_span_end(raw, tend)
                dl_w = msgpack.unpackb(raw[tend:dend], raw=False)
                if dend < len(raw):
                    pr_w = msgpack.unpackb(raw[dend:], raw=False)
        return raw[off:pend], trace_w, dl_w, pr_w
    except Exception:  # broad-ok — a bad trailing element must not fail
        return raw[off:], None, None, None


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


def _unpack(raw: bytes) -> Any:
    return msgpack.unpackb(raw, raw=False, strict_map_key=False,
                           use_list=True, unicode_errors="surrogateescape")


class RpcServer:
    """Dispatcher + listener: register(), then serve_background(), then stop()."""

    def __init__(self, trace: Optional[Registry] = None,
                 legacy_wire: bool = False,
                 wire_detect: bool = False) -> None:
        self._methods: Dict[str, Callable[..., Any]] = {}
        self._arity: Dict[str, Optional[int]] = {}
        #: answer every call in the pre-2013 msgpack format
        #: (--legacy-wire), except the binary methods
        self.legacy_wire = legacy_wire
        #: fingerprint each connection's requests (wire_is_legacy) and
        #: answer legacy-format while they carry no post-2013 type byte:
        #: an unmodified deployed jubatus client works against a server
        #: started with no flags. Engine servers and proxies enable this;
        #: internal planes (coordd) stay modern-only.
        self.wire_detect = wire_detect
        self._binary_methods: Set[str] = set()
        #: raw-span fast paths: method -> fn(raw_params bytes) -> result
        #: (or RAW_FALLBACK to decode generically)
        self._raw_methods: Dict[str, Callable[[bytes], Any]] = {}
        #: per-server span aggregates and counters
        self.trace = trace or Registry()
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
        #: usage ledger (utils/usage.py): notes per-method errors and
        #: bytes in/out; CPU-seconds arrive via the registry's usage_sink
        self.usage_recorder: Optional[Any] = None

    def register(self, name: str, fn: Callable[..., Any],
                 arity: Optional[int] = None,
                 binary: bool = False) -> None:
        if binary:
            self._binary_methods.add(name)
        self._methods[name] = fn
        self._arity[name] = _arity(fn) if arity is None else arity

    def register_raw(self, name: str, fn: Callable[[bytes], Any]) -> None:
        """Fast path for ``name``: ``fn`` receives the request's raw params
        msgpack bytes (no Python decode) and returns the result — or
        ``RAW_FALLBACK`` to route the request through the generic decode +
        registered handler. The generic handler must also be registered
        (fallback + arity)."""
        self._raw_methods[name] = fn

    def method_names(self):
        return sorted(self._methods)

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
        # Frame messages by span (Unpacker.skip + tell: builds no objects)
        # and keep a mirror of the bytes: raw-registered methods get their
        # params span as is, everything else goes through one unpackb.
        framer = msgpack.Unpacker()
        buf = bytearray()
        base = 0       # stream offset of buf[0]
        msg_start = 0  # stream offset of the next undelivered message
        wlock = threading.Lock()

        def send(payload: bytes) -> None:
            try:
                with wlock:
                    conn.sendall(payload)
            except OSError:
                pass

        try:
            peer = "%s:%s" % conn.getpeername()[:2]
        except (OSError, TypeError):
            peer = ""
        #: requests fingerprint the peer's wire era (skipped when
        #: --legacy-wire already forces every answer legacy). A legacy
        #: verdict is PROVISIONAL: a modern client whose early calls are
        #: all fixtypes emits zero post-2013 bytes, so the connection is
        #: re-scanned and upgrades to modern the first time a scanned
        #: request carries a modern type byte; only the modern verdict
        #: latches. Re-scans are SAMPLED: every small request (<= 1 KB)
        #: but only power-of-2-numbered bulk ones, since a scan of every
        #: request costs legacy-looking pipelined bulk train traffic about
        #: 3x its throughput.
        conn_state = {"legacy": False, "peer": peer}
        scanning = self.wire_detect and not self.legacy_wire
        nreq = 0
        try:
            while self._running:
                data = conn.recv(65536)
                if not data:
                    return
                framer.feed(data)
                buf += data
                while True:
                    try:
                        framer.skip()
                    except msgpack.OutOfData:
                        break
                    end = framer.tell()
                    raw = bytes(buf[msg_start - base:end - base])
                    msg_start = end
                    if scanning:
                        nreq += 1
                        if len(raw) <= 1024 or (nreq & (nreq - 1)) == 0:
                            conn_state["legacy"] = wire_is_legacy(raw)
                            scanning = conn_state["legacy"]
                    self._handle_raw(send, raw, conn_state)
                del buf[:msg_start - base]
                base = msg_start
        except (OSError, ValueError):
            pass
        finally:
            with self._conns_lock:
                self._conns.discard(conn)
            try:
                conn.close()
            except OSError:
                pass

    def _handle_raw(self, send: Callable[[bytes], None], raw: bytes,
                    conn_state: Dict[str, Any]) -> None:
        env = _parse_envelope(raw)
        if env is not None:
            msgid, method, off, n_extra = env
            if method in self._raw_methods:
                params_span, trace, dl, pr = raw[off:], None, None, None
                if n_extra:
                    params_span, trace, dl, pr = split_extras(raw, off)
                self._work.put((self._dispatch, (
                    send, msgid, method, params_span, True,
                    conn_state, trace, dl, pr, len(raw))))
                return
        msg = _unpack(raw)
        if not isinstance(msg, (list, tuple)) or not msg:
            return
        if msg[0] == REQUEST and 4 <= len(msg) <= 7:
            _, msgid, method, params = msg[:4]
            # 5th element: trace context ({"t", "s"}); 6th: deadline
            # budget (remaining seconds); 7th: principal (tenant id)
            trace = msg[4] if len(msg) >= 5 else None
            dl = msg[5] if len(msg) >= 6 else None
            pr = msg[6] if len(msg) == 7 else None
            self._work.put((self._dispatch, (
                send, msgid, method, params, False, conn_state, trace,
                dl, pr, len(raw))))
        elif msg[0] == NOTIFY and len(msg) == 3:
            self._work.put((self._invoke_silent, (msg[1], msg[2])))

    def _dispatch(self, send: Callable[[bytes], None], msgid: int,
                  method: str, params: Any, raw: bool,
                  conn_state: Dict[str, Any], trace: Any, dl: Any, pr: Any,
                  nbytes: int = 0) -> None:
        """Serve one request and answer it through ``send`` (the
        transport's writer of one response frame); ``raw`` says whether
        ``params`` is the undecoded span of a raw-registered method.
        ``nbytes`` is the request frame's size, billed as bytes in."""
        # adopt the caller's trace context (or root a fresh one), its
        # deadline AND its principal for the duration of the dispatch;
        # restore after — worker threads are reused
        ctx = tracing.from_wire(trace)
        ctx.peer = conn_state["peer"]
        prev = tracing.swap_trace(ctx)
        prev_dl = deadlines.swap(deadlines.adopt_wire(dl))
        p_req = principals.adopt_wire(pr)
        prev_pr = principals.swap(p_req)
        try:
            if raw:
                error, result = self._execute_fast(method, params)
            else:
                error, result = self._execute(method, params)
        finally:
            tracing.swap_trace(prev)
            deadlines.swap(prev_dl)
            principals.swap(prev_pr)
        bill = (method, p_req, nbytes)
        legacy = self.response_legacy(method, conn_state)
        if error is None and isinstance(result, concurrent.futures.Future):
            result.add_done_callback(
                lambda fut: self._reply_deferred(send, msgid, method, fut,
                                                 bill, legacy))
            return
        self._reply(send, msgid, error, result, bill, legacy)

    def _reply(self, send: Callable[[bytes], None], msgid, error, result,
               bill: Optional[tuple] = None, legacy: bool = False) -> None:
        payload = build_response(msgid, error, result, legacy=legacy)
        rec = self.usage_recorder
        if rec is not None and bill is not None:
            method, p_req, nbytes = bill
            rec.account(method, principal=p_req, resolve=False,
                        bytes_in=float(nbytes),
                        bytes_out=float(len(payload)))
        send(payload)

    def _reply_deferred(self, send: Callable[[bytes], None], msgid,
                        method: str,
                        fut: "concurrent.futures.Future",
                        bill: Optional[tuple] = None,
                        legacy: bool = False) -> None:
        """The response of a handler that answered with a future."""
        error, result = None, None
        try:
            result = fut.result()
        except BaseException as e:  # broad-ok — every failure must answer
            log.debug("rpc method %s raised", method, exc_info=True)
            self._note_error(method)
            error = error_to_wire(e)
        self._reply(send, msgid, error, result, bill, legacy)

    def _execute_fast(self, method: str, raw_params: bytes):
        """Raw-span invoke; falls back to the generic decode + handler when
        the fast fn declines (RAW_FALLBACK). The span is recorded here only
        when the fast path served the request — a fallback cancels it so
        the request is counted once, by _invoke's span."""
        fn = self._raw_methods[method]
        with self.trace.span(f"rpc.{method}") as sp:
            try:
                self._admit(method)
                result = fn(raw_params)
            except Exception as e:  # broad-ok — every failure must answer
                log.debug("rpc raw method %s raised", method, exc_info=True)
                self._note_error(method)
                return error_to_wire(e), None
            if result is not RAW_FALLBACK:
                return None, result
            sp.cancel()
        return self._execute(method, _unpack(raw_params))

    def _execute(self, method: str, params: Any):
        """Invoke + error taxonomy."""
        error, result = None, None
        try:
            result = self._invoke(method, params)
        except Exception as e:  # broad-ok — every failure must answer
            if not isinstance(e, RpcMethodNotFound):
                log.debug("rpc method %s raised", method, exc_info=True)
            self._note_error(method)
            error = error_to_wire(e)
        return error, result

    def _note_error(self, method: str) -> None:
        """Per-method failure counter (the dispatch span times success and
        failure alike, so the error rate needs its own series), and the
        usage ledger's error count."""
        self.trace.count(f"rpc.{method}.errors")
        rec = self.usage_recorder
        if rec is not None:
            rec.note_error(method)

    def _invoke(self, method: str, params: Any) -> Any:
        fn = self._methods.get(method)
        if fn is None:
            raise RpcMethodNotFound(method)
        params = list(params) if isinstance(params, (list, tuple)) else [params]
        want = self._arity.get(method)
        if want is not None and len(params) != want:
            raise TypeError(f"{method}: expected {want} params, got {len(params)}")
        self._admit(method)
        with self.trace.span(f"rpc.{method}"):
            return fn(*params)

    def _admit(self, method: str) -> None:
        """The checks before a handler runs: the dispatch fault site (fired
        BEFORE the deadline gate, so an injected delay can expire a
        propagated budget), the deadline, the drain gate."""
        if faults.is_armed():
            faults.fire(f"rpc.dispatch.{method}")
        self._check_deadline(method)
        gate = self.dispatch_gate
        if gate is not None:
            gate(method)

    def _check_deadline(self, method: str) -> None:
        """Reject already-expired work at dispatch: computing an answer
        nobody is waiting for only steals capacity from live requests.
        Counted per server (``rpc.deadline_rejected``)."""
        if deadlines.expired():
            self.trace.count("rpc.deadline_rejected")
            raise DeadlineExceeded(f"{method}: deadline expired at dispatch")

    def _invoke_silent(self, method: str, params: Any) -> None:
        try:
            self._invoke(method, params)
        except Exception:  # broad-ok — a notify has no one to answer
            log.debug("rpc notify %s raised", method, exc_info=True)

    def response_legacy(self, method: str,
                        conn_state: Optional[Dict[str, Any]] = None) -> bool:
        """Whether this method's responses go out in the old wire format:
        forced globally by --legacy-wire, or detected per connection
        (wire_detect). Binary methods always answer modern."""
        if method in self._binary_methods:
            return False
        if self.legacy_wire:
            return True
        return bool(conn_state and conn_state.get("legacy"))


def wire_is_legacy(raw: bytes) -> bool:
    """Fingerprint one request: True when it contains NO post-2013 msgpack
    type byte, i.e. the reference's vendored-msgpack client could have
    produced it. Such connections are answered in the legacy raw format,
    which modern unpackers also accept (old raw16/raw32 are modern
    str16/str32), so a false positive only costs the str/bytes distinction
    a modern client never relied on for the jubatus API. Skip-style scan,
    budget-capped (``legacy.scan_is_legacy``): no values are built."""
    return _legacy.scan_is_legacy(raw)


def deferred(fn: Callable[..., Any], name: str = "rpc-deferred"
             ) -> Callable[..., "concurrent.futures.Future"]:
    """``fn`` as a handler that frees its worker: each call runs ``fn`` on
    a daemon thread of its own and answers with a future of its result."""
    def call(*args: Any) -> "concurrent.futures.Future":
        fut: "concurrent.futures.Future" = concurrent.futures.Future()

        def run() -> None:
            try:
                fut.set_result(fn(*args))
            except BaseException as e:  # broad-ok — the caller gets it
                fut.set_exception(e)

        threading.Thread(target=run, daemon=True, name=name).start()
        return fut

    return call


def _shutdown(sock: socket.socket) -> None:
    try:
        sock.shutdown(socket.SHUT_RDWR)
    except OSError:  # not connected, or already shut
        pass


def build_response(msgid: int, error: Any, result: Any,
                   legacy: bool = False) -> bytes:
    """Pack one msgpack-rpc response message. A ``RawResult`` is spliced
    in as its pre-encoded span (fixarray(4) + RESPONSE + msgid + nil
    error + the span), with no decode/encode of the payload.
    ``legacy=True`` packs in the pre-2013 format (``legacy.packb``:
    strings and bytes both go out as old "raw"), so a RawResult is
    decoded and re-packed."""
    if isinstance(result, RawResult):
        if error is None and not legacy:
            return (b"\x94\x01" + msgpack.packb(msgid) + b"\xc0"
                    + result.span)
        result = _unpack(result.span)
    if legacy:
        return _legacy.packb([RESPONSE, msgid, error, result],
                             default=_to_wire)
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
