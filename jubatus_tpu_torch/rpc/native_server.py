"""Native-transport RPC server (copy of ``jubatus_tpu/rpc/native_server.py``):
the C++ front-end (``native/rpc_frontend.cpp``) owns sockets, buffering and
msgpack framing; Python owns dispatch and response serialization, the split
of the reference, whose transport plane (the mpio event loop and the
msgpack-rpc framing) is C++ under C++ handlers.

``NativeRpcServer`` is an ``RpcServer`` (rpc/server.py) on another
transport: the same method table, admission (dispatch fault site,
deadline, drain gate), spans, error taxonomy, usage billing, legacy-wire
answers and deferred (future) replies, all through ``RpcServer._dispatch``
with a writer that hands the packed response to ``jt_rpc_respond``. It is
the DEFAULT transport of engine servers and proxies (``create_rpc_server``);
``JUBATUS_TPU_NATIVE_RPC=0`` (or ``false`` / ``no``) selects the Python
one. Internal services (jubacoordd, the mixers' planes, the visor) build
an ``RpcServer`` directly.

The library is built by ``jubatus_tpu_torch.native.ensure_built`` into
``build/torch_native/``. Unlike the JAX package, which quietly serves the
Python transport when ``g++`` cannot build the front-end, a failed build
raises ``NativeBuildError`` with the compiler's output: the caller asked
for the native transport.

Requests arrive through a ctypes callback on the connection's C++ reader
thread, carrying (conn, msgid, method, raw params span, envelope flags).
Flag bit 0: the method name came as str8, proof of a post-2013 client
(the era pin of ``RpcClient.call_raw``); bit 1: an extended 5-7-element
envelope, whose trace / deadline / principal elements end the span and
are split off here (``split_extras``). Small requests dispatch inline on
the reader thread; raw-registered requests whose params span is at least
``_POOL_THRESHOLD`` bytes dispatch on a 64-worker pool, so a pipelined
connection's queued train calls are in flight at once and join the same
device flush. Either way responses correlate by msgid and per-connection
order is NOT guaranteed, the Python transport's pipelining contract.

The C++ relay plane (proxies only): ``relay_config`` hands the C++ side a
routing table of methods and clusters; a request for such a method and
cluster is forwarded verbatim to a backend over a per-(client connection,
cluster) pipe and its response streams back without entering Python.
``relay_stats`` reads the per-method counts and the synthesized
backend-loss answers (``__errors__``).
"""

from __future__ import annotations

import ctypes
import functools
import logging
import os
import threading
from concurrent.futures import ThreadPoolExecutor
from typing import Any, Dict, Mapping, Optional, Sequence, Tuple

from jubatus_tpu_torch import native
from jubatus_tpu_torch.rpc import principal as principals
from jubatus_tpu_torch.rpc.errors import error_to_wire
from jubatus_tpu_torch.rpc.server import (RpcServer, _unpack, split_extras,
                                          wire_is_legacy)
from jubatus_tpu_torch.utils.tracing import Registry

log = logging.getLogger(__name__)

# method is POINTER(c_char), NOT c_char_p: the span is not NUL-terminated
# (the params bytes follow it) and c_char_p would strlen past it
_REQUEST_CB = ctypes.CFUNCTYPE(
    None, ctypes.c_uint64, ctypes.c_uint64, ctypes.POINTER(ctypes.c_char),
    ctypes.c_int64, ctypes.POINTER(ctypes.c_uint8), ctypes.c_int64,
    ctypes.c_int32)

_lib_lock = threading.Lock()
_lib: Optional[ctypes.CDLL] = None


def _load_lib() -> ctypes.CDLL:
    """Build and load the front-end once; raises NativeBuildError."""
    global _lib
    with _lib_lock:
        if _lib is not None:
            return _lib
        lib = native.load("rpc_frontend")
        lib.jt_rpc_create.restype = ctypes.c_void_p
        lib.jt_rpc_create.argtypes = [_REQUEST_CB]
        lib.jt_rpc_listen.restype = ctypes.c_int
        lib.jt_rpc_listen.argtypes = [ctypes.c_void_p, ctypes.c_char_p,
                                      ctypes.c_int, ctypes.c_int]
        lib.jt_rpc_respond.restype = ctypes.c_int
        lib.jt_rpc_respond.argtypes = [ctypes.c_void_p, ctypes.c_uint64,
                                       ctypes.c_char_p, ctypes.c_int64]
        lib.jt_rpc_stop.restype = None
        lib.jt_rpc_stop.argtypes = [ctypes.c_void_p]
        lib.jt_rpc_destroy.restype = None
        lib.jt_rpc_destroy.argtypes = [ctypes.c_void_p]
        lib.jt_rpc_relay_config.restype = ctypes.c_int
        lib.jt_rpc_relay_config.argtypes = [
            ctypes.c_void_p, ctypes.c_char_p, ctypes.c_char_p,
            ctypes.c_double, ctypes.c_double]
        lib.jt_rpc_relay_stats.restype = ctypes.c_int64
        lib.jt_rpc_relay_stats.argtypes = [ctypes.c_void_p, ctypes.c_char_p,
                                           ctypes.c_int64]
        _lib = lib
        return _lib


def available() -> bool:
    """Whether the front-end builds and loads here."""
    try:
        _load_lib()
    except native.NativeBuildError:
        return False
    return True


def _frame_bytes(msgid: int, method_len: int, flags: int,
                 span_len: int) -> int:
    """Size of the request frame as a client encodes it (minimal
    encodings): the array header, the type, the msgid, the method name's
    header and bytes, and the params span with its trailing elements.
    The Python transport bills the frame it read; this bills the same."""
    if msgid < 0x80:
        mid = 1
    elif msgid <= 0xFF:
        mid = 2
    elif msgid <= 0xFFFF:
        mid = 3
    elif msgid <= 0xFFFFFFFF:
        mid = 5
    else:
        mid = 9
    if flags & 1:
        hdr = 2                      # str8
    elif method_len < 32:
        hdr = 1                      # fixstr
    elif method_len <= 0xFFFF:
        hdr = 3                      # str16
    else:
        hdr = 5
    return 2 + mid + hdr + method_len + span_len


class NativeRpcServer(RpcServer):
    """``RpcServer`` over the C++ transport."""

    #: msgid sentinel the C++ side uses for notifications
    _NOTIFY = (1 << 64) - 1
    #: msgid sentinel the C++ side sends when a connection closes
    _CLOSE = (1 << 64) - 2
    #: params size from which raw requests dispatch on the bulk pool
    _POOL_THRESHOLD = 4096
    #: wire-era fingerprints kept at most (one per live connection)
    _CONN_CAP = 4096

    def __init__(self, trace: Optional[Registry] = None,
                 legacy_wire: bool = False,
                 wire_detect: bool = False) -> None:
        super().__init__(trace=trace, legacy_wire=legacy_wire,
                         wire_detect=wire_detect)
        self._lib = _load_lib()
        #: conn_id -> its wire-era state ({"legacy", "peer", "nreq"});
        #: entries die with their connection (the _CLOSE sentinel), the
        #: cap is a backstop against more live connections than it holds
        self._conn_wire: Dict[int, Dict[str, Any]] = {}
        self._wire_lock = threading.Lock()
        # 64: a PROXY's bulk handler blocks its worker on the backend
        # round trip, so the pool covers the whole in-flight depth (16
        # pipelined clients x depth 4); idle workers are never started
        self._bulk_pool = ThreadPoolExecutor(
            max_workers=64, thread_name_prefix="native-rpc-bulk")
        # the callback object lives as long as the server
        self._cb = _REQUEST_CB(self._on_request)
        self._handle = self._lib.jt_rpc_create(self._cb)
        self._stopped = False

    # -- C++ -> Python ---------------------------------------------------------
    def _on_request(self, conn_id, msgid, method, method_len, params_ptr,
                    params_len, flags) -> None:
        """Runs on the connection's C++ reader thread; never raises into
        C++."""
        if msgid == self._CLOSE:
            with self._wire_lock:
                self._conn_wire.pop(conn_id, None)
            return
        if self._stopped:
            return
        try:
            name = ctypes.string_at(method, method_len).decode(
                "utf-8", "surrogateescape")
            span = ctypes.string_at(params_ptr, params_len)
            self._serve(conn_id, msgid, name, span, int(flags),
                        _frame_bytes(msgid, method_len, flags, params_len))
        except Exception:  # broad-ok — never raise into C++
            log.exception("native rpc dispatch failed")

    def _serve(self, conn_id: int, msgid: int, method: str, span: bytes,
               flags: int, nbytes: int) -> None:
        if msgid == self._NOTIFY:
            self._invoke_silent(method, _unpack(span))
            return
        conn_state = self._conn_state(conn_id, bool(flags & 1), span, nbytes)
        params, trace, dl, pr = span, None, None, None
        if flags & 2:
            params, trace, dl, pr = split_extras(span, 0)
        send = functools.partial(self._respond, conn_id)
        if method in self._raw_methods:
            args = (send, msgid, method, params, True, conn_state, trace, dl,
                    pr, nbytes)
            if len(params) >= self._POOL_THRESHOLD:
                self._bulk_pool.submit(self._dispatch, *args)
            else:
                self._dispatch(*args)
            return
        try:
            decoded = _unpack(params)
        except Exception as e:  # broad-ok — undecodable params must answer
            self._reply(send, msgid, error_to_wire(e), None,
                        (method, principals.adopt_wire(pr), nbytes),
                        self.response_legacy(method, conn_state))
            return
        self._dispatch(send, msgid, method, decoded, False, conn_state,
                       trace, dl, pr, nbytes)

    def _conn_state(self, conn_id: int, envelope_modern: bool, span: bytes,
                    nbytes: int) -> Dict[str, Any]:
        """The connection's wire era, fingerprinted as the Python
        transport does (rpc/server.py ``_conn_loop``): every small request
        and the power-of-2-numbered bulk ones are scanned while the
        verdict is legacy, and a modern verdict latches. The C++ framer
        strips the envelope, so the str8 evidence of the method name
        arrives as flag bit 0."""
        if not self.wire_detect or self.legacy_wire:
            return {"legacy": False, "peer": ""}
        with self._wire_lock:
            st = self._conn_wire.get(conn_id)
            if st is None:
                if len(self._conn_wire) >= self._CONN_CAP:
                    self._conn_wire.pop(next(iter(self._conn_wire)))
                st = self._conn_wire[conn_id] = {
                    "legacy": False, "peer": "", "nreq": 0, "scanning": True}
        if st["scanning"]:
            st["nreq"] += 1
            nreq = st["nreq"]
            if nbytes <= 1024 or (nreq & (nreq - 1)) == 0:
                st["legacy"] = (not envelope_modern) and wire_is_legacy(span)
                st["scanning"] = st["legacy"]
        return st

    def _respond(self, conn_id: int, payload: bytes) -> None:
        """One response frame onto the client connection (any thread)."""
        if self._stopped:
            return  # the C++ handle may be going away
        self._lib.jt_rpc_respond(self._handle, conn_id, payload,
                                 len(payload))

    # -- the C++ relay plane (proxies only) ----------------------------------
    def relay_config(self, methods: Sequence[str],
                     clusters: Mapping[str, Sequence[Tuple[str, int]]],
                     timeout: float = 10.0,
                     idle_expire: float = 60.0) -> bool:
        """Route ``methods`` for ``clusters`` in C++: the request frame goes
        verbatim to a backend of its cluster on a per-(client connection,
        cluster) pipe and the response streams back without entering
        Python. ``clusters`` maps a cluster name to its ``(host, port)``
        list; the table is replaced wholesale. A request the C++ side
        declines (unknown cluster, dead pipe) is served by the registered
        Python handler."""
        if self._stopped:
            return False
        spec = "\n".join(
            f"{name}\t" + ",".join(f"{h}:{p}" for h, p in nodes)
            for name, nodes in clusters.items() if nodes)
        rc = self._lib.jt_rpc_relay_config(
            self._handle, "\n".join(methods).encode(), spec.encode(),
            float(timeout), float(idle_expire))
        return rc == 0

    def relay_stats(self) -> Dict[str, int]:
        """Per-method relayed-request counts (relayed requests never reach
        Python); the reserved ``__errors__`` key counts the synthesized
        backend-loss answers."""
        cap = 1 << 16
        while True:
            buf = ctypes.create_string_buffer(cap)
            n = self._lib.jt_rpc_relay_stats(self._handle, buf, cap)
            if n >= 0:
                out: Dict[str, int] = {}
                for line in buf.raw[:n].decode().splitlines():
                    m, _, c = line.partition("\t")
                    if m:
                        out[m] = int(c)
                return out
            cap = -int(n) + 16

    # -- lifecycle --------------------------------------------------------------
    def serve_background(self, port: int = 0, nthreads: int = 2,
                         host: str = "0.0.0.0") -> int:
        """Listen; concurrency comes from the C++ per-connection reader
        threads and the bulk pool, so ``nthreads`` is unused."""
        rc = self._lib.jt_rpc_listen(self._handle, host.encode(), port, 128)
        if rc < 0:
            raise OSError(-rc, os.strerror(-rc))
        self.port = rc
        return rc

    def stop(self) -> None:
        """Drop the queued bulk work, then stop the C++ side, which shuts
        every connection down and waits for its reader threads and relay
        pumps (so no handler may call it). In-flight bulk tasks and
        deferred replies answer nothing after this."""
        if self._stopped:
            return
        self._stopped = True
        self._bulk_pool.shutdown(wait=False, cancel_futures=True)
        self._lib.jt_rpc_stop(self._handle)

    def __del__(self) -> None:
        try:
            if getattr(self, "_handle", None):
                self.stop()
                # the handle must not be DESTROYED under an in-flight bulk
                # task: drain the pool first
                self._bulk_pool.shutdown(wait=True)
                self._lib.jt_rpc_destroy(self._handle)
                self._handle = None
        except Exception:  # broad-ok — interpreter teardown
            pass


def create_rpc_server(trace: Optional[Registry] = None,
                      legacy_wire: bool = False,
                      wire_detect: bool = True) -> RpcServer:
    """The transport of the jubatus-facing planes (engine servers and
    proxies): the C++ one unless ``JUBATUS_TPU_NATIVE_RPC`` is ``0`` /
    ``false`` / ``no``, with per-connection legacy-wire detection on by
    default, so an unmodified deployed client works with no flags. A
    failed build of the front-end raises ``NativeBuildError``."""
    native_rpc = os.environ.get("JUBATUS_TPU_NATIVE_RPC", "") not in \
        ("0", "false", "no")
    cls = NativeRpcServer if native_rpc else RpcServer
    return cls(trace=trace, legacy_wire=legacy_wire, wire_detect=wire_detect)
