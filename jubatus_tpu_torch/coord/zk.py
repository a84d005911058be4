"""Real ZooKeeper backend for the Coordinator ABC (``zk://host:port``;
copy of ``jubatus_tpu/coord/zk.py``).

Existing jubatus deployments run a ZK quorum and drive it with jubactl
muscle memory (reference jubatus/server/common/zk.cpp:88-675);
drop-in parity needs this framework to join the SAME quorum, and JAX and
port members on one ensemble see each other (same node paths and payload
bytes as the other coordinators). The image
ships no ZK client library, so this module speaks the ZooKeeper wire
protocol (jute serialization) directly over TCP — the subset the
reference uses: session handshake + pings, create (persistent /
ephemeral / sequence), delete, exists, getData, setData, getChildren,
one-shot watches (re-armed internally so the Coordinator ABC's
persistent-watch contract holds), and closeSession.

Semantics mapped onto the ABC:

- ``try_lock``: non-blocking ephemeral-create of the lock node (the
  reference zkmutex's try_lock is the same race: whoever creates the
  ephemeral wins; session death releases it, zk.hpp:126-139).
- ``create_id``: setData on the id node and use the returned stat
  version — each set bumps the version atomically, which is exactly how
  global_id_generator_zk mints ids (global_id_generator_zk.cpp:32-56).
- parents are auto-created (persistent) to honor the ABC contract; ZK
  itself requires explicit parents.

Connection model: one socket; a reader thread demultiplexes replies by
xid and delivers watch events (xid -1); a ping thread keeps the session
alive at timeout/3. Loss of the SOCKET is not loss of the SESSION: the
reader reconnects across the host list re-presenting sessionId+passwd
within the negotiated timeout — exactly libzookeeper's behavior
(reference zk.cpp:88 session watcher, zk.cpp:139-150 connect-wait) — and
the coordinator re-arms its watches, firing any delete that happened
while disconnected. In-flight calls during the gap fail with a retryable
connection-loss error (ZK cannot say whether they applied — same
contract as ZCONNECTIONLOSS). Only a server-side session expiry (resume
answered with session 0) fails all pending calls and fires delete
watchers (session-lost contract, same as coord/remote.py).

Tested against an in-process fake speaking the same wire
(tests/fake_zk.py) always, and against a REAL ZooKeeper when
``JUBATUS_TPU_ZK`` points at one (integration-gated like the
reference's --enable-zktest, wscript:138-139).
"""

from __future__ import annotations

import logging
import socket
import struct
import threading
from typing import Any, Callable, Dict, List, Optional, Tuple

from jubatus_tpu_torch.coord.base import Coordinator, CoordinatorError

log = logging.getLogger(__name__)

# ZooKeeper opcodes
OP_CREATE, OP_DELETE, OP_EXISTS, OP_GETDATA, OP_SETDATA = 1, 2, 3, 4, 5
OP_GETCHILDREN = 8
OP_PING, OP_CLOSE = 11, -11
XID_WATCH, XID_PING = -1, -2

# error codes (subset)
ZOK = 0
ZNONODE = -101
ZNODEEXISTS = -110
ZNOTEMPTY = -111
ZBADVERSION = -103
ZCONNECTIONLOSS = -4

# event types
EV_CREATED, EV_DELETED, EV_CHANGED, EV_CHILD = 1, 2, 3, 4

# create flags
F_EPHEMERAL, F_SEQUENCE = 1, 2

#: world:anyone ALL — the ACL the reference passes (ZOO_OPEN_ACL_UNSAFE)
_OPEN_ACL = (31, "world", "anyone")

#: event-queue sentinel: session resumed on a new socket, re-arm watches
_RECONNECTED = object()


class _Buf:
    """jute reader over a bytes span."""

    def __init__(self, data: bytes) -> None:
        self.data = data
        self.off = 0

    def i32(self) -> int:
        v = struct.unpack_from(">i", self.data, self.off)[0]
        self.off += 4
        return v

    def i64(self) -> int:
        v = struct.unpack_from(">q", self.data, self.off)[0]
        self.off += 8
        return v

    def b(self) -> bool:
        v = self.data[self.off] != 0
        self.off += 1
        return v

    def buf(self) -> Optional[bytes]:
        n = self.i32()
        if n < 0:
            return None
        out = self.data[self.off:self.off + n]
        self.off += n
        return out

    def s(self) -> str:
        raw = self.buf()
        return raw.decode("utf-8") if raw is not None else ""

    def stat(self) -> Dict[str, int]:
        names = ("czxid", "mzxid", "ctime", "mtime")
        st = {k: self.i64() for k in names}
        st["version"] = self.i32()
        st["cversion"] = self.i32()
        st["aversion"] = self.i32()
        st["ephemeralOwner"] = self.i64()
        st["dataLength"] = self.i32()
        st["numChildren"] = self.i32()
        st["pzxid"] = self.i64()
        return st


def _s(out: List[bytes], v: str) -> None:
    raw = v.encode("utf-8")
    out.append(struct.pack(">i", len(raw)) + raw)


def _buf(out: List[bytes], v: Optional[bytes]) -> None:
    if v is None:
        out.append(struct.pack(">i", -1))
    else:
        out.append(struct.pack(">i", len(v)) + v)


class ZkError(CoordinatorError):
    def __init__(self, code: int, path: str = "") -> None:
        super().__init__(f"zookeeper error {code} ({path})")
        self.code = code


class _SessionExpired(Exception):
    """Resume handshake answered with session 0: ZK expired the session."""


class ZkConnection:
    """One ZK session over one socket; thread-safe request dispatch."""

    def __init__(self, hosts: List[Tuple[str, int]],
                 session_timeout_ms: int = 10000) -> None:
        self.hosts = hosts
        self.session_timeout_ms = session_timeout_ms
        self._sock: Optional[socket.socket] = None
        self._wlock = threading.Lock()
        self._xid = 0
        self._xid_lock = threading.Lock()
        self._pending: Dict[int, Any] = {}  # xid -> [event, reply|None]
        self._pending_lock = threading.Lock()
        self._closed = False
        self.session_id = 0
        self._passwd = b"\x00" * 16
        #: set while a live socket carries the session; cleared during
        #: reconnect so call() can wait instead of failing spuriously
        self._up = threading.Event()
        self.on_event: Optional[Callable[[int, int, str], None]] = None
        self.on_session_lost: Optional[Callable[[], None]] = None
        #: fired (on the event-dispatch thread) after a successful
        #: in-session reconnect — the coordinator re-arms its watches here
        self.on_reconnected: Optional[Callable[[], None]] = None
        #: successful in-session reconnects (observability + tests)
        self.reconnect_count = 0
        #: events dispatch from their own thread — handlers re-arm watches
        #: with blocking calls, which would deadlock the reader (the reader
        #: is the only thread that can deliver those calls' replies)
        import queue

        self._events: "queue.Queue" = queue.Queue()
        self._connect()
        self._reader = threading.Thread(target=self._read_loop, daemon=True,
                                        name="zk-reader")
        self._reader.start()
        self._dispatcher = threading.Thread(target=self._event_loop,
                                            daemon=True, name="zk-events")
        self._dispatcher.start()
        self._pinger = threading.Thread(target=self._ping_loop, daemon=True,
                                        name="zk-ping")
        self._pinger.start()

    # -- wiring ---------------------------------------------------------------
    def _connect(self, resume: bool = False) -> None:
        """Establish a socket carrying this session. ``resume=True``
        re-presents sessionId+passwd (the reconnect path, ≙ libzookeeper's
        in-timeout reconnect, zk.cpp:139-150); raises _SessionExpired when
        ZK answers with session 0 — the session is genuinely gone."""
        last: Optional[Exception] = None
        for host, port in self.hosts:
            try:
                sock = socket.create_connection((host, port), timeout=10)
                sock.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
                # ConnectRequest
                req = b"".join([
                    struct.pack(">i", 0),            # protocolVersion
                    struct.pack(">q", 0),            # lastZxidSeen
                    struct.pack(">i", self.session_timeout_ms),
                    struct.pack(">q", self.session_id if resume else 0),
                    struct.pack(">i", len(self._passwd) if resume else 16),
                    self._passwd if resume else b"\x00" * 16,
                ])
                sock.sendall(struct.pack(">i", len(req)) + req)
                resp = self._read_frame_from(sock)
                rb = _Buf(resp)
                rb.i32()                              # protocolVersion
                negotiated = rb.i32()
                sid = rb.i64()
                passwd = rb.buf()
                if negotiated <= 0 or sid == 0:
                    if resume:
                        sock.close()
                        raise _SessionExpired()
                    raise CoordinatorError("zookeeper rejected the session")
                self.negotiated_ms = negotiated
                self.session_id = sid
                if passwd:
                    self._passwd = passwd
                # the connect timeout must NOT persist: the reader blocks in
                # recv between pings (interval = negotiated/3, which may
                # exceed 10s), and a spurious socket.timeout there would
                # fire the session-lost suicide path on a healthy session
                sock.settimeout(None)
                self._sock = sock
                self._up.set()
                return
            except (OSError, struct.error, CoordinatorError) as e:
                last = e
                continue
        raise CoordinatorError(f"cannot reach zookeeper at {self.hosts}: {last}")

    @staticmethod
    def _read_frame_from(sock: socket.socket) -> bytes:
        hdr = b""
        while len(hdr) < 4:
            chunk = sock.recv(4 - len(hdr))
            if not chunk:
                raise OSError("zookeeper connection closed")
            hdr += chunk
        (n,) = struct.unpack(">i", hdr)
        body = b""
        while len(body) < n:
            chunk = sock.recv(n - len(body))
            if not chunk:
                raise OSError("zookeeper connection closed")
            body += chunk
        return body

    def _read_loop(self) -> None:
        while not self._closed:
            try:
                frame = self._read_frame_from(self._sock)
                rb = _Buf(frame)
                xid = rb.i32()
                rb.i64()  # zxid
                err = rb.i32()
                if xid == XID_WATCH:
                    ev_type = rb.i32()
                    state = rb.i32()
                    path = rb.s()
                    self._events.put((ev_type, state, path))
                    continue
                if xid == XID_PING:
                    continue
            except Exception:  # noqa: BLE001 — a corrupt/truncated frame
                # means the stream is unusable, exactly like a dead socket:
                # resume the session on a fresh connection or die loudly —
                # the reader must NEVER exit silently (call()s would all
                # time out and the suicide contract would never fire)
                if self._closed:
                    break
                log.warning("zookeeper stream error; reconnecting",
                            exc_info=True)
                if self._try_resume():
                    continue
                self._fail_all()
                return
            with self._pending_lock:
                slot = self._pending.pop(xid, None)
            if slot is not None:
                slot[1] = (err, rb)
                slot[0].set()

    def _try_resume(self) -> bool:
        """Socket died: reconnect across the host list with the existing
        session credentials before the server expires the session. True =
        the session lives on a fresh socket (watch re-arm is queued for
        the dispatcher); False = expired or out of time — session is lost."""
        import time as _time

        self._up.clear()
        try:
            self._sock.close()
        except OSError:
            pass
        # in-flight replies died with the socket; their outcome is unknown
        # (ZCONNECTIONLOSS semantics — the op may or may not have applied)
        with self._pending_lock:
            pending = list(self._pending.values())
            self._pending.clear()
        for slot in pending:
            slot[1] = (ZCONNECTIONLOSS, None)
            slot[0].set()
        deadline = _time.monotonic() + self.negotiated_ms / 1000.0
        while not self._closed and _time.monotonic() < deadline:
            try:
                self._connect(resume=True)
            except _SessionExpired:
                log.error("zookeeper expired session 0x%x during reconnect",
                          self.session_id)
                return False
            except (CoordinatorError, OSError, struct.error):
                _time.sleep(0.2)
                continue
            log.warning("zookeeper session 0x%x resumed on a new socket",
                        self.session_id)
            self.reconnect_count += 1
            # dispatcher thread re-arms watches (blocking calls would
            # deadlock here: this IS the reader that delivers replies)
            self._events.put(_RECONNECTED)
            return True
        return False

    def _event_loop(self) -> None:
        while True:
            ev = self._events.get()
            if ev is None:
                return
            if ev is _RECONNECTED:
                if self.on_reconnected is not None:
                    try:
                        self.on_reconnected()
                    except Exception:  # noqa: BLE001
                        log.exception("zk reconnect re-arm failed")
                continue
            if self.on_event is not None:
                try:
                    self.on_event(*ev)
                except Exception:  # noqa: BLE001 — watcher's problem
                    log.exception("zk watch handler failed")

    def _fail_all(self) -> None:
        if self._closed:
            return
        self._closed = True
        self._up.set()  # unblock call()s parked on the reconnect gate
        with self._pending_lock:
            pending = list(self._pending.values())
            self._pending.clear()
        for slot in pending:
            slot[1] = (ZNONODE, None)  # delivered as session-lost below
            slot[0].set()
        self._events.put(None)  # stop the dispatcher
        if self.on_session_lost is not None:
            try:
                self.on_session_lost()
            except Exception:  # noqa: BLE001
                log.exception("zk session-lost handler failed")

    def _ping_loop(self) -> None:
        interval = max(self.negotiated_ms / 3000.0, 0.5)
        while not self._closed:
            threading.Event().wait(interval)
            if self._closed:
                return
            if not self._up.is_set():
                continue  # reconnect in progress; the reader owns recovery
            sock = self._sock  # the socket THIS ping used: shutting down
            # self._sock after a concurrent resume would kill the fresh one
            try:
                hdr = struct.pack(">ii", XID_PING, OP_PING)
                with self._wlock:
                    sock.sendall(struct.pack(">i", len(hdr)) + hdr)
            except OSError:
                # wake the reader (it may be blocked in recv on a socket
                # that only fails on write); it drives resume-or-die
                try:
                    sock.shutdown(socket.SHUT_RDWR)
                except OSError:
                    pass

    # -- request plumbing -----------------------------------------------------
    def call(self, opcode: int, payload: bytes, timeout: float = 10.0):
        if self._closed:
            raise CoordinatorError("zookeeper session closed")
        if not self._up.wait(timeout):
            # mid-reconnect and it didn't come back in time
            raise CoordinatorError("zookeeper connection lost (reconnecting)")
        if self._closed:
            raise CoordinatorError("zookeeper session closed")
        with self._xid_lock:
            self._xid += 1
            xid = self._xid
        slot = [threading.Event(), None]
        with self._pending_lock:
            self._pending[xid] = slot
        frame = struct.pack(">ii", xid, opcode) + payload
        sock = self._sock  # shut down the socket WE failed on, never a
        # fresh one a concurrent resume may have installed
        try:
            with self._wlock:
                sock.sendall(struct.pack(">i", len(frame)) + frame)
        except OSError as e:
            # socket died under us: the reader notices and resumes the
            # session; THIS call's outcome is unknown (connection loss)
            with self._pending_lock:
                self._pending.pop(xid, None)
            try:
                sock.shutdown(socket.SHUT_RDWR)  # wake the reader
            except OSError:
                pass
            raise CoordinatorError(
                f"zookeeper connection lost during send: {e}") from e
        if not slot[0].wait(timeout):
            with self._pending_lock:
                self._pending.pop(xid, None)
            raise CoordinatorError("zookeeper request timed out")
        err, rb = slot[1]
        if rb is None:
            if err == ZCONNECTIONLOSS:
                raise CoordinatorError(
                    "zookeeper connection lost mid-request (outcome "
                    "unknown; session resuming)")
            raise CoordinatorError("zookeeper session lost")
        return err, rb

    def close(self) -> None:
        if self._closed:
            return
        try:
            frame = struct.pack(">ii", 0, OP_CLOSE)
            with self._wlock:
                self._sock.sendall(struct.pack(">i", len(frame)) + frame)
        except OSError:
            pass
        self._closed = True
        self._up.set()  # unblock call()s parked on the reconnect gate
        # fail any in-flight call immediately: a thread blocked in call()
        # must not sit out its full timeout reporting a bogus "timed out"
        # when the session was intentionally closed
        with self._pending_lock:
            pending = list(self._pending.values())
            self._pending.clear()
        for slot in pending:
            slot[1] = (ZNONODE, None)
            slot[0].set()
        self._events.put(None)
        try:
            self._sock.close()
        except OSError:
            pass


class ZkCoordinator(Coordinator):
    """Coordinator ABC over a live ZooKeeper ensemble."""

    def __init__(self, hosts: List[Tuple[str, int]],
                 session_timeout_ms: int = 10000) -> None:
        self._conn = ZkConnection(hosts, session_timeout_ms)
        self._conn.on_event = self._on_event
        self._conn.on_session_lost = self._session_lost
        self._conn.on_reconnected = self._on_reconnected
        self._lock = threading.Lock()
        self._child_watchers: Dict[str, List[Callable[[str], None]]] = {}
        self._delete_watchers: Dict[str, List[Callable[[str], None]]] = {}
        self._held_locks: set = set()
        self._closed = False

    @classmethod
    def from_locator(cls, spec: str) -> "ZkCoordinator":
        """"zk://host:port[,host:port...]" → coordinator."""
        rest = spec[len("zk://"):] if spec.startswith("zk://") else spec
        hosts = []
        for part in rest.split(","):
            host, _, port = part.rpartition(":")
            if not host or not port.isdigit():
                raise CoordinatorError(f"bad zookeeper locator {spec!r}")
            hosts.append((host, int(port)))
        return cls(hosts)

    # -- watch re-arm machinery ----------------------------------------------
    def _on_event(self, ev_type: int, _state: int, path: str) -> None:
        # ZK watches are one-shot: re-arm BEFORE delivering so no change
        # slips between the event and the re-watch
        if ev_type == EV_CHILD or ev_type in (EV_CREATED, EV_DELETED):
            with self._lock:
                child_fns = list(self._child_watchers.get(path, ()))
            if child_fns:
                try:
                    if self._get_children(path, watch=True) is None:
                        # watched node deleted: a getChildren watch cannot
                        # arm on a missing node — fall back to an exists
                        # watch so recreation (EV_CREATED) re-enters here
                        # and restores the child watch
                        self._exists(path, watch=True)
                except CoordinatorError:
                    log.warning("child watch re-arm failed for %s "
                                "(will retry on next event)", path,
                                exc_info=True)
                for fn in child_fns:
                    try:
                        fn(path)
                    except Exception:  # noqa: BLE001
                        log.exception("child watcher failed for %s", path)
        if ev_type == EV_DELETED:
            with self._lock:
                del_fns = self._delete_watchers.pop(path, [])
            for fn in del_fns:
                try:
                    fn(path)
                except Exception:  # noqa: BLE001
                    log.exception("delete watcher failed for %s", path)
        elif ev_type in (EV_CREATED, EV_CHANGED):
            # a delete watch armed via exists() also fires on create/change;
            # re-arm it
            with self._lock:
                has_del = path in self._delete_watchers
            if has_del:
                try:
                    self._exists(path, watch=True)
                except CoordinatorError:
                    pass

    def _on_reconnected(self) -> None:
        """The session survived a socket loss on a fresh connection: ZK
        dropped our one-shot watches with the old socket, so re-arm every
        registered watch, and deliver anything that changed while we were
        away — a delete-watched node that vanished fires its handler NOW
        (the event itself is gone forever), and child watchers get one
        synthetic notification so membership readers resync."""
        from jubatus_tpu_torch.utils import tracing

        tracing.count("zk.session.reconnects")
        with self._lock:
            child_paths = list(self._child_watchers)
            del_paths = list(self._delete_watchers)
        for p in del_paths:
            try:
                present = self._exists(p, watch=True) is not None
            except CoordinatorError:
                log.warning("delete-watch re-arm failed for %s", p,
                            exc_info=True)
                continue
            if not present:
                with self._lock:
                    fns = self._delete_watchers.pop(p, [])
                for fn in fns:
                    try:
                        fn(p)
                    except Exception:  # noqa: BLE001
                        log.exception("delete watcher failed for %s", p)
        for p in child_paths:
            try:
                if self._get_children(p, watch=True) is None:
                    self._exists(p, watch=True)
            except CoordinatorError:
                log.warning("child-watch re-arm failed for %s", p,
                            exc_info=True)
            with self._lock:
                fns = list(self._child_watchers.get(p, ()))
            for fn in fns:
                try:
                    fn(p)
                except Exception:  # noqa: BLE001
                    log.exception("child watcher failed for %s", p)

    def _session_lost(self) -> None:
        log.error("zookeeper session lost; firing delete watchers")
        from jubatus_tpu_torch.utils import tracing

        tracing.count("zk.session.lost")
        with self._lock:
            taken = self._delete_watchers
            self._delete_watchers = {}
        for path, fns in taken.items():
            for fn in fns:
                try:
                    fn(path)
                except Exception:  # noqa: BLE001
                    log.exception("delete watcher failed for %s", path)

    # -- raw ops --------------------------------------------------------------
    def _create(self, path: str, payload: bytes, flags: int) -> Tuple[int, str]:
        out: List[bytes] = []
        _s(out, path)
        _buf(out, payload)
        perms, scheme, ident = _OPEN_ACL
        out.append(struct.pack(">i", 1))  # one ACL
        out.append(struct.pack(">i", perms))
        _s(out, scheme)
        _s(out, ident)
        out.append(struct.pack(">i", flags))
        err, rb = self._conn.call(OP_CREATE, b"".join(out))
        return err, (rb.s() if err == ZOK else "")

    def _mkparents(self, path: str) -> None:
        parts = path.strip("/").split("/")
        cur = ""
        for p in parts[:-1]:
            cur += "/" + p
            err, _ = self._create(cur, b"", 0)
            if err not in (ZOK, ZNODEEXISTS):
                raise ZkError(err, cur)

    def _exists(self, path: str, watch: bool = False) -> Optional[Dict]:
        out: List[bytes] = []
        _s(out, path)
        out.append(b"\x01" if watch else b"\x00")
        err, rb = self._conn.call(OP_EXISTS, b"".join(out))
        if err == ZNONODE:
            return None
        if err != ZOK:
            raise ZkError(err, path)
        return rb.stat()

    def _get_children(self, path: str,
                      watch: bool = False) -> Optional[List[str]]:
        """None = node absent (and, NB, no child watch armed — ZK refuses
        getChildren watches on missing nodes; callers that need to survive
        deletion must fall back to an exists watch)."""
        out: List[bytes] = []
        _s(out, path)
        out.append(b"\x01" if watch else b"\x00")
        err, rb = self._conn.call(OP_GETCHILDREN, b"".join(out))
        if err == ZNONODE:
            return None
        if err != ZOK:
            raise ZkError(err, path)
        n = rb.i32()
        return sorted(rb.s() for _ in range(n))

    # -- Coordinator ABC ------------------------------------------------------
    def create(self, path: str, payload: bytes = b"",
               ephemeral: bool = False) -> bool:
        self._mkparents(path)
        err, _ = self._create(path, payload,
                              F_EPHEMERAL if ephemeral else 0)
        if err == ZNODEEXISTS:
            return False
        if err != ZOK:
            raise ZkError(err, path)
        return True

    def create_seq(self, path: str, payload: bytes = b"") -> Optional[str]:
        self._mkparents(path)
        err, actual = self._create(path, payload, F_EPHEMERAL | F_SEQUENCE)
        if err != ZOK:
            raise ZkError(err, path)
        return actual

    def set(self, path: str, payload: bytes) -> bool:
        out: List[bytes] = []
        _s(out, path)
        _buf(out, payload)
        out.append(struct.pack(">i", -1))  # any version
        err, _ = self._conn.call(OP_SETDATA, b"".join(out))
        if err == ZNONODE:
            self._mkparents(path)
            cerr, _ = self._create(path, payload, 0)
            if cerr == ZOK:
                return True
            if cerr == ZNODEEXISTS:
                return self.set(path, payload)
            raise ZkError(cerr, path)
        if err != ZOK:
            raise ZkError(err, path)
        return True

    def read(self, path: str) -> Optional[bytes]:
        out: List[bytes] = []
        _s(out, path)
        out.append(b"\x00")
        err, rb = self._conn.call(OP_GETDATA, b"".join(out))
        if err == ZNONODE:
            return None
        if err != ZOK:
            raise ZkError(err, path)
        return rb.buf() or b""

    def remove(self, path: str) -> bool:
        out: List[bytes] = []
        _s(out, path)
        out.append(struct.pack(">i", -1))
        err, _ = self._conn.call(OP_DELETE, b"".join(out))
        if err == ZNONODE:
            return False
        if err == ZNOTEMPTY:
            # the ABC removes subtrees implicitly nowhere, but membership
            # cleanup may target non-empty dirs: refuse like ZK does
            raise ZkError(err, path)
        if err != ZOK:
            raise ZkError(err, path)
        return True

    def exists(self, path: str) -> bool:
        return self._exists(path) is not None

    def list(self, path: str) -> List[str]:
        return self._get_children(path) or []

    def watch_children(self, path: str, fn: Callable[[str], None]) -> None:
        with self._lock:
            self._child_watchers.setdefault(path, []).append(fn)
        # parents must exist for the watch to arm
        self._mkparents(path + "/x")
        err, _ = self._create(path, b"", 0)
        if err not in (ZOK, ZNODEEXISTS):
            raise ZkError(err, path)
        self._get_children(path, watch=True)

    def watch_delete(self, path: str, fn: Callable[[str], None]) -> None:
        with self._lock:
            self._delete_watchers.setdefault(path, []).append(fn)
        self._exists(path, watch=True)

    def _owned(self, path: str) -> Optional[bool]:
        """Whether this session owns the ephemeral at ``path`` (None: no
        node). Only the owning session creates or deletes a lock node, so
        the answer cannot change under us while we own it."""
        st = self._exists(path)
        if st is None:
            return None
        return st["ephemeralOwner"] == self._conn.session_id

    def try_lock(self, path: str) -> bool:
        with self._lock:
            if path in self._held_locks:
                return True
        self._mkparents(path)
        err, _ = self._create(path, b"", F_EPHEMERAL)
        # ZNODEEXISTS on our own node: an earlier create was applied but
        # its reply was lost to a connection blip (the caller saw an
        # error); the lock is ours, or nobody could ever take it again
        if err == ZOK or (err == ZNODEEXISTS and self._owned(path)):
            with self._lock:
                self._held_locks.add(path)
            return True
        if err == ZNODEEXISTS:
            return False
        raise ZkError(err, path)

    def unlock(self, path: str) -> bool:
        with self._lock:
            if path not in self._held_locks:
                return False
        # remove FIRST and drop membership only once the node is gone: a
        # remove that raises keeps membership, so the caller's retry loop
        # works across reconnects (session_grace keeps the session alive).
        # Remove only our own node: when a blip lost the reply to an
        # applied delete, another session may hold the lock by the retry,
        # and an unconditional delete would release ITS lock (two holders)
        if self._owned(path):
            self.remove(path)
        with self._lock:
            self._held_locks.discard(path)
        # no node, or another session's: the lock is no longer ours
        # either way, so the release succeeded
        return True

    def create_id(self, path: str) -> int:
        # setData bumps the node version atomically — the version IS the
        # counter (global_id_generator_zk.cpp:32-56 uses the same trick)
        out: List[bytes] = []
        _s(out, path)
        _buf(out, b"")
        out.append(struct.pack(">i", -1))
        err, rb = self._conn.call(OP_SETDATA, b"".join(out))
        if err == ZNONODE:
            self._mkparents(path)
            cerr, _ = self._create(path, b"", 0)
            if cerr not in (ZOK, ZNODEEXISTS):
                raise ZkError(cerr, path)
            return self.create_id(path)
        if err != ZOK:
            raise ZkError(err, path)
        return rb.stat()["version"]

    def close(self) -> None:
        if self._closed:
            return
        self._closed = True
        self._conn.on_session_lost = None  # intentional close: no suicide
        self._conn.close()
