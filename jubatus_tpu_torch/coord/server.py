"""Standalone coordination service — the framework's own ZooKeeper-role
daemon (``jubacoordd``; copy of ``jubatus_tpu/coord/server.py``).

The reference outsources membership/config/locks to a ZooKeeper quorum
(common/zk.cpp). This framework ships its own single-process coordination
server speaking the same MessagePack-RPC wire as everything else, so a
multi-host cluster needs no shared filesystem and no external system:

    python -m jubatus_tpu_torch.coord.server -p 2199 [--journal FILE]
    python -m jubatus_tpu_torch.server classifier -z tcp://host:2199 -n c1

The wire, the session and lease rules and the journal's records are the
JAX package's, so port and JAX servers, proxies and CLIs share one
``jubacoordd`` of either package.

Sessions are leases: each remote client opens a session and heartbeats
every lease/3 s; a session silent for a full lease expires and its
ephemeral nodes and locks are released (ZK session-expiry semantics,
the failure detector of SURVEY.md §5). Every session is backed by a
MemoryCoordinator on one shared store, so node/lock/watch semantics are
identical to the in-process backend the tests use.

Durability (``--journal FILE``): persistent nodes (configs), id counters,
and the sequence counter journal to disk (coord/journal.py) and recover
on restart; ephemerals and locks die with their sessions, and clients
RESUME sessions across a coordd restart (coord/remote.py re-opens and
re-creates its ephemerals within the resume window), so a kill/restart
of coordd loses neither configs nor membership. Availability model: a
single process, like a one-node ZK — down during the restart (clients
retry), journaled against process death, not host loss; a quorum backend
remains possible behind the Coordinator ABC.
"""

from __future__ import annotations

import argparse
import logging
import signal
import threading
import time
from typing import Dict, List, Optional, Tuple

from jubatus_tpu_torch.coord.memory import MemoryCoordinator, _Store
from jubatus_tpu_torch.rpc.server import RpcServer

log = logging.getLogger(__name__)

DEFAULT_LEASE_SEC = 10.0


class CoordServer:
    def __init__(self, lease_sec: float = DEFAULT_LEASE_SEC,
                 journal_path: Optional[str] = None) -> None:
        self.store = _Store()
        self.journal = None
        if journal_path:
            from jubatus_tpu_torch.coord.journal import Journal

            self.journal = Journal(journal_path)
            n = self.journal.replay_into(self.store)
            if n:
                log.info("journal: recovered %d records from %s",
                         n, journal_path)
            self.journal.open_and_compact(self.store)
            self.store.on_durable = self.journal.append
        self.lease_sec = lease_sec
        self.rpc = RpcServer()
        self._mu = threading.Lock()
        #: session id → (session-scoped MemoryCoordinator, last heartbeat)
        self._sessions: Dict[int, Tuple[MemoryCoordinator, float]] = {}
        #: serves the sessionless ops (set/read/list/...) — never owns
        #: ephemerals or locks, so one shared instance is fine
        self._root = MemoryCoordinator(self.store)
        self._stop_event = threading.Event()
        self._reaper = threading.Thread(target=self._expire_loop, daemon=True,
                                        name="coord-expire")
        for name, fn, arity in [
            ("coord_open", self.open_session, 0),
            ("coord_heartbeat", self.heartbeat, 1),
            ("coord_close", self.close_session, 1),
            ("coord_create", self.create, 4),
            ("coord_create_seq", self.create_seq, 3),
            ("coord_set", self.set, 2),
            ("coord_read", self.read, 1),
            ("coord_remove", self.remove, 1),
            ("coord_exists", self.exists, 1),
            ("coord_list", self.list, 1),
            ("coord_try_lock", self.try_lock, 2),
            ("coord_unlock", self.unlock, 2),
            ("coord_create_id", self.create_id, 1),
        ]:
            self.rpc.register(name, fn, arity=arity)

    # -- session lifecycle ----------------------------------------------------
    def open_session(self) -> List:
        import secrets

        with self._mu:
            # random 63-bit ids: a restarted coordd must never mint a sid a
            # previous incarnation handed out — a client resuming across the
            # restart calls coord_close(old_sid), and with sequential ids
            # that could close ANOTHER client's fresh session (membership
            # flapping during recovery)
            while True:
                sid = secrets.randbits(63) or 1
                if sid not in self._sessions:
                    break
            self._sessions[sid] = (MemoryCoordinator(self.store),
                                   time.monotonic())
        log.info("session %d opened", sid)
        return [sid, self.lease_sec]

    def heartbeat(self, sid: int) -> bool:
        with self._mu:
            entry = self._sessions.get(int(sid))
            if entry is None:
                return False  # expired: client must treat this as fatal
            self._sessions[int(sid)] = (entry[0], time.monotonic())
            return True

    def close_session(self, sid: int) -> bool:
        with self._mu:
            entry = self._sessions.pop(int(sid), None)
        if entry is None:
            return False
        entry[0].close()  # drops ephemerals + locks, fires watchers
        log.info("session %d closed", sid)
        return True

    def _expire_loop(self) -> None:
        while not self._stop_event.wait(self.lease_sec / 3):
            horizon = time.monotonic() - self.lease_sec
            with self._mu:
                dead = [sid for sid, (_mc, hb) in self._sessions.items()
                        if hb < horizon]
                entries = [self._sessions.pop(sid) for sid in dead]
            for sid, (mc, _hb) in zip(dead, entries):
                log.warning("session %d expired (no heartbeat)", sid)
                mc.close()

    def _mc(self, sid: int) -> MemoryCoordinator:
        with self._mu:
            entry = self._sessions.get(int(sid))
        if entry is None:
            raise KeyError(f"unknown or expired session {sid}")
        return entry[0]

    # -- store operations ------------------------------------------------------
    def create(self, sid: int, path: str, payload: bytes, ephemeral: bool) -> bool:
        return self._mc(sid).create(path, payload or b"", bool(ephemeral))

    def create_seq(self, sid: int, path: str, payload: bytes) -> Optional[str]:
        return self._mc(sid).create_seq(path, payload or b"")

    def set(self, path: str, payload: bytes) -> bool:
        return self._root.set(path, payload or b"")

    def read(self, path: str) -> Optional[bytes]:
        return self._root.read(path)

    def remove(self, path: str) -> bool:
        return self._root.remove(path)

    def exists(self, path: str) -> bool:
        return self._root.exists(path)

    def list(self, path: str) -> List[str]:
        return self._root.list(path)

    def try_lock(self, sid: int, path: str) -> bool:
        return self._mc(sid).try_lock(path)

    def unlock(self, sid: int, path: str) -> bool:
        return self._mc(sid).unlock(path)

    def create_id(self, path: str) -> int:
        return self._root.create_id(path)

    # -- lifecycle ------------------------------------------------------------
    def start(self, port: int = 2199, host: str = "0.0.0.0") -> int:
        actual = self.rpc.serve_background(port, nthreads=4, host=host)
        self._reaper.start()
        log.info("coordination service listening on %s:%d (lease %.1fs)",
                 host, actual, self.lease_sec)
        return actual

    def join(self) -> None:
        self._stop_event.wait()

    def stop(self) -> None:
        self._stop_event.set()
        self.rpc.stop()
        with self._mu:
            sessions = list(self._sessions.values())
            self._sessions.clear()
        for mc, _hb in sessions:
            mc.close()
        if self.journal is not None:
            self.journal.close()


def main(argv=None) -> int:
    p = argparse.ArgumentParser(prog="jubatus_tpu_torch.coord.server",
                                description="jubatus_tpu_torch coordination "
                                            "service")
    p.add_argument("-p", "--rpc-port", type=int, default=2199)
    p.add_argument("-b", "--listen-addr", default="0.0.0.0")
    p.add_argument("--lease-sec", type=float, default=DEFAULT_LEASE_SEC)
    p.add_argument("--journal", default="",
                   help="journal durable state (configs, id counters) to "
                        "this file and recover it on restart")
    ns = p.parse_args(argv)
    logging.basicConfig(level=logging.INFO,
                        format="%(asctime)s %(levelname)s [jubacoordd] %(message)s")
    srv = CoordServer(lease_sec=ns.lease_sec, journal_path=ns.journal or None)
    signal.signal(signal.SIGTERM, lambda *_: srv.stop())
    signal.signal(signal.SIGINT, lambda *_: srv.stop())
    srv.start(ns.rpc_port, ns.listen_addr)
    srv.join()
    return 0


if __name__ == "__main__":
    import sys

    sys.exit(main())
