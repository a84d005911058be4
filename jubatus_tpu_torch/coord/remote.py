"""Remote coordinator client (copy of ``jubatus_tpu/coord/remote.py``) —
sessions on the coordination service (coord/server.py, or the JAX
package's), selected by a ``tcp://host:port`` or ``host:port`` locator.

Semantics match the ZooKeeper client the reference uses (common/zk.cpp):

- ephemeral nodes and locks belong to a server-side session kept alive by
  a heartbeat thread (lease/3 cadence, ≙ ZK ticks);
- on heartbeat failure or an expired-session reply the client first tries
  to RESUME: re-open a session and re-create its ephemerals from the
  local registry, retrying for ``resume_window_sec`` (3 leases). This is
  what lets a journaled coordd (coord/server.py --journal) restart
  without losing cluster membership — the reference instead suicides on
  ZK session expiry and relies on jubavisor to respawn the process.
  Locks are NOT resumed (they were observably lost; holders re-acquire
  per round, linear_mixer master_lock semantics);
- only when resumption times out do my ephemerals count as gone
  cluster-wide: the client fires its delete watchers (→ the server's
  suicide watcher stops it) and closes, the same cleanup contract as the
  reference's connection-loss stack (zk push_cleanup(&shutdown_server),
  server_helper.cpp:56);
- watches are client-side polls (0.5 s): child watchers diff list(path),
  delete watchers poll exists(path) — the cached_zk/file-backend pattern.
"""

from __future__ import annotations

import logging
import threading
from typing import Callable, Dict, List, Optional, Set

from jubatus_tpu_torch.coord.base import Coordinator, CoordinatorError
from jubatus_tpu_torch.rpc.client import RpcClient

log = logging.getLogger(__name__)

_WATCH_POLL_SEC = 0.5
_HEARTBEAT_FAILURE_LIMIT = 3


class RemoteCoordinator(Coordinator):
    def __init__(self, host: str, port: int, timeout: float = 10.0,
                 resume_window_sec: Optional[float] = None) -> None:
        self.host = host
        self.port = port
        self._client = RpcClient(host, port, timeout)
        self._lock = threading.Lock()
        self._closed = False
        #: my live ephemerals (path → payload), re-created on session resume
        self._ephemerals: Dict[str, bytes] = {}
        try:
            sid, lease = self._client.call("coord_open")
        except Exception as e:
            raise CoordinatorError(
                f"cannot reach coordination service {host}:{port}: {e}") from e
        self._sid = int(sid)
        self.lease_sec = float(lease)
        self.resume_window_sec = (resume_window_sec
                                  if resume_window_sec is not None
                                  else 3.0 * self.lease_sec)
        self._child_watchers: Dict[str, List[Callable[[str], None]]] = {}
        self._child_snapshot: Dict[str, Set[str]] = {}
        self._delete_watchers: Dict[str, List[Callable[[str], None]]] = {}
        self._watch_thread: Optional[threading.Thread] = None
        #: set while the session is suspect (heartbeat failing / resuming):
        #: delete-watcher polls pause, or a poll racing the resume would
        #: see the restarted coordd before the ephemerals are re-created
        #: and suicide a healthy server
        self._suspect = threading.Event()
        self._hb_stop = threading.Event()
        self._hb = threading.Thread(target=self._heartbeat_loop, daemon=True,
                                    name="coord-remote-hb")
        self._hb.start()

    @classmethod
    def from_locator(cls, spec: str) -> "RemoteCoordinator":
        """"tcp://host:port" → client."""
        rest = spec[len("tcp://"):] if spec.startswith("tcp://") else spec
        host, _, port = rest.rpartition(":")
        if not host or not port.isdigit():
            raise CoordinatorError(f"bad coordinator locator {spec!r}")
        return cls(host, int(port))

    # -- session keepalive ----------------------------------------------------
    def _heartbeat_loop(self) -> None:
        failures = 0
        while not self._hb_stop.wait(self.lease_sec / 3):
            try:
                ok = self._client.call("coord_heartbeat", self._sid)
            except Exception:  # noqa: BLE001 — connection trouble
                self._suspect.set()
                failures += 1
                log.warning("coordinator heartbeat failed (%d/%d)",
                            failures, _HEARTBEAT_FAILURE_LIMIT)
                if failures >= _HEARTBEAT_FAILURE_LIMIT:
                    if self._try_resume():
                        failures = 0
                        self._suspect.clear()
                        continue
                    if self._closed:
                        return  # intentional shutdown, not a lost session
                    self._session_lost()
                    return
                continue
            if not ok:  # server says the session expired
                self._suspect.set()
                if self._try_resume():
                    failures = 0
                    self._suspect.clear()
                    continue
                if self._closed:
                    return
                self._session_lost()
                return
            failures = 0
            self._suspect.clear()

    def _try_resume(self) -> bool:
        """Re-establish the session after a coordd restart/expiry: open a
        fresh session and re-create my ephemerals, retrying for the resume
        window. True = resumed (heartbeating continues on the new sid)."""
        import time

        deadline = time.monotonic() + self.resume_window_sec
        old_sid = self._sid
        while not self._closed and time.monotonic() < deadline:
            try:
                sid, lease = self._client.call("coord_open")
            except Exception:  # noqa: BLE001 — coordd still down
                if self._hb_stop.wait(min(1.0, self.lease_sec / 3)):
                    return False
                continue
            try:
                # same coordd, old session still alive: free its ephemerals
                # so the re-creates below can't collide. Heartbeat-verify
                # first — after a coordd restart old_sid is unknown (or, if
                # ids could ever repeat, someone ELSE's session; coordd
                # mints from a random 63-bit space to make that impossible,
                # and this check keeps even a misconfigured store safe)
                if self._client.call("coord_heartbeat", old_sid):
                    self._client.call("coord_close", old_sid)
            except Exception:  # noqa: BLE001 — restarted coordd: no-op
                pass
            self._sid = int(sid)
            self.lease_sec = float(lease)
            with self._lock:
                mine = dict(self._ephemerals)
            ok = True
            for path, payload in mine.items():
                try:
                    if not self._client.call("coord_create", self._sid, path,
                                             payload, True):
                        # someone else now owns the path (e.g. a replacement
                        # node took my slot) — that is a real loss
                        ok = False
                except Exception:  # noqa: BLE001
                    ok = False
                    break
            if ok:
                log.warning("coordination session resumed (sid %d -> %d, "
                            "%d ephemerals re-created)",
                            old_sid, self._sid, len(mine))
                return True
            old_sid = self._sid  # free the half-resumed session next try
        return False

    def _session_lost(self) -> None:
        """My ephemerals are gone cluster-wide — run the cleanup contract:
        fire every delete watcher (suicide path), then close."""
        log.error("coordination session lost; firing delete watchers")
        with self._lock:
            # take ownership atomically: the watch loop pops under the same
            # lock, so no watcher can fire twice (once from each thread)
            taken = self._delete_watchers
            self._delete_watchers = {}
        watchers = [(p, fn) for p, fns in taken.items() for fn in fns]
        for path, fn in watchers:
            try:
                fn(path)
            except Exception:  # noqa: BLE001 — watcher errors are theirs
                log.exception("delete watcher failed for %s", path)
        self.close()

    # -- RPC plumbing ---------------------------------------------------------
    def _call(self, method: str, *args):
        if self._closed:
            raise CoordinatorError("coordinator session closed")
        return self._client.call(method, *args)

    # -- node CRUD ------------------------------------------------------------
    def create(self, path: str, payload: bytes = b"", ephemeral: bool = False) -> bool:
        ok = bool(self._call("coord_create", self._sid, path, payload,
                             ephemeral))
        if ok and ephemeral:
            with self._lock:
                self._ephemerals[path] = payload
        return ok

    def create_seq(self, path: str, payload: bytes = b"") -> Optional[str]:
        out = self._call("coord_create_seq", self._sid, path, payload)
        return out.decode() if isinstance(out, bytes) else out

    def set(self, path: str, payload: bytes) -> bool:
        return bool(self._call("coord_set", path, payload))

    def read(self, path: str) -> Optional[bytes]:
        out = self._call("coord_read", path)
        if out is None:
            return None
        return out if isinstance(out, bytes) else str(out).encode()

    def remove(self, path: str) -> bool:
        # drop the resume-registry entry only after the server confirms:
        # a failed RPC leaves the node alive server-side, and a later
        # session resume must still know to re-create/track it
        ok = bool(self._call("coord_remove", path))
        with self._lock:
            self._ephemerals.pop(path, None)
        return ok

    def exists(self, path: str) -> bool:
        return bool(self._call("coord_exists", path))

    def list(self, path: str) -> List[str]:
        return [c.decode() if isinstance(c, bytes) else c
                for c in self._call("coord_list", path)]

    # -- watchers (client-side polling) ---------------------------------------
    def _ensure_watch_thread(self) -> None:
        with self._lock:
            if self._watch_thread is not None:
                return
            self._watch_thread = threading.Thread(
                target=self._watch_loop, daemon=True, name="coord-remote-watch")
        self._watch_thread.start()

    def _watch_loop(self) -> None:
        while not self._hb_stop.wait(_WATCH_POLL_SEC):
            with self._lock:
                child_paths = list(self._child_watchers)
                delete_paths = list(self._delete_watchers)
            for path in child_paths:
                try:
                    now = set(self.list(path))
                except Exception:  # noqa: BLE001 — transient; retry next tick
                    continue
                old = self._child_snapshot.get(path)
                self._child_snapshot[path] = now
                if old is not None and now != old:
                    with self._lock:
                        fns = list(self._child_watchers.get(path, ()))
                    for fn in fns:
                        try:
                            fn(path)
                        except Exception:  # noqa: BLE001
                            log.exception("child watcher failed for %s", path)
            for path in delete_paths:
                if self._suspect.is_set():
                    break  # session suspect: absence may be transient
                try:
                    alive = self.exists(path)
                except Exception:  # noqa: BLE001
                    continue
                if not alive:
                    # ZK semantics: watches only fire within a valid
                    # session. A vanished node + a dead session means a
                    # coordd restart the resume path will repair — firing
                    # here would suicide a healthy server.
                    try:
                        if not self._client.call("coord_heartbeat",
                                                 self._sid):
                            self._suspect.set()
                            continue
                    except Exception:  # noqa: BLE001
                        self._suspect.set()
                        continue
                    with self._lock:
                        fns = self._delete_watchers.pop(path, [])
                    for fn in fns:
                        try:
                            fn(path)
                        except Exception:  # noqa: BLE001
                            log.exception("delete watcher failed for %s", path)

    def watch_children(self, path: str, fn: Callable[[str], None]) -> None:
        with self._lock:
            self._child_watchers.setdefault(path, []).append(fn)
        try:
            self._child_snapshot.setdefault(path, set(self.list(path)))
        except Exception:  # noqa: BLE001 — first poll will seed it
            pass
        self._ensure_watch_thread()

    def watch_delete(self, path: str, fn: Callable[[str], None]) -> None:
        with self._lock:
            self._delete_watchers.setdefault(path, []).append(fn)
        self._ensure_watch_thread()

    # -- locks / ids -----------------------------------------------------------
    def try_lock(self, path: str) -> bool:
        return bool(self._call("coord_try_lock", self._sid, path))

    def unlock(self, path: str) -> bool:
        return bool(self._call("coord_unlock", self._sid, path))

    def create_id(self, path: str) -> int:
        return int(self._call("coord_create_id", path))

    # -- lifecycle -------------------------------------------------------------
    def close(self) -> None:
        if self._closed:
            return
        self._closed = True
        self._hb_stop.set()
        try:
            self._client.call("coord_close", self._sid)
        except Exception:  # noqa: BLE001 — session will lease-expire anyway
            pass
        self._client.close()
