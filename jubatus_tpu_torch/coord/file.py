"""File-based coordinator (copy of ``jubatus_tpu/coord/file.py``):
multi-process clusters without ZooKeeper. The on-disk layout is the JAX
package's, so servers of both packages sharing one directory see each
other and contend for the same locks.

Maps the coordinator tree onto a shared directory:

- node /a/b/c            → <root>/a/b/c.node          (payload file)
- ephemeral node         → payload + <path>.lease file whose mtime a
                           background heartbeat refreshes every LEASE/3 s;
                           a node whose lease is older than LEASE is dead
                           (the reference's ZK session-expiry failure
                           detector, membership.cpp:100-112)
- lock /x                → <root>/x.lock created O_EXCL with pid+session,
                           stale if its lease expires
- counter /y             → <root>/y.ctr under an O_EXCL spin-lock

Works on local disk for single-host multi-process deployments; on a shared
filesystem it extends to multi-host (with the usual NFS mtime caveats — a
real ZK/etcd backend slots in behind the same ABC for production).
"""

from __future__ import annotations

import contextlib
import os
import threading
import time
import uuid
from typing import Callable, Dict, List, Optional

from jubatus_tpu_torch.coord.base import Coordinator, CoordinatorError

LEASE_SEC = 10.0
_WATCH_POLL_SEC = 0.5


class FileCoordinator(Coordinator):
    def __init__(self, root: str, lease_sec: float = LEASE_SEC) -> None:
        self.root = os.path.abspath(root)
        os.makedirs(self.root, exist_ok=True)
        self.lease_sec = lease_sec
        self.session = uuid.uuid4().hex
        self._ephemerals: List[str] = []  # fs paths of my lease files
        self._locks: List[str] = []
        self._mu = threading.Lock()
        self._closed = False
        self._watch_thread: Optional[threading.Thread] = None
        self._child_watchers: Dict[str, List[Callable[[str], None]]] = {}
        self._delete_watchers: Dict[str, List[Callable[[str], None]]] = {}
        self._hb = threading.Thread(target=self._heartbeat, daemon=True,
                                    name="coord-heartbeat")
        self._hb.start()

    # -- path mapping --------------------------------------------------------
    def _fs(self, path: str, suffix: str = ".node") -> str:
        clean = path.strip("/")
        if ".." in clean.split("/"):
            raise CoordinatorError(f"bad path {path!r}")
        return os.path.join(self.root, clean + suffix) if clean else self.root

    def _dir(self, path: str) -> str:
        clean = path.strip("/")
        return os.path.join(self.root, clean) if clean else self.root

    def _alive(self, fs_node: str) -> bool:
        lease = fs_node[: -len(".node")] + ".lease"
        if not os.path.exists(lease):
            return True  # persistent node
        try:
            return (time.time() - os.stat(lease).st_mtime) <= self.lease_sec
        except OSError:
            return False

    # -- heartbeat -----------------------------------------------------------
    def _heartbeat(self) -> None:
        while not self._closed:
            time.sleep(self.lease_sec / 3)
            with self._mu:
                paths = list(self._ephemerals) + [
                    p + ".hb" for p in self._locks
                ]
            now = time.time()
            for p in paths:
                real = p[: -len(".hb")] if p.endswith(".hb") else p
                with contextlib.suppress(OSError):
                    os.utime(real, (now, now))

    # -- node CRUD -----------------------------------------------------------
    def create(self, path: str, payload: bytes = b"", ephemeral: bool = False) -> bool:
        fs = self._fs(path)
        os.makedirs(os.path.dirname(fs), exist_ok=True)
        if os.path.exists(fs) and self._alive(fs):
            if not ephemeral:
                return False
            # Ephemeral nodes are identity-keyed (ip_port): a crash-restarted
            # process re-claiming its own path must take the lease over, or
            # the stale lease expires under it and the suicide watcher kills
            # the healthy new process. Newest claimant wins (unlike ZK, which
            # blocks until the old session expires).
            lease = fs[: -len(".node")] + ".lease"
            try:
                with open(lease, "r") as f:
                    if f.read().strip() == self.session:
                        return False  # genuinely ours already
            except OSError:
                return False  # persistent node of someone else
        tmp = fs + f".tmp.{self.session}"
        with open(tmp, "wb") as f:
            f.write(payload)
        os.replace(tmp, fs)
        lease = fs[: -len(".node")] + ".lease"
        if ephemeral:
            with open(lease, "wb") as f:
                f.write(self.session.encode())
            with self._mu:
                self._ephemerals.append(lease)
        else:
            # a dead session's stale lease must not shadow the new
            # persistent node
            with contextlib.suppress(OSError):
                os.remove(lease)
        return True

    def create_seq(self, path: str, payload: bytes = b"") -> Optional[str]:
        for _ in range(1000):
            n = self.create_id("/__seq__" + path)
            actual = f"{path}{n:010d}"
            if self.create(actual, payload, ephemeral=True):
                return actual
        return None

    def set(self, path: str, payload: bytes) -> bool:
        fs = self._fs(path)
        os.makedirs(os.path.dirname(fs), exist_ok=True)
        tmp = fs + f".tmp.{self.session}"
        with open(tmp, "wb") as f:
            f.write(payload)
        os.replace(tmp, fs)
        return True

    def read(self, path: str) -> Optional[bytes]:
        fs = self._fs(path)
        if not os.path.exists(fs) or not self._alive(fs):
            return None
        try:
            with open(fs, "rb") as f:
                return f.read()
        except OSError:
            return None

    def remove(self, path: str) -> bool:
        fs = self._fs(path)
        removed = False
        with contextlib.suppress(OSError):
            os.remove(fs)
            removed = True
        with contextlib.suppress(OSError):
            os.remove(fs[: -len(".node")] + ".lease")
        return removed

    def exists(self, path: str) -> bool:
        fs = self._fs(path)
        return os.path.exists(fs) and self._alive(fs)

    def list(self, path: str) -> List[str]:
        d = self._dir(path)
        if not os.path.isdir(d):
            return []
        out = []
        for entry in os.listdir(d):
            if entry.endswith(".node"):
                if self._alive(os.path.join(d, entry)):
                    out.append(entry[: -len(".node")])
            elif os.path.isdir(os.path.join(d, entry)):
                out.append(entry)
        return sorted(set(out))

    # -- watchers (polling) --------------------------------------------------
    def _ensure_watch_thread(self) -> None:
        if self._watch_thread is None:
            self._watch_thread = threading.Thread(
                target=self._watch_loop, daemon=True, name="coord-watch"
            )
            self._watch_thread.start()

    def _watch_loop(self) -> None:
        last_children: Dict[str, List[str]] = {}
        while not self._closed:
            time.sleep(_WATCH_POLL_SEC)
            with self._mu:
                child_paths = list(self._child_watchers)
                delete_paths = list(self._delete_watchers)
            for p in child_paths:
                cur = self.list(p)
                if p in last_children and cur != last_children[p]:
                    for fn in list(self._child_watchers.get(p, ())):
                        with contextlib.suppress(Exception):
                            fn(p)
                last_children[p] = cur
            for p in delete_paths:
                if not self.exists(p):
                    with self._mu:
                        fns = self._delete_watchers.pop(p, [])
                    for fn in fns:
                        with contextlib.suppress(Exception):
                            fn(p)

    def watch_children(self, path: str, fn: Callable[[str], None]) -> None:
        with self._mu:
            self._child_watchers.setdefault(path, []).append(fn)
        self._ensure_watch_thread()

    def watch_delete(self, path: str, fn: Callable[[str], None]) -> None:
        with self._mu:
            self._delete_watchers.setdefault(path, []).append(fn)
        self._ensure_watch_thread()

    # -- locks ---------------------------------------------------------------
    def try_lock(self, path: str) -> bool:
        fs = self._fs(path, ".lock")
        os.makedirs(os.path.dirname(fs), exist_ok=True)
        try:
            fd = os.open(fs, os.O_CREAT | os.O_EXCL | os.O_WRONLY)
        except FileExistsError:
            # steal stale locks (holder's heartbeat stopped)
            try:
                with open(fs, "r") as f:
                    holder = f.read().split()[0]
                if holder == self.session:
                    return True
                if (time.time() - os.stat(fs).st_mtime) > self.lease_sec:
                    # rename is the atomic claim: exactly one stealer wins;
                    # a plain remove would let a second stealer delete the
                    # winner's freshly created lock (two masters)
                    stale = fs + f".stale.{self.session}"
                    os.rename(fs, stale)
                    os.remove(stale)
                    return self.try_lock(path)
            except (OSError, IndexError):
                pass
            return False
        with os.fdopen(fd, "w") as f:
            f.write(f"{self.session} {os.getpid()}")
        with self._mu:
            self._locks.append(fs)
        return True

    def unlock(self, path: str) -> bool:
        fs = self._fs(path, ".lock")
        try:
            with open(fs, "r") as f:
                if f.read().split()[0] != self.session:
                    return False
            os.remove(fs)
        except (OSError, IndexError):
            return False
        with self._mu:
            with contextlib.suppress(ValueError):
                self._locks.remove(fs)
        return True

    # -- ids -----------------------------------------------------------------
    def create_id(self, path: str) -> int:
        fs = self._fs(path, ".ctr")
        os.makedirs(os.path.dirname(fs), exist_ok=True)
        guard = fs + ".guard"
        deadline = time.time() + 10.0
        while True:
            try:
                fd = os.open(guard, os.O_CREAT | os.O_EXCL | os.O_WRONLY)
                os.close(fd)
                break
            except FileExistsError:
                if time.time() > deadline:
                    with contextlib.suppress(OSError):
                        os.remove(guard)  # stale guard from a dead process
                else:
                    time.sleep(0.002)
        try:
            cur = 0
            with contextlib.suppress(OSError, ValueError):
                with open(fs, "r") as f:
                    cur = int(f.read() or 0)
            nxt = cur + 1
            tmp = fs + f".tmp.{self.session}"
            with open(tmp, "w") as f:
                f.write(str(nxt))
            os.replace(tmp, fs)
            return nxt
        finally:
            with contextlib.suppress(OSError):
                os.remove(guard)

    # -- lifecycle -----------------------------------------------------------
    def close(self) -> None:
        if self._closed:
            return
        self._closed = True
        with self._mu:
            leases = list(self._ephemerals)
            locks = list(self._locks)
            self._ephemerals.clear()
            self._locks.clear()
        for lease in leases:
            with contextlib.suppress(OSError):
                os.remove(lease)
            with contextlib.suppress(OSError):
                os.remove(lease[: -len(".lease")] + ".node")
        for lk in locks:
            with contextlib.suppress(OSError):
                os.remove(lk)
