"""In-memory coordinator (copy of ``jubatus_tpu/coord/memory.py``) — the
test/standalone backend, and the store behind the coordination service
(coord/server.py), whose journal the durable-mutation hooks feed.

One process-wide store; each `MemoryCoordinator` instance is a *session*
(ephemeral nodes die with the instance), so multi-node logic (membership,
master locks, suicide watchers) is testable in-process — the ZK mock the
reference never wrote (common/zk.hpp:36 TODO).
"""

from __future__ import annotations

import itertools
import threading
from typing import Callable, Dict, List, Optional, Set, Tuple

from jubatus_tpu_torch.coord.base import Coordinator


class _Store:
    """Shared node tree: path → (payload, owner_session_or_None)."""

    def __init__(self) -> None:
        self.lock = threading.RLock()
        self.nodes: Dict[str, Tuple[bytes, Optional[int]]] = {"/": (b"", None)}
        self.locks: Dict[str, int] = {}  # lock path → owner session
        self.counters: Dict[str, int] = {}
        self.seq = 0
        #: hi-lo reservations already journaled (coord/journal.py); minting
        #: below the reservation needs no IO
        self.counter_res: Dict[str, int] = {}
        self.seq_res = 0
        #: durable-mutation hook (set by CoordServer to the journal's
        #: append); called UNDER the store lock so record order matches
        #: mutation order
        self.on_durable: Optional[Callable[[tuple], None]] = None
        self.child_watchers: Dict[str, List[Callable[[str], None]]] = {}
        self.delete_watchers: Dict[str, List[Callable[[str], None]]] = {}

    def durable(self, rec: tuple) -> None:
        if self.on_durable is not None:
            self.on_durable(rec)

    def next_seq(self) -> int:
        n = self.seq
        self.seq += 1
        if self.seq > self.seq_res and self.on_durable is not None:
            from jubatus_tpu_torch.coord.journal import RESERVE_BLOCK

            self.seq_res = self.seq + RESERVE_BLOCK
            self.on_durable(("seq", self.seq_res))
        return n

    def fire_child(self, parent: str) -> None:
        for fn in list(self.child_watchers.get(parent, ())):
            try:
                fn(parent)
            except Exception:  # noqa: BLE001 — watcher errors are theirs
                pass

    def fire_delete(self, path: str) -> None:
        for fn in list(self.delete_watchers.get(path, ())):
            try:
                fn(path)
            except Exception:  # noqa: BLE001
                pass


def _parent(path: str) -> str:
    return path.rsplit("/", 1)[0] or "/"


class MemoryCoordinator(Coordinator):
    _shared: Optional[_Store] = None
    _shared_lock = threading.Lock()
    _session_ids = itertools.count(1)

    def __init__(self, store: Optional[_Store] = None) -> None:
        self._store = store if store is not None else _Store()
        self._session = next(self._session_ids)
        self._closed = False

    @classmethod
    def shared(cls) -> "MemoryCoordinator":
        """A new session on the process-wide shared store."""
        with cls._shared_lock:
            if cls._shared is None:
                cls._shared = _Store()
            return cls(cls._shared)

    # -- helpers -------------------------------------------------------------
    def _mkparents(self, path: str) -> None:
        parts = path.strip("/").split("/")
        cur = ""
        for p in parts[:-1]:
            cur += "/" + p
            self._store.nodes.setdefault(cur, (b"", None))

    # -- node CRUD -----------------------------------------------------------
    # Watchers always fire AFTER the store lock is released: a suicide
    # watcher may call EngineServer.stop() which joins threads that are
    # themselves blocked on coordinator reads — firing under the lock would
    # deadlock them.

    def create(self, path: str, payload: bytes = b"", ephemeral: bool = False) -> bool:
        with self._store.lock:
            # a closed session must not leave ephemerals behind: close()
            # already swept its nodes, so anything created after would be
            # orphaned forever (dead member stuck in the registry)
            if ephemeral and self._closed:
                return False
            if path in self._store.nodes:
                return False
            self._mkparents(path)
            owner = self._session if ephemeral else None
            self._store.nodes[path] = (payload, owner)
            if owner is None:
                self._store.durable(("c", path, payload))
        self._store.fire_child(_parent(path))
        return True

    def create_seq(self, path: str, payload: bytes = b"") -> Optional[str]:
        with self._store.lock:
            if self._closed:
                return None
            actual = f"{path}{self._store.next_seq():010d}"
            self._mkparents(actual)
            self._store.nodes[actual] = (payload, self._session)
        self._store.fire_child(_parent(actual))
        return actual

    def set(self, path: str, payload: bytes) -> bool:
        created = False
        with self._store.lock:
            if path not in self._store.nodes:
                self._mkparents(path)
                self._store.nodes[path] = (payload, None)
                created = True
                self._store.durable(("c", path, payload))
            else:
                _, owner = self._store.nodes[path]
                self._store.nodes[path] = (payload, owner)
                if owner is None:
                    self._store.durable(("c", path, payload))
        if created:
            self._store.fire_child(_parent(path))
        return True

    def read(self, path: str) -> Optional[bytes]:
        with self._store.lock:
            node = self._store.nodes.get(path)
            return node[0] if node else None

    def remove(self, path: str) -> bool:
        with self._store.lock:
            node = self._store.nodes.pop(path, None)
            if node is None:
                return False
            if node[1] is None:
                self._store.durable(("r", path))
        self._store.fire_delete(path)
        self._store.fire_child(_parent(path))
        return True

    def exists(self, path: str) -> bool:
        with self._store.lock:
            return path in self._store.nodes

    def list(self, path: str) -> List[str]:
        with self._store.lock:
            prefix = path.rstrip("/") + "/"
            out: Set[str] = set()
            for p in self._store.nodes:
                if p.startswith(prefix):
                    out.add(p[len(prefix) :].split("/", 1)[0])
            return sorted(out)

    # -- watchers ------------------------------------------------------------
    def watch_children(self, path: str, fn: Callable[[str], None]) -> None:
        with self._store.lock:
            self._store.child_watchers.setdefault(path, []).append(fn)

    def watch_delete(self, path: str, fn: Callable[[str], None]) -> None:
        with self._store.lock:
            self._store.delete_watchers.setdefault(path, []).append(fn)

    # -- locks ---------------------------------------------------------------
    def try_lock(self, path: str) -> bool:
        with self._store.lock:
            if self._closed:
                return False  # a dead session's lock would never release
            if path in self._store.locks:
                return self._store.locks[path] == self._session
            self._store.locks[path] = self._session
            return True

    def unlock(self, path: str) -> bool:
        with self._store.lock:
            if self._store.locks.get(path) == self._session:
                del self._store.locks[path]
                return True
            return False

    # -- ids -----------------------------------------------------------------
    def create_id(self, path: str) -> int:
        with self._store.lock:
            nxt = self._store.counters.get(path, 0) + 1
            self._store.counters[path] = nxt
            if nxt > self._store.counter_res.get(path, 0) \
                    and self._store.on_durable is not None:
                from jubatus_tpu_torch.coord.journal import RESERVE_BLOCK

                hi = nxt + RESERVE_BLOCK
                self._store.counter_res[path] = hi
                self._store.on_durable(("cnt", path, hi))
            return nxt

    # -- lifecycle -----------------------------------------------------------
    def close(self) -> None:
        if self._closed:
            return
        self._closed = True
        with self._store.lock:
            mine = [
                p
                for p, (_, owner) in self._store.nodes.items()
                if owner == self._session
            ]
            for p in mine:
                del self._store.nodes[p]
            held = [p for p, s in self._store.locks.items() if s == self._session]
            for p in held:
                del self._store.locks[p]
        # fire watchers outside the node mutation loop
        for p in mine:
            self._store.fire_delete(p)
            self._store.fire_child(_parent(p))
