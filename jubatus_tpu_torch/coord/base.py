"""Coordinator interface (copy of ``jubatus_tpu/coord/base.py``;
≙ lock_service ABC, common/lock_service.hpp:33-118).

Path-keyed hierarchical store with ephemeral nodes, watchers, locks, and
64-bit id minting — the subset of ZooKeeper the reference actually uses.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Callable, List, Optional


class CoordinatorError(RuntimeError):
    pass


@dataclass(frozen=True)
class NodeInfo:
    """A cluster member (ip, port) — the reference stores these as znode
    names "<ip>_<port>" (membership.cpp:59-66)."""

    host: str
    port: int

    @property
    def name(self) -> str:
        return f"{self.host}_{self.port}"

    @classmethod
    def from_name(cls, name: str) -> "NodeInfo":
        host, _, port = name.rpartition("_")
        return cls(host, int(port))


class Coordinator:
    """ABC. All paths are '/'-separated strings rooted at '/'."""

    # -- node CRUD (≙ lock_service create/set/remove/exists/read/list) ------
    def create(self, path: str, payload: bytes = b"", ephemeral: bool = False) -> bool:
        """Create a node (parents auto-created). False if it exists.
        Ephemeral nodes vanish when their creator session ends."""
        raise NotImplementedError

    def create_seq(self, path: str, payload: bytes = b"") -> Optional[str]:
        """Create an ephemeral-sequence node; returns the actual path
        (≙ zk.cpp:203-205)."""
        raise NotImplementedError

    def set(self, path: str, payload: bytes) -> bool:
        raise NotImplementedError

    def read(self, path: str) -> Optional[bytes]:
        raise NotImplementedError

    def remove(self, path: str) -> bool:
        raise NotImplementedError

    def exists(self, path: str) -> bool:
        raise NotImplementedError

    def list(self, path: str) -> List[str]:
        """Child names (not full paths), sorted."""
        raise NotImplementedError

    # -- watchers (≙ bind_watcher/bind_child_watcher/bind_delete_watcher) ---
    def watch_children(self, path: str, fn: Callable[[str], None]) -> None:
        """fn(path) fires on any child add/remove under path (persistent
        watch — unlike ZK's one-shot, so callers need no re-arm dance)."""
        raise NotImplementedError

    def watch_delete(self, path: str, fn: Callable[[str], None]) -> None:
        """fn(path) fires when the node is deleted (suicide watcher,
        server_helper.cpp:91-94)."""
        raise NotImplementedError

    # -- locks (≙ zkmutex, common/zk.hpp:126-139) ---------------------------
    def try_lock(self, path: str) -> bool:
        raise NotImplementedError

    def unlock(self, path: str) -> bool:
        raise NotImplementedError

    # -- id minting (≙ create_id, global_id_generator_zk.cpp:32-56) ---------
    def create_id(self, path: str) -> int:
        """Monotonic uint64, cluster-unique per path."""
        raise NotImplementedError

    # -- lifecycle -----------------------------------------------------------
    def close(self) -> None:
        """End the session: ephemeral nodes vanish, locks release."""

    def run_cleanup(self) -> None:
        """≙ lock_service cleanup stack — close is our cleanup."""
        self.close()
