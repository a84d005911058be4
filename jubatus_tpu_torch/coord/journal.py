"""Durable-state journal for the coordination service (jubacoordd; copy
of ``jubatus_tpu/coord/journal.py``, the same records, so either package's
jubacoordd recovers the other's journal).

The reference gets control-plane durability from the ZooKeeper quorum's
transaction log; a memory-only coordd loses every config and counter
in a crash. This journal persists the DURABLE subset of the
store — persistent nodes, id counters, the sequence counter — as
msgpack-framed append-only records, replayed on boot and compacted to a
snapshot at open.

Ephemerals and locks are deliberately NOT journaled: they belong to
sessions, and a restarted coordd has no sessions — clients re-establish
them through session resumption (coord/remote.py).

Availability model (documented, not hidden): appends flush to the OS on
every record, so a killed/restarted process loses nothing; a HOST crash
may lose the tail. Counter records are hi-lo reservations (the journal
stores an upper bound, minting advances in memory), so a lost tail can
only skip ids, never reissue one.

Record shapes: ("c", path, payload) persistent create/set,
("r", path) remove, ("cnt", path, hi) id-counter reservation,
("seq", hi) sequence-counter reservation.
"""

from __future__ import annotations

import logging
import os
import threading
from typing import Tuple

import msgpack

log = logging.getLogger(__name__)

#: ids/sequences are reserved in blocks: one journal record per
#: RESERVE_BLOCK mints, and recovery resumes at the reserved bound
RESERVE_BLOCK = 1000


class Journal:
    def __init__(self, path: str) -> None:
        self.path = path
        self._lock = threading.Lock()
        self._fh = None

    # -- recovery -------------------------------------------------------------
    def replay_into(self, store) -> int:
        """Apply journaled durable state to a fresh _Store. Returns the
        record count (pre-compaction)."""
        n = 0
        if not os.path.exists(self.path):
            return 0
        with open(self.path, "rb") as f:
            unpacker = msgpack.Unpacker(f, raw=True, strict_map_key=False)
            for rec in unpacker:
                n += 1
                try:
                    self._apply(store, rec)
                except Exception:  # noqa: BLE001 — a torn tail record
                    log.warning("journal: stopping at malformed record %d", n)
                    break
        return n

    @staticmethod
    def _apply(store, rec) -> None:
        kind = rec[0].decode() if isinstance(rec[0], bytes) else rec[0]
        if kind == "c":
            path = rec[1].decode() if isinstance(rec[1], bytes) else rec[1]
            payload = rec[2] if isinstance(rec[2], bytes) else bytes(rec[2])
            parts = path.strip("/").split("/")
            cur = ""
            for p in parts[:-1]:
                cur += "/" + p
                store.nodes.setdefault(cur, (b"", None))
            store.nodes[path] = (payload, None)
        elif kind == "r":
            path = rec[1].decode() if isinstance(rec[1], bytes) else rec[1]
            store.nodes.pop(path, None)
        elif kind == "cnt":
            path = rec[1].decode() if isinstance(rec[1], bytes) else rec[1]
            hi = int(rec[2])
            store.counters[path] = max(store.counters.get(path, 0), hi)
            store.counter_res[path] = max(store.counter_res.get(path, 0), hi)
        elif kind == "seq":
            hi = int(rec[1])
            store.seq = max(store.seq, hi)
            store.seq_res = max(store.seq_res, hi)

    # -- writing --------------------------------------------------------------
    def open_and_compact(self, store) -> None:
        """Rewrite the journal as a snapshot of the current durable state
        (bounds growth across restarts), then keep it open for appends."""
        tmp = self.path + ".tmp"
        os.makedirs(os.path.dirname(os.path.abspath(self.path)), exist_ok=True)
        with open(tmp, "wb") as f:
            for path, (payload, owner) in sorted(store.nodes.items()):
                if owner is None and path != "/":
                    f.write(msgpack.packb(("c", path, payload)))
            for path, hi in sorted(store.counter_res.items()):
                f.write(msgpack.packb(("cnt", path, hi)))
            if store.seq_res:
                f.write(msgpack.packb(("seq", store.seq_res)))
            f.flush()
            os.fsync(f.fileno())
        os.replace(tmp, self.path)
        self._fh = open(self.path, "ab")

    def append(self, rec: Tuple) -> None:
        with self._lock:
            if self._fh is None:
                return
            self._fh.write(msgpack.packb(rec))
            self._fh.flush()

    def close(self) -> None:
        with self._lock:
            if self._fh is not None:
                try:
                    self._fh.flush()
                    os.fsync(self._fh.fileno())
                except OSError:
                    pass
                self._fh.close()
                self._fh = None
