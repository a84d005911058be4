"""Consistent hashing (copy of ``jubatus_tpu/coord/cht.py``;
≙ common/cht.{hpp,cpp}).

Same construction as the reference: an MD5 ring with 8 virtual nodes per
server (cht.hpp:36, ring entries md5(f"{node}_{i}"), cht.cpp:77-93);
`find(key, n)` returns the n distinct servers succeeding md5(key) clockwise
(cht.cpp:107-143).

The ring is a pure function of the member list: every observer of the
same membership computes the identical ring, so nothing needs storing. The
port's server uses it for burst's keyword assignment and for row
ownership in the migration plane (framework/migration.py).
"""

from __future__ import annotations

import hashlib
from typing import List, Sequence, Tuple

from jubatus_tpu_torch.coord import membership
from jubatus_tpu_torch.coord.base import Coordinator, NodeInfo

NUM_VSERV = 8  # common/cht.hpp:36


def make_hash(key: str) -> str:
    """Hex MD5 — the reference's ring coordinate (cht.cpp make_hash)."""
    return hashlib.md5(key.encode("utf-8")).hexdigest()


def ring_key(members: Sequence[NodeInfo]) -> Tuple[str, ...]:
    """Canonical identity of a ring: the sorted member names. Two member
    lists with the same key build the IDENTICAL ring."""
    return tuple(sorted(m.name for m in members))


class CHT:
    def __init__(self, members: Sequence[NodeInfo], epoch: int = 0) -> None:
        self.members = list(members)
        #: membership epoch this ring was built from (0 = unknown/static).
        #: Monotone across joins/leaves (coord/membership.py); consumers
        #: treat ANY difference as "refresh", never as an ordering.
        self.epoch = int(epoch)
        ring: List[Tuple[str, NodeInfo]] = []
        for m in self.members:
            for i in range(NUM_VSERV):
                ring.append((make_hash(f"{m.name}_{i}"), m))
        ring.sort(key=lambda e: e[0])
        self._ring = ring

    @property
    def key(self) -> Tuple[str, ...]:
        return ring_key(self.members)

    @classmethod
    def from_coordinator(
        cls, coord: Coordinator, engine: str, name: str, actives_only: bool = True
    ) -> "CHT":
        get = membership.get_all_actives if actives_only else membership.get_all_nodes
        return cls(get(coord, engine, name),
                   epoch=membership.get_epoch(coord, engine, name))

    def find(self, key: str, n: int = 2) -> List[NodeInfo]:
        """n distinct successors of md5(key) on the ring (cht.cpp:107-143).
        Fewer than n members → all members, primary first."""
        if not self._ring:
            return []
        h = make_hash(key)
        # first ring entry with hash > h, wrapping
        lo, hi = 0, len(self._ring)
        while lo < hi:
            mid = (lo + hi) // 2
            if self._ring[mid][0] <= h:
                lo = mid + 1
            else:
                hi = mid
        out: List[NodeInfo] = []
        seen = set()
        for i in range(len(self._ring)):
            node = self._ring[(lo + i) % len(self._ring)][1]
            if node.name not in seen:
                seen.add(node.name)
                out.append(node)
                if len(out) == n:
                    break
        return out


def shard_for(key: str, n_shards: int) -> int:
    """Static placement over a fixed shard count: a stable key → shard
    map (the row-sharded store's owning shard)."""
    return int(make_hash(key)[:8], 16) % max(1, n_shards)
