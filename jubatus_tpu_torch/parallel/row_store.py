"""Sharded row store and the IVF cell arenas (copy of
``jubatus_tpu/parallel/row_store.py``).

``ShardedRowStore`` is a drop-in for ``core/row_store.RowStore`` with S
fixed-capacity per-shard arenas:

- **Placement** is CHT-compatible: ``coord.cht.shard_for(row_id, S)`` picks
  the owning shard, the stable hash the migration plane uses, so a row put
  over the wire (``NNRowMigration.put_rows``) lands in its owning shard's
  arena, and ``serve_range`` walks the host arenas without touching a
  device table.
- **Layout**: global slot = ``shard * capacity_per_shard + local_slot``, so
  the [S*C, K] host arenas, and the signature table the NN backend aligns
  to slots, are shard-contiguous: shard ``s`` is rows ``[s*C, (s+1)*C)``.
- **Capacity**: every shard arena doubles together when one fills (local
  slots are kept, so a row's global slot moves with the doubling);
  ``max_size`` evicts the least recently touched row across all shards.
- **Mix**: ``pop_update_diff_sharded`` groups the diff by owning shard.
- The pack format is the flat store's, so a flat or N-shard checkpoint of
  either package restores onto any shard count (placement is a function of
  the id alone).

As in the port's flat store, the live mask is kept up to date on every
write and ``version`` is a process-wide unique stamp (the device caches key
on it). ``place_all`` fills an empty store with many rows at once, to the
same state as one ``set_row`` a row in that order.

``CellArenas`` is the IVF index over a store: a host ``id → cell`` map and
insertion-ordered member sets per cell, materialised as the [S*n_cells,
cap] int32 table of local slots (−1-padded) that the IVF probe gathers
from.
"""

from __future__ import annotations

from typing import Any, Dict, Iterator, List, Optional, Sequence, Tuple

import numpy as np
import torch

from jubatus_tpu_torch.coord.cht import shard_for
from jubatus_tpu_torch.core.row_store import _STAMPS, _pow2_at_least
from jubatus_tpu_torch.core.sparse import SparseVector

_INITIAL_CAPACITY = 64   # per shard
_INITIAL_WIDTH = 8


class ShardedRowStore:
    """Drop-in RowStore with S fixed-capacity per-shard arenas."""

    def __init__(self, n_shards: int = 1, max_size: Optional[int] = None,
                 keep_datum: bool = False,
                 capacity_per_shard: int = _INITIAL_CAPACITY) -> None:
        if n_shards < 1:
            raise ValueError(f"n_shards must be >= 1, got {n_shards}")
        self.n_shards = int(n_shards)
        self.max_size = max_size
        self.keep_datum = keep_datum
        self._initial_cap = int(capacity_per_shard)
        self._init()

    def _init(self) -> None:
        self.cap_per_shard = self._initial_cap
        self.width = _INITIAL_WIDTH
        s, c = self.n_shards, self.cap_per_shard
        self.idx = np.zeros((s * c, self.width), np.int32)
        self.val = np.zeros((s * c, self.width), np.float32)
        self.live = np.zeros(s * c, bool)
        self.ids: List[str] = [""] * (s * c)   # slot -> id ("" = dead)
        self.slots: Dict[str, int] = {}        # id -> global slot
        self._free: List[List[int]] = [[] for _ in range(s)]
        self._fill: List[int] = [0] * s        # per-shard high-water mark
        self._clock = 0
        self._touch: Dict[str, int] = {}       # id -> last-touch tick (LRU)
        self.datums: Dict[str, Any] = {}
        self.updated_since_mix: Dict[str, None] = {}
        self.version = next(_STAMPS)
        self._dev_cache: Optional[Tuple[int, torch.device, tuple]] = None

    # -- sizing ---------------------------------------------------------------
    @property
    def capacity(self) -> int:
        return self.n_shards * self.cap_per_shard

    def __len__(self) -> int:
        return len(self.slots)

    def __contains__(self, row_id: str) -> bool:
        return row_id in self.slots

    def shard_of(self, row_id: str) -> int:
        """The owning shard: CHT-stable, shared with the migration plane."""
        return shard_for(row_id, self.n_shards)

    def shard_slot(self, row_id: str) -> Optional[Tuple[int, int]]:
        """(shard, local slot) of a live row; None when absent."""
        g = self.slots.get(row_id)
        if g is None:
            return None
        return divmod(g, self.cap_per_shard)

    def _regrid(self, new_c: int) -> None:
        """Re-lay every shard arena at ``new_c`` slots a shard, keeping
        local slots (rows never move between shards)."""
        old_c, s = self.cap_per_shard, self.n_shards
        idx = np.zeros((s * new_c, self.width), np.int32)
        val = np.zeros((s * new_c, self.width), np.float32)
        live = np.zeros(s * new_c, bool)
        ids: List[str] = [""] * (s * new_c)
        for sh in range(s):
            src, dst = slice(sh * old_c, (sh + 1) * old_c), \
                slice(sh * new_c, sh * new_c + old_c)
            idx[dst], val[dst], live[dst] = self.idx[src], self.val[src], \
                self.live[src]
            ids[dst] = self.ids[src]
        self.idx, self.val, self.live, self.ids = idx, val, live, ids
        self.cap_per_shard = new_c
        self.slots = {rid: (g // old_c) * new_c + (g % old_c)
                      for rid, g in self.slots.items()}
        self._free = [[(g // old_c) * new_c + (g % old_c) for g in fl]
                      for fl in self._free]

    def _grow_capacity(self) -> None:
        """Double every shard arena, remapping global slots."""
        self._regrid(self.cap_per_shard * 2)

    def _grow_width(self, need: int) -> None:
        new_w = _pow2_at_least(need, self.width * 2)
        pad = new_w - self.width
        self.idx = np.pad(self.idx, ((0, 0), (0, pad)))
        self.val = np.pad(self.val, ((0, 0), (0, pad)))
        self.width = new_w

    def _free_slot(self, shard: int) -> int:
        if self._free[shard]:
            return self._free[shard].pop()
        if self._fill[shard] >= self.cap_per_shard:
            self._grow_capacity()
        slot = shard * self.cap_per_shard + self._fill[shard]
        self._fill[shard] += 1
        return slot

    # -- writes ---------------------------------------------------------------
    def set_row(self, row_id: str, vec: SparseVector,
                datum: Any = None) -> int:
        """Insert or overwrite a row in its owning shard's arena; returns
        its global slot. Evicts the least recently touched row (across all
        shards) first when max_size is reached."""
        slot = self.slots.get(row_id)
        if slot is None:
            if self.max_size is not None and len(self.slots) >= self.max_size:
                self._evict_lru()
            slot = self._free_slot(self.shard_of(row_id))
            self.ids[slot] = row_id
            self.slots[row_id] = slot
            self.live[slot] = True
        if len(vec) > self.width:
            self._grow_width(len(vec))
        self.idx[slot].fill(0)
        self.val[slot].fill(0.0)
        k = len(vec)
        if k:
            self.idx[slot, :k] = [i for i, _ in vec]
            self.val[slot, :k] = [w for _, w in vec]
        if self.keep_datum and datum is not None:
            self.datums[row_id] = datum
        self.touch(row_id)
        self.updated_since_mix[row_id] = None
        self.version = next(_STAMPS)
        return slot

    def place_all(self, ids: Sequence[str], idx: np.ndarray, val: np.ndarray,
                  datums: Optional[Sequence[Any]] = None) -> None:
        """Fill an EMPTY store with ``ids[i]``'s row ``(idx[i], val[i])``
        (padded arrays; zero values are dropped, as ``get_row`` drops
        them): the state ``set_row`` gives, a row at a time in this order,
        at array speed."""
        if self.slots:
            raise ValueError("place_all needs an empty store")
        n = len(ids)
        if n == 0:
            return
        if self.max_size is not None and n > self.max_size:
            raise ValueError(f"{n} rows over max_size {self.max_size}")
        shards = np.fromiter((self.shard_of(r) for r in ids), np.int64, n)
        counts = np.bincount(shards, minlength=self.n_shards)
        local = np.empty(n, np.int64)
        for sh in range(self.n_shards):
            mine = np.flatnonzero(shards == sh)
            local[mine] = np.arange(mine.size)
        nz = val != 0
        # each row's nonzero entries first, in their order
        order = np.argsort(~nz, axis=1, kind="stable")
        keep = np.take_along_axis(nz, order, 1)
        idx = np.where(keep, np.take_along_axis(idx, order, 1), 0)
        val = np.where(keep, np.take_along_axis(val, order, 1), 0.0)
        need = int(nz.sum(axis=1).max()) if n else 0
        if need > self.width:
            self._grow_width(need)
        cap = _pow2_at_least(int(counts.max()), self.cap_per_shard)
        if cap != self.cap_per_shard:
            self._regrid(cap)
        g = shards * cap + local
        k = min(idx.shape[1], self.width)
        self.idx[g, :k] = idx[:, :k]
        self.val[g, :k] = val[:, :k]
        self.live[g] = True
        for sh in range(self.n_shards):
            self._fill[sh] = int(counts[sh])
        gl = g.tolist()
        for rid, slot in zip(ids, gl):
            self.ids[slot] = rid
        self.slots = dict(zip(ids, gl))
        self._touch = {rid: i + 1 for i, rid in enumerate(ids)}
        self._clock = n
        if self.keep_datum and datums is not None:
            self.datums = {rid: d for rid, d in zip(ids, datums)
                           if d is not None}
        self.updated_since_mix = dict.fromkeys(ids)
        self.version = next(_STAMPS)

    def remove_row(self, row_id: str) -> bool:
        slot = self.slots.pop(row_id, None)
        if slot is None:
            return False
        self.ids[slot] = ""
        self.live[slot] = False
        self.idx[slot].fill(0)
        self.val[slot].fill(0.0)
        self._free[slot // self.cap_per_shard].append(slot)
        self._touch.pop(row_id, None)
        self.datums.pop(row_id, None)
        self.updated_since_mix.pop(row_id, None)
        self.version = next(_STAMPS)
        return True

    def clear(self) -> None:
        self._init()

    def touch(self, row_id: str) -> None:
        self._clock += 1
        self._touch[row_id] = self._clock

    def _evict_lru(self) -> None:
        victim = min(self._touch, key=self._touch.get)
        self.remove_row(victim)

    # -- reads ----------------------------------------------------------------
    def get_row(self, row_id: str) -> Optional[SparseVector]:
        slot = self.slots.get(row_id)
        if slot is None:
            return None
        order = np.nonzero(self.val[slot])[0]
        return [(int(self.idx[slot, j]), float(self.val[slot, j]))
                for j in order]

    def all_ids(self) -> List[str]:
        return list(self.slots.keys())

    def shard_ids(self, shard: int) -> List[str]:
        """Live row ids in one shard arena (host metadata only)."""
        lo = shard * self.cap_per_shard
        return [rid for rid in self.ids[lo:lo + self.cap_per_shard] if rid]

    def iter_rows(self) -> Iterator[Tuple[str, int]]:
        return iter(self.slots.items())

    def live_mask(self) -> np.ndarray:
        return self.live.copy()

    def rows_per_shard(self) -> List[int]:
        c = self.cap_per_shard
        return [int(self.live[s * c:(s + 1) * c].sum())
                for s in range(self.n_shards)]

    def bytes_in_use(self) -> int:
        """Host bytes of the padded arenas (idx int32 + val float32)."""
        return int(self.idx.nbytes + self.val.nbytes)

    def shard_stats(self) -> Dict[str, Any]:
        return {"count": self.n_shards, "rows": len(self.slots),
                "rows_per_shard": self.rows_per_shard(),
                "capacity_per_shard": self.cap_per_shard,
                "bytes_in_use": self.bytes_in_use()}

    def device_view(self, device) -> Tuple[torch.Tensor, torch.Tensor,
                                           torch.Tensor]:
        """(idx, val, live) on ``device``, cached per store version."""
        device = torch.device(device)
        cache = self._dev_cache
        if cache is None or cache[0] != self.version or cache[1] != device:
            self._dev_cache = cache = (
                self.version, device,
                (torch.from_numpy(self.idx).to(device, copy=True),
                 torch.from_numpy(self.val).to(device, copy=True),
                 torch.from_numpy(self.live).to(device, copy=True)))
        return cache[2]

    # -- mix / persistence ----------------------------------------------------
    def pop_update_diff(self) -> Dict[str, Tuple[list, list, Any]]:
        """Rows written since the last mix as {id: (idx_list, val_list,
        datum)}; clears the tracker. Wire-identical to the flat store."""
        out = {}
        for rid in self.updated_since_mix:
            slot = self.slots.get(rid)
            if slot is None:
                continue
            nz = np.nonzero(self.val[slot])[0]
            out[rid] = (
                self.idx[slot, nz].tolist(),
                self.val[slot, nz].tolist(),
                self.datums.get(rid),
            )
        self.updated_since_mix = {}
        return out

    def pop_update_diff_sharded(self) -> List[Dict[str, Tuple[list, list, Any]]]:
        """The same diff grouped by owning shard (one dict per shard)."""
        out: List[Dict[str, Tuple[list, list, Any]]] = \
            [{} for _ in range(self.n_shards)]
        for rid, row in self.pop_update_diff().items():
            out[self.shard_of(rid)][rid] = row
        return out

    def apply_update_diff(self, diff: Dict[str, Tuple[list, list, Any]]) -> None:
        for rid, (ii, vv, datum) in diff.items():
            rid = rid.decode() if isinstance(rid, bytes) else rid
            vec = [(int(i), float(v)) for i, v in zip(ii, vv)]
            self.set_row(rid, vec, datum=datum)
        # rows arriving via mix are not "local updates" for the next round
        self.updated_since_mix = {}

    def pack(self) -> Any:
        return {
            "rows": {
                rid: (
                    self.idx[s][np.nonzero(self.val[s])].tolist(),
                    self.val[s][np.nonzero(self.val[s])].tolist(),
                )
                for rid, s in self.slots.items()
            },
            "datums": {rid: d.to_msgpack() if hasattr(d, "to_msgpack") else d
                       for rid, d in self.datums.items()}
            if self.keep_datum else {},
        }

    def unpack(self, obj: Any, datum_decoder=None) -> None:
        """Restore from the shared pack format, re-placing every row into
        the CURRENT shard count's owning arenas."""
        self._init()
        for rid, (ii, vv) in obj["rows"].items():
            rid = rid.decode() if isinstance(rid, bytes) else rid
            self.set_row(rid, [(int(i), float(v)) for i, v in zip(ii, vv)])
        for rid, d in (obj.get("datums") or {}).items():
            rid = rid.decode() if isinstance(rid, bytes) else rid
            self.datums[rid] = datum_decoder(d) if datum_decoder else d
        self.updated_since_mix = {}


class CellArenas:
    """Per-shard IVF cell arenas layered over a row store.

    The store's arenas stay the source of truth: rows never move when
    their cell changes. This is an index over them, materialised on demand
    as the table the IVF probe gathers from:

        tables[s * n_cells + c] = int32 LOCAL slots of shard s's live
                                  members of cell c, −1-padded to a
                                  pow2 ``cell_cap``

    Shard ``s``'s block is rows ``[s*n_cells, (s+1)*n_cells)``, and a
    gathered local slot indexes the shard's own arena block. A flat store
    is the S = 1 case with local slot == global slot.

    Liveness is lazy: the store can evict or remove rows without telling
    the arenas; dead ids are pruned at the next table build, and the
    ``(store.version, version)`` cache key makes that build happen before
    any query sees the change. ``cell_cap`` is pow2-bucketed.
    """

    _MIN_CAP = 8

    def __init__(self, store: Any, n_cells: int) -> None:
        if n_cells < 1:
            raise ValueError(f"n_cells must be >= 1, got {n_cells}")
        self.store = store
        self.n_shards = int(getattr(store, "n_shards", 1))
        self._members: List[Dict[str, None]] = [{} for _ in range(n_cells)]
        self._cell_of: Dict[str, int] = {}
        self.version = 0
        self._table_cache: Optional[Tuple[tuple, torch.Tensor, int]] = None

    @property
    def n_cells(self) -> int:
        return len(self._members)

    def __len__(self) -> int:
        return len(self._cell_of)

    def cell_of(self, row_id: str) -> Optional[int]:
        return self._cell_of.get(row_id)

    def assign(self, row_id: str, cell: int) -> None:
        """Bind a row to a cell (moving it if bound elsewhere)."""
        old = self._cell_of.get(row_id)
        if old == cell:
            return
        if old is not None:
            self._members[old].pop(row_id, None)
        self._members[cell][row_id] = None
        self._cell_of[row_id] = cell
        self.version += 1

    def remove(self, row_id: str) -> bool:
        cell = self._cell_of.pop(row_id, None)
        if cell is None:
            return False
        self._members[cell].pop(row_id, None)
        self.version += 1
        return True

    def add_cell(self) -> int:
        """Append an empty cell (re-split target); returns its id."""
        self._members.append({})
        self.version += 1
        return len(self._members) - 1

    def members(self, cell: int) -> List[str]:
        return list(self._members[cell])

    def sizes(self) -> List[int]:
        """Member count per cell (may include not-yet-pruned dead ids)."""
        return [len(m) for m in self._members]

    def clear(self) -> None:
        self._members = [{} for _ in self._members]
        self._cell_of = {}
        self.version += 1
        self._table_cache = None

    def _shard_slot(self, row_id: str) -> Optional[Tuple[int, int]]:
        if hasattr(self.store, "shard_slot"):
            return self.store.shard_slot(row_id)
        g = self.store.slots.get(row_id)
        return None if g is None else (0, g)

    def device_tables(self, device) -> Tuple[torch.Tensor, int]:
        """(tables [S*n_cells, cap] int32 on ``device``, cap). Dead ids are
        pruned as a side effect; cached per (store, index) version."""
        device = torch.device(device)
        key = (self.store.version, self.version, device)
        if self._table_cache is not None and self._table_cache[0] == key:
            return self._table_cache[1], self._table_cache[2]
        buckets: List[List[List[int]]] = \
            [[[] for _ in self._members] for _ in range(self.n_shards)]
        dead: List[Tuple[str, int]] = []
        for cell, mem in enumerate(self._members):
            for rid in mem:
                loc = self._shard_slot(rid)
                if loc is None:
                    dead.append((rid, cell))
                    continue
                buckets[loc[0]][cell].append(loc[1])
        for rid, cell in dead:
            self._members[cell].pop(rid, None)
            self._cell_of.pop(rid, None)
        widest = max((len(b) for per in buckets for b in per), default=0)
        cap = _pow2_at_least(max(widest, 1), self._MIN_CAP)
        tab = np.full((self.n_shards * len(self._members), cap), -1,
                      np.int32)
        for s, per in enumerate(buckets):
            for cell, slots in enumerate(per):
                if slots:
                    tab[s * len(self._members) + cell, :len(slots)] = slots
        dev = torch.from_numpy(tab).to(device)
        self._table_cache = (key, dev, cap)
        return dev, cap
