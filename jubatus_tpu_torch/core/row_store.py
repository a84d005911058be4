"""Fixed-capacity sparse row store with LRU unlearning.

Copy of ``jubatus_tpu/core/row_store.py``: id-keyed rows of hashed sparse
vectors held as padded [C, K] host numpy arenas, the instance-data backbone
of the nearest-neighbor backend.

- Capacity C and pad width K grow by doubling.
- ``max_size`` caps the live row count with least-recently-touched eviction
  (the reference's "unlearner": "lru").
- Host numpy is the source of truth; the backend uploads what it scans:
  the hash methods the pending rows at a flush and the live mask per
  ``version``, the exact methods the whole arenas through
  ``device_view``, cached per ``version`` and uploaded again in full when
  it moves (as the JAX package does).
- The live-slot mask is kept up to date on every write (the JAX package
  rebuilds it per query, a loop over every row).
- Mix support: ``updated_since_mix`` tracks locally-written row ids.
- ``version`` is a stamp drawn from one process-wide counter on every
  write, clear and unpack, so two different contents of any store never
  share one: the device caches and the migration walk's sorted ids
  (framework/migration.py) key on it.
"""

from __future__ import annotations

import itertools
from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch

from jubatus_tpu_torch.core.sparse import SparseVector

#: version stamps, unique across the process (next() is atomic)
_STAMPS = itertools.count(1)

_INITIAL_CAPACITY = 64
_INITIAL_WIDTH = 8


def _pow2_at_least(n: int, minimum: int) -> int:
    p = minimum
    while p < n:
        p *= 2
    return p


class RowStore:
    def __init__(self, max_size: Optional[int] = None,
                 keep_datum: bool = False) -> None:
        self.max_size = max_size
        self.keep_datum = keep_datum
        self._init()

    def _init(self) -> None:
        self.capacity = _INITIAL_CAPACITY
        self.width = _INITIAL_WIDTH
        self.idx = np.zeros((self.capacity, self.width), np.int32)
        self.val = np.zeros((self.capacity, self.width), np.float32)
        self.live = np.zeros(self.capacity, bool)
        self.ids: List[str] = []              # slot -> id ("" = dead)
        self.slots: Dict[str, int] = {}       # id -> slot
        self._clock = 0
        self._touch: Dict[str, int] = {}      # id -> last-touch tick (LRU)
        self.datums: Dict[str, Any] = {}      # id -> original datum
        self.updated_since_mix: Dict[str, None] = {}
        self.version = next(_STAMPS)          # new stamp on every write
        self._dev_cache: Optional[Tuple[int, torch.device, tuple]] = None

    # -- sizing --------------------------------------------------------------
    def __len__(self) -> int:
        return len(self.slots)

    def __contains__(self, row_id: str) -> bool:
        return row_id in self.slots

    def _grow_capacity(self) -> None:
        self.capacity *= 2
        self.idx = np.vstack([self.idx, np.zeros_like(self.idx)])
        self.val = np.vstack([self.val, np.zeros_like(self.val)])
        self.live = np.concatenate([self.live, np.zeros_like(self.live)])

    def _grow_width(self, need: int) -> None:
        new_w = _pow2_at_least(need, self.width * 2)
        pad = new_w - self.width
        self.idx = np.pad(self.idx, ((0, 0), (0, pad)))
        self.val = np.pad(self.val, ((0, 0), (0, pad)))
        self.width = new_w

    def _free_slot(self) -> int:
        if len(self.ids) < self.capacity:
            self.ids.append("")
            return len(self.ids) - 1
        for s, rid in enumerate(self.ids):
            if not rid:
                return s
        self._grow_capacity()
        self.ids.append("")
        return len(self.ids) - 1

    # -- writes --------------------------------------------------------------
    def set_row(self, row_id: str, vec: SparseVector,
                datum: Any = None) -> int:
        """Insert or overwrite a row; returns its slot. Evicts the least
        recently touched row first when max_size is reached."""
        slot = self.slots.get(row_id)
        if slot is None:
            if self.max_size is not None and len(self.slots) >= self.max_size:
                self._evict_lru()
            slot = self._free_slot()
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

    def remove_row(self, row_id: str) -> bool:
        slot = self.slots.pop(row_id, None)
        if slot is None:
            return False
        self.ids[slot] = ""
        self.live[slot] = False
        self.idx[slot].fill(0)
        self.val[slot].fill(0.0)
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

    # -- reads ---------------------------------------------------------------
    def get_row(self, row_id: str) -> Optional[SparseVector]:
        slot = self.slots.get(row_id)
        if slot is None:
            return None
        k = int((self.val[slot] != 0).sum())
        order = np.nonzero(self.val[slot])[0]
        return [(int(self.idx[slot, j]), float(self.val[slot, j]))
                for j in order[:k]]

    def all_ids(self) -> List[str]:
        return list(self.slots.keys())

    def live_mask(self) -> np.ndarray:
        return self.live.copy()

    def device_view(self, device) -> Tuple[torch.Tensor, torch.Tensor,
                                           torch.Tensor]:
        """(idx [C, K] int32, val [C, K] float32, live [C] bool) as tensors
        on ``device``, cached per store version: any write uploads all
        three again."""
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
        datum)}; clears the tracker."""
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
                       for rid, d in self.datums.items()} if self.keep_datum else {},
        }

    def unpack(self, obj: Any, datum_decoder=None) -> None:
        self._init()
        for rid, (ii, vv) in obj["rows"].items():
            rid = rid.decode() if isinstance(rid, bytes) else rid
            self.set_row(rid, [(int(i), float(v)) for i, v in zip(ii, vv)])
        for rid, d in (obj.get("datums") or {}).items():
            rid = rid.decode() if isinstance(rid, bytes) else rid
            self.datums[rid] = datum_decoder(d) if datum_decoder else d
        self.updated_since_mix = {}
