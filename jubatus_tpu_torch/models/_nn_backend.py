"""Similarity-search backend for the instance-based engines, in torch.

Counterpart of ``jubatus_tpu/models/_nn_backend.py``, single device, used by
nearest_neighbor, recommender, anomaly and the NN classifier. Composes a
RowStore (core/row_store.py) with one of the ops/knn.py methods. The hash
methods keep a signature table on the device aligned with the store's
slots:

  lsh          [C, W] int32 (uint32 bit patterns); Hamming distance in
               [0, 1]; similarity = 1 - distance. Scanned by the CUDA kernel.
  minhash      [C, H] int32; 1 - matching-lane fraction; similarity =
               1 - distance. Scanned by the CUDA kernel.
  euclid_lsh   [C, H] float32 JL projections; distance ||p_q - p_r||/√H;
               similarity = -distance.

The exact methods hold no signatures; they score the store's arenas
(``RowStore.device_view``) against the densified query:

  inverted_index  distance = 1 - cosine similarity; similarity = 1 - d.
  euclid          exact euclidean distance; similarity = -distance.

Write path is buffered: set_row queues the row id, and the next query
computes the signatures of ALL pending rows in one batch, straight from the
store's padded arenas. Dead slots score +inf. Top-k runs on the device.

Not ported yet: the mesh-sharded layout (``attach_mesh``) and the IVF tier
(``configure_ann("ivf")``).
"""

from __future__ import annotations

from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch

from jubatus_tpu_torch import NotYetPorted, resolve_device
from jubatus_tpu_torch.core.row_store import RowStore
from jubatus_tpu_torch.core.sparse import SparseBatch, SparseVector
from jubatus_tpu_torch.ops import knn

HASH_METHODS = ("lsh", "minhash", "euclid_lsh")
EXACT_METHODS = ("inverted_index", "euclid")
METHODS = HASH_METHODS + EXACT_METHODS


class NNBackend:
    def __init__(self, method: str, *, dim: int, hash_num: int = 64,
                 seed: int = 0, max_size: Optional[int] = None,
                 keep_datum: bool = False, device=None):
        if method not in METHODS:
            raise ValueError(f"unknown nearest-neighbor method {method!r}")
        self.device = resolve_device(device)
        self.method = method
        self.dim = dim
        self.hash_num = int(hash_num)
        self.seed = int(seed)
        self.store = RowStore(max_size=max_size, keep_datum=keep_datum)
        #: row ids whose signatures are not computed yet (insertion order)
        self._pending: Dict[str, None] = {}
        self._init_sigs()

    def _init_sigs(self) -> None:
        c = self.store.capacity
        self._live_dev: Optional[Tuple[int, torch.Tensor]] = None
        if self.method == "lsh":
            shape, dtype = (c, knn.packed_words(self.hash_num)), torch.int32
        elif self.method == "minhash":
            shape, dtype = (c, self.hash_num), torch.int32
        elif self.method == "euclid_lsh":
            shape, dtype = (c, self.hash_num), torch.float32
        else:
            self._sigs: Optional[torch.Tensor] = None
            return
        self._sigs = torch.zeros(shape, dtype=dtype, device=self.device)

    # -- writes ---------------------------------------------------------------
    def set_row(self, row_id: str, vec: SparseVector, datum: Any = None) -> None:
        self.store.set_row(row_id, vec, datum=datum)
        if self._sigs is not None:
            self._pending[row_id] = None

    def remove_row(self, row_id: str) -> bool:
        self._pending.pop(row_id, None)
        return self.store.remove_row(row_id)

    def clear(self) -> None:
        self.store.clear()
        self._pending.clear()
        self._init_sigs()

    # -- signature maintenance -----------------------------------------------
    def _signatures(self, idx: torch.Tensor, val: torch.Tensor) -> torch.Tensor:
        if self.method == "lsh":
            return knn.lsh_signature(idx, val, hash_num=self.hash_num,
                                     seed=self.seed)
        if self.method == "minhash":
            return knn.minhash_signature(idx, val, hash_num=self.hash_num,
                                         seed=self.seed)
        return knn.euclid_projection(idx, val, hash_num=self.hash_num,
                                     seed=self.seed)

    def flush(self) -> int:
        """Compute the signatures of every pending row in one batch;
        returns how many rows it signed (0 for the exact methods)."""
        if self._sigs is None:
            return 0
        # keep the table sized to the store even when nothing is pending
        grow = self.store.capacity - self._sigs.shape[0]
        if grow:
            self._sigs = torch.cat([self._sigs, self._sigs.new_zeros(
                (grow, self._sigs.shape[1]))])
        if not self._pending:
            return 0
        slots = np.fromiter((self.store.slots[rid] for rid in self._pending
                             if rid in self.store.slots), np.int64)
        self._pending.clear()
        if not slots.size:
            return 0
        idx = torch.tensor(self.store.idx[slots], device=self.device)
        val = torch.tensor(self.store.val[slots], device=self.device)
        sigs = self._signatures(idx, val)
        self._sigs[torch.from_numpy(slots).to(self.device)] = sigs
        return int(slots.size)

    def sig_table(self) -> torch.Tensor:
        """The [C, W/H] signature table on the device (after a flush)."""
        self.flush()
        return self._sigs

    def _live_view(self) -> torch.Tensor:
        if self._live_dev is None or self._live_dev[0] != self.store.version:
            self._live_dev = (self.store.version,
                              torch.tensor(self.store.live, device=self.device))
        return self._live_dev[1]

    # -- unported layouts --------------------------------------------------------
    def attach_mesh(self, mesh, axis: str = "shard") -> None:
        if mesh is not None:
            raise NotYetPorted("mesh-sharded serving is not yet ported")

    def configure_ann(self, mode: str, **_: Any) -> None:
        if mode != "off":
            raise NotYetPorted(f"ann mode {mode!r} is not yet ported")

    # -- queries ---------------------------------------------------------------
    def _query_sig(self, vec: SparseVector) -> torch.Tensor:
        sb = SparseBatch.from_vectors([vec])
        idx = torch.tensor(sb.idx, device=self.device)
        val = torch.tensor(sb.val, device=self.device)
        return self._signatures(idx, val)[0]

    def _scan(self, q: torch.Tensor, sigs: torch.Tensor) -> torch.Tensor:
        """[B, W/H] query signatures against the table → [B, C]."""
        if self.method == "lsh":
            return knn.hamming_distances_batch(q, sigs, hash_num=self.hash_num)
        if self.method == "minhash":
            return knn.minhash_distances_batch(q, sigs)
        return knn.euclid_lsh_distances_batch(q, sigs, hash_num=self.hash_num)

    def _exact_distances(self, vec: SparseVector) -> torch.Tensor:
        """[C] exact distances on the device (dead slots not masked)."""
        idx, val, _ = self.store.device_view(self.device)
        qd = knn.densify(
            torch.tensor([i for i, _ in vec] or [0], dtype=torch.int32,
                         device=self.device),
            torch.tensor([v for _, v in vec] or [0.0], dtype=torch.float32,
                         device=self.device),
            dim=self.dim)
        if self.method == "inverted_index":
            return 1.0 - knn.cosine_scores(idx, val, qd)
        return knn.euclid_distances(idx, val, qd)

    def _distances_dev(self, vec: SparseVector) -> torch.Tensor:
        """[C] distances on the device, dead slots +inf."""
        inf = torch.tensor(float("inf"), device=self.device)
        if self._sigs is None:
            live = self.store.device_view(self.device)[2]
            return torch.where(live, self._exact_distances(vec), inf)
        sigs = self.sig_table()
        q = self._query_sig(vec)
        if self.method == "euclid_lsh":
            d = knn.euclid_lsh_distances(q, sigs, hash_num=self.hash_num)
        else:
            d = self._scan(q[None, :], sigs)[0]
        return torch.where(self._live_view(), d, inf)

    def distances(self, vec: SparseVector) -> np.ndarray:
        """Distance of every live slot to the query; dead slots +inf. [C]."""
        self.flush()
        if not len(self.store):
            return np.full(self.store.capacity, np.inf, np.float32)
        return self._distances_dev(vec).cpu().numpy()

    def similarity_from_distance(self, d: np.ndarray) -> np.ndarray:
        if self.method in ("euclid_lsh", "euclid"):
            return -d
        return 1.0 - d

    def neighbors(self, vec: SparseVector, k: int) -> List[Tuple[str, float]]:
        """k nearest as (id, distance), ascending."""
        self.flush()
        k = min(k, len(self.store))
        if k <= 0:
            return []
        d = self._distances_dev(vec)
        vals, order = torch.topk(d, k, largest=False, sorted=True)
        vals, order = vals.cpu().numpy(), order.cpu().numpy()
        return [(self.store.ids[s], float(v)) for s, v in zip(order, vals)]

    def similar(self, vec: SparseVector, k: int) -> List[Tuple[str, float]]:
        """k most similar as (id, similarity), descending."""
        return [(rid, float(self.similarity_from_distance(np.float32(dist))))
                for rid, dist in self.neighbors(vec, k)]

    # -- batch distances (LOF lrd cache) ---------------------------------------
    def distances_from_slots(self, slots: np.ndarray,
                             chunk: int = 256) -> np.ndarray:
        """Distances from each of the given row slots to every slot:
        [len(slots), C]; dead columns +inf. The hash methods run one
        batched scan per chunk of ``chunk`` rows; the exact methods loop
        over the rows, one single-query scan each."""
        self.flush()
        c = self.store.capacity
        out = np.full((len(slots), c), np.inf, np.float32)
        if not len(self.store):
            return out
        if self._sigs is None:
            for row, s in enumerate(slots):
                vec = self.store.get_row(self.store.ids[int(s)]) or []
                out[row] = self._distances_dev(vec).cpu().numpy()
            return out
        sigs = self._sigs
        for lo in range(0, len(slots), chunk):
            sel = torch.as_tensor(np.asarray(slots[lo:lo + chunk], np.int64),
                                  device=self.device)
            out[lo:lo + chunk] = self._scan(sigs[sel], sigs).cpu().numpy()
        out[:, ~self.store.live] = np.inf
        return out

    # -- persistence / mix -----------------------------------------------------
    def pack(self) -> Any:
        self.flush()
        return {"store": self.store.pack()}

    def unpack(self, obj: Any, datum_decoder=None) -> None:
        self.clear()
        self.store.unpack(obj["store"], datum_decoder=datum_decoder)
        if self._sigs is not None:
            self._pending = dict.fromkeys(self.store.all_ids())

    def pop_update_diff(self):
        return self.store.pop_update_diff()

    def apply_update_diff(self, diff, datum_decoder=None) -> None:
        for rid, (ii, vv, datum) in diff.items():
            rid = rid.decode() if isinstance(rid, bytes) else rid
            if datum is not None and datum_decoder is not None:
                datum = datum_decoder(datum)
            vec = [(int(i), float(v)) for i, v in zip(ii, vv)]
            self.set_row(rid, vec, datum=datum)
        self.store.updated_since_mix = {}


class NNRowMigration:
    """Row-migration driver hooks shared by the NNBackend-based engines.

    Wire row shape: ``[id, idx_list, val_list, datum_msgpack_or_None]`` —
    the already-hashed vector. Migrated rows do not re-enter the next mix
    diff. Mixed into drivers that define ``self.backend``."""

    def row_ids(self) -> List[str]:
        return self.backend.store.all_ids()

    @property
    def rows_version(self) -> int:
        """The row store's version stamp: a new one on every write, clear
        and unpack (the migration walk caches its sorted ids on it)."""
        return self.backend.store.version

    def get_rows(self, ids: Optional[List[str]] = None) -> List[list]:
        """The rows of ``ids`` (default: all) that exist, in that order:
        each row's nonzero entries in slot order, as the store's
        ``get_row`` reads them, gathered for the whole list at once."""
        store = self.backend.store
        found = []
        for rid in (ids if ids is not None else store.all_ids()):
            rid = rid.decode() if isinstance(rid, bytes) else rid
            slot = store.slots.get(rid)
            if slot is not None:
                found.append((rid, slot))
        if not found:
            return []
        slots = np.fromiter((s for _, s in found), np.int64, len(found))
        val = store.val[slots]
        nonzero = val != 0
        # row-major: each row's nonzeros in slot order, rows back to back
        flat_idx = store.idx[slots][nonzero].tolist()
        flat_val = val[nonzero].tolist()
        out: List[list] = []
        lo = 0
        for (rid, _), k in zip(found, nonzero.sum(axis=1).tolist()):
            datum = store.datums.get(rid)
            out.append([rid, flat_idx[lo:lo + k], flat_val[lo:lo + k],
                        datum.to_msgpack()
                        if hasattr(datum, "to_msgpack") else None])
            lo += k
        return out

    def put_rows(self, rows: List[list]) -> int:
        from jubatus_tpu_torch.core.datum import Datum

        n = 0
        for row in rows or []:
            rid = row[0]
            rid = rid.decode() if isinstance(rid, bytes) else str(rid)
            ii, vv = row[1], row[2]
            datum = row[3] if len(row) > 3 else None
            if datum is not None:
                datum = Datum.from_msgpack(datum)
            self.backend.set_row(
                rid, [(int(i), float(v)) for i, v in zip(ii, vv)],
                datum=datum)
            self.backend.store.updated_since_mix.pop(rid, None)
            n += 1
        return n
