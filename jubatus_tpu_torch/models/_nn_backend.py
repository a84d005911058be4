"""Similarity-search backend for the instance-based engines, in torch.

Counterpart of ``jubatus_tpu/models/_nn_backend.py``, used by
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

The exact methods hold no signatures (unless the IVF tier is on, below);
they score the store's arenas (``RowStore.device_view``) against the
densified query:

  inverted_index  distance = 1 - cosine similarity; similarity = 1 - d.
  euclid          exact euclidean distance; similarity = -distance.

Write path is buffered: set_row queues the row id, and the next query
computes the signatures of ALL pending rows in one batch, straight from the
store's padded arenas. Dead slots score +inf. Top-k runs on the device.

Two layouts beside the flat one, as in the JAX package:

- **Row-sharded** (``attach_mesh(ShardMesh)``, hash methods only): the
  store becomes a ``ShardedRowStore`` (parallel/row_store.py) whose rows
  sit in their CHT-owned shard's slot range, so the signature table is
  shard-contiguous; a query scans each shard's block on its device (K1 once
  a shard for lsh / minhash) and merges the local top-k
  (parallel/sharded_knn.py). LOF's full distance rows come from
  ``sharded_distances``. When the sharded store grows, every shard's block
  of the signature table moves with it (the JAX package pads the table at
  its end instead, which misaligns the rows of shards past the first:
  ROADMAP C5).
- **IVF** (``configure_ann("ivf")``): a lazily built k-means cell index
  (ops/ivf.py, ``CellArenas``) probed by ``nprobe`` cells and rescored
  exactly (K1's gathered variant for lsh / minhash), flat or sharded
  (parallel/sharded_ivf.py). New rows join their nearest cell at each
  flush; a cell past its width budget splits in two (an ``ann`` /
  ``resplit`` event); a fault at the ``ann.rebuild`` site degrades the
  tier to the exact scan until it is configured again (``ann`` /
  ``degraded``). Every 64th IVF batch shadows one query down the exact
  path for the ``recall_probe`` gauge. The exact methods probe by a JL
  projection table allocated when the tier is armed. The centroids ride
  the pack under ``"ann"``, byte for byte the JAX package's.
"""

from __future__ import annotations

import time
from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch

from jubatus_tpu_torch import resolve_device
from jubatus_tpu_torch.core.row_store import RowStore
from jubatus_tpu_torch.core.sparse import SparseBatch, SparseVector
from jubatus_tpu_torch.ops import ivf, knn
from jubatus_tpu_torch.parallel import sharded_ivf, sharded_knn
from jubatus_tpu_torch.parallel.row_store import CellArenas, ShardedRowStore
from jubatus_tpu_torch.utils import events, faults

HASH_METHODS = ("lsh", "minhash", "euclid_lsh")
EXACT_METHODS = ("inverted_index", "euclid")
METHODS = HASH_METHODS + EXACT_METHODS

#: rows of the IVF training sample, and of one assignment chunk
ANN_SAMPLE = 65536


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
        self.store: Any = RowStore(max_size=max_size, keep_datum=keep_datum)
        #: row ids whose signatures are not computed yet (insertion order)
        self._pending: Dict[str, None] = {}
        self._mesh = None
        self._mesh_axis = "shard"
        self._mesh_dev: Optional[tuple] = None
        #: wall ms of the last sharded top-k (scans, merge and readback):
        #: the shard.topk_merge_ms gauge
        self.last_topk_ms: Optional[float] = None
        # the IVF tier: off until configure_ann("ivf") arms the lazy build
        self.ann_mode = "off"
        self.ann_cells = 0        # 0 = auto (pow2 ≈ √rows)
        self.ann_nprobe = 8
        self.ann_min_rows = 128   # build lazily once this many rows live
        self.ann_split_width = 0  # 0 = auto; cells past it re-split
        #: seconds of the last index build, by step (embed, train, assign)
        #: and of the last cell-table build (tables)
        self.ann_last_build: Dict[str, float] = {}
        self._ann_reset()
        self._init_sigs()

    def _ann_reset(self) -> None:
        self._ann_centroids: Optional[np.ndarray] = None
        self._ann_arenas: Optional[CellArenas] = None
        self._ann_degraded = False
        self._ann_counters = {"builds": 0, "resplits": 0,
                              "rebuild_failed": 0}
        self._ann_last = {"probed_cells": 0, "rescore_candidates": 0}
        self._ann_recall_probe: Optional[float] = None
        self._ann_queries = 0
        self._ann_dev: Optional[tuple] = None

    def _init_sigs(self) -> None:
        c = self.store.capacity
        self._live_dev: Optional[Tuple[int, torch.Tensor]] = None
        self._mesh_dev = None
        if self.method == "lsh":
            shape, dtype = (c, knn.packed_words(self.hash_num)), torch.int32
        elif self.method == "minhash":
            shape, dtype = (c, self.hash_num), torch.int32
        elif self.method == "euclid_lsh" or self.ann_mode == "ivf":
            # euclid_lsh's projections; for the exact methods the JL probe
            # table of the IVF tier (their rescore stays exact)
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
        if self._ann_arenas is not None:
            self._ann_arenas.remove(row_id)
        return self.store.remove_row(row_id)

    def clear(self) -> None:
        self.store.clear()
        self._pending.clear()
        self._ann_reset()
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

    def _fit_sig_table(self) -> None:
        """Size the signature table to the store. A sharded store grows
        every shard's slot range at once, keeping local slots, so each
        shard's block of rows moves to its new range."""
        have, c = self._sigs.shape[0], self.store.capacity
        if have == c:
            return
        n = getattr(self.store, "n_shards", 1)
        new = self._sigs.new_zeros((c, self._sigs.shape[1]))
        old_c, new_c = have // n, c // n
        for s in range(n):
            new[s * new_c:s * new_c + old_c] = \
                self._sigs[s * old_c:(s + 1) * old_c]
        self._sigs = new
        self._mesh_dev = None

    def flush(self) -> int:
        """Compute the signatures of every pending row in one batch;
        returns how many rows it signed (0 without a signature table).
        With the IVF index live, each signed row joins its nearest cell
        and overflowing cells re-split."""
        if self._sigs is None:
            return 0
        # keep the table sized to the store even when nothing is pending
        self._fit_sig_table()
        if not self._pending:
            return 0
        items = [(rid, self.store.slots[rid]) for rid in self._pending
                 if rid in self.store.slots]
        self._pending.clear()
        if not items:
            return 0
        slots = np.fromiter((s for _, s in items), np.int64, len(items))
        idx = torch.tensor(self.store.idx[slots], device=self.device)
        val = torch.tensor(self.store.val[slots], device=self.device)
        sigs = self._signatures(idx, val)
        self._sigs[torch.from_numpy(slots).to(self.device)] = sigs
        self._mesh_dev = None
        if self._ann_arenas is not None:
            self._ann_assign(sigs, [rid for rid, _ in items])
            self._ann_maintain()
        return len(items)

    def sig_table(self) -> torch.Tensor:
        """The [C, W/H] signature table on the device (after a flush)."""
        self.flush()
        return self._sigs

    def _live_view(self) -> torch.Tensor:
        if self._live_dev is None or self._live_dev[0] != self.store.version:
            self._live_dev = (self.store.version,
                              torch.tensor(self.store.live, device=self.device))
        return self._live_dev[1]

    # -- the IVF tier -------------------------------------------------------------
    def configure_ann(self, mode: str, *, cells: int = 0, nprobe: int = 8,
                      min_rows: int = 128) -> None:
        """Arm or disarm the IVF tier. ``"ivf"`` schedules a lazy index
        build (the first query past ``min_rows`` live rows trains the
        cells); ``"off"`` restores the exact scans, bit-identical to a
        backend that never had the tier. Reconfiguring drops any index
        (and a degraded latch); the exact methods also allocate (or drop)
        the JL probe table and re-pend every row to fill it."""
        if mode not in ("off", "ivf"):
            raise ValueError(f"unknown ann mode {mode!r} "
                             "(expected 'off' or 'ivf')")
        self.ann_mode = mode
        self.ann_cells = max(0, int(cells))
        self.ann_nprobe = max(1, int(nprobe))
        self.ann_min_rows = max(1, int(min_rows))
        self._ann_reset()
        had_sigs = self._sigs is not None
        if self.method in EXACT_METHODS and (mode == "ivf") != had_sigs:
            self._init_sigs()
            self._pending = (dict.fromkeys(self.store.all_ids())
                             if self._sigs is not None else {})

    def _ann_ready(self) -> bool:
        """True when queries take the IVF path: armed, not degraded, and
        the index built (or buildable now)."""
        if self.ann_mode != "ivf" or self._ann_degraded:
            return False
        if self._ann_arenas is not None:
            return True
        if len(self.store) < self.ann_min_rows:
            return False
        return self._ann_rebuild()

    def _ann_embed(self, sig_rows: torch.Tensor) -> torch.Tensor:
        return ivf.embed_signatures(sig_rows, method=self.method,
                                    hash_num=self.hash_num)

    def _rows_of(self, slots: np.ndarray) -> torch.Tensor:
        return self._sigs[torch.from_numpy(slots).to(self.device)]

    def _ann_rebuild(self) -> bool:
        """Train the centroids on a row sample and assign every live row
        to its cell. A fault at ``ann.rebuild`` degrades the tier to the
        exact scan instead of answering from a half-built index."""
        self.flush()
        try:
            faults.fire("ann.rebuild")
        except faults.FaultInjected:
            self._ann_counters["rebuild_failed"] += 1
            self._ann_degrade("rebuild_fault")
            return False
        ids = self.store.all_ids()
        if not ids:
            return False
        slots = np.fromiter((self.store.slots[r] for r in ids),
                            np.int64, len(ids))
        n_cells = self.ann_cells or ivf.auto_cells(len(ids))
        n_cells = max(1, min(n_cells, len(ids)))
        if len(slots) > ANN_SAMPLE:
            rng = np.random.default_rng(self.seed)
            sample = np.sort(rng.choice(slots, ANN_SAMPLE, replace=False))
        else:
            sample = slots
        t0 = time.perf_counter()
        emb_s = self._ann_embed(self._rows_of(sample))
        t1 = time.perf_counter()
        self._ann_centroids = ivf.train_centroids(emb_s, n_cells,
                                                  seed=self.seed)
        t2 = time.perf_counter()
        arenas = CellArenas(self.store, n_cells)
        cen = torch.from_numpy(self._ann_centroids).to(self.device)
        for lo in range(0, len(ids), ANN_SAMPLE):
            chunk = slots[lo:lo + ANN_SAMPLE]
            asg = ivf.assign_cells(self._ann_embed(self._rows_of(chunk)), cen)
            for rid, cell in zip(ids[lo:lo + ANN_SAMPLE], asg.tolist()):
                arenas.assign(rid, cell)
        self.ann_last_build = {"rows": len(ids), "cells": n_cells,
                               "embed_s": t1 - t0, "train_s": t2 - t1,
                               "assign_s": time.perf_counter() - t2}
        self._ann_arenas = arenas
        self._ann_dev = None
        self._ann_counters["builds"] += 1
        # cells can come out of training past the width budget (skewed
        # data): the same re-split pass inserts get
        self._ann_maintain()
        return not self._ann_degraded

    def _ann_assign(self, sig_rows: torch.Tensor, rids: List[str]) -> None:
        """Cell-assign freshly signed rows against the live centroids."""
        if not rids:
            return
        cells = ivf.assign_cells(
            self._ann_embed(sig_rows),
            torch.from_numpy(self._ann_centroids).to(self.device))
        for rid, cell in zip(rids, cells.tolist()):
            self._ann_arenas.assign(rid, cell)

    def _ann_split_width(self) -> int:
        return self.ann_split_width or max(
            64, 4 * max(1, len(self.store) // self._ann_arenas.n_cells))

    def _ann_maintain(self) -> None:
        """Re-split every cell past its width budget into itself and a
        new cell (2-means); a fault at ``ann.rebuild`` degrades."""
        arenas = self._ann_arenas
        if arenas is None:
            return
        width = self._ann_split_width()
        over = [c for c, n in enumerate(arenas.sizes()) if n > width]
        try:
            for cell in over:
                faults.fire("ann.rebuild")
                self._ann_split_cell(cell)
                self._ann_counters["resplits"] += 1
        except faults.FaultInjected:
            self._ann_counters["rebuild_failed"] += 1
            self._ann_degrade("resplit_fault")

    def _ann_split_cell(self, cell: int) -> None:
        arenas = self._ann_arenas
        members = [rid for rid in arenas.members(cell)
                   if rid in self.store.slots]
        if len(members) < 2:
            return
        slots = np.fromiter((self.store.slots[r] for r in members),
                            np.int64, len(members))
        emb = self._ann_embed(self._rows_of(slots))
        cents = ivf.train_centroids(emb, 2, seed=len(members))
        asg = ivf.assign_cells(emb, torch.from_numpy(cents).to(self.device))
        new_cell = arenas.add_cell()
        cen = np.array(self._ann_centroids, np.float32)
        cen[cell] = cents[0]
        self._ann_centroids = np.vstack([cen, cents[1:2]])
        for rid, side in zip(members, asg.tolist()):
            arenas.assign(rid, new_cell if side else cell)
        self._ann_dev = None
        events.emit("ann", "resplit", cell=int(cell), new_cell=int(new_cell),
                    rows=len(members))

    def _ann_degrade(self, reason: str) -> None:
        """Drop the index and latch the tier off: every later query takes
        the exact path until the tier is configured again."""
        self._ann_degraded = True
        self._ann_arenas = None
        self._ann_dev = None
        events.emit("ann", "degraded", severity="warning", reason=reason)

    def _ann_restore(self, centroids: np.ndarray) -> None:
        """Adopt checkpointed centroids over the CURRENT store layout: the
        arenas start empty and every (re-pended) row joins its cell at the
        next flush, through the stored centroids."""
        self._ann_centroids = np.array(centroids, np.float32)
        self._ann_arenas = CellArenas(self.store,
                                      self._ann_centroids.shape[0])
        self._ann_degraded = False
        self._ann_dev = None

    def _ann_device_state(self):
        """(centroids, cell tables, cell_cap) on the device, the tables
        split into shard blocks when a mesh is attached; cached per
        (store, arenas) version."""
        arenas = self._ann_arenas
        key = (self.store.version, arenas.version)
        if self._ann_dev is not None and self._ann_dev[0] == key:
            return self._ann_dev[1:]
        t0 = time.perf_counter()
        tab, cap = arenas.device_tables(self.device)
        cen = torch.from_numpy(self._ann_centroids).to(self.device)
        if self._mesh is not None:
            tab = sharded_knn.shard_table(self._mesh, tab, self._mesh_axis)
        self.ann_last_build["tables_s"] = time.perf_counter() - t0
        self._ann_dev = (key, cen, tab, cap)
        return cen, tab, cap

    def ann_stats(self) -> Dict[str, Any]:
        """The ann.* gauges; {} when the tier is off."""
        if self.ann_mode == "off":
            return {}
        arenas = self._ann_arenas
        st: Dict[str, Any] = {
            "mode": self.ann_mode,
            "built": arenas is not None,
            "degraded": self._ann_degraded,
            "nprobe": self.ann_nprobe,
            "cells": arenas.n_cells if arenas is not None else 0,
            "rows_indexed": len(arenas) if arenas is not None else 0,
        }
        st.update(self._ann_counters)
        st.update(self._ann_last)
        if self._ann_recall_probe is not None:
            st["recall_probe"] = self._ann_recall_probe
        return st

    def _ann_query(self, vecs, k: int) -> List[List[Tuple[str, float]]]:
        self.flush()
        k = min(k, len(self.store))
        if k <= 0 or not vecs:
            return [[] for _ in vecs]
        out = self._ann_neighbors_flat(vecs, k)
        self._ann_shadow(out[0], lambda: self._exact_ids(vecs[0], k))
        return out

    def _ann_neighbors_flat(self, vecs, k: int) -> \
            List[List[Tuple[str, float]]]:
        """The single-device two-phase IVF query: probe, then the exact
        rescore of the probed cells' rows only."""
        q = self._query_sigs_batch(vecs)
        emb = ivf.embed_signatures(q, method=self.method,
                                   hash_num=self.hash_num)
        cen, tab, cap = self._ann_device_state()
        nprobe = min(self.ann_nprobe, self._ann_arenas.n_cells)
        if self.method in HASH_METHODS:
            d, slots = ivf.ivf_topk(
                q, emb, self._sigs, cen, tab, method=self.method,
                hash_num=self.hash_num, k=k, nprobe=nprobe)
        else:
            idx, val, _ = self.store.device_view(self.device)
            qd = np.zeros((len(vecs), self.dim), np.float32)
            for b, vec in enumerate(vecs):
                for i, v in vec:
                    qd[b, i] += v
            d, slots = ivf.ivf_topk_exact(
                torch.from_numpy(qd).to(self.device), emb, idx, val, cen,
                tab, method=self.method, k=k, nprobe=nprobe)
        self._ann_last = {"probed_cells": nprobe,
                          "rescore_candidates": nprobe * cap}
        return self._rows_out(d, slots)

    def _rows_out(self, d: torch.Tensor, slots: torch.Tensor):
        """[B, k] distances and slots → per query [(id, distance)], the
        non-finite ones (no candidate) dropped."""
        d, slots = d.cpu().numpy(), slots.cpu().numpy()
        return [[(self.store.ids[int(s)], float(d[b, j]))
                 for j, s in enumerate(slots[b]) if np.isfinite(d[b, j])]
                for b in range(d.shape[0])]

    def _ann_shadow(self, approx, exact_ids) -> None:
        """Every 64th IVF batch, shadow its first query down the exact path
        and record overlap@k: the ann.recall_probe gauge. ``approx`` is
        that query's IVF answer, ``exact_ids()`` its exact top-k ids."""
        self._ann_queries += 1
        if self._ann_queries % 64 != 1:
            return
        want = exact_ids()
        if want:
            got = {rid for rid, _ in approx}
            self._ann_recall_probe = round(len(want & got) / len(want), 4)

    def _exact_ids(self, vec, k: int) -> set:
        """The flat exact top-k ids of one query (the recall shadow)."""
        d = self.distances(vec)
        kk = min(k, len(self.store))
        if kk <= 0:
            return set()
        order = np.argpartition(d, kk - 1)[:kk]
        return {self.store.ids[int(s)] for s in order if np.isfinite(d[s])}

    # -- row-sharded serving ---------------------------------------------------
    def attach_mesh(self, mesh, axis: str = "shard") -> None:
        """Serve the hash methods from a row-sharded signature table on a
        ``ShardMesh`` instead of one device; mesh=None detaches. Attaching
        swaps the flat store for a ``ShardedRowStore`` (rows land in their
        CHT-owned shard's slot range), re-placing every row. The exact
        methods keep the flat path."""
        if mesh is not None and self.method not in HASH_METHODS:
            raise ValueError(
                f"mesh-sharded serving supports hash methods {HASH_METHODS}, "
                f"not {self.method!r}")
        self._mesh = mesh
        self._mesh_axis = axis
        self._mesh_dev = None
        n = mesh.shape[axis] if mesh is not None else 1
        self._reshape_store(n if n > 1 else 1)

    def _reshape_store(self, n_shards: int) -> None:
        """Swap the store's layout (flat <-> N shards), re-placing every
        live row by ``shard_for`` and re-pending every signature (slots
        move). The update and mix trackers carry over."""
        old = self.store
        sharded = isinstance(old, ShardedRowStore)
        if n_shards <= 1 and not sharded:
            return
        if sharded and old.n_shards == n_shards:
            return
        ids = old.all_ids()
        datums = [old.datums.get(rid) for rid in ids]
        if n_shards > 1:
            new: Any = ShardedRowStore(
                n_shards=n_shards, max_size=old.max_size,
                keep_datum=old.keep_datum)
            slots = np.fromiter((old.slots[r] for r in ids), np.int64,
                                len(ids))
            new.place_all(ids, old.idx[slots], old.val[slots], datums)
        else:
            new = RowStore(max_size=old.max_size, keep_datum=old.keep_datum)
            for rid, datum in zip(ids, datums):
                new.set_row(rid, old.get_row(rid), datum=datum)
        if not old.keep_datum:
            new.datums.update(old.datums)
        new.updated_since_mix = dict(old.updated_since_mix)
        self.store = new
        self._ann_dev = None
        self._init_sigs()
        # every slot moved: recompute every signature at the next flush
        self._pending = (dict.fromkeys(new.all_ids())
                         if self._sigs is not None else {})
        if self._ann_centroids is not None and not self._ann_degraded:
            # re-partition through the STORED centroids over the new
            # layout; the re-pended rows join their cells at the next flush
            self._ann_restore(self._ann_centroids)

    def shard_stats(self) -> Dict[str, Any]:
        """The shard.* gauges: the arena layout and the last sharded
        top-k's wall time."""
        if isinstance(self.store, ShardedRowStore):
            st = self.store.shard_stats()
        else:
            st = {"count": 1, "rows": len(self.store),
                  "rows_per_shard": [len(self.store)],
                  "capacity_per_shard": self.store.capacity,
                  "bytes_in_use":
                      int(self.store.idx.nbytes + self.store.val.nbytes)}
        if self.last_topk_ms is not None:
            st["topk_merge_ms"] = round(self.last_topk_ms, 3)
        return st

    def _mesh_view(self):
        """(signature blocks, live-mask blocks), one of each a shard on its
        device; cached per store version and dropped at every flush."""
        if self._mesh_dev is not None and \
                self._mesh_dev[0] == self.store.version:
            return self._mesh_dev[1:]
        s = self._mesh.shape[self._mesh_axis]
        sigs = self._sigs
        live = torch.from_numpy(self.store.live_mask()).to(self.device)
        pad = (-sigs.shape[0]) % s
        if pad:
            sigs = torch.cat([sigs, sigs.new_zeros((pad, sigs.shape[1]))])
            live = torch.cat([live, live.new_zeros(pad)])
        blocks = sharded_knn.shard_table(self._mesh, sigs, self._mesh_axis)
        valid = sharded_knn.shard_table(self._mesh, live, self._mesh_axis)
        self._mesh_dev = (self.store.version, blocks, valid)
        return blocks, valid

    def _query_sigs_batch(self, vecs) -> torch.Tensor:
        """[B, W/H] query signatures (hash methods) or JL projections (the
        exact methods' IVF probe space), one batch."""
        sb = SparseBatch.from_vectors(list(vecs))
        idx = torch.tensor(sb.idx, device=self.device)
        val = torch.tensor(sb.val, device=self.device)
        return self._signatures(idx, val)

    def _mesh_exact_topk(self, q, sigs, valid, k: int):
        """The exact sharded top-k of pre-computed query signatures."""
        if self.method == "lsh":
            return sharded_knn.sharded_hamming_topk(
                self._mesh, q, sigs, hash_num=self.hash_num, k=k,
                axis=self._mesh_axis, valid=valid)
        if self.method == "minhash":
            return sharded_knn.sharded_minhash_topk(
                self._mesh, q, sigs, k=k, axis=self._mesh_axis, valid=valid)
        return sharded_knn.sharded_euclid_lsh_topk(
            self._mesh, q, sigs, hash_num=self.hash_num, k=k,
            axis=self._mesh_axis, valid=valid)

    def _mesh_neighbors(self, vecs, k: int) -> List[List[Tuple[str, float]]]:
        self.flush()
        k = min(k, len(self.store))
        if k <= 0 or not vecs:
            return [[] for _ in vecs]
        sigs, valid = self._mesh_view()
        t0 = time.perf_counter()
        q = self._query_sigs_batch(vecs)
        ann_used = self._ann_ready()
        if ann_used:
            emb = ivf.embed_signatures(q, method=self.method,
                                       hash_num=self.hash_num)
            cen, tab, cap = self._ann_device_state()
            nprobe = min(self.ann_nprobe, self._ann_arenas.n_cells)
            d, gidx = sharded_ivf.sharded_ivf_topk(
                self._mesh, q, emb, sigs, cen, tab, method=self.method,
                hash_num=self.hash_num, k=k, nprobe=nprobe,
                axis=self._mesh_axis)
            self._ann_last = {"probed_cells": nprobe,
                              "rescore_candidates": nprobe * cap}
        else:
            d, gidx = self._mesh_exact_topk(q, sigs, valid, k)
        d, gidx = d.cpu(), gidx.cpu()
        self.last_topk_ms = (time.perf_counter() - t0) * 1e3
        out = self._rows_out(d, gidx)
        if ann_used:
            self._ann_shadow(out[0], lambda: {
                rid for rid, _ in self._rows_out(
                    *self._mesh_exact_topk(q[:1], sigs, valid, k))[0]})
        return out

    def _mesh_distances(self, q_batch: torch.Tensor) -> np.ndarray:
        """[B, C] distances from the row-sharded table (dead slots not
        masked)."""
        sigs, _valid = self._mesh_view()
        d = sharded_knn.sharded_distances(
            self._mesh, q_batch, sigs, method=self.method,
            hash_num=self.hash_num, axis=self._mesh_axis)
        return d.cpu().numpy()[:, :self.store.capacity]

    # -- queries ---------------------------------------------------------------
    def _query_sig(self, vec: SparseVector) -> torch.Tensor:
        return self._query_sigs_batch([vec])[0]

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
        """[C] distances on the device, dead slots +inf (flat layout)."""
        inf = torch.tensor(float("inf"), device=self.device)
        if self.method in EXACT_METHODS:
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
        if self._mesh is not None:
            d = self._mesh_distances(self._query_sig(vec)[None])[0]
            d[~self.store.live] = np.inf
            return d
        return self._distances_dev(vec).cpu().numpy()

    def similarity_from_distance(self, d: np.ndarray) -> np.ndarray:
        if self.method in ("euclid_lsh", "euclid"):
            return -d
        return 1.0 - d

    def neighbors(self, vec: SparseVector, k: int) -> List[Tuple[str, float]]:
        """k nearest as (id, distance), ascending."""
        if self._mesh is not None:
            return self._mesh_neighbors([vec], k)[0]
        self.flush()
        if self._ann_ready():
            return self._ann_query([vec], k)[0]
        k = min(k, len(self.store))
        if k <= 0:
            return []
        d = self._distances_dev(vec)
        vals, order = torch.topk(d, k, largest=False, sorted=True)
        vals, order = vals.cpu().numpy(), order.cpu().numpy()
        return [(self.store.ids[s], float(v)) for s, v in zip(order, vals)]

    def neighbors_batch(self, vecs: List[SparseVector],
                        k: int) -> List[List[Tuple[str, float]]]:
        """Batched k-nearest: one sharded scan for the whole batch when a
        mesh is attached, one batched IVF probe when the tier is live,
        else one exact scan per query."""
        if self._mesh is not None:
            return self._mesh_neighbors(list(vecs), k)
        self.flush()
        if self._ann_ready():
            return self._ann_query(list(vecs), k)
        return [self.neighbors(v, k) for v in vecs]

    def similar(self, vec: SparseVector, k: int) -> List[Tuple[str, float]]:
        """k most similar as (id, similarity), descending."""
        return [(rid, float(self.similarity_from_distance(np.float32(dist))))
                for rid, dist in self.neighbors(vec, k)]

    # -- batch distances (LOF lrd cache) ---------------------------------------
    def distances_from_slots(self, slots: np.ndarray,
                             chunk: int = 256) -> np.ndarray:
        """Distances from each of the given row slots to every slot:
        [len(slots), C]; dead columns +inf. The hash methods run one
        batched scan per chunk of ``chunk`` rows (over the mesh's shards
        when one is attached); the exact methods loop over the rows, one
        single-query scan each."""
        self.flush()
        c = self.store.capacity
        out = np.full((len(slots), c), np.inf, np.float32)
        if not len(self.store):
            return out
        if self.method in EXACT_METHODS:
            for row, s in enumerate(slots):
                vec = self.store.get_row(self.store.ids[int(s)]) or []
                out[row] = self._distances_dev(vec).cpu().numpy()
            return out
        sigs = self._sigs
        for lo in range(0, len(slots), chunk):
            sel = torch.as_tensor(np.asarray(slots[lo:lo + chunk], np.int64),
                                  device=self.device)
            if self._mesh is not None:
                out[lo:lo + chunk] = self._mesh_distances(sigs[sel])
            else:
                out[lo:lo + chunk] = self._scan(sigs[sel], sigs).cpu().numpy()
        out[:, ~self.store.live] = np.inf
        return out

    # -- persistence / mix -----------------------------------------------------
    def pack(self) -> Any:
        self.flush()
        out: Dict[str, Any] = {"store": self.store.pack()}
        if self.ann_mode == "ivf" and self._ann_centroids is not None:
            cen = np.ascontiguousarray(self._ann_centroids, np.float32)
            # the centroid table rides the save_load envelope as raw bytes
            # and its shape
            out["ann"] = {"cells": int(cen.shape[0]),
                          "dim": int(cen.shape[1]),
                          "centroids": cen.tobytes()}
        return out

    def unpack(self, obj: Any, datum_decoder=None) -> None:
        self.clear()
        self.store.unpack(obj["store"], datum_decoder=datum_decoder)
        if self._sigs is not None:
            self._pending = dict.fromkeys(self.store.all_ids())
        ann = obj.get("ann") if isinstance(obj, dict) else None
        if ann is not None and self.ann_mode == "ivf":
            cen = np.frombuffer(ann["centroids"], np.float32)
            self._ann_restore(cen.reshape(ann["cells"], ann["dim"]))

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


class NNIndexStats:
    """The shard.* and ann.* gauges of a driver on an NNBackend (mixed
    into drivers that define ``self.backend``)."""

    def shard_stats(self) -> Dict[str, Any]:
        """Row-shard layout gauges; empty when unsharded."""
        if self.backend._mesh is None:
            return {}
        return self.backend.shard_stats()

    def ann_stats(self) -> Dict[str, Any]:
        """IVF tier gauges; empty when the tier is off."""
        return self.backend.ann_stats()

    def index_status(self) -> Dict[str, Any]:
        """Both, under their prefixes, for get_status."""
        st = {f"shard.{k}": v for k, v in self.shard_stats().items()}
        st.update({f"ann.{k}": v for k, v in self.ann_stats().items()})
        return st


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
