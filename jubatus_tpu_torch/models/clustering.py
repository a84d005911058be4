"""Clustering engine driver (counterpart of
``jubatus_tpu/models/clustering.py``): methods kmeans, gmm and dbscan, with
the simple and compressive compressors.

Business API of the reference's clustering service: push / get_revision /
get_core_members(_light) / get_k_center / get_nearest_center /
get_nearest_members(_light) / clear.

- ``push`` buffers weighted points; every ``bucket_size`` pushed points the
  model reclusters and ``revision`` increments. One fit serves however many
  buckets a push completed. Queries serve the last finished clustering and
  raise ``NotClusteredError`` before the first.
- ``compressive`` caps the working set at ``compressed_bucket_size``
  points; the evicted points fold their weight into their nearest survivor.
  Its draw is numpy's generator seeded with ``seed + revision``, as in the
  JAX package, so both packages keep the same survivors.

Host work stays as the JAX driver has it: the working set is compacted on
the host to a dense [N, d_active] matrix over the distinct hashed features
(``_compact``), uploaded, fitted on the driver's device (``ops/
clustering.py``), and the centres and assignments are read back to numpy
inside the lock. ``last_recluster`` keeps the wall seconds of the last
recluster's steps: compact, upload, fit (to the device's completion),
readback and members.
"""

from __future__ import annotations

import json
import time
from typing import Any, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from jubatus_tpu_torch import resolve_device, synchronize
from jubatus_tpu_torch.core.datum import Datum
from jubatus_tpu_torch.core.fv import make_fv_converter
from jubatus_tpu_torch.framework.driver import DriverBase, locked
from jubatus_tpu_torch.ops import clustering as ops

METHODS = ("kmeans", "gmm", "dbscan")


class ClusteringConfigError(ValueError):
    pass


class NotClusteredError(RuntimeError):
    """Raised by query methods before the first clustering round."""


class ClusteringDriver(DriverBase):
    TYPE = "clustering"

    def __init__(self, config: dict, dim_bits: int = 18, device=None):
        super().__init__()
        self.config = config
        self.config_json = json.dumps(config)
        method = config.get("method")
        if method not in METHODS:
            raise ClusteringConfigError(f"unknown clustering method {method!r}")
        self.method = method
        param = dict(config.get("parameter") or {})
        self.k = int(param.get("k", 2))
        self.seed = int(param.get("seed", 0))
        self.eps = float(param.get("eps", 0.2))
        self.min_core_point = int(param.get("min_core_point", 2))
        self.compressor = config.get("compressor_method", "simple")
        cparam = dict(config.get("compressor_parameter") or {})
        self.bucket_size = int(cparam.get("bucket_size", 100))
        self.compressed_size = int(cparam.get("compressed_bucket_size",
                                              self.bucket_size * 4))
        self.device = resolve_device(device)
        self.converter = make_fv_converter(config.get("converter"),
                                           dim_bits=dim_bits)
        #: wall seconds of the last recluster's steps
        self.last_recluster: Dict[str, Any] = {}
        self._init_model()

    def _init_model(self) -> None:
        # working set: parallel lists (id, datum, sparse vec, weight)
        self._ids: List[str] = []
        self._id_pos: Dict[str, int] = {}  # id -> row in the parallel lists
        self._datums: List[Datum] = []
        self._vecs: List[list] = []
        self._weights: List[float] = []
        self._pending = 0
        self._mix_new_ids: List[str] = []
        self.revision = 0
        # snapshot of the last clustering, host numpy
        self._centers: Optional[np.ndarray] = None   # [k, d_active]
        self._active_dims: Optional[np.ndarray] = None
        self._assign: Optional[np.ndarray] = None    # [N]
        self._members: List[List[int]] = []          # cluster -> working-set rows

    # -- update ----------------------------------------------------------------
    @locked
    def push(self, points: Sequence[Tuple[str, Datum]]) -> bool:
        csr = self.converter.convert_batch(
            [datum for _, datum in points], update_weights=True)
        for pos, (row_id, datum) in enumerate(points):
            vec = csr.row(pos)
            i = self._id_pos.get(row_id)
            if i is not None:
                self._datums[i], self._vecs[i] = datum, vec
            else:
                self._id_pos[row_id] = len(self._ids)
                self._ids.append(row_id)
                self._datums.append(datum)
                self._vecs.append(vec)
                self._weights.append(1.0)
                self._mix_new_ids.append(row_id)
            self._pending += 1
        self.event_model_updated(len(points))
        if self._pending >= self.bucket_size:
            self._pending %= self.bucket_size
            self._recluster()
        return True

    def _compact(self) -> Tuple[np.ndarray, np.ndarray]:
        """Working set → dense [N, d_active] + the active dim index vector."""
        dims = sorted({i for vec in self._vecs for i, _ in vec})
        pos = {d: j for j, d in enumerate(dims)}
        x = np.zeros((len(self._vecs), max(len(dims), 1)), np.float32)
        for r, vec in enumerate(self._vecs):
            for i, v in vec:
                x[r, pos[i]] = v
        return x, np.asarray(dims or [0], np.int64)

    def _downsample(self) -> None:
        """Compressive compressor: cap the working set; evicted points fold
        their weight into their nearest survivor."""
        n = len(self._ids)
        if n <= self.compressed_size:
            return
        rng = np.random.default_rng(self.seed + self.revision)
        w = np.asarray(self._weights)
        keep = rng.choice(n, size=self.compressed_size, replace=False,
                          p=w / w.sum())
        keep_set = set(int(i) for i in keep)
        x, _ = self._compact()
        survivors = sorted(keep_set)
        sx = x[survivors]
        new_w = {s: self._weights[s] for s in survivors}
        for i in range(n):
            if i in keep_set:
                continue
            d2 = ((sx - x[i]) ** 2).sum(axis=1)
            nearest = survivors[int(np.argmin(d2))]
            new_w[nearest] += self._weights[i]
        self._ids = [self._ids[s] for s in survivors]
        self._id_pos = {rid: i for i, rid in enumerate(self._ids)}
        self._datums = [self._datums[s] for s in survivors]
        self._vecs = [self._vecs[s] for s in survivors]
        self._weights = [new_w[s] for s in survivors]

    def _recluster(self) -> None:
        if self.compressor.startswith("compressive"):
            self._downsample()
        if not self._vecs:
            return
        t0 = time.perf_counter()
        x, dims = self._compact()
        w = np.asarray(self._weights, np.float32)
        t1 = time.perf_counter()
        xt = torch.from_numpy(x).to(self.device)
        wt = torch.from_numpy(w).to(self.device)
        synchronize(self.device)
        t2 = time.perf_counter()
        if self.method == "kmeans":
            out = ops.kmeans_fit(xt, wt, k=min(self.k, len(self._vecs)),
                                 seed=self.seed)
        elif self.method == "gmm":
            state, assign = ops.gmm_fit(xt, wt, k=min(self.k, len(self._vecs)),
                                        seed=self.seed)
            out = (state.means, assign)
        else:
            out = (ops.dbscan_fit(xt, wt, self.eps,
                                  min_core_point=self.min_core_point),)
        synchronize(self.device)
        t3 = time.perf_counter()
        out = [o.cpu().numpy() for o in out]
        t4 = time.perf_counter()
        if self.method == "dbscan":
            labels = out[0]
            reps = sorted({int(lab) for lab in labels if lab >= 0})
            renum = {rep: c for c, rep in enumerate(reps)}
            assign = np.asarray([renum.get(int(lab), -1) for lab in labels])
            centers = np.zeros((max(len(reps), 1), x.shape[1]), np.float32)
            for c in range(len(reps)):
                rows = assign == c
                if rows.any():
                    cw = w[rows][:, None]
                    centers[c] = (x[rows] * cw).sum(0) / cw.sum()
        else:
            centers, assign = out
        self._centers = centers
        self._active_dims = dims
        self._assign = assign
        self._members = [
            [i for i in range(len(assign)) if assign[i] == c]
            for c in range(len(centers))
        ]
        self.revision += 1
        self.last_recluster = dict(
            method=self.method, n=int(x.shape[0]), d=int(x.shape[1]),
            compact_s=t1 - t0, upload_s=t2 - t1, fit_s=t3 - t2,
            readback_s=t4 - t3, members_s=time.perf_counter() - t4)

    @locked
    def clear(self) -> None:
        self._init_model()
        self.converter.weights.clear()
        self.update_count = 0

    # -- queries ---------------------------------------------------------------
    def _require_clustered(self) -> None:
        if self._centers is None:
            raise NotClusteredError(
                f"not clustered yet: {self._pending + len(self._ids)} points "
                f"pushed, bucket_size={self.bucket_size}")

    @locked
    def get_revision(self) -> int:
        return self.revision

    def _center_datum(self, c: int) -> Datum:
        num_values = []
        for j, dim in enumerate(self._active_dims):
            v = float(self._centers[c, j])
            if v == 0.0:
                continue
            decoded = self.converter.revert_feature(int(dim))
            if decoded is None:
                continue
            key, sval = decoded
            if not sval:
                num_values.append((key, v))
        return Datum(num_values=num_values)

    @locked
    def get_k_center(self) -> List[Datum]:
        self._require_clustered()
        return [self._center_datum(c) for c in range(len(self._centers))]

    @locked
    def get_core_members(self) -> List[List[Tuple[float, Datum]]]:
        self._require_clustered()
        return [[(self._weights[i], self._datums[i]) for i in mem]
                for mem in self._members]

    @locked
    def get_core_members_light(self) -> List[List[Tuple[float, str]]]:
        self._require_clustered()
        return [[(self._weights[i], self._ids[i]) for i in mem]
                for mem in self._members]

    def _nearest_cluster(self, datum: Datum) -> int:
        vec = dict(self.converter.convert(datum))
        pos = {int(d): j for j, d in enumerate(self._active_dims)}
        q = np.zeros(self._centers.shape[1], np.float32)
        for i, v in vec.items():
            j = pos.get(i)
            if j is not None:
                q[j] = v
        d2 = ((self._centers - q) ** 2).sum(axis=1)
        return int(np.argmin(d2))

    @locked
    def get_nearest_center(self, datum: Datum) -> Datum:
        self._require_clustered()
        return self._center_datum(self._nearest_cluster(datum))

    @locked
    def get_nearest_members(self, datum: Datum) -> List[Tuple[float, Datum]]:
        self._require_clustered()
        c = self._nearest_cluster(datum)
        return [(self._weights[i], self._datums[i]) for i in self._members[c]]

    @locked
    def get_nearest_members_light(self, datum: Datum) -> List[Tuple[float, str]]:
        self._require_clustered()
        c = self._nearest_cluster(datum)
        return [(self._weights[i], self._ids[i]) for i in self._members[c]]

    # -- mix plane --------------------------------------------------------------
    def get_mixables(self):
        return {"points": _PointMixable(self)}

    # -- persistence ------------------------------------------------------------
    @locked
    def pack(self) -> Any:
        return {
            "method": self.method,
            "ids": list(self._ids),
            "datums": [d.to_msgpack() for d in self._datums],
            "weights": list(self._weights),
            "pending": self._pending,
            "revision": self.revision,
            "fv_weights": self.converter.weights.pack(),
        }

    @locked
    def unpack(self, obj: Any) -> None:
        saved = obj.get("method")
        if isinstance(saved, bytes):
            saved = saved.decode()
        if saved != self.method:
            raise ValueError(
                f"checkpoint method {saved!r} != driver method {self.method!r}")
        self._init_model()
        ids = [i.decode() if isinstance(i, bytes) else i for i in obj["ids"]]
        datums = [Datum.from_msgpack(d) for d in obj["datums"]]
        self._ids = ids
        self._id_pos = {rid: i for i, rid in enumerate(ids)}
        self._datums = datums
        # the converter's weight state first, so idf / user weights give
        # the original vectors again
        if "fv_weights" in obj:
            self.converter.weights.unpack(obj["fv_weights"])
        self._vecs = self.converter.convert_batch(datums).rows()
        self._weights = [float(w) for w in obj["weights"]]
        self._pending = int(obj.get("pending", 0))
        if self._vecs:
            self._recluster()
        self.revision = int(obj["revision"])

    @locked
    def get_status(self) -> Dict[str, Any]:
        st = super().get_status()
        st.update(method=self.method, revision=self.revision,
                  num_points=len(self._ids), device=str(self.device))
        return st


class _PointMixable:
    """Replicates pushed points across the cluster: diff = points added
    since the last mix as {id: (datum_msgpack, weight)}; dict-merge fold."""

    def __init__(self, driver: ClusteringDriver):
        self._d = driver

    def get_diff(self):
        d = self._d
        out = {}
        for rid in d._mix_new_ids:
            i = d._id_pos.get(rid)
            if i is not None:
                out[rid] = (d._datums[i].to_msgpack(), d._weights[i])
        d._mix_new_ids = []
        return out

    @staticmethod
    def mix(acc, diff):
        acc.update(diff)
        return acc

    def put_diff(self, diff) -> bool:
        d = self._d
        pts = []
        for rid, (dm, w) in diff.items():
            rid = rid.decode() if isinstance(rid, bytes) else rid
            if rid not in d._id_pos:
                pts.append((rid, Datum.from_msgpack(dm)))
        if pts:
            d.push(pts)
        d._mix_new_ids = []
        return True
