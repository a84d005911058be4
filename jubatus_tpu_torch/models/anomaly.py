"""Anomaly engine driver (counterpart of ``jubatus_tpu/models/anomaly.py``):
LOF / light_lof over a nearest-neighbor backend.

API of the reference's anomaly service: clear_row / add / update /
overwrite / clear / calc_score / get_all_rows. Config: method lof|light_lof,
parameter {nearest_neighbor_num, reverse_nearest_neighbor_num, method: <nn
method>, parameter: {...}}, optional lru unlearner.

Local Outlier Factor with k = nearest_neighbor_num:

  kdist(o)       distance from o to its k-th nearest stored neighbor
  reach(q, o)  = max(kdist(o), d(q, o))
  lrd(q)       = k / Σ_{o ∈ kNN(q)} reach(q, o)
  LOF(q)       = mean_{o ∈ kNN(q)} lrd(o) / lrd(q)

``add`` scores the point against the store before inserting it and returns
(generated_id, score); ids come from the driver's counter unless a cluster
id generator is set (``set_id_generator``).

The per-row kdist/lrd tables (``_support``) are rebuilt per store version
from ``NNBackend.distances_from_slots`` (for lsh/minhash the signature-scan
kernel at up to 256 queries a launch) read back as an [n, C] float32
array. ``_support`` and ``_score`` then run on the host in numpy, as the
JAX package's do: numpy's sort/argsort/argpartition decide the order of
tied distances, so equal distances give equal scores in both packages.
"""

from __future__ import annotations

import json
from typing import Any, Dict, List, Optional, Tuple

import numpy as np

from jubatus_tpu_torch.core.datum import Datum
from jubatus_tpu_torch.core.fv import make_fv_converter
from jubatus_tpu_torch.core.sparse import SparseVector
from jubatus_tpu_torch.framework.driver import DriverBase, locked
from jubatus_tpu_torch.models._nn_backend import NNBackend, NNIndexStats
from jubatus_tpu_torch.models.nearest_neighbor import _RowUpdateMixable

METHODS = ("lof", "light_lof")


class AnomalyConfigError(ValueError):
    pass


class AnomalyDriver(NNIndexStats, DriverBase):
    TYPE = "anomaly"

    def __init__(self, config: dict, dim_bits: int = 18, device=None):
        super().__init__()
        self.config = config
        self.config_json = json.dumps(config)
        method = config.get("method")
        if method not in METHODS:
            raise AnomalyConfigError(f"unknown anomaly method {method!r}")
        self.method = method
        param = dict(config.get("parameter") or {})
        self.k = int(param.get("nearest_neighbor_num", 10))
        nn_method = param.get("method", "euclid_lsh")
        nn_param = dict(param.get("parameter") or {})
        if nn_method == "inverted_index_euclid":
            nn_method = "euclid"
        self.converter = make_fv_converter(config.get("converter"),
                                           dim_bits=dim_bits)
        unl_param = param.get("unlearner_parameter") or {}
        self.backend = NNBackend(
            nn_method,
            dim=self.converter.dim,
            hash_num=int(nn_param.get("hash_num", 64)),
            seed=int(nn_param.get("seed", 0)),
            max_size=(int(unl_param["max_size"])
                      if param.get("unlearner") == "lru" else None),
            device=device,
        )
        self._next_id = 0
        #: cluster-wide id minting, set by a server in distributed mode so
        #: ids minted on different nodes never collide; None standalone
        self.idgen = None
        self._lrd_cache: Optional[Tuple[int, np.ndarray, np.ndarray]] = None

    @property
    def device(self):
        return self.backend.device

    def set_id_generator(self, gen) -> None:
        self.idgen = gen

    # -- lrd support structure -------------------------------------------------
    def _support(self) -> Tuple[np.ndarray, np.ndarray]:
        """(kdist [C], lrd [C]) over store slots, rebuilt per store version."""
        v = self.backend.store.version
        if self._lrd_cache is not None and self._lrd_cache[0] == v:
            return self._lrd_cache[1], self._lrd_cache[2]
        store = self.backend.store
        c = store.capacity
        kdist = np.full(c, np.inf, np.float32)
        lrd = np.zeros(c, np.float32)
        slots = np.asarray(sorted(store.slots.values()), np.int64)
        n = len(slots)
        if n >= 2:
            k = min(self.k, n - 1)
            d = self.backend.distances_from_slots(slots)     # [n, C]
            d[np.arange(n), slots] = np.inf                  # exclude self
            dl = d[:, slots]                                 # [n, n]
            part = np.sort(dl, axis=1)[:, :k]                # kNN distances
            kdist[slots] = part[:, -1]
            # lrd needs each row's neighbors' kdist
            nbr = np.argsort(dl, axis=1)[:, :k]              # local indices
            nbr_slots = slots[nbr]                           # [n, k]
            reach = np.maximum(kdist[nbr_slots], np.take_along_axis(dl, nbr, 1))
            denom = reach.sum(axis=1)
            lrd[slots] = np.where(denom > 0, k / np.maximum(denom, 1e-30),
                                  np.float32(np.inf))
        self._lrd_cache = (v, kdist, lrd)
        return kdist, lrd

    def _score(self, vec: SparseVector) -> float:
        """LOF of a query point against the current store."""
        store = self.backend.store
        n = len(store)
        if n < 2:
            return 1.0
        k = min(self.k, n)
        kdist, lrd = self._support()
        d = self.backend.distances(vec)                      # [C]
        order = np.argpartition(d, k - 1)[:k]
        order = order[np.argsort(d[order])]
        reach = np.maximum(kdist[order], d[order])
        denom = reach.sum()
        if denom <= 0:
            return 1.0  # exact duplicates of dense cluster points
        lrd_q = k / denom
        nbr_lrd = lrd[order]
        if np.isinf(nbr_lrd).any():
            return float("inf") if not np.isinf(lrd_q) else 1.0
        return float(nbr_lrd.mean() / lrd_q)

    # -- updates ---------------------------------------------------------------
    def add(self, row: Datum) -> Tuple[str, float]:
        # mint a cluster id before taking the model lock, so a round trip
        # to the generator does not stall the other RPC threads
        row_id = str(self.idgen.generate()) if self.idgen is not None else None
        with self.lock:
            if row_id is None:
                row_id = str(self._next_id)
                self._next_id += 1
            vec = self.converter.convert(row, update_weights=True)
            score = self._score(vec)
            self.backend.set_row(row_id, vec)
            self.event_model_updated()
        return row_id, score

    @locked
    def update(self, row_id: str, row: Datum) -> float:
        if row_id not in self.backend.store:
            raise KeyError(f"unknown row id {row_id!r}")
        return self._overwrite(row_id, row)

    @locked
    def overwrite(self, row_id: str, row: Datum) -> float:
        return self._overwrite(row_id, row)

    def _overwrite(self, row_id: str, row: Datum) -> float:
        vec = self.converter.convert(row, update_weights=True)
        self.backend.remove_row(row_id)
        score = self._score(vec)
        self.backend.set_row(row_id, vec)
        self.event_model_updated()
        return score

    @locked
    def clear_row(self, row_id: str) -> bool:
        ok = self.backend.remove_row(row_id)
        if ok:
            self.event_model_updated()
        return ok

    @locked
    def clear(self) -> None:
        self.backend.clear()
        self.converter.weights.clear()
        self._next_id = 0
        self._lrd_cache = None
        self.update_count = 0

    # -- queries ---------------------------------------------------------------
    @locked
    def calc_score(self, row: Datum) -> float:
        return self._score(self.converter.convert(row))

    @locked
    def get_all_rows(self) -> List[str]:
        return self.backend.store.all_ids()

    # -- mix plane -------------------------------------------------------------
    def get_mixables(self):
        return {"rows": _RowUpdateMixable(self.backend),
                "weights": self.converter.weights}

    # -- persistence -----------------------------------------------------------
    @locked
    def pack(self) -> Any:
        return {"method": self.method, "backend": self.backend.pack(),
                "weights": self.converter.weights.pack(),
                "next_id": self._next_id}

    @locked
    def unpack(self, obj: Any) -> None:
        saved = obj.get("method")
        if isinstance(saved, bytes):
            saved = saved.decode()
        if saved != self.method:
            raise ValueError(
                f"checkpoint method {saved!r} != driver method {self.method!r}")
        self.backend.unpack(obj["backend"])
        self.converter.weights.unpack(obj["weights"])
        self._next_id = int(obj.get("next_id", 0))
        self._lrd_cache = None

    @locked
    def get_status(self) -> Dict[str, Any]:
        st = super().get_status()
        st.update(method=self.method, num_rows=len(self.backend.store),
                  k=self.k, device=str(self.device))
        st.update(self.index_status())
        return st
