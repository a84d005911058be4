"""Recommender engine driver (counterpart of ``jubatus_tpu/models/recommender.py``).

API of the reference's recommender service: clear_row / update_row / clear
/ complete_row_from_{id,datum} / similar_row_from_{id,datum} / decode_row /
get_all_rows / calc_similarity / calc_l2norm. Methods: inverted_index,
inverted_index_euclid, lsh, minhash, euclid_lsh and
nearest_neighbor_recommender (a nested NN config), each with an optional
{"unlearner": "lru", "unlearner_parameter": {"max_size": N}}.

- similar_row_* return (id, similarity) descending (conventions in
  models/_nn_backend.py).
- complete_row_* fills in a datum by averaging the feature vectors of the
  nearest ``_COMPLETE_TOP_K`` rows, weighted by similarity, and decodes the
  hashed features back to (key, value) through the hasher's reverse table.
- decode_row returns the stored datum (the store keeps it).
``pack()`` gives the JAX driver's layout, so checkpoints move both ways.
"""

from __future__ import annotations

import json
import math
from typing import Any, Dict, List, Tuple

from jubatus_tpu_torch.core.datum import Datum
from jubatus_tpu_torch.core.fv import make_fv_converter
from jubatus_tpu_torch.core.sparse import SparseVector
from jubatus_tpu_torch.framework.driver import DriverBase, locked
from jubatus_tpu_torch.models._nn_backend import (NNBackend, NNIndexStats,
                                                  NNRowMigration)
from jubatus_tpu_torch.models.nearest_neighbor import _RowUpdateMixable

METHODS = ("inverted_index", "inverted_index_euclid", "lsh", "minhash",
           "euclid_lsh", "nearest_neighbor_recommender")

#: rows aggregated by complete_row (similarity-weighted average)
_COMPLETE_TOP_K = 128


class RecommenderConfigError(ValueError):
    pass


class RecommenderDriver(NNIndexStats, NNRowMigration, DriverBase):
    TYPE = "recommender"

    def __init__(self, config: dict, dim_bits: int = 18, device=None):
        super().__init__()
        self.config = config
        self.config_json = json.dumps(config)
        method = config.get("method")
        if method not in METHODS:
            raise RecommenderConfigError(f"unknown recommender method {method!r}")
        self.method = method
        param = dict(config.get("parameter") or {})
        self.converter = make_fv_converter(config.get("converter"),
                                           dim_bits=dim_bits)
        if method == "nearest_neighbor_recommender":
            backend_method = param.get("method")
            param = dict(param.get("parameter") or {})
        elif method == "inverted_index_euclid":
            backend_method = "euclid"
        else:
            backend_method = method
        unl_param = param.get("unlearner_parameter") or {}
        self.backend = NNBackend(
            backend_method,
            dim=self.converter.dim,
            hash_num=int(param.get("hash_num", 64)),
            seed=int(param.get("seed", 0)),
            max_size=(int(unl_param["max_size"])
                      if param.get("unlearner") == "lru" else None),
            keep_datum=True,
            device=device,
        )

    @property
    def device(self):
        return self.backend.device

    # -- updates --------------------------------------------------------------
    @locked
    def update_row(self, row_id: str, row: Datum) -> bool:
        """Updating an existing row overlays the new datum's keys onto the
        stored one, then converts the merged datum."""
        old = self.backend.store.datums.get(row_id)
        if old is not None:
            merged_str = dict(old.string_values)
            merged_num = dict(old.num_values)
            merged_str.update(row.string_values)
            merged_num.update(row.num_values)
            row = Datum(string_values=merged_str.items(),
                        num_values=merged_num.items())
        vec = self.converter.convert(row, update_weights=True)
        self.backend.set_row(row_id, vec, datum=row)
        self.event_model_updated()
        return True

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
        self.update_count = 0

    # -- queries --------------------------------------------------------------
    def _row_vec(self, row_id: str) -> SparseVector:
        vec = self.backend.store.get_row(row_id)
        if vec is None:
            raise KeyError(f"unknown row id {row_id!r}")
        return vec

    @locked
    def similar_row_from_id(self, row_id: str, size: int) -> List[Tuple[str, float]]:
        return self.backend.similar(self._row_vec(row_id), size)

    @locked
    def similar_row_from_datum(self, row: Datum, size: int) -> List[Tuple[str, float]]:
        return self.backend.similar(self.converter.convert(row), size)

    def _complete(self, vec: SparseVector) -> Datum:
        # aggregation weights must be positive: cosine/hash similarities are
        # used as they are (anti-correlated rows drop out), the euclid
        # family's similarity is a negated distance, so it weighs 1/(1+d)
        neighbors = self.backend.neighbors(vec, _COMPLETE_TOP_K)
        euclid = self.backend.method in ("euclid_lsh", "euclid")
        acc: Dict[int, float] = {}
        total = 0.0
        for rid, dist in neighbors:
            w = 1.0 / (1.0 + dist) if euclid else 1.0 - dist
            if w <= 0:
                continue
            total += w
            for i, v in self.backend.store.get_row(rid) or []:
                acc[i] = acc.get(i, 0.0) + w * v
        if total <= 0:
            return Datum()
        string_values: List[Tuple[str, str]] = []
        num_values: List[Tuple[str, float]] = []
        for i, v in sorted(acc.items()):
            decoded = self.converter.revert_feature(i)
            if decoded is None:
                continue
            key, sval = decoded
            if sval:
                string_values.append((key, sval))
            else:
                num_values.append((key, v / total))
        return Datum(string_values=string_values, num_values=num_values)

    @locked
    def complete_row_from_id(self, row_id: str) -> Datum:
        return self._complete(self._row_vec(row_id))

    @locked
    def complete_row_from_datum(self, row: Datum) -> Datum:
        return self._complete(self.converter.convert(row))

    @locked
    def decode_row(self, row_id: str) -> Datum:
        return self.backend.store.datums.get(row_id) or Datum()

    @locked
    def get_all_rows(self) -> List[str]:
        return self.backend.store.all_ids()

    @locked
    def calc_similarity(self, lhs: Datum, rhs: Datum) -> float:
        a = dict(self.converter.convert(lhs))
        b = dict(self.converter.convert(rhs))
        dot = sum(v * b.get(i, 0.0) for i, v in a.items())
        na = math.sqrt(sum(v * v for v in a.values()))
        nb = math.sqrt(sum(v * v for v in b.values()))
        return dot / (na * nb) if na > 0 and nb > 0 else 0.0

    @locked
    def calc_l2norm(self, row: Datum) -> float:
        vec = self.converter.convert(row)
        return math.sqrt(sum(v * v for _, v in vec))

    # -- mix plane -------------------------------------------------------------
    def get_mixables(self):
        return {"rows": _RowUpdateMixable(self.backend),
                "weights": self.converter.weights}

    # -- persistence -----------------------------------------------------------
    @locked
    def pack(self) -> Any:
        return {"method": self.method, "backend": self.backend.pack(),
                "weights": self.converter.weights.pack()}

    @locked
    def unpack(self, obj: Any) -> None:
        saved = obj.get("method")
        if isinstance(saved, bytes):
            saved = saved.decode()
        if saved != self.method:
            raise ValueError(
                f"checkpoint method {saved!r} != driver method {self.method!r}")
        self.backend.unpack(obj["backend"], datum_decoder=Datum.from_msgpack)
        self.converter.weights.unpack(obj["weights"])

    @locked
    def get_status(self) -> Dict[str, Any]:
        st = super().get_status()
        st.update(method=self.method, num_rows=len(self.backend.store),
                  device=str(self.device))
        st.update(self.index_status())
        return st
