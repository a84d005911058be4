"""Nearest-neighbor engine driver (counterpart of
``jubatus_tpu/models/nearest_neighbor.py``).

API of the reference's nearest_neighbor service: clear / set_row /
neighbor_row_from_{id,datum} / similar_row_from_{id,datum} / get_all_rows,
with methods lsh / minhash / euclid_lsh and parameter {hash_num}.
neighbor_* return (id, distance) ascending; similar_* return
(id, similarity) descending — conventions in models/_nn_backend.py.
``pack()`` gives the JAX driver's layout, so checkpoints move both ways.
"""

from __future__ import annotations

import json
from typing import Any, Dict, List, Tuple

from jubatus_tpu_torch.core.datum import Datum
from jubatus_tpu_torch.core.fv import make_fv_converter
from jubatus_tpu_torch.framework.driver import DriverBase, locked
from jubatus_tpu_torch.models._nn_backend import (HASH_METHODS, NNBackend,
                                                  NNIndexStats, NNRowMigration)


class NearestNeighborConfigError(ValueError):
    pass


class NearestNeighborDriver(NNIndexStats, NNRowMigration, DriverBase):
    TYPE = "nearest_neighbor"

    def __init__(self, config: dict, dim_bits: int = 18, device=None):
        super().__init__()
        self.config = config
        self.config_json = json.dumps(config)
        method = config.get("method")
        if method not in HASH_METHODS:
            raise NearestNeighborConfigError(
                f"unknown nearest_neighbor method {method!r}")
        self.method = method
        param = config.get("parameter") or {}
        self.converter = make_fv_converter(config.get("converter"),
                                           dim_bits=dim_bits)
        unl_param = param.get("unlearner_parameter") or {}
        self.backend = NNBackend(
            method,
            dim=self.converter.dim,
            hash_num=int(param.get("hash_num", 64)),
            seed=int(param.get("seed", 0)),
            max_size=(int(unl_param["max_size"])
                      if param.get("unlearner") == "lru" else None),
            device=device,
        )

    @property
    def device(self):
        return self.backend.device

    # -- updates --------------------------------------------------------------
    @locked
    def set_row(self, row_id: str, datum: Datum) -> bool:
        vec = self.converter.convert(datum, update_weights=True)
        self.backend.set_row(row_id, vec)
        self.event_model_updated()
        return True

    @locked
    def clear(self) -> None:
        self.backend.clear()
        self.converter.weights.clear()
        self.update_count = 0

    # -- queries --------------------------------------------------------------
    def _row_vec(self, row_id: str):
        vec = self.backend.store.get_row(row_id)
        if vec is None:
            raise KeyError(f"unknown row id {row_id!r}")
        return vec

    @locked
    def neighbor_row_from_id(self, row_id: str, size: int) -> List[Tuple[str, float]]:
        return self.backend.neighbors(self._row_vec(row_id), size)

    @locked
    def neighbor_row_from_datum(self, query: Datum, size: int) -> List[Tuple[str, float]]:
        return self.backend.neighbors(self.converter.convert(query), size)

    @locked
    def similar_row_from_id(self, row_id: str, ret_num: int) -> List[Tuple[str, float]]:
        return self.backend.similar(self._row_vec(row_id), ret_num)

    @locked
    def similar_row_from_datum(self, query: Datum, ret_num: int) -> List[Tuple[str, float]]:
        return self.backend.similar(self.converter.convert(query), ret_num)

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
                "weights": self.converter.weights.pack()}

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

    @locked
    def get_status(self) -> Dict[str, Any]:
        st = super().get_status()
        # the rejected non-finite values count on the default registry
        # (trace.counter.fv.nonfinite_rejected), as in the JAX driver
        st.update(method=self.method, num_rows=len(self.backend.store),
                  device=str(self.device))
        st.update(self.index_status())
        return st


class _RowUpdateMixable:
    """Sparse row-update diff: {id: (idx, val, datum)} written since the last
    mix; the combiner merges dicts (last writer in fold order wins)."""

    def __init__(self, backend: NNBackend):
        self._b = backend

    def get_diff(self):
        return self._b.pop_update_diff()

    @staticmethod
    def mix(acc, diff):
        out = dict(acc)
        out.update(diff)
        return out

    def put_diff(self, diff) -> bool:
        self._b.apply_update_diff(diff)
        return True
