"""Global-weight state: document frequencies for idf + user-set weights.

Copy of ``jubatus_tpu/core/fv/weight_manager.py`` (the reference's
core::fv_converter::weight_manager), trimmed to what the per-datum and the
batch converter use. Document-frequency counts live in a dense float32
array over the hashed feature space; the state packs to the same layout as
the JAX package's, so a model moves between the two.
"""

from __future__ import annotations

import math
import threading
from typing import Dict

import numpy as np


def _host(x) -> np.ndarray:
    """A diff leaf as host numpy (the collective mixer hands tensors)."""
    if hasattr(x, "detach"):
        return x.detach().cpu().numpy()
    return np.asarray(x)


class WeightManager:
    """Tracks df counts and user weights over the hashed feature space."""

    def __init__(self, dim: int):
        self.dim = dim
        # master = state as of last mix; diff = local updates since.
        self._df_master = np.zeros(dim, dtype=np.float32)
        self._df_diff = np.zeros(dim, dtype=np.float32)
        self._ndocs_master = 0.0
        self._ndocs_diff = np.zeros(1, dtype=np.float64)
        self._user_weights: Dict[int, float] = {}
        self.lock = threading.Lock()

    # -- ingest -------------------------------------------------------------
    def observe(self, indices) -> None:
        """Record one document's feature occurrence (unique indices)."""
        with self.lock:
            self._df_diff[np.asarray(list(indices), dtype=np.int64)] += 1.0
            self._ndocs_diff[0] += 1.0

    def observe_batch(self, indices: np.ndarray, rows: np.ndarray) -> None:
        """Record a whole batch of documents at once (``convert_batch``'s
        train path). Entry j says document ``rows[j]`` contained feature
        ``indices[j]``; duplicate (row, index) pairs count once, and the
        number of documents is the number of distinct rows."""
        if indices.size == 0:
            return
        rows = np.asarray(rows, dtype=np.int64)
        pair = rows * np.int64(self.dim) + np.asarray(indices, np.int64)
        uniq = np.unique(pair)
        ndocs = int(np.unique(rows).size)
        uidx = uniq % np.int64(self.dim)
        with self.lock:
            np.add.at(self._df_diff, uidx, 1.0)
            self._ndocs_diff[0] += float(ndocs)

    # -- lookup -------------------------------------------------------------
    @property
    def ndocs(self) -> float:
        return self._ndocs_master + float(self._ndocs_diff[0])

    def idf(self, index: int) -> float:
        n = self.ndocs
        df = float(self._df_master[index] + self._df_diff[index])
        if n <= 0 or df <= 0:
            return 1.0
        return math.log(n / df)

    def idf_many(self, indices: np.ndarray) -> np.ndarray:
        """``idf`` of many indices at once, equal to it element by element:
        the master + diff sum stays float32 before widening, log in
        float64."""
        ix = np.asarray(indices, dtype=np.int64)
        n = self.ndocs
        df = (self._df_master[ix] + self._df_diff[ix]).astype(np.float64)
        out = np.ones(ix.shape, dtype=np.float64)
        if n <= 0:
            return out
        live = df > 0
        out[live] = np.log(n / df[live])
        return out

    def user_weight(self, index: int) -> float:
        return self._user_weights.get(index, 1.0)

    def user_weight_many(self, indices: np.ndarray) -> np.ndarray:
        """``user_weight`` of many indices at once (global_weight "weight")."""
        ix = np.asarray(indices, dtype=np.int64)
        if not self._user_weights:
            return np.ones(ix.shape, dtype=np.float64)
        uw = self._user_weights
        return np.fromiter((uw.get(int(i), 1.0) for i in ix),
                           dtype=np.float64, count=ix.shape[0])

    # -- mixable protocol ---------------------------------------------------
    #: mix() below is elementwise addition, so the collective mixer and
    #: the guard's screens treat the diff as a plain sum
    MIX_IS_SUM = True

    def get_diff(self):
        with self.lock:
            return {
                "df": self._df_diff.copy(),
                "ndocs": np.float32(self._ndocs_diff[0]),
            }

    @staticmethod
    def mix(lhs, rhs):
        return {"df": lhs["df"] + rhs["df"], "ndocs": lhs["ndocs"] + rhs["ndocs"]}

    def put_diff(self, diff) -> bool:
        with self.lock:
            self._df_master += _host(diff["df"])
            # wire round-trips can deliver the scalar as a shape-(1,) array
            self._ndocs_master += float(_host(diff["ndocs"]).reshape(()))
            self._df_diff[:] = 0.0
            self._ndocs_diff[0] = 0.0
        return True

    # -- persistence --------------------------------------------------------
    def pack(self):
        return {
            "df": (self._df_master + self._df_diff),
            "ndocs": self.ndocs,
            "user_weights": dict(self._user_weights),
        }

    def unpack(self, obj) -> None:
        with self.lock:
            self._df_master = np.asarray(obj["df"], dtype=np.float32).copy()
            self._ndocs_master = float(obj["ndocs"])
            self._df_diff[:] = 0.0
            self._ndocs_diff[0] = 0.0
            self._user_weights = {int(k): float(v)
                                  for k, v in obj["user_weights"].items()}

    def clear(self) -> None:
        with self.lock:
            self._df_master[:] = 0.0
            self._df_diff[:] = 0.0
            self._ndocs_master = 0.0
            self._ndocs_diff[0] = 0.0
            self._user_weights.clear()
