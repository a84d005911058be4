"""Regression engine driver (counterpart of
``jubatus_tpu/models/regression.py``): methods PA, PA1, PA2 with
parameter {sensitivity, regularization_weight}.

Business API of the reference's regression service: train / estimate /
clear. The model is one [D] weight row plus its local diff on the driver's
device (``ops/regression.py``); a train batch is one launch of the
per-example scan kernel on the card (``ops/online_scan.py``). Estimates
dispatch under the driver lock and wait unlocked, as the classifier's
queries do. ``pack()`` hands over host numpy in the JAX driver's layout.

Feature sharding (``mesh=`` or ``shard_features=``): the [D] row is split
into column blocks over the mesh (``parallel/sharded_model.py``). A train
batch gathers its distinct keys from their owners into one working set,
runs the scan over it (one kernel launch on the card) and writes the
touched diff columns back; estimates sum per-shard partial products.
Diffs travel as the JAX package's per-shard chunks.
"""

from __future__ import annotations

import json
from typing import Any, Dict, List, Sequence, Tuple

import numpy as np

from jubatus_tpu_torch import resolve_device
from jubatus_tpu_torch.core.datum import Datum
from jubatus_tpu_torch.core.fv import make_fv_converter
from jubatus_tpu_torch.core.sparse import _bucket, to_device
from jubatus_tpu_torch.framework.driver import DriverBase, locked
from jubatus_tpu_torch.ops import regression as ops
from jubatus_tpu_torch.parallel import sharded_model as sm
from jubatus_tpu_torch.parallel.mix import tree_sum


class RegressionConfigError(ValueError):
    pass


class RegressionDriver(DriverBase):
    TYPE = "regression"

    def __init__(self, config: dict, dim_bits: int = 18, mesh=None,
                 shard_features: int = 0, device=None):
        super().__init__()
        self.config = config
        self.config_json = json.dumps(config)
        method = config.get("method")
        if method not in ops.METHODS:
            raise RegressionConfigError(f"unknown regression method {method!r}")
        self.method = method
        param = config.get("parameter") or {}
        self.sensitivity = float(param.get("sensitivity", 0.1))
        self.c = float(param.get("regularization_weight", 1.0))
        self.converter = make_fv_converter(config.get("converter"),
                                           dim_bits=dim_bits)
        self._mesh, self.device = sm.driver_mesh(
            mesh, shard_features, self.converter, RegressionConfigError,
            resolve_device(device))
        self.state = self._new_state()

    def _new_state(self) -> ops.RegressionState:
        """A zero model; on a mesh each shard's blocks on its device."""
        return sm.new_state(self._mesh, ops.init_state, self.converter.dim,
                            self.device)

    def featurize_train(self, data: Sequence[Tuple[float, Datum]]):
        """Stage 1 of the pipelined microbatch: batch-convert without the
        driver lock. Returns the (targets, idx, val) triple
        ``train_hashed`` consumes."""
        targets = np.asarray([float(y) for y, _ in data], dtype=np.float32)
        csr = self.converter.convert_batch(
            [d for _, d in data], update_weights=True)
        sb = csr.to_padded()
        return targets, sb.idx, sb.val

    def train(self, data: Sequence[Tuple[float, Datum]]) -> int:
        if not data:
            return 0
        targets, idx, val = self.featurize_train(data)
        return self.train_hashed(targets, idx, val)

    @locked
    def train_hashed(self, targets: np.ndarray, idx: np.ndarray,
                     val: np.ndarray) -> int:
        """Train on pre-hashed features: the scan walks the ``len(targets)``
        live rows only (rows past them, if given, are padding and would
        update nothing)."""
        n = len(targets)
        if n == 0:
            return 0
        # on a mesh: the batch's keys gathered, one scan, dw written back
        self.state = sm.regression_train_batch(
            self._mesh, self.state, idx[:n], val[:n], targets,
            self.sensitivity, self.c, method=self.method)
        self.event_model_updated(n)
        return n

    def estimate(self, data: Sequence[Datum]) -> List[float]:
        # not @locked: estimate_hashed locks only its dispatch
        if not data:
            return []
        sb = self.converter.convert_batch(data).to_padded(batch_bucket=16)
        return self.estimate_hashed(sb.idx, sb.val)[: len(data)]

    def estimate_hashed(self, idx: np.ndarray,
                        val: np.ndarray) -> List[float]:
        """Estimates of pre-hashed features: launched under the lock, read
        back after it."""
        n = idx.shape[0]
        if n == 0:
            return []
        b = _bucket(n, 16)
        if b != n:
            idx = np.pad(idx, ((0, b - n), (0, 0)))
            val = np.pad(val, ((0, b - n), (0, 0)))
        didx, dval = to_device(idx, self.device), to_device(val, self.device)
        with self.lock:
            pending = sm.regression_estimate(self._mesh, self.state, didx,
                                             dval)
        return [float(x) for x in pending[:n].cpu().numpy()]

    @locked
    def clear(self) -> None:
        self.state = self._new_state()
        self.converter.weights.clear()
        self.update_count = 0

    def get_mixables(self):
        return {"regression": _RegressionMixable(self),
                "weights": self.converter.weights}

    @locked
    def pack(self) -> Any:
        return {"method": self.method, "dim": self.converter.dim,
                "w": sm.host_sum(self.state.w, self.state.dw),
                "weights": self.converter.weights.pack()}

    @locked
    def unpack(self, obj: Any) -> None:
        saved_method = obj.get("method")
        if isinstance(saved_method, bytes):
            saved_method = saved_method.decode()
        if saved_method != self.method:
            raise ValueError(f"checkpoint method {saved_method!r} != driver "
                             f"method {self.method!r}")
        if int(obj.get("dim", self.converter.dim)) != self.converter.dim:
            raise ValueError(
                f"checkpoint feature dim {obj['dim']} != driver dim "
                f"{self.converter.dim} (dim_bits mismatch)")
        w = np.asarray(obj["w"], dtype=np.float32)
        self.state = sm.place_host(
            self._mesh, ops.RegressionState(w=w, dw=np.zeros_like(w)),
            self.converter.dim, self.device)
        self.converter.weights.unpack(obj["weights"])

    def shard_stats(self) -> Dict[str, Any]:
        """The feature-shard layout (the ``shard.*`` gauges); empty when
        unsharded."""
        return sm.shard_stats(self._mesh, self.state, 1)

    def get_status(self) -> Dict[str, Any]:
        st = super().get_status()
        st.update(method=self.method, num_features=self.converter.dim,
                  device=str(self.device))
        st.update({f"shard.{k}": v for k, v in self.shard_stats().items()})
        return st


class _RegressionMixable:
    """The ops-level diff as host numpy (a sharded row as per-shard
    chunks). ``mix`` is the elementwise sum (``MIX_IS_SUM``), so the
    admission guard screens it and the async fold weights it as the JAX
    package's summed diff."""

    MIX_IS_SUM = True

    def __init__(self, driver: RegressionDriver):
        self._d = driver

    def get_diff(self):
        return {"dw": sm.diff_leaf(self._d.state.dw), "count": 1.0}

    @staticmethod
    def mix(lhs, rhs):
        return tree_sum([lhs, rhs])

    def put_diff(self, diff) -> bool:
        d = self._d
        d.state = sm.put_diff(d.state, sm.assemble_diff(d._mesh, diff,
                                                        d.converter.dim))
        return True
