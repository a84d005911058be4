"""Regression engine driver (counterpart of
``jubatus_tpu/models/regression.py``): methods PA, PA1, PA2 with
parameter {sensitivity, regularization_weight}.

Business API of the reference's regression service: train / estimate /
clear. The model is one [D] weight row plus its local diff on the driver's
device (``ops/regression.py``); a train batch is one launch of the
per-example scan kernel on the card (``ops/online_scan.py``). Estimates
dispatch under the driver lock and wait unlocked, as the classifier's
queries do. ``pack()`` hands over host numpy in the JAX driver's layout.
Feature sharding is not yet ported.
"""

from __future__ import annotations

import json
from typing import Any, Dict, List, Sequence, Tuple

import numpy as np
import torch

from jubatus_tpu_torch import resolve_device
from jubatus_tpu_torch.core.datum import Datum
from jubatus_tpu_torch.core.fv import make_fv_converter
from jubatus_tpu_torch.core.sparse import _bucket, to_device
from jubatus_tpu_torch.framework.driver import DriverBase, locked
from jubatus_tpu_torch.models.classifier import _not_ported_sharding
from jubatus_tpu_torch.ops import regression as ops


class RegressionConfigError(ValueError):
    pass


class RegressionDriver(DriverBase):
    TYPE = "regression"

    def __init__(self, config: dict, dim_bits: int = 18, mesh=None,
                 shard_features: int = 0, device=None):
        super().__init__()
        _not_ported_sharding(mesh, shard_features)
        self.config = config
        self.config_json = json.dumps(config)
        method = config.get("method")
        if method not in ops.METHODS:
            raise RegressionConfigError(f"unknown regression method {method!r}")
        self.method = method
        param = config.get("parameter") or {}
        self.sensitivity = float(param.get("sensitivity", 0.1))
        self.c = float(param.get("regularization_weight", 1.0))
        self.device = resolve_device(device)
        self.converter = make_fv_converter(config.get("converter"),
                                           dim_bits=dim_bits)
        self.state = ops.init_state(self.converter.dim, device=self.device)

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
        dev = self.device
        self.state = ops.train_batch(
            self.state, to_device(idx[:n], dev), to_device(val[:n], dev),
            to_device(np.asarray(targets, dtype=np.float32), dev),
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
            pending = ops.estimate(self.state, didx, dval)
        return [float(x) for x in pending[:n].cpu().numpy()]

    @locked
    def clear(self) -> None:
        self.state = ops.init_state(self.converter.dim, device=self.device)
        self.converter.weights.clear()
        self.update_count = 0

    def get_mixables(self):
        return {"regression": _RegressionMixable(self),
                "weights": self.converter.weights}

    @locked
    def pack(self) -> Any:
        return {"method": self.method, "dim": self.converter.dim,
                "w": (self.state.w + self.state.dw).cpu().numpy(),
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
        w = to_device(np.array(obj["w"], dtype=np.float32), self.device)
        self.state = ops.RegressionState(w=w, dw=torch.zeros_like(w))
        self.converter.weights.unpack(obj["weights"])

    def get_status(self) -> Dict[str, Any]:
        st = super().get_status()
        st.update(method=self.method, num_features=self.converter.dim,
                  device=str(self.device))
        return st


class _RegressionMixable:
    """The ops-level diff as host numpy. ``mix`` is the elementwise sum
    (``MIX_IS_SUM``), so the admission guard screens it and the async
    fold weights it as the JAX package's summed diff."""

    MIX_IS_SUM = True

    def __init__(self, driver: RegressionDriver):
        self._d = driver

    def get_diff(self):
        return {"dw": self._d.state.dw.cpu().numpy(), "count": 1.0}

    @staticmethod
    def mix(lhs, rhs):
        return {k: lhs[k] + rhs[k] for k in lhs}

    def put_diff(self, diff) -> bool:
        self._d.state = ops.put_diff(self._d.state, diff)
        return True
