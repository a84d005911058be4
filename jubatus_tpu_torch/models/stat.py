"""Stat engine driver (copy of ``jubatus_tpu/models/stat.py``).

Business API of the reference's stat service: push / sum / stddev / max /
min / entropy / moment / clear; config ``{"window_size": N}``.

- ``push(key, value)`` appends to a per-key sliding window of
  ``window_size`` values (the oldest is evicted).
- ``sum/max/min/stddev/moment`` reduce over one key's current window;
  ``stddev`` is the population standard deviation, ``moment(key, n, c)``
  the mean of ``(x - c)**n``.
- ``entropy()`` is taken over the window counts across keys,
  ``H = log N - (sum_k n_k log n_k) / N``; after a mix it uses the
  cluster-wide counts.

Windows are host numpy ring buffers: O(window) scalar work per query, no
device work, as in the JAX package.
The driver resolves ``device`` as every driver of the port does (``cuda``
unless ``"cpu"`` is asked for, raising without CUDA), so that ``--device``
means the same for every engine; it holds no tensor.
"""

from __future__ import annotations

import json
import math
from typing import Any, Dict, List, Optional

import numpy as np

from jubatus_tpu_torch import resolve_device
from jubatus_tpu_torch.framework.driver import DriverBase, locked


class StatDriver(DriverBase):
    TYPE = "stat"

    def __init__(self, config: dict, device=None):
        super().__init__()
        self.device = resolve_device(device)
        self.config = config
        self.config_json = json.dumps(config)
        self.window_size = int(config.get("window_size", 128))
        if self.window_size <= 0:
            raise ValueError("window_size must be positive")
        self._init_model()

    def _init_model(self) -> None:
        # key -> ring buffer of the last window_size values (numpy-backed)
        self._windows: Dict[str, np.ndarray] = {}
        self._counts: Dict[str, int] = {}   # valid entries in the ring
        self._heads: Dict[str, int] = {}    # next write position
        # cluster-wide per-key window counts as of the last mix (None before)
        self._mixed_counts: Optional[Dict[str, float]] = None

    # -- update --------------------------------------------------------------
    @locked
    def push(self, key: str, value: float) -> bool:
        win = self._windows.get(key)
        if win is None:
            win = np.zeros(self.window_size, dtype=np.float64)
            self._windows[key] = win
            self._counts[key] = 0
            self._heads[key] = 0
        head = self._heads[key]
        win[head] = float(value)
        self._heads[key] = (head + 1) % self.window_size
        self._counts[key] = min(self._counts[key] + 1, self.window_size)
        self.event_model_updated()
        return True

    def _window(self, key: str) -> np.ndarray:
        count = self._counts.get(key, 0)
        if count == 0:
            raise KeyError(f"stat key {key!r} has no data")
        return self._windows[key][:count] if count < self.window_size \
            else self._windows[key]

    # -- analysis ------------------------------------------------------------
    @locked
    def sum(self, key: str) -> float:
        return float(self._window(key).sum())

    @locked
    def stddev(self, key: str) -> float:
        return float(self._window(key).std())

    @locked
    def max(self, key: str) -> float:
        return float(self._window(key).max())

    @locked
    def min(self, key: str) -> float:
        return float(self._window(key).min())

    @locked
    def moment(self, key: str, degree: int, center: float) -> float:
        w = self._window(key)
        return float(((w - center) ** int(degree)).mean())

    @locked
    def entropy(self, key: str = "") -> float:
        """Entropy of the across-key count distribution. The RPC carries a
        key argument only for CHT routing (stat.idl); the value is global.
        Uses cluster-wide counts when a mix has run."""
        if self._mixed_counts is not None:
            counts = [c for c in self._mixed_counts.values() if c > 0]
        else:
            counts = [c for c in self._counts.values() if c > 0]
        total = float(np.sum(counts)) if counts else 0.0
        if total <= 0:
            return 0.0
        e = sum(c * math.log(c) for c in counts)
        return math.log(total) - e / total

    @locked
    def clear(self) -> None:
        self._init_model()
        self.update_count = 0

    # -- mix plane -----------------------------------------------------------
    def get_schema(self) -> List[str]:
        return sorted(self._counts.keys())

    def sync_schema(self, union_schema: List[str]) -> None:
        self._schema = list(union_schema)

    def get_mixables(self):
        return {"stat": _StatMixable(self)}

    # -- persistence ---------------------------------------------------------
    @locked
    def pack(self) -> Any:
        return {
            "window_size": self.window_size,
            "windows": {
                k: np.concatenate(
                    [self._windows[k][self._heads[k]:self._counts[k]],
                     self._windows[k][:self._heads[k]]]
                ) if self._counts[k] == self.window_size
                else self._windows[k][:self._counts[k]].copy()
                for k in self._counts
            },
        }

    @locked
    def unpack(self, obj: Any) -> None:
        if int(obj["window_size"]) != self.window_size:
            raise ValueError(
                f"checkpoint window_size {obj['window_size']} != "
                f"config window_size {self.window_size}"
            )
        self._init_model()
        # restore rings directly (oldest-first order from pack); does NOT
        # touch update_count — a freshly loaded model has no pending updates
        for key, values in obj["windows"].items():
            if isinstance(key, bytes):
                key = key.decode()
            vals = np.asarray(values, dtype=np.float64)
            win = np.zeros(self.window_size, dtype=np.float64)
            n = min(len(vals), self.window_size)
            win[:n] = vals[-n:]
            self._windows[key] = win
            self._counts[key] = n
            self._heads[key] = n % self.window_size

    @locked
    def get_status(self) -> Dict[str, Any]:
        st = super().get_status()
        st.update(num_keys=len(self._counts), window_size=self.window_size,
                  device=str(self.device))
        return st


class _StatMixable:
    """Diff = per-key current window counts, aligned to the synced schema.

    Summing across replicas yields cluster-wide counts; put_diff *snapshots*
    them (they are state, not increments — each round replaces the last)."""

    def __init__(self, driver: StatDriver):
        self._d = driver

    def get_diff(self):
        schema = getattr(self._d, "_schema", None) or self._d.get_schema()
        return {
            "counts": np.asarray(
                [float(self._d._counts.get(k, 0)) for k in schema],
                dtype=np.float32,
            )
        }

    def put_diff(self, diff) -> bool:
        schema = getattr(self._d, "_schema", None) or self._d.get_schema()
        counts = np.asarray(diff["counts"], dtype=np.float64)
        self._d._mixed_counts = {
            k: float(c) for k, c in zip(schema, counts)
        }
        return True
