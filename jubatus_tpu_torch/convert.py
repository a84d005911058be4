"""Carry state between the JAX package and the port.

- ``from_jax_pack(obj, config, engine=...)`` builds the port's driver of
  any of the eleven engines from the JAX driver's ``pack()`` output, as
  plain msgpack/numpy data: the store's rows with their datums
  (recommender) or labels (NN classifier), the converter's weight state,
  anomaly's next id, the NN classifier's label states, the linear
  classifier's and regression's weight tables (``w``, ``prec``,
  ``labels``, ``capacity``, ``label_counts``), which go onto the driver's
  device, clustering's working set (reclustered at once, as the JAX
  driver's ``unpack`` does), graph's nodes, edges and preset queries,
  stat's windows, bandit's arms and player stats, burst's keywords and
  counts, and weight's document frequencies. Where the engine has a
  converter, the feature space size is read from the packed df table
  (clustering keeps it under ``fv_weights``); the pack's method must be
  the config's, except for stat, burst, graph and weight, whose packs name
  none. The signatures are recomputed from the rows at the first query,
  with the same draws (ops/prng.py).
- The way back is the port driver's own ``pack()``: it has the JAX
  driver's layout, and the JAX driver's ``unpack`` takes it as it is.
- ``sigs_from_numpy`` moves a uint32 signature table onto a device as int32
  bit patterns (``ndarray.view``, never a value cast); ``sigs_to_numpy`` is
  the way back.

Nothing here imports the JAX package: the pack is plain data. The hasher's
reverse table is not part of a pack in either package.
"""

from __future__ import annotations

from typing import Any

import numpy as np
import torch

from jubatus_tpu_torch import resolve_device
from jubatus_tpu_torch.server.factory import driver_class


def _text(x: Any) -> Any:
    return x.decode() if isinstance(x, bytes) else x


#: where each engine's pack keeps the converter's weight state (the df
#: table gives the feature space size); engines absent here have none
_WEIGHT_STATE = {
    "nearest_neighbor": "weights", "recommender": "weights",
    "anomaly": "weights", "classifier": "weights", "regression": "weights",
    "clustering": "fv_weights", "weight": "weights",
}
#: engines whose pack names no method (the config's is not checked)
_NO_METHOD = ("stat", "burst", "graph", "weight")


def from_jax_pack(obj: Any, config: dict, *, engine: str = "nearest_neighbor",
                  device=None):
    """A port driver of ``engine`` holding the state of a packed JAX driver.
    ``config`` is the engine config the JAX driver was built from: the pack
    holds rows and weights, not the converter, hash_num or seed."""
    if engine not in _NO_METHOD:
        method = _text(obj["method"])
        if config.get("method") != method:
            raise ValueError(f"pack method {method!r} != config method "
                             f"{config.get('method')!r}")
    cls = driver_class(engine, config)
    key = _WEIGHT_STATE.get(engine)
    if key is None:
        driver = cls(config, device=device)
        driver.unpack(obj)
        return driver
    dim = int(np.asarray(obj[key]["df"]).shape[0])
    if dim & (dim - 1):
        raise ValueError(f"packed df table has {dim} entries, not a power of 2")
    driver = cls(config, dim_bits=dim.bit_length() - 1, device=device)
    if driver.converter.dim != dim:
        raise ValueError(f"config gives a {driver.converter.dim}-feature "
                         f"space, the pack {dim}")
    driver.unpack(obj)
    return driver


def sigs_from_numpy(sigs: np.ndarray, device=None) -> torch.Tensor:
    """uint32 signature table → int32 bit-pattern tensor on ``device``."""
    arr = np.ascontiguousarray(sigs, dtype=np.uint32)
    return torch.from_numpy(arr.view(np.int32).copy()).to(resolve_device(device))


def sigs_to_numpy(sigs: torch.Tensor) -> np.ndarray:
    """int32 bit-pattern tensor → uint32 numpy table (same bits)."""
    return sigs.detach().cpu().numpy().view(np.uint32)
