"""Data-parallel replicas × feature-sharded tables in one process
(counterpart of ``jubatus_tpu/parallel/spmd.py``).

The grid has two axes (parallel/mesh.py ``grid_mesh`` / ``replica_mesh``,
whose devices may be logical: one card, or the CPU, named several times):

- ``replica``: each replica trains on its own batch, the reference's N
  servers. The mix is a sum of the replicas' diffs.
- ``shard`` (optional): the hashed feature dim D is split into column
  blocks, one a device of the replica's row, as the feature-sharded
  linear engines hold it (parallel/sharded_model.py).

A step trains every replica with the port's parallel classifier step
(``ops/classifier.train_batch_parallel``, or its feature-sharded form
``sharded_model.train_batch``, whose cross-shard sums land on the row's
first device in shard order), then, with ``mix``, sums the replicas' diffs
in replica order on replica 0's devices, adds the average into every
replica's ``w`` and the sum into its ``prec``, and zeroes the diffs. The
JAX package runs the same step as one shard_map'd program.
"""

from __future__ import annotations

from typing import Any, List, NamedTuple, Optional, Tuple

import numpy as np
import torch

from jubatus_tpu_torch.ops import classifier as cops
from jubatus_tpu_torch.ops.classifier import CONFIDENCE_METHODS
from jubatus_tpu_torch.parallel import sharded_model as sm
from jubatus_tpu_torch.parallel.mesh import DeviceGrid, ShardMesh


class SpmdClassifierState(NamedTuple):
    """The replicas' classifier states: each field a tuple over replicas
    of that replica's table ([L, D] on its device, or column blocks across
    its row of the grid)."""

    w: Tuple[Any, ...]
    dw: Tuple[Any, ...]
    prec: Tuple[Any, ...]
    dprec: Tuple[Any, ...]

    def replica(self, r: int) -> cops.ClassifierState:
        return cops.ClassifierState(self.w[r], self.dw[r], self.prec[r],
                                    self.dprec[r])

    def stacked(self, field: str) -> np.ndarray:
        """One field read back as [R, L, D] host numpy."""
        out = []
        for a in getattr(self, field):
            out.append(np.concatenate([b.cpu().numpy() for b in a], axis=-1)
                       if sm.is_blocks(a) else a.cpu().numpy())
        return np.stack(out)


def _dev(d: Any) -> torch.device:
    d = getattr(d, "device", d)
    return torch.device(d)


def _rows(mesh: DeviceGrid) -> List[List[torch.device]]:
    """Each replica's devices (one unless the grid has a shard axis)."""
    devs = mesh.devices
    if "shard" in mesh.axis_names:
        return [[_dev(d) for d in row] for row in devs]
    return [[_dev(d)] for d in devs.reshape(-1)]


def _row_mesh(row: List[torch.device]) -> Optional[ShardMesh]:
    return ShardMesh(row) if len(row) > 1 else None


def init_spmd_state(mesh: DeviceGrid, num_labels: int, dim: int,
                    confidence: bool = True) -> SpmdClassifierState:
    """Zero diffs and masters, unit precisions (placeholders without
    confidence), on every replica's devices."""
    states = []
    for row in _rows(mesh):
        states.append(sm.new_state(
            _row_mesh(row),
            lambda d, dev: cops.init_state(num_labels, d, confidence, dev),
            dim, row[0]))
    return SpmdClassifierState(*(tuple(st[i] for st in states)
                                 for i in range(4)))


def place_host(mesh: DeviceGrid, host_state, dim: int
               ) -> SpmdClassifierState:
    """A state of host numpy ``[R, L, D]`` leaves (the JAX package's
    stacked global arrays, ``SpmdClassifierState.stacked``) on the grid:
    replica r's slice onto its row's devices, split into the row's column
    blocks when the grid has a shard axis (``sharded_model.place_host``
    per replica)."""
    states = []
    for r, row in enumerate(_rows(mesh)):
        replica = cops.ClassifierState(*(np.asarray(a)[r]
                                         for a in host_state))
        states.append(sm.place_host(_row_mesh(row), replica, dim, row[0]))
    return SpmdClassifierState(*(tuple(st[i] for st in states)
                                 for i in range(4)))


def _replica_sum(tables: Tuple[Any, ...]):
    """The replicas' tables summed in replica order on replica 0's
    devices (block by block when sharded)."""
    first = tables[0]
    if sm.is_blocks(first):
        return tuple(_replica_sum(tuple(t[s] for t in tables))
                     for s in range(len(first)))
    tot = first.clone()
    for t in tables[1:]:
        tot += t.to(first.device)
    return tot


def _absorb(master: Any, total: Any, scale: Optional[float]) -> None:
    if sm.is_blocks(master):
        for m, t in zip(master, total):
            _absorb(m, t, scale)
        return
    t = total.to(master.device)
    master += t / scale if scale is not None else t


def _zero(a: Any) -> None:
    for t in (a if sm.is_blocks(a) else (a,)):
        t.zero_()


def make_spmd_train_step(mesh: DeviceGrid, *, method: str = "AROW",
                         param: float = 1.0, mix: bool = True):
    """The train(+mix) step: ``(state, idx [R, B, K], val [R, B, K],
    labels [R, B], label_mask [L]) -> state``, in place on the tables."""
    confidence = method in CONFIDENCE_METHODS
    rows = _rows(mesh)
    n = len(rows)

    def step(state: SpmdClassifierState, idx, val, labels, label_mask
             ) -> SpmdClassifierState:
        idx, val, labels, label_mask = (
            torch.as_tensor(np.asarray(x)) for x in
            (idx, val, labels, label_mask))
        for r, row in enumerate(rows):
            dev = row[0]
            st = state.replica(r)
            args = (idx[r].to(dev), val[r].to(dev), labels[r].to(dev),
                    label_mask.to(dev), param)
            rm = _row_mesh(row)
            if rm is not None:
                sm.train_batch(rm, st, *args, method=method)
            else:
                cops.train_batch_parallel(st, *args, method=method)
        if mix:
            total_dw = _replica_sum(state.dw)
            total_dp = _replica_sum(state.dprec) if confidence else None
            for r in range(n):
                _absorb(state.w[r], total_dw, float(n))
                _zero(state.dw[r])
                if confidence:
                    _absorb(state.prec[r], total_dp, None)
                    _zero(state.dprec[r])
        return state

    return step
