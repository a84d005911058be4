"""The mix engine (counterpart of ``jubatus_tpu/parallel/mix.py``).

Reference semantics (linear_mixer.cpp:437-559, SURVEY.md §3.3): the master
pulls diffs from all replicas, folds them pairwise, broadcasts the folded
diff, and every replica applies it via put_diff. Diffs here are host numpy
trees in both packages, so a JAX master and a port master fold the same
contributions to the same bits.

Three pieces share the Mixable protocol:

- ``tree_sum``: the host fold of the RPC mix;
- ``allreduce_diffs``: per-replica diffs summed over a replica grid's
  devices (parallel/mesh.py), in replica order on the first device, with
  the bf16 wire of ``--mix-bf16`` as an option (summed in float32 and
  rounded once, as XLA's bf16 all-reduce);
- ``LocalMixGroup``: N drivers in one process mixing through it, after
  the schema sync (the reference's linear_communication_stub seam,
  linear_mixer_test.cpp:65-112).
"""

from __future__ import annotations

import functools
import time
from typing import (Any, Dict, List, Optional, Protocol, Sequence,
                    runtime_checkable)

import numpy as np
import torch

from jubatus_tpu_torch.utils.tree import tree_flatten, tree_map, tree_unflatten


@runtime_checkable
class Mixable(Protocol):
    """The linear-mixable protocol (reference core mixable, SURVEY.md
    §2.9): get_diff returns a tree of arrays / scalars; the mix is
    elementwise addition (performed by the engine, not the mixable);
    put_diff absorbs the reduced diff and resets local accumulation,
    returning False if the local model is obsolete. A mixable may also
    carry a custom associative ``mix(acc, diff) -> acc`` (the reference's
    mixable->mix), which the group folds with instead; ``MIX_IS_SUM``
    marks one that is elementwise addition after all."""

    def get_diff(self) -> Any: ...

    def put_diff(self, diff: Any) -> bool: ...


def _add(a: Any, b: Any) -> Any:
    """One leaf of the fold. Leaves whose LEADING dimension disagrees are
    zero-padded to the larger row count before adding."""
    an = getattr(a, "shape", None)
    bn = getattr(b, "shape", None)
    if an and bn and len(an) == len(bn) and an != bn and an[1:] == bn[1:]:
        rows = max(an[0], bn[0])
        if an[0] < rows:
            a = np.concatenate(
                [np.asarray(a),
                 np.zeros((rows - an[0],) + tuple(an[1:]),
                          np.asarray(a).dtype)])
        if bn[0] < rows:
            b = np.concatenate(
                [np.asarray(b),
                 np.zeros((rows - bn[0],) + tuple(bn[1:]),
                          np.asarray(b).dtype)])
    return a + b


def tree_sum(diffs: Sequence[Any]) -> Any:
    """Host-side fold of diff trees (the reference's pairwise fold —
    associative here, so order is irrelevant).

    Leaves whose LEADING dimension disagrees are zero-padded to the
    larger row count before adding: row-trimmed label diffs
    (models/classifier.py _ClassifierMixable) can legitimately differ by
    a row when a replica trained a novel label between the round's
    schema sync and its get_diff — the pad reproduces the full-capacity
    semantics (absent rows contribute zeros) instead of aborting the
    round on a shape error."""
    acc = diffs[0]
    for d in diffs[1:]:
        acc = tree_map(_add, acc, d)
    return acc


def _as_tensor(x: Any) -> torch.Tensor:
    """A diff leaf as a tensor, 64-bit narrowed to 32 as the JAX package's
    arrays are (it runs without x64)."""
    t = x if isinstance(x, torch.Tensor) else torch.as_tensor(np.asarray(x))
    if t.dtype == torch.float64:
        return t.to(torch.float32)
    if t.dtype == torch.int64:
        return t.to(torch.int32)
    return t


def allreduce_diffs(per_replica_diffs: Sequence[Any], mesh,
                    axis: str = "replica", compress: bool = False,
                    phases: Optional[dict] = None):
    """Reduce per-replica diff trees to one total over ``mesh``'s
    ``axis``: each replica's leaves on its device, summed in replica order
    on the first device, read back as host numpy. ``compress`` ships f32
    leaves as bf16 (each replica's cast on its device, the sum in bf16,
    the total handed back as f32). ``phases`` records ship / reduce /
    readback ms and the payload MB, the keys of the cross-process
    plane."""
    along = mesh.devices if mesh.devices.ndim == 1 else mesh.devices[:, 0]
    devices = [torch.device(getattr(d, "device", d)) for d in along]
    n = mesh.shape[axis]
    if len(per_replica_diffs) != n:
        raise ValueError(
            f"got {len(per_replica_diffs)} diffs for a {n}-replica mesh")
    t0 = time.perf_counter()
    flats = [tree_flatten(d) for d in per_replica_diffs]
    spec = flats[0][1]
    staged: List[List[torch.Tensor]] = []
    for (leaves, _), dev in zip(flats, devices):
        row = []
        for x in leaves:
            t = _as_tensor(x).to(dev)
            if compress and t.dtype == torch.float32:
                t = t.to(torch.bfloat16)
            row.append(t)
        staged.append(row)
    t1 = time.perf_counter()
    first = devices[0]
    totals = []
    for j in range(len(staged[0])):
        wire = staged[0][j].dtype
        # a bf16 wire sums in float32 and rounds once, as XLA's bf16
        # all-reduce does
        tot = staged[0][j].to(torch.float32) if wire == torch.bfloat16 \
            else staged[0][j].clone()
        for row in staged[1:]:
            tot += row[j].to(first, tot.dtype)
        if wire == torch.bfloat16:
            tot = tot.to(torch.bfloat16).to(torch.float32)
        totals.append(tot)
    t2 = time.perf_counter()
    out = [t.cpu().numpy() for t in totals]
    if phases is not None:
        nbytes = sum(t.numel() * t.element_size()
                     // (2 if compress and t.dtype == torch.float32 else 1)
                     for t in totals)
        phases.update(
            ship_ms=round((t1 - t0) * 1e3, 2),
            reduce_ms=round((t2 - t1) * 1e3, 2),
            readback_ms=round((time.perf_counter() - t2) * 1e3, 2),
            payload_mb=round(nbytes / 2**20, 2),
        )
    return tree_unflatten(spec, out)


class LocalMixGroup:
    """In-process mix over N mixable-bearing drivers.

    Drivers expose ``get_mixables() -> dict[name, Mixable]`` and optionally
    ``get_schema() / sync_schema(union)`` for row alignment (classifier
    labels). ``mix()`` runs the schema sync, then each mixable's reduce
    (over ``mesh`` when given and the diff is a plain sum), then put_diff
    everywhere."""

    def __init__(self, drivers: Sequence[Any], mesh=None,
                 compress: bool = False):
        if not drivers:
            raise ValueError("LocalMixGroup needs at least one driver")
        self.drivers = list(drivers)
        self.mesh = mesh
        #: ship f32 diffs over the mesh as bf16
        self.compress = compress
        #: phases of the last mesh reduce this group ran
        self.last_phases: Dict[str, Any] = {}

    def mix(self) -> Dict[str, Any]:
        # every participant's model lock for the round, in one order
        locks = sorted((d.lock for d in self.drivers if hasattr(d, "lock")),
                       key=id)
        try:
            for lk in locks:
                lk.acquire()
            return self._mix_locked()
        finally:
            for lk in reversed(locks):
                lk.release()

    def _mix_locked(self) -> Dict[str, Any]:
        schemas = [d.get_schema() for d in self.drivers
                   if hasattr(d, "get_schema")]
        if schemas:
            union: List[str] = sorted(set().union(*map(set, schemas)))
            for d in self.drivers:
                d.sync_schema(union)
        stats: Dict[str, Any] = {}
        names = list(self.drivers[0].get_mixables().keys())
        for name in names:
            mixables = [d.get_mixables()[name] for d in self.drivers]
            diffs = [m.get_diff() for m in mixables]
            custom_mix = getattr(mixables[0], "mix", None)
            # the mesh reduce takes any diff whose combine is elementwise
            # addition over a fixed-shape tree; dict-shaped sparse diffs
            # fold on the host
            summable = custom_mix is None or \
                getattr(mixables[0], "MIX_IS_SUM", False)
            if (summable and self.mesh is not None
                    and self.mesh.shape.get("replica") == len(diffs)):
                self.last_phases = {}
                total = allreduce_diffs(diffs, self.mesh,
                                        compress=self.compress,
                                        phases=self.last_phases)
            elif custom_mix is not None:
                total = functools.reduce(custom_mix, diffs)
            else:
                total = tree_sum(diffs)
            for m in mixables:
                m.put_diff(total)
            stats[name] = tree_map(lambda x: getattr(x, "shape", None),
                                   total)
        return stats
