"""Linear classifier engine driver (counterpart of
``jubatus_tpu/models/classifier.py``): methods perceptron, PA, PA1, PA2,
CW, AROW, NHERD.

Business API of the reference's classifier service: train / classify /
get_labels / set_label / delete_label / clear. Labels are rows of dense
[L, D] tables (``ops/classifier.py``) on the driver's device; the
vocabulary is host metadata. Label slots grow by doubling from 8, and a
deleted label's slot is zeroed and reused. Before a mix, replicas align
their vocabularies with ``sync_schema`` (sorted union, rows permuted on
the device) so the row-trimmed diffs add row by row; label train counts
ride the same diff.

Queries dispatch under the driver lock and wait unlocked: the scores are
launched while the lock keeps a train step from updating the state in
place, and read back (``.cpu()``) after it is released. Every launch goes
on the one current stream, so a train launched later cannot overtake a
classify launched before it.

``pack()`` hands over host numpy in the JAX driver's layout, so a model
saved by either package loads in the other.

Feature sharding (``mesh=``, a ``ShardMesh``, or ``shard_features=``, the
per-device feature budget): every [L, D] table is split into column blocks
over the mesh (``parallel/sharded_model.py``). The parallel train and the
sparse classify run shard by shard with one cross-shard sum of the [B, L]
logits; the sequential train and the uniform-schema plans run the flat op
on the batch's gathered columns and write the diffs back. Diffs travel as
the JAX package's per-shard chunks; ``pack()`` joins the blocks on the
host, so the file has the unsharded layout.
"""

from __future__ import annotations

import json
from typing import Any, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from jubatus_tpu_torch import resolve_device
from jubatus_tpu_torch.core.datum import Datum
from jubatus_tpu_torch.core.fv import make_fv_converter
from jubatus_tpu_torch.core.sparse import _bucket, to_device
from jubatus_tpu_torch.framework.driver import DriverBase, locked
from jubatus_tpu_torch.ops import classifier as ops
from jubatus_tpu_torch.parallel import sharded_model as sm

_INITIAL_CAPACITY = 8


class ClassifierConfigError(ValueError):
    pass


class ClassifierDriver(DriverBase):
    TYPE = "classifier"

    def __init__(self, config: dict, dim_bits: int = 18,
                 train_mode: str = "parallel", mesh=None,
                 shard_features: int = 0, device=None):
        super().__init__()
        self.config = config
        self.config_json = json.dumps(config)
        #: "parallel" = batch-start snapshot per microbatch (the server's
        #: mode); "sequential" = exact per-example semantics
        self.train_mode = train_mode
        method = config.get("method")
        if method not in ops.METHODS:
            raise ClassifierConfigError(f"unknown classifier method {method!r}")
        self.method = method
        param = config.get("parameter") or {}
        self.param = float(param.get("regularization_weight", 1.0))
        self.converter = make_fv_converter(config.get("converter"),
                                           dim_bits=dim_bits)
        self._mesh, self.device = sm.driver_mesh(
            mesh, shard_features, self.converter, ClassifierConfigError,
            resolve_device(device))
        #: the parameter as a float32 tensor on the device, made once: a
        #: fresh host scalar per step would be a synchronous upload
        self._param = torch.tensor(np.float32(self.param), device=self.device)
        self._confidence = method in ops.CONFIDENCE_METHODS
        self._init_model()

    def _new_state(self) -> ops.ClassifierState:
        """Fresh tables of ``capacity`` label rows; on a mesh each shard's
        blocks are made on its own device."""
        return sm.new_state(
            self._mesh, lambda d, dev: ops.init_state(
                self.capacity, d, self._confidence, device=dev),
            self.converter.dim, self.device)

    def _init_model(self) -> None:
        self.labels: List[str] = []           # slot -> label name
        self.label_slots: Dict[str, int] = {}  # label name -> slot
        self.capacity = _INITIAL_CAPACITY
        self.state = self._new_state()
        self.label_counts = np.zeros(self.capacity, dtype=np.float32)
        self._dcounts = np.zeros(self.capacity, dtype=np.float32)
        self._mask_dev: Optional[torch.Tensor] = None

    # -- label management ----------------------------------------------------
    def _mask(self) -> torch.Tensor:
        """The live-label mask on the device, rebuilt after a label change."""
        if self._mask_dev is None:
            m = np.zeros(self.capacity, dtype=bool)
            for s in self.label_slots.values():
                m[s] = True
            self._mask_dev = to_device(m, self.device)
        return self._mask_dev

    def _ensure_label(self, label: str) -> int:
        slot = self.label_slots.get(label)
        if slot is not None:
            return slot
        # reuse a freed slot if any, else grow capacity
        used = set(self.label_slots.values())
        free = [s for s in range(self.capacity) if s not in used]
        if free:
            slot = free[0]
        else:
            self.capacity *= 2
            cap = self.capacity
            self.state = sm.map_shards(
                lambda st: ops.grow_labels(st, cap), self.state)
            self.label_counts = np.pad(self.label_counts, (0, self.capacity // 2))
            self._dcounts = np.pad(self._dcounts, (0, self.capacity // 2))
            slot = len(self.labels)
        if slot == len(self.labels):
            self.labels.append(label)
        else:
            self.labels[slot] = label
        self.label_slots[label] = slot
        self._mask_dev = None
        return slot

    @locked
    def set_label(self, label: str) -> bool:
        if label in self.label_slots:
            return False
        self._ensure_label(label)
        return True

    @locked
    def delete_label(self, label: str) -> bool:
        """Remove a label locally. In a cluster it must reach every replica
        (the reference broadcasts delete_label): a one-replica delete is
        resurrected with a zeroed master by the next mix's schema union."""
        slot = self.label_slots.pop(label, None)
        if slot is None:
            return False
        # zero the slot so a future reuse starts clean
        for st in sm.per_shard(self.state):
            st.w[slot] = 0.0
            st.dw[slot] = 0.0
            if st.prec.shape != (1, 1):
                st.prec[slot] = 1.0
                st.dprec[slot] = 0.0
        self.label_counts[slot] = 0.0
        self._dcounts[slot] = 0.0
        self.labels[slot] = ""
        self._mask_dev = None
        return True

    @locked
    def get_labels(self) -> Dict[str, int]:
        return {
            lab: int(self.label_counts[slot] + self._dcounts[slot])
            for lab, slot in self.label_slots.items()
        }

    # -- train / classify ----------------------------------------------------
    def featurize_train(self, data: Sequence[Tuple[str, Datum]]):
        """Stage 1 of the pipelined microbatch (server/microbatch.py
        PipelinedCoalescer): batch-convert without the driver lock (the
        WeightManager has its own). Returns the (labels, idx, val) triple
        ``train_hashed`` consumes."""
        labels = [label for label, _ in data]
        csr = self.converter.convert_batch(
            [datum for _, datum in data], update_weights=True)
        sb = csr.to_padded()
        return labels, sb.idx, sb.val

    def train(self, data: Sequence[Tuple[str, Datum]]) -> int:
        """One convert_batch sweep, then the pre-hashed device path."""
        if not data:
            return 0
        labels, idx, val = self.featurize_train(data)
        return self.train_hashed(labels, idx, val)

    def _train_slots(self, slots: np.ndarray, idx: np.ndarray,
                     val: np.ndarray, b: int) -> int:
        """Shared tail of the hashed entry points: rows bucketed to a power
        of two (zero rows are no-ops: x2 = 0 gives alpha 0), upload, step."""
        bsz = _bucket(b, 16)
        if bsz != b:
            idx = np.pad(idx, ((0, bsz - b), (0, 0)))
            val = np.pad(val, ((0, bsz - b), (0, 0)))
        slots_arr = np.zeros(bsz, dtype=np.int32)
        slots_arr[:b] = slots
        self.state = sm.classifier_train(
            self._mesh, self.state, idx, val, slots_arr, self._mask(),
            self._param, method=self.method, mode=self.train_mode)
        self.event_model_updated(b)
        return b

    @locked
    def train_hashed(self, labels: Sequence[str], idx: np.ndarray,
                     val: np.ndarray) -> int:
        """Train on pre-hashed features: idx / val are [B, K] arrays, what
        the converter would have produced."""
        if len(labels) == 0:
            return 0
        slots = [self._ensure_label(lb) for lb in labels]
        for s in slots:
            self._dcounts[s] += 1.0
        return self._train_slots(np.asarray(slots, dtype=np.int32),
                                 idx, val, len(labels))

    def _count_uniq(self, uniq_labels: Sequence[str],
                    label_idx: np.ndarray) -> np.ndarray:
        """Slots of the distinct labels, with their counts added; returns
        each row's slot. np.add.at, not +=: ``uniq_labels`` may repeat a
        label, and += keeps only the last write per repeated slot."""
        slots_u = np.array([self._ensure_label(lb) for lb in uniq_labels],
                           dtype=np.int32)
        counts = np.bincount(label_idx, minlength=len(uniq_labels))
        np.add.at(self._dcounts, slots_u, counts[:len(slots_u)])
        return slots_u[label_idx]

    @locked
    def train_indexed(self, uniq_labels: Sequence[str], label_idx: np.ndarray,
                      idx: np.ndarray, val: np.ndarray) -> int:
        """Train with deduplicated labels: ``uniq_labels`` the distinct
        label strings, ``label_idx`` the int32 [B] row -> uniq mapping."""
        b = int(label_idx.shape[0])
        if b == 0:
            return 0
        return self._train_slots(self._count_uniq(uniq_labels, label_idx),
                                 idx, val, b)

    @locked
    def train_indexed_schema(self, uniq_labels: Sequence[str],
                             label_idx: np.ndarray, uidx: np.ndarray,
                             val: np.ndarray) -> int:
        """train_indexed for a uniform-schema batch (every example shares
        ``uidx`` [K]): the dense [L, K]-submatrix plan. Sequential train
        mode takes the sparse path, where exact per-example semantics
        come first."""
        b = int(label_idx.shape[0])
        if b == 0:
            return 0
        slots = self._count_uniq(uniq_labels, label_idx)
        if self.train_mode != "parallel":
            return self._train_slots(
                slots, np.broadcast_to(uidx, (b, uidx.shape[0])), val, b)
        bsz = _bucket(b, 16)
        if bsz != b:  # zero rows are no-ops (x2 = 0 → alpha 0)
            val = np.pad(val, ((0, bsz - b), (0, 0)))
            slots = np.pad(slots, (0, bsz - b))
        dval, dslots = to_device(val, self.device), to_device(slots, self.device)
        # on a mesh, on the gathered columns of uidx, diffs written back
        self.state = sm.on_columns(self.state, uidx, lambda st, u: (
            ops.train_batch_schema(st, u, dval, dslots, self._mask(),
                                   self._param, method=self.method)))
        self.event_model_updated(b)
        return b

    @locked
    def train_indexed_combo(self, uniq_labels: Sequence[str],
                            label_idx: np.ndarray, uidx: np.ndarray,
                            base_val: np.ndarray, a_idx: np.ndarray,
                            b_idx: np.ndarray, mul_mask: np.ndarray) -> int:
        """train_indexed_schema with the combination slots expanded on the
        device: ``uidx`` is the full base + slot index vector ([K0 + S], no
        duplicate index), ``base_val`` only the [B, K0] base columns."""
        b = int(label_idx.shape[0])
        if b == 0:
            return 0
        slots = self._count_uniq(uniq_labels, label_idx)
        if self.train_mode != "parallel":
            full = _expand_combo_host(base_val, a_idx, b_idx, mul_mask)
            return self._train_slots(
                slots, np.broadcast_to(uidx, (b, uidx.shape[0])), full, b)
        bsz = _bucket(b, 16)
        if bsz != b:  # zero base rows expand to zero slots: still no-ops
            base_val = np.pad(base_val, ((0, bsz - b), (0, 0)))
            slots = np.pad(slots, (0, bsz - b))
        dev = self.device
        args = [to_device(a, dev)
                for a in (base_val, a_idx, b_idx, mul_mask, slots)]
        self.state = sm.on_columns(self.state, uidx, lambda st, u: (
            ops.train_batch_schema_combo(st, u, *args, self._mask(),
                                         self._param, method=self.method)))
        self.event_model_updated(b)
        return b

    def _ranked(self, n: int, launch) -> List[List[Tuple[str, float]]]:
        """Dispatch under the lock, read back unlocked: ``launch()`` enqueues
        the [B, L] scores while the lock is held; ``.cpu()`` waits for them
        after it is released."""
        with self.lock:
            if not self.label_slots:
                return [[] for _ in range(n)]
            slots = list(self.label_slots.items())
            pending = launch()
        sc = pending[:n].cpu().numpy()
        return [[(lab, float(row[slot])) for lab, slot in slots]
                for row in sc]

    def classify_hashed_combo(self, uidx: np.ndarray, base_val: np.ndarray,
                              a_idx: np.ndarray, b_idx: np.ndarray,
                              mul_mask: np.ndarray
                              ) -> List[List[Tuple[str, float]]]:
        """classify_hashed_schema with the combination slots expanded on
        the device."""
        n = base_val.shape[0]
        if n == 0:
            return []
        b = _bucket(n, 16)
        if b != n:
            base_val = np.pad(base_val, ((0, b - n), (0, 0)))
        dev = self.device
        dval = to_device(base_val, dev)
        da, db = to_device(a_idx, dev), to_device(b_idx, dev)
        dm = to_device(mul_mask, dev)

        def launch():
            st, duidx = sm.query_columns(self.state, uidx)
            return ops.scores_schema_combo(st, duidx, dval, da, db, dm,
                                           self._mask())
        return self._ranked(n, launch)

    def classify_hashed_schema(self, uidx: np.ndarray,
                               val: np.ndarray) -> List[List[Tuple[str, float]]]:
        """classify_hashed for a uniform-schema batch (one product)."""
        n = val.shape[0]
        if n == 0:
            return []
        b = _bucket(n, 16)
        if b != n:
            val = np.pad(val, ((0, b - n), (0, 0)))
        dval = to_device(val, self.device)

        def launch():
            st, duidx = sm.query_columns(self.state, uidx)
            return ops.scores_schema(st, duidx, dval, self._mask())
        return self._ranked(n, launch)

    def classify(self, data: Sequence[Datum]) -> List[List[Tuple[str, float]]]:
        # not @locked: conversion touches no driver state, and
        # classify_hashed holds the lock only while it launches
        if not data:
            return []
        sb = self.converter.convert_batch(data).to_padded(batch_bucket=16)
        out = self.classify_hashed(sb.idx, sb.val)
        if not out:
            return [[] for _ in data]
        return out[: len(data)]

    def classify_hashed(self, idx: np.ndarray,
                        val: np.ndarray) -> List[List[Tuple[str, float]]]:
        """Classify pre-hashed features; same output as classify()."""
        n = idx.shape[0]
        if n == 0:
            return []
        b = _bucket(n, 16)
        if b != n:
            idx = np.pad(idx, ((0, b - n), (0, 0)))
            val = np.pad(val, ((0, b - n), (0, 0)))
        # uploads touch no driver state: stage them before the lock
        didx, dval = to_device(idx, self.device), to_device(val, self.device)
        return self._ranked(n, lambda: sm.scores(
            self._mesh, self.state, didx, dval, self._mask()))

    def shard_stats(self) -> Dict[str, Any]:
        """The feature-shard layout (the ``shard.*`` gauges): shard count,
        label rows, bytes of every table and per shard. Empty when
        unsharded."""
        return sm.shard_stats(self._mesh, self.state, self.capacity)

    @locked
    def clear(self) -> None:
        self._init_model()
        self.converter.weights.clear()
        self.update_count = 0

    # -- mix plane -----------------------------------------------------------
    def get_schema(self) -> List[str]:
        return sorted(self.label_slots.keys())

    def sync_schema(self, union_schema: List[str]) -> None:
        """Realign label slots to the canonical (sorted union) vocabulary,
        so slot i holds union_schema[i] on every replica. Free when already
        aligned (every steady-state mix round); otherwise the rows are
        permuted on the device with one gather, never through the host."""
        new_cap = max(_INITIAL_CAPACITY, _next_pow2(len(union_schema)))
        target_slots = {lab: i for i, lab in enumerate(union_schema)}
        if new_cap == self.capacity and target_slots == self.label_slots:
            return
        perm = np.full(new_cap, -1, dtype=np.int64)  # new slot -> old slot
        for new_slot, label in enumerate(union_schema):
            old = self.label_slots.get(label)
            if old is not None:
                perm[new_slot] = old
        live_h = perm >= 0
        gather_h = np.where(live_h, perm, 0)

        def take_rows(a: torch.Tensor, fill: float) -> torch.Tensor:
            if a.shape == (1, 1):
                return a
            gather = to_device(gather_h, a.device)
            live_d = to_device(live_h, a.device)[:, None]
            return torch.where(live_d, a.index_select(0, gather), fill)

        self.state = sm.map_shards(lambda st: ops.ClassifierState(
            w=take_rows(st.w, 0.0), dw=take_rows(st.dw, 0.0),
            prec=take_rows(st.prec, 1.0), dprec=take_rows(st.dprec, 0.0)),
            self.state)

        def take_vec(v: np.ndarray) -> np.ndarray:
            out = np.zeros(new_cap, dtype=v.dtype)
            out[live_h] = v[perm[live_h]]
            return out

        self.label_counts = take_vec(self.label_counts)
        self._dcounts = take_vec(self._dcounts)
        self.capacity = new_cap
        self.labels = list(union_schema) + [""] * (new_cap - len(union_schema))
        self.label_slots = dict(target_slots)
        self._mask_dev = None

    def get_mixables(self):
        return {"classifier": _ClassifierMixable(self),
                "weights": self.converter.weights}

    # -- persistence ---------------------------------------------------------
    @locked
    def pack(self) -> Any:
        st = self.state
        return {
            "method": self.method,
            "dim": self.converter.dim,
            "labels": self.labels,
            "capacity": self.capacity,
            "w": sm.host_sum(st.w, st.dw),
            "prec": sm.host_sum(st.prec, st.dprec),
            "label_counts": self.label_counts + self._dcounts,
            "weights": self.converter.weights.pack(),
        }

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
        self.capacity = int(obj["capacity"])
        self.labels = [s.decode() if isinstance(s, bytes) else s
                       for s in obj["labels"]]
        self.label_slots = {lab: i for i, lab in enumerate(self.labels) if lab}
        w = np.asarray(obj["w"], dtype=np.float32)
        prec = np.asarray(obj["prec"], dtype=np.float32)
        # on a mesh the host arrays are split straight into the blocks
        self.state = sm.place_host(self._mesh, ops.ClassifierState(
            w=w, dw=np.zeros_like(w), prec=prec, dprec=np.zeros_like(prec)),
            self.converter.dim, self.device)
        self.label_counts = np.asarray(obj["label_counts"],
                                       dtype=np.float32).copy()
        self._dcounts = np.zeros_like(self.label_counts)
        self._mask_dev = None
        self.converter.weights.unpack(obj["weights"])

    @locked
    def get_status(self) -> Dict[str, Any]:
        st = super().get_status()
        st.update(method=self.method, num_labels=len(self.label_slots),
                  num_features=self.converter.dim, device=str(self.device))
        st.update({f"shard.{k}": v for k, v in self.shard_stats().items()})
        return st


class _ClassifierMixable:
    """The ops-level diff, trimmed to the live label rows, with the label
    counts; host numpy on the way out (a sharded table as per-shard
    chunks). No custom ``mix``: the fold is the host tree_sum (its
    trailing-row pad included), as in the JAX package, so the guard
    screens it and the async fold weights it."""

    def __init__(self, driver: ClassifierDriver):
        self._d = driver

    def get_diff(self):
        d = self._d
        # only the rows up to the highest slot in use: after the round's
        # schema sync the slot assignment is the same on every replica,
        # while capacities (pow2-padded) may differ
        n = max(d.label_slots.values(), default=0) + 1
        # sharded tables travel as per-shard chunks keyed by start
        # column; peers fold them chunk by chunk
        return {"dw": sm.diff_leaf(d.state.dw, n),
                "dprec": sm.diff_leaf(d.state.dprec, n), "count": 1.0,
                "label_counts": d._dcounts[:n].copy()}

    def get_device_diff(self):
        """The diff the collective mixer stages: the same leaves as
        ``get_diff`` as float32 tensors on the driver's device (copies),
        as the JAX model's diff is device-resident, so a full-width round
        pays no device→host→device trip."""
        d = self._d
        n = max(d.label_slots.values(), default=0) + 1
        return {"dw": sm.device_diff_leaf(d.state.dw, n),
                "dprec": sm.device_diff_leaf(d.state.dprec, n),
                "count": torch.ones((), dtype=torch.float32,
                                    device=d.device),
                "label_counts": torch.from_numpy(
                    d._dcounts[:n].copy()).to(d.device)}

    def put_diff(self, diff) -> bool:
        d = self._d
        array_diff = {k: v for k, v in diff.items() if k != "label_counts"}
        d.state = sm.put_diff(d.state, sm.assemble_diff(
            d._mesh, array_diff, d.converter.dim))
        counts = diff.get("label_counts")
        if counts is not None:
            counts = counts.cpu().numpy() if isinstance(
                counts, torch.Tensor) else np.asarray(counts)
            d.label_counts[:len(counts)] += counts
            d._dcounts[:] = 0.0
        return True


def _next_pow2(n: int) -> int:
    p = 1
    while p < n:
        p *= 2
    return p


def _expand_combo_host(base_val: np.ndarray, a_idx: np.ndarray,
                       b_idx: np.ndarray, mul_mask: np.ndarray) -> np.ndarray:
    """Host mirror of ops._expand_combo (sequential train mode)."""
    va = base_val[:, a_idx]
    vb = base_val[:, b_idx]
    slots = np.where(mul_mask[None, :], va * vb, va + vb)
    return np.concatenate([base_val, slots], axis=1).astype(np.float32)
