"""Instance-based classifiers (counterpart of
``jubatus_tpu/models/classifier_nn.py``): methods NN / cosine / euclidean.

The model is a store of labeled examples; classify finds the
``nearest_neighbor_num`` closest stored examples and votes per label with
weight exp(-d / local_sensitivity), where d is the backend's distance.

- method "NN": a nested nearest_neighbor backend config {"method":
  "euclid_lsh"|"lsh"|"minhash", "parameter": {...}}; lsh and minhash scan
  with the signature-scan kernel.
- "cosine" / "euclidean": the exact inverted_index / euclid scans.

The label of each stored example rides in the row store's datum slot, so
row mixing, checkpointing and LRU unlearning carry labels. Row ids are
uuid4, so ids minted on different nodes never collide when diffs merge.
``pack()`` gives the JAX driver's layout, so checkpoints move both ways.
"""

from __future__ import annotations

import json
import math
import uuid
from typing import Any, Dict, List, Tuple

from jubatus_tpu_torch.core.datum import Datum
from jubatus_tpu_torch.core.fv import make_fv_converter
from jubatus_tpu_torch.framework.driver import DriverBase, locked
from jubatus_tpu_torch.models._nn_backend import NNBackend, NNIndexStats
from jubatus_tpu_torch.models.nearest_neighbor import _RowUpdateMixable

NN_METHODS = ("NN", "cosine", "euclidean")


class ClassifierConfigError(ValueError):
    pass


def _as_label(x: Any) -> str:
    """Normalize a stored/wire label (bytes after msgpack round trips)."""
    return x.decode() if isinstance(x, bytes) else str(x)


def _wins(new: Tuple[int, bool], cur) -> bool:
    """Last-writer-wins on (epoch, alive): a higher epoch wins, and on an
    epoch tie the tombstone (alive=False) wins."""
    return cur is None or new[0] > cur[0] or (new[0] == cur[0] and not new[1])


class _LabelSetMixable:
    """Last-writer-wins label-state mix, so set_label / delete_label reach
    the other replicas even for labels with no examples (the examples
    travel in the row diff).

    The diff is the full ``{label: [epoch, alive]}`` map: a failed exchange
    loses nothing and a peer re-ships what it learned. Per label the
    highest epoch wins; on an epoch tie the tombstone wins, so an idle
    replica's old registration never resurrects a delete."""

    def __init__(self, driver: "ClassifierNNDriver") -> None:
        self._d = driver

    def get_diff(self):
        return {label: [int(e), bool(a)]
                for label, (e, a) in self._d._label_states.items()}

    @staticmethod
    def mix(acc, diff):
        out = {_as_label(k): [int(v[0]), bool(v[1])] for k, v in acc.items()}
        for k, v in diff.items():
            k = _as_label(k)
            new = (int(v[0]), bool(v[1]))
            if _wins(new, out.get(k)):
                out[k] = list(new)
        return out

    def put_diff(self, diff) -> bool:
        states = self._d._label_states
        for k, v in diff.items():
            k = _as_label(k)
            new = (int(v[0]), bool(v[1]))
            if _wins(new, states.get(k)):
                states[k] = new
        self._d.registered = {k for k, (_e, a) in states.items() if a}
        self._d._invalidate_counts()
        return True


class _NNRowsMixable(_RowUpdateMixable):
    """Row diff that also invalidates the driver's label-count cache when
    mixed-in rows land."""

    def __init__(self, driver: "ClassifierNNDriver") -> None:
        super().__init__(driver.backend)
        self._d = driver

    def put_diff(self, diff) -> bool:
        ok = super().put_diff(diff)
        self._d._invalidate_counts()
        return ok


class ClassifierNNDriver(NNIndexStats, DriverBase):
    TYPE = "classifier"

    def __init__(self, config: dict, dim_bits: int = 18, device=None):
        super().__init__()
        self.config = config
        self.config_json = json.dumps(config)
        method = config.get("method")
        if method not in NN_METHODS:
            raise ClassifierConfigError(
                f"unknown NN classifier method {method!r}")
        self.method = method
        param = dict(config.get("parameter") or {})
        self.k = int(param.get("nearest_neighbor_num", 16))
        self.local_sensitivity = float(param.get("local_sensitivity", 1.0))
        if self.k < 1:
            raise ClassifierConfigError("nearest_neighbor_num must be >= 1")
        if self.local_sensitivity <= 0:
            raise ClassifierConfigError("local_sensitivity must be positive")
        self.converter = make_fv_converter(config.get("converter"),
                                           dim_bits=dim_bits)
        if method == "NN":
            backend_method = param.get("method", "euclid_lsh")
            nn_param = dict(param.get("parameter") or {})
        else:
            backend_method = "inverted_index" if method == "cosine" else "euclid"
            nn_param = {}
        unl_param = param.get("unlearner_parameter") or {}
        self.backend = NNBackend(
            backend_method,
            dim=self.converter.dim,
            hash_num=int(nn_param.get("hash_num", 64)),
            seed=int(nn_param.get("seed", 0)),
            max_size=(int(unl_param["max_size"])
                      if param.get("unlearner") == "lru" else None),
            keep_datum=True,  # the datum slot holds the example's label
            device=device,
        )
        #: labels alive in _label_states (kept for fast membership tests)
        self.registered: set = set()
        #: label → (epoch, alive): the state _LabelSetMixable mixes
        self._label_states: Dict[str, Tuple[int, bool]] = {}
        #: label → example count, memoized; every mutation invalidates it
        self._counts_cache: Dict[str, int] = None  # type: ignore[assignment]

    @property
    def device(self):
        return self.backend.device

    def _invalidate_counts(self) -> None:
        self._counts_cache = None

    def _mark_label(self, label: str, alive: bool) -> None:
        epoch = max((e for e, _a in self._label_states.values()), default=0) + 1
        self._label_states[label] = (epoch, alive)
        if alive:
            self.registered.add(label)
        else:
            self.registered.discard(label)

    # -- training -------------------------------------------------------------
    @locked
    def train(self, data: List[Tuple[str, Datum]]) -> int:
        # batch featurization (one hash sweep, one idf observe); the row
        # inserts stay per row, the row store's API
        csr = self.converter.convert_batch(
            [datum for _, datum in data], update_weights=True)
        for i, (label, _datum) in enumerate(data):
            self.backend.set_row(uuid.uuid4().hex, csr.row(i),
                                 datum=str(label))
            if str(label) not in self.registered:
                self._mark_label(str(label), True)
        self._invalidate_counts()
        self.event_model_updated(len(data))
        return len(data)

    # -- classification -------------------------------------------------------
    def _label_counts(self) -> Dict[str, int]:
        if self._counts_cache is None:
            counts = {label: 0 for label in self.registered}
            for label in self.backend.store.datums.values():
                label = _as_label(label)
                counts[label] = counts.get(label, 0) + 1
            self._counts_cache = counts
        return self._counts_cache

    @locked
    def classify(self, data: List[Datum]) -> List[List[Tuple[str, float]]]:
        labels = sorted(self._label_counts())
        csr = self.converter.convert_batch(list(data))
        out: List[List[Tuple[str, float]]] = []
        for i in range(len(data)):
            scores = {label: 0.0 for label in labels}
            for rid, dist in self.backend.neighbors(csr.row(i), self.k):
                label = self.backend.store.datums.get(rid)
                if label is None:
                    continue
                w = math.exp(-float(dist) / self.local_sensitivity)
                label = _as_label(label)
                scores[label] = scores.get(label, 0.0) + w
            out.append(sorted(scores.items()))
        return out

    # -- label management -------------------------------------------------------
    @locked
    def get_labels(self) -> Dict[str, int]:
        return dict(self._label_counts())

    @locked
    def set_label(self, label: str) -> bool:
        if label in self._label_counts():
            return False
        self._mark_label(str(label), True)
        self._invalidate_counts()
        self.event_model_updated()
        return True

    @locked
    def delete_label(self, label: str) -> bool:
        """Removes the label's examples and tombstones the label. Cluster-
        wide only through a broadcast to every replica: a single replica's
        delete is resurrected by its peers' row diffs."""
        if label not in self._label_counts():
            return False
        doomed = [rid for rid, lab in list(self.backend.store.datums.items())
                  if _as_label(lab) == label]
        for rid in doomed:
            self.backend.remove_row(rid)
        self._mark_label(label, False)  # tombstone: survives later mixes
        self._invalidate_counts()
        self.event_model_updated()
        return True

    @locked
    def clear(self) -> None:
        self.backend.clear()
        self.registered.clear()
        self._label_states.clear()
        self._invalidate_counts()
        self.converter.weights.clear()
        self.update_count = 0

    # -- mix plane ------------------------------------------------------------
    def get_mixables(self):
        return {"rows": _NNRowsMixable(self),
                "labels": _LabelSetMixable(self),
                "weights": self.converter.weights}

    # -- persistence ----------------------------------------------------------
    @locked
    def pack(self) -> Any:
        return {"method": self.method,
                "backend": self.backend.pack(),
                "label_states": {k: [e, a] for k, (e, a)
                                 in self._label_states.items()},
                "weights": self.converter.weights.pack()}

    @locked
    def unpack(self, obj: Any) -> None:
        saved = obj.get("method")
        if isinstance(saved, bytes):
            saved = saved.decode()
        if saved != self.method:
            raise ValueError(
                f"checkpoint method {saved!r} != driver method {self.method!r}")
        self.backend.unpack(obj["backend"], datum_decoder=_as_label)
        self._label_states = {
            _as_label(k): (int(v[0]), bool(v[1]))
            for k, v in (obj.get("label_states") or {}).items()
        }
        # checkpoints from before the state map carried a plain list
        for r in obj.get("registered", []):
            self._label_states.setdefault(_as_label(r), (0, True))
        self.registered = {k for k, (_e, a) in self._label_states.items() if a}
        self._invalidate_counts()
        self.converter.weights.unpack(obj["weights"])

    @locked
    def get_status(self) -> Dict[str, Any]:
        st = super().get_status()
        st.update(method=self.method, num_examples=len(self.backend.store),
                  num_labels=len(self._label_counts()),
                  device=str(self.device))
        st.update(self.index_status())
        return st
