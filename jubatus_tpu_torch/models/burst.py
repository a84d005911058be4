"""Burst engine driver (copy of ``jubatus_tpu/models/burst.py``):
Kleinberg burst detection over keyword streams.

Business API of the reference's burst service: add_documents / get_result /
get_result_at / get_all_bursted_results(_at) / get_all_keywords /
add_keyword / remove_keyword / remove_all_keywords / clear. Config
parameter {window_batch_size, batch_interval, max_reuse_batch_num,
costcut_threshold, result_window_rotate_size}; keywords carry
(scaling_param, gamma).

- A document is (pos, text), in batch floor(pos / batch_interval). Each
  document counts in its batch's all_data_count, and in a keyword's
  relevant_data_count when its text contains the keyword.
- A window is the ``window_batch_size`` batches ending at a position's
  batch (``get_result``: the latest position seen).
- Weights come from the two-state automaton: the base state emits at
  p0 = Σr/Σd over the window, the burst state at min(1, p0 ·
  scaling_param); the emission cost is the binomial negative
  log-likelihood, the up-transition costs ``gamma``, and Viterbi finds the
  states. A batch in the burst state reports cost_0 − cost_1 (clipped at a
  positive ``costcut_threshold``), others 0.
- Batches older than (result_window_rotate_size + 1) windows are pruned.
- ``set_assignment`` installs a keyword-ownership predicate (the server's
  CHT placement); the mix is an elementwise max of count totals, since
  documents are broadcast to every replica.

The dynamic programme is a few dozen scalar operations per query and runs
on the host, as in the JAX package.
The driver resolves ``device`` as every driver of the port does (``cuda``
unless ``"cpu"`` is asked for, raising without CUDA), so that ``--device``
means the same for every engine; it holds no tensor.
"""

from __future__ import annotations

import json
import math
from typing import Any, Dict, List, Optional, Tuple

from jubatus_tpu_torch import resolve_device
from jubatus_tpu_torch.framework.driver import DriverBase, locked


class BurstConfigError(ValueError):
    pass


class BurstDriver(DriverBase):
    TYPE = "burst"

    def __init__(self, config: dict, device=None):
        super().__init__()
        self.device = resolve_device(device)
        self.config = config
        self.config_json = json.dumps(config)
        param = dict(config.get("parameter") or {})
        self.window_batch_size = int(param.get("window_batch_size", 5))
        self.batch_interval = float(param.get("batch_interval", 10))
        # accepted for config parity; the reference reuses previous windows'
        # DP results for speed — our DP is recomputed per query (it is a few
        # dozen scalar ops), so there is nothing to reuse
        self.max_reuse_batch_num = int(param.get("max_reuse_batch_num", 5))
        self.costcut_threshold = float(param.get("costcut_threshold", -1))
        self.result_window_rotate_size = int(
            param.get("result_window_rotate_size", 5))
        if self.window_batch_size <= 0 or self.batch_interval <= 0:
            raise BurstConfigError(
                "window_batch_size and batch_interval must be positive")
        self._init_model()

    def _init_model(self) -> None:
        # keyword -> (scaling_param, gamma)
        self.keywords: Dict[str, Tuple[float, float]] = {}
        # master + since-last-mix diff counters
        self._all_m: Dict[int, int] = {}     # batch -> all_data_count
        self._all_d: Dict[int, int] = {}
        self._rel_m: Dict[str, Dict[int, int]] = {}
        self._rel_d: Dict[str, Dict[int, int]] = {}
        self._max_batch: Optional[int] = None
        #: keyword -> am-I-assigned predicate; None = standalone (process
        #: every keyword). Set by the server from CHT placement.
        self._assigned = None
        self._assigned_cache: Dict[str, bool] = {}

    # -- keyword partitioning (burst_serv.cpp:86-102, 225-239) ---------------
    def set_assignment(self, assigned) -> None:
        """Install (or update) the CHT assignment predicate and drop
        counts for keywords that are no longer mine — the re-hash step of
        a membership change. Registry entries stay (the keyword list is
        cluster-global); only count state is partitioned."""
        with self.lock:
            self._assigned = assigned
            self._assigned_cache = {}
            if assigned is None:
                return
            for kw in self.keywords:
                if not self._is_assigned(kw):
                    self._rel_m[kw] = {}
                    self._rel_d[kw] = {}

    def _is_assigned(self, kw: str) -> bool:
        """Memoized per keyword: the predicate is a CHT ring walk (md5 +
        bisect) and add_documents asks it per (document x keyword) — the
        cache is cleared whenever the assignment changes."""
        if self._assigned is None:
            return True
        hit = self._assigned_cache.get(kw)
        if hit is None:
            hit = self._assigned_cache[kw] = bool(self._assigned(kw))
        return hit

    # -- keyword registry -------------------------------------------------------
    @locked
    def add_keyword(self, keyword: str, scaling_param: float,
                    gamma: float) -> bool:
        if keyword in self.keywords:
            return False
        if scaling_param <= 1.0:
            raise BurstConfigError("scaling_param must be > 1")
        if gamma <= 0.0:
            raise BurstConfigError("gamma must be positive")
        self.keywords[keyword] = (float(scaling_param), float(gamma))
        self._rel_m.setdefault(keyword, {})
        self._rel_d.setdefault(keyword, {})
        return True

    @locked
    def remove_keyword(self, keyword: str) -> bool:
        if keyword not in self.keywords:
            return False
        del self.keywords[keyword]
        self._rel_m.pop(keyword, None)
        self._rel_d.pop(keyword, None)
        return True

    @locked
    def remove_all_keywords(self) -> bool:
        self.keywords.clear()
        self._rel_m.clear()
        self._rel_d.clear()
        return True

    @locked
    def get_all_keywords(self) -> List[Dict[str, float]]:
        return [{"keyword": kw, "scaling_param": s, "gamma": g}
                for kw, (s, g) in self.keywords.items()]

    # -- ingest -----------------------------------------------------------------
    @locked
    def add_documents(self, documents: List[Tuple[float, str]]) -> int:
        n = 0
        for pos, text in documents:
            b = int(math.floor(float(pos) / self.batch_interval))
            self._all_d[b] = self._all_d.get(b, 0) + 1
            for kw in self.keywords:
                if self._is_assigned(kw) and kw in text:
                    rel = self._rel_d[kw]
                    rel[b] = rel.get(b, 0) + 1
            if self._max_batch is None or b > self._max_batch:
                self._max_batch = b
            n += 1
        if n:
            self._prune()
            self.event_model_updated(n)
        return n

    def _prune(self) -> None:
        if self._max_batch is None:
            return
        horizon = self._max_batch - self.window_batch_size * (
            self.result_window_rotate_size + 1)
        for d in [self._all_m, self._all_d,
                  *self._rel_m.values(), *self._rel_d.values()]:
            for b in [b for b in d if b < horizon]:
                del d[b]

    # -- burst math -------------------------------------------------------------
    def _counts(self, kw: str, b: int) -> Tuple[int, int]:
        d = self._all_m.get(b, 0) + self._all_d.get(b, 0)
        r = self._rel_m.get(kw, {}).get(b, 0) + self._rel_d.get(kw, {}).get(b, 0)
        return d, r

    @staticmethod
    def _emission_cost(r: int, d: int, p: float) -> float:
        if d == 0:
            return 0.0
        p = min(max(p, 1e-9), 1.0 - 1e-9)
        return -(r * math.log(p) + (d - r) * math.log(1.0 - p))

    def _window(self, kw: str, end_batch: int) -> Dict[str, Any]:
        w = self.window_batch_size
        batches = list(range(end_batch - w + 1, end_batch + 1))
        counts = [self._counts(kw, b) for b in batches]
        total_d = sum(d for d, _ in counts)
        total_r = sum(r for _, r in counts)
        scaling, gamma = self.keywords[kw]
        weights = [0.0] * w
        if total_d > 0 and total_r > 0:
            p0 = total_r / total_d
            p1 = min(1.0 - 1e-9, p0 * scaling)
            # Viterbi over states {0: base, 1: burst}; up-transition costs gamma
            c0, c1 = 0.0, gamma
            back: List[Tuple[int, int]] = []
            for d, r in counts:
                e0 = self._emission_cost(r, d, p0)
                e1 = self._emission_cost(r, d, p1)
                n0, b0 = (c0, 0) if c0 <= c1 else (c1, 1)
                n1, b1 = (c0 + gamma, 0) if c0 + gamma < c1 else (c1, 1)
                back.append((b0, b1))
                c0, c1 = n0 + e0, n1 + e1
            state = 0 if c0 <= c1 else 1
            states = [0] * w
            for i in range(w - 1, -1, -1):
                states[i] = state
                state = back[i][state]
            for i, ((d, r), s) in enumerate(zip(counts, states)):
                if s == 1:
                    save = self._emission_cost(r, d, p0) - \
                        self._emission_cost(r, d, p1)
                    if self.costcut_threshold > 0:
                        save = min(save, self.costcut_threshold)
                    weights[i] = max(save, 0.0)
        return {
            "start_pos": (end_batch - w + 1) * self.batch_interval,
            "batches": [
                {"all_data_count": d, "relevant_data_count": r,
                 "burst_weight": weights[i]}
                for i, (d, r) in enumerate(counts)
            ],
        }

    # -- queries ----------------------------------------------------------------
    def _end_batch(self, pos: Optional[float] = None) -> Optional[int]:
        if pos is not None:
            return int(math.floor(float(pos) / self.batch_interval))
        return self._max_batch

    @locked
    def get_result(self, keyword: str) -> Dict[str, Any]:
        return self.get_result_at(keyword, None)

    @locked
    def get_result_at(self, keyword: str, pos: Optional[float]) -> Dict[str, Any]:
        if keyword not in self.keywords:
            raise KeyError(f"unknown keyword {keyword!r}")
        end = self._end_batch(pos)
        if end is None:
            return {"start_pos": 0.0, "batches": []}
        return self._window(keyword, end)

    def _all_results(self, pos: Optional[float]) -> Dict[str, Dict[str, Any]]:
        end = self._end_batch(pos)
        if end is None:
            return {}
        out = {}
        for kw in self.keywords:
            win = self._window(kw, end)
            if any(b["burst_weight"] > 0 for b in win["batches"]):
                out[kw] = win
        return out

    @locked
    def get_all_bursted_results(self) -> Dict[str, Dict[str, Any]]:
        return self._all_results(None)

    @locked
    def get_all_bursted_results_at(self, pos: float) -> Dict[str, Dict[str, Any]]:
        return self._all_results(pos)

    @locked
    def clear(self) -> None:
        self._init_model()
        self.update_count = 0

    # -- mix plane ---------------------------------------------------------------
    def get_mixables(self):
        return {"burst": _BurstMixable(self)}

    # -- persistence ---------------------------------------------------------------
    @locked
    def pack(self) -> Any:
        return {
            "keywords": {kw: list(sg) for kw, sg in self.keywords.items()},
            "all": {b: self._all_m.get(b, 0) + self._all_d.get(b, 0)
                    for b in set(self._all_m) | set(self._all_d)},
            "rel": {kw: {b: self._rel_m.get(kw, {}).get(b, 0) +
                         self._rel_d.get(kw, {}).get(b, 0)
                         for b in set(self._rel_m.get(kw, {})) |
                         set(self._rel_d.get(kw, {}))}
                    for kw in self.keywords},
            "max_batch": self._max_batch,
        }

    @locked
    def unpack(self, obj: Any) -> None:
        def _s(x):
            return x.decode() if isinstance(x, bytes) else x

        self._init_model()
        for kw, (s, g) in obj["keywords"].items():
            kw = _s(kw)
            self.keywords[kw] = (float(s), float(g))
            self._rel_m[kw] = {}
            self._rel_d[kw] = {}
        self._all_m = {int(b): int(c) for b, c in obj["all"].items()}
        for kw, batches in obj["rel"].items():
            self._rel_m[_s(kw)] = {int(b): int(c) for b, c in batches.items()}
        mb = obj.get("max_batch")
        self._max_batch = int(mb) if mb is not None else None

    @locked
    def get_status(self) -> Dict[str, Any]:
        st = super().get_status()
        st.update(num_keywords=len(self.keywords),
                  window_batch_size=self.window_batch_size,
                  device=str(self.device))
        return st


class _BurstMixable:
    """(keyword, batch) count TOTALS merged by elementwise max.

    Documents are broadcast, so a keyword's two CHT owners hold duplicate
    counts — max is the correct replica merge (the reference's mixable
    keeps the window with more data, mixable_burst semantics). Max over
    totals is also idempotent and order-insensitive, which makes the fold
    safe under retries and partial rounds. A replica newly assigned a
    keyword (membership change) back-fills here: its zero counts max with
    the surviving owner's totals."""

    def __init__(self, driver: BurstDriver):
        self._d = driver

    def get_diff(self):
        d = self._d
        rel = {}
        for kw in d.keywords:
            if not d._is_assigned(kw):
                continue
            tot = {b: d._rel_m.get(kw, {}).get(b, 0) +
                   d._rel_d.get(kw, {}).get(b, 0)
                   for b in set(d._rel_m.get(kw, {})) |
                   set(d._rel_d.get(kw, {}))}
            if tot:
                rel[kw] = tot
        all_tot = {b: d._all_m.get(b, 0) + d._all_d.get(b, 0)
                   for b in set(d._all_m) | set(d._all_d)}
        return {"all": all_tot, "rel": rel, "max_batch": d._max_batch}

    @staticmethod
    def mix(acc, diff):
        for b, c in diff["all"].items():
            acc["all"][b] = max(acc["all"].get(b, 0), c)
        for kw, bs in diff["rel"].items():
            mine = acc["rel"].setdefault(kw, {})
            for b, c in bs.items():
                mine[b] = max(mine.get(b, 0), c)
        if diff["max_batch"] is not None and (
                acc["max_batch"] is None or diff["max_batch"] > acc["max_batch"]):
            acc["max_batch"] = diff["max_batch"]
        return acc

    def put_diff(self, diff) -> bool:
        def _s(x):
            return x.decode() if isinstance(x, bytes) else x

        d = self._d
        for b, c in diff["all"].items():
            b = int(b)
            local = d._all_m.get(b, 0) + d._all_d.get(b, 0)
            d._all_m[b] = max(local, int(c))
        for kw, bs in diff["rel"].items():
            kw = _s(kw)
            if kw not in d.keywords or not d._is_assigned(kw):
                continue  # removed locally, or not my partition to hold
            mine_m = d._rel_m.setdefault(kw, {})
            mine_d = d._rel_d.get(kw, {})
            for b, c in bs.items():
                b = int(b)
                local = mine_m.get(b, 0) + mine_d.get(b, 0)
                mine_m[b] = max(local, int(c))
        mb = diff.get("max_batch")
        if mb is not None and (d._max_batch is None or mb > d._max_batch):
            d._max_batch = int(mb)
        d._all_d.clear()
        for bs in d._rel_d.values():
            bs.clear()
        d._prune()
        return True
