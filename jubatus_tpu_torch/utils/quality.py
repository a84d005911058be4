"""Data-quality & prediction-quality plane (copy of
``jubatus_tpu/utils/quality.py``).

The tracing, SLO and usage planes make the *system* legible; this module
observes the *data and the model*. Three signal families, all bounded and all
mergeable across the fleet (utils/sketches.py):

- **Drift** — per-feature-group and per-prediction PSI between a PINNED
  reference window and the live window. PSI (population stability
  index, the credit-scoring classic) is ``sum((p_i - q_i) *
  ln(p_i / q_i))`` over a fixed binning — symmetric, additive over
  bins, and 0 iff the distributions agree; >~0.2 conventionally means
  "significant shift". The binning here is the sketch's own log-bucket
  grid (coarsened to octaves) for values and top-k + tail for labels,
  so drift falls straight out of two sketch states with no raw data.
  Scores publish as ``quality.drift.<group>`` gauges plus the
  ``quality.drift.max`` roll-up — SLO-able via the existing ``gauge:``
  grammar (utils/slo.py) with zero engine changes. The roll-up covers
  INCOMING data only (feature groups + the training-label mix);
  model-output drift keys (``OUTPUT_DRIFT_KEYS``) publish under their
  own gauges but never page the input-drift SLO.
- **Prequential accuracy** — test-then-train (Dawid 1984; Gama et al.
  2013): every sampled train datum is FIRST scored with the current
  model, then trained on. The running accuracy/MAE is an unbiased
  streaming estimate of held-out performance with zero extra labels —
  the signal that catches concept shift (the label boundary moved)
  which covariate drift alone cannot see.
- **Calibration** — classifier confidence (softmax over the ranked
  scores) vs empirical accuracy in 10 fixed bins; the expected
  calibration error (ECE) is the weighted mean |confidence - accuracy|
  gap.

:class:`QualityPlane` owns the live window, the completed-window ring,
the pinned reference, and the sampling gates; ``server/base.py`` ticks
it from the telemetry thread and ships ``snapshot()`` through the
idempotent ``get_quality`` RPC; ``merge_quality`` is the proxy/CLI fold.
"""

from __future__ import annotations

import math
import threading
import time
from typing import Any, Dict, Iterable, List, Optional, Sequence

import numpy as np

from jubatus_tpu_torch.utils import sketches

#: PSI above this is "significant shift" by the usual operator rule of
#: thumb; docs + the bench drill use it as the SLO ceiling example
DEFAULT_DRIFT_THRESHOLD = 0.2
#: live window needs this many recorded values before its PSI is
#: trusted (a 3-sample window against a 10^6-sample reference is noise)
DEFAULT_DRIFT_MIN_COUNT = 50
#: collapse quarter-octave bins to octave bins for PSI (full resolution
#: splits the mass too thin for small windows)
_PSI_COARSEN = 4
#: smoothing mass per bin: keeps ln(p/q) finite when one side is empty
_PSI_EPS = 1e-3

_CAL_BINS = 10


# -- drift scores ------------------------------------------------------------

def psi_from_freqs(p: Dict[Any, float], q: Dict[Any, float],
                   eps: float = _PSI_EPS) -> float:
    """PSI between two relative-frequency dicts over the union support,
    with additive smoothing ``eps`` per bin."""
    keys = set(p) | set(q)
    if not keys:
        return 0.0
    denom_p = 1.0 + eps * len(keys)
    denom_q = 1.0 + eps * len(keys)
    out = 0.0
    for k in keys:
        pi = (float(p.get(k, 0.0)) + eps) / denom_p
        qi = (float(q.get(k, 0.0)) + eps) / denom_q
        out += (pi - qi) * math.log(pi / qi)
    return out


def kl_from_freqs(p: Dict[Any, float], q: Dict[Any, float],
                  eps: float = _PSI_EPS) -> float:
    """Smoothed KL(p || q) over the union support — the asymmetric
    companion score (PSI is its symmetrized form)."""
    keys = set(p) | set(q)
    if not keys:
        return 0.0
    denom_p = 1.0 + eps * len(keys)
    denom_q = 1.0 + eps * len(keys)
    out = 0.0
    for k in keys:
        pi = (float(p.get(k, 0.0)) + eps) / denom_p
        qi = (float(q.get(k, 0.0)) + eps) / denom_q
        out += pi * math.log(pi / qi)
    return out


def value_freqs(state: Dict[str, Any],
                coarsen: int = _PSI_COARSEN) -> Dict[int, float]:
    """A value sketch state as coarse-bin relative frequencies (the
    fixed binning PSI compares)."""
    count = int(state.get("count", 0))
    if count <= 0:
        return {}
    out: Dict[int, float] = {}
    for k, v in (state.get("bins") or {}).items():
        b = int(k) // max(1, int(coarsen))
        out[b] = out.get(b, 0.0) + int(v) / count
    return out


def psi_value_states(ref: Dict[str, Any], live: Dict[str, Any]) -> float:
    return psi_from_freqs(value_freqs(ref), value_freqs(live))


def psi_categorical_states(ref: Dict[str, Any],
                           live: Dict[str, Any]) -> float:
    return psi_from_freqs(sketches.categorical_freqs(ref),
                          sketches.categorical_freqs(live))


# -- prequential accumulator -------------------------------------------------

def _empty_prequential() -> Dict[str, Any]:
    return {"n": 0, "correct": 0, "abs_err": 0.0, "sq_err": 0.0,
            "conf": [[0, 0, 0.0] for _ in range(_CAL_BINS)]}


def merge_prequential(states: Iterable[Dict[str, Any]]) -> Dict[str, Any]:
    """Sum prequential accumulators (commutative integer/float sums)."""
    out = _empty_prequential()
    for st in states:
        if not st:
            continue
        out["n"] += int(st.get("n", 0))
        out["correct"] += int(st.get("correct", 0))
        out["abs_err"] += float(st.get("abs_err", 0.0))
        out["sq_err"] += float(st.get("sq_err", 0.0))
        for i, row in enumerate((st.get("conf") or [])[:_CAL_BINS]):
            out["conf"][i][0] += int(row[0])
            out["conf"][i][1] += int(row[1])
            out["conf"][i][2] += float(row[2])
    return out


def prequential_accuracy(state: Dict[str, Any]) -> Optional[float]:
    n = int(state.get("n", 0))
    return int(state.get("correct", 0)) / n if n else None


def prequential_mae(state: Dict[str, Any]) -> Optional[float]:
    n = int(state.get("n", 0))
    return float(state.get("abs_err", 0.0)) / n if n else None


def calibration_ece(state: Dict[str, Any]) -> Optional[float]:
    """Expected calibration error: confidence-bin-weighted mean of
    |empirical accuracy - mean confidence|."""
    rows = state.get("conf") or []
    total = sum(int(r[0]) for r in rows)
    if not total:
        return None
    ece = 0.0
    for n, correct, conf_sum in rows:
        if not n:
            continue
        ece += (n / total) * abs(correct / n - conf_sum / n)
    return ece


def _softmax_confidence(ranked: Sequence) -> float:
    """Winner's softmax probability over the ranked (label, score) list
    — classifier margins are unnormalized, so calibration bins need a
    common [0, 1] scale."""
    scores = np.array([float(s) for _l, s in ranked], dtype=np.float64)
    scores -= scores.max()
    e = np.exp(scores)
    return float(e.max() / e.sum())


# -- the plane ---------------------------------------------------------------

#: distinct feature groups tracked before the long tail folds into one
#: overflow group (bounded memory under feature-name churn)
MAX_GROUPS = 32
OVERFLOW_GROUP = "__overflow__"
#: group name for the prediction-output sketch (per-prediction drift)
PREDICTIONS_GROUP = "predictions"
#: drift keys that track model OUTPUT distributions, not incoming
#: data: they publish under their own quality.drift.<key> gauges but
#: stay out of the quality.drift.max roll-up — a cold or still-
#: converging model swings its prediction mix between windows with
#: nothing wrong in the data, and an input-drift SLO must not page on
#: that (alarm these keys separately if prediction drift is an SLO in
#: its own right). Incoming feature groups AND the training-label
#: distribution stay in the roll-up: both are the data's business.
OUTPUT_DRIFT_KEYS = ("label_predictions", PREDICTIONS_GROUP)


def _input_drift_max(drift: Dict[str, float]) -> float:
    vals = [v for g, v in drift.items() if g not in OUTPUT_DRIFT_KEYS]
    return max(vals) if vals else 0.0


def group_of(name: str) -> str:
    """Feature-key → drift group: the leading run of the key before the
    first digit or separator (``ch0`` → ``ch``, ``user@str$tokyo`` →
    ``user``, ``age`` → ``age``) — per-feature-family granularity that
    stays bounded when keys carry per-row suffixes."""
    for j, ch in enumerate(name):
        if ch.isdigit() or ch in "@$/#:":
            return name[:j] or "other"
    return name or "other"


class QualityPlane:
    """Per-process data-quality recorder: bounded live-window sketches,
    a completed-window ring with a pinned reference, prequential and
    calibration accumulators, and the drift gauges the telemetry tick
    publishes. All entry points are thread-safe (one lock; record paths
    do O(sampled rows) work)."""

    def __init__(self, *, sample: float = 0.05, window_s: float = 60.0,
                 ref_windows: int = 2,
                 ring_capacity: int = sketches.DEFAULT_RING_CAPACITY,
                 registry: Any = None, max_score_rows: int = 8,
                 drift_min_count: int = DEFAULT_DRIFT_MIN_COUNT) -> None:
        self.sample = max(0.0, min(1.0, float(sample)))
        self.window_s = max(1.0, float(window_s))
        self.ref_windows = max(1, int(ref_windows))
        self.registry = registry
        self.max_score_rows = max(1, int(max_score_rows))
        self.drift_min_count = max(1, int(drift_min_count))
        self._lock = threading.Lock()
        self._gates: Dict[str, float] = {}
        self._groups: Dict[str, sketches.ValueSketch] = {}
        self._group_memo: Dict[str, str] = {}
        self._labels = sketches.CategoricalSketch()
        self._predictions = sketches.CategoricalSketch()
        self._preq_live = _empty_prequential()
        self._preq_total = _empty_prequential()
        self.ring = sketches.SnapshotRing(capacity=ring_capacity)
        self._ref_pending: List[Dict[str, Any]] = []
        #: stamped on the first tick (not at construction) so injected
        #: clocks in tests and replays behave
        self._live_started: Optional[float] = None
        self._drift: Dict[str, float] = {}
        self._trend: List[Dict[str, Any]] = []
        self._recorded_rows = 0
        self._scored_rows = 0

    # -- sampling gates ------------------------------------------------------
    def admit(self, gate: str) -> bool:
        """Deterministic stride sampler: admits ``sample`` of the calls
        on each gate (no RNG — replays stay replays)."""
        if self.sample <= 0.0:
            return False
        with self._lock:
            acc = self._gates.get(gate, 0.0) + self.sample
            if acc >= 1.0:
                self._gates[gate] = acc - 1.0
                return True
            self._gates[gate] = acc
            return False

    def arm(self, sample: Optional[float] = None,
            now: Optional[float] = None) -> None:
        """(Re)arm the recorder mid-flight: optionally change the
        sample rate, restart the live-window clock at ``now`` and drop
        whatever the old rate recorded mid-window — so the NEXT roll
        covers exactly one window of post-arm traffic. Operators (and
        the bench drills) toggling the plane on a warm server want the
        first window to start when real traffic does; a stale window
        start would pin a seconds-short, unrepresentative reference.
        A reference already pinned survives re-arming (it is still the
        agreed baseline); prequential totals survive too."""
        with self._lock:
            if sample is not None:
                self.sample = max(0.0, min(1.0, float(sample)))
            self._live_started = time.time() if now is None \
                else float(now)
            self._groups = {}
            self._labels = sketches.CategoricalSketch()
            self._predictions = sketches.CategoricalSketch()
            self._preq_live = _empty_prequential()

    # -- recording -----------------------------------------------------------
    def _group_sketch(self, group: str) -> sketches.ValueSketch:
        sk = self._groups.get(group)
        if sk is None:
            if len(self._groups) >= MAX_GROUPS:
                group = OVERFLOW_GROUP
                sk = self._groups.get(group)
                if sk is None:
                    sk = self._groups[group] = sketches.ValueSketch()
                return sk
            sk = self._groups[group] = sketches.ValueSketch()
        return sk

    def record_named(self, names: Sequence[str], values: Any) -> None:
        """The batched-FV hook (core/fv/converter.convert_batch): one
        flat (feature name, value) batch, self-sampled. Group codes come
        from a memo dict (hot key sets repeat), bucketing is one
        vectorized pass per touched group."""
        if not self.admit("fv") or not len(names):
            return
        vals = np.asarray(values, dtype=np.float64).ravel()
        memo = self._group_memo
        codes = []
        for nm in names:
            g = memo.get(nm)
            if g is None:
                if len(memo) >= 4096:
                    memo.clear()
                g = memo[nm] = group_of(nm)
            codes.append(g)
        with self._lock:
            arr = np.asarray(codes)
            for g in dict.fromkeys(codes):
                self._group_sketch(g).observe_array(vals[arr == g])
            self._recorded_rows += int(vals.size)
        reg = self.registry
        if reg is not None:
            reg.count("quality.recorded_values", int(vals.size))

    def record_hashed(self, values: Any) -> None:
        """Raw-ingest hook (native fast path): feature names never
        materialize there, so the post-hash value distribution records
        under one ``hashed`` group."""
        vals = np.asarray(values, dtype=np.float64).ravel()
        if vals.size == 0:
            return
        with self._lock:
            self._group_sketch("hashed").observe_array(vals)
            self._recorded_rows += int(vals.size)
        reg = self.registry
        if reg is not None:
            reg.count("quality.recorded_values", int(vals.size))

    def record_labels(self, labels: Iterable[Any]) -> None:
        with self._lock:
            self._labels.observe_many(str(x) for x in labels)

    def record_classified(self, truth: str, ranked: Sequence) -> None:
        """One prequential classifier observation: ``ranked`` is the
        CURRENT model's (label, score) list for a datum about to be
        trained on."""
        if not ranked:
            return
        pred, _score = max(ranked, key=lambda kv: float(kv[1]))
        conf = _softmax_confidence(ranked)
        correct = 1 if str(pred) == str(truth) else 0
        b = min(_CAL_BINS - 1, int(conf * _CAL_BINS))
        with self._lock:
            for st in (self._preq_live, self._preq_total):
                st["n"] += 1
                st["correct"] += correct
                st["conf"][b][0] += 1
                st["conf"][b][1] += correct
                st["conf"][b][2] += conf
            self._predictions.observe(str(pred))
            self._scored_rows += 1
        reg = self.registry
        if reg is not None:
            reg.count("quality.scored_rows")

    def record_estimated(self, truth: float, predicted: float) -> None:
        """One prequential regression observation (current-model
        estimate vs the incoming target)."""
        err = abs(float(predicted) - float(truth))
        with self._lock:
            for st in (self._preq_live, self._preq_total):
                st["n"] += 1
                st["abs_err"] += err
                st["sq_err"] += err * err
            self._group_sketch(PREDICTIONS_GROUP).observe(float(predicted))
            self._scored_rows += 1
        reg = self.registry
        if reg is not None:
            reg.count("quality.scored_rows")

    # -- windowing + drift ---------------------------------------------------
    def _live_doc_locked(self) -> Dict[str, Any]:
        return {
            "features": {g: sk.state() for g, sk in self._groups.items()},
            "labels": self._labels.state(),
            "predictions": self._predictions.state(),
            "prequential": dict(self._preq_live,
                                conf=[list(r)
                                      for r in self._preq_live["conf"]]),
            "started": self._live_started or 0.0,
        }

    def _roll_locked(self, now: float) -> None:
        doc = self._live_doc_locked()
        doc["ts"] = now
        self.ring.push(doc, now)
        if self.ring.reference is None:
            self._ref_pending.append(doc)
            if len(self._ref_pending) >= self.ref_windows:
                self.ring.pin_reference(
                    merge_window_docs(self._ref_pending), now)
                self._ref_pending = []
        self._groups = {}
        self._labels = sketches.CategoricalSketch()
        self._predictions = sketches.CategoricalSketch()
        self._preq_live = _empty_prequential()
        self._live_started = now

    def _live_count_locked(self) -> int:
        return sum(sk.count for sk in self._groups.values())

    def tick(self, now: Optional[float] = None) -> Dict[str, float]:
        """One telemetry tick: roll the live window when due, recompute
        drift against the pinned reference, publish the quality gauges
        into the registry, and append the trend point. Returns the
        gauge dict (tests read it directly)."""
        now = time.time() if now is None else float(now)
        with self._lock:
            if self._live_started is None:
                self._live_started = now
            if now - self._live_started >= self.window_s and \
                    (self._live_count_locked() or self._preq_live["n"] or
                     self._labels.total):
                self._roll_locked(now)
            ref = self.ring.reference
            # score COMPLETED windows only: a partial live window reads
            # spiky against a full reference (few distinct rows early
            # in the window — zipf traffic makes this brutal), and a
            # gauge that pages must not ride window-phase noise.
            # Detection cost: at most one window plus one tick.
            live = self.ring.newest()
            drift: Dict[str, float] = {}
            if ref is not None and live is not None:
                for g, st in (live.get("features") or {}).items():
                    rst = (ref.get("features") or {}).get(g)
                    if rst is None or int(st.get("count", 0)) < \
                            self.drift_min_count:
                        continue
                    drift[g] = round(psi_value_states(rst, st), 4)
                if int((live.get("labels") or {}).get("total", 0)) >= \
                        self.drift_min_count and \
                        int((ref.get("labels") or {}).get("total", 0)):
                    drift["labels"] = round(psi_categorical_states(
                        ref["labels"], live["labels"]), 4)
                rp = ref.get("predictions") or {}
                lp = live.get("predictions") or {}
                if int(lp.get("total", 0)) >= self.drift_min_count and \
                        int(rp.get("total", 0)):
                    drift["label_predictions"] = round(
                        psi_categorical_states(rp, lp), 4)
            self._drift = drift
            total = self._preq_total
            acc = prequential_accuracy(total)
            mae = prequential_mae(total)
            ece = calibration_ece(total)
            point = {"ts": round(now, 3),
                     "drift_max": _input_drift_max(drift),
                     "accuracy": acc, "mae": mae}
            self._trend.append(point)
            del self._trend[:-120]
        gauges: Dict[str, float] = {}
        for g, v in drift.items():
            gauges[f"quality.drift.{g}"] = v
        gauges["quality.drift.max"] = _input_drift_max(drift)
        if acc is not None:
            gauges["quality.prequential.accuracy"] = round(acc, 4)
            gauges["quality.prequential.error_rate"] = round(1.0 - acc, 4)
        if mae is not None:
            gauges["quality.prequential.mae"] = round(mae, 6)
        if ece is not None:
            gauges["quality.calibration.ece"] = round(ece, 4)
        reg = self.registry
        if reg is not None:
            for g, v in drift.items():
                reg.gauge(f"quality.drift.{g}", v)
            reg.gauge("quality.drift.max", gauges["quality.drift.max"])
            if acc is not None:
                reg.gauge("quality.prequential.accuracy", round(acc, 4))
                reg.gauge("quality.prequential.error_rate",
                          round(1.0 - acc, 4))
            if mae is not None:
                reg.gauge("quality.prequential.mae", round(mae, 6))
            if ece is not None:
                reg.gauge("quality.calibration.ece", round(ece, 4))
        return gauges

    def drift_scores(self) -> Dict[str, float]:
        with self._lock:
            return dict(self._drift)

    # -- views ---------------------------------------------------------------
    def snapshot(self) -> Dict[str, Any]:
        """This node's mergeable quality doc — the ``get_quality`` RPC
        payload (reference + live sketch states, prequential totals,
        drift scores, trend)."""
        with self._lock:
            live = self._live_doc_locked()
            live["ts"] = time.time()
            ref = self.ring.reference
            return {
                "sample": self.sample,
                "window_s": self.window_s,
                "reference": ref,
                "reference_ts": self.ring.reference_ts,
                "live": live,
                "drift": dict(self._drift),
                "prequential": dict(self._preq_total,
                                    conf=[list(r) for r in
                                          self._preq_total["conf"]]),
                "trend": list(self._trend),
                "stats": dict(self.ring.stats(),
                              recorded_rows=self._recorded_rows,
                              scored_rows=self._scored_rows,
                              groups=len(self._groups)),
            }

    def incident_doc(self) -> Dict[str, Any]:
        """The forensic slice an incident bundle captures: the top
        drifting group NAMED, with its reference/live sketch pair."""
        with self._lock:
            drift = dict(self._drift)
            # name the worst INPUT group when any input drifted — the
            # bundle's headline is "which data went bad", model-output
            # keys only lead when they are the only thing moving
            pool = {g: v for g, v in drift.items()
                    if g not in OUTPUT_DRIFT_KEYS} or drift
            top = max(pool.items(), key=lambda kv: kv[1])[0] if pool \
                else ""
            ref = self.ring.reference or {}
            live = self._live_doc_locked() \
                if self._live_count_locked() else (self.ring.newest() or {})
            doc: Dict[str, Any] = {"drift": drift, "top_drift_group": top}
            if top:
                if top in ("labels", "label_predictions"):
                    key = "labels" if top == "labels" else "predictions"
                    doc["reference_sketch"] = ref.get(key)
                    doc["live_sketch"] = live.get(key)
                else:
                    doc["reference_sketch"] = \
                        (ref.get("features") or {}).get(top)
                    doc["live_sketch"] = \
                        (live.get("features") or {}).get(top)
            acc = prequential_accuracy(self._preq_total)
            if acc is not None:
                doc["prequential_accuracy"] = round(acc, 4)
            return doc

    def stats(self) -> Dict[str, Any]:
        """Flat stat rows for get_status (``quality.*`` keys)."""
        with self._lock:
            drift = dict(self._drift)
            out = {
                "sample": self.sample,
                "window_s": self.window_s,
                "groups": len(self._groups),
                "recorded_rows": self._recorded_rows,
                "scored_rows": self._scored_rows,
                "drift_max": _input_drift_max(drift),
                "reference_pinned": self.ring.reference is not None,
                "windows": self.ring.stats()["pushed"],
            }
            acc = prequential_accuracy(self._preq_total)
            if acc is not None:
                out["prequential_accuracy"] = round(acc, 4)
            mae = prequential_mae(self._preq_total)
            if mae is not None:
                out["prequential_mae"] = round(mae, 6)
            return out


# -- fleet folds -------------------------------------------------------------

def merge_window_docs(docs: Sequence[Dict[str, Any]]) -> Dict[str, Any]:
    """Merge window docs ({features, labels, predictions, prequential})
    sketch-wise — the reference pin and the cross-node fold share it."""
    feats: Dict[str, List[Dict[str, Any]]] = {}
    labels: List[Dict[str, Any]] = []
    preds: List[Dict[str, Any]] = []
    preqs: List[Dict[str, Any]] = []
    ts = 0.0
    for d in docs:
        if not d:
            continue
        for g, st in (d.get("features") or {}).items():
            feats.setdefault(g, []).append(st)
        if d.get("labels"):
            labels.append(d["labels"])
        if d.get("predictions"):
            preds.append(d["predictions"])
        if d.get("prequential"):
            preqs.append(d["prequential"])
        ts = max(ts, float(d.get("ts", 0.0)))
    return {
        "features": {g: sketches.merge_value_states(sts)
                     for g, sts in feats.items()},
        "labels": sketches.merge_categorical_states(labels),
        "predictions": sketches.merge_categorical_states(preds),
        "prequential": merge_prequential(preqs),
        "ts": ts,
    }


def merge_quality(docs: Sequence[Dict[str, Any]]) -> Dict[str, Any]:
    """Fold per-node ``get_quality`` docs into one fleet view: merge
    reference and live sketches group-wise, RECOMPUTE drift from the
    merged pair (that is what mergeable sketches buy — fleet drift is
    exact, not an average of node scores), sum prequential totals."""
    live_docs = [d.get("live") for d in docs if d and d.get("live")]
    ref_docs = [d.get("reference") for d in docs if d and d.get("reference")]
    live = merge_window_docs(live_docs) if live_docs else {}
    ref = merge_window_docs(ref_docs) if ref_docs else {}
    drift: Dict[str, float] = {}
    for g, st in (live.get("features") or {}).items():
        rst = (ref.get("features") or {}).get(g)
        if rst is not None and int(st.get("count", 0)):
            drift[g] = round(psi_value_states(rst, st), 4)
    if int((live.get("labels") or {}).get("total", 0)) and \
            int((ref.get("labels") or {}).get("total", 0)):
        drift["labels"] = round(
            psi_categorical_states(ref["labels"], live["labels"]), 4)
    # nodes mid-window ship empty live sketches; their last COMPUTED
    # drift scores still describe the fleet, so fold them in (per-key
    # max) wherever the merged-sketch recompute had no data
    recomputed = set(drift)
    for d in docs:
        for g, v in ((d or {}).get("drift") or {}).items():
            if g not in recomputed:
                drift[g] = max(float(v), drift.get(g, 0.0))
    preq = merge_prequential(
        [d.get("prequential") for d in docs if d])
    trend: List[Dict[str, Any]] = []
    for d in docs:
        if d:
            trend.extend(d.get("trend") or [])
    trend.sort(key=lambda p: p.get("ts", 0.0))
    return {
        "nodes": len([d for d in docs if d]),
        "reference": ref,
        "live": live,
        "drift": drift,
        "prequential": preq,
        "trend": trend[-240:],
        "sample": max([float(d.get("sample", 0.0)) for d in docs if d],
                      default=0.0),
    }
