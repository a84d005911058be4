"""Bounded mergeable streaming sketches (copy of
``jubatus_tpu/utils/sketches.py``).

The data-quality plane needs distribution summaries that are (a) bounded
— a fixed few KB per tracked group no matter how many values stream
through, (b) *mergeable* — fold across microbatches, windows, and fleet
nodes with ``merge(a, b) == merge(b, a)`` so the proxy's ``get_quality``
broadcast+fold is exact, and (c) cheap to record — vectorized numpy on
the batched FV path. Three primitives:

- :class:`ValueSketch` — log-bucket quantile sketch over SIGNED reals,
  reusing the span histograms' geometry (utils/tracing.py: quarter-octave
  log2 buckets spanning 2^-20..2^7 plus overflow). The signed domain is
  three ranges laid end to end: negative magnitudes descending, an
  exact-zero bin, positive magnitudes ascending — 219 bins total, so a
  bucket-frequency comparison (PSI/KL in utils/quality.py) and a
  quantile walk both read one dense int array.
- :class:`CategoricalSketch` — count-min (fixed ``depth x width``
  counter matrix, seeded crc32 row hashes: deterministic across
  processes, so matrices merge element-wise) + a top-k heavy-hitter
  dict re-estimated from the matrix on merge. Bounded under arbitrary
  label/category cardinality churn.
- :class:`SnapshotRing` — windowed reference-vs-live snapshots ringed
  like utils/timeseries.py: completed window docs in a bounded deque,
  plus a PINNED reference doc (the drift baseline) that survives ring
  eviction.

States are plain dicts of ints/floats/strings (sparse where it pays) so
they ride msgpack verbatim, exactly like tracing histogram states.
"""

from __future__ import annotations

import zlib
from collections import deque
from typing import Any, Dict, Iterable, List, Optional, Tuple

import numpy as np

# -- signed log-bucket geometry (mirrors tracing's quarter-octave grid) ------

_LOG2_MIN = -20          # |v| at/below 2^-20 lands in magnitude bucket 0
_SUB = 4                 # quarter-octave: 4 buckets per power of two
_OCTAVES = 27            # top finite bound 2^7
_OVERFLOW = _SUB * _OCTAVES   # = 108: |v| >= 2^7 magnitude bucket
_NMAG = _OVERFLOW + 1    # 109 magnitude buckets per sign

#: zero bin index; negatives occupy [0, 108] (most negative first),
#: positives [110, 218] — the bins are ordered along the real line
ZERO_BIN = _NMAG
NBINS = 2 * _NMAG + 1    # 219

#: magnitude-bucket upper bounds (inclusive, like tracing._BOUNDS)
_BOUNDS = np.array([2.0 ** (_LOG2_MIN + (i + 1) / _SUB)
                    for i in range(_OVERFLOW)])
#: geometric midpoint multiplier below a bucket's upper bound
_MID = 2.0 ** (-0.5 / _SUB)
#: representative value per magnitude bucket (overflow pegged above top)
_REPS = np.concatenate([_BOUNDS * _MID, [2.0 ** (_LOG2_MIN + _OCTAVES + 1)]])


def _mag_buckets(a: np.ndarray) -> np.ndarray:
    """Vectorized magnitude bucket (a > 0): smallest i with bound >= a —
    the same inclusive-upper-bound rule as tracing.bucket_index."""
    with np.errstate(divide="ignore"):
        i = np.ceil((np.log2(a) - _LOG2_MIN) * _SUB) - 1
    return np.clip(i, 0, _OVERFLOW).astype(np.int64)


def value_bins(values: np.ndarray) -> np.ndarray:
    """Signed bin per value: one vectorized pass, NaNs dropped by the
    caller (``ValueSketch.observe_array`` masks them)."""
    v = np.asarray(values, dtype=np.float64)
    out = np.full(v.shape, ZERO_BIN, dtype=np.int64)
    pos = v > 0.0
    neg = v < 0.0
    if pos.any():
        out[pos] = ZERO_BIN + 1 + _mag_buckets(v[pos])
    if neg.any():
        out[neg] = _OVERFLOW - _mag_buckets(-v[neg])
    return out


def value_bin(v: float) -> int:
    """Scalar signed bin (tests + single observations)."""
    return int(value_bins(np.array([v]))[0])


def bin_rep(i: int) -> float:
    """Representative real value of bin ``i`` (quantile reporting)."""
    if i == ZERO_BIN:
        return 0.0
    if i > ZERO_BIN:
        return float(_REPS[i - ZERO_BIN - 1])
    return -float(_REPS[_OVERFLOW - i])


class ValueSketch:
    """Bounded signed-value quantile sketch: one dense int64 bin array
    (219 entries, ~2 KB) + count/sum/min/max moments."""

    __slots__ = ("bins", "count", "sum", "min", "max")

    def __init__(self) -> None:
        self.bins = np.zeros(NBINS, dtype=np.int64)
        self.count = 0
        self.sum = 0.0
        self.min = float("inf")
        self.max = float("-inf")

    def observe_array(self, values: np.ndarray) -> int:
        """Record every finite value of ``values`` (vectorized); returns
        the number recorded."""
        v = np.asarray(values, dtype=np.float64).ravel()
        if v.size == 0:
            return 0
        finite = np.isfinite(v)
        if not finite.all():
            v = v[finite]
            if v.size == 0:
                return 0
        np.add.at(self.bins, value_bins(v), 1)
        self.count += int(v.size)
        self.sum += float(v.sum())
        self.min = min(self.min, float(v.min()))
        self.max = max(self.max, float(v.max()))
        return int(v.size)

    def observe(self, value: float) -> None:
        self.observe_array(np.array([value]))

    def state(self) -> Dict[str, Any]:
        """Sparse mergeable state (msgpack-ready, like tracing hist
        states): only occupied bins ship."""
        nz = np.flatnonzero(self.bins)
        return {
            "bins": {int(i): int(self.bins[i]) for i in nz},
            "count": int(self.count),
            "sum": float(self.sum),
            "min": float(self.min) if self.count else 0.0,
            "max": float(self.max) if self.count else 0.0,
        }


def merge_value_states(states: Iterable[Dict[str, Any]]) -> Dict[str, Any]:
    """Fold sketch states bin-wise; commutative and associative (integer
    sums + min/max), so fleet folds are order-independent."""
    bins: Dict[int, int] = {}
    count = 0
    total = 0.0
    vmin, vmax = float("inf"), float("-inf")
    for st in states:
        if not st:
            continue
        for k, v in (st.get("bins") or {}).items():
            i = int(k)  # msgpack map keys may arrive as strings
            bins[i] = bins.get(i, 0) + int(v)
        c = int(st.get("count", 0))
        count += c
        total += float(st.get("sum", 0.0))
        if c:
            vmin = min(vmin, float(st.get("min", 0.0)))
            vmax = max(vmax, float(st.get("max", 0.0)))
    return {"bins": bins, "count": count, "sum": total,
            "min": vmin if count else 0.0, "max": vmax if count else 0.0}


def value_quantile(state: Dict[str, Any], q: float) -> Optional[float]:
    """Quantile at bin resolution: walk the signed bins in real-line
    order, return the target bin's representative value clamped into
    the observed [min, max]."""
    count = int(state.get("count", 0))
    if count <= 0:
        return None
    target = max(0.0, min(1.0, q)) * count
    seen = 0
    items = sorted((int(k), int(v))
                   for k, v in (state.get("bins") or {}).items())
    for i, n in items:
        seen += n
        if seen >= target:
            rep = bin_rep(i)
            return float(min(max(rep, state.get("min", rep)),
                             state.get("max", rep)))
    return float(state.get("max", 0.0))


# -- categorical frequencies: count-min + top-k ------------------------------

DEFAULT_CMS_WIDTH = 512
DEFAULT_CMS_DEPTH = 4
DEFAULT_TOPK = 16


def _row_hash(item: str, seed: int, width: int) -> int:
    """Deterministic per-row hash: crc32 with a seed prefix — identical
    across processes, so fleet-wide matrices index the same cells."""
    return zlib.crc32(b"%d\x00%s" % (seed, item.encode("utf-8"))) % width


class CategoricalSketch:
    """Bounded label/category frequency sketch: count-min matrix (exact
    element-wise merge) + a top-k heavy-hitter dict whose estimates come
    from the matrix — the dict is a cache, the matrix is the truth, so
    merges re-derive the dict and stay commutative."""

    __slots__ = ("width", "depth", "k", "rows", "total", "topk")

    def __init__(self, width: int = DEFAULT_CMS_WIDTH,
                 depth: int = DEFAULT_CMS_DEPTH,
                 k: int = DEFAULT_TOPK) -> None:
        self.width = int(width)
        self.depth = int(depth)
        self.k = int(k)
        self.rows = np.zeros((self.depth, self.width), dtype=np.int64)
        self.total = 0
        self.topk: Dict[str, int] = {}

    def _estimate(self, item: str) -> int:
        return int(min(self.rows[d][_row_hash(item, d, self.width)]
                       for d in range(self.depth)))

    def observe(self, item: str, n: int = 1) -> None:
        for d in range(self.depth):
            self.rows[d][_row_hash(item, d, self.width)] += n
        self.total += n
        est = self._estimate(item)
        if item in self.topk or len(self.topk) < self.k:
            self.topk[item] = est
            return
        worst = min(self.topk.items(), key=lambda kv: (kv[1], kv[0]))
        if est > worst[1]:
            del self.topk[worst[0]]
            self.topk[item] = est

    def observe_many(self, items: Iterable[str]) -> None:
        for it in items:
            self.observe(str(it))

    def state(self) -> Dict[str, Any]:
        return {
            "width": self.width, "depth": self.depth, "k": self.k,
            "rows": [row.tolist() for row in self.rows],
            "total": int(self.total),
            "topk": {k: int(v) for k, v in self.topk.items()},
        }


def merge_categorical_states(
        states: Iterable[Dict[str, Any]]) -> Dict[str, Any]:
    """Element-wise matrix sum + top-k re-derivation from the MERGED
    matrix over the union of candidate items — commutative by
    construction (deterministic tie-break on the item string)."""
    acc: Optional[np.ndarray] = None
    width = DEFAULT_CMS_WIDTH
    depth = DEFAULT_CMS_DEPTH
    k = DEFAULT_TOPK
    total = 0
    candidates: set = set()
    for st in states:
        if not st or not st.get("rows"):
            continue
        rows = np.asarray(st["rows"], dtype=np.int64)
        if acc is None:
            acc = rows.copy()
            width = int(st.get("width", rows.shape[1]))
            depth = int(st.get("depth", rows.shape[0]))
            k = int(st.get("k", DEFAULT_TOPK))
        elif rows.shape == acc.shape:
            acc += rows
        else:
            continue  # geometry mismatch: skip rather than corrupt
        total += int(st.get("total", 0))
        candidates.update((st.get("topk") or {}).keys())
    if acc is None:
        return {"width": width, "depth": depth, "k": k,
                "rows": [], "total": 0, "topk": {}}
    est = {item: int(min(acc[d][_row_hash(item, d, width)]
                         for d in range(depth)))
           for item in candidates}
    top = sorted(est.items(), key=lambda kv: (-kv[1], kv[0]))[:k]
    return {"width": width, "depth": depth, "k": k,
            "rows": [row.tolist() for row in acc],
            "total": total, "topk": dict(top)}


def categorical_freqs(state: Dict[str, Any]) -> Dict[str, float]:
    """Top-k relative frequencies + the residual tail mass under
    ``__other__`` — the fixed-support distribution PSI compares."""
    total = int(state.get("total", 0))
    if total <= 0:
        return {}
    out = {str(k): int(v) / total
           for k, v in (state.get("topk") or {}).items()}
    other = 1.0 - sum(out.values())
    if other > 1e-9:
        out["__other__"] = other
    return out


# -- windowed reference-vs-live ring -----------------------------------------

DEFAULT_RING_CAPACITY = 48


class SnapshotRing:
    """Bounded ring of completed-window snapshot docs plus one PINNED
    reference doc (the drift baseline): the live window compares against
    the reference long after the reference's windows left the ring —
    the same shape as utils/timeseries.TimeSeriesRing, minus deltas
    (sketch windows are already per-window, not cumulative)."""

    def __init__(self, capacity: int = DEFAULT_RING_CAPACITY) -> None:
        self.capacity = max(2, int(capacity))
        self._ring: deque = deque(maxlen=self.capacity)
        self._pushed = 0
        self.reference: Optional[Dict[str, Any]] = None
        self.reference_ts = 0.0

    def push(self, doc: Dict[str, Any], ts: float) -> None:
        self._ring.append({"ts": float(ts), "doc": doc})
        self._pushed += 1

    def pin_reference(self, doc: Dict[str, Any], ts: float) -> None:
        self.reference = doc
        self.reference_ts = float(ts)

    def newest(self) -> Optional[Dict[str, Any]]:
        return self._ring[-1]["doc"] if self._ring else None

    def points(self, last: int = 0) -> List[Dict[str, Any]]:
        out = list(self._ring)
        return out[-last:] if last > 0 else out

    def stats(self) -> Dict[str, Any]:
        return {"pushed": self._pushed, "retained": len(self._ring),
                "capacity": self.capacity,
                "reference_pinned": self.reference is not None,
                "reference_ts": self.reference_ts}


# -- shared helpers ----------------------------------------------------------

def top_bins(state: Dict[str, Any], n: int = 8) -> List[Tuple[float, int]]:
    """The ``n`` heaviest (representative_value, count) pairs of a value
    state — the compact sketch rendering jubactl tables use."""
    items = sorted(((int(k), int(v))
                    for k, v in (state.get("bins") or {}).items()),
                   key=lambda kv: -kv[1])[:n]
    return [(bin_rep(i), c) for i, c in items]
