"""Config-driven datum → weighted sparse feature vector (copy of
``jubatus_tpu/core/fv/converter.py``).

Implements the converter JSON schema of every engine config in the
reference: string/num filter types+rules, string/num types+rules,
combination types+rules, ``dynamic`` (plugin) string, num and binary
types with binary rules, sample weights (bin/tf/log_tf) and global
weights (bin/idf/weight). The feature names, hashing and weights are the
JAX package's, so both packages turn a datum into the same
``SparseVector``:

  string features:  "<key>$<value>@<type>#<sample_weight>/<global_weight>"
  num features:     "<key>@num" / "<key>@log" / "<key>$<value>@str"
  combinations:     "<left>&<right>"

Two entry points: ``convert`` (per datum) and ``convert_batch`` (the
batch path: memoized filters and tokenization, one hash sweep, vectorized
global weights, CSR output). ``convert_named`` serves the weight engine
and ``revert_feature`` the recommender's ``complete_row_*``.

Plugin ("dynamic") types — the reference's dlopen'd mecab/ux/image plugins
— load by path through ``core/fv/plugins.py``: a bare name against
``jubatus_tpu_torch/plugins/``, a ``.so`` through the ``jt_splitter_*`` C
ABI. A plugin that fails to load raises
``ConverterError``.

The memo caches (``--fv-cache-size``) hold weight-independent facts only
and count their hits and misses (``memo_stats``); rejected non-finite num
values count into ``fv.nonfinite_rejected`` of the process's default
tracing registry; ``quality_hook`` sees every ``convert_batch``.
"""

from __future__ import annotations

import math
import re
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np

from jubatus_tpu_torch.core.datum import Datum
from jubatus_tpu_torch.core.fv.hashing import FeatureHasher
from jubatus_tpu_torch.core.fv.weight_manager import WeightManager
from jubatus_tpu_torch.core.sparse import CSRBatch, SparseVector


def _count_nonfinite(n: int) -> None:
    """Count ingest-rejected non-finite num values into the process
    default registry: ``trace.counter.fv.nonfinite_rejected`` in every
    server's get_status and on /metrics."""
    from jubatus_tpu_torch.utils import tracing

    tracing.default_registry().count("fv.nonfinite_rejected", n)


class ConverterError(ValueError):
    pass


# ---------------------------------------------------------------------------
# key matchers: "*" all, "prefix*", "*suffix", exact
# ---------------------------------------------------------------------------
def make_key_matcher(pattern: str) -> Callable[[str], bool]:
    if pattern == "*":
        return lambda key: True
    if pattern.endswith("*"):
        prefix = pattern[:-1]
        return lambda key: key.startswith(prefix)
    if pattern.startswith("*"):
        suffix = pattern[1:]
        return lambda key: key.endswith(suffix)
    return lambda key: key == pattern


# ---------------------------------------------------------------------------
# string splitters
# ---------------------------------------------------------------------------
Splitter = Callable[[str], List[str]]


def _split_whole(text: str) -> List[str]:
    return [text] if text else []


def _split_space(text: str) -> List[str]:
    return text.split()


def _make_ngram(char_num: int) -> Splitter:
    def split(text: str) -> List[str]:
        return [text[i : i + char_num] for i in range(len(text) - char_num + 1)]

    return split


def _make_regexp_splitter(pattern: str, group: int) -> Splitter:
    rx = re.compile(pattern)

    def split(text: str) -> List[str]:
        return [m.group(group) for m in rx.finditer(text)]

    return split


def _build_string_type(name: str, params: Dict[str, str]) -> Splitter:
    method = params.get("method")
    if method == "ngram":
        char_num = int(params.get("char_num", "1"))
        if char_num < 1:
            raise ConverterError(f"ngram char_num must be >= 1: {char_num}")
        return _make_ngram(char_num)
    if method == "regexp":
        return _make_regexp_splitter(params["pattern"], int(params.get("group", "0")))
    if method == "dynamic":
        # loaded by path: the so_factory dlopen path (plugins.py)
        if params.get("path"):
            from jubatus_tpu_torch.core.fv.plugins import load_string_plugin

            return load_string_plugin(params)
        raise ConverterError(
            "unknown dynamic string type plugin: "
            f"{params.get('function') or ''!r}")
    raise ConverterError(f"unknown string type method {method!r} for {name!r}")


# ---------------------------------------------------------------------------
# filters
# ---------------------------------------------------------------------------
def _build_string_filter(params: Dict[str, str]) -> Callable[[str], str]:
    method = params.get("method")
    if method == "regexp":
        rx = re.compile(params["pattern"])
        replace = params.get("replace", "")
        return lambda text: rx.sub(replace, text)
    raise ConverterError(f"unknown string filter method {method!r}")


def _build_num_filter(params: Dict[str, str]) -> Callable[[float], float]:
    method = params.get("method")
    if method == "add":
        value = float(params["value"])
        return lambda x: x + value
    if method == "linear_normalization":
        lo, hi = float(params["min"]), float(params["max"])
        if hi <= lo:
            raise ConverterError("linear_normalization requires max > min")
        return lambda x: (min(max(x, lo), hi) - lo) / (hi - lo)
    if method == "gaussian_normalization":
        mean = float(params["average"])
        std = float(params["standard_deviation"])
        if std <= 0:
            raise ConverterError("gaussian_normalization requires positive stddev")
        return lambda x: (x - mean) / std
    if method == "sigmoid_normalization":
        gain, bias = float(params["gain"]), float(params["bias"])
        return lambda x: 1.0 / (1.0 + math.exp(-gain * (x - bias)))
    raise ConverterError(f"unknown num filter method {method!r}")


# ---------------------------------------------------------------------------
# config
# ---------------------------------------------------------------------------
class StringRule:
    def __init__(self, key: str, type_name: str, sample_weight: str, global_weight: str):
        self.matcher = make_key_matcher(key)
        self.type_name = type_name
        if sample_weight not in ("bin", "tf", "log_tf"):
            raise ConverterError(f"unknown sample_weight {sample_weight!r}")
        if global_weight not in ("bin", "idf", "weight"):
            raise ConverterError(f"unknown global_weight {global_weight!r}")
        self.sample_weight = sample_weight
        self.global_weight = global_weight


class NumRule:
    def __init__(self, key: str, type_name: str):
        self.matcher = make_key_matcher(key)
        self.type_name = type_name


class FilterRule:
    def __init__(self, key: str, type_name: str, suffix: str):
        self.matcher = make_key_matcher(key)
        self.type_name = type_name
        self.suffix = suffix


class CombinationRule:
    def __init__(self, key_left: str, key_right: str, type_name: str):
        self.match_left = make_key_matcher(key_left)
        self.match_right = make_key_matcher(key_right)
        self.type_name = type_name


class ConverterConfig:
    """Parsed "converter" block of an engine config JSON."""

    def __init__(self, raw: Optional[dict] = None):
        raw = raw or {}
        self.raw = raw

        self.string_types: Dict[str, Splitter] = {
            "str": _split_whole,
            "space": _split_space,
        }
        for name, params in (raw.get("string_types") or {}).items():
            self.string_types[name] = _build_string_type(name, params)

        self.string_filters: Dict[str, Callable[[str], str]] = {}
        for name, params in (raw.get("string_filter_types") or {}).items():
            self.string_filters[name] = _build_string_filter(params)

        self.num_filters: Dict[str, Callable[[float], float]] = {}
        for name, params in (raw.get("num_filter_types") or {}).items():
            self.num_filters[name] = _build_num_filter(params)

        # built-in num types: num / log / str; "dynamic" via registry
        self.num_types: Dict[str, str] = {"num": "num", "log": "log", "str": "str"}
        self.num_type_fns: Dict[str, Callable] = {}
        for name, params in (raw.get("num_types") or {}).items():
            method = params.get("method")
            if method == "dynamic":
                if not params.get("path"):
                    raise ConverterError(
                        "unknown dynamic num type plugin: "
                        f"{params.get('function') or ''!r}")
                from jubatus_tpu_torch.core.fv.plugins import load_feature_plugin

                self.num_type_fns[name] = load_feature_plugin(params)
            elif method in ("num", "log", "str"):
                self.num_types[name] = method
            else:
                raise ConverterError(f"unknown num type method {method!r}")

        # binary types are dynamic plugins only (the reference's sole binary
        # consumer is the image_feature plugin, plugin/src/fv_converter)
        self.binary_type_fns: Dict[str, Callable] = {}
        for name, params in (raw.get("binary_types") or {}).items():
            if params.get("method") != "dynamic" or not params.get("path"):
                raise ConverterError(
                    f"binary type {name!r}: only dynamic plugins supported")
            from jubatus_tpu_torch.core.fv.plugins import load_feature_plugin

            self.binary_type_fns[name] = load_feature_plugin(params)

        self.string_rules = [
            StringRule(
                r["key"],
                r["type"],
                r.get("sample_weight", "bin"),
                r.get("global_weight", "bin"),
            )
            for r in (raw.get("string_rules") or [])
        ]
        self.num_rules = [NumRule(r["key"], r["type"]) for r in (raw.get("num_rules") or [])]
        self.string_filter_rules = [
            FilterRule(r["key"], r["type"], r["suffix"])
            for r in (raw.get("string_filter_rules") or [])
        ]
        self.num_filter_rules = [
            FilterRule(r["key"], r["type"], r["suffix"])
            for r in (raw.get("num_filter_rules") or [])
        ]
        self.binary_rules = [
            NumRule(r["key"], r["type"]) for r in (raw.get("binary_rules") or [])
        ]
        # combination types: built-ins mul/add, or named with method mul/add
        self.combination_types: Dict[str, str] = {"mul": "mul", "add": "add"}
        for name, params in (raw.get("combination_types") or {}).items():
            method = params.get("method")
            if method not in ("mul", "add"):
                raise ConverterError(f"unknown combination method {method!r}")
            self.combination_types[name] = method
        self.combination_rules = [
            CombinationRule(r["key_left"], r["key_right"], r["type"])
            for r in (raw.get("combination_rules") or [])
        ]

        # "hash_max_size": caps the hashed feature space (reference core's
        # converter_config optional member; there hash % size, here the
        # next power of two NOT EXCEEDING it so the [L, D] tables keep the
        # mask-indexed layout — the memory cap the option exists for holds)
        hms = raw.get("hash_max_size")
        if hms is not None:
            if not isinstance(hms, int) or hms < 16:
                raise ConverterError(
                    f"hash_max_size must be an int >= 16, got {hms!r}")
            self.dim_bits: Optional[int] = hms.bit_length() - 1
        else:
            self.dim_bits = None

        # validate referenced type names exist
        for r in self.string_rules:
            if r.type_name not in self.string_types:
                raise ConverterError(f"string rule references unknown type {r.type_name!r}")
        for r in self.num_rules:
            if r.type_name not in self.num_types and r.type_name not in self.num_type_fns:
                raise ConverterError(f"num rule references unknown type {r.type_name!r}")
        for r in self.binary_rules:
            if r.type_name not in self.binary_type_fns:
                raise ConverterError(f"binary rule references unknown type {r.type_name!r}")
        for r in self.string_filter_rules:
            if r.type_name not in self.string_filters:
                raise ConverterError(f"string filter rule references unknown type {r.type_name!r}")
        for r in self.num_filter_rules:
            if r.type_name not in self.num_filters:
                raise ConverterError(f"num filter rule references unknown type {r.type_name!r}")
        for r in self.combination_rules:
            if r.type_name not in self.combination_types:
                raise ConverterError(f"combination rule references unknown type {r.type_name!r}")


# ---------------------------------------------------------------------------
# the converter
# ---------------------------------------------------------------------------
#: global-weight kind codes carried through the batch pipeline's flat arrays
_GW_BIN, _GW_IDF, _GW_USER = 0, 1, 2
_GW_CODE = {"bin": _GW_BIN, "idf": _GW_IDF, "weight": _GW_USER}

#: default bound for the tokenization/name memo caches (entries, not bytes);
#: overridable per converter via set_cache_size (--fv-cache-size)
DEFAULT_CACHE_SIZE = 1 << 16


class _ComboPlan:
    """The combination cross product as a pure function of the BASE
    feature-name schema (which repeats across a feed's datums): slot
    names, hashed indices, gw kinds, and the bilinear terms feeding each
    slot. On a schema hit the whole string/pair stage of _apply_combos is
    replayed as numpy gathers + multiplies over the batch — the Python
    mirror of the native parser's combo plan (native/fast_ingest.cpp)."""

    __slots__ = ("slot_idx", "slot_kind", "a_idx", "b_idx", "mul_mask",
                 "t_starts", "slot_names")

    def __init__(self, slot_names, slot_idx, slot_kind,
                 a_idx, b_idx, mul_mask, t_starts):
        self.slot_names = slot_names
        self.slot_idx = slot_idx      # int32 [S]
        self.slot_kind = slot_kind    # uint8 [S]
        self.a_idx = a_idx            # int32 [T] base column of left term
        self.b_idx = b_idx            # int32 [T]
        self.mul_mask = mul_mask      # bool  [T] mul (True) vs add
        self.t_starts = t_starts      # int64 [S] first term per slot

    def slot_values(self, base_vals: np.ndarray) -> np.ndarray:
        """[G, nbase] float64 base values → [G, S] slot values."""
        va = base_vals[:, self.a_idx]
        vb = base_vals[:, self.b_idx]
        tv = np.where(self.mul_mask, va * vb, va + vb)
        if self.t_starts.shape[0] == tv.shape[1]:
            return tv  # one term per slot — the common case
        return np.add.reduceat(tv, self.t_starts, axis=1)


class DatumToFVConverter:
    """datum → hashed weighted sparse feature vector.

    Two entry points: ``convert`` (per-datum, reference semantics) and
    ``convert_batch`` (batch-native: memoized tokenization, one hash
    sweep, vectorized global weights, CSR output — the serving hot
    path). Both run the same extraction code, so they cannot drift."""

    def __init__(
        self,
        config: ConverterConfig,
        hasher: Optional[FeatureHasher] = None,
        weights: Optional[WeightManager] = None,
        cache_size: int = DEFAULT_CACHE_SIZE,
    ):
        self.config = config
        self.hasher = hasher or FeatureHasher()
        self.weights = weights or WeightManager(self.hasher.dim)
        # bounded memo caches (clear-on-full — the native parser's
        # discipline; hot keys repopulate in one batch). Caches hold only
        # weight-INDEPENDENT facts (tokenizations, filter outputs, hashed
        # indices, gw kinds) so they can never serve a stale idf/user
        # weighted value.
        self._cache_max = max(int(cache_size), 0)
        self._filter_memo: Dict[tuple, str] = {}
        self._token_memo: Dict[tuple, tuple] = {}
        self._name_memo: Dict[str, Tuple[int, int]] = {}
        self._combo_plans: Dict[tuple, _ComboPlan] = {}
        # optional data-quality recorder: called from convert_batch with
        # (flat feature names, weighted values); the callee self-samples
        self.quality_hook = None
        #: num values dropped for being inf/NaN (they would poison a model)
        self.nonfinite_rejected = 0
        #: memo lookups by cache: [hits, misses] (memo_stats)
        self._memo_counts: Dict[str, List[int]] = {
            "filter": [0, 0], "token": [0, 0], "name": [0, 0]}

    @property
    def dim(self) -> int:
        return self.hasher.dim

    def set_cache_size(self, n: int) -> None:
        """Rebound the tokenization/name memo caches (--fv-cache-size);
        0 disables memoization."""
        self._cache_max = max(int(n), 0)
        for memo in (self._filter_memo, self._token_memo, self._name_memo):
            if len(memo) > self._cache_max:
                memo.clear()

    def memo_stats(self) -> Dict[str, Any]:
        """Each memo cache's entries, hits and misses since construction,
        and the hit rate over all three."""
        out: Dict[str, Any] = {}
        hits = lookups = 0
        for name, memo in (("filter", self._filter_memo),
                           ("token", self._token_memo),
                           ("name", self._name_memo)):
            h, m = self._memo_counts[name]
            out[name] = {"entries": len(memo), "hits": h, "misses": m}
            hits += h
            lookups += h + m
        out["hit_rate"] = hits / lookups if lookups else 0.0
        out["cache_size"] = self._cache_max
        return out

    def _memo_put(self, memo: dict, key, value):
        if self._cache_max:
            if len(memo) >= self._cache_max:
                memo.clear()
            memo[key] = value
        return value

    # -- filters ------------------------------------------------------------
    def _apply_filters(self, datum: Datum) -> Datum:
        cfg = self.config
        out = Datum(
            string_values=datum.string_values,
            num_values=datum.num_values,
            binary_values=datum.binary_values,
        )
        memo = self._filter_memo
        counts = self._memo_counts["filter"]
        for fi, rule in enumerate(cfg.string_filter_rules):
            fn = cfg.string_filters[rule.type_name]
            for key, value in list(out.string_values):
                if rule.matcher(key):
                    fkey = (fi, value)
                    fv = memo.get(fkey)
                    if fv is None:
                        counts[1] += 1
                        fv = self._memo_put(memo, fkey, fn(value))
                    else:
                        counts[0] += 1
                    out.string_values.append((key + rule.suffix, fv))
        for rule in cfg.num_filter_rules:
            fn = cfg.num_filters[rule.type_name]
            for key, value in list(out.num_values):
                if rule.matcher(key):
                    out.num_values.append((key + rule.suffix, fn(value)))
        return out

    def _term_counts(self, type_name: str, splitter: Splitter,
                     text: str) -> tuple:
        """Distinct (term, tf) pairs in first-seen order, memoized per
        (splitter type, input string) — repeated hot strings (headers,
        categorical values) skip re-splitting entirely."""
        tkey = (type_name, text)
        cached = self._token_memo.get(tkey)
        counts = self._memo_counts["token"]
        if cached is not None:
            counts[0] += 1
            return cached
        counts[1] += 1
        counts: Dict[str, int] = {}
        for term in splitter(text):
            counts[term] = counts.get(term, 0) + 1
        return self._memo_put(self._token_memo, tkey, tuple(counts.items()))

    # -- extraction ---------------------------------------------------------
    def _base_named_features(self, datum: Datum) -> Dict[str, float]:
        """The weighted feature dict BEFORE combination rules — the
        snapshot the combo cross product feeds on."""
        cfg = self.config
        datum = self._apply_filters(datum)
        # ingest hardening: a single inf/NaN num value from
        # a client would flow straight into the weights (train adds the
        # feature value into the model; NaN is absorbing and the next
        # mix round would broadcast it fleet-wide). Reject non-finite
        # num values HERE — after filters, so a filter emitting
        # non-finite output is caught too — counted, never silently
        # trained. Runs for every convert path (per-datum, batch,
        # named).
        if datum.num_values and any(
                isinstance(v, float) and not math.isfinite(v)
                for _, v in datum.num_values):
            kept = [kv for kv in datum.num_values
                    if not (isinstance(kv[1], float)
                            and not math.isfinite(kv[1]))]
            self.nonfinite_rejected += len(datum.num_values) - len(kept)
            _count_nonfinite(len(datum.num_values) - len(kept))
            datum = Datum(string_values=datum.string_values,
                          num_values=kept,
                          binary_values=datum.binary_values)
        features: Dict[str, float] = {}

        # string rules
        for rule in cfg.string_rules:
            splitter = cfg.string_types[rule.type_name]
            suffix = (f"@{rule.type_name}"
                      f"#{rule.sample_weight}/{rule.global_weight}")
            for key, text in datum.string_values:
                if not rule.matcher(key):
                    continue
                for term, tf in self._term_counts(
                        rule.type_name, splitter, text):
                    if rule.sample_weight == "bin":
                        sw = 1.0
                    elif rule.sample_weight == "tf":
                        sw = float(tf)
                    else:  # log_tf
                        sw = math.log(1.0 + tf)
                    name = f"{key}${term}{suffix}"
                    features[name] = features.get(name, 0.0) + sw

        # num rules
        for rule in cfg.num_rules:
            kind = cfg.num_types.get(rule.type_name)
            fn = cfg.num_type_fns.get(rule.type_name)
            for key, value in datum.num_values:
                if not rule.matcher(key):
                    continue
                if fn is not None:
                    for name, v in fn(key, value):
                        features[name] = features.get(name, 0.0) + v
                    continue
                tname = rule.type_name
                if kind == "num":
                    name = f"{key}@{tname}"
                    features[name] = features.get(name, 0.0) + value
                elif kind == "log":
                    name = f"{key}@{tname}"
                    features[name] = features.get(name, 0.0) + math.log(max(1.0, value))
                elif kind == "str":
                    name = f"{key}${_format_num(value)}@{tname}"
                    features[name] = features.get(name, 0.0) + 1.0

        # binary rules (image_feature-style plugins)
        for rule in cfg.binary_rules:
            fn = cfg.binary_type_fns[rule.type_name]
            for key, value in datum.binary_values:
                if not rule.matcher(key):
                    continue
                for name, v in fn(key, value):
                    features[name] = features.get(name, 0.0) + v

        return features

    def _apply_combos(self, features: Dict[str, float]) -> None:
        """Combination features over the features produced so far, added
        in place. Each rule emits each unordered pair once (canonical
        name order), regardless of which side matched which matcher;
        values accumulate across rules."""
        cfg = self.config
        base = list(features.items())
        for rule in cfg.combination_rules:
            op = cfg.combination_types[rule.type_name]
            seen = set()
            for lname, lval in base:
                if not rule.match_left(lname):
                    continue
                for rname, rval in base:
                    if lname == rname or not rule.match_right(rname):
                        continue
                    a, b = (lname, rname) if lname < rname else (rname, lname)
                    if (a, b) in seen:
                        continue
                    seen.add((a, b))
                    cval = lval * rval if op == "mul" else lval + rval
                    name = f"{a}&{b}"
                    features[name] = features.get(name, 0.0) + cval

    def _named_features(self, datum: Datum) -> Dict[str, float]:
        """Produce the weighted feature dict keyed by full feature name."""
        features = self._base_named_features(datum)
        if self.config.combination_rules:
            self._apply_combos(features)
        return features

    # -- hashing + global weights -------------------------------------------
    def convert(self, datum: Datum, update_weights: bool = False) -> SparseVector:
        """Convert to hashed (index, value) pairs, applying global weights.

        update_weights=True is the train path (reference's
        convert_and_update_weight): document frequencies are recorded before
        idf lookup.
        """
        named = self._named_features(datum)
        # hash (one native batch call when built) + resolve global weights
        hashed: Dict[int, float] = {}
        idf_indices = []
        entries: List[Tuple[int, float, str]] = []
        names = list(named.keys())
        for idx, name in zip(self.hasher.index_many(names), names):
            value = named[name]
            gw_kind = _global_weight_kind(name)
            entries.append((idx, value, gw_kind))
            if gw_kind == "idf":
                idf_indices.append(idx)
        if update_weights and idf_indices:
            self.weights.observe(set(idf_indices))
        for idx, value, gw_kind in entries:
            if gw_kind == "idf":
                value *= self.weights.idf(idx)
            elif gw_kind == "weight":
                value *= self.weights.user_weight(idx)
            hashed[idx] = hashed.get(idx, 0.0) + value
        return sorted(hashed.items())

    # -- batch pipeline ------------------------------------------------------
    def _resolve_names(self, names: List[str]):
        """names → (int32 indices, uint8 gw kinds): memo lookups plus ONE
        ``index_array`` sweep for the misses. The memo holds only pure
        facts (hash, kind parsed from the name) — never weighted values."""
        n = len(names)
        idx = np.empty(n, dtype=np.int32)
        kind = np.empty(n, dtype=np.uint8)
        memo = self._name_memo
        miss_pos: List[int] = []
        miss_names: List[str] = []
        for i, nm in enumerate(names):
            e = memo.get(nm)
            if e is None:
                miss_pos.append(i)
                miss_names.append(nm)
            else:
                idx[i] = e[0]
                kind[i] = e[1]
        counts = self._memo_counts["name"]
        counts[0] += n - len(miss_names)
        counts[1] += len(miss_names)
        if miss_names:
            new_idx = self.hasher.index_array(miss_names)
            for p, nm, ix in zip(miss_pos, miss_names, new_idx.tolist()):
                k = _GW_CODE[_global_weight_kind(nm)]
                self._memo_put(memo, nm, (ix, k))
                idx[p] = ix
                kind[p] = k
        return idx, kind

    def _combo_plan_for(self, base_names: tuple) -> _ComboPlan:
        """Build (or fetch) the combo plan for one base-name schema —
        a symbolic replay of _apply_combos with values left abstract."""
        plan = self._combo_plans.get(base_names)
        if plan is not None:
            return plan
        cfg = self.config
        slot_names: List[str] = []
        slot_map: Dict[str, int] = {}
        slot_terms: List[List[Tuple[int, int, bool]]] = []
        for rule in cfg.combination_rules:
            mul = cfg.combination_types[rule.type_name] == "mul"
            seen = set()
            left = [i for i, nm in enumerate(base_names)
                    if rule.match_left(nm)]
            right = [i for i, nm in enumerate(base_names)
                     if rule.match_right(nm)]
            for li in left:
                ln = base_names[li]
                for ri in right:
                    if li == ri:
                        continue
                    rn = base_names[ri]
                    a, b = (ln, rn) if ln < rn else (rn, ln)
                    if (a, b) in seen:
                        continue
                    seen.add((a, b))
                    name = f"{a}&{b}"
                    s = slot_map.get(name)
                    if s is None:
                        s = len(slot_names)
                        slot_map[name] = s
                        slot_names.append(name)
                        slot_terms.append([])
                    slot_terms[s].append((li, ri, mul))
        a_idx, b_idx, mul_mask, t_starts = [], [], [], []
        for terms in slot_terms:
            t_starts.append(len(a_idx))
            for li, ri, mul in terms:
                a_idx.append(li)
                b_idx.append(ri)
                mul_mask.append(mul)
        sidx, skind = self._resolve_names(slot_names)
        plan = _ComboPlan(
            slot_names, sidx, skind,
            np.asarray(a_idx, dtype=np.int32),
            np.asarray(b_idx, dtype=np.int32),
            np.asarray(mul_mask, dtype=bool),
            np.asarray(t_starts, dtype=np.int64),
        )
        if len(self._combo_plans) >= 64:
            self._combo_plans.clear()
        self._combo_plans[base_names] = plan
        return plan

    def convert_batch(self, data: Sequence[Datum],
                      update_weights: bool = False) -> CSRBatch:
        """Batch-native conversion: tokenize/filter with the memo caches,
        hash every feature name in one sweep, apply global weights as
        numpy gathers, and emit an arena-style CSR triple — no per-datum
        SparseVector objects on the hot path.

        Semantics match per-datum ``convert`` exactly, with ONE
        documented difference under ``update_weights=True``: document
        frequencies for the WHOLE batch are observed first (one
        ``observe_batch`` call — the idf batch-collapse fix), then every
        row's idf reflects the full batch's counts. Per-datum convert
        interleaves observe/lookup per document, so a document sees only
        its predecessors; intra-batch arrival order was never a contract
        (the microbatch coalescer already merges concurrent requests in
        arbitrary order), and the two agree for batch size 1 and
        converge as counts grow."""
        b = len(data)
        if b == 0:
            return CSRBatch(np.zeros(0, np.int32), np.zeros(0, np.float32),
                            np.zeros(1, np.int64))
        base = [self._base_named_features(d) for d in data]
        combo = bool(self.config.combination_rules)

        row_idx: List[np.ndarray] = [None] * b  # type: ignore[list-item]
        row_val: List[np.ndarray] = [None] * b  # type: ignore[list-item]
        row_kind: List[np.ndarray] = [None] * b  # type: ignore[list-item]
        if not combo:
            flat_names: List[str] = []
            counts = np.empty(b, dtype=np.int64)
            for i, nd in enumerate(base):
                flat_names.extend(nd.keys())
                counts[i] = len(nd)
            idx, kind = self._resolve_names(flat_names)
            val = np.empty(len(flat_names), dtype=np.float64)
            pos = 0
            for nd in base:
                for v in nd.values():
                    val[pos] = v
                    pos += 1
            flat_idx, flat_val, flat_kind = idx, val, kind
            entry_rows = np.repeat(np.arange(b, dtype=np.int64), counts)
        else:
            # group rows by base-name schema; the cross product becomes
            # one vectorized bilinear evaluation per group (fixed key
            # schemas — the production shape — form a single group)
            groups: Dict[tuple, List[int]] = {}
            for i, nd in enumerate(base):
                groups.setdefault(tuple(nd.keys()), []).append(i)
            for names_t, members in groups.items():
                bidx, bkind = self._resolve_names(list(names_t))
                plan = self._combo_plan_for(names_t)
                bvals = np.array(
                    [list(base[r].values()) for r in members],
                    dtype=np.float64).reshape(len(members), len(names_t))
                svals = plan.slot_values(bvals) if len(plan.slot_names) \
                    else np.zeros((len(members), 0))
                gidx = np.concatenate([bidx, plan.slot_idx])
                gkind = np.concatenate([bkind, plan.slot_kind])
                for gi, r in enumerate(members):
                    row_idx[r] = gidx
                    row_kind[r] = gkind
                    row_val[r] = np.concatenate([bvals[gi], svals[gi]])
            counts = np.fromiter((a.shape[0] for a in row_idx),
                                 dtype=np.int64, count=b)
            flat_idx = np.concatenate(row_idx) if b else np.zeros(0, np.int32)
            flat_val = np.concatenate(row_val)
            flat_kind = np.concatenate(row_kind)
            entry_rows = np.repeat(np.arange(b, dtype=np.int64), counts)

        # global weights — vectorized gathers instead of per-index calls.
        # observe() runs ONCE for the whole batch (before any lookup), so
        # every row sees the post-batch document counts.
        idf_mask = flat_kind == _GW_IDF
        if idf_mask.any():
            if update_weights:
                self.weights.observe_batch(flat_idx[idf_mask],
                                           entry_rows[idf_mask])
            flat_val[idf_mask] *= self.weights.idf_many(flat_idx[idf_mask])
        user_mask = flat_kind == _GW_USER
        if user_mask.any():
            flat_val[user_mask] *= self.weights.user_weight_many(
                flat_idx[user_mask])

        hook = self.quality_hook
        if hook is not None:
            try:
                if not combo:
                    hook(flat_names, flat_val)
                else:
                    row_names: List[List[str]] = [[]] * b
                    for names_t, members in groups.items():
                        nm = list(names_t) + \
                            list(self._combo_plan_for(names_t).slot_names)
                        for r in members:
                            row_names[r] = nm
                    hook([n for rn in row_names for n in rn], flat_val)
            except Exception:  # broad-ok — quality stats must not break FV
                pass

        # per-row merge by hashed index (convert()'s sorted-dict
        # semantics): stable lexsort keeps insertion order for colliding
        # entries, so float accumulation order matches the per-datum dict
        if flat_idx.shape[0] == 0:
            return CSRBatch(np.zeros(0, np.int32), np.zeros(0, np.float32),
                            np.zeros(b + 1, np.int64))
        order = np.lexsort((flat_idx, entry_rows))
        srow = entry_rows[order]
        sidx = flat_idx[order]
        sval = flat_val[order]
        boundary = np.ones(sidx.shape[0], dtype=bool)
        boundary[1:] = (srow[1:] != srow[:-1]) | (sidx[1:] != sidx[:-1])
        starts = np.flatnonzero(boundary)
        midx = sidx[starts].astype(np.int32)
        mval = np.add.reduceat(sval, starts)
        mrows = srow[starts]
        mcounts = np.bincount(mrows, minlength=b)
        off = np.zeros(b + 1, dtype=np.int64)
        np.cumsum(mcounts, out=off[1:])
        return CSRBatch(midx, mval.astype(np.float32), off)

    def convert_named(self, datum: Datum, update_weights: bool = False) -> Dict[str, float]:
        """Named (unhashed) features with global weights applied — for the
        weight engine's calc_weight/update and for tests. Runs the extraction
        pipeline once; update_weights records document frequencies first."""
        named = self._named_features(datum)
        entries = [(name, self.hasher.index(name), value) for name, value in named.items()]
        if update_weights:
            idf_idx = {i for name, i, _ in entries if _global_weight_kind(name) == "idf"}
            if idf_idx:
                self.weights.observe(idf_idx)
        out = {}
        for name, idx, value in entries:
            gw_kind = _global_weight_kind(name)
            if gw_kind == "idf":
                value *= self.weights.idf(idx)
            elif gw_kind == "weight":
                value *= self.weights.user_weight(idx)
            out[name] = value
        return out

    def revert_feature(self, index: int) -> Optional[Tuple[str, str]]:
        """Best-effort hash→(key, value) decode, for decode_row-style APIs."""
        name = self.hasher.name_of(index)
        if name is None:
            return None
        if "$" in name:
            key, rest = name.split("$", 1)
            value = rest.split("@", 1)[0]
            return key, value
        return name.split("@", 1)[0], ""


def _format_num(v: float) -> str:
    return str(int(v)) if float(v).is_integer() else repr(v)


def _global_weight_kind(name: str) -> str:
    if "/" in name:
        return name.rsplit("/", 1)[1]
    return "bin"


def make_fv_converter(
    converter_block: Optional[dict],
    dim_bits: int = 20,
    weights: Optional[WeightManager] = None,
    cache_size: int = DEFAULT_CACHE_SIZE,
) -> DatumToFVConverter:
    """Factory mirroring core::fv_converter::make_fv_converter
    (reference usage: jubatus/server/server/classifier_serv.cpp:110).

    A "hash_max_size" in the converter block overrides ``dim_bits`` — the
    config is the deployment's statement of model scale, same as the
    reference core's converter_config member. ``cache_size`` bounds the
    tokenization/name memo caches (--fv-cache-size)."""
    config = ConverterConfig(converter_block)
    if config.dim_bits is not None:
        dim_bits = config.dim_bits
    hasher = FeatureHasher(dim_bits=dim_bits)
    return DatumToFVConverter(config, hasher,
                              weights or WeightManager(hasher.dim),
                              cache_size=cache_size)
