"""ctypes bindings for the native train-request parser
(native/fast_ingest.cpp; copy of ``jubatus_tpu/native/ingest.py``).

``IngestParser`` turns the raw msgpack bytes of one train RPC
([name, [[label, datum], ...]]) into the driver's input — padded
int32/float32 [B, K] arrays + label strings — entirely in C++: no Datum
objects, no per-feature Python strings, no GIL-held convert loop. The
supported converter subset and the exact name/hash semantics are
documented in the C++ file; ``from_converter_config`` decides eligibility
and returns None when the config needs the Python converter, or when
``JUBATUS_TPU_NATIVE_INGEST=0`` switches the parser off. The library is
built by ``jubatus_tpu_torch.native.ensure_built`` into
``build/torch_native/``; for an eligible config a failed build raises
``NativeBuildError`` (the JAX package serves the Python converter then).
"""

from __future__ import annotations

import ctypes
import os
import threading
from typing import Dict, List, Optional

import numpy as np

from jubatus_tpu_torch import native as nb

_lock = threading.Lock()
_lib: Optional[ctypes.CDLL] = None


class _Out(ctypes.Structure):
    _fields_ = [
        ("batch", ctypes.c_int32),
        ("width", ctypes.c_int32),
        ("labels_numeric", ctypes.c_int32),
        ("idx", ctypes.POINTER(ctypes.c_int32)),
        ("val", ctypes.POINTER(ctypes.c_float)),
        ("labels", ctypes.POINTER(ctypes.c_uint8)),
        ("label_off", ctypes.POINTER(ctypes.c_int32)),
        ("targets", ctypes.POINTER(ctypes.c_float)),
        ("uniq", ctypes.c_int32),
        ("label_idx", ctypes.POINTER(ctypes.c_int32)),
    ]


def _load() -> ctypes.CDLL:
    """Build and load the parser library once; raises NativeBuildError."""
    global _lib
    with _lock:
        if _lib is not None:
            return _lib
        lib = nb.load("fast_ingest")
        lib.jt_ingest_create.restype = ctypes.c_void_p
        lib.jt_ingest_create.argtypes = [ctypes.c_char_p]
        lib.jt_ingest_destroy.restype = None
        lib.jt_ingest_destroy.argtypes = [ctypes.c_void_p]
        lib.jt_ingest_parse.restype = ctypes.c_int
        lib.jt_ingest_parse.argtypes = [
            ctypes.c_void_p, ctypes.c_char_p, ctypes.c_int64,
            ctypes.c_uint32, ctypes.POINTER(_Out)]
        lib.jt_ingest_parse_datums.restype = ctypes.c_int
        lib.jt_ingest_parse_datums.argtypes = [
            ctypes.c_void_p, ctypes.c_char_p, ctypes.c_int64,
            ctypes.c_uint32, ctypes.POINTER(_Out)]
        _fp = ctypes.POINTER(ctypes.c_float)
        _dp = ctypes.POINTER(ctypes.c_double)
        lib.jt_ingest_parse_w.restype = ctypes.c_int
        lib.jt_ingest_parse_w.argtypes = [
            ctypes.c_void_p, ctypes.c_char_p, ctypes.c_int64,
            ctypes.c_uint32, _fp, _fp, ctypes.c_double, _dp, ctypes.c_int,
            ctypes.POINTER(_Out)]
        lib.jt_ingest_parse_datums_w.restype = ctypes.c_int
        lib.jt_ingest_parse_datums_w.argtypes = [
            ctypes.c_void_p, ctypes.c_char_p, ctypes.c_int64,
            ctypes.c_uint32, _fp, _fp, ctypes.c_double, _dp,
            ctypes.POINTER(_Out)]
        lib.jt_ingest_free_out.restype = None
        lib.jt_ingest_free_out.argtypes = [ctypes.POINTER(_Out)]
        _lib = lib
        return _lib


def spec_from_converter_config(conv: dict) -> Optional[str]:
    """Compile a converter config into the C++ rule spec, or None when the
    config needs features the native parser does not implement (STRING
    filters, user "weight" global weights, plugins, regexp splitters,
    binary rules) — the caller then stays on the Python converter. num
    filters, ngram splitters, idf global weights and combination rules
    (mul/add over the named cross product) compile to the native spec,
    except combination rules combined with idf."""
    if not isinstance(conv, dict):
        return None
    for k in ("string_filter_rules", "binary_rules", "binary_types"):
        if conv.get(k):
            return None
    combo_lines: List[str] = []
    if conv.get("combination_rules"):
        kinds = {"mul": "mul", "add": "add"}
        for tname, params in (conv.get("combination_types") or {}).items():
            m = (params or {}).get("method")
            kinds[tname] = m if m in ("mul", "add") else None
        for r in conv.get("combination_rules"):
            kind = kinds.get(r.get("type"))
            if kind is None:
                return None
            kl, kr = r.get("key_left", "*"), r.get("key_right", "*")
            if any("\t" in k or "\n" in k for k in (kl, kr)):
                return None
            combo_lines.append(f"combo\t{kind}\t{kl}\t{kr}")
        # combos run over pre-hash NAMES; idf weights hashed indices —
        # composing both stays on the Python converter (C++ create also
        # refuses, belt and suspenders)
        for r in conv.get("string_rules") or []:
            if r.get("global_weight") == "idf":
                return None
    # num filters: pure-math transforms appending (key+suffix, f(value)),
    # expressible in C++. Param validity (max > min, std > 0)
    # is the converter's job at server start; unknown methods decline.
    nf_lines: List[str] = []
    if conv.get("num_filter_rules"):
        kinds = {}
        for tname, params in (conv.get("num_filter_types") or {}).items():
            p = params or {}
            try:
                if p.get("method") == "add":
                    kinds[tname] = ("add", float(p["value"]), 0.0)
                elif p.get("method") == "linear_normalization":
                    kinds[tname] = ("linear", float(p["min"]),
                                    float(p["max"]))
                elif p.get("method") == "gaussian_normalization":
                    kinds[tname] = ("gauss", float(p["average"]),
                                    float(p["standard_deviation"]))
                elif p.get("method") == "sigmoid_normalization":
                    kinds[tname] = ("sigmoid", float(p["gain"]),
                                    float(p["bias"]))
            except (KeyError, TypeError, ValueError):
                pass  # missing/odd params: rules using it decline below
        for r in conv.get("num_filter_rules"):
            k = kinds.get(r.get("type"))
            if k is None:
                return None
            suffix = r.get("suffix", "")
            if "\t" in suffix or "\n" in suffix:
                return None
            nf_lines.append(f"nf\t{k[0]}\t{k[1]!r}\t{k[2]!r}\t"
                            f"{r.get('key', '*')}\t{suffix}")
    # type tables: builtin names plus parameterized ngram
    str_types = {"str": "str", "space": "space"}
    for tname, params in (conv.get("string_types") or {}).items():
        method = (params or {}).get("method")
        if method in ("str", "space"):
            str_types[tname] = method
        elif method == "ngram":
            try:
                n = int((params or {}).get("char_num", ""))
            except (TypeError, ValueError):
                n = 0
            # upper bound: C++ parses with atoi (int); a window wider than
            # any realistic text must decline rather than risk divergence
            str_types[tname] = f"ngram:{n}" if 1 <= n <= 65535 else None
        else:
            str_types[tname] = None  # unsupported; rules using it bail
    num_types = {"num": "num", "log": "log", "str": "str"}
    for tname, params in (conv.get("num_types") or {}).items():
        method = (params or {}).get("method")
        if method in ("num", "log", "str"):
            num_types[tname] = method
        else:
            num_types[tname] = None
    lines: List[str] = []
    for r in conv.get("num_rules") or []:
        kind = num_types.get(r.get("type"))
        if kind is None:
            return None
        lines.append(f"num\t{kind}\t{r.get('key', '*')}")
    for r in conv.get("string_rules") or []:
        split = str_types.get(r.get("type"))
        if split is None:
            return None
        sw = r.get("sample_weight", "bin")
        gw = r.get("global_weight", "bin")
        # idf rides the fast path too (the parser takes the WeightManager's
        # dense df tables); user "weight" needs the user-weight map -> no
        if sw not in ("bin", "tf", "log_tf") or gw not in ("bin", "idf"):
            return None
        lines.append(f"str\t{split}\t{sw}\t{gw}\t{r.get('type')}\t"
                     f"{r.get('key', '*')}")
    if not lines:
        return None
    lines = nf_lines + lines + combo_lines  # filters first, combos last
    for ln in lines:  # keys with separators would corrupt the spec
        if "\n" in ln.replace("\t", " ") or ln.count("\t") > 5:
            return None
    return "\n".join(lines)


#: cross-request memo cap for the hybrid filter path (entries are
#: (rule_idx, input) -> output; a repeated key schema makes the inputs
#: highly repetitive in real feeds)
_FILTER_MEMO_MAX = 1 << 16


def deferred_idf_scale(idx: np.ndarray, val: np.ndarray, weights,
                       observe: bool) -> np.ndarray:
    """Flush-time batch idf for a deferred-idf parser's output: observe
    every document of the coalesced flush ONCE (train path), then scale
    the raw sample-weighted values by log(ndocs/df) gathered over the
    index matrix. ONE weights-lock acquisition per flush instead of one
    serialized parse per request — the idf batch-collapse fix. Padding
    entries (index 0, value 0) stay 0 (df 0 → factor 1.0 → 0.0)."""
    if observe:
        weights.observe_rows(idx)
    w = weights.idf_many(idx.reshape(-1)).reshape(idx.shape)
    return (val.astype(np.float64) * w).astype(np.float32)


def _build_prefilters(conv: dict):
    """[(matcher, suffix, fn)] mirroring converter.Config's
    string_filter_rules, built from the same factories so behavior
    cannot drift. Raises on unknown methods (caller declines)."""
    from jubatus_tpu_torch.core.fv.converter import (_build_string_filter,
                                                     make_key_matcher)

    types = {name: _build_string_filter(params or {})
             for name, params in
             (conv.get("string_filter_types") or {}).items()}
    out = []
    for r in conv.get("string_filter_rules") or []:
        out.append((make_key_matcher(r["key"]), r["suffix"],
                    types[r["type"]]))
    return out


class IngestParser:
    """One immutable parser handle per (converter config, dim).

    ``needs_weights``: the spec carries idf rules — every parse must be
    given the converter's WeightManager (and run under its lock: the C++
    mutates the df tables in place on the train path).

    ``_prefilters``: hybrid string-filter mode — Python rewrites the
    request with filter-appended string values (regex memoized per
    distinct input) before the C++ parse; see from_converter_config."""

    def __init__(self, spec: str, dim_bits: int) -> None:
        self._prefilters = None
        self._filter_memo: Dict[tuple, str] = {}
        lib = _load()
        self._lib = lib
        self._mask = (1 << dim_bits) - 1
        # field-positional, not a substring grep: a string TYPE named
        # "idf" must not make a bin-weighted spec demand weight state
        self.needs_weights = any(
            ln.split("\t")[3] == "idf"
            for ln in spec.split("\n") if ln.startswith("str\t"))
        #: deferred-idf mode (from_converter_config sets it for pure-idf
        #: configs): the parse emits RAW sample-weighted values — names
        #: and hashes unchanged — against zeroed df tables (idf factor
        #: 1.0, nothing observed, NO WeightManager lock), and the caller
        #: applies observe + scaling once per coalesced FLUSH
        #: (deferred_idf_scale). Fixes the idf batch-collapse: per-request
        #: parses no longer serialize on the weights lock.
        self.deferred_idf = False
        self._zero_df: Optional[np.ndarray] = None
        self._zero_nd: Optional[np.ndarray] = None
        self._handle = lib.jt_ingest_create(spec.encode())
        if not self._handle:
            raise ValueError(f"native ingest rejected spec: {spec!r}")

    @classmethod
    def from_converter_config(cls, conv: dict,
                              dim_bits: int) -> Optional["IngestParser"]:
        # A/B switch: "0" declines every config, so the server serves the
        # Python-converter path (the two packages' parity tests set it)
        if os.environ.get("JUBATUS_TPU_NATIVE_INGEST", "") in \
                ("0", "false", "no") or not isinstance(conv, dict):
            return None
        prefilters = None
        if conv.get("string_filter_rules"):
            # HYBRID path: the regex itself stays in Python (std::regex
            # diverges from `re` on real patterns), memoized per
            # distinct input string;
            # everything else (datum walk, tokenize, tf, hash, emit)
            # stays in C++. The C++ spec is built from the config SANS
            # filters; parse() first rewrites the request with the
            # filter-appended values, exactly like the converter's
            # _apply_filters.
            try:
                prefilters = _build_prefilters(conv)
            except Exception:  # noqa: BLE001 — unknown method: python path
                return None
            conv = {k: v for k, v in conv.items()
                    if k not in ("string_filter_rules",
                                 "string_filter_types")}
        spec = spec_from_converter_config(conv)
        if spec is None:
            return None
        try:
            p = cls(spec, dim_bits)  # a failed build raises, never declines
        except ValueError:
            return None  # the C++ refused the spec: the Python converter
        if prefilters is not None:
            p._prefilters = prefilters
        # pure-idf configs defer weighting to the flush: every feature
        # the spec can emit is idf-weighted (all string rules idf, no
        # num/combination rules), so post-merge scaling at flush time is
        # exact — see deferred_idf_scale. Mixed specs keep the in-parse
        # protocol (a post-merge scale would mis-weight hash collisions
        # between idf and non-idf features).
        if p.needs_weights and not conv.get("num_rules") \
                and not conv.get("combination_rules") \
                and all(r.get("global_weight") == "idf"
                        for r in (conv.get("string_rules") or [])):
            p.deferred_idf = True
        return p

    @staticmethod
    def _idx_val(out: "_Out"):
        """Copy the [B, K] arrays out of a parse result (one place owns
        the ctypes-extraction dance: shapes, .copy() before free, and the
        empty-batch dtype fallback). Also the native path's half of the
        ingest hardening: the C++ parser never sees the
        Python converter's finite screen, so a client's inf/NaN num
        value would flow straight into the weights here — non-finite
        entries are zeroed into the padding slot (index 0 — features
        never hash there) and counted, exactly like the converter-path
        rejection."""
        b, w = out.batch, out.width
        idx = np.ctypeslib.as_array(out.idx, shape=(b, w)).copy() \
            if b else np.zeros((0, 8), np.int32)
        val = np.ctypeslib.as_array(out.val, shape=(b, w)).copy() \
            if b else np.zeros((0, 8), np.float32)
        bad = ~np.isfinite(val)
        if bad.any():
            n = int(bad.sum())
            val[bad] = 0.0
            idx[bad] = 0
            from jubatus_tpu_torch.utils import tracing

            _registry = tracing.default_registry()
            _registry.count("fv.nonfinite_rejected", n)
        return idx, val

    def _weight_args(self, weights):
        import ctypes as ct

        fp = ct.POINTER(ct.c_float)
        dp = ct.POINTER(ct.c_double)
        return (weights._df_master.ctypes.data_as(fp),
                weights._df_diff.ctypes.data_as(fp),
                float(weights._ndocs_master),
                weights._ndocs_diff.ctypes.data_as(dp))

    def _zero_weight_args(self):
        """Zeroed df tables for deferred-idf parses: df 0 → idf factor
        1.0 (raw values out), observe 0 → nothing written — the parse
        touches no shared state and needs no lock."""
        import ctypes as ct

        if self._zero_df is None:
            self._zero_df = np.zeros(self._mask + 1, np.float32)
            self._zero_nd = np.zeros(1, np.float64)
        fp = ct.POINTER(ct.c_float)
        dp = ct.POINTER(ct.c_double)
        return (self._zero_df.ctypes.data_as(fp),
                self._zero_df.ctypes.data_as(fp),
                0.0,
                self._zero_nd.ctypes.data_as(dp))

    def _apply_prefilters(self, sv: list) -> None:
        """Append filter outputs to one datum's string_values IN PLACE,
        mirroring converter._apply_filters: each rule snapshots the
        current list, so later rules see earlier rules' appends."""
        memo = self._filter_memo
        for ri, (match, suffix, fn) in enumerate(self._prefilters):
            for kv in list(sv):
                k, v = kv[0], kv[1]
                if not match(k):
                    continue
                key = (ri, v)
                fv = memo.get(key)
                if fv is None:
                    fv = fn(v)
                    if len(memo) >= _FILTER_MEMO_MAX:
                        memo.clear()
                    memo[key] = fv
                sv.append([k + suffix, fv])

    def _prefilter_rewrite(self, raw: bytes, with_labels: bool):
        """The hybrid filter pre-pass: decode the request, apply string
        filters (Python regex, memoized), re-encode for the C++ parse.
        Returns None when the wire shape is not the expected format —
        the caller then falls back to the generic path, which fails or
        serves it with identical semantics."""
        import msgpack

        try:
            req = msgpack.unpackb(raw, raw=False, strict_map_key=False,
                                  use_list=True,
                                  unicode_errors="surrogateescape")
            if not isinstance(req, list) or len(req) != 2 \
                    or not isinstance(req[1], list):
                return None
            for item in req[1]:
                d = item[1] if with_labels else item
                # datums are inline arrays on this wire (Datum.to_msgpack
                # emits the [sv, nv, bv] structure; the C++ parser reads
                # it with array_len directly) — anything else cannot
                # parse natively regardless, so fall back
                if not isinstance(d, list) or not d \
                        or not isinstance(d[0], list):
                    return None
                self._apply_prefilters(d[0])
            return msgpack.packb(req, use_bin_type=True,
                                 unicode_errors="surrogateescape")
        except Exception:  # noqa: BLE001 — any wire oddity: generic path
            return None

    def parse_indexed(self, raw: bytes, weights=None):
        """Raw train params msgpack -> (labels, idx [B,K] i32, val [B,K] f32).

        ``labels`` is a float32 array for regression targets, or — for
        string labels — a ``(uniq_labels, label_idx)`` pair: the DISTINCT
        label strings plus an int32 [B] row->uniq index (the C++ parser
        dedups, so the host never loops over B Python strings). None when
        the wire shape is not the expected train format (caller falls back
        to the generic decode path).

        ``weights``: the converter's WeightManager, REQUIRED for idf specs
        (train path: documents are observed and values idf-scaled exactly
        like converter.convert(update_weights=True)); caller must hold
        ``weights.lock``."""
        if self._prefilters is not None:
            raw = self._prefilter_rewrite(raw, with_labels=True)
            if raw is None:
                return None
        out = _Out()
        if self.needs_weights:
            if self.deferred_idf:
                dfm, dfd, nm, nd = self._zero_weight_args()
                rc = self._lib.jt_ingest_parse_w(
                    self._handle, raw, len(raw), self._mask, dfm, dfd, nm,
                    nd, 0, ctypes.byref(out))
            else:
                if weights is None:
                    return None
                dfm, dfd, nm, nd = self._weight_args(weights)
                rc = self._lib.jt_ingest_parse_w(
                    self._handle, raw, len(raw), self._mask, dfm, dfd, nm,
                    nd, 1, ctypes.byref(out))
        else:
            rc = self._lib.jt_ingest_parse(self._handle, raw, len(raw),
                                           self._mask, ctypes.byref(out))
        if rc != 0:
            return None
        try:
            b = out.batch
            idx, val = self._idx_val(out)
            if out.labels_numeric:
                labels = np.ctypeslib.as_array(
                    out.targets, shape=(b,)).copy() if b else \
                    np.zeros(0, np.float32)
            else:
                u = out.uniq
                offs = np.ctypeslib.as_array(out.label_off, shape=(u + 1,))
                blob = bytes(np.ctypeslib.as_array(
                    out.labels, shape=(max(int(offs[-1]), 1),)))
                uniq = [
                    blob[offs[i]:offs[i + 1]].decode("utf-8",
                                                     "surrogateescape")
                    for i in range(u)
                ]
                lidx = np.ctypeslib.as_array(
                    out.label_idx, shape=(b,)).copy() if b else \
                    np.zeros(0, np.int32)
                labels = (uniq, lidx)
        finally:
            self._lib.jt_ingest_free_out(ctypes.byref(out))
        return labels, idx, val

    def parse(self, raw: bytes, weights=None):
        """Like parse_indexed but with per-row label strings (compat shape:
        a list of B strings for classifiers, float32 array for targets)."""
        parsed = self.parse_indexed(raw, weights=weights)
        if parsed is None:
            return None
        labels, idx, val = parsed
        if isinstance(labels, tuple):
            uniq, lidx = labels
            labels = [uniq[i] for i in lidx]
        return labels, idx, val

    def parse_datums(self, raw: bytes, weights=None):
        """Raw classify/estimate params msgpack ([name, [datum, ...]]) ->
        (idx [B,K] i32, val [B,K] f32), or None when the wire shape is
        not a datum list. For idf specs, ``weights`` is read (NOT
        observed — queries never record documents; caller holds the
        lock)."""
        if self._prefilters is not None:
            raw = self._prefilter_rewrite(raw, with_labels=False)
            if raw is None:
                return None
        out = _Out()
        if self.needs_weights:
            if self.deferred_idf:
                dfm, dfd, nm, nd = self._zero_weight_args()
            elif weights is None:
                return None
            else:
                dfm, dfd, nm, nd = self._weight_args(weights)
            rc = self._lib.jt_ingest_parse_datums_w(
                self._handle, raw, len(raw), self._mask, dfm, dfd, nm, nd,
                ctypes.byref(out))
        else:
            rc = self._lib.jt_ingest_parse_datums(
                self._handle, raw, len(raw), self._mask, ctypes.byref(out))
        if rc != 0:
            return None
        try:
            return self._idx_val(out)
        finally:
            self._lib.jt_ingest_free_out(ctypes.byref(out))

    def __del__(self):  # noqa: D105
        try:
            if getattr(self, "_handle", None):
                self._lib.jt_ingest_destroy(self._handle)
                self._handle = None
        except Exception:  # noqa: BLE001 — interpreter teardown
            pass
