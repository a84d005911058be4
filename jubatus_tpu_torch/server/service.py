"""Wire adapters: bind a driver onto the RpcServer (counterpart of
``jubatus_tpu/server/service.py``).

Registers the built-ins get_config, get_status, save, load and do_mix,
those of the forensics plane (get_metrics, get_spans, get_slow_log,
get_profile, profile_device), of the model-health, event, data-quality and
usage planes (get_timeseries, get_alerts, get_events, get_incidents,
get_quality, get_usage), of the elastic membership plane (get_epoch,
drain, drain_status, rebalance, migrate_range, put_rows, get_row_count),
of the snapshot ring (rollback) and of the model store (store_restore,
get_store_status), and the engine's IDL methods, each under its wire
name, arity and wire shape, with the leading cluster-name parameter every
jubatus call carries (the mixer registers its own ``mix_*`` RPCs). Update
methods run under the driver lock and bump the driver's update counter
when the driver did not.
The classifier's and regression's ``train`` go through the microbatch
coalescer (``server/microbatch.py``), which bills each ticket to its
principal in the usage ledger and, on the pipelined path, stamps the
``fv.convert`` and ``fv.upload`` spans; a sampled train batch is first
scored on the current model for the data-quality plane
(``_quality_observe_pairs``, test-then-train). In a fleet, anomaly's ``add`` and
graph's ``create_node`` mint a cluster-unique id and place it on its CHT(2)
owners by direct peer RPC (``_replicated_write``: ``overwrite`` and
``create_node_here`` on each owner, the primary's result answered), as the
JAX server does, so the CHT-routed calls that follow through a proxy find
the row on its owners; standalone they apply locally. Graph's internal
RPCs (``create_node_here``, ``remove_global_node``, ``create_edge_here``)
are registered for the peers and never exposed on a proxy.

The raw-wire path (``_register_train_raw``): when the converter config is
one the native parser (``native/ingest.py``) can express, the linear
classifier's and regression's ``train``, ``classify`` and ``estimate``
also register a raw handler. It parses the request's msgpack bytes in C++
straight to hashed [B, K] arrays, coalesces them (``train_raw`` and the
``*_raw`` query coalescers) and feeds the driver's hashed entry points;
a uniform-schema flush rides the dense schema plan, a combination config
the device-expanded combo plan, a pure-idf config the deferred idf. A
request the parser declines answers ``RAW_FALLBACK`` and is served by the
generic handler, with the same semantics.
"""

from __future__ import annotations

import json
import logging
from typing import Any, Callable, Dict, List

import msgpack
import numpy as np

from jubatus_tpu_torch.core.datum import Datum
from jubatus_tpu_torch.native.ingest import IngestParser, deferred_idf_scale
from jubatus_tpu_torch.rpc.server import RAW_FALLBACK, RpcServer, deferred
from jubatus_tpu_torch.server.microbatch import Coalescer, PipelinedCoalescer


log = logging.getLogger(__name__)


def _datum(obj: Any) -> Datum:
    return Datum.from_msgpack(obj)


def _datums(objs: Any) -> List[Datum]:
    return [Datum.from_msgpack(o) for o in objs]


def _wire_datum(d: Datum):
    return d.to_msgpack()


def _scored(results: List) -> List:
    """[(id, score)] → [[id, score]] (id_with_score wire shape)."""
    return [[i, float(s)] for i, s in results]


_BINDERS: Dict[str, Callable[[RpcServer, Any], None]] = {}


def _binder(engine: str):
    def deco(fn):
        _BINDERS[engine] = fn
        return fn

    return deco


def bind_engine(rpc: RpcServer, server: Any) -> None:
    """Register built-ins + the engine's IDL surface on the RPC server."""
    rpc.register("get_config", server.get_config, arity=1)
    rpc.register("save", server.save, arity=2)
    rpc.register("load", server.load, arity=2)
    rpc.register("get_status", server.get_status, arity=1)
    # forensics plane: mergeable metrics, the per-trace span store, the
    # slow-request ring, the folded stack profile and device captures
    rpc.register("get_metrics", server.get_metrics, arity=1)
    rpc.register("get_spans", server.get_spans, arity=2)
    rpc.register("get_slow_log", server.get_slow_log, arity=1)
    rpc.register("get_profile", server.get_profile, arity=2)
    # a capture runs for seconds: on a thread of its own, holding no worker
    rpc.register("profile_device",
                 deferred(server.profile_device, "device-capture"), arity=2)
    # model-health plane: the metric time series and the SLO alerts
    rpc.register("get_timeseries", server.get_timeseries, arity=1)
    rpc.register("get_alerts", server.get_alerts, arity=1)
    # data-quality plane and usage ledger: mergeable docs
    rpc.register("get_quality", server.get_quality, arity=1)
    rpc.register("get_usage", server.get_usage, arity=1)
    # self-tuning performance plane: tuner state + decision journal
    rpc.register("get_tune", server.get_tune, arity=1)
    # event plane: the HLC-ordered journal (cursor-resumable) and the
    # capped incident bundles
    rpc.register("get_events", server.get_events, arity=3)
    rpc.register("get_incidents", server.get_incidents, arity=2)
    rpc.register("do_mix", server.do_mix, arity=1)
    # elastic membership: ring version, drain control and the migration
    # data plane (framework/migration.py); row payloads travel as msgpack
    # bin, and binary=True keeps them so even under --legacy-wire
    rpc.register("get_epoch", server.get_epoch, arity=1)
    rpc.register("drain", server.drain, arity=2)
    rpc.register("drain_status", server.drain_status, arity=1)
    rpc.register("rebalance", server.rebalance, arity=1)
    rpc.register("migrate_range", server.migrate_range, arity=5,
                 binary=True)
    rpc.register("put_rows", server.put_rows, arity=2, binary=True)
    rpc.register("get_row_count", server.get_row_count, arity=1)
    # model-integrity plane: restore the last-good snapshot
    rpc.register("rollback", server.rollback, arity=2)
    # durable model plane: point-in-time restore + the store's status
    rpc.register("store_restore", server.store_restore, arity=2)
    rpc.register("get_store_status", server.get_store_status, arity=1)
    _BINDERS[server.engine](rpc, server)


def _updating(server: Any, fn: Callable,
              count: Callable[[Any], int] = lambda r: 1) -> Callable:
    """Driver lock + ``count(result)`` update events, unless the driver
    counted them itself."""

    def wrapped(*args):
        with server.driver.lock:
            before = server.driver.update_count
            result = fn(*args)
            if server.driver.update_count == before:
                n = count(result)
                if n:
                    server.driver.event_model_updated(n)
        return result

    return wrapped


class _ComboPlanCache:
    """Device-expansion plans for combination-rule configs, keyed by the
    base index row (the feature schema). The C++ base parser ships only
    the [B, K0] base columns; the plan carries the full base+slot index
    vector and the (a, b, op) bilinear terms the device expands
    (ops.train_batch_schema_combo). Slot hashes and pair structure come from the
    Python converter's own combo plan (core/fv/converter.py) — the
    single owner of combination semantics — validated against the C++
    row by hashing a sample datum's base names. Schemas the plan cannot
    serve exactly (hash collisions, idf/user weights, multi-term slots)
    are declined and the request falls back to the generic
    batch-converter path with identical semantics."""

    _MISS = object()

    class Plan:
        __slots__ = ("uidx", "a_idx", "b_idx", "mul_mask")

        def __init__(self, uidx, a_idx, b_idx, mul_mask):
            self.uidx = uidx
            self.a_idx = a_idx
            self.b_idx = b_idx
            self.mul_mask = mul_mask

    def __init__(self, conv: dict, converter) -> None:
        self._conv = conv or {}
        self._converter = converter  # the driver's full converter
        self._plans: Dict[bytes, Any] = {}

    def make_base_parser(self, dim_bits: int):
        """The C++ parser for the config SANS combination rules (base
        features only); None when that subset is not native-expressible."""
        base_conv = {k: v for k, v in self._conv.items()
                     if k != "combination_rules"}
        return IngestParser.from_converter_config(base_conv, dim_bits)

    def _plan_for(self, row0, raw_params: bytes, with_labels: bool):
        key = row0.tobytes()
        plan = self._plans.get(key, self._MISS)
        if plan is not self._MISS:
            return plan
        plan = self._build(row0, raw_params, with_labels)
        if len(self._plans) >= 64:
            self._plans.clear()
        self._plans[key] = plan
        return plan

    def _build(self, row0, raw_params: bytes, with_labels: bool):
        try:
            req = msgpack.unpackb(raw_params, raw=False,
                                  strict_map_key=False, use_list=True,
                                  unicode_errors="surrogateescape")
            wire = req[1][0][1] if with_labels else req[1][0]
            datum = Datum.from_msgpack(wire)
        except Exception:  # broad-ok — undecodable sample: decline plan
            return None
        conv = self._converter
        named = conv._base_named_features(datum)
        names = list(named)
        live = row0[row0 != 0]
        if len(names) != live.shape[0]:
            return None  # hash collision merged base columns
        idxs, kinds = conv._resolve_names(names)
        order = np.argsort(idxs, kind="stable")
        if not np.array_equal(idxs[order], live.astype(np.int32)):
            return None  # sample's schema does not explain the row
        if kinds.any():
            return None  # base features must be bin-weighted
        sorted_names = tuple(names[i] for i in order)
        cplan = conv._combo_plan_for(sorted_names)
        if cplan.slot_kind.any():
            return None  # combo slots must be bin-weighted
        if cplan.t_starts.shape[0] != cplan.a_idx.shape[0]:
            return None  # multi-term slots: host semantics required
        nz = np.concatenate([live.astype(np.int32), cplan.slot_idx])
        if np.unique(nz).shape[0] != nz.shape[0]:
            return None  # index collision: expansion would double-count
        uidx = np.concatenate([row0.astype(np.int32), cplan.slot_idx])
        return self.Plan(uidx, cplan.a_idx, cplan.b_idx,
                         cplan.mul_mask.astype(bool))

    def parse_train(self, base_parser, raw_params: bytes):
        """Raw train params -> a coalescer item riding the device-
        expansion plan, or RAW_FALLBACK (generic path, same semantics)."""
        parsed = base_parser.parse_indexed(raw_params)
        if parsed is None:
            return RAW_FALLBACK
        labels, idx, val = parsed
        if isinstance(labels, np.ndarray):
            return RAW_FALLBACK  # numeric labels on a classifier wire
        b = idx.shape[0]
        if b == 0:
            return RAW_FALLBACK
        row0 = idx[0]
        if b > 1 and not (idx == row0).all():
            return RAW_FALLBACK  # mixed schemas in one request
        plan = self._plan_for(row0, raw_params, with_labels=True)
        if plan is None:
            return RAW_FALLBACK
        return (("combo", plan), labels, idx, val)

    def parse_query(self, base_parser, raw_params: bytes):
        """Raw datum-list params -> (plan, base_val) or RAW_FALLBACK."""
        parsed = base_parser.parse_datums(raw_params)
        if parsed is None:
            return RAW_FALLBACK
        idx, val = parsed
        if idx.shape[0] == 0:
            return (None, val)
        row0 = idx[0]
        if idx.shape[0] > 1 and not (idx == row0).all():
            return RAW_FALLBACK
        plan = self._plan_for(row0, raw_params, with_labels=False)
        if plan is None:
            return RAW_FALLBACK
        return (plan, val)


def _quality_observe_pairs(server: Any, pairs) -> None:
    """Prequential (test-then-train) hook of the train path: on a sampled
    batch, score a bounded prefix with the CURRENT model before the update
    is submitted, and record the label distribution. Failures are logged
    and never reach ingest."""
    q = getattr(server, "quality", None)
    if q is None or not pairs or not q.admit("train"):
        return
    d = server.driver
    sub = pairs[:q.max_score_rows]
    try:
        q.record_labels(p[0] for p in pairs)
        data = [p[1] for p in sub]
        if isinstance(sub[0][0], str) and hasattr(d, "classify"):
            for (truth, _dat), ranked in zip(sub, d.classify(data)):
                q.record_classified(truth, ranked)
        elif hasattr(d, "estimate"):
            for (truth, _dat), est in zip(sub, d.estimate(data)):
                q.record_estimated(float(truth), float(est))
    except Exception:  # broad-ok — quality scoring must not break ingest
        server.trace.count("quality.score_errors")
        log.debug("prequential hook failed", exc_info=True)


def _quality_observe_raw(server: Any, item, numeric: bool) -> None:
    """Prequential + feature-stat hook for the native raw-ingest path:
    names never materialize here, so values record under the ``hashed``
    group; scoring rides classify_hashed/estimate_hashed on a bounded
    row prefix. Combo-plan items skip scoring (the base arrays are not
    the model's input rows)."""
    q = getattr(server, "quality", None)
    if q is None or not q.admit("train"):
        return
    d = server.driver
    tag, labels, idx, val = item
    try:
        q.record_hashed(val)
        if tag[0] != "plain":
            return
        k = min(q.max_score_rows, idx.shape[0])
        if numeric:
            if hasattr(d, "estimate_hashed"):
                for t, e in zip(labels[:k], d.estimate_hashed(idx[:k],
                                                              val[:k])):
                    q.record_estimated(float(t), float(e))
        else:
            uniq, lidx = labels
            q.record_labels(uniq[int(j)] for j in lidx)
            if hasattr(d, "classify_hashed"):
                ranked = d.classify_hashed(idx[:k], val[:k])
                for j, r in enumerate(ranked):
                    q.record_classified(uniq[int(lidx[j])], r)
    except Exception:  # broad-ok — quality scoring must not break ingest
        server.trace.count("quality.score_errors")
        log.debug("raw prequential hook failed", exc_info=True)


def _usage_batch_hook(server: Any, method: str):
    """The coalescer's billing hook: once a ticket a flush, the tenant, its
    rows, its queue seconds and its share of the flush's seconds go to the
    usage ledger. None (no hook, no cost) when the ledger is off."""
    u = getattr(server, "usage", None)
    if u is None:
        return None

    def hook(principal, rows, queue_s, device_s):
        u.record_batch(principal, method, rows, queue_s, device_s)

    return hook


def _register_train(rpc: RpcServer, server: Any, decode_pair,
                    train_fn) -> None:
    """Register "train" with microbatch coalescing: concurrent train RPCs
    merge into one driver batch (``--microbatch-max``; 0 = one driver call
    per RPC). Either way each caller's reply is its own item count.
    Drivers with the featurize / apply split (``featurize_train`` +
    ``train_hashed``) ride the two-stage PipelinedCoalescer: the next
    batch featurizes on the host while the device takes the previous."""
    max_batch = getattr(server.args, "microbatch_max", 8192)
    flush = _updating(server, train_fn, count=lambda r: r)
    if not max_batch:
        def train_direct(name, data):
            pairs = [decode_pair(p) for p in data]
            _quality_observe_pairs(server, pairs)
            return flush(pairs)

        rpc.register("train", train_direct, arity=2)
        return
    driver = server.driver
    featurize = getattr(driver, "featurize_train", None)
    apply_fn = getattr(driver, "train_hashed", None)
    if featurize is not None and apply_fn is not None:
        device_step = _updating(server, lambda prepared: apply_fn(*prepared),
                                count=lambda r: r)
        co = PipelinedCoalescer(featurize, device_step, max_batch=max_batch,
                                trace=rpc.trace)
    else:
        co = Coalescer(flush, max_batch=max_batch)
    server.coalescers["train"] = co
    co.usage_hook = _usage_batch_hook(server, "train")
    # -t 0 conventionally means "no timeout": an unbounded wait
    wait_s = server.args.timeout * 6 if server.args.timeout > 0 else None

    def train(name, data):
        pairs = [decode_pair(p) for p in data]
        if not pairs:
            return 0
        # test-then-train: prequential scoring sees the pre-update model
        _quality_observe_pairs(server, pairs)
        co.submit(pairs, timeout=wait_s)
        return len(pairs)

    rpc.register("train", train, arity=2)


def _register_train_raw(rpc: RpcServer, server: Any, numeric: bool) -> None:
    """Native ingest fast path for ``train`` (native/fast_ingest.cpp): the
    request's raw msgpack params parse in C++ straight to pre-hashed [B, K]
    arrays — no Datum objects, no Python convert loop. Registered only
    when the driver has ``train_hashed`` and the converter config is
    expressible in the native parser
    (``native/ingest.py`` decides); any request the parser declines
    (unexpected wire shape, unrepresentable values) falls back to the
    generic decode + converter path, so behavior is identical either way.
    A failed build of the parser raises here, at server start: it is
    never taken for a declined config. Each flush hands the driver one
    merged [B, K] batch, which it moves to its device once."""
    driver = server.driver
    if not hasattr(driver, "train_hashed"):
        return
    conv = json.loads(server.config_json).get("converter")
    parser = IngestParser.from_converter_config(
        conv, driver.converter.hasher.dim_bits)
    if parser is None:
        return

    def _pad_concat(pairs):
        """Merge per-request (idx, val) pairs into one batch: pad widths
        to the max (already pow2-bucketed by the parser, so pads are rare
        and small) and concatenate at numpy speed. ONE owner for both the
        train and query flush paths."""
        kmax = max(i.shape[1] for i, _ in pairs)
        parts_i, parts_v = [], []
        for ir, vr in pairs:
            if ir.shape[1] != kmax:
                pad = kmax - ir.shape[1]
                ir = np.pad(ir, ((0, 0), (0, pad)))
                vr = np.pad(vr, ((0, 0), (0, pad)))
            parts_i.append(ir)
            parts_v.append(vr)
        return (np.concatenate(parts_i) if len(parts_i) > 1 else parts_i[0],
                np.concatenate(parts_v) if len(parts_v) > 1 else parts_v[0])

    def _uniform_row(pairs):
        """The shared index row if EVERY row of every (idx, val) pair
        equals the first one (same width), else None. A fixed key schema
        — the common production feed shape — hashes every datum to the
        same index vector; detecting it per flush costs ~B*K int
        compares (~0.02 µs/sample) and unlocks the dense submatrix train
        plan (ops.train_batch_schema: no B*K-element gathers/scatters)."""
        first = pairs[0][0]
        row0 = first[0]
        k = first.shape[1]
        for ir, _vr in pairs:
            if ir.shape[1] != k or not (ir == row0).all():
                return None
        return row0

    schema_train = getattr(driver, "train_indexed_schema", None)
    combo_train = getattr(driver, "train_indexed_combo", None)
    # schema-plan accounting, surfaced by get_status ("ingest.*" keys,
    # server/base.py): how often flushes actually ride the dense
    # submatrix plan
    stats = server.ingest_stats = {"schema_flushes": 0, "sparse_flushes": 0,
                                   "combo_flushes": 0,
                                   "schema_query_flushes": 0,
                                   "sparse_query_flushes": 0}

    # deferred-idf (pure-idf specs): parses run lock-free against zero df
    # tables; ONE observe+scale per coalesced flush (the idf
    # batch-collapse fix — see native/ingest.py deferred_idf_scale)
    deferred = parser.deferred_idf
    weights = driver.converter.weights \
        if (parser.needs_weights or deferred) else None

    # combo device plan (classifier combo configs): parse only the BASE
    # features in C++, expand the cross product ON DEVICE
    # (ops.train_batch_schema_combo) — the (K0+S)-wide row never crosses
    # the host/device wire. None when ineligible; requests the plan
    # cannot serve fall back to the generic batch-converter path.
    combo_ctx = None
    if combo_train is not None and not numeric \
            and (conv or {}).get("combination_rules"):
        combo_ctx = _ComboPlanCache(conv, driver.converter)
        base_parser = combo_ctx.make_base_parser(
            driver.converter.hasher.dim_bits)
        if base_parser is None:
            combo_ctx = None

    def _merge_labels(label_pairs):
        """Union per-request (uniq_labels, label_idx) pairs into one
        distinct-label list + remapped int32 row index — no per-example
        Python loop (the C++ dedup did the heavy lifting)."""
        label_map: dict = {}
        parts_l = []
        for uniq, lidx in label_pairs:
            lut = np.empty(len(uniq), np.int32)
            for j, u in enumerate(uniq):
                lut[j] = label_map.setdefault(u, len(label_map))
            parts_l.append(lut[lidx])
        lidx = np.concatenate(parts_l) if len(parts_l) > 1 else parts_l[0]
        return list(label_map), lidx

    def prep_requests(reqs):
        """Stage 1 (host) of the pipelined flush: merge per-request
        arrays into ONE device-ready batch — label-map union, width
        pad+concat, deferred-idf observe+scale, execution-plan selection.
        Runs on the flusher thread while the device consumes the
        previous batch."""
        if not reqs:
            return None
        if reqs[0][0][0] == "combo":
            # (("combo", plan), labels, base_idx, base_val): group by
            # plan (one group for a fixed-schema feed) for the
            # device-expansion path
            groups: dict = {}
            for tag, lb, _ir, vr in reqs:
                entry = groups.setdefault(id(tag[1]), (tag[1], [], []))
                entry[1].append(lb)
                entry[2].append(vr)
            out = []
            for plan, lbs, vals in groups.values():
                uniq, lidx = _merge_labels(lbs)
                val = np.concatenate(vals) if len(vals) > 1 else vals[0]
                out.append((uniq, lidx, plan, val))
            stats["combo_flushes"] += 1
            return ("combo", out)
        if numeric:
            idx, val = _pad_concat([(ir, vr) for _t, _lb, ir, vr in reqs])
            labels = np.concatenate([r[1] for r in reqs]) \
                if len(reqs) > 1 else reqs[0][1]
            return ("numeric", labels, idx, val)
        uniq, lidx = _merge_labels([lb for _t, lb, _i, _v in reqs])
        if schema_train is not None and not deferred:
            row0 = _uniform_row([(ir, vr) for _t, _lb, ir, vr in reqs])
            if row0 is not None:
                stats["schema_flushes"] += 1
                val = np.concatenate([vr for _t, _lb, _ir, vr in reqs]) \
                    if len(reqs) > 1 else reqs[0][3]
                return ("schema", uniq, lidx, row0, val)
        stats["sparse_flushes"] += 1
        idx, val = _pad_concat([(ir, vr) for _t, _lb, ir, vr in reqs])
        if deferred:
            val = deferred_idf_scale(idx, val, weights, observe=True)
        return ("sparse", uniq, lidx, idx, val)

    def apply_prepared(prepared):
        """Stage 2 (device): dispatch the prepared batch onto the
        matching driver plan."""
        if prepared is None:
            return 0
        kind = prepared[0]
        if kind == "combo":
            n = 0
            for uniq, lidx, plan, val in prepared[1]:
                n += combo_train(uniq, lidx, plan.uidx, val,
                                 plan.a_idx, plan.b_idx, plan.mul_mask)
            return n
        if kind == "numeric":
            return driver.train_hashed(prepared[1], prepared[2], prepared[3])
        if kind == "schema":
            return schema_train(prepared[1], prepared[2], prepared[3],
                                prepared[4])
        return driver.train_indexed(prepared[1], prepared[2], prepared[3],
                                    prepared[4])

    max_batch = getattr(server.args, "microbatch_max", 8192)
    wait_s = server.args.timeout * 6 if server.args.timeout > 0 else None
    device_step = _updating(server, apply_prepared, count=lambda r: r)
    if max_batch:
        co = PipelinedCoalescer(
            prep_requests, device_step, max_batch=max_batch,
            weigher=lambda item: item[2].shape[0], trace=rpc.trace)
        server.coalescers["train_raw"] = co
        co.usage_hook = _usage_batch_hook(server, "train")
    trace = rpc.trace

    def train_raw(raw_params: bytes):
        with trace.span("fv.convert"):
            if combo_ctx is not None:
                item = combo_ctx.parse_train(base_parser, raw_params)
                if item is RAW_FALLBACK:
                    return RAW_FALLBACK  # generic batch-converter path
            elif weights is not None and not deferred:
                with weights.lock:
                    parsed = parser.parse_indexed(raw_params,
                                                  weights=weights)
            else:
                # deferred idf / unweighted: lock-free parallel parse
                parsed = parser.parse_indexed(raw_params)
        if combo_ctx is None:
            if parsed is None:
                return RAW_FALLBACK
            labels, idx, val = parsed
            if numeric != isinstance(labels, np.ndarray):
                return RAW_FALLBACK  # label kind mismatch: let the
                # generic path produce the proper type error
            item = (("plain",), labels, idx, val)
        n = item[2].shape[0]
        if n == 0:
            return 0
        # test-then-train: prequential scoring sees the pre-update model
        _quality_observe_raw(server, item, numeric)
        if max_batch:
            co.submit([item], timeout=wait_s)
        else:
            device_step(prep_requests([item]))
        return n

    rpc.register_raw("train", train_raw)

    # the query path rides the same parser: [name, [datum, ...]] -> hashed
    # batch -> snapshot-read scores, no Datum objects
    def _parse_datums(raw_params: bytes):
        if deferred:
            # lock-free parse, then one vectorized idf gather (queries
            # read idf, never observe)
            parsed = parser.parse_datums(raw_params)
            if parsed is None:
                return None
            idx, val = parsed
            return idx, deferred_idf_scale(idx, val, weights,
                                           observe=False)
        if weights is not None:
            with weights.lock:  # queries read idf, never observe
                return parser.parse_datums(raw_params, weights=weights)
        return parser.parse_datums(raw_params)

    def _query_coalescer(name: str, score_batch, schema_score=None):
        """Query-plane microbatching (the mirror of the train coalescer):
        concurrent read requests join ONE device dispatch against the
        same model snapshot — every kernel launch costs ~ms on an
        accelerator regardless of batch size, so per-request dispatch
        caps the query plane at launches/s, not samples/s.
        ``score_batch(idx, val) -> per-row results``; each request gets
        exactly its rows back (Coalescer split_results).
        ``schema_score(uidx, val)`` is the uniform-schema dense variant,
        taken whenever the flush's rows all share one index vector."""
        def query_flush(items):
            if schema_score is not None:
                row0 = _uniform_row(items)
                if row0 is not None:
                    stats["schema_query_flushes"] += 1
                    if len(items) == 1:
                        return [schema_score(row0, items[0][1])]
                    vals = np.concatenate([v for _i, v in items])
                    rows = schema_score(row0, vals)
                    out, off = [], 0
                    for i, _ in items:
                        out.append(rows[off:off + i.shape[0]])
                        off += i.shape[0]
                    return out
            stats["sparse_query_flushes"] += 1
            if len(items) == 1:
                i, v = items[0]
                return [score_batch(i, v)]
            rows = score_batch(*_pad_concat(items))
            out, off = [], 0
            for i, _ in items:
                out.append(rows[off:off + i.shape[0]])
                off += i.shape[0]
            return out

        qco = Coalescer(query_flush, max_batch=max_batch,
                        weigher=lambda it: it[0].shape[0],
                        split_results=True)
        server.coalescers[name] = qco
        # bill under the wire method ("classify"), not the coalescer key
        qco.usage_hook = _usage_batch_hook(
            server, name[:-4] if name.endswith("_raw") else name)

        def raw_handler(raw_params: bytes):
            with trace.span("fv.convert"):
                parsed = _parse_datums(raw_params)
            if parsed is None:
                return RAW_FALLBACK
            idx, val = parsed
            if idx.shape[0] == 0:
                return []
            (mine,) = qco.submit([(idx, val)], timeout=wait_s)
            return mine

        return raw_handler

    if numeric and hasattr(driver, "estimate_hashed"):
        if max_batch:
            rpc.register_raw("estimate", _query_coalescer(
                "estimate_raw", driver.estimate_hashed))
        else:
            def estimate_raw(raw_params: bytes):
                parsed = _parse_datums(raw_params)
                if parsed is None:
                    return RAW_FALLBACK
                return driver.estimate_hashed(*parsed)

            rpc.register_raw("estimate", estimate_raw)
    elif combo_ctx is not None and hasattr(driver, "classify_hashed_combo"):
        def classify_combo_raw(raw_params: bytes):
            with trace.span("fv.convert"):
                out = combo_ctx.parse_query(base_parser, raw_params)
            if out is RAW_FALLBACK:
                return RAW_FALLBACK
            plan, val = out
            if plan is None:
                return []
            rows = driver.classify_hashed_combo(
                plan.uidx, val, plan.a_idx, plan.b_idx, plan.mul_mask)
            return [_scored(r) for r in rows]

        rpc.register_raw("classify", classify_combo_raw)
    elif not numeric and hasattr(driver, "classify_hashed"):
        if max_batch:
            schema_cls = getattr(driver, "classify_hashed_schema", None)
            rpc.register_raw("classify", _query_coalescer(
                "classify_raw",
                lambda i, v: [_scored(r)
                              for r in driver.classify_hashed(i, v)],
                schema_score=None if schema_cls is None else
                (lambda u, v: [_scored(r) for r in schema_cls(u, v)])))
        else:
            def classify_raw(raw_params: bytes):
                parsed = _parse_datums(raw_params)
                if parsed is None:
                    return RAW_FALLBACK
                return [_scored(r) for r in driver.classify_hashed(*parsed)]

            rpc.register_raw("classify", classify_raw)


@_binder("nearest_neighbor")
def _bind_nearest_neighbor(rpc: RpcServer, server: Any) -> None:
    d = server.driver
    rpc.register("clear", _updating(server, lambda name: (d.clear(), True)[1]), arity=1)
    rpc.register("set_row", _updating(server, lambda name, rid, dat: d.set_row(rid, _datum(dat))), arity=3)
    rpc.register("neighbor_row_from_id",
                 lambda name, rid, size: _scored(d.neighbor_row_from_id(rid, int(size))), arity=3)
    rpc.register("neighbor_row_from_datum",
                 lambda name, q, size: _scored(d.neighbor_row_from_datum(_datum(q), int(size))), arity=3)
    rpc.register("similar_row_from_id", lambda name, rid, n: _scored(d.similar_row_from_id(rid, int(n))),
                 arity=3)
    rpc.register("similar_row_from_datum",
                 lambda name, q, n: _scored(d.similar_row_from_datum(_datum(q), int(n))), arity=3)
    rpc.register("get_all_rows", lambda name: d.get_all_rows(), arity=1)


@_binder("recommender")
def _bind_recommender(rpc: RpcServer, server: Any) -> None:
    d = server.driver
    rpc.register("clear_row", _updating(server, lambda name, rid: d.clear_row(rid)), arity=2)
    rpc.register(
        "update_row",
        _updating(server, lambda name, rid, row: d.update_row(rid, _datum(row))),
        arity=3,
    )
    rpc.register("clear", _updating(server, lambda name: (d.clear(), True)[1]), arity=1)
    rpc.register("complete_row_from_id", lambda name, rid: _wire_datum(d.complete_row_from_id(rid)), arity=2)
    rpc.register("complete_row_from_datum",
                 lambda name, row: _wire_datum(d.complete_row_from_datum(_datum(row))), arity=2)
    rpc.register("similar_row_from_id",
                 lambda name, rid, size: _scored(d.similar_row_from_id(rid, int(size))), arity=3)
    rpc.register("similar_row_from_datum",
                 lambda name, row, size: _scored(d.similar_row_from_datum(_datum(row), int(size))), arity=3)
    rpc.register("decode_row", lambda name, rid: _wire_datum(d.decode_row(rid)), arity=2)
    rpc.register("get_all_rows", lambda name: d.get_all_rows(), arity=1)
    rpc.register("calc_similarity", lambda name, lhs, rhs: float(d.calc_similarity(_datum(lhs), _datum(rhs))),
                 arity=3)
    rpc.register("calc_l2norm", lambda name, row: float(d.calc_l2norm(_datum(row))), arity=2)


def _replicated_write(server: Any, key: str, apply_local, apply_remote,
                      replication: int = 2):
    """Server-side CHT-replicated write (≙ anomaly_serv.cpp:178-211,
    graph_serv.cpp:181-228): place ``key`` on its ``replication`` ring
    successors — apply locally when a successor is me, RPC the peer
    otherwise. The primary write must succeed (exceptions propagate);
    replicas are best-effort (warn + continue). Returns the primary's
    result. Falls back to a local-only apply when the ring is empty."""
    cht = server.cluster_cht()
    nodes = cht.find(key, replication) if cht is not None else []
    if not nodes:
        return apply_local()
    me = server.self_nodeinfo()
    result = None
    for i, node in enumerate(nodes):
        try:
            if node.name == me.name:
                out = apply_local()
            else:
                out = apply_remote(server.peer_client(node))
            if i == 0:
                result = out
        except Exception:  # broad-ok — replica writes are best-effort
            if i == 0:
                raise  # primary failure is the caller's failure
            server.drop_peer_client(node)
            log.warning("replica write to %s failed (best-effort)",
                        node.name, exc_info=True)
    return result


@_binder("anomaly")
def _bind_anomaly(rpc: RpcServer, server: Any) -> None:
    d = server.driver
    rpc.register("clear_row", _updating(server, lambda name, rid: d.clear_row(rid)), arity=2)

    def add(name, row):
        """Distributed add = mint id + CHT(2) placement + primary write +
        best-effort replica, INSIDE the server — a direct-to-server add is
        replicated immediately, not at the next mix (anomaly_serv.cpp:
        155-211). Standalone keeps the driver's local add."""
        if server.coord is None:
            return list(_updating(server, lambda: d.add(_datum(row)))())
        row_id = str(d.idgen.generate()) if getattr(d, "idgen", None) \
            else None
        if row_id is None:
            return list(_updating(server, lambda: d.add(_datum(row)))())
        score = _replicated_write(
            server, row_id,
            apply_local=_updating(
                server, lambda: float(d.overwrite(row_id, _datum(row)))),
            apply_remote=lambda cli: float(
                cli.call("overwrite", name, row_id, row)),
        )
        return [row_id, float(score)]

    rpc.register("add", add, arity=2)
    rpc.register("update", _updating(server, lambda name, rid, row: float(d.update(rid, _datum(row)))),
                 arity=3)
    rpc.register("overwrite", _updating(server, lambda name, rid, row: float(d.overwrite(rid, _datum(row)))),
                 arity=3)
    rpc.register("clear", _updating(server, lambda name: (d.clear(), True)[1]), arity=1)
    rpc.register("calc_score", lambda name, row: float(d.calc_score(_datum(row))), arity=2)
    rpc.register("get_all_rows", lambda name: d.get_all_rows(), arity=1)


@_binder("classifier")
def _bind_classifier(rpc: RpcServer, server: Any) -> None:
    """Both classifier drivers: the linear one (its train pipelined) and
    the instance-based one."""
    d = server.driver
    _register_train(rpc, server, lambda p: (p[0], _datum(p[1])), d.train)
    _register_train_raw(rpc, server, numeric=False)
    rpc.register("classify",
                 lambda name, data: [_scored(r) for r in d.classify(_datums(data))],
                 arity=2)
    rpc.register("get_labels", lambda name: {k: int(v) for k, v in d.get_labels().items()}, arity=1)
    rpc.register("set_label", _updating(server, lambda name, lbl: d.set_label(lbl)), arity=2)
    rpc.register("delete_label", _updating(server, lambda name, lbl: d.delete_label(lbl)), arity=2)
    rpc.register("clear", _updating(server, lambda name: (d.clear(), True)[1]), arity=1)


@_binder("regression")
def _bind_regression(rpc: RpcServer, server: Any) -> None:
    d = server.driver
    _register_train(rpc, server, lambda p: (float(p[0]), _datum(p[1])),
                    d.train)
    _register_train_raw(rpc, server, numeric=True)
    rpc.register("estimate",
                 lambda name, data: [float(x) for x in d.estimate(_datums(data))],
                 arity=2)
    rpc.register("clear", _updating(server, lambda name: (d.clear(), True)[1]), arity=1)


@_binder("graph")
def _bind_graph(rpc: RpcServer, server: Any) -> None:
    d = server.driver

    def edge_parts(e):
        """wire edge [property_map, source, target] → driver arg order
        (source, target, properties)."""
        return e[1], e[2], dict(e[0])

    def create_node(name):
        """Distributed create_node = mint global id + create_node_here on
        the CHT(2) successors via direct peer RPC (graph_serv.cpp:181-228)
        — a direct-to-server create is visible on its replica before any
        mix. Standalone keeps the local driver path."""
        if server.coord is None:
            return _updating(server, lambda: d.create_node())()
        node_id = str(d.idgen.generate()) if getattr(d, "idgen", None) \
            else None
        if node_id is None:
            return _updating(server, lambda: d.create_node())()
        _replicated_write(
            server, node_id,
            apply_local=_updating(
                server, lambda: d.create_node_here(node_id)),
            apply_remote=lambda cli: cli.call(
                "create_node_here", name, node_id),
        )
        return node_id

    rpc.register("create_node", create_node, arity=1)
    rpc.register("remove_node", _updating(server, lambda name, nid: d.remove_node(nid)), arity=2)
    rpc.register("update_node", _updating(server, lambda name, nid, prop: d.update_node(nid, dict(prop))),
                 arity=3)
    rpc.register(
        "create_edge",
        _updating(server, lambda name, nid, e: d.create_edge(nid, *edge_parts(e))),
        arity=3,
    )
    rpc.register(
        "update_edge",
        _updating(server, lambda name, nid, eid, e: d.update_edge(nid, int(eid), *edge_parts(e))),
        arity=4,
    )
    rpc.register("remove_edge", _updating(server, lambda name, nid, eid: d.remove_edge(nid, int(eid))),
                 arity=3)
    rpc.register("get_centrality", lambda name, nid, ct, q: float(d.get_centrality(nid, int(ct), q)), arity=4)
    rpc.register("add_centrality_query", _updating(server, lambda name, q: d.add_centrality_query(q)),
                 arity=2)
    rpc.register("add_shortest_path_query", _updating(server, lambda name, q: d.add_shortest_path_query(q)),
                 arity=2)
    rpc.register("remove_centrality_query", _updating(server, lambda name, q: d.remove_centrality_query(q)),
                 arity=2)
    rpc.register("remove_shortest_path_query", _updating(server,
                 lambda name, q: d.remove_shortest_path_query(q)), arity=2)
    rpc.register(
        "get_shortest_path",
        lambda name, q: d.get_shortest_path(q[0], q[1], int(q[2]), q[3] if len(q) > 3 else None),
        arity=2,
    )
    rpc.register("update_index", _updating(server, lambda name: d.update_index()), arity=1)
    rpc.register("clear", _updating(server, lambda name: (d.clear(), True)[1]), arity=1)
    rpc.register(
        "get_node",
        lambda name, nid: (lambda n: [n["property"], n["in_edges"], n["out_edges"]])(d.get_node(nid)),
        arity=2,
    )
    rpc.register(
        "get_edge",
        lambda name, nid, eid: (lambda e: [e["property"], e["source"],
                                           e["target"]])(d.get_edge(nid, int(eid))),
        arity=3,
    )
    rpc.register("create_node_here", _updating(server, lambda name, nid: d.create_node_here(nid)), arity=2)
    rpc.register("remove_global_node", _updating(server, lambda name, nid: d.remove_global_node(nid)),
                 arity=2)
    rpc.register(
        "create_edge_here",
        _updating(server, lambda name, eid, e: d.create_edge_here(int(eid), *edge_parts(e))),
        arity=3,
    )


@_binder("burst")
def _bind_burst(rpc: RpcServer, server: Any) -> None:
    d = server.driver

    def wire_window(w):
        """driver window dict → wire [start_pos, [[all, rel, weight]...]]."""
        return [w["start_pos"],
                [[b["all_data_count"], b["relevant_data_count"],
                  b["burst_weight"]] for b in w["batches"]]]

    rpc.register(
        "add_documents",
        lambda name, docs: _updating(
            server,
            lambda: d.add_documents([(float(p), t) for p, t in docs]),
            count=lambda r: r,
        )(),
        arity=2,
    )
    rpc.register("get_result", lambda name, kw: wire_window(d.get_result(kw)), arity=2)
    rpc.register("get_result_at", lambda name, kw, pos: wire_window(d.get_result_at(kw, float(pos))), arity=3)
    rpc.register(
        "get_all_bursted_results",
        lambda name: {k: wire_window(w) for k, w in d.get_all_bursted_results().items()},
        arity=1,
    )
    rpc.register(
        "get_all_bursted_results_at",
        lambda name, pos: {k: wire_window(w) for k, w in d.get_all_bursted_results_at(float(pos)).items()},
        arity=2,
    )
    rpc.register(
        "get_all_keywords",
        lambda name: [[k["keyword"], k["scaling_param"], k["gamma"]] for k in d.get_all_keywords()],
        arity=1,
    )
    rpc.register(
        "add_keyword",
        _updating(server, lambda name, kw: d.add_keyword(kw[0], float(kw[1]), float(kw[2]))),
        arity=2,
    )
    rpc.register("remove_keyword", _updating(server, lambda name, kw: d.remove_keyword(kw)), arity=2)
    rpc.register("remove_all_keywords", _updating(server, lambda name: d.remove_all_keywords()), arity=1)
    rpc.register("clear", _updating(server, lambda name: (d.clear(), True)[1]), arity=1)


@_binder("clustering")
def _bind_clustering(rpc: RpcServer, server: Any) -> None:
    d = server.driver

    def wd(pair):  # (weight, Datum) → wire weighted_datum
        return [float(pair[0]), _wire_datum(pair[1])]

    def wi(pair):  # (weight, id) → wire weighted_index
        return [float(pair[0]), pair[1]]

    rpc.register(
        "push",
        _updating(server, lambda name, points: d.push([(p[0], _datum(p[1])) for p in points])),
        arity=2,
    )
    rpc.register("get_revision", lambda name: int(d.get_revision()), arity=1)
    rpc.register("get_core_members", lambda name: [[wd(p) for p in c] for c in d.get_core_members()], arity=1)
    rpc.register("get_core_members_light",
                 lambda name: [[wi(p) for p in c] for c in d.get_core_members_light()], arity=1)
    rpc.register("get_k_center", lambda name: [_wire_datum(c) for c in d.get_k_center()], arity=1)
    rpc.register("get_nearest_center", lambda name, p: _wire_datum(d.get_nearest_center(_datum(p))), arity=2)
    rpc.register("get_nearest_members", lambda name, p: [wd(x) for x in d.get_nearest_members(_datum(p))],
                 arity=2)
    rpc.register("get_nearest_members_light",
                 lambda name, p: [wi(x) for x in d.get_nearest_members_light(_datum(p))], arity=2)
    rpc.register("clear", _updating(server, lambda name: (d.clear(), True)[1]), arity=1)


@_binder("stat")
def _bind_stat(rpc: RpcServer, server: Any) -> None:
    d = server.driver
    rpc.register("push", _updating(server, lambda name, key, val: d.push(key, float(val))), arity=3)
    rpc.register("sum", lambda name, key: float(d.sum(key)), arity=2)
    rpc.register("stddev", lambda name, key: float(d.stddev(key)), arity=2)
    rpc.register("max", lambda name, key: float(d.max(key)), arity=2)
    rpc.register("min", lambda name, key: float(d.min(key)), arity=2)
    rpc.register("entropy", lambda name, key: float(d.entropy(key)), arity=2)
    rpc.register("moment", lambda name, key, deg, center: float(d.moment(key, int(deg), float(center))),
                 arity=4)
    rpc.register("clear", _updating(server, lambda name: (d.clear(), True)[1]), arity=1)


@_binder("bandit")
def _bind_bandit(rpc: RpcServer, server: Any) -> None:
    d = server.driver
    rpc.register("register_arm", _updating(server, lambda name, a: d.register_arm(a)), arity=2)
    rpc.register("delete_arm", _updating(server, lambda name, a: d.delete_arm(a)), arity=2)
    rpc.register("select_arm", _updating(server, lambda name, p: d.select_arm(p)), arity=2)
    rpc.register("register_reward", _updating(server,
                 lambda name, p, a, r: d.register_reward(p, a, float(r))), arity=4)
    rpc.register(
        "get_arm_info",
        lambda name, p: {
            arm: [int(info["trial_count"]), float(info["weight"])]
            for arm, info in d.get_arm_info(p).items()
        },
        arity=2,
    )
    rpc.register("reset", _updating(server, lambda name, p: d.reset(p)), arity=2)
    rpc.register("clear", _updating(server, lambda name: (d.clear(), True)[1]), arity=1)


@_binder("weight")
def _bind_weight(rpc: RpcServer, server: Any) -> None:
    d = server.driver
    rpc.register(
        "update",
        lambda name, dat: [[k, float(v)] for k, v in _updating(server, lambda: d.update(_datum(dat)))()],
        arity=2,
    )
    rpc.register(
        "calc_weight",
        lambda name, dat: [[k, float(v)] for k, v in d.calc_weight(_datum(dat))],
        arity=2,
    )
    rpc.register("clear", _updating(server, lambda name: (d.clear(), True)[1]), arity=1)
