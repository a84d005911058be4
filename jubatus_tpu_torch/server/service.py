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
are registered for the peers and never exposed on a proxy. Not carried
over: the raw-wire train path (``_register_train_raw``), which needs the
native ingest parse.
"""

from __future__ import annotations

import logging
from typing import Any, Callable, Dict, List

from jubatus_tpu_torch.core.datum import Datum
from jubatus_tpu_torch.rpc.server import RpcServer, deferred
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
