"""Engine service definitions (trimmed copy of
``jubatus_tpu/framework/idl.py``; ≙ jubatus/server/server/*.idl).

The reference generates server bindings, proxy routing and clients from
msgpack-IDL files with three decorators per RPC — routing (#@random /
#@broadcast / #@cht(n) / #@internal), lock (#@update / #@analysis /
#@nolock) and aggregator (#@pass / #@all_and / #@all_or / #@merge /
#@concat). Here the same information is a data table: one ``Method`` per
RPC, transcribed from each engine's .idl, with the retry-safety class the
JAX package adds to the reference's decorators. The table drives:

- ``jubatus_tpu_torch.server.proxy`` — routing + aggregation per method
  (``get_service``, ``INTERNAL`` methods never exposed, ``USES_CHT``);
- the drain plane's dispatch gate (framework/migration.py), which tells
  the calls it still answers (reads, ``idempotent_methods``) from the
  effectful ones it refuses with ``NodeDraining``;
- ``jubatus_tpu_torch.rpc.client`` — ``CLIENT_SAFE_RETRY``, the methods a
  client retries on a transport failure.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, FrozenSet, Optional, Tuple

RANDOM, BROADCAST, CHT, INTERNAL = "random", "broadcast", "cht", "internal"


@dataclass(frozen=True)
class Method:
    name: str
    #: wire argument names AFTER the leading cluster-name string every
    #: jubatus call carries (client.hpp:30-87)
    args: Tuple[str, ...]
    routing: str = RANDOM
    #: CHT successor count for routing == "cht" (#@cht defaults to 2,
    #: recommender_proxy.cpp:21-45; #@cht(1) where the idl says so)
    cht_n: int = 2
    #: update → model write lock; analysis → read; nolock (server decides)
    lock: str = "nolock"
    #: broadcast/cht reducer (framework/aggregators.hpp)
    aggregator: str = "pass"
    #: retry-safety class (beyond the reference's IDL): True when
    #: re-issuing the call cannot change state (reads), False when a
    #: duplicate would double-apply (train/push/clear/...). None derives
    #: from the lock decorator — analysis → idempotent, update →
    #: effectful, nolock → effectful unless tagged here explicitly.
    idempotent: Optional[bool] = None

    @property
    def is_idempotent(self) -> bool:
        if self.idempotent is not None:
            return self.idempotent
        return self.lock == "analysis"


def _m(name, args=(), routing=RANDOM, cht_n=2, lock="nolock", agg="pass",
       idem: Optional[bool] = None):
    return Method(name, tuple(args), routing, cht_n, lock, agg, idem)


#: engine name → RPC surface. Source: the .idl file named per key.
SERVICES: Dict[str, Tuple[Method, ...]] = {
    # classifier.idl:40-81
    "classifier": (
        _m("train", ("data",), RANDOM, lock="update"),
        _m("classify", ("data",), RANDOM, lock="analysis"),
        _m("get_labels", (), RANDOM, lock="analysis"),
        _m("set_label", ("new_label",), BROADCAST, lock="update", agg="all_and"),
        _m("clear", (), BROADCAST, lock="update", agg="all_and"),
        _m("delete_label", ("target_label",), BROADCAST, lock="update", agg="all_or"),
    ),
    # regression.idl
    "regression": (
        _m("train", ("train_data",), RANDOM, lock="update"),
        _m("estimate", ("estimate_data",), RANDOM, lock="analysis"),
        _m("clear", (), BROADCAST, lock="update", agg="all_and"),
    ),
    # recommender.idl
    "recommender": (
        _m("clear_row", ("id",), CHT, 2, "update", "all_and"),
        _m("update_row", ("id", "row"), CHT, 2, "update", "all_and"),
        _m("clear", (), BROADCAST, lock="update", agg="all_and"),
        _m("complete_row_from_id", ("id",), CHT, 2, "analysis"),
        _m("complete_row_from_datum", ("row",), RANDOM, lock="analysis"),
        _m("similar_row_from_id", ("id", "size"), CHT, 2, "analysis"),
        _m("similar_row_from_datum", ("row", "size"), RANDOM, lock="analysis"),
        _m("decode_row", ("id",), CHT, 2, "analysis"),
        _m("get_all_rows", (), RANDOM, lock="analysis"),
        _m("calc_similarity", ("lhs", "rhs"), RANDOM, lock="analysis"),
        _m("calc_l2norm", ("row",), RANDOM, lock="analysis"),
    ),
    # nearest_neighbor.idl (queries are #@nolock reads: retry-safe)
    "nearest_neighbor": (
        _m("clear", (), BROADCAST, lock="update", agg="all_and"),
        _m("set_row", ("id", "d"), CHT, 1, "update"),
        _m("neighbor_row_from_id", ("id", "size"), RANDOM, idem=True),
        _m("neighbor_row_from_datum", ("query", "size"), RANDOM, idem=True),
        _m("similar_row_from_id", ("id", "ret_num"), RANDOM, idem=True),
        _m("similar_row_from_datum", ("query", "ret_num"), RANDOM, idem=True),
        _m("get_all_rows", (), RANDOM, idem=True),
    ),
    # anomaly.idl
    "anomaly": (
        _m("clear_row", ("id",), CHT, 2, "update", "all_and"),
        _m("add", ("row",), RANDOM),
        _m("update", ("id", "row"), CHT, 2, "update"),
        _m("overwrite", ("id", "row"), CHT, 2, "update"),
        _m("clear", (), BROADCAST, lock="update", agg="all_and"),
        _m("calc_score", ("row",), RANDOM, lock="analysis"),
        _m("get_all_rows", (), RANDOM, lock="analysis"),
    ),
    # graph.idl
    "graph": (
        _m("create_node", (), RANDOM),
        _m("remove_node", ("node_id",), CHT, 2),
        _m("update_node", ("node_id", "property"), CHT, 2, "update", "all_and"),
        _m("create_edge", ("node_id", "e"), CHT, 1),
        _m("update_edge", ("node_id", "edge_id", "e"), CHT, 2, "update", "all_and"),
        _m("remove_edge", ("node_id", "edge_id"), CHT, 2, "update", "all_and"),
        _m("get_centrality", ("node_id", "centrality_type", "query"), RANDOM, lock="analysis"),
        _m("add_centrality_query", ("query",), BROADCAST, lock="update", agg="all_and"),
        _m("add_shortest_path_query", ("query",), BROADCAST, lock="update", agg="all_and"),
        _m("remove_centrality_query", ("query",), BROADCAST, lock="update", agg="all_and"),
        _m("remove_shortest_path_query", ("query",), BROADCAST, lock="update", agg="all_and"),
        _m("get_shortest_path", ("query",), RANDOM, lock="analysis"),
        _m("update_index", (), BROADCAST, lock="update", agg="all_and"),
        _m("clear", (), BROADCAST, lock="update", agg="all_and"),
        _m("get_node", ("node_id",), CHT, 2, "analysis"),
        _m("get_edge", ("node_id", "edge_id"), CHT, 2, "analysis"),
        _m("create_node_here", ("node_id",), INTERNAL, lock="update"),
        _m("remove_global_node", ("node_id",), INTERNAL, lock="update"),
        _m("create_edge_here", ("edge_id", "e"), INTERNAL, lock="update"),
    ),
    # burst.idl
    "burst": (
        # broadcast to every node (each processes only its CHT-assigned
        # keywords); the reply is the first node's count — #@pass, NOT a sum
        # (burst.idl:40-41, burst_proxy.cpp:21-23)
        _m("add_documents", ("data",), BROADCAST, lock="update", agg="pass"),
        _m("get_result", ("keyword",), CHT, 2, "analysis"),
        _m("get_result_at", ("keyword", "pos"), CHT, 2, "analysis"),
        _m("get_all_bursted_results", (), BROADCAST, lock="analysis", agg="merge"),
        _m("get_all_bursted_results_at", ("pos",), BROADCAST, lock="analysis", agg="merge"),
        _m("get_all_keywords", (), RANDOM, lock="analysis"),
        _m("add_keyword", ("keyword",), BROADCAST, lock="update", agg="all_and"),
        _m("remove_keyword", ("keyword",), BROADCAST, lock="update", agg="all_and"),
        _m("remove_all_keywords", (), BROADCAST, lock="update", agg="all_and"),
        _m("clear", (), BROADCAST, lock="update", agg="all_and"),
    ),
    # clustering.idl
    "clustering": (
        _m("push", ("points",), RANDOM, lock="update"),
        _m("get_revision", (), RANDOM, lock="analysis"),
        _m("get_core_members", (), RANDOM, lock="analysis"),
        _m("get_core_members_light", (), RANDOM, lock="analysis"),
        _m("get_k_center", (), RANDOM, lock="analysis"),
        _m("get_nearest_center", ("point",), RANDOM, lock="analysis"),
        _m("get_nearest_members", ("point",), RANDOM, lock="analysis"),
        _m("get_nearest_members_light", ("point",), RANDOM, lock="analysis"),
        _m("clear", (), BROADCAST, lock="update", agg="all_and"),
    ),
    # stat.idl
    "stat": (
        _m("push", ("key", "value"), CHT, 1, "update", "all_and"),
        _m("sum", ("key",), CHT, 1, "analysis"),
        _m("stddev", ("key",), CHT, 1, "analysis"),
        _m("max", ("key",), CHT, 1, "analysis"),
        _m("min", ("key",), CHT, 1, "analysis"),
        _m("entropy", ("key",), CHT, 1, "analysis"),
        _m("moment", ("key", "degree", "center"), CHT, 1, "analysis"),
        _m("clear", (), BROADCAST, lock="update", agg="all_and"),
    ),
    # bandit.idl
    "bandit": (
        _m("register_arm", ("arm_id",), BROADCAST, lock="update", agg="all_and"),
        _m("delete_arm", ("arm_id",), BROADCAST, lock="update", agg="all_and"),
        _m("select_arm", ("player_id",), CHT, 1, "update"),
        _m("register_reward", ("player_id", "arm_id", "reward"), CHT, 1, "update", "all_and"),
        _m("get_arm_info", ("player_id",), CHT, 1, "analysis"),
        _m("reset", ("player_id",), BROADCAST, lock="update", agg="all_or"),
        _m("clear", (), BROADCAST, lock="update", agg="all_and"),
    ),
    # weight.idl (calc_weight is a pure read; update mutates df tables)
    "weight": (
        _m("update", ("d",), RANDOM),
        _m("calc_weight", ("d",), RANDOM, idem=True),
        _m("clear", (), BROADCAST, agg="all_and"),
    ),
}

#: engines whose proxies route by CHT (use_cht=true in *_impl.cpp)
USES_CHT = frozenset(
    e
    for e, methods in SERVICES.items()
    if any(m.routing == CHT for m in methods)
)

ENGINES: Tuple[str, ...] = tuple(sorted(SERVICES))


def get_service(engine: str) -> Tuple[Method, ...]:
    try:
        return SERVICES[engine]
    except KeyError:
        raise KeyError(f"unknown engine {engine!r}; known: {', '.join(ENGINES)}")


# -- idempotency classes (rpc/retry.py consumers) -----------------------------

#: built-ins + mixer internals that are pure reads — safe to retry on a
#: transport failure (the mix_* reads matter: a mixer master retrying a
#: get_diff against a flaky member beats skipping its contribution)
IDEMPOTENT_BUILTINS: FrozenSet[str] = frozenset({
    "get_config", "get_status", "get_metrics", "get_mix_history",
    "get_spans", "get_slow_log",
    "get_timeseries", "get_alerts",
    # continuous profiling plane: profile reads are pure;
    # profile_device only re-captures into the same capped artifacts
    # dir on a retry — safe to re-issue after a transport failure
    "get_profile", "profile_device", "get_proxy_profile",
    "get_proxy_status", "get_proxy_metrics", "get_proxy_spans",
    "get_proxy_slow_log", "get_proxy_timeseries", "get_proxy_alerts",
    "get_breakers",
    "mix_get_schema", "mix_get_diff", "mix_get_model",
    # elastic membership: epoch/drain/migration READS.
    # migrate_range is a pure read on the SOURCE (the puller owns the
    # cursor, so re-issuing a chunk fetch just re-reads the same rows)
    "get_epoch", "drain_status", "migrate_range", "get_row_count",
    # async mix: the inbox/fold status read is pure
    "mix_async_status",
    # autoscaling control plane: journal/status read is pure
    "get_autoscale_status",
    # event plane + incident bundles: journal/bundle reads
    # are pure (get_events is cursor-driven; a replayed read re-serves
    # the same events)
    "get_events", "get_incidents", "get_proxy_events",
    "get_proxy_incidents",
    # data-quality plane: the sketch/drift doc read is pure
    "get_quality", "get_proxy_quality",
    # usage-attribution plane: the ledger doc read is pure —
    # a retried get_usage re-serves the same mergeable snapshot
    "get_usage", "get_proxy_usage",
    # durable model plane: the store/warm-boot status read
    # is pure
    "get_store_status",
    # self-tuning performance plane: tuner state/journal
    # read is pure
    "get_tune",
})

#: effectful built-ins, listed for the docs' idempotency matrix (anything
#: not in either set is treated as effectful — the safe default)
EFFECTFUL_BUILTINS: FrozenSet[str] = frozenset({
    "save", "load", "clear", "do_mix", "mix_put_diff", "mix_sync_schema",
    "mix_prepare", "mix_abort",
    # elastic membership: drain flips routing state,
    # rebalance pulls rows in, put_rows writes rows
    "drain", "rebalance", "put_rows",
    # async mix: a replayed submit is mostly-safe
    # (latest-wins inbox) but a retry racing a fold can double-count a
    # delta — classed effectful; the submitter resubmits next tick
    # instead of retrying
    "mix_submit_diff",
    # model-integrity plane: rollback rewrites the live
    # model from the snapshot ring — effectful by definition
    "rollback",
    # durable model plane: point-in-time restore rewrites
    # the live model from the shared store — effectful by definition
    "store_restore",
})


def idempotent_methods(engine: str) -> FrozenSet[str]:
    """Wire-method names safe to retry for ``engine`` (IDL reads +
    idempotent built-ins)."""
    return frozenset(
        m.name for m in get_service(engine) if m.is_idempotent
    ) | IDEMPOTENT_BUILTINS


def _client_safe() -> FrozenSet[str]:
    """Method names idempotent in EVERY engine that defines them — the
    conservative table for clients that don't know which engine they talk
    to (a name like ``update`` that is effectful anywhere stays
    effectful everywhere)."""
    verdict: Dict[str, bool] = {}
    for methods in SERVICES.values():
        for m in methods:
            verdict[m.name] = verdict.get(m.name, True) and m.is_idempotent
    return frozenset(n for n, ok in verdict.items() if ok) \
        | IDEMPOTENT_BUILTINS


#: engine-agnostic retry-safety table (rpc/client.py's default gate)
CLIENT_SAFE_RETRY: FrozenSet[str] = _client_safe()
