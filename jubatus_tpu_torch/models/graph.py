"""Graph engine driver (counterpart of ``jubatus_tpu/models/graph.py``):
graph_wo_index, PageRank centrality and shortest path.

Business API of the reference's graph service: create_node / remove_node /
update_node / create_edge / update_edge / remove_edge / get_centrality /
add_{centrality,shortest_path}_query / remove_{centrality,shortest_path}_query
/ get_shortest_path / update_index / clear / get_node / get_edge, and the
internal create_node_here / create_edge_here / remove_global_node.

- Nodes carry a string-map property; edges are directed (source, target,
  property) with integer ids. A preset query is (edge_query, node_query),
  lists of (key, value) pairs that all must match (empty matches all);
  centrality and shortest path answer only for a registered preset query.
- ``get_centrality(node, 0, query)`` is PageRank in the mean-one form
  pr = (1 − α) + α Σ_{j→i} pr_j / outdeg_j, α = damping_factor, 30
  iterations on the preset query's subgraph, cached per query until
  ``update_index`` refreshes it.
- ``get_shortest_path`` is a BFS bounded by max_hop on the host.

Graph mutation and the filter stay host-side, as in the JAX package.
PageRank runs on the driver's device: the edge arrays are uploaded once
per refresh, and each iteration is one gather and one ``index_add_``
scatter. On CUDA the scatter adds duplicates in no fixed order, so ranks
on the card carry a stated relative tolerance against the CPU; the
out-degree is a count and stays exact. ``last_pagerank`` keeps the wall
seconds of the last PageRank's steps: the filter and the edge arrays
(host), the upload, the iterations (to the device's completion) and the
readback.
"""


from __future__ import annotations

import json
import time
from typing import Any, Dict, List, Optional, Tuple

import numpy as np

import torch

from jubatus_tpu_torch import resolve_device, synchronize
from jubatus_tpu_torch.framework.driver import DriverBase, locked

CENTRALITY_PAGERANK = 0

QueryPairs = List[Tuple[str, str]]
PresetQuery = Tuple[QueryPairs, QueryPairs]  # (edge_query, node_query)


def _canon_query(query: Any) -> PresetQuery:
    """Normalize a preset_query wire value to hashable canonical form."""
    if query is None:
        return ((), ())
    eq, nq = query[0] if len(query) > 0 else [], query[1] if len(query) > 1 else []

    def _s(x):
        return x.decode() if isinstance(x, bytes) else x

    def canon(pairs):
        return tuple(sorted((_s(k), _s(v)) for k, v in pairs))

    return (canon(eq), canon(nq))


def _match(props: Dict[str, str], pairs) -> bool:
    return all(props.get(k) == v for k, v in pairs)


class GraphDriver(DriverBase):
    TYPE = "graph"

    def __init__(self, config: dict, device=None):
        super().__init__()
        self.config = config
        self.config_json = json.dumps(config)
        param = dict(config.get("parameter") or {})
        self.damping_factor = float(param.get("damping_factor", 0.9))
        self.landmark_num = int(param.get("landmark_num", 5))
        self.device = resolve_device(device)
        #: wall seconds of the last PageRank's steps
        self.last_pagerank: Dict[str, Any] = {}
        self._init_model()

    def _init_model(self) -> None:
        self.nodes: Dict[str, Dict[str, str]] = {}
        self.in_edges: Dict[str, List[int]] = {}
        self.out_edges: Dict[str, List[int]] = {}
        # edge id -> (source, target, property)
        self.edges: Dict[int, Tuple[str, str, Dict[str, str]]] = {}
        self._next_node_id = 0
        self._next_edge_id = 0
        #: cluster-wide id minting (≙ ZK global_id_generator,
        #: graph_serv.cpp:109-126) — set by the server in distributed mode
        self.idgen = None
        self.centrality_queries: set = set()
        self.shortest_path_queries: set = set()
        self._pagerank_cache: Dict[PresetQuery, Dict[str, float]] = {}
        self._index_version = 0
        self._mix_log: Dict[str, Any] = {"nodes": {}, "edges": {}}

    # -- node / edge CRUD -------------------------------------------------------
    def set_id_generator(self, gen) -> None:
        self.idgen = gen

    def create_node(self) -> str:
        # coordinator id minting happens OUTSIDE the model lock (a slow
        # coordinator must not stall serving threads or mix rounds)
        node_id = str(self.idgen.generate()) if self.idgen is not None else None
        with self.lock:
            if node_id is None:
                node_id = str(self._next_node_id)
                self._next_node_id += 1
            self._create_node(node_id)
        return node_id

    def _create_node(self, node_id: str) -> None:
        if node_id not in self.nodes:
            self.nodes[node_id] = {}
            self.in_edges[node_id] = []
            self.out_edges[node_id] = []
            self._mix_log["nodes"][node_id] = {}
            self.event_model_updated()

    @locked
    def create_node_here(self, node_id: str) -> bool:
        """Internal RPC: materialize a node with a caller-chosen id (the
        CHT-replication path, graph_serv.cpp:181-228)."""
        self._create_node(node_id)
        self._next_node_id = max(self._next_node_id,
                                 _int_or(node_id, -1) + 1)
        return True

    @locked
    def update_node(self, node_id: str, properties: Dict[str, str]) -> bool:
        if node_id not in self.nodes:
            raise KeyError(f"unknown node {node_id!r}")
        self.nodes[node_id] = dict(properties)
        self._mix_log["nodes"][node_id] = dict(properties)
        self.event_model_updated()
        return True

    @locked
    def remove_node(self, node_id: str) -> bool:
        if node_id not in self.nodes:
            return False
        for eid in list(self.in_edges[node_id]) + list(self.out_edges[node_id]):
            self._remove_edge(eid)
        del self.nodes[node_id]
        del self.in_edges[node_id]
        del self.out_edges[node_id]
        self._mix_log["nodes"][node_id] = None
        self.event_model_updated()
        return True

    @locked
    def remove_global_node(self, node_id: str) -> bool:
        """Internal RPC: the broadcast half of remove_node
        (graph_serv.cpp:240-265)."""
        return self.remove_node(node_id)

    def create_edge(self, node_id: str, source: str, target: str,
                    properties: Optional[Dict[str, str]] = None) -> int:
        eid = int(self.idgen.generate()) if self.idgen is not None else None
        with self.lock:
            if eid is None:
                eid = self._next_edge_id
                self._next_edge_id += 1
            self._create_edge(eid, source, target, properties or {})
        return eid

    @locked
    def create_edge_here(self, edge_id: int, source: str, target: str,
                         properties: Optional[Dict[str, str]] = None) -> bool:
        self._create_edge(int(edge_id), source, target, properties or {})
        self._next_edge_id = max(self._next_edge_id, int(edge_id) + 1)
        return True

    def _create_edge(self, eid: int, source: str, target: str,
                     properties: Dict[str, str]) -> None:
        if source not in self.nodes:
            raise KeyError(f"unknown source node {source!r}")
        if target not in self.nodes:
            raise KeyError(f"unknown target node {target!r}")
        if eid in self.edges:
            return
        self.edges[eid] = (source, target, dict(properties))
        self.out_edges[source].append(eid)
        self.in_edges[target].append(eid)
        self._mix_log["edges"][eid] = (source, target, dict(properties))
        self.event_model_updated()

    @locked
    def update_edge(self, node_id: str, edge_id: int,
                    properties: Dict[str, str]) -> bool:
        if edge_id not in self.edges:
            raise KeyError(f"unknown edge {edge_id!r}")
        s, t, _ = self.edges[edge_id]
        self.edges[edge_id] = (s, t, dict(properties))
        self._mix_log["edges"][edge_id] = (s, t, dict(properties))
        self.event_model_updated()
        return True

    @locked
    def remove_edge(self, node_id: str, edge_id: int) -> bool:
        return self._remove_edge(int(edge_id))

    def _remove_edge(self, eid: int) -> bool:
        rec = self.edges.pop(eid, None)
        if rec is None:
            return False
        s, t, _ = rec
        if s in self.out_edges and eid in self.out_edges[s]:
            self.out_edges[s].remove(eid)
        if t in self.in_edges and eid in self.in_edges[t]:
            self.in_edges[t].remove(eid)
        self._mix_log["edges"][eid] = None
        self.event_model_updated()
        return True

    # -- reads ------------------------------------------------------------------
    @locked
    def get_node(self, node_id: str) -> Dict[str, Any]:
        if node_id not in self.nodes:
            raise KeyError(f"unknown node {node_id!r}")
        return {"property": dict(self.nodes[node_id]),
                "in_edges": list(self.in_edges[node_id]),
                "out_edges": list(self.out_edges[node_id])}

    @locked
    def get_edge(self, node_id: str, edge_id: int) -> Dict[str, Any]:
        rec = self.edges.get(int(edge_id))
        if rec is None:
            raise KeyError(f"unknown edge {edge_id!r}")
        s, t, p = rec
        return {"property": dict(p), "source": s, "target": t}

    # -- preset queries -----------------------------------------------------------
    @locked
    def add_centrality_query(self, query: Any) -> bool:
        self.centrality_queries.add(_canon_query(query))
        self._pagerank_cache.clear()
        return True

    @locked
    def remove_centrality_query(self, query: Any) -> bool:
        self.centrality_queries.discard(_canon_query(query))
        return True

    @locked
    def add_shortest_path_query(self, query: Any) -> bool:
        self.shortest_path_queries.add(_canon_query(query))
        return True

    @locked
    def remove_shortest_path_query(self, query: Any) -> bool:
        self.shortest_path_queries.discard(_canon_query(query))
        return True

    def _filtered(self, q: PresetQuery):
        """(node set, edge list[(eid, src, dst)]) matching the preset query."""
        eq, nq = q
        nodes = {n for n, p in self.nodes.items() if _match(p, nq)}
        edges = [(eid, s, t) for eid, (s, t, p) in self.edges.items()
                 if s in nodes and t in nodes and _match(p, eq)]
        return nodes, edges

    # -- centrality ---------------------------------------------------------------
    @locked
    def update_index(self) -> bool:
        """Recompute cached centralities (the reference's explicit index
        refresh; queries between update_index calls serve the cache)."""
        self._index_version += 1
        self._pagerank_cache.clear()
        for q in self.centrality_queries:
            self._pagerank_cache[q] = self._pagerank(q)
        return True

    def _pagerank(self, q: PresetQuery, iters: int = 30) -> Dict[str, float]:
        t0 = time.perf_counter()
        nodes, edges = self._filtered(q)
        if not nodes:
            return {}
        t_filter = time.perf_counter()
        order = sorted(nodes)
        slot = {n: i for i, n in enumerate(order)}
        n = len(order)
        src = np.asarray([slot[s] for _, s, _t in edges], np.int64)
        dst = np.asarray([slot[t] for _, _s, t in edges], np.int64)
        t1 = time.perf_counter()
        dev = self.device
        srct = torch.from_numpy(src).to(dev)
        dstt = torch.from_numpy(dst).to(dev)
        synchronize(dev)
        t2 = time.perf_counter()
        outdeg = torch.zeros(n, dtype=torch.float32, device=dev).index_add_(
            0, srct, torch.ones(len(src), dtype=torch.float32, device=dev))
        deg = torch.clamp(outdeg, min=1.0)[srct]
        # the JAX package's float32 constants: 1 - alpha rounded once
        alpha = float(np.float32(self.damping_factor))
        base = float(np.float32(1.0 - self.damping_factor))
        pr = torch.ones(n, dtype=torch.float32, device=dev)
        for _ in range(iters):
            contrib = pr[srct] / deg
            pr = base + alpha * torch.zeros(
                n, dtype=torch.float32, device=dev).index_add_(0, dstt, contrib)
        synchronize(dev)
        t3 = time.perf_counter()
        pr = pr.cpu().numpy()
        out = {order[i]: float(pr[i]) for i in range(n)}
        self.last_pagerank = dict(
            nodes=n, edges=len(edges), iters=iters, filter_s=t_filter - t0,
            arrays_s=t1 - t_filter, upload_s=t2 - t1, iterate_s=t3 - t2,
            readback_s=time.perf_counter() - t3)
        return out

    @locked
    def get_centrality(self, node_id: str, centrality_type: int,
                       query: Any) -> float:
        if centrality_type != CENTRALITY_PAGERANK:
            raise ValueError(f"unsupported centrality type {centrality_type}")
        q = _canon_query(query)
        if q not in self.centrality_queries:
            raise ValueError("centrality query not preset; call "
                             "add_centrality_query + update_index first")
        cached = self._pagerank_cache.get(q)
        if cached is None:
            cached = self._pagerank(q)
            self._pagerank_cache[q] = cached
        if node_id not in cached:
            raise KeyError(f"node {node_id!r} not in filtered graph")
        return cached[node_id]

    # -- shortest path --------------------------------------------------------------
    @locked
    def get_shortest_path(self, source: str, target: str, max_hop: int,
                          query: Any = None) -> List[str]:
        q = _canon_query(query)
        if q not in self.shortest_path_queries:
            raise ValueError("shortest-path query not preset; call "
                             "add_shortest_path_query first")
        nodes, edges = self._filtered(q)
        if source not in nodes or target not in nodes:
            return []
        adj: Dict[str, List[str]] = {}
        for _eid, s, t in edges:
            adj.setdefault(s, []).append(t)
        # BFS bounded by max_hop
        prev: Dict[str, Optional[str]] = {source: None}
        frontier = [source]
        for _hop in range(int(max_hop)):
            if target in prev:
                break
            nxt = []
            for u in frontier:
                for v in adj.get(u, ()):
                    if v not in prev:
                        prev[v] = u
                        nxt.append(v)
            if not nxt:
                break
            frontier = nxt
        if target not in prev:
            return []
        path = [target]
        while prev[path[-1]] is not None:
            path.append(prev[path[-1]])
        return list(reversed(path))

    @locked
    def clear(self) -> None:
        self._init_model()
        self.update_count = 0

    # -- mix plane -------------------------------------------------------------
    def get_mixables(self):
        return {"graph": _GraphMixable(self)}

    # -- persistence -----------------------------------------------------------
    @locked
    def pack(self) -> Any:
        return {
            "nodes": {n: dict(p) for n, p in self.nodes.items()},
            "edges": {eid: [s, t, dict(p)]
                      for eid, (s, t, p) in self.edges.items()},
            "next_node_id": self._next_node_id,
            "next_edge_id": self._next_edge_id,
            "centrality_queries": sorted(self.centrality_queries),
            "shortest_path_queries": sorted(self.shortest_path_queries),
        }

    @locked
    def unpack(self, obj: Any) -> None:
        def _s(x):
            return x.decode() if isinstance(x, bytes) else x

        self._init_model()
        for n, p in obj["nodes"].items():
            n = _s(n)
            self.nodes[n] = {_s(k): _s(v) for k, v in p.items()}
            self.in_edges[n] = []
            self.out_edges[n] = []
        for eid, (s, t, p) in obj["edges"].items():
            eid, s, t = int(eid), _s(s), _s(t)
            self.edges[eid] = (s, t, {_s(k): _s(v) for k, v in p.items()})
            self.out_edges[s].append(eid)
            self.in_edges[t].append(eid)
        self._next_node_id = int(obj["next_node_id"])
        self._next_edge_id = int(obj["next_edge_id"])
        for q in obj.get("centrality_queries", []):
            self.centrality_queries.add(_canon_query(q))
        for q in obj.get("shortest_path_queries", []):
            self.shortest_path_queries.add(_canon_query(q))
        self._mix_log = {"nodes": {}, "edges": {}}

    @locked
    def get_status(self) -> Dict[str, Any]:
        st = super().get_status()
        st.update(num_nodes=len(self.nodes), num_edges=len(self.edges),
                  device=str(self.device))
        return st


class _GraphMixable:
    """Ships node/edge mutations since the last mix: {nodes: {id: props|None},
    edges: {eid: (s, t, props)|None}} (None = removed); dict-merge fold."""

    def __init__(self, driver: GraphDriver):
        self._d = driver

    def get_diff(self):
        log = self._d._mix_log
        self._d._mix_log = {"nodes": {}, "edges": {}}
        return log

    @staticmethod
    def mix(acc, diff):
        acc["nodes"].update(diff["nodes"])
        acc["edges"].update(diff["edges"])
        return acc

    def put_diff(self, diff) -> bool:
        def _s(x):
            return x.decode() if isinstance(x, bytes) else x

        d = self._d
        for n, props in diff["nodes"].items():
            n = _s(n)
            if props is None:
                if n in d.nodes:
                    d.remove_node(n)
            else:
                d._create_node(n)
                # apply unconditionally: an empty map means the node's
                # properties were cleared, which must replicate too
                d.nodes[n] = {_s(k): _s(v) for k, v in props.items()}
                d._next_node_id = max(d._next_node_id, _int_or(n, -1) + 1)
        for eid, rec in diff["edges"].items():
            eid = int(eid)
            if rec is None:
                d._remove_edge(eid)
            else:
                s, t, props = rec
                s, t = _s(s), _s(t)
                if s in d.nodes and t in d.nodes:
                    if eid in d.edges:
                        d.edges[eid] = (s, t,
                                        {_s(k): _s(v) for k, v in props.items()})
                    else:
                        d._create_edge(eid, s, t,
                                       {_s(k): _s(v) for k, v in props.items()})
                    d._next_edge_id = max(d._next_edge_id, eid + 1)
        d._mix_log = {"nodes": {}, "edges": {}}
        d._pagerank_cache.clear()
        return True


def _int_or(s: str, default: int) -> int:
    try:
        return int(s)
    except (TypeError, ValueError):
        return default
