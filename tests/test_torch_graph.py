"""The port's graph engine (jubatus_tpu_torch/models/graph.py) against the
JAX package's: every graph case of tests/test_clustering_burst_graph.py,
run on both drivers with the same calls, with the reference test's own
assertions on the port, and the packs cross-loaded both ways.

Node and edge bookkeeping, the preset queries and the shortest path are
host code in both packages: their answers are held equal. PageRank runs on
the driver's device in the port (an index_add_ scatter per iteration) and
in XLA in the JAX package; the two add in other orders and XLA may fuse the
final multiply-add, so ranks are held within PAGERANK_RTOL (relative). The
``cuda`` case holds the ranks on the card against the CPU within
PAGERANK_CARD_RTOL: CUDA's index_add_ adds duplicates in no fixed order.
"""

from __future__ import annotations

import numpy as np
import pytest
import torch

from jubatus_tpu.models import GraphDriver as JGraph
from jubatus_tpu.parallel import LocalMixGroup
from jubatus_tpu_torch.convert import from_jax_pack
from jubatus_tpu_torch.models.graph import GraphDriver
from torch_parity import port_mix

PAGERANK_RTOL = 1e-5
PAGERANK_CARD_RTOL = 1e-5

GRAPH_CFG = {"method": "graph_wo_index",
             "parameter": {"damping_factor": 0.9, "landmark_num": 5}}
EMPTY_Q = ([], [])


def _port(cfg=GRAPH_CFG, device="cpu"):
    return GraphDriver(cfg, device=device)


def _both():
    return _port(), JGraph(GRAPH_CFG)


def _diamond(g):
    """a -> b -> d, a -> c -> d plus a hub z pointed at by everyone."""
    ids = {}
    for name in "abcdz":
        ids[name] = g.create_node()
        g.update_node(ids[name], {"name": name})
    for s, t in [("a", "b"), ("b", "d"), ("a", "c"), ("c", "d"),
                 ("a", "z"), ("b", "z"), ("c", "z"), ("d", "z")]:
        g.create_edge(ids[s], ids[s], ids[t])
    return ids


def _state(g):
    return ({n: g.get_node(n) for n in sorted(g.nodes)},
            {e: g.get_edge("", e) for e in sorted(g.edges)})


def _ranks(g, query=EMPTY_Q):
    return {n: g.get_centrality(n, 0, query) for n in sorted(g.nodes)}


def assert_ranks_close(got, want, rtol=PAGERANK_RTOL):
    assert sorted(got) == sorted(want)
    for n in want:
        assert got[n] == pytest.approx(want[n], rel=rtol), n


def _random_graph(gs, rng, nodes=120, edges=700):
    """The same random graph on each driver: nodes with a "kind" of x or y,
    edges with a "rel" of f or g."""
    kinds = rng.integers(2, size=nodes)
    ends = rng.integers(nodes, size=(edges, 2))
    rels = rng.integers(2, size=edges)
    for g in gs:
        for i in range(nodes):
            n = g.create_node()
            g.update_node(n, {"kind": "xy"[kinds[i]]})
        for (s, t), r in zip(ends, rels):
            g.create_edge(str(s), str(s), str(t), {"rel": "fg"[r]})


# ---------------------------------------------------------------------------
# the graph cases of tests/test_clustering_burst_graph.py
# ---------------------------------------------------------------------------
def test_graph_crud_and_get_node_edge():
    t, j = _both()
    out = []
    for g in (t, j):
        ids = _diamond(g)
        node = g.get_node(ids["a"])
        eid = node["out_edges"][0]
        rec = [node, g.get_edge(ids["a"], eid),
               g.update_edge(ids["a"], eid, {"w": "2"}),
               g.get_edge(ids["a"], eid), g.remove_edge(ids["a"], eid),
               g.get_node(ids["a"]), g.remove_node(ids["b"]), _state(g)]
        with pytest.raises(KeyError):
            g.get_node(ids["b"])
        out.append((ids, rec))
    assert out[0] == out[1]
    ids, (node, e, _, e2, removed, node2, gone, _) = out[0]
    assert node["property"] == {"name": "a"}
    assert len(node["out_edges"]) == 3
    assert e["source"] == ids["a"]
    assert e2["property"] == {"w": "2"}
    assert removed and len(node2["out_edges"]) == 2 and gone
    assert all(ids["b"] not in (s, d) for (s, d, _) in t.edges.values())


def test_graph_pagerank_centrality():
    t, j = _both()
    for g in (t, j):
        ids = _diamond(g)
        g.add_centrality_query(EMPTY_Q)
        g.update_index()
    assert_ranks_close(_ranks(t), _ranks(j))
    assert t.get_centrality(ids["z"], 0, EMPTY_Q) > \
        t.get_centrality(ids["a"], 0, EMPTY_Q)
    with pytest.raises(ValueError):
        t.get_centrality(ids["z"], 0, ([], [("name", "a")]))
    assert t.last_pagerank["nodes"] == 5 and t.last_pagerank["edges"] == 8


def test_graph_shortest_path_bounded():
    t, j = _both()
    out = []
    for g in (t, j):
        ids = _diamond(g)
        g.add_shortest_path_query(EMPTY_Q)
        out.append([g.get_shortest_path(ids["a"], ids["d"], 10, EMPTY_Q),
                    g.get_shortest_path(ids["d"], ids["a"], 10, EMPTY_Q),
                    g.get_shortest_path(ids["a"], ids["d"], 1, EMPTY_Q)])
    assert out[0] == out[1]
    path, back, short = out[0]
    assert path[0] == ids["a"] and path[-1] == ids["d"] and len(path) == 3
    assert back == [] and short == []


def test_graph_preset_query_filters():
    out = []
    for g in _both():
        n1, n2, n3 = (g.create_node() for _ in range(3))
        g.update_node(n1, {"kind": "x"})
        g.update_node(n2, {"kind": "x"})
        g.update_node(n3, {"kind": "y"})
        g.create_edge(n1, n1, n2, {"rel": "f"})
        g.create_edge(n2, n2, n3, {"rel": "f"})
        q = ([], [("kind", "x")])
        g.add_shortest_path_query(q)
        out.append([g.get_shortest_path(n1, n3, 5, q),
                    g.get_shortest_path(n1, n2, 5, q), [n1, n2]])
    assert out[0] == out[1]
    assert out[0][0] == [] and out[0][1] == out[0][2]


def test_graph_internal_rpcs_and_mix():
    out = []
    for mk, mix in ((lambda: _port(), port_mix),
                    (lambda: JGraph(GRAPH_CFG),
                     lambda ds: LocalMixGroup(ds).mix())):
        a, b = mk(), mk()
        assert a.create_node_here("100")
        a.update_node("100", {"k": "v"})
        nb = b.create_node()
        b.update_node(nb, {"k2": "v2"})
        mix([a, b])
        assert "100" in a.nodes and "100" in b.nodes
        assert b.nodes["100"] == {"k": "v"}
        assert nb in a.nodes
        fresh = a.create_node()
        assert int(fresh) > 100
        out.append([fresh, _state(a), _state(b)])
    assert out[0] == out[1]


def test_graph_save_load():
    t, j = _both()
    for g in (t, j):
        ids = _diamond(g)
        g.add_centrality_query(EMPTY_Q)
    t2 = _port()
    t2.unpack(t.pack())
    assert t2.get_node(ids["a"])["property"] == {"name": "a"}
    assert len(t2.edges) == len(t.edges)
    t2.update_index()
    assert t2.get_centrality(ids["z"], 0, EMPTY_Q) == pytest.approx(
        t.get_centrality(ids["z"], 0, EMPTY_Q))
    assert _state(t2) == _state(j)


# ---------------------------------------------------------------------------
# PageRank on larger graphs, and the packs across packages
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("seed,query", [
    (0, EMPTY_Q), (1, ([], [("kind", "x")])), (2, ([("rel", "f")], [])),
    (3, ([("rel", "g")], [("kind", "y")]))])
def test_pagerank_matches_jax_on_random_graphs(seed, query):
    t, j = _both()
    _random_graph((t, j), np.random.default_rng(seed))
    for g in (t, j):
        g.add_centrality_query(query)
        g.update_index()
    nodes = sorted(n for n, p in j.nodes.items()
                   if all(p.get(k) == v for k, v in query[1]))
    got = {n: t.get_centrality(n, 0, query) for n in nodes}
    want = {n: j.get_centrality(n, 0, query) for n in nodes}
    assert_ranks_close(got, want)
    assert t.last_pagerank["nodes"] == len(nodes)


def test_graph_packs_cross_load_both_ways():
    j = JGraph(GRAPH_CFG)
    _random_graph((j,), np.random.default_rng(5), nodes=60, edges=300)
    q = ([], [("kind", "x")])
    j.add_centrality_query(q)
    j.add_shortest_path_query(EMPTY_Q)
    j.update_index()
    t = from_jax_pack(j.pack(), GRAPH_CFG, engine="graph", device="cpu")
    assert _state(t) == _state(j)
    t.update_index()
    xs = sorted(n for n, p in j.nodes.items() if p.get("kind") == "x")
    assert_ranks_close({n: t.get_centrality(n, 0, q) for n in xs},
                       {n: j.get_centrality(n, 0, q) for n in xs})
    assert t.get_shortest_path("0", "7", 6, EMPTY_Q) == \
        j.get_shortest_path("0", "7", 6, EMPTY_Q)
    n = t.create_node()
    t.create_edge(n, n, "3", {"rel": "f"})
    j2 = JGraph(GRAPH_CFG)
    j2.unpack(t.pack())
    assert _state(j2) == _state(t)
    assert j2.create_node() == t.create_node()


# ---------------------------------------------------------------------------
# the card against the CPU
# ---------------------------------------------------------------------------
@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: PageRank on the card against the "
                    "CPU")
    return torch.device("cuda")


@pytest.mark.cuda
def test_pagerank_on_the_card_matches_the_cpu(cuda):
    t, g = _port(), _port(device="cuda")
    _random_graph((t, g), np.random.default_rng(9), nodes=2000, edges=20000)
    for d in (t, g):
        d.add_centrality_query(EMPTY_Q)
        d.update_index()
    assert_ranks_close(_ranks(g), _ranks(t), PAGERANK_CARD_RTOL)
