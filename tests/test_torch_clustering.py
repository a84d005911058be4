"""The port's clustering (jubatus_tpu_torch/ops/clustering.py and
models/clustering.py) against the JAX package's, on the CPU.

The ops take the same seeded numpy points and weights in both packages:

- k-means assignments equal, centres within KMEANS_TOL (absolute);
- GMM assignments equal, means within GMM_MEAN_TOL (absolute), variances
  within GMM_VAR_RTOL (relative) and mixing weights within GMM_PI_TOL;
- DBSCAN labels equal.

Float sums and matmuls round differently in XLA and in torch, so decisions
on float distances can flip at a tie: the data are blobs whose points lie
clearly nearer one centre, and the DBSCAN data are drawn so that no pair's
squared distance lies within DBSCAN_MARGIN (relative) of eps² (a point
that would is drawn again), which each case checks. EM amplifies rounding
where the fit is ill-posed (a blob split between two components), so the
GMM cases first check that the JAX fit put one component on each blob.
The k-means++ picks go through ops/prng.py's categorical, which picks as
jax.random.categorical does (tests/test_torch_prng.py).

Then every clustering case of tests/test_clustering_burst_graph.py runs on
both drivers with the same pushes (kmeans, dbscan, the compressive
compressor, mix, save/load), with the reference test's own assertions on
the port, and the packs cross-load both ways. The ``cuda`` cases hold the
ops on the card against the CPU and skip without one.
"""

from __future__ import annotations

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from jubatus_tpu.core.datum import Datum as JDatum
from jubatus_tpu.models import ClusteringDriver as JClustering
from jubatus_tpu.models.clustering import NotClusteredError as JNotClustered
from jubatus_tpu.ops import clustering as jops
from jubatus_tpu.parallel import LocalMixGroup
from jubatus_tpu_torch.convert import from_jax_pack
from jubatus_tpu_torch.core.datum import Datum
from jubatus_tpu_torch.models.clustering import ClusteringDriver, NotClusteredError
from jubatus_tpu_torch.ops import clustering as tops
from torch_parity import port_mix

KMEANS_TOL = 1e-5
GMM_MEAN_TOL = 1e-4
GMM_VAR_RTOL = 1e-3
GMM_PI_TOL = 1e-5
DBSCAN_MARGIN = 1e-3
# the card against the CPU (cuBLAS and the CPU's BLAS round differently)
CARD_TOL = 1e-4

CONV = {
    "string_rules": [{"key": "*", "type": "str", "sample_weight": "bin",
                      "global_weight": "bin"}],
    "num_rules": [{"key": "*", "type": "num"}],
}


def _three_blobs(rng, n_per=30, d=2):
    centers = np.zeros((3, d), np.float32)
    centers[1, 0] = centers[2, 1] = 10.0
    pts = np.concatenate([
        c + rng.normal(scale=0.5, size=(n_per, d)).astype(np.float32)
        for c in centers
    ])
    return pts, centers


def _blobs(seed, k=4, n_per=40, d=3, spread=0.5):
    """k blobs, their centres at least 12 apart, weights in [0.5, 2)."""
    rng = np.random.default_rng(seed)
    centers = np.arange(k, dtype=np.float32)[:, None] * \
        np.full((1, d), 12.0 / np.sqrt(d), np.float32)
    centers += rng.uniform(-1, 1, (k, d)).astype(np.float32)
    x = np.concatenate([c + rng.normal(scale=spread, size=(n_per, d))
                        .astype(np.float32) for c in centers])
    w = rng.uniform(0.5, 2.0, len(x)).astype(np.float32)
    return x, w


def _margin_blobs(seed, eps, k=3, n_per=30, spread=0.6, noise=6):
    """Blobs plus uniform noise points, drawn point by point; a point whose
    squared distance to an earlier one lies within DBSCAN_MARGIN of eps² is
    drawn again."""
    rng = np.random.default_rng(seed)
    centers = rng.uniform(0, 30, (k, 2))
    eps2 = float(np.float32(eps)) ** 2
    pts = []
    while len(pts) < k * n_per + noise:
        i = len(pts)
        p = (rng.uniform(-20, 50, 2) if i >= k * n_per else
             centers[i // n_per] + rng.normal(scale=spread, size=2))
        p = p.astype(np.float32)
        if pts:
            d2 = ((np.asarray(pts, np.float64) - p) ** 2).sum(1)
            if (np.abs(d2 - eps2) / eps2 <= DBSCAN_MARGIN).any():
                continue
        pts.append(p)
    x = np.asarray(pts, np.float32)
    w = np.ones(len(x), np.float32)
    w[::5] = 2.0
    return x, w


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def _assert_eps_margin(x, eps):
    d2 = ((x[:, None, :].astype(np.float64) - x[None, :, :]) ** 2).sum(-1)
    gap = np.abs(d2 - float(np.float32(eps)) ** 2) / float(eps) ** 2
    assert gap.min() > DBSCAN_MARGIN, "a pair lies within the margin of eps"


# ---------------------------------------------------------------------------
# ops against jubatus_tpu.ops.clustering
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("seed", range(6))
def test_kmeans_fit_matches_jax(seed):
    x, w = _blobs(seed, d=2 + seed % 3)
    cj, aj = jops.kmeans_fit(jnp.asarray(x), jnp.asarray(w), k=4, seed=seed)
    ct, at = tops.kmeans_fit(_t(x), _t(w), k=4, seed=seed)
    np.testing.assert_array_equal(at.numpy(), np.asarray(aj))
    np.testing.assert_allclose(ct.numpy(), np.asarray(cj), rtol=0,
                               atol=KMEANS_TOL)


@pytest.mark.parametrize("seed", range(6))
def test_gmm_fit_matches_jax(seed):
    rng = np.random.default_rng(seed + 100)
    x, true_centers = _three_blobs(rng, n_per=40, d=2 + seed % 3)
    w = rng.uniform(0.5, 2.0, len(x)).astype(np.float32)
    sj, aj = jops.gmm_fit(jnp.asarray(x), jnp.asarray(w), k=3, seed=seed)
    for tc in true_centers:     # one component on each blob
        assert np.min(np.linalg.norm(np.asarray(sj.means) - tc, axis=1)) < 1.0
    st, at = tops.gmm_fit(_t(x), _t(w), k=3, seed=seed)
    np.testing.assert_array_equal(at.numpy(), np.asarray(aj))
    np.testing.assert_allclose(st.means.numpy(), np.asarray(sj.means),
                               rtol=0, atol=GMM_MEAN_TOL)
    np.testing.assert_allclose(st.var.numpy(), np.asarray(sj.var),
                               rtol=GMM_VAR_RTOL, atol=0)
    np.testing.assert_allclose(st.pi.numpy(), np.asarray(sj.pi), rtol=0,
                               atol=GMM_PI_TOL)


@pytest.mark.parametrize("seed,eps,min_core", [(0, 1.1, 3), (1, 0.9, 2),
                                               (2, 1.3, 4), (3, 0.6, 2)])
def test_dbscan_fit_matches_jax(seed, eps, min_core):
    x, w = _margin_blobs(seed + 200, eps)
    _assert_eps_margin(x, eps)
    lj = np.asarray(jops.dbscan_fit(jnp.asarray(x), jnp.asarray(w), eps,
                                    min_core_point=min_core))
    lt = tops.dbscan_fit(_t(x), _t(w), eps, min_core_point=min_core).numpy()
    np.testing.assert_array_equal(lt, lj)
    assert (lt == -1).any() and len(set(lt[lt >= 0])) >= 2


def test_pairwise_sq_dists_matches_jax(rng):
    x = rng.normal(size=(50, 7)).astype(np.float32)
    y = rng.normal(size=(9, 7)).astype(np.float32)
    want = np.asarray(jops.pairwise_sq_dists(jnp.asarray(x), jnp.asarray(y)))
    got = tops.pairwise_sq_dists(_t(x), _t(y)).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)


# -- the kernel cases of tests/test_clustering_burst_graph.py ------------------
def test_kmeans_recovers_blobs(rng):
    x, true_centers = _three_blobs(rng)
    w = np.ones(len(x), np.float32)
    centers, assign = tops.kmeans_fit(_t(x), _t(w), k=3, seed=1)
    cj, aj = jops.kmeans_fit(jnp.asarray(x), jnp.asarray(w), k=3, seed=1)
    np.testing.assert_array_equal(assign.numpy(), np.asarray(aj))
    centers = centers.numpy()
    np.testing.assert_allclose(centers, np.asarray(cj), atol=KMEANS_TOL)
    for tc in true_centers:
        assert np.min(np.linalg.norm(centers - tc, axis=1)) < 1.0
    a = assign.numpy()
    for b in range(3):
        blob = a[b * 30:(b + 1) * 30]
        assert (blob == np.bincount(blob).argmax()).mean() > 0.9


def test_gmm_recovers_blobs(rng):
    x, true_centers = _three_blobs(rng)
    w = np.ones(len(x), np.float32)
    state, assign = tops.gmm_fit(_t(x), _t(w), k=3, seed=0)
    sj, aj = jops.gmm_fit(jnp.asarray(x), jnp.asarray(w), k=3, seed=0)
    np.testing.assert_array_equal(assign.numpy(), np.asarray(aj))
    means = state.means.numpy()
    np.testing.assert_allclose(means, np.asarray(sj.means), atol=GMM_MEAN_TOL)
    for tc in true_centers:
        assert np.min(np.linalg.norm(means - tc, axis=1)) < 1.0
    assert state.pi.numpy().sum() == pytest.approx(1.0, abs=1e-5)


def test_dbscan_labels_blobs_and_noise(rng):
    x, _ = _three_blobs(rng)
    x = np.vstack([x, np.array([[100.0, 100.0]], np.float32)])
    w = np.ones(len(x), np.float32)
    _assert_eps_margin(x, 2.0)
    labels = tops.dbscan_fit(_t(x), _t(w), 2.0, min_core_point=3).numpy()
    np.testing.assert_array_equal(labels, np.asarray(jops.dbscan_fit(
        jnp.asarray(x), jnp.asarray(w), 2.0, min_core_point=3)))
    assert labels[-1] == -1
    assert len({lab for lab in labels[:90] if lab >= 0}) >= 3


def test_closure_steps_are_the_jax_count():
    assert [tops.closure_steps(n) for n in (1, 2, 3, 90, 8192, 8193)] == \
        [1, 1, 2, 7, 13, 14]


# ---------------------------------------------------------------------------
# the engine (tests/test_clustering_burst_graph.py), on both drivers
# ---------------------------------------------------------------------------
def _pair(cfg):
    return (ClusteringDriver(cfg, dim_bits=12, device="cpu"),
            JClustering(cfg, dim_bits=12))


def _push_blobs(drivers, rng, n_per=20, i=0):
    pts = []
    for cx, cy in [(0, 0), (30, 0), (0, 30)]:
        for _ in range(n_per):
            pts.append((f"p{i}", {"x": cx + float(rng.normal()),
                                  "y": cy + float(rng.normal())}))
            i += 1
    t, j = drivers
    t.push([(rid, Datum(d)) for rid, d in pts])
    j.push([(rid, JDatum(d)) for rid, d in pts])


def _num(datum):
    return dict(datum.num_values)


def assert_centers_close(got, want, tol=KMEANS_TOL):
    assert len(got) == len(want)
    for g, w in zip(got, want):
        g, w = _num(g), _num(w)
        assert set(g) == set(w)
        for key in g:
            assert g[key] == pytest.approx(w[key], abs=tol)


def _light(members):
    return [[(float(wt), rid) for wt, rid in m] for m in members]


def assert_same_clustering(t, j, tol=KMEANS_TOL):
    """Revision, centres, members and nearest answers agree."""
    assert t.get_revision() == j.get_revision()
    assert_centers_close(t.get_k_center(), j.get_k_center(), tol)
    assert _light(t.get_core_members_light()) == \
        _light(j.get_core_members_light())
    for q in ({"x": 30.0, "y": 0.0}, {"x": 0.0, "y": 30.0}, {"x": 1.0}):
        assert_centers_close([t.get_nearest_center(Datum(q))],
                             [j.get_nearest_center(JDatum(q))], tol)
        assert _light([t.get_nearest_members_light(Datum(q))]) == \
            _light([j.get_nearest_members_light(JDatum(q))])


def test_clustering_kmeans_engine(rng):
    cfg = {"converter": CONV, "method": "kmeans",
           "parameter": {"k": 3, "seed": 0},
           "compressor_method": "simple",
           "compressor_parameter": {"bucket_size": 60}}
    t, j = _pair(cfg)
    with pytest.raises(NotClusteredError):
        t.get_k_center()
    with pytest.raises(JNotClustered):
        j.get_k_center()
    assert t.get_revision() == 0
    _push_blobs((t, j), rng)
    assert t.get_revision() == 1
    assert_same_clustering(t, j)
    centers = t.get_k_center()
    assert len(centers) == 3
    nv = _num(t.get_nearest_center(Datum({"x": 30.0, "y": 0.0})))
    assert nv["x"] == pytest.approx(30.0, abs=2.0)
    ids = {rid for _, rid in t.get_nearest_members_light(
        Datum({"x": 0.0, "y": 30.0}))}
    assert ids & {f"p{i}" for i in range(40, 60)}
    core = t.get_core_members()
    assert sum(len(c) for c in core) == 60
    assert [[(w, d.num_values) for w, d in c] for c in core] == \
        [[(w, d.num_values) for w, d in c] for c in j.get_core_members()]
    t.clear()
    assert t.get_revision() == 0


@pytest.mark.parametrize("method", ["gmm", "kmeans"])
def test_clustering_engine_over_many_buckets(method):
    """Several pushes, each completing a bucket: every recluster's answers
    agree (GMM centres within GMM_MEAN_TOL)."""
    cfg = {"converter": CONV, "method": method,
           "parameter": {"k": 3, "seed": 4},
           "compressor_method": "simple",
           "compressor_parameter": {"bucket_size": 30}}
    t, j = _pair(cfg)
    rng = np.random.default_rng(21)
    for push in range(3):
        _push_blobs((t, j), rng, n_per=10, i=30 * push)
        assert_same_clustering(t, j, GMM_MEAN_TOL if method == "gmm"
                               else KMEANS_TOL)
    assert t.get_revision() == 3
    assert t.last_recluster["n"] == 90 and t.last_recluster["fit_s"] > 0


def test_clustering_dbscan_engine(rng):
    cfg = {"converter": CONV, "method": "dbscan",
           "parameter": {"eps": 3.0, "min_core_point": 3},
           "compressor_method": "simple",
           "compressor_parameter": {"bucket_size": 60}}
    t, j = _pair(cfg)
    _push_blobs((t, j), rng)
    x, _ = t._compact()
    _assert_eps_margin(x, 3.0)
    assert_same_clustering(t, j)
    assert len(t.get_k_center()) >= 3


def test_clustering_compressive_caps_points(rng):
    cfg = {"converter": CONV, "method": "kmeans",
           "parameter": {"k": 2, "seed": 0},
           "compressor_method": "compressive",
           "compressor_parameter": {"bucket_size": 20,
                                    "compressed_bucket_size": 30}}
    t, j = _pair(cfg)
    for batch in range(5):
        vals = [float(rng.normal(batch * 5)) for _ in range(20)]
        t.push([(f"b{batch}_{i}", Datum({"x": v})) for i, v in enumerate(vals)])
        j.push([(f"b{batch}_{i}", JDatum({"x": v}))
                for i, v in enumerate(vals)])
    assert t.get_status()["num_points"] <= 30
    assert t.get_status()["num_points"] == j.get_status()["num_points"]
    assert_same_clustering(t, j)
    total_w = sum(w for mem in t.get_core_members_light() for w, _ in mem)
    assert total_w == pytest.approx(100.0)


def test_clustering_mix_replicates_points():
    cfg = {"converter": CONV, "method": "kmeans",
           "parameter": {"k": 2, "seed": 0},
           "compressor_method": "simple",
           "compressor_parameter": {"bucket_size": 10}}
    ta, tb = (ClusteringDriver(cfg, dim_bits=12, device="cpu")
              for _ in range(2))
    ja, jb = JClustering(cfg, dim_bits=12), JClustering(cfg, dim_bits=12)
    for D, a, b in ((Datum, ta, tb), (JDatum, ja, jb)):
        a.push([(f"a{i}", D({"x": float(i)})) for i in range(5)])
        b.push([(f"b{i}", D({"x": float(100 + i)})) for i in range(5)])
    port_mix([ta, tb])
    LocalMixGroup([ja, jb]).mix()
    for t, j in ((ta, ja), (tb, jb)):
        assert t.get_status()["num_points"] == 10
        assert_same_clustering(t, j)


def test_clustering_save_load():
    cfg = {"converter": CONV, "method": "kmeans",
           "parameter": {"k": 2, "seed": 0},
           "compressor_method": "simple",
           "compressor_parameter": {"bucket_size": 10}}
    t = ClusteringDriver(cfg, dim_bits=12, device="cpu")
    t.push([(f"p{i}", Datum({"x": float(i % 2 * 50)})) for i in range(10)])
    t2 = ClusteringDriver(cfg, dim_bits=12, device="cpu")
    t2.unpack(t.pack())
    assert t2.get_revision() == t.get_revision()
    assert len(t2.get_k_center()) == 2
    # the port's pack in the JAX driver, and the JAX pack in the port
    j = JClustering(cfg, dim_bits=12)
    j.unpack(t.pack())
    assert_same_clustering(t2, j)
    t3 = from_jax_pack(j.pack(), cfg, engine="clustering", device="cpu")
    assert_same_clustering(t3, j)


@pytest.mark.parametrize("method,param", [
    ("kmeans", {"k": 3, "seed": 2}), ("gmm", {"k": 3, "seed": 1}),
    ("dbscan", {"eps": 2.5, "min_core_point": 3})])
def test_clustering_packs_cross_load_both_ways(method, param):
    cfg = {"converter": CONV, "method": method, "parameter": param,
           "compressor_method": "simple",
           "compressor_parameter": {"bucket_size": 25}}
    rng = np.random.default_rng(17)
    j = JClustering(cfg, dim_bits=14)
    pts = [(f"q{i}", {"x": 15.0 * (i % 3) + float(rng.normal()),
                      "y": float(rng.normal()), "s": "t"})
           for i in range(60)]
    j.push([(rid, JDatum(d)) for rid, d in pts])
    tol = GMM_MEAN_TOL if method == "gmm" else KMEANS_TOL
    t = from_jax_pack(j.pack(), cfg, engine="clustering", device="cpu")
    assert_same_clustering(t, j, tol)
    t.push([(f"r{i}", Datum({"x": 1.0 + i, "y": 2.0})) for i in range(25)])
    j2 = JClustering(cfg, dim_bits=14)
    j2.unpack(t.pack())
    assert_same_clustering(t, j2, tol)
    with pytest.raises(ValueError):
        from_jax_pack(j.pack(), dict(cfg, method="kmeans" if method != "kmeans"
                                     else "gmm"),
                      engine="clustering", device="cpu")


# ---------------------------------------------------------------------------
# the card against the CPU
# ---------------------------------------------------------------------------
@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the ops on the card against the CPU")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("seed", range(3))
def test_ops_on_the_card_match_the_cpu(cuda, seed):
    x, w = _blobs(seed + 300, k=4, n_per=200, d=6)
    xd, wd = _margin_blobs(seed + 400, 1.0, n_per=150)
    ct, at = tops.kmeans_fit(_t(x), _t(w), k=4, seed=seed)
    cg, ag = tops.kmeans_fit(_t(x).to(cuda), _t(w).to(cuda), k=4, seed=seed)
    np.testing.assert_array_equal(ag.cpu().numpy(), at.numpy())
    np.testing.assert_allclose(cg.cpu().numpy(), ct.numpy(), atol=CARD_TOL)
    rng = np.random.default_rng(seed + 500)
    x, true_centers = _three_blobs(rng, n_per=200, d=6)
    w = rng.uniform(0.5, 2.0, len(x)).astype(np.float32)
    st, at = tops.gmm_fit(_t(x), _t(w), k=3, seed=seed)
    for tc in true_centers:     # one component on each blob
        assert np.min(np.linalg.norm(st.means.numpy() - tc, axis=1)) < 1.0
    sg, ag = tops.gmm_fit(_t(x).to(cuda), _t(w).to(cuda), k=3, seed=seed)
    np.testing.assert_array_equal(ag.cpu().numpy(), at.numpy())
    np.testing.assert_allclose(sg.means.cpu().numpy(), st.means.numpy(),
                               atol=CARD_TOL)
    _assert_eps_margin(xd, 1.0)
    lt = tops.dbscan_fit(_t(xd), _t(wd), 1.0, min_core_point=3)
    lg = tops.dbscan_fit(_t(xd).to(cuda), _t(wd).to(cuda), 1.0,
                         min_core_point=3)
    np.testing.assert_array_equal(lg.cpu().numpy(), lt.numpy())
