"""Clustering on tensors: k-means (Lloyd), diagonal-covariance GMM (EM),
DBSCAN (counterpart of ``jubatus_tpu/ops/clustering.py``).

Plain functions on tensors, run on the tensors' device. The JAX package's
``fori_loop``s are Python loops of tensor ops here, with the same iteration
counts: k − 1 seeding steps and 25 Lloyd iterations for k-means, 5 k-means
iterations and then 25 EM iterations for the GMM, ⌈log2 N⌉ reachability
squarings for DBSCAN. The products stay ``torch.matmul`` at full float32
(the distance expansion's cross term, the one-hot centre sums, DBSCAN's
0/1 closure, whose sums stay below 2^24 and so are exact).

What the JAX package does is kept as it is, where it is unusual:

- the k-means++ seeding measures every point against all k centre rows,
  the rows not yet chosen included, which are still zero (so the distance
  to the origin counts);
- its draws are ``jax.random.split`` and ``jax.random.categorical`` from
  ``PRNGKey(seed)``, through ``ops/prng.py``, which picks the same rows
  unless two candidates lie within the last bits of a float32 log;
- the GMM's starting variance is the population variance (``jnp.var``);
- DBSCAN's threshold is ``d2 <= eps * eps`` with eps and its square in
  float32.

Every function takes point weights w [N] (the compressor's coreset
weights) and respects them in the centre and covariance updates.
"""

from __future__ import annotations

import math
from typing import NamedTuple

import numpy as np
import torch

from jubatus_tpu_torch.ops import prng


# ---------------------------------------------------------------------------
# shared
# ---------------------------------------------------------------------------
def pairwise_sq_dists(x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    """[N, d], [M, d] → [N, M] squared euclidean distances (matmul cross
    term, clamped at 0)."""
    xn = torch.sum(x * x, dim=1)[:, None]
    yn = torch.sum(y * y, dim=1)[None, :]
    return torch.clamp(xn - 2.0 * (x @ y.T) + yn, min=0.0)


# ---------------------------------------------------------------------------
# k-means
# ---------------------------------------------------------------------------
def kmeans_fit(x: torch.Tensor, w: torch.Tensor, *, k: int, iters: int = 25,
               seed: int = 0):
    """Weighted Lloyd k-means: x [N, d] points, w [N] weights →
    (centers [k, d], assign [N] int64). Seeding: the first centre is the
    heaviest point (the first of equals), then distance-weighted picks."""
    key = prng.PRNGKey(seed, device=x.device)
    centers = torch.zeros((k, x.shape[1]), dtype=x.dtype, device=x.device)
    centers[0] = torch.index_select(x, 0, torch.argmax(w).reshape(1))[0]
    for i in range(1, k):
        d2 = torch.min(pairwise_sq_dists(x, centers), dim=1).values
        probs = d2 * w
        k1, k2 = prng.split(key)
        key, sub = (k1[0], k2[0]), (k1[1], k2[1])
        # distance-weighted pick; uniform logits when every point sits on
        # a centre already
        logits = torch.where(torch.sum(probs) > 0,
                             prng._log32(torch.clamp(probs, min=1e-30)),
                             torch.zeros_like(probs))
        pick = prng.categorical(sub, logits)
        centers[i] = torch.index_select(x, 0, pick.reshape(1))[0]
    for _ in range(iters):
        centers = _lloyd_step(x, w, centers, k)
    assign = torch.argmin(pairwise_sq_dists(x, centers), dim=1)
    return centers, assign


def _lloyd_step(x, w, centers, k: int):
    assign = torch.argmin(pairwise_sq_dists(x, centers), dim=1)
    onehot = torch.nn.functional.one_hot(assign, k).to(x.dtype) * w[:, None]
    sums = onehot.T @ x
    counts = torch.sum(onehot, dim=0)[:, None]
    return torch.where(counts > 0, sums / torch.clamp(counts, min=1e-30),
                       centers)


# ---------------------------------------------------------------------------
# gmm (diagonal covariance EM)
# ---------------------------------------------------------------------------
class GMMState(NamedTuple):
    means: torch.Tensor   # [k, d]
    var: torch.Tensor     # [k, d] diagonal covariance
    pi: torch.Tensor      # [k] mixing weights


def _log_resp(x, state: GMMState):
    """Normalized log responsibilities [N, k] of diagonal Gaussians."""
    inv = 1.0 / state.var
    x2 = (x * x) @ inv.T
    xm = x @ (state.means * inv).T
    m2 = torch.sum(state.means * state.means * inv, dim=1)
    quad = x2 - 2.0 * xm + m2[None, :]
    logdet = torch.sum(torch.log(state.var), dim=1)
    ll = -0.5 * (quad + logdet[None, :]) + torch.log(state.pi)[None, :]
    return ll - torch.logsumexp(ll, dim=1, keepdim=True)


def gmm_fit(x: torch.Tensor, w: torch.Tensor, *, k: int, iters: int = 25,
            seed: int = 0):
    """Weighted diagonal-covariance EM → (GMMState, assign [N] int64)."""
    centers, _ = kmeans_fit(x, w, k=k, iters=5, seed=seed)
    d = x.shape[1]
    var0 = torch.clamp(torch.var(x, dim=0, correction=0), min=1e-4)
    state = GMMState(means=centers,
                     var=var0.expand(k, d).to(x.dtype).clone(),
                     pi=torch.full((k,), 1.0 / k, dtype=x.dtype,
                                   device=x.device))
    for _ in range(iters):
        r = torch.exp(_log_resp(x, state)) * w[:, None]
        nk = torch.clamp(torch.sum(r, dim=0), min=1e-10)
        means = (r.T @ x) / nk[:, None]
        ex2 = (r.T @ (x * x)) / nk[:, None]
        var = torch.clamp(ex2 - means * means, min=1e-6)
        state = GMMState(means=means, var=var, pi=nk / torch.sum(nk))
    assign = torch.argmax(_log_resp(x, state), dim=1)
    return state, assign


# ---------------------------------------------------------------------------
# dbscan
# ---------------------------------------------------------------------------
def closure_steps(n: int) -> int:
    """The reachability squarings DBSCAN runs for N points: ⌈log2 N⌉."""
    return max(1, math.ceil(math.log2(max(n, 2))))


def dbscan_fit(x: torch.Tensor, w: torch.Tensor, eps: float, *,
               min_core_point: int = 2) -> torch.Tensor:
    """DBSCAN → labels [N] int64: −1 is noise, else the index of the
    cluster's representative point (the caller renumbers them 0..C−1).

    The reachability closure runs as ⌈log2 N⌉ squarings of the core-core
    adjacency matrix (float32 products of 0/1 matrices)."""
    n = x.shape[0]
    eps32 = np.float32(eps)
    d2 = pairwise_sq_dists(x, x)
    adj = d2 <= float(np.float32(eps32 * eps32))         # [N, N] incl. self
    ncount = torch.sum(torch.where(adj, w[None, :], 0.0), dim=1)
    core = ncount >= min_core_point                      # [N]
    core_adj = adj & core[None, :] & core[:, None]
    reach = core_adj | torch.eye(n, dtype=torch.bool, device=x.device)
    for _ in range(closure_steps(n)):
        # reach[i, j]: j reachable from i through core points
        f = reach.to(torch.float32)
        reach = reach | ((f @ f) > 0)
    idx = torch.arange(n, device=x.device)
    big = torch.full((), n, dtype=idx.dtype, device=x.device)
    # cluster id of a core point = the least index of the core points it
    # reaches
    member = reach & core[None, :] & core[:, None]
    cluster_of_core = torch.min(torch.where(member, idx[None, :], big),
                                dim=1).values
    # a border point adopts the cluster of an adjacent core point
    border_c = torch.min(torch.where(adj & core[None, :],
                                     cluster_of_core[None, :], big),
                         dim=1).values
    raw = torch.where(core, cluster_of_core, border_c)
    return torch.where(raw >= n, torch.full_like(raw, -1), raw)
