"""IVF (inverted-file) approximate nearest neighbours in torch (counterpart
of ``jubatus_tpu/ops/ivf.py``).

The exact scan prices a query at O(rows). IVF answers in two phases:

1. **Probe**: embed the query into the method's float space and rank the
   k-means cell centroids against it (one [B, K]×[K, E] matmul, the
   ``pairwise_sq_dists`` expansion) and keep the ``nprobe`` nearest cells.
2. **Rescore**: gather only the probed cells' member slots from the cell
   table ([n_cells, cap] int32, −1-padded) and score them with the
   method's EXACT distance. For lsh and minhash that is K1's gathered
   variant (``ops/sig_scan.py:gathered``, ``csrc/sig_scan.cu``), the same
   popcount / lane-match bits as the full scan; euclid_lsh and the exact
   methods (cosine / euclid over the sparse arenas) are torch. Answers
   carry true distances; only which rows get scored is approximate.

Embedding spaces, chosen so that k-means cells follow each metric:

  lsh         the unpacked sign bits as ±1: ||a−b||² = 4·hamming bits.
  minhash     per lane, a hash of the lane's winning feature id mapped to
              [−1, 1] (uint32 arithmetic, computed in int64 masked to 32
              bits: the port holds signatures as int32 bit patterns).
  euclid_lsh  the JL projection itself.
  inverted_index / euclid
              the JL projection of the raw row (``knn.euclid_projection``)
              for probing; the rescore is the exact cosine / euclid.

The coarse partitioner is ``ops/clustering.py:kmeans_fit`` up to 256
cells; above that, Lloyd iterations seeded from a numpy ``default_rng``
sample of rows (kmeans_fit's update, without its O(K²·N) seeding loop).

Where the JAX package takes ``lax.top_k`` of a small candidate set (the
probe, the candidates' top-k), this takes a stable descending sort: on
equal scores it keeps the lower position first, as ``lax.top_k`` does
(``torch.topk`` does not promise an order among equal scores). The
products run at full float32 (TF32 off, PyTorch's default), or cells move.

The two-level assignment of the JAX package's 10^8-row builds is here too
(``build_super``, ``assign_cells_hier`` on the device, and the host's
``assign_cells_grouped``); no entry point reaches it yet.
"""

from __future__ import annotations

import math
from typing import Tuple

import numpy as np
import torch

from jubatus_tpu_torch import resolve_device
from jubatus_tpu_torch.ops import sig_scan
from jubatus_tpu_torch.ops.clustering import kmeans_fit, pairwise_sq_dists

#: kmeans_fit's seeding loop is O(K²·N); above this cell count
#: train_centroids seeds Lloyd from a row sample instead
_PLUS_PLUS_MAX_CELLS = 256

#: lane-hash constants of the minhash embedding (a splitmix-style mixer)
_MIX1 = 0x9E3779B9
_MIX2 = 0x85EBCA6B
_MIX3 = 0xC2B2AE35
_MASK = 0xFFFFFFFF
#: float32 2 / (2^32 − 1), the minhash embedding's scale
_U32_SCALE = np.float32(2.0 / 4294967295.0)

_SIG_MODE = {"lsh": "hamming", "minhash": "minhash"}


def auto_cells(n_rows: int) -> int:
    """Default cell count: the power of two nearest √rows, at least 8."""
    if n_rows <= 64:
        return 8
    return max(8, 2 ** int(round(math.log2(max(math.sqrt(n_rows), 8.0)))))


# ---------------------------------------------------------------------------
# embeddings (signature → metric-aligned float space)
# ---------------------------------------------------------------------------
def _mul32(a: torch.Tensor, b: int) -> torch.Tensor:
    """(a * b) mod 2^32 for a in [0, 2^32) held in int64, without an int64
    overflow: b is split into 16-bit halves."""
    lo = a * (b & 0xFFFF)
    hi = ((a * (b >> 16)) & 0xFFFF) << 16
    return (lo + hi) & _MASK


def embed_signatures(sigs: torch.Tensor, *, method: str,
                     hash_num: int) -> torch.Tensor:
    """[N, W/H] signature rows → [N, E] float32 whose squared euclidean
    distance tracks the method's distance. euclid_lsh and the exact
    methods' JL projections pass through."""
    if method == "lsh":
        shifts = torch.arange(32, dtype=torch.int32, device=sigs.device)
        # bit i of the int32 word is (word >> i) & 1 for every i < 32
        bits = (sigs[:, :, None] >> shifts[None, None, :]) & 1
        bits = bits.reshape(sigs.shape[0], -1)[:, :hash_num]
        return bits.to(torch.float32) * 2.0 - 1.0
    if method == "minhash":
        lane = torch.arange(sigs.shape[1], dtype=torch.int64,
                            device=sigs.device)[None, :]
        h = ((sigs.to(torch.int64) & _MASK) + lane * _MIX1) & _MASK
        h = _mul32(h ^ (h >> 16), _MIX2)
        h = _mul32(h ^ (h >> 13), _MIX3)
        h = h ^ (h >> 16)
        scale = torch.tensor(_U32_SCALE, device=sigs.device)
        # int64 → float32 rounds to nearest, as XLA's uint32 → float32
        return h.to(torch.float32) * scale - 1.0
    return sigs.to(torch.float32)


# ---------------------------------------------------------------------------
# coarse partitioner
# ---------------------------------------------------------------------------
def _lloyd_refine(x: torch.Tensor, centers: torch.Tensor, *,
                  iters: int) -> torch.Tensor:
    """Unweighted Lloyd iterations from the given seeds."""
    k = centers.shape[0]
    for _ in range(iters):
        assign = torch.argmin(pairwise_sq_dists(x, centers), dim=1)
        onehot = torch.nn.functional.one_hot(assign, k).to(x.dtype)
        sums = onehot.T @ x
        counts = torch.sum(onehot, dim=0)[:, None]
        centers = torch.where(counts > 0,
                              sums / torch.clamp(counts, min=1e-30), centers)
    return centers


def train_centroids(emb: torch.Tensor, n_cells: int, *, iters: int = 8,
                    seed: int = 0) -> np.ndarray:
    """Centroids [n_cells, E] float32 (host) from the embedded rows on
    their device: ``kmeans_fit`` up to 256 cells, else Lloyd seeded from
    a deterministic row sample."""
    emb = emb.to(torch.float32)
    n = emb.shape[0]
    if n == 0:
        raise ValueError("train_centroids needs at least one row")
    if n_cells <= _PLUS_PLUS_MAX_CELLS:
        centers, _ = kmeans_fit(
            emb, torch.ones(n, dtype=torch.float32, device=emb.device),
            k=n_cells, iters=max(iters, 1), seed=seed)
        return centers.cpu().numpy().astype(np.float32)
    rng = np.random.default_rng(seed)
    if n >= n_cells:
        pick = rng.choice(n, size=n_cells, replace=False)
    else:  # fewer rows than cells: repeat rows as seeds
        pick = rng.integers(0, n, size=n_cells)
    seeds = emb[torch.from_numpy(np.sort(pick)).to(emb.device)]
    return _lloyd_refine(emb, seeds, iters=max(iters, 1)).cpu().numpy() \
        .astype(np.float32)


def assign_cells(emb: torch.Tensor, centroids: torch.Tensor) -> torch.Tensor:
    """Nearest-centroid cell per row (the first on a tie): [N] int32."""
    return torch.argmin(pairwise_sq_dists(emb, centroids),
                        dim=1).to(torch.int32)


def build_super(centroids: np.ndarray, *, n_super: int, seed: int = 0,
                device=None) -> Tuple[np.ndarray, np.ndarray]:
    """Two-level routing tables for bulk assignment: cluster the cell
    centroids into ``n_super`` groups on ``device`` (``cuda`` unless asked)
    → (supers [G, E] float32, members [G, M] int32, −1-padded; M = max
    group size), cells in ascending order within a group."""
    dev = resolve_device(device)
    n_super = max(1, min(n_super, centroids.shape[0]))
    cen = torch.from_numpy(np.asarray(centroids, np.float32)).to(dev)
    supers = train_centroids(cen, n_super, seed=seed)
    owner = assign_cells(cen, torch.from_numpy(supers).to(dev)).cpu().numpy()
    m = max(1, int(np.bincount(owner, minlength=n_super).max()))
    members = np.full((n_super, m), -1, np.int32)
    fill = np.zeros(n_super, np.int64)
    for cell, g in enumerate(owner):
        members[g, fill[g]] = cell
        fill[g] += 1
    return supers, members


def assign_cells_hier(emb: torch.Tensor, centroids: torch.Tensor,
                      supers: torch.Tensor, members: torch.Tensor, *,
                      top_supers: int = 2) -> torch.Tensor:
    """Two-level cell assignment: rank the super-groups, then the argmin
    over the union of the top groups' member cells — (G + top·M)·E flops a
    row instead of K·E. Exact when the nearest cell's group is among the
    probed groups. The ranking keeps ``lax.top_k``'s order; the distance is
    the expansion ‖c‖² − 2⟨e, c⟩, one batched product over the gathered
    centroids. [N] int32."""
    ds = pairwise_sq_dists(emb, supers)                       # [N, G]
    top = min(top_supers, supers.shape[0])
    gsel = top_sorted(-ds, top)[1]                            # [N, top]
    cand = members.long()[gsel].reshape(emb.shape[0], -1)     # [N, top·M]
    safe = torch.clamp(cand, min=0)
    cn2 = torch.sum(centroids * centroids, dim=-1)            # [K]
    dots = torch.bmm(centroids[safe], emb[:, :, None])[:, :, 0]
    d2 = torch.where(cand >= 0, cn2[safe] - 2.0 * dots,
                     torch.full_like(dots, float("inf")))
    best = torch.argmin(d2, dim=1)
    return safe.gather(1, best[:, None])[:, 0].to(torch.int32)


def assign_cells_grouped(emb: np.ndarray, centroids: np.ndarray,
                         supers: np.ndarray, members: np.ndarray,
                         top_supers: int = 2) -> np.ndarray:
    """Bulk two-level assignment on the host (the JAX package's numpy code):
    rows group by their ranked super so each group is one dense
    [n_g, E]×[E, M] product against a cache-resident centroid block, with
    no per-row gather tensor. Same answer as ``assign_cells_hier``."""
    emb = np.asarray(emb, np.float32)
    n = emb.shape[0]
    n_super = supers.shape[0]
    top = max(1, min(top_supers, n_super))
    cn2 = np.sum(np.square(centroids), axis=-1)
    sn2 = np.sum(np.square(supers), axis=-1)
    sd = sn2[None, :] - 2.0 * (emb @ supers.T)                # [N, G]
    if top < n_super:
        gtop = np.argpartition(sd, top, axis=1)[:, :top]
    else:
        gtop = np.tile(np.arange(n_super), (n, 1))
    out = np.zeros(n, np.int32)
    best = np.full(n, np.inf, np.float32)
    for t in range(top):
        gs = gtop[:, t]
        order = np.argsort(gs, kind="stable")
        bounds = np.searchsorted(gs[order], np.arange(n_super + 1))
        for g in range(n_super):
            lo, hi = bounds[g], bounds[g + 1]
            if lo == hi:
                continue
            idx = order[lo:hi]
            cells = members[g]
            cells = cells[cells >= 0]
            if cells.size == 0:
                continue
            d = cn2[cells][None, :] - 2.0 * (emb[idx] @ centroids[cells].T)
            am = np.argmin(d, axis=1)
            dm = d[np.arange(len(idx)), am]
            upd = dm < best[idx]
            out[idx[upd]] = cells[am[upd]]
            best[idx[upd]] = dm[upd]
    return out


# ---------------------------------------------------------------------------
# probe + candidate-shaped exact rescore
# ---------------------------------------------------------------------------
def top_sorted(scores: torch.Tensor, kk: int) -> Tuple[torch.Tensor,
                                                       torch.Tensor]:
    """(values, positions) of the ``kk`` highest scores of each row, the
    lower position first among equals (``lax.top_k``'s order)."""
    vals, pos = torch.sort(scores, dim=-1, descending=True, stable=True)
    return vals[..., :kk], pos[..., :kk]


def probe_cells(q_emb: torch.Tensor, centroids: torch.Tensor, *,
                nprobe: int) -> torch.Tensor:
    """The ``nprobe`` nearest cells of each query: [B, P] int64."""
    d2 = pairwise_sq_dists(q_emb, centroids)
    return top_sorted(-d2, min(nprobe, centroids.shape[0]))[1]


def candidate_sig_distances(q_sigs: torch.Tensor, table: torch.Tensor,
                            cand: torch.Tensor, *, method: str,
                            hash_num: int) -> torch.Tensor:
    """The method's exact signature distance of each query to its
    candidate rows ``table[cand[b, m]]``: [B, M] float32, +inf where
    ``cand`` is −1. lsh and minhash run K1's gathered variant."""
    mode = _SIG_MODE.get(method)
    if mode is not None:
        return sig_scan.gathered(mode, q_sigs, table, cand, hash_num)
    # euclid_lsh: the batch kernel's ||q||² − 2q·r + ||r||² expansion
    rows = table[torch.clamp(cand, min=0)]                  # [B, M, H]
    dots = torch.sum(q_sigs[:, None, :] * rows, dim=-1)
    rn = torch.sum(rows * rows, dim=-1)
    qn = torch.sum(q_sigs * q_sigs, dim=-1)[:, None]
    d = torch.sqrt(torch.clamp(qn - 2.0 * dots + rn, min=0.0)) \
        / float(hash_num) ** 0.5
    return torch.where(cand >= 0, d, torch.full_like(d, float("inf")))


def candidate_exact_distances(q_dense: torch.Tensor, cand_idx: torch.Tensor,
                              cand_val: torch.Tensor, *,
                              method: str) -> torch.Tensor:
    """Exact cosine / euclid distance over gathered sparse candidate rows:
    q_dense [B, D], cand_idx / cand_val [B, M, K] → [B, M]."""
    b = q_dense.shape[0]
    gathered = torch.gather(q_dense, 1, cand_idx.reshape(b, -1).long()) \
        .view_as(cand_val)
    dots = torch.sum(cand_val * gathered, dim=-1)
    rn2 = torch.sum(cand_val * cand_val, dim=-1)
    qn2 = torch.sum(q_dense * q_dense, dim=-1)[:, None]
    if method == "inverted_index":
        denom = torch.sqrt(rn2) * torch.sqrt(qn2)
        sim = torch.where(denom > 0, dots / torch.clamp(denom, min=1e-30),
                          torch.zeros_like(dots))
        return 1.0 - sim
    return torch.sqrt(torch.clamp(rn2 - 2.0 * dots + qn2, min=0.0))


def tie_ordered(scores: torch.Tensor, ids: torch.Tensor):
    """Order each row by score descending, then id ascending (two stable
    sorts: torch has no lexsort)."""
    order = torch.sort(ids, dim=-1, stable=True).indices
    scores, ids = scores.gather(-1, order), ids.gather(-1, order)
    order = torch.sort(scores, dim=-1, descending=True, stable=True).indices
    return scores.gather(-1, order), ids.gather(-1, order)


def probe_gather(q_emb: torch.Tensor, centroids: torch.Tensor,
                 cell_slots: torch.Tensor, nprobe: int) -> torch.Tensor:
    """The probe phase: [B, P·cap] candidate slots (−1 = padding) of the
    ``nprobe`` nearest cells."""
    cells = probe_cells(q_emb, centroids, nprobe=nprobe)    # [B, P]
    return cell_slots[cells].reshape(q_emb.shape[0], -1)


def select_topk(d: torch.Tensor, cand: torch.Tensor, k: int):
    """The candidates' top-k by distance: (distances [B, k'], slots
    [B, k']), k' = min(k, M), score desc then slot asc; a non-finite
    distance marks no candidate."""
    neg = torch.where(cand >= 0, -d, torch.full_like(d, -float("inf")))
    neg, pos = top_sorted(neg, min(k, neg.shape[-1]))
    slots = torch.clamp(cand, min=0).gather(-1, pos)
    neg, slots = tie_ordered(neg, slots)
    return -neg, slots


def ivf_topk(q_sigs, q_emb, sig_table, centroids, cell_slots, *,
             method: str, hash_num: int, k: int, nprobe: int):
    """Single-device two-phase IVF query of the signature methods.

    q_sigs [B, W/H], q_emb [B, E]; sig_table [C, W/H]; centroids
    [n_cells, E]; cell_slots [n_cells, cap] int32, −1-padded. Returns
    (distances [B, k'], slots [B, k']), k' = min(k, P·cap)."""
    cand = probe_gather(q_emb, centroids, cell_slots, nprobe)
    d = candidate_sig_distances(q_sigs, sig_table, cand, method=method,
                                hash_num=hash_num)
    return select_topk(d, cand, k)


def ivf_topk_exact(q_dense, q_emb, row_idx, row_val, centroids, cell_slots,
                   *, method: str, k: int, nprobe: int):
    """Two-phase IVF query of the exact methods (inverted_index, euclid):
    probe by the JL projections, rescore the gathered sparse rows with
    the exact cosine / euclid expansion. row_idx / row_val [C, K]."""
    cand = probe_gather(q_emb, centroids, cell_slots, nprobe)
    safe = torch.clamp(cand, min=0)
    d = candidate_exact_distances(q_dense, row_idx[safe], row_val[safe],
                                  method=method)
    return select_topk(d, cand, k)
