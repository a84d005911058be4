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

Not ported (no entry point reaches them): ``build_super``,
``assign_cells_hier`` and ``assign_cells_grouped``, the two-level
assignment of the JAX package's 10^8-row builds.
"""

from __future__ import annotations

import math
from typing import Tuple

import numpy as np
import torch

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
