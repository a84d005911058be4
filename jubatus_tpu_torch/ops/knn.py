"""Nearest-neighbor scoring in torch: exact cosine/euclid and the LSH family.

Counterpart of ``jubatus_tpu/ops/knn.py``. The exact scorers (``densify``,
``dot_scores``, ``row_norms``, ``cosine_scores``, ``euclid_distances``) are
XLA programs there and plain torch here: the query is scattered into a dense
[D] vector once, and every row's score is a gather + multiply + row sum over
the store's padded [C, K] arenas (padding entries (0, 0.0) add nothing).

The LSH family's per-feature projections are the same threefry draws
(``ops/prng.py``), keyed by ``(seed, tag, feature index)``:

- lsh: sign random projection, bits packed 32 to a word (uint32 bit patterns
  in int32); distance = normalized Hamming, scanned by ``ops/sig_scan.py``;
- minhash: weighted minhash, lane value = the feature index minimizing
  ``-log(u) / w``; distance = 1 - matching-lane fraction (``ops/sig_scan.py``);
- euclid_lsh: JL projection to hash_num floats; distance ``||p_q - p_r||/√H``.

Draws depend only on the feature index, so they are made once per distinct
index in the batch and gathered, instead of once per (row, entry) as the
JAX package's vmap does: the same numbers at a fraction of the memory. The
projection sums over the row's entries in entry order, one float32 multiply
and add at a time; that order is the same on the CPU and on the card, so a
signature does not depend on the device.

Inputs are a padded sparse batch: ``idx`` [B, K] int32 and ``val`` [B, K]
float32 tensors on one device (padding is (0, 0.0)).
"""

from __future__ import annotations

import torch

from jubatus_tpu_torch.ops import prng, sig_scan

# fold_in domain tags so lsh / minhash / euclid_lsh draw independent streams
_TAG_LSH = 0x1A5B
_TAG_MINHASH = 0x3C7D
_TAG_EUCLID = 0x5E9F

#: rows per step of the signature loops (bounds the [rows, H] temporaries)
ROW_CHUNK = 1 << 16
#: distinct features per step of the draw (bounds threefry's int64 temporaries)
DRAW_CHUNK = 1 << 15


# ---------------------------------------------------------------------------
# dense/exact scoring
# ---------------------------------------------------------------------------
def densify(idx: torch.Tensor, val: torch.Tensor, *, dim: int) -> torch.Tensor:
    """Scatter one sparse vector [K] into dense [dim]; duplicate indices
    sum (``index_add_``, as ``.at[idx].add`` does)."""
    out = torch.zeros(dim, dtype=torch.float32, device=val.device)
    return out.index_add_(0, idx, val.float())


def dot_scores(row_idx: torch.Tensor, row_val: torch.Tensor,
               q_dense: torch.Tensor) -> torch.Tensor:
    """row_i · q for all rows: gather q at each row's indices. [C]."""
    gathered = q_dense.index_select(0, row_idx.reshape(-1))
    return (row_val * gathered.view_as(row_val)).sum(dim=1)


def row_norms(row_idx: torch.Tensor, row_val: torch.Tensor) -> torch.Tensor:
    """L2 norm per row; padding zeros add nothing. [C]."""
    return torch.sqrt((row_val * row_val).sum(dim=1))


def cosine_scores(row_idx: torch.Tensor, row_val: torch.Tensor,
                  q_dense: torch.Tensor) -> torch.Tensor:
    """Cosine similarity of every row against the query. [C]; dead and
    zero rows (and a zero query) score 0."""
    dots = dot_scores(row_idx, row_val, q_dense)
    rn = row_norms(row_idx, row_val)
    qn = torch.sqrt((q_dense * q_dense).sum())
    denom = rn * qn
    return torch.where(denom > 0, dots / torch.clamp(denom, min=1e-30),
                       torch.zeros_like(dots))


def euclid_distances(row_idx: torch.Tensor, row_val: torch.Tensor,
                     q_dense: torch.Tensor) -> torch.Tensor:
    """Exact euclidean distance of every row to the query, expanded as
    ||r||² - 2 r·q + ||q||², clamped at 0 before the square root. [C]."""
    dots = dot_scores(row_idx, row_val, q_dense)
    rn2 = (row_val * row_val).sum(dim=1)
    qn2 = (q_dense * q_dense).sum()
    return torch.sqrt(torch.clamp(rn2 - 2.0 * dots + qn2, min=0.0))


# ---------------------------------------------------------------------------
# the LSH family
# ---------------------------------------------------------------------------
def packed_words(hash_num: int) -> int:
    return (hash_num + 31) // 32


def _feature_draws(idx: torch.Tensor, hash_num: int, seed: int, tag: int,
                   draw) -> tuple:
    """(draws [U, H] float32, inverse [B, K]) for the distinct indices."""
    uniq, inv = torch.unique(idx, return_inverse=True)
    base = prng.fold_in(prng.PRNGKey(seed, device=idx.device), tag)
    out = torch.empty((uniq.shape[0], hash_num), dtype=torch.float32,
                      device=idx.device)
    for lo in range(0, uniq.shape[0], DRAW_CHUNK):
        keys = prng.fold_in(base, uniq[lo:lo + DRAW_CHUNK])
        out[lo:lo + DRAW_CHUNK] = draw(keys, hash_num)
    return out, inv


def _uniform_open(keys, n):
    return prng.uniform(keys, n, 1e-12, 1.0)


def _projection(val, g, inv):
    """Σ_k val[:, k] · g[inv[:, k]] in entry order → [rows, H]."""
    proj = torch.zeros((val.shape[0], g.shape[1]), dtype=torch.float32,
                       device=val.device)
    for k in range(val.shape[1]):
        proj = proj + val[:, k, None] * g[inv[:, k]]
    return proj


def to_int32_words(words: torch.Tensor) -> torch.Tensor:
    """int64 words in [0, 2^32) → the same bits as int32."""
    return torch.where(words >= (1 << 31), words - (1 << 32), words).to(torch.int32)


def lsh_signature(idx: torch.Tensor, val: torch.Tensor, *, hash_num: int,
                  seed: int = 0) -> torch.Tensor:
    """[B, K] sparse batch → [B, W] int32 bit-packed sign signatures."""
    g, inv = _feature_draws(idx, hash_num, seed, _TAG_LSH, prng.normal)
    w = packed_words(hash_num)
    shifts = torch.arange(32, dtype=torch.int64, device=idx.device)
    out = torch.empty((idx.shape[0], w), dtype=torch.int32, device=idx.device)
    for lo in range(0, idx.shape[0], ROW_CHUNK):
        proj = _projection(val[lo:lo + ROW_CHUNK], g, inv[lo:lo + ROW_CHUNK])
        bits = (proj >= 0).to(torch.int64)
        pad = w * 32 - hash_num
        if pad:
            bits = torch.nn.functional.pad(bits, (0, pad))
        bits = bits.reshape(bits.shape[0], w, 32)
        out[lo:lo + ROW_CHUNK] = to_int32_words((bits << shifts).sum(dim=-1))
    return out


def minhash_signature(idx: torch.Tensor, val: torch.Tensor, *, hash_num: int,
                      seed: int = 0) -> torch.Tensor:
    """[B, K] weighted sparse batch → [B, H] int32 signatures (uint32 bits).

    Lane h's value is the feature index minimizing -log(u_{f,h}) / w_f (the
    first such entry on a tie, as argmin takes it); padding (val <= 0) never
    wins, and an all-padding row signs 0xFFFFFFFF on every lane."""
    u, inv = _feature_draws(idx, hash_num, seed, _TAG_MINHASH, _uniform_open)
    e = (-torch.log(u.double())).float()              # [U, H]
    inf = torch.tensor(float("inf"), device=idx.device)
    out = torch.empty((idx.shape[0], hash_num), dtype=torch.int32,
                      device=idx.device)
    for lo in range(0, idx.shape[0], ROW_CHUNK):
        v = val[lo:lo + ROW_CHUNK]
        iv = inv[lo:lo + ROW_CHUNK]
        ix = idx[lo:lo + ROW_CHUNK]
        best = torch.full((v.shape[0], hash_num), float("inf"),
                          device=idx.device)
        win = torch.zeros((v.shape[0], hash_num), dtype=torch.int32,
                          device=idx.device)
        for k in range(v.shape[1]):
            w = v[:, k, None]
            kv = torch.where(w > 0, e[iv[:, k]] / torch.clamp(w, min=1e-30), inf)
            better = kv < best
            best = torch.where(better, kv, best)
            win = torch.where(better, ix[:, k, None], win)
        empty = (v <= 0).all(dim=1, keepdim=True)
        out[lo:lo + ROW_CHUNK] = torch.where(empty, -1, win)
    return out


def euclid_projection(idx: torch.Tensor, val: torch.Tensor, *, hash_num: int,
                      seed: int = 0) -> torch.Tensor:
    """[B, K] sparse batch → [B, H] float32 JL projections."""
    g, inv = _feature_draws(idx, hash_num, seed, _TAG_EUCLID, prng.normal)
    out = torch.empty((idx.shape[0], hash_num), dtype=torch.float32,
                      device=idx.device)
    for lo in range(0, idx.shape[0], ROW_CHUNK):
        out[lo:lo + ROW_CHUNK] = _projection(val[lo:lo + ROW_CHUNK], g,
                                             inv[lo:lo + ROW_CHUNK])
    return out


# ---------------------------------------------------------------------------
# distances
# ---------------------------------------------------------------------------
hamming_distances = sig_scan.hamming_distances
hamming_distances_batch = sig_scan.hamming_distances_batch
minhash_distances = sig_scan.minhash_distances
minhash_distances_batch = sig_scan.minhash_distances_batch


def euclid_lsh_distances(q_proj: torch.Tensor, row_projs: torch.Tensor, *,
                         hash_num: int) -> torch.Tensor:
    """Estimated euclidean distance ||p_q - p_r|| / sqrt(H): [H], [C, H] → [C]."""
    d = row_projs - q_proj[None, :]
    return torch.sqrt((d * d).sum(dim=1)) / float(hash_num) ** 0.5


def euclid_lsh_distances_batch(q_projs: torch.Tensor, row_projs: torch.Tensor,
                               *, hash_num: int) -> torch.Tensor:
    """[B, H], [C, H] → [B, C], expanded as ||q||² - 2q·r + ||r||²."""
    qn = (q_projs * q_projs).sum(dim=1)[:, None]
    rn = (row_projs * row_projs).sum(dim=1)[None, :]
    cross = q_projs @ row_projs.T
    return torch.sqrt(torch.clamp(qn - 2.0 * cross + rn, min=0.0)) \
        / float(hash_num) ** 0.5
