"""Ring all-to-all scans over a ``ShardMesh`` (counterpart of
``jubatus_tpu/parallel/ring.py``).

``sharded_knn`` keeps the queries replicated and merges tiny per-shard
top-k candidates on ``devices[0]``; that is the right shape when the query
batch is small. When both the query batch and the row table are too large
to replicate, the ring keeps both sharded:

- queries stay put, B/S to a shard (``queries`` split as the table is);
- table blocks rotate around the ring: at each of the S steps every shard
  scores the block it holds, then hands it to its neighbour (``s → s+1``)
  with one tensor copy between the mesh's devices — the JAX ring's
  ``ppermute`` hop, here within one process, as ``sharded_knn`` holds its
  blocks;
- each shard keeps a running top-k, merged as ``lax.top_k`` merges: the
  running candidates first, then the new block's, the lower position
  first among equal scores. So ties resolve by visit step, then slot,
  exactly as in the JAX ring.

The global id of a slot is ``origin · c_local + slot``, ``origin`` the
shard the block started on. ``ring_hamming_topk`` scores each block with
the single-device scan (``ops/sig_scan.py``: on the card one K1 hamming
launch a shard a step, S² a call); ``ring_euclid_topk`` with the exact
euclid code of ``ops/knn.py``. A ``valid`` mask rotates with its block.
"""

from __future__ import annotations

from typing import Callable, List, Optional, Sequence, Tuple, Union

import torch

from jubatus_tpu_torch.ops import knn
from jubatus_tpu_torch.ops.ivf import top_sorted
from jubatus_tpu_torch.parallel.mesh import ShardMesh
from jubatus_tpu_torch.parallel.sharded_knn import (  # noqa: F401
    shard_table as shard_rows,
)

Tensors = Union[torch.Tensor, Sequence[torch.Tensor]]


def _split(mesh: ShardMesh, x: Tensors, axis: str) -> List[torch.Tensor]:
    """``x`` as S row blocks on the mesh's devices; a list passes as is.
    An indivisible row count raises ``ValueError`` ("not divisible")."""
    if not isinstance(x, torch.Tensor):
        return list(x)
    n = mesh.shape[axis]
    if x.shape[0] % n:
        raise ValueError(
            f"row count {x.shape[0]} not divisible by {n} ring shards "
            "(pad the table to a multiple and mask the padding rows)")
    c = x.shape[0] // n
    return [x[s * c:(s + 1) * c].to(mesh.devices[s]) for s in range(n)]


def ring_scan(mesh: ShardMesh, step_fn: Callable, carries: List,
              blocks: List, axis: str = "shard") -> List:
    """Rotate the per-shard ``blocks`` (any tuple of tensors each) once
    around the ring. ``step_fn(shard, carry, block, origin) -> carry`` is
    applied S times per shard; ``origin`` is the shard the block started
    on. Returns the final carries, one a shard."""
    n = mesh.shape[axis]
    held = list(blocks)
    carries = list(carries)
    for t in range(n):
        for s in range(n):
            carries[s] = step_fn(s, carries[s], held[s], (s - t) % n)
        if t + 1 < n:                       # the hop: s's block goes to s+1
            held = [tuple(x.to(mesh.devices[s]) for x in held[(s - 1) % n])
                    for s in range(n)]
    return carries


def _topk_merge(best_neg, best_idx, neg, idx, k: int):
    """Merge running [b, k] candidates with new [b, kk] ones (the running
    ones first among equal scores)."""
    top, pos = top_sorted(torch.cat([best_neg, neg], dim=1), k)
    return top, torch.cat([best_idx, idx], dim=1).gather(1, pos)


def _ring_topk(mesh: ShardMesh, queries: Tensors, blocks: Sequence[Tensors],
               local_scores: Callable, k: int, axis: str):
    """``local_scores(q_block, *row_block) -> [b, c]`` (HIGHER = better).
    ``blocks`` is a tuple of [C, ...] tables rotated together. Returns
    (scores [B, k], global row ids [B, k]) on ``devices[0]``, the shards'
    query rows in order."""
    n = mesh.shape[axis]
    tables = [_split(mesh, b, axis) for b in blocks]
    qs = _split(mesh, queries, axis)
    c_local = tables[0][0].shape[0]
    # never return more candidates than the table holds: padding slots
    # would carry +inf distance but a fabricated row id 0
    k = min(k, c_local * n)
    kk = min(k, c_local)

    def step(s, carry, block, origin):
        q = qs[s]
        sc = local_scores(q, *block).to(torch.float32)        # [b, c_local]
        neg, idx = top_sorted(sc, kk)
        return _topk_merge(carry[0], carry[1], neg, idx + origin * c_local, k)

    init = [(torch.full((q.shape[0], k), -float("inf"), dtype=torch.float32,
                        device=q.device),
             torch.zeros((q.shape[0], k), dtype=torch.int64, device=q.device))
            for q in qs]
    out = ring_scan(mesh, step, init,
                    [tuple(t[s] for t in tables) for s in range(n)], axis)
    home = mesh.devices[0]
    return (torch.cat([o[0].to(home) for o in out]),
            torch.cat([o[1].to(home) for o in out]))


def ring_hamming_topk(mesh: ShardMesh, q_sigs: Tensors, row_sigs: Tensors, *,
                      hash_num: int, k: int, axis: str = "shard",
                      valid: Optional[Tensors] = None
                      ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Global top-k smallest normalised Hamming distances, queries and
    table both sharded ([B, W] and [C, W] int32 words). Returns
    (distances [B, k], global row ids [B, k]). ``valid`` ([C] bool) masks
    dead or padding rows out; it rotates with the table blocks."""
    if valid is None:
        def scores(q, sigs):
            return -knn.hamming_distances_batch(q, sigs, hash_num=hash_num)

        blocks = (row_sigs,)
    else:
        def scores(q, sigs, v):
            d = knn.hamming_distances_batch(q, sigs, hash_num=hash_num)
            return torch.where(v[None, :], -d, -float("inf"))

        blocks = (row_sigs, valid)
    neg, gidx = _ring_topk(mesh, q_sigs, blocks, scores, k, axis)
    return -neg, gidx


def batch_euclid_distances(q_dense: torch.Tensor, row_idx: torch.Tensor,
                           row_val: torch.Tensor) -> torch.Tensor:
    """``knn.euclid_distances`` for a batch of dense queries: [B, C]."""
    gathered = q_dense[:, row_idx.reshape(-1)].view(
        q_dense.shape[0], *row_idx.shape)                   # [B, C, nnz]
    dots = (row_val[None] * gathered).sum(dim=2)
    rn2 = (row_val * row_val).sum(dim=1)
    qn2 = (q_dense * q_dense).sum(dim=1, keepdim=True)
    return torch.sqrt(torch.clamp(rn2[None, :] - 2.0 * dots + qn2, min=0.0))


def ring_euclid_topk(mesh: ShardMesh, q_dense: Tensors, row_idx: Tensors,
                     row_val: Tensors, *, k: int, axis: str = "shard",
                     valid: Optional[Tensors] = None
                     ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Global top-k smallest euclidean distances over a sparse row table
    ([C, nnz] indices and values), queries ([B, D] float32) and table both
    sharded. Returns (distances [B, k], ids [B, k]); rows that ``valid``
    masks out surface as +inf."""
    if valid is None:
        def scores(q, idx, val):
            return -batch_euclid_distances(q, idx, val)

        blocks = (row_idx, row_val)
    else:
        def scores(q, idx, val, v):
            d = batch_euclid_distances(q, idx, val)
            return torch.where(v[None, :], -d, -float("inf"))

        blocks = (row_idx, row_val, valid)
    neg, gidx = _ring_topk(mesh, q_dense, blocks, scores, k, axis)
    return -neg, gidx
