"""Row-sharded similarity scans over a ``ShardMesh`` (counterpart of
``jubatus_tpu/parallel/sharded_knn.py``).

The signature table is split into S contiguous row blocks, block ``s`` a
tensor of its own on ``mesh.devices[s]`` (``shard_table``). A query batch
goes to every shard; each shard scans its block with the single-device
scan (``ops/sig_scan.py``, so on the card one K1 launch a shard; euclid_lsh
the ``ops/knn.py`` torch code), takes a local top-k, and the [S, B, kk]
partials are gathered onto ``devices[0]`` and merged there by
``merge_topk``'s pairwise tree: log2(S) selections over O(k)-sized sets.

Global ids are ``shard * c_local + local_slot``. Shards run one after
another on the host; on a mesh of several cards their kernels overlap
only as far as the launches do.
"""

from __future__ import annotations

from typing import Callable, List, Optional, Sequence, Tuple, Union

import torch

from jubatus_tpu_torch.ops import knn
from jubatus_tpu_torch.ops.ivf import tie_ordered, top_sorted
from jubatus_tpu_torch.parallel.mesh import ShardMesh

Blocks = Union[torch.Tensor, Sequence[torch.Tensor]]


def shard_table(mesh: ShardMesh, table: torch.Tensor,
                axis: str = "shard") -> List[torch.Tensor]:
    """Split [S*c, ...] rows into S blocks, block ``s`` on
    ``mesh.devices[s]`` (a view where it already lies there)."""
    n = mesh.shape[axis]
    if table.shape[0] % n:
        raise ValueError(f"{table.shape[0]} rows do not split over {n} shards")
    c = table.shape[0] // n
    return [table[s * c:(s + 1) * c].to(mesh.devices[s]) for s in range(n)]


def replicate(mesh: ShardMesh, x: torch.Tensor) -> List[torch.Tensor]:
    """``x`` on every device of the mesh, one tensor per shard."""
    return [x.to(dev) for dev in mesh.devices]


def _blocks(mesh: ShardMesh, table: Blocks, axis: str) -> List[torch.Tensor]:
    if isinstance(table, torch.Tensor):
        return shard_table(mesh, table, axis)
    return list(table)


def merge_topk(scores: torch.Tensor, ids: torch.Tensor, k: int):
    """Log-depth merge of per-shard top-k candidate sets.

    ``scores`` / ``ids``: [S, B, kk] partials (HIGHER score = better). Each
    level merges shard pairs with one selection over the concatenated 2·kk
    candidates, halving S (an odd last shard is carried); selection is
    associative, so the result is the flat merge's. The final order is
    score descending, id ascending (−inf sentinels last). Returns
    ([B, k'], [B, k']) with k' = min(k, S·kk)."""
    s = scores.shape[0]
    k = min(k, s * scores.shape[2])
    while s > 1:
        half = s // 2
        cat_s = torch.cat([scores[:half], scores[half:2 * half]], dim=-1)
        cat_i = torch.cat([ids[:half], ids[half:2 * half]], dim=-1)
        kk = min(k, cat_s.shape[-1])
        merged_s, pos = top_sorted(cat_s, kk)
        merged_i = cat_i.gather(-1, pos)
        if s % 2:                                   # odd: carry the last
            carry_s, carry_i = scores[-1:], ids[-1:]
            if carry_s.shape[-1] > kk:              # its own top-kk
                carry_s, pos = top_sorted(carry_s, kk)
                carry_i = carry_i.gather(-1, pos)
            pad = kk - carry_s.shape[-1]
            if pad > 0:        # widen with -inf sentinels (never selected)
                carry_s = torch.nn.functional.pad(carry_s, (0, pad),
                                                  value=-float("inf"))
                carry_i = torch.nn.functional.pad(carry_i, (0, pad))
            merged_s = torch.cat([merged_s, carry_s], dim=0)
            merged_i = torch.cat([merged_i, carry_i], dim=0)
        scores, ids = merged_s, merged_i
        s = scores.shape[0]
    out_s, out_i = scores[0], ids[0]
    if out_s.shape[-1] > k:
        out_s, pos = top_sorted(out_s, k)
        out_i = out_i.gather(-1, pos)
    return tie_ordered(out_s, out_i)


def _sharded_topk(mesh: ShardMesh, q: torch.Tensor, table: Blocks,
                  local_scores: Callable, k: int, axis: str = "shard",
                  valid: Optional[Blocks] = None):
    """Per-shard scan, local top-k and the tree merge. ``local_scores(q,
    rows) -> [B, c]`` (HIGHER = better). Returns (scores [B, k'], global
    ids [B, k']) on ``devices[0]``, k' = min(k, C)."""
    blocks = _blocks(mesh, table, axis)
    vblocks = _blocks(mesh, valid, axis) if valid is not None else None
    n_shards = len(blocks)
    c_local = blocks[0].shape[0]
    k = min(k, c_local * n_shards)
    kk = min(k, c_local)
    home = mesh.devices[0]
    negs, gidxs = [], []
    for s, rows in enumerate(blocks):
        sc = local_scores(q.to(rows.device), rows).to(torch.float32)
        if vblocks is not None:
            sc = torch.where(vblocks[s][None, :], sc,
                             torch.full_like(sc, -float("inf")))
        neg, idx = torch.topk(sc, kk, dim=-1)                # [B, kk]
        negs.append(neg.to(home))
        gidxs.append((idx + s * c_local).to(home))
    return merge_topk(torch.stack(negs), torch.stack(gidxs), k)


_SCAN = {
    "lsh": lambda q, r, h: knn.hamming_distances_batch(q, r, hash_num=h),
    "minhash": lambda q, r, h: knn.minhash_distances_batch(q, r),
    "euclid_lsh": lambda q, r, h: knn.euclid_lsh_distances_batch(
        q, r, hash_num=h),
}


def sharded_distances(mesh: ShardMesh, q_sigs: torch.Tensor, row_sigs: Blocks,
                      *, method: str, hash_num: int,
                      axis: str = "shard") -> torch.Tensor:
    """The full [B, C] distance matrix from a sharded table (for LOF's
    support, which needs every distance): each shard scans its block and
    the blocks' columns are gathered onto ``devices[0]``."""
    scan = _SCAN[method]
    home = mesh.devices[0]
    parts = [scan(q_sigs.to(rows.device), rows, hash_num)
             .to(torch.float32).to(home)
             for rows in _blocks(mesh, row_sigs, axis)]
    return torch.cat(parts, dim=1)


def sharded_hamming_topk(mesh: ShardMesh, q_sigs: torch.Tensor,
                         row_sigs: Blocks, *, hash_num: int, k: int,
                         axis: str = "shard",
                         valid: Optional[Blocks] = None) -> Tuple[torch.Tensor,
                                                                  torch.Tensor]:
    """Global top-k smallest normalised Hamming distances. Returns
    (distances [B, k], global row ids [B, k])."""
    neg, gidx = _sharded_topk(
        mesh, q_sigs, row_sigs,
        lambda q, r: -knn.hamming_distances_batch(q, r, hash_num=hash_num),
        k, axis, valid)
    return -neg, gidx


def sharded_minhash_topk(mesh: ShardMesh, q_sigs: torch.Tensor,
                         row_sigs: Blocks, *, k: int, axis: str = "shard",
                         valid: Optional[Blocks] = None):
    """Top-k smallest (1 − match fraction) distances."""
    neg, gidx = _sharded_topk(
        mesh, q_sigs, row_sigs,
        lambda q, r: -knn.minhash_distances_batch(q, r), k, axis, valid)
    return -neg, gidx


def sharded_euclid_lsh_topk(mesh: ShardMesh, q_projs: torch.Tensor,
                            row_projs: Blocks, *, hash_num: int, k: int,
                            axis: str = "shard",
                            valid: Optional[Blocks] = None):
    """Top-k smallest JL-estimated euclidean distances."""
    neg, gidx = _sharded_topk(
        mesh, q_projs, row_projs,
        lambda q, r: -knn.euclid_lsh_distances_batch(q, r, hash_num=hash_num),
        k, axis, valid)
    return -neg, gidx
