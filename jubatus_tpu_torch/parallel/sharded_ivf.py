"""Row-sharded two-phase IVF queries (counterpart of
``jubatus_tpu/parallel/sharded_ivf.py``).

The placement of the exact sharded scan (parallel/sharded_knn.py): the
signature table and the cell table ([S*n_cells, cap], ``CellArenas``) are
split into per-shard blocks, the query and the centroids go to every
shard, and the candidates merge through the same ``merge_topk`` tree.
What each shard scans changes:

  exact   every row of its block                O(C/S) a query
  ivf     the probed cells' members only        O(K + P·cap)

Each shard gathers its own [n_cells, cap] block's rows of the probed cells
(local slots, −1-padded) and rescores them with the method's exact
distance: K1's gathered variant for lsh and minhash, one launch a shard.
The centroids are the same on every shard, so the probe is computed once
on ``devices[0]`` and its cells sent to each shard. Global ids are
``shard * c_local + local_slot``, as on the exact path.
"""

from __future__ import annotations

import torch

from jubatus_tpu_torch.ops.ivf import (candidate_sig_distances, probe_cells,
                                       top_sorted)
from jubatus_tpu_torch.parallel.mesh import ShardMesh
from jubatus_tpu_torch.parallel.sharded_knn import (Blocks, _blocks,
                                                    merge_topk)


def sharded_ivf_topk(mesh: ShardMesh, q_sigs: torch.Tensor,
                     q_emb: torch.Tensor, row_sigs: Blocks,
                     centroids: torch.Tensor, cell_slots: Blocks, *,
                     method: str, hash_num: int, k: int, nprobe: int,
                     axis: str = "shard"):
    """Global approximate top-k over the sharded table: the cell probe,
    each shard's gathered exact rescore and local top-k, the tree merge.

    Returns (distances [B, k'], global row ids [B, k']) on ``devices[0]``,
    k' = min(k, S·min(k, nprobe·cap)); a non-finite distance marks no
    candidate (its id means nothing)."""
    rows = _blocks(mesh, row_sigs, axis)
    cells = _blocks(mesh, cell_slots, axis)
    c_local = rows[0].shape[0]
    n_cells = cells[0].shape[0]
    home = mesh.devices[0]
    sel = probe_cells(q_emb.to(home), centroids.to(home),
                      nprobe=min(nprobe, n_cells))              # [B, P]
    negs, gidxs = [], []
    for s, (block, tab) in enumerate(zip(rows, cells)):
        dev = block.device
        cand = tab[sel.to(dev)].reshape(q_sigs.shape[0], -1)    # [B, P·cap]
        d = candidate_sig_distances(q_sigs.to(dev), block, cand,
                                    method=method, hash_num=hash_num)
        sc = torch.where(cand >= 0, -d.to(torch.float32),
                         torch.full_like(d, -float("inf")))
        neg, pos = top_sorted(sc, min(k, sc.shape[-1]))
        lslot = torch.clamp(cand, min=0).gather(-1, pos)
        negs.append(neg.to(home))
        gidxs.append((lslot.to(torch.int64) + s * c_local).to(home))
    neg, gidx = merge_topk(torch.stack(negs), torch.stack(gidxs), k)
    return -neg, gidx
