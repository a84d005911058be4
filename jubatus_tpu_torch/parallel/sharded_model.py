"""Feature-sharded linear model state over a ``ShardMesh`` (counterpart of
``jubatus_tpu/parallel/sharded_model.py``).

The linear engines' tables ([L, D] for the classifier, [D] for regression)
are split along the feature axis into S equal column blocks: block ``s``
holds columns ``[s * D/S, (s+1) * D/S)`` and lives on ``mesh.devices[s]``.
A sharded state is the engine's state NamedTuple whose feature-spanning
leaves are tuples of blocks; the (1, 1) no-confidence placeholders stay
single tensors on the first device (``state_spec`` in the JAX package).

The JAX package runs each op as one ``shard_map`` program. Here the same
body runs shard by shard from the host, and the shard axis's ``psum``
becomes ``psum`` below: each shard's partial goes to ``mesh.devices[0]``,
the partials are summed there in shard order, and the sum is copied back
to every shard device, after which each shard runs the rest of the body on
its own block. As in the JAX package, every shard sees the whole batch and
masks it to the columns it owns (``_owned``): unowned entries gather
column 0 and contribute exact zeros (scattered to their own column modulo
the block width, ``_scatter_columns_of``), so only [B, L] logits and [B]
norms cross shards. On S logical shards of one card that masked form
costs S times the gathers and scatters of a flat step.

Paths that scan examples in order (regression's train, the classifier's
sequential mode, the uniform-schema plans) do not run shard by shard.
They gather the columns the batch touches into one compact working set on
the first device (``gather_columns``), run the flat op on it with the
indices remapped, and write the touched diff columns back to their owners
(``scatter_columns``, an assignment). Because the keys are sorted and each
shard owns one contiguous column range, each shard's keys are one run of
the sorted keys, and gathering them shard by shard gives their sorted
order with no sort on the device. Regression's train is then one launch of
the scan kernel a batch, not a loop with two cross-shard sums an example.

Mix integration: ``shard_chunks`` / ``assemble_chunks`` turn blocks into
per-shard host chunks keyed by start column (``c0``, ``c<D/S>``, ...) and
back, the JAX package's wire shape, so sharded members of either package
fold chunk by chunk; ``concat_chunks`` joins them for an unsharded
receiver.

The drivers hold no layout branches of their own: ``new_state``,
``place_host``, ``classifier_train``, ``scores``, ``on_columns``,
``query_columns``, ``regression_train_batch``, ``regression_estimate``,
``shard_stats``, ``diff_leaf``, ``assemble_diff`` and ``put_diff`` also
take an unsharded state (and mesh None) and run the flat op on it.
"""

from __future__ import annotations

from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple, Union

import numpy as np
import torch

from jubatus_tpu_torch.core.sparse import to_device
from jubatus_tpu_torch.ops import classifier as cops
from jubatus_tpu_torch.ops import regression as rops
from jubatus_tpu_torch.ops.classifier import (CONFIDENCE_METHODS,
                                              ClassifierState,
                                              decide_updates)
from jubatus_tpu_torch.parallel.mesh import (ShardMesh, feature_split,
                                             local_shard_mesh)

Blocks = Tuple[torch.Tensor, ...]


def feature_shard_mesh(n_shards: int, err_cls=ValueError,
                       device="cuda") -> ShardMesh:
    """A 1-D feature-shard mesh over the first ``n_shards`` local devices
    of ``device``'s type (the CUDA cards this process sees; the CPU counts
    as one device), with the JAX package's error when there are fewer."""
    return local_shard_mesh(
        n_shards, device, err_cls,
        "feature sharding needs {n} local devices, have {have}")


def mesh_for_features(dim: int, d_per_shard: int, err_cls=ValueError,
                      device="cuda") -> Optional[ShardMesh]:
    """The ``--shard-features D_PER_SHARD`` resolver: shard count =
    dim / d_per_shard (must divide; one shard or fewer means no mesh)."""
    if d_per_shard <= 0:
        raise err_cls(f"--shard-features must be > 0, got {d_per_shard}")
    if dim % d_per_shard:
        raise err_cls(
            f"--shard-features {d_per_shard} does not divide the feature "
            f"dim {dim} (pick a power-of-two slice of 2^dim_bits)")
    n = dim // d_per_shard
    if n <= 1:
        return None
    return feature_shard_mesh(n, err_cls, device)


def driver_mesh(mesh: Optional[ShardMesh], shard_features: int, converter,
                err_cls, device) -> Tuple[Optional[ShardMesh], torch.device]:
    """A linear driver's (mesh, device): the mesh given or the one
    ``shard_features`` asks for, checked against the converter's feature
    dim (not the driver's dim_bits argument: a config-side
    "hash_max_size" overrides it). On a mesh the driver's device is the
    first shard's: batches upload there and are replicated from it, and
    the cross-shard sums land there."""
    if shard_features and mesh is None:
        mesh = mesh_for_features(converter.dim, shard_features, err_cls,
                                 device)
    if mesh is None:
        return None, device
    feature_split(mesh, converter.hasher.dim_bits, err_cls)
    return mesh, mesh.devices[0]


# ---------------------------------------------------------------------------
# layout
# ---------------------------------------------------------------------------
def is_blocks(leaf: Any) -> bool:
    """Is this state leaf a tuple of per-shard column blocks?"""
    return isinstance(leaf, tuple)


def _root(state) -> torch.device:
    """The device of an unsharded state, or of a sharded one's first
    shard (where its batches upload and its sums land)."""
    a = state[0]
    return (a[0] if is_blocks(a) else a).device


def split_columns(mesh: ShardMesh, a: torch.Tensor) -> Blocks:
    """[.., D] → S contiguous [.., D/S] blocks, block ``s`` copied onto
    ``mesh.devices[s]``."""
    n = len(mesh.devices)
    d_local = a.shape[-1] // n
    return tuple(a[..., s * d_local:(s + 1) * d_local]
                 .to(dev, copy=True).contiguous()
                 for s, dev in enumerate(mesh.devices))


def place_state(mesh: ShardMesh, state, dim: int):
    """Every leaf whose last dim is ``dim`` as blocks on the mesh's devices;
    the other leaves (the (1, 1) placeholders) on the first device."""
    def put(a):
        if is_blocks(a):
            return a
        if a.dim() >= 1 and a.shape[-1] == dim:
            return split_columns(mesh, a)
        return a.to(mesh.devices[0])

    return type(state)(*(put(a) for a in state))


def new_state(mesh: Optional[ShardMesh], init_fn: Callable, dim: int,
              device):
    """A fresh state in the driver's layout: ``init_fn(dim, device)``
    unsharded; on a mesh, ``init_fn(D/S, device)`` made on each shard's
    device and joined (leaves shaped as ``w`` span the shards, the
    placeholders stay the first shard's)."""
    if mesh is None:
        return init_fn(dim, device)
    d_local = dim // len(mesh.devices)
    shards = [init_fn(d_local, dev) for dev in mesh.devices]
    return join_shards(shards, [a.shape == shards[0][0].shape
                                for a in shards[0]])


def place_host(mesh: Optional[ShardMesh], host_state, dim: int, device):
    """A state of host numpy leaves (a loaded model) in the driver's
    layout: uploaded to ``device``, or split straight into the mesh's
    blocks."""
    # copies: the tables are updated in place, the caller's arrays not
    leaves = [torch.from_numpy(np.array(a, dtype=np.float32))
              for a in host_state]
    if mesh is None:
        return type(host_state)(*(a.to(device) for a in leaves))
    return place_state(mesh, type(host_state)(*leaves), dim)


def join_shards(shards: Sequence[Any], spans: Sequence[bool]):
    """Per-shard states (each leaf one shard's block) as one sharded
    state: leaf i becomes the tuple of the shards' leaves where
    ``spans[i]``, else the first shard's leaf."""
    first = shards[0]
    return type(first)(*(tuple(sh[i] for sh in shards) if span else first[i]
                         for i, span in enumerate(spans)))


def per_shard(state) -> List[Any]:
    """The sharded state as S states of one shard each: block ``s`` of
    every sharded leaf, the placeholders shared; an unsharded state as
    itself."""
    n = next((len(a) for a in state if is_blocks(a)), None)
    if n is None:
        return [state]
    return [type(state)(*(a[s] if is_blocks(a) else a for a in state))
            for s in range(n)]


def map_shards(fn: Callable[[Any], Any], state):
    """``fn`` applied to each shard's state, the results joined back in
    the input's layout. ``fn`` must leave a placeholder as it is."""
    if not is_blocks(state[0]):
        return fn(state)
    return join_shards([fn(st) for st in per_shard(state)],
                       [is_blocks(a) for a in state])


def host_sum(a, da) -> np.ndarray:
    """``a + da`` read back to the host; blocks are added shard by shard
    and joined on the host, so no device holds the whole table."""
    if is_blocks(a):
        return np.concatenate([(x + dx).cpu().numpy()
                               for x, dx in zip(a, da)], axis=-1)
    return (a + da).cpu().numpy()


def nbytes(state) -> int:
    """Bytes of every leaf, blocks included (JAX's ``a.nbytes`` over the
    state's global arrays)."""
    total = 0
    for a in state:
        for t in (a if is_blocks(a) else (a,)):
            total += t.numel() * t.element_size()
    return total


def shard_stats(mesh: Optional[ShardMesh], state, rows: int
                ) -> Dict[str, Any]:
    """The feature-shard layout (the ``shard.*`` gauges): shard count,
    table rows, bytes of every table and per shard. Empty unsharded."""
    if mesh is None:
        return {}
    n = len(mesh.devices)
    total = nbytes(state)
    return {"count": n, "rows": rows, "bytes_in_use": total,
            "bytes_per_shard": total // n}


# ---------------------------------------------------------------------------
# the cross-shard sum
# ---------------------------------------------------------------------------
def reduce_sum(mesh: ShardMesh, partials: Sequence[torch.Tensor]
               ) -> torch.Tensor:
    """The partials summed on ``mesh.devices[0]`` in shard order."""
    root = mesh.devices[0]
    acc = partials[0].to(root)
    for p in partials[1:]:
        acc = acc + p.to(root)
    return acc


def psum(mesh: ShardMesh, partials: Sequence[torch.Tensor]
         ) -> List[torch.Tensor]:
    """The shard axis's ``psum``: ``reduce_sum`` on the first device, the
    sum copied back to every shard device (a shared tensor where a device
    repeats)."""
    total = reduce_sum(mesh, partials)
    return [total.to(dev) for dev in mesh.devices]


def _owned(idx: torch.Tensor, val: torch.Tensor, lo: int, d_local: int):
    """Column-range partition of one CSR batch: local indices and values
    for the entries this shard owns, index 0 and value 0.0 elsewhere."""
    li_raw = idx - lo
    owned = (li_raw >= 0) & (li_raw < d_local)
    li = torch.where(owned, li_raw, 0)
    lv = torch.where(owned, val, 0.0)
    return li, lv, owned


def _scatter_columns_of(idx: torch.Tensor, d_local: int) -> torch.Tensor:
    """Where a shard's scatter puts each entry: owned entries at their
    local column, the others (which add exact zeros) at their column
    modulo the block width. The JAX body sends every unowned entry to
    column 0; on CUDA ``index_put_(accumulate=True)`` adds a run of
    duplicates serially, and (S-1)/S of B·K entries on one column cost
    seconds a step. Adding +0.0 leaves every value as it was (dw and
    dprec start at +0.0, and float addition never turns them into -0.0),
    so spreading the zeros changes no bit of the result."""
    return idx.remainder(d_local)


def _local_batch(mesh: ShardMesh, d_local: int, idx, val):
    """Each shard's (li, lv, owned) of the replicated batch."""
    out = []
    for s, dev in enumerate(mesh.devices):
        out.append(_owned(idx.to(dev), val.to(dev), s * d_local, d_local))
    return out


# ---------------------------------------------------------------------------
# classifier
# ---------------------------------------------------------------------------
def _shard_partials(w, dw, prec, dprec, li, lv, confidence: bool):
    """One shard's partial scores [B, L] and norms [B], and its gathered
    precisions [L, B, K] (confidence methods; else None)."""
    B, K = li.shape
    flat = li.reshape(-1)
    g = cops._gather_cols(w, dw, flat).view(-1, B, K)              # [L, B, K]
    s = (g * lv[None]).sum(-1).T                                   # [B, L]
    x2 = (lv * lv).sum(1)
    pg = (cops._gather_cols(prec, dprec, flat).view(-1, B, K)
          if confidence else None)
    return s, x2, pg


def _shard_confidence(pg, owned, lv, s, labels, label_mask, x2, param,
                      method: str):
    """One shard's sig_c / sig_w [B, K] and partial v [B] (the body's
    first decide picks the rival whose precision it reads)."""
    B = labels.shape[0]
    cols = torch.arange(B, device=pg.device)
    x2_vec = lv * lv
    sig_c = torch.where(owned, 1.0 / pg[labels, cols], 0.0)
    wrong0, _, _, _ = decide_updates(
        s, labels, label_mask, x2, torch.zeros_like(x2), x2_vec, param,
        method=method)
    no_rival = label_mask.sum() < 2
    sig_w = torch.where(owned,
                        torch.where(no_rival, 1.0, 1.0 / pg[wrong0, cols]),
                        0.0)
    return sig_c, sig_w, ((sig_c + sig_w) * x2_vec).sum(1)


def _shard_scatter(dw, dprec, labels, wrong, li, lv, owned, sig_c, sig_w,
                   alpha, alpha_w, dp, confidence: bool) -> None:
    """One shard's scatter-adds into its ``dw`` (and ``dprec``) block;
    ``li`` is ``_scatter_columns_of``'s index."""
    B, K = li.shape
    up_c = alpha[:, None] * sig_c * lv
    up_w = alpha_w[:, None] * sig_w * lv
    rows_c = labels[:, None].expand(B, K)
    rows_w = wrong[:, None].expand(B, K)
    dw.index_put_((rows_c, li), torch.where(owned, up_c, 0.0),
                  accumulate=True)
    dw.index_put_((rows_w, li), torch.where(owned, -up_w, 0.0),
                  accumulate=True)
    if confidence:
        dp = torch.where(owned, dp, 0.0)
        dprec.index_put_((rows_c, li), dp, accumulate=True)
        dprec.index_put_((rows_w, li),
                         torch.where((alpha_w > 0.0)[:, None], dp, 0.0),
                         accumulate=True)


def train_batch(mesh: ShardMesh, state: ClassifierState, idx: torch.Tensor,
                val: torch.Tensor, labels: torch.Tensor,
                label_mask: torch.Tensor, param, *,
                method: str) -> ClassifierState:
    """Feature-sharded vectorized microbatch update (the counterpart of
    the JAX package's shard_map'd ``train_batch``), in place on the dw /
    dprec blocks. The batch arrays are replicated to every shard device;
    the state's blocks never move. One ``psum`` of [B, L] partial scores
    and [B] norms, and for the confidence methods one of [B] v."""
    confidence = method in CONFIDENCE_METHODS
    shards = per_shard(state)
    d_local = shards[0].w.shape[1]
    devs = mesh.devices
    local = _local_batch(mesh, d_local, idx, val)
    spread = [_scatter_columns_of(idx.to(d), d_local) for d in devs]
    p0 = cops._f32(param, devs[0])
    rep = [(labels.to(d), label_mask.to(d), p0.to(d)) for d in devs]

    parts = [_shard_partials(st.w, st.dw, st.prec, st.dprec, li, lv,
                             confidence)
             for st, (li, lv, _) in zip(shards, local)]
    s_all = psum(mesh, [p[0] for p in parts])
    x2_all = psum(mesh, [p[1] for p in parts])
    if confidence:
        sigs = [_shard_confidence(pg, owned, lv, s, lab, mask, x2, p, method)
                for (_, _, pg), (_, lv, owned), s, x2, (lab, mask, p)
                in zip(parts, local, s_all, x2_all, rep)]
        v_all = psum(mesh, [sg[2] for sg in sigs])
    else:
        sigs = [(torch.where(owned, 1.0, 0.0),) * 2 for _, _, owned in local]
        v_all = [torch.zeros_like(x2) for x2 in x2_all]
    del parts
    for st, (_, lv, owned), ls, s, x2, v, sg, (lab, mask, p) in zip(
            shards, local, spread, s_all, x2_all, v_all, sigs, rep):
        wrong, alpha, alpha_w, dp = decide_updates(
            s, lab, mask, x2, v, lv * lv, p, method=method)
        _shard_scatter(st.dw, st.dprec, lab, wrong, ls, lv, owned, sg[0],
                       sg[1], alpha, alpha_w, dp, confidence)
    return state


def classifier_train(mesh: Optional[ShardMesh], state: ClassifierState,
                     idx: np.ndarray, val: np.ndarray, labels: np.ndarray,
                     label_mask: torch.Tensor, param, *, method: str,
                     mode: str) -> ClassifierState:
    """The linear classifier's train step in either layout, from host
    [B, K] idx / val and [B] label slots. "parallel" on a mesh runs shard
    by shard (``train_batch``): the batch masked to each shard's columns,
    one cross-shard sum of the logits, the blocks never move. Otherwise
    the flat op runs, on a mesh over the batch's gathered columns
    (``on_columns``)."""
    if mesh is not None and mode == "parallel":
        dev = mesh.devices[0]
        return train_batch(mesh, state, to_device(idx, dev),
                           to_device(val, dev), to_device(labels, dev),
                           label_mask, param, method=method)
    dev = _root(state)
    dval, dlab = to_device(val, dev), to_device(labels, dev)
    return on_columns(state, idx, lambda st, i: cops.train_batch(
        st, i, dval, dlab, label_mask, param, method=method, mode=mode))


def scores(mesh: Optional[ShardMesh], state: ClassifierState,
           idx: torch.Tensor, val: torch.Tensor,
           label_mask: torch.Tensor) -> torch.Tensor:
    """Batch classify in either layout. Feature-sharded, each shard scores
    its column range, the partials are summed on the first device, dead
    labels at -1e30. Returns [B, L] on ``mesh.devices[0]``."""
    if mesh is None:
        return cops.scores(state, idx, val, label_mask)
    d_local = state.w[0].shape[1]
    parts = []
    for w, dw, (li, lv, _) in zip(state.w, state.dw,
                                  _local_batch(mesh, d_local, idx, val)):
        B, K = li.shape
        g = cops._gather_cols(w, dw, li.reshape(-1)).view(-1, B, K)
        parts.append((g * lv[None]).sum(-1).T)
    s = reduce_sum(mesh, parts)
    return torch.where(label_mask.to(s.device)[None, :], s, cops._NEG)


# ---------------------------------------------------------------------------
# gathered working sets (ordered scans and the uniform-schema plans)
# ---------------------------------------------------------------------------
class ColumnPlan:
    """Where the sorted keys ``uniq`` live: shard ``s`` owns the run
    ``uniq[cuts[s]:cuts[s+1]]`` (one ``np.searchsorted``), as local column
    indices on its own device."""

    def __init__(self, blocks: Blocks, uniq: np.ndarray) -> None:
        d_local = blocks[0].shape[-1]
        uniq = np.asarray(uniq, dtype=np.int64)
        self.size = len(uniq)
        self.cuts = np.searchsorted(uniq, np.arange(len(blocks) + 1)
                                    * d_local)
        self.keys = [to_device(uniq[self.cuts[s]:self.cuts[s + 1]]
                               - s * d_local, b.device)
                     for s, b in enumerate(blocks)]


def _plan(blocks: Blocks, uniq) -> ColumnPlan:
    return uniq if isinstance(uniq, ColumnPlan) else ColumnPlan(blocks, uniq)


def gather_columns(blocks: Blocks, uniq) -> torch.Tensor:
    """The blocks' columns at the sorted global keys ``uniq`` (an array or
    a ``ColumnPlan``), in that order, as one [.., U] tensor on the first
    block's device."""
    plan = _plan(blocks, uniq)
    root = blocks[0].device
    parts = [b.index_select(-1, k).to(root)
             for b, k in zip(blocks, plan.keys) if k.numel()]
    if not parts:
        return blocks[0].new_zeros(blocks[0].shape[:-1] + (0,))
    return torch.cat(parts, dim=-1)


def scatter_columns(blocks: Blocks, uniq, cols: torch.Tensor) -> None:
    """Write ``cols`` [.., U] back to the blocks at the sorted global keys
    ``uniq`` (an assignment: each key's column of ``cols`` replaces the
    owner's)."""
    plan = _plan(blocks, uniq)
    for s, (b, k) in enumerate(zip(blocks, plan.keys)):
        if k.numel():
            b.index_copy_(b.dim() - 1, k,
                          cols[..., plan.cuts[s]:plan.cuts[s + 1]]
                          .to(b.device))


def working_set(state, uniq):
    """The sharded state's columns at ``uniq`` as a flat state on the
    first device (placeholders as they are), and the plan that wrote it
    (hand it to ``write_back``)."""
    blocks = next(a for a in state if is_blocks(a))
    plan = _plan(blocks, uniq)
    work = type(state)(*(gather_columns(a, plan) if is_blocks(a) else a
                         for a in state))
    return work, plan


def write_back(state, plan: ColumnPlan, work,
               fields: Sequence[str] = ("dw", "dprec")) -> None:
    """The working set's ``fields`` (the local diffs; those the state
    has) written back to the sharded state's blocks."""
    for name in fields:
        a = getattr(state, name, None)
        if is_blocks(a):
            scatter_columns(a, plan, getattr(work, name))


def compact_indices(idx: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
    """(uniq, inv): the sorted distinct keys of ``idx`` and ``idx``
    remapped to positions in them, int32 of ``idx``'s shape."""
    uniq, inv = np.unique(np.asarray(idx), return_inverse=True)
    return uniq, inv.reshape(np.shape(idx)).astype(np.int32)


def on_columns(state, idx: np.ndarray, fn: Callable):
    """``state = fn(state, idx on the device)`` in either layout, in
    place. On a sharded state ``fn`` runs on the working set of ``idx``'s
    distinct keys with ``idx`` remapped into it (distinct keys stay
    distinct, so a uniform-schema plan keeps its no-duplicate promise),
    and the diffs are written back."""
    root = _root(state)
    if not is_blocks(state[0]):
        return fn(state, to_device(idx, root))
    uniq, inv = compact_indices(idx)
    work, plan = working_set(state, uniq)
    write_back(state, plan, fn(work, to_device(inv, root)))
    return state


def query_columns(state, idx: np.ndarray):
    """(state, idx on the device) for a query that reads ``w + dw`` at
    ``idx``: on a sharded state, the gathered w / dw columns of its
    distinct keys (the other leaves None) and ``idx`` remapped."""
    root = _root(state)
    if not is_blocks(state[0]):
        return state, to_device(idx, root)
    uniq, inv = compact_indices(idx)
    plan = ColumnPlan(state.w, uniq)
    work = type(state)(*(gather_columns(a, plan) if name in ("w", "dw")
                         else None
                         for name, a in zip(state._fields, state)))
    return work, to_device(inv, root)


# ---------------------------------------------------------------------------
# regression (one weight row)
# ---------------------------------------------------------------------------
def regression_train_batch(mesh: Optional[ShardMesh],
                           state: rops.RegressionState,
                           idx: np.ndarray, val: np.ndarray,
                           targets: np.ndarray, sensitivity: float, c: float,
                           *, method: str) -> rops.RegressionState:
    """Feature-sharded PA regression train, in place on the dw blocks.
    ``idx`` / ``val`` [B, K] and ``targets`` [B] are host arrays of the
    rows to scan (no padding rows). The batch's distinct keys are gathered
    from their owners (w and dw) into one working set on the first
    device, the per-example scan (on the card one launch of the scan
    kernel) runs over it in example order, and the touched dw columns are
    written back: the flat scan's arithmetic on the same values. Without
    a mesh, the flat scan."""
    if len(targets) == 0:
        return state
    if mesh is None:
        dev = _root(state)
        return rops.train_batch(
            state, to_device(idx, dev),
            to_device(np.asarray(val, dtype=np.float32), dev),
            to_device(np.asarray(targets, dtype=np.float32), dev),
            sensitivity, c, method=method)
    uniq, inv = compact_indices(idx)
    work, plan = working_set(state, uniq)
    root = mesh.devices[0]
    rops.train_batch(work, to_device(inv, root),
                     to_device(np.asarray(val, dtype=np.float32), root),
                     to_device(np.asarray(targets, dtype=np.float32), root),
                     sensitivity, c, method=method)
    write_back(state, plan, work)
    return state


def regression_estimate(mesh: Optional[ShardMesh],
                        state: rops.RegressionState, idx: torch.Tensor,
                        val: torch.Tensor) -> torch.Tensor:
    """Batch estimates [B] in either layout; feature-sharded, on the first
    device, one sum of the per-shard partial dot products."""
    if mesh is None:
        return rops.estimate(state, idx, val)
    d_local = state.w[0].shape[0]
    parts = [((w[li] + dw[li]) * lv).sum(-1)
             for w, dw, (li, lv, _) in zip(
                 state.w, state.dw, _local_batch(mesh, d_local, idx, val))]
    return reduce_sum(mesh, parts)


# ---------------------------------------------------------------------------
# the mix: per-shard diff chunks and the sharded apply
# ---------------------------------------------------------------------------
def _key(k: Union[str, bytes]) -> str:
    return k.decode() if isinstance(k, bytes) else k


def shard_chunks(blocks: Blocks, rows: Optional[int] = None
                 ) -> Dict[str, np.ndarray]:
    """Blocks as per-shard host chunks keyed by start column (``c0``,
    ``c<D/S>``, ...); each block is read back on its own, so no buffer
    holds the whole table. ``rows`` trims [L, D/S] blocks to the active
    label rows."""
    out: Dict[str, np.ndarray] = {}
    start = 0
    for b in blocks:
        if rows is not None and b.dim() == 2 and rows < b.shape[0]:
            b = b[:rows]
        out[f"c{start}"] = b.to("cpu", copy=True).numpy()
        start += b.shape[-1]
    return out


def diff_leaf(a, rows: Optional[int] = None):
    """A local diff leaf on the wire: host numpy (trimmed to ``rows``
    label rows), a sharded one as per-shard chunks. A copy: on the CPU
    ``.cpu()`` would alias the diff, which ``put_diff`` zeroes while the
    diff may still be read."""
    if is_blocks(a):
        return shard_chunks(a, rows)
    return a[:rows].to("cpu", copy=True).numpy()


def is_chunked(leaf: Any) -> bool:
    """Does this diff leaf carry the per-shard chunk wire shape?"""
    return isinstance(leaf, dict) and bool(leaf) and \
        all(isinstance(k, (str, bytes)) and _key(k).startswith("c")
            for k in leaf)


def _sorted_chunks(chunks: Dict[Any, Any]) -> List[Tuple[int, np.ndarray]]:
    return sorted(((int(_key(k)[1:]), np.asarray(v))
                   for k, v in chunks.items()), key=lambda kv: kv[0])


def concat_chunks(chunks: Dict[Any, Any]) -> np.ndarray:
    """Per-shard chunks joined into one host array, for a receiver that
    is not sharded."""
    return np.concatenate([v for _, v in _sorted_chunks(chunks)], axis=-1)


def assemble_chunks(chunks: Dict[Any, Any], mesh: ShardMesh) -> Blocks:
    """Per-shard wire chunks back to blocks, each chunk uploaded straight
    to its owning shard's device (no host concatenation). Raises
    ValueError on a layout mismatch: a peer sharded differently must not
    fold misaligned columns."""
    items = _sorted_chunks(chunks)
    devices = mesh.devices
    if len(items) != len(devices):
        raise ValueError(
            f"shard layout mismatch: {len(items)} wire chunks for a "
            f"{len(devices)}-shard mesh (peers must share one "
            "--shard-devices/--shard-features layout)")
    expect = 0
    for start, v in items:
        if start != expect:
            raise ValueError(
                f"shard layout mismatch: chunk starts at column {start}, "
                f"expected {expect}")
        expect += v.shape[-1]
    return tuple(to_device(np.asarray(v, dtype=np.float32), dev)
                 for (_, v), dev in zip(items, devices))


def assemble_diff(mesh: Optional[ShardMesh], diff: Dict[str, Any],
                  dim: int) -> Dict[str, Any]:
    """A received diff made ready for the receiver's layout: per-shard
    chunks uploaded to their shards (``assemble_chunks``) or, unsharded,
    joined on the host; a peer's unsharded [.., D] array split into the
    mesh's blocks."""
    out = dict(diff)
    for key, v in diff.items():
        if key == "count":
            continue
        if is_chunked(v):
            out[key] = (assemble_chunks(v, mesh) if mesh is not None
                        else concat_chunks(v))
        elif mesh is not None and np.shape(v)[-1:] == (dim,):
            out[key] = split_columns(
                mesh, torch.from_numpy(np.array(v, dtype=np.float32)))
    return out


def _absorb(master: torch.Tensor, x: Any, count) -> None:
    """master[:rows] += x (/ count when given), x host numpy or a tensor."""
    t = cops._on(x, master)
    if count is not None:
        t = t / torch.clamp_min(cops._f32(count, master.device), 1.0)
    if master.dim() == 2:
        master[:t.shape[0]] += t
    else:
        master += t


def put_diff(state, diff: Dict[str, Any]):
    """Absorb the summed diff into the state, in place: the masters
    ``w`` += dw / max(count, 1) and (classifier) ``prec`` += dprec, the
    flat ``put_diff``'s float32 arithmetic element for element; then the
    local diffs are zeroed. Sharded diff leaves are per-shard blocks
    (``assemble_diff``); the placeholders' are single arrays. An
    unsharded state takes its engine's flat ``put_diff``."""
    if not is_blocks(state.w):
        flat = cops.put_diff if "prec" in state._fields else rops.put_diff
        return flat(state, diff)
    count = np.float32(diff["count"])
    pairs = [("w", "dw", count)]
    if "prec" in state._fields:
        pairs.append(("prec", "dprec", None))
    for master_name, diff_name, scale in pairs:
        master = getattr(state, master_name)
        local = getattr(state, diff_name)
        d = diff[diff_name]
        if is_blocks(master):
            for m, x in zip(master, d):
                _absorb(m, x, scale)
            for lo in local:
                lo.zero_()
        else:
            _absorb(master, d, scale)
            local.zero_()
    return state
