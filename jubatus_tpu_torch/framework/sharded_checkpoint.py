"""Sharded checkpoint/resume on ``torch.distributed.checkpoint``
(counterpart of ``jubatus_tpu/framework/sharded_checkpoint.py``).

The envelope path (framework/save_load.py) serializes through a host
gather and msgpack: right for byte-format parity with the JAX package,
costly for a sharded table of gigabytes. Here every block of a sharded
state is written as a raw tensor through ``dcp.save``, and a restore
places blocks by the template's layout.

The states covered: the classifier's ``ClassifierState``, flat or as
column blocks on a ``ShardMesh`` (parallel/sharded_model.py), and the
``SpmdClassifierState`` of a (replica, shard) ``DeviceGrid``
(parallel/spmd.py); any NamedTuple or mapping of tensors (or of tuples of
column blocks) saves the same way.

Layout:

    <dir>/system.jubatus   envelope header + system container, 0 user bytes
    <dir>/state/           dcp checkpoint: one entry a block

The sidecar is the JAX package's, with the same keys (``version``,
``timestamp``, ``type``, ``id``, ``config``, ``user_data_version``,
``sharded``, ``shard_layout``, ``pairing_token``), so ``jubadump`` and
the semantic-config check work on checkpoint directories of either
package. A block's entry is keyed by field, replica and its global column
range (``w/0:1024``, ``w/r1/0:1024``), so a restore finds the saved
blocks that overlap each block it has to fill.

Why not DTensor: dcp's own resharding needs DTensor, and a DTensor mesh
must match the process group; four logical shards of one card in one
process do not fit that. The blocks are keyed by column range here
instead, and ``load_sharded`` reshards by reading, one saved entry at a
time (host memory stays one block), only the entries that overlap the
target's blocks.

Pairing: dcp's ``Metadata`` carries no user field in the torch releases
this port runs on, so the pairing token is one more entry of the dcp
checkpoint (``pairing_token``, its hex bytes as uint8). It commits with
the state: dcp writes the checkpoint's ``.metadata`` last, so a reader
sees the new blocks and the new token together or neither. The sidecar
is written after. A torn overwrite (new state, stale sidecar) fails at
load with "pairing mismatch".

In a ``torch.distributed`` world (parallel/multihost.py) the save is
collective: rank 0's token reaches every rank (``broadcast_object_list``),
``dcp.save`` writes each rank's blocks (an entry several ranks hold is
written once), rank 0 writes the sidecar, and a barrier runs before any
rank returns. Restores read independently on every rank.

Checkpoints do not cross packages: the JAX package's ``state/`` is an
orbax checkpoint, this one a dcp checkpoint (model files do cross).
"""

from __future__ import annotations

import binascii
import os
import re
import shutil
import time
from collections.abc import Mapping
from typing import Any, Dict, List, NamedTuple, Optional, Tuple

import torch

from jubatus_tpu_torch.framework.save_load import (FORMAT_VERSION,
                                                   SaveLoadError,
                                                   _semantic_config_equal,
                                                   read_envelope,
                                                   write_envelope)
from jubatus_tpu_torch.utils.disk import tree_bytes
from jubatus_tpu_torch.utils.serialization import pack_obj, unpack_obj

SYSTEM_FILE = "system.jubatus"
STATE_DIR = "state"
#: the dcp entry that carries the pairing token
TOKEN_KEY = "pairing_token"

_KEY = re.compile(r"^(?P<field>[^/]+)(?:/r(?P<r>\d+))?/(?P<lo>\d+):(?P<hi>\d+)$")


class _Leaf(NamedTuple):
    """One field of one replica (``replica`` None in a state without a
    replica axis) as its column blocks, in column order."""

    field: str
    replica: Optional[int]
    blocks: Tuple[Any, ...]


def _fields(state) -> List[Tuple[str, Any]]:
    if isinstance(state, Mapping):
        return [(str(k), v) for k, v in state.items()]
    return list(zip(state._fields, state))


def _replicated(state) -> bool:
    from jubatus_tpu_torch.parallel.spmd import SpmdClassifierState

    return isinstance(state, SpmdClassifierState)


def _blocks(v: Any) -> Tuple[Any, ...]:
    return v if isinstance(v, tuple) else (v,)


def _leaves(state) -> List[_Leaf]:
    rep = _replicated(state)
    out = []
    for name, v in _fields(state):
        if rep:
            out.extend(_Leaf(name, r, _blocks(rv)) for r, rv in enumerate(v))
        else:
            out.append(_Leaf(name, None, _blocks(v)))
    return out


def _key(field: str, replica: Optional[int], lo: int, hi: int) -> str:
    rep = "" if replica is None else f"/r{replica}"
    return f"{field}{rep}/{lo}:{hi}"


def _ranges(blocks) -> List[Tuple[int, int]]:
    out, lo = [], 0
    for b in blocks:
        out.append((lo, lo + int(b.shape[-1])))
        lo += int(b.shape[-1])
    return out


def _entries(state) -> Dict[str, torch.Tensor]:
    out = {}
    for leaf in _leaves(state):
        for b, (lo, hi) in zip(leaf.blocks, _ranges(leaf.blocks)):
            out[_key(leaf.field, leaf.replica, lo, hi)] = b
    return out


def _map_tensors(x: Any, fn) -> Any:
    if isinstance(x, torch.Tensor):
        return fn(x)
    if isinstance(x, tuple) and hasattr(x, "_fields"):
        return type(x)(*(_map_tensors(v, fn) for v in x))
    if isinstance(x, tuple):
        return tuple(_map_tensors(v, fn) for v in x)
    if isinstance(x, Mapping):
        return {k: _map_tensors(v, fn) for k, v in x.items()}
    raise TypeError(f"not a state leaf: {type(x).__name__}")


def abstract_like(state: Any):
    """The state's structure with every tensor replaced by a ``device=
    "meta"`` tensor of its shape and dtype (it allocates nothing) that
    carries the block's device as ``target_device``: what a restore needs
    to place blocks (``jax.ShapeDtypeStruct`` with its sharding, in the
    JAX package)."""
    def meta(t):
        m = torch.empty(t.shape, dtype=t.dtype, device="meta")
        m.target_device = getattr(t, "target_device", t.device)
        return m

    return _map_tensors(state, meta)


def shard_layout(state: Any) -> dict:
    """{axis: size} of the state's layout, recorded in the sidecar so
    operators read what wrote a checkpoint without opening it: ``{"shard":
    N}`` for column blocks, ``{"replica": R, "shard": S}`` for a grid
    state, {} for a flat one. Informational: a restore places blocks by
    the template's layout."""
    leaves = _leaves(state)
    shards = max((len(leaf.blocks) for leaf in leaves), default=1)
    if _replicated(state):
        return {"replica": 1 + max(leaf.replica for leaf in leaves),
                "shard": shards}
    return {"shard": shards} if shards > 1 else {}


def _write_system(path: str, system: dict) -> None:
    write_envelope(path, pack_obj(system))


def _read_system(path: str) -> dict:
    with open(path, "rb") as f:
        raw = f.read()
    system_bytes, _ = read_envelope(raw, path)
    return unpack_obj(system_bytes)


def _world() -> Tuple[int, int]:
    """(rank, world size) of the initialized torch.distributed world, or
    (0, 1)."""
    from jubatus_tpu_torch.parallel import multihost

    return multihost.rank(), multihost.world_size()


def _check_space(dir_path: str, need: int) -> None:
    """Fail before writing when the disk cannot hold the blocks (the state
    dir being overwritten counts as free)."""
    probe = dir_path
    while not os.path.exists(probe):
        probe = os.path.dirname(probe)
    free = shutil.disk_usage(probe).free + tree_bytes(
        os.path.join(dir_path, STATE_DIR))
    if need > free:
        raise SaveLoadError(
            f"{dir_path}: the checkpoint needs {need} bytes, the disk has "
            f"{free} free")


def _token_tensor(token: str) -> torch.Tensor:
    return torch.tensor(list(token.encode()), dtype=torch.uint8)


def save_sharded(
    dir_path: str,
    state: Any,
    *,
    engine_type: str,
    model_id: str = "",
    config: str = "",
    user_data_version: int = 0,
) -> Dict[str, float]:
    """Checkpoint a (possibly sharded) state into ``dir_path``: the blocks
    staged to the host, written with the pairing token through
    ``dcp.save``, then the sidecar. Returns the save's split in
    milliseconds: ``stage_ms`` (the blocks copied off their devices),
    ``write_ms`` (``dcp.save``) and ``sidecar_ms``. Staging holds one host
    copy of this rank's blocks for the length of the save."""
    import torch.distributed.checkpoint as dcp

    dir_path = os.path.abspath(dir_path)
    rank, world = _world()
    token = binascii.hexlify(os.urandom(8)).decode()
    if world > 1:
        # every rank must commit the token rank 0 writes into the sidecar
        import torch.distributed as dist

        box = [token]
        dist.broadcast_object_list(box, src=0)
        token = str(box[0])
    blocks = _entries(state)
    _check_space(dir_path, sum(b.numel() * b.element_size()
                               for b in blocks.values()))
    split: Dict[str, float] = {}
    t0 = time.perf_counter()
    entries = {k: b.detach().to("cpu").contiguous()
               for k, b in blocks.items()}
    del blocks
    split["stage_ms"] = (time.perf_counter() - t0) * 1e3
    os.makedirs(dir_path, exist_ok=True)
    entries[TOKEN_KEY] = _token_tensor(token)
    t0 = time.perf_counter()
    dcp.save(entries, storage_writer=dcp.FileSystemWriter(
        os.path.join(dir_path, STATE_DIR)), no_dist=world <= 1)
    split["write_ms"] = (time.perf_counter() - t0) * 1e3
    layout = shard_layout(state)
    t0 = time.perf_counter()
    if rank == 0:
        _write_system(os.path.join(dir_path, SYSTEM_FILE), {
            "version": FORMAT_VERSION,
            "timestamp": int(time.time()),  # wall-clock
            "type": engine_type,
            "id": model_id,
            "config": config,
            "user_data_version": user_data_version,
            "sharded": True,
            "shard_layout": layout,
            "pairing_token": token,
        })
    split["sidecar_ms"] = (time.perf_counter() - t0) * 1e3
    if world > 1:
        # no rank may report the save complete (and let a reader see
        # state/ without its sidecar) before rank 0 has written it
        import torch.distributed as dist

        dist.barrier()
    from jubatus_tpu_torch.utils import events

    events.emit("checkpoint", "save", dir=dir_path, model_id=model_id,
                shard_layout=layout or None)
    return split


class _Saved(NamedTuple):
    lo: int
    hi: int
    key: str
    size: Tuple[int, ...]
    dtype: torch.dtype


def _saved_blocks(meta) -> Dict[Tuple[str, Optional[int]], List[_Saved]]:
    """The checkpoint's block entries by (field, replica), column order."""
    out: Dict[Tuple[str, Optional[int]], List[_Saved]] = {}
    for key, md in meta.state_dict_metadata.items():
        m = _KEY.match(key)
        if m is None:
            continue
        r = m.group("r")
        out.setdefault((m.group("field"), None if r is None else int(r)),
                       []).append(_Saved(int(m.group("lo")),
                                         int(m.group("hi")), key,
                                         tuple(md.size),
                                         md.properties.dtype))
    for blocks in out.values():
        blocks.sort()
    return out


def _read_entry(state_path: str, key: str, size, dtype) -> torch.Tensor:
    import torch.distributed.checkpoint as dcp

    buf = torch.empty(size, dtype=dtype)
    dcp.load({key: buf}, storage_reader=dcp.FileSystemReader(state_path),
             no_dist=True)
    return buf


def _state_token(state_path: str, meta) -> Optional[str]:
    """The pairing token committed with the state; None for a checkpoint
    that carries none."""
    md = meta.state_dict_metadata.get(TOKEN_KEY)
    if md is None:
        return None
    buf = _read_entry(state_path, TOKEN_KEY, tuple(md.size),
                      md.properties.dtype)
    try:
        return bytes(buf.tolist()).decode()
    except (UnicodeDecodeError, ValueError) as e:
        raise SaveLoadError(
            f"{state_path}: the committed pairing token is corrupt "
            f"({e})") from e


def _target_device(t: torch.Tensor) -> torch.device:
    return getattr(t, "target_device", t.device) if t.is_meta else t.device


def load_sharded(
    dir_path: str,
    template: Any,
    *,
    expected_type: Optional[str] = None,
    expected_config: Optional[str] = None,
) -> Tuple[dict, Any]:
    """Restore a checkpoint into the template's shapes, dtypes and layout.

    ``template`` is a live state or the result of ``abstract_like``.
    Returns (system container, restored state); raises SaveLoadError on a
    metadata mismatch (engine type, semantic config equality, as the
    envelope loader checks) and on a torn overwrite.

    Reshard on restore: the template's blocks govern placement,
    independent of the layout that wrote the checkpoint: a save at N
    shards restores bit-exact onto an M-shard template (N→1, 1→M, N→M).
    Each target block is filled from the saved entries that overlap its
    columns, read one at a time. The replica count is fixed (it is part
    of the state's shape)."""
    import torch.distributed.checkpoint as dcp

    dir_path = os.path.abspath(dir_path)
    system = _read_system(os.path.join(dir_path, SYSTEM_FILE))
    if expected_type is not None and system.get("type") != expected_type:
        raise SaveLoadError(
            f"{dir_path}: model type {system.get('type')!r} != "
            f"{expected_type!r}")
    if expected_config is not None and not _semantic_config_equal(
            system.get("config", ""), expected_config):
        raise SaveLoadError(
            f"{dir_path}: saved config does not match server config")
    state_path = os.path.join(dir_path, STATE_DIR)
    meta = dcp.FileSystemReader(state_path).read_metadata()
    want_token = system.get("pairing_token")
    if want_token is not None and _state_token(state_path, meta) != want_token:
        raise SaveLoadError(
            f"{dir_path}: state/metadata pairing mismatch "
            "(interrupted overwrite?) — the sidecar describes a "
            "different checkpoint than the state directory holds")
    saved = _saved_blocks(meta)
    out = _map_tensors(template, lambda t: torch.empty(
        t.shape, dtype=t.dtype, device=_target_device(t)))
    for leaf in _leaves(out):
        have = saved.get((leaf.field, leaf.replica))
        where = leaf.field if leaf.replica is None else \
            f"{leaf.field} (replica {leaf.replica})"
        if not have:
            raise SaveLoadError(f"{dir_path}: no saved array for {where}")
        targets = _ranges(leaf.blocks)
        lead = tuple(leaf.blocks[0].shape[:-1])
        if have[-1].hi != targets[-1][1] or any(
                s.size[:-1] != lead for s in have):
            raise SaveLoadError(
                f"{dir_path}: saved {where} is {list(have[0].size[:-1])} x "
                f"{have[-1].hi} columns, the template's "
                f"{list(lead)} x {targets[-1][1]}")
        edge = 0
        for s in have:
            if s.lo != edge:
                raise SaveLoadError(
                    f"{dir_path}: saved {where} does not cover its columns: "
                    f"{'a gap' if s.lo > edge else 'an overlap'} at "
                    f"column {min(edge, s.lo)}")
            edge = s.hi
        for s in have:
            hits = [(b, lo, hi) for b, (lo, hi) in zip(leaf.blocks, targets)
                    if lo < s.hi and s.lo < hi]
            if not hits:
                continue
            buf = _read_entry(state_path, s.key, s.size, s.dtype)
            for b, lo, hi in hits:
                a, z = max(lo, s.lo), min(hi, s.hi)
                b[..., a - lo:z - lo].copy_(buf[..., a - s.lo:z - s.lo])
            del buf
    from jubatus_tpu_torch.utils import events

    saved_layout = system.get("shard_layout") or {}
    restored_layout = shard_layout(out) or {}
    events.emit("checkpoint",
                "reshard" if saved_layout != restored_layout else "restore",
                dir=dir_path, saved_layout=saved_layout or None,
                restored_layout=restored_layout or None)
    return system, out


def checkpoint_metadata(dir_path: str) -> dict:
    """System container + per-array shape/dtype metadata without reading
    array bytes (jubadump uses this for directory inputs). Each field is
    reported as one global array (``[R, L, D]`` for a grid state, ``[L,
    D]`` otherwise) with the JAX package's ``partition_spec`` strings, so
    both packages' jubadump print the same ``arrays`` for one state."""
    import torch.distributed.checkpoint as dcp

    dir_path = os.path.abspath(dir_path)
    system = _read_system(os.path.join(dir_path, SYSTEM_FILE))
    meta = dcp.FileSystemReader(
        os.path.join(dir_path, STATE_DIR)).read_metadata()
    sharded_state = bool(system.get("shard_layout"))
    by_field: Dict[str, Dict[Optional[int], List[_Saved]]] = {}
    for (field, r), blocks in _saved_blocks(meta).items():
        by_field.setdefault(field, {})[r] = blocks
    arrays = {}
    for field in sorted(by_field):
        reps = by_field[field]
        blocks = next(iter(reps.values()))
        shape = list(blocks[0].size[:-1]) + [blocks[-1].hi]
        entry: Dict[str, Any] = {
            "dtype": str(blocks[0].dtype).replace("torch.", "")}
        if None in reps:
            if len(blocks) > 1:
                entry["partition_spec"] = ["None"] * (len(shape) - 1) + \
                    ["shard"]
            elif sharded_state:
                entry["partition_spec"] = []
        else:
            shape = [1 + max(reps)] + shape
            entry["partition_spec"] = ["replica"] + \
                ["None"] * (len(shape) - 2) + ["shard"]
        arrays[field] = {"shape": shape, **entry}
    return {"system": system, "arrays": arrays}
