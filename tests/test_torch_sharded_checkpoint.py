"""The port's sharded checkpoints (jubatus_tpu_torch/framework/
sharded_checkpoint.py, on torch.distributed.checkpoint), mirroring every
case of tests/test_sharded_checkpoint.py on the port's
``grid_mesh(replica=2, shard=4, devices=["cpu"] * 8)`` and on column
blocks over ``ShardMesh(["cpu"] * n)`` (the port's stand-in for the JAX
tests' virtual CPU devices); plus parity with the JAX package (the same
seeded state saved and loaded by each package gives equal arrays, the same
sidecar less timestamp and token, and the same ``arrays`` metadata), a
two-rank gloo save and load, the events and the disk-space check."""

from __future__ import annotations

import json
import os
import shutil

import jax
import numpy as np
import pytest
import torch

from jubatus_tpu.framework import sharded_checkpoint as jsc
from jubatus_tpu.parallel import sharded_model as jsm
from jubatus_tpu.parallel.mesh import grid_mesh as jgrid_mesh
from jubatus_tpu.parallel.spmd import init_spmd_state as jinit_spmd_state
from jubatus_tpu_torch.framework.save_load import SaveLoadError
from jubatus_tpu_torch.framework.sharded_checkpoint import (
    abstract_like, checkpoint_metadata, load_sharded, save_sharded,
    shard_layout)
from jubatus_tpu_torch.ops import classifier as cops
from jubatus_tpu_torch.parallel import multihost, spmd
from jubatus_tpu_torch.parallel import sharded_model as sm
from jubatus_tpu_torch.parallel.mesh import ShardMesh, grid_mesh
from jubatus_tpu_torch.parallel.spmd import init_spmd_state

CONFIG = json.dumps({"method": "AROW", "parameter": {}})
FIELDS = ("w", "dw", "prec", "dprec")


def _grid(replica: int, shard: int):
    return grid_mesh(replica=replica, shard=shard, devices=["cpu"] * 8)


@pytest.fixture(scope="module")
def mesh():
    return _grid(2, 4)


@pytest.fixture()
def saved(mesh, tmp_path):
    st = init_spmd_state(mesh, 4, 64)
    st = spmd.place_host(mesh, [st.stacked("w") + 3.25, st.stacked("dw"),
                                st.stacked("prec"),
                                st.stacked("dprec") + 0.5], 64)
    path = str(tmp_path / "ckpt")
    save_sharded(path, st, engine_type="classifier", model_id="m1",
                 config=CONFIG)
    return path, st


def _blocks(leaf):
    return leaf if isinstance(leaf, tuple) else (leaf,)


def _same_layout(a, b) -> bool:
    """Same structure, block shapes and devices, leaf by leaf."""
    if isinstance(a, tuple) != isinstance(b, tuple):
        return False
    if isinstance(a, tuple):
        return len(a) == len(b) and all(_same_layout(x, y)
                                        for x, y in zip(a, b))
    dev = getattr(b, "target_device", b.device) if b.is_meta else b.device
    return a.shape == b.shape and a.device == dev


def test_roundtrip_preserves_values_and_layout(mesh, saved):
    path, st = saved
    tmpl = abstract_like(init_spmd_state(mesh, 4, 64))
    assert all(b.is_meta for f in tmpl for r in f for b in _blocks(r))
    system, st2 = load_sharded(path, tmpl, expected_type="classifier",
                               expected_config=CONFIG)
    assert system["id"] == "m1"
    assert system["sharded"] is True
    assert system["shard_layout"] == {"replica": 2, "shard": 4}
    for f in FIELDS:
        np.testing.assert_array_equal(st2.stacked(f), st.stacked(f))
    assert _same_layout(tuple(st2), tuple(tmpl))


def test_live_state_as_template(mesh, saved):
    path, st = saved
    fresh = init_spmd_state(mesh, 4, 64)
    _, st2 = load_sharded(path, fresh)
    np.testing.assert_array_equal(st2.stacked("w"), st.stacked("w"))
    # the restore returns new tensors; the live template stays as it was
    assert float(fresh.w[0][0].abs().sum()) == 0.0


def test_type_and_config_validation(mesh, saved):
    path, _ = saved
    tmpl = abstract_like(init_spmd_state(mesh, 4, 64))
    with pytest.raises(SaveLoadError, match="model type"):
        load_sharded(path, tmpl, expected_type="recommender")
    with pytest.raises(SaveLoadError, match="config"):
        load_sharded(path, tmpl, expected_type="classifier",
                     expected_config=json.dumps({"method": "CW"}))
    reordered = json.dumps(json.loads(CONFIG), indent=2)
    load_sharded(path, tmpl, expected_type="classifier",
                 expected_config=reordered)


def test_overwrite_existing(mesh, saved):
    path, st = saved
    st3 = spmd.place_host(mesh, [st.stacked("w") * 2.0, st.stacked("dw"),
                                 st.stacked("prec"), st.stacked("dprec")], 64)
    save_sharded(path, st3, engine_type="classifier", model_id="m2",
                 config=CONFIG)
    system, st4 = load_sharded(path, abstract_like(st3))
    assert system["id"] == "m2"
    np.testing.assert_array_equal(st4.stacked("w"), st3.stacked("w"))


def test_metadata_without_reading_arrays(saved, monkeypatch):
    from jubatus_tpu_torch.framework import sharded_checkpoint as sc

    path, _ = saved

    def no_read(*_a, **_k):
        raise AssertionError("metadata must not read array bytes")

    monkeypatch.setattr(sc, "_read_entry", no_read)
    md = checkpoint_metadata(path)
    assert md["system"]["type"] == "classifier"
    assert md["arrays"]["w"]["shape"] == [2, 4, 64]
    assert md["arrays"]["w"]["dtype"] == "float32"
    assert md["arrays"]["w"]["partition_spec"] == ["replica", "None", "shard"]


def test_jubadump_reads_checkpoint_dirs(saved, capsys):
    from jubatus_tpu_torch.cmd import jubadump

    path, _ = saved
    assert jubadump.main(["-i", path]) == 0
    out = json.loads(capsys.readouterr().out)
    assert out["system"]["type"] == "classifier"
    assert out["system"]["config"]["method"] == "AROW"
    assert out["arrays"]["dw"]["shape"] == [2, 4, 64]


def test_torn_overwrite_detected(saved):
    """New state + stale sidecar (a crash between the two commits) is
    rejected through the pairing token, not silently mispaired."""
    path, st = saved
    sidecar = os.path.join(path, "system.jubatus")
    stale = sidecar + ".stale"
    shutil.copy(sidecar, stale)
    save_sharded(path, st, engine_type="classifier", model_id="m-new",
                 config=CONFIG)
    shutil.copy(stale, sidecar)  # the state committed, the sidecar not
    with pytest.raises(SaveLoadError, match="pairing mismatch"):
        load_sharded(path, abstract_like(st))


def test_jubadump_cli_corrupt_dir_exits_cleanly(saved, capsys):
    from jubatus_tpu_torch.cmd import jubadump

    path, _ = saved
    with open(os.path.join(path, "system.jubatus"), "wb") as f:
        f.write(b"not a container")
    assert jubadump.main(["-i", path]) == 1
    err = capsys.readouterr().err
    assert "truncated" in err or "magic" in err
    assert "Traceback" not in err


def _featured(n: int, dim: int = 64, confidence: bool = True):
    st = cops.init_state(4, dim, confidence, "cpu")
    return sm.place_state(ShardMesh(["cpu"] * n), st, dim) if n > 1 else st


@pytest.mark.parametrize("n_from,n_to", [(4, 1), (1, 4), (4, 2), (2, 8)])
def test_reshard_on_restore(tmp_path, n_from, n_to):
    """A checkpoint saved at N shards restores bit-exact onto an M-shard
    template: the template's layout governs placement."""
    dim = 64
    rng = np.random.default_rng(7)
    host = cops.ClassifierState(
        rng.normal(size=(4, dim)).astype(np.float32),
        np.zeros((4, dim), np.float32), np.ones((4, dim), np.float32),
        np.full((4, dim), 0.25, np.float32))
    src = sm.place_host(ShardMesh(["cpu"] * n_from) if n_from > 1 else None,
                        host, dim, "cpu")
    path = str(tmp_path / "ckpt")
    save_sharded(path, src, engine_type="classifier", model_id="rs",
                 config=CONFIG)
    md = checkpoint_metadata(path)
    if n_from > 1:
        assert md["system"]["shard_layout"] == {"shard": n_from}
    tmpl = abstract_like(_featured(n_to))
    _, out = load_sharded(path, tmpl, expected_type="classifier",
                          expected_config=CONFIG)
    for name, a, b in zip(FIELDS, src, out):
        np.testing.assert_array_equal(
            np.concatenate([x.numpy() for x in _blocks(a)], -1),
            np.concatenate([x.numpy() for x in _blocks(b)], -1),
            err_msg=name)   # bit-exact
    assert _same_layout(tuple(out), tuple(tmpl))
    if n_to > 1:
        assert all(x.shape[-1] == dim // n_to for x in out.w)


def test_reshard_on_restore_grid(mesh, saved):
    """The (replica, shard) grid state reshards along the shard axis; the
    replica count is part of its shape."""
    path, st = saved
    for r, s in ((2, 2), (2, 1)):
        tmpl = abstract_like(init_spmd_state(_grid(r, s), 4, 64))
        _, out = load_sharded(path, tmpl)
        np.testing.assert_array_equal(out.stacked("w"), st.stacked("w"))
        assert _same_layout(tuple(out), tuple(tmpl))
    with pytest.raises(SaveLoadError, match="no saved array"):
        load_sharded(path, abstract_like(init_spmd_state(_grid(4, 2), 4,
                                                         64)))


def test_corrupt_system_sidecar(mesh, saved):
    path, _ = saved
    sysfile = os.path.join(path, "system.jubatus")
    raw = bytearray(open(sysfile, "rb").read())
    raw[-1] ^= 0xFF
    open(sysfile, "wb").write(bytes(raw))
    with pytest.raises(SaveLoadError, match="CRC32 mismatch"):
        load_sharded(path, abstract_like(init_spmd_state(mesh, 4, 64)))


def test_shape_mismatch_is_refused(tmp_path):
    path = str(tmp_path / "ckpt")
    save_sharded(path, _featured(2), engine_type="classifier")
    with pytest.raises(SaveLoadError, match="columns"):
        load_sharded(path, abstract_like(_featured(2, dim=128)))


def test_placeholders_of_a_no_confidence_state(tmp_path):
    """PA's (1, 1) placeholders save and restore beside the sharded
    tables, reported replicated (partition spec []) as in the JAX
    package."""
    src = _featured(4, confidence=False)
    src = src._replace(w=tuple(b + 1.5 for b in src.w))
    path = str(tmp_path / "ckpt")
    save_sharded(path, src, engine_type="classifier")
    md = checkpoint_metadata(path)
    assert md["arrays"]["prec"] == {"shape": [1, 1], "dtype": "float32",
                                    "partition_spec": []}
    _, out = load_sharded(path, abstract_like(_featured(2, confidence=False)))
    assert out.prec.shape == (1, 1)
    assert torch.equal(torch.cat(out.w, -1), torch.cat(src.w, -1))


def test_events_mark_save_restore_and_reshard(tmp_path):
    from jubatus_tpu_torch.utils import events

    path = str(tmp_path / "ckpt")
    since = events.hlc_now()
    save_sharded(path, _featured(4), engine_type="classifier",
                 model_id="ev")
    load_sharded(path, abstract_like(_featured(4)))
    load_sharded(path, abstract_like(_featured(2)))
    got = [(e["type"], e.get("saved_layout"), e.get("restored_layout"))
           for e in events.default_journal().snapshot(since=since)
           if e["subsystem"] == "checkpoint"]
    assert got == [("save", None, None),
                   ("restore", {"shard": 4}, {"shard": 4}),
                   ("reshard", {"shard": 4}, {"shard": 2})]


def test_save_refuses_a_short_disk(tmp_path, monkeypatch):
    from jubatus_tpu_torch.framework import sharded_checkpoint as sc

    from collections import namedtuple

    usage = namedtuple("usage", "total used free")
    monkeypatch.setattr(sc.shutil, "disk_usage",
                        lambda _p: usage(1, 1, 16))
    with pytest.raises(SaveLoadError, match="needs .* bytes"):
        save_sharded(str(tmp_path / "ckpt"), _featured(4),
                     engine_type="classifier")
    assert not os.path.exists(tmp_path / "ckpt" / "system.jubatus")


def test_the_disk_check_runs_before_staging(tmp_path, monkeypatch):
    """A short disk refuses the save before any block is copied to the
    host: a template of meta tensors, which cannot be staged, fails on
    the space check."""
    from collections import namedtuple

    from jubatus_tpu_torch.framework import sharded_checkpoint as sc

    usage = namedtuple("usage", "total used free")
    monkeypatch.setattr(sc.shutil, "disk_usage",
                        lambda _p: usage(1, 1, 16))
    with pytest.raises(SaveLoadError, match="needs .* bytes"):
        save_sharded(str(tmp_path / "ckpt"), abstract_like(_featured(4)),
                     engine_type="classifier")


@pytest.mark.parametrize("edit,message", [
    ("drop", "a gap at column 16"),
    ("overlap", "an overlap at column 8"),
])
def test_saved_blocks_must_tile_the_columns(tmp_path, monkeypatch, edit,
                                            message):
    """A checkpoint whose saved column ranges leave a gap (a lost middle
    entry) or overlap is refused, not restored with unfilled columns."""
    from jubatus_tpu_torch.framework import sharded_checkpoint as sc

    entries = sc._entries

    def edited(state):
        out = dict(entries(state))
        if edit == "drop":
            del out["w/16:32"]
        else:
            out["w/8:24"] = torch.zeros(4, 16)
        return out

    path = str(tmp_path / "ckpt")
    monkeypatch.setattr(sc, "_entries", edited)
    save_sharded(path, _featured(4), engine_type="classifier")
    monkeypatch.undo()
    with pytest.raises(SaveLoadError, match=message):
        load_sharded(path, abstract_like(_featured(4)))


def test_a_corrupt_committed_token_is_a_load_error(tmp_path, monkeypatch):
    from jubatus_tpu_torch.framework import sharded_checkpoint as sc

    path = str(tmp_path / "ckpt")
    monkeypatch.setattr(sc, "_token_tensor", lambda _t: torch.tensor(
        [0xFF, 0xFE], dtype=torch.uint8))
    save_sharded(path, _featured(2), engine_type="classifier")
    monkeypatch.undo()
    with pytest.raises(SaveLoadError, match="pairing token is corrupt"):
        load_sharded(path, abstract_like(_featured(2)))


# -- parity with the JAX package ----------------------------------------------


def _host_grid(seed: int):
    rng = np.random.default_rng(seed)
    return [rng.normal(size=(2, 4, 64)).astype(np.float32)
            for _ in FIELDS]


@pytest.mark.parametrize("layout", ["grid", "feature", "flat"])
def test_parity_with_the_jax_package(tmp_path, layout):
    """The same seeded state saved and loaded by each package: equal
    arrays, the same sidecar less timestamp and pairing token, the same
    ``arrays`` metadata."""
    host = _host_grid(11)
    if layout == "grid":
        jst = jinit_spmd_state(jgrid_mesh(replica=2, shard=4), 4, 64)
        jst = type(jst)(*(jax.device_put(h, getattr(jst, f).sharding)
                          for f, h in zip(FIELDS, host)))
        pst = spmd.place_host(_grid(2, 4), host, 64)
        ptmpl = abstract_like(init_spmd_state(_grid(2, 4), 4, 64))

        def pread(st, f):
            return st.stacked(f)
    else:
        from jubatus_tpu.ops.classifier import init_state as jinit_state

        host = [h[0] for h in host]
        jst = jinit_state(4, 64, True)
        pst = sm.place_host(ShardMesh(["cpu"] * 4)
                            if layout == "feature" else None,
                            cops.ClassifierState(*host), 64, "cpu")
        if layout == "feature":
            jst = jsm.place_state(jsm.feature_shard_mesh(4), jst, 64)
        jst = type(jst)(*(jax.device_put(h, getattr(jst, f).sharding)
                          for f, h in zip(FIELDS, host)))
        ptmpl = abstract_like(pst)

        def pread(st, f):
            return torch.cat(_blocks(getattr(st, f)), -1).numpy()
    jpath, ppath = str(tmp_path / "jax"), str(tmp_path / "port")
    jsc.save_sharded(jpath, jst, engine_type="classifier", model_id="p",
                     config=CONFIG)
    save_sharded(ppath, pst, engine_type="classifier", model_id="p",
                 config=CONFIG)
    jsys, jout = jsc.load_sharded(jpath, jsc.abstract_like(jst))
    psys, pout = load_sharded(ppath, ptmpl)
    for f, h in zip(FIELDS, host):
        np.testing.assert_array_equal(np.asarray(getattr(jout, f)), h)
        np.testing.assert_array_equal(pread(pout, f), h)

    def less(sysd):
        return {k: v for k, v in sysd.items()
                if k not in ("timestamp", "pairing_token")}

    assert less(psys) == less(jsys)
    assert shard_layout(pst) == jsc.shard_layout(jst)
    assert checkpoint_metadata(ppath)["arrays"] == \
        jsc.checkpoint_metadata(jpath)["arrays"]


# -- a two-rank world ---------------------------------------------------------

_WORLD = r"""
import sys
import numpy as np
import torch
from jubatus_tpu_torch.framework.sharded_checkpoint import (
    abstract_like, load_sharded, save_sharded)
from jubatus_tpu_torch.parallel import multihost
from jubatus_tpu_torch.parallel.mesh import ShardMesh
from jubatus_tpu_torch.parallel import sharded_model as sm

rank, n, port, path = int(sys.argv[1]), int(sys.argv[2]), sys.argv[3], sys.argv[4]
multihost.enable_cpu_collectives()
assert multihost.initialize(f"127.0.0.1:{port}", n, rank, device="cpu",
                            timeout=60)
w = torch.from_numpy(np.random.default_rng(3).normal(size=(4, 64))
                     .astype(np.float32))
state = {"w": sm.split_columns(ShardMesh(["cpu"] * 2), w),
         f"own{rank}": torch.full((2, 8), float(rank + 1))}
save_sharded(path, state, engine_type="classifier", model_id="world")
tmpl = {"w": sm.split_columns(ShardMesh(["cpu"] * (4 if rank else 1)), w),
        "own0": torch.zeros(2, 8), "own1": torch.zeros(2, 8)}
system, out = load_sharded(path, abstract_like(tmpl))
got = torch.cat(out["w"], -1) if isinstance(out["w"], tuple) else out["w"]
assert torch.equal(got, w)
assert torch.equal(out["own0"], torch.full((2, 8), 1.0))
assert torch.equal(out["own1"], torch.full((2, 8), 2.0))
print("RANK-OK", rank, system["pairing_token"], system["shard_layout"],
      flush=True)
"""


def test_two_rank_save_and_load(tmp_path):
    """In a gloo world of two ranks the save is collective: one token for
    both ranks, each rank's own entries written, the replicated blocks
    once; each rank restores everything at its own layout."""
    path = str(tmp_path / "ckpt")
    outs, rcs = multihost.run_local_world(_WORLD, 2, args=(path,),
                                          timeout=120)
    assert rcs == [0, 0], [o[-2000:] for o in outs]
    lines = [o.split("RANK-OK", 1)[1].split() for o in outs]
    assert lines[0][1] == lines[1][1]  # the token rank 0 broadcast
    md = checkpoint_metadata(path)
    assert md["system"]["pairing_token"] == lines[0][1]
    assert sorted(md["arrays"]) == ["own0", "own1", "w"]
