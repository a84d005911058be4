"""The port's jubadump (jubatus_tpu_torch/cmd/jubadump.py), mirroring
tests/test_jubadump.py on model files the port writes, plus: the port
tool's JSON equals the JAX tool's on model files written by each package
(both write the same envelope), the same ``arrays`` for a sharded
checkpoint of one state, and a JAX package's orbax checkpoint directory
answered with its sidecar and a one-line message."""

from __future__ import annotations

import json
import struct
import zlib

import jax
import numpy as np
import pytest
import torch

from jubatus_tpu.cmd import jubadump as jdump
from jubatus_tpu.core.datum import Datum as JDatum
from jubatus_tpu.framework import save_model as jsave_model
from jubatus_tpu.server.factory import create_driver as jcreate_driver
from jubatus_tpu_torch.cmd import jubadump
from jubatus_tpu_torch.core.datum import Datum
from jubatus_tpu_torch.framework.save_load import _HEADER, MAGIC, save_model
from jubatus_tpu_torch.server.factory import create_driver

CLASSIFIER_CFG = {
    "method": "PA",
    "parameter": {},
    "converter": {
        "string_rules": [{"key": "*", "type": "space",
                          "sample_weight": "bin", "global_weight": "bin"}],
        "num_rules": [{"key": "*", "type": "num"}],
    },
}
EXAMPLES = [("spam", {"w": "buy pills now"}), ("ham", {"w": "lunch at noon"})]


def _port_model(path: str, engine: str = "classifier",
                cfg=CLASSIFIER_CFG) -> str:
    d = create_driver(engine, cfg, device="cpu")
    d.train([(label, Datum(v)) for label, v in EXAMPLES])
    save_model(path, d, model_id="snap1", config=json.dumps(cfg))
    return path


def _jax_model(path: str) -> str:
    d = jcreate_driver("classifier", CLASSIFIER_CFG)
    d.train([(label, JDatum(v)) for label, v in EXAMPLES])
    jsave_model(path, d, model_id="snap1",
                config=json.dumps(CLASSIFIER_CFG))
    return path


@pytest.fixture()
def model_file(tmp_path):
    return _port_model(str(tmp_path / "m.jubatus"))


def test_dump_full(model_file):
    out = jubadump.dump_file(model_file)
    assert out["header"]["crc32_ok"] is True
    assert out["header"]["format_version"] == 1
    assert out["system"]["type"] == "classifier"
    assert out["system"]["id"] == "snap1"
    assert out["system"]["config"]["method"] == "PA"
    assert "user_data" in out
    json.dumps(out)


def test_dump_summary_digests_arrays(model_file):
    blob = json.dumps(jubadump.dump_file(model_file, summary=True))
    assert len(blob) < 100_000
    assert "__array__" in blob


def test_dump_rejects_non_model(tmp_path):
    p = tmp_path / "junk.bin"
    p.write_bytes(b"\x00" * 100)
    with pytest.raises(ValueError, match="bad magic"):
        jubadump.dump_file(str(p))
    (tmp_path / "short.bin").write_bytes(b"xy")
    with pytest.raises(ValueError, match="truncated"):
        jubadump.dump_file(str(tmp_path / "short.bin"))


def test_dump_detects_corruption(model_file):
    raw = bytearray(open(model_file, "rb").read())
    raw[-1] ^= 0xFF
    open(model_file, "wb").write(bytes(raw))
    assert jubadump.dump_file(model_file)["header"]["crc32_ok"] is False


def test_dump_undecodable_body_keeps_header_report(tmp_path):
    body = b"\xc1" * 32 + b"\xc1" * 16  # 0xc1: the invalid msgpack byte
    header = _HEADER.pack(MAGIC, 1, 1, 0, 2,
                          zlib.crc32(body) & 0xFFFFFFFF, 32, 16)
    p = tmp_path / "garbage.jubatus"
    p.write_bytes(header + body)
    out = jubadump.dump_file(str(p))
    assert out["header"]["crc32_ok"] is True
    assert "system_error" in out
    json.dumps(out)


def test_dump_size_mismatch_and_version_warn(model_file, tmp_path):
    raw = open(model_file, "rb").read()
    short = tmp_path / "short.jubatus"
    short.write_bytes(raw[:-3])
    assert "size mismatch" in jubadump.dump_file(str(short))["header"][
        "warning"]
    future = tmp_path / "v9.jubatus"
    future.write_bytes(raw[:8] + struct.pack(">I", 9) + raw[12:])
    assert "unsupported format version 9" in jubadump.dump_file(
        str(future))["header"]["warning"]


def test_cli_main(model_file, capsys):
    assert jubadump.main(["-i", model_file, "--summary"]) == 0
    out = json.loads(capsys.readouterr().out)
    assert out["system"]["type"] == "classifier"
    assert jubadump.main(["-i", model_file + ".nope"]) == 1
    assert jubadump.main([]) == 1


def test_no_user_data(model_file):
    out = jubadump.dump_file(model_file, skip_user_data=True)
    assert "user_data" not in out and out["system"]["id"] == "snap1"


def test_dump_sharded_sidecar_reports_null_user_data(tmp_path):
    """A sharded checkpoint's sidecar (no user bytes) dumps with
    user_data null, not a user_data_error."""
    from jubatus_tpu_torch.framework import sharded_checkpoint as sc

    d = str(tmp_path / "ckpt")
    sc.save_sharded(d, {"w": torch.zeros(2, 8)}, engine_type="classifier",
                    model_id="s1", config=json.dumps(CLASSIFIER_CFG))
    out = jubadump.dump_file(str(tmp_path / "ckpt" / "system.jubatus"))
    assert "user_data_error" not in out
    assert out["user_data"] is None
    assert out["system"]["sharded"] is True


# -- the JAX tool's output -----------------------------------------------------


@pytest.mark.parametrize("writer", ["port", "jax"])
@pytest.mark.parametrize("flags", [[], ["--summary"], ["--no-user-data"]])
def test_json_equals_the_jax_tools(tmp_path, capsys, writer, flags):
    """Both packages write one envelope: on a model file of either, the
    port's jubadump prints the JAX tool's JSON byte for byte."""
    path = str(tmp_path / "m.jubatus")
    (_port_model if writer == "port" else _jax_model)(path)
    assert jubadump.main(["-i", path, *flags]) == 0
    mine = capsys.readouterr().out
    assert jdump.main(["-i", path, *flags]) == 0
    theirs = capsys.readouterr().out
    assert mine == theirs
    assert json.loads(mine)["system"]["id"] == "snap1"


@pytest.mark.parametrize("engine,cfg", [
    ("regression", {"method": "PA1", "parameter": {"sensitivity": 0.1,
                                                   "regularization_weight":
                                                   1.0},
                    "converter": {"num_rules": [{"key": "*",
                                                 "type": "num"}]}}),
    ("stat", {"window_size": 16}),
])
def test_json_equals_the_jax_tools_other_engines(tmp_path, capsys, engine,
                                                 cfg):
    d = create_driver(engine, cfg, device="cpu")
    if engine == "regression":
        d.train([(1.5, Datum({"x": 2.0})), (-0.5, Datum({"y": 1.0}))])
    else:
        d.push("k", 1.0)
        d.push("k", 3.0)
    path = str(tmp_path / f"{engine}.jubatus")
    save_model(path, d, model_id="e", config=json.dumps(cfg))
    for flags in ([], ["--summary"]):
        assert jubadump.main(["-i", path, *flags]) == 0
        mine = capsys.readouterr().out
        assert jdump.main(["-i", path, *flags]) == 0
        assert mine == capsys.readouterr().out


def test_sharded_arrays_equal_the_jax_tools(tmp_path, capsys):
    """One state, checkpointed by each package: each tool on its own
    package's directory prints the same ``arrays``."""
    from jubatus_tpu.framework import sharded_checkpoint as jsc
    from jubatus_tpu.parallel.mesh import grid_mesh as jgrid_mesh
    from jubatus_tpu.parallel.spmd import init_spmd_state as jinit
    from jubatus_tpu_torch.framework import sharded_checkpoint as sc
    from jubatus_tpu_torch.parallel import spmd
    from jubatus_tpu_torch.parallel.mesh import grid_mesh

    rng = np.random.default_rng(5)
    host = [rng.normal(size=(2, 4, 64)).astype(np.float32)
            for _ in range(4)]
    jst = jinit(jgrid_mesh(replica=2, shard=4), 4, 64)
    jst = type(jst)(*(jax.device_put(h, a.sharding)
                      for h, a in zip(host, jst)))
    pst = spmd.place_host(grid_mesh(2, 4, devices=["cpu"] * 8), host, 64)
    cfg = json.dumps(CLASSIFIER_CFG)
    jsc.save_sharded(str(tmp_path / "j"), jst, engine_type="classifier",
                     config=cfg)
    sc.save_sharded(str(tmp_path / "p"), pst, engine_type="classifier",
                    config=cfg)
    assert jubadump.main(["-i", str(tmp_path / "p")]) == 0
    mine = json.loads(capsys.readouterr().out)
    assert jdump.main(["-i", str(tmp_path / "j")]) == 0
    theirs = json.loads(capsys.readouterr().out)
    assert mine["arrays"] == theirs["arrays"]
    drop = ("timestamp", "pairing_token")
    assert {k: v for k, v in mine["system"].items() if k not in drop} == \
        {k: v for k, v in theirs["system"].items() if k not in drop}


def test_orbax_directory_prints_its_sidecar_and_exits(tmp_path, capsys):
    """A JAX package's checkpoint directory: the sidecar on stdout, then
    the JAX tool's exit code 1 and one line naming the format."""
    from jubatus_tpu.framework import sharded_checkpoint as jsc

    path = str(tmp_path / "jckpt")
    jsc.save_sharded(path, {"w": np.zeros((2, 8), np.float32)},
                     engine_type="classifier", model_id="o1",
                     config=json.dumps(CLASSIFIER_CFG))
    assert jubadump.main(["-i", path]) == 1
    cap = capsys.readouterr()
    doc = json.loads(cap.out)
    assert doc["system"]["id"] == "o1"
    assert doc["system"]["config"]["method"] == "PA"
    err = cap.err.strip()
    assert "\n" not in err and "orbax" in err and "Traceback" not in err
