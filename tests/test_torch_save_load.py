"""Save/load through the port: the checkpoint envelope
(framework/save_load.py) against the JAX package's, and model files that
cross between the two packages' servers.

Mirrors ``tests/test_classifier_driver.py::test_save_load_roundtrip`` and
``::test_load_validates_type_crc_and_config`` against the port's driver
(device "cpu"), holds the envelope bytes equal to the JAX package's for the
same system and user data, and, for each of the eleven engines (and the NN
classifier's methods), loads a file saved by the JAX server into the port
server and one saved by the port server into the JAX server: the loaded
server then answers as the one that saved.
"""

from __future__ import annotations

import json
import os
import shutil
import subprocess
import sys

import numpy as np
import pytest

from jubatus_tpu.client import Datum as JDatum
from jubatus_tpu.framework import save_load as jax_save_load
from jubatus_tpu.models import ClassifierDriver as JClassifierDriver
from jubatus_tpu.server import EngineServer as JEngineServer
from jubatus_tpu.server.args import ServerArgs as JServerArgs
from jubatus_tpu.utils import serialization as jax_serialization
from jubatus_tpu_torch.core.datum import Datum
from jubatus_tpu_torch.framework import save_load
from jubatus_tpu_torch.framework.save_load import (SaveLoadError, load_model,
                                                   save_model)
from jubatus_tpu_torch.models.classifier import ClassifierDriver
from jubatus_tpu_torch.models.regression import RegressionDriver
from jubatus_tpu_torch.rpc.client import RpcClient
from jubatus_tpu_torch.server import EngineServer
from jubatus_tpu_torch.server.args import ServerArgs
from jubatus_tpu_torch.utils import serialization

ROOT = os.path.join(os.path.dirname(__file__), "..")
NAME = "sl"

CFG = {
    "method": "AROW",
    "parameter": {"regularization_weight": 1.0},
    "converter": {
        "string_rules": [{"key": "*", "type": "space",
                          "sample_weight": "bin", "global_weight": "bin"}],
        "num_rules": [],
    },
}
SPAM = [Datum({"t": "cheap pills discount now"}),
        Datum({"t": "discount viagra cheap"}),
        Datum({"t": "win money now cheap"})]
HAM = [Datum({"t": "meeting tomorrow at noon"}),
       Datum({"t": "lunch with the team tomorrow"}),
       Datum({"t": "project status meeting"})]


def trained_driver():
    d = ClassifierDriver(CFG, dim_bits=12, device="cpu")
    for _ in range(3):
        d.train([("spam", x) for x in SPAM] + [("ham", x) for x in HAM])
    return d


def test_save_load_roundtrip(tmp_path):
    d = trained_driver()
    path = str(tmp_path / "model.jubatus")
    save_model(path, d, model_id="c0", config=json.dumps(CFG))
    before = d.classify([Datum({"t": "cheap discount pills"})])

    d2 = ClassifierDriver(CFG, dim_bits=12, device="cpu")
    system, ver = load_model(path, d2, expected_config=json.dumps(CFG))
    assert system["type"] == "classifier" and system["id"] == "c0"
    assert ver == 1
    after = d2.classify([Datum({"t": "cheap discount pills"})])
    assert sorted(dict(before[0])) == sorted(dict(after[0]))
    np.testing.assert_allclose(
        sorted(v for _, v in before[0]), sorted(v for _, v in after[0]),
        atol=1e-6)
    assert d2.get_labels() == d.get_labels()


def test_load_validates_type_crc_and_config(tmp_path):
    d = trained_driver()
    path = str(tmp_path / "model.jubatus")
    save_model(path, d, config=json.dumps(CFG))

    # wrong engine type
    r = RegressionDriver({"method": "PA1"}, dim_bits=10, device="cpu")
    with pytest.raises(SaveLoadError, match="type"):
        load_model(path, r)

    # config mismatch (semantic compare — whitespace-only diffs are fine)
    with pytest.raises(SaveLoadError, match="config"):
        load_model(path, ClassifierDriver(CFG, dim_bits=12, device="cpu"),
                   expected_config=json.dumps({"method": "PA"}))
    spaced = json.dumps(CFG, indent=3)
    load_model(path, ClassifierDriver(CFG, dim_bits=12, device="cpu"),
               expected_config=spaced)

    # corruption -> CRC failure
    raw = bytearray(open(path, "rb").read())
    raw[60] ^= 0xFF
    bad = str(tmp_path / "bad.jubatus")
    open(bad, "wb").write(bytes(raw))
    with pytest.raises(SaveLoadError, match="CRC32"):
        load_model(bad, ClassifierDriver(CFG, dim_bits=12, device="cpu"))


def _fixed_time(monkeypatch, t=1_700_000_000):
    for mod in (save_load, jax_save_load):
        monkeypatch.setattr(mod.time, "time", lambda: t)


def test_envelope_bytes_equal_the_jax_packages(tmp_path, monkeypatch):
    """With the timestamp fixed, both packages' save_model write the same
    bytes for the same driver state: the port driver's pack() through
    either package's envelope, and a JAX driver's through either."""
    _fixed_time(monkeypatch)
    port = trained_driver()
    jax_d = JClassifierDriver(CFG, dim_bits=12)
    from jubatus_tpu.core import Datum as JD

    for _ in range(3):
        jax_d.train([("spam", JD({"t": "cheap pills discount now"})),
                     ("ham", JD({"t": "meeting tomorrow at noon"}))])
    for i, drv in enumerate((port, jax_d)):
        a, b = str(tmp_path / f"p{i}"), str(tmp_path / f"j{i}")
        save_model(a, drv, model_id="m", config="{}")
        jax_save_load.save_model(b, drv, model_id="m", config="{}")
        assert open(a, "rb").read() == open(b, "rb").read()
    # the user data alone, and the ndarray ext type for every dtype a
    # pack holds
    obj = {"w": np.arange(6, dtype=np.float32).reshape(2, 3),
           "n": np.int64(3), "u": np.arange(4, dtype=np.uint32),
           "s": ["a", "b"], "f": 1.5}
    assert serialization.pack_obj(obj) == jax_serialization.pack_obj(obj)
    assert save_load.pack_envelope(b"sys", b"user") == \
        jax_save_load.pack_envelope(b"sys", b"user")


def test_a_cuda_tensor_is_refused_by_the_packer():
    import torch

    t = torch.ones(3)
    assert serialization.unpack_obj(serialization.pack_obj({"t": t}))[
        "t"].tolist() == [1.0, 1.0, 1.0]
    meta = torch.empty(2, device="meta")
    with pytest.raises(TypeError, match="read it back"):
        serialization.pack_obj(meta)


# -- cross-loading between the two packages' servers --------------------------

def _d(**kv):
    return JDatum(kv).to_msgpack()


def _rows(n, seed=0):
    rng = np.random.default_rng(seed)
    return [_d(x=float(np.round(rng.standard_normal(), 3)),
               y=float(np.round(rng.standard_normal(), 3)),
               c=f"c{int(rng.integers(4))}") for _ in range(n)]


def _session(engine, conf):
    """(updates, queries): (method, args) lists in wire shapes."""
    rows = _rows(24)
    q = _rows(4, seed=1)
    if engine == "nearest_neighbor":
        return ([("set_row", (f"r{i}", r)) for i, r in enumerate(rows)],
                [("neighbor_row_from_datum", (x, 5)) for x in q]
                + [("similar_row_from_id", ("r3", 5)), ("get_all_rows", ())])
    if engine == "recommender":
        # not complete_row_* / decode_row: they decode through the hasher's
        # reverse table, which neither package's pack holds, so a server
        # that loaded a file decodes fewer strings in both packages
        return ([("update_row", (f"r{i}", r)) for i, r in enumerate(rows)],
                [("similar_row_from_datum", (x, 5)) for x in q]
                + [("similar_row_from_id", ("r2", 5)),
                   ("calc_l2norm", (q[0],)),
                   ("calc_similarity", (q[0], q[1])), ("get_all_rows", ())])
    if engine == "anomaly":
        return ([("add", (r,)) for r in rows],
                [("calc_score", (x,)) for x in q] + [("get_all_rows", ())])
    if engine == "classifier":
        pairs = [["ab"[i % 2] if conf["method"] != "NN" else "abc"[i % 3],
                  r] for i, r in enumerate(rows)]
        return ([("train", (pairs,))],
                [("classify", (q,)), ("get_labels", ())])
    if engine == "regression":
        pairs = [[float(i % 5) - 2.0, r] for i, r in enumerate(rows)]
        return ([("train", (pairs,))], [("estimate", (q,))])
    if engine == "clustering":
        pts = [[f"p{i}", r] for i, r in enumerate(rows)]
        return ([("push", (pts,))],
                [("get_revision", ()), ("get_k_center", ()),
                 ("get_core_members_light", ()),
                 ("get_nearest_center", (q[0],)),
                 ("get_nearest_members_light", (q[1],))])
    if engine == "graph":
        qq = [[], []]
        ups = [("create_node", ())] * 6
        ups += [("update_node", (str(i), {"k": "ab"[i % 2]}))
                for i in range(6)]
        ups += [("create_edge", ("0", [{"r": "x"}, str(i % 6),
                                      str((i * 5 + 1) % 6)]))
                for i in range(10)]
        ups += [("add_centrality_query", (qq,)),
                ("add_shortest_path_query", (qq,)), ("update_index", ())]
        return (ups, [("get_centrality", ("1", 0, qq)),
                      ("get_shortest_path", (["0", "5", 6, qq],)),
                      ("get_node", ("0",)), ("get_edge", ("0", 3))])
    if engine == "stat":
        vals = np.round(np.random.default_rng(2).standard_normal(300), 3)
        return ([("push", (f"k{i % 3}", float(v)))
                 for i, v in enumerate(vals)],
                [(m, ("k1",)) for m in ("sum", "stddev", "max", "min",
                                        "entropy")]
                + [("moment", ("k0", 3, 1.0))])
    if engine == "bandit":
        ups = [("register_arm", (a,)) for a in "abc"]
        ups += [("register_reward", (f"p{i % 2}", "abc"[i % 3],
                                     float(i % 3 == 1))) for i in range(30)]
        return ups, [("get_arm_info", ("p0",)), ("get_arm_info", ("p1",))]
    if engine == "burst":
        docs = [[float(i) * 0.7, "storm rising" if 30 <= i < 45 else
                 f"calm {i % 4}"] for i in range(120)]
        return ([("add_keyword", (["storm", 2.0, 1.0],)),
                 ("add_keyword", (["calm", 1.5, 1.0],)),
                 ("add_documents", (docs,))],
                [("get_result", ("storm",)),
                 ("get_result_at", ("storm", 30.0)),
                 ("get_all_bursted_results", ()), ("get_all_keywords", ())])
    texts = ["a b a", "b c", "c d e", "a e"]
    return ([("update", (_d(t=texts[i % 4], n=float(i)),)) for i in range(8)],
            [("calc_weight", (_d(t="a b z"),))])


def _conf(path, **edits):
    with open(os.path.join(ROOT, "config", path)) as f:
        conf = json.load(f)
    for key, value in edits.items():
        conf[key] = value
    return conf


#: (engine, config, rtol): the answers of the server that loaded a model
#: against the server that saved it. Scores that sum over features (the
#: linear engines, euclid, cosine, LOF, the centres) add in another order
#: in each package: within rtol (relative, 1e-6 absolute). Stat's windows
#: are saved oldest-first, so a loaded window sums its float64 values in
#: another order than the saver's ring: within 1e-12. lsh and the other
#: host-state engines exactly.
CASES = [
    ("nearest_neighbor", _conf("nearest_neighbor/lsh.json"), 0.0),
    ("recommender", _conf("recommender/default.json"), 1e-5),
    ("anomaly", _conf("anomaly/lof.json"), 1e-4),
    ("classifier", _conf("classifier/pa.json"), 1e-5),
    ("classifier", _conf("classifier/arow.json"), 1e-5),
    ("classifier", _conf("classifier/nn.json"), 1e-5),
    ("classifier", _conf("classifier/cosine.json"), 1e-5),
    ("classifier", _conf("classifier/euclidean.json"), 1e-5),
    ("regression", _conf("regression/default.json"), 1e-5),
    ("clustering", _conf("clustering/default.json", compressor_parameter={
        "bucket_size": 24}), 1e-5),
    ("graph", _conf("graph/default.json"), 1e-5),
    ("stat", _conf("stat/default.json"), 1e-12),
    ("bandit", _conf("bandit/default.json"), 0.0),
    ("burst", _conf("burst/default.json"), 0.0),
    ("weight", _conf("weight/default.json"), 0.0),
]


def _is_scored(x):
    return isinstance(x, (list, tuple)) and len(x) == 2 and \
        isinstance(x[1], float) and not isinstance(x[0], (list, dict))


def _same(got, want, rtol):
    """Equal, floats within ``rtol`` (relative, 1e-6 absolute). A list
    of [id, score] pairs whose ids come in another order is compared by
    its scores, and by the ids whose score is clear of the last one
    (ties at the boundary may pick other ids)."""
    tol = lambda w: rtol * abs(w) + (1e-6 if rtol else 0.0)  # noqa: E731
    if isinstance(want, float):
        return isinstance(got, (int, float)) and abs(got - want) <= tol(want)
    if isinstance(want, dict):
        return isinstance(got, dict) and got.keys() == want.keys() and all(
            _same(got[k], want[k], rtol) for k in want)
    if isinstance(want, (list, tuple)):
        if not isinstance(got, (list, tuple)) or len(got) != len(want):
            return False
        if want and all(_is_scored(w) for w in want) and \
                all(_is_scored(g) for g in got) and \
                [g[0] for g in got] != [w[0] for w in want]:
            gs = sorted(g[1] for g in got)
            ws = sorted(w[1] for w in want)
            if not all(abs(g - w) <= tol(w) for g, w in zip(gs, ws)):
                return False
            edge = want[-1][1]
            clear = lambda s: abs(s - edge) > tol(edge) + 1e-6  # noqa: E731
            return {g[0] for g in got if clear(g[1])} == \
                {w[0] for w in want if clear(w[1])}
        return all(_same(g, w, rtol) for g, w in zip(got, want))
    return got == want


def _port_server(engine, conf, datadir):
    srv = EngineServer(engine, conf, ServerArgs(
        engine=engine, listen_addr="127.0.0.1", datadir=datadir,
        microbatch_max=0), device="cpu")
    return srv, srv.start(0)


def _jax_server(engine, conf, datadir):
    srv = JEngineServer(engine, conf, JServerArgs(
        engine=engine, listen_addr="127.0.0.1", datadir=datadir,
        microbatch_max=0))
    return srv, srv.start(0)


def _cross(engine, conf, rtol, make_saver, make_loader, tmp_path, tag):
    """Train the saver, save; copy the file to the loader's model path and
    load it over RPC; every query answers the same on both."""
    updates, queries = _session(engine, conf)
    dirs = [str(tmp_path / f"{tag}_{side}") for side in "sl"]
    for d in dirs:
        os.makedirs(d)
    saver, sport = make_saver(engine, conf, dirs[0])
    loader, lport = make_loader(engine, conf, dirs[1])
    try:
        with RpcClient("127.0.0.1", sport, timeout=60) as s, \
                RpcClient("127.0.0.1", lport, timeout=60) as ld:
            for method, args in updates:
                s.call(method, NAME, *args)
            (path,) = s.call("save", NAME, "m1").values()
            shutil.copy(path, loader.model_path("m1"))
            assert ld.call("load", NAME, "m1") is True
            for method, args in queries:
                want = s.call(method, NAME, *args)
                got = ld.call(method, NAME, *args)
                assert _same(got, want, rtol), (method, got, want)
            (st,) = ld.call("get_status", NAME).values()
            assert st["last_loaded"] > 0
    finally:
        saver.stop()
        loader.stop()


@pytest.mark.parametrize(
    "engine,conf,rtol", CASES,
    ids=[f"{c[0]}-{c[1].get('method', 'default')}" for c in CASES])
def test_model_files_cross_load_between_the_packages(engine, conf, rtol,
                                                     tmp_path):
    """A file the JAX server saved loads in the port server (device "cpu")
    and answers as the JAX server does; then a file the port server saved
    loads in the JAX server and answers as the port server does."""
    _cross(engine, conf, rtol, _jax_server, _port_server, tmp_path, "j2p")
    _cross(engine, conf, rtol, _port_server, _jax_server, tmp_path, "p2j")


def test_load_refuses_store_ids_as_not_yet_ported(tmp_path):
    """Without --store-dir a store id names no store: load refuses it as
    the JAX server does, looking for a model file of that id."""
    srv, _ = _port_server("stat", _conf("stat/default.json"), str(tmp_path))
    jsrv, _ = _jax_server("stat", _conf("stat/default.json"), str(tmp_path))
    try:
        for s in (srv, jsrv):
            with pytest.raises(FileNotFoundError, match="store:abc"):
                s.load(NAME, "store:abc")
    finally:
        srv.stop()
        jsrv.stop()


def test_server_main_saves_and_loads_with_datadir_and_model_file(tmp_path):
    """``python -m jubatus_tpu_torch.server regression -d <dir>`` answers
    save; a second server started with ``-m`` on that file answers as the
    first."""
    def start(*extra):
        proc = subprocess.Popen(
            [sys.executable, "-m", "jubatus_tpu_torch.server", "regression",
             "-f", os.path.join(ROOT, "config", "regression", "default.json"),
             "-p", "0", "-b", "127.0.0.1", "--device", "cpu",
             "-d", str(tmp_path), *extra],
            cwd=ROOT, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
            text=True)
        line = proc.stdout.readline()
        assert "serving on port" in line, proc.stderr.read()
        return proc, int(line.split("serving on port")[1].split()[0])

    updates, queries = _session("regression", {})
    first, port = start()
    try:
        with RpcClient("127.0.0.1", port, timeout=60) as c:
            for method, args in updates:
                c.call(method, NAME, *args)
            (path,) = c.call("save", NAME, "m").values()
            want = [c.call(m, NAME, *a) for m, a in queries]
    finally:
        first.terminate()
        first.wait(timeout=30)
    assert os.path.dirname(path) == str(tmp_path)
    assert path.endswith(f"127.0.0.1_{port}_regression_m.jubatus")
    second, port2 = start("-m", path)
    try:
        with RpcClient("127.0.0.1", port2, timeout=60) as c:
            assert [c.call(m, NAME, *a) for m, a in queries] == want
    finally:
        second.terminate()
        second.wait(timeout=30)
