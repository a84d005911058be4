"""The port's legacy wire (jubatus_tpu_torch/rpc/legacy.py and the
per-connection detection in rpc/server.py), case for case with
tests/test_legacy_wire.py: an unmodified old jubatus client must parse
every response — the reference's vendored msgpack predates str8/bin and
REJECTS those type bytes (jubatus/client/common/client.hpp). The native
transport's cases there wait for the port's C++ front-end.

The "legacy client" here is a raw socket speaking old-format msgpack-rpc
plus ``legacy.unpackb`` — a faithful reimplementation of the pre-2013
unpacker including its rejection of post-2013 type bytes. Then parity with
the JAX package: ``legacy.packb`` and the legacy ``build_response`` give
the JAX server's bytes for seeded nested values, ``scan_is_legacy`` gives
its verdicts, and a legacy session against an ``arow.json`` server of each
package gets the same answers.
"""

from __future__ import annotations

import re
import socket

import msgpack
import pytest

from jubatus_tpu_torch.rpc import legacy
from jubatus_tpu_torch.rpc.server import RpcServer, build_response
from jubatus_tpu_torch.server import EngineServer
from jubatus_tpu_torch.server.args import ServerArgs

NAME = "legacy"
# get_config must round-trip a config whose JSON is far beyond 31 bytes —
# the exact case that breaks old clients when packed as str8/raw-modern
CLASSIFIER_CONF = {
    "method": "AROW",
    "parameter": {"regularization_weight": 1.0},
    "converter": {
        "string_rules": [
            {"key": "*", "type": "str", "sample_weight": "bin",
             "global_weight": "bin"}
        ],
        "num_rules": [{"key": "*", "type": "num"}],
    },
}


class LegacyClient:
    """Old-format msgpack-rpc: requests packed use_bin_type=False (raw
    family only — byte-identical to what a pre-2013 client emits), responses
    decoded with the legacy unpacker that rejects str8/bin/ext."""

    def __init__(self, host, port):
        self.sock = socket.create_connection((host, port), timeout=10)
        self.msgid = 0
        self.buf = b""

    def close(self):
        self.sock.close()

    def call(self, method, *params):
        self.msgid += 1
        req = msgpack.packb([0, self.msgid, method, list(params)],
                            use_bin_type=False)
        self.sock.sendall(req)
        return self._read_response()

    def _read_response(self):
        # frame by attempting a legacy decode over the accumulated bytes
        while True:
            if self.buf:
                try:
                    obj, off = legacy._decode(memoryview(self.buf), 0)
                except legacy.LegacyFormatError as e:
                    if "truncated" not in str(e):
                        raise  # forbidden type byte — the actual assertion
                else:
                    self.buf = self.buf[off:]
                    kind, msgid, error, result = obj
                    assert kind == 1 and msgid == self.msgid
                    if error is not None:
                        raise RuntimeError(f"rpc error: {error!r}")
                    return result
            chunk = self.sock.recv(65536)
            if not chunk:
                raise ConnectionError("server closed")
            self.buf += chunk


def _datum(pairs_str, pairs_num):
    # wire-format datum: ([[k, v]...], [[k, v]...])
    return [list(map(list, pairs_str)), list(map(list, pairs_num))]


@pytest.fixture(params=["forced", "autodetect"])
def legacy_server(tmp_path, request):
    """Old client against (a) a server FORCED legacy with --legacy-wire,
    and (b) a server started with NO flags — per-connection autodetection
    must make the same full session pass."""
    srv = EngineServer(
        "classifier", CLASSIFIER_CONF,
        args=ServerArgs(engine="classifier",
                        legacy_wire=(request.param == "forced"),
                        datadir=str(tmp_path)), device="cpu")
    port = srv.start(0)
    cli = LegacyClient("127.0.0.1", port)
    yield cli, srv
    cli.close()
    srv.stop()


def test_legacy_client_full_session(legacy_server):
    """Every built-in + every classifier method parses under the old
    unpacker — including >=32-byte strings (get_config, get_status)."""
    cli, _srv = legacy_server
    cfg = cli.call("get_config", NAME)
    assert isinstance(cfg, bytes) and b"AROW" in cfg and len(cfg) > 32

    n = cli.call("train", NAME, [
        ["spam", _datum([["subject", "win money now"]], [])],
        ["ham", _datum([["subject", "meeting at noon"]], [])],
    ] * 5)
    assert n == 10

    res = cli.call("classify", NAME,
                   [_datum([["subject", "win money now"]], [])])
    # [[ [label, score], ... ]] — labels are old-raw bytes
    labels = {lbl: score for lbl, score in res[0]}
    assert b"spam" in labels and b"ham" in labels
    assert labels[b"spam"] > labels[b"ham"]

    labels = cli.call("get_labels", NAME)
    assert set(labels) == {b"spam", b"ham"}
    assert cli.call("set_label", NAME, "maybe") in (True, False)
    assert cli.call("delete_label", NAME, "maybe") in (True, False)

    st = cli.call("get_status", NAME)
    (node_status,) = st.values()
    assert b"classifier" == node_status[b"type"]
    # flags maps contain >=32-byte strings (paths) — must arrive as raw
    assert any(len(k) >= 32 or (isinstance(v, bytes) and len(v) >= 32)
               for k, v in node_status.items())

    paths = cli.call("save", NAME, "legacy_model")
    assert all(v.endswith(b".jubatus") for v in paths.values())
    assert cli.call("load", NAME, "legacy_model") is True
    assert cli.call("do_mix", NAME) is False  # standalone: no mixer
    assert cli.call("clear", NAME) is True


def test_autodetect_pins_modern_connection_modern(tmp_path):
    """A first request carrying a post-2013 type byte (str8) proves a
    modern client: that connection's responses stay modern (str8 present)
    — autodetection must not degrade modern clients' wire."""
    srv = EngineServer(
        "classifier", CLASSIFIER_CONF,
        args=ServerArgs(engine="classifier", datadir=str(tmp_path)),
        device="cpu")
    port = srv.start(0)
    sock = socket.create_connection(("127.0.0.1", port), timeout=10)
    try:
        # use_bin_type=True + a >=32-char param emits str8 in the request;
        # the config string response is >32 bytes, so a MODERN response
        # must contain str8/bin and the legacy unpacker must reject it
        req = msgpack.packb([0, 1, "get_config", ["m" * 40]],
                            use_bin_type=True)
        sock.sendall(req)
        buf = b""
        while True:
            try:
                legacy._decode(memoryview(buf), 0)
                pytest.fail("response parsed as legacy — connection was "
                            "not pinned modern")
            except legacy.LegacyFormatError as e:
                if "truncated" not in str(e):
                    break  # forbidden modern type byte: exactly right
            chunk = sock.recv(65536)
            if not chunk:
                pytest.fail("no response")
            buf += chunk
    finally:
        sock.close()
        srv.stop()


def _read_one_frame(sock, buf=b""):
    """Accumulate bytes until one complete msgpack object; returns
    (frame_bytes, leftover)."""
    while True:
        if buf:
            u = msgpack.Unpacker()
            u.feed(buf)
            try:
                u.skip()
                end = u.tell()
                return buf[:end], buf[end:]
            except msgpack.OutOfData:
                pass
        chunk = sock.recv(65536)
        if not chunk:
            raise ConnectionError("server closed")
        buf += chunk


def _frame_is_legacy_format(frame: bytes) -> bool:
    try:
        legacy.unpackb(frame)
        return True
    except legacy.LegacyFormatError:
        return False


@pytest.mark.parametrize("transport", ["python"])
def test_autodetect_upgrades_on_later_modern_byte(tmp_path, transport):
    """A modern client whose FIRST call is all-fixtype (short method, tiny
    args — zero post-2013 bytes) must not be latched legacy forever: the
    first request that does carry a modern type byte upgrades the
    connection, and it stays modern afterwards. (The JAX package runs
    this on its native transport too, which the port has not yet.)"""
    srv = EngineServer(
        "classifier", CLASSIFIER_CONF,
        args=ServerArgs(engine="classifier", datadir=str(tmp_path)),
        device="cpu")
    port = srv.start(0)
    sock = socket.create_connection(("127.0.0.1", port), timeout=10)
    buf = b""
    try:
        # 1: a modern client's small first call — indistinguishable from
        # legacy on the wire, so the response is (provisionally) legacy
        sock.sendall(msgpack.packb([0, 1, "get_config", ["m"]],
                                   use_bin_type=True))
        frame, buf = _read_one_frame(sock, buf)
        assert _frame_is_legacy_format(frame)
        # 2: a later call carries str8 — proof of a modern client; the
        # connection upgrades and answers modern
        sock.sendall(msgpack.packb([0, 2, "get_config", ["m" * 40]],
                                   use_bin_type=True))
        frame, buf = _read_one_frame(sock, buf)
        assert not _frame_is_legacy_format(frame)
        # 3: modern latches: an all-fixtype request no longer downgrades
        sock.sendall(msgpack.packb([0, 3, "get_config", ["m"]],
                                   use_bin_type=True))
        frame, buf = _read_one_frame(sock, buf)
        assert not _frame_is_legacy_format(frame)
    finally:
        sock.close()
        srv.stop()


def test_modern_mode_emits_str8_legacy_rejects():
    """Sanity: without --legacy-wire the same response DOES contain type
    bytes the old unpacker rejects (else the test above proves nothing)."""
    long_s = "x" * 64
    modern = build_response(1, None, long_s, legacy=False)
    with pytest.raises(legacy.LegacyFormatError):
        legacy.unpackb(modern)
    old = build_response(1, None, long_s, legacy=True)
    assert legacy.unpackb(old) == [1, 1, None, long_s.encode()]


def test_binary_methods_keep_modern_format():
    """Mixer internals ship packed bytes between OUR servers; they must
    keep the modern bin type even under legacy_wire (old clients never
    call them, and our peers need the str/bytes distinction)."""
    srv = RpcServer(legacy_wire=True)
    srv.register("mix_get_diff", lambda _n: b"\x00" * 40, binary=True)
    srv.register("get_config", lambda _n: "y" * 40)
    assert not srv.response_legacy("mix_get_diff")
    assert srv.response_legacy("get_config")
    payload = build_response(7, None, b"\x00" * 40,
                             legacy=srv.response_legacy("mix_get_diff"))
    out = msgpack.unpackb(payload, raw=False)
    assert out[3] == b"\x00" * 40  # bin type survived


def test_legacy_roundtrip_all_scalar_shapes():
    """The legacy packer/unpacker pair covers the whole old type system."""
    for v in [None, True, False, 0, 1, 127, 128, -1, -32, -33, 2**33,
              -(2**33), 0.5, "", "short", "y" * 31, "z" * 32, "w" * 70000,
              [1, [2, "three"]], {"k": [1.5, None]}, list(range(40))]:
        buf = msgpack.packb(v, use_bin_type=False)
        got = legacy.unpackb(buf)

        def norm(x):
            if isinstance(x, bytes):
                return x.decode()
            if isinstance(x, list):
                return [norm(i) for i in x]
            if isinstance(x, dict):
                return {norm(k): norm(val) for k, val in x.items()}
            return x
        assert norm(got) == v


def test_legacy_truncation_always_legacy_format_error():
    """Every truncation point raises LegacyFormatError (never struct.error)
    — the streaming framing loop keys on it to wait for more bytes."""
    for v in [3.14, 2**40, -7, "y" * 300, [1, 2, [3, "four"]], {"k": 1.5}]:
        buf = msgpack.packb(v, use_bin_type=False)
        for cut in range(len(buf)):
            with pytest.raises(legacy.LegacyFormatError):
                legacy.unpackb(buf[:cut])


def test_legacy_binary_datum_value_survives(legacy_server):
    """A legacy client packing a non-UTF8 binary datum value as old-raw
    must not kill the connection; the bytes must round-trip exactly
    (a UnicodeDecodeError must not close the socket with no reply)."""
    cli, srv = legacy_server
    blob = bytes(range(256))  # not valid UTF-8
    n = cli.call("train", NAME, [
        ["spam", [[["subject", "buy now"]], [], [["payload", blob]]]],
    ])
    assert n == 1
    # the connection is still alive and the server decoded the datum
    assert cli.call("get_labels", NAME)
    # direct check that surrogateescape restored the exact bytes
    from jubatus_tpu_torch.core.datum import Datum
    via_wire = blob.decode("utf-8", "surrogateescape")
    d = Datum.from_msgpack([[["k", "v"]], [], [["bin", via_wire]]])
    assert d.binary_values == [("bin", blob)]


def test_legacy_surrogate_label_roundtrip(legacy_server):
    """A legacy client may store a non-UTF8 label (old-raw); every later
    response echoing it must re-encode to the ORIGINAL bytes, not raise
    UnicodeEncodeError after dispatch (the client would hang with no
    response)."""
    cli, _srv = legacy_server
    weird = b"\xff\xfelabel"
    assert cli.call("set_label", NAME, weird) in (True, False)
    labels = cli.call("get_labels", NAME)
    assert weird in set(labels)


def test_legacy_binary_datum_through_proxy():
    """The binary-datum fix must survive the proxy hop: the proxy decodes
    with surrogateescape and its forwarding client must re-encode the
    original bytes (a UnicodeEncodeError in RpcClient.call must not be
    taken for a dead backend). The proxy runs
    with NO flags — autodetection must recognize the old client."""
    from jubatus_tpu_torch.coord.memory import MemoryCoordinator, _Store
    from jubatus_tpu_torch.server.proxy import Proxy, ProxyArgs

    store = _Store()
    args = ServerArgs(engine="classifier", coordinator="(shared)",
                      name=NAME, listen_addr="127.0.0.1",
                      interval_sec=1e9, interval_count=1 << 30)
    srv = EngineServer("classifier", CLASSIFIER_CONF, args, device="cpu",
                       coord=MemoryCoordinator(store))
    srv.start(0)
    proxy = Proxy(ProxyArgs(engine="classifier", listen_addr="127.0.0.1"),
                  coord=MemoryCoordinator(store))
    proxy.start(0)
    cli = LegacyClient("127.0.0.1", proxy.args.rpc_port)
    try:
        blob = bytes(range(256))
        n = cli.call("train", NAME, [
            ["spam", [[["subject", "buy now"]], [], [["payload", blob]]]],
        ])
        assert n == 1
        assert cli.call("get_labels", NAME)  # proxy + backend still alive
    finally:
        cli.close()
        proxy.stop()
        srv.stop()


def test_scan_is_legacy_matches_unpackb_verdict():
    """The skip-style fingerprint must agree with the full legacy decoder
    on every shape: legal-legacy buffers scan True, any post-2013 type
    byte scans False, truncation scans False."""
    legal = [None, True, 0, -5, 2**40, 0.5, "s", "y" * 31, "z" * 70000,
             [1, [2, "three"]], {"k": [1.5, None]}, list(range(40)),
             [0, 1, "train", ["c", [["lb", [[["k", "v"]], [["n", 1.0]]]]]]]]
    for v in legal:
        buf = msgpack.packb(v, use_bin_type=False)
        assert legacy.scan_is_legacy(buf), v
        for cut in range(1, len(buf)):
            assert not legacy.scan_is_legacy(buf[:cut])
    modern = [b"\x00" * 4, "z" * 40, ["x", b"\x01"], {"k": "w" * 64}]
    for v in modern:
        buf = msgpack.packb(v, use_bin_type=True)
        assert not legacy.scan_is_legacy(buf), v
    # hostile: huge claimed array length must not loop forever
    assert not legacy.scan_is_legacy(b"\xdd\x7f\xff\xff\xff" + b"\x01" * 8)


# -- parity with the JAX package ----------------------------------------------

def _seeded_values(seed, n=60):
    """Seeded nested values: ints at every msgpack width boundary, floats,
    raw strings around the fixraw/raw16/raw32 limits, bytes, lists and
    maps, nested a few levels."""
    import numpy as np

    rng = np.random.default_rng(seed)
    ints = [0, 1, 127, 128, 255, 256, 65535, 65536, 2**32 - 1, 2**32,
            2**63 - 1, 2**64 - 1, -1, -32, -33, -128, -129, -32768, -32769,
            -2**31, -2**31 - 1, -2**63]
    lens = [0, 1, 31, 32, 33, 255, 256, 65535, 65536]

    def leaf():
        k = int(rng.integers(0, 6))
        if k == 0:
            return ints[int(rng.integers(0, len(ints)))]
        if k == 1:
            return float(rng.normal() * 10 ** int(rng.integers(-3, 9)))
        if k == 2:
            return "s" * int(rng.choice(lens))
        if k == 3:
            return bytes(rng.integers(0, 256, int(rng.choice(lens[:6])),
                                      dtype=np.uint8))
        if k == 4:
            return bool(rng.integers(0, 2))
        return None

    def value(depth):
        k = int(rng.integers(0, 3)) if depth < 3 else 0
        if k == 0:
            return leaf()
        if k == 1:
            return [value(depth + 1)
                    for _ in range(int(rng.choice([0, 1, 15, 16, 17])))]
        return {f"k{int(rng.integers(0, 1000))}" + "x" * int(
            rng.choice([0, 40])): value(depth + 1)
            for _ in range(int(rng.choice([0, 1, 15, 16, 17])))}

    return [value(0) for _ in range(n)]


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_packb_bytes_equal_the_jax_legacy_response(seed):
    from jubatus_tpu.rpc.server import build_response as jbuild

    for i, v in enumerate(_seeded_values(seed)):
        want = jbuild(i, None, v, legacy=True)
        assert legacy.packb([1, i, None, v]) == want
        assert build_response(i, None, v, legacy=True) == want
        assert build_response(i, None, v) == jbuild(i, None, v)
        legacy.unpackb(want)  # the old unpacker takes every answer


@pytest.mark.parametrize("seed", [3, 4])
def test_scan_is_legacy_verdicts_equal_the_jax_package(seed):
    import numpy as np

    from jubatus_tpu.rpc import legacy as jlegacy
    from jubatus_tpu.rpc.server import wire_is_legacy as jwire
    from jubatus_tpu_torch.rpc.server import wire_is_legacy

    rng = np.random.default_rng(seed)
    verdicts = []
    for v in _seeded_values(seed, n=40):
        for bin_type in (False, True):
            buf = msgpack.packb([0, 1, "train", [v]],
                                use_bin_type=bin_type)
            cuts = {len(buf)} | {int(c) for c in rng.integers(
                0, len(buf) + 1, size=4)}
            for cut in sorted(cuts):
                for budget in (8, 1 << 14):
                    got = legacy.scan_is_legacy(buf[:cut], budget)
                    assert got == jlegacy.scan_is_legacy(buf[:cut], budget)
                    verdicts.append(got)
            assert wire_is_legacy(buf) == jwire(buf)
    assert True in verdicts and False in verdicts


def test_legacy_session_answers_equal_the_jax_server(tmp_path, monkeypatch):
    """A legacy client runs the same session against an ``arow.json``
    classifier of each package: get_config, train and classify answer the
    same bytes, and get_status parses under the old unpacker with the
    same key set (backend rows apart)."""
    import json
    import os

    from jubatus_tpu.server import EngineServer as JEngineServer
    from jubatus_tpu.server.args import ServerArgs as JServerArgs
    from jubatus_tpu.utils import tracing as jtracing

    from jubatus_tpu_torch.utils import tracing

    monkeypatch.setenv("JUBATUS_TPU_NATIVE_RPC", "0")
    monkeypatch.setenv("JUBATUS_TPU_NATIVE_INGEST", "0")
    # get_status surfaces the process default registry's counters
    # (trace.counter.*) in both packages; earlier tests in this process
    # bump them in one package only (C10), so each package gets a fresh
    # default registry for this session
    monkeypatch.setattr(tracing, "_default", tracing.Registry())
    monkeypatch.setattr(jtracing, "_default", jtracing.Registry())
    path = os.path.join(os.path.dirname(__file__), "..", "config",
                        "classifier", "arow.json")
    with open(path) as f:
        conf = json.load(f)
    # no telemetry thread: a tick between calls would add the usage
    # ledger's capacity rows on one side only
    port_srv = EngineServer("classifier", conf, ServerArgs(
        engine="classifier", datadir=str(tmp_path / "p"), configpath=path,
        telemetry_interval=0), device="cpu")
    jax_srv = JEngineServer("classifier", conf, args=JServerArgs(
        engine="classifier", datadir=str(tmp_path / "j"), configpath=path,
        telemetry_interval=0))
    rows = [["spam", _datum([["subject", "win money now"]],
                            [["n", 1.0]])],
            ["ham", _datum([["subject", "meeting at noon"]],
                           [["n", -1.0]])]] * 4
    query = [_datum([["subject", "win money now"]], [["n", 0.5]]),
             _datum([["subject", "noon"]], [])]
    frames, status = [], []
    try:
        for srv in (port_srv, jax_srv):
            sock = socket.create_connection(("127.0.0.1", srv.start(0)),
                                            timeout=30)
            got = []
            for i, (method, params) in enumerate([
                    ("get_config", [NAME]), ("train", [NAME, rows]),
                    ("classify", [NAME, query]),
                    ("get_status", [NAME])]):
                sock.sendall(msgpack.packb([0, i, method, params],
                                           use_bin_type=False))
                frame, rest = _read_one_frame(sock)
                assert rest == b""
                got.append(frame)
            sock.close()
            frames.append(got[:3])
            kind, _, err, st = legacy.unpackb(got[3])
            assert kind == 1 and err is None
            (node,) = st.values()
            status.append({re.sub(rb"\d+", b"N", k) for k in node})
    finally:
        port_srv.stop()
        jax_srv.stop()
    assert frames[0] == frames[1]
    for frame in frames[0]:
        legacy.unpackb(frame)
    backend = re.compile(rb"^(runtime\.(jax|kernel_build)_|kernel\.|"
                         rb"argv\.device$|driver\.device$|fv\.memo)")
    port_keys = {k for k in status[0] if not backend.match(k)}
    jax_keys = {k for k in status[1] if not backend.match(k)}
    assert port_keys == jax_keys
