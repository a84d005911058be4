"""The port's usage ledger (``jubatus_tpu_torch/utils/usage.py``) on a
live server, mirroring ``tests/test_usage_attribution.py``'s server cases:
tagged traffic bills per tenant, untagged traffic bills ``(untagged)``,
``get_usage`` serves the mergeable doc, the ledger's CPU books equal the
span plane's, and ``get_status`` carries the ``usage.*`` rows. Parity: a
JAX server and a port server fed the same stream bill the same requests,
rows and bytes to each tenant."""

from __future__ import annotations

import pytest

from jubatus_tpu_torch.core.datum import Datum
from jubatus_tpu_torch.rpc import principal as principals
from jubatus_tpu_torch.rpc.client import ClassifierClient, RpcClient
from jubatus_tpu_torch.server import EngineServer
from jubatus_tpu_torch.server.args import ServerArgs
from jubatus_tpu_torch.utils import usage as usage_mod

CONF = {"method": "PA", "converter": {
    "num_rules": [{"key": "*", "type": "num"}]}}


def _server(**flags):
    srv = EngineServer("classifier", CONF, ServerArgs(
        engine="classifier", listen_addr="127.0.0.1", telemetry_interval=0,
        **flags), device="cpu")
    srv.start(0)
    return srv


def test_server_bills_tenants_and_serves_get_usage():
    srv = _server()
    port = srv.rpc.port
    try:
        rows = [["a", Datum({"x": 1.0}).to_msgpack()]]
        with principals.use("checkout"):
            with ClassifierClient("127.0.0.1", port, "") as c:
                for _ in range(5):
                    c.train(rows)
                c.classify([Datum({"x": 1.0}).to_msgpack()])
        with ClassifierClient("127.0.0.1", port, "") as c:
            c.train(rows)  # untagged stream

        doc = srv.usage.snapshot()
        table = doc["table"]
        assert "checkout" in table and "train" in table["checkout"]
        assert table["checkout"]["train"][0] >= 5   # requests
        assert table["checkout"]["train"][usage_mod.FIELDS.index("rows")] \
            == 5   # the coalescer billed each ticket's rows
        assert "(untagged)" in table
        tot = srv.usage.totals()
        assert tot["bytes_in"] > 0 and tot["bytes_out"] > 0
        # conservation: the ledger's CPU books equal the span plane's
        hists = srv.trace.snapshot()["hists"]
        span_s = sum(h["total_s"] for n, h in hists.items()
                     if n.startswith("rpc.") and
                     not n.startswith("rpc.client."))
        assert tot["cpu_seconds"] == pytest.approx(span_s, rel=1e-6)
        # the RPC view is the same doc, keyed by node
        with RpcClient("127.0.0.1", port, timeout=10) as rc:
            served = rc.call("get_usage", "")
        (served_doc,) = served.values()
        assert "checkout" in served_doc["table"]
        # fold two node docs: cells SUM, capacity sums — never averages
        fleet = usage_mod.merge_usage([doc, served_doc])
        folded = dict(usage_mod.principal_rows(fleet))
        assert folded["checkout"]["requests"] >= \
            2 * table["checkout"]["train"][0]
    finally:
        srv.stop()


def test_get_status_carries_usage_rows():
    srv = _server()
    try:
        with principals.use("ads"):
            with ClassifierClient("127.0.0.1", srv.rpc.port, "") as c:
                c.train([["a", Datum({"x": 1.0}).to_msgpack()]])
        srv.usage.tick(0.0)
        with RpcClient("127.0.0.1", srv.rpc.port, timeout=10) as rc:
            st = next(iter(rc.call("get_status", "").values()))
        assert st["usage.principals"] >= 1
        assert st["usage.top_principal"]
    finally:
        srv.stop()


def test_usage_top_zero_disarms_the_ledger():
    srv = _server(usage_top=0)
    try:
        assert srv.usage is None and srv.rpc.usage_recorder is None
        assert srv.trace.usage_sink is None
        assert srv.get_usage() == {srv._node_key(): {}}
        assert srv.coalescers["train"].usage_hook is None
    finally:
        srv.stop()


def test_failed_call_bills_an_error_to_its_tenant():
    srv = _server()
    try:
        with principals.use("bad"), \
                RpcClient("127.0.0.1", srv.rpc.port, timeout=10) as rc:
            with pytest.raises(Exception):
                rc.call("train", "", [["a", "not a datum"]])
        errors = usage_mod.FIELDS.index("errors")
        assert srv.usage.snapshot()["table"]["bad"]["train"][errors] == 1
    finally:
        srv.stop()


def test_parity_usage_rows_with_the_jax_server(monkeypatch):
    """Two tenants' train streams into a JAX server and a port server:
    each tenant's requests, errors, rows and bytes in and out are equal;
    the seconds are each server's own."""
    from jubatus_tpu.server import EngineServer as JServer
    from jubatus_tpu.server.args import ServerArgs as JArgs

    monkeypatch.setenv("JUBATUS_TPU_NATIVE_RPC", "0")
    monkeypatch.setenv("JUBATUS_TPU_NATIVE_INGEST", "0")
    jsrv = JServer("classifier", CONF, args=JArgs(
        engine="classifier", listen_addr="127.0.0.1", telemetry_interval=0,
        quality_sample=1.0))
    jsrv.start(0)
    psrv = _server(quality_sample=1.0)
    sent = {"tenant-a": 0, "tenant-b": 0}
    try:
        for port in (jsrv.rpc.port, psrv.rpc.port):
            for i in range(12):
                tenant = "tenant-a" if i % 3 else "tenant-b"
                batch = [["a" if (i + k) % 2 else "b",
                          Datum({"x": float(k - i)}).to_msgpack()]
                         for k in range(8 + i)]
                with principals.use(tenant), \
                        RpcClient("127.0.0.1", port, timeout=30) as rc:
                    assert rc.call("train", "", batch) == len(batch)
                if port == psrv.rpc.port:
                    sent[tenant] += len(batch)
        jtab = jsrv.usage.snapshot()["table"]
        ptab = psrv.usage.snapshot()["table"]
        exact = [usage_mod.FIELDS.index(f) for f in
                 ("requests", "errors", "rows", "bytes_in", "bytes_out")]
        for tenant, n in sent.items():
            prow, jrow = ptab[tenant]["train"], jtab[tenant]["train"]
            assert [prow[i] for i in exact] == [jrow[i] for i in exact]
            assert prow[usage_mod.FIELDS.index("rows")] == n
            for f in ("cpu_seconds", "queue_seconds", "device_seconds"):
                assert prow[usage_mod.FIELDS.index(f)] >= 0.0
            assert prow[usage_mod.FIELDS.index("cpu_seconds")] > 0.0
    finally:
        jsrv.stop()
        psrv.stop()
