"""The port stands alone: importing every module of jubatus_tpu_torch
loads no jax module and nothing of jubatus_tpu, its native libraries
build under build/torch_native/ and never under native/, and its entry
points run on CUDA unless the CPU is asked for — without CUDA they
raise."""

from __future__ import annotations

import os
import subprocess
import sys

import pytest
import torch

ROOT = os.path.join(os.path.dirname(__file__), "..")

_PROBE = r"""
import importlib, pkgutil, sys
import jubatus_tpu_torch
names = [m.name for m in pkgutil.walk_packages(jubatus_tpu_torch.__path__,
                                               "jubatus_tpu_torch.")]
for name in names:
    importlib.import_module(name)
bad = sorted(m for m in sys.modules
             if m == "jax" or m.startswith(("jax.", "jaxlib"))
             or m == "jubatus_tpu" or m.startswith("jubatus_tpu."))
print(len(names))
print(",".join(bad))
print(",".join(names))
"""

#: modules each slice added; the walk above must reach every one of them
SLICE_MODULES = (
    "jubatus_tpu_torch.models.recommender",
    "jubatus_tpu_torch.models.anomaly",
    "jubatus_tpu_torch.models.classifier_nn",
    "jubatus_tpu_torch.core.fv.hashing",
    "jubatus_tpu_torch.core.fv.converter",
    "jubatus_tpu_torch.core.row_store",
    "jubatus_tpu_torch.ops.knn",
    "jubatus_tpu_torch.models._nn_backend",
    "jubatus_tpu_torch.server.factory",
    "jubatus_tpu_torch.server.service",
    "jubatus_tpu_torch.rpc.client",
    "jubatus_tpu_torch.convert",
    "jubatus_tpu_torch.ops.classifier",
    "jubatus_tpu_torch.ops.regression",
    "jubatus_tpu_torch.ops.online_scan",
    "jubatus_tpu_torch.ops._build",
    "jubatus_tpu_torch.models.classifier",
    "jubatus_tpu_torch.models.regression",
    "jubatus_tpu_torch.server.microbatch",
    "jubatus_tpu_torch.ops.clustering",
    "jubatus_tpu_torch.models.clustering",
    "jubatus_tpu_torch.models.graph",
    "jubatus_tpu_torch.models.stat",
    "jubatus_tpu_torch.models.bandit",
    "jubatus_tpu_torch.models.burst",
    "jubatus_tpu_torch.models.weight",
    "jubatus_tpu_torch.utils.serialization",
    "jubatus_tpu_torch.utils.events",
    "jubatus_tpu_torch.utils.faults",
    "jubatus_tpu_torch.utils.tracing",
    "jubatus_tpu_torch.utils.tree",
    "jubatus_tpu_torch.utils.disk",
    "jubatus_tpu_torch.version",
    "jubatus_tpu_torch.framework.save_load",
    "jubatus_tpu_torch.framework.model_guard",
    "jubatus_tpu_torch.framework.mixer",
    "jubatus_tpu_torch.framework.linear_mixer",
    "jubatus_tpu_torch.coord",
    "jubatus_tpu_torch.coord.base",
    "jubatus_tpu_torch.coord.memory",
    "jubatus_tpu_torch.coord.file",
    "jubatus_tpu_torch.coord.membership",
    "jubatus_tpu_torch.coord.idgen",
    "jubatus_tpu_torch.coord.cht",
    "jubatus_tpu_torch.rpc.breaker",
    "jubatus_tpu_torch.parallel.mix",
    "jubatus_tpu_torch.framework.idl",
    "jubatus_tpu_torch.framework.migration",
    "jubatus_tpu_torch.framework.push_mixer",
    "jubatus_tpu_torch.framework.async_mixer",
    "jubatus_tpu_torch.framework.model_store",
    "jubatus_tpu_torch.rpc.errors",
    "jubatus_tpu_torch.rpc.server",
    "jubatus_tpu_torch.rpc.deadline",
    "jubatus_tpu_torch.rpc.principal",
    "jubatus_tpu_torch.rpc.retry",
    "jubatus_tpu_torch.rpc.aggregators",
    "jubatus_tpu_torch.coord.journal",
    "jubatus_tpu_torch.coord.server",
    "jubatus_tpu_torch.coord.remote",
    "jubatus_tpu_torch.cmd",
    "jubatus_tpu_torch.cmd.jubaconfig",
    "jubatus_tpu_torch.cmd.jubavisor",
    "jubatus_tpu_torch.cmd.jubactl",
    "jubatus_tpu_torch.server.proxy",
    "jubatus_tpu_torch.parallel.mesh",
    "jubatus_tpu_torch.parallel.row_store",
    "jubatus_tpu_torch.parallel.sharded_knn",
    "jubatus_tpu_torch.parallel.sharded_ivf",
    "jubatus_tpu_torch.parallel.sharded_model",
    "jubatus_tpu_torch.ops.ivf",
    "jubatus_tpu_torch.parallel.multihost",
    "jubatus_tpu_torch.parallel.collective",
    "jubatus_tpu_torch.parallel.spmd",
    "jubatus_tpu_torch.framework.collective_mixer",
    "jubatus_tpu_torch.utils.slowlog",
    "jubatus_tpu_torch.utils.metrics_http",
    "jubatus_tpu_torch.utils.runtime_telemetry",
    "jubatus_tpu_torch.utils.profiler",
    "jubatus_tpu_torch.framework.sharded_checkpoint",
    "jubatus_tpu_torch.cmd.jubadump",
    "jubatus_tpu_torch.utils.logger",
    "jubatus_tpu_torch.utils.sketches",
    "jubatus_tpu_torch.utils.timeseries",
    "jubatus_tpu_torch.utils.slo",
    "jubatus_tpu_torch.utils.quality",
    "jubatus_tpu_torch.utils.usage",
    "jubatus_tpu_torch.utils.incidents",
    "jubatus_tpu_torch.core.fv.plugins",
    "jubatus_tpu_torch.plugins",
    "jubatus_tpu_torch.plugins.ux_splitter",
    "jubatus_tpu_torch.plugins.image_feature",
    "jubatus_tpu_torch.plugins.mecab_splitter",
    "jubatus_tpu_torch.native",
    "jubatus_tpu_torch.coord.controller",
    "jubatus_tpu_torch.coord.autoscaler",
    "jubatus_tpu_torch.coord.perf_tuner",
    "jubatus_tpu_torch.rpc.legacy",
    "jubatus_tpu_torch.coord.zk",
    "jubatus_tpu_torch.client",
    "jubatus_tpu_torch.cmd.jubaconv",
    "jubatus_tpu_torch.launch",
    "jubatus_tpu_torch.codegen",
    "jubatus_tpu_torch.codegen.parser",
    "jubatus_tpu_torch.codegen.emit",
    "jubatus_tpu_torch.codegen.emit_cpp",
    "jubatus_tpu_torch.codegen.emit_clients",
    "jubatus_tpu_torch.parallel",
    "jubatus_tpu_torch.parallel.ring",
    "jubatus_tpu_torch.native.ingest",
    "jubatus_tpu_torch.rpc.native_server",
)


def test_importing_every_module_loads_no_jax_and_no_reference():
    env = dict(os.environ)
    env.pop("PYTHONPATH", None)
    proc = subprocess.run([sys.executable, "-c", _PROBE], cwd=ROOT, env=env,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr
    lines = proc.stdout.splitlines()
    assert int(lines[0]) >= 30
    assert lines[1] == "", f"imported: {lines[1]}"
    walked = set(lines[2].split(","))
    assert not set(SLICE_MODULES) - walked


_PLANES_PROBE = r"""
import os, sys, tempfile
from jubatus_tpu_torch.core.datum import Datum
from jubatus_tpu_torch.core.fv.converter import make_fv_converter
from jubatus_tpu_torch.rpc.client import RpcClient
from jubatus_tpu_torch.server import EngineServer
from jubatus_tpu_torch.server.args import ServerArgs
d = tempfile.mkdtemp()
kw = os.path.join(d, "kw.txt")
open(kw, "w").write("tpu\nbat\n")
conv = {"string_types": {"ux": {"method": "dynamic", "path": "ux_splitter",
                                "dict_path": kw}},
        "string_rules": [{"key": "*", "type": "ux", "sample_weight": "bin",
                          "global_weight": "bin"}]}
print(len(make_fv_converter(conv).convert(Datum({"t": "jubatus tpu"}))))
plug = [m for m in sys.modules if m.startswith("jubatus_tpu_torch_plugin_")]
print(sys.modules[plug[0]].__file__)
srv = EngineServer("classifier", {"method": "AROW", "converter": conv,
                                  "parameter": {"regularization_weight": 1}},
                   ServerArgs(engine="classifier", listen_addr="127.0.0.1",
                              quality_sample=1.0, telemetry_interval=0,
                              datadir=d), device="cpu")
port = srv.start(0)
with RpcClient("127.0.0.1", port) as c:
    c.call("train", "", [["a", Datum({"t": "tpu bat"}).to_msgpack()]])
    srv._model_health_tick()
    for m in ("get_quality", "get_usage", "get_alerts", "get_timeseries"):
        c.call(m, "")
    c.call("get_events", "", 0, "")
    c.call("get_incidents", "", "")
srv.stop()
print(",".join(sorted(m for m in sys.modules
                      if m == "jax" or m.startswith(("jax.", "jaxlib"))
                      or m == "jubatus_tpu" or m.startswith("jubatus_tpu.")
                      or m in ("cv2", "MeCab"))))
"""


def test_plugins_and_planes_load_nothing_of_jax_or_the_reference():
    """A bare-name plugin resolves to the port's own plugin file, and a
    server with every new plane on answers their RPCs, and still neither
    jax, jubatus_tpu nor an optional plugin library is imported."""
    env = dict(os.environ)
    env.pop("PYTHONPATH", None)
    proc = subprocess.run([sys.executable, "-c", _PLANES_PROBE], cwd=ROOT,
                          env=env, capture_output=True, text=True,
                          timeout=180)
    assert proc.returncode == 0, proc.stderr
    n, plugin_file, bad = proc.stdout.splitlines()[-3:]
    assert n == "2"  # "tpu", and "bat" inside "jubatus"
    assert os.path.samefile(plugin_file, os.path.join(
        ROOT, "jubatus_tpu_torch", "plugins", "ux_splitter.py"))
    assert bad == "", f"imported: {bad}"


_NATIVE_PROBE = r"""
import os, sys
from pathlib import Path
from jubatus_tpu_torch import native
from jubatus_tpu_torch.native import ingest
from jubatus_tpu_torch.rpc.native_server import NativeRpcServer
from jubatus_tpu_torch.server import EngineServer
from jubatus_tpu_torch.server.args import ServerArgs
print(native.BUILD_DIR)
native.BUILD_DIR = Path(sys.argv[1])
conf = {"method": "AROW", "parameter": {"regularization_weight": 1.0},
        "converter": {"num_rules": [{"key": "*", "type": "num"}]}}
srv = EngineServer("classifier", conf, ServerArgs(
    engine="classifier", listen_addr="127.0.0.1", telemetry_interval=0),
    device="cpu")
srv.start(0)
print("train" in srv.rpc._raw_methods, native.crc32(b"x"),
      isinstance(srv.rpc, NativeRpcServer))
srv.stop()
print(",".join(sorted(m for m in sys.modules
                      if m == "jax" or m.startswith(("jax.", "jaxlib"))
                      or m == "jubatus_tpu" or m.startswith("jubatus_tpu."))))
"""


def _tree(path):
    out = {}
    for d, _dirs, files in os.walk(path):
        for f in files:
            p = os.path.join(d, f)
            out[p] = os.stat(p).st_mtime_ns
    return out


def test_native_build_writes_only_under_build_torch_native(tmp_path):
    """The native ingest parser, jt_native and the RPC front-end build
    into build/torch_native/ by default; a build (here into a fresh
    directory, so it really runs) writes its libraries there and nothing
    under native/, and a server on the raw path and the native transport
    loads nothing of jax."""
    env = dict(os.environ)
    env.pop("PYTHONPATH", None)
    before = _tree(os.path.join(ROOT, "native"))
    out = tmp_path / "torch_native"
    proc = subprocess.run([sys.executable, "-c", _NATIVE_PROBE, str(out)],
                          cwd=ROOT, env=env, capture_output=True, text=True,
                          timeout=300)
    assert proc.returncode == 0, proc.stderr
    default, served, bad = proc.stdout.splitlines()[-3:]
    assert os.path.samefile(os.path.dirname(default),
                            os.path.join(ROOT, "build"))
    assert os.path.basename(default) == "torch_native"
    assert served.split()[0] == "True" and served.split()[2] == "True"
    assert bad == "", f"imported: {bad}"
    built = sorted(p.name for p in out.iterdir())
    assert [n.split("_")[0] for n in built] == ["libfast", "libjt",
                                               "librpc"]
    assert all(n.endswith(".so") for n in built)
    assert _tree(os.path.join(ROOT, "native")) == before


_TELEMETRY_PROBE = r"""
import torch
from jubatus_tpu_torch.utils.runtime_telemetry import RuntimeTelemetry
from jubatus_tpu_torch.utils.tracing import Registry
rt = RuntimeTelemetry(Registry(), interval_sec=0.01)
s = rt.sample()
rt.start()
rt.status()
rt.stop()
print(torch.cuda.is_initialized(), sorted(k for k in s if "torch_" in k),
      "kernel_build_count" in s)
"""


def test_telemetry_sample_never_initializes_cuda():
    """A process that never used CUDA (jubactl, jubadump, jubacoordd) pays
    no CUDA context for its telemetry: the sample reads the card only once
    CUDA is initialized, and carries no torch_* key before."""
    env = dict(os.environ)
    env.pop("PYTHONPATH", None)
    proc = subprocess.run([sys.executable, "-c", _TELEMETRY_PROBE], cwd=ROOT,
                          env=env, capture_output=True, text=True,
                          timeout=120)
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout.split() == ["False", "[]", "True"]


_PROXY_PROBE = r"""
import sys, time
import torch
from jubatus_tpu_torch.cmd import jubactl
from jubatus_tpu_torch.coord.memory import MemoryCoordinator, _Store
from jubatus_tpu_torch.rpc.client import RpcClient
from jubatus_tpu_torch.server.proxy import Proxy, ProxyArgs
from jubatus_tpu_torch.utils import tracing
store = _Store()
p = Proxy(ProxyArgs(engine="classifier", listen_addr="127.0.0.1",
                    metrics_port=0, telemetry_interval=0.05,
                    slo=["latency:rpc.classify:p99:1"]),
          coord=MemoryCoordinator(store))
p.start(0)
time.sleep(0.3)
p._model_health_tick()
p.telemetry.sample()
with tracing.use_trace(tracing.new_root()), \
        RpcClient("127.0.0.1", p.args.rpc_port) as c:
    for m in ("get_proxy_status", "get_usage", "get_timeseries", "get_alerts",
              "get_quality", "get_slow_log", "get_incidents"):
        c.call(m, "x", *(("",) if m == "get_incidents" else ()))
    c.call("get_profile", "x", 0.0)
    c.call("get_events", "x", 0, "")
jubactl.render_watch_frame({"nodes": {}, "proxies": {}})
p.stop()
bad = sorted(m for m in sys.modules
             if m == "jax" or m.startswith(("jax.", "jaxlib"))
             or m == "jubatus_tpu" or m.startswith("jubatus_tpu."))
print(torch.cuda.is_initialized(), ",".join(bad) or "-")
"""


def test_proxy_planes_never_initialize_cuda():
    """A proxy with every plane on (telemetry ticks, SLOs, /metrics, the
    usage ledger's capacity tick, the stack sampler) answering each
    forensics RPC creates no CUDA context and loads nothing of jax."""
    env = dict(os.environ)
    env.pop("PYTHONPATH", None)
    proc = subprocess.run([sys.executable, "-c", _PROXY_PROBE], cwd=ROOT,
                          env=env, capture_output=True, text=True,
                          timeout=180)
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout.split() == ["False", "-"]


@pytest.fixture
def no_cuda():
    if torch.cuda.is_available():
        pytest.skip("CUDA is present: the default device is usable here")


def test_backend_without_device_raises_without_cuda(no_cuda):
    from jubatus_tpu_torch.models._nn_backend import NNBackend

    with pytest.raises(RuntimeError, match="CUDA is not available"):
        NNBackend("lsh", dim=1 << 10)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        NNBackend("lsh", dim=1 << 10, device="cuda")
    assert NNBackend("lsh", dim=1 << 10, device="cpu").device.type == "cpu"


def test_driver_and_server_without_device_raise_without_cuda(no_cuda):
    from jubatus_tpu_torch.models.nearest_neighbor import NearestNeighborDriver
    from jubatus_tpu_torch.server import EngineServer

    conf = {"method": "lsh", "parameter": {"hash_num": 64}}
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        NearestNeighborDriver(conf)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        EngineServer("nearest_neighbor", conf)


def test_server_main_without_device_fails_without_cuda(no_cuda):
    proc = subprocess.run(
        [sys.executable, "-m", "jubatus_tpu_torch.server", "nearest_neighbor",
         "--config-test", "-f", os.path.join(ROOT, "config",
                                             "nearest_neighbor", "lsh.json")],
        cwd=ROOT, capture_output=True, text=True, timeout=120)
    assert proc.returncode == 1
    assert "CUDA is not available" in proc.stderr


@pytest.mark.parametrize("argv", [
    ["jubatus_tpu_torch.cmd.jubavisor", "-z", "memory", "-p", "0"],
    ["jubatus_tpu_torch.cmd.jubaconfig", "-c", "write", "-t",
     "nearest_neighbor", "-n", "x", "-z", "memory", "-f",
     os.path.join(ROOT, "config", "nearest_neighbor", "lsh.json")],
])
def test_new_entry_points_default_to_cuda(no_cuda, argv):
    """The visor's children and jubaconfig's dry validation run on cuda
    unless --device cpu is passed: without CUDA the visor refuses to
    start a child on the CPU by itself (its --device default is cuda) and
    jubaconfig rejects the config."""
    if argv[0].endswith("jubavisor"):
        from jubatus_tpu_torch.cmd.jubavisor import Jubavisor

        assert Jubavisor("memory").device == "cuda"
        return
    proc = subprocess.run([sys.executable, "-m", *argv], cwd=ROOT,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 1
    assert "CUDA is not available" in proc.stderr


def test_chip_smoke_refuses_to_run_without_cuda(no_cuda):
    proc = subprocess.run([sys.executable, "chip_smoke.py"], cwd=ROOT,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode != 0
    assert '"ok"' not in proc.stdout


@pytest.mark.parametrize("extra,own", [((), False),
                                       (("-d", "given"), True),
                                       (("--datadir", "given"), True)])
def test_chip_smoke_servers_keep_their_files_in_the_output_dir(
        monkeypatch, tmp_path, extra, own):
    """Every server chip_smoke.py starts gets a datadir of its own under
    its output directory (incident bundles and captures go there), unless
    the caller names one."""
    sys.path.insert(0, ROOT)
    try:
        import chip_smoke as cs
    finally:
        sys.path.remove(ROOT)
    seen = []

    def popen(cmd, **_kw):
        seen.append(cmd)
        return None

    monkeypatch.setattr(cs, "OUT_DIR", str(tmp_path))
    monkeypatch.setattr(cs.subprocess, "Popen", popen)
    _proc, port, _log = cs.start_server("classifier", "cfg.json", "_t",
                                        extra=extra)
    (cmd,) = seen
    flags = [i for i, a in enumerate(cmd) if a in ("-d", "--datadir")]
    assert len(flags) == 1
    datadir = cmd[flags[0] + 1]
    if own:
        assert datadir == "given"
        return
    assert datadir == os.path.join(str(tmp_path), "data",
                                   f"classifier_t_{port}")
    assert os.path.isdir(datadir) and not os.listdir(datadir)


@pytest.mark.parametrize("engine,conf", [
    ("recommender", {"method": "inverted_index"}),
    ("anomaly", {"method": "lof", "parameter": {"method": "lsh"}}),
    ("classifier", {"method": "cosine"}),
    ("classifier", {"method": "AROW"}),
    ("regression", {"method": "PA1"}),
    ("clustering", {"method": "kmeans"}),
    ("graph", {"method": "graph_wo_index"}),
    ("stat", {"window_size": 8}),
    ("bandit", {"method": "ucb1"}),
    ("burst", {"parameter": {}}),
    ("weight", {}),
])
def test_new_engines_without_device_raise_without_cuda(no_cuda, engine, conf):
    from jubatus_tpu_torch.server import EngineServer
    from jubatus_tpu_torch.server.factory import create_driver

    with pytest.raises(RuntimeError, match="CUDA is not available"):
        create_driver(engine, conf)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        EngineServer(engine, conf)
    assert create_driver(engine, conf, device="cpu").device.type == "cpu"
