"""The port stands alone: importing every module of jubatus_tpu_torch
loads no jax module and nothing of jubatus_tpu, and its entry points run
on CUDA unless the CPU is asked for — without CUDA they raise."""

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
