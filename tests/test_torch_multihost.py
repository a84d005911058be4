"""The port's process world (jubatus_tpu_torch/parallel/multihost.py)
against the JAX package's (tests/test_multihost.py): the same endpoint
resolution through the coordination store, run through both packages,
then real gloo worlds of two ranks on this host."""

from __future__ import annotations

import pytest

from jubatus_tpu.coord.memory import MemoryCoordinator as JMemory
from jubatus_tpu.coord.memory import _Store as JStore
from jubatus_tpu.parallel import multihost as jmultihost
from jubatus_tpu_torch.coord.memory import MemoryCoordinator as TMemory
from jubatus_tpu_torch.coord.memory import _Store as TStore
from jubatus_tpu_torch.parallel import multihost

PKGS = {"jax": (jmultihost, JMemory, JStore),
        "torch": (multihost, TMemory, TStore)}

#: every multi-rank world here ends within this (the harness kills it)
WORLD_TIMEOUT = 60.0


@pytest.fixture(params=["jax", "torch"])
def pkg(request):
    return PKGS[request.param]


def test_single_host_noop(pkg):
    mh, _, _ = pkg
    assert mh.initialize() is False
    assert mh.initialize(num_processes=1,
                         coordinator_address="x:1") is False


def test_process0_requires_address(pkg):
    mh, Memory, Store = pkg
    with pytest.raises(ValueError):
        mh.initialize(coord=Memory(Store()), process_id=0, num_processes=4)


def test_single_host_never_polls_or_publishes(pkg):
    mh, Memory, Store = pkg
    coord = Memory(Store())
    assert mh.initialize(coordinator_address="10.0.0.1:8476",
                         coord=coord, process_id=0,
                         num_processes=1) is False
    assert coord.read(mh.JAX_COORD_PATH) is None


def test_publish_endpoint_and_failure(pkg):
    mh, Memory, Store = pkg
    coord = Memory(Store())
    mh.publish_endpoint(coord, "10.0.0.1:8476")
    assert coord.read(mh.JAX_COORD_PATH) == b"10.0.0.1:8476"
    coord.close()
    with pytest.raises(RuntimeError, match="publish"):
        mh.publish_endpoint(coord, "10.0.0.1:9999")  # closed session


def test_worker_resolves_endpoint_from_store(pkg):
    mh, Memory, Store = pkg
    store = Store()
    mh.publish_endpoint(Memory(store), "10.0.0.1:8476")
    assert mh.initialize(coord=Memory(store), process_id=3,
                         num_processes=1) is False


def test_worker_times_out_loudly(pkg):
    """No published endpoint → raise, never a silent single-host split."""
    mh, Memory, Store = pkg
    with pytest.raises(TimeoutError, match="process 0"):
        mh.initialize(coord=Memory(Store()), process_id=2,
                      num_processes=4, resolve_timeout=0.1)


def test_endpoint_is_ephemeral(pkg):
    """A dead process 0's endpoint must vanish with its session."""
    mh, Memory, Store = pkg
    store = Store()
    p0 = Memory(store)
    mh.publish_endpoint(p0, "10.0.0.1:8476")
    p0.close()
    assert Memory(store).read(mh.JAX_COORD_PATH) is None


def test_collective_capabilities_single_host():
    """The same keys as the JAX package's probe; a world of one can ride
    the int8 transport (no point-to-point sends needed)."""
    caps = multihost.collective_capabilities()
    jcaps = jmultihost.collective_capabilities()
    assert set(caps) == set(jcaps)
    assert caps["world"] == 1
    assert caps["distributed"] is False
    assert caps["quantized_transport"] is True
    assert caps["backend"] == "cpu"
    assert caps["topology"] == f"1x{caps['local_devices']}"
    assert multihost.wire_device().type == "cpu"


_JOIN = r"""
import sys, time
import torch, torch.distributed as dist
torch.set_num_threads(2)
from jubatus_tpu_torch.coord import create_coordinator
from jubatus_tpu_torch.parallel import multihost
rank, n, port, coord_dir, mode = (int(sys.argv[1]), int(sys.argv[2]),
                                  sys.argv[3], sys.argv[4], sys.argv[5])
coord = create_coordinator("file://" + coord_dir)
# rank 0 publishes its rendezvous address; the others find it there
addr = f"127.0.0.1:{port}" if rank == 0 else None
assert multihost.initialize(coordinator_address=addr, num_processes=n,
                            process_id=rank, coord=coord, device="cpu",
                            timeout=5.0) is True
assert multihost.initialize(num_processes=n) is False  # already joined
caps = multihost.collective_capabilities()
assert caps["backend"] == "gloo" and caps["world"] == n, caps
assert caps["distributed"] and caps["topology"] == f"{n}x1", caps
assert multihost.rank_hosts() == [multihost.socket.gethostname()] * n
x = torch.full((3,), float(rank + 1))
dist.all_reduce(x)
assert x.tolist() == [n * (n + 1) / 2] * 3, x
if mode == "dead" and rank == 1:
    import os
    os._exit(0)  # a peer dies: rank 0's next collective must raise
if mode == "dead":
    t0 = time.monotonic()
    try:
        dist.all_reduce(torch.ones(3))
        raise SystemExit("a collective with a dead peer returned")
    except Exception as e:
        print("RAISED", type(e).__name__, round(time.monotonic() - t0, 1))
multihost.shutdown()
assert not multihost.is_initialized()
print("RANK-OK", rank, flush=True)
"""


def test_two_rank_gloo_world_joins_through_the_coordinator(tmp_path):
    """A CPU world of two ranks: rank 0 publishes its rendezvous in the
    file coordinator, rank 1 resolves it there; the group is gloo, the
    capabilities name it, and an all-reduce sums across the ranks."""
    outs, rcs = multihost.run_local_world(
        _JOIN, 2, args=(str(tmp_path), "ok"), timeout=WORLD_TIMEOUT)
    for r, (out, rc) in enumerate(zip(outs, rcs)):
        assert rc == 0 and f"RANK-OK {r}" in out, out[-2000:]


def test_dead_peer_raises_within_the_bounded_timeout(tmp_path):
    """The group's timeout bounds a collective whose peer died: rank 0
    raises instead of wedging (the collective mixer's failure model)."""
    outs, rcs = multihost.run_local_world(
        _JOIN, 2, args=(str(tmp_path), "dead"), timeout=WORLD_TIMEOUT)
    assert rcs[1] == 0, outs[1][-2000:]
    assert rcs[0] == 0 and "RAISED" in outs[0], outs[0][-2000:]
    waited = float(outs[0].split("RAISED")[1].split()[1])
    assert waited < 30.0, outs[0]


def test_run_local_world_kills_a_hung_world():
    """The harness's bound: a rank that never ends is killed and reported
    with no exit code."""
    outs, rcs = multihost.run_local_world(
        "import sys, time\nprint('UP', flush=True)\n"
        "time.sleep(0 if sys.argv[1] == '0' else 600)\n", 2, timeout=5.0)
    assert rcs[0] == 0 and rcs[1] is None
    assert all("UP" in o for o in outs)
