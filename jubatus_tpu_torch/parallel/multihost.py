"""The process world of the collective mix plane (counterpart of
``jubatus_tpu/parallel/multihost.py`` on ``torch.distributed``).

``initialize()`` joins one ``torch.distributed`` world with the JAX
package's conventions: the rendezvous address comes from the flags
(``--jax-coordinator``) or from the coordination store, where process 0
publishes it under ``/jubatus/jax_coordinator`` as an ephemeral node, so
only process 0 needs static config. The names keep the JAX package's
spelling even though the runtime is torch, so a jubavisor's argv carries
over.

The backend: ``nccl`` when every rank owns a distinct CUDA device (each
rank sets its device to its index among the ranks of its host), ``gloo``
otherwise — a CPU world, or several ranks sharing one card (NCCL refuses
two ranks of one communicator on one GPU). gloo's buffers live on the
host. The ranks settle the choice together before the group exists: each
writes its hostname and CUDA device count into the rendezvous store, so
every rank computes the same answer. ``enable_cpu_collectives()`` forces
gloo (the JAX package's switch to gloo for CPU worlds keeps its name).

The group gets a bounded ``timeout``: gloo's default is 30 minutes, and
with it a dead peer would wedge the world instead of raising in the
peers' collectives, which the collective mixer's failure model relies on
(framework/collective_mixer.py).

A world of one, or one already initialized, is a no-op (False), so
servers call this unconditionally at boot.
"""

from __future__ import annotations

import datetime
import logging
import os
import socket
import subprocess
import sys
import tempfile
import time
from typing import Any, Dict, List, Optional, Sequence, Tuple, Union

import torch
import torch.distributed as dist

from jubatus_tpu_torch.coord.base import Coordinator

log = logging.getLogger(__name__)

JAX_COORD_PATH = "/jubatus/jax_coordinator"

#: the group's timeout when the caller names none (seconds)
DEFAULT_TIMEOUT_SEC = 60.0

#: what initialize() settled for this process: backend, the rank's device,
#: every rank's hostname (rank order)
_WORLD: Dict[str, Any] = {"force_gloo": False, "backend": None,
                          "device": None, "hosts": None}

#: subgroups made for rank lists, in creation order (new_group is called
#: for every list by every rank in the same order); emptied with the world
_GROUPS: Dict[Tuple[int, ...], Any] = {}


def enable_cpu_collectives() -> bool:
    """Select gloo for the next ``initialize`` whatever devices the ranks
    own. True when gloo is available (it always is in a torch build with
    distributed support)."""
    _WORLD["force_gloo"] = True
    return dist.is_available() and dist.is_gloo_available()


def is_initialized() -> bool:
    return dist.is_available() and dist.is_initialized()


def world_size() -> int:
    """Ranks in the world; 1 without one."""
    return dist.get_world_size() if is_initialized() else 1


def rank() -> int:
    return dist.get_rank() if is_initialized() else 0


def backend() -> str:
    """``nccl``, ``gloo``, or ``cpu`` without a world."""
    return str(dist.get_backend()) if is_initialized() else "cpu"


def wire_device() -> torch.device:
    """Where the world's collectives take their buffers: this rank's card
    under NCCL, the host under gloo (and without a world)."""
    if backend() == "nccl":
        dev = _WORLD.get("device")
        return dev if dev is not None else \
            torch.device("cuda", torch.cuda.current_device())
    return torch.device("cpu")


def local_devices() -> List[torch.device]:
    """The devices this process holds: the CUDA cards it sees, else the
    CPU once."""
    if torch.cuda.is_available() and torch.cuda.device_count() > 0:
        return [torch.device("cuda", i)
                for i in range(torch.cuda.device_count())]
    return [torch.device("cpu")]


def rank_hosts() -> List[str]:
    """Every rank's hostname in rank order (one exchange a process; the
    hostname alone without a world)."""
    hosts = _WORLD.get("hosts")
    if hosts is not None and len(hosts) == world_size():
        return list(hosts)
    if not is_initialized():
        return [socket.gethostname()]
    out: List[Any] = [None] * world_size()
    dist.all_gather_object(out, socket.gethostname())
    _WORLD["hosts"] = [str(h) for h in out]
    return list(_WORLD["hosts"])


def collective_capabilities() -> dict:
    """What the world can carry for the mix plane, with the JAX package's
    keys: ``backend`` (nccl / gloo / cpu), ``distributed`` (one world
    spans the fleet), ``world`` (ranks), ``local_devices`` (lanes this
    process contributes: one a rank in a world, its local devices alone),
    ``topology`` (``NxM``, ranks x local devices) and
    ``quantized_transport`` (the int8 ring's point-to-point sends are
    available: gloo and NCCL both carry them, and a world of one needs
    none)."""
    init = is_initialized()
    world = world_size()
    local = 1 if init else len(local_devices())
    be = backend()
    return {
        "backend": be,
        "distributed": init,
        "world": world,
        "local_devices": local,
        "topology": f"{world}x{local}",
        "quantized_transport": be in ("nccl", "gloo", "cpu"),
    }


def _resolve_address(coordinator_address, process_id, coord,
                     resolve_timeout):
    if coord is None:
        return coordinator_address
    if process_id == 0:
        if not coordinator_address:
            raise ValueError("process 0 must pass coordinator_address "
                             "(its own reachable host:port) to publish")
        publish_endpoint(coord, coordinator_address)  # BEFORE peers join
        return coordinator_address
    if coordinator_address is not None:
        return coordinator_address
    # fleets boot unordered: poll until process 0 publishes. Timing out
    # RAISES — a silent single-process fallback would leave the rest of
    # the fleet hanging in the rendezvous
    deadline = time.monotonic() + resolve_timeout
    while True:
        raw = coord.read(JAX_COORD_PATH)
        if raw:
            return raw.decode()
        if time.monotonic() >= deadline:
            raise TimeoutError(
                f"no JAX coordinator endpoint published within "
                f"{resolve_timeout:.0f}s (is process 0 up?)")
        time.sleep(0.5)


def initialize(
    coordinator_address: Optional[str] = None,
    num_processes: Optional[int] = None,
    process_id: Optional[int] = None,
    coord: Optional[Coordinator] = None,
    resolve_timeout: float = 60.0,
    device: Union[str, torch.device, None] = None,
    timeout: float = DEFAULT_TIMEOUT_SEC,
) -> bool:
    """Join the process world. Returns True if it ran, False for a world
    of one or one already initialized.

    Endpoint resolution: explicit ``coordinator_address`` (``host:port``,
    where process 0 runs the rendezvous store), then the coordination
    store (process 0 publishes, others poll until ``resolve_timeout`` and
    raise ``TimeoutError``). ``device`` is where this rank's model lives
    (``cuda`` unless ``cpu``); NCCL needs it on CUDA. ``timeout`` bounds
    every collective of the group."""
    if is_initialized():
        return False
    if not num_processes or num_processes <= 1:
        return False  # single process: never poll or raise
    address = _resolve_address(coordinator_address, process_id, coord,
                               resolve_timeout)
    if not address:
        return False
    host, _, port = address.rpartition(":")
    td = datetime.timedelta(seconds=float(timeout))
    store = dist.TCPStore(host or "127.0.0.1", int(port), num_processes,
                          is_master=process_id == 0, timeout=td)
    me = socket.gethostname()
    on_cuda = device is not None and torch.device(device).type == "cuda"
    ndev = torch.cuda.device_count() if on_cuda else 0
    store.set(f"jubatus/host/{process_id}", me)
    store.set(f"jubatus/ndev/{process_id}", str(ndev))
    hosts = [store.get(f"jubatus/host/{r}").decode()
             for r in range(num_processes)]
    ndevs = [int(store.get(f"jubatus/ndev/{r}"))
             for r in range(num_processes)]
    local_rank = sum(1 for r in range(process_id) if hosts[r] == me)
    per_host = {h: hosts.count(h) for h in hosts}
    nccl = (on_cuda and not _WORLD["force_gloo"] and dist.is_nccl_available()
            and all(per_host[h] <= n for h, n in zip(hosts, ndevs)))
    if nccl:
        dev = torch.device("cuda", local_rank)
        torch.cuda.set_device(dev)
    else:
        dev = torch.device(device) if device is not None else None
    be = "nccl" if nccl else "gloo"
    dist.init_process_group(be, store=store, rank=process_id,
                            world_size=num_processes, timeout=td)
    _WORLD.update(backend=be, device=dev, hosts=hosts)
    log.info("joined the process world: rank %d/%d via %s (%s)",
             process_id, num_processes, address, be)
    return True


def subgroups(rank_lists: Sequence[Sequence[int]]) -> List[Any]:
    """One process group per rank list, made once a world. Every rank must
    call this with the same lists in the same order: ``new_group`` is
    collective."""
    out = []
    for ranks in rank_lists:
        key = tuple(int(r) for r in ranks)
        if key not in _GROUPS:
            _GROUPS[key] = dist.new_group(list(key))
        out.append(_GROUPS[key])
    return out


def shutdown() -> None:
    """Tear this process's world down (peers' collectives then fail)."""
    _GROUPS.clear()
    if is_initialized():
        dist.destroy_process_group()
    _WORLD.update(backend=None, device=None, hosts=None)


def publish_endpoint(coord: Coordinator, address: str) -> None:
    """Process 0 publishes the rendezvous endpoint for the fleet. The node
    is EPHEMERAL (owned by process 0's coordinator session): a crashed
    fleet's endpoint disappears instead of pointing late-booting workers
    at a dead rendezvous from the previous incarnation."""
    coord.remove(JAX_COORD_PATH)
    if not coord.create(JAX_COORD_PATH, address.encode(), ephemeral=True):
        raise RuntimeError(
            f"cannot publish JAX coordinator endpoint at {JAX_COORD_PATH} "
            "(stale node owned by another session, or session closed)")


def free_port() -> int:
    """A TCP port free on this host now (for a local rendezvous)."""
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def run_local_world(script: str, n: int, *, args: Sequence[str] = (),
                    timeout: float = 60.0, env: Optional[dict] = None,
                    cwd: Optional[str] = None):
    """Run the Python source ``script`` as ``n`` processes on this host,
    each with argv ``[rank, n, rendezvous_port, *args]`` (one free port
    for all). Returns (outputs, exit codes) in rank order. A process still
    running after ``timeout`` seconds is killed and its code is None:
    a hung world must not outlast its caller's bound."""
    root = os.path.dirname(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))
    base = dict(os.environ if env is None else env)
    base["PYTHONPATH"] = root + (os.pathsep + base["PYTHONPATH"]
                                 if base.get("PYTHONPATH") else "")
    port = str(free_port())
    logs, procs = [], []
    with tempfile.TemporaryDirectory() as tmp:
        for r in range(n):
            log_path = os.path.join(tmp, f"rank{r}.log")
            fh = open(log_path, "w")
            logs.append((log_path, fh))
            procs.append(subprocess.Popen(
                [sys.executable, "-c", script, str(r), str(n), port,
                 *map(str, args)], stdout=fh, stderr=subprocess.STDOUT,
                env=base, cwd=cwd or root))
        deadline = time.monotonic() + timeout
        codes: List[Optional[int]] = [None] * n
        while time.monotonic() < deadline and any(c is None for c in codes):
            codes = [p.poll() for p in procs]
            time.sleep(0.05)
        for i, p in enumerate(procs):
            if codes[i] is None:
                p.kill()
                p.wait()
        outs = []
        for path, fh in logs:
            fh.close()
            with open(path) as f:
                outs.append(f.read())
    return outs, codes
