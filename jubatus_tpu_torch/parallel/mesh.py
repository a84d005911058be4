"""Device meshes (counterpart of ``jubatus_tpu/parallel/mesh.py``): the 1-D
shard mesh of row-sharded serving and the feature-sharded linear engines,
and the replica, grid and two-tier host meshes of the collective mix plane.

A ``ShardMesh`` is an ordered list of ``torch.device`` with one named axis,
``shard``: shard ``s`` of a row-sharded table lives on ``devices[s]``, and
``mesh.shape[axis]`` is the shard count, as ``jax.sharding.Mesh`` gives it.
The server builds one from the first N cards (``--shard-devices N``,
``local_shard_mesh``). A mesh may name one device several times: tests and
the chip smoke use ``ShardMesh(["cpu"] * 4)`` or ``ShardMesh(["cuda:0"] *
4)`` as logical shards on one device, the stand-in for the JAX tests'
virtual CPU devices. No flag builds such a mesh.

``feature_split`` is ``make_feature_sharding``'s divisibility check: the
linear engines split their feature dim 2^k into equal column blocks, one a
shard.

The collective plane's meshes (``host_topology``, ``host_mesh``,
``replica_mesh``, ``grid_mesh``) are grids of devices. In a world of
several processes a device is a ``RankDevice``, a (rank, ``torch.device``)
pair that also names the rank's host: one rank contributes one device, and
ranks group by host (each shares its hostname once). A single process
regrids its own devices, which may name one device several times (``["cpu"]
* 8``), the stand-in for the JAX tests' eight virtual CPU devices. Devices
are taken host-major, so a "local" row never spans hosts.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, List, NamedTuple, Optional, Sequence, Tuple, Union

import numpy as np
import torch

DeviceLike = Union[str, torch.device]


class ShardMesh:
    """Devices along one axis; ``shape[axis]`` is their count."""

    def __init__(self, devices: Sequence[DeviceLike], axis: str = "shard"):
        devs = tuple(torch.device(d) for d in devices)
        if not devs:
            raise ValueError("a shard mesh needs at least one device")
        self.devices: Tuple[torch.device, ...] = devs
        self.axis_names = (axis,)
        self.shape: Dict[str, int] = {axis: len(devs)}

    def __repr__(self) -> str:
        return (f"ShardMesh({[str(d) for d in self.devices]}, "
                f"axis={self.axis_names[0]!r})")


def local_shard_mesh(n: int, device: DeviceLike = "cuda", err_cls=ValueError,
                     message: str = "--shard-devices {n} but only {have} "
                     "local devices present") -> ShardMesh:
    """The mesh of ``--shard-devices n``: the first ``n`` local devices of
    ``device``'s type (the CUDA cards this process sees; the CPU is one).
    With fewer, raises ``err_cls(message)``, ``message`` formatted with
    ``n`` and ``have`` (the JAX server's text by default)."""
    dev = torch.device(device)
    have = torch.cuda.device_count() if dev.type == "cuda" else 1
    if have < n:
        raise err_cls(message.format(n=n, have=have))
    if dev.type == "cuda":
        return ShardMesh([torch.device("cuda", i) for i in range(n)])
    return ShardMesh([dev] * n)


def feature_split(mesh: ShardMesh, dim_bits: int, err_cls=ValueError) -> int:
    """Columns per shard when the feature dim 2^dim_bits is split over the
    mesh; raises ``err_cls`` with the JAX package's message when the
    shard count does not divide it."""
    n = len(mesh.devices)
    if (1 << dim_bits) % n:
        raise err_cls(
            f"feature dim 2^{dim_bits} not divisible by {n} shard devices")
    return (1 << dim_bits) // n


# -- the collective plane's meshes -------------------------------------------

class RankDevice(NamedTuple):
    """One participant of the collective plane: a rank, its device (None
    for another process's rank: only the rank itself touches it), its
    host, and its lane, the index among the process's devices (a single
    process regrids several)."""

    rank: int
    device: Optional[torch.device]
    host: str = ""
    lane: int = 0

    @property
    def process_index(self) -> int:
        return self.rank


def world_devices() -> List[Any]:
    """The participants of this process's world: one ``RankDevice`` a rank
    (its device, its host) in a world of several ranks; this process's
    local devices alone."""
    from jubatus_tpu_torch.parallel import multihost

    hosts = multihost.rank_hosts()
    if multihost.world_size() > 1:
        me = multihost.rank()
        dev = multihost.wire_device()
        return [RankDevice(r, dev if r == me else None, h)
                for r, h in enumerate(hosts)]
    return [RankDevice(0, d, hosts[0], i)
            for i, d in enumerate(multihost.local_devices())]


def _as_device(d: Any) -> Any:
    return torch.device(d) if isinstance(d, str) else d


def _host_of(d: Any) -> Any:
    host = getattr(d, "host", "")
    return host if host else getattr(d, "process_index", 0)


def host_major(devices: Optional[Sequence[Any]] = None) -> list:
    """Devices ordered host-major: grouped by host (hosts in the order of
    their first rank), by rank and local index within a host. Plain
    ``torch.device`` entries keep their order. A rank order that
    interleaves hosts would otherwise put a "local" slice across the
    network."""
    devices = [_as_device(d) for d in
               (devices if devices is not None else world_devices())]
    first: Dict[Any, int] = {}
    for d in devices:
        h = _host_of(d)
        r = getattr(d, "process_index", 0)
        first[h] = min(first.get(h, r), r)

    def key(d: Any):
        return (first[_host_of(d)], getattr(d, "process_index", 0),
                getattr(d, "lane", getattr(d, "id", 0)))

    return sorted(devices, key=key)


@dataclasses.dataclass(frozen=True)
class HostTopology:
    """Two-tier device topology for the hierarchical mix: ``hosts`` groups
    of ``locals`` devices each. ``grid`` is the host-major (hosts, locals)
    device grid as nested tuples. ``source`` records how it was derived
    (``derived`` from the runtime, ``override`` from an explicit ``HxM``
    spec, ``nonuniform`` when hosts hold different rank counts)."""

    hosts: int
    locals: int
    grid: Tuple[tuple, ...]
    source: str = "derived"

    @property
    def signature(self) -> str:
        """The ``NxM`` string the collective mixer folds into its prepare
        signature — heterogeneous fleets mismatch here and fall back to
        the RPC mix instead of wedging a skewed collective."""
        return f"{self.hosts}x{self.locals}"

    @property
    def trivial(self) -> bool:
        return self.hosts * self.locals <= 1


def _parse_topology(spec) -> Tuple[int, int]:
    if isinstance(spec, (tuple, list)) and len(spec) == 2:
        h, m = int(spec[0]), int(spec[1])
    else:
        try:
            h_s, _, m_s = str(spec).lower().partition("x")
            h, m = int(h_s), int(m_s)
        except ValueError:
            raise ValueError(
                f"bad topology {spec!r}: expected 'HxM' (hosts x local "
                "devices), e.g. '4x2'") from None
    if h < 1 or m < 1:
        raise ValueError(f"bad topology {spec!r}: both tiers must be >= 1")
    return h, m


def host_topology(devices: Optional[Sequence[Any]] = None,
                  override=None) -> HostTopology:
    """The world's two-tier (host, local) topology.

    Derived (no ``override``): one grid row per host, the host's
    participants (host-major) as its row. Hosts holding different counts
    degrade to one row a participant (``Nx1``): a ragged grid cannot mesh.

    ``override`` (``"HxM"`` / ``(H, M)``): regrids the participants
    host-major. With several ranks the participants are one device a rank
    and H*M must equal the rank count; a single process regrids its own
    devices (H*M of them), which is how one process runs real two-tier
    collectives without a cluster."""
    devices = host_major(devices)
    if not devices:
        raise ValueError("no devices")
    by_host: Dict[Any, list] = {}
    for d in devices:
        by_host.setdefault(_host_of(d), []).append(d)
    rows = [tuple(r) for r in by_host.values()]
    ranks = sorted({getattr(d, "process_index", 0) for d in devices})
    if override is not None and override != "":
        h, m = _parse_topology(override)
        if len(ranks) > 1:
            if h * m != len(ranks):
                raise ValueError(
                    f"topology {h}x{m} needs {h * m} processes, "
                    f"world has {len(ranks)}")
            seen: Dict[int, Any] = {}
            for d in devices:
                seen.setdefault(getattr(d, "process_index", 0), d)
            flat = list(seen.values())
        else:
            if h * m > len(devices):
                raise ValueError(
                    f"topology {h}x{m} needs {h * m} devices, "
                    f"have {len(devices)}")
            flat = devices[: h * m]
        grid = tuple(tuple(flat[i * m:(i + 1) * m]) for i in range(h))
        return HostTopology(h, m, grid, source="override")
    counts = {len(r) for r in rows}
    if len(counts) != 1:
        return HostTopology(len(devices), 1,
                            tuple((d,) for d in devices),
                            source="nonuniform")
    return HostTopology(len(rows), counts.pop(), tuple(rows),
                        source="derived")


class DeviceGrid:
    """Devices on named axes: ``devices`` a numpy object array of the axes'
    shape, ``shape[axis]`` each axis's length (``jax.sharding.Mesh``'s
    attributes)."""

    def __init__(self, devices: np.ndarray, axis_names: Tuple[str, ...]):
        if devices.ndim != len(axis_names):
            raise ValueError("one axis name a grid dimension")
        self.devices = devices
        self.axis_names = tuple(axis_names)
        self.shape: Dict[str, int] = dict(zip(axis_names, devices.shape))

    def __repr__(self) -> str:
        return f"DeviceGrid({self.shape})"


def _grid(rows: Sequence[Sequence[Any]], axis_names) -> DeviceGrid:
    arr = np.empty((len(rows), len(rows[0])), dtype=object)
    for i, row in enumerate(rows):
        for j, d in enumerate(row):
            arr[i, j] = d
    return DeviceGrid(arr, axis_names)


def host_mesh(topo: Optional[HostTopology] = None, devices=None,
              override=None) -> DeviceGrid:
    """The 2-D ``(host, local)`` grid of ``host_topology``: intra-host
    collectives run along ``local``, inter-host ones along ``host``."""
    if topo is None:
        topo = host_topology(devices, override)
    return _grid(topo.grid, ("host", "local"))


def replica_mesh(n_replicas: Optional[int] = None,
                 devices=None) -> DeviceGrid:
    """A 1-D grid of model replicas over the first n devices (host-major,
    so "first n" is the first hosts' devices)."""
    devices = host_major(devices)
    if n_replicas is not None:
        if n_replicas > len(devices):
            raise ValueError(
                f"requested {n_replicas} replicas but only {len(devices)} "
                "devices")
        devices = devices[:n_replicas]
    arr = np.empty((len(devices),), dtype=object)
    for i, d in enumerate(devices):
        arr[i] = d
    return DeviceGrid(arr, ("replica",))


def grid_mesh(replica: int, shard: int, devices=None) -> DeviceGrid:
    """A 2-D (replica, shard) grid: data-parallel groups of feature-sharded
    tables. Devices are taken host-major so the trailing ``shard`` axis
    stays within a host wherever the shape allows."""
    devices = host_major(devices)
    need = replica * shard
    if need > len(devices):
        raise ValueError(f"mesh {replica}x{shard} needs {need} devices, "
                         f"have {len(devices)}")
    return _grid([devices[r * shard:(r + 1) * shard]
                  for r in range(replica)], ("replica", "shard"))
