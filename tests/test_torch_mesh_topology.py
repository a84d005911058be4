"""The port's two-tier topology and host-major ordering
(jubatus_tpu_torch/parallel/mesh.py) against the JAX package's
(tests/test_mesh_topology.py). The JAX tests' fake devices are processes
with device ids; the port's participants are ranks that name their host.
Each case feeds both packages the same layout: JAX process p ↔ port host
``h{p}``, and the grids must group the same participants."""

from __future__ import annotations

import jax
import pytest
import torch

from jubatus_tpu.parallel import mesh as jmesh
from jubatus_tpu_torch.parallel.mesh import (
    DeviceGrid,
    HostTopology,
    RankDevice,
    grid_mesh,
    host_major,
    host_mesh,
    host_topology,
    replica_mesh,
)


class _FakeDevice:
    def __init__(self, proc: int, dev_id: int):
        self.process_index = proc
        self.id = dev_id

    def __repr__(self):
        return f"fake(p{self.process_index}/d{self.id})"


def _interleaved_jax(hosts: int, per_host: int):
    """Round-robin across hosts (device 0 of every host first)."""
    return [_FakeDevice(p, p * per_host + i)
            for i in range(per_host) for p in range(hosts)]


def _interleaved_port(hosts: int, per_host: int):
    """The same layout as ranks: rank p*per_host+i lives on host h{p}, in
    the round-robin order."""
    return [RankDevice(p * per_host + i, None, f"h{p}")
            for i in range(per_host) for p in range(hosts)]


def _jax_groups(topo):
    return [[d.process_index for d in row] for row in topo.grid]


def _port_groups(topo):
    return [[int(d.host[1:]) for d in row] for row in topo.grid]


def _local(n: int):
    """A single process's n logical lanes (the JAX tests' virtual CPU
    devices)."""
    return ["cpu"] * n


# -- host_major ordering --------------------------------------------------------

def test_host_major_groups_interleaved_hosts():
    j = jmesh.host_major(_interleaved_jax(2, 4))
    p = host_major(_interleaved_port(2, 4))
    assert [(d.process_index, d.id) for d in j] == \
        [(0, 0), (0, 1), (0, 2), (0, 3), (1, 4), (1, 5), (1, 6), (1, 7)]
    assert [(d.host, d.rank) for d in p] == \
        [("h0", 0), ("h0", 1), ("h0", 2), ("h0", 3),
         ("h1", 4), ("h1", 5), ("h1", 6), ("h1", 7)]


def test_replica_mesh_is_host_major():
    devs = list(reversed(_interleaved_port(2, 2)))
    mesh = replica_mesh(devices=devs)
    assert isinstance(mesh, DeviceGrid) and mesh.axis_names == ("replica",)
    assert [d.rank for d in mesh.devices] == [0, 1, 2, 3]
    jm = jmesh.replica_mesh(devices=list(reversed(jax.devices())))
    assert mesh.shape == {"replica": 4} and jm.shape["replica"] == 8
    with pytest.raises(ValueError, match="replicas"):
        replica_mesh(5, devices=devs)


def test_grid_mesh_is_host_major():
    mesh = grid_mesh(2, 4, devices=_local(8))
    jm = jmesh.grid_mesh(2, 4)
    assert mesh.shape == {"replica": 2, "shard": 4} == dict(jm.shape)
    assert all(d == torch.device("cpu") for d in mesh.devices.reshape(-1))
    with pytest.raises(ValueError, match="needs 16 devices, have 8"):
        grid_mesh(4, 4, devices=_local(8))


def test_grid_mesh_shard_axis_stays_on_host():
    """2 hosts x 4 ranks handed over INTERLEAVED: each replica row lands
    on ONE host, in both packages."""
    j = jmesh.grid_mesh(2, 4, devices=_interleaved_jax(2, 4))
    p = grid_mesh(2, 4, devices=_interleaved_port(2, 4))
    for jrow, prow in zip(j.devices, p.devices):
        assert len({d.process_index for d in jrow}) == 1
        assert len({d.host for d in prow}) == 1


# -- host_topology derivation ---------------------------------------------------

def test_host_topology_derived_groups_by_host():
    j = jmesh.host_topology(devices=_interleaved_jax(3, 2))
    p = host_topology(devices=_interleaved_port(3, 2))
    assert (p.hosts, p.locals) == (j.hosts, j.locals) == (3, 2)
    assert p.signature == j.signature == "3x2"
    assert p.source == j.source == "derived"
    assert _port_groups(p) == _jax_groups(j) == [[0, 0], [1, 1], [2, 2]]


def test_host_topology_nonuniform_degrades_to_one_per_row():
    """Hosts holding 2 and 1 ranks: a ragged grid cannot mesh. JAX keeps
    one device per process (2x1); the port, whose unit is a rank, one row
    per rank (3x1) — every rank still contributes."""
    j = jmesh.host_topology(devices=[_FakeDevice(0, 0), _FakeDevice(0, 1),
                                     _FakeDevice(1, 2)])
    p = host_topology(devices=[RankDevice(0, None, "h0"),
                               RankDevice(1, None, "h0"),
                               RankDevice(2, None, "h1")])
    assert (j.hosts, j.locals, j.source) == (2, 1, "nonuniform")
    assert (p.hosts, p.locals, p.source) == (3, 1, "nonuniform")


def test_host_topology_override_single_process_regrid():
    """A single process regrids its own (logical) devices."""
    p = host_topology(devices=_local(8), override="2x4")
    j = jmesh.host_topology(override="2x4")
    assert (p.hosts, p.locals) == (j.hosts, j.locals) == (2, 4)
    assert p.source == j.source == "override"
    assert p.signature == "2x4" and not p.trivial
    assert sum(len(r) for r in p.grid) == 8
    assert host_topology(devices=_local(8), override=(2, 4)).signature \
        == "2x4"


def test_host_topology_override_multi_process_groups_ranks():
    j_devs = [_FakeDevice(p, 10 + p) for p in range(4)]
    p_devs = [RankDevice(r, None, f"h{r}") for r in range(4)]
    j = jmesh.host_topology(devices=j_devs, override="2x2")
    p = host_topology(devices=p_devs, override="2x2")
    assert _jax_groups(j) == [[0, 1], [2, 3]]
    assert [[d.rank for d in row] for row in p.grid] == [[0, 1], [2, 3]]
    for mod, devs in ((jmesh, j_devs), (None, p_devs)):
        fn = mod.host_topology if mod is not None else host_topology
        with pytest.raises(ValueError, match="needs 6 processes, world "
                                             "has 4"):
            fn(devices=devs, override="3x2")


def test_host_topology_rejects_bad_specs():
    for bad in ("3x", "x3", "junk", "0x2", "2x0"):
        with pytest.raises(ValueError) as pe:
            host_topology(devices=_local(8), override=bad)
        with pytest.raises(ValueError) as je:
            jmesh.host_topology(override=bad)
        assert str(pe.value) == str(je.value)
    with pytest.raises(ValueError, match="needs 16 devices, have 8"):
        host_topology(devices=_local(8), override="4x4")


def test_trivial_topology():
    assert HostTopology(1, 1, ((None,),)).trivial
    assert not HostTopology(2, 1, ((None,), (None,))).trivial


def test_world_devices_default_single_process():
    """Without a world the participants are this process's devices (the
    CPU once here): the derived topology is 1x1, and an override beyond
    them is refused with the JAX package's message."""
    topo = host_topology()
    assert topo.signature == "1x1" and topo.source == "derived"
    with pytest.raises(ValueError, match="topology 2x4 needs 8 devices, "
                                         "have 1"):
        host_topology(override="2x4")


# -- host_mesh ------------------------------------------------------------------

def test_host_mesh_axes_and_shape():
    mesh = host_mesh(devices=_local(8), override="2x4")
    jm = jmesh.host_mesh(override="2x4")
    assert mesh.axis_names == tuple(jm.axis_names) == ("host", "local")
    assert mesh.shape == dict(jm.shape) == {"host": 2, "local": 4}
    topo = host_topology(devices=_interleaved_port(2, 2))
    grid = host_mesh(topo)
    assert [[d.rank for d in row] for row in grid.devices] == \
        [[0, 1], [2, 3]]
