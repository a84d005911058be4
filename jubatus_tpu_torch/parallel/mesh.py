"""The 1-D shard mesh (the pieces of ``jubatus_tpu/parallel/mesh.py`` that
row-sharded serving and the feature-sharded linear engines need).

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

The replica, host and grid meshes of the JAX package belong to the
collective mix planes, which are not ported yet.
"""

from __future__ import annotations

from typing import Dict, Sequence, Tuple, Union

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
