"""jubatus_tpu_torch — the PyTorch/CUDA port of jubatus_tpu.

A second package beside ``jubatus_tpu`` (which stays the reference): the same
engines behind the same MessagePack-RPC surface, with the model plane in
PyTorch and the TPU kernels rewritten by hand for NVIDIA Hopper
(``csrc/``). It imports ``torch``, ``numpy`` and ``msgpack`` and nothing of
JAX or of ``jubatus_tpu``: host layers it needs are copied, module by module,
under the same names.

All eleven engines are ported: the engines on the nearest-neighbor
backend — nearest_neighbor, recommender, anomaly (LOF) and the NN
classifier — with the exact methods (inverted_index, euclid) and the LSH
family, whose signature scan is a CUDA kernel (``ops/sig_scan.py``,
``csrc/sig_scan.cu``); the linear classifier and regression engines, whose
per-example scan is a CUDA kernel (``ops/online_scan.py``,
``csrc/online_scan.cu``); clustering (k-means, GMM, DBSCAN) and graph
(PageRank) on the device in PyTorch (``ops/clustering.py``,
``models/graph.py``); and stat, bandit, burst and weight, which hold host
state only. The instance engines also serve row-sharded over several
devices (``parallel/``) and through the IVF tier (``ops/ivf.py``), the
linear engines feature-sharded (``parallel/sharded_model.py``). Fleets mix
over RPC or, with ``--mixer collective_mixer``, as a collective across the
ranks of one ``torch.distributed`` world (``parallel/collective.py``).
Converters load plugins (``core/fv/plugins.py``, ``plugins/``), and a
server carries the forensics, model-health, event, data-quality and usage
planes (``utils/``). Fleets coordinate through a directory, the
coordination service or a ZooKeeper ensemble (``coord/``); clients are
typed per engine (``client/``) or generated from an IDL (``codegen/``).

Entry points run on ``cuda`` unless the caller passes ``device="cpu"``; they
raise when CUDA is absent and the CPU was not asked for.
"""

from __future__ import annotations

import contextlib
from typing import Optional, Union

import torch

__version__ = "0.1.0"


class NotYetPorted(NotImplementedError):
    """A feature of the JAX package that the port has not reached yet."""


def resolve_device(device: Optional[Union[str, torch.device]] = None) -> torch.device:
    """The device an entry point runs on: ``cuda`` by default, the CPU only
    when asked for. Never slides to the CPU."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "CUDA is not available; pass device='cpu' (--device cpu) to run "
            "on the CPU")
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"unsupported device {dev}")
    return dev


def synchronize(device: torch.device) -> None:
    """Wait for the work queued on ``device`` (nothing to wait for on the
    CPU), so that a host timer around it reads the device's time too."""
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def device_scope(device: torch.device):
    """Make ``device`` the current CUDA device for the block (a no-op on
    the CPU). Threads that call into a driver from outside the thread that
    built it (RPC workers, the mixer) enter it, so kernels launch on the
    driver's card whatever the thread's current device is."""
    if device.type == "cuda":
        return torch.cuda.device(device)
    return contextlib.nullcontext()
