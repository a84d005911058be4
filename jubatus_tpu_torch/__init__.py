"""jubatus_tpu_torch — the PyTorch/CUDA port of jubatus_tpu.

A second package beside ``jubatus_tpu`` (which stays the reference): the same
engines behind the same MessagePack-RPC surface, with the model plane in
PyTorch and the TPU kernels rewritten by hand for NVIDIA Hopper
(``csrc/``). It imports ``torch``, ``numpy`` and ``msgpack`` and nothing of
JAX or of ``jubatus_tpu``: host layers it needs are copied, module by module,
under the same names.

Ported so far: the engines on the nearest-neighbor backend — nearest_neighbor,
recommender, anomaly (LOF) and the NN classifier — with the exact methods
(inverted_index, euclid) and the LSH family, whose signature scan is a CUDA
kernel (``ops/sig_scan.py``, ``csrc/sig_scan.cu``); and the linear
classifier and regression engines, whose per-example scan is a CUDA kernel
(``ops/online_scan.py``, ``csrc/online_scan.cu``).

Entry points run on ``cuda`` unless the caller passes ``device="cpu"``; they
raise when CUDA is absent and the CPU was not asked for.
"""

from __future__ import annotations

from typing import Optional, Union

import torch

__version__ = "0.1.0"


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
