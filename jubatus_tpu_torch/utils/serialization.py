"""msgpack packing for model state (copy of
``jubatus_tpu/utils/serialization.py``).

The reference serializes models through core::framework::packer into msgpack
streams (linear_mixer.cpp:513-517, save_load.cpp:113-158). msgpack is the
envelope for wire/file parity, with one ext type (42) for ndarrays whose
bytes are the JAX package's: ``(dtype.str, shape, raw bytes)``.

Numpy arrays and CPU tensors pack; a CUDA tensor raises ``TypeError``.
Device readback stays explicit in the drivers (``.cpu()``), where it runs
under the model lock and is timed, never hidden in the packer.
"""

from __future__ import annotations

from typing import Any

import msgpack
import numpy as np
import torch

_EXT_NDARRAY = 42


def _default(obj: Any):
    if isinstance(obj, torch.Tensor):
        if obj.device.type != "cpu":
            raise TypeError(
                f"cannot msgpack a tensor on {obj.device}: read it back to "
                "the host first")
        obj = obj.numpy()
    # np.ndarray and numpy scalars both expose __array__
    if hasattr(obj, "__array__"):
        arr = np.ascontiguousarray(np.asarray(obj))
        payload = msgpack.packb(
            (arr.dtype.str, list(arr.shape), arr.tobytes()), use_bin_type=True
        )
        return msgpack.ExtType(_EXT_NDARRAY, payload)
    raise TypeError(f"cannot msgpack {type(obj)!r}")


def _ext_hook(code: int, data: bytes):
    if code == _EXT_NDARRAY:
        dtype, shape, raw = msgpack.unpackb(data, raw=False)
        return np.frombuffer(raw, dtype=np.dtype(dtype)).reshape(shape).copy()
    return msgpack.ExtType(code, data)


def pack_obj(obj: Any) -> bytes:
    return msgpack.packb(obj, default=_default, use_bin_type=True)


def unpack_obj(data: bytes) -> Any:
    return msgpack.unpackb(
        data, ext_hook=_ext_hook, raw=False, strict_map_key=False
    )
