"""Feature-name hashing into a fixed 2^k index space.

Copy of ``jubatus_tpu/core/fv/hashing.py``: crc32 of the UTF-8 name
(surrogateescape, so non-UTF-8 legacy strings hash their original bytes,
as the native ingest parser does), masked to ``dim_bits``. Index 0 is
reserved as the padding slot: real features map to [1, dim-1].
``index_many`` hashes through the native batch path
(``jubatus_tpu_torch.native.hash_names``) when ``JUBATUS_TPU_NATIVE=1``;
it gives the same indices and was measured no faster than the zlib loop,
so it is opt-in.

A bounded reverse table keeps hash→name (first name seen per index, at most
``reverse_capacity`` entries) for the engines that decode features back to
names: the recommender's ``complete_row_*`` through
``DatumToFVConverter.revert_feature``.
"""

from __future__ import annotations

import os
import zlib
from typing import Dict, Optional

import numpy as np


def _native_batch_enabled() -> bool:
    """The opt-in native batch hashing, read per call (tests flip it)."""
    return os.environ.get("JUBATUS_TPU_NATIVE", "") in ("1", "true", "yes")


class FeatureHasher:
    """Stable string→index hashing with optional reverse lookup."""

    def __init__(self, dim_bits: int = 20, reverse_capacity: int = 1 << 16):
        if not (4 <= dim_bits <= 31):
            raise ValueError("dim_bits must be in [4, 31]")
        self.dim_bits = dim_bits
        self.dim = 1 << dim_bits
        self._mask = self.dim - 1
        self._reverse: Dict[int, str] = {}
        self._reverse_capacity = reverse_capacity

    def index(self, name: str, remember: bool = True) -> int:
        h = zlib.crc32(name.encode("utf-8", "surrogateescape")) & self._mask
        if h == 0:
            h = 1  # index 0 is the padding slot
        if remember and len(self._reverse) < self._reverse_capacity:
            self._reverse.setdefault(h, name)
        return h

    def _remember_many(self, idxs, names) -> None:
        """Grow the reverse map from a batch, re-checking the capacity per
        entry so one oversized batch cannot pass the bound."""
        rev = self._reverse
        cap = self._reverse_capacity
        for h, name in zip(idxs, names):
            if len(rev) >= cap:
                break
            rev.setdefault(int(h), name)

    def index_many(self, names, remember: bool = True):
        """Batch hashing; ints aligned with ``names``."""
        if not _native_batch_enabled():
            return [self.index(n, remember) for n in names]
        from jubatus_tpu_torch import native

        idxs = native.hash_names(list(names), self._mask)
        if remember:
            self._remember_many(idxs.tolist(), names)
        return [int(i) for i in idxs]

    def index_array(self, names, remember: bool = True) -> np.ndarray:
        """Batch hashing to an int32 numpy array (the batch converter's
        sweep); the same indices as ``index``."""
        crc = zlib.crc32
        out = np.fromiter(
            (crc(n.encode("utf-8", "surrogateescape")) for n in names),
            dtype=np.uint32, count=len(names))
        out &= np.uint32(self._mask)
        idxs = out.astype(np.int32)
        idxs[idxs == 0] = 1  # index 0 is the padding slot
        if remember:
            self._remember_many(idxs.tolist(), names)
        return idxs

    def name_of(self, index: int) -> Optional[str]:
        """Reverse lookup (best effort; None if never seen or not kept)."""
        return self._reverse.get(int(index))
