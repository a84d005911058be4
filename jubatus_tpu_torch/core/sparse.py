"""Padded sparse-vector batches — the host↔device interchange format.

Copy of ``jubatus_tpu/core/sparse.py``. A feature vector is hashed into a
2^k index space (fv/hashing.py) and a *batch* of vectors is a pair of dense
arrays (indices, values) padded to a common nnz. Padding entries carry value
0.0 so they are no-ops in every kernel.

Pad widths are bucketed to powers of two, as in the JAX package, so both
packages see the same batch shapes.
"""

from __future__ import annotations

from typing import List, Optional, Sequence, Tuple

import numpy as np
import torch

# (index, weight) pairs, already hashed. The canonical sparse vector type.
SparseVector = List[Tuple[int, float]]


def to_device(a: np.ndarray, device: torch.device) -> torch.Tensor:
    """A host array as a tensor on ``device``: on the CPU it shares the
    array's memory; to a card it goes through pinned memory with a
    non-blocking copy on the current stream."""
    a = np.ascontiguousarray(a)
    if not a.flags.writeable:  # torch.from_numpy wants a writable array
        a = a.copy()
    t = torch.from_numpy(a)
    if device.type == "cpu":
        return t
    return t.pin_memory().to(device, non_blocking=True)


def _bucket(n: int, minimum: int = 8) -> int:
    b = minimum
    while b < n:
        b *= 2
    return b


class CSRBatch:
    """Arena-style batch of hashed sparse feature vectors (CSR triple).

    The batch converter (core/fv/converter.py convert_batch) emits one of
    these instead of B per-datum SparseVector lists: three flat arrays,
    no per-entry Python objects, ready for a single vectorized pad into
    the device interchange format (``to_padded`` → SparseBatch).

    Attributes:
      indices:     int32   [nnz]  hashed feature indices, per-row sorted
      values:      float32 [nnz]  feature values
      row_offsets: int64   [B+1]  row i spans [row_offsets[i], row_offsets[i+1])
    """

    __slots__ = ("indices", "values", "row_offsets")

    def __init__(self, indices: np.ndarray, values: np.ndarray,
                 row_offsets: np.ndarray) -> None:
        assert indices.shape == values.shape and indices.ndim == 1
        assert row_offsets.ndim == 1 and row_offsets[-1] == indices.shape[0]
        self.indices = indices
        self.values = values
        self.row_offsets = row_offsets

    @property
    def batch_size(self) -> int:
        return self.row_offsets.shape[0] - 1

    @property
    def nnz(self) -> int:
        return self.indices.shape[0]

    def __len__(self) -> int:
        return self.batch_size

    def row(self, i: int) -> SparseVector:
        """One row as the canonical (index, value) pair list — for the
        instance engines that store per-row vectors (NN backends)."""
        lo, hi = int(self.row_offsets[i]), int(self.row_offsets[i + 1])
        return list(zip(self.indices[lo:hi].tolist(),
                        self.values[lo:hi].astype(np.float64).tolist()))

    def rows(self) -> List[SparseVector]:
        return [self.row(i) for i in range(self.batch_size)]

    @classmethod
    def from_vectors(cls, vectors: Sequence[SparseVector]) -> "CSRBatch":
        """Pack per-datum SparseVectors (the per-datum converter's output)
        — the parity bridge between the two pipelines."""
        counts = np.fromiter((len(v) for v in vectors), dtype=np.int64,
                             count=len(vectors))
        off = np.zeros(len(vectors) + 1, dtype=np.int64)
        np.cumsum(counts, out=off[1:])
        idx = np.zeros(int(off[-1]), dtype=np.int32)
        val = np.zeros(int(off[-1]), dtype=np.float32)
        for i, vec in enumerate(vectors):
            if not vec:
                continue
            lo = int(off[i])
            idx[lo:lo + len(vec)] = [j for j, _ in vec]
            val[lo:lo + len(vec)] = [w for _, w in vec]
        return cls(idx, val, off)

    def uniform_row(self) -> Optional[np.ndarray]:
        """The shared index row if EVERY row carries the same index vector
        (fixed key schema — the common production feed), else None.
        Unlocks the dense submatrix device plans (ops.*_schema)."""
        b = self.batch_size
        if b == 0:
            return None
        counts = np.diff(self.row_offsets)
        k = int(counts[0])
        if k == 0 or not (counts == k).all():
            return None
        mat = self.indices.reshape(b, k)
        if b > 1 and not (mat == mat[0]).all():
            return None
        return mat[0]

    def to_padded(self, min_width: int = 8,
                  batch_bucket: int = 1) -> "SparseBatch":
        """Vectorized pad into the [B, K] device interchange format —
        the CSR equivalent of SparseBatch.from_vectors (same pow2 width
        and optional row bucketing, no Python per-row loop)."""
        b = self.batch_size
        counts = np.diff(self.row_offsets)
        bsz = _bucket(max(b, 1), batch_bucket) if batch_bucket > 1 \
            else max(b, 1)
        width = _bucket(int(counts.max()) if b else 1, min_width)
        idx = np.zeros((bsz, width), dtype=np.int32)
        val = np.zeros((bsz, width), dtype=np.float32)
        if self.nnz:
            rows = np.repeat(np.arange(b), counts)
            cols = np.arange(self.nnz) - np.repeat(
                self.row_offsets[:-1], counts)
            idx[rows, cols] = self.indices
            val[rows, cols] = self.values
        return SparseBatch(idx, val)


class SparseBatch:
    """A batch of hashed sparse feature vectors as padded numpy arrays.

    Attributes:
      idx:  int32  [B, K] feature indices (0 for padding)
      val:  float32 [B, K] feature values (0.0 for padding)
    """

    __slots__ = ("idx", "val")

    def __init__(self, idx: np.ndarray, val: np.ndarray) -> None:
        assert idx.shape == val.shape and idx.ndim == 2
        self.idx = idx
        self.val = val

    @property
    def batch_size(self) -> int:
        return self.idx.shape[0]

    @property
    def width(self) -> int:
        return self.idx.shape[1]

    @classmethod
    def from_vectors(
        cls,
        vectors: Sequence[SparseVector],
        min_width: int = 8,
        batch_bucket: int = 1,
    ) -> "SparseBatch":
        """Pack hashed sparse vectors into padded arrays.

        Widths (and optionally batch sizes) are rounded up to power-of-two
        buckets, as in the JAX package.
        """
        n = len(vectors)
        bsz = _bucket(max(n, 1), batch_bucket) if batch_bucket > 1 else max(n, 1)
        width = _bucket(max((len(v) for v in vectors), default=1), min_width)
        idx = np.zeros((bsz, width), dtype=np.int32)
        val = np.zeros((bsz, width), dtype=np.float32)
        for i, vec in enumerate(vectors):
            if not vec:
                continue
            k = len(vec)
            idx[i, :k] = [j for j, _ in vec]
            val[i, :k] = [w for _, w in vec]
        return cls(idx, val)

    def pad_aux(self, aux: Sequence, fill=0, dtype=None) -> np.ndarray:
        """Pad a per-example array (labels, targets) to this batch's row count.

        Required when batch_bucket > 1 added all-zero padding rows: training
        kernels gate updates on ||x||^2 > 0, so padded rows are no-ops for
        any in-range fill value.
        """
        out = np.full(self.batch_size, fill, dtype=dtype or np.asarray(aux).dtype)
        out[: len(aux)] = aux
        return out

    def squared_norms(self) -> np.ndarray:
        return (self.val.astype(np.float64) ** 2).sum(axis=1)

    def __len__(self) -> int:
        return self.batch_size
