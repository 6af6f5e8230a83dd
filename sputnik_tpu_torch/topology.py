"""Sparse topology: where the nonzeros of an ``m x n`` matrix live.

PyTorch-side counterpart of ``sputnik_tpu/topology.py``. The topology is
host structure (numpy), built once; values are tensors held outside it.
The four-array CSR convention is the same:

  - ``values        : f32[nnz]``   nonzero values (held *outside* the topology)
  - ``row_offsets   : i32[m+1]``   cumulative row lengths
  - ``column_indices: i32[nnz]``   column of each nonzero
  - ``row_swizzle   : i32[m]``     row processing order, longest rows first

``nnz`` is padded to ``nnz_pad`` (a multiple of ``pad_to``); padding slots
carry column 0 and the out-of-range row id ``m`` so every op drops them
structurally. This module is the numpy path only: the arrays it builds
equal the JAX package's exactly for the same input.
"""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np

__all__ = [
    "SparseTopology",
    "SparseMatrix",
    "diffsort",
    "dense_to_csr_arrays",
    "DEFAULT_PAD_TO",
]

DEFAULT_PAD_TO = 4


def _round_up(x: int, m: int) -> int:
    return ((x + m - 1) // m) * m


def diffsort(row_offsets: np.ndarray) -> np.ndarray:
    """Row processing order: longest rows first (stable)."""
    row_offsets = np.asarray(row_offsets)
    lengths = row_offsets[1:] - row_offsets[:-1]
    return np.argsort(-lengths, kind="stable").astype(np.int32)


def dense_to_csr_arrays(matrix: np.ndarray) -> Tuple[np.ndarray, ...]:
    """Dense numpy matrix -> (values, row_offsets, column_indices)."""
    matrix = np.asarray(matrix)
    if matrix.ndim != 2:
        raise ValueError(f"expected 2-D matrix, got {matrix.shape}")
    mask = matrix != 0
    values = matrix[mask].astype(np.float32)
    lengths = mask.sum(axis=1).astype(np.int64)
    row_offsets = np.zeros(matrix.shape[0] + 1, dtype=np.int32)
    np.cumsum(lengths, out=row_offsets[1:])
    column_indices = np.nonzero(mask)[1].astype(np.int32)
    return values, row_offsets, column_indices


class SparseTopology:
    """Static sparsity pattern of an ``m x n`` matrix (host-side numpy).

    Compared and hashed by identity; derived structure (transpose
    permutation, block views) is cached on the instance.
    """

    __slots__ = ("m", "n", "nnz", "nnz_pad", "row_offsets",
                 "column_indices", "row_ids", "row_swizzle", "valid",
                 "_transpose_cache", "_block_cache")

    def __init__(self, m: int, n: int, row_offsets: np.ndarray,
                 column_indices: np.ndarray, *, pad_to: int = DEFAULT_PAD_TO,
                 nnz_pad: Optional[int] = None):
        row_offsets = np.ascontiguousarray(row_offsets, dtype=np.int32)
        column_indices = np.ascontiguousarray(column_indices, dtype=np.int32)
        if row_offsets.shape != (m + 1,):
            raise ValueError(f"row_offsets {row_offsets.shape} != ({m + 1},)")
        nnz = int(row_offsets[-1])
        if column_indices.shape[0] < nnz:
            raise ValueError("fewer column indices than row_offsets[-1]")
        column_indices = column_indices[:nnz]
        if nnz_pad is None:
            nnz_pad = _round_up(max(nnz, 1), pad_to)
        if nnz_pad < nnz:
            raise ValueError(f"nnz_pad {nnz_pad} < nnz {nnz}")

        self.m = int(m)
        self.n = int(n)
        self.nnz = nnz
        self.nnz_pad = int(nnz_pad)
        self.row_offsets = row_offsets

        ci = np.zeros(self.nnz_pad, dtype=np.int32)
        ci[:nnz] = column_indices
        self.column_indices = ci

        row_ids = np.full(self.nnz_pad, self.m, dtype=np.int32)
        row_ids[:nnz] = np.repeat(
            np.arange(self.m, dtype=np.int32),
            (row_offsets[1:] - row_offsets[:-1]).astype(np.int64))
        self.row_ids = row_ids
        self.row_swizzle = diffsort(row_offsets)
        self.valid = np.arange(self.nnz_pad) < nnz
        self._transpose_cache = None
        self._block_cache = {}

    @classmethod
    def from_dense_mask(cls, mask: np.ndarray, *,
                        pad_to: int = DEFAULT_PAD_TO) -> "SparseTopology":
        mask = np.asarray(mask)
        _, row_offsets, column_indices = dense_to_csr_arrays(
            (mask != 0).astype(np.float32))
        return cls(mask.shape[0], mask.shape[1], row_offsets, column_indices,
                   pad_to=pad_to)

    def __repr__(self):
        density = self.nnz / max(self.m * self.n, 1)
        return (f"SparseTopology(m={self.m}, n={self.n}, nnz={self.nnz}, "
                f"nnz_pad={self.nnz_pad}, density={density:.4f})")

    def to_dense_mask(self) -> np.ndarray:
        out = np.zeros((self.m, self.n), dtype=np.float32)
        out[self.row_ids[: self.nnz], self.column_indices[: self.nnz]] = 1.0
        return out

    def transpose(self) -> Tuple["SparseTopology", np.ndarray]:
        """Transposed topology + value permutation ``values_t = values[perm]``
        (``perm: i32[topo_t.nnz_pad]``); transposing twice gives back this
        object."""
        if self._transpose_cache is not None:
            return self._transpose_cache
        rows = self.row_ids[: self.nnz].astype(np.int64)
        cols = self.column_indices[: self.nnz].astype(np.int64)
        order = np.lexsort((rows, cols)).astype(np.int32)
        counts = np.bincount(cols, minlength=self.n)
        row_offsets_t = np.zeros(self.n + 1, dtype=np.int32)
        np.cumsum(counts, out=row_offsets_t[1:])
        column_indices_t = rows[order].astype(np.int32)

        topo_t = SparseTopology(self.n, self.m, row_offsets_t,
                                column_indices_t, nnz_pad=self.nnz_pad)
        perm = np.full(topo_t.nnz_pad, min(self.nnz, self.nnz_pad - 1),
                       dtype=np.int32)
        perm[: self.nnz] = order
        if self.nnz < self.nnz_pad:
            perm[self.nnz:] = self.nnz
        fill = self.nnz if self.nnz < self.nnz_pad else 0
        inv = np.full(self.nnz_pad, fill, dtype=np.int32)
        inv[order] = np.arange(self.nnz, dtype=np.int32)
        topo_t._transpose_cache = (self, inv)
        self._transpose_cache = (topo_t, perm)
        return self._transpose_cache

    def block(self, bm: int = 64, bk: int = 64):
        key = (bm, bk)
        if key not in self._block_cache:
            from .blocking import build_blocks

            self._block_cache[key] = build_blocks(self, bm=bm, bk=bk)
        return self._block_cache[key]


class SparseMatrix:
    """values + topology, built on the host from a dense matrix."""

    def __init__(self, matrix: np.ndarray, *, pad_to: int = DEFAULT_PAD_TO):
        matrix = np.asarray(matrix, dtype=np.float32)
        values, row_offsets, column_indices = dense_to_csr_arrays(matrix)
        self.topology = SparseTopology(matrix.shape[0], matrix.shape[1],
                                       row_offsets, column_indices,
                                       pad_to=pad_to)
        v = np.zeros(self.topology.nnz_pad, dtype=np.float32)
        v[: self.topology.nnz] = values
        self.values = v
        self.shape = matrix.shape

    @property
    def dense(self) -> np.ndarray:
        out = np.zeros(self.shape, dtype=np.float32)
        t = self.topology
        out[t.row_ids[: t.nnz], t.column_indices[: t.nnz]] = (
            self.values[: t.nnz])
        return out
