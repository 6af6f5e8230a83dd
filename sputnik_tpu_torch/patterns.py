"""Sparsity-pattern generators (numpy, host side).

Counterpart of ``sputnik_tpu/patterns.py``: the same generators with the
same seeds give the same masks, so a test can feed one pattern to both
packages. Every generator takes an explicit seed or
``numpy.random.Generator``.
"""

from __future__ import annotations

from typing import Optional, Sequence

import numpy as np

__all__ = [
    "uniform_mask",
    "sparsify_uniform",
    "causal_mask",
    "driver_masks",
    "local_window_mask",
    "local_window_topology",
    "causal_topology",
    "random_mask_batch",
    "block_random_mask",
    "block_random_topology",
]


def _rng(seed) -> np.random.Generator:
    if isinstance(seed, np.random.Generator):
        return seed
    return np.random.default_rng(seed)


def sparsify_uniform(dense: np.ndarray, sparsity: float, *,
                     round_to: int = 1, seed=0) -> np.ndarray:
    """Zero a uniform random subset so that ``1 - sparsity`` survives, with
    the surviving nonzero count rounded *up* to a multiple of ``round_to``."""
    if not 0.0 <= sparsity < 1.0:
        raise ValueError("sparsity must be in [0, 1)")
    dense = np.array(dense, copy=True)
    if sparsity == 0.0:
        return dense
    size = dense.size
    num_dormant = int(round(sparsity * size))
    if round_to > 1:
        nnz = size - num_dormant
        nnz = (nnz + round_to - 1) // round_to * round_to
        num_dormant = size - nnz
    dormant = _rng(seed).choice(size, max(num_dormant, 0), replace=False)
    flat = dense.reshape(-1)
    flat[dormant] = 0.0
    return flat.reshape(dense.shape)


def uniform_mask(m: int, n: int, *, sparsity: float = 0.9,
                 round_to: int = 4, seed=0) -> np.ndarray:
    """0/1 mask with ~``(1-sparsity)`` ones, nnz rounded to ``round_to``."""
    return (sparsify_uniform(np.ones((m, n), np.float32), sparsity,
                             round_to=round_to, seed=seed) != 0
            ).astype(np.float32)


def causal_mask(s: int, *, band: Optional[int] = None) -> np.ndarray:
    """Lower-triangular mask; optional banding to ``band`` past diagonals."""
    mask = np.tril(np.ones((s, s), np.float32))
    if band is not None:
        mask *= np.triu(np.ones((s, s), np.float32), -band + 1)
    return mask


def driver_masks(b: int, s: int) -> np.ndarray:
    """Per-batch causal masks ``[b, s, s]`` with row ``s // 2`` fully
    masked: the reference transformer driver's scenario, degenerate row
    included (``tests/transformer/driver.py:8-14`` of Torch-Sputnik)."""
    m = causal_mask(s)
    m[s // 2, :] = 0.0
    return np.broadcast_to(m, (b, s, s)).copy()


def local_window_mask(s: int, window: int) -> np.ndarray:
    """Symmetric local-attention window."""
    i = np.arange(s)[:, None]
    j = np.arange(s)[None, :]
    return (np.abs(i - j) < window).astype(np.float32)


def random_mask_batch(b: int, m: int, n: int, *,
                      sparsities: Sequence[float] = (0.2, 0.5),
                      round_to: int = 4, seed=0) -> np.ndarray:
    """Per-batch-element masks with alternating sparsities."""
    rng = _rng(seed)
    masks = [uniform_mask(m, n, sparsity=sparsities[i % len(sparsities)],
                          round_to=round_to, seed=rng) for i in range(b)]
    return np.stack(masks)


def block_random_mask(m: int, n: int, bm: int, bk: int, *, density: float,
                      seed=0, balanced: bool = True) -> np.ndarray:
    """Random BLOCK-structured 0/1 mask: whole ``(bm, bk)`` tiles are on or
    off, so the block kernels' work scales with the density. ``balanced``
    gives every block-row the same number of occupied blocks."""
    if not 0.0 < density <= 1.0:
        raise ValueError("density must be in (0, 1]")
    if bm < 1 or bk < 1:
        raise ValueError("tile dims must be positive")
    rng = _rng(seed)
    mb = -(-m // bm)
    kb = -(-n // bk)
    occ = np.zeros((mb, kb), bool)
    if balanced:
        bpr = max(1, int(round(density * kb)))
        for i in range(mb):
            occ[i, rng.choice(kb, min(bpr, kb), replace=False)] = True
    else:
        total = max(1, int(round(density * mb * kb)))
        flat = rng.choice(mb * kb, min(total, mb * kb), replace=False)
        occ.ravel()[flat] = True
    mask = np.kron(occ, np.ones((bm, bk), np.float32))
    return np.ascontiguousarray(mask[:m, :n])


def block_random_topology(m: int, n: int, bm: int, bk: int, *,
                          density: float, seed=0, balanced: bool = True):
    """``SparseTopology`` over a :func:`block_random_mask` pattern."""
    from .topology import SparseTopology

    return SparseTopology.from_dense_mask(
        block_random_mask(m, n, bm, bk, density=density, seed=seed,
                          balanced=balanced))


def _analytic_topology(cls, s, starts, ends):
    """CSR assembly for the analytic builders; offsets accumulate in int64
    and a pattern past int32 indexing is rejected."""
    lengths = ends - starts
    offsets64 = np.zeros(s + 1, np.int64)
    np.cumsum(lengths, out=offsets64[1:])
    if offsets64[-1] >= np.iinfo(np.int32).max:
        raise ValueError(
            f"analytic topology has {int(offsets64[-1])} nonzeros, "
            "exceeding int32 indexing; use a banded/windowed pattern")
    cols = np.concatenate(
        [np.arange(a, b, dtype=np.int32) for a, b in zip(starts, ends)])
    return cls(s, s, offsets64.astype(np.int32), cols)


def causal_topology(s: int, *, band: Optional[int] = None):
    """Causal (optionally banded) topology built in CSR without a dense
    ``[s, s]`` mask."""
    from .topology import SparseTopology

    starts = (np.maximum(np.arange(s) - (band - 1), 0)
              if band is not None else np.zeros(s, np.int64))
    ends = np.arange(s, dtype=np.int64) + 1
    return _analytic_topology(SparseTopology, s, starts, ends)


def local_window_topology(s: int, window: int):
    """Symmetric local-window topology (|i-j| < window) built in CSR."""
    from .topology import SparseTopology

    i = np.arange(s, dtype=np.int64)
    starts = np.maximum(i - (window - 1), 0)
    ends = np.minimum(i + window, s)
    return _analytic_topology(SparseTopology, s, starts, ends)
