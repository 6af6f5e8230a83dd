"""The flat, differentiable op set (counterpart of ``sputnik_tpu/ops/api.py``).

Torch-Sputnik's calling convention: a ``SparseTopology`` and CSR-ordered
``values [nnz_pad]`` per call. The rank rules and errors are the JAX
package's:

  * ``spmm(topo, values[nnz], dense[k, n]) -> [m, n]``; replicated
    ``values[r, nnz], dense[r, k, n] -> [r, m, n]``;
  * ``left_spmm(topo, values[nnz], dense[r, k, n]) -> [r, m, n]``: one
    shared matrix, the replicas folded into the dense columns (one launch;
    the values' gradient sums over the replicas);
  * ``sddmm(topo, lhs[m, d], rhs[n, d]) -> [nnz]``, or 3-D ``-> [r, nnz]``;
  * ``sparse_softmax(topo, values)`` over each row's nonzeros,
    ``[nnz]`` or ``[r, nnz]``;
  * ``csr_transpose(topo, values) -> (topo_t, values_t)``: the topology's
    precomputed permutation, a differentiable ``index_select``;
  * ``spmm_bias_relu`` (alias ``spmm_bias``): ``relu(A @ dense +
    bias[:, None])``.

Gradients keep the reference's algebra: SpMM <- SDDMM + SpMM^T, SDDMM <-
SpMM + SpMM^T, softmax <- ``p * (g - rowsum(p * g))``.

Routes, chosen per thread by ``set_backend`` with the JAX package's names,
so code written against ``sputnik_tpu`` runs unchanged:

  * ``"xla"``: the plain PyTorch oracle (``plain_ops``) on any device,
    differentiated by autograd as it stands;
  * ``"pallas"``: the panel route (``dispatch``): the CUDA kernels on CUDA
    tensors, their plain versions on CPU tensors (as interpret mode runs
    the Pallas kernels off a TPU);
  * ``"auto"`` (default): the kernels on CUDA tensors at every size, the
    oracle on CPU tensors.

The oracle gathers ``[nnz_pad, n]`` rows, which at 4096^3 d=0.1 is 27 GB;
the kernel route never materialises it.
"""

from __future__ import annotations

import threading
from typing import Tuple

import torch

from . import dispatch, plain_ops

__all__ = ["spmm", "left_spmm", "sddmm", "sparse_softmax", "csr_transpose",
           "spmm_bias_relu", "spmm_bias", "set_backend", "get_backend"]

_BACKENDS = ("auto", "xla", "pallas")
_state = threading.local()


def set_backend(name: str) -> None:
    """Route of this thread's flat ops: ``"auto"``, ``"xla"`` or
    ``"pallas"`` (module docstring)."""
    if name not in _BACKENDS:
        raise ValueError(f"backend must be one of {_BACKENDS}, got {name!r}")
    _state.backend = name


def get_backend() -> str:
    return getattr(_state, "backend", "auto")


def _kernel_route(x: torch.Tensor) -> bool:
    backend = get_backend()
    return backend == "pallas" or (backend == "auto" and x.is_cuda)


def _promote(a, b):
    dt = torch.promote_types(a.dtype, b.dtype)
    return a.to(dt), b.to(dt)


def _per_replica(fn, *args):
    """The oracle on ``[r, ...]`` operands: one call per replica."""
    return torch.stack([fn(*xs) for xs in zip(*args)])


# -- the oracle (plain_ops on the topology's host arrays) ---------------------


def _spmm_oracle(topo, values, dense):
    values, dense = _promote(values, dense)
    if values.dim() == 2:
        return _per_replica(lambda v, d: _spmm_oracle(topo, v, d),
                            values, dense)
    return plain_ops.spmm(values, topo.column_indices, topo.row_ids, topo.m,
                          dense)


def _sddmm_oracle(topo, lhs, rhs):
    lhs, rhs = _promote(lhs, rhs)
    if lhs.dim() == 3:
        return _per_replica(lambda a, b: _sddmm_oracle(topo, a, b), lhs, rhs)
    return plain_ops.sddmm(lhs, rhs, topo.row_ids, topo.column_indices,
                           topo.valid)


# -- the public ops -----------------------------------------------------------


def _check_dense(topo, dense):
    if dense.shape[-2] != topo.n:
        raise ValueError(f"dense rows {dense.shape[-2]} != sparse cols "
                         f"{topo.n}")


def _spmm(topo, values, dense):
    if _kernel_route(dense):
        return dispatch.spmm(topo, values, dense)
    return _spmm_oracle(topo, values, dense)


def spmm(topo, values, dense):
    """``A_sp @ B``. 2-D: ``values[nnz], dense[k, n] -> [m, n]``;
    replicated: ``values[r, nnz], dense[r, k, n] -> [r, m, n]``."""
    _check_dense(topo, dense)
    if (values.dim(), dense.dim()) in ((1, 2), (2, 3)):
        return _spmm(topo, values, dense)
    raise ValueError(f"bad ranks: values {tuple(values.shape)}, dense "
                     f"{tuple(dense.shape)}")


def _fold(dense):
    """``[r, k, n] -> [k, r * n]``: replicas become dense columns."""
    r, k, n = dense.shape
    return dense.permute(1, 0, 2).reshape(k, r * n)


def _unfold(out, r):
    """``[m, r * n] -> [r, m, n]``."""
    return out.reshape(out.shape[0], r, -1).permute(1, 0, 2)


def left_spmm(topo, values, dense):
    """One shared sparse matrix times batched dense: ``values[nnz],
    dense[r, k, n] -> [r, m, n]`` (or 2-D dense as ``spmm``), the replicas
    folded into the dense columns: one launch."""
    _check_dense(topo, dense)
    if values.dim() != 1:
        raise ValueError(f"left_spmm values must be 1-D, got "
                         f"{tuple(values.shape)}")
    if dense.dim() == 2:
        return _spmm(topo, values, dense)
    if dense.dim() == 3:
        return _unfold(_spmm(topo, values, _fold(dense)), dense.shape[0])
    raise ValueError(f"bad dense rank: {tuple(dense.shape)}")


def sddmm(topo, lhs, rhs):
    """Sampled ``L @ R^T`` at the topology's nonzeros: ``lhs[m, d],
    rhs[n, d] -> values[nnz]``; 3-D operands -> ``[r, nnz]``."""
    if lhs.shape[-2] != topo.m or rhs.shape[-2] != topo.n:
        raise ValueError(f"lhs rows {lhs.shape[-2]} != m={topo.m} or rhs "
                         f"rows {rhs.shape[-2]} != n={topo.n}")
    if (lhs.dim(), rhs.dim()) not in ((2, 2), (3, 3)):
        raise ValueError(f"bad ranks: lhs {tuple(lhs.shape)}, rhs "
                         f"{tuple(rhs.shape)}")
    if _kernel_route(lhs):
        return dispatch.sddmm(topo, lhs, rhs)
    return _sddmm_oracle(topo, lhs, rhs)


def sparse_softmax(topo, values):
    """Row-wise softmax over the nonzeros; ``[nnz]`` or ``[r, nnz]``. A row
    without nonzeros has no slot; padding slots give 0."""
    if values.dim() not in (1, 2):
        raise ValueError(f"bad values rank: {tuple(values.shape)}")
    if _kernel_route(values):
        return dispatch.sparse_softmax(topo, values)
    return plain_ops.sparse_softmax(values, topo.row_ids, topo.valid, topo.m)


def csr_transpose(topo, values) -> Tuple[object, torch.Tensor]:
    """CSR -> CSC as the topology's precomputed permutation: returns
    ``(topo_t, values_t)``; differentiable (an ``index_select``)."""
    if values.dim() not in (1, 2):
        raise ValueError(f"bad values rank: {tuple(values.shape)}")
    topo_t, perm = topo.transpose()
    perm = torch.as_tensor(perm, dtype=torch.int64, device=values.device)
    return topo_t, values.index_select(-1, perm)


def spmm_bias_relu(topo, values, dense, bias):
    """Fused ``relu(A_sp @ B + bias[:, None])``; ``bias [m]``. Ranks as
    ``spmm``, plus shared ``values[nnz]`` with ``dense[r, k, n]`` (folded
    into the columns, one launch)."""
    _check_dense(topo, dense)
    if tuple(bias.shape) != (topo.m,):
        raise ValueError(f"bias must be [m]={topo.m}, got "
                         f"{tuple(bias.shape)}")
    ranks = (values.dim(), dense.dim())
    if ranks not in ((1, 2), (1, 3), (2, 3)):
        raise ValueError(f"bad ranks: values {tuple(values.shape)}, dense "
                         f"{tuple(dense.shape)}")
    if _kernel_route(dense):
        if ranks == (1, 3):
            return _unfold(dispatch.spmm_bias_relu(
                topo, values, _fold(dense), bias), dense.shape[0])
        return dispatch.spmm_bias_relu(topo, values, dense, bias)
    if ranks == (1, 3):
        values = values.expand(dense.shape[0], -1)
    out = _spmm_oracle(topo, values, dense)
    return torch.relu(out + bias.to(out.dtype)[:, None])


# The reference's phantom binding name.
spmm_bias = spmm_bias_relu
