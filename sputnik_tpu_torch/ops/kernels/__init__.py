"""Hand-written CUDA kernels for Hopper, each beside its plain PyTorch version.

Every wrapper launches its kernel for CUDA tensors and runs the plain
version only for CPU tensors; a failed build or launch raises. Each wrapper
counts its own launches in ``<wrapper>.launches``. A raw launch returns a
tensor without a ``grad_fn``: gradients flow through the autograd ops of
``ops.panel_api`` and ``ops.fused_attention``, whose backward launches the
backward kernels. So with grad mode on and an input that requires grad, a
wrapper raises on CUDA and names the autograd op to call instead. The
serving kernels (decode attention, ragged append) have no autograd op:
serving never differentiates.
"""

from __future__ import annotations

import torch

__all__ = ["check_operands", "guard_no_grad", "kernel_wrappers"]


def check_operands(name: str, device: torch.device, **operands) -> None:
    """Each operand is ``(tensor, dtype)``: raise unless it lies on ``device``
    with that dtype and is contiguous."""
    for arg, (t, dtype) in operands.items():
        if t.device != device:
            raise ValueError(f"{name}: {arg} is on {t.device}, "
                             f"expected {device}")
        if t.dtype != dtype:
            raise TypeError(f"{name}: {arg} is {t.dtype}, expected {dtype}")
        if not t.is_contiguous():
            raise ValueError(f"{name}: {arg} must be contiguous")


def guard_no_grad(kernel: str, autograd_op: str, *tensors) -> None:
    """Raise if a raw kernel launch would drop a gradient."""
    if torch.is_grad_enabled() and any(
            t is not None and t.requires_grad for t in tensors):
        raise RuntimeError(
            f"{kernel} is a raw kernel launch and records no gradient; "
            f"call {autograd_op} to train through it")


def kernel_wrappers():
    """The kernel wrappers of the port, by name (each has ``.launches``)."""
    from .bsr_sddmm import bsr_sddmm_panel
    from .bsr_spmm import bsr_spmm_panel
    from .bsr_spmm_t import bsr_spmm_t_panel
    from .decode_attention import decode_attention_kernel
    from .flash_sparse import (flash_sparse_attention_fwd,
                               flash_sparse_bwd_dkv, flash_sparse_bwd_dq,
                               flash_sparse_bwd_fused)
    from .ragged_append import ragged_append_kernel

    return {"bsr_spmm_panel": bsr_spmm_panel,
            "bsr_spmm_t_panel": bsr_spmm_t_panel,
            "bsr_sddmm_panel": bsr_sddmm_panel,
            "flash_sparse_attention_fwd": flash_sparse_attention_fwd,
            "flash_sparse_bwd_fused": flash_sparse_bwd_fused,
            "flash_sparse_bwd_dq": flash_sparse_bwd_dq,
            "flash_sparse_bwd_dkv": flash_sparse_bwd_dkv,
            "decode_attention": decode_attention_kernel,
            "ragged_append": ragged_append_kernel}
