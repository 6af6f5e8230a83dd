"""Hand-written CUDA kernels for Hopper, each beside its plain PyTorch version.

Every wrapper launches its kernel for CUDA tensors and runs the plain
version only for CPU tensors; a failed build or launch raises. Each wrapper
counts its own launches in ``<wrapper>.launches``. A raw launch returns a
tensor without a ``grad_fn``: gradients flow through the autograd ops of
``ops.panel_api`` (both layouts), ``ops.batched_panel``, ``ops.api`` (the flat softmax),
``ops.fused_attention``, ``ops.int8_api`` (``spmm_qat``,
``attention_qat``) and ``parallel`` (``ring_flash_attention``,
``sharded_spmm_halo``), whose backward launches the backward kernels.
So with grad mode on and an input that requires grad, a wrapper raises on
CUDA and names the autograd op to call instead. The serving kernels (decode and paged attention, ragged and paged append) have
no autograd op: serving never differentiates.
"""

from __future__ import annotations

import torch

__all__ = ["check_operands", "guard_no_grad", "kernel_wrappers", "SMS"]

# Streaming multiprocessors of the card the split plans are sized for (an
# H100 SXM). The split walks of B9 / B10a / B10b / B11a / B11b
# (flash_sparse.SPLIT_CTAS), B13a and B15a (bsr_compressed.SPLIT_CTAS) and
# B19 / B20a (decode_attention.SPLIT_CTAS) cut their walks into chunks from
# this count, and the chunks are merged in a fixed order: a plan read from
# the device would change the merge order, and with it the bits, from card
# to card. So the plans stay fixed, named here once.
SMS = 132


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
    from .batched_panel import (sddmm_bh_kernel, spmm_bh_kernel,
                                spmm_t_bh_kernel)
    from .bsr_compressed import (bsr_sddmm_panel_c, bsr_spmm_panel_c,
                                 bsr_spmm_t_panel_c, c_softmax_apply,
                                 c_softmax_grad, c_softmax_rowsum,
                                 c_softmax_stats)
    from .bsr_sddmm import bsr_sddmm_panel
    from .bsr_spmm import bsr_spmm_panel, bsr_spmm_panel_sel
    from .bsr_spmm_int8 import (bsr_sddmm_panel_int8, bsr_spmm_panel_int8,
                                bsr_spmm_t_panel_int8)
    from .bsr_spmm_t import bsr_spmm_t_panel
    from .decode_attention import decode_attention_kernel
    from .ell_softmax import (ell_softmax_bwd_kernel, ell_softmax_kernel,
                              panel_softmax_bwd_kernel, panel_softmax_kernel)
    from .flash_sparse import (flash_sparse_attention_fwd,
                               flash_sparse_bwd_dkv, flash_sparse_bwd_dq,
                               flash_sparse_bwd_fused,
                               flash_sparse_ring_band_bwd,
                               flash_sparse_ring_band_fwd)
    from .flash_sparse_int8 import (flash_sparse_attention_fwd_int8,
                                    flash_sparse_bwd_dkv_int8,
                                    flash_sparse_bwd_dq_int8)
    from .paged_append import paged_append_kernel
    from .paged_attention import paged_attention_kernel
    from .ragged_append import ragged_append_kernel

    return {"bsr_spmm_panel": bsr_spmm_panel,
            "bsr_spmm_t_panel": bsr_spmm_t_panel,
            "bsr_sddmm_panel": bsr_sddmm_panel,
            "flash_sparse_attention_fwd": flash_sparse_attention_fwd,
            "flash_sparse_bwd_fused": flash_sparse_bwd_fused,
            "flash_sparse_bwd_dq": flash_sparse_bwd_dq,
            "flash_sparse_bwd_dkv": flash_sparse_bwd_dkv,
            "decode_attention": decode_attention_kernel,
            "ragged_append": ragged_append_kernel,
            "paged_attention": paged_attention_kernel,
            "paged_append": paged_append_kernel,
            "spmm_bh": spmm_bh_kernel,
            "sddmm_bh": sddmm_bh_kernel,
            "spmm_t_bh": spmm_t_bh_kernel,
            "ell_softmax": ell_softmax_kernel,
            "ell_softmax_bwd": ell_softmax_bwd_kernel,
            "panel_softmax": panel_softmax_kernel,
            "panel_softmax_bwd": panel_softmax_bwd_kernel,
            "bsr_spmm_panel_int8": bsr_spmm_panel_int8,
            "bsr_spmm_t_panel_int8": bsr_spmm_t_panel_int8,
            "bsr_sddmm_panel_int8": bsr_sddmm_panel_int8,
            "flash_sparse_attention_fwd_int8": flash_sparse_attention_fwd_int8,
            "flash_sparse_bwd_dq_int8": flash_sparse_bwd_dq_int8,
            "flash_sparse_bwd_dkv_int8": flash_sparse_bwd_dkv_int8,
            "bsr_spmm_panel_c": bsr_spmm_panel_c,
            "bsr_spmm_t_panel_c": bsr_spmm_t_panel_c,
            "bsr_sddmm_panel_c": bsr_sddmm_panel_c,
            "c_softmax_stats": c_softmax_stats,
            "c_softmax_apply": c_softmax_apply,
            "c_softmax_rowsum": c_softmax_rowsum,
            "c_softmax_grad": c_softmax_grad,
            "bsr_spmm_panel_sel": bsr_spmm_panel_sel,
            "flash_sparse_ring_band_fwd": flash_sparse_ring_band_fwd,
            "flash_sparse_ring_band_bwd": flash_sparse_ring_band_bwd}
