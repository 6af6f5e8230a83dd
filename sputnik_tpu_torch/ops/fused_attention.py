"""Fused sparse attention, forward (counterpart of
``sputnik_tpu/ops/fused_attention.py``).

``fused_sparse_attention(spec, q, k, v)`` computes masked softmax attention
over the score topology of ``spec`` without materialising the scores: one
launch of the sparse-flash kernel for all replicas
(``kernels/flash_sparse.py``), or its plain version for CPU tensors.
There is no backward yet (ROADMAP B10): on CUDA with grad mode on and an
input that requires grad, the kernel wrapper raises.
"""

from __future__ import annotations

import numpy as np

from .batched_panel import BatchedPanelSpec
from .kernels.flash_sparse import flash_sparse_attention_fwd

__all__ = ["fused_sparse_attention"]


def _fused_fwd(spec: BatchedPanelSpec, q, k, v, scale: float, group: int):
    """-> ``(out [R, s, hd], m [R, m_pad], l [R, m_pad])``."""
    meta = spec.flash_meta(q.device)
    return flash_sparse_attention_fwd(
        meta["block_cols"], meta["nblocks"], meta["mask_slot"],
        meta["is_partial"], meta["pmask"], q.contiguous(), k.contiguous(),
        v.contiguous(), heads=spec.heads, max_bpr=meta["max_bpr"],
        scale=scale, group=group)


def fused_sparse_attention(spec: BatchedPanelSpec, q, k, v, scale=None,
                           group: int = 1):
    """``q: [R, s, hd]`` with ``R = spec.B * spec.heads`` -> ``[R, s, hd]``;
    softmax over the nonzeros of each replica's mask row.

    ``group`` (GQA): ``k``/``v`` carry ``R // group`` replicas; each run of
    ``group`` consecutive query replicas reads its shared KV replica
    (``r // group``, the head-minor ``b*heads + h`` fold order)."""
    if q.shape[0] != spec.R:
        raise ValueError(f"replica dim {q.shape[0]} != spec.R {spec.R}")
    if q.shape[1] != spec.m:
        raise ValueError(f"seq {q.shape[1]} != mask rows {spec.m}")
    if group < 1 or spec.R % group or spec.heads % group:
        raise ValueError(f"group {group} must divide heads {spec.heads}")
    if k.shape[0] != q.shape[0] // group or v.shape[0] != q.shape[0] // group:
        raise ValueError(
            f"k/v replicas {k.shape[0]}/{v.shape[0]} != R // group "
            f"{q.shape[0] // group}")
    if scale is None:
        scale = 1.0 / np.sqrt(q.shape[-1])
    return _fused_fwd(spec, q, k, v, float(scale), int(group))[0]
