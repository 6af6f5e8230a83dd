"""Int8 (W8A8) sparse serving (counterpart of the JAX package's
``examples/serve_sparse_int8.py``).

Quantises a sparse layer's weight once at load time (blockwise int8), then
serves forward passes through the int8 op family: causal sparse-flash
attention (``int8.attention_int8``, kernel B18a) and the sparse output
projection (``int8.spmm_int8``, B16a). It prints the forward time of the
int8 path and of the fp32 path (B9 + B1) and the int8 relative error, which
must stay under 0.1.

The full config is the JAX example's chip config: h=1024, s=2048, 8 heads
(hd=128), a 1024 x 1024 weight at d=0.1 on a 128 x 128 panel. The
attention runs the port's 64 x 64 flash tile, which is also its
quantisation grid (JAX's chip example passes 512 x 1024, a TPU tile
choice). ``--small`` is the JAX example's CPU config (h=256, s=128, 4
heads). On the CPU both paths run under ``set_backend("pallas")``, the
kernels' plain versions, as the JAX example runs its kernels in interpret
mode off a TPU; times are taken with CUDA events on the card only.
``--device`` never falls back by itself.

Run:  python -m sputnik_tpu_torch.examples.serve_sparse_int8 [--small]
          [--device cuda]
"""

from __future__ import annotations

import argparse

import numpy as np
import torch

from sputnik_tpu_torch import int8
from sputnik_tpu_torch.many_mask import ManyMaskTopology
from sputnik_tpu_torch.ops import api
from sputnik_tpu_torch.ops import panel_api as P
from sputnik_tpu_torch.ops.batched_panel import BatchedPanelSpec
from sputnik_tpu_torch.ops.fused_attention import (fused_sparse_attention,
                                                   warm_flash_meta)
from sputnik_tpu_torch.topology import SparseMatrix

__all__ = ["main", "setup", "ITERS"]

ITERS = 20      # timed calls of each forward, after one warm-up call


def setup(small: bool, device) -> dict:
    """The example's weight (fp32 panel and its int8 quantisation), causal
    attention spec and input ``x [heads, s, hd]`` on ``device``, from
    ``RandomState(0)``, with its two forward functions."""
    device = torch.device(device)
    h, s, heads = (256, 128, 4) if small else (1024, 2048, 8)
    hd = h // heads
    rng = np.random.RandomState(0)
    # the sparse output projection (90% sparse), quantised once
    w = ((rng.rand(h, h) < 0.1) * rng.randn(h, h)).astype(np.float32) * 0.05
    mat = SparseMatrix(w)
    spec = P.PanelSpec(mat.topology, bm=128, bk=128)
    panel_np = P.values_to_panel_np(mat.topology, mat.values, spec.bm,
                                    spec.bk)
    panel = torch.from_numpy(panel_np).to(device)
    qp = int8.quantize_panel(spec, panel_np).to(device)
    spec.meta(device)
    # causal attention, metadata built once
    masks = np.tril(np.ones((1, s, s), np.float32))
    bspec = BatchedPanelSpec.from_many_mask(
        ManyMaskTopology.from_dense_masks(masks), heads=heads)
    warm_flash_meta(bspec, device, backward=False, hd=hd)
    x = torch.from_numpy(rng.randn(heads, s, hd).astype(np.float32)).to(
        device)

    def project(ctx, fn):
        flat = ctx.transpose(0, 1).reshape(s, h)      # [s, h]
        return fn(flat.T).T

    def forward_f32(x):
        ctx = fused_sparse_attention(bspec, x, x, x)
        return project(ctx, lambda d: P.spmm(spec, panel, d))

    def forward_int8(x):
        ctx = int8.attention_int8(bspec, x, x, x)
        return project(ctx, lambda d: int8.spmm_int8(spec, qp, d))

    return dict(h=h, s=s, heads=heads, spec=spec, qp=qp, bspec=bspec, x=x,
                project=project, forward_f32=forward_f32,
                forward_int8=forward_int8)


def _cuda_ms(fn, x, iters=ITERS):
    """Milliseconds per call: CUDA events around ``iters`` calls after a
    warm-up call."""
    fn(x)
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn(x)
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser()
    ap.add_argument("--small", action="store_true",
                    help="the CPU smoke config")
    ap.add_argument("--device", default="cuda",
                    help="torch device to serve on (default: cuda)")
    args = ap.parse_args(argv)
    device = torch.device(args.device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(f"device {args.device!r} requested, but no CUDA "
                           f"device is available")

    ex = setup(args.small, device)
    x = ex["x"]
    on_card = device.type == "cuda"
    backend = api.get_backend()
    if not on_card:
        api.set_backend("pallas")     # the kernels' plain int8 algebra
    try:
        with torch.no_grad():
            y32, y8 = ex["forward_f32"](x), ex["forward_int8"](x)
            rel = float((y8 - y32).abs().max() / y32.abs().max())
            ms32 = _cuda_ms(ex["forward_f32"], x) if on_card else None
            ms8 = _cuda_ms(ex["forward_int8"], x) if on_card else None
    finally:
        api.set_backend(backend)

    def show(ms):
        return f"{ms:.4f} ms" if ms is not None else "not measured (CPU)"

    print(f"serving fwd (h={ex['h']}, s={ex['s']}, heads={ex['heads']}): "
          f"fp32 {show(ms32)}  int8 {show(ms8)}  int8 rel err {rel:.4f}")
    if not rel < 0.1:
        raise RuntimeError(f"int8 relative error {rel} is not below 0.1")
    return dict(h=ex["h"], s=ex["s"], heads=ex["heads"], ms_fp32=ms32,
                ms_int8=ms8, rel_err=rel, y_fp32=y32, y_int8=y8)


if __name__ == "__main__":
    main()
