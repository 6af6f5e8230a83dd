"""End-to-end example: train a sparse-attention transformer (counterpart of
the JAX package's ``examples/train_sparse_transformer.py``).

The reference's transformer driver scenario (6 layers, seq 512, hidden 512,
8 heads, ffn 2048, causal masks with a fully-masked row) as a training loop:
sparse-flash attention forward and backward on the CUDA kernels, MSE
against a random target, Adam at lr 1e-3 (``torch.optim.Adam``: the same
update as optax's ``adam`` defaults, eps outside the square root).

Run:  python -m sputnik_tpu_torch.examples.train_sparse_transformer
          [--steps 20] [--small] [--device cuda]
"""

from __future__ import annotations

import argparse
import time

import numpy as np
import torch

from sputnik_tpu_torch.models import SparseTransformer
from sputnik_tpu_torch.patterns import driver_masks

__all__ = ["build", "train_step", "main"]


def build(small: bool, device, seed: int = 0):
    """``(model, x, y)``: the driver config (``small``: the CPU smoke
    config) with weights from ``torch.Generator(seed)`` and input / target
    from ``numpy.random.RandomState(seed)``, on ``device``."""
    if small:
        b, s, h, heads, layers, ffn = 2, 64, 64, 4, 2, 128
    else:
        b, s, h, heads, layers, ffn = 4, 512, 512, 8, 6, 2048
    model = SparseTransformer.from_masks(
        driver_masks(b, s), num_layers=layers, hidden_size=h,
        num_heads=heads, ffn_hidden_size=ffn, use_residual=True,
        use_layernorm=True, activation="gelu",
        generator=torch.Generator().manual_seed(seed)).to(device)
    rng = np.random.RandomState(seed)
    x = torch.from_numpy(rng.randn(b, s, h).astype(np.float32)).to(device)
    y = torch.from_numpy(rng.randn(b, s, h).astype(np.float32)).to(device)
    return model, x, y


def train_step(model, opt, x, y) -> torch.Tensor:
    """One Adam step on ``mean((model(x) - y) ** 2)``; returns the loss
    before the step (detached, on the model's device)."""
    opt.zero_grad(set_to_none=True)
    loss = torch.mean((model(x) - y) ** 2)
    loss.backward()
    opt.step()
    return loss.detach()


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--steps", type=int, default=20)
    ap.add_argument("--small", action="store_true",
                    help="tiny config for CPU smoke runs")
    ap.add_argument("--device", default="cuda",
                    help="torch device to train on (default: cuda)")
    args = ap.parse_args(argv)

    device = torch.device(args.device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(f"device {args.device!r} requested, but no CUDA "
                           f"device is available")
    model, x, y = build(args.small, device)
    opt = torch.optim.Adam(model.parameters(), lr=1e-3)
    losses = []
    t0 = time.perf_counter()
    for i in range(args.steps):
        losses.append(float(train_step(model, opt, x, y)))
        if i % max(args.steps // 10, 1) == 0 or i == args.steps - 1:
            print(f"step {i:4d}  loss {losses[-1]:.6f}")
    print(f"{args.steps} steps on {device} in "
          f"{time.perf_counter() - t0:.2f}s (first step builds the kernels "
          f"and the block metadata)")
    return losses


if __name__ == "__main__":
    main()
