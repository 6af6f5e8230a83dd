"""End-to-end example: train a Switch-style MoE sparse transformer
(counterpart of the JAX package's ``examples/train_moe_transformer.py``).

Every 2nd layer's MLP is a ``SparseMoE`` (top-2 router, CSR-sparse expert
FFNs at density 0.3 running the batched expert bank: kernel B6 forward, B7
and B8 backward), the other layers keep the dense MLP, and attention is the
sparse-flash path over causal masks. The router's aux loss
(``SparseTransformer.aux_loss()``) is added to the MSE with weight 0.01;
Adam at lr 1e-3 (``torch.optim.Adam``, the same update as optax's ``adam``).

Full config (the default): b=4, s=512, hidden 512, ffn 2048, 6 layers, 8
heads, 8 experts. ``--small``: b=2, s=64, hidden 32, ffn 48, 4 layers, 2
heads, 4 experts. Topologies, input and target come from
``numpy.random.RandomState(seed)`` in the JAX example's order, weights from
``torch.Generator().manual_seed(seed)``.

Self-checks: the loss decreases, the aux loss stays finite, and every MoE
layer's ``w_in_values`` gets a finite nonzero gradient on step 1.

Run:  python -m sputnik_tpu_torch.examples.train_moe_transformer
          [--steps 10] [--small] [--device cuda] [--aux-weight 0.01]
"""

from __future__ import annotations

import argparse
import time

import numpy as np
import torch

from sputnik_tpu_torch.models import SparseTransformer
from sputnik_tpu_torch.topology import SparseTopology

__all__ = ["build", "moe_layers", "train_step", "main"]


def build(small: bool, device, seed: int = 0, mesh=None):
    """``(model, x, y)``: the example's config (``small``: the CPU smoke
    config) on ``device``; ``mesh`` makes every MoE layer expert-parallel
    over its ``ep`` axis (a one-device mesh keeps the same parameters)."""
    if small:
        b, s, h, f, layers, heads, E = 2, 64, 32, 48, 4, 2, 4
    else:
        b, s, h, f, layers, heads, E = 4, 512, 512, 2048, 6, 8, 8
    rng = np.random.RandomState(seed)
    masks = np.broadcast_to(np.tril(np.ones((s, s), np.float32)),
                            (b, s, s)).copy()
    topo_in = SparseTopology.from_dense_mask(
        (rng.rand(f, h) < 0.3).astype(np.float32))
    topo_out = SparseTopology.from_dense_mask(
        (rng.rand(h, f) < 0.3).astype(np.float32))
    model = SparseTransformer.from_masks(
        masks, num_layers=layers, hidden_size=h, num_heads=heads,
        ffn_hidden_size=f, use_residual=True, use_layernorm=True,
        activation="gelu",
        moe=dict(topo_in=topo_in, topo_out=topo_out, num_experts=E, top_k=2,
                 mesh=mesh),
        moe_every=2, generator=torch.Generator().manual_seed(seed),
        device=device)
    x = torch.from_numpy(rng.randn(b, s, h).astype(np.float32) * 0.5)
    y = torch.from_numpy(rng.randn(b, s, h).astype(np.float32) * 0.5)
    return model, x.to(device), y.to(device)


def moe_layers(model):
    """``{index: SparseMoE}`` of the model's MoE layers."""
    return {i: layer.mlp for i, layer in enumerate(model.layers)
            if hasattr(layer.mlp, "w_in_values")}


def train_step(model, opt, x, y, aux_weight: float = 0.01):
    """One Adam step on ``mean((model(x) - y) ** 2) + aux_weight *
    model.aux_loss()``; returns ``(mse, aux)`` before the step (detached,
    on the model's device). The gradients stay in ``.grad``."""
    opt.zero_grad(set_to_none=True)
    mse = torch.mean((model(x) - y) ** 2)
    aux = model.aux_loss()
    (mse + aux_weight * aux).backward()
    opt.step()
    return mse.detach(), aux.detach()


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--steps", type=int, default=10)
    ap.add_argument("--small", action="store_true",
                    help="tiny config for CPU smoke runs")
    ap.add_argument("--device", default="cuda",
                    help="torch device to train on (default: cuda)")
    ap.add_argument("--aux-weight", type=float, default=0.01)
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
        mse, aux = train_step(model, opt, x, y, args.aux_weight)
        losses.append(float(mse))
        if i == 0:
            # expert values get gradients on every MoE layer, step 1
            for j, moe in moe_layers(model).items():
                gv = moe.w_in_values.grad
                if not (torch.isfinite(gv).all() and gv.abs().sum() > 0):
                    raise RuntimeError(f"layer {j}: w_in_values has no "
                                       f"finite nonzero gradient")
        if not np.isfinite(float(aux)):
            raise RuntimeError(f"aux loss blew up at step {i}: {float(aux)}")
        if i % max(args.steps // 10, 1) == 0 or i == args.steps - 1:
            print(f"step {i:4d}  mse {losses[-1]:.6f}  aux {float(aux):.4f}")
    print(f"{args.steps} steps on {device} in "
          f"{time.perf_counter() - t0:.2f}s (first step builds the kernels "
          f"and the block metadata)")
    if args.steps > 1 and not losses[-1] < losses[0]:
        raise RuntimeError(f"loss did not decrease: {losses}")
    print("OK: MoE transformer trains (per-layer experts, aux loss wired)")
    return losses


if __name__ == "__main__":
    main()
