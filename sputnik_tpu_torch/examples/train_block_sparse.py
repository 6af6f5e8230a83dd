"""Block-structured dynamic sparse training: whole-tile RigL (counterpart of
the JAX package's ``examples/train_block_sparse.py``).

Element-granular RigL drifts to element-random patterns that occupy every
tile, so the panel kernels do dense work through sparse bookkeeping. This
loop keeps the pattern BLOCK-dense:

  * seed with ``patterns.block_random_topology`` (whole ``(bm, bk)`` tiles
    on or off, the tiles of the layer's panel: ``panel_api.DEFAULT_BLOCK``);
  * train a panel-layout ``SparseLinear`` with Adam on a fresh batch a step;
  * every ``--update-every`` steps run ``training.rigl_update_linear(...,
    block=(bm, bk))``: drop the occupied tiles of least ``sum|w|``, grow the
    empty tiles of largest ``sum|dense grad|`` (grown tiles enter at 0),
    ``nnz`` / ``nnz_pad`` kept, Adam's moments carried.

Self-checks: the pattern stays block-dense through every update, and the
evolved pattern reaches a LOWER held-out loss than the same run with its
initial pattern frozen.

Run:  python -m sputnik_tpu_torch.examples.train_block_sparse
          [--small] [--device cuda]
"""

from __future__ import annotations

import argparse
import statistics
import time

import numpy as np
import torch

from sputnik_tpu_torch.models import SparseLinear
from sputnik_tpu_torch.ops.panel_api import DEFAULT_BLOCK
from sputnik_tpu_torch.patterns import (block_random_mask,
                                        block_random_topology)
from sputnik_tpu_torch.training import (block_occupancy, dense_linear_grad,
                                        rigl_update_linear)

__all__ = ["run", "main"]


def run(evolve: bool, *, small: bool = False, density: float = 0.25,
        update_every: int = 50, device="cuda", seed: int = 0) -> dict:
    """One training run; ``evolve`` turns the block-RigL updates on. Returns
    ``{"loss": held-out loss, "step_ms": [host-clock ms of each step]}``;
    raises if an update leaves the block-dense regime."""
    if small:
        m = n = 256
        (bm, bk), steps, upd, batch = (16, 64), 120, 30, 64
    else:
        m = n = 1024
        (bm, bk), steps, upd, batch = DEFAULT_BLOCK, 400, update_every, 256
    device = torch.device(device)
    rng = np.random.RandomState(seed)
    topo = block_random_topology(m, n, bm, bk, density=density, seed=seed)
    layer = SparseLinear(topo, use_bias=True, bm=bm, bk=bk, device=device,
                         generator=torch.Generator().manual_seed(seed))
    # the TRUE weight is block-sparse on a DIFFERENT support: a frozen
    # pattern cannot fit it, an evolved one migrates its tiles toward it
    w_true = (block_random_mask(m, n, bm, bk, density=density,
                                seed=seed + 100)
              * rng.randn(m, n).astype(np.float32) * 0.3)
    wt = torch.from_numpy(w_true.astype(np.float32)).to(device)
    x0 = rng.randn(batch, n).astype(np.float32)
    xd = torch.from_numpy(x0).to(device)
    y0 = x0 @ w_true.T.astype(np.float32)
    opt = torch.optim.Adam(layer.parameters(), lr=3e-2)
    gen = torch.Generator(device=device).manual_seed(seed + 1)
    step_ms = []
    for t in range(steps):
        t0 = time.perf_counter()
        # a FRESH batch per step: with one small batch any support fits the
        # data; fitting the input distribution needs the right tiles
        x_ = torch.randn((batch, n), generator=gen, device=device)
        opt.zero_grad(set_to_none=True)
        loss = torch.mean((layer(x_) - x_ @ wt.T) ** 2)
        loss.backward()
        opt.step()
        if device.type == "cuda":
            torch.cuda.synchronize(device)
        step_ms.append((time.perf_counter() - t0) * 1e3)
        if evolve and (t + 1) % upd == 0 and t + 1 < steps:
            with torch.no_grad():
                pred = layer(xd).cpu().numpy()
            gy = 2 * (pred - y0) / y0.size
            rigl_update_linear(layer, dense_linear_grad(x0, gy),
                               fraction=0.25, optimizer=opt, block=(bm, bk))
            occ = block_occupancy(layer.topology, bm, bk)
            if not set(np.unique(occ)) <= {0, bm * bk}:
                raise RuntimeError("block-RigL left the block-dense regime")
    # held-out loss: the input distribution, not the last minibatch
    xe = torch.from_numpy(np.random.RandomState(seed + 7).randn(
        4 * batch, n).astype(np.float32)).to(device)
    with torch.no_grad():
        held = torch.mean((layer(xe) - xe @ wt.T) ** 2)
    return {"loss": float(held), "step_ms": step_ms}


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser()
    ap.add_argument("--small", action="store_true",
                    help="tiny config for CPU smoke runs")
    ap.add_argument("--density", type=float, default=0.25)
    ap.add_argument("--update-every", type=int, default=50)
    ap.add_argument("--device", default="cuda",
                    help="torch device to train on (default: cuda)")
    args = ap.parse_args(argv)
    if torch.device(args.device).type == "cuda" and \
            not torch.cuda.is_available():
        raise RuntimeError(f"device {args.device!r} requested, but no CUDA "
                           f"device is available")

    kw = dict(small=args.small, density=args.density,
              update_every=args.update_every, device=args.device)
    evolved, frozen = run(True, **kw), run(False, **kw)
    ms = statistics.median(evolved["step_ms"] + frozen["step_ms"])
    print(f"final loss  evolved={evolved['loss']:.5f}  "
          f"frozen={frozen['loss']:.5f}; median step {ms:.4f} ms (host "
          f"clock, synchronized)")
    if not evolved["loss"] < frozen["loss"]:
        raise RuntimeError(f"block-RigL should out-train the frozen pattern "
                           f"({evolved['loss']} vs {frozen['loss']})")
    print("OK: block-RigL evolved pattern out-trains the frozen one, "
          "staying block-dense throughout")
    return {"evolved": evolved["loss"], "frozen": frozen["loss"],
            "step_ms": ms}


if __name__ == "__main__":
    main()
