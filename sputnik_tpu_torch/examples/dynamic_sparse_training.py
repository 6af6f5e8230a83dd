"""Dynamic sparse training: RigL on a SparseLinear regression (counterpart
of the JAX package's ``examples/dynamic_sparse_training.py``).

Seeds a sparse layer by magnitude-pruning a dense init
(``training.topology_from_dense``), trains it with Adam, and every
``--update-every`` steps runs a RigL connectivity update
(``training.rigl_update_linear``): drop the smallest-|w| connections, grow
the inactive ones with the largest |dense grad|, and carry the values and
Adam's moments across in the same parameter (``nnz`` / ``nnz_pad`` are
held constant). Self-check: the evolved pattern trains to a LOWER loss
than the same run with its initial pattern frozen. ``--layout csr`` (the
default) trains through the flat op set, ``panel`` through the panel ops.

Run:  python -m sputnik_tpu_torch.examples.dynamic_sparse_training
          [--layout csr|panel] [--small] [--device cuda]
"""

from __future__ import annotations

import argparse
import statistics
import time

import numpy as np
import torch

from sputnik_tpu_torch.models import SparseLinear
from sputnik_tpu_torch.training import (dense_linear_grad, rigl_update_linear,
                                        topology_from_dense)

__all__ = ["run", "main"]


def run(dynamic: bool, *, layout: str = "csr", small: bool = False,
        steps: int = 0, update_every: int = 40, density: float = 0.1,
        device="cuda") -> dict:
    """One training run; ``dynamic`` turns the RigL updates on. Returns
    ``{"loss": final loss, "step_ms": [host-clock ms of each step]}``."""
    if small:
        m, n, b = 64, 96, 32
        steps = steps or 120
    else:
        m, n, b = 512, 768, 256
        steps = steps or 400
    device = torch.device(device)
    rng = np.random.RandomState(0)
    # a teacher with planted structure: the sparse layer must REWIRE to
    # find the heavy rows; magnitude at init picks the wrong connections
    w_true = (rng.randn(m, n) * (rng.rand(m, n) < 0.15)).astype(np.float32)
    x = rng.randn(b, n).astype(np.float32)
    y = x @ w_true.T
    w0 = rng.randn(m, n).astype(np.float32) * 0.1
    topo, _ = topology_from_dense(w0, density=density)

    layer = SparseLinear(topo, use_bias=False, layout=layout, device=device)
    with torch.no_grad():          # both runs start from the pruned init
        layer.values.copy_(torch.from_numpy(layer.pack_dense(w0)))
    opt = torch.optim.Adam(layer.parameters(), lr=2e-2)
    xd, yd = torch.from_numpy(x).to(device), torch.from_numpy(y).to(device)
    step_ms = []
    for t in range(steps):
        t0 = time.perf_counter()
        opt.zero_grad(set_to_none=True)
        pred = layer(xd)
        loss = torch.mean((pred - yd) ** 2)
        loss.backward()
        opt.step()
        if device.type == "cuda":
            torch.cuda.synchronize(device)
        step_ms.append((time.perf_counter() - t0) * 1e3)
        if dynamic and (t + 1) % update_every == 0 and t != steps - 1:
            # pred is from the parameters before this step's update: the
            # dense gradient is one step stale, which RigL tolerates
            gy = 2.0 / (b * m) * (pred.detach().cpu().numpy() - y)
            rigl_update_linear(layer, dense_linear_grad(x, gy),
                               fraction=0.3, optimizer=opt)
    return {"loss": float(loss.detach()), "step_ms": step_ms}


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser()
    ap.add_argument("--small", action="store_true",
                    help="tiny config for CPU smoke runs")
    ap.add_argument("--steps", type=int, default=0)
    ap.add_argument("--update-every", type=int, default=40)
    ap.add_argument("--density", type=float, default=0.1)
    ap.add_argument("--layout", default="csr", choices=["csr", "panel"])
    ap.add_argument("--device", default="cuda",
                    help="torch device to train on (default: cuda)")
    args = ap.parse_args(argv)
    if torch.device(args.device).type == "cuda" and \
            not torch.cuda.is_available():
        raise RuntimeError(f"device {args.device!r} requested, but no CUDA "
                           f"device is available")

    kw = dict(layout=args.layout, small=args.small, steps=args.steps,
              update_every=args.update_every, density=args.density,
              device=args.device)
    static = run(False, **kw)
    rigl = run(True, **kw)
    ms = statistics.median(static["step_ms"] + rigl["step_ms"])
    print(f"density={args.density} layout={args.layout} device={args.device}")
    print(f"static-topology final loss : {static['loss']:.5f}")
    print(f"RigL-evolved final loss    : {rigl['loss']:.5f} "
          f"({static['loss'] / max(rigl['loss'], 1e-12):.2f}x lower)")
    print(f"median step {ms:.4f} ms (host clock, synchronized)")
    if not (np.isfinite(rigl["loss"]) and np.isfinite(static["loss"])):
        raise RuntimeError(f"non-finite loss: {rigl} / {static}")
    if not rigl["loss"] < static["loss"]:
        raise RuntimeError(f"RigL {rigl['loss']} did not beat the frozen "
                           f"pattern's {static['loss']}")
    print("OK: evolved sparsity beats the frozen pattern")
    return {"static": static["loss"], "rigl": rigl["loss"], "step_ms": ms}


if __name__ == "__main__":
    main()
