"""Sequence-parallel training: a long context split across shards
(counterpart of the JAX package's ``examples/train_seq_parallel.py``).

A miniature training loop whose attention runs sequence-parallel, each
shard owning a band of query rows and a band of K / V rows:

  * a banded (causal local-window) topology -> ``flash_attention_kv_sharded``
    (the halo exchange, split into interior and halo passes; psum-free
    backward);
  * the full-causal topology -> ``ring_flash_attention`` (K / V bands
    rotate; psum-free two-pass backward).

Each trains a toy regression (predict the previous position) by SGD on
three scalar weights at lr 0.5. Self-checks: each path against dense
attention at init, computed on the device in row chunks (a full score
tensor at the full config would be 4.3 GB), and the loss falls.

Full config (the default): 8 shards of s = 16384, hd 64, R 4, a window of
s / 8 = 2048 keys, 4 steps, the kernels' 64 x 64 tiles, on one card (the
shards run one after another: ``ROADMAP.md`` A9c puts them on separate
cards). ``--small``: the JAX example's small config, s = 1024, hd 16, R 2.
Input from ``numpy.random.RandomState(seed)``.

Run:  python -m sputnik_tpu_torch.examples.train_seq_parallel [--small]
          [--device cuda]
"""

from __future__ import annotations

import argparse
import time

import numpy as np
import torch

from sputnik_tpu_torch.parallel import (RingFlashSpec, RowPartition,
                                        ShardedFlashSpec,
                                        flash_attention_kv_sharded,
                                        ring_flash_attention)
from sputnik_tpu_torch.patterns import causal_topology

__all__ = ["NDEV", "config", "build", "dense_reference", "train", "main"]

NDEV = 8
TILE = 64          # the kernels' bm = bk


def config(small: bool) -> dict:
    """The example's sizes: ``s``, ``hd``, ``R``, ``steps`` and the band's
    ``window``."""
    s, hd, R = (NDEV * 128, 16, 2) if small else (NDEV * 2048, 64, 4)
    return dict(s=s, hd=hd, R=R, steps=4, window=max(s // 8, TILE))


def build(small: bool, device, seed: int = 0) -> dict:
    """The two specs (``"halo/banded"``, ``"ring/causal"``), the input ``x``
    ``[R, s, hd]`` and its query-sharded ``x_sh`` / target ``t_sh`` on
    ``device``."""
    cfg = config(small)
    s, hd, R = cfg["s"], cfg["hd"], cfg["R"]
    bspec = ShardedFlashSpec(RowPartition(
        causal_topology(s, band=cfg["window"]), NDEV, balance=False))
    rspec = RingFlashSpec(RowPartition(causal_topology(s), NDEV,
                                       balance=False))
    rng = np.random.RandomState(seed)
    x = (rng.randn(R, s, hd) * 0.5).astype(np.float32)
    target = np.roll(x, 1, axis=1)            # predict the previous position
    # natural order: shard d owns query and key rows [d * s / 8, ...)
    x_sh, t_sh = (rspec.shard_queries(torch.from_numpy(a)).contiguous()
                  .to(device) for a in (x, target))
    return dict(cfg=cfg, bspec=bspec, rspec=rspec, x_sh=x_sh, t_sh=t_sh,
                x=torch.from_numpy(x).to(device))


def dense_reference(x, window, chunk: int = 2048):
    """Masked softmax attention of ``x [R, s, hd]`` with itself as q, k and
    v, on ``x``'s device, ``chunk`` query rows at a time: causal, within
    ``window`` keys (None: the whole causal prefix)."""
    R, s, hd = x.shape
    out = torch.empty_like(x)
    j = torch.arange(s, device=x.device)[None, :]
    for r0 in range(0, s, chunk):
        i = torch.arange(r0, min(r0 + chunk, s), device=x.device)[:, None]
        keep = j <= i
        if window is not None:
            keep &= j > i - window
        sc = (x[:, r0: r0 + chunk] @ x.transpose(1, 2)) * hd ** -0.5
        out[:, r0: r0 + chunk] = torch.softmax(
            sc.masked_fill(~keep, -1e30), -1) @ x
    return out


def train(attn, x_sh, t_sh, steps: int):
    """``steps`` SGD steps (lr 0.5) on ``mean((attn(x w_q, x w_k, x w_v) -
    t) ** 2)`` from unit weights -> (losses, step ms)."""
    w = {n: torch.ones((), device=x_sh.device, requires_grad=True)
         for n in "qkv"}
    losses, ms = [], []
    for _ in range(steps):
        t0 = time.perf_counter()
        loss = (attn(x_sh * w["q"], x_sh * w["k"], x_sh * w["v"])
                - t_sh).square().mean()
        loss.backward()
        with torch.no_grad():
            for p in w.values():
                p -= 0.5 * p.grad
                p.grad = None
        losses.append(loss.item())
        ms.append((time.perf_counter() - t0) * 1e3)
    return losses, ms


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser()
    ap.add_argument("--small", action="store_true",
                    help="the JAX example's small config")
    ap.add_argument("--device", default="cuda",
                    help="torch device (default: cuda)")
    args = ap.parse_args(argv)
    device = torch.device(args.device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(f"device {args.device!r} requested, but no CUDA "
                           f"device is available")
    b = build(args.small, device)
    cfg, rspec = b["cfg"], b["rspec"]
    paths = {
        "halo/banded": (lambda q, k, v: flash_attention_kv_sharded(
            b["bspec"], q, k, v), cfg["window"]),
        "ring/causal": (lambda q, k, v: ring_flash_attention(
            rspec, q, k, v), None),
    }
    results = {}
    for name, (attn, window) in paths.items():
        with torch.no_grad():
            got = rspec.unshard_output(attn(b["x_sh"], b["x_sh"], b["x_sh"]))
            err = (got - dense_reference(b["x"], window)).abs().max().item()
        if not err < 1e-3:
            raise RuntimeError(f"{name}: {err} from dense attention at init")
        losses, ms = train(attn, b["x_sh"], b["t_sh"], cfg["steps"])
        if not (np.isfinite(losses).all() and losses[-1] < losses[0]):
            raise RuntimeError(f"{name}: the loss did not fall ({losses})")
        results[name] = dict(err=err, losses=losses, step_ms=ms)
        print(f"{name}: oracle err {err:.2e}, loss {losses[0]:.6f} -> "
              f"{losses[-1]:.6f} over {cfg['steps']} steps, step ms "
              f"{', '.join(f'{t:.2f}' for t in ms)}", flush=True)
    print(f"OK ({NDEV} shards of s={cfg['s']}, hd={cfg['hd']}, "
          f"R={cfg['R']} on {device})", flush=True)
    return results


if __name__ == "__main__":
    main()
