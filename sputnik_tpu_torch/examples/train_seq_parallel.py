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

Full config (the default): s = 16384, hd 64, R 4, a window of s / 8 =
2048 keys, 4 steps, the kernels' 64 x 64 tiles. The specs run on the
``sp`` axis of a ``parallel.Mesh``: by default the one-device mesh of 8
shards, which run one after another on one card; under ``torchrun`` one
shard a rank (NCCL between cards, gloo on the CPU), the world's size the
shard count, each rank holding its shard of the input and the loss a
``psum`` over the ranks. ``--small``: the JAX example's small config, s =
1024, hd 16, R 2. Input from ``numpy.random.RandomState(seed)``.

Run:  python -m sputnik_tpu_torch.examples.train_seq_parallel [--small]
          [--device cuda]
      torchrun --nproc-per-node 4 -m \
          sputnik_tpu_torch.examples.train_seq_parallel [--device cpu]
"""

from __future__ import annotations

import argparse
import datetime
import os
import time

import numpy as np
import torch

from sputnik_tpu_torch.parallel import (Mesh, RingFlashSpec, RowPartition,
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


def build(small: bool, device, seed: int = 0, mesh: Mesh = None) -> dict:
    """The two specs (``"halo/banded"``, ``"ring/causal"``) on the ``sp``
    axis of ``mesh`` (``None``: the one-device mesh of ``NDEV`` shards),
    the input ``x`` ``[R, s, hd]`` and this process's shards of the
    query-sharded ``x_sh`` / target ``t_sh`` on ``device``."""
    cfg = config(small)
    s, hd, R = cfg["s"], cfg["hd"], cfg["R"]
    ndev = mesh.shape["sp"] if mesh is not None else NDEV
    bspec = ShardedFlashSpec(RowPartition(
        causal_topology(s, band=cfg["window"]), ndev, balance=False),
        mesh=mesh)
    rspec = RingFlashSpec(RowPartition(causal_topology(s), ndev,
                                       balance=False), mesh=mesh)
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


def train(attn, spec, x_sh, t_sh, steps: int):
    """``steps`` SGD steps (lr 0.5) on ``mean((attn(x w_q, x w_k, x w_v) -
    t) ** 2)`` over every shard, from unit weights -> (losses, step ms).
    ``spec``'s mesh hands each replicated weight to the shards' work
    through ``pvary`` and sums the loss over its axis (on ranks: the
    weights' gradients and the loss are the whole ones on every rank)."""
    w = {n: torch.ones((), device=x_sh.device, requires_grad=True)
         for n in "qkv"}
    k, comm, ax = x_sh.shape[0], spec.comm, spec.axis
    n_all = t_sh[0].numel() * spec.part.ndev
    losses, ms = [], []
    for _ in range(steps):
        t0 = time.perf_counter()
        ws = {n: comm.pvary([p] * k, ax)[0] for n, p in w.items()}
        sq = (attn(x_sh * ws["q"], x_sh * ws["k"], x_sh * ws["v"])
              - t_sh).square()
        loss = comm.psum(list(sq.flatten(1).sum(1)), ax)[0] / n_all
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
    if "RANK" not in os.environ:
        return _run(args, device, None)
    import torch.distributed as dist

    if device.type == "cuda":
        torch.cuda.set_device(int(os.environ.get("LOCAL_RANK", 0)))
    dist.init_process_group("nccl" if device.type == "cuda" else "gloo",
                            timeout=datetime.timedelta(seconds=600))
    try:
        mesh = Mesh({"sp": dist.get_world_size()}, distributed=True)
        return _run(args, mesh.device, mesh)
    finally:
        dist.destroy_process_group()


def _run(args, device, mesh) -> dict:
    b = build(args.small, device, mesh=mesh)
    cfg, rspec = b["cfg"], b["rspec"]
    paths = {
        "halo/banded": (b["bspec"], lambda q, k, v:
                        flash_attention_kv_sharded(b["bspec"], q, k, v),
                        cfg["window"]),
        "ring/causal": (rspec, lambda q, k, v: ring_flash_attention(
            rspec, q, k, v), None),
    }
    results = {}
    for name, (spec, attn, window) in paths.items():
        with torch.no_grad():
            got = attn(b["x_sh"], b["x_sh"], b["x_sh"])
            want = rspec.shard_queries(dense_reference(b["x"], window))
            err = (got - want).abs().max().item()
        if not err < 1e-3:
            raise RuntimeError(f"{name}: {err} from dense attention at init")
        losses, ms = train(attn, spec, b["x_sh"], b["t_sh"], cfg["steps"])
        if not (np.isfinite(losses).all() and losses[-1] < losses[0]):
            raise RuntimeError(f"{name}: the loss did not fall ({losses})")
        results[name] = dict(err=err, losses=losses, step_ms=ms)
        print(f"{name}: oracle err {err:.2e}, loss {losses[0]:.6f} -> "
              f"{losses[-1]:.6f} over {cfg['steps']} steps, step ms "
              f"{', '.join(f'{t:.2f}' for t in ms)}", flush=True)
    where = (f"shard {rspec.here[0]} of {rspec.part.ndev} on {device}"
             if mesh is not None else
             f"{rspec.part.ndev} shards on {device}")
    print(f"OK ({where}, s={cfg['s']}, hd={cfg['hd']}, R={cfg['R']})",
          flush=True)
    return results


if __name__ == "__main__":
    main()
