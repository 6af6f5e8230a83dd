"""Tensor / data-parallel serving with ``parallel.TPLMServer``, on one device
or one rank a position of a ``torch.distributed`` world.

Builds a SparseLM from a seed (the full config is benchmarks/serving.py's:
b=4, P=1024, h=1024, 8 heads, 6 layers, ffn 4096, V=32000, bk=1024;
``--small`` is a CPU smoke config), keeps its core on the CPU and moves the
replicated embedding and final LayerNorm to the serving device, so that a
rank holds only its own view of the sharded weights. Then greedy
``generate`` of ``--tokens`` tokens; prints this process's ms/token. With
``--check`` it also serves the same rows on a one-device mesh in this
process and fails unless the tokens are equal.

Run on one device (every position on it):

    python -m sputnik_tpu_torch.examples.serve_tp --tp 2 [--dp 2]
        [--paged] [--small --device cpu]

or one position a rank (NCCL on cards, gloo on the CPU); ``torchrun`` sets
the world's size, ranks and address (on ``localhost``):

    torchrun --nproc-per-node 4 -m sputnik_tpu_torch.examples.serve_tp \\
        --dp 2 --tp 2 [--check]
"""

from __future__ import annotations

import argparse
import datetime
import json
import os
import time

import numpy as np
import torch

from sputnik_tpu_torch.models import SparseLM
from sputnik_tpu_torch.parallel import Mesh, TPLMServer

__all__ = ["main"]


def config(small: bool) -> dict:
    if small:
        return dict(b=4, P=128, h=64, heads=4, layers=2, ffn=128, V=97,
                    bk=128)
    return dict(b=4, P=1024, h=1024, heads=8, layers=6, ffn=4096, V=32000,
                bk=1024)


def _sync(device):
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser()
    ap.add_argument("--tp", type=int, default=2, help="tensor-parallel size")
    ap.add_argument("--dp", type=int, default=1, help="data-parallel size")
    ap.add_argument("--paged", action="store_true",
                    help="serve from KV page pools (one a position)")
    ap.add_argument("--small", action="store_true",
                    help="tiny config for CPU smoke runs")
    ap.add_argument("--tokens", type=int, default=64,
                    help="tokens to generate")
    ap.add_argument("--device", default="cuda",
                    help="torch device (default: cuda; a rank of an NCCL "
                         "world serves on cuda:LOCAL_RANK)")
    ap.add_argument("--check", action="store_true",
                    help="compare with a one-device mesh in this process")
    args = ap.parse_args(argv)
    device = torch.device(args.device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(f"device {args.device!r} requested, but no CUDA "
                           f"device is available")
    distributed = "RANK" in os.environ
    if distributed:
        import torch.distributed as dist

        if device.type == "cuda":
            torch.cuda.set_device(int(os.environ.get("LOCAL_RANK", 0)))
        dist.init_process_group("nccl" if device.type == "cuda" else "gloo",
                                timeout=datetime.timedelta(seconds=120))
    try:
        return _serve(args, device, distributed)
    finally:
        if distributed:
            dist.destroy_process_group()


def _serve(args, device, distributed) -> dict:
    cfg = config(args.small)
    axes = {"dp": args.dp, "tp": args.tp} if args.dp > 1 else {"tp": args.tp}
    mesh = (Mesh(axes, distributed=True) if distributed
            else Mesh(axes, device=device))
    b, P, V = cfg["b"], cfg["P"], cfg["V"]
    masks = np.broadcast_to(np.tril(np.ones((P, P), np.float32)),
                            (b, P, P)).copy()
    lm = SparseLM.from_masks(
        masks, vocab_size=V, num_layers=cfg["layers"], hidden_size=cfg["h"],
        num_heads=cfg["heads"], ffn_hidden_size=cfg["ffn"],
        use_residual=True, use_layernorm=True, activation="gelu",
        generator=torch.Generator().manual_seed(0)).eval()
    lm.embed.to(mesh.device)        # replicated; the core stays here
    lm.ln_f.to(mesh.device)
    kw = dict(batch_axis="dp" if args.dp > 1 else None, s_max=P + 64,
              bk=cfg["bk"])
    if args.paged:       # a pool a position: b rows x its KV heads x pages
        kw["n_pages"] = b * cfg["heads"] * (-(-(P + 64) // cfg["bk"]))
    srv = TPLMServer(lm, mesh, **kw)
    prompts = torch.from_numpy(
        np.random.RandomState(1).randint(0, V, (b, P))).to(mesh.device)
    rows = srv.rows(prompts)
    srv.generate(rows, 2)                              # warm-up

    def wall(n):
        _sync(mesh.device)
        t0 = time.perf_counter()
        toks, _ = srv.generate(rows, n)
        _sync(mesh.device)
        return toks, time.perf_counter() - t0

    toks, t_n = wall(args.tokens)
    _, t_1 = wall(1)
    out = {"position": dict(zip(mesh.names, mesh.positions[0]))
           if distributed else "all", "device": str(mesh.device),
           "mesh": mesh.shape, "paged": args.paged, "rows": len(rows),
           "ms_per_token": (t_n - t_1) * 1e3 / max(1, args.tokens - 1),
           "tokens_sum": int(toks.sum())}
    if device.type == "cuda":
        out["card"] = torch.cuda.get_device_name(mesh.device)
    if args.check:
        one = TPLMServer(lm, Mesh(axes, device=mesh.device), **kw)
        want = one.generate(prompts, args.tokens)[0]
        if distributed and args.dp > 1:
            d = mesh.index("dp")[0]
            n = b // args.dp
            want = want[d * n:(d + 1) * n]
        if not torch.equal(toks, want):
            raise RuntimeError("tokens differ from the one-device mesh's")
        out["check"] = "tokens equal to the one-device mesh's"
    print(json.dumps(out), flush=True)
    return out


if __name__ == "__main__":
    main()
