"""End-to-end generation: prefill + autoregressive block-KV decode
(counterpart of the JAX package's ``examples/generate.py``).

Builds a sparse transformer (causal masks), prefills a prompt through the
sparse-flash kernel while filling every layer's block KV cache, then
decodes one token at a time through the decode-attention kernel
(``SparseDecoder.decode_loop``). Prints the prefill time and the decode
time per token. The full config is the JAX example's (b=4, P=2048,
h=1024, 8 heads, 6 layers, ffn 4096, bk=1024); ``--small`` is a CPU smoke
config. ``--device`` never falls back by itself.

Run:  python -m sputnik_tpu_torch.examples.generate [--small] [--int8]
          [--kv-heads K] [--window W] [--tokens N] [--device cuda]
"""

from __future__ import annotations

import argparse
import time

import numpy as np
import torch

from sputnik_tpu_torch.models import SparseDecoder, SparseTransformer

__all__ = ["main"]


def _sync(device):
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--small", action="store_true",
                    help="tiny config for CPU smoke runs")
    ap.add_argument("--int8", action="store_true",
                    help="int8 KV cache (half the decode bytes of bf16)")
    ap.add_argument("--kv-heads", type=int, default=0,
                    help="grouped-query attention: KV heads (0 = MHA)")
    ap.add_argument("--window", type=int, default=0,
                    help="sliding-window tokens (0 = full causal)")
    ap.add_argument("--tokens", type=int, default=0,
                    help="tokens to decode (default: the prompt length)")
    ap.add_argument("--device", default="cuda",
                    help="torch device to serve on (default: cuda)")
    args = ap.parse_args(argv)

    device = torch.device(args.device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(f"device {args.device!r} requested, but no CUDA "
                           f"device is available")
    if args.small:
        b, P, h, heads, layers, ffn, bk = 2, 64, 128, 4, 2, 256, 32
    else:
        b, P, h, heads, layers, ffn, bk = 4, 2048, 1024, 8, 6, 4096, 1024
    n_new = args.tokens or P
    masks = np.broadcast_to(np.tril(np.ones((P, P), np.float32)),
                            (b, P, P)).copy()
    model = SparseTransformer.from_masks(
        masks, num_layers=layers, hidden_size=h, num_heads=heads,
        ffn_hidden_size=ffn, num_kv_heads=args.kv_heads or None,
        use_residual=True, use_layernorm=True, activation="gelu",
        generator=torch.Generator().manual_seed(0)).to(device).eval()
    dec = SparseDecoder(
        model, s_max=P + n_new, bk=bk, window=args.window or None,
        sinks=1 if args.window else 0,
        cache_dtype=torch.int8 if args.int8 else torch.bfloat16)
    rng = np.random.RandomState(0)
    x = torch.from_numpy(rng.randn(b, P, h).astype(np.float32) * 0.3
                         ).to(device)

    dec.prefill(x, dec.init_caches(b))          # builds kernels + metadata
    caches = dec.init_caches(b)
    _sync(device)
    t0 = time.perf_counter()
    y, caches = dec.prefill(x, caches)
    _sync(device)
    t_prefill = time.perf_counter() - t0

    tok = y[:, -1:]
    warm = tuple(c.clone() for c in caches)
    dec.decode_loop(tok, warm, min(n_new, 2))   # warm-up
    _sync(device)
    t0 = time.perf_counter()
    ys, _ = dec.decode_loop(tok, caches, n_new)
    _sync(device)
    dt = (time.perf_counter() - t0) / n_new

    kv = "int8" if args.int8 else "bf16"
    if args.kv_heads:
        kv += f"+gqa{args.kv_heads}"
    win = f"window={args.window}" if args.window else "causal"
    print(f"generate on {device} (b={b} P={P} h={h} L={layers} {win} "
          f"kv={kv}): prefill {t_prefill * 1e3:.3f} ms, decode "
          f"{dt * 1e3:.4f} ms/token ({b / dt:.0f} tok/s aggregate)")
    if not torch.isfinite(ys).all():
        raise RuntimeError("non-finite decode outputs")
    return t_prefill, dt


if __name__ == "__main__":
    main()
