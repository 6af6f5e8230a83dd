"""Paged serving: page-pool KV, prefix caching, eviction without copies
(counterpart of the JAX package's ``examples/serve_paged.py``).

A miniature multi-tenant loop over ``PagedDecoder``: every request shares
one SYSTEM PROMPT, whose KV pages are prefilled once and refcount-shared
into every other slot (``share_prefix``); the slots decode raggedly
(finished slots are frozen with ``active``), then release their pages, and
the pool must drain completely. It prints the pool pages held against the
contiguous per-slot reservation, and the decode time per step.

The full config is the JAX example's (4 slots, P=1024, h=1024, 8 heads, 6
layers, ffn 4096, 256-token pages, 32 tokens, a bf16 pool); ``--small`` is
a CPU smoke config (f32 pool). ``--device`` never falls back by itself.

Run:  python -m sputnik_tpu_torch.examples.serve_paged [--small]
          [--device cuda]
"""

from __future__ import annotations

import argparse
import time

import numpy as np
import torch

from sputnik_tpu_torch.models import PagedDecoder, SparseTransformer

__all__ = ["main"]


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--small", action="store_true",
                    help="tiny config for CPU smoke runs")
    ap.add_argument("--device", default="cuda",
                    help="torch device to serve on (default: cuda)")
    args = ap.parse_args(argv)

    device = torch.device(args.device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(f"device {args.device!r} requested, but no CUDA "
                           f"device is available")
    if args.small:
        slots, P, h, heads, layers, ffn, bk = 2, 128, 64, 2, 2, 96, 128
        n_new = 4
    else:
        slots, P, h, heads, layers, ffn, bk = 4, 1024, 1024, 8, 6, 4096, 256
        n_new = 32
    s_max = P + -(-n_new // bk) * bk
    cache_dtype = torch.bfloat16 if device.type == "cuda" else torch.float32

    masks = np.broadcast_to(np.tril(np.ones((P, P), np.float32)),
                            (slots, P, P)).copy()
    model = SparseTransformer.from_masks(
        masks, num_layers=layers, hidden_size=h, num_heads=heads,
        ffn_hidden_size=ffn, use_residual=True, use_layernorm=True,
        activation="gelu", generator=torch.Generator().manual_seed(0)
    ).to(device).eval()
    rng = np.random.RandomState(0)

    # one shared system prompt for everyone
    system = rng.randn(1, P, h).astype(np.float32) * 0.3
    prompts = torch.from_numpy(np.repeat(system, slots, 0)).to(device)

    # pool sized for the shared prefix (stored once) + decode tails per slot
    prefix_pages = (P // bk) * slots * heads          # worst case, no share
    dec = PagedDecoder(model, n_pages=prefix_pages + slots * heads * 2,
                       s_max=s_max, bk=bk, cache_dtype=cache_dtype)
    caches = dec.init_caches(slots)

    # prefill slot 0 only; every other slot shares its prefix pages
    lengths = torch.tensor([P] + [0] * (slots - 1), device=device)
    _, caches = dec.prefill(prompts, caches, lengths=lengths)
    for s in range(1, slots):
        caches = dec.release(caches, s)   # drop the empty slots' pages
        caches = dec.share_prefix(caches, src=0, dst=s, n_tokens=P)
    live = dec.pools[0].n_pages - dec.free_pages[0]
    print(f"prefix shared into {slots} slots; layer-0 pool: {live} pages "
          f"live (vs {slots * (P // bk) * heads} unshared)")
    if live != (P // bk) * heads:
        raise RuntimeError("the prefix pages must be stored once")

    # ragged decode: slot s wants n_new - s tokens
    budgets = np.array([n_new - s for s in range(slots)])
    x = torch.from_numpy(rng.randn(slots, 1, h).astype(np.float32) * 0.3
                         ).to(device)
    done_at = {}
    step_s = []
    for t in range(int(budgets.max())):
        act = torch.from_numpy(budgets > t).to(device)
        caches = dec.reserve(caches, 1)                 # host step (syncs)
        t0 = time.perf_counter()
        x, caches = dec.decode_step(x, caches, active=act)
        if device.type == "cuda":
            torch.cuda.synchronize(device)
        step_s.append(time.perf_counter() - t0)
        for s in range(slots):
            if budgets[s] == t + 1:
                done_at[s] = t + 1
    kv = caches[0].kv_len.tolist()
    for s in range(slots):
        if kv[s * heads] != P + budgets[s]:
            raise RuntimeError(f"slot {s}: kv_len {kv[s * heads]}, expected "
                               f"{P + budgets[s]}")
    if not torch.isfinite(x).all():
        raise RuntimeError("non-finite decode outputs")

    # retire everyone; the pool must drain completely (refcounts)
    for s in range(slots):
        caches = dec.release(caches, s)
    if dec.free_pages[0] != dec.pools[0].n_pages:
        raise RuntimeError("leaked pages")
    ms = float(np.median(step_s)) * 1e3
    print(f"all {slots} slots finished ({done_at}); pool fully drained; "
          f"decode_step {ms:.4f} ms (median of {len(step_s)}, on {device})")
    print("OK")
    return {"live_prefix_pages": live, "done_at": done_at, "step_ms": ms}


if __name__ == "__main__":
    main()
