"""Continuous batching: ragged decode + slot admission (counterpart of the
JAX package's ``examples/serve_continuous.py``).

A miniature serving loop over ``SparseDecoder.decode_step_ragged``:
requests arrive over time, each slot decodes until its own budget is
spent, and a finished slot is re-admitted at once with the next queued
request through ``ops.decode.insert_kv_slot`` (a batch=1 prefill copied
into the slot's cache rows). Sequences at different positions share one
step; nothing is padded to the longest request. Self-check: every queued
request completes.

The full config is the JAX example's (4 slots, P=512, h=1024, 8 heads, 6
layers, ffn 4096, bk=512); ``--small`` is a CPU smoke config.
``--device`` never falls back by itself.

Run:  python -m sputnik_tpu_torch.examples.serve_continuous [--small]
          [--device cuda]
"""

from __future__ import annotations

import argparse
import time

import numpy as np
import torch

from sputnik_tpu_torch.models import SparseDecoder, SparseTransformer
from sputnik_tpu_torch.ops.decode import insert_kv_slot

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
        slots, P, h, heads, layers, ffn, bk = 2, 64, 128, 4, 2, 256, 32
    else:
        slots, P, h, heads, layers, ffn, bk = 4, 512, 1024, 8, 6, 4096, 512
    s_max = 2 * P

    def model(b):
        masks = np.broadcast_to(np.tril(np.ones((P, P), np.float32)),
                                (b, P, P)).copy()
        return SparseTransformer.from_masks(
            masks, num_layers=layers, hidden_size=h, num_heads=heads,
            ffn_hidden_size=ffn, use_residual=True, use_layernorm=True,
            activation="gelu", generator=torch.Generator().manual_seed(0),
            device=device).eval()

    # one set of weights, bound to the batch's masks and to a single
    # request's (the prefill runs the model's own masks)
    m_slots = model(slots)
    m_one = model(1)
    m_one.load_state_dict(m_slots.state_dict())

    rng = np.random.RandomState(0)
    n_requests = 2 * slots
    budgets = rng.randint(3, 9, n_requests)
    prompts = [torch.from_numpy(rng.randn(1, P, h).astype(np.float32) * 0.3
                                ).to(device) for _ in range(n_requests)]

    dec = SparseDecoder(m_slots, s_max=s_max, bk=bk,
                        cache_dtype=torch.bfloat16)
    dec1 = SparseDecoder(m_one, s_max=s_max, bk=bk,
                         cache_dtype=torch.bfloat16)

    def admit(caches, x, slot, prompt):
        """Prefill the request alone, copy its cache rows into the slot and
        seed the slot's next input with the prompt's LAST output (a real LM
        samples a token from it and embeds that instead)."""
        y1, c1 = dec1.prefill(prompt, dec1.init_caches(1))
        caches = tuple(insert_kv_slot(c, cc, slot, kv_heads=dec.kv_heads)
                       for c, cc in zip(caches, c1))
        x[slot] = y1[0, -1:]
        return caches, x

    caches = dec.init_caches(slots)
    slot_req = list(range(slots))
    remaining = [int(budgets[r]) for r in slot_req]
    x = torch.zeros((slots, 1, h), device=device)
    for s in range(slots):
        caches, x = admit(caches, x, s, prompts[s])
    next_req, done, steps = slots, 0, 0
    t0 = time.perf_counter()
    while done < n_requests:
        active = np.array([r >= 0 and remaining[s] > 0
                           for s, r in enumerate(slot_req)])
        if not active.any():
            break
        y, caches = dec.decode_step_ragged(
            x, caches, torch.from_numpy(active).to(device))
        x = y  # feed activations back (a real LM samples + embeds here)
        steps += 1
        for s in range(slots):
            if active[s]:
                remaining[s] -= 1
                if remaining[s] == 0:
                    done += 1
                    print(f"  slot {s}: request {slot_req[s]} finished "
                          f"({int(budgets[slot_req[s]])} tokens)")
                    if next_req < n_requests:
                        caches, x = admit(caches, x, s, prompts[next_req])
                        slot_req[s] = next_req
                        remaining[s] = int(budgets[next_req])
                        next_req += 1
                    else:
                        slot_req[s] = -1
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    dt = time.perf_counter() - t0
    print(f"served {n_requests} requests ({int(budgets.sum())} tokens) in "
          f"{steps} ragged steps on {device}, {dt:.2f}s wall")
    if done != n_requests:
        raise RuntimeError(f"only {done} of {n_requests} requests completed")
    if not torch.isfinite(x).all():
        raise RuntimeError("non-finite decode outputs")
    return {"requests": n_requests, "tokens": int(budgets.sum()),
            "steps": steps, "seconds": dt}


if __name__ == "__main__":
    main()
