"""Speculative decoding end to end: a draft proposes, the target verifies
(counterpart of the JAX package's ``examples/serve_speculative.py``).

A DRAFT LM proposes ``k`` tokens greedily; the TARGET LM verifies all of
them in ONE ``decode_multi`` pass (q <= 8 query rows a replica); the longest
matching prefix is accepted, both caches roll back past the first mismatch
(``rollback``, per slot), and the target's own argmax at the mismatch is
emitted as the bonus / correction token. Every round emits 1 to ``k``
tokens for one target pass. Greedy target decoding is EXACT: whatever the
draft proposes, the emitted sequence is plain greedy decoding's.

Drafts here are the target with perturbed weights (sigma 0: identical, and
0.02) and an early-exit draft (the target's first layers with its
embedding, final LayerNorm and head); the deep layers' residual branches
are damped, so that an untrained model behaves like a trained one whose
deep layers refine. Reports acceptance and ms/token against plain greedy
decoding (``LMServer.generate``, one CUDA graph replay a token on the
card). Self-checks: with an f32 cache (the CPU) the emitted sequence
equals plain greedy decoding's token for token and the identical draft is
fully accepted; with the bf16 cache (the card), where the one-shot
verification and the token loop round differently, each draft agrees with
plain greedy decoding on more than half the tokens.

The full config is the JAX example's (b=4, P=1024, V=32000, h=1024, 8
heads, 6 layers, ffn 4096, 16 rounds); ``--small`` is a CPU smoke config.
``--device`` never falls back by itself.

Run:  python -m sputnik_tpu_torch.examples.serve_speculative [--small]
          [--k K] [--reps N] [--device cuda]
"""

from __future__ import annotations

import argparse
import copy
import json
import time

import numpy as np
import torch

from sputnik_tpu_torch.models import LMServer, SparseLM

__all__ = ["main"]


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--small", action="store_true",
                    help="tiny config for CPU smoke runs")
    ap.add_argument("--k", type=int, default=4, help="draft tokens a round")
    ap.add_argument("--reps", type=int, default=3,
                    help="timed repetitions of each loop")
    ap.add_argument("--device", default="cuda",
                    help="torch device to serve on (default: cuda)")
    args = ap.parse_args(argv)

    device = torch.device(args.device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(f"device {args.device!r} requested, but no CUDA "
                           f"device is available")
    if args.small:
        b, P, V, h, heads, layers, ffn = 2, 128, 256, 64, 2, 2, 96
        rounds = 4
    else:
        b, P, V, h, heads, layers, ffn = 4, 1024, 32000, 1024, 8, 6, 4096
        rounds = 16
    k = args.k
    if not 2 <= k <= 8:
        raise ValueError(f"--k {k}: decode_multi verifies 2 to 8 tokens")
    bk = 128
    s_max = P + -(-(rounds * k + k) // bk) * bk
    cfg = dict(vocab_size=V, hidden_size=h, num_heads=heads,
               ffn_hidden_size=ffn, use_residual=True, use_layernorm=True,
               activation="gelu")
    masks = np.broadcast_to(np.tril(np.ones((P, P), np.float32)),
                            (b, P, P)).copy()
    # initialised on the host from a seeded CPU generator, then moved
    lm = SparseLM.from_masks(masks, num_layers=layers,
                             generator=torch.Generator().manual_seed(0),
                             **cfg).eval().to(device)
    prompts = torch.from_numpy(np.random.RandomState(0).randint(
        0, V, (b, P))).to(device)

    # EARLY-EXIT draft: the target's first layers + its embedding, final
    # LayerNorm and head (self-speculative decoding)
    layers_d = max(1, layers // 3)
    with torch.no_grad():
        # A random-init target gives an early-exit draft ~0% acceptance
        # (untrained deep layers rewrite the stream); trained residual LMs
        # refine in their deep layers. Damping the deep residual branches
        # emulates that regime at the same target cost (every layer runs).
        for layer in lm.core.layers[layers_d:]:
            for lin in (layer.self_attention.dense, layer.mlp.to_h):
                lin.weight.mul_(0.15)
                lin.bias.mul_(0.15)
    lm_ee = SparseLM.from_masks(masks, num_layers=layers_d,
                                **cfg).eval().to(device)
    lm_ee.load_state_dict({n: t for n, t in lm.state_dict().items()
                           if n in lm_ee.state_dict()})

    def perturb(sigma):
        draft = copy.deepcopy(lm)
        gen = torch.Generator(device=device).manual_seed(7)
        with torch.no_grad():
            for p in draft.parameters():
                if p.dim() >= 2:
                    p.add_(sigma * p.std() * torch.randn(
                        p.shape, generator=gen, device=device))
        return draft

    kv_dtype = torch.bfloat16 if device.type == "cuda" else torch.float32

    def server(model):
        return LMServer(model, s_max=s_max, bk=bk, cache_dtype=kv_dtype)

    srv = server(lm)

    def plain(n_new):
        """Plain greedy decoding: ``[b, n_new]``."""
        return srv.generate(prompts, n_new)[0]

    @torch.no_grad()
    def speculative(srv_d):
        """``rounds`` rounds; returns the first token, the emitted tokens
        ``[b, rounds, k]`` (-1 past each round's count) and the counts
        ``[b, rounds]``."""
        ct, cd = srv.init_caches(b), srv_d.init_caches(b)
        lg_t, ct = srv.prefill(prompts, ct)
        _, cd = srv_d.prefill(prompts, cd)
        cur = torch.argmax(lg_t[:, -1], dim=-1)
        first = cur
        pos = torch.arange(k, device=device)[None]
        kvl_t = ct[0].kv_len.shape[0] // b
        kvl_d = cd[0].kv_len.shape[0] // b
        emitted, counts = [], []
        for _ in range(rounds):
            # the draft proposes k tokens greedily (fed cur, d1..d_{k-1})
            tok, drafts = cur, []
            for _ in range(k):
                lg, cd = srv_d.decode_step(tok, cd)
                tok = torch.argmax(lg, dim=-1)
                drafts.append(tok)
            drafts = torch.stack(drafts, dim=1)                   # [b, k]
            # the target verifies the whole proposal in ONE pass: fed
            # [cur, d1..d_{k-1}], row i predicts token i + 1
            x = torch.cat([cur[:, None], drafts[:, :-1]], dim=1)
            y, ct = srv.decoder.decode_multi(srv.lm.embed(x), ct)
            t_pred = torch.argmax(srv.lm.head(y), dim=-1)         # [b, k]
            # the longest accepted prefix (d_k is never accepted: the draft
            # cache does not hold it); the bonus is the target's argmax at
            # the first mismatch
            match = (t_pred[:, :k - 1] == drafts[:, :k - 1]).to(torch.int32)
            a = torch.cumprod(match, dim=1).sum(dim=1)            # [b]
            bonus = torch.gather(t_pred, 1, a[:, None])[:, 0]
            # both caches took k tokens: keep cur and the accepted drafts
            nroll = (k - (1 + a)).to(torch.int32)
            ct = srv.decoder.rollback(ct, nroll.repeat_interleave(kvl_t))
            cd = srv_d.decoder.rollback(cd, nroll.repeat_interleave(kvl_d))
            emitted.append(torch.where(
                pos < a[:, None], drafts,
                torch.where(pos == a[:, None], bonus[:, None], -1)))
            counts.append(a + 1)
            cur = bonus
        return first, torch.stack(emitted, 1), torch.stack(counts, 1)

    def flatten(first, emitted, counts, n):
        """Per-slot accepted streams -> ``[b, n]`` tokens."""
        first, emitted, counts = (t.cpu().numpy()
                                  for t in (first, emitted, counts))
        out = np.full((b, n), -1, np.int64)
        for s in range(b):
            stream = [int(first[s])]
            for r in range(emitted.shape[1]):
                stream.extend(int(t) for t in emitted[s, r, :counts[s, r]])
            out[s, :min(n, len(stream))] = stream[:n]
        return out

    drafts = {0.0: server(perturb(0.0)), 0.02: server(perturb(0.02)),
              "early_exit": server(lm_ee)}
    ref = plain(rounds * k).cpu().numpy()
    results = {}
    for sigma, srv_d in drafts.items():
        first, em, cn = speculative(srv_d)
        n_tok = 1 + int(cn.sum(dim=1).min())
        flat = flatten(first, em, cn, n_tok)
        nref = min(n_tok, ref.shape[1])
        agree = float((flat[:, :nref] == ref[:, :nref]).mean())
        acc = float((cn - 1).sum()) / (cn.numel() * (k - 1))
        if kv_dtype == torch.float32:
            # f32 cache: decode_multi and decode_step agree, so greedy
            # speculative decoding is exact
            if not np.array_equal(flat[:, :nref], ref[:, :nref]):
                raise RuntimeError(f"speculative output diverged from plain "
                                   f"greedy decoding (sigma={sigma})")
            if sigma == 0.0 and acc != 1.0:
                raise RuntimeError(f"an identical draft must be fully "
                                   f"accepted: {acc}")
        elif agree <= 0.5:
            # bf16 cache: the one-shot verification and the token loop
            # round differently, which can flip an untrained model's
            # argmax near-ties; this guards against gross desync only
            raise RuntimeError(f"agreement {agree} (sigma={sigma})")
        results[sigma] = {"acceptance": acc, "agreement": agree,
                          "tok_per_round": float(cn.float().mean())}

    def timed(fn):
        fn()                                    # warm
        if device.type == "cuda":
            torch.cuda.synchronize(device)
        t0 = time.perf_counter()
        for _ in range(args.reps):
            out = fn()
        if device.type == "cuda":
            torch.cuda.synchronize(device)
        return (time.perf_counter() - t0) / args.reps, out

    n_plain = rounds * k
    t_plain, _ = timed(lambda: plain(n_plain))
    report = {"k": k, "rounds": rounds, "device": str(device),
              "plain_ms_per_token": t_plain / n_plain * 1e3,
              "checks": {str(s): r for s, r in results.items()}}
    for sigma in (0.02, "early_exit"):
        t_spec, (_, _, cn) = timed(lambda: speculative(drafts[sigma]))
        per_tok = t_spec / (float(cn.sum()) / b) * 1e3
        report[f"spec_{sigma}"] = {
            "acceptance": results[sigma]["acceptance"],
            "ms_per_token": per_tok,
            "speedup_vs_plain": t_plain / n_plain * 1e3 / per_tok}
    print(json.dumps(report, indent=1))
    print("OK: speculative decoding checked against plain greedy decoding; "
          f"drafts {list(results)}")
    return report


if __name__ == "__main__":
    main()
