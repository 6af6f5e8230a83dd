#!/usr/bin/env python3
"""Smoke run of the PyTorch port (``sputnik_tpu_torch``) on one NVIDIA GPU.

    python3 chip_smoke.py        # from the repository root, one CUDA GPU

Phases, each printing its lines:
  1. the device (name, power limit) and the kernels' nvcc build;
  2. each CUDA kernel against its plain PyTorch version at the headline
     shapes (SpMM and transposed SpMM 4096^3 d=0.1 with dense fp32 anchors,
     the bias+ReLU epilogue, SDDMM 4096^2 d=0.1 at d=64, sparse-flash
     forward and the three backward kernels at R=32 s=512 hd=64, the
     backward also at hd 32 / 128 and GQA group 2) and at the shapes the
     main paths give them; both backward routes timed at the driver shape
     and at s=4096;
  3. the main paths, with every launch counter reset just before each:
     a. forward: the reference driver's SparseTransformer (6 layers, b=4,
        s=512, h=512, 8 heads, ffn 2048, residual, LayerNorm, gelu,
        layout="flash", causal masks with row s//2 fully masked), 3 forward
        batches, then a SparseAttention forward (b=4, s=512, embed 512,
        8 heads, a random 90%-sparse score mask);
     b. training: the same SparseTransformer takes 3 Adam steps through the
        single-pass flash backward and 1 through the two-kernel backward,
        then the SparseAttention takes 3 Adam steps (SpMM, transposed SpMM
        and SDDMM in its backward);
  4. the outputs, losses and gradients against the same modules' plain path
     on the CPU, and the forward / training-step times and peak device
     memory.
It prints one JSON line of per-kernel results, then, last, the device line
``{"ok": true, "device": {...}}``. Any failed check raises (exit code != 0).
TF32 is switched off, so every product here runs in full fp32.
"""

from __future__ import annotations

import copy
import json
import statistics
import subprocess
import sys
import time

import numpy as np

TOL_KERNEL = 1e-4   # x max(1, max|plain|): fp32 sums in another order
TOL_MODEL = 1e-3    # x max(1, max|ref|): six LayerNorm'd fp32 layers
REPLACES = {
    "bsr_spmm_panel": ("sputnik_tpu_torch/csrc/bsr_spmm.cu",
                       "sputnik_tpu/ops/pallas/bsr_spmm.py:44"),
    "bsr_sddmm_panel": ("sputnik_tpu_torch/csrc/bsr_sddmm.cu",
                        "sputnik_tpu/ops/pallas/bsr_sddmm.py:37"),
    "bsr_spmm_t_panel": ("sputnik_tpu_torch/csrc/bsr_spmm_t.cu",
                         "sputnik_tpu/ops/pallas/bsr_spmm_t.py:33"),
    "flash_sparse_attention_fwd": (
        "sputnik_tpu_torch/csrc/flash_sparse_fwd.cu",
        "sputnik_tpu/ops/pallas/flash_sparse.py:115"),
    "flash_sparse_bwd_fused": ("sputnik_tpu_torch/csrc/flash_sparse_bwd.cu",
                               "sputnik_tpu/ops/pallas/flash_sparse.py:282"),
    "flash_sparse_bwd_dq": ("sputnik_tpu_torch/csrc/flash_sparse_bwd.cu",
                            "sputnik_tpu/ops/pallas/flash_sparse.py:445"),
    "flash_sparse_bwd_dkv": ("sputnik_tpu_torch/csrc/flash_sparse_bwd.cu",
                             "sputnik_tpu/ops/pallas/flash_sparse.py:529"),
}
TOL_LOSS = 1e-3     # relative, losses after the first Adam step


def _fail(msg: str):
    raise RuntimeError(f"chip_smoke: {msg}")


def _time_ms(fn, reps: int = 10, inner: int = 10, warmup: int = 3) -> float:
    """Milliseconds per ``fn()`` call: the median over ``reps`` samples,
    each CUDA events around ``inner`` back-to-back calls (so the host's
    launch overhead overlaps the device work, as in a steady loop)."""
    import torch

    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(inner):
            fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end) / inner)
    return statistics.median(times)


def _compare(name, got, ref, tol, results=None):
    """max |got - ref| against ``tol * max(1, max |ref|)``; raises."""
    import torch

    if got.shape != ref.shape:
        _fail(f"{name}: shape {tuple(got.shape)} != {tuple(ref.shape)}")
    if not torch.isfinite(got).all():
        _fail(f"{name}: non-finite values")
    err = (got.float() - ref.float()).abs().max().item()
    bound = tol * max(1.0, ref.abs().max().item())
    print(f"  {name}: max_abs_err {err:.3e} (bound {bound:.3e})", flush=True)
    if not err <= bound:
        _fail(f"{name}: max_abs_err {err} > {bound}")
    if results is not None:
        results["max_abs_err"] = max(results.get("max_abs_err", 0.0), err)


def phase_kernels(stt, torch, dev, kres):
    """Each kernel against its plain version on the card."""
    from sputnik_tpu_torch.ops import panel_api as P
    from sputnik_tpu_torch.ops.kernels.bsr_sddmm import (
        bsr_sddmm_panel, bsr_sddmm_panel_plain)
    from sputnik_tpu_torch.ops.kernels.bsr_spmm import (
        bsr_spmm_panel, bsr_spmm_panel_plain)
    from sputnik_tpu_torch.ops.kernels.bsr_spmm_t import (
        bsr_spmm_t_panel, bsr_spmm_t_panel_plain)
    from sputnik_tpu_torch.ops.kernels.flash_sparse import (
        flash_sparse_attention_fwd, flash_sparse_attention_fwd_plain)
    from sputnik_tpu_torch.patterns import driver_masks, uniform_mask

    print("phase 2: kernels vs plain PyTorch on the card", flush=True)
    # -- SpMM at bench.py's config: 4096^3, element-random d=0.1
    size, density = 4096, 0.1
    rng = np.random.RandomState(0)
    t0 = time.perf_counter()
    w = ((rng.rand(size, size) < density) * rng.randn(size, size)
         ).astype(np.float32)
    mat = stt.SparseMatrix(w)
    spec = P.PanelSpec(mat.topology)
    panel = torch.from_numpy(P.values_to_panel_np(
        mat.topology, mat.values, spec.bm, spec.bk)).to(dev)
    dense = torch.from_numpy(
        rng.randn(size, size).astype(np.float32)).to(dev)
    bias = torch.from_numpy(rng.randn(size).astype(np.float32)).to(dev)
    meta = spec.meta(dev)
    bv = spec.view
    print(f"  spmm setup {time.perf_counter() - t0:.1f} s: {size}^2 "
          f"d={density} nnz={mat.topology.nnz} tiles {spec.bm}x{spec.bk} "
          f"block_density {bv.block_density:.4f} max_bpr {bv.max_bpr}",
          flush=True)

    def kern(epi="none"):
        return bsr_spmm_panel(meta["block_cols"], meta["nblocks"], panel[None],
                              dense[None], None if epi == "none" else bias,
                              rows=size, epilogue=epi)[0]

    def plain(epi="none"):
        return bsr_spmm_panel_plain(
            meta["block_cols"], meta["nblocks"], panel[None], dense[None],
            None if epi == "none" else bias, rows=size, epilogue=epi)[0]

    r = kres["bsr_spmm_panel"]
    for epi in ("none", "bias_relu"):
        _compare(f"spmm {size}^3 epilogue={epi}", kern(epi), plain(epi),
                 TOL_KERNEL, r)
    a_dense = torch.from_numpy(w).to(dev)
    _compare("spmm vs dense torch.matmul", kern(), a_dense @ dense,
             TOL_KERNEL)
    r["ms"] = _time_ms(kern)
    r["plain_ms"] = _time_ms(plain)
    dense_ms = _time_ms(lambda: a_dense @ dense)
    ms_relu = _time_ms(lambda: kern("bias_relu"))
    flop = 2.0 * bv.num_blocks * spec.bm * spec.bk * size
    print("  (times: median of 10 samples of 10 back-to-back calls)")
    print(f"  spmm {size}^3 d={density}: kernel {r['ms']:.4f} ms "
          f"({flop / r['ms'] / 1e9:.2f} TFLOP/s), bias_relu {ms_relu:.4f} ms, "
          f"plain {r['plain_ms']:.4f} ms, dense fp32 torch.matmul "
          f"{dense_ms:.4f} ms", flush=True)

    # -- transposed SpMM (B3) at the same headline: A^T @ G, G = dense
    r = kres["bsr_spmm_t_panel"]
    targs = (meta["t_src_i"], meta["t_src_s"], meta["t_nblocks"], panel[None],
             dense[None])

    def t_kern():
        return bsr_spmm_t_panel(*targs, rows=size)[0]

    def t_plain():
        return bsr_spmm_t_panel_plain(*targs, rows=size)[0]

    got = t_kern()
    _compare(f"spmm_t {size}^3 d={density}", got, t_plain(), TOL_KERNEL, r)
    _compare("spmm_t vs dense a.T @ G", got, a_dense.T @ dense, TOL_KERNEL)
    r["ms"], r["plain_ms"] = _time_ms(t_kern), _time_ms(t_plain)
    dense_t_ms = _time_ms(lambda: a_dense.T @ dense)
    print(f"  spmm_t {size}^3 d={density}: kernel {r['ms']:.4f} ms "
          f"({flop / r['ms'] / 1e9:.2f} TFLOP/s), plain "
          f"{r['plain_ms']:.4f} ms, dense fp32 a.T @ G {dense_t_ms:.4f} ms",
          flush=True)
    del panel, dense, a_dense, got

    # -- SDDMM at 4096^2 d=0.1, d=64
    d = 64
    lhs = torch.from_numpy(rng.randn(1, size, d).astype(np.float32)).to(dev)
    rhs = torch.from_numpy(rng.randn(1, size, d).astype(np.float32)).to(dev)
    r = kres["bsr_sddmm_panel"]

    def sd_kern():
        return bsr_sddmm_panel(meta["block_cols"], meta["nblocks"], lhs, rhs,
                               meta["mask"])

    def sd_plain():
        return bsr_sddmm_panel_plain(meta["block_cols"], meta["nblocks"],
                                     lhs, rhs, meta["mask"])

    got = sd_kern()
    _compare(f"sddmm {size}^2 d={density} dim {d}", got, sd_plain(),
             TOL_KERNEL, r)
    if not torch.all(got[0][meta["mask"] == 0] == 0):
        _fail("sddmm: padded or masked panel slots are not exactly zero")
    r["ms"], r["plain_ms"] = _time_ms(sd_kern), _time_ms(sd_plain)
    print(f"  sddmm {size}^2 dim {d}: kernel {r['ms']:.4f} ms, plain "
          f"{r['plain_ms']:.4f} ms", flush=True)
    del lhs, rhs, got

    # -- sparse-flash forward at the reference transformer's attention:
    #    R=32, s=512, hd=64
    b, heads, s, hd = 4, 8, 512, 64
    fspec = stt.BatchedPanelSpec.from_many_mask(
        stt.ManyMaskTopology.from_dense_masks(driver_masks(b, s)),
        heads=heads)
    fm = fspec.flash_meta(dev)
    q, k, v = (torch.from_numpy(rng.randn(b * heads, s, hd).astype(
        np.float32)).to(dev) for _ in range(3))
    fargs = (fm["block_cols"], fm["nblocks"], fm["mask_slot"],
             fm["is_partial"], fm["pmask"], q, k, v)
    fkw = dict(heads=heads, max_bpr=fm["max_bpr"], scale=hd ** -0.5)
    r = kres["flash_sparse_attention_fwd"]
    out, m, l = flash_sparse_attention_fwd(*fargs, **fkw)
    ref, m_ref, l_ref = flash_sparse_attention_fwd_plain(*fargs, **fkw)
    _compare(f"flash R={b * heads} s={s} hd={hd}", out, ref, TOL_KERNEL, r)
    _compare("flash row denominators l", l, l_ref, TOL_KERNEL)
    if not torch.all(out[:, s // 2] == 0):
        _fail("flash: the fully-masked row is not exactly 0")
    r["ms"] = _time_ms(lambda: flash_sparse_attention_fwd(*fargs, **fkw))
    r["plain_ms"] = _time_ms(
        lambda: flash_sparse_attention_fwd_plain(*fargs, **fkw))
    print(f"  flash R={b * heads} s={s} hd={hd}: kernel {r['ms']:.4f} ms, "
          f"plain {r['plain_ms']:.4f} ms", flush=True)

    # -- SpMM / SDDMM at the shapes SparseAttention gives them
    e, heads = 512, 8
    topo = stt.SparseTopology.from_dense_mask(
        uniform_mask(s, s, sparsity=0.9, seed=0))
    aspec = P.PanelSpec(topo)
    am = aspec.meta(dev)
    R = b * heads
    q, k, v = (torch.from_numpy(rng.randn(R, s, e // heads).astype(
        np.float32)).to(dev) for _ in range(3))
    sc = bsr_sddmm_panel(am["block_cols"], am["nblocks"], q, k, am["mask"])
    _compare(f"sddmm attention R={R} s={s}", sc,
             bsr_sddmm_panel_plain(am["block_cols"], am["nblocks"], q, k,
                                   am["mask"]), TOL_KERNEL,
             kres["bsr_sddmm_panel"])
    wts = P.sparse_softmax(aspec, sc)
    _compare(f"spmm attention R={R} s={s}",
             bsr_spmm_panel(am["block_cols"], am["nblocks"], wts, v, rows=s),
             bsr_spmm_panel_plain(am["block_cols"], am["nblocks"], wts, v,
                                  rows=s), TOL_KERNEL, kres["bsr_spmm_panel"])
    at = (am["t_src_i"], am["t_src_s"], am["t_nblocks"], wts, v)
    _compare(f"spmm_t attention R={R} s={s}", bsr_spmm_t_panel(*at, rows=s),
             bsr_spmm_t_panel_plain(*at, rows=s), TOL_KERNEL,
             kres["bsr_spmm_t_panel"])
    full = P.PanelSpec(stt.SparseTopology.from_dense_mask(np.ones((e, e))))
    fmeta = full.meta(dev)
    wp = torch.from_numpy(rng.randn(1, *full.view.values_shape).astype(
        np.float32)).to(dev)
    xt = torch.from_numpy(rng.randn(1, e, b * s).astype(np.float32)).to(dev)
    pb = torch.from_numpy(rng.randn(e).astype(np.float32)).to(dev)
    _compare(f"spmm projection {e}x{e} x [{e},{b * s}] epilogue=bias",
             bsr_spmm_panel(fmeta["block_cols"], fmeta["nblocks"], wp, xt, pb,
                            rows=e, epilogue="bias"),
             bsr_spmm_panel_plain(fmeta["block_cols"], fmeta["nblocks"], wp,
                                  xt, pb, rows=e, epilogue="bias"),
             TOL_KERNEL, kres["bsr_spmm_panel"])
    gt = torch.from_numpy(rng.randn(1, e, b * s).astype(np.float32)).to(dev)
    pt = (fmeta["t_src_i"], fmeta["t_src_s"], fmeta["t_nblocks"], wp, gt)
    _compare(f"spmm_t projection {e}x{e} x [{e},{b * s}]",
             bsr_spmm_t_panel(*pt, rows=e),
             bsr_spmm_t_panel_plain(*pt, rows=e), TOL_KERNEL,
             kres["bsr_spmm_t_panel"])


def _flash_problem(stt, torch, dev, b, heads, s, hd, group, seed):
    """Driver masks, seeded q / k / v / g, and the forward kernel's out, m
    and l: the operands of the flash backward kernels."""
    from sputnik_tpu_torch.ops.kernels.flash_sparse import (
        flash_sparse_attention_fwd)
    from sputnik_tpu_torch.patterns import driver_masks

    rng = np.random.RandomState(seed)
    spec = stt.BatchedPanelSpec.from_many_mask(
        stt.ManyMaskTopology.from_dense_masks(driver_masks(b, s)),
        heads=heads)
    R = b * heads
    q, g = (torch.from_numpy(rng.randn(R, s, hd).astype(np.float32)).to(dev)
            for _ in range(2))
    k, v = (torch.from_numpy(rng.randn(R // group, s, hd).astype(
        np.float32)).to(dev) for _ in range(2))
    fm = spec.flash_meta(dev)
    kw = dict(heads=heads, scale=hd ** -0.5, group=group)
    out, m, l = flash_sparse_attention_fwd(
        fm["block_cols"], fm["nblocks"], fm["mask_slot"], fm["is_partial"],
        fm["pmask"], q, k, v, max_bpr=fm["max_bpr"], **kw)
    D = (g * out).sum(-1)
    fm, bm = spec.flash_meta(dev), spec.flash_bwd_meta(dev)
    rows = (fm["block_cols"], fm["nblocks"], fm["mask_slot"],
            fm["is_partial"], fm["pmask"], q, k, v, g, m, l, D)
    cols = (bm["t_src_i"], bm["t_nblocks"], bm["t_mask_slot"],
            bm["t_is_partial"], bm["pmask"], q, k, v, g, m, l, D)
    return rows, cols, dict(kw, max_bpr=fm["max_bpr"]), dict(
        kw, max_bpc=bm["max_bpc"])


def phase_flash_backward(stt, torch, dev, kres):
    """B10a / B10b / B10c against their plain versions on the card, and the
    two backward routes against each other."""
    from sputnik_tpu_torch.ops.kernels import flash_sparse as fs

    b, heads, s = 4, 8, 512
    for hd, group in ((64, 1), (32, 1), (128, 1), (64, 2)):
        rows, cols, rkw, ckw = _flash_problem(stt, torch, dev, b, heads, s,
                                              hd, group, seed=hd + group)
        calls = {
            "flash_sparse_bwd_fused": (
                lambda: fs.flash_sparse_bwd_fused(*rows, **rkw),
                lambda: fs.flash_sparse_bwd_fused_plain(*rows, **rkw)),
            "flash_sparse_bwd_dq": (
                lambda: fs.flash_sparse_bwd_dq(*rows, **rkw),
                lambda: fs.flash_sparse_bwd_dq_plain(*rows, **rkw)),
            "flash_sparse_bwd_dkv": (
                lambda: fs.flash_sparse_bwd_dkv(*cols, **ckw),
                lambda: fs.flash_sparse_bwd_dkv_plain(*cols, **ckw)),
        }
        tag = f"R={b * heads} s={s} hd={hd} group={group}"
        fused = calls["flash_sparse_bwd_fused"][0]()
        ref = calls["flash_sparse_bwd_fused"][1]()
        dq = calls["flash_sparse_bwd_dq"][0]()
        dk, dv = calls["flash_sparse_bwd_dkv"][0]()
        for name, got, want in zip(("dq", "dk", "dv"), fused, ref):
            _compare(f"bwd_fused {name} {tag}", got, want, TOL_KERNEL,
                     kres["flash_sparse_bwd_fused"])
        _compare(f"bwd_dq {tag}", dq, ref[0], TOL_KERNEL,
                 kres["flash_sparse_bwd_dq"])
        for name, got, want in (("dk", dk, ref[1]), ("dv", dv, ref[2])):
            _compare(f"bwd_dkv {name} {tag}", got, want, TOL_KERNEL,
                     kres["flash_sparse_bwd_dkv"])
        for name, got, want in zip(("dq", "dk", "dv"), (dq, dk, dv), fused):
            _compare(f"two-kernel vs single-pass route {name} {tag}", got,
                     want, TOL_KERNEL)
        if not (torch.all(fused[0][:, s // 2] == 0)
                and torch.all(dq[:, s // 2] == 0)):
            _fail(f"flash backward {tag}: the fully-masked row's dq is not "
                  f"exactly 0")
        if (hd, group) == (64, 1):
            for name, (kern, plain) in calls.items():
                kres[name]["ms"] = _time_ms(kern)
                kres[name]["plain_ms"] = _time_ms(plain)
                print(f"  {name} {tag}: kernel {kres[name]['ms']:.4f} ms, "
                      f"plain {kres[name]['plain_ms']:.4f} ms", flush=True)
            two = _time_ms(lambda: (calls["flash_sparse_bwd_dq"][0](),
                                    calls["flash_sparse_bwd_dkv"][0]()))
            print(f"  backward routes at the driver shape ({tag}): "
                  f"single-pass {kres['flash_sparse_bwd_fused']['ms']:.4f} "
                  f"ms, two-kernel {two:.4f} ms", flush=True)

    # the routes at a longer sequence (the crossover question)
    b, heads, s, hd = 1, 8, 4096, 64
    rows, cols, rkw, ckw = _flash_problem(stt, torch, dev, b, heads, s, hd,
                                          1, seed=7)
    fused = fs.flash_sparse_bwd_fused(*rows, **rkw)
    dq = fs.flash_sparse_bwd_dq(*rows, **rkw)
    dk, dv = fs.flash_sparse_bwd_dkv(*cols, **ckw)
    tag = f"R={b * heads} s={s} hd={hd}"
    for name, got, want in zip(("dq", "dk", "dv"), (dq, dk, dv), fused):
        _compare(f"two-kernel vs single-pass route {name} {tag}", got, want,
                 TOL_KERNEL)
    one = _time_ms(lambda: fs.flash_sparse_bwd_fused(*rows, **rkw), reps=5)
    two = _time_ms(lambda: (fs.flash_sparse_bwd_dq(*rows, **rkw),
                            fs.flash_sparse_bwd_dkv(*cols, **ckw)), reps=5)
    print(f"  backward routes at {tag} (causal): single-pass {one:.4f} ms, "
          f"two-kernel {two:.4f} ms", flush=True)


def phase_main_path(stt, torch, dev, wrappers):
    """The port's main path, launches counted; then held against the CPU."""
    from sputnik_tpu_torch.models import SparseAttention, SparseTransformer
    from sputnik_tpu_torch.patterns import driver_masks, uniform_mask

    b, s, h, heads, layers, ffn = 4, 512, 512, 8, 6, 2048
    print(f"phase 3a: forward path — SparseTransformer {layers}L b={b} "
          f"s={s} h={h} heads={heads} ffn={ffn} layout=flash, then "
          f"SparseAttention", flush=True)
    gen = torch.Generator().manual_seed(0)
    cpu_model = SparseTransformer.from_masks(
        driver_masks(b, s), num_layers=layers, hidden_size=h,
        num_heads=heads, ffn_hidden_size=ffn, use_residual=True,
        use_layernorm=True, activation="gelu", attention_layout="flash",
        generator=gen).eval()
    model = copy.deepcopy(cpu_model).to(dev)
    xs = [torch.randn(b, s, h, generator=torch.Generator().manual_seed(sd))
          for sd in (1, 2, 3)]
    topo = stt.SparseTopology.from_dense_mask(
        uniform_mask(s, s, sparsity=0.9, seed=0))
    cpu_attn = SparseAttention(heads, h, topo, generator=gen).eval()
    attn = copy.deepcopy(cpu_attn).to(dev)
    xa = torch.randn(b, s, h, generator=torch.Generator().manual_seed(4))
    flash = wrappers["flash_sparse_attention_fwd"]

    with torch.inference_mode():
        model(xs[0].to(dev))          # first call builds the device metadata
        attn(xa.to(dev))
        torch.cuda.synchronize()
        for w in wrappers.values():
            w.launches = 0
        outs = []
        for i, x in enumerate(xs):
            before = flash.launches
            outs.append(model(x.to(dev)))
            if flash.launches - before != layers:
                _fail(f"forward {i}: {flash.launches - before} flash "
                      f"launches, expected {layers}")
        out_a = attn(xa.to(dev))
        torch.cuda.synchronize()
        launches = {n: w.launches for n, w in wrappers.items()}
    print(f"  launches in the forward path: {launches}", flush=True)
    for n in ("bsr_spmm_panel", "bsr_sddmm_panel",
              "flash_sparse_attention_fwd"):
        if launches[n] == 0:
            _fail(f"kernel {n} was not launched by the forward path")

    print("phase 4a: forward outputs vs the CPU plain path; forward time",
          flush=True)
    with torch.inference_mode():
        for i, (x, out) in enumerate(zip(xs, outs)):
            ref = cpu_model(x)
            _compare(f"transformer forward batch {i}", out.cpu(), ref,
                     TOL_MODEL)
        _compare("SparseAttention forward", out_a.cpu(), cpu_attn(xa),
                 TOL_MODEL)
        xd = xs[0].to(dev)
        xad = xa.to(dev)
        torch.cuda.reset_peak_memory_stats(dev)
        fwd_ms = _time_ms(lambda: model(xd))
        peak = torch.cuda.max_memory_allocated(dev)
        attn_ms = _time_ms(lambda: attn(xad))
    print(f"  transformer forward {fwd_ms:.4f} ms, peak "
          f"device memory {peak / 2**20:.1f} MiB; SparseAttention forward "
          f"{attn_ms:.4f} ms", flush=True)
    return launches


def _train(model, x, y, steps, route=None, wrappers=None, label=""):
    """``steps`` Adam steps of the port's ``train_step``; returns the losses,
    the gradients of the first step and the optimizer. ``route(i)`` runs
    before step ``i`` and returns the launches expected of it by kernel
    (None: at least one); they are checked when ``wrappers`` are given."""
    import torch

    from sputnik_tpu_torch.examples.train_sparse_transformer import (
        train_step)

    opt = torch.optim.Adam(model.parameters(), lr=1e-3)
    losses, grads0 = [], None
    for i in range(steps):
        expect = route(i) if route else {}
        before = {n: w.launches for n, w in (wrappers or {}).items()}
        losses.append(train_step(model, opt, x, y))
        if i == 0:
            grads0 = {n: p.grad.detach().cpu().clone()
                      for n, p in model.named_parameters()}
        for n, want in (expect if wrappers else {}).items():
            got = wrappers[n].launches - before[n]
            if not (got == want if want is not None else got > 0):
                _fail(f"{label} step {i}: {got} launches of {n}, expected "
                      f"{'> 0' if want is None else want}")
    return [float(v) for v in losses], grads0, opt


def phase_train(stt, torch, dev, wrappers):
    """The training path, launches counted; then held against the CPU."""
    from sputnik_tpu_torch.examples.train_sparse_transformer import (
        train_step)
    from sputnik_tpu_torch.models import SparseAttention, SparseTransformer
    from sputnik_tpu_torch.ops import fused_attention as tfa
    from sputnik_tpu_torch.patterns import driver_masks, uniform_mask

    b, s, h, heads, layers, ffn = 4, 512, 512, 8, 6, 2048
    print(f"phase 3b: training path — SparseTransformer {layers}L b={b} "
          f"s={s} h={h}: 3 Adam steps (single-pass flash backward) + 1 "
          f"(two-kernel backward); SparseAttention: 3 Adam steps",
          flush=True)
    gen = torch.Generator().manual_seed(10)
    cpu_model = SparseTransformer.from_masks(
        driver_masks(b, s), num_layers=layers, hidden_size=h,
        num_heads=heads, ffn_hidden_size=ffn, use_residual=True,
        use_layernorm=True, activation="gelu", attention_layout="flash",
        generator=gen)
    model = copy.deepcopy(cpu_model).to(dev)
    x, y, xa, ya = (torch.randn(b, s, h, generator=torch.Generator(
        ).manual_seed(sd)) for sd in (11, 12, 13, 14))
    topo = stt.SparseTopology.from_dense_mask(
        uniform_mask(s, s, sparsity=0.9, seed=1))
    cpu_attn = SparseAttention(heads, h, topo, generator=gen)
    attn = copy.deepcopy(cpu_attn).to(dev)
    xd, yd, xad, yad = (t.to(dev) for t in (x, y, xa, ya))

    budget = tfa._FUSED_BWD_ACC_BYTES

    def fused_then_two(i):
        """Steps 0-2 take the single-pass backward, step 3 the two-kernel
        one (forced by the module constant, as the JAX test does)."""
        if i == 3:
            tfa._FUSED_BWD_ACC_BYTES = 0
            return {"flash_sparse_attention_fwd": layers,
                    "flash_sparse_bwd_fused": 0,
                    "flash_sparse_bwd_dq": layers,
                    "flash_sparse_bwd_dkv": layers}
        return {"flash_sparse_attention_fwd": layers,
                "flash_sparse_bwd_fused": layers,
                "flash_sparse_bwd_dq": 0, "flash_sparse_bwd_dkv": 0}

    torch.cuda.synchronize()
    for w in wrappers.values():
        w.launches = 0
    try:
        losses, grads0, opt = _train(model, xd, yd, 4, fused_then_two,
                                     wrappers, "transformer")
    finally:
        tfa._FUSED_BWD_ACC_BYTES = budget
    attn_losses, attn_grads0, attn_opt = _train(
        attn, xad, yad, 3, lambda i: {"bsr_spmm_panel": None,
                                      "bsr_spmm_t_panel": None,
                                      "bsr_sddmm_panel": None},
        wrappers, "SparseAttention")
    torch.cuda.synchronize()
    launches = {n: w.launches for n, w in wrappers.items()}
    print(f"  launches in the training path: {launches}", flush=True)
    print(f"  transformer losses {losses}; SparseAttention losses "
          f"{attn_losses}", flush=True)

    print("phase 4b: losses and gradients vs the CPU plain path; step time",
          flush=True)
    t0 = time.perf_counter()
    try:
        cpu_losses, cpu_grads0, _ = _train(cpu_model, x, y, 4,
                                           fused_then_two)
    finally:
        tfa._FUSED_BWD_ACC_BYTES = budget
    cpu_attn_losses, cpu_attn_grads0, _ = _train(cpu_attn, xa, ya, 3)
    print(f"  CPU reference: {len(cpu_losses)} + {len(cpu_attn_losses)} "
          f"steps in {time.perf_counter() - t0:.1f} s", flush=True)
    for tag, got, ref, g_got, g_ref in (
            ("transformer", losses, cpu_losses, grads0, cpu_grads0),
            ("SparseAttention", attn_losses, cpu_attn_losses, attn_grads0,
             cpu_attn_grads0)):
        _compare(f"{tag} step-0 loss", torch.tensor(got[:1]),
                 torch.tensor(ref[:1]), TOL_MODEL)
        worst = max(abs(a - r) / abs(r) for a, r in zip(got[1:], ref[1:]))
        print(f"  {tag} losses after step 0: max relative error "
              f"{worst:.3e} (bound {TOL_LOSS:.0e})", flush=True)
        if not worst <= TOL_LOSS:
            _fail(f"{tag} losses {got} vs CPU {ref}")
        errs = []
        for name, ref_g in g_ref.items():
            err = (g_got[name] - ref_g).abs().max().item()
            bound = TOL_MODEL * max(1.0, ref_g.abs().max().item())
            errs.append((err / bound, name, err, bound))
            if not (torch.isfinite(g_got[name]).all() and err <= bound):
                _fail(f"{tag} step-0 gradient {name}: max_abs_err {err} > "
                      f"{bound}")
        ratio, name, err, bound = max(errs)
        print(f"  {tag} step-0 gradients: {len(errs)} parameters within "
              f"{TOL_MODEL:.0e} x max(1, max|ref|); closest to its bound: "
              f"{name} {err:.3e} (bound {bound:.3e})", flush=True)

    step_ms = _time_ms(lambda: train_step(model, opt, xd, yd), reps=5,
                       inner=5)

    def fwd_bwd():
        model.zero_grad(set_to_none=True)
        torch.mean((model(xd) - yd) ** 2).backward()

    fb_ms = _time_ms(fwd_bwd, reps=5, inner=5)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats(dev)
    train_step(model, opt, xd, yd)
    torch.cuda.synchronize()
    peak = torch.cuda.max_memory_allocated(dev)
    attn_ms = _time_ms(lambda: train_step(attn, attn_opt, xad, yad), reps=5,
                       inner=5)
    print(f"  transformer training step (forward + backward + Adam) "
          f"{step_ms:.4f} ms, forward + backward {fb_ms:.4f} ms, peak device "
          f"memory of a step {peak / 2**20:.1f} MiB; SparseAttention "
          f"training step {attn_ms:.4f} ms", flush=True)
    return launches


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this run needs an NVIDIA GPU",
              file=sys.stderr)
        return 2
    import sputnik_tpu_torch as stt
    from sputnik_tpu_torch.ops.kernels import _build, kernel_wrappers

    dev = torch.device("cuda", 0)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True).stdout.strip().splitlines()[0]
    print(f"phase 1: device {torch.cuda.get_device_name(0)}; torch "
          f"{torch.__version__} CUDA {torch.version.cuda}; TF32 off "
          f"(matmul and cuDNN)", flush=True)
    print(smi, flush=True)
    t0 = time.perf_counter()
    _build.library()
    print(f"  kernels built (nvcc, sm_90a) in "
          f"{time.perf_counter() - t0:.2f} s", flush=True)
    for line in _build.build_log().splitlines():
        if "registers" in line or "spill" in line:
            print(f"  {line.strip()}", flush=True)

    wrappers = kernel_wrappers()
    kres = {n: {} for n in wrappers}
    phase_kernels(stt, torch, dev, kres)
    phase_flash_backward(stt, torch, dev, kres)
    fwd = phase_main_path(stt, torch, dev, wrappers)
    train = phase_train(stt, torch, dev, wrappers)
    launches = {n: fwd[n] + train[n] for n in wrappers}
    for n, c in launches.items():
        if c == 0:
            _fail(f"kernel {n} was launched on none of the smoke's paths")

    loaded = [m for m in sys.modules if m.split(".")[0] in
              ("jax", "jaxlib", "flax", "optax", "sputnik_tpu")]
    if loaded:
        _fail(f"JAX modules were imported: {loaded[:5]}")
    kernels = []
    for name, r in kres.items():
        source, replaces = REPLACES[name]
        kernels.append({"name": name, "route": "cuda", "source": source,
                        "replaces": replaces, "launches": launches[name],
                        "max_abs_err": r["max_abs_err"], "ms": r["ms"],
                        "plain_ms": r["plain_ms"]})
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
