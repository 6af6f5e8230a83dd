#!/usr/bin/env python3
"""Smoke run of the PyTorch port (``sputnik_tpu_torch``) on one NVIDIA GPU.

    python3 chip_smoke.py        # from the repository root, one CUDA GPU
    python3 chip_smoke.py --only moe_train,ring_path   # chosen phases only
    python3 chip_smoke.py --only decode_steps   # decode ms/token, launches
    python3 chip_smoke.py --only serving,graph_decode   # graph vs eager

Phases, each printing its lines:
  1. the device (name, power limit) and the kernels' nvcc build;
  2. each CUDA kernel against its plain PyTorch version at the headline
     shapes (SpMM and transposed SpMM 4096^3 d=0.1 with dense fp32 anchors,
     the bias+ReLU epilogue, by CUDA graph replay beside eager calls, the
     same bits twice, an emptied walk exactly 0 (+ bias), their SASS shown
     to hold TF32 tensor-core instructions and no FFMA, and again on a
     block-structured 4096^2 pattern (10% of the 64x64 tiles) beside
     torch.sparse_bsr_tensor @ dense; SDDMM 4096^2 d=0.1 at d=64 (graph
     replay beside eager, the same bits twice; its SASS, and the column
     walk B10c's, shown to hold TF32 tensor-core instructions and no
     FFMA), sparse-flash
     forward and the three backward kernels at R=32 s=512 hd=64 (the
     forward by CUDA graph replay beside eager calls, the same bits twice,
     its SASS shown to hold TF32 tensor-core instructions and B18a's walk
     int8 ones and no __dp4a; the backward likewise: the row walk B10a /
     B10b / B11b holds TF32 tensor-core instructions, B18b and B18c int8
     ones and no __dp4a), the
     backward also at hd 32 / 128 and GQA group 2, timed by CUDA graph
     replay beside eager calls, the row walk's dq and the column walk's
     dk / dv the same bits twice) and
     at the shapes the main paths give them; both backward routes timed at
     the driver shape and at s=4096, the single pass there also against a
     float64 plain run; decode attention (R=32, S=2, bk=1024, hd=128; bf16,
     f32 and int8 caches; qlen 1 and 4; GQA group 1 and 4, the latter
     with R_kv=8 as run (f) gives it; and B19 / B20a at hd 192 and 256)
     and the KV append B21 (R=32, hd=128, fp32 token views of a
     projection; bf16, f32 and int8 caches; bit-identical to its plain
     version, new lengths included, on the uniform, ragged and speculative
     routes; its device time by graph replay, its host-inclusive time a
     call and the plain composite's) at the serving shapes; the paged
     kernels, B20b likewise on the paged routes, at the paged serving
     shapes (2d); the batched many-mask kernels B6 / B7 / B8 at the
     MoE bank's shape (8 experts, d=0.3 [2048, 512] / [512, 2048] panels,
     C=640; timed, B7 by graph replay beside eager, the same bits twice)
     and at the panel attention's (b=4 DISTINCT masks, 8 heads, s=512,
     hd=64, and GQA) (2e); the sparse softmax B5's four (policy, mode)
     pairs, CSR rows forward / backward at the flat attention layout (32
     replicas of one [512, 512] mask at sparsity 0.9, an emptied row, a
     row of -inf scores) and at bench.py's pattern, panel rows forward /
     backward at the panel-layout step's [32, 8, 8, 64, 64] causal panel
     and SparseAttention's (by graph replay beside the plain version and a
     torch.sparse call, a team sweep, the same bits twice and after graph
     replays) (2f);
     the int8 kernels B16a / B16b at bench.py's 4096^3 d=0.1 (bn=1024) and
     at the int8 serving weight's shape (1024^2 at 128x128, N=2048,
     bn=512), each the same bits twice, an emptied walk block exactly 0,
     timed by CUDA graph replay beside torch._int_mm timed the same way,
     its pre-pass / product split from torch.profiler, and their SASS shown
     to hold int8 tensor-core instructions and no __dp4a; B17 at B4's
     shape (its product's SASS likewise; graph replay beside eager, the
     same bits twice, its pre-pass / product split), B18a (graph replay
     beside eager, the same bits twice, its pre-pass / walk split from
     torch.profiler) and the int8 flash backward B18b / B18c (likewise) at
     the int8
     example's attention and at B9's shape, each also shown >= 10x its
     limit away from the fp32 kernel's result (B1, B3, B4, B9, B10b,
     B10c), so that a kernel computing in fp32 would fail (2h); the
     compressed (true-BSR) kernels B13a / B13b (every epilogue; widths 64
     and 4096, B1 / B3 on the ELL panel of the same topology beside them),
     B14 and B15a / B15b (B15a on its split plan, its chunk size swept at
     R = 1 and 8, its merge counters back at 0; B15b also slot by slot,
     with a planted fault; both also in the softmax backward's modes, the
     same bits twice and after graph replays, by graph replay beside
     eager) on the skewed 4096^2 pattern (a 32-wide band plus three dense
     rows) at 64x64 tiles (2i); the sequence-parallel kernels B2 (the halo SpMM's
     interior and halo passes at 8192^2 window 1024, q=512, summing to B1
     over the shard), B11a and B11b (every band of a ring shard at s=8192
     causal, R=4, hd=64, carried and finished against B9 / B10a over the
     shard's keys, m bit-equal; a shard's empty bands keep the carry bit
     for bit; B11a's split plan printed, its fullest band by graph replay
     beside eager with its pre-pass / walk / merge split; B11b's fullest
     band by graph replay beside eager, against a float64 plain run, its
     dq the same bits twice; B10c at the GQA ring's fullest band, against
     a float64 plain run, the same bits twice, by graph replay beside eager
     with its pre-pass / walk / merge split) (2j); bf16 and
     mixed operands of the panel ops and a
     bf16 SparseLinear launching the f32 kernels, JAX's dtypes out (2m);
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
     c. serving at benchmarks/serving.py's full width (SparseLM 6 layers,
        b=4, P=1024, h=1024, 8 heads, ffn 4096, V=32000, causal masks;
        LMServer(s_max=P+64, bk=1024), bf16 cache): (a) greedy generate of
        64 tokens, (b) sampled (T=0.8, top_k=40, seeded generator), (c)
        prompt_lengths [1024, 900, 700, 512] (the ragged step), (d)
        decode_multi q=4 + rollback, (e) int8 cache, (f) GQA kv_heads=2 on
        2 layers, one KV append a layer a step on each; one decode_step
        under the sync debug mode. generate replays one CUDA graph a
        decode token: its wrappers count the eager warm-up step and the
        capture (2 a layer), and torch.profiler's device kernels over a
        generate show decode attention and the KV append layers x steps
        times;
     d. paged serving from a KV page pool (LMServer(n_pages=)), one
        paged append a layer a step, (e) a paged decode_multi q=4 too;
        then four decode routes of the same model (contiguous bf16 and
        int8, ragged bf16, paged bf16) timed in turns and profiled (device
        launches a step), one step's ops sorted by site: the KV write may
        issue none but its kernel (``--only decode_steps`` runs this part
        alone, unchecked, for comparisons across checkouts);
     e. MoE training at examples/train_moe_transformer.py's full config
        (6 layers, every 2nd a top-2 SparseMoE of 8 experts): the example's
        10 Adam steps with its self-checks, 6 launches each of B6, B7, B8 a
        step; then the driver config with attention_layout="panel", 1 step
        (12 each of B6, B7, B8);
     f, g. the flat op set and dynamic sparse training;
     h. int8 serving at examples/serve_sparse_int8.py's full width (h=1024,
        s=2048, 8 heads): its int8 forward (B18a + B16a) and fp32 forward
        (B9 + B1), the example itself, one spmm_qat SGD step (B16a; B16b +
        B17; the step timed and profiled), one attention_qat step (B18a;
        B9 + B10a) and one attention_qat(backward="int8") step (B18a; B18b
        + B18c), its
        gradients within tpu_smoke.py's 4e-1 of the fp32 fused attention's,
        the two steps timed in turns;
     i. the compressed chain: sddmm -> sparse_softmax -> spmm through
        stt.panel on PanelSpec(compressed=True) at the skewed 4096^2
        pattern, hd=64, forward and backward (B14 x 2, B15a and B15b each
        in both modes, B13a x 2, B13b x 2 a step; no ELL kernel), the step
        timed against the ELL layout's in turns and profiled; 5 SGD steps
        on a compressed-panel regression (the loss falls);
     j. ring flash attention at examples/train_seq_parallel.py's full
        config on 4 shards of the one card (s=8192 causal, R=4, hd=64):
        natural and zigzag order (group 1: B11a and B11b, 16 launches
        each) and GQA group 2 (B11a; B10b + B10c), forward and backward,
        both orders timed in turns, the GQA step timed and profiled, the
        example's toy regression for 4 SGD steps (the loss falls);
     k. the halo SpMM at benchmarks/scaling.py's banded problem (8192^2,
        causal window 1024, q=512, 4 shards): the interior / halo split
        (B2 x 2 a shard; B4 + B3 a shard backward), then the ragged
        exchange (8000^2) and the all_gather (a random 4096^2 mask, B1);
     l. decode as one CUDA graph replay a token against the parent's eager
        loop (written here from the public decode_step calls) on phase c's
        model: contiguous bf16 and int8, ragged and paged, greedy and
        sampled tokens and lengths bit-equal, ms/token (t65 - t1) / 64 in
        turns with its spread, device launches a token and busy share;
        decode_loop at examples/generate.py's shape (P=2048) with f32 and
        bf16-stored weights (cast_params), graph vs eager in turns, outputs
        bit-equal; the bf16-weights logits vs the CPU; the example with
        --bf16-params; examples/serve_continuous and serve_speculative at
        their full configs with their self-checks;
     m. remat: the driver config with remat False / True (gradients within
        1e-4 x max(1, max|ref|), B9 called 6 / 12 times a step, step ms in
        turns, peak memory), then b=1 s=8192;
     n. the auto crossover: the driver's widths at 2 layers, the xla and
        flash layouts at s = 128 ... 4096, forward and forward + backward
        in turns: the readings behind _XLA_FLASH_CROSSOVER;
     o. the sharded panel ops: sharded_spmm forward + backward at bench.py's
        4096^3 d=0.1 on 1 and 8 shards (B1, B4, B3 a shard) against
        stt.panel.spmm on the same topology and tiles, in turns (the seam's
        cost); sparse_attention_sharded and its compressed twin (B4 / B14,
        B5 / B15a + B15b, B1 / B13a, B3 / B13b a shard) on a +-256 window
        of 32768 (hd = 64) and the skewed 4096^2 pattern, 8 shards, timed;
     p. sharded flash attention at benchmarks/scaling.py's attention
        problem (s = 32768, +-256 window, R = 4, hd = 64, 8 shards):
        flash_attention_sharded at group 1 and 2 (B9, B10a a shard, the dk
        / dv psums) and once on the two-kernel route (B10b + B10c), and
        flash_attention_kv_sharded with the interior / halo split (B9 x 2 a
        shard, B10b + B10c by the budget) and without (B9, B10a), group 1
        and 2; the branch and halo rows printed; timed in turns against
        fused_sparse_attention unsharded;
     q. examples/train_seq_parallel.py at its full config (8 shards of
        s = 16384, hd 64, R 4: the kv-sharded split over a 2048 window and
        the natural ring, 4 SGD steps each, its self-checks), then
        dryrun_sp at 4, 6, 8 and 16 shards (every sequence-parallel path's
        gradient, DRYRUN_COMM, both halos ragged) against the CPU's losses;
     r. tensor-parallel serving at c's full width: TPLMServer greedy (64
        tokens, fp32 cache, eager steps) on one-device CUDA meshes at tp 2
        and tp 4, contiguous (B9 a shard a layer, B19 + B21 a shard a layer
        a step) and paged (B20a + B20b), dp 2 x tp 2 and GQA kv_heads=2 at
        tp 2, each held against the unsharded LMServer on the card
        (teacher-forced logits within 1e-3 x max(1, max|ref|), greedy tokens
        its argmax unless the top-2 gap is below that), its bf16-cache
        ms/token beside the unsharded server's; then an NCCL world of 1
        (the mesh's collectives, TPLMServer at tp 1 through all_reduce,
        tokens equal to the one-device mesh's) and dryrun_tp_serving(4);
     s. training over a mesh: the GPipe pipeline (4 TransformerLayer stages
        at the MoE example's width, h=512, 8 heads, ffn 2048, causal
        s=512, flash; n_micro 4 and 8 microbatches of 2: B9 + B10a T x 4
        times a step, T = n_micro + 3) against the sequential stack, and
        the MoE example's full config at ep 4 on a one-device mesh (B6,
        B7, B8 4 times a projection) against the unsharded model, each on
        the card (outputs and losses within 1e-4 x max(1, max|ref|),
        gradients within 1e-3 x max|ref|), the steps timed in turns
        against it and profiled, the bubble read against n_micro / T; an
        NCCL world of 1 (each collective's gradient, pp 1 and ep 1 through
        all_reduce, counted); dryrun_pp(4) and dryrun_ep(4);
  4. the outputs, losses and gradients against the same modules' plain path
     on the CPU (serving: fp32-cache logits and greedy tokens, teacher
     forced, of the MHA model and of run (f)'s GQA model; the paged pool;
     the first MoE step's routing, losses and router / expert gradients and
     the panel model's forward; the flat chain under set_backend("xla") and
     the csr SparseLinear, also against the panel layer on the card; the
     int8 attention, projection, spmm_qat gradients and
     attention_qat(backward="int8") gradients under
     set_backend("pallas"); the compressed chain's output and gradients;
     the ring's output and gradients, also against dense causal attention
     on the card; the halo SpMM's, banded also against the dense product;
     every sharded path of o and p at full size),
     and the forward / training-step / prefill /
     decode times and peak device memory.
It prints one JSON line of per-kernel results, then, last, the device line
``{"ok": true, "device": {...}}``. Any failed check raises (exit code != 0).
TF32 is switched off, so every product here runs in full fp32.
"""

from __future__ import annotations

import contextlib
import copy
import io
import itertools
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
    "decode_attention": ("sputnik_tpu_torch/csrc/decode_attention.cu",
                         "sputnik_tpu/ops/pallas/decode_attention.py:51"),
    "ragged_append": ("sputnik_tpu_torch/csrc/ragged_append.cu",
                      "sputnik_tpu/ops/pallas/ragged_append.py:54"),
    "paged_attention": ("sputnik_tpu_torch/csrc/decode_attention.cu",
                        "sputnik_tpu/ops/pallas/paged_attention.py:51"),
    "paged_append": ("sputnik_tpu_torch/csrc/ragged_append.cu",
                     "sputnik_tpu/ops/pallas/paged_attention.py:188"),
    "spmm_bh": ("sputnik_tpu_torch/csrc/bsr_spmm.cu",
                "sputnik_tpu/ops/batched_panel.py:123"),
    "sddmm_bh": ("sputnik_tpu_torch/csrc/bsr_sddmm.cu",
                 "sputnik_tpu/ops/batched_panel.py:177"),
    "spmm_t_bh": ("sputnik_tpu_torch/csrc/bsr_spmm_t.cu",
                  "sputnik_tpu/ops/batched_panel.py:238"),
    "ell_softmax": ("sputnik_tpu_torch/csrc/ell_softmax.cu",
                    "sputnik_tpu/ops/pallas/ell_softmax.py:31"),
    # B5's other modes: its CSR backward (JAX takes the VJP in XLA,
    # _sparse_softmax_bwd), its panel forward (the TPU kernel's own ELL
    # panel) and panel backward (XLA, _softmax_bwd / _sm_bh_bwd)
    "ell_softmax_bwd": ("sputnik_tpu_torch/csrc/ell_softmax.cu",
                        "sputnik_tpu/ops/api.py:194"),
    "panel_softmax": ("sputnik_tpu_torch/csrc/ell_softmax.cu",
                      "sputnik_tpu/ops/pallas/ell_softmax.py:31"),
    "panel_softmax_bwd": ("sputnik_tpu_torch/csrc/ell_softmax.cu",
                          "sputnik_tpu/ops/panel_api.py:489"),
    "bsr_spmm_panel_int8": ("sputnik_tpu_torch/csrc/bsr_spmm_int8.cu",
                            "sputnik_tpu/ops/pallas/bsr_spmm_int8.py:44"),
    "bsr_spmm_t_panel_int8": ("sputnik_tpu_torch/csrc/bsr_spmm_int8.cu",
                              "sputnik_tpu/ops/pallas/bsr_spmm_int8.py:121"),
    "bsr_sddmm_panel_int8": ("sputnik_tpu_torch/csrc/bsr_spmm_int8.cu",
                             "sputnik_tpu/ops/pallas/bsr_spmm_int8.py:198"),
    "flash_sparse_attention_fwd_int8": (
        "sputnik_tpu_torch/csrc/flash_sparse_int8.cu",
        "sputnik_tpu/ops/pallas/flash_sparse_int8.py:54"),
    "flash_sparse_bwd_dq_int8": (
        "sputnik_tpu_torch/csrc/flash_sparse_int8_bwd.cu",
        "sputnik_tpu/ops/pallas/flash_sparse_int8.py:189"),
    "flash_sparse_bwd_dkv_int8": (
        "sputnik_tpu_torch/csrc/flash_sparse_int8_bwd.cu",
        "sputnik_tpu/ops/pallas/flash_sparse_int8.py:298"),
    "bsr_spmm_panel_c": ("sputnik_tpu_torch/csrc/bsr_spmm.cu",
                         "sputnik_tpu/ops/pallas/bsr_compressed.py:32"),
    "bsr_spmm_t_panel_c": ("sputnik_tpu_torch/csrc/bsr_spmm_t.cu",
                           "sputnik_tpu/ops/pallas/bsr_compressed.py:103"),
    "bsr_sddmm_panel_c": ("sputnik_tpu_torch/csrc/bsr_sddmm.cu",
                          "sputnik_tpu/ops/pallas/bsr_compressed.py:163"),
    "c_softmax_stats": ("sputnik_tpu_torch/csrc/bsr_compressed.cu",
                        "sputnik_tpu/ops/pallas/bsr_compressed.py:253"),
    "c_softmax_apply": ("sputnik_tpu_torch/csrc/bsr_compressed.cu",
                        "sputnik_tpu/ops/pallas/bsr_compressed.py:331"),
    # the softmax backward's modes of B15a / B15b: JAX takes the row sum by
    # B13a against a ones column, the product in XLA (_softmax_bwd)
    "c_softmax_rowsum": ("sputnik_tpu_torch/csrc/bsr_compressed.cu",
                         "sputnik_tpu/ops/pallas/bsr_compressed.py:32"),
    "c_softmax_grad": ("sputnik_tpu_torch/csrc/bsr_compressed.cu",
                       "sputnik_tpu/ops/panel_api.py:489"),
    "bsr_spmm_panel_sel": ("sputnik_tpu_torch/csrc/bsr_spmm.cu",
                           "sputnik_tpu/ops/pallas/bsr_spmm.py:153"),
    "flash_sparse_ring_band_fwd": (
        "sputnik_tpu_torch/csrc/flash_sparse_fwd.cu",
        "sputnik_tpu/ops/pallas/flash_sparse.py:653"),
    "flash_sparse_ring_band_bwd": (
        "sputnik_tpu_torch/csrc/flash_sparse_bwd.cu",
        "sputnik_tpu/ops/pallas/flash_sparse.py:772"),
}
TOL_LOSS = 1e-3     # relative, losses after the first Adam step
# the MoE example's default step count: Adam's first steps at lr 1e-3
# overshoot (the loss rises for ~3 steps at the full config, as the driver
# config's does in phase 3b), so "the loss decreases" is checked over these
MOE_STEPS = 10
# The H100 SXM's published peaks (NVIDIA's data sheet, at 700 W): fp32
# outside the tensor cores, which is what the fp32 kernels compute in, int8
# (the rate of the int8 kernels' operations) and device memory. A bound is
# the larger of operations / peak and bytes / PEAK_BYTES, counting each
# input byte read once and each output byte written once, and only the work
# this run's data needs.
PEAK_F32 = 67e12
PEAK_INT8 = 1979e12
PEAK_BYTES = 3.35e12
# fp32-accurate products on the tensor cores in split TF32: three TF32
# products (hi.hi + hi.lo + lo.hi) an fp32 one at the 495 TFLOP/s TF32
# peak. The bound of the fp32 SpMMs that run so (B1, B2, B3, B6, B8, B13a,
# B13b); the FMA peak's figure is printed beside it.
PEAK_3XTF32 = 495e12 / 3


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


_GRAPH_STREAM = []   # the one side stream that _graph_ms captures on


def _graph_ms(fn, reps: int = 10, inner: int = 8, warmup: int = 3) -> float:
    """Milliseconds per ``fn()`` call on the device alone: ``inner`` calls
    captured in one CUDA graph and replayed, the median over ``reps``
    replays, CUDA events around each. A call's host work (argument checks,
    the launch through ctypes) is not in it; ``_time_ms`` measures the
    host's rate of calls instead where a kernel takes less device time
    than its wrapper takes on the host (tens of microseconds). The capture
    runs on one side stream, and the cuBLAS workspaces a captured
    ``torch.matmul`` takes are released after, so that later phases'
    peak memory does not carry them."""
    import torch

    if not _GRAPH_STREAM:
        _GRAPH_STREAM.append(torch.cuda.Stream())
    side = _GRAPH_STREAM[0]
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for _ in range(warmup):
            fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph, stream=side):
        for _ in range(inner):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        graph.replay()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end) / inner)
    del graph
    clear = getattr(torch._C, "_cuda_clearCublasWorkspaces", None)
    if clear is not None:
        torch.cuda.synchronize()
        clear()
    return statistics.median(times)


def _compare(name, got, ref, tol, results=None, floor=1.0, quiet=False):
    """max |got - ref| against ``tol * max(floor, max |ref|)``; raises.
    ``floor=0`` makes the limit relative, for values far below 1 such as
    gradients; then an all-zero ``ref`` fails too, so that a zeroed ``got``
    cannot pass. ``quiet`` prints nothing. Returns the share of the limit
    used (0 for an exact match at a zero limit)."""
    import torch

    if got.shape != ref.shape:
        _fail(f"{name}: shape {tuple(got.shape)} != {tuple(ref.shape)}")
    if not torch.isfinite(got).all():
        _fail(f"{name}: non-finite values")
    err = (got.float() - ref.float()).abs().max().item()
    ref_max = ref.abs().max().item()
    bound = tol * max(floor, ref_max)
    if not quiet:
        print(f"  {name}: max_abs_err {err:.3e} (bound {bound:.3e}, max|ref| "
              f"{ref_max:.3e})", flush=True)
    if floor == 0 and not ref_max > 0:
        _fail(f"{name}: the reference is all zeros")
    if not err <= bound:
        _fail(f"{name}: max_abs_err {err} > {bound}")
    if results is not None:
        results["max_abs_err"] = max(results.get("max_abs_err", 0.0), err)
    return err / bound if bound else 0.0


def _nbytes(*tensors) -> int:
    return sum(t.numel() * t.element_size() for t in tensors)


def _compare_each(name, got, ref, rtol, scale=None):
    """Each slot's |got - ref| against ``rtol * |ref|`` (floored at f32
    ``tiny``, so an exact 0 must stay 0); raises. For outputs spread over
    many magnitudes far below 1, such as a softmax's, where a limit from
    max|ref| would pass a kernel that zeroed its small outputs. ``scale``
    (each slot's) replaces |ref| where the output cancels."""
    import torch

    if got.shape != ref.shape:
        _fail(f"{name}: shape {tuple(got.shape)} != {tuple(ref.shape)}")
    if not torch.isfinite(got).all():
        _fail(f"{name}: non-finite values")
    ref = ref.float()
    scale = (ref.abs() if scale is None else scale.float()).clamp(
        min=torch.finfo(torch.float32).tiny)
    rel = ((got.float() - ref).abs() / scale).max().item()
    live = ref[ref != 0].abs()
    med = live.median().item() if live.numel() else 0.0
    print(f"  {name}: max_rel_err {rel:.3e} per slot (limit {rtol:.0e} x "
          f"|plain|; median |plain| {med:.3e}, so a limit {rtol * med:.3e} "
          f"there)", flush=True)
    if not rel <= rtol:
        _fail(f"{name}: max_rel_err {rel} > {rtol}")


def _bound(r, flops, nbytes, peak=PEAK_F32):
    """The least time of the timed call (``r["ms"]``): the larger of its
    operations over ``peak`` (fp32 unless given) and its bytes over the
    memory rate."""
    ops_ms = flops / peak * 1e3
    bytes_ms = nbytes / PEAK_BYTES * 1e3
    r["bound_ms"] = max(ops_ms, bytes_ms)
    r["bound_by"] = "operations" if ops_ms >= bytes_ms else "bytes"
    print(f"    bound {r['bound_ms']:.4f} ms by {r['bound_by']} "
          f"({flops / 1e9:.3f} G op at {peak / 1e12:.0f} T/s, "
          f"{nbytes / 1e6:.2f} MB); kernel at "
          f"{r['bound_ms'] / r['ms']:.1%} of it", flush=True)


def _sparse_bound(r, nnz, heads, width, dense_bytes, peak=PEAK_F32):
    """The bound of a sparse product from what its data needs: 2 operations
    per nonzero, replica and dense column (``width``); bytes of the pattern
    (a 4-byte column index per nonzero, shared by a mask's ``heads``
    replicas), of the values (4 bytes per nonzero and replica, read or
    written) and of the dense operands and output (``dense_bytes``). The
    zeros a panel stores in its occupied tiles, and its padding, are the
    kernel's choice, not the function's work. ``peak``: PEAK_3XTF32 for the
    products on the tensor cores, with the FMA figure printed beside."""
    flops = 2.0 * nnz * heads * width
    _bound(r, flops, 4 * nnz + 4 * nnz * heads + dense_bytes, peak)
    if peak != PEAK_F32:
        print(f"    (at the fp32 FMA peak the operations would take "
              f"{flops / PEAK_F32 * 1e3:.4f} ms)", flush=True)


def _stored_note(name, tiles, width):
    """Prints the work of the stored panel (every occupied tile, zeros
    included) beside the bound, which counts the nonzeros alone: at the
    fp32 FMA peak and in split TF32 on the tensor cores."""
    flops = 2.0 * tiles * width
    print(f"    {name}: the stored panel's {flops / 1e9:.3f} GFLOP would take "
          f"{flops / PEAK_F32 * 1e3:.4f} ms at the fp32 FMA peak, "
          f"{flops / PEAK_3XTF32 * 1e3:.4f} ms in split TF32 (ops / "
          f"{PEAK_3XTF32 / 1e12:.0f} TFLOP/s) (not the bound)", flush=True)


def _library_ms(name, fn, timer=None, **kw):
    """The time of one PyTorch call computing the kernel's function, a
    yardstick the port never calls, by ``timer`` (``_time_ms``; with
    ``_graph_ms``, eager calls where the call cannot be captured); None
    (printed) where it fails here."""
    try:
        try:
            ms = (timer or _time_ms)(fn, **kw)
        except Exception as e:
            if timer is not _graph_ms:
                raise
            print(f"  library call for {name}: no CUDA graph ({e!r}); "
                  f"timed in eager calls", flush=True)
            ms = _time_ms(fn, **kw)
    except Exception as e:  # a yardstick, not a check of the port
        print(f"  library call for {name} failed: {e!r}", flush=True)
        return None
    print(f"  library call for {name}: {ms:.4f} ms", flush=True)
    return ms


def _same_bits_and_empty(name, first, second, call, meta, count, bias):
    """Two calls give the same bits (no float atomics), and the first walk
    (row block 0 for ``count`` = "nblocks", block column 0 for
    "t_nblocks") emptied by setting its count to 0 writes exactly 0, or
    exactly its ``bias``, while the other rows keep their bits."""
    import torch

    if not torch.equal(first.view(torch.int32), second.view(torch.int32)):
        _fail(f"{name}: two calls differ in their bits")
    md = dict(meta)
    md[count] = meta[count].clone()
    md[count][..., 0] = 0
    got = call(md)
    rows = 64
    want = (torch.zeros_like(got[:rows]) if bias is None
            else bias[:rows, None].expand_as(got[:rows]))
    if not torch.equal(got[:rows], want):
        _fail(f"{name}: an emptied walk is not exactly "
              f"{'0' if bias is None else 'its bias'}")
    if not torch.equal(got[rows:].view(torch.int32),
                       first[rows:].view(torch.int32)):
        _fail(f"{name}: emptying one walk changed the others' bits")
    print(f"  {name}: the same bits twice; an emptied walk exactly "
          f"{'0' if bias is None else 'its bias'}, the rest unchanged",
          flush=True)


def _block_structured_row(stt, torch, dev, dense):
    """B1 and B3 on a block-structured pattern at the headline's size:
    4096^2, 10% of the 64 x 64 tiles kept and dense inside (balanced over
    the row blocks), dense operand 4096 wide; beside dense fp32
    torch.matmul and torch.sparse_bsr_tensor @ dense (timed, not checked;
    None where the call fails here). Printed, not in the JSON line."""
    from sputnik_tpu_torch.ops import panel_api as P
    from sputnik_tpu_torch.ops.kernels.bsr_spmm import (
        bsr_spmm_panel, bsr_spmm_panel_plain)
    from sputnik_tpu_torch.ops.kernels.bsr_spmm_t import (
        bsr_spmm_t_panel, bsr_spmm_t_panel_plain)
    from sputnik_tpu_torch.patterns import block_random_topology

    size = dense.shape[-1]
    topo = block_random_topology(size, size, 64, 64, density=0.1)
    rng = np.random.RandomState(5)
    w = (topo.to_dense_mask() * rng.randn(size, size)).astype(np.float32)
    mat = stt.SparseMatrix(w)
    spec = P.PanelSpec(mat.topology)
    bv = spec.view
    panel = torch.from_numpy(P.values_to_panel_np(
        mat.topology, mat.values, spec.bm, spec.bk)).to(dev)[None]
    meta = spec.meta(dev)
    args = (meta["block_cols"], meta["nblocks"], panel, dense[None])
    targs = (meta["t_src_i"], meta["t_src_s"], meta["t_nblocks"], panel,
             dense[None])
    a_dense = torch.from_numpy(w).to(dev)
    stored = 2.0 * bv.num_blocks * spec.bm * spec.bk * size
    print(f"  block-structured row: {size}^2, {bv.num_blocks} of "
          f"{bv.mb * bv.kb} 64x64 tiles kept (max_bpr {bv.max_bpr}), "
          f"{stored / 1e9:.2f} GFLOP stored; split TF32 bound "
          f"{stored / PEAK_3XTF32 * 1e3:.4f} ms, fp32 FMA "
          f"{stored / PEAK_F32 * 1e3:.4f} ms", flush=True)
    got = bsr_spmm_panel(*args, rows=size)[0]
    _compare("spmm block-structured", got,
             bsr_spmm_panel_plain(*args, rows=size)[0], TOL_KERNEL)
    _compare("spmm block-structured vs dense torch.matmul", got,
             a_dense @ dense, TOL_KERNEL)
    tgot = bsr_spmm_t_panel(*targs, rows=size)[0]
    _compare("spmm_t block-structured", tgot,
             bsr_spmm_t_panel_plain(*targs, rows=size)[0], TOL_KERNEL)
    if not (torch.equal(got, bsr_spmm_panel(*args, rows=size)[0]) and
            torch.equal(tgot, bsr_spmm_t_panel(*targs, rows=size)[0])):
        _fail("block-structured: two calls differ in their bits")
    del got, tgot
    ms = _graph_ms(lambda: bsr_spmm_panel(*args, rows=size))
    tms = _graph_ms(lambda: bsr_spmm_t_panel(*targs, rows=size))
    mm = _graph_ms(lambda: a_dense @ dense)
    a_bsr, at_bsr = _to_bsr(a_dense), _to_bsr(a_dense.T.contiguous())
    bsr = None if a_bsr is None else _library_ms(
        "block-structured spmm (torch.sparse_bsr_tensor @ dense)",
        lambda: a_bsr @ dense, timer=_graph_ms)
    tbsr = None if at_bsr is None else _library_ms(
        "block-structured spmm_t (torch.sparse_bsr_tensor of A^T @ G)",
        lambda: at_bsr @ dense, timer=_graph_ms)
    print(f"  block-structured: B1 {ms:.4f} ms ({stored / ms / 1e9:.2f} "
          f"TFLOP/s fp32 on the stored tiles), B3 {tms:.4f} ms; dense fp32 "
          f"torch.matmul {mm:.4f} ms; torch.sparse_bsr_tensor @ dense "
          f"{bsr if bsr is None else f'{bsr:.4f} ms'}, of A^T "
          f"{tbsr if tbsr is None else f'{tbsr:.4f} ms'}", flush=True)


def _to_bsr(a):
    """``a`` as a ``torch.sparse_bsr_tensor`` of 64 x 64 blocks (its zero
    blocks dropped), or None (printed) where PyTorch cannot build it."""
    try:
        return a.to_sparse_bsr((64, 64))
    except Exception as e:  # a yardstick, not a check of the port
        print(f"  torch.sparse_bsr_tensor: cannot build ({e!r})", flush=True)
        return None


def phase_kernels(stt, torch, dev, kres):
    """Each kernel against its plain version on the card."""
    from sputnik_tpu_torch.ops import panel_api as P
    from sputnik_tpu_torch.ops.kernels import _build
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
    _sass_check_tc(_build)
    _sass_check_flash(_build)
    _sass_check_sddmm_col(_build)
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
    _same_bits_and_empty("spmm", kern("bias"), kern("bias"),
                         lambda md: bsr_spmm_panel(
                             md["block_cols"], md["nblocks"], panel[None],
                             dense[None], bias, rows=size,
                             epilogue="bias")[0],
                         meta, "nblocks", bias)
    flop = 2.0 * bv.num_blocks * spec.bm * spec.bk * size
    r["ms"], eager_ms = _graph_ms(kern), _time_ms(kern)
    r["plain_ms"] = _time_ms(plain)
    dense_ms = _graph_ms(lambda: a_dense @ dense)
    dense_eager = _time_ms(lambda: a_dense @ dense)
    ms_relu = _graph_ms(lambda: kern("bias_relu"))
    print("  (times: CUDA graph replay, the median of 10 replays of 8 calls; "
          "eager: the median of 10 samples of 10 back-to-back calls)")
    print(f"  spmm {size}^3 d={density}: kernel {r['ms']:.4f} ms "
          f"(eager {eager_ms:.4f}; {flop / r['ms'] / 1e9:.2f} TFLOP/s fp32 "
          f"on the stored tiles), bias_relu {ms_relu:.4f} ms, plain "
          f"{r['plain_ms']:.4f} ms, dense fp32 torch.matmul {dense_ms:.4f} "
          f"ms (eager {dense_eager:.4f})", flush=True)
    r["library_ms"] = dense_ms          # torch.matmul on the densified A
    nnz = mat.topology.nnz
    _sparse_bound(r, nnz, 1, size, _nbytes(dense) + size * size * 4,
                  PEAK_3XTF32)
    _stored_note("spmm", bv.num_blocks * spec.bm * spec.bk, size)

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
    _same_bits_and_empty("spmm_t", got, t_kern(),
                         lambda md: bsr_spmm_t_panel(
                             md["t_src_i"], md["t_src_s"], md["t_nblocks"],
                             panel[None], dense[None], rows=size)[0],
                         meta, "t_nblocks", None)
    r["ms"], eager_ms = _graph_ms(t_kern), _time_ms(t_kern)
    r["plain_ms"] = _time_ms(t_plain)
    dense_t_ms = _graph_ms(lambda: a_dense.T @ dense)
    dense_t_eager = _time_ms(lambda: a_dense.T @ dense)
    print(f"  spmm_t {size}^3 d={density}: kernel {r['ms']:.4f} ms (eager "
          f"{eager_ms:.4f}; {flop / r['ms'] / 1e9:.2f} TFLOP/s), plain "
          f"{r['plain_ms']:.4f} ms, dense fp32 a.T @ G {dense_t_ms:.4f} ms "
          f"(eager {dense_t_eager:.4f})", flush=True)
    r["library_ms"] = dense_t_ms
    _sparse_bound(r, nnz, 1, size, _nbytes(dense) + size * size * 4,
                  PEAK_3XTF32)
    del a_dense, got
    _block_structured_row(stt, torch, dev, dense)
    del panel, dense

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
    if not torch.equal(got.view(torch.int32), sd_kern().view(torch.int32)):
        _fail("sddmm: two calls differ in their bits")
    r["ms"], eager_ms = _graph_ms(sd_kern), _time_ms(sd_kern)
    r["plain_ms"] = _time_ms(sd_plain)
    print(f"  sddmm {size}^2 dim {d}: kernel {r['ms']:.4f} ms (graph; eager "
          f"{eager_ms:.4f}; the FMA body read 0.1387 eager, PERF.md), the "
          f"same bits twice; plain {r['plain_ms']:.4f} ms", flush=True)
    # library: cuSPARSE's SDDMM on the CSR pattern, (lhs @ rhs^T) at nnz
    topo = mat.topology
    csr = torch.sparse_csr_tensor(      # column_indices is padded past nnz
        torch.from_numpy(np.asarray(topo.row_offsets, np.int64)),
        torch.from_numpy(np.asarray(topo.column_indices[:topo.nnz],
                                    np.int64)),
        torch.ones(topo.nnz), (size, size)).to(dev)
    rhs_t = rhs[0].T.contiguous()
    r["library_ms"] = _library_ms(
        "sddmm (torch.sparse.sampled_addmm, CSR)",
        lambda: torch.sparse.sampled_addmm(csr, lhs[0], rhs_t, beta=0.0),
        timer=_graph_ms)
    _sparse_bound(r, nnz, 1, d, _nbytes(lhs, rhs), PEAK_3XTF32)
    _stored_note("sddmm", int(meta["nblocks"].sum()) * 64 * 64, d)
    del lhs, rhs, got, csr, rhs_t

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
    _flash_split_note("flash", b * heads * fspec.mb, fm["max_bpr"])
    if not torch.equal(out.view(torch.int32), flash_sparse_attention_fwd(
            *fargs, **fkw)[0].view(torch.int32)):
        _fail("flash: two calls differ in their bits")
    r["ms"] = _graph_ms(lambda: flash_sparse_attention_fwd(*fargs, **fkw))
    eager_ms = _time_ms(lambda: flash_sparse_attention_fwd(*fargs, **fkw))
    r["plain_ms"] = _time_ms(
        lambda: flash_sparse_attention_fwd_plain(*fargs, **fkw))
    split = _device_split(torch, lambda: flash_sparse_attention_fwd(*fargs,
                                                                    **fkw))
    print(f"  flash R={b * heads} s={s} hd={hd}: kernel {r['ms']:.4f} ms "
          f"(graph; eager {eager_ms:.4f}; the FMA body read 0.1034 eager, "
          f"PERF.md), "
          f"plain {r['plain_ms']:.4f} ms; device split "
          f"{_split_text(split)}", flush=True)
    sdpa = _sdpa_inputs(torch, dev, b, heads, q, k, v)
    r["library_ms"] = _library_ms(
        "flash forward (F.scaled_dot_product_attention, boolean mask)",
        lambda: sdpa["fwd"](), timer=_graph_ms)
    _bound(r, 4.0 * _flash_pairs(b, heads, s) * hd,
           _nbytes(*fargs[:5], q, k, v) + _nbytes(out, m, l), PEAK_3XTF32)
    print(f"    (at the fp32 FMA peak the operations would take "
          f"{4.0 * _flash_pairs(b, heads, s) * hd / PEAK_F32 * 1e3:.4f} ms)",
          flush=True)

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


def _flash_pairs(b, heads, s) -> float:
    """Key-query pairs the driver's masks keep, once per head: the work the
    data needs (the kernels also visit the masked pairs of partial tiles)."""
    from sputnik_tpu_torch.patterns import driver_masks

    return float((driver_masks(b, s) != 0).sum()) * heads


def _flash_split_note(name, walks, max_bpr):
    """Prints the forward kernel's split plan (B9, B11a) for these walks."""
    from sputnik_tpu_torch.ops.kernels.flash_sparse import flash_split_tiles

    tiles = flash_split_tiles(walks, max_bpr)
    chunks = -(-max_bpr // tiles)
    print(f"  {name}: {walks} walks of <= {max_bpr} slots; "
          + (f"split into {chunks} chunks of {tiles} slots ({walks * chunks} "
             f"blocks) and merged" if chunks > 1 else "walked whole"),
          flush=True)


def _split_text(split):
    """A _device_split result as text: each kernel's device ms."""
    return ", ".join(f"{k.split('(')[0].split('<')[0][-40:]} {v:.4f}"
                     for k, v in sorted(split.items(), key=lambda x: -x[1])
                     if v > 0)


def _sdpa_inputs(torch, dev, b, heads, q, k, v, g=None):
    """``F.scaled_dot_product_attention`` on the flash kernels' operands
    (``[b * heads, s, hd]`` viewed as ``[b, heads, s, hd]``, the driver's
    masks as a boolean ``attn_mask``): the library call timed beside the
    flash kernels. ``fwd()`` runs it; ``bwd()`` its backward for ``g``."""
    import torch.nn.functional as F

    from sputnik_tpu_torch.patterns import driver_masks

    s, hd = q.shape[1], q.shape[2]
    mask = torch.from_numpy(driver_masks(b, s) != 0).to(dev)[:, None]
    q4, k4, v4 = (t.reshape(b, heads, s, hd).detach().clone()
                  for t in (q, k, v))

    def fwd():
        return F.scaled_dot_product_attention(q4, k4, v4, attn_mask=mask,
                                              scale=hd ** -0.5)

    out = {"fwd": fwd}
    if g is not None:
        qg, kg, vg = (t.requires_grad_() for t in (q4, k4, v4))
        o = F.scaled_dot_product_attention(qg, kg, vg, attn_mask=mask,
                                           scale=hd ** -0.5)
        g4 = g.reshape(b, heads, s, hd)
        out["bwd"] = lambda: torch.autograd.grad(o, (qg, kg, vg), g4,
                                                 retain_graph=True)
    return out


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


def _f64_rows_compare(name, fs, rows, rkw, got):
    """The single-pass backward's (dq, dk, dv) from the kernel against its
    plain version run in float64 on the same (upcast) operands: split TF32
    is held to fp32's accuracy, the cancellation in ds = p (dP - D)
    included, at the deep walks."""
    rows64 = tuple(x.double() if x.is_floating_point() and i >= 5 else x
                   for i, x in enumerate(rows))
    ref = fs.flash_sparse_bwd_fused_plain(*rows64, **rkw)
    for part, a, b in zip(("dq", "dk", "dv"), got, ref):
        _compare(f"{name} {part} vs float64 plain", a, b.float(), TOL_KERNEL)


def phase_flash_backward(stt, torch, dev, kres):
    """B10a / B10b / B10c against their plain versions on the card, the
    row walk's dq the same bits twice, the deep walk against float64, and
    the two backward routes against each other."""
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
        # dq takes no float atomics (the fused dk / dv do), nor does the
        # column walk: the same bits twice
        if not (torch.equal(fused[0], calls["flash_sparse_bwd_fused"][0]()[0])
                and torch.equal(dq, calls["flash_sparse_bwd_dq"][0]())):
            _fail(f"flash backward {tag}: dq differs between two calls")
        if not all(torch.equal(a, b_) for a, b_ in zip(
                (dk, dv), calls["flash_sparse_bwd_dkv"][0]())):
            _fail(f"flash backward {tag}: dk / dv of the column walk differ "
                  f"between two calls")
        print(f"  flash backward {tag}: dq the same bits twice (B10a, "
              f"B10b), dk / dv too (B10c), the fully-masked row's dq "
              f"exactly 0", flush=True)
        if (hd, group) == (64, 1):
            q, k, v, g = rows[5:9]
            sdpa = _sdpa_inputs(torch, dev, b, heads, q, k, v, g)
            lib = _library_ms("flash backward (the backward of "
                              "F.scaled_dot_product_attention: dq, dk, dv)",
                              sdpa["bwd"])
            pairs = _flash_pairs(b, heads, s)
            # per key-query pair and head dim: the recomputed QK^T and
            # dO V^T, then dV, dQ, dK (fused), dQ (dq), dV and dK (dkv);
            # the row and column walks on the tensor cores in split TF32
            work = {"flash_sparse_bwd_fused": (10, rows, (q, k, v),
                                               PEAK_3XTF32),
                    "flash_sparse_bwd_dq": (6, rows, (q,), PEAK_3XTF32),
                    "flash_sparse_bwd_dkv": (8, cols, (k, v), PEAK_3XTF32)}
            for name, (kern, plain) in calls.items():
                eager = _time_ms(kern)
                kres[name]["ms"] = _graph_ms(kern)
                kres[name]["plain_ms"] = _time_ms(plain)
                kres[name]["library_ms"] = lib
                print(f"  {name} {tag}: kernel {kres[name]['ms']:.4f} ms "
                      f"(graph; eager {eager:.4f}), plain "
                      f"{kres[name]['plain_ms']:.4f} ms; device split "
                      f"{_split_text(_device_split(torch, kern))}",
                      flush=True)
                per, ins, outs, peak = work[name]
                _bound(kres[name], per * pairs * hd,
                       _nbytes(*ins) + _nbytes(*outs), peak)
                if peak != PEAK_F32:
                    print(f"    (at the fp32 FMA peak the operations would "
                          f"take {per * pairs * hd / PEAK_F32 * 1e3:.4f} ms)",
                          flush=True)

            def two_kernel():
                return (calls["flash_sparse_bwd_dq"][0](),
                        calls["flash_sparse_bwd_dkv"][0]())

            print(f"  backward routes at the driver shape ({tag}): "
                  f"single-pass {kres['flash_sparse_bwd_fused']['ms']:.4f} "
                  f"ms, two-kernel {_graph_ms(two_kernel):.4f} ms (graph)",
                  flush=True)

    # the routes at a longer sequence (the crossover question), and the deep
    # walk (64 slots) against float64
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
    _f64_rows_compare(f"bwd_fused {tag}", fs, rows, rkw, fused)
    if not torch.equal(dq, fs.flash_sparse_bwd_dq(*rows, **rkw)):
        _fail(f"flash backward {tag}: dq differs between two calls")

    def one_pass():
        return fs.flash_sparse_bwd_fused(*rows, **rkw)

    def two_pass():
        return (fs.flash_sparse_bwd_dq(*rows, **rkw),
                fs.flash_sparse_bwd_dkv(*cols, **ckw))

    one, two = _graph_ms(one_pass, reps=5), _graph_ms(two_pass, reps=5)
    print(f"  backward routes at {tag} (causal): single-pass {one:.4f} ms, "
          f"two-kernel {two:.4f} ms (graph; eager "
          f"{_time_ms(one_pass, reps=5):.4f} / "
          f"{_time_ms(two_pass, reps=5):.4f})", flush=True)


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
              "flash_sparse_attention_fwd", "panel_softmax"):
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
                                      "bsr_sddmm_panel": None,
                                      "panel_softmax": 1,
                                      "panel_softmax_bwd": 1},
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


def _decode_library_ms(torch, timed, R, s_max, hd):
    """One ``F.scaled_dot_product_attention`` call over a contiguous bf16
    cache (its keys masked to ``kv_len``), cold like the kernel: four
    caches in turn. A paged pool has no such call."""
    import torch.nn.functional as F

    calls = []
    for (_, _, kv_len, q, k, v, _, _), _, _, _ in timed:
        keys = torch.arange(s_max, device=q.device)
        mask = (keys[None] < kv_len[:, None])[:, None, None]
        calls.append((q.to(k.dtype)[:, None], k[:, None], v[:, None], mask))
    turn = itertools.count()

    def call():
        q4, k4, v4, m4 = calls[next(turn) % len(calls)]
        return F.scaled_dot_product_attention(q4, k4, v4, attn_mask=m4,
                                              scale=hd ** -0.5)

    return _library_ms("decode attention (F.scaled_dot_product_attention "
                       "over the cache, cold, graph replay)", call,
                       timer=_graph_ms)


def _decode_bound(r, *, tables, q, k, n_keys, group):
    """B19 / B20a: the attended K/V rows (``n_keys``: keys below ``kv_len``
    in valid slots, summed over KV replicas, each read once) with their two
    scales, the tables, ``q`` and the output (``q``'s size); two products
    of ``qlen x hd`` per attended key and query replica."""
    _, qlen, hd = q.shape
    per_key = 2 * hd * k.element_size() + 2 * 4
    _bound(r, 4.0 * qlen * hd * n_keys * group,
           n_keys * per_key + _nbytes(*tables) + 2 * _nbytes(q))


def _split_kv_note(name, R, S, bk, lens):
    """Prints B19 / B20a's split at the timed shape (bf16, every slot
    valid): keys a chunk, chunks a replica and those holding keys, and the
    CTAs of each launch; fails unless there are more CTAs than replicas."""
    from sputnik_tpu_torch.ops.kernels.decode_attention import split_keys

    keys = split_keys(R, S, bk, False)
    per = S * -(-bk // keys)
    live = sum(-(-min(n, S * bk) // keys) for n in lens)
    print(f"  {name} split: {keys} keys a chunk, {per} chunks a replica, "
          f"{R * per} CTAs in pass 1 ({live} holding keys; unsplit {R}), "
          f"merge {R} CTAs; 2 device launches a call (int8: a whole "
          f"{bk}-key slot a chunk, {R * S} CTAs, 3 launches)", flush=True)
    if not R * per > R:
        _fail(f"{name}: the split launches no more CTAs than replicas")


def _wide_head_decode(torch, dev, kres):
    """B19 and B20a at head dims 192 and 256 (two 128-wide groups a lane)
    against their plain versions: f32, bf16 and int8 caches, qlen 1 and 4,
    GQA group 1 and 2, a skipped slot, an empty KV replica (exactly 0), the
    same bits twice; the paged pool holds the same blocks page by page."""
    from sputnik_tpu_torch.ops.kernels.decode_attention import (
        decode_attention_kernel, decode_attention_plain)
    from sputnik_tpu_torch.ops.kernels.paged_attention import (
        paged_attention_kernel, paged_attention_plain)

    rng = np.random.RandomState(31)
    R, S, bk = 8, 3, 256
    s_max = S * bk
    for hd, dtype, (qlen, group) in itertools.product(
            (192, 256), (torch.float32, torch.bfloat16, torch.int8),
            ((1, 1), (4, 2))):
        R_kv = R // group
        if dtype == torch.int8:
            k, v = (torch.from_numpy(rng.randint(-127, 128, (
                R_kv, s_max, hd)).astype(np.int8)).to(dev) for _ in range(2))
            ks, vs = (torch.from_numpy((0.01 + 0.05 * rng.rand(
                R_kv, s_max)).astype(np.float32)).to(dev) for _ in range(2))
        else:
            k, v = (torch.from_numpy(rng.randn(R_kv, s_max, hd).astype(
                np.float32)).to(dev).to(dtype) for _ in range(2))
            ks = vs = torch.ones(R_kv, s_max, device=dev)
        lens = torch.from_numpy(rng.randint(1, s_max + 1, R_kv).astype(
            np.int32)).to(dev)
        lens[-1] = 0                                  # an empty KV replica
        tbl = torch.from_numpy(np.stack([rng.permutation(S) for _ in range(
            R)]).astype(np.int32)).to(dev)
        valid = torch.ones_like(tbl)
        valid[0, 1] = 0                               # a skipped slot
        q = torch.from_numpy(rng.randn(R, qlen, hd).astype(
            np.float32)).to(dev)
        kw = dict(qlen=qlen, group=group, scale=hd ** -0.5)
        tag = f"hd={hd} {str(dtype)[6:]} qlen={qlen} group={group}"
        args = (tbl, valid, lens, q, k, v, ks, vs)
        got = decode_attention_kernel(*args, bk=bk, **kw)
        _compare(f"decode_attention {tag}", got,
                 decode_attention_plain(*args, bk=bk, **kw), TOL_KERNEL,
                 kres["decode_attention"])
        # the pool: KV replica rk's block b is page rk * S + b
        phys = ((torch.arange(R, device=dev) // group)[:, None] * S
                + tbl).int().contiguous()
        pargs = (phys, tbl, valid, lens, q, k.reshape(-1, bk, hd),
                 v.reshape(-1, bk, hd), ks.reshape(-1, bk),
                 vs.reshape(-1, bk))
        pgot = paged_attention_kernel(*pargs, **kw)
        _compare(f"paged_attention {tag}", pgot,
                 paged_attention_plain(*pargs, **kw), TOL_KERNEL,
                 kres["paged_attention"])
        for name, a, call in (("decode_attention", got, lambda: (
                decode_attention_kernel(*args, bk=bk, **kw))),
                ("paged_attention", pgot,
                 lambda: paged_attention_kernel(*pargs, **kw))):
            if not torch.all(a[R - group:] == 0):
                _fail(f"{name} {tag}: the empty replica is not exactly 0")
            if not torch.equal(a, call()):
                _fail(f"{name} {tag}: two runs differ")
    print("  decode / paged attention at hd 192 and 256: every case within "
          "1e-4 x max|plain|, the same bits twice", flush=True)


def phase_serving_kernels(stt, torch, dev, kres):
    """B19 and B21 against their plain versions at the serving shapes, and
    their times."""
    from sputnik_tpu_torch.ops import decode as D
    from sputnik_tpu_torch.ops.kernels.decode_attention import (
        decode_attention_kernel, decode_attention_plain)
    from sputnik_tpu_torch.ops.kernels.ragged_append import (
        ragged_append_fused_plain, ragged_append_kernel)

    print("phase 2c: serving kernels vs plain PyTorch at the serving shapes",
          flush=True)
    rng = np.random.RandomState(30)
    R, hd, bk, s_max = 32, 128, 1024, 2048
    r = kres["decode_attention"]
    # group 1: the MHA serving runs (kv_len 1088 everywhere); group 4: run
    # (f)'s GQA shape (8 KV replicas, one per 4 query replicas), lengths
    # differing per KV replica, tables expanded as ops.decode does
    gqa_lens = [1088, 1000, 900, 1025, 700, 1024, 513, 0]
    for dtype, qlen, group in itertools.product(
            (torch.bfloat16, torch.float32, torch.int8), (1, 4), (1, 4)):
        R_kv = R // group
        kv = torch.from_numpy(rng.randn(2, R_kv, s_max, hd).astype(
            np.float32)).to(dev)
        if group == 1:
            lens = torch.full((R,), 1088, dtype=torch.int32, device=dev)
            lens[R - 1] = 0                       # an empty replica
        else:
            lens = torch.tensor(gqa_lens, dtype=torch.int32, device=dev)
        cache = D.prefill_kv(D.init_kv_cache(R_kv, s_max, hd, dtype,
                                             device=dev),
                             kv[0], kv[1], lens)
        tbl, valid = D.decode_block_table(cache.kv_len, s_max=s_max, bk=bk,
                                          window_blocks=2, sink_blocks=0)
        tbl, valid = (t.repeat_interleave(group, 0).contiguous()
                      for t in (tbl, valid))
        q = torch.from_numpy(rng.randn(R, qlen, hd).astype(
            np.float32)).to(dev)
        args = (tbl, valid, cache.kv_len, q, cache.k, cache.v,
                cache.k_scale, cache.v_scale)
        kw = dict(bk=bk, qlen=qlen, group=group, scale=hd ** -0.5)
        got = decode_attention_kernel(*args, **kw)
        _compare(f"decode_attention R={R} R_kv={R_kv} group={group} S=2 "
                 f"bk={bk} hd={hd} {str(dtype)[6:]} qlen={qlen}", got,
                 decode_attention_plain(*args, **kw), TOL_KERNEL, r)
        if not torch.all(got[R - group:] == 0):
            _fail("decode_attention: the empty replica is not exactly 0")
        if not torch.equal(got, decode_attention_kernel(*args, **kw)):
            _fail("decode_attention: two runs differ")
        if dtype == torch.bfloat16 and qlen == 1 and group == 1:
            timed = [(args, kw, int(valid.sum()), int(lens.sum()))]
    # Times at the serving shape (bf16, kv_len 1088): L2-warm, the same
    # cache every call (its 16.5 MiB of attended K/V stay in the 50 MB L2),
    # and cold, four caches in turn (134 MB), as a decode step finds it.
    (args, kw, n_valid, n_keys), = timed
    _split_kv_note("decode_attention", R, args[0].shape[1], bk,
                   args[2].tolist())
    for _ in range(3):
        kv = torch.from_numpy(rng.randn(2, R, s_max, hd).astype(
            np.float32)).to(dev)
        c = D.prefill_kv(D.init_kv_cache(R, s_max, hd, torch.bfloat16,
                                         device=dev), kv[0], kv[1], args[2])
        timed.append(((args[0], args[1], c.kv_len, args[3], c.k, c.v,
                       c.k_scale, c.v_scale), kw, n_valid, n_keys))
    turn = itertools.count()

    def cold(fn):
        return lambda: fn(*timed[next(turn) % 4][0], **kw)

    # device times by CUDA graph replay (the eager calls measure the
    # wrapper's host time at these sizes)
    eager_ms = _time_ms(cold(decode_attention_kernel))
    warm_ms = _graph_ms(lambda: decode_attention_kernel(*args, **kw))
    r["ms"] = _graph_ms(cold(decode_attention_kernel))
    r["plain_ms"] = _time_ms(cold(decode_attention_plain))
    warm_plain = _time_ms(lambda: decode_attention_plain(*args, **kw))
    print(f"  decode_attention cold L2, eager calls: {eager_ms:.4f} ms a "
          f"call", flush=True)
    r["library_ms"] = _decode_library_ms(torch, timed, R, s_max, hd)
    _decode_bound(r, tables=args[:3], q=args[3], k=args[4], n_keys=n_keys,
                  group=1)
    tabled = n_valid * bk * hd * 2 * 2
    attended = n_keys * hd * 2 * 2
    for tag, ms, plain in (("cold L2", r["ms"], r["plain_ms"]),
                           ("warm L2", warm_ms, warm_plain)):
        print(f"  decode_attention R={R} S=2 bk={bk} hd={hd} bf16 kv_len "
              f"1088, {tag}: kernel {ms:.4f} ms, plain {plain:.4f} ms; "
              f"tabled KV {tabled / 2**20:.1f} MiB -> "
              f"{tabled / ms / 1e6:.1f} GB/s, attended KV "
              f"{attended / 2**20:.1f} MiB -> {attended / ms / 1e6:.1f} GB/s "
              f"(of 3350 GB/s)", flush=True)
    del kv, cache, timed
    _wide_head_decode(torch, dev, kres)

    # B21 on every contiguous route at the serving shape: replicas at 1088
    # (the uniform step's shared position), one a row short of s_max and
    # one full (the ragged step's capacity guard)
    lens = [1088] * (R - 2) + [s_max - 1, s_max]

    def make(dtype):
        k, v = (torch.from_numpy(rng.randn(R, s_max, hd).astype(
            np.float32) * 40).to(dtype).to(dev) for _ in range(2))
        kv_len = torch.tensor(lens, dtype=torch.int32, device=dev)
        return ([k, v] + [torch.rand(R, s_max, device=dev)
                          for _ in range(2)], (kv_len,), kv_len)

    def at(p):
        return torch.tensor(p, dtype=torch.int32, device=dev)

    kv_len = at(lens)            # the uniform routes' shared position: [0]
    active = torch.from_numpy((rng.rand(R) < 0.8).astype(np.int32)).to(dev)
    _kv_append_routes(
        torch, dev, kres["ragged_append"], "ragged_append",
        ragged_append_kernel, ragged_append_fused_plain, make,
        {"uniform step": (1, dict(pos=kv_len[0])),
         "uniform at s_max": (1, dict(pos=at(s_max))),
         "ragged step": (1, dict(active=active)),
         "ragged step, no active": (1, {}),
         "draft q=4": (4, dict(pos=kv_len[0], seq=True)),
         "draft q=8 past s_max": (8, dict(pos=at(s_max - 7), seq=True))},
        b=4, heads=8, hd=hd, rows_written=R)


def _host_ms(fn, n: int = 200, warmup: int = 20) -> float:
    """Milliseconds per eager ``fn()`` call on the host's clock: ``n``
    back-to-back calls ended by one synchronize, so a call that takes less
    device time than its host work counts its host time (the
    host-inclusive time per call)."""
    import torch

    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(n):
        fn()
    torch.cuda.synchronize()
    return (time.perf_counter() - t0) * 1e3 / n


def _append_tokens(torch, dev, rng, b, heads, q, hd):
    """fp32 K / V tokens as the decoders hand them to the append: the split
    views of a ``[b, q, heads, 3 * hd]`` projection, folded (``[R, hd]``
    strided views for one token)."""
    x = torch.from_numpy(rng.randn(b, q, heads, 3 * hd).astype(
        np.float32)).to(dev)
    out = [p.transpose(1, 2).reshape(b * heads, q, hd)
           for p in (x[..., hd:2 * hd], x[..., 2 * hd:])]
    return [t[:, 0] for t in out] if q == 1 else out


def _kv_append_routes(torch, dev, r, name, kernel, plain, make, routes, b,
                      heads, hd, rows_written=None):
    """The fused KV append (B21 or B20b) against its plain version, bit for
    bit (cache bytes, scales and the new lengths), on every route and cache
    dtype; then, at the serving shape with a bf16 cache, its device time by
    CUDA graph replay (``ms``), its host-inclusive time per eager call, and
    the plain version's (the composite of PyTorch ops the decode step ran
    before: cast or quantise, guarded indexed writes, length arithmetic).
    ``make(dtype)`` -> ``(buffers, args after them, kv_len)``; ``routes``:
    label -> ``(q, kwargs)``, the first one timed and bounded;
    ``rows_written`` by it (default: what its lengths advanced by)."""
    rng = np.random.RandomState(32)
    R = b * heads
    for dtype in (torch.bfloat16, torch.float32, torch.int8):
        bufs, extra, _ = make(dtype)
        for label, (q, kw) in routes.items():
            toks = _append_tokens(torch, dev, rng, b, heads, q, hd)
            want = [t.clone() for t in bufs]
            got = [t.clone() for t in bufs]
            ref_len = plain(*toks, *want, *extra, **kw)
            new_len = kernel(*toks, *got, *extra, **kw)
            torch.cuda.synchronize()
            for g, w in zip(got + [new_len], want + [ref_len]):
                if not torch.equal(g.view(torch.uint8), w.view(torch.uint8)):
                    _fail(f"{name} {label} {dtype}: not bit-identical to "
                          f"plain")
        print(f"  {name} R={R} hd={hd} {str(dtype)[6:]} cache, fp32 token "
              f"views: bit-identical to plain (bytes, scales, new lengths) "
              f"on {len(routes)} routes: {', '.join(routes)}", flush=True)
    r["max_abs_err"] = 0.0
    for dtype in (torch.bfloat16, torch.int8):
        bufs, extra, kv_len = make(dtype)
        for i, (label, (q, kw)) in enumerate(routes.items()):
            toks = _append_tokens(torch, dev, rng, b, heads, q, hd)
            call = (lambda t=toks, kw=kw:
                    kernel(*t, *bufs, *extra, **kw))
            host = _host_ms(call)
            plain_host = _host_ms(lambda t=toks, kw=kw:
                                  plain(*t, *bufs, *extra, **kw), n=20)
            line = (f"  {name} {label} R={R} hd={hd} {str(dtype)[6:]}: "
                    f"{host:.4f} ms host-inclusive a call (eager, 200 "
                    f"calls, one sync), plain composite {plain_host:.4f}")
            if i == 0 and dtype == torch.bfloat16:
                r["ms"] = _graph_ms(call)
                r["plain_ms"] = _time_ms(lambda: plain(*toks, *bufs, *extra,
                                                       **kw))
                # no one PyTorch call casts, writes under a guard and
                # returns the lengths
                r["library_ms"] = None
                n_rows = (int((call() - kv_len).sum()) if rows_written is None
                          else rows_written)
                nbytes = (_nbytes(*toks, kv_len) + R * 4
                          + n_rows * 2 * (hd * bufs[0].element_size() + 4)
                          + _nbytes(*[t for t in extra if t is not kv_len]))
                line += (f"; device {r['ms']:.5f} ms by graph replay, plain "
                         f"{r['plain_ms']:.4f} ms eager (CUDA events); "
                         f"bound {nbytes / PEAK_BYTES * 1e3:.2e} ms "
                         f"({nbytes} B: fp32 tokens read, {n_rows} rows and "
                         f"scales written, lengths, indices)")
                r["bound_ms"] = nbytes / PEAK_BYTES * 1e3
                r["bound_by"] = "bytes"
            print(line, flush=True)


def phase_paged_kernels(stt, torch, dev, kres):
    """B20a and B20b against their plain versions at the paged serving
    shapes (a shuffled pool of 96 1024-token pages, R = 32, hd = 128), and
    their times."""
    import dataclasses

    from sputnik_tpu_torch.ops import paged as PG
    from sputnik_tpu_torch.ops.kernels.paged_append import (
        paged_append_fused_plain, paged_append_kernel)
    from sputnik_tpu_torch.ops.kernels.paged_attention import (
        paged_attention_kernel, paged_attention_plain)

    print("phase 2d: paged kernels vs plain PyTorch at the paged serving "
          "shapes", flush=True)
    rng = np.random.RandomState(31)
    R, hd, bk, mb, n_pages = 32, 128, 1024, 2, 96
    gqa_lens = [1088, 1000, 900, 1025, 700, 1024, 513, 0]

    def pool_of(dtype, R_kv, lens, seed):
        """A pool whose pages were allocated in a shuffled order, filled
        with each replica's ``mb * bk`` prompt tokens."""
        prng = np.random.RandomState(seed)
        cache, pool = PG.init_paged_cache(R_kv, n_pages, bk, hd, mb,
                                          dtype=dtype, device=dev)
        pool.free(list(prng.permutation(pool.allocate(n_pages))))
        lens = torch.tensor(lens, dtype=torch.int32, device=dev)
        cache = PG.ensure_pages(dataclasses.replace(cache, kv_len=lens),
                                pool, 0)
        for r_, n in enumerate(lens.tolist()):
            cache = PG.ensure_pages(cache, pool, mb * bk - n, replicas=[r_])
        kv = torch.from_numpy(prng.randn(2, R_kv, mb * bk, hd).astype(
            np.float32)).to(dev)
        return PG.write_prompt_pages(cache, kv[0], kv[1],
                                     replica_pages=cache.page_table.cpu(),
                                     lengths=lens)

    r = kres["paged_attention"]
    timed = None
    for dtype, qlen, group in itertools.product(
            (torch.bfloat16, torch.float32, torch.int8), (1, 4), (1, 4)):
        R_kv = R // group
        lens = [1088] * (R - 1) + [0] if group == 1 else gqa_lens
        cache = pool_of(dtype, R_kv, lens, seed=qlen + 10 * group)
        phys, logical, valid = (
            t.repeat_interleave(group, 0).contiguous()
            for t in PG.paged_block_table(cache, window_blocks=mb))
        if torch.equal(phys, logical):
            _fail("paged tables: the pages are the logical blocks")
        q = torch.from_numpy(rng.randn(R, qlen, hd).astype(
            np.float32)).to(dev)
        args = (phys, logical, valid, cache.kv_len, q, cache.k, cache.v,
                cache.k_scale, cache.v_scale)
        kw = dict(qlen=qlen, group=group, scale=hd ** -0.5)
        got = paged_attention_kernel(*args, **kw)
        _compare(f"paged_attention R={R} R_kv={R_kv} group={group} S={mb} "
                 f"bk={bk} hd={hd} {str(dtype)[6:]} qlen={qlen}", got,
                 paged_attention_plain(*args, **kw), TOL_KERNEL, r)
        if not torch.all(got[R - group:] == 0):
            _fail("paged_attention: the empty replica is not exactly 0")
        if not torch.equal(got, paged_attention_kernel(*args, **kw)):
            _fail("paged_attention: two runs differ")
        if dtype == torch.bfloat16 and qlen == 1 and group == 1:
            timed = [args]
            n_keys = sum(lens)
    # cold L2, as a decode step finds it: four pools (4 x 51 MB) in turn
    for seed in range(3):
        c = pool_of(torch.bfloat16, R, [1088] * (R - 1) + [0], seed=50 + seed)
        timed.append(timed[0][:3] + (c.kv_len, timed[0][4], c.k, c.v,
                                     c.k_scale, c.v_scale))
    kw = dict(qlen=1, group=1, scale=hd ** -0.5)
    _split_kv_note("paged_attention", R, mb, bk, timed[0][3].tolist())
    turn = itertools.count()

    def cold(fn):
        return lambda: fn(*timed[next(turn) % 4], **kw)

    eager_ms = _time_ms(cold(paged_attention_kernel))
    r["ms"] = _graph_ms(cold(paged_attention_kernel))
    r["plain_ms"] = _time_ms(cold(paged_attention_plain))
    warm_ms = _graph_ms(lambda: paged_attention_kernel(*timed[0], **kw))
    print(f"  paged_attention R={R} S={mb} bk={bk} hd={hd} bf16 kv_len "
          f"1088: kernel {r['ms']:.4f} ms cold L2 ({warm_ms:.4f} warm; "
          f"graph replay; eager calls {eager_ms:.4f} ms a call), plain "
          f"{r['plain_ms']:.4f} ms", flush=True)
    # no PyTorch call reads K/V through a page table
    r["library_ms"] = None
    _decode_bound(r, tables=timed[0][:4], q=timed[0][4], k=timed[0][5],
                  n_keys=n_keys, group=1)
    del timed, cache

    # B20b on every paged route: each replica's two blocks on shuffled
    # pages, except the last (no page for block 1); one replica at the
    # table's capacity, one a token short of block 1 (drafts cross into it)
    P = n_pages + 1
    plens = [1088] * (R - 3) + [mb * bk, bk - 1, bk]
    table = np.random.RandomState(33).permutation(n_pages)[:R * mb].reshape(
        R, mb).astype(np.int32)
    table[R - 1, 1] = -1

    def make(dtype):
        k, v = (torch.from_numpy(rng.randn(P, bk, hd).astype(
            np.float32) * 40).to(dtype).to(dev) for _ in range(2))
        kv_len = torch.tensor(plens, dtype=torch.int32, device=dev)
        return ([k, v] + [torch.rand(P, bk, device=dev) for _ in range(2)],
                (torch.from_numpy(table).to(dev), kv_len), kv_len)

    active = torch.from_numpy((rng.rand(R) < 0.8).astype(np.int32)).to(dev)
    _kv_append_routes(
        torch, dev, kres["paged_append"], "paged_append",
        paged_append_kernel, paged_append_fused_plain, make,
        {"step": (1, {}), "ragged step": (1, dict(active=active)),
         "draft q=4": (4, {}), "draft q=8": (8, dict(active=active))},
        b=4, heads=8, hd=hd)


def _counted(wrappers, total, label, fn, expect):
    """``fn()`` with every launch counter at 0 just before; the counts read
    just after are added to ``total`` and must equal ``expect`` (kernel ->
    launches)."""
    import torch

    torch.cuda.synchronize()
    for w in wrappers.values():
        w.launches = 0
    out = fn()
    torch.cuda.synchronize()
    got = {n: w.launches for n, w in wrappers.items()}
    for n, c in got.items():
        total[n] += c
    for n, want in expect.items():
        if got[n] != want:
            _fail(f"{label}: {got[n]} launches of {n}, expected {want}")
    print(f"  {label}: launches {dict((n, c) for n, c in got.items() if c)}",
          flush=True)
    return out


# the launches a wrapper counts in one generate or decode_loop call with two
# or more decode steps: the eager warm-up step's and the capture's
GRAPH_COUNTED = 2


def _graph_kernels(torch, label, fn, want, addr, pos):
    """``fn()`` (a generate) under torch.profiler: the device kernels of
    decode attention on the ``addr`` route (B19: ``ContigAddr``, B20a:
    ``PagedAddr``; its chunk pass, once a call) and of the KV append at
    ``pos`` must each run ``want`` times (layers x decode steps), replays
    included, where the wrappers count only the warm-up and the capture.
    A kernel bypassed on the replays fails it. Returns ``fn()``."""
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        out = fn()
        torch.cuda.synchronize()
    attn = append = 0
    for e in prof.key_averages():
        if not str(getattr(e, "device_type", "")).endswith("CUDA"):
            continue
        if ("decode_chunk" in e.key and addr in e.key
                and "_int8<true" not in e.key):
            attn += e.count
        elif "kv_append_kernel" in e.key and pos in e.key:
            append += e.count
    print(f"  {label}: device kernels decode attention ({addr}) {attn}, "
          f"KV append ({pos}) {append}; expected {want} each", flush=True)
    if attn != want or append != want:
        _fail(f"{label}: decode attention ran {attn} and the KV append "
              f"{append} times on the device, expected {want} each")
    return out


def _teacher_forced_logits(server, prompt, tokens):
    """The head's logits at the prompt's last position, then after each of
    ``tokens[:, :-1]`` fed through ``decode_step``: ``[n, b, vocab]``. A
    paged server reserves every page first, as ``generate`` does."""
    import torch

    with torch.no_grad():
        caches = server.init_caches(prompt.shape[0])
        if hasattr(server.decoder, "reserve"):
            caches = server.decoder.reserve(
                caches, prompt.shape[1] + tokens.shape[1])
        y, caches = server.decoder.prefill(server.lm.embed(prompt), caches)
        out = [server.lm.head(y[:, -1])]
        for t in range(tokens.shape[1] - 1):
            logits, caches = server.decode_step(tokens[:, t], caches)
            out.append(logits)
    return torch.stack(out)


def phase_serving(stt, torch, dev, wrappers):
    """The serving path at benchmarks/serving.py's full width, launches
    counted; held against the CPU by teacher forcing."""
    from sputnik_tpu_torch.models import LMServer, SparseLM
    from sputnik_tpu_torch.patterns import causal_mask

    b, P, h, heads, layers, ffn, V, n_new, bk = (4, 1024, 1024, 8, 6, 4096,
                                                 32000, 64, 1024)
    print(f"phase 3c: serving path — SparseLM {layers}L b={b} P={P} h={h} "
          f"heads={heads} ffn={ffn} V={V}, LMServer(s_max=P+64, bk={bk}), "
          f"{n_new} new tokens", flush=True)
    masks = np.broadcast_to(causal_mask(P), (b, P, P)).copy()
    t0 = time.perf_counter()
    cpu_lm = SparseLM.from_masks(
        masks, vocab_size=V, num_layers=layers, hidden_size=h,
        num_heads=heads, ffn_hidden_size=ffn, use_residual=True,
        use_layernorm=True, activation="gelu",
        generator=torch.Generator().manual_seed(20)).eval()
    lm = copy.deepcopy(cpu_lm).to(dev)
    cpu_gqa = SparseLM.from_masks(
        masks, vocab_size=V, num_layers=2, hidden_size=h, num_heads=heads,
        num_kv_heads=2, ffn_hidden_size=ffn, use_residual=True,
        use_layernorm=True, activation="gelu",
        generator=torch.Generator().manual_seed(22)).eval()
    gqa_lm = copy.deepcopy(cpu_gqa).to(dev)
    prompt = torch.from_numpy(np.random.RandomState(21).randint(
        0, V, (b, P)))
    pd = prompt.to(dev)
    lens = [1024, 900, 700, 512]
    print(f"  models built in {time.perf_counter() - t0:.1f} s", flush=True)

    def server(model=lm, dtype=torch.bfloat16):
        return LMServer(model, s_max=P + 64, bk=bk, cache_dtype=dtype)

    srv = server()
    srv.generate(pd, 2)                     # builds metadata, warms up
    torch.cuda.synchronize()
    total = {n: 0 for n in wrappers}

    def run(label, fn, expect):
        return _counted(wrappers, total, f"serving {label}", fn,
                        dict(expect, paged_attention=0, paged_append=0))

    def check_tokens(label, toks, n):
        if toks.shape != (b, n) or not ((toks >= 0) & (toks < V)).all():
            _fail(f"serving {label}: tokens {tuple(toks.shape)} out of range")

    steps = n_new - 1
    # generate replays one captured graph a decode token: the wrappers
    # count the eager warm-up step and the capture (GRAPH_COUNTED a layer),
    # the profiler every replayed kernel (_graph_kernels)
    captured = {"flash_sparse_attention_fwd": layers,
                "decode_attention": layers * GRAPH_COUNTED,
                "ragged_append": layers * GRAPH_COUNTED}
    torch.cuda.reset_peak_memory_stats(dev)
    t0 = time.perf_counter()
    toks_a, caches_a = run("(a) greedy generate, bf16 cache",
                           lambda: srv.generate(pd, n_new), captured)
    gen_s = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated(dev)
    check_tokens("(a)", toks_a, n_new)
    if caches_a[0].kv_len.tolist() != [P + steps] * (b * heads):
        _fail(f"serving (a): kv_len {caches_a[0].kv_len.tolist()[:4]}...")
    again = _graph_kernels(torch, "serving (a) greedy generate",
                           lambda: srv.generate(pd, n_new)[0], layers * steps,
                           "ContigAddr", "UniformPos")
    if not torch.equal(again, toks_a):
        _fail("serving (a): a second greedy generate gave other tokens")

    gen = torch.Generator(device=dev)
    toks_b = run("(b) sampled generate T=0.8 top_k=40",
                 lambda: srv.generate(pd, n_new, gen.manual_seed(5),
                                      temperature=0.8, top_k=40)[0],
                 captured)
    check_tokens("(b)", toks_b, n_new)
    again = srv.generate(pd, n_new, gen.manual_seed(5), temperature=0.8,
                         top_k=40)[0]
    if not torch.equal(toks_b, again):
        _fail("serving (b): the same generator seed gave other tokens")

    toks_c, caches_c = run(
        f"(c) generate, prompt_lengths={lens}",
        lambda: _graph_kernels(
            torch, "serving (c) generate, prompt_lengths",
            lambda: srv.generate(pd, n_new, prompt_lengths=lens),
            layers * steps, "ContigAddr", "RaggedPos"), captured)
    check_tokens("(c)", toks_c, n_new)
    want_len = [n + steps for n in lens for _ in range(heads)]
    if caches_c[0].kv_len.tolist() != want_len:
        _fail(f"serving (c): kv_len {caches_c[0].kv_len.tolist()}")

    def speculative():
        dec_ = srv.decoder
        caches = srv.init_caches(b)
        y, caches = dec_.prefill(srv.lm.embed(pd), caches)
        draft = toks_a[:, :4]
        seq = tuple(c.clone() for c in caches)
        y_multi, caches = dec_.decode_multi(srv.lm.embed(draft), caches)
        if caches[0].kv_len.tolist() != [P + 4] * (b * heads):
            _fail("serving (d): decode_multi did not advance kv_len by 4")
        caches = dec_.rollback(caches, 3)
        y_next, caches = dec_.decode_step(
            srv.lm.embed(toks_a[:, 1])[:, None], caches)
        ys = []
        for i in range(4):
            y1, seq = dec_.decode_step(srv.lm.embed(draft[:, i])[:, None],
                                       seq)
            ys.append(y1)
        return y_multi, torch.cat(ys, 1), y_next, caches

    y_multi, y_seq, y_next, caches_d = run(
        "(d) decode_multi q=4, rollback 3, decode_step (+ 4 sequential steps)",
        speculative, {"flash_sparse_attention_fwd": layers,
                      "decode_attention": layers * 6,
                      "ragged_append": layers * 6})
    _compare("(d) decode_multi vs 4 sequential decode_steps", y_multi, y_seq,
             TOL_MODEL)
    _compare("(d) decode_step after rollback vs sequential step 2",
             y_next[:, 0], y_seq[:, 1], TOL_MODEL)
    if caches_d[0].kv_len.tolist() != [P + 2] * (b * heads):
        _fail("serving (d): kv_len after rollback + step")

    srv8 = server(dtype=torch.int8)
    toks_e = run("(e) greedy generate, int8 cache",
                 lambda: _graph_kernels(
                     torch, "serving (e) greedy generate, int8 cache",
                     lambda: srv8.generate(pd, n_new)[0], layers * steps,
                     "ContigAddr", "UniformPos"), captured)
    check_tokens("(e)", toks_e, n_new)
    gqa = server(gqa_lm)
    toks_f = run("(f) greedy generate, GQA kv_heads=2, 2 layers",
                 lambda: _graph_kernels(
                     torch, "serving (f) greedy generate, GQA",
                     lambda: gqa.generate(pd, 16)[0], 2 * 15, "ContigAddr",
                     "UniformPos"),
                 {"flash_sparse_attention_fwd": 2,
                  "decode_attention": 2 * GRAPH_COUNTED,
                  "ragged_append": 2 * GRAPH_COUNTED})
    if toks_f.shape != (b, 16):
        _fail("serving (f): token shape")
    agree = {k: float((t == toks_a).float().mean()) for k, t in
             (("int8 cache", toks_e), ("bf16 sampled", toks_b))}
    print(f"  share of greedy bf16 tokens matched: {agree}", flush=True)

    print("  one decode_step under torch.cuda.set_sync_debug_mode('error')",
          flush=True)
    caches = srv.init_caches(b)
    with torch.no_grad():
        _, caches = srv.decoder.prefill(srv.lm.embed(pd), caches)
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        _, caches = srv.decode_step(toks_a[:, 0], caches)
    finally:
        torch.cuda.set_sync_debug_mode(0)

    print("phase 4c: serving vs the CPU plain path (fp32 cache, teacher "
          "forcing the card's greedy tokens); serving times", flush=True)
    def hold(label, model, cpu_model, n):
        """Greedy generate with an fp32 cache on the card, then the same
        tokens teacher-forced through the card and through the CPU copy."""
        srv32 = server(model, torch.float32)
        toks32, _ = srv32.generate(pd, n)
        gpu_logits = _teacher_forced_logits(srv32, pd, toks32).cpu()
        if not torch.equal(gpu_logits.argmax(-1).T, toks32.cpu()):
            _fail(f"serving {label}: teacher-forced argmax differs from "
                  f"generate's tokens")
        t0 = time.perf_counter()
        cpu_srv = LMServer(cpu_model, s_max=P + 64, bk=bk,
                           cache_dtype=torch.float32)
        cpu_logits = _teacher_forced_logits(cpu_srv, prompt, toks32.cpu())
        print(f"  {label} CPU reference: prefill + {n - 1} steps in "
              f"{time.perf_counter() - t0:.1f} s", flush=True)
        _compare(f"{label} fp32-cache logits, {n} positions x {b} sequences",
                 gpu_logits, cpu_logits, TOL_MODEL)
        bound = TOL_MODEL * max(1.0, cpu_logits.abs().max().item())
        top2 = cpu_logits.topk(2, dim=-1).values
        gap = top2[..., 0] - top2[..., 1]
        miss = (cpu_logits.argmax(-1).T != toks32.cpu()) & (gap.T >= bound)
        if miss.any():
            _fail(f"serving {label}: {int(miss.sum())} greedy card tokens "
                  f"are not the CPU argmax with a top-2 gap >= {bound:.3e}")
        print(f"  {label} greedy card tokens: all {b * n} are the CPU argmax "
              f"(or within a top-2 gap < {bound:.3e}: "
              f"{int((gap < bound).sum())} positions)", flush=True)
        return toks32, gpu_logits

    mha32 = hold("MHA", lm, cpu_lm, n_new)
    hold("(f) GQA kv_heads=2", gqa_lm, cpu_gqa, 16)

    caches = srv.init_caches(b)

    def prefill():
        with torch.no_grad():
            y, _ = srv.decoder.prefill(srv.lm.embed(pd), caches)
            return srv.lm.head(y[:, -1])

    prefill_ms = _time_ms(prefill, reps=5, inner=1, warmup=1)
    _, caches = srv.decoder.prefill(srv.lm.embed(pd), caches)
    tok = toks_a[:, 0]
    for _ in range(3):
        srv.decode_step(tok, tuple(c.clone() for c in caches))
    torch.cuda.synchronize()
    times = []
    for i in range(32):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        _, caches = srv.decode_step(toks_a[:, i], caches)
        end.record()
        times.append((start, end))
    torch.cuda.synchronize()
    step_ms = sorted(s.elapsed_time(e) for s, e in times)
    med = statistics.median(step_ms)
    print(f"  prefill (b={b}, P={P}, head on the last position) "
          f"{prefill_ms:.4f} ms (median of 5); decode_step bf16 cache "
          f"{med:.4f} ms/token (median of 32 steps, min {step_ms[0]:.4f}, "
          f"max {step_ms[-1]:.4f}) -> {b / med * 1e3:.1f} tokens/s; "
          f"generate({n_new}) {gen_s:.3f} s wall incl. prefill; peak "
          f"device memory of (a) {peak / 2**20:.1f} MiB", flush=True)
    shared = dict(lm=lm, cpu_lm=cpu_lm, pd=pd, prompt=prompt, toks_a=toks_a,
                  mha32=mha32, decode_ms=med)
    return total, shared


def phase_paged_serving(stt, torch, dev, wrappers, ctx):
    """The paged serving path at the same full width, launches counted:
    greedy tokens equal to the contiguous server's, the serve_paged flow
    (prefix stored once, a partial-page share, ragged decode with freezes,
    the pool drained) on 1024-token pages and as the example at its own
    config; then an fp32 pool held against the CPU and the contiguous
    server."""
    from sputnik_tpu_torch.examples import serve_paged
    from sputnik_tpu_torch.models import LMServer

    lm, pd, toks_a = ctx["lm"], ctx["pd"], ctx["toks_a"]
    b, P, heads, layers, n_new, bk, n_pages = 4, 1024, 8, 6, 64, 1024, 96
    hd = lm.core.hidden_size // heads
    steps = n_new - 1
    print(f"phase 3d: paged serving path — the same SparseLM, "
          f"LMServer(s_max=P+64, bk={bk}, n_pages={n_pages}), bf16 pool "
          f"({2 * (n_pages + 1) * bk * hd * 2 / 1e6:.1f} MB a layer)",
          flush=True)
    total = {n: 0 for n in wrappers}
    none = {"decode_attention": 0, "ragged_append": 0}

    def server(dtype=torch.bfloat16, model=lm):
        return LMServer(model, s_max=P + 64, bk=bk, n_pages=n_pages,
                        cache_dtype=dtype)

    psrv = server()
    psrv.generate(pd, 2)                            # warms up
    t0 = time.perf_counter()
    toks, caches = _counted(
        wrappers, total, "paged (a) greedy generate, bf16 pool",
        lambda: psrv.generate(pd, n_new),
        dict(none, flash_sparse_attention_fwd=layers,
             paged_attention=layers * GRAPH_COUNTED,
             paged_append=layers * GRAPH_COUNTED))
    gen_s = time.perf_counter() - t0
    again = _graph_kernels(torch, "paged (a) greedy generate",
                           lambda: psrv.generate(pd, n_new)[0],
                           layers * steps, "PagedAddr", "PagedPos")
    if not torch.equal(again, toks):
        _fail("paged (a): a second greedy generate gave other tokens")
    same = int((toks == toks_a).sum())
    print(f"  paged greedy tokens equal to the contiguous server's: "
          f"{same}/{toks.numel()}; generate({n_new}) {gen_s:.3f} s wall",
          flush=True)
    if not torch.equal(toks, toks_a):
        _fail("paged (a): greedy tokens differ from the contiguous server's")
    if caches[0].kv_len.tolist() != [P + steps] * (b * heads):
        _fail(f"paged (a): kv_len {caches[0].kv_len.tolist()[:4]}...")
    held = -(-(P + n_new) // bk) * b * heads     # generate's one reserve
    if psrv.decoder.free_pages != [n_pages - held] * layers:
        _fail(f"paged (a): free pages {psrv.decoder.free_pages}")

    budgets = [4, 3, 2, 1]
    part = 1000                     # not a multiple of bk: a copied tail

    def prefix_flow():
        """The system prompt prefilled once (slot 0), shared whole into
        slots 1 and 2 and its first 1000 tokens into slot 3 (a partial
        page: copied); ragged decode with freezes; every slot released."""
        dec = psrv.decoder
        caches = dec.init_caches(b)
        x = psrv.lm.embed(pd[:1].expand(b, -1))
        _, caches = dec.prefill(x, caches, lengths=torch.tensor(
            [P, 0, 0, 0], device=dev))
        for dst, n in ((1, P), (2, P), (3, part)):
            caches = dec.release(caches, dst)
            caches = dec.share_prefix(caches, 0, dst, n)
        live = n_pages - dec.free_pages[0]
        tbl = caches[0].page_table.cpu()
        prefix = P // bk * heads
        print(f"  prefix of {P} tokens shared into slots 1, 2 and its first "
              f"{part} into slot 3: {live} pages live a layer ({prefix} "
              f"prefix + {heads} copied tails; {b * prefix} unshared)",
              flush=True)
        if live != prefix + heads or not torch.equal(
                tbl[heads:3 * heads, 0], tbl[:heads, 0].repeat(2)):
            _fail(f"paged (c): the prefix is not stored once ({live} pages)")
        for c in caches:
            for h in range(heads):
                src = tbl[h, part // bk]
                dst = tbl[3 * heads + h, part // bk]
                if src == dst or not all(torch.equal(t[dst], t[src]) for t in
                                         (c.k, c.v, c.k_scale, c.v_scale)):
                    _fail("paged (c): the partial page was not copied")
        ys = []
        for t in range(max(budgets)):
            act = torch.tensor([n > t for n in budgets], device=dev)
            caches = dec.reserve(caches, 1)
            logits, caches = psrv.decode_step_ragged(
                toks_a[:1, t].expand(b), caches, act)
            ys.append(logits)
        want = [n + k for n, k in zip((P, P, P, part), budgets)]
        got = caches[0].kv_len.tolist()[::heads]
        if got != want:
            _fail(f"paged (c): kv_len by slot {got}, expected {want}")
        _compare("(c) slot 1 (shared prefix) vs slot 0, first step logits",
                 ys[0][1], ys[0][0], TOL_MODEL)
        for s_ in range(b):
            caches = dec.release(caches, s_)
        if dec.free_pages != [n_pages] * layers:
            _fail(f"paged (c): the pool did not drain: {dec.free_pages}")
        print("  every slot released: the pool drained on every layer",
              flush=True)

    _counted(wrappers, total, "paged (c) prefix flow, ragged decode",
             prefix_flow, dict(none, flash_sparse_attention_fwd=layers,
                               paged_attention=layers * max(budgets),
                               paged_append=layers * max(budgets)))
    out = _counted(
        wrappers, total, "paged (d) examples/serve_paged at its config",
        lambda: serve_paged.main([]),
        dict(none, flash_sparse_attention_fwd=6, paged_attention=6 * 32,
             paged_append=6 * 32))
    print(f"  serve_paged: {out}", flush=True)

    def speculative():
        """decode_multi q=4 from the pool (one append a layer, all four
        tokens), against four sequential decode steps on a copy."""
        dec = psrv.decoder
        caches = dec.reserve(psrv.init_caches(b), P + 4)
        _, caches = dec.prefill(psrv.lm.embed(pd), caches)
        seq = tuple(c.clone() for c in caches)
        draft = toks_a[:, :4]
        y_multi, caches = dec.decode_multi(psrv.lm.embed(draft), caches)
        if caches[0].kv_len.tolist() != [P + 4] * (b * heads):
            _fail("paged (e): decode_multi did not advance kv_len by 4")
        ys = []
        for i in range(4):
            y1, seq = dec.decode_step(psrv.lm.embed(draft[:, i])[:, None],
                                      seq)
            ys.append(y1)
        for s_ in range(b):
            caches = dec.release(caches, s_)
        return y_multi, torch.cat(ys, 1)

    y_multi, y_seq = _counted(
        wrappers, total, "paged (e) decode_multi q=4 (+ 4 sequential steps)",
        speculative, dict(none, flash_sparse_attention_fwd=layers,
                          paged_attention=layers * 5,
                          paged_append=layers * 5))
    _compare("paged (e) decode_multi vs 4 sequential decode_steps", y_multi,
             y_seq, TOL_MODEL)

    print("  one paged decode_step under torch.cuda.set_sync_debug_mode("
          "'error')", flush=True)
    caches = psrv.decoder.reserve(psrv.init_caches(b), P + 48)
    with torch.no_grad():
        _, caches = psrv.decoder.prefill(psrv.lm.embed(pd), caches)
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        _, caches = psrv.decode_step(toks_a[:, 0], caches)
    finally:
        torch.cuda.set_sync_debug_mode(0)
    del caches
    _decode_routes(torch, dev, lm, pd, toks_a, check=True)
    print(f"  phase 4c read the contiguous bf16 step at "
          f"{ctx['decode_ms']:.4f} ms/token", flush=True)

    n = 16
    print(f"phase 4d: paged fp32 pool vs the CPU and vs the contiguous "
          f"server on the card ({n} positions, teacher forcing phase 4c's "
          f"greedy tokens)", flush=True)
    toks32, flat_logits = ctx["mha32"]
    gpu = _teacher_forced_logits(server(torch.float32), pd,
                                 toks32[:, :n]).cpu()
    _compare("paged vs contiguous fp32 logits on the card", gpu,
             flat_logits[:n], TOL_KERNEL)
    print(f"  paged and contiguous fp32 logits bit-identical: "
          f"{torch.equal(gpu, flat_logits[:n])}", flush=True)
    t0 = time.perf_counter()
    cpu = _teacher_forced_logits(server(torch.float32, ctx["cpu_lm"]),
                                 ctx["prompt"], toks32[:, :n].cpu())
    print(f"  CPU reference (paged, plain versions): prefill + {n - 1} "
          f"steps in {time.perf_counter() - t0:.1f} s", flush=True)
    _compare(f"paged fp32-pool logits, {n} positions x {b} sequences, vs "
             f"the CPU", gpu, cpu, TOL_MODEL)
    return total


def phase_decode_steps(stt, torch, dev, _kres):
    """Phase 3d's decode routes alone, on phase 3c's model and prompt
    (``--only decode_steps``): public entry points only and no check of
    launch counts, so a copy of the script placed in another checkout
    times that checkout's decode the same way, for comparisons in one
    call."""
    from sputnik_tpu_torch.models import SparseLM
    from sputnik_tpu_torch.patterns import causal_mask

    b, P, h, heads, layers, ffn, V = 4, 1024, 1024, 8, 6, 4096, 32000
    print(f"phase decode_steps: SparseLM {layers}L b={b} P={P} h={h} "
          f"heads={heads} ffn={ffn} V={V}", flush=True)
    masks = np.broadcast_to(causal_mask(P), (b, P, P)).copy()
    lm = SparseLM.from_masks(
        masks, vocab_size=V, num_layers=layers, hidden_size=h,
        num_heads=heads, ffn_hidden_size=ffn, use_residual=True,
        use_layernorm=True, activation="gelu",
        generator=torch.Generator().manual_seed(20)).eval().to(dev)
    rng = np.random.RandomState(21)
    pd = torch.from_numpy(rng.randint(0, V, (b, P))).to(dev)
    toks = torch.from_numpy(rng.randint(0, V, (b, 64))).to(dev)
    _decode_routes(torch, dev, lm, pd, toks, check=False)


def _decode_routes(torch, dev, lm, pd, toks, *, check):
    """Decode ms/token and device launches a step of ``lm`` (phase 3c's
    model, b=4, P=1024) on four routes: the contiguous uniform step (bf16
    and int8 caches), the contiguous ragged step (prompt lengths 1024 /
    900 / 700 / 512) and the paged step (bf16 pool of 96 pages of 1024).
    The routes take turns (4 rounds of 8 steps, the order reversed every
    other round: host time varies between calls and within one), CUDA
    events around each step; then each is profiled over 8 steps and its
    ops of one step are sorted into the KV write's and the rest's
    (``check``: fail if the write issues any op that launches a kernel
    besides the append itself). Needs ``toks`` ``[b, >= 48]``."""
    from sputnik_tpu_torch.models import LMServer

    b, P = pd.shape
    bk = 1024
    routes = {}
    for name, dtype, pages, lens in (
            ("contiguous bf16", torch.bfloat16, None, None),
            ("contiguous int8", torch.int8, None, None),
            ("contiguous ragged bf16", torch.bfloat16, None,
             [1024, 900, 700, 512]),
            ("paged bf16", torch.bfloat16, 96, None)):
        srv = LMServer(lm, s_max=P + 64, bk=bk, cache_dtype=dtype,
                       n_pages=pages)
        caches = srv.init_caches(b)
        if pages:
            caches = srv.decoder.reserve(caches, P + 64)
        with torch.no_grad():
            _, caches = srv.decoder.prefill(
                srv.lm.embed(pd), caches,
                lengths=None if lens is None else torch.tensor(lens,
                                                               device=dev))
        step = srv.decode_step if lens is None else srv.decode_step_ragged
        for i in range(3):
            _, caches = step(toks[:, i], caches)
        routes[name] = [step, caches, []]
    torch.cuda.synchronize()
    i = 3
    names = list(routes)
    for rnd in range(4):
        for name in (names if rnd % 2 == 0 else names[::-1]):
            step, caches, times = routes[name]
            for j in range(8):
                start = torch.cuda.Event(enable_timing=True)
                end = torch.cuda.Event(enable_timing=True)
                start.record()
                _, caches = step(toks[:, i + j], caches)
                end.record()
                times.append((start, end))
            torch.cuda.synchronize()
            routes[name][1] = caches
        i += 8
    for name, (step, caches, times) in routes.items():
        ms = sorted(s_.elapsed_time(e) for s_, e in times)
        print(f"  decode step {name}: {statistics.median(ms):.4f} ms/token "
              f"(median of {len(ms)} steps in turns, min {ms[0]:.4f}, max "
              f"{ms[-1]:.4f})", flush=True)
    # the profiler's first window pays its own start-up: one step unprinted
    from torch.profiler import ProfilerActivity, profile
    step, caches, _ = routes[names[0]]
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]):
        routes[names[0]][1] = step(toks[:, 35], caches)[1]
        torch.cuda.synchronize()
    for name, (step, caches, _) in routes.items():
        _profile_decode(torch, step, caches, toks[:, 36:], name, check)


def _profile_steps(torch, label, step, n=8):
    """Device time by kernel over ``n`` calls ``step(i)`` (torch.profiler),
    and the device's busy share of the window's wall time."""
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for i in range(n):
            step(i)
        torch.cuda.synchronize()
    wall_ms = (time.perf_counter() - t0) * 1e3
    rows = [(e.key, getattr(e, "device_time_total", 0.0) / 1e3, e.count)
            for e in prof.key_averages()
            if getattr(e, "device_type", None) is not None
            and str(e.device_type).endswith("CUDA")]
    busy = sum(t for _, t, _ in rows)
    launches = sum(c for _, _, c in rows)
    print(f"  profile of {n} {label}: {wall_ms:.3f} ms wall (profiled), "
          f"device kernels {busy:.3f} ms -> busy {busy / wall_ms:.1%}; "
          f"{launches / n:.1f} device launches a step; by device time:",
          flush=True)
    for key, t, c in sorted(rows, key=lambda x: -x[1])[:12]:
        print(f"    {t / n:.4f} ms/step  {c / n:.0f} launches/step  "
              f"{key[:90]}", flush=True)
    return rows


# kernels of the kinds the KV write launched before it was one kernel a
# layer: indexed reads and writes, selects, fills and casts
_WRITE_KINDS = ("index_copy", "indexSelect", "where", "Fill", "copy_kernel")

# aten ops that launch no kernel (besides views)
_NO_KERNEL = ("empty", "empty_strided", "detach", "alias", "lift_fresh")


def _step_ops(torch, step):
    """The aten ops of one ``step()``, counted by (op, innermost frame of
    the port): those issued inside the KV write (an append function of
    ``ops/decode.py`` or ``ops/paged.py`` on the Python stack) and the
    rest, views left out."""
    import collections
    import os
    from torch.utils._python_dispatch import TorchDispatchMode

    from sputnik_tpu_torch.ops import decode as decode_ops
    from sputnik_tpu_torch.ops import paged as paged_ops

    write = {f.__code__ for f in (
        decode_ops.append_kv, decode_ops.append_kv_seq,
        paged_ops.append_paged, paged_ops.append_paged_seq)}
    inside, outside = collections.Counter(), collections.Counter()

    class Ops(TorchDispatchMode):
        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            out = func(*args, **(kwargs or {}))
            name = func.overloadpacket.__name__
            if func.is_view or name in _NO_KERNEL:
                return out
            f, site, in_write = sys._getframe(1), None, False
            while f is not None and not in_write:
                code = f.f_code
                in_write = code in write
                if site is None and "sputnik_tpu_torch" in code.co_filename:
                    site = (f"{os.path.basename(code.co_filename)}:"
                            f"{code.co_name}")
                f = f.f_back
            (inside if in_write else outside)[(name, site)] += 1
            return out

    with torch.no_grad(), Ops():
        step()
    return inside, outside


def _profile_decode(torch, step, caches, toks, label, check):
    """Device time by kernel over 8 decode steps, the device launches a
    step and how many a step are of the kinds the KV write used to launch;
    then one step's ops by site: those of the write (``check``: fail
    unless there are none, i.e. the append is its one kernel and the new
    length's ``empty``) and those of the kinds above elsewhere in the
    step (the embedding's gather, the tables, the casts around the
    projections and attention)."""
    caches = tuple(c.clone() for c in caches)

    def one(i):
        nonlocal caches
        _, caches = step(toks[:, i], caches)

    try:
        rows = _profile_steps(torch, f"decode steps, {label}", one)
        kinds = {k: sum(c for key, _, c in rows if k in key) / 8
                 for k in _WRITE_KINDS}
        print(f"    launches a step by kind: {kinds}", flush=True)
    except Exception as e:  # a measurement, not a check of the path
        print(f"  torch.profiler gave no device times: {e!r}", flush=True)
    inside, outside = _step_ops(torch, lambda: one(8))
    kin = ("index", "where", "fill", "copy", "clone", "ones", "zeros",
           "full", "scalar_tensor", "embedding")
    rest = {f"{op}@{site}": n for (op, site), n in sorted(outside.items())
            if any(k in op for k in kin)}
    print(f"    ops of one step in the KV write: {dict(inside) or 'none'}; "
          f"of those kinds elsewhere: {rest}", flush=True)
    if check and inside:
        _fail(f"decode {label}: the KV write issued ops besides its one "
              f"kernel: {dict(inside)}")


def _softmax_profile(torch, step, n):
    """torch.profiler over ``n`` calls of ``step()``: (wall ms, device ms,
    the softmax's device ms, device launches, the softmax ranges' span),
    each a step. The softmax is B5's kernel (``softmax_rows_kernel``) or, on
    the parent's route, the kernels under its "B5 softmax" ranges (their
    device time; the span of the ranges on the device timeline, which also
    holds the gaps between their kernels, is returned beside it)."""
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(n):
            step()
        torch.cuda.synchronize()
    wall = (time.perf_counter() - t0) * 1e3
    dev_ms = launches = sm = span = 0.0
    for e in prof.key_averages():
        t = getattr(e, "device_time_total", 0.0) / 1e3
        on_dev = str(getattr(e, "device_type", "")).endswith("CUDA")
        if e.key == "B5 softmax":
            if on_dev:
                span += t             # the ranges on the device timeline
            else:
                sm += t               # the kernels launched in the ranges
        elif on_dev:
            dev_ms += t
            launches += e.count
            if "softmax_rows_kernel" in e.key:
                sm += t
    return wall / n, dev_ms / n, sm / n, launches / n, span / n


def _softmax_turns(torch, label, step, routes, pairs=5):
    """B5's routes in turns on one step: ``routes`` maps a name to a
    context manager that installs the route; pair i runs them in the order
    given, odd pairs reversed, each a warm-up step, 3 steps timed on the
    host clock (synchronized; their median) and 2 profiled. Prints each
    turn, then each route's median, min and max."""
    names = list(routes)
    got = {n: [] for n in names}
    for i in range(pairs):
        for name in (names if i % 2 == 0 else names[::-1]):
            with routes[name]():
                step()
                wall = statistics.median(_step_times(torch, step, 3))
                _, dev_ms, sm, launches, span = _softmax_profile(torch, step,
                                                                 2)
            got[name].append((wall, dev_ms, sm, launches))
            share = sm / dev_ms if dev_ms > 0 else float("nan")
            print(f"  {label}, pair {i} {name}: wall {wall:.4f} ms, device "
                  f"{dev_ms:.4f} ms, softmax {sm:.4f} ms ({share:.1%} of the "
                  f"device time), {launches:.1f} device launches"
                  + (f"; the softmax ranges span {span:.4f} ms of the "
                     f"device timeline" if span else ""), flush=True)
    for name in names:
        cols = list(zip(*got[name]))
        text = ", ".join(
            f"{what} {statistics.median(v):.4f} [{min(v):.4f}, "
            f"{max(v):.4f}]" for what, v in zip(
                ("wall ms", "device ms", "softmax ms", "launches"), cols))
        print(f"  {label}, {name} route over {pairs} turns (median [min, "
              f"max]): {text}", flush=True)
    return got


# -- the MoE bank and the panel attention layout (B6, B7, B8) --------------


def _bh_problem(stt, torch, dev, topologies, heads, seed):
    """A ``BatchedPanelSpec`` over ``topologies`` x ``heads`` with random
    values on its occupied elements, on the card."""
    rng = np.random.RandomState(seed)
    spec = stt.BatchedPanelSpec(topologies, heads=heads)
    meta = spec.panel_meta(dev)
    panels = torch.from_numpy(rng.randn(spec.R, *spec.panel_shape).astype(
        np.float32)).to(dev)
    panels = (panels.view(spec.B, heads, *spec.panel_shape)
              * meta["mask"][:, None]).reshape(panels.shape)
    return spec, meta, panels, rng


def _bh_tiles(meta, heads) -> float:
    """Occupied tiles over all replicas (each mask's ``nblocks``, once per
    head): the stored-panel work of one batched call."""
    return float(meta["nblocks"].sum().item()) * heads


def _dense_bank(torch, panels, spec, topo):
    """The bank's panels densified ``[E, m, n]`` (the library yardstick's
    operand)."""
    from sputnik_tpu_torch.ops import panel_api as P

    out = np.zeros((panels.shape[0], topo.m, topo.n), np.float32)
    rows, cols = topo.row_ids[:topo.nnz], topo.column_indices[:topo.nnz]
    for e, p in enumerate(panels.cpu().numpy()):
        out[e, rows, cols] = P.panel_to_values_np(topo, p, spec.bm,
                                                  spec.bk)[:topo.nnz]
    return torch.from_numpy(out).to(panels.device)


def phase_batched_kernels(stt, torch, dev, kres, small=False):
    """Phase 2e: B6 / B7 / B8 against their plain versions at the MoE bank's
    shape (E = 8 experts over the example's d = 0.3 topologies, q = d = C =
    640; timed) and at the panel attention's (b = 4 DISTINCT masks, 8
    heads, s = 512, hd = 64, and a GQA case with K/V expanded 4x)."""
    from sputnik_tpu_torch.examples.train_moe_transformer import build
    from sputnik_tpu_torch.ops.kernels import batched_panel as K

    print("phase 2e: batched many-mask kernels (B6 spmm_bh, B7 sddmm_bh, B8 "
          "spmm_t_bh) vs plain PyTorch at the MoE bank and panel attention "
          "shapes", flush=True)
    model, x, _ = build(small, "cpu")
    moe = model.layers[1].mlp
    E, T = moe.num_experts, x.shape[0] * x.shape[1]
    C = max(int(np.ceil(T / E * moe.top_k * moe.capacity_factor)), 1)
    f, h = moe.topo_in.m, moe.topo_in.n
    sp_in, meta_in, p_in, rng = _bh_problem(stt, torch, dev, [moe.topo_in],
                                            E, 20)
    xin = torch.from_numpy(rng.randn(E, h, C).astype(np.float32)).to(dev)
    gy = torch.from_numpy(rng.randn(E, f, C).astype(np.float32)).to(dev)
    print(f"  bank: E={E} experts, topo_in [{f}, {h}] nnz "
          f"{moe.topo_in.nnz} (d=0.3), C={C}; panels "
          f"{tuple(p_in.shape)}, {_bh_tiles(meta_in, E) / E:.0f} of "
          f"{sp_in.mb * sp_in.kb} tiles occupied", flush=True)

    # B6: the bank's first projection y1 = W_in[e] @ xin[e]
    r = kres["spmm_bh"]
    a6 = (meta_in["block_cols"], meta_in["nblocks"], p_in, xin)
    kw6 = dict(heads=E, rows=f)
    _compare(f"spmm_bh bank [{E},{f},{h}] x [{E},{h},{C}]",
             K.spmm_bh_kernel(*a6, **kw6), K.spmm_bh_kernel_plain(*a6, **kw6),
             TOL_KERNEL, r)
    r["ms"] = _time_ms(lambda: K.spmm_bh_kernel(*a6, **kw6))
    r["plain_ms"] = _time_ms(lambda: K.spmm_bh_kernel_plain(*a6, **kw6),
                             reps=3, inner=2)
    w_in = _dense_bank(torch, p_in, sp_in, moe.topo_in)
    _compare("spmm_bh bank vs torch.bmm on the densified weights",
             K.spmm_bh_kernel(*a6, **kw6), torch.bmm(w_in, xin), TOL_KERNEL)
    r["library_ms"] = _library_ms("spmm_bh (torch.bmm, densified bank)",
                                  lambda: torch.bmm(w_in, xin))
    tiles_in = _bh_tiles(meta_in, E) * sp_in.bm * sp_in.bk
    nnz_in = moe.topo_in.nnz
    print(f"  spmm_bh bank: kernel {r['ms']:.4f} ms, plain "
          f"{r['plain_ms']:.4f} ms", flush=True)
    _sparse_bound(r, nnz_in, E, C, _nbytes(xin) + E * f * C * 4,
                  PEAK_3XTF32)
    _stored_note("spmm_bh bank", tiles_in, C)

    # B7: the bank's values gradient d_W_in = sddmm(g_y1, xin), D = C
    r = kres["sddmm_bh"]
    a7 = (meta_in["block_cols"], meta_in["nblocks"], gy, xin,
          meta_in["mask"])
    got = K.sddmm_bh_kernel(*a7, heads=E)
    _compare(f"sddmm_bh bank [{E},{f},{C}] x [{E},{h},{C}]", got,
             K.sddmm_bh_kernel_plain(*a7, heads=E), TOL_KERNEL, r)
    off = (meta_in["mask"] == 0)[:, None].expand(
        1, E, *sp_in.panel_shape).reshape(got.shape)
    if not torch.all(got[off] == 0):
        _fail("sddmm_bh: masked or padded panel slots are not exactly 0")
    if not torch.equal(got.view(torch.int32),
                       K.sddmm_bh_kernel(*a7, heads=E).view(torch.int32)):
        _fail("sddmm_bh: two calls differ in their bits")
    r["ms"] = _graph_ms(lambda: K.sddmm_bh_kernel(*a7, heads=E))
    eager_ms = _time_ms(lambda: K.sddmm_bh_kernel(*a7, heads=E))
    r["plain_ms"] = _time_ms(lambda: K.sddmm_bh_kernel_plain(*a7, heads=E),
                             reps=3, inner=2)
    topo = moe.topo_in
    crow = torch.from_numpy(np.asarray(topo.row_offsets, np.int64))
    col = torch.from_numpy(np.asarray(topo.column_indices[:topo.nnz],
                                      np.int64))
    csr = torch.sparse_csr_tensor(crow.expand(E, -1).contiguous(),
                                  col.expand(E, -1).contiguous(),
                                  torch.ones(E, topo.nnz), (E, f, h)).to(dev)
    xin_t = xin.transpose(1, 2).contiguous()
    r["library_ms"] = _library_ms(
        "sddmm_bh (torch.sparse.sampled_addmm, batched CSR)",
        lambda: torch.sparse.sampled_addmm(csr, gy, xin_t, beta=0.0),
        timer=_graph_ms)
    print(f"  sddmm_bh bank: kernel {r['ms']:.4f} ms (graph; eager "
          f"{eager_ms:.4f}; the FMA body read 0.5145, PERF.md), the same "
          f"bits twice; plain {r['plain_ms']:.4f} ms", flush=True)
    _sparse_bound(r, nnz_in, E, C, _nbytes(gy, xin), PEAK_3XTF32)
    _stored_note("sddmm_bh bank", tiles_in, C)
    del got, csr

    # B8: the bank's input gradient d_xin = W_in^T @ g_y1
    r = kres["spmm_t_bh"]
    a8 = (meta_in["t_src_i"], meta_in["t_src_s"], meta_in["t_nblocks"], p_in,
          gy)
    kw8 = dict(heads=E, rows=h)
    got = K.spmm_t_bh_kernel(*a8, **kw8)
    _compare(f"spmm_t_bh bank [{E},{h},{f}] x [{E},{f},{C}]", got,
             K.spmm_t_bh_kernel_plain(*a8, **kw8), TOL_KERNEL, r)
    _compare("spmm_t_bh bank vs torch.bmm(W^T, g)", got,
             torch.bmm(w_in.transpose(1, 2), gy), TOL_KERNEL)
    r["ms"] = _time_ms(lambda: K.spmm_t_bh_kernel(*a8, **kw8))
    r["plain_ms"] = _time_ms(lambda: K.spmm_t_bh_kernel_plain(*a8, **kw8),
                             reps=3, inner=2)
    r["library_ms"] = _library_ms(
        "spmm_t_bh (torch.bmm, densified bank transposed)",
        lambda: torch.bmm(w_in.transpose(1, 2), gy))
    print(f"  spmm_t_bh bank: kernel {r['ms']:.4f} ms, plain "
          f"{r['plain_ms']:.4f} ms", flush=True)
    _sparse_bound(r, nnz_in, E, C, _nbytes(gy, got), PEAK_3XTF32)
    del got, w_in

    # the bank's second projection: topo_out [h, f] x [E, f, C]
    sp_o, meta_o, p_o, rng = _bh_problem(stt, torch, dev, [moe.topo_out], E,
                                         21)
    a1 = torch.from_numpy(rng.randn(E, f, C).astype(np.float32)).to(dev)
    ao = (meta_o["block_cols"], meta_o["nblocks"], p_o, a1)
    _compare(f"spmm_bh bank out [{E},{h},{f}] x [{E},{f},{C}]",
             K.spmm_bh_kernel(*ao, heads=E, rows=h),
             K.spmm_bh_kernel_plain(*ao, heads=E, rows=h), TOL_KERNEL,
             kres["spmm_bh"])
    g2 = torch.from_numpy(rng.randn(E, h, C).astype(np.float32)).to(dev)
    ao7 = (meta_o["block_cols"], meta_o["nblocks"], g2, a1, meta_o["mask"])
    _compare("sddmm_bh bank out (d W_out)", K.sddmm_bh_kernel(*ao7, heads=E),
             K.sddmm_bh_kernel_plain(*ao7, heads=E), TOL_KERNEL,
             kres["sddmm_bh"])
    ao8 = (meta_o["t_src_i"], meta_o["t_src_s"], meta_o["t_nblocks"], p_o, g2)
    _compare("spmm_t_bh bank out (d a1)",
             K.spmm_t_bh_kernel(*ao8, heads=E, rows=f),
             K.spmm_t_bh_kernel_plain(*ao8, heads=E, rows=f), TOL_KERNEL,
             kres["spmm_t_bh"])
    del p_in, p_o, a1, g2, xin, gy

    # the panel attention: b = 4 DISTINCT masks (tril(k=-i), a fully-masked
    # row in mask 0), 8 heads, s = 512, hd = 64; and GQA (2 KV heads)
    b, heads, s, hd = (4, 8, 512, 64) if not small else (2, 2, 64, 16)
    masks = np.stack([np.tril(np.ones((s, s), np.float32), k=-i)
                      for i in range(b)])
    masks[0, s // 2] = 0.0
    mt = stt.ManyMaskTopology.from_dense_masks(masks)
    sp, meta, w, rng = _bh_problem(stt, torch, dev, mt.topologies, heads, 22)
    R = sp.R
    q, k, v = (torch.from_numpy(rng.randn(R, s, hd).astype(np.float32)
                                ).to(dev) for _ in range(3))
    print(f"  attention: b={b} distinct masks, heads={heads}, s={s}, hd={hd}; "
          f"occupied tiles per mask {meta['nblocks'].sum(1).tolist()} of "
          f"{sp.mb * sp.kb}; scores panel {tuple(w.shape)}", flush=True)
    at7 = (meta["block_cols"], meta["nblocks"], q, k, meta["mask"])
    sc = K.sddmm_bh_kernel(*at7, heads=heads)
    _compare(f"sddmm_bh attention R={R} s={s} hd={hd}", sc,
             K.sddmm_bh_kernel_plain(*at7, heads=heads), TOL_KERNEL,
             kres["sddmm_bh"])
    kv = heads // 4 or 1
    k_kv = torch.from_numpy(rng.randn(b * kv, s, hd).astype(np.float32)).to(
        dev).repeat_interleave(heads // kv, dim=0)
    gq = (meta["block_cols"], meta["nblocks"], q, k_kv, meta["mask"])
    _compare(f"sddmm_bh attention GQA ({kv} KV heads, expanded)",
             K.sddmm_bh_kernel(*gq, heads=heads),
             K.sddmm_bh_kernel_plain(*gq, heads=heads), TOL_KERNEL,
             kres["sddmm_bh"])
    p = stt.sparse_softmax_bh(sp, sc * hd ** -0.5)
    at6 = (meta["block_cols"], meta["nblocks"], p, v)
    ctx = K.spmm_bh_kernel(*at6, heads=heads, rows=s)
    _compare(f"spmm_bh attention P @ V R={R}", ctx,
             K.spmm_bh_kernel_plain(*at6, heads=heads, rows=s), TOL_KERNEL,
             kres["spmm_bh"])
    if not torch.all(ctx[:heads, s // 2] == 0):
        _fail("panel attention: mask 0's fully-masked row is not exactly 0")
    at8 = (meta["t_src_i"], meta["t_src_s"], meta["t_nblocks"], p, q)
    _compare(f"spmm_t_bh attention P^T @ G R={R}",
             K.spmm_t_bh_kernel(*at8, heads=heads, rows=s),
             K.spmm_t_bh_kernel_plain(*at8, heads=heads, rows=s), TOL_KERNEL,
             kres["spmm_t_bh"])
    ms = {n: _graph_ms(fn) for n, fn in (
        ("sddmm_bh", lambda: K.sddmm_bh_kernel(*at7, heads=heads)),
        ("spmm_bh", lambda: K.spmm_bh_kernel(*at6, heads=heads, rows=s)),
        ("spmm_t_bh", lambda: K.spmm_t_bh_kernel(*at8, heads=heads,
                                                  rows=s)))}
    # the bound of each from the masks' nonzeros: hd-wide operands, the
    # pattern and one value per nonzero and head
    nnz = float(masks.sum())
    dense = _nbytes(q, k)
    bound = max(2.0 * nnz * heads * hd / PEAK_F32,
                (4 * nnz + 4 * nnz * heads + dense) / PEAK_BYTES) * 1e3
    print(f"  attention shape (not the JSON's timed call; graph): sddmm_bh "
          f"{ms['sddmm_bh']:.4f} ms, spmm_bh {ms['spmm_bh']:.4f} ms, "
          f"spmm_t_bh {ms['spmm_t_bh']:.4f} ms; bound of each {bound:.4f} "
          f"ms ({nnz:.0f} mask nonzeros; the stored scores panel is "
          f"{_nbytes(sc) / 1e6:.1f} MB)", flush=True)


def _moe_grads(model):
    """The router and expert values' gradients of every MoE layer, on the
    CPU."""
    from sputnik_tpu_torch.examples.train_moe_transformer import moe_layers

    return {f"layers.{i}.mlp.{n}": p.grad.detach().cpu().clone()
            for i, moe in moe_layers(model).items()
            for n, p in moe.named_parameters()}


def _step_times(torch, fn, n):
    """Host-clock milliseconds of ``n`` calls of ``fn``, each ending in a
    device synchronize."""
    out = []
    for _ in range(n):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        out.append((time.perf_counter() - t0) * 1e3)
    return out


def phase_moe_train(stt, torch, dev, wrappers, small=False):
    """Phase 3e: the MoE transformer at the example's full config (b=4,
    s=512, h=512, ffn 2048, 6 layers, 8 heads, 8 experts top-2, MoE every
    2nd layer) takes the example's 10 Adam steps through its ``train_step``
    with its self-checks, and the driver config under ``attention_layout=
    "panel"`` takes one; launches checked against the VJP algebra; then
    the panel-layout step on the parent's softmax (plain PyTorch) and on
    B5's panel modes in turns (``_softmax_turns``). Phase 4e: the first
    MoE step (routing, losses, router and expert gradients) and the panel
    model's forward against the same modules on the CPU."""
    from sputnik_tpu_torch.examples import train_moe_transformer as ex
    from sputnik_tpu_torch.examples.train_sparse_transformer import (
        train_step)
    from sputnik_tpu_torch.models import SparseTransformer
    from sputnik_tpu_torch.patterns import driver_masks

    layers = 4 if small else 6
    print(f"phase 3e: MoE training path — the example's config "
          f"({'small' if small else 'full'}), {layers} layers, MoE every 2nd "
          f"(top-2, d=0.3), {MOE_STEPS} Adam steps (the example's default); "
          f"then the driver config with attention_layout='panel', 1 step",
          flush=True)
    cpu_model, x, y = ex.build(small, "cpu")
    model = copy.deepcopy(cpu_model).to(dev)
    xd, yd = x.to(dev), y.to(dev)
    moes = ex.moe_layers(model)
    n_moe = len(moes)
    with torch.no_grad():                 # builds the device metadata
        out0 = model(xd).cpu()
    routes = {i: m.last_experts.cpu() for i, m in moes.items()}
    probs = {i: m.last_probs.cpu() for i, m in moes.items()}
    opt = torch.optim.Adam(model.parameters(), lr=1e-3)
    total = {n: 0 for n in wrappers}
    # per MoE layer: two B6 forward; B7 (values) + B8 (input) for each
    # projection backward; the attention is flash (B9, then B10a)
    bank = {"spmm_bh": 2 * n_moe, "sddmm_bh": 2 * n_moe,
            "spmm_t_bh": 2 * n_moe, "flash_sparse_attention_fwd": layers,
            "flash_sparse_bwd_fused": layers, "flash_sparse_bwd_dq": 0,
            "flash_sparse_bwd_dkv": 0, "bsr_spmm_panel": 0,
            "bsr_sddmm_panel": 0, "bsr_spmm_t_panel": 0}
    steps, grads0 = [], None
    for i in range(MOE_STEPS):
        steps.append(_counted(wrappers, total, f"MoE step {i}",
                              lambda: ex.train_step(model, opt, xd, yd),
                              bank))
        if i == 0:
            grads0 = _moe_grads(model)
            for j, moe in moes.items():
                gv = moe.w_in_values.grad
                if not (torch.isfinite(gv).all() and gv.abs().sum() > 0):
                    _fail(f"MoE layer {j}: w_in_values has no finite nonzero "
                          f"gradient on step 1")
    mse = [float(m) for m, _ in steps]
    aux = [float(a) for _, a in steps]
    print(f"  MoE mse {mse}, aux {aux}", flush=True)
    if not all(np.isfinite(aux)):
        _fail(f"MoE aux loss not finite: {aux}")
    if not mse[-1] < mse[0]:
        _fail(f"MoE loss did not decrease: {mse}")
    moe_ms = _step_times(torch, lambda: ex.train_step(model, opt, xd, yd), 8)
    _profile_steps(torch, "MoE training steps",
                   lambda i: ex.train_step(model, opt, xd, yd), 3)
    torch.cuda.reset_peak_memory_stats(dev)
    ex.train_step(model, opt, xd, yd)
    torch.cuda.synchronize()
    moe_peak = torch.cuda.max_memory_allocated(dev)

    b, s, h, heads, p_layers, ffn = (
        (4, 512, 512, 8, 6, 2048) if not small else (2, 64, 32, 2, 2, 64))
    gen = torch.Generator().manual_seed(30)
    cpu_panel = SparseTransformer.from_masks(
        driver_masks(b, s), num_layers=p_layers, hidden_size=h,
        num_heads=heads, ffn_hidden_size=ffn, use_residual=True,
        use_layernorm=True, activation="gelu", attention_layout="panel",
        generator=gen)
    panel = copy.deepcopy(cpu_panel).to(dev)
    xp, yp = (torch.randn(b, s, h, generator=torch.Generator().manual_seed(sd))
              for sd in (31, 32))
    xpd, ypd = xp.to(dev), yp.to(dev)
    with torch.no_grad():
        outp = panel(xpd).cpu()
    popt = torch.optim.Adam(panel.parameters(), lr=1e-3)
    loss_p = _counted(
        wrappers, total, "panel-layout step",
        lambda: train_step(panel, popt, xpd, ypd),
        # per layer: B7 + B6 forward; B7 + B8 (spmm_bh's VJP) and B6 + B8
        # (sddmm_bh's VJP) backward
        # and B5's panel modes, one forward and one backward
        {"spmm_bh": 2 * p_layers, "sddmm_bh": 2 * p_layers,
         "spmm_t_bh": 2 * p_layers, "flash_sparse_attention_fwd": 0,
         "bsr_spmm_panel": 0, "bsr_sddmm_panel": 0, "bsr_spmm_t_panel": 0,
         "panel_softmax": p_layers, "panel_softmax_bwd": p_layers,
         "ell_softmax": 0, "ell_softmax_bwd": 0})
    panel_ms = _step_times(torch, lambda: train_step(panel, popt, xpd, ypd),
                           5)
    _profile_steps(torch, "panel-layout training steps",
                   lambda i: train_step(panel, popt, xpd, ypd), 3)
    print(f"  panel-layout loss {float(loss_p):.6f}", flush=True)
    from sputnik_tpu_torch.ops import batched_panel

    parent_apply = _parent_softmax(torch)[2]

    @contextlib.contextmanager
    def parent():
        # the parent's softmax: eager PyTorch, a bool mask every call
        keep = batched_panel.masked_softmax
        batched_panel.masked_softmax = parent_apply
        try:
            yield
        finally:
            batched_panel.masked_softmax = keep

    print("  panel-layout step: B5's routes in turns (parent: the plain "
          "panel softmax; B5: its panel modes)", flush=True)
    _softmax_turns(torch, "panel-layout step",
                   lambda: train_step(panel, popt, xpd, ypd),
                   {"parent": parent, "B5": contextlib.nullcontext})
    for tag, t in (("MoE training step", moe_ms),
                   ("panel-layout training step", panel_ms)):
        print(f"  {tag}: median {statistics.median(t):.4f} ms, min "
              f"{min(t):.4f}, max {max(t):.4f} over {len(t)} steps (host "
              f"clock, synchronized)", flush=True)
    print(f"  MoE step peak device memory {moe_peak / 2**20:.1f} MiB",
          flush=True)

    print("phase 4e: the first MoE step and the panel forward vs the CPU "
          "plain path", flush=True)
    t0 = time.perf_counter()
    with torch.no_grad():
        ref0 = cpu_model(x)
    for i, m in ex.moe_layers(cpu_model).items():
        p_sorted = probs[i].sort(dim=-1, descending=True).values
        margin = float((p_sorted[:, :2] - p_sorted[:, 1:3]).min())
        same = torch.equal(routes[i], m.last_experts)
        print(f"  MoE layer {i}: routing of {routes[i].shape[0]} tokens equal "
              f"to the CPU's: {same}; smallest top-1/top-2 probability "
              f"margin {margin:.3e}", flush=True)
        if not same:
            _fail(f"MoE layer {i}: the card routes differently from the CPU "
                  f"(smallest margin {margin:.3e})")
    _compare("MoE forward output", out0, ref0, TOL_MODEL)
    cpu_opt = torch.optim.Adam(cpu_model.parameters(), lr=1e-3)
    cmse, caux = ex.train_step(cpu_model, cpu_opt, x, y)
    _compare("MoE step-0 mse", torch.tensor([mse[0]]), cmse[None],
             TOL_MODEL)
    _compare("MoE step-0 aux", torch.tensor([aux[0]]), caux[None],
             TOL_MODEL)
    # relative limits: a zeroed gradient is off by max|ref|, 1 / TOL_MODEL
    # times its limit; each expert-values check is shown to fail on one
    for name, ref_g in _moe_grads(cpu_model).items():
        _compare(f"MoE step-0 gradient {name}", grads0[name], ref_g,
                 TOL_MODEL, floor=0.0)
        if name.endswith("_values"):
            try:
                _compare(f"  planted fault, {name} zeroed",
                         torch.zeros_like(ref_g), ref_g, TOL_MODEL, floor=0.0)
            except RuntimeError:
                continue
            _fail(f"a zeroed {name} passed its check")
    with torch.no_grad():
        _compare("panel-layout forward output", outp, cpu_panel(xp),
                 TOL_MODEL)
    print(f"  CPU reference in {time.perf_counter() - t0:.1f} s", flush=True)
    return total


# -- the flat op set, B5 and dynamic sparse training ------------------------


def _bench_matrix(stt):
    """``bench.py``'s sparse operand: 4096^2, element-random d = 0.1, from
    ``RandomState(0)`` as phase 2 draws it."""
    rng = np.random.RandomState(0)
    size, density = 4096, 0.1
    w = ((rng.rand(size, size) < density) * rng.randn(size, size)
         ).astype(np.float32)
    return w, stt.SparseMatrix(w)


def _softmax_library_ms(torch, topo, vals):
    """``torch.sparse.softmax`` over the coalesced COO of the same pattern
    (replicas as a leading sparse dim), which also takes the softmax over
    the specified entries only: B5's yardstick."""
    R, nnz = vals.shape[0], topo.nnz
    rows = torch.from_numpy(topo.row_ids[:nnz].astype(np.int64))
    cols = torch.from_numpy(topo.column_indices[:nnz].astype(np.int64))
    idx = torch.stack([torch.arange(R).repeat_interleave(nnz),
                       rows.repeat(R), cols.repeat(R)]).to(vals.device)
    coo = torch.sparse_coo_tensor(idx, vals[:, :nnz].reshape(-1),
                                  (R, topo.m, topo.n)).coalesce()
    return _library_ms("sparse softmax (torch.sparse.softmax, COO)",
                       lambda: torch.sparse.softmax(coo, dim=2))


def _attention_mask():
    """The reference SparseAttention's score mask: [512, 512] at sparsity
    0.9 (``tests/test_attention.py``), row 37 emptied."""
    from sputnik_tpu_torch.patterns import uniform_mask

    mask = uniform_mask(512, 512, sparsity=0.9, seed=0)
    mask[37] = 0.0
    return mask


def _parent_softmax(torch):
    """The panel softmax as the parent of B5's panel policy computed it
    (``panel_api._MaskedSoftmax`` before it launched B5): eager PyTorch on
    a bool mask built from the spec's f32 mask on every call. ``fwd(panel
    [R, ...], mask [n, ...], heads)`` and ``bwd(p, g)``; ``apply`` the
    autograd op that phases 3e / 3f switch the model's softmax to."""

    def fwd(panel, mask, heads):
        n = mask.shape[0]
        live = mask[:, None] != 0
        x = panel.reshape(n, heads, *panel.shape[1:])
        v = torch.where(live, x, -1e30)
        row_max = v.amax(dim=(-3, -1), keepdim=True).clamp(min=-1e30)
        e = torch.where(live, torch.exp(v - row_max), 0.0)
        denom = e.sum(dim=(-3, -1), keepdim=True)
        p = e / denom.clamp(min=torch.finfo(panel.dtype).tiny)
        return p.reshape(panel.shape)

    def bwd(p, g):
        return p * (g - (p * g).sum(dim=(-3, -1), keepdim=True))

    class Parent(torch.autograd.Function):
        @staticmethod
        def forward(ctx, panel, mask, nblocks, heads):
            with torch.profiler.record_function("B5 softmax"):
                p = fwd(panel, mask, heads)
            ctx.save_for_backward(p)
            return p

        @staticmethod
        def backward(ctx, g):
            (p,) = ctx.saved_tensors
            with torch.profiler.record_function("B5 softmax"):
                return bwd(p, g), None, None, None

    return fwd, bwd, Parent.apply


def _softmax_cases(stt, torch, dev, mat):
    """Phase 2f's four shapes, inputs made from a seed: the two CSR ones,
    (a) the flat attention layout (32 replicas of one [512, 512] mask at
    d = 0.1, row 37 emptied, a row of -inf scores) and (b) bench.py's 4096^2
    d = 0.1 at r = 1 (a row of -inf scores); the two panel ones, (c) the
    panel-layout training step's [32, 8, 8, 64, 64] (4 causal masks of 512
    with the driver's emptied row 256, 8 heads) and (d) SparseAttention's
    (R = 32, the [512, 512] d = 0.1 mask of phase 2), each with a row of
    -inf scores. Every cotangent is finite."""
    from sputnik_tpu_torch.many_mask import ManyMaskTopology
    from sputnik_tpu_torch.ops import panel_api as P
    from sputnik_tpu_torch.ops.batched_panel import BatchedPanelSpec
    from sputnik_tpu_torch.patterns import driver_masks, uniform_mask

    rng = np.random.RandomState(60)
    csr = []
    ta = stt.SparseTopology.from_dense_mask(_attention_mask(), pad_to=64)
    for tag, topo, R in (("(a) attention R=32 s=512 d=0.1", ta, 32),
                         ("(b) bench 4096^2 d=0.1 r=1", mat.topology, 1)):
        vals = (rng.randn(R, topo.nnz_pad) * 4).astype(np.float32)
        ro = topo.row_offsets
        vals[:, ro[5]:ro[6]] = -np.inf            # a row of -inf scores
        csr.append(dict(
            tag=tag, topo=topo, R=R, v=torch.from_numpy(vals).to(dev),
            g=torch.from_numpy(rng.randn(R, topo.nnz_pad).astype(
                np.float32)).to(dev),
            row_offsets=torch.from_numpy(ro).to(dev),
            row_ids=torch.from_numpy(topo.row_ids.astype(np.int64)).to(dev),
            valid=torch.from_numpy(topo.valid).to(dev)))
    panel = []
    bspec = BatchedPanelSpec.from_many_mask(
        ManyMaskTopology.from_dense_masks(driver_masks(4, 512)), heads=8)
    bm = bspec.panel_meta(dev)
    aspec = P.PanelSpec(stt.SparseTopology.from_dense_mask(
        uniform_mask(512, 512, sparsity=0.9, seed=0)))
    am = aspec.meta(dev)
    for tag, mask, nblocks, heads in (
            ("(c) panel-layout step [32, 8, 8, 64, 64] causal", bm["mask"],
             bm["nblocks"], 8),
            ("(d) SparseAttention R=32 s=512 d=0.1", am["mask"][None],
             am["nblocks"][None], 32)):
        R = mask.shape[0] * heads
        shape = (R,) + tuple(mask.shape[1:])
        x = torch.from_numpy((rng.randn(*shape) * 4).astype(np.float32)
                             ).to(dev)
        x[:, 1, :, 5] = -float("inf")              # row 5 of row block 1
        panel.append(dict(
            tag=tag, mask=mask, nblocks=nblocks, heads=heads, R=R, v=x,
            g=torch.from_numpy(rng.randn(*shape).astype(np.float32)
                               ).to(dev)))
    return csr, panel


def _row_scale(p, g, rowsum):
    """Each slot's scale for the backward's slot-by-slot check: |p| times
    the row's sum of |p * g|. The backward's g - rowsum(p * g) cancels
    where g is near the row sum; there the f32 rounding of the sum (a few
    ulp of that sum of magnitudes, in any order) sets the error, not
    |dx|."""
    return p.abs() * rowsum((p * g).abs())


def phase_softmax_routes(stt, torch, dev, kres, mat):
    """B5's four shapes (``_softmax_cases``) on the routes a checkout has:
    ``ell_softmax_kernel`` forward and the plain CSR backward
    (``plain_ops.softmax_vjp``), and the panel softmax as the parent
    computed it (``_parent_softmax``), by CUDA graph replay and in eager
    calls. Measures a parent checkout (a copy of this script run there with
    ``--only softmax_routes``) against this one; checks nothing."""
    from sputnik_tpu_torch.ops import plain_ops
    from sputnik_tpu_torch.ops.kernels.ell_softmax import ell_softmax_kernel

    csr, panel = _softmax_cases(stt, torch, dev, mat)
    print("phase softmax_routes: B5 on this checkout's routes (ms: CUDA "
          "graph replay / eager calls)", flush=True)
    for c in csr:
        p = ell_softmax_kernel(c["row_offsets"], c["row_ids"], c["v"],
                               nnz=c["topo"].nnz)

        def kern(c=c):
            return ell_softmax_kernel(c["row_offsets"], c["row_ids"],
                                      c["v"], nnz=c["topo"].nnz)

        def vjp(c=c, p=p):
            return plain_ops.softmax_vjp(p, c["g"], c["row_ids"],
                                         c["topo"].m)

        for name, fn in (("ell_softmax_kernel forward", kern),
                         ("plain softmax_vjp backward", vjp)):
            print(f"  {c['tag']}: {name} {_graph_ms(fn):.4f} / "
                  f"{_time_ms(fn):.4f} ms", flush=True)
    fwd, bwd, _ = _parent_softmax(torch)
    for c in panel:
        p = fwd(c["v"], c["mask"], c["heads"])
        for name, fn in (
                ("parent plain forward",
                 lambda c=c: fwd(c["v"], c["mask"], c["heads"])),
                ("parent plain backward", lambda c=c, p=p: bwd(p, c["g"]))):
            print(f"  {c['tag']}: {name} {_graph_ms(fn):.4f} / "
                  f"{_time_ms(fn):.4f} ms", flush=True)


def _panel_library_ms(torch, c, vals, bwd_of=None):
    """``torch.sparse.softmax`` (or, with ``bwd_of = (p, g)``,
    ``torch._sparse_softmax_backward_data``) over the COO of the panel's
    live slots, a row a panel row: B5's panel yardstick."""
    R, mb, max_bpr, bm, bk = vals.shape
    live = (c["mask"] != 0).permute(0, 1, 3, 2, 4).reshape(
        -1, mb * bm, max_bpr * bk)
    idx = live.repeat_interleave(c["heads"], 0).reshape(
        R * mb * bm, max_bpr * bk).nonzero().T

    def coo(x):
        x = x.permute(0, 1, 3, 2, 4).reshape(R * mb * bm, max_bpr * bk)
        return torch.sparse_coo_tensor(idx, x[idx[0], idx[1]],
                                       x.shape).coalesce()

    if bwd_of is None:
        s = coo(vals)
        return _library_ms("panel softmax (torch.sparse.softmax, COO)",
                           lambda: torch.sparse.softmax(s, dim=1))
    out, grad = coo(bwd_of[0]), coo(bwd_of[1])
    return _library_ms(
        "panel softmax backward (torch._sparse_softmax_backward_data, COO)",
        lambda: torch._sparse_softmax_backward_data(grad, out, 1, out))


def _b5_checks(name, kern, got, ref, scale, zeros):
    """B5's checks of one (policy, mode) pair: max|plain|, each slot at
    TOL_KERNEL x ``scale`` (shown to fail on outputs below the median
    zeroed), exactly 0 where ``zeros``, the same bits on a second call and
    after two graph replays."""
    import torch

    _compare(name, got, ref, TOL_KERNEL)
    _compare_each(name, got, ref, TOL_KERNEL, scale)
    small = (ref != 0) & (ref.abs() < ref[ref != 0].abs().median())
    try:
        _compare_each(f"  planted fault, {name} small outputs zeroed",
                      torch.where(small, 0.0, got), ref, TOL_KERNEL, scale)
    except RuntimeError:
        pass
    else:
        _fail(f"{name}: zeroed small outputs passed the check")
    if not torch.all(got[zeros] == 0):
        _fail(f"{name}: a slot that must be exactly 0 is not")
    print(f"  {name}: {int(zeros.sum())} slots exactly 0 as they must be",
          flush=True)
    _same_bits_and_replays(name, kern, got)
    return (got.float() - ref.float()).abs().max().item()


def _team_sweep(name, fwd, bwd):
    """B5's forward and backward by graph replay at each team shape: 8, 16
    or 32 lanes a row, 4 or 8 chunks a lane in registers, set through the
    wrappers' measurement hook ``_TEAM``; then the kernel's own rule. The
    readings behind the rule (``lanes_for`` and the C entries' nv)."""
    from sputnik_tpu_torch.ops.kernels import ell_softmax as K

    text = []
    try:
        for mode, fn in (("fwd", fwd), ("bwd", bwd)):
            cells = []
            for team in [(n, v) for n in (8, 16, 32) for v in (4, 8)] + [
                    (0, 0)]:
                K._TEAM = team
                cells.append(f"{team[0]}/{team[1]}: {_graph_ms(fn):.4f}")
            text.append(f"{mode} " + ", ".join(cells))
    finally:
        K._TEAM = (0, 0)
    print(f"  B5 team sweep {name} (lanes/nv: ms, graph replay; 0/0 the "
          f"rule): {'; '.join(text)}", flush=True)


def phase_softmax_kernel(stt, torch, dev, kres, mat):
    """Phase 2f: B5's four (policy, mode) pairs against their plain versions
    at ``_softmax_cases``' shapes: CSR forward / backward at the flat
    attention layout and bench.py's pattern, panel forward / backward at the
    panel-layout step's and SparseAttention's. Each: max|plain|, each slot,
    exact zeros (padding, masked, -inf and emptied rows forward; slots with
    p = 0 backward), the same bits twice and after graph replays, a NaN
    cotangent at a masked slot reaching its row as in the plain version;
    then graph-replay ms, the byte bound, the plain version's ms (graph
    replay, eager beside) and one PyTorch call's ms. The JSON line holds
    (b) for the CSR modes and (c) for the panel modes."""
    from sputnik_tpu_torch.ops import plain_ops
    from sputnik_tpu_torch.ops.kernels import ell_softmax as K

    print("phase 2f: sparse softmax B5 (CSR rows and panel rows, forward "
          "and backward) vs plain PyTorch; each slot at a relative limit, "
          "besides the max|plain| one", flush=True)
    csr, panel = _softmax_cases(stt, torch, dev, mat)

    for c in csr:
        topo, R, tag = c["topo"], c["R"], c["tag"]
        ro, ri = c["row_offsets"], c["row_ids"]

        def fwd(c=c):
            return K.ell_softmax_kernel(ro, ri, c["v"], nnz=topo.nnz)

        def fwd_plain(c=c):
            return plain_ops.sparse_softmax(c["v"], ri, c["valid"], topo.m)

        p = fwd()
        ref = fwd_plain()
        pad = torch.zeros_like(p, dtype=torch.bool)
        pad[:, topo.nnz:] = True
        pad[:, topo.row_offsets[5]:topo.row_offsets[6]] = True
        rf = kres["ell_softmax"]
        err_f = _b5_checks(f"ell_softmax {tag}", fwd, p, ref, ref.abs(), pad)
        del ref

        def bwd(c=c, p=p):
            return K.ell_softmax_bwd_kernel(ro, ri, p, c["g"], nnz=topo.nnz)

        def bwd_plain(c=c, p=p):
            return plain_ops.softmax_vjp(p, c["g"], ri, topo.m)

        def rowsum(x):
            s = x.new_zeros(R, topo.m + 1).index_add_(1, ri, x)
            return s.index_select(1, ri)

        dx = bwd()
        ref = bwd_plain()
        rb = kres["ell_softmax_bwd"]
        err_b = _b5_checks(f"ell_softmax_bwd {tag}", bwd, dx, ref,
                           ref.abs() + _row_scale(p, c["g"], rowsum),
                           p == 0)
        del ref
        empty = int((topo.row_lengths == 0).sum())
        print(f"  {tag}: nnz {topo.nnz} nnz_pad {topo.nnz_pad}, {empty} "
              f"empty rows", flush=True)
        t = {}
        for key, kern, plain in (("f", fwd, fwd_plain), ("b", bwd, bwd_plain)):
            t[key] = {"ms": _graph_ms(kern), "eager": _time_ms(kern),
                      "plain_ms": _graph_ms(plain),
                      "plain_eager": _time_ms(plain)}
            print(f"  ell_softmax{'_bwd' if key == 'b' else ''} {tag}: "
                  f"kernel {t[key]['ms']:.4f} ms (graph replay; eager "
                  f"{t[key]['eager']:.4f}), plain {t[key]['plain_ms']:.4f} "
                  f"ms (graph replay; eager {t[key]['plain_eager']:.4f})",
                  flush=True)
        _team_sweep(f"ell_softmax {tag}", fwd, bwd)
        vlib = torch.where(torch.isinf(c["v"]), -30.0, c["v"])
        t["f"]["library_ms"] = _softmax_library_ms(torch, topo, vlib)
        t["b"]["library_ms"] = _softmax_bwd_library_ms(torch, topo, p,
                                                       c["g"])
        nz = R * topo.nnz
        pad_b = 4 * R * (topo.nnz_pad - topo.nnz)
        # forward: each score read once, each slot written once; backward:
        # p and g read once, dx written once; row_offsets read once
        _bound(t["f"], 4.0 * nz, 8 * nz + pad_b + 4 * (topo.m + 1))
        _bound(t["b"], 4.0 * nz, 12 * nz + 3 * pad_b + 4 * (topo.m + 1))
        for r, tt, err in ((rf, t["f"], err_f), (rb, t["b"], err_b)):
            r["max_abs_err"] = max(r.get("max_abs_err", 0.0), err)
            r.update({k: tt[k] for k in ("ms", "plain_ms", "library_ms",
                                         "bound_ms", "bound_by")})
        del p, dx

    for c in panel:
        mask, nblocks, heads, tag = c["mask"], c["nblocks"], c["heads"], \
            c["tag"]

        def fwd(c=c):
            return K.panel_softmax_kernel(mask, nblocks, c["v"], heads=heads)

        def fwd_plain(c=c):
            return K.masked_softmax_plain(c["v"], mask, heads)

        p = fwd()
        ref = fwd_plain()
        live = (mask != 0).repeat_interleave(heads, 0)
        dead = ~live
        dead[:, 1, :, 5] = True                   # the -inf row
        rf = kres["panel_softmax"]
        err_f = _b5_checks(f"panel_softmax {tag}", fwd, p, ref, ref.abs(),
                           dead)
        rows = p.sum(dim=(-3, -1))
        want = (live.sum(dim=(-3, -1)) > 0).float()
        want[:, 1, 5] = 0.0
        _compare(f"panel_softmax {tag} rows sum to 1 (0 where no slot is "
                 f"live)", rows, want, 1e-5)
        del ref

        def bwd(c=c, p=p):
            return K.panel_softmax_bwd_kernel(p, c["g"])

        def bwd_plain(c=c, p=p):
            return K.masked_softmax_vjp_plain(p, c["g"])

        def rowsum(x):
            return x.sum(dim=(-3, -1), keepdim=True).expand_as(x)

        dx = bwd()
        ref = bwd_plain()
        rb = kres["panel_softmax_bwd"]
        err_b = _b5_checks(f"panel_softmax_bwd {tag}", bwd, dx, ref,
                           ref.abs() + _row_scale(p, c["g"], rowsum),
                           p == 0)
        del ref
        # a NaN cotangent at one masked slot of a row: that row is NaN, as
        # the plain version (and JAX's VJP) has it, every other row holds
        gn = c["g"].clone()
        r0, b0, i0 = 0, 0, 3                      # causal: slot (3, 63) masked
        j0 = int((~live[r0, b0, :, i0]).reshape(-1).nonzero()[-1])
        gn[r0, b0, j0 // gn.shape[-1], i0, j0 % gn.shape[-1]] = float("nan")
        got_n = K.panel_softmax_bwd_kernel(p, gn)
        ref_n = K.masked_softmax_vjp_plain(p, gn)
        if not (torch.isnan(got_n[r0, b0, :, i0]).all()
                and torch.isnan(ref_n[r0, b0, :, i0]).all()):
            _fail(f"panel_softmax_bwd {tag}: a NaN cotangent at a masked "
                  f"slot did not reach its row")
        got_n[r0, b0, :, i0] = 0.0
        ref_n[r0, b0, :, i0] = 0.0
        _compare(f"panel_softmax_bwd {tag}, NaN at a masked slot: the other "
                 f"rows", got_n, ref_n, TOL_KERNEL)
        del got_n, ref_n, gn
        t = {}
        for key, kern, plain in (("f", fwd, fwd_plain), ("b", bwd, bwd_plain)):
            t[key] = {"ms": _graph_ms(kern), "eager": _time_ms(kern),
                      "plain_ms": _graph_ms(plain),
                      "plain_eager": _time_ms(plain)}
            print(f"  panel_softmax{'_bwd' if key == 'b' else ''} {tag}: "
                  f"kernel {t[key]['ms']:.4f} ms (graph replay; eager "
                  f"{t[key]['eager']:.4f}), plain {t[key]['plain_ms']:.4f} "
                  f"ms (graph replay; eager {t[key]['plain_eager']:.4f})",
                  flush=True)
        _team_sweep(f"panel_softmax {tag}", fwd, bwd)
        t["f"]["library_ms"] = _panel_library_ms(
            torch, c, torch.where(torch.isinf(c["v"]), -30.0, c["v"]))
        t["b"]["library_ms"] = _panel_library_ms(torch, c, c["v"],
                                                 (p, c["g"]))
        slots = p.numel()
        tile = mask.shape[-1] * mask.shape[-2]
        present = int(nblocks.sum()) * tile
        # forward: the scores and the mask of the present tiles read once
        # (the mask once per mask, not per head), every slot written once;
        # backward: p and g read once, dx written once
        _bound(t["f"], 4.0 * heads * present,
               4 * heads * present + 4 * present + 4 * slots)
        _bound(t["b"], 4.0 * slots, 12 * slots)
        print(f"    panel_softmax {tag}: {present * heads} slots in present "
              f"tiles of {slots}", flush=True)
        if tag.startswith("(c)"):
            for r, tt, err in ((rf, t["f"], err_f), (rb, t["b"], err_b)):
                r["max_abs_err"] = max(r.get("max_abs_err", 0.0), err)
                r.update({k: tt[k] for k in ("ms", "plain_ms", "library_ms",
                                             "bound_ms", "bound_by")})
        else:
            for r, err in ((rf, err_f), (rb, err_b)):
                r["max_abs_err"] = max(r.get("max_abs_err", 0.0), err)
        del p, dx


def phase_flat_path(stt, torch, dev, wrappers, mat, w):
    """Phases 3f / 4f: the flat op set through its public calls, launches
    counted. (i) ``bench.py``'s flat row: eager ``stt.spmm(topo, values,
    dense)`` at 4096^3 d=0.1, first call and steady state, against the
    panel route, the scatter alone and dense ``torch.matmul``; (ii) the
    reference's attention chain on the flat [32, nnz] layout, hd = 64,
    forward and backward, against a CPU copy under ``set_backend("xla")``,
    and its step on the parent's CSR backward (plain PyTorch) and on B5's
    backward mode in turns (``_softmax_turns``);
    (iii) a csr ``SparseLinear`` (b=4, seq 512, 768 -> 3072, bias, d=0.1)
    against the panel layer with the same weights and its CPU copy. Phase
    3g: the dynamic sparse training examples at their default sizes."""
    from sputnik_tpu_torch.examples import (dynamic_sparse_training,
                                            train_block_sparse)
    from sputnik_tpu_torch.models import SparseLinear
    from sputnik_tpu_torch.ops import dispatch, plain_ops
    from sputnik_tpu_torch.ops import panel_api as P
    from sputnik_tpu_torch.patterns import uniform_mask

    total = {n: 0 for n in wrappers}
    size = w.shape[0]
    print(f"phase 3f: the flat op set — (i) stt.spmm {size}^3 d=0.1 with "
          f"CSR values per call; (ii) the attention chain on [32, nnz]; "
          f"(iii) a csr SparseLinear", flush=True)
    # a fresh topology object: the first call builds its panel spec
    mt = mat.topology
    topo = stt.SparseTopology(mt.m, mt.n, mt.row_offsets, mt.column_indices)
    values = torch.from_numpy(mat.values).to(dev)
    rng = np.random.RandomState(61)
    dense = torch.from_numpy(rng.randn(size, size).astype(np.float32)).to(dev)
    host = []

    def call():
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = stt.spmm(topo, values, dense)
        torch.cuda.synchronize()
        host.append((time.perf_counter() - t0) * 1e3)
        return out

    out = _counted(wrappers, total, "flat spmm, first call", call,
                   {"bsr_spmm_panel": 1})
    _counted(wrappers, total, "flat spmm, second call", call,
             {"bsr_spmm_panel": 1})
    a_dense = torch.from_numpy(w).to(dev)
    _compare(f"flat spmm {size}^3 vs torch.matmul of the densified A", out,
             a_dense @ dense, TOL_MODEL)
    spec = dispatch.flat_spec(topo)
    panel = dispatch.to_panel(spec, values)
    ms = {"flat": _time_ms(lambda: stt.spmm(topo, values, dense), reps=5,
                           inner=5),
          "panel": _time_ms(lambda: P.spmm(spec, panel, dense), reps=5,
                            inner=5),
          "scatter": _time_ms(lambda: dispatch.to_panel(spec, values)),
          "dense": _time_ms(lambda: a_dense @ dense, reps=5, inner=5)}
    print(f"  flat spmm: first call {host[0]:.1f} ms (host clock; builds the "
          f"64x64 panel spec and the device index maps), second "
          f"{host[1]:.4f} ms; steady {ms['flat']:.4f} ms vs the panel route "
          f"{ms['panel']:.4f} ms (B1 alone), the values -> panel scatter "
          f"alone {ms['scatter']:.4f} ms = {ms['scatter'] / ms['flat']:.2%} "
          f"of the steady call; dense fp32 torch.matmul {ms['dense']:.4f} ms",
          flush=True)
    del panel, out, a_dense, dense

    # (ii) the attention chain: sddmm -> scale -> sparse_softmax -> spmm
    R, s, hd = 32, 512, 64
    ta = stt.SparseTopology.from_dense_mask(_attention_mask())
    cpu = [torch.from_numpy(rng.randn(R, s, hd).astype(np.float32)
                            ).requires_grad_() for _ in range(3)]
    gpu = [x.detach().to(dev).requires_grad_() for x in cpu]

    def chain(q, k, v):
        p = stt.sparse_softmax(ta, stt.sddmm(ta, q, k) * hd ** -0.5)
        return stt.spmm(ta, p, v)

    def step():
        for x in gpu:
            x.grad = None
        out = chain(*gpu)
        out.sum().backward()
        return out

    # forward B4 + B5 + B1; backward: spmm's B4 + B3, B5's backward mode,
    # sddmm's B1 + B3
    out = _counted(wrappers, total, "flat attention chain, forward + "
                   "backward", step, {"bsr_sddmm_panel": 2, "ell_softmax": 1,
                                      "ell_softmax_bwd": 1,
                                      "panel_softmax": 0,
                                      "panel_softmax_bwd": 0,
                                      "bsr_spmm_panel": 2,
                                      "bsr_spmm_t_panel": 2})
    grads = [x.grad.cpu() for x in gpu]
    chain_ms = _step_times(torch, step, 10)
    print(f"  flat chain step (R={R}, s={s}, hd={hd}): median "
          f"{statistics.median(chain_ms):.4f} ms, min {min(chain_ms):.4f}, "
          f"max {max(chain_ms):.4f} (host clock, synchronized)", flush=True)
    try:
        _profile_steps(torch, "flat chain steps", lambda i: step())
    except Exception as e:  # a measurement, not a check of the path
        print(f"  torch.profiler gave no device times: {e!r}", flush=True)

    @contextlib.contextmanager
    def parent():
        # the parent's backward: plain_ops.softmax_vjp (its forward kernel
        # is gone: both routes run B5's forward mode)
        keep = dispatch.ell_softmax_bwd_kernel

        def vjp(row_offsets, row_ids, p, g, *, nnz):
            with torch.profiler.record_function("B5 softmax"):
                return plain_ops.softmax_vjp(p, g, row_ids,
                                             row_offsets.numel() - 1)

        dispatch.ell_softmax_bwd_kernel = vjp
        try:
            yield
        finally:
            dispatch.ell_softmax_bwd_kernel = keep

    print("  flat chain step: B5's routes in turns (parent: the plain CSR "
          "backward; B5: its backward mode)", flush=True)
    _softmax_turns(torch, "flat chain step", step,
                   {"parent": parent, "B5": contextlib.nullcontext})

    # (iii) a csr SparseLinear and the panel layer with the same weights
    lt = stt.SparseTopology.from_dense_mask(
        uniform_mask(3072, 768, sparsity=0.9, seed=5))
    cpu_lin = SparseLinear(lt, layout="csr",
                           generator=torch.Generator().manual_seed(62))
    with torch.no_grad():
        cpu_lin.bias.copy_(torch.from_numpy(rng.randn(3072).astype(
            np.float32)))
    lin = copy.deepcopy(cpu_lin).to(dev)
    pan = SparseLinear(lt).to(dev)
    with torch.no_grad():
        pan.values.copy_(torch.from_numpy(pan.pack_dense(
            cpu_lin.unpack_dense(cpu_lin.values))))
        pan.bias.copy_(cpu_lin.bias)
    x = torch.from_numpy(rng.randn(4, 512, 768).astype(np.float32))
    cot = torch.from_numpy(rng.randn(4, 512, 3072).astype(np.float32))
    xs = {k: x.to(dev).clone().requires_grad_() for k in ("csr", "panel")}

    def lin_step(layer, xd):
        y = layer(xd)
        (y * cot.to(dev)).sum().backward()
        return y

    y = _counted(wrappers, total, "csr SparseLinear forward + backward",
                 lambda: lin_step(lin, xs["csr"]),
                 {"bsr_spmm_panel": 1, "bsr_sddmm_panel": 1,
                  "bsr_spmm_t_panel": 1})
    y_pan = lin_step(pan, xs["panel"])

    print("phase 4f: the flat path vs the CPU (chain under "
          "set_backend('xla'); csr SparseLinear on the panel route's plain "
          "versions) and the panel layer", flush=True)
    t0 = time.perf_counter()
    stt.set_backend("xla")
    try:
        ref = chain(*cpu)
        ref.sum().backward()
    finally:
        stt.set_backend("auto")
    _compare("flat chain output", out.detach().cpu(), ref.detach(), TOL_MODEL)
    if not torch.all(out[:, 37] == 0):
        _fail("flat chain: the emptied row's output is not exactly 0")
    for name, got, x_ in zip("qkv", grads, cpu):
        _compare(f"flat chain d{name}", got, x_.grad, TOL_MODEL)
    _compare("csr SparseLinear vs the panel layer (card)", y.detach(),
             y_pan.detach(), TOL_MODEL)
    _compare("csr SparseLinear input grad vs the panel layer (card)",
             xs["csr"].grad, xs["panel"].grad, TOL_MODEL)
    _compare("csr SparseLinear values grad vs the panel layer (card)",
             lin.values.grad.cpu(),
             torch.from_numpy(pan.to_csr(pan.values.grad)), TOL_MODEL)
    xc = x.detach().clone().requires_grad_()
    stt.set_backend("pallas")
    try:
        y_cpu = cpu_lin(xc)
        (y_cpu * cot).sum().backward()
    finally:
        stt.set_backend("auto")
    _compare("csr SparseLinear vs its CPU copy", y.detach().cpu(),
             y_cpu.detach(), TOL_MODEL)
    _compare("csr SparseLinear values grad vs its CPU copy",
             lin.values.grad.cpu(), cpu_lin.values.grad, TOL_MODEL)
    _compare("csr SparseLinear bias grad vs its CPU copy",
             lin.bias.grad.cpu(), cpu_lin.bias.grad, TOL_MODEL)
    _compare("csr SparseLinear input grad vs its CPU copy",
             xs["csr"].grad.cpu(), xc.grad, TOL_MODEL)
    print(f"  CPU references in {time.perf_counter() - t0:.1f} s",
          flush=True)

    print("phase 3g: dynamic sparse training — dynamic_sparse_training.py "
          "(csr, panel) and train_block_sparse.py at their default sizes",
          flush=True)
    runs = [(f"dynamic_sparse_training --layout {lay}",
             lambda lay=lay: dynamic_sparse_training.main(["--layout", lay]))
            for lay in ("csr", "panel")]
    runs.append(("train_block_sparse", lambda: train_block_sparse.main([])))
    for label, fn in runs:
        before = dict(total)
        res = _counted(wrappers, total, label, fn, {})
        # the forward and the values' gradient (the inputs need none)
        for n in ("bsr_spmm_panel", "bsr_sddmm_panel"):
            if total[n] == before[n]:
                _fail(f"{label}: kernel {n} was not launched")
        print(f"  {label}: {res}", flush=True)
    return total


# -- the int8 serving family (B16a, B16b, B17, B18a) -------------------------


def _int8_distance(name, plain, fp32):
    """The plain int8 result's distance from the fp32 kernel's on the same
    inputs must be >= 10x the kernel limit: a kernel that skipped a
    quantisation would then fail its own check."""
    lim = TOL_KERNEL * max(1.0, plain.abs().max().item())
    dist = (plain.float() - fp32.float()).abs().max().item()
    print(f"  {name}: plain int8 vs fp32 max distance {dist:.3e} = "
          f"{dist / lim:.1f}x the kernel limit {lim:.3e}", flush=True)
    if not dist >= 10 * lim:
        _fail(f"{name}: int8 is within 10x the kernel limit of fp32")


def _dense_codes(torch, topo, values_q):
    """The int8 panel's codes scattered into a dense int8 matrix (the
    library yardstick's operand)."""
    from sputnik_tpu_torch.ops import panel_api as P

    bm, bk = values_q.shape[2:]
    vals = P.panel_to_values_np(topo, values_q.cpu().numpy(), bm, bk)
    a = np.zeros((topo.m, topo.n), np.int8)
    nnz = topo.nnz
    a[topo.row_ids[:nnz], topo.column_indices[:nnz]] = vals[:nnz]
    return torch.from_numpy(a).to(values_q.device)


def _int8_flash_case(stt, torch, dev, r, label, masks, heads, hd, seed,
                     timed):
    """B18a against its plain version and B9 on one problem; ``timed``
    fills the JSON entry ``r`` (ms, plain, library, bound)."""
    import torch.nn.functional as F

    from sputnik_tpu_torch.ops.kernels import flash_sparse_int8 as f8
    from sputnik_tpu_torch.ops.kernels.flash_sparse import (
        flash_sparse_attention_fwd)

    b, s = masks.shape[0], masks.shape[1]
    spec = stt.BatchedPanelSpec.from_many_mask(
        stt.ManyMaskTopology.from_dense_masks(masks), heads=heads)
    fm = spec.flash_meta(dev)
    rng = np.random.RandomState(seed)
    q, k, v = (torch.from_numpy(rng.randn(b * heads, s, hd).astype(
        np.float32)).to(dev) for _ in range(3))
    args = (fm["block_cols"], fm["nblocks"], fm["mask_slot"],
            fm["is_partial"], fm["pmask"], q, k, v)
    kw = dict(heads=heads, max_bpr=fm["max_bpr"], scale=hd ** -0.5)
    out, m, l = f8.flash_sparse_attention_fwd_int8(*args, **kw)
    ref, m_ref, l_ref = f8.flash_sparse_attention_fwd_int8_plain(*args, **kw)
    _compare(f"flash int8 {label}", out, ref, TOL_KERNEL, r)
    _compare(f"flash int8 {label} row denominators l", l, l_ref, TOL_KERNEL)
    n_diff = int(((out - ref).abs() > 1e-6).sum().item())
    print(f"  flash int8 {label}: {n_diff} of {out.numel()} outputs differ "
          f"from plain by more than 1e-6", flush=True)
    empty = torch.from_numpy(masks.sum(-1) == 0).to(dev).repeat_interleave(
        heads, 0)
    if not torch.all(out[empty] == 0):
        _fail(f"flash int8 {label}: a fully-masked row is not exactly 0")
    fp32, _, _ = flash_sparse_attention_fwd(*args, **kw)
    _int8_distance(f"flash int8 {label}", ref, fp32)
    again = f8.flash_sparse_attention_fwd_int8(*args, **kw)
    if not all(torch.equal(a.view(torch.int32), b_.view(torch.int32))
               for a, b_ in zip((out, m, l), again)):
        _fail(f"flash int8 {label}: two calls differ in their bits")
    if not timed:
        return
    def kern():
        return f8.flash_sparse_attention_fwd_int8(*args, **kw)

    r["ms"], eager_ms = _graph_ms(kern), _time_ms(kern)
    r["plain_ms"] = _time_ms(
        lambda: f8.flash_sparse_attention_fwd_int8_plain(*args, **kw),
        reps=3, inner=2)
    fp32_ms = _graph_ms(lambda: flash_sparse_attention_fwd(*args, **kw))
    mask = torch.from_numpy(masks != 0).to(dev)[:, None]
    q4, k4, v4 = (x.reshape(b, heads, s, hd) for x in (q, k, v))
    r["library_ms"] = _library_ms(
        "flash int8 (F.scaled_dot_product_attention, f32, bool mask)",
        lambda: F.scaled_dot_product_attention(q4, k4, v4, attn_mask=mask,
                                               scale=hd ** -0.5),
        timer=_graph_ms)
    qb, kb_, vb = (x.bfloat16() for x in (q4, k4, v4))
    bf16_ms = _library_ms(
        "flash int8 (F.scaled_dot_product_attention, bf16, bool mask)",
        lambda: F.scaled_dot_product_attention(qb, kb_, vb, attn_mask=mask,
                                               scale=hd ** -0.5),
        timer=_graph_ms)
    print(f"  flash int8 {label}: kernel {r['ms']:.4f} ms (graph; eager "
          f"{eager_ms:.4f}), fp32 B9 {fp32_ms:.4f} ms, plain "
          f"{r['plain_ms']:.4f} ms, SDPA bf16 {bf16_ms} ms; device split "
          f"{_split_text(_device_split(torch, kern))}", flush=True)
    pairs = float((masks != 0).sum()) * heads
    _bound(r, 4.0 * pairs * hd, _nbytes(*args[:5], q, k, v, out, m, l),
           PEAK_INT8)


def _int8_flash_bwd_case(stt, torch, dev, kres, label, masks, heads, hd,
                         seed, timed):
    """B18b and B18c against their plain versions and the fp32 B10b / B10c
    on one problem (the int8 forward's out, m and l, D = rowsum(g * out));
    ``timed`` fills their JSON entries (ms, plain, library, bound)."""
    import torch.nn.functional as F

    from sputnik_tpu_torch.ops.kernels import flash_sparse as fs
    from sputnik_tpu_torch.ops.kernels import flash_sparse_int8 as f8

    b, s = masks.shape[0], masks.shape[1]
    spec = stt.BatchedPanelSpec.from_many_mask(
        stt.ManyMaskTopology.from_dense_masks(masks), heads=heads)
    fm, bm = spec.flash_meta(dev), spec.flash_bwd_meta(dev)
    rng = np.random.RandomState(seed)
    q, k, v, g = (torch.from_numpy(rng.randn(b * heads, s, hd).astype(
        np.float32)).to(dev) for _ in range(4))
    kw = dict(heads=heads, scale=hd ** -0.5)
    out, m, l = f8.flash_sparse_attention_fwd_int8(
        fm["block_cols"], fm["nblocks"], fm["mask_slot"], fm["is_partial"],
        fm["pmask"], q, k, v, max_bpr=fm["max_bpr"], **kw)
    D = (g * out).sum(-1)
    ops = (q, k, v, g, m, l, D)
    rows = (fm["block_cols"], fm["nblocks"], fm["mask_slot"],
            fm["is_partial"], fm["pmask"], *ops)
    cols = (bm["t_src_i"], bm["t_nblocks"], bm["t_mask_slot"],
            bm["t_is_partial"], bm["pmask"], *ops)
    rkw, ckw = dict(kw, max_bpr=fm["max_bpr"]), dict(kw, max_bpc=bm["max_bpc"])
    calls = {
        "flash_sparse_bwd_dq_int8": (
            ("dq",), lambda: (f8.flash_sparse_bwd_dq_int8(*rows, **rkw),),
            lambda: (f8.flash_sparse_bwd_dq_int8_plain(*rows, **rkw),),
            lambda: (fs.flash_sparse_bwd_dq(*rows, **rkw),)),
        "flash_sparse_bwd_dkv_int8": (
            ("dk", "dv"), lambda: f8.flash_sparse_bwd_dkv_int8(*cols, **ckw),
            lambda: f8.flash_sparse_bwd_dkv_int8_plain(*cols, **ckw),
            lambda: fs.flash_sparse_bwd_dkv(*cols, **ckw))}
    for name, (parts, kern, plain, fp32) in calls.items():
        for part, got, ref, f32 in zip(parts, kern(), plain(), fp32()):
            tag = f"{name} {part} {label}"
            _compare(tag, got, ref, TOL_KERNEL, kres[name])
            n_diff = int(((got - ref).abs() > 1e-6 * ref.abs().max()).sum())
            print(f"  {tag}: {n_diff} of {got.numel()} entries differ from "
                  f"plain by more than 1e-6 x max|plain|", flush=True)
            _int8_distance(tag, ref, f32)
    empty = torch.from_numpy(masks.sum(-1) == 0).to(dev).repeat_interleave(
        heads, 0)
    if not torch.all(calls["flash_sparse_bwd_dq_int8"][1]()[0][empty] == 0):
        _fail(f"flash int8 dq {label}: a fully-masked row is not exactly 0")
    if not timed:
        return
    mask = torch.from_numpy(masks != 0).to(dev)[:, None]

    def sdpa_bwd(dtype):
        q4, k4, v4 = (x.reshape(b, heads, s, hd).to(dtype).requires_grad_()
                      for x in (q, k, v))
        o = F.scaled_dot_product_attention(q4, k4, v4, attn_mask=mask,
                                           scale=hd ** -0.5)
        g4 = g.reshape(b, heads, s, hd).to(dtype)
        return lambda: torch.autograd.grad(o, (q4, k4, v4), g4,
                                           retain_graph=True)

    lib = _library_ms("flash int8 backward (the backward of "
                      "F.scaled_dot_product_attention, f32, bool mask: dq, "
                      "dk, dv)", sdpa_bwd(torch.float32))
    bf16_ms = _library_ms("flash int8 backward (SDPA backward, bf16, bool "
                          "mask)", sdpa_bwd(torch.bfloat16))
    pairs = float((masks != 0).sum()) * heads
    # per kept pair and head dim: QK^T and GV^T recomputed, then dS K (dq);
    # dS^T Q and P^T G (dk, dv)
    work = {"flash_sparse_bwd_dq_int8": (6, rows),
            "flash_sparse_bwd_dkv_int8": (8, cols)}
    for name, (parts, kern, plain, fp32) in calls.items():
        r = kres[name]
        # each a pre-pass + a wgmma walk: by CUDA graph replay, eager beside
        first = kern()
        if not all(torch.equal(a.view(torch.int32), b_.view(torch.int32))
                   for a, b_ in zip(first, kern())):
            _fail(f"{name} {label}: two calls differ in their bits")
        del first
        eager = _time_ms(kern)
        r["ms"] = _graph_ms(kern)
        r["plain_ms"] = _time_ms(plain, reps=3, inner=2)
        r["library_ms"] = lib
        f32_ms = _time_ms(fp32)
        print(f"  {name} {label}: kernel {r['ms']:.4f} ms (graph; eager "
              f"{eager:.4f}; the same bits twice; device split "
              f"{_split_text(_device_split(torch, kern))}), fp32 "
              f"{'B10b' if len(parts) == 1 else 'B10c'} {f32_ms:.4f} ms, "
              f"plain {r['plain_ms']:.4f} ms, SDPA backward f32 {lib} ms, "
              f"bf16 {bf16_ms} ms", flush=True)
        per, args = work[name]
        _bound(r, per * pairs * hd, _nbytes(*args[:5], *ops, *kern()),
               PEAK_INT8)


def _device_split(torch, fn, n=8):
    """Device milliseconds per ``fn()`` call of each kernel it launches
    (torch.profiler), by kernel name."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(n):
            fn()
        torch.cuda.synchronize()
    return {e.key: getattr(e, "device_time_total", 0.0) / 1e3 / n
            for e in prof.key_averages()
            if getattr(e, "device_type", None) is not None
            and str(e.device_type).endswith("CUDA")}


def _int8_spmm_case(torch, r, label, kern, plain, lib_label, lib, nblocks,
                    tile_rows, flops, nbytes):
    """B16a or B16b on one problem: against its plain version, the same bits
    from two calls, a block of the walk emptied (``kern(nblocks)`` with
    block 1's count 0: its rows exactly 0, every other row the same bits);
    timed by CUDA graph replay beside ``lib`` timed the same way (eager
    times beside them), the pre-pass / product split from torch.profiler,
    and the bound."""
    got, ref = kern(), plain()
    _compare(label, got, ref, TOL_KERNEL, r)
    if not torch.equal(got.view(torch.int32), kern().view(torch.int32)):
        _fail(f"{label}: two calls gave different bits")
    nb = nblocks.clone()
    nb[1] = 0
    emptied = kern(nb)
    rows = slice(tile_rows, 2 * tile_rows)
    if not torch.all(emptied[rows] == 0):
        _fail(f"{label}: an empty walk block is not exactly 0")
    emptied[rows] = got[rows]
    if not torch.equal(emptied.view(torch.int32), got.view(torch.int32)):
        _fail(f"{label}: emptying one walk block moved the others")
    print(f"  {label}: the same bits twice; an emptied block exactly 0",
          flush=True)
    del got, ref, emptied
    r["ms"] = _graph_ms(kern)
    eager_ms = _time_ms(kern)
    r["plain_ms"] = _time_ms(plain, reps=3, inner=2)
    r["library_ms"] = _library_ms(f"{label} ({lib_label})", lib,
                                  timer=_graph_ms)
    lib_eager = _library_ms(f"{label} ({lib_label}), eager calls", lib)
    split = _device_split(torch, kern)
    pre = sum(t for k, t in split.items()
              if "absmax" in k or "pack_kmajor" in k or "emset" in k)
    prod = sum(t for k, t in split.items() if "spmm_int8_wgmma" in k)
    trans = sum(t for k, t in split.items() if "transpose_tiles" in k)
    lib = "failed" if r["library_ms"] is None else f"{r['library_ms']:.4f}"
    lib_e = "failed" if lib_eager is None else f"{lib_eager:.4f}"
    print(f"  {label}: kernel {r['ms']:.4f} ms (graph; eager "
          f"{eager_ms:.4f}), plain {r['plain_ms']:.4f} ms, torch._int_mm "
          f"{lib} ms (graph; eager {lib_e}); profiler: pre-pass {pre:.4f} "
          f"ms, transpose {trans:.4f} ms, product {prod:.4f} ms", flush=True)
    for k, t in sorted(split.items(), key=lambda x: -x[1]):
        print(f"    {t:.4f} ms/call  {k[:90]}", flush=True)
    _bound(r, flops, nbytes, PEAK_INT8)


def _int8_serving_spmm(torch, dev, k8):
    """B16a / B16b at the int8 serving weight's shape (1024^2 at 128 x 128,
    an activation [1024, 2048], bn = bq = 512), each against its plain
    version, the same bits twice, timed beside ``torch._int_mm``."""
    from sputnik_tpu_torch.examples import serve_sparse_int8 as ex8
    from sputnik_tpu_torch.ops.int8_api import _tile_width

    ex = ex8.setup(False, dev)
    spec, qp = ex["spec"], ex["qp"]
    h, s = ex["h"], ex["s"]
    meta, topo = spec.meta(dev), spec.topo
    bn = _tile_width(spec, s)
    rng = np.random.RandomState(76)
    x = torch.from_numpy(rng.randn(h, s).astype(np.float32)).to(dev)
    a_q = _dense_codes(torch, topo, qp.values_q)
    a_qt = a_q.T.contiguous()
    need = 5 * topo.nnz + _nbytes(x) + h * s * 4
    args = (meta["block_cols"], qp.values_q, qp.scales)
    _int8_spmm_case(torch, {}, f"spmm int8 serving {h}^2 at 128x128, "
                    f"N={s} bn={bn}",
                    lambda nb=meta["nblocks"]: k8.bsr_spmm_panel_int8(
                        args[0], nb, *args[1:], x, rows=h, bn=bn),
                    lambda: k8.bsr_spmm_panel_int8_plain(
                        args[0], meta["nblocks"], *args[1:], x, rows=h,
                        bn=bn),
                    "torch._int_mm, densified A_q",
                    lambda d=k8.quant_tile(x, spec.bk, bn)[0]:
                    torch._int_mm(a_q, d), meta["nblocks"], spec.bm,
                    2.0 * topo.nnz * s, need)
    targs = (meta["t_src_i"], meta["t_src_s"])
    _int8_spmm_case(torch, {}, f"spmm_t int8 serving {h}^2 at 128x128, "
                    f"Q={s} bq={bn}",
                    lambda nb=meta["t_nblocks"]: k8.bsr_spmm_t_panel_int8(
                        *targs, nb, qp.values_q, qp.scales, x, rows=h,
                        bq=bn),
                    lambda: k8.bsr_spmm_t_panel_int8_plain(
                        *targs, meta["t_nblocks"], qp.values_q, qp.scales, x,
                        rows=h, bq=bn),
                    "torch._int_mm, densified A_q^T",
                    lambda g=k8.quant_tile(x, spec.bm, bn)[0]:
                    torch._int_mm(a_qt, g), meta["t_nblocks"], spec.bk,
                    2.0 * topo.nnz * s, need)


_SASS = {}   # the built library's SASS counts, read once


def _sass_counts(build):
    """Per kernel of the built library (cuobjdump -sass), the count of
    instructions whose opcode starts with each of _SASS_OPS; None (printed)
    where the toolkit has no cuobjdump."""
    import os
    import shutil

    if "funcs" in _SASS:
        return _SASS["funcs"]
    tool = shutil.which("cuobjdump") or os.path.join(
        os.environ.get("CUDA_HOME", "/usr/local/cuda"), "bin", "cuobjdump")
    if not os.path.exists(tool):
        print("  SASS: cuobjdump not found, not checked", flush=True)
        _SASS["funcs"] = None
        return None
    sass = subprocess.run([tool, "-sass", str(build._so_path())],
                          capture_output=True, text=True, timeout=300,
                          check=True).stdout
    funcs, name = {}, None
    for line in sass.splitlines():
        if "Function :" in line:
            name = line.split("Function :")[1].strip()
            funcs[name] = dict.fromkeys(_SASS_OPS, 0)
        elif name is not None:
            parts = line.split("*/")
            op = parts[1].split() if len(parts) > 1 else []
            for key in funcs[name]:
                funcs[name][key] += any(w.startswith(key) for w in op[:2])
    _SASS["funcs"] = funcs
    return funcs


_SASS_OPS = ("IGMMA", "IMMA", "IDP.4A", "HGMMA", "HMMA", "FFMA")


def _sass_print(funcs, keys):
    for n, c in funcs:
        print(f"  SASS {n[:70]}: " + ", ".join(f"{c[k]} {k}" for k in keys),
              flush=True)


def _sass_check(k8_build):
    """The int8 panel product kernels' SASS (B16a / B16b:
    spmm_int8_wgmma_kernel; B17: sddmm_int8_wgmma_kernel, every depth
    instantiation): int8 tensor-core instructions (IGMMA, wgmma's; IMMA,
    mma.sync's) in each, IDP.4A (__dp4a) in none. Raises if one fails
    it."""
    funcs = _sass_counts(k8_build)
    if funcs is None:
        return
    prods = {n: c for n, c in funcs.items() if "spmm_int8_wgmma" in n}
    sdd = {n: c for n, c in funcs.items() if "sddmm_int8_wgmma" in n}
    _sass_print(sorted(prods.items()) + sorted(sdd.items()),
                ("IGMMA", "IMMA", "IDP.4A"))
    for label, fs in (("B16a / B16b", prods), ("B17", sdd)):
        if not fs or any(c["IGMMA"] + c["IMMA"] == 0 or c["IDP.4A"]
                         for c in fs.values()):
            _fail(f"SASS: the int8 product kernels ({label}) do not run on "
                  f"the int8 tensor cores alone")


def _sass_check_flash(build):
    """The fp32 flash bodies (flash_tc_kernel: B9, B11a; flash_bwd_tc_kernel:
    B10a, B10b, B11b; every width and mode) hold TF32 tensor-core
    instructions (HGMMA; FFMA stays allowed: the softmax and the split use
    it), and B18a's and B18c's walks (flash_int8_wgmma_kernel,
    flash_bwd_dkv_int8_wgmma_kernel) int8 ones (IGMMA) and no IDP.4A
    (__dp4a). Raises if one fails it."""
    funcs = _sass_counts(build)
    if funcs is None:
        return
    fp = {n: c for n, c in funcs.items() if "flash_tc_kernel" in n}
    i8 = {n: c for n, c in funcs.items() if "flash_int8_wgmma_kernel" in n}
    _sass_print(sorted(fp.items()) + sorted(i8.items()),
                ("HGMMA", "IGMMA", "IDP.4A", "FFMA"))
    if not fp or any(c["HGMMA"] == 0 for c in fp.values()):
        _fail("SASS: the fp32 flash forward body does not run on the tensor "
              "cores")
    if not i8 or any(c["IGMMA"] == 0 or c["IDP.4A"] for c in i8.values()):
        _fail("SASS: B18a's walk does not run on the int8 tensor cores "
              "alone")
    # the backward: the row walk (B10a, B10b, B11b: flash_bwd_tc_kernel,
    # every width and mode) on the TF32 tensor cores; B18b's row walk and
    # B18c's column walk on the int8 ones and no __dp4a
    bw = {n: c for n, c in funcs.items() if "flash_bwd_tc_kernel" in n}
    b8 = {n: c for n, c in funcs.items()
          if "flash_bwd_dkv_int8_wgmma_kernel" in n}
    q8 = {n: c for n, c in funcs.items()
          if "flash_bwd_dq_int8_wgmma_kernel" in n}
    _sass_print(sorted(bw.items()) + sorted(q8.items()) + sorted(b8.items()),
                ("HGMMA", "IGMMA", "IDP.4A", "FFMA"))
    if not bw or any(c["HGMMA"] == 0 for c in bw.values()):
        _fail("SASS: the flash backward's row walk does not run on the "
              "tensor cores")
    for label, fs in (("B18b", q8), ("B18c", b8)):
        if not fs or any(c["IGMMA"] == 0 or c["IDP.4A"] for c in fs.values()):
            _fail(f"SASS: {label} does not run on the int8 tensor cores "
                  f"alone")


def _sass_check_tc(build):
    """The fp32 SpMM bodies' SASS (spmm_tc_kernel: B1, B2, B6, B13a;
    spmm_t_tc_kernel: B3, B8, B13b, every address policy and width): TF32
    tensor-core instructions (HMMA, mma.sync's; HGMMA, wgmma's) in each,
    and no FFMA (the SIMT body's inner loop). Raises if one fails it."""
    funcs = _sass_counts(build)
    if funcs is None:
        return
    tc = {n: c for n, c in funcs.items()
          if "spmm_tc_kernel" in n or "spmm_t_tc_kernel" in n}
    _sass_print(sorted(tc.items()), ("HGMMA", "HMMA", "FFMA"))
    if not tc or any(c["HGMMA"] + c["HMMA"] == 0 or c["FFMA"]
                     for c in tc.values()):
        _fail("SASS: the fp32 SpMM bodies do not run on the tensor cores "
              "alone")


def _sass_check_sddmm_col(build):
    """The SDDMM body (sddmm_tc_kernel: B4, B7, B14, both slot policies) and
    the column walk (flash_bwd_col_tc_kernel: B10c, every width and mode)
    hold TF32 tensor-core instructions (HGMMA) and no FFMA: their products
    run on the tensor cores alone (the FMA bodies they replace were FFMA
    loops). Raises if one fails it."""
    funcs = _sass_counts(build)
    if funcs is None:
        return
    tc = {n: c for n, c in funcs.items()
          if "sddmm_tc_kernel" in n or "flash_bwd_col_tc_kernel" in n}
    _sass_print(sorted(tc.items()), ("HGMMA", "HMMA", "FFMA"))
    if len(tc) < 6 or any(c["HGMMA"] == 0 or c["FFMA"] for c in tc.values()):
        _fail("SASS: the SDDMM body or the column walk does not run on the "
              "tensor cores alone")


def phase_int8_kernels(stt, torch, dev, kres, w, mat):
    """Phase 2h: B16a, B16b, B17 and B18a against their plain versions on
    the card, each also held >= 10x its limit away from the fp32 kernel."""
    from sputnik_tpu_torch import int8
    from sputnik_tpu_torch.ops import panel_api as P
    from sputnik_tpu_torch.ops.int8_api import _tile_width
    from sputnik_tpu_torch.ops.kernels import _build
    from sputnik_tpu_torch.ops.kernels import bsr_spmm_int8 as k8
    from sputnik_tpu_torch.ops.kernels.bsr_sddmm import bsr_sddmm_panel
    from sputnik_tpu_torch.ops.kernels.bsr_spmm import bsr_spmm_panel
    from sputnik_tpu_torch.ops.kernels.bsr_spmm_t import bsr_spmm_t_panel
    from sputnik_tpu_torch.patterns import driver_masks

    print("phase 2h: int8 kernels (B16a, B16b, B17, B18a, B18b, B18c) vs "
          "plain PyTorch on the card", flush=True)
    _sass_check(_build)
    size, topo = w.shape[0], mat.topology
    spec = P.PanelSpec(topo)
    bn = _tile_width(spec, size)    # JAX's width rule: 1024 at 4096 columns
    panel_np = P.values_to_panel_np(topo, mat.values, spec.bm, spec.bk)
    qp = int8.quantize_panel(spec, panel_np).to(dev)
    panel = torch.from_numpy(panel_np).to(dev)
    meta = spec.meta(dev)
    nnz = topo.nnz
    rng = np.random.RandomState(70)
    dense = torch.from_numpy(rng.randn(size, size).astype(np.float32)).to(dev)
    a_q = _dense_codes(torch, topo, qp.values_q)
    a_f = torch.from_numpy(w).to(dev)

    # B16a / B16b at bench.py's 4096^3, 64 x 64 panel, bn = bq = 1024 (the
    # JSON entries), then at the int8 serving weight's shape
    targs = (meta["t_src_i"], meta["t_src_s"], meta["t_nblocks"],
             qp.values_q, qp.scales)
    args = (meta["block_cols"], meta["nblocks"], qp.values_q, qp.scales)
    d_q = k8.quant_tile(dense, spec.bk, bn)[0]
    g_q = k8.quant_tile(dense, spec.bm, bn)[0]
    a_qt = a_q.T.contiguous()
    need = 5 * nnz + _nbytes(dense) + size * size * 4
    _int8_spmm_case(torch, kres["bsr_spmm_panel_int8"],
                    f"spmm int8 {size}^3 bn={bn}",
                    lambda nb=meta["nblocks"]: k8.bsr_spmm_panel_int8(
                        meta["block_cols"], nb, *args[2:], dense, rows=size,
                        bn=bn),
                    lambda: k8.bsr_spmm_panel_int8_plain(*args, dense,
                                                         rows=size, bn=bn),
                    "torch._int_mm: densified int8 A x int8 dense -> int32, "
                    "cuBLASLt, no per-tile rescale",
                    lambda: torch._int_mm(a_q, d_q),
                    meta["nblocks"], spec.bm, 2.0 * nnz * size, need)
    _int8_distance("spmm int8", k8.bsr_spmm_panel_int8_plain(
        *args, dense, rows=size, bn=bn), bsr_spmm_panel(
        meta["block_cols"], meta["nblocks"], panel[None], dense[None],
        rows=size)[0])
    f32_ms = _graph_ms(lambda: a_f @ dense)
    print(f"  dense fp32 torch.matmul {size}^3: {f32_ms:.4f} ms (graph)",
          flush=True)
    _int8_spmm_case(torch, kres["bsr_spmm_t_panel_int8"],
                    f"spmm_t int8 {size}^3 bq={bn}",
                    lambda nb=meta["t_nblocks"]: k8.bsr_spmm_t_panel_int8(
                        *targs[:2], nb, *targs[3:], dense, rows=size, bq=bn),
                    lambda: k8.bsr_spmm_t_panel_int8_plain(
                        *targs, dense, rows=size, bq=bn),
                    "torch._int_mm: densified A_q^T x int8 G",
                    lambda: torch._int_mm(a_qt, g_q),
                    meta["t_nblocks"], spec.bk, 2.0 * nnz * size, need)
    _int8_distance("spmm_t int8", k8.bsr_spmm_t_panel_int8_plain(
        *targs, dense, rows=size, bq=bn), bsr_spmm_t_panel(
        meta["t_src_i"], meta["t_src_s"], meta["t_nblocks"], panel[None],
        dense[None], rows=size)[0])
    f32_ms = _graph_ms(lambda: a_f.T @ dense)
    print(f"  dense fp32 a.T @ G {size}^3: {f32_ms:.4f} ms (graph)",
          flush=True)
    del dense, a_q, a_qt, a_f, d_q, g_q
    _int8_serving_spmm(torch, dev, k8)

    # B17 at B4's shape: 4096^2 d=0.1, dim 64 (one 128-deep chunk)
    r = kres["bsr_sddmm_panel_int8"]
    d = 64
    lhs = torch.from_numpy(rng.randn(size, d).astype(np.float32)).to(dev)
    rhs = torch.from_numpy(rng.randn(size, d).astype(np.float32)).to(dev)
    sargs = (meta["block_cols"], meta["nblocks"], lhs, rhs, meta["mask"])
    got = k8.bsr_sddmm_panel_int8(*sargs)
    ref = k8.bsr_sddmm_panel_int8_plain(*sargs)
    _compare(f"sddmm int8 {size}^2 dim {d}", got, ref, TOL_KERNEL, r)
    if not torch.all(got[meta["mask"] == 0] == 0):
        _fail("sddmm int8: padded or masked panel slots are not exactly 0")
    _int8_distance("sddmm int8", ref, bsr_sddmm_panel(
        meta["block_cols"], meta["nblocks"], lhs[None], rhs[None],
        meta["mask"])[0])
    if not torch.equal(got.view(torch.int32),
                       k8.bsr_sddmm_panel_int8(*sargs).view(torch.int32)):
        _fail("sddmm int8: two calls gave different bits")
    del got, ref

    def sdd8():
        return k8.bsr_sddmm_panel_int8(*sargs)

    r["ms"], eager_ms = _graph_ms(sdd8), _time_ms(sdd8)
    r["plain_ms"] = _time_ms(lambda: k8.bsr_sddmm_panel_int8_plain(*sargs),
                             reps=3, inner=2)
    csr = torch.sparse_csr_tensor(
        torch.from_numpy(np.asarray(topo.row_offsets, np.int64)),
        torch.from_numpy(np.asarray(topo.column_indices[:nnz], np.int64)),
        torch.ones(nnz), (size, size)).to(dev)
    rhs_t = rhs.T.contiguous()
    r["library_ms"] = _library_ms(
        "sddmm int8 (torch.sparse.sampled_addmm, f32 CSR)",
        lambda: torch.sparse.sampled_addmm(csr, lhs, rhs_t, beta=0.0))
    print(f"  sddmm int8 {size}^2 dim {d}: kernel {r['ms']:.4f} ms (graph; "
          f"eager {eager_ms:.4f}; the same bits twice; device split "
          f"{_split_text(_device_split(torch, sdd8))}), plain "
          f"{r['plain_ms']:.4f} ms", flush=True)
    _bound(r, 2.0 * nnz * d, 8 * nnz + _nbytes(lhs, rhs), PEAK_INT8)
    stored = 2 * _nbytes(meta["mask"])
    tiles = int(meta["nblocks"].sum()) * spec.bm * spec.bk
    print(f"    sddmm int8: the stored mask read and panel written, "
          f"{stored / 1e6:.2f} MB, take {stored / PEAK_BYTES * 1e3:.4f} ms "
          f"at {PEAK_BYTES / 1e12:.2f} TB/s (kernel at "
          f"{stored / PEAK_BYTES * 1e3 / r['ms']:.1%} of it); the stored "
          f"tiles' {2.0 * tiles * d / 1e9:.3f} G int8 op "
          f"{2.0 * tiles * d / PEAK_INT8 * 1e3:.4f} ms (not the bound)",
          flush=True)
    del lhs, rhs, csr, rhs_t

    # B18a at the int8 example's attention (R=8, s=2048, hd=128, causal),
    # timed into the JSON line; then at B9's shape (R=32, s=512, hd=64,
    # the driver's masks with a fully-masked row)
    r = kres["flash_sparse_attention_fwd_int8"]
    s = 2048
    _int8_flash_case(stt, torch, dev, r, "R=8 s=2048 hd=128 causal",
                     np.tril(np.ones((1, s, s), np.float32)), 8, 128, 71,
                     timed=True)
    b9 = {}
    _int8_flash_case(stt, torch, dev, b9, "R=32 s=512 hd=64 driver",
                     driver_masks(4, 512), 8, 64, 72, timed=True)
    r["max_abs_err"] = max(r["max_abs_err"], b9["max_abs_err"])
    print(f"  flash int8: the __dp4a kernel read 0.7433 ms at R=8 s=2048 "
          f"hd=128 causal (SDPA f32 0.4828), 0.1033 at B9's shape, eager "
          f"(PERF.md); now "
          f"{r['ms']:.4f} and {b9['ms']:.4f} (graph)", flush=True)

    # B18b / B18c at the same two problems, timed into the JSON line at the
    # example's attention
    _int8_flash_bwd_case(stt, torch, dev, kres, "R=8 s=2048 hd=128 causal",
                         np.tril(np.ones((1, s, s), np.float32)), 8, 128, 74,
                         timed=True)
    b9 = {n: {} for n in ("flash_sparse_bwd_dq_int8",
                          "flash_sparse_bwd_dkv_int8")}
    _int8_flash_bwd_case(stt, torch, dev, b9, "R=32 s=512 hd=64 driver",
                         driver_masks(4, 512), 8, 64, 75, timed=True)
    for name, r9 in b9.items():
        kres[name]["max_abs_err"] = max(kres[name]["max_abs_err"],
                                        r9["max_abs_err"])
        print(f"  {name} at B9's shape: {r9['ms']:.4f} ms, plain "
              f"{r9['plain_ms']:.4f} ms, bound {r9['bound_ms']:.4f} ms",
              flush=True)


def phase_int8_path(stt, torch, dev, wrappers):
    """Phases 3h / 4h: the int8 serving path at the example's full width,
    launches counted, and its quantised training steps; held against the
    CPU under ``set_backend("pallas")``."""
    from sputnik_tpu_torch import int8
    from sputnik_tpu_torch.examples import serve_sparse_int8 as ex8

    total = {n: 0 for n in wrappers}
    print("phase 3h: int8 serving — serve_sparse_int8 at h=1024 s=2048 "
          "heads=8 (128x128 weight panel, 64x64 flash tiles)", flush=True)
    ex = ex8.setup(False, dev)
    x = ex["x"]
    with torch.no_grad():
        y8 = _counted(wrappers, total, "int8 forward",
                      lambda: ex["forward_int8"](x),
                      {"flash_sparse_attention_fwd_int8": 1,
                       "bsr_spmm_panel_int8": 1,
                       "flash_sparse_attention_fwd": 0,
                       "bsr_spmm_panel": 0})
        _counted(wrappers, total, "fp32 forward",
                 lambda: ex["forward_f32"](x),
                 {"flash_sparse_attention_fwd": 1, "bsr_spmm_panel": 1,
                  "flash_sparse_attention_fwd_int8": 0,
                  "bsr_spmm_panel_int8": 0})
        ctx8 = int8.attention_int8(ex["bspec"], x, x, x)
    calls = 2 + ex8.ITERS
    res = _counted(wrappers, total, "serve_sparse_int8.main()",
                   lambda: ex8.main([]),
                   {"flash_sparse_attention_fwd_int8": calls,
                    "bsr_spmm_panel_int8": calls,
                    "flash_sparse_attention_fwd": calls,
                    "bsr_spmm_panel": calls})
    print(f"  the example: fp32 {res['ms_fp32']:.4f} ms, int8 "
          f"{res['ms_int8']:.4f} ms a forward (CUDA events, {ex8.ITERS} "
          f"calls), int8 {res['ms_fp32'] / res['ms_int8']:.3f}x faster; "
          f"rel err {res['rel_err']:.4f} (< 0.1)", flush=True)
    for label, fwd in (("int8 forwards", ex["forward_int8"]),
                       ("fp32 forwards", ex["forward_f32"])):
        try:
            with torch.no_grad():
                _profile_steps(torch, label, lambda i, f=fwd: f(x))
        except Exception as e:  # a measurement, not a check of the path
            print(f"  torch.profiler gave no device times: {e!r}",
                  flush=True)

    # one spmm_qat SGD step on the example's weight, dense = the int8
    # attention's flattened output [h, s]
    spec = ex["spec"]
    rng = np.random.RandomState(73)
    panel_cpu = (ex["qp"].values_q.float().cpu()
                 * ex["qp"].scales.cpu()[:, :, None, None])
    dense_cpu = ctx8.transpose(0, 1).reshape(ex["s"], ex["h"]).T.cpu()
    cot = torch.from_numpy(rng.randn(ex["h"], ex["s"]).astype(np.float32))
    panel = panel_cpu.to(dev, copy=True).requires_grad_()
    dense = dense_cpu.to(dev, copy=True).requires_grad_()

    def qat_loss(p, d, c):
        return (int8.spmm_qat(spec, p, d) * c).sum()

    def qat_step():
        loss = qat_loss(panel, dense, cot.to(dev))
        loss.backward()
        return loss

    loss0 = _counted(wrappers, total, "spmm_qat step (forward + backward)",
                     qat_step, {"bsr_spmm_panel_int8": 1,
                                "bsr_spmm_t_panel_int8": 1,
                                "bsr_sddmm_panel_int8": 1})
    lr = 1e-4
    with torch.no_grad():
        panel -= lr * panel.grad
        loss1 = qat_loss(panel, dense, cot.to(dev))
    print(f"  spmm_qat SGD step (lr {lr}): loss {loss0.item():.4f} -> "
          f"{loss1.item():.4f}", flush=True)
    if not loss1.item() < loss0.item():
        _fail("spmm_qat: the SGD step did not lower the loss")
    p_t = panel.detach().clone().requires_grad_()
    d_t = dense.detach().clone().requires_grad_()
    cot_d = cot.to(dev)

    def qat_timed(i=0):
        qat_loss(p_t, d_t, cot_d).backward()

    print(f"  spmm_qat step (forward + backward, CUDA events): "
          f"{_time_ms(qat_timed, reps=5, inner=3):.4f} ms", flush=True)
    try:
        _profile_steps(torch, "spmm_qat steps", qat_timed)
    except Exception as e:  # a measurement, not a check of the path
        print(f"  torch.profiler gave no device times: {e!r}", flush=True)
    del p_t, d_t

    # one attention_qat step: B18a forward, B9 + B10a backward; the
    # gradients are the fp32 fused attention's (B10a adds dk / dv with
    # atomics, so in another order)
    bspec = ex["bspec"]
    qkv = [x.detach().clone().requires_grad_() for _ in range(3)]
    acot = torch.from_numpy(rng.randn(*x.shape).astype(np.float32)).to(dev)

    def attn_step():
        out = int8.attention_qat(bspec, *qkv)
        (out * acot).sum().backward()
        return out

    _counted(wrappers, total, "attention_qat step (forward + backward)",
             attn_step, {"flash_sparse_attention_fwd_int8": 1,
                         "flash_sparse_attention_fwd": 1,
                         "flash_sparse_bwd_fused": 1})
    ref = [x.detach().clone().requires_grad_() for _ in range(3)]
    (stt.fused_sparse_attention(bspec, *ref) * acot).sum().backward()
    for name, a, b in zip("qkv", qkv, ref):
        _compare(f"attention_qat d{name} vs the fp32 fused attention's",
                 a.grad, b.grad, TOL_KERNEL, floor=0)

    # one attention_qat(backward="int8") step: B18a forward, B18b + B18c
    # backward from B18a's own m and l, and no fp32 flash kernel; its
    # gradients are held at tpu_smoke.py's 4e-1 of the fp32 fused ones
    qkv8 = [x.detach().clone().requires_grad_() for _ in range(3)]

    def attn8_step(tensors=qkv8):
        out = int8.attention_qat(bspec, *tensors, backward="int8")
        (out * acot).sum().backward()
        return out

    _counted(wrappers, total, "attention_qat(backward='int8') step "
             "(forward + backward)", attn8_step,
             {"flash_sparse_attention_fwd_int8": 1,
              "flash_sparse_bwd_dq_int8": 1, "flash_sparse_bwd_dkv_int8": 1,
              "flash_sparse_attention_fwd": 0, "flash_sparse_bwd_fused": 0,
              "flash_sparse_bwd_dq": 0, "flash_sparse_bwd_dkv": 0})
    grads8 = [a.grad.detach().clone() for a in qkv8]
    for name, a, b in zip("qkv", grads8, ref):
        _compare(f"attention_qat(backward='int8') d{name} vs the fp32 fused "
                 f"attention's (tpu_smoke.py's limit)", a, b.grad, 4e-1,
                 floor=0)
    steps = {}
    for label, fn in (("fp32", attn_step), ("int8", attn8_step),
                      ("int8 ", attn8_step), ("fp32 ", attn_step)):
        steps.setdefault(label.strip(), []).append(_time_ms(fn, reps=5,
                                                            inner=3))
    fp32_ms, int8_ms = min(steps["fp32"]), min(steps["int8"])
    print(f"  attention_qat step (forward + backward, CUDA events, in turns "
          f"fp32 / int8 / int8 / fp32): backward='fp32' (B18a + B9 + B10a) "
          f"{steps['fp32'][0]:.4f} / {steps['fp32'][1]:.4f} ms, "
          f"backward='int8' (B18a + B18b + B18c) {steps['int8'][0]:.4f} / "
          f"{steps['int8'][1]:.4f} ms: "
          f"{'int8' if int8_ms < fp32_ms else 'fp32'} faster by "
          f"{max(fp32_ms, int8_ms) / min(fp32_ms, int8_ms):.3f}x",
          flush=True)
    for label, fn in (("attention_qat(backward='int8') steps", attn8_step),
                      ("attention_qat(backward='fp32') steps", attn_step)):
        try:
            _profile_steps(torch, label, lambda i, f=fn: f())
        except Exception as e:  # a measurement, not a check of the path
            print(f"  torch.profiler gave no device times: {e!r}",
                  flush=True)

    print("phase 4h: the int8 path vs the CPU under set_backend('pallas') "
          "(full size: s=2048)", flush=True)
    t0 = time.perf_counter()
    cpu = ex8.setup(False, "cpu")
    stt.set_backend("pallas")
    try:
        with torch.no_grad():
            ctx_cpu = int8.attention_int8(cpu["bspec"], cpu["x"], cpu["x"],
                                          cpu["x"])
            # the projection from the card's attention output: the same
            # activation codes on both sides
            y_from_card = cpu["project"](ctx8.cpu(), lambda d: int8.spmm_int8(
                cpu["spec"], cpu["qp"], d))
            y_cpu = cpu["project"](ctx_cpu, lambda d: int8.spmm_int8(
                cpu["spec"], cpu["qp"], d))
        p_c = panel_cpu.clone().requires_grad_()
        d_c = dense_cpu.clone().requires_grad_()
        qat_loss(p_c, d_c, cot).backward()
        qkv_c = [cpu["x"].clone().requires_grad_() for _ in range(3)]
        (int8.attention_qat(cpu["bspec"], *qkv_c, backward="int8")
         * acot.cpu()).sum().backward()
    finally:
        stt.set_backend("auto")
    _compare("int8 attention vs the CPU", ctx8.cpu(), ctx_cpu, TOL_MODEL)
    n_diff = int(((ctx8.cpu() - ctx_cpu).abs() > 1e-6).sum())
    print(f"  int8 attention: {n_diff} of {ctx_cpu.numel()} outputs differ "
          f"from the CPU by more than 1e-6", flush=True)
    _compare("int8 projection of the card's attention output vs the CPU",
             y8.cpu(), y_from_card, TOL_MODEL)
    # end to end, a last-place difference in the attention output can move
    # an activation code by one step (|w| x d_scale, ~4e-3 here): the chain
    # is held at the W8A8 class, 1e-2 x max|ref|, and the count shown
    lim = TOL_MODEL * max(1.0, y_cpu.abs().max().item())
    n_off = int(((y8.cpu() - y_cpu).abs() > lim).sum())
    print(f"  int8 forward end to end: {n_off} of {y_cpu.numel()} outputs "
          f"beyond {lim:.3e} (where an activation code moved)", flush=True)
    _compare("int8 forward end to end vs the CPU", y8.cpu(), y_cpu, 1e-2)
    _compare("spmm_qat dense gradient vs the CPU", dense.grad.cpu(),
             d_c.grad, TOL_MODEL, floor=0)
    _compare("spmm_qat panel gradient vs the CPU", panel.grad.cpu(),
             p_c.grad, TOL_MODEL, floor=0)
    # the card's exp and forward sums (so D) differ from the CPU's in the
    # last place, which can move a ds or p code by one step: held at the
    # W8A8 class, 1e-2 x max|ref|, with the count beyond TOL_MODEL shown
    for name, a, c in zip("qkv", grads8, qkv_c):
        ref = c.grad
        lim = TOL_MODEL * ref.abs().max().item()
        n_off = int(((a.cpu() - ref).abs() > lim).sum())
        print(f"  attention_qat(backward='int8') d{name}: {n_off} of "
              f"{ref.numel()} entries beyond {lim:.3e} from the CPU",
              flush=True)
        _compare(f"attention_qat(backward='int8') d{name} vs the CPU",
                 a.cpu(), ref, 1e-2, floor=0)
    print(f"  CPU reference in {time.perf_counter() - t0:.1f} s", flush=True)
    return total


def _skewed_mask(m=4096, n=4096):
    """``tests/test_sharded_compressed.py``'s skewed pattern scaled to
    ``bench.py``'s 4096 x 4096: a 32-wide band (sliding-window attention)
    plus the dense rows 7, 140 and m - 3 (three global tokens)."""
    rows = np.arange(m)
    lo = np.maximum(0, rows * n // m - 16)
    cols = np.arange(n)
    mask = (cols[None, :] >= lo[:, None]) & (cols[None, :] < lo[:, None] + 32)
    mask[[7, 140, m - 3]] = True
    return mask


def _bsr_tensor(torch, spec, panel):
    """The compressed panel as a ``torch.sparse_bsr_tensor`` of the same
    tiles (the same true-BSR layout), for the library yardstick."""
    bv = spec.view
    offs = torch.from_numpy(bv.block_offsets.astype(np.int64))
    cols = torch.from_numpy(bv.block_cols[: bv.num_blocks].astype(np.int64))
    return torch.sparse_bsr_tensor(
        offs.to(panel.device), cols.to(panel.device),
        panel[: bv.num_blocks], (bv.m_pad, bv.n_pad))


def _split_note(kc, bv, plans, R, width, label):
    """Prints B13a's split plan for a call at ``width`` on ``R`` replicas:
    the chunk size, the chunks and the row-blocks they cut, and the blocks
    of each launch; returns the number of chunks."""
    chunk = kc.split_chunk(bv.num_blocks, bv.mb, R, width, bv.bm)
    plan = plans[chunk]
    n_chunks, n_split = plan["chunks"].shape[0], plan["split_rows"].numel()
    tiles = R * -(-width // 64) * -(-bv.bm // 64)
    print(f"  {label}: split plan at {chunk} tiles a chunk: {n_chunks} "
          f"chunks over {bv.mb} row-blocks ({n_split} cut, "
          f"{plan['n_parts']} partial slots); pass 1 {n_chunks * tiles} "
          f"CTAs (unsplit {bv.mb * tiles}), merge "
          f"{n_split * R * -(-bv.bm * width // 256)} CTAs; "
          f"{1 + (n_split > 0)} device launches a call", flush=True)
    return n_chunks


def _split_cases(stt, torch, dev, kc, P, rng):
    """B13a's split walk on one very heavy row-block (every tile of its
    row), two empty row-blocks and rows past ``M``, at bm = 64 and 128,
    widths 1 and 64, every epilogue: against the plain version, the empty
    row-blocks exactly 0 (+ bias), the same bits twice."""
    for bm in (64, 128):
        m, n = 4 * bm - 5, 4096
        mask = np.zeros((m, n), bool)
        mask[bm + 3] = True                       # row-block 1: 64 tiles
        mask[2 * bm + 1, ::1000] = True           # row-block 2: 5 tiles
        spec = P.PanelSpec(stt.SparseTopology.from_dense_mask(mask), bm, 64,
                           compressed=True)
        meta, bv = spec.meta(dev), spec.view
        panel = torch.from_numpy(rng.randn(1, *bv.values_shape).astype(
            np.float32)).to(dev) * meta["mask"]
        bias = torch.from_numpy(rng.randn(m).astype(np.float32)).to(dev)
        for width in (1, 64):
            x = torch.from_numpy(rng.randn(1, n, width).astype(np.float32)
                                 ).to(dev)
            r = {}
            for epi in ("none", "bias", "bias_relu"):
                args = (meta["block_offsets"], meta["block_cols"], panel, x,
                        None if epi == "none" else bias)
                kw = dict(rows=m, epilogue=epi)
                got = kc.bsr_spmm_panel_c(*args, **kw,
                                          plans=meta["split_plans"])
                if not torch.equal(got, kc.bsr_spmm_panel_c(
                        *args, **kw, plans=meta["split_plans"])):
                    _fail(f"spmm_c heavy row-block bm={bm} width={width}: "
                          f"two runs differ")
                _compare(f"spmm_c heavy row-block bm={bm} width={width} "
                         f"epilogue={epi}", got,
                         kc.bsr_spmm_panel_c_plain(*args, **kw), TOL_KERNEL,
                         r)
                for i in (0, 3):
                    lo, hi = i * bm, min((i + 1) * bm, m)
                    want = (torch.zeros_like(got[:, lo:hi]) if epi == "none"
                            else bias[lo:hi, None].expand_as(got[:, lo:hi]))
                    if not torch.equal(got[:, lo:hi], want.clamp(min=0) if
                                       epi == "bias_relu" else want):
                        _fail(f"spmm_c: empty row-block {i} is not exactly "
                              f"0 (+ bias)")
            _split_note(kc, bv, meta["split_plans"], 1, width,
                        f"spmm_c heavy row-block bm={bm} width={width}")


def _softmax_split_note(kc, bv, plans, R):
    """Prints B15a's split plan for ``R`` replicas: the chunk size, the
    chunks and the row-blocks they cut, the longest row-block, the CTAs
    of its one launch."""
    chunk = kc.softmax_chunk(bv.num_blocks, R)
    plan = plans[chunk]
    n_chunks, n_split = plan["chunks"].shape[0], plan["split_rows"].numel()
    print(f"  c_softmax_stats / c_softmax_rowsum: split plan at {chunk} tiles "
          f"a chunk: {n_chunks} chunks over {bv.mb} row-blocks ({n_split} "
          f"cut, {plan['n_parts']} partial slots; the longest row-block "
          f"{int(np.diff(bv.block_offsets).max())} tiles); one launch of "
          f"{n_chunks * R} CTAs, the last CTA of a cut row-block merging "
          f"its chunks", flush=True)


def _counters_idle(name, plans):
    """Fails unless B15a's merge counters exist and every set (one a
    replica count and stream) is back at 0."""
    sets = plans.merge_counters
    if not sets or any(bool(c.any()) for c in sets.values()):
        _fail(f"{name}: B15a's merge counters are not all back at 0 "
              f"({len(sets)} sets)")


def _softmax_chunk_sweep(kc, meta, scores, p, cot):
    """B15a in both modes by graph replay at chunk sizes 1-4, 6, 8 and 12,
    on the chain's scores at R = 1 and stacked to R = 8, where the rule
    (``softmax_chunk``) reaches its cap ``SOFTMAX_MAX_CHUNK``: the readings
    behind the rule. Each graph captures its own zeroed merge counters, so
    every reading holds one small fill beside the kernel."""
    rule, plans = kc.softmax_chunk, meta["split_plans"]
    try:
        for R in (1, 8):
            x, pr, gr = (t.expand(R, -1, -1, -1).contiguous()
                         for t in (scores, p, cot))
            row = []
            for chunk in (1, 2, 3, 4, 6, 8, 12):
                kc.softmax_chunk = lambda n, r, c=chunk: c
                ms = [_graph_ms(lambda: kc.c_softmax_stats(
                          meta["block_offsets"], x, meta["mask"],
                          plans=plans)),
                      _graph_ms(lambda: kc.c_softmax_rowsum(
                          meta["block_offsets"], pr, gr, meta["mask"],
                          plans=plans))]
                row.append(f"{chunk}: {ms[0]:.4f} / {ms[1]:.4f}")
            print(f"  B15a chunk sweep, R = {R} (stats / row sum ms, graph "
                  f"replay; the rule picks {rule(x.shape[1] - 1, R)}): "
                  + ", ".join(row), flush=True)
            del x, pr, gr
    finally:
        kc.softmax_chunk = rule


def _same_bits_and_replays(name, fn, want):
    """A second call of ``fn`` gives ``want``'s bits, and so do two replays
    of a CUDA graph that captured it (outputs filled with NaN before each
    replay)."""
    import torch

    want = want if isinstance(want, tuple) else (want,)
    again = fn()
    again = again if isinstance(again, tuple) else (again,)

    def same(got):
        return all(torch.equal(a.view(torch.int32), b.view(torch.int32))
                   for a, b in zip(got, want))

    if not same(again):
        _fail(f"{name}: two calls differ in their bits")
    if not _GRAPH_STREAM:
        _GRAPH_STREAM.append(torch.cuda.Stream())
    side = _GRAPH_STREAM[0]
    side.wait_stream(torch.cuda.current_stream())
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph, stream=side):
        outs = fn()
    outs = outs if isinstance(outs, tuple) else (outs,)
    for i in range(2):
        for o in outs:
            o.fill_(float("nan"))
        graph.replay()
        torch.cuda.synchronize()
        if not same(outs):
            _fail(f"{name}: graph replay {i + 1} differs from an eager call")
    del graph
    print(f"  {name}: the same bits twice and after two graph replays",
          flush=True)


def _softmax_bwd_library_ms(torch, topo, p_vals, g_vals):
    """``torch._sparse_softmax_backward_data`` over the coalesced COO of the
    same pattern: one PyTorch call computing the softmax backward, the
    yardstick of its row sum and product together."""
    R, nnz = p_vals.shape[0], topo.nnz
    rows = torch.from_numpy(topo.row_ids[:nnz].astype(np.int64))
    cols = torch.from_numpy(topo.column_indices[:nnz].astype(np.int64))
    idx = torch.stack([torch.arange(R).repeat_interleave(nnz),
                       rows.repeat(R), cols.repeat(R)]).to(p_vals.device)

    def coo(v):
        return torch.sparse_coo_tensor(idx, v[:, :nnz].reshape(-1),
                                       (R, topo.m, topo.n)).coalesce()

    out, grad = coo(p_vals), coo(g_vals)
    return _library_ms(
        "sparse softmax backward (torch._sparse_softmax_backward_data, "
        "COO)", lambda: torch._sparse_softmax_backward_data(
            grad, out, 2, out))


def phase_compressed_kernels(stt, torch, dev, kres):
    """Phase 2i: the compressed (true-BSR) kernels B13a, B13b, B14, B15a,
    B15b against their plain versions on the skewed 4096 x 4096 pattern at
    64 x 64 tiles (sliding window plus three global tokens): the chain's
    shapes (widths 64, timed into the JSON line) and bench.py's width
    4096; B1 / B3 on the ELL panel of the same topology beside them. B13a
    walks its split plan, timed beside the unsplit walk, also as JAX's
    ones-column row sum of the softmax backward; then on a heavy
    row-block. B15a walks its own split plan (one launch, the chunks
    merged by the last block of a row-block), B15a / B15b are held in
    both modes (the softmax backward's row sum and product), each the same
    bits twice and after graph replays, timed by graph replay beside
    eager calls; B15a's chunk size swept."""
    from sputnik_tpu_torch.ops import panel_api as P
    from sputnik_tpu_torch.ops.kernels import bsr_compressed as kc
    from sputnik_tpu_torch.ops.kernels.bsr_spmm import bsr_spmm_panel
    from sputnik_tpu_torch.ops.kernels.bsr_spmm_t import bsr_spmm_t_panel

    print("phase 2i: compressed (true-BSR) kernels (B13a, B13b, B14, B15a, "
          "B15b) vs plain PyTorch on the skewed 4096^2 pattern, 64x64 tiles",
          flush=True)
    rng = np.random.RandomState(90)
    mask = _skewed_mask()
    w = (mask * rng.randn(*mask.shape)).astype(np.float32)
    mat = stt.SparseMatrix(w)
    topo, nnz = mat.topology, mat.topology.nnz
    spec = P.PanelSpec(topo, 64, 64, compressed=True)
    espec = P.PanelSpec(topo, 64, 64)
    bv, ev = spec.view, espec.view
    meta, emeta = spec.meta(dev), espec.meta(dev)
    panel = torch.from_numpy(P.values_to_panel_np(
        topo, mat.values, 64, 64, compressed=True)).to(dev)[None]
    epanel = torch.from_numpy(P.values_to_panel_np(
        topo, mat.values, 64, 64)).to(dev)[None]
    print(f"  pattern: nnz {nnz} (d={nnz / topo.m / topo.n:.4f}), "
          f"{bv.num_blocks} real tiles, max_bpr {ev.max_bpr}; compressed "
          f"panel {_nbytes(panel) / 1e6:.2f} MB "
          f"{tuple(panel.shape[1:])}, ELL panel {_nbytes(epanel) / 1e6:.2f} "
          f"MB {tuple(epanel.shape[1:])}", flush=True)
    a_dense = torch.from_numpy(w).to(dev)
    bsr = _bsr_tensor(torch, spec, panel[0])
    size = topo.m

    # -- B13a and B13b at the chain's width 64 (JSON) and bench's 4096
    for width in (4096, 64):
        x = torch.from_numpy(rng.randn(1, size, width).astype(np.float32)
                             ).to(dev)
        bias = torch.from_numpy(rng.randn(size).astype(np.float32)).to(dev)
        cargs = (meta["block_offsets"], meta["block_cols"], panel, x)
        eargs = (emeta["block_cols"], emeta["nblocks"], epanel, x)

        def c_kern(epi="none", plans=meta["split_plans"]):
            return kc.bsr_spmm_panel_c(*cargs, None if epi == "none" else
                                       bias, rows=size, epilogue=epi,
                                       plans=plans)

        def c_plain(epi="none"):
            return kc.bsr_spmm_panel_c_plain(
                *cargs, None if epi == "none" else bias, rows=size,
                epilogue=epi)

        r = {}
        for epi in ("none", "bias", "bias_relu"):
            _compare(f"spmm_c width {width} epilogue={epi}", c_kern(epi),
                     c_plain(epi), TOL_KERNEL, r)
            _compare(f"spmm_c width {width} epilogue={epi}, unsplit walk",
                     c_kern(epi, plans=None), c_plain(epi), TOL_KERNEL)
        if not torch.equal(c_kern(), c_kern()):
            _fail(f"spmm_c width {width}: two runs differ")
        _compare(f"spmm_c width {width} vs dense torch.matmul", c_kern()[0],
                 a_dense @ x[0], TOL_KERNEL)
        _compare(f"B1 (ELL panel) width {width} vs spmm_c",
                 bsr_spmm_panel(*eargs, rows=size), c_kern(), TOL_KERNEL)
        chunks = _split_note(kc, bv, meta["split_plans"], 1, width,
                             f"spmm_c width {width}")
        if width == 64 and not chunks > bv.mb:
            _fail(f"spmm_c width 64: {chunks} chunks, not more than the "
                  f"{bv.mb} row-blocks")
        # device times by CUDA graph replay; the eager calls beside them
        eager_ms = _time_ms(c_kern)
        r["ms"], r["plain_ms"] = _graph_ms(c_kern), _time_ms(c_plain)
        whole_ms = _graph_ms(lambda: c_kern(plans=None))
        ell_ms = _graph_ms(lambda: bsr_spmm_panel(*eargs, rows=size))
        dense_ms = _graph_ms(lambda: a_dense @ x[0])
        print(f"  spmm_c width {width}: kernel {r['ms']:.4f} ms (graph "
              f"replay; eager calls {eager_ms:.4f} ms a call), the unsplit "
              f"walk {whole_ms:.4f} ms, plain {r['plain_ms']:.4f} ms; B1 on "
              f"the ELL panel {ell_ms:.4f} ms (B13a {ell_ms / r['ms']:.2f}x "
              f"faster); dense fp32 torch.matmul {dense_ms:.4f} ms (graph "
              f"replay)", flush=True)
        r["library_ms"] = _library_ms(
            f"spmm_c width {width} (torch.sparse_bsr_tensor @ dense, the "
            f"same 64x64 tiles)", lambda: bsr @ x[0])
        _sparse_bound(r, nnz, 1, width, 2 * _nbytes(x), PEAK_3XTF32)
        _stored_note("spmm_c", bv.num_blocks * 64 * 64, width)
        _stored_note("B1 (ELL)", ev.mb * ev.max_bpr * 64 * 64, width)
        if width == 64:
            kres["bsr_spmm_panel_c"].update(r)

        g = torch.from_numpy(rng.randn(1, size, width).astype(np.float32)
                             ).to(dev)
        targs = (meta["t_gblk"], meta["t_rows"], meta["t_nblocks"], panel, g)
        eargs = (emeta["t_src_i"], emeta["t_src_s"], emeta["t_nblocks"],
                 epanel, g)
        r = {}
        got = kc.bsr_spmm_t_panel_c(*targs, rows=size)
        _compare(f"spmm_t_c width {width}", got,
                 kc.bsr_spmm_t_panel_c_plain(*targs, rows=size), TOL_KERNEL,
                 r)
        _compare(f"spmm_t_c width {width} vs dense a.T @ G", got[0],
                 a_dense.T @ g[0], TOL_KERNEL)
        _compare(f"B3 (ELL panel) width {width} vs spmm_t_c",
                 bsr_spmm_t_panel(*eargs, rows=size), got, TOL_KERNEL)
        r["ms"] = _time_ms(lambda: kc.bsr_spmm_t_panel_c(*targs, rows=size))
        r["plain_ms"] = _time_ms(
            lambda: kc.bsr_spmm_t_panel_c_plain(*targs, rows=size))
        ell_ms = _time_ms(lambda: bsr_spmm_t_panel(*eargs, rows=size))
        r["library_ms"] = _time_ms(lambda: a_dense.T @ g[0])
        print(f"  spmm_t_c width {width}: kernel {r['ms']:.4f} ms, plain "
              f"{r['plain_ms']:.4f} ms; B3 on the ELL panel {ell_ms:.4f} ms; "
              f"library: dense fp32 a.T @ G {r['library_ms']:.4f} ms",
              flush=True)
        _sparse_bound(r, nnz, 1, width, 2 * _nbytes(g), PEAK_3XTF32)
        if width == 64:
            kres["bsr_spmm_t_panel_c"].update(r)
        del x, g, got

    # -- B13a as JAX's ragged row sum of the softmax backward (a ones
    # column; the port's backward takes it by B15a's walk)
    ones = torch.ones(1, bv.n_pad, 1, device=dev)
    rargs = (meta["block_offsets"], meta["block_cols"], panel, ones)
    got = kc.bsr_spmm_panel_c(*rargs, rows=bv.m_pad,
                              plans=meta["split_plans"])
    _compare("spmm_c row sum (ones column, N = 1)", got,
             kc.bsr_spmm_panel_c_plain(*rargs, rows=bv.m_pad), TOL_KERNEL)
    _split_note(kc, bv, meta["split_plans"], 1, 1, "spmm_c row sum")
    split_ms = _graph_ms(lambda: kc.bsr_spmm_panel_c(
        *rargs, rows=bv.m_pad, plans=meta["split_plans"]))
    whole_ms = _graph_ms(lambda: kc.bsr_spmm_panel_c(*rargs, rows=bv.m_pad))
    print(f"  spmm_c row sum (N = 1): split {split_ms:.4f} ms, the unsplit "
          f"walk {whole_ms:.4f} ms (graph replay)", flush=True)
    _split_cases(stt, torch, dev, kc, P, rng)

    # -- B14 at the chain's d = 64, scaled as attention scores
    d = 64
    q, k = (torch.from_numpy((rng.randn(1, size, d) * d ** -0.25).astype(
        np.float32)).to(dev) for _ in range(2))
    sargs = (meta["block_rows"], meta["block_cols"], q, k, meta["mask"])
    r = kres["bsr_sddmm_panel_c"]
    scores = kc.bsr_sddmm_panel_c(*sargs)
    _compare(f"sddmm_c d={d}", scores, kc.bsr_sddmm_panel_c_plain(*sargs),
             TOL_KERNEL, r)
    if not (torch.all(scores[0, -1] == 0)
            and torch.all(scores[0][meta["mask"] == 0] == 0)):
        _fail("sddmm_c: the dump tile or a masked slot is not exactly 0")
    if not torch.equal(scores.view(torch.int32),
                       kc.bsr_sddmm_panel_c(*sargs).view(torch.int32)):
        _fail("sddmm_c: two calls differ in their bits")
    r["ms"] = _graph_ms(lambda: kc.bsr_sddmm_panel_c(*sargs))
    eager_ms = _time_ms(lambda: kc.bsr_sddmm_panel_c(*sargs))
    r["plain_ms"] = _time_ms(lambda: kc.bsr_sddmm_panel_c_plain(*sargs))
    print(f"  sddmm_c d={d}: kernel {r['ms']:.4f} ms (graph; eager "
          f"{eager_ms:.4f}; the FMA body read 0.0344 eager, PERF.md), the "
          f"same bits twice; plain {r['plain_ms']:.4f} ms", flush=True)
    csr = torch.sparse_csr_tensor(
        torch.from_numpy(np.asarray(topo.row_offsets, np.int64)),
        torch.from_numpy(np.asarray(topo.column_indices[:nnz], np.int64)),
        torch.ones(nnz), (size, size)).to(dev)
    k_t = k[0].T.contiguous()
    r["library_ms"] = _library_ms(
        "sddmm_c (torch.sparse.sampled_addmm, CSR)",
        lambda: torch.sparse.sampled_addmm(csr, q[0], k_t, beta=0.0),
        timer=_graph_ms)
    _sparse_bound(r, nnz, 1, d, _nbytes(q, k), PEAK_3XTF32)
    _stored_note("sddmm_c", bv.num_blocks * 64 * 64, d)
    del csr, k_t

    # -- B15a / B15b on the chain's scores: B15a walks its split plan
    plans = meta["split_plans"]
    _softmax_split_note(kc, bv, plans, 1)
    stats_args = (meta["block_offsets"], scores, meta["mask"])

    def stats():
        return kc.c_softmax_stats(*stats_args, plans=plans)

    m, l = stats()
    m_ref, l_ref = kc.c_softmax_stats_plain(*stats_args)
    r = kres["c_softmax_stats"]
    _compare("c_softmax_stats row_max (exactly equal)", m, m_ref, 0.0, r)
    _compare("c_softmax_stats row_denom", l, l_ref, TOL_KERNEL, r, floor=0)
    _compare_each("c_softmax_stats row_denom", l, l_ref, TOL_KERNEL)
    _same_bits_and_replays("c_softmax_stats", stats, (m, l))
    _counters_idle("c_softmax_stats", plans)
    aargs = (meta["block_rows"], scores, meta["mask"], m, l)

    def apply():
        return kc.c_softmax_apply(*aargs)

    p = apply()
    p_ref = kc.c_softmax_apply_plain(*aargs)
    ra = kres["c_softmax_apply"]
    _compare("c_softmax_apply", p, p_ref, TOL_KERNEL, ra)
    _compare_each("c_softmax_apply", p, p_ref, TOL_KERNEL)
    small = (p_ref != 0) & (p_ref < p_ref[p_ref != 0].median())
    try:
        _compare_each("  planted fault, c_softmax_apply small outputs "
                      "zeroed", torch.where(small, 0.0, p), p_ref, TOL_KERNEL)
    except RuntimeError:
        pass
    else:
        _fail("c_softmax_apply: zeroed small outputs passed the check")
    if not (torch.all(p[0, -1] == 0)
            and torch.all(p[0][meta["mask"] == 0] == 0)):
        _fail("c_softmax_apply: the dump tile or a masked slot is not 0")
    rows = p[0].sum(dim=-1).new_zeros(bv.m_pad).index_add_(
        0, (meta["block_rows"].long()[:, None] * 64
            + torch.arange(64, device=dev)).reshape(-1),
        p[0].sum(dim=-1).reshape(-1))[:size]
    _compare("c_softmax rows sum to 1", rows, torch.ones_like(rows), 1e-5)
    _same_bits_and_replays("c_softmax_apply", apply, p)

    # -- the softmax backward's two modes, on a cotangent that is NaN at
    # the masked slots and in the dump tile
    cot = torch.from_numpy(rng.randn(*scores.shape).astype(np.float32)
                           ).to(dev)
    cot = torch.where(meta["mask"] != 0, cot, float("nan"))

    def rowsum():
        return kc.c_softmax_rowsum(meta["block_offsets"], p, cot,
                                   meta["mask"], plans=plans)

    rs = rowsum()
    rr = kres["c_softmax_rowsum"]
    _compare("c_softmax_rowsum", rs, kc.c_softmax_rowsum_plain(
        meta["block_offsets"], p, cot, meta["mask"]), TOL_KERNEL, rr)
    _same_bits_and_replays("c_softmax_rowsum", rowsum, rs)
    gargs = (meta["block_rows"], p, cot, meta["mask"], rs)

    def grad():
        return kc.c_softmax_grad(*gargs)

    dx = grad()
    rg = kres["c_softmax_grad"]
    _compare("c_softmax_grad", dx, kc.c_softmax_grad_plain(*gargs),
             TOL_KERNEL, rg)
    if not (torch.all(dx[0, -1] == 0)
            and torch.all(dx[0][meta["mask"] == 0] == 0)):
        _fail("c_softmax_grad: the dump tile or a masked slot is not 0")
    _same_bits_and_replays("c_softmax_grad", grad, dx)

    # device times by CUDA graph replay; the eager calls beside them
    timed = (("c_softmax_stats", r, stats,
              lambda: kc.c_softmax_stats_plain(*stats_args)),
             ("c_softmax_apply", ra, apply,
              lambda: kc.c_softmax_apply_plain(*aargs)),
             ("c_softmax_rowsum", rr, rowsum,
              lambda: kc.c_softmax_rowsum_plain(meta["block_offsets"], p,
                                                cot, meta["mask"])),
             ("c_softmax_grad", rg, grad,
              lambda: kc.c_softmax_grad_plain(*gargs)))
    for name, res, kern, plain in timed:
        res["ms"], eager_ms = _graph_ms(kern), _time_ms(kern)
        res["plain_ms"] = _time_ms(plain)
        print(f"  {name}: kernel {res['ms']:.4f} ms (graph replay; eager "
              f"calls {eager_ms:.4f} ms a call), plain {res['plain_ms']:.4f}"
              f" ms", flush=True)
    _softmax_chunk_sweep(kc, meta, scores, p, cot)
    _counters_idle("c_softmax_stats / c_softmax_rowsum", plans)
    vals = P.panel_to_values(topo, scores[0], 64, 64, compressed=True)[None]
    lib = _softmax_library_ms(torch, topo, vals)
    r["library_ms"] = ra["library_ms"] = lib   # one call does both passes
    rr["library_ms"] = rg["library_ms"] = _softmax_bwd_library_ms(
        torch, topo, *(P.panel_to_values(topo, x[0], 64, 64,
                                         compressed=True)[None]
                       for x in (p, cot)))
    # bytes of the nonzeros: B15a reads the scores and a 4-byte index per
    # nonzero and writes m, l; B15b reads them again and writes p; the
    # backward's row sum reads p and g, its product p, g and rs and
    # writes the gradient
    _bound(r, 3.0 * nnz, 8 * nnz + 8 * size)
    _bound(ra, 2.0 * nnz, 12 * nnz + 8 * size)
    _bound(rr, 2.0 * nnz, 12 * nnz + 4 * size)
    _bound(rg, 2.0 * nnz, 16 * nnz + 4 * size)
    tiles = (bv.num_blocks + 1) * 64 * 64
    print(f"    c_softmax: the stored panel's bytes (f32 values and mask of "
          f"every occupied tile; not the bound): B15a reads "
          f"{8 * tiles / 1e6:.2f} MB ({8 * tiles / PEAK_BYTES * 1e3:.4f} "
          f"ms), B15b moves {12 * tiles / 1e6:.2f} MB "
          f"({12 * tiles / PEAK_BYTES * 1e3:.4f} ms); the row sum reads "
          f"{12 * tiles / 1e6:.2f} MB ({12 * tiles / PEAK_BYTES * 1e3:.4f} "
          f"ms), the gradient moves {16 * tiles / 1e6:.2f} MB "
          f"({16 * tiles / PEAK_BYTES * 1e3:.4f} ms)", flush=True)


def phase_compressed_path(stt, torch, dev, wrappers):
    """Phases 3i / 4i: the compressed attention chain (sddmm ->
    sparse_softmax -> spmm through ``stt.panel`` on
    ``PanelSpec(compressed=True)``) forward and backward on the skewed
    4096 x 4096 pattern, hd = 64, launches counted (no ELL kernel), held
    against the port's CPU plain route; the chain step timed against the
    ELL layout's; then SGD on a compressed-panel regression."""
    from sputnik_tpu_torch.ops import panel_api as P

    total = {n: 0 for n in wrappers}
    print("phase 3i: compressed chain — sddmm -> sparse_softmax -> spmm on "
          "PanelSpec(compressed=True), skewed 4096^2, 64x64 tiles, hd=64",
          flush=True)
    topo = stt.SparseTopology.from_dense_mask(_skewed_mask())
    spec = P.PanelSpec(topo, 64, 64, compressed=True)
    espec = P.PanelSpec(topo, 64, 64)
    s, hd = topo.m, 64
    rng = np.random.RandomState(91)
    host = [rng.randn(s, hd).astype(np.float32) for _ in range(3)]
    cot = torch.from_numpy(rng.randn(s, hd).astype(np.float32))

    def chain(sp, q, k, v):
        w = stt.panel.sparse_softmax(sp, stt.panel.sddmm(sp, q, k)
                                     * hd ** -0.5)
        return stt.panel.spmm(sp, w, v), w

    gpu = [torch.from_numpy(x).to(dev).requires_grad_() for x in host]
    cot_d = cot.to(dev)

    def step():
        out, w = chain(spec, *gpu)
        (out * cot_d).sum().backward()
        return out, w

    out, w = _counted(
        wrappers, total, "compressed chain forward + backward", step,
        {"bsr_sddmm_panel_c": 2, "c_softmax_stats": 1, "c_softmax_apply": 1,
         "c_softmax_rowsum": 1, "c_softmax_grad": 1,
         "bsr_spmm_panel_c": 2, "bsr_spmm_t_panel_c": 2,
         "bsr_spmm_panel": 0, "bsr_spmm_t_panel": 0, "bsr_sddmm_panel": 0,
         "ell_softmax": 0, "ell_softmax_bwd": 0, "panel_softmax": 0,
         "panel_softmax_bwd": 0})
    if not (torch.all(w[-1] == 0) and torch.all(
            w[spec.meta(dev)["mask"] == 0] == 0)):
        _fail("compressed chain: the dump tile or a masked slot of the "
              "softmax is not exactly 0")
    if not all(torch.isfinite(x.grad).all() for x in gpu):
        _fail("compressed chain: non-finite gradients")
    _counters_idle("compressed chain", spec.meta(dev)["split_plans"])

    def timed_step(sp):
        for x in gpu:
            x.grad = None
        out, _ = chain(sp, *gpu)
        (out * cot_d).sum().backward()

    times = {"compressed": [], "ELL": []}
    for name in ("compressed", "ELL", "ELL", "compressed"):
        sp = spec if name == "compressed" else espec
        times[name].append(_time_ms(lambda sp=sp: timed_step(sp), reps=5,
                                    inner=5))
    print(f"  chain step (forward + backward, CUDA events, in turns "
          f"compressed / ELL / ELL / compressed): compressed "
          f"{times['compressed'][0]:.4f} / {times['compressed'][1]:.4f} ms, "
          f"ELL {times['ELL'][0]:.4f} / {times['ELL'][1]:.4f} ms", flush=True)
    try:
        _profile_steps(torch, "compressed chain steps",
                       lambda i: timed_step(spec))
    except Exception as e:  # a measurement, not a check of the path
        print(f"  torch.profiler gave no device times: {e!r}", flush=True)

    # SGD on a spmm regression over a compressed panel (B13a; B14)
    mat = stt.SparseMatrix((_skewed_mask() * rng.randn(s, s)).astype(
        np.float32))
    target_panel = torch.from_numpy(P.values_to_panel_np(
        mat.topology, mat.values, 64, 64, compressed=True)).to(dev)
    rspec = P.PanelSpec(mat.topology, 64, 64, compressed=True)
    x = torch.from_numpy(rng.randn(s, hd).astype(np.float32)).to(dev)
    y = stt.panel.spmm(rspec, target_panel, x).detach()
    panel = torch.nn.Parameter(P.panel_kaiming_values(
        mat.topology, 64, 64, compressed=True,
        generator=torch.Generator().manual_seed(0)).to(dev))
    opt = torch.optim.SGD([panel], lr=10.0)

    def sgd_step():
        opt.zero_grad()
        loss = (stt.panel.spmm(rspec, panel, x) - y).square().mean()
        loss.backward()
        opt.step()
        return loss.item()

    steps = 5
    losses = _counted(wrappers, total, f"{steps} SGD steps on a compressed "
                      f"panel", lambda: [sgd_step() for _ in range(steps)],
                      {"bsr_spmm_panel_c": steps, "bsr_sddmm_panel_c": steps,
                       "bsr_spmm_t_panel_c": 0, "bsr_spmm_panel": 0})
    print(f"  SGD losses {[round(v, 6) for v in losses]}", flush=True)
    if not losses[-1] < losses[0] or not all(np.isfinite(losses)):
        _fail(f"compressed SGD: the loss did not fall ({losses})")
    if not torch.all(panel.detach()[-1] == 0):
        _fail("compressed SGD: the dump tile moved")

    print("phase 4i: the compressed chain vs the CPU plain route (full size)",
          flush=True)
    t0 = time.perf_counter()
    cpu = [torch.from_numpy(x).requires_grad_() for x in host]
    ref, w_ref = chain(spec, *cpu)
    (ref * cot).sum().backward()
    _compare("compressed chain output vs the CPU", out.detach().cpu(),
             ref.detach(), TOL_MODEL)
    _compare("compressed chain softmax vs the CPU", w.detach().cpu(),
             w_ref.detach(), TOL_MODEL)
    for name, a, c in zip("qkv", gpu, cpu):
        _compare(f"compressed chain d{name} vs the CPU", a.grad.cpu(),
                 c.grad, TOL_MODEL, floor=0)
    print(f"  CPU reference in {time.perf_counter() - t0:.1f} s", flush=True)
    return total


# -- the sequence-parallel layer (B2, B11a, B11b) and the dtype repair ------

# examples/train_seq_parallel.py's full config (s = ndev * 2048, R = 4,
# hd = 64) at 4 shards, benchmarks/ring_moe_pipeline.py's s / hd / R
RING_S, RING_R, RING_HD, NDEV = 8192, 4, 64, 4
# benchmarks/scaling.py's banded problem (_mk_problem(banded=True)): a
# causal local window of size // 8, at width q = 512
HALO_S, HALO_W, HALO_Q = 8192, 1024, 512


def _ring_spec(stt, zigzag):
    from sputnik_tpu_torch.patterns import causal_topology

    return stt.parallel.RingFlashSpec(stt.parallel.RowPartition(
        causal_topology(RING_S), NDEV, balance=False, zigzag=zigzag))


def _halo_problem(stt, case, seed):
    """(spec, panels, dense_sh [ndev, n_loc, q], values) on the host for the
    halo SpMM's three branches: "banded" (benchmarks/scaling.py's window
    at 8192^2: the interior / halo split), "ragged" (the window at 8000^2:
    n_loc = 2000 is no whole number of 64-blocks, so the exchange without
    the split) and "random" (4096^2 d=0.01, balanced rows: the halo spans
    everything, so the all_gather)."""
    from sputnik_tpu_torch.patterns import causal_topology

    rng = np.random.RandomState(seed)
    if case == "random":
        s = HALO_S // 2
        topo = stt.SparseTopology.from_dense_mask(rng.rand(s, s) < 0.01)
    else:
        s = HALO_S if case == "banded" else HALO_S - 3 * 64
        topo = causal_topology(s, band=s // 8)
    part = stt.parallel.RowPartition(topo, NDEV, balance=case == "random")
    spec = stt.parallel.ShardedPanelSpec(part)
    values = rng.randn(topo.nnz_pad).astype(np.float32)
    panels = spec.stack_values(values)
    dense = rng.randn(NDEV, topo.n // NDEV, HALO_Q).astype(np.float32)
    return spec, panels, dense, values


def _ring_band_problem(stt, torch, dev, spec, seed):
    """Seeded q (pre-scaled) [R, m_pad_loc, hd] and the key bands k, v
    [ndev, R, n_loc, hd] of one shard of the ring, on the card."""
    rng = np.random.RandomState(seed)
    q = torch.from_numpy((rng.randn(RING_R, spec.m_pad_loc, RING_HD)
                          * RING_HD ** -0.5).astype(np.float32)).to(dev)
    k, v = (torch.from_numpy(rng.randn(NDEV, RING_R, spec.n_loc, RING_HD)
                             .astype(np.float32)).to(dev) for _ in range(2))
    return q, k, v


def _band_mask(spec, d, band):
    """The sliced (shard d, band) topology of a natural-order ring."""
    from sputnik_tpu_torch.parallel.ring_flash import _slice_columns

    return _slice_columns(spec.part.shards[d],
                          [(band * spec.n_loc, (band + 1) * spec.n_loc)])


def phase_parallel_kernels(stt, torch, dev, kres):
    """Phase 2j: B2, B11a and B11b against their plain versions on the
    card at the shapes the sequence-parallel paths give them, timed, with
    the algebraic checks: B2's interior pass plus its halo pass equals B1
    over the same shard; a shard's bands carried through B11a and finished
    equal B9 over its whole key range; its bands through B11b equal
    B10a."""
    import torch.nn.functional as F

    from sputnik_tpu_torch.ops.kernels import flash_sparse as fs
    from sputnik_tpu_torch.ops.kernels.bsr_spmm import (
        bsr_spmm_panel, bsr_spmm_panel_sel, bsr_spmm_panel_sel_plain)
    from sputnik_tpu_torch.parallel.sharded_ops import (_ov_split_dev,
                                                        _ov_split_meta)

    print(f"phase 2j: sequence-parallel kernels (B2 bsr_spmm_panel_sel, "
          f"B11a / B11b ring band steps) vs plain PyTorch: B2 at the halo "
          f"SpMM's {HALO_S}^2 window {HALO_W}, q={HALO_Q}, {NDEV} shards; "
          f"B11a / B11b at the ring's s={RING_S} causal, R={RING_R}, "
          f"hd={RING_HD}, {NDEV} shards", flush=True)
    # -- B2: shard 1's interior and halo passes
    spec, panels_np, dense_np, _ = _halo_problem(stt, "banded", 100)
    n_loc = dense_np.shape[1]
    panels = torch.from_numpy(panels_np).to(dev)
    full = torch.from_numpy(dense_np.reshape(-1, HALO_Q)).to(dev)
    d = 1
    own = full[d * n_loc: (d + 1) * n_loc]
    halo = full.clone()
    halo[d * n_loc: (d + 1) * n_loc] = 0.0    # the halo-only buffer
    sm, st = _ov_split_dev(spec, n_loc, dev), _ov_split_meta(spec, n_loc)
    r = kres["bsr_spmm_panel_sel"]
    outs = {}
    for name, src in (("interior", own), ("halo", halo)):
        args = (sm[name[0]]["cols"][d], sm[name[0]]["nblk"][d],
                sm[name[0]]["sel"][d], panels[d], src)
        outs[name] = bsr_spmm_panel_sel(*args)
        _compare(f"spmm_sel {name} pass shard {d}", outs[name],
                 bsr_spmm_panel_sel_plain(*args), TOL_KERNEL, r)
    meta = spec.meta(dev)
    b1 = bsr_spmm_panel(meta["block_cols"][d], meta["nblocks"][d],
                        panels[d][None], full[None], rows=spec.m_pad_loc)[0]
    _compare(f"spmm_sel interior + halo vs B1 over shard {d}",
             outs["interior"] + outs["halo"], b1, TOL_KERNEL)
    ii = st["i"]
    cols = ii["cols"][d].reshape(spec.mb, ii["maxb"])
    sel = ii["sel"][d].reshape(spec.mb, ii["maxb"])
    nblk = ii["nblk"][d]
    tiles = [(i, s) for i in range(spec.mb) for s in range(int(nblk[i]))]
    nnz_sel = int(sum(spec.mask[d, i, sel[i, s]].sum() for i, s in tiles))
    a_sel = torch.zeros(spec.m_pad_loc, n_loc, device=dev)
    for i, s in tiles:
        c = int(cols[i, s])
        a_sel[i * 64:(i + 1) * 64, c * 64:(c + 1) * 64] = panels[d, i,
                                                               sel[i, s]]
    _compare("spmm_sel interior vs torch.matmul on its densified tiles",
             outs["interior"], a_sel @ own, TOL_KERNEL)
    args = (sm["i"]["cols"][d], sm["i"]["nblk"][d], sm["i"]["sel"][d],
            panels[d], own)
    r["ms"] = _time_ms(lambda: bsr_spmm_panel_sel(*args))
    r["plain_ms"] = _time_ms(lambda: bsr_spmm_panel_sel_plain(*args))
    r["library_ms"] = _time_ms(lambda: a_sel @ own)
    print(f"  spmm_sel interior pass shard {d} ({len(tiles)} tiles, nnz "
          f"{nnz_sel}): kernel {r['ms']:.4f} ms, plain {r['plain_ms']:.4f} "
          f"ms; library: torch.matmul on the densified tiles "
          f"{r['library_ms']:.4f} ms", flush=True)
    _sparse_bound(r, nnz_sel, 1, HALO_Q, _nbytes(own, outs["interior"]),
                  PEAK_3XTF32)
    _stored_note("spmm_sel interior", len(tiles) * 64 * 64, HALO_Q)
    del panels, full, halo, a_sel, outs, b1

    # -- B11a / B11b: the last shard's bands, each step against its plain
    # version, then the finished carry against B9 / B10a over all its keys
    spec = _ring_spec(stt, False)
    q, k, v = _ring_band_problem(stt, torch, dev, spec, 101)
    d, R, rows = NDEV - 1, RING_R, spec.m_pad_loc
    rmeta = spec.meta(dev)

    def band_meta(band):
        return [rmeta[key][d, band] for key in (
            "block_cols", "nblocks", "mask_slot", "is_partial", "pmask")]

    acc = torch.zeros(R, rows, RING_HD, device=dev)
    m = torch.full((R, rows), -1e30, device=dev)
    l = torch.zeros(R, rows, device=dev)
    rf = kres["flash_sparse_ring_band_fwd"]
    for t in range(NDEV):
        band = (d - t) % NDEV
        args = (*band_meta(band), q, k[band], v[band])
        want = fs.flash_sparse_ring_band_fwd_plain(
            *args, acc.clone(), m.clone(), l.clone(), max_bpr=spec.max_bpr)
        fs.flash_sparse_ring_band_fwd(*args, acc, m, l,
                                      max_bpr=spec.max_bpr)
        for name, got, ref in zip(("acc", "m", "l"), (acc, m, l), want):
            _compare(f"ring_band_fwd shard {d} band {band} {name}", got,
                     ref, TOL_KERNEL, rf)
    out = acc / l.clamp(min=1e-30)[..., None]
    view = spec.part.shards[d].block(64, 64)
    fm = {key: torch.from_numpy(x).to(dev) for key, x in
          fs.build_flash_meta([view]).items() if isinstance(x, np.ndarray)}
    k_full = spec.unshard_kv(k).contiguous()
    v_full = spec.unshard_kv(v).contiguous()
    ref, m_ref, l_ref = fs.flash_sparse_attention_fwd(
        fm["block_cols"], fm["nblocks"], fm["mask_slot"], fm["is_partial"],
        fm["pmask"], q, k_full, v_full, heads=R, max_bpr=view.max_bpr,
        scale=1.0)
    _compare(f"ring: {NDEV} bands carried through B11a vs B9 over shard "
             f"{d}'s keys", out, ref, TOL_KERNEL)
    _compare("ring: carried m vs B9's (exactly equal)", m, m_ref, 0.0)
    # shard 0's future bands are empty: the carry keeps its bits
    carry0 = [x.clone() for x in (acc, m, l)]
    for band in range(1, NDEV):
        if int(spec.nblocks[0, band].sum()):
            _fail(f"ring: shard 0's band {band} is not empty")
        fs.flash_sparse_ring_band_fwd(
            *[rmeta[key][0, band] for key in (
                "block_cols", "nblocks", "mask_slot", "is_partial",
                "pmask")], q, k[band], v[band], *carry0,
            max_bpr=spec.max_bpr)
    if not all(torch.equal(a.view(torch.int32), b.view(torch.int32))
               for a, b in zip(carry0, (acc, m, l))):
        _fail("ring: an empty band changed the carry")
    print(f"  ring: shard 0's {NDEV - 1} empty bands leave the carry bit for "
          f"bit", flush=True)

    g = torch.from_numpy(np.random.RandomState(102).randn(
        R, rows, RING_HD).astype(np.float32)).to(dev)
    D = (g * out).sum(-1)
    dq = torch.zeros_like(q)
    dks, dvs = torch.zeros_like(k), torch.zeros_like(v)
    rb = kres["flash_sparse_ring_band_bwd"]
    for t in range(NDEV):
        band = (d - t) % NDEV
        args = (*band_meta(band), q, k[band], v[band], g, m, l, D)
        want = fs.flash_sparse_ring_band_bwd_plain(
            *args, dq.clone(), dks[band].clone(), dvs[band].clone(),
            max_bpr=spec.max_bpr)
        fs.flash_sparse_ring_band_bwd(*args, dq, dks[band], dvs[band],
                                      max_bpr=spec.max_bpr)
        for name, got, want_ in zip(("dq", "dk", "dv"),
                                    (dq, dks[band], dvs[band]), want):
            _compare(f"ring_band_bwd shard {d} band {band} {name}", got,
                     want_, TOL_KERNEL, rb)
    rq, rk, rv = fs.flash_sparse_bwd_fused(
        fm["block_cols"], fm["nblocks"], fm["mask_slot"], fm["is_partial"],
        fm["pmask"], q, k_full, v_full, g, m, l, D, heads=R,
        max_bpr=view.max_bpr, scale=1.0)
    for name, got, want in (("dq", dq, rq),
                            ("dk", spec.unshard_kv(dks), rk),
                            ("dv", spec.unshard_kv(dvs), rv)):
        _compare(f"ring: {NDEV} bands through B11b vs B10a over shard {d}'s "
                 f"keys, {name}", got, want, TOL_KERNEL)

    # times at the fullest band: shard ndev-1's band 0, every tile full
    band = 0
    sliced = _band_mask(spec, d, band)
    pairs = float(sliced.nnz) * R
    mask_b = torch.from_numpy(sliced.to_dense_mask() != 0).to(dev)
    fargs = (*band_meta(band), q, k[band], v[band])
    carry = [x.clone() for x in (acc, m, l)]
    _flash_split_note("ring_band_fwd", R * spec.mb, spec.max_bpr)

    def band_kern():
        return fs.flash_sparse_ring_band_fwd(*fargs, *carry,
                                             max_bpr=spec.max_bpr)

    rf["ms"], eager_ms = _graph_ms(band_kern), _time_ms(band_kern)
    rf["plain_ms"] = _time_ms(lambda: fs.flash_sparse_ring_band_fwd_plain(
        *fargs, *carry, max_bpr=spec.max_bpr), reps=3, inner=2)
    q4, k4, v4 = q[None], k[band][None], v[band][None]
    rf["library_ms"] = _library_ms(
        "ring_band_fwd (F.scaled_dot_product_attention, the band's bool "
        "mask)", lambda: F.scaled_dot_product_attention(
            q4, k4, v4, attn_mask=mask_b, scale=1.0), timer=_graph_ms)
    print(f"  ring_band_fwd shard {d} band {band} ({int(pairs)} pairs): "
          f"kernel {rf['ms']:.4f} ms (graph; eager {eager_ms:.4f}; the FMA "
          f"body read 0.4155 eager, SDPA 0.2772, PERF.md), plain "
          f"{rf['plain_ms']:.4f} ms; device split "
          f"{_split_text(_device_split(torch, band_kern))}", flush=True)
    _bound(rf, 4 * pairs * RING_HD,
           _nbytes(q, k[band], v[band]) + 2 * _nbytes(*carry), PEAK_3XTF32)
    print(f"    (at the fp32 FMA peak the operations would take "
          f"{4 * pairs * RING_HD / PEAK_F32 * 1e3:.4f} ms)", flush=True)
    bargs = (*band_meta(band), q, k[band], v[band], g, m, l, D)
    gcarry = [x.clone() for x in (dq, dks[band], dvs[band])]
    # the fullest band (32-slot walks, split in chunks and merged) against
    # its plain version in float64 from the same carries
    got = fs.flash_sparse_ring_band_bwd(*bargs, *[x.clone() for x in gcarry],
                                        max_bpr=spec.max_bpr)
    want = fs.flash_sparse_ring_band_bwd_plain(
        *bargs[:5], *(x.double() for x in bargs[5:]),
        *(x.double() for x in gcarry), max_bpr=spec.max_bpr)
    for name, a, w in zip(("dq", "dk", "dv"), got, want):
        _compare(f"ring_band_bwd fullest band {name} vs float64 plain", a,
                 w.float(), TOL_KERNEL)
    again = fs.flash_sparse_ring_band_bwd(
        *bargs, *[x.clone() for x in gcarry], max_bpr=spec.max_bpr)
    if not torch.equal(got[0], again[0]):
        _fail("ring_band_bwd: dq differs between two calls")
    tiles = fs.flash_split_tiles(R * spec.mb, spec.max_bpr)
    print(f"  ring_band_bwd: {R * spec.mb} walks of <= {spec.max_bpr} slots,"
          f" chunks of {tiles} slots ({-(-spec.max_bpr // tiles)} a walk); "
          f"dq the same bits twice", flush=True)

    def band_bwd():
        return fs.flash_sparse_ring_band_bwd(*bargs, *gcarry,
                                             max_bpr=spec.max_bpr)

    rb["ms"], eager_ms = _graph_ms(band_bwd), _time_ms(band_bwd)
    rb["plain_ms"] = _time_ms(lambda: fs.flash_sparse_ring_band_bwd_plain(
        *bargs, *gcarry, max_bpr=spec.max_bpr), reps=3, inner=2)
    qg, kg, vg = (x.clone().requires_grad_() for x in (q4, k4, v4))
    o = F.scaled_dot_product_attention(qg, kg, vg, attn_mask=mask_b,
                                       scale=1.0)
    rb["library_ms"] = _library_ms(
        "ring_band_bwd (the backward of F.scaled_dot_product_attention, the "
        "band's bool mask)", lambda: torch.autograd.grad(
            o, (qg, kg, vg), g[None], retain_graph=True))
    print(f"  ring_band_bwd shard {d} band {band}: kernel {rb['ms']:.4f} "
          f"ms (graph; eager {eager_ms:.4f}; the FMA body read 0.5728 eager, "
          f"PERF.md), plain {rb['plain_ms']:.4f} ms; device split "
          f"{_split_text(_device_split(torch, band_bwd))}", flush=True)
    _bound(rb, 10 * pairs * RING_HD,
           _nbytes(q, k[band], v[band], g, m, l, D) + 2 * _nbytes(*gcarry),
           PEAK_3XTF32)
    print(f"    (at the fp32 FMA peak the operations would take "
          f"{10 * pairs * RING_HD / PEAK_F32 * 1e3:.4f} ms)", flush=True)

    # B10c at the GQA ring's fullest band, as its backward calls it (group
    # 2: each KV replica's walk runs its two query replicas' slots, 64 a
    # walk), against its plain version in float64, the same bits twice,
    # timed (printed; the JSON's entry is the driver shape's)
    cols = [rmeta[key][d, band][None] for key in (
        "t_src_i", "t_nblocks", "t_mask_slot", "t_is_partial", "pmask")]
    kg, vg = k[band][:R // 2].contiguous(), v[band][:R // 2].contiguous()
    cargs = (*cols, q, kg, vg, g, m, l, D)
    ckw = dict(heads=R, scale=1.0, group=2, max_bpc=spec.max_bpc)
    got = fs.flash_sparse_bwd_dkv(*cargs, **ckw)
    want = fs.flash_sparse_bwd_dkv_plain(
        *cols, *(x.double() for x in cargs[5:]), **ckw)
    for name, a, w in zip(("dk", "dv"), got, want):
        _compare(f"bwd_dkv GQA ring fullest band {name} vs float64 plain", a,
                 w.float(), TOL_KERNEL, kres["flash_sparse_bwd_dkv"])
    if not all(torch.equal(a, b_) for a, b_ in zip(
            got, fs.flash_sparse_bwd_dkv(*cargs, **ckw))):
        _fail("bwd_dkv GQA ring band: two calls differ in their bits")
    walks, longest = (R // 2) * cols[1].shape[1], 2 * spec.max_bpc
    tiles = fs.flash_split_tiles(walks, longest)
    print(f"  bwd_dkv GQA ring band: {walks} walks of <= {longest} slots, "
          f"chunks of {tiles} ({-(-longest // tiles)} a walk, merged in "
          f"chunk order); the same bits twice", flush=True)

    def dkv_band():
        return fs.flash_sparse_bwd_dkv(*cargs, **ckw)

    ms, eager_ms = _graph_ms(dkv_band), _time_ms(dkv_band)
    plain_ms = _time_ms(lambda: fs.flash_sparse_bwd_dkv_plain(*cargs, **ckw),
                        reps=3, inner=2)
    ops = 8 * pairs * RING_HD
    print(f"  bwd_dkv GQA ring fullest band: kernel {ms:.4f} ms (graph; eager "
          f"{eager_ms:.4f}), plain {plain_ms:.4f} ms; device split "
          f"{_split_text(_device_split(torch, dkv_band))}; bound "
          f"{ops / PEAK_3XTF32 * 1e3:.4f} ms ({ops / 1e9:.3f} G op at 165 "
          f"T/s; at the fp32 FMA peak {ops / PEAK_F32 * 1e3:.4f})",
          flush=True)


def _ring_dense(torch, q, k, v, group, scale):
    """Dense causal attention in plain torch, natural order: the ring's
    reference on the card."""
    s = q.shape[1]
    kf, vf = (x.repeat_interleave(group, 0) for x in (k, v))
    sc = (q @ kf.transpose(-1, -2)) * scale
    causal = torch.ones(s, s, dtype=torch.bool, device=q.device).tril()
    return torch.softmax(sc.masked_fill(~causal, -1e30), -1) @ vf


def phase_ring_path(stt, torch, dev, wrappers):
    """Phases 3j / 4j: ``ring_flash_attention`` at the example's config
    (s = 8192 causal, R = 4, hd = 64, 4 shards, 64 x 64 tiles): natural
    and zigzag order with group 1 (B11a, B11b: ndev^2 launches each a
    step) and GQA group 2 (B11a; B10b + B10c), forward and backward,
    held against dense causal attention on the card and the CPU plain
    route; the step timed in both orders; the example's toy regression
    (predict the previous position) for 4 SGD steps, the loss falling."""
    total = {n: 0 for n in wrappers}
    print(f"phase 3j: ring flash attention — s={RING_S} causal, R={RING_R}, "
          f"hd={RING_HD}, {NDEV} shards on the one card, 64x64 tiles",
          flush=True)
    t0 = time.perf_counter()
    specs = {"natural": _ring_spec(stt, False),
             "zigzag": _ring_spec(stt, True)}
    print(f"  specs built in {time.perf_counter() - t0:.1f} s", flush=True)
    for name, spec in specs.items():
        print(f"  ring_compute_balance {name}: "
              f"{spec.ring_compute_balance()}", flush=True)
    n2 = NDEV * NDEV
    cases = (("natural", 1), ("zigzag", 1), ("natural", 2))
    rng = np.random.RandomState(110)
    results = {}
    for name, group in cases:
        spec = specs[name]
        label = f"ring {name} group {group}"
        host = [rng.randn(r, RING_S, RING_HD).astype(np.float32)
                for r in (RING_R, RING_R // group, RING_R // group)]
        cot = torch.from_numpy(rng.randn(RING_R, RING_S, RING_HD).astype(
            np.float32))

        def sharded(x, i):
            x = torch.from_numpy(x)
            return (spec.shard_queries(x) if i == 0 else spec.shard_keys(x))

        gpu = [sharded(x, i).contiguous().to(dev).requires_grad_()
               for i, x in enumerate(host)]
        cot_sh = spec.shard_queries(cot).contiguous().to(dev)

        def step(gpu=gpu, spec=spec, group=group, cot_sh=cot_sh):
            out = stt.parallel.ring_flash_attention(spec, *gpu, group=group)
            (out * cot_sh).sum().backward()
            return out

        bwd = ({"flash_sparse_ring_band_bwd": n2, "flash_sparse_bwd_dq": 0,
                "flash_sparse_bwd_dkv": 0} if group == 1 else
               {"flash_sparse_ring_band_bwd": 0, "flash_sparse_bwd_dq": n2,
                "flash_sparse_bwd_dkv": n2})
        out = _counted(wrappers, total, f"{label} forward + backward", step,
                       {"flash_sparse_ring_band_fwd": n2, **bwd,
                        "flash_sparse_attention_fwd": 0,
                        "flash_sparse_bwd_fused": 0})
        results[(name, group)] = (spec, host, cot, gpu, out.detach())

    print("phase 4j: the ring vs dense causal attention on the card and vs "
          "the CPU plain route (full size)", flush=True)
    for (name, group), (spec, host, cot, gpu, out) in results.items():
        label = f"ring {name} group {group}"
        dense = [torch.from_numpy(x).to(dev).requires_grad_() for x in host]
        ref = _ring_dense(torch, *dense, group, RING_HD ** -0.5)
        (ref * cot.to(dev)).sum().backward()
        _compare(f"{label} output vs dense attention", spec.unshard_output(
            out), ref.detach(), TOL_MODEL)
        grads = [spec.unshard_output(gpu[0].grad)] + [
            spec.unshard_kv(x.grad) for x in gpu[1:]]
        for gname, got, d_ in zip(("dq", "dk", "dv"), grads, dense):
            _compare(f"{label} {gname} vs dense attention", got, d_.grad,
                     TOL_MODEL, floor=0)
        del dense, ref
        t0 = time.perf_counter()
        cpu = [x.detach().cpu().requires_grad_() for x in gpu]
        ref = stt.parallel.ring_flash_attention(spec, *cpu, group=group)
        (ref * spec.shard_queries(cot)).sum().backward()
        _compare(f"{label} output vs the CPU", out.cpu(), ref.detach(),
                 TOL_MODEL)
        for gname, a, c in zip(("dq", "dk", "dv"), gpu, cpu):
            _compare(f"{label} {gname} vs the CPU", a.grad.cpu(), c.grad,
                     TOL_MODEL, floor=0)
        print(f"  CPU reference in {time.perf_counter() - t0:.1f} s",
              flush=True)

    times = {"natural": [], "zigzag": []}
    for name in ("natural", "zigzag", "zigzag", "natural"):
        spec, _, _, gpu, _ = results[(name, 1)]
        cot_sh = torch.ones_like(gpu[0])

        def timed(spec=spec, gpu=gpu, cot_sh=cot_sh):
            for x in gpu:
                x.grad = None
            out = stt.parallel.ring_flash_attention(spec, *gpu)
            (out * cot_sh).sum().backward()

        times[name].append(_time_ms(timed, reps=5, inner=3))
    print(f"  ring step (forward + backward, group 1, CUDA events, in turns "
          f"natural / zigzag / zigzag / natural): natural "
          f"{times['natural'][0]:.4f} / {times['natural'][1]:.4f} ms, "
          f"zigzag {times['zigzag'][0]:.4f} / {times['zigzag'][1]:.4f} ms",
          flush=True)
    try:
        spec, _, _, gpu, _ = results[("zigzag", 1)]
        _profile_steps(torch, "zigzag ring steps", lambda i: (
            stt.parallel.ring_flash_attention(spec, *gpu).sum().backward()))
    except Exception as e:  # a measurement, not a check of the path
        print(f"  torch.profiler gave no device times: {e!r}", flush=True)
    # the GQA ring (natural, group 2): 16 B11a a forward, 16 B10b + 16
    # B10c a backward
    spec, _, _, gpu, _ = results[("natural", 2)]

    def gqa_step(spec=spec, gpu=gpu):
        for x in gpu:
            x.grad = None
        stt.parallel.ring_flash_attention(spec, *gpu, group=2).sum(
            ).backward()

    print(f"  GQA ring step (natural, group 2, CUDA events): "
          f"{_time_ms(gqa_step, reps=5, inner=3):.4f} ms", flush=True)
    try:
        _profile_steps(torch, "GQA ring steps (natural, group 2)",
                       lambda i: gqa_step())
    except Exception as e:  # a measurement, not a check of the path
        print(f"  torch.profiler gave no device times: {e!r}", flush=True)

    # the example's toy regression: predict the previous position
    spec = specs["natural"]
    x = (rng.randn(RING_R, RING_S, RING_HD) * 0.5).astype(np.float32)
    x_sh = spec.shard_queries(torch.from_numpy(x)).contiguous().to(dev)
    t_sh = spec.shard_queries(torch.from_numpy(np.roll(x, 1, axis=1))
                              ).contiguous().to(dev)
    w = {n: torch.ones((), device=dev, requires_grad=True) for n in "qkv"}
    steps, losses = 4, []

    def sgd_step():
        loss = (stt.parallel.ring_flash_attention(
            spec, x_sh * w["q"], x_sh * w["k"], x_sh * w["v"])
            - t_sh).square().mean()
        loss.backward()
        with torch.no_grad():
            for p in w.values():
                p -= 0.5 * p.grad
                p.grad = None
        return loss.item()

    losses = _counted(wrappers, total, f"{steps} SGD steps of the example's "
                      f"regression", lambda: [sgd_step() for _ in
                                              range(steps)],
                      {"flash_sparse_ring_band_fwd": steps * n2,
                       "flash_sparse_ring_band_bwd": steps * n2})
    print(f"  SGD losses {[round(v, 6) for v in losses]}", flush=True)
    if not losses[-1] < losses[0] or not all(np.isfinite(losses)):
        _fail(f"ring SGD: the loss did not fall ({losses})")
    return total


def phase_halo_path(stt, torch, dev, wrappers):
    """Phases 3k / 4k: ``sharded_spmm_halo`` at benchmarks/scaling.py's
    banded problem (8192^2, causal window 1024, q = 512, 4 shards, 64 x 64
    tiles: the interior / halo split, B2 x 2 a shard; backward B4 + B3 a
    shard), then the ragged exchange without the split (8000^2, n_loc =
    2000) and the all_gather (a random 4096^2 d=0.01 mask), forward and
    backward, held against the CPU plain route and, for the banded case,
    against the dense product on the card."""
    from sputnik_tpu_torch.parallel.sharded_ops import _halo_plan

    total = {n: 0 for n in wrappers}
    print(f"phase 3k: halo SpMM — {HALO_S}^2 causal window {HALO_W}, "
          f"q={HALO_Q}, {NDEV} shards, 64x64 tiles; then the ragged and "
          f"the all_gather branches", flush=True)
    runs = {}
    for case, seed in (("banded", 120), ("ragged", 121), ("random", 122)):
        spec, panels_np, dense_np, values = _halo_problem(stt, case, seed)
        n_loc = dense_np.shape[1]
        plan = _halo_plan(spec, n_loc)
        branch = ("all_gather" if plan is None else "split"
                  if n_loc % spec.bk == 0 else "ragged")
        if branch != {"banded": "split", "ragged": "ragged",
                      "random": "all_gather"}[case]:
            _fail(f"halo {case}: took the {branch} branch")
        print(f"  {case}: {spec.part.topo}, n_loc {n_loc}, halo plan "
              f"{plan} -> the {branch} branch", flush=True)
        gpu = [torch.from_numpy(x).to(dev).requires_grad_()
               for x in (panels_np, dense_np)]
        cot = torch.from_numpy(np.random.RandomState(seed + 50).randn(
            NDEV, spec.m_pad_loc, HALO_Q).astype(np.float32))
        cot_d = cot.to(dev)

        def step(spec=spec, gpu=gpu, cot_d=cot_d):
            out = stt.parallel.sharded_spmm_halo(spec, *gpu)
            (out * cot_d).sum().backward()
            return out

        fwd = ({"bsr_spmm_panel_sel": 2 * NDEV, "bsr_spmm_panel": 0}
               if branch == "split" else
               {"bsr_spmm_panel_sel": 0, "bsr_spmm_panel": NDEV})
        out = _counted(wrappers, total, f"halo {case} forward + backward",
                       step, {**fwd, "bsr_sddmm_panel": NDEV,
                              "bsr_spmm_t_panel": NDEV})
        runs[case] = (spec, gpu, cot, out.detach(), values, dense_np)
        if case == "banded":
            def fwd_only(spec=spec, gpu=gpu):
                with torch.no_grad():
                    stt.parallel.sharded_spmm_halo(spec, *gpu)

            def timed(spec=spec, gpu=gpu, cot_d=cot_d):
                for x in gpu:
                    x.grad = None
                (stt.parallel.sharded_spmm_halo(spec, *gpu)
                 * cot_d).sum().backward()

            print(f"  halo {case}: forward {_time_ms(fwd_only):.4f} ms, "
                  f"forward + backward {_time_ms(timed, reps=5):.4f} ms "
                  f"(CUDA events)", flush=True)

    print("phase 4k: the halo SpMM vs the CPU plain route (full size) and, "
          "banded, vs the dense product on the card", flush=True)
    for case, (spec, gpu, cot, out, values, dense_np) in runs.items():
        t0 = time.perf_counter()
        cpu = [x.detach().cpu().requires_grad_() for x in gpu]
        ref = stt.parallel.sharded_spmm_halo(spec, *cpu)
        (ref * cot).sum().backward()
        _compare(f"halo {case} output vs the CPU", out.cpu(), ref.detach(),
                 TOL_MODEL)
        _compare(f"halo {case} d_panels vs the CPU", gpu[0].grad.cpu(),
                 cpu[0].grad, TOL_MODEL, floor=0)
        _compare(f"halo {case} d_dense vs the CPU", gpu[1].grad.cpu(),
                 cpu[1].grad, TOL_MODEL, floor=0)
        print(f"  CPU reference in {time.perf_counter() - t0:.1f} s",
              flush=True)
        if case == "banded":
            topo = spec.part.topo
            a = torch.zeros(topo.m, topo.n, device=dev)
            a[torch.from_numpy(topo.row_ids[: topo.nnz].astype(np.int64)),
              torch.from_numpy(topo.column_indices[: topo.nnz].astype(
                  np.int64))] = torch.from_numpy(values[: topo.nnz]).to(dev)
            want = a @ torch.from_numpy(dense_np.reshape(-1, HALO_Q)).to(dev)
            got = spec.part.unpermute_rows(out.reshape(-1, HALO_Q))
            _compare(f"halo {case} output vs the dense product", got, want,
                     TOL_MODEL)
            del a, want
    return total


def phase_dtype_repair(stt, torch, dev, wrappers):
    """Phase 2m: bf16 and mixed operands through ``stt.panel.spmm`` /
    ``sddmm`` (ELL and compressed) and a bf16 ``SparseLinear`` on an f32
    input launch the f32 kernels once each and return JAX's dtypes."""
    from sputnik_tpu_torch.models import SparseLinear

    print("phase 2m: bf16 / mixed panel operands on the card (f32 kernels, "
          "promoted dtypes)", flush=True)
    total = {n: 0 for n in wrappers}
    rng = np.random.RandomState(130)
    mask = rng.rand(2048, 2048) < 0.05
    topo = stt.SparseTopology.from_dense_mask(mask)
    dense = torch.from_numpy(rng.randn(2048, 256).astype(np.float32))
    for compressed in (False, True):
        spec = stt.PanelSpec(topo, 64, 64, compressed=compressed)
        panel = stt.panel.panel_kaiming_values(
            topo, 64, 64, compressed=compressed,
            generator=torch.Generator().manual_seed(1))
        ks, kd = (("bsr_spmm_panel_c", "bsr_sddmm_panel_c") if compressed
                  else ("bsr_spmm_panel", "bsr_sddmm_panel"))
        tag = "compressed" if compressed else "ELL"
        pb, db = panel.to(dev).bfloat16(), dense.to(dev).bfloat16()
        out = _counted(wrappers, total, f"{tag} spmm bf16 x bf16",
                       lambda: stt.panel.spmm(spec, pb, db), {ks: 1})
        mixed = _counted(wrappers, total, f"{tag} spmm bf16 x f32",
                         lambda: stt.panel.spmm(spec, pb, dense.to(dev)),
                         {ks: 1})
        sc = _counted(wrappers, total, f"{tag} sddmm bf16 x bf16",
                      lambda: stt.panel.sddmm(spec, db[:, :64], db[:, :64]),
                      {kd: 1})
        if (out.dtype, mixed.dtype, sc.dtype) != (
                torch.bfloat16, torch.float32, torch.bfloat16):
            _fail(f"{tag}: dtypes {out.dtype}, {mixed.dtype}, {sc.dtype}")
        ref = stt.panel.spmm(spec, pb.float().cpu(), db.float().cpu())
        _compare(f"{tag} bf16 spmm vs the CPU in f32", out.float().cpu(),
                 ref, 2e-2)
    layer = SparseLinear(topo, dtype=torch.bfloat16, device=dev,
                         generator=torch.Generator().manual_seed(2))
    x = dense.T[:8].contiguous().to(dev).requires_grad_()

    def lin():
        y = layer(x)
        y.sum().backward()
        return y

    y = _counted(wrappers, total, "bf16 SparseLinear forward + backward",
                 lin, {"bsr_spmm_panel": 1, "bsr_sddmm_panel": 1,
                       "bsr_spmm_t_panel": 1})
    if (y.dtype, layer.values.grad.dtype, x.grad.dtype) != (
            torch.float32, torch.bfloat16, torch.float32):
        _fail(f"bf16 SparseLinear: dtypes {y.dtype}, "
              f"{layer.values.grad.dtype}, {x.grad.dtype}")
    print(f"  dtypes: bf16 x bf16 -> bf16, bf16 x f32 -> f32; bf16 "
          f"SparseLinear on f32 -> {y.dtype}, value grad "
          f"{layer.values.grad.dtype}", flush=True)


# -- one graph replay a decode token; remat; the auto crossover ------------

def _eager_generate(torch, srv, tokens, n_new, gen=None, lens=None, **samp):
    """``LMServer.generate``'s loop built from the public calls with every
    decode step eager (the parent's loop): prefill, the head at the last
    real position, then ``decode_step`` / ``decode_step_ragged`` and
    ``sample_logits`` a token. Returns ``(tokens [b, n_new], caches)``."""
    from sputnik_tpu_torch.models import sample_logits

    samp.setdefault("temperature", 0.0)       # generate's default: greedy
    b, P = tokens.shape
    with torch.no_grad():
        caches = srv.init_caches(b)
        if hasattr(srv.decoder, "reserve"):
            caches = srv.decoder.reserve(caches, P + n_new)
        lt = None if lens is None else torch.as_tensor(
            lens, device=tokens.device).long()
        y, caches = srv.decoder.prefill(srv.lm.embed(tokens), caches,
                                        lengths=lt)
        last = y[:, -1] if lt is None else y[torch.arange(b), lt - 1]
        tok = sample_logits(srv.lm.head(last), gen, **samp)
        out = [tok]
        step = srv.decode_step if lt is None else srv.decode_step_ragged
        for _ in range(n_new - 1):
            logits, caches = step(tok, caches)
            tok = sample_logits(logits, gen, **samp)
            out.append(tok)
    return torch.stack(out, 1), caches


def _spread(v):
    return (f"{statistics.median(v):.4f} (min {min(v):.4f}, max "
            f"{max(v):.4f}, {len(v)} turns)")


def _window_profile(torch, fn):
    """torch.profiler over one ``fn()``: (wall ms, device kernel ms, device
    launches); the wall time is the profiled one."""
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    wall = (time.perf_counter() - t0) * 1e3
    dev_ms = launches = 0.0
    for e in prof.key_averages():
        if str(getattr(e, "device_type", "")).endswith("CUDA"):
            dev_ms += getattr(e, "device_time_total", 0.0) / 1e3
            launches += e.count
    return wall, dev_ms, launches


def phase_graph_decode(stt, torch, dev, wrappers, ctx):
    """Decode as one CUDA graph replay a token, against the parent's eager
    loop (``_eager_generate``) on phase 3c's model: tokens (greedy and
    sampled) and lengths bit-equal on four routes, ms/token in turns,
    device kernels a token and busy share; decode_loop at
    examples/generate.py's shape, also with bf16-stored weights
    (cast_params), whose logits are held against the CPU; the example with
    --bf16-params; the continuous-batching and speculative examples at
    their full configs."""
    from sputnik_tpu_torch.examples import (generate, serve_continuous,
                                            serve_speculative)
    from sputnik_tpu_torch.models import (LMServer, SparseDecoder,
                                          SparseTransformer)
    from sputnik_tpu_torch.patterns import causal_mask

    lm, pd = ctx["lm"], ctx["pd"]
    b, P, layers, n = 4, 1024, 6, 65
    print(f"phase 3l: decode as one CUDA graph replay a token vs eager "
          f"steps — phase 3c's SparseLM, generate(pd, {n}) and "
          f"generate(pd, 1), ms/token = (t{n} - t1) / {n - 1}", flush=True)
    total = {k: 0 for k in wrappers}
    routes = {
        "contiguous bf16": (dict(cache_dtype=torch.bfloat16), None),
        "contiguous int8": (dict(cache_dtype=torch.int8), None),
        "contiguous ragged bf16": (dict(cache_dtype=torch.bfloat16),
                                   [1024, 900, 700, 512]),
        "paged bf16": (dict(cache_dtype=torch.bfloat16, n_pages=96), None),
    }
    gen = torch.Generator(device=dev)
    servers = {}
    for name, (kw, lens) in routes.items():
        srv = LMServer(lm, s_max=P + 64, bk=1024, **kw)
        servers[name] = (srv, lens)
        for samp in ({}, dict(temperature=0.8, top_k=40)):
            seed = (lambda: gen.manual_seed(5)) if samp else (lambda: None)
            want, wc = _eager_generate(torch, srv, pd, n, seed(), lens,
                                       **samp)
            got, gc = srv.generate(pd, n, seed(), prompt_lengths=lens,
                                   **samp)
            kind = "sampled T=0.8 top_k=40" if samp else "greedy"
            same = int((got == want).sum())
            lens_eq = all(torch.equal(c.kv_len, w.kv_len)
                          for c, w in zip(gc, wc))
            print(f"  {name}, {kind}: graph tokens equal to the eager "
                  f"loop's {same}/{want.numel()}, lengths equal {lens_eq}",
                  flush=True)
            if same != want.numel() or not lens_eq:
                _fail(f"graph decode {name} {kind}: tokens or lengths "
                      f"differ from the eager loop's")

    def host_ms(fn):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        return (time.perf_counter() - t0) * 1e3

    # (t65 - t1) / 64 holds the warm-up step and the capture; (t65 - t33)
    # / 32 is the steady replay a token
    half = (n + 1) // 2
    times = {(r, m): [] for r in routes for m in ("graph", "eager")}
    steady = {(r, m): [] for r in routes for m in ("graph", "eager")}
    for pair in range(5):
        for name in (routes if pair % 2 == 0 else list(routes)[::-1]):
            srv, lens = servers[name]
            modes = (("graph", lambda k: srv.generate(
                         pd, k, prompt_lengths=lens)),
                     ("eager", lambda k: _eager_generate(
                         torch, srv, pd, k, lens=lens)))
            for mode, fn in (modes if pair % 2 == 0 else modes[::-1]):
                t_n = host_ms(lambda: fn(n))
                t_h = host_ms(lambda: fn(half))
                t_1 = host_ms(lambda: fn(1))
                times[(name, mode)].append((t_n - t_1) / (n - 1))
                steady[(name, mode)].append((t_n - t_h) / (n - half))
    result = {}
    for name in routes:
        srv, lens = servers[name]
        line = []
        for mode, fn in (("graph", lambda k: srv.generate(
                              pd, k, prompt_lengths=lens)),
                         ("eager", lambda k: _eager_generate(
                             torch, srv, pd, k, lens=lens))):
            _, d_n, l_n = _window_profile(torch, lambda: fn(n))
            _, d_1, l_1 = _window_profile(torch, lambda: fn(1))
            per = (l_n - l_1) / (n - 1)
            dev_ms = (d_n - d_1) / (n - 1)
            ms = times[(name, mode)]
            result[(name, mode)] = statistics.median(ms)
            line.append(f"{mode} {_spread(ms)} ms/token, steady "
                        f"{_spread(steady[(name, mode)])}; {per:.1f} device "
                        f"launches and {dev_ms:.4f} ms of kernels a token "
                        f"(profiled), busy {dev_ms / statistics.median(ms):.1%}"
                        f" of the median")
        print(f"  decode {name}: " + "; ".join(line), flush=True)

    # decode_loop at examples/generate.py's full shape, f32 and bf16 weights
    Pg, hg, n_loop = 2048, 1024, 64
    masks = np.broadcast_to(causal_mask(Pg), (b, Pg, Pg)).copy()
    model = SparseTransformer.from_masks(
        masks, num_layers=layers, hidden_size=hg, num_heads=8,
        ffn_hidden_size=4096, use_residual=True, use_layernorm=True,
        activation="gelu", generator=torch.Generator().manual_seed(0),
        device=dev).eval()
    cast = SparseDecoder.cast_params(copy.deepcopy(model))
    x = torch.from_numpy(np.random.RandomState(0).randn(
        b, Pg, hg).astype(np.float32) * 0.3).to(dev)
    decs = {"f32 weights": SparseDecoder(model, s_max=Pg + n_loop, bk=1024),
            "bf16 weights": SparseDecoder(cast, s_max=Pg + n_loop, bk=1024)}
    starts = {}
    for name, dec in decs.items():
        y, caches = dec.prefill(x, dec.init_caches(b))
        starts[name] = (y[:, -1:], caches)
    loop_ms = {(k, m): [] for k in decs for m in ("graph", "eager")}

    def eager_loop(dec, tok, caches):
        ys = []
        for _ in range(n_loop):
            y, caches = dec.decode_step(tok, caches)
            ys.append(y)
            tok = y
        return torch.stack(ys)

    for name, dec in decs.items():
        tok, caches = starts[name]
        ys_g, _ = dec.decode_loop(tok, tuple(c.clone() for c in caches),
                                  n_loop)
        ys_e = eager_loop(dec, tok, tuple(c.clone() for c in caches))
        if not torch.equal(ys_g, ys_e):
            _fail(f"decode_loop {name}: the graph's outputs differ from "
                  f"the eager steps' (max "
                  f"{(ys_g - ys_e).abs().max().item():.3e})")
    for pair in range(3):
        for name in (decs if pair % 2 == 0 else list(decs)[::-1]):
            dec = decs[name]
            tok, caches = starts[name]
            modes = (("graph", lambda c: dec.decode_loop(tok, c, n_loop)),
                     ("eager", lambda c: eager_loop(dec, tok, c)))
            for mode, fn in (modes if pair % 2 == 0 else modes[::-1]):
                cl = tuple(c.clone() for c in caches)
                loop_ms[(name, mode)].append(host_ms(lambda: fn(cl))
                                             / n_loop)
    for name in decs:
        print(f"  decode_loop b={b} P={Pg} h={hg} {layers}L, {name}, "
              f"{n_loop} tokens: graph {_spread(loop_ms[(name, 'graph')])} "
              f"ms/token, eager {_spread(loop_ms[(name, 'eager')])} "
              f"ms/token; outputs bit-equal", flush=True)
    del decs, starts, model, cast

    # bf16-stored weights on phase 3c's model against the CPU copy
    k = 8
    toks32 = ctx["mha32"][0][:, :k]
    lm16 = SparseDecoder.cast_params(copy.deepcopy(lm))
    cpu16 = SparseDecoder.cast_params(copy.deepcopy(ctx["cpu_lm"]))
    gpu = _teacher_forced_logits(LMServer(lm16, s_max=P + 64, bk=1024,
                                          cache_dtype=torch.float32),
                                 pd, toks32).cpu()
    cpu = _teacher_forced_logits(LMServer(cpu16, s_max=P + 64, bk=1024,
                                          cache_dtype=torch.float32),
                                 ctx["prompt"], toks32.cpu())
    _compare(f"bf16-weights (cast_params) logits, {k} positions x {b} "
             f"sequences, card vs the CPU", gpu, cpu, TOL_MODEL)
    srv16 = LMServer(lm16, s_max=P + 64, bk=1024)
    bf16_ms = []
    for _ in range(3):
        t_n = host_ms(lambda: srv16.generate(pd, n))
        t_1 = host_ms(lambda: srv16.generate(pd, 1))
        bf16_ms.append((t_n - t_1) / (n - 1))
    print(f"  generate with bf16-stored weights (bf16 cache): "
          f"{_spread(bf16_ms)} ms/token", flush=True)
    del lm16, cpu16, srv16
    _counted(wrappers, total, "examples/generate.py --bf16-params "
             "--tokens 256", lambda: generate.main(["--bf16-params",
                                                    "--tokens", "256"]),
             # a 2-token decode_loop warm-up, then the timed loop
             {"decode_attention": 2 * layers * GRAPH_COUNTED,
              "ragged_append": 2 * layers * GRAPH_COUNTED})
    out = _counted(wrappers, total, "examples/serve_continuous (full "
                   "config)", lambda: serve_continuous.main([]), {})
    print(f"  serve_continuous: {out}", flush=True)
    out = _counted(wrappers, total, "examples/serve_speculative (full "
                   "config)", lambda: serve_speculative.main([]), {})
    print(f"  serve_speculative: plain {out['plain_ms_per_token']:.4f} "
          f"ms/token; draft 0.02 {out['spec_0.02']}; early exit "
          f"{out['spec_early_exit']}", flush=True)
    torch.cuda.empty_cache()
    return total, result


def _driver_model(torch, dev, s, b=4, layers=6, **kw):
    """The reference driver's SparseTransformer (h=512, 8 heads, ffn 2048,
    residual, LayerNorm, gelu) over its masks at sequence ``s``."""
    from sputnik_tpu_torch.models import SparseTransformer
    from sputnik_tpu_torch.patterns import driver_masks

    return SparseTransformer.from_masks(
        driver_masks(b, s), num_layers=layers, hidden_size=512, num_heads=8,
        ffn_hidden_size=2048, use_residual=True, use_layernorm=True,
        activation="gelu", generator=torch.Generator().manual_seed(40),
        device=dev, **kw)


def phase_remat(stt, torch, dev, wrappers):
    """SparseTransformer(remat=True) against remat=False on the driver
    config: gradients of one step, B9's wrapper calls a step (6 -> 12),
    step time in turns and peak memory; peak memory at s = 8192."""
    flash = wrappers["flash_sparse_attention_fwd"]
    total = {k: 0 for k in wrappers}
    print("phase 3m: remat — the driver's SparseTransformer (6L b=4 s=512 "
          "h=512 8 heads), remat=False vs True, forward + backward; then "
          "b=1 s=8192", flush=True)
    for b, s in ((4, 512), (1, 8192)):
        models = {False: _driver_model(torch, dev, s, b)}
        models[True] = copy.deepcopy(models[False])
        models[True].remat = True
        g = torch.Generator().manual_seed(41)
        x = torch.randn(b, s, 512, generator=g).to(dev)
        y = torch.randn(b, s, 512, generator=g).to(dev)

        def step(m):
            m.zero_grad(set_to_none=True)
            torch.mean((m(x) - y) ** 2).backward()

        grads, peak = {}, {}
        for r, m in models.items():
            step(m)                              # builds the metadata
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats(dev)
            base = torch.cuda.memory_allocated(dev)
            calls = _counted(wrappers, total, f"remat={r} b={b} s={s} step",
                             lambda: (step(m), flash.launches)[1],
                             {"flash_sparse_attention_fwd": 12 if r else 6})
            peak[r] = torch.cuda.max_memory_allocated(dev) - base
            grads[r] = {k: p.grad.detach().clone()
                        for k, p in m.named_parameters()}
            print(f"  remat={r} b={b} s={s}: B9 wrapper calls a step "
                  f"{calls}, peak device memory above the weights "
                  f"{peak[r] / 2**20:.1f} MiB", flush=True)
        worst = 0.0
        for k, ref in grads[False].items():
            err = (grads[True][k] - ref).abs().max().item()
            bound = 1e-4 * max(1.0, ref.abs().max().item())
            worst = max(worst, err / bound)
            if not err <= bound:
                _fail(f"remat b={b} s={s}: gradient {k} differs by {err} > "
                      f"{bound}")
        ms = {False: [], True: []}
        for pair in range(5 if s == 512 else 2):
            for r in ((False, True) if pair % 2 == 0 else (True, False)):
                ms[r].extend(_step_times(torch, lambda: step(models[r]), 1))
        print(f"  b={b} s={s}: gradients within 1e-4 x max(1, max|ref|) "
              f"(worst {worst:.3f} of the bound); step ms remat=False "
              f"{_spread(ms[False])}, remat=True {_spread(ms[True])}; peak "
              f"memory ratio {peak[True] / peak[False]:.3f}", flush=True)
        del models, grads
        torch.cuda.empty_cache()
    return total


CROSSOVER_LENGTHS = (128, 256, 512, 1024, 2048, 4096)


def phase_crossover(stt, torch, dev, wrappers):
    """The xla and flash layouts of the driver's widths (b=4, h=512, 8
    heads, ffn 2048; 2 layers), forward and forward + backward, in turns
    at each length: the readings behind ``_XLA_FLASH_CROSSOVER``."""
    from sputnik_tpu_torch.models import transformer as ttr

    print(f"phase 3n: the auto crossover — driver widths, 2 layers, xla vs "
          f"flash at s in {CROSSOVER_LENGTHS}, 3 turns each", flush=True)
    total = {k: 0 for k in wrappers}
    rows = []
    for s in CROSSOVER_LENGTHS:
        models = {"xla": _driver_model(torch, dev, s, layers=2,
                                       attention_layout="xla")}
        models["flash"] = _driver_model(torch, dev, s, layers=2)
        g = torch.Generator().manual_seed(42)
        x = torch.randn(4, s, 512, generator=g).to(dev)

        def fwd(m):
            with torch.no_grad():
                m(x)

        def step(m):
            m.zero_grad(set_to_none=True)
            m(x).square().mean().backward()

        for m in models.values():
            step(m)
        got = {(k, w): [] for k in models for w in ("fwd", "step")}
        for turn in range(3):
            for k in (("xla", "flash") if turn % 2 == 0
                      else ("flash", "xla")):
                got[(k, "fwd")].append(_time_ms(lambda: fwd(models[k]),
                                                reps=3, inner=3, warmup=1))
                got[(k, "step")].append(_time_ms(lambda: step(models[k]),
                                                 reps=3, inner=2, warmup=1))
        med = {key: statistics.median(v) for key, v in got.items()}
        rows.append((s, med))
        print(f"  s={s}: forward xla {_spread(got[('xla', 'fwd')])} ms, "
              f"flash {_spread(got[('flash', 'fwd')])} ms; forward + "
              f"backward xla {_spread(got[('xla', 'step')])} ms, flash "
              f"{_spread(got[('flash', 'step')])} ms", flush=True)
        del models
        torch.cuda.empty_cache()
    # the least length from which flash is no slower, forward and step
    cross = None
    for s, med in reversed(rows):
        if (med[("flash", "fwd")] <= med[("xla", "fwd")]
                and med[("flash", "step")] <= med[("xla", "step")]):
            cross = s
        else:
            break
    print(f"  crossover read here: "
          f"{cross if cross is not None else 'none tested'}; the package's "
          f"_XLA_FLASH_CROSSOVER = {ttr._XLA_FLASH_CROSSOVER}", flush=True)
    return total


# -- the rest of the sequence-parallel op family --------------------------

# benchmarks/scaling.py's attention problem: s = 32768, a +-256 window,
# R = 4, hd = 64, on 8 shards of the one card
SP_NDEV, SP_S, SP_W, SP_R, SP_HD = 8, 32768, 256, 4, 64


def _grad_step(fn, xs, cot):
    """One forward and backward of ``sum(fn(*xs) * cot)``, the inputs'
    gradients cleared first; returns the output."""
    def step():
        for x in xs:
            x.grad = None
        out = fn(*xs)
        (out * cot).sum().backward()
        return out
    return step


def _against_cpu(torch, label, fn, xs, cot, out, names):
    """The card's output and gradients (``xs[i].grad``) against the CPU
    plain route on the same inputs, at full size."""
    t0 = time.perf_counter()
    cpu = [x.detach().cpu().requires_grad_() for x in xs]
    ref = fn(*cpu)
    (ref * cot.cpu()).sum().backward()
    _compare(f"{label} output vs the CPU", out.detach().cpu(), ref.detach(),
             TOL_MODEL)
    for name, a, c in zip(names, xs, cpu):
        _compare(f"{label} {name} vs the CPU", a.grad.cpu(), c.grad,
                 TOL_MODEL, floor=0)
    print(f"  CPU reference in {time.perf_counter() - t0:.1f} s", flush=True)


def _in_turns(label, steps, order, **kw):
    """Each named step timed by CUDA events (``_time_ms``) in ``order``;
    prints and returns the readings by name."""
    got = {name: [] for name in steps}
    for name in order:
        got[name].append(_time_ms(steps[name], **kw))
    print(f"  {label} (forward + backward, CUDA events, in turns "
          f"{' / '.join(order)}): " + "; ".join(
              f"{n} {' / '.join(f'{t:.4f}' for t in v)} ms"
              for n, v in got.items()), flush=True)
    return got


def phase_sharded_panel(stt, torch, dev, wrappers):
    """Phases 3o / 4o: the replicated-operand sharded panel ops.
    ``sharded_spmm`` forward + backward at bench.py's 4096^3 d=0.1 on 1 and
    8 shards (B1, B4, B3 a shard, the psum of d_dense) against
    ``stt.panel.spmm`` on the same topology and tiles, timed in turns (the
    seam's cost); then ``sparse_attention_sharded`` and its compressed twin
    (B4 / B14, B5 / B15a + B15b, B1 / B13a, B3 / B13b) on a +-256 window of
    32768 (hd = 64) and on the skewed 4096^2 pattern (width 64), 8 shards,
    each timed; every path against the CPU plain route."""
    from sputnik_tpu_torch.patterns import local_window_topology

    P = stt.parallel
    total = {n: 0 for n in wrappers}
    print(f"phase 3o: sharded panel ops — sharded_spmm at 4096^3 d=0.1 on 1 "
          f"and {SP_NDEV} shards vs stt.panel.spmm; sparse_attention_"
          f"sharded(_c) on 8 shards", flush=True)
    _, mat = _bench_matrix(stt)
    topo, n = mat.topology, 4096
    rng = np.random.RandomState(140)
    dense, cot = (torch.from_numpy(rng.randn(n, n).astype(np.float32)).to(
        dev) for _ in range(2))
    pspec = stt.PanelSpec(topo)
    xs = [torch.from_numpy(stt.panel.values_to_panel_np(
        topo, mat.values, 64, 64)).to(dev).requires_grad_(),
        dense.clone().requires_grad_()]
    steps = {"unsharded": _grad_step(
        lambda p, d: stt.panel.spmm(pspec, p, d), xs, cot)}
    want = _counted(wrappers, total, "stt.panel.spmm forward + backward",
                    steps["unsharded"], {"bsr_spmm_panel": 1,
                                         "bsr_sddmm_panel": 1,
                                         "bsr_spmm_t_panel": 1}).detach()
    d_want = xs[1].grad.clone()
    for shards in (1, SP_NDEV):
        spec = P.ShardedPanelSpec(P.RowPartition(topo, shards,
                                                 balance=False))
        sx = [torch.from_numpy(spec.stack_values(mat.values)).to(
            dev).requires_grad_(), dense.clone().requires_grad_()]
        c = cot.reshape(shards, n // shards, n)

        def fn(p, d, spec=spec):
            return P.sharded_spmm(spec, p, d)

        steps[f"{shards} shards"] = _grad_step(fn, sx, c)
        out = _counted(wrappers, total, f"sharded_spmm {shards} shards "
                       f"forward + backward", steps[f"{shards} shards"],
                       {"bsr_spmm_panel": shards, "bsr_sddmm_panel": shards,
                        "bsr_spmm_t_panel": shards})
        _compare(f"sharded_spmm {shards} shards vs stt.panel.spmm",
                 out.detach().reshape(n, n), want, TOL_MODEL)
        _compare(f"sharded_spmm {shards} shards d_dense vs stt.panel.spmm",
                 sx[1].grad, d_want, TOL_MODEL, floor=0)
        if shards == SP_NDEV:
            _against_cpu(torch, f"sharded_spmm {shards} shards", fn, sx, c,
                         out, ("d_panels", "d_dense"))
    _in_turns("sharded_spmm at 4096^3 d=0.1", steps,
              ["unsharded", "1 shards", "8 shards", "8 shards", "1 shards",
               "unsharded"], reps=5, inner=3)
    del steps, xs, sx

    problems = {
        f"window +-{SP_W} of {SP_S}": (local_window_topology(SP_S, SP_W),
                                        False),
        "skewed 4096^2": (stt.SparseTopology.from_dense_mask(
            _skewed_mask()), True)}
    for label, (topo, balance) in problems.items():
        part = P.RowPartition(topo, SP_NDEV, balance=balance)
        print(f"  {label}: {topo}, {SP_NDEV} shards (balance={balance}), "
              f"m_loc {part.m_loc}", flush=True)
        ax = [torch.from_numpy(rng.randn(*s).astype(np.float32)).to(dev)
              for s in ((SP_NDEV, part.m_loc, SP_HD), (topo.n, SP_HD),
                        (topo.n, SP_HD), (SP_NDEV, part.m_loc, SP_HD))]
        steps = {}
        for layout in ("ELL", "compressed"):
            if layout == "ELL":
                spec, fn0 = P.ShardedPanelSpec(part), P.sparse_attention_sharded
                kn = {"bsr_sddmm_panel": 2, "bsr_spmm_panel": 2,
                      "bsr_spmm_t_panel": 2, "panel_softmax": 1,
                      "panel_softmax_bwd": 1}
            else:
                spec = P.ShardedCompressedSpec(part)
                fn0 = P.sparse_attention_sharded_c
                kn = {"bsr_sddmm_panel_c": 2, "bsr_spmm_panel_c": 2,
                      "bsr_spmm_t_panel_c": 2, "c_softmax_stats": 1,
                      "c_softmax_apply": 1, "c_softmax_rowsum": 1,
                      "c_softmax_grad": 1}
            gx = [x.clone().requires_grad_() for x in ax[:3]]

            def fn(q, k, v, spec=spec, fn0=fn0):
                return fn0(spec, q, k, v)

            steps[layout] = _grad_step(fn, gx, ax[3])
            out = _counted(wrappers, total, f"{label} sparse_attention_"
                           f"sharded {layout}", steps[layout],
                           {k: c * SP_NDEV for k, c in kn.items()})
            _against_cpu(torch, f"{label} {layout} attention", fn, gx, ax[3],
                         out, ("dq", "dk", "dv"))
        _in_turns(f"{label} sharded attention", steps,
                  ["ELL", "compressed", "compressed", "ELL"], reps=5,
                  inner=3)
        try:
            _profile_steps(torch, f"{label} ELL attention steps",
                           lambda i: steps["ELL"](), n=4)
        except Exception as e:  # a measurement, not a check of the path
            print(f"  torch.profiler gave no device times: {e!r}",
                  flush=True)
    return total


def phase_flash_sharded(stt, torch, dev, wrappers):
    """Phases 3p / 4p: sequence-parallel flash attention at
    benchmarks/scaling.py's attention problem (s = 32768, a +-256 window,
    R = 4, hd = 64, 8 shards): ``flash_attention_sharded`` (K / V
    replicated; B9, B10a, the dk / dv psums; at group 1 and 2, and once on
    the two-kernel route B10b + B10c by setting the budget to 0) and
    ``flash_attention_kv_sharded`` with the interior / halo split (B9 twice
    a shard; the budget sends it to B10b + B10c) and without (B9, B10a),
    at group 1 and 2, each against the CPU plain route, timed in turns
    against ``fused_sparse_attention`` unsharded on the same topology."""
    from sputnik_tpu_torch.ops import fused_attention as fa
    from sputnik_tpu_torch.patterns import local_window_topology

    P, nd = stt.parallel, SP_NDEV
    total = {n: 0 for n in wrappers}
    print(f"phase 3p: sharded flash attention — s={SP_S}, window +-{SP_W}, "
          f"R={SP_R}, hd={SP_HD}, {nd} shards; fused_sparse_attention "
          f"unsharded beside", flush=True)
    topo = local_window_topology(SP_S, SP_W)
    spec = P.ShardedFlashSpec(P.RowPartition(topo, nd, balance=False))
    n_loc = spec.n_pad // nd
    plan = spec.halo_plan(n_loc)
    hd_pad = fa._hd_pad(SP_HD)
    ov_fused = (2 * (n_loc // spec.bk + spec.kb) * spec.bk * hd_pad * 4
                <= fa._FUSED_BWD_ACC_BYTES)
    rep_fused = fa._use_fused_bwd(spec, hd_pad)
    print(f"  halo rows {spec.halo_extents(n_loc)}, plan {plan}: "
          f"kv-sharded takes the {'split' if plan and n_loc % 64 == 0 else 'monolithic'} "
          f"branch by default; backward routes: replicated / monolithic "
          f"{'B10a' if rep_fused else 'B10b + B10c'} (2 x {spec.n_pad} x "
          f"{hd_pad} x 4 B vs {fa._FUSED_BWD_ACC_BYTES} B), split "
          f"{'B10a' if ov_fused else 'B10b + B10c'}", flush=True)
    rng = np.random.RandomState(150)

    def sh(x):
        R, s, hd = x.shape
        return x.reshape(R, nd, s // nd, hd).transpose(0, 1).contiguous()

    host = {g: [torch.from_numpy(rng.randn(r, SP_S, SP_HD).astype(
        np.float32)).to(dev) for r in (SP_R, SP_R // g, SP_R // g)]
        for g in (1, 2)}
    cot = torch.from_numpy(rng.randn(SP_R, SP_S, SP_HD).astype(
        np.float32)).to(dev)
    bspec = stt.BatchedPanelSpec([topo], heads=SP_R)

    def route(fused):
        return ({"flash_sparse_bwd_fused": 1} if fused else
                {"flash_sparse_bwd_dq": 1, "flash_sparse_bwd_dkv": 1})

    cases = [("unsharded", 1, None), ("replicated", 1, None),
             ("replicated", 2, None), ("replicated", 1, 0),
             ("kv split", 1, None), ("kv split", 2, None),
             ("kv monolithic", 1, None), ("kv monolithic", 2, None)]
    steps, keep = {}, fa._FUSED_BWD_ACC_BYTES
    for kind, g, budget in cases:
        label = f"{kind} group {g}" + ("" if budget is None else
                                       ", budget 0 (B10b + B10c)")
        if kind == "unsharded":
            xs = [x.clone().requires_grad_() for x in host[g]]
            c = cot

            def fn(q, k, v, g=g):
                return stt.fused_sparse_attention(bspec, q, k, v, group=g)
            n_walk, fused = 1, rep_fused
        elif kind == "replicated":
            xs = [sh(host[g][0]).requires_grad_()] + [
                x.clone().requires_grad_() for x in host[g][1:]]
            c = sh(cot)

            def fn(q, k, v, g=g):
                return P.flash_attention_sharded(spec, q, k, v, group=g)
            n_walk, fused = nd, rep_fused and budget is None
        else:
            xs = [sh(x).requires_grad_() for x in host[g]]
            c, ov = sh(cot), kind == "kv split"

            def fn(q, k, v, g=g, ov=ov):
                return P.flash_attention_kv_sharded(spec, q, k, v, group=g,
                                                    overlap=ov)
            n_walk = 2 * nd if ov else nd
            fused = ov_fused if ov else rep_fused
        step = _grad_step(fn, xs, c)
        if budget is not None:
            fa._FUSED_BWD_ACC_BYTES = budget
        try:
            out = _counted(wrappers, total, f"{label} forward + backward",
                           step, {"flash_sparse_attention_fwd": n_walk,
                                  **{k: v * n_walk for k, v in
                                     route(fused).items()}})
            _against_cpu(torch, label, fn, xs, c, out, ("dq", "dk", "dv"))
            if g == 1 and budget is None:
                steps[kind] = step
        finally:
            fa._FUSED_BWD_ACC_BYTES = keep
    _in_turns("sharded flash at group 1", steps,
              ["unsharded", "replicated", "kv split", "kv monolithic",
               "kv monolithic", "kv split", "replicated", "unsharded"],
              reps=5, inner=3)
    for kind, step in steps.items():
        try:
            _profile_steps(torch, f"{kind} flash steps", lambda i: step(),
                           n=4)
        except Exception as e:  # a measurement, not a check of the path
            print(f"  torch.profiler gave no device times: {e!r}",
                  flush=True)
    return total


def phase_seq_parallel(stt, torch, dev, wrappers):
    """Phase 3q: ``examples/train_seq_parallel.py`` at its full config (8
    shards of s = 16384, hd 64, R 4; the kv-sharded split over a window of
    2048, B9 twice a shard, B10a; the natural ring, B11a and B11b 64 times
    a pass), its self-checks (dense attention at init, the loss falls),
    then ``dryrun_sp`` at 4, 6, 8 and 16 shards, every path's loss against
    the CPU's, both halos on the ragged exchange (B2 launched)."""
    from sputnik_tpu_torch.dryrun import dryrun_sp
    from sputnik_tpu_torch.examples import train_seq_parallel as ex

    total = {n: 0 for n in wrappers}
    cfg = ex.config(False)
    print(f"phase 3q: examples/train_seq_parallel.py at its full config "
          f"({ex.NDEV} shards, {cfg}); dryrun_sp at 4, 6, 8, 16", flush=True)
    walks, steps = 2 * ex.NDEV, cfg["steps"]
    ring = ex.NDEV * ex.NDEV
    res = _counted(wrappers, total, "train_seq_parallel", lambda: ex.main(
        ["--device", str(dev)]), {
            "flash_sparse_attention_fwd": walks * (steps + 1),
            "flash_sparse_bwd_fused": walks * steps,
            "flash_sparse_ring_band_fwd": ring * (steps + 1),
            "flash_sparse_ring_band_bwd": ring * steps})
    for name, r in res.items():
        print(f"  {name}: step ms {[round(t, 4) for t in r['step_ms']]}, "
              f"losses {[round(v, 6) for v in r['losses']]}", flush=True)
    for n in (4, 6, 8, 16):
        got = _counted(wrappers, total, f"dryrun_sp({n})",
                       lambda n=n: dryrun_sp(n, dev), {})
        with contextlib.redirect_stdout(io.StringIO()):
            ref = dryrun_sp(n, "cpu")
        for path, v in got["losses"].items():
            err = abs(v - ref["losses"][path])
            if not err <= TOL_MODEL * max(1.0, abs(ref["losses"][path])):
                _fail(f"dryrun_sp({n}) {path}: loss {v} vs the CPU's "
                      f"{ref['losses'][path]}")
        print(f"  dryrun_sp({n}): {len(got['losses'])} paths' losses within "
              f"{TOL_MODEL} of the CPU's (relative)", flush=True)
    if not total["bsr_spmm_panel_sel"]:
        _fail("the dry runs' halo SpMM launched no B2")
    return total


def _tp_cases():
    """Phase 3r's routes: (label, mesh axes, batch axis, KV heads, paged)."""
    return [("tp 2", {"tp": 2}, None, None, False),
            ("tp 2 paged", {"tp": 2}, None, None, True),
            ("tp 4", {"tp": 4}, None, None, False),
            ("tp 4 paged", {"tp": 4}, None, None, True),
            ("dp 2 x tp 2", {"dp": 2, "tp": 2}, "dp", None, False),
            ("GQA kv_heads=2, tp 2", {"tp": 2}, None, 2, False)]


def _gen_ms(torch, gen, n_new):
    """ms a decode token of ``gen(n)`` (a generate of n tokens): (wall of
    n_new tokens - wall of 1) / (n_new - 1), each the median of 3
    synchronised calls."""
    def wall(n):
        ts = []
        for _ in range(3):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            gen(n)
            torch.cuda.synchronize()
            ts.append(time.perf_counter() - t0)
        return statistics.median(ts)

    return (wall(n_new) - wall(1)) * 1e3 / (n_new - 1)


def _nccl_world_of_one(torch, dev, lm, pd, n_new, kw, want, counted):
    """An NCCL world of 1 (FileStore in a temporary directory): the mesh's
    collectives on a CUDA tensor against the one-device mesh's, then
    ``TPLMServer`` greedy at tp 1 through ``all_reduce`` under
    ``counted(fn)`` (the launch count), its tokens equal to the one-device
    mesh's (``want``). Returns the all_reduce count and the bf16-cache
    ms/token there."""
    import os
    import tempfile

    import torch.distributed as dist
    from sputnik_tpu_torch.parallel import Mesh, TPLMServer

    with tempfile.TemporaryDirectory() as tmp:
        store = dist.FileStore(os.path.join(tmp, "store"), 1)
        dist.init_process_group("nccl", store=store, rank=0, world_size=1)
        try:
            mesh = Mesh({"tp": 1}, distributed=True)
            if mesh.device != dev:
                _fail(f"NCCL mesh on {mesh.device}, expected {dev}")
            one = Mesh({"tp": 1}, device=dev)
            x = torch.arange(24.0, device=dev).reshape(4, 6)
            for name, fn in (
                    ("psum", lambda m: m.psum([x], "tp")),
                    ("all_gather", lambda m: m.all_gather([x], "tp", 1)),
                    ("psum_scatter", lambda m: m.psum_scatter([x], "tp")),
                    ("ppermute", lambda m: m.ppermute([x], "tp",
                                                      [(0, 0)]))):
                if not torch.equal(fn(mesh)[0], fn(one)[0]):
                    _fail(f"NCCL world of 1: {name} differs from the "
                          f"one-device mesh's")
            try:
                mesh.psum([x.cpu()], "tp")
                _fail("NCCL mesh took a CPU tensor")
            except ValueError:
                pass
            calls = [0]
            real = dist.all_reduce

            def count_all_reduce(*a, **k):
                calls[0] += 1
                return real(*a, **k)

            srv = TPLMServer(lm, mesh, **kw)
            dist.all_reduce = count_all_reduce
            try:
                toks, _ = counted(lambda: srv.generate(pd, n_new))
            finally:
                dist.all_reduce = real
            if not torch.equal(toks, want):
                _fail("NCCL world of 1: TPLMServer tokens differ from the "
                      "one-device mesh's")
            srv = TPLMServer(lm, mesh, **dict(kw, cache_dtype=torch.bfloat16))
            return calls[0], _gen_ms(
                torch, lambda n: srv.generate(pd, n), n_new)
        finally:
            dist.destroy_process_group()


def phase_tp_serving(stt, torch, dev, wrappers):
    """Phase 3r: tensor-parallel serving (``TPLMServer``) at
    benchmarks/serving.py's full config on one-device CUDA meshes, each
    route held against the unsharded ``LMServer`` on the card, then an
    NCCL world of 1 and ``dryrun_tp_serving(4)``."""
    from sputnik_tpu_torch.dryrun import dryrun_tp_serving
    from sputnik_tpu_torch.models import LMServer, SparseLM
    from sputnik_tpu_torch.parallel import Mesh, TPLMServer
    from sputnik_tpu_torch.patterns import causal_mask

    b, P, h, heads, layers, ffn, V, n_new, bk = (4, 1024, 1024, 8, 6, 4096,
                                                 32000, 64, 1024)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True).stdout.strip().splitlines()[0]
    print(f"phase 3r: tensor-parallel serving — TPLMServer on one-device "
          f"meshes, SparseLM {layers}L b={b} P={P} h={h} heads={heads} "
          f"ffn={ffn} V={V}, s_max=P+64, bk={bk}, {n_new} new tokens, "
          f"greedy; eager steps; on {smi}", flush=True)
    masks = np.broadcast_to(causal_mask(P), (b, P, P)).copy()
    pd = torch.from_numpy(np.random.RandomState(31).randint(
        0, V, (b, P))).to(dev)
    total = {n: 0 for n in wrappers}
    models = {}

    def model(kv):
        if kv not in models:
            models[kv] = SparseLM.from_masks(
                masks, vocab_size=V, num_layers=layers, hidden_size=h,
                num_heads=heads, num_kv_heads=kv, ffn_hidden_size=ffn,
                use_residual=True, use_layernorm=True, activation="gelu",
                generator=torch.Generator().manual_seed(30 + (kv or 0))
            ).eval().to(dev)
        return models[kv]

    def kw(paged, dtype, batch_axis=None):
        out = dict(s_max=P + 64, bk=bk, cache_dtype=dtype)
        if batch_axis:
            out["batch_axis"] = batch_axis
        if paged:        # a pool a position: b rows x KV_l heads x 2 pages
            out["n_pages"] = 2 * b * heads
        return out

    refs = {}
    for label, axes, batch_axis, kv, paged in _tp_cases():
        lm = model(kv)
        if kv not in refs:
            ref = LMServer(lm, **kw(False, torch.float32))
            bf = LMServer(lm, **kw(False, torch.bfloat16))
            refs[kv] = (ref, ref.generate(pd, n_new)[0], _gen_ms(
                torch, lambda n: bf.generate(pd, n), n_new), _gen_ms(
                torch, lambda n: _eager_generate(torch, bf, pd, n), n_new))
            print(f"  unsharded LMServer (KV heads {kv or heads}), bf16 "
                  f"cache: {refs[kv][2]:.4f} ms/token by CUDA graph, "
                  f"{refs[kv][3]:.4f} eager, on {smi}", flush=True)
        ref, ref_toks, ref_ms, ref_eager = refs[kv]
        mesh = Mesh(axes, device=dev)
        srv = TPLMServer(lm, mesh, **kw(paged, torch.float32, batch_axis))
        n_sh = mesh.size
        steps = layers * n_sh * (n_new - 1)
        attn, app = (("paged_attention", "paged_append") if paged else
                     ("decode_attention", "ragged_append"))
        toks, _ = _counted(
            wrappers, total, f"TPLMServer {label}",
            lambda: srv.generate(pd, n_new),
            {"flash_sparse_attention_fwd": layers * n_sh, attn: steps,
             app: steps})
        got = _teacher_forced_logits(srv, pd, toks).cpu()
        want = _teacher_forced_logits(ref, pd, toks).cpu()
        _compare(f"TPLMServer {label} teacher-forced logits vs the unsharded "
                 f"LMServer (fp32 cache)", got, want, TOL_MODEL)
        bound = TOL_MODEL * max(1.0, want.abs().max().item())
        top2 = want.topk(2, dim=-1).values
        gap = top2[..., 0] - top2[..., 1]
        miss = (want.argmax(-1).T != toks.cpu()) & (gap.T >= bound)
        if miss.any():
            _fail(f"TPLMServer {label}: {int(miss.sum())} greedy tokens are "
                  f"not the unsharded argmax with a top-2 gap >= {bound:.3e}")
        same = float((toks == ref_toks).float().mean())
        bf = TPLMServer(lm, mesh, **kw(paged, torch.bfloat16, batch_axis))
        ms = _gen_ms(torch, lambda n: bf.generate(pd, n), n_new)
        print(f"  TPLMServer {label}: all {toks.numel()} greedy tokens are "
              f"the unsharded argmax (or within a top-2 gap < {bound:.3e}: "
              f"{int((gap < bound).sum())} positions); share equal to the "
              f"unsharded generate {same:.4f}; bf16 cache {ms:.4f} ms/token "
              f"eager against the unsharded LMServer's {ref_eager:.4f} "
              f"eager and {ref_ms:.4f} by CUDA graph, on {smi}", flush=True)
        if label == "tp 2":
            tp2_toks = toks

    # an NCCL world of 1 through the same server, tp = 1
    lm = model(None)
    one = TPLMServer(lm, Mesh({"tp": 1}, device=dev),
                     **kw(False, torch.float32))
    want = one.generate(pd, n_new)[0]
    one_bf = TPLMServer(lm, Mesh({"tp": 1}, device=dev),
                        **kw(False, torch.bfloat16))
    one_ms = _gen_ms(torch, lambda n: one_bf.generate(pd, n), n_new)
    n_ar, nccl_ms = _nccl_world_of_one(
        torch, dev, lm, pd, n_new, kw(False, torch.float32), want,
        lambda fn: _counted(
            wrappers, total, "TPLMServer tp 1 on an NCCL world of 1", fn,
            {"flash_sparse_attention_fwd": layers,
             "decode_attention": layers * (n_new - 1),
             "ragged_append": layers * (n_new - 1)}))
    if n_ar != 2 * layers * n_new:
        _fail(f"NCCL world of 1: {n_ar} all_reduce calls, expected "
              f"{2 * layers * n_new} (2 a layer, prefill + {n_new - 1} "
              f"steps)")
    same = float((want == tp2_toks).float().mean())
    print(f"  NCCL world of 1: collectives equal to the one-device mesh's; "
          f"TPLMServer tokens equal to the one-device tp 1 mesh's, "
          f"{n_ar} all_reduce calls; tp 1 vs tp 2 tokens equal share "
          f"{same:.4f}; bf16 cache tp 1 {nccl_ms:.4f} ms/token on NCCL, "
          f"{one_ms:.4f} on the one-device mesh, on {smi}", flush=True)
    diffs = _counted(wrappers, total, "dryrun_tp_serving(4)",
                     lambda: dryrun_tp_serving(4, dev), {})
    print(f"  dryrun_tp_serving(4): {len(diffs)} routes within 1e-4 of the "
          f"unsharded decoder, max {max(diffs.values()):.3e}", flush=True)
    return total


# -- training over a mesh: the pipeline and expert parallelism --------------

# the pipeline's stages: 4 TransformerLayers at the MoE example's width
PP_NDEV, PP_MB, PP_S, PP_H, PP_HEADS, PP_FFN = 4, 2, 512, 512, 8, 2048


def _hold_grads(label, got, ref):
    """Every gradient through :func:`_compare` (within TOL_MODEL x its
    reference's max|.|, a zero reference failing), one line for all."""
    worst, name = max((_compare(f"{label} {k}", got[k], r, TOL_MODEL,
                                floor=0, quiet=True), k)
                      for k, r in ref.items())
    print(f"  {label}: {len(ref)} gradients within {TOL_MODEL} x max|ref|, "
          f"the worst ({name}) at {worst:.3e} of its limit", flush=True)


def _pp_problem(torch, dev, n_stages, seed):
    """``n_stages`` full-width flash-layout TransformerLayers (causal s=512,
    microbatches of 2): the template layer and the stacked stages."""
    from sputnik_tpu_torch import ManyMaskTopology
    from sputnik_tpu_torch.models import TransformerLayer
    from sputnik_tpu_torch.parallel import stack_stage_params
    from sputnik_tpu_torch.patterns import causal_mask

    mt = ManyMaskTopology.from_dense_masks(np.broadcast_to(
        causal_mask(PP_S), (PP_MB, PP_S, PP_S)).copy())
    layers = [TransformerLayer(
        mt, PP_H, PP_HEADS, PP_FFN, activation="gelu", use_residual=True,
        use_layernorm=True, attention_layout="flash",
        generator=torch.Generator().manual_seed(seed + i), device=dev)
        for i in range(n_stages)]
    return layers[0], {k: v.detach() for k, v in stack_stage_params(
        [dict(l.named_parameters()) for l in layers]).items()}


def _pp_steps(torch, mesh, layer, stacked):
    """``(pipelined, sequential)``: each ``fn(n_micro, x, y)`` one forward
    and backward of ``mean((out - y) ** 2)`` on fresh leaves of
    ``stacked``, returning ``(out, loss, grads)``. The sequential step runs
    each microbatch through the stages one after another."""
    from torch.func import functional_call

    from sputnik_tpu_torch.parallel import PipelineSpec, pipeline_apply

    def stage(p, xm):
        return functional_call(layer, p, (xm,))

    def run(fwd, x, y):
        leaves = {k: v.clone().requires_grad_() for k, v in stacked.items()}
        out = fwd(leaves, x)
        loss = (out - y).square().mean()
        loss.backward()
        return out.detach(), loss.detach(), {k: v.grad for k, v in
                                             leaves.items()}

    def pipelined(n_micro, x, y):
        return run(lambda p, xx: pipeline_apply(
            PipelineSpec(mesh, n_micro=n_micro), stage, p, xx), x, y)

    def sequential(n_micro, x, y):
        def fwd(p, xx):
            outs = []
            for xm in xx.chunk(n_micro):
                for i in range(next(iter(p.values())).shape[0]):
                    xm = stage({k: v[i] for k, v in p.items()}, xm)
                outs.append(xm)
            return torch.cat(outs)
        return run(fwd, x, y)

    return pipelined, sequential


def _moe_step(model, x, y):
    """One forward and backward of the MoE example's loss (MSE + 0.01 x
    aux): ``(out, loss, {name: grad})``, the gradients kept."""
    for p in model.parameters():
        p.grad = None
    out = model(x)
    loss = (out - y).square().mean() + 0.01 * model.aux_loss()
    loss.backward()
    return out.detach(), loss.detach(), {
        k: p.grad.detach().clone() for k, p in model.named_parameters()}


def _counting_all_reduce():
    """``dist.all_reduce`` wrapped with a call count; ``(calls, undo)``."""
    import torch.distributed as dist

    calls, real = [0], dist.all_reduce

    def counted(*a, **k):
        calls[0] += 1
        return real(*a, **k)

    dist.all_reduce = counted

    def undo():
        dist.all_reduce = real
    return calls, undo


def _nccl_training(torch, dev, smi, counted, ref_model, ref):
    """An NCCL world of 1 (FileStore in a temporary directory): each
    collective's gradient on a CUDA tensor against the one-device mesh's,
    the pipeline at pp 1 against the one-device mesh and the sequential
    stack, and the MoE example at ep 1 against the unsharded model
    (``ref_model`` and its step ``ref``), ``dist.all_reduce`` calls
    counted."""
    import os
    import tempfile

    import torch.distributed as dist
    from sputnik_tpu_torch.examples import train_moe_transformer as ex
    from sputnik_tpu_torch.parallel import Mesh

    with tempfile.TemporaryDirectory() as tmp:
        store = dist.FileStore(os.path.join(tmp, "store"), 1)
        dist.init_process_group("nccl", store=store, rank=0, world_size=1)
        try:
            mesh = Mesh({"pp": 1}, distributed=True)
            one = Mesh({"pp": 1}, device=dev)
            for name, fn in (
                    ("psum", lambda m, x: m.psum([x], "pp")),
                    ("pvary", lambda m, x: m.pvary([x], "pp")),
                    ("all_gather", lambda m, x: m.all_gather([x], "pp", 1)),
                    ("psum_scatter", lambda m, x: m.psum_scatter([x], "pp")),
                    ("ppermute", lambda m, x: m.ppermute([x], "pp",
                                                         [(0, 0)]))):
                grads = []
                for m in (mesh, one):
                    x = torch.arange(24.0, device=dev).reshape(4, 6)
                    x.requires_grad_()
                    (fn(m, x)[0] * (x.detach() + 1)).sum().backward()
                    grads.append(x.grad)
                if not torch.equal(*grads):
                    _fail(f"NCCL world of 1: {name}'s gradient differs from "
                          f"the one-device mesh's")
            layer, stacked = _pp_problem(torch, dev, 1, 60)
            g = torch.Generator().manual_seed(61)
            x = torch.randn(4 * PP_MB, PP_S, PP_H, generator=g).to(dev)
            y = torch.randn(4 * PP_MB, PP_S, PP_H, generator=g).to(dev)
            nccl_pipe, seq = _pp_steps(torch, mesh, layer, stacked)
            one_pipe, _ = _pp_steps(torch, one, layer, stacked)
            calls, undo = _counting_all_reduce()
            try:
                got = counted("pipeline pp 1 on an NCCL world of 1",
                              lambda: nccl_pipe(4, x, y))
            finally:
                undo()
            n_pp = calls[0]
            for label, (o, l, gr) in (("the one-device mesh",
                                       one_pipe(4, x, y)),
                                      ("the sequential stack",
                                       seq(4, x, y))):
                _compare(f"pp 1 on NCCL: output vs {label}", got[0], o,
                         1e-4)
                _compare(f"pp 1 on NCCL: loss vs {label}", got[1][None],
                         l[None], 1e-4)
                _hold_grads(f"pp 1 on NCCL vs {label}", got[2], gr)

            ep = Mesh({"ep": 1}, distributed=True)
            model, xm, ym = ex.build(False, dev, mesh=ep)
            model.load_state_dict(ref_model.state_dict())
            calls, undo = _counting_all_reduce()
            try:
                got = counted("MoE example ep 1 on an NCCL world of 1",
                              lambda: _moe_step(model, xm, ym))
            finally:
                undo()
            n_ep = calls[0]
            _compare("ep 1 on NCCL: output vs the unsharded model", got[0],
                     ref[0], 1e-4)
            _compare("ep 1 on NCCL: loss vs the unsharded model",
                     got[1][None], ref[1][None], 1e-4)
            _hold_grads("ep 1 on NCCL vs the unsharded model", got[2],
                        ref[2])
            n_moe = len(ex.moe_layers(ref_model))
            # pp: the output's psum (x takes no gradient); ep: each MoE
            # layer's psum forward, its input's and gates' pvary backward
            if n_pp != 1 or n_ep != 3 * n_moe:
                _fail(f"NCCL world of 1: {n_pp} / {n_ep} all_reduce calls, "
                      f"expected 1 (pp) / {3 * n_moe} (ep)")
            print(f"  NCCL world of 1: every collective's gradient equal to "
                  f"the one-device mesh's; pp 1 {n_pp} all_reduce a step, "
                  f"ep 1 {n_ep} ({n_moe} MoE layers: a psum forward, two "
                  f"pvary backward), on {smi}", flush=True)
        finally:
            dist.destroy_process_group()


def phase_mesh_training(stt, torch, dev, wrappers):
    """Phase 3s: training over a mesh. The GPipe pipeline (4 full-width
    flash-layout stages, n_micro 4 and 8 microbatches of 2) and the MoE
    example's full config expert-parallel at ep 4, both on one-device CUDA
    meshes, each held against the unsharded model on the card (outputs and
    losses within 1e-4 x max(1, max|ref|), gradients within 1e-3 x
    max|ref|), their steps timed in turns against it and profiled; then an
    NCCL world of 1 (pp 1, ep 1) and ``dryrun_pp(4)`` / ``dryrun_ep(4)``."""
    from sputnik_tpu_torch.dryrun import dryrun_ep, dryrun_pp
    from sputnik_tpu_torch.examples import train_moe_transformer as ex
    from sputnik_tpu_torch.parallel import Mesh

    t_phase = time.perf_counter()
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True).stdout.strip().splitlines()[0]
    print(f"phase 3s: training over a mesh — the pipeline ({PP_NDEV} "
          f"TransformerLayer stages, h={PP_H}, {PP_HEADS} heads, ffn "
          f"{PP_FFN}, causal s={PP_S}, flash, microbatches of {PP_MB}) and "
          f"the MoE example's full config at ep 4, on one-device meshes; "
          f"on {smi}", flush=True)
    total = {n: 0 for n in wrappers}

    def counted(label, fn, expect=None):
        return _counted(wrappers, total, label, fn, expect or {})

    layer, stacked = _pp_problem(torch, dev, PP_NDEV, 50)
    pipe, seq = _pp_steps(torch, Mesh({"pp": PP_NDEV}, device=dev), layer,
                          stacked)
    walls = {}
    for n_micro in (4, 8):
        T = n_micro + PP_NDEV - 1
        g = torch.Generator().manual_seed(51 + n_micro)
        x = torch.randn(n_micro * PP_MB, PP_S, PP_H, generator=g).to(dev)
        y = torch.randn(n_micro * PP_MB, PP_S, PP_H, generator=g).to(dev)
        got = {}
        for name, fn in (("sequential", seq), ("pipeline", pipe)):
            torch.cuda.synchronize()
            for w in wrappers.values():
                w.launches = 0
            got[name] = fn(n_micro, x, y)
            torch.cuda.synchronize()
            got[name + " launches"] = {n: w.launches for n, w in
                                       wrappers.items() if w.launches}
            for n, w in wrappers.items():
                total[n] += w.launches
        want = {n: c * T // n_micro
                for n, c in got["sequential launches"].items()}
        print(f"  n_micro {n_micro}: launches a step, sequential "
              f"{got['sequential launches']}, pipeline "
              f"{got['pipeline launches']} (T = {T} steps of {PP_NDEV} "
              f"stages)", flush=True)
        if got["pipeline launches"] != want:
            _fail(f"pipeline n_micro {n_micro}: launches "
                  f"{got['pipeline launches']}, expected {want}")
        (o, l, gr), (ro, rl, rg) = got["pipeline"], got["sequential"]
        _compare(f"pipeline n_micro {n_micro} output vs the sequential "
                 f"stack", o, ro, 1e-4)
        _compare(f"pipeline n_micro {n_micro} loss vs the sequential stack",
                 l[None], rl[None], 1e-4)
        _hold_grads(f"pipeline n_micro {n_micro} vs the sequential stack",
                    gr, rg)
        steps = {"pipeline": lambda: pipe(n_micro, x, y),
                 "sequential": lambda: seq(n_micro, x, y)}
        turns = {k: [] for k in steps}
        for name in ("pipeline", "sequential", "sequential", "pipeline"):
            turns[name].append(statistics.median(
                _step_times(torch, steps[name], 5)))
        walls[n_micro] = turns
        ratio = statistics.median(turns["pipeline"]) / statistics.median(
            turns["sequential"])
        print(f"  n_micro {n_micro}: step ms (forward + backward, host clock "
              f"synchronized, median of 5, in turns pipeline / sequential / "
              f"sequential / pipeline): pipeline "
              f"{' / '.join(f'{t:.4f}' for t in turns['pipeline'])}, "
              f"sequential "
              f"{' / '.join(f'{t:.4f}' for t in turns['sequential'])}; "
              f"ratio {ratio:.4f} against T / n_micro = {T / n_micro:.4f} "
              f"(the analytic bubble share n_micro / T = {n_micro / T:.4f}, "
              f"measured {1 / ratio:.4f}), on {smi}", flush=True)
        if n_micro == 4:
            for name in ("pipeline", "sequential"):
                _profile_steps(torch, f"{name} steps, n_micro 4",
                               lambda i, f=steps[name]: f(), 3)

    # expert parallelism: the MoE example at ep 4 on the one-device mesh
    model, x, y = ex.build(False, dev, mesh=Mesh({"ep": 4}, device=dev))
    ref_model, _, _ = ex.build(False, dev)
    for (k, a), b in zip(model.state_dict().items(),
                         ref_model.state_dict().values()):
        if not torch.equal(a, b):
            _fail(f"ep 4 model: {k} differs from the unsharded model's")
    n_moe, layers = len(ex.moe_layers(model)), len(model.layers)
    bank = {"spmm_bh": 2 * n_moe, "sddmm_bh": 2 * n_moe,
            "spmm_t_bh": 2 * n_moe, "flash_sparse_attention_fwd": layers,
            "flash_sparse_bwd_fused": layers}
    # the unsharded step's gradients, for the NCCL world of 1 too
    ref = counted("MoE example step, unsharded", lambda: _moe_step(
        ref_model, x, y), bank)
    got = counted("MoE example step, ep 4 (one-device mesh)",
                  lambda: _moe_step(model, x, y),
                  dict(bank, spmm_bh=8 * n_moe, sddmm_bh=8 * n_moe,
                       spmm_t_bh=8 * n_moe))
    for i, m in ex.moe_layers(model).items():
        if not torch.equal(m.last_experts, ref_model.layers[i].mlp
                           .last_experts):
            _fail(f"ep 4: MoE layer {i} routes differently")
    _compare("ep 4 output vs the unsharded model", got[0], ref[0], 1e-4)
    _compare("ep 4 loss vs the unsharded model", got[1][None], ref[1][None],
             1e-4)
    _hold_grads("ep 4 vs the unsharded model", got[2], ref[2])
    opts = {"ep 4": torch.optim.Adam(model.parameters(), lr=1e-3),
            "unsharded": torch.optim.Adam(ref_model.parameters(), lr=1e-3)}
    steps = {"ep 4": lambda: ex.train_step(model, opts["ep 4"], x, y),
             "unsharded": lambda: ex.train_step(ref_model,
                                                opts["unsharded"], x, y)}
    turns = {k: [] for k in steps}
    for name in ("ep 4", "unsharded", "unsharded", "ep 4"):
        turns[name].append(statistics.median(
            _step_times(torch, steps[name], 5)))
    print(f"  MoE example Adam step ms (host clock synchronized, median of "
          f"5, in turns ep 4 / unsharded / unsharded / ep 4): ep 4 "
          f"{' / '.join(f'{t:.4f}' for t in turns['ep 4'])}, unsharded "
          f"{' / '.join(f'{t:.4f}' for t in turns['unsharded'])}, on {smi}",
          flush=True)
    for name in ("ep 4", "unsharded"):
        _profile_steps(torch, f"MoE {name} steps",
                       lambda i, f=steps[name]: f(), 3)
    del model, opts

    # the Adam steps moved the parameters: the unsharded step again
    ref = _moe_step(ref_model, x, y)
    _nccl_training(torch, dev, smi, counted, ref_model, ref)
    for fn in (dryrun_pp, dryrun_ep):
        got = counted(f"{fn.__name__}(4)", lambda f=fn: f(4, dev))
        print(f"  {fn.__name__}(4): loss {got['loss']:.6f}, max difference "
              f"from the unsharded {got['max_diff']:.3e}", flush=True)
    print(f"  phase 3s in {time.perf_counter() - t_phase:.1f} s", flush=True)
    return total


def main(argv=None) -> int:
    """No arguments: every phase, then the kernels' JSON line and the
    device line. ``--only NAME[,NAME]`` runs just the named phase functions
    (``phase_moe_train``, ``phase_ring_path``, ...: the part after
    ``phase_``) on the package beside this script and prints no JSON line:
    a copy of the script placed in another checkout measures that checkout
    the same way, for comparisons in one call."""
    import torch

    argv = sys.argv[1:] if argv is None else argv
    only = None
    if argv:
        if len(argv) != 2 or argv[0] != "--only":
            print("usage: chip_smoke.py [--only phase[,phase]]",
                  file=sys.stderr)
            return 2
        only = argv[1].split(",")
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
    func = ""
    for line in _build.build_log().splitlines():
        if "Function properties for" in line:
            func = line.split("Function properties for")[1].strip()[:60]
        elif "registers" in line or "spill" in line:
            print(f"  {func}: {line.strip()}", flush=True)

    wrappers = kernel_wrappers()
    kres = {n: {} for n in wrappers}
    if only is not None:
        # the phases that also take bench.py's matrix (w, mat)
        mat_args = {"int8_kernels": lambda w, m: (w, m),
                    "softmax_kernel": lambda w, m: (m,),
                    "softmax_routes": lambda w, m: (m,),
                    "flat_path": lambda w, m: (m, w)}
        ctx = None          # phase_serving's model, for the phases after it
        for name in only:
            fn = globals()[f"phase_{name}"]
            extra = (mat_args[name](*_bench_matrix(stt)) if name in mat_args
                     else ())
            if name in ("paged_serving", "graph_decode"):
                extra = (ctx,)
            out = fn(stt, torch, dev, wrappers if name.endswith(
                ("_path", "_train", "serving", "_repair", "graph_decode",
                 "remat", "crossover", "sharded_panel", "flash_sharded",
                 "seq_parallel", "mesh_training")) else kres, *extra)
            if name == "serving":
                ctx = out[1]
        print(f"chip_smoke: --only {','.join(only)} done", flush=True)
        return 0
    seconds = {}

    def run(fn, *args):
        t = time.perf_counter()
        out = fn(stt, torch, dev, *args)
        seconds[fn.__name__[len("phase_"):]] = round(
            time.perf_counter() - t, 1)
        return out

    run(phase_kernels, kres)
    run(phase_flash_backward, kres)
    run(phase_serving_kernels, kres)
    run(phase_paged_kernels, kres)
    run(phase_batched_kernels, kres)
    w, mat = _bench_matrix(stt)
    run(phase_softmax_kernel, kres, mat)
    run(phase_int8_kernels, kres, w, mat)
    run(phase_compressed_kernels, kres)
    run(phase_parallel_kernels, kres)
    run(phase_dtype_repair, wrappers)
    fwd = run(phase_main_path, wrappers)
    train = run(phase_train, wrappers)
    serve, ctx = run(phase_serving, wrappers)
    paged = run(phase_paged_serving, wrappers, ctx)
    graph, _ = run(phase_graph_decode, wrappers, ctx)
    del ctx
    remat = run(phase_remat, wrappers)
    cross = run(phase_crossover, wrappers)
    moe = run(phase_moe_train, wrappers)
    flat = run(phase_flat_path, wrappers, mat, w)
    int8 = run(phase_int8_path, wrappers)
    comp = run(phase_compressed_path, wrappers)
    ring = run(phase_ring_path, wrappers)
    halo = run(phase_halo_path, wrappers)
    spanel = run(phase_sharded_panel, wrappers)
    sflash = run(phase_flash_sharded, wrappers)
    seq = run(phase_seq_parallel, wrappers)
    tps = run(phase_tp_serving, wrappers)
    mtrain = run(phase_mesh_training, wrappers)
    launches = {n: fwd[n] + train[n] + serve[n] + paged[n] + graph[n]
                + remat[n] + cross[n] + moe[n] + flat[n] + int8[n] + comp[n]
                + ring[n] + halo[n] + spanel[n] + sflash[n] + seq[n] + tps[n]
                + mtrain[n] for n in wrappers}
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
                        "plain_ms": r["plain_ms"], "bound_ms": r["bound_ms"],
                        "bound_by": r["bound_by"],
                        "library_ms": r["library_ms"]})
    print(f"phase seconds (host clock, {time.perf_counter() - t0:.1f} s "
          f"since the build started): {json.dumps(seconds)}", flush=True)
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
