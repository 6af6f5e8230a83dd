"""A dry run of the sequence-parallel layer at ``n`` shards (counterpart of
the sequence-parallel parts of the JAX package's
``__graft_entry__.dryrun_multichip``: ``_dryrun_sp`` and
``_dryrun_sharded_compressed``), on the one-device seam.

:func:`dryrun_sp` takes one gradient of ``sum(out ** 2)`` through each
sharded path, every gradient finite:

  * ``sparse_attention_sharded`` and ``flash_attention_sharded`` on a causal
    topology (K / V replicated);
  * ``flash_attention_kv_sharded`` and ``sharded_spmm_halo`` on a local
    window, wide enough in shards that both halos take the ragged exchange
    (the interior / halo split: ``n_loc`` is whole 64-blocks);
  * ``ring_flash_attention`` on the zigzag partition of a causal topology;
  * ``sparse_attention_sharded_c`` on a band with a dense row;

then prints ``DRYRUN_COMM`` from :mod:`parallel.comm_model` and raises if
either halo fell back to the dense gather. The shapes follow ``n`` so that
every path's rule holds at any ``n``: the zigzag ring's ``n_pad % (2 * n *
bk) == 0``, the key sharding's ``n_pad % n == 0``.

:func:`dryrun_tp_serving` is the twin of ``_dryrun_tp_serving`` and
``_dryrun_tp_serving_ragged_spec`` on the one-device mesh: tensor- (and,
at an even ``n > 2``, data-) parallel prefill and decode, paged decode, a
ragged freeze / resume and a speculative ``decode_multi`` + rollback,
every output finite and within 1e-4 x max(1, max|ref|) of the unsharded
decoder's.

:func:`dryrun_pp` and :func:`dryrun_ep` are the twins of ``_dryrun_pp`` and
``_dryrun_ep``: ``n`` pipelined ``TransformerLayer`` stages (mb=2, s=16,
h=32, 2 heads, ffn 48, the panel layout, two microbatches) and a top-2
``SparseMoE`` of ``n`` experts (h=32, f=48, density 0.4) over ``n``
positions, one gradient of ``mean(out ** 2)`` each, finite and within 1e-4
x max(1, max|ref|) of the unsharded sequential stack / module; on the
ranks of a process-group mesh also within 1e-6 x max(1, max|ref|) of the
one-device mesh's.

Run:  python -m sputnik_tpu_torch.dryrun [--n 4,6,8,16] [--device cuda]

or, the pipeline and expert parallelism over one position a rank (NCCL on
cards, gloo on the CPU; ``torchrun`` sets the world on ``localhost``):

      torchrun --nproc-per-node 4 -m sputnik_tpu_torch.dryrun [--device cpu]
"""

from __future__ import annotations

import argparse
import datetime
import json
import os

import numpy as np
import torch
from torch.func import functional_call

from .many_mask import ManyMaskTopology
from .models import (PagedDecoder, SparseDecoder, SparseMoE,
                     SparseTransformer, TransformerLayer)
from .parallel import (Mesh, PagedTPDecoder, PipelineSpec, RingFlashSpec,
                       RowPartition, ShardedCompressedSpec, ShardedFlashSpec,
                       ShardedPanelSpec, TPDecoder, comm_model,
                       flash_attention_kv_sharded, flash_attention_sharded,
                       pipeline_apply, ring_flash_attention,
                       sharded_spmm_halo, sparse_attention_sharded,
                       sparse_attention_sharded_c, stack_stage_params)
from .patterns import causal_topology, local_window_topology
from .topology import SparseTopology

__all__ = ["dryrun_sp", "dryrun_tp_serving", "dryrun_pp", "dryrun_ep",
           "main"]

TILE = 64          # the kernels' bm = bk
HD, Q = 32, 48     # attention head dim, the halo SpMM's width


def _banded_dense_rows(m: int, n: int) -> SparseTopology:
    """``_dryrun_sharded_compressed``'s pattern: a 16-wide band walking the
    columns, plus a dense row."""
    mask = np.zeros((m, n), bool)
    for r in range(m):
        lo = max(0, r * n // m - 8)
        mask[r, lo: lo + 16] = True
    mask[3] = True
    return SparseTopology.from_dense_mask(mask)


def dryrun_sp(n_devices: int, device="cuda", seed: int = 0) -> dict:
    """One gradient through every sequence-parallel path at ``n_devices``
    shards on ``device``; returns ``{"losses": {path: loss}, "comm":
    DRYRUN_COMM's dict}``."""
    n, dev = int(n_devices), torch.device(device)
    rng = np.random.RandomState(seed)
    losses = {}

    def grad_of(name, fn, *shapes, values=()):
        xs = [torch.from_numpy(x).to(dev).requires_grad_() for x in
              list(values) + [rng.randn(*s).astype(np.float32)
                              for s in shapes]]
        loss = fn(*xs).square().sum()
        loss.backward()
        losses[name] = float(loss.detach())
        if not np.isfinite(losses[name]) or not all(
                torch.isfinite(x.grad).all() for x in xs):
            raise RuntimeError(f"dryrun_sp({n}): non-finite {name}")

    # causal, K / V replicated: 2 row blocks a shard
    s = 2 * n * TILE
    part = RowPartition(causal_topology(s), n, balance=False)
    spec, fspec = ShardedPanelSpec(part), ShardedFlashSpec(part)
    grad_of("attention", lambda q, k, v: sparse_attention_sharded(
        spec, q, k, v), (n, s // n, HD), (s, HD), (s, HD))
    grad_of("attention_flash", lambda q, k, v: flash_attention_sharded(
        fspec, q, k, v), (n, 1, s // n, HD), (1, s, HD), (1, s, HD))

    # a local window (|i - j| < 64) over 4 key blocks a shard: one halo
    # block each side, so the exchange and its split
    sb = 4 * n * TILE
    bpart = RowPartition(local_window_topology(sb, TILE), n, balance=False)
    bspec, pspec = ShardedFlashSpec(bpart), ShardedPanelSpec(bpart)
    n_loc = bspec.n_pad // n
    grad_of("attention_kv_halo", lambda q, k, v: flash_attention_kv_sharded(
        bspec, q, k, v), (n, 2, sb // n, HD), (n, 2, n_loc, HD),
        (n, 2, n_loc, HD))
    grad_of("spmm_halo", lambda p, d: sharded_spmm_halo(pspec, p, d),
            (n, n_loc, Q), values=[pspec.stack_values(rng.randn(
                bpart.topo.nnz_pad).astype(np.float32))])

    # the zigzag ring over the causal topology
    rspec = RingFlashSpec(RowPartition(causal_topology(s), n, zigzag=True))
    grad_of("attention_ring", lambda q, k, v: ring_flash_attention(
        rspec, q, k, v), (n, 2, s // n, HD), (n, 2, rspec.n_loc, HD),
        (n, 2, rspec.n_loc, HD))

    # the compressed layout on a band with a dense row (balanced rows)
    cpart = RowPartition(_banded_dense_rows(s, 8 * TILE), n)
    cspec = ShardedCompressedSpec(cpart)
    grad_of("attention_compressed", lambda q, k, v:
            sparse_attention_sharded_c(cspec, q, k, v),
            (n, cpart.m_loc, HD), (8 * TILE, HD), (8 * TILE, HD))

    cm = comm_model
    comm = {
        "n_devices": n,
        "attention": cm.attention_comm_bytes(spec, HD),
        "attention_kv_halo": cm.attention_halo_comm_bytes(
            bspec, HD, n_loc, kv_replicas=2),
        "attention_ring": cm.attention_ring_comm_bytes(
            rspec.n_loc, HD, n, kv_replicas=2),
        "spmm": cm.spmm_comm_bytes(spec, HD),
        "spmm_halo": cm.spmm_halo_comm_bytes(pspec, n_loc, Q),
        # causal load balance: the zigzag partition the ring runs against
        # the contiguous one, and what the slowest shard costs
        "nnz_balance": cm.nnz_balance(rspec.part),
        "nnz_balance_contiguous": cm.nnz_balance(part),
        "nnz_balance_compressed": cm.nnz_balance(cpart),
    }
    ring_fwd = comm["attention_ring"]["fwd"]
    comm["causal_worst_device_projection"] = {
        name: cm.project_scaling(1.0, ring_fwd, n, worst_device_factor=comm[
            key]["max_over_mean"])
        for name, key in (("contiguous", "nnz_balance_contiguous"),
                          ("zigzag", "nnz_balance"))}
    for key in ("spmm_halo", "attention_kv_halo"):
        if comm[key]["dense_fallback"]:
            raise RuntimeError(f"dryrun_sp({n}): {key} fell back to the "
                               f"dense gather")
    print("DRYRUN_COMM " + json.dumps(comm, default=float), flush=True)
    return {"losses": losses, "comm": comm}


def _hold(label, got, ref, tol) -> float:
    """max |got - ref|, raising unless finite and within ``tol`` x max(1,
    max|ref|)."""
    d = float((got - ref).abs().max())
    if not (torch.isfinite(got).all() and
            d <= tol * max(1.0, float(ref.abs().max()))):
        raise RuntimeError(f"{label}: {d} from the reference")
    return d


def _tp_model(b, s, heads, layers, seed, device):
    """``_dryrun_tp_serving``'s model: causal masks, one head a tp position
    (``heads``), h = 8 heads, ffn = 16 heads."""
    masks = np.broadcast_to(np.tril(np.ones((s, s), np.float32)),
                            (b, s, s)).copy()
    return SparseTransformer.from_masks(
        masks, num_layers=layers, hidden_size=8 * heads, num_heads=heads,
        ffn_hidden_size=16 * heads, use_residual=True, use_layernorm=True,
        activation="gelu", generator=torch.Generator().manual_seed(seed),
        device=device)


def dryrun_tp_serving(n_devices: int, device="cuda", seed: int = 0) -> dict:
    """Tensor-parallel serving at ``n_devices`` positions of a one-device
    mesh on ``device``: dp 2 x tp n/2 where ``n`` is even and > 2, else tp
    n, one head a tp position. Prefill and a decode step (contiguous), a
    paged prefill + step, then at tp = n a ragged step freezing one slot, a
    step resuming it, ``decode_multi`` of 3 drafts, a rollback of 1 and a
    step. Each output is finite and within 1e-4 x max(1, max|ref|) of the
    unsharded decoder's on the same inputs. Returns ``{route: max abs
    difference}``."""
    n, dev = int(n_devices), torch.device(device)
    rng = np.random.RandomState(seed)
    diffs = {}

    def hold(route, got, ref):
        diffs[route] = _hold(f"dryrun_tp_serving({n}) {route}", got, ref,
                             1e-4)

    def act(*shape):
        return torch.from_numpy(
            (rng.randn(*shape) * 0.3).astype(np.float32)).to(dev)

    dp = 2 if n % 2 == 0 and n > 2 else 1
    tp = n // dp
    axes = {"dp": dp, "tp": tp} if dp > 1 else {"tp": tp}
    batch_axis = "dp" if dp > 1 else None
    mesh = Mesh(axes, device=dev)
    b, s = 2 * dp, 16
    kw = dict(s_max=s + 8, bk=8, cache_dtype=torch.float32)
    model = _tp_model(b, s, tp, 2, seed, dev)
    tpd = TPDecoder(model, mesh, batch_axis=batch_axis, **kw)
    ref = SparseDecoder(model, **kw)
    x = act(b, s, 8 * tp)
    y, c = tpd.prefill(x, tpd.init_caches(b))
    y_ref, c_ref = ref.prefill(x, ref.init_caches(b))
    hold("prefill", y, y_ref)
    y2, c = tpd.decode_step(y[:, -1:], c)
    hold("decode_step", y2, ref.decode_step(y_ref[:, -1:], c_ref)[0])

    # paged: one pool a position, prompts padded to the page size
    s_p = 128
    model_p = _tp_model(b, s_p, tp, 1, seed + 1, dev)
    pkw = dict(s_max=s_p + 128, bk=128, cache_dtype=torch.float32)
    ppd = PagedTPDecoder(model_p, mesh, n_pages=2 * (b // dp),
                         batch_axis=batch_axis, **pkw)
    pref = PagedDecoder(model_p, n_pages=2 * b * tp, **pkw)
    xp = act(b, s_p, 8 * tp)
    yp, pc = ppd.prefill(xp, ppd.init_caches(b))
    yp_ref, pc_ref = pref.prefill(xp, pref.init_caches(b))
    hold("paged prefill", yp, yp_ref)
    yp2, pc = ppd.decode_step(yp[:, -1:], ppd.reserve(pc, 1))
    hold("paged decode_step",
         yp2, pref.decode_step(yp_ref[:, -1:], pref.reserve(pc_ref, 1))[0])

    # ragged freeze / resume and speculative verification at tp = n
    b = 2
    model = _tp_model(b, s, n, 2, seed + 2, dev)
    tpd = TPDecoder(model, Mesh({"tp": n}, device=dev), **kw)
    ref = SparseDecoder(model, **kw)
    x = act(b, s, 8 * n)
    _, c = tpd.prefill(x, tpd.init_caches(b))
    _, c_ref = ref.prefill(x, ref.init_caches(b))
    tok = act(b, 1, 8 * n)
    frozen = torch.tensor([True, False], device=dev)
    for route, a in (("ragged frozen", frozen), ("ragged resumed", None)):
        y, c = tpd.decode_step_ragged(tok, c, a)
        y_ref, c_ref = ref.decode_step_ragged(tok, c_ref, a)
        hold(route, y, y_ref)
    drafts = act(b, 3, 8 * n)
    ym, c = tpd.decode_multi(drafts, c)
    ym_ref, c_ref = ref.decode_multi(drafts, c_ref)
    hold("decode_multi", ym, ym_ref)
    c, c_ref = tpd.rollback(c, 1), ref.rollback(c_ref, 1)
    y, c = tpd.decode_step(ym[:, -2:-1], c)
    hold("after rollback", y, ref.decode_step(ym_ref[:, -2:-1], c_ref)[0])
    return diffs


def dryrun_pp(n_devices: int, device="cuda", seed: int = 0,
              mesh: Mesh = None) -> dict:
    """``_dryrun_pp``'s pipeline over ``n_devices`` positions of a one-device
    mesh on ``device`` (or of ``mesh``, a process-group mesh with a ``pp``
    axis of that size, also held against the one-device mesh in this
    process). One gradient of ``mean(out ** 2)`` against the unsharded
    sequential stack. Returns ``{"loss": ..., "max_diff": ...}``."""
    n, dev = int(n_devices), torch.device(device)
    mb, s, h, heads, ffn, n_micro = 2, 16, 32, 2, 48, 2
    masks = np.broadcast_to(np.tril(np.ones((s, s), np.float32)),
                            (mb, s, s)).copy()
    mt = ManyMaskTopology.from_dense_masks(masks)
    layers = [TransformerLayer(
        mt, h, heads, ffn, activation="gelu", use_residual=True,
        use_layernorm=True, attention_layout="panel",
        generator=torch.Generator().manual_seed(seed + i), device=dev)
        for i in range(n)]
    stacked = stack_stage_params([dict(l.named_parameters())
                                  for l in layers])
    x = torch.from_numpy(np.random.RandomState(seed).randn(
        n_micro * mb, s, h).astype(np.float32)).to(dev)

    def stage(p, xm):
        return functional_call(layers[0], p, (xm,))

    def grad_of(m, fn):
        held = m.held("pp", n) if m is not None else range(n)
        leaves = {k: v[held.start:held.stop].detach().clone()
                  .requires_grad_() for k, v in stacked.items()}
        loss = fn(leaves)
        loss.backward()
        return loss.detach(), {k: v.grad for k, v in leaves.items()}

    def pipelined(m):
        return lambda p: pipeline_apply(PipelineSpec(m, n_micro=n_micro),
                                        stage, p, x).square().mean()

    def sequential(p):
        outs = []
        for j in range(n_micro):
            y = x[j * mb:(j + 1) * mb]
            for i in range(n):
                y = stage({k: v[i] for k, v in p.items()}, y)
            outs.append(y)
        return torch.cat(outs).square().mean()

    mesh = mesh or Mesh({"pp": n}, device=dev)
    loss, grads = grad_of(mesh, pipelined(mesh))
    ref_loss, ref = grad_of(None, sequential)
    held = mesh.held("pp", n)
    held = slice(held.start, held.stop)
    label = f"dryrun_pp({n})"
    diffs = [_hold(f"{label} loss", loss, ref_loss, 1e-4)]
    diffs += [_hold(f"{label} grad {k}", g, ref[k][held], 1e-4)
              for k, g in grads.items()]
    if mesh.distributed:
        one = Mesh({"pp": n}, device=mesh.device)
        one_loss, one_g = grad_of(one, pipelined(one))
        _hold(f"{label} loss vs the one-device mesh", loss, one_loss, 1e-6)
        for k, g in grads.items():
            _hold(f"{label} grad {k} vs the one-device mesh", g,
                  one_g[k][held], 1e-6)
    return {"loss": float(loss), "max_diff": max(diffs)}


def dryrun_ep(n_devices: int, device="cuda", seed: int = 0,
              mesh: Mesh = None) -> dict:
    """``_dryrun_ep``'s expert-parallel ``SparseMoE`` (``n_devices`` experts,
    top-2) over ``n_devices`` positions of a one-device mesh on ``device``
    (or of ``mesh``, a process-group mesh with an ``ep`` axis of that size,
    also held against the one-device mesh). One gradient of ``mean(out **
    2)`` against the unsharded module. Returns ``{"loss": ...,
    "max_diff": ...}``."""
    n, dev = int(n_devices), torch.device(device)
    rng = np.random.RandomState(seed)
    h, f = 32, 48
    topo_in = SparseTopology.from_dense_mask(
        (rng.rand(f, h) < 0.4).astype(np.float32))
    topo_out = SparseTopology.from_dense_mask(
        (rng.rand(h, f) < 0.4).astype(np.float32))
    x = torch.from_numpy(rng.randn(2, 16, h).astype(np.float32)).to(dev)

    def grad_of(m):
        moe = SparseMoE(topo_in, topo_out, n, top_k=2, mesh=m,
                        generator=torch.Generator().manual_seed(seed),
                        device=dev)
        loss = moe(x).square().mean()
        loss.backward()
        return (loss.detach(), {k: p.grad for k, p in moe.named_parameters()},
                slice(moe.experts.start, moe.experts.stop))

    mesh = mesh or Mesh({"ep": n}, device=dev)
    loss, grads, held = grad_of(mesh)
    ref_loss, ref, _ = grad_of(None)
    label = f"dryrun_ep({n})"

    def mine(k, g):
        return g[held] if k.startswith("w_") else g

    diffs = [_hold(f"{label} loss", loss, ref_loss, 1e-4)]
    diffs += [_hold(f"{label} grad {k}", g, mine(k, ref[k]), 1e-4)
              for k, g in grads.items()]
    if mesh.distributed:
        one_loss, one_g, _ = grad_of(Mesh({"ep": n}, device=mesh.device))
        _hold(f"{label} loss vs the one-device mesh", loss, one_loss, 1e-6)
        for k, g in grads.items():
            _hold(f"{label} grad {k} vs the one-device mesh", g,
                  mine(k, one_g[k]), 1e-6)
    return {"loss": float(loss), "max_diff": max(diffs)}


def _on_ranks(device) -> dict:
    """Under ``torchrun``: the pipeline and expert parallelism over one
    position a rank, the world's size the axes'."""
    import torch.distributed as dist

    if device.type == "cuda":
        torch.cuda.set_device(int(os.environ.get("LOCAL_RANK", 0)))
    dist.init_process_group("nccl" if device.type == "cuda" else "gloo",
                            timeout=datetime.timedelta(seconds=300))
    try:
        n = dist.get_world_size()
        pp = Mesh({"pp": n}, distributed=True)
        got = {"pp": dryrun_pp(n, pp.device, mesh=pp)}
        ep = Mesh({"ep": n}, distributed=True)
        got["ep"] = dryrun_ep(n, ep.device, mesh=ep)
        where = (torch.cuda.get_device_name(pp.device)
                 if pp.device.type == "cuda" else "cpu")
        print(f"DRYRUN_RANK {dist.get_rank()}/{n} {where} "
              + json.dumps(got), flush=True)
        return {n: got}
    finally:
        dist.destroy_process_group()


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--n", default="4,6,8,16",
                    help="shard counts, comma-separated (one device)")
    ap.add_argument("--device", default="cuda",
                    help="torch device (default: cuda; a rank of an NCCL "
                         "world runs on cuda:LOCAL_RANK)")
    args = ap.parse_args(argv)
    device = torch.device(args.device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(f"device {args.device!r} requested, but no CUDA "
                           f"device is available")
    if "RANK" in os.environ:
        return _on_ranks(device)
    return {int(n): {"sp": dryrun_sp(int(n), device),
                     "tp_serving": dryrun_tp_serving(int(n), device),
                     "pp": dryrun_pp(int(n), device),
                     "ep": dryrun_ep(int(n), device)}
            for n in args.n.split(",")}


if __name__ == "__main__":
    main()
