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

Run:  python -m sputnik_tpu_torch.dryrun [--n 4,6,8,16] [--device cuda]
"""

from __future__ import annotations

import argparse
import json

import numpy as np
import torch

from .parallel import (RingFlashSpec, RowPartition, ShardedCompressedSpec,
                       ShardedFlashSpec, ShardedPanelSpec, comm_model,
                       flash_attention_kv_sharded, flash_attention_sharded,
                       ring_flash_attention, sharded_spmm_halo,
                       sparse_attention_sharded, sparse_attention_sharded_c)
from .patterns import causal_topology, local_window_topology
from .topology import SparseTopology

__all__ = ["dryrun_sp", "main"]

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


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--n", default="4,6,8,16",
                    help="shard counts, comma-separated")
    ap.add_argument("--device", default="cuda",
                    help="torch device (default: cuda)")
    args = ap.parse_args(argv)
    device = torch.device(args.device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(f"device {args.device!r} requested, but no CUDA "
                           f"device is available")
    return {int(n): dryrun_sp(int(n), device)
            for n in args.n.split(",")}


if __name__ == "__main__":
    main()
