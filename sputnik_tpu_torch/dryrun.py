"""Dry runs of the distribution layer at ``n`` positions: the port's twin of
the JAX package's ``__graft_entry__.dryrun_multichip``, each run on the
one-device mesh (every position's shard in this process) or, under
``torchrun``, over one position a rank.

:func:`dryrun_sp` (``_dryrun_sp`` and ``_dryrun_sharded_compressed``) takes
one gradient of ``sum(out ** 2)`` through each sequence-parallel path on
an ``sp`` axis, every gradient finite:

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

:func:`dryrun_hier` (``_dryrun_hier``) runs ``flash_attention_kv_sharded``
over the ``sp`` axis of a ``("host", "sp")`` 2 x n/2 mesh, its replicas
split over ``host``, against dense windowed attention, and prints
``DRYRUN_COMM_HIER``, the cross-host bytes the layout implies.

:func:`dryrun_dp_tp` (``_dryrun_dp_tp``) takes one SGD step of a
``SparseTransformer`` over a ``("dp", "tp")`` mesh (:func:`dp_tp_step`:
QKV and ``to_4h`` column-parallel, ``dense`` and ``to_h`` row-parallel by
``serving_tp.tp_slice``, the batch split over ``dp``) against the unsharded
step.

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
x max(1, max|ref|) of the unsharded sequential stack / module.

Every run but ``dryrun_tp_serving`` takes ``mesh=``, a process-group mesh
of the run's axes; on its ranks every loss and gradient is also held within
1e-6 x max(1, max|ref|) of the one-device mesh's, in the same process.

Run:  python -m sputnik_tpu_torch.dryrun [--n 4,6,8,16] [--device cuda]

or, every run but the serving one over one position a rank (NCCL on cards,
gloo on the CPU; ``torchrun`` sets the world on ``localhost``; the meshes
``{"sp": n}``, ``{"host": 2, "sp": n / 2}``, ``{"dp": 2, "tp": n / 2}``,
``{"pp": n}`` and ``{"ep": n}`` of the world's ``n`` ranks):

      torchrun --nproc-per-node 4 -m sputnik_tpu_torch.dryrun [--device cpu]
"""

from __future__ import annotations

import argparse
import datetime
import json
import os

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn
from torch.func import functional_call

from .many_mask import ManyMaskTopology
from .models import (PagedDecoder, SparseDecoder, SparseMoE,
                     SparseTransformer, TransformerLayer)
from .models.transformer import _LN_EPS, SparseCoreAttention
from .parallel import (Mesh, PagedTPDecoder, PipelineSpec, RingFlashSpec,
                       RowPartition, ShardedCompressedSpec, ShardedFlashSpec,
                       ShardedPanelSpec, TPDecoder, comm_model,
                       flash_attention_kv_sharded, flash_attention_sharded,
                       pipeline_apply, ring_flash_attention,
                       sharded_spmm_halo, sparse_attention_sharded,
                       sparse_attention_sharded_c, stack_stage_params)
from .parallel.serving_tp import tp_slice
from .patterns import causal_topology, driver_masks, local_window_topology
from .topology import SparseTopology

__all__ = ["dryrun_sp", "dryrun_hier", "dryrun_dp_tp", "dp_tp_step",
           "dryrun_tp_serving", "dryrun_pp", "dryrun_ep", "main"]

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


def _hold(label, got, ref, tol) -> float:
    """max |got - ref|, raising unless finite and within ``tol`` x max(1,
    max|ref|)."""
    d = float((got - ref).abs().max())
    if not (torch.isfinite(got).all() and
            d <= tol * max(1.0, float(ref.abs().max()))):
        raise RuntimeError(f"{label}: {d} from the reference")
    return d


def _mesh_sum(mesh, x, axes):
    """A process's local scalar summed over ``axes`` of ``mesh`` (the whole
    sum on one device, where ``x`` already covers every position)."""
    if not mesh.distributed:
        return x
    for ax in axes:
        x = mesh.psum([x], ax)[0]
    return x


def _sp_grads(mesh, paths, dev):
    """Each path's ``(loss, [gradients])`` on ``mesh``'s ``sp`` axis: this
    process's shards of the sharded operands, the replicated ones whole;
    the loss ``sum(out ** 2)`` over every shard."""
    out = {}
    for name, (make, fn, arrays, sharded) in paths.items():
        spec = make(mesh)
        here = np.asarray(spec.here)
        xs = [torch.from_numpy(a[here] if sh else a).to(dev)
              .requires_grad_() for a, sh in zip(arrays, sharded)]
        local = fn(spec, *xs).square().sum()
        local.backward()
        out[name] = (_mesh_sum(mesh, local.detach(), ["sp"]),
                     [x.grad for x in xs])
    return out


def dryrun_sp(n_devices: int, device="cuda", seed: int = 0,
              mesh: Mesh = None) -> dict:
    """One gradient through every sequence-parallel path at ``n_devices``
    shards on ``device``, on the ``sp`` axis of the one-device mesh (or of
    ``mesh``, a process-group mesh ``{"sp": n_devices}``, also held against
    the one-device mesh). Returns ``{"losses": {path: loss}, "comm":
    DRYRUN_COMM's dict}`` (``"comm"`` on the one-device mesh only) and, on
    ranks, ``"max_diff"`` from the one-device mesh."""
    n, dev = int(n_devices), torch.device(device)
    rng = np.random.RandomState(seed)

    def rand(*shape):
        return rng.randn(*shape).astype(np.float32)

    # causal, K / V replicated: 2 row blocks a shard
    s = 2 * n * TILE
    part = RowPartition(causal_topology(s), n, balance=False)
    # a local window (|i - j| < 64) over 4 key blocks a shard: one halo
    # block each side, so the exchange and its split
    sb = 4 * n * TILE
    bpart = RowPartition(local_window_topology(sb, TILE), n, balance=False)
    n_loc = bpart.topo.n // n
    # the zigzag ring over the causal topology; the compressed layout on a
    # band with a dense row (balanced rows)
    rpart = RowPartition(causal_topology(s), n, zigzag=True)
    cpart = RowPartition(_banded_dense_rows(s, 8 * TILE), n)
    pspec1 = ShardedPanelSpec(bpart, axis="sp")
    paths = {
        "attention": (
            lambda m: ShardedPanelSpec(part, mesh=m, axis="sp"),
            sparse_attention_sharded,
            [rand(n, s // n, HD), rand(s, HD), rand(s, HD)],
            (True, False, False)),
        "attention_flash": (
            lambda m: ShardedFlashSpec(part, mesh=m),
            flash_attention_sharded,
            [rand(n, 1, s // n, HD), rand(1, s, HD), rand(1, s, HD)],
            (True, False, False)),
        "attention_kv_halo": (
            lambda m: ShardedFlashSpec(bpart, mesh=m),
            flash_attention_kv_sharded,
            [rand(n, 2, sb // n, HD), rand(n, 2, n_loc, HD),
             rand(n, 2, n_loc, HD)], (True, True, True)),
        "spmm_halo": (
            lambda m: ShardedPanelSpec(bpart, mesh=m, axis="sp"),
            sharded_spmm_halo,
            [pspec1.stack_values(rand(bpart.topo.nnz_pad)),
             rand(n, n_loc, Q)], (True, True)),
        "attention_ring": (
            lambda m: RingFlashSpec(rpart, mesh=m),
            ring_flash_attention,
            [rand(n, 2, s // n, HD), rand(n, 2, s // n, HD),
             rand(n, 2, s // n, HD)], (True, True, True)),
        "attention_compressed": (
            lambda m: ShardedCompressedSpec(cpart, mesh=m, axis="sp"),
            sparse_attention_sharded_c,
            [rand(n, cpart.m_loc, HD), rand(8 * TILE, HD),
             rand(8 * TILE, HD)], (True, False, False)),
    }
    one = Mesh({"sp": n}, device=dev)
    mesh = mesh or one
    got = _sp_grads(mesh, paths, dev)
    for name, (loss, grads) in got.items():
        if not torch.isfinite(loss) or not all(
                torch.isfinite(g).all() for g in grads):
            raise RuntimeError(f"dryrun_sp({n}): non-finite {name}")
    res = {"losses": {k: float(v[0]) for k, v in got.items()}}
    if mesh.distributed:
        here = mesh.index("sp")
        ref = _sp_grads(one, paths, dev)
        diffs = []
        for name, (loss, grads) in got.items():
            label = f"dryrun_sp({n}) {name} vs the one-device mesh"
            diffs.append(_hold(f"{label}: loss", loss, ref[name][0], 1e-6))
            for i, (g, r, sh) in enumerate(zip(grads, ref[name][1],
                                               paths[name][3])):
                diffs.append(_hold(f"{label}: operand {i}'s gradient", g,
                                   r[here] if sh else r, 1e-6))
        res["max_diff"] = max(diffs)
        return res

    spec, bspec = ShardedPanelSpec(part), ShardedFlashSpec(bpart)
    rspec = RingFlashSpec(rpart)
    cm = comm_model
    comm = {
        "n_devices": n,
        "attention": cm.attention_comm_bytes(spec, HD),
        "attention_kv_halo": cm.attention_halo_comm_bytes(
            bspec, HD, n_loc, kv_replicas=2),
        "attention_ring": cm.attention_ring_comm_bytes(
            rspec.n_loc, HD, n, kv_replicas=2),
        "spmm": cm.spmm_comm_bytes(spec, HD),
        "spmm_halo": cm.spmm_halo_comm_bytes(pspec1, n_loc, Q),
        # causal load balance: the zigzag partition the ring runs against
        # the contiguous one, and what the slowest shard costs
        "nnz_balance": cm.nnz_balance(rpart),
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
    res["comm"] = comm
    return res


def _hier_grads(mesh, spec, arrays, dev):
    """``sum(out ** 2)`` through ``flash_attention_kv_sharded`` over the
    ``sp`` axis of ``mesh``, the replica dim split over ``host``: this
    process's loss share summed over the mesh, and its q / k / v
    gradients."""
    sp = np.asarray(spec.here)
    hosts = mesh.shape["host"]
    if mesh.distributed:
        h = mesh.index("host")[0]
        R = arrays[0].shape[1] // hosts
        rows = slice(h * R, (h + 1) * R)
    else:
        rows = slice(None)
    xs = [torch.from_numpy(a[sp][:, rows]).to(dev).requires_grad_()
          for a in arrays]
    local = flash_attention_kv_sharded(spec, *xs).square().sum()
    local.backward()
    return (_mesh_sum(mesh, local.detach(), ["sp", "host"]),
            [x.grad for x in xs], rows)


def dryrun_hier(n_devices: int, device="cuda", seed: int = 7,
                mesh: Mesh = None) -> dict:
    """``_dryrun_hier``: the K / V-sharded flash attention over the ``sp``
    axis of a ``("host", "sp")`` 2 x n/2 mesh, its 2 replicas split over
    ``host`` (a local window of 96 over s = 128 n/2 keys, hd 32, the
    port's 64 tiles; q, k and k again as v). The loss ``sum(out ** 2)``
    within 1e-4 x max(1, |ref|) of dense windowed attention, its q / k / v
    gradients finite; on ``mesh`` (a process-group mesh of those axes)
    also within 1e-6 x max(1, max|ref|) of the one-device mesh's. Prints
    ``DRYRUN_COMM_HIER``; returns ``{"loss", "grads", "comm",
    "max_diff"}`` (this process's gradients), or ``None`` at an odd ``n``
    (as JAX)."""
    n, dev = int(n_devices), torch.device(device)
    if n % 2:
        return None
    hosts, sp = 2, n // 2
    one = Mesh({"host": hosts, "sp": sp}, device=dev)
    mesh = mesh or one
    s, hd, R = sp * 128, 32, 2
    btopo = local_window_topology(s, window=96)
    bpart = RowPartition(btopo, sp, balance=False)
    n_loc = ShardedFlashSpec(bpart, axis="sp").n_pad // sp
    rng = np.random.RandomState(seed)
    q = rng.randn(sp, R, s // sp, hd).astype(np.float32)
    k = rng.randn(sp, R, n_loc, hd).astype(np.float32)
    label = f"dryrun_hier({n})"

    spec = ShardedFlashSpec(bpart, mesh=mesh, axis="sp")
    loss, grads, rows = _hier_grads(mesh, spec, [q, k, k], dev)
    if not torch.isfinite(loss) or not all(torch.isfinite(g).all()
                                           for g in grads):
        raise RuntimeError(f"{label}: non-finite loss or gradient")
    # dense windowed attention on the natural sequence (balance=False: shard
    # d holds rows [d * s / sp, ...))
    qn, kn = (torch.from_numpy(a).transpose(0, 1).reshape(R, -1, hd)[:, :s]
              for a in (q, k))
    keep = torch.from_numpy(btopo.to_dense_mask() != 0)
    sc = (qn @ kn.transpose(1, 2) * hd ** -0.5).masked_fill(~keep, -1e30)
    ref = (torch.softmax(sc, -1) @ kn).square().sum()
    res = {"loss": float(loss), "grads": grads,
           "max_diff": _hold(f"{label} loss vs dense attention",
                             loss.cpu()[None], ref[None], 1e-4)}
    if mesh.distributed:
        sp_here = mesh.index("sp")
        r_loss, r_grads, _ = _hier_grads(
            one, ShardedFlashSpec(bpart, mesh=one, axis="sp"), [q, k, k],
            dev)
        diffs = [_hold(f"{label} loss vs the one-device mesh", loss[None],
                       r_loss[None], 1e-6)]
        diffs += [_hold(f"{label} {w} grad vs the one-device mesh", g,
                        r[sp_here][:, rows], 1e-6)
                  for w, g, r in zip("qkv", grads, r_grads)]
        res["max_diff"] = max(res["max_diff"], *diffs)

    plan = spec.halo_plan(n_loc)
    res["comm"] = {
        "layout": "dp(host) x sp(nvlink)",
        "halo_rows": plan,
        "dcn_dp_grad_bytes_per_host": comm_model.hier_dp_grad_dcn_bytes(
            int(btopo.nnz), 2),
        "dcn_rowpart_boundary_bytes_per_host":
            comm_model.hier_halo_dcn_bytes(plan or (0, 0), hd, 2),
    }
    print("DRYRUN_COMM_HIER " + json.dumps(res["comm"], default=float),
          flush=True)
    return res


def _dp_tp_forward(model, params, x, mesh, dp_axis, tp_axis):
    """The transformer's forward over a ``(dp, tp)`` mesh: ``params[i]``
    local position ``i``'s per-layer parameters (``tp_slice``'s share),
    ``x`` the whole batch. Returns each local position's output rows (its
    dp slice; the same on every position of a tp line)."""
    tp = mesh.shape[tp_axis]
    H, KV = model.num_heads, model.num_kv_heads or model.num_heads
    hd = model.hidden_size // H
    H_l, KV_l = H // tp, KV // tp
    mt, b_l = model.mask_topology, x.shape[0] // mesh.shape[dp_axis]
    ds = mesh.index(dp_axis)
    cores = {d: SparseCoreAttention(
        ManyMaskTopology(mt.topologies[d * b_l:(d + 1) * b_l]), H_l,
        model.attention_layout) for d in set(ds)}
    ys = [x[d * b_l:(d + 1) * b_l] for d in ds]

    def norm(layer, name, y, p):
        if not isinstance(getattr(layer, name), nn.LayerNorm):
            return y
        return F.layer_norm(y, y.shape[-1:], p[f"{name}.weight"],
                            p[f"{name}.bias"], _LN_EPS)

    def attend(core, a, p):
        b, s, _ = a.shape
        qkv = F.linear(a, p["self_attention.query_key_value.weight"],
                       p["self_attention.query_key_value.bias"])
        if KV == H:
            q, k, v = qkv.reshape(b, s, H_l, 3 * hd).split(hd, dim=-1)
        else:
            q = qkv[..., : H_l * hd].reshape(b, s, H_l, hd)
            k = qkv[..., H_l * hd: (H_l + KV_l) * hd].reshape(b, s, KV_l, hd)
            v = qkv[..., (H_l + KV_l) * hd:].reshape(b, s, KV_l, hd)
        return F.linear(core(q, k, v), p["self_attention.dense.weight"])

    def ffn(layer, a, p):
        y = F.linear(a, p["mlp.to_4h.weight"], p["mlp.to_4h.bias"])
        if layer.mlp.activation == "gelu":
            y = F.gelu(y, approximate="tanh")
        elif layer.mlp.activation == "relu":
            y = F.relu(y)
        return F.linear(y, p["mlp.to_h.weight"])

    for li, layer in enumerate(model.layers):
        ps = [p[li] for p in params]
        # attention: the LayerNorm is tp-invariant work; its output enters
        # the column-parallel QKV through pvary, and the row-parallel
        # output projection's partials meet in one psum, its bias once
        a = mesh.pvary([norm(layer, "ln_attn", y, p)
                        for y, p in zip(ys, ps)], tp_axis)
        red = mesh.psum([attend(cores[d], x_, p)
                         for d, x_, p in zip(ds, a, ps)], tp_axis)
        attn = [r + p["self_attention.dense.bias"] for r, p in zip(red, ps)]
        ys = [y + o if layer.use_residual else o for y, o in zip(ys, attn)]
        a = mesh.pvary([norm(layer, "ln_mlp", y, p)
                        for y, p in zip(ys, ps)], tp_axis)
        red = mesh.psum([ffn(layer, x_, p) for x_, p in zip(a, ps)],
                        tp_axis)
        mlp = [r + p["mlp.to_h.bias"] for r, p in zip(red, ps)]
        ys = [y + o if layer.use_residual else o for y, o in zip(ys, mlp)]
    return ys


def _layer_params(i: int, params: dict) -> dict:
    """Layer ``i``'s entries of a model-level parameter dict, unprefixed."""
    pre = f"layers.{i}."
    return {k[len(pre):]: v for k, v in params.items() if k.startswith(pre)}


def _shares(model, params: dict, t: int, tp: int) -> dict:
    """Tp position ``t``'s ``tp_slice`` of model-level ``params``."""
    H = model.num_heads
    kv, hd = model.num_kv_heads or H, model.hidden_size // H
    return {f"layers.{i}.{k}": v for i in range(len(model.layers))
            for k, v in tp_slice(_layer_params(i, params), t, tp, H, kv,
                                 hd).items()}


def _sgd(leaves: dict, loss, lr: float):
    loss.backward()
    return (loss.detach(), {k: v.grad for k, v in leaves.items()},
            {k: (v - lr * v.grad).detach() for k, v in leaves.items()})


def dp_tp_step(model, x, mesh: Mesh, lr: float = 1e-3, *,
               dp_axis: str = "dp", tp_axis: str = "tp"):
    """One SGD step (``lr``) of ``model``, a ``SparseTransformer`` of dense
    MLPs, on ``mean(y ** 2)`` over the whole batch ``x [b, s, h]``, over the
    ``(dp_axis, tp_axis)`` axes of ``mesh``: the batch split over dp, the
    weights by ``serving_tp.tp_slice`` over tp (QKV and ``to_4h``
    column-parallel; ``dense`` and ``to_h`` row-parallel, their partials
    meeting in one ``psum``, their biases added once after it; the rest
    replicated). Every parameter enters its dp slice's work through
    ``Mesh.pvary`` over dp, and each LayerNorm's output enters the
    column-parallel layers through ``pvary`` over tp; the loss is
    ``psum``'d over dp. The model's parameters are not changed.

    Returns ``(loss, grads, params)``: the loss, and this process's
    leaves' gradients and updated values, named as ``named_parameters()``:
    the whole tensors on the one-device mesh, a rank's ``tp_slice`` share
    (the slices of the whole gradient) on a rank."""
    if getattr(model, "moe_every", 0):
        raise ValueError("dp_tp_step takes dense-MLP layers (moe_every 0)")
    extra = [a for a, n in mesh.shape.items()
             if a not in (dp_axis, tp_axis) and n > 1]
    if extra:
        raise ValueError(f"mesh axes {extra} are neither dp nor tp")
    tp, dp = mesh.shape[tp_axis], mesh.shape[dp_axis]
    kv = model.num_kv_heads or model.num_heads
    ffn = model.layers[0].mlp.to_4h.weight.shape[0]
    if model.num_heads % tp or kv % tp or ffn % tp or x.shape[0] % dp:
        raise ValueError(f"heads {model.num_heads}, kv heads {kv}, ffn "
                         f"{ffn} must divide by tp {tp} and the batch "
                         f"{x.shape[0]} by dp {dp}")
    full = dict(model.named_parameters())
    ts = mesh.index(tp_axis)
    if mesh.distributed:
        leaves = {k: v.detach().clone().requires_grad_()
                  for k, v in _shares(model, full, ts[0], tp).items()}
        shares = [dict(leaves)]
    else:
        leaves = {k: v.detach().clone().requires_grad_()
                  for k, v in full.items()}
        shares = [_shares(model, leaves, t, tp) for t in ts]
    for k in shares[0]:          # dp-invariant parameters, dp-varying work
        for sh, v in zip(shares, mesh.pvary([sh[k] for sh in shares],
                                            dp_axis)):
            sh[k] = v
    per_layer = [[_layer_params(i, sh) for i in range(len(model.layers))]
                 for sh in shares]
    ys = _dp_tp_forward(model, per_layer, x, mesh, dp_axis, tp_axis)
    # the loss over the whole batch (a psum over dp), counted once along tp
    loss = mesh.psum([y.square().sum() for y in ys], dp_axis)[0] / x.numel()
    return _sgd(leaves, loss, lr)


def _unsharded_step(model, x, lr):
    leaves = {k: v.detach().clone().requires_grad_()
              for k, v in model.named_parameters()}
    return _sgd(leaves, functional_call(model, leaves, (x,)).square().mean(),
                lr)


def dryrun_dp_tp(n_devices: int, device="cuda", seed: int = 0,
                 mesh: Mesh = None) -> dict:
    """``_dryrun_dp_tp``: one SGD step (lr 1e-3) of a ``SparseTransformer``
    over a ``("dp", "tp")`` mesh, dp 2 where ``n`` is even and > 1, tp the
    rest (b = 2 dp, s 64, h 32 tp, tp heads, one layer, ffn 64 tp, the
    driver's causal masks, residual + LayerNorm + gelu, the biases and
    LayerNorms drawn away from 0 / 1), through :func:`dp_tp_step` on the
    one-device mesh (or on ``mesh``, a process-group mesh of those axes,
    also held within 1e-6 x max(1, max|ref|) of the one-device mesh). The
    loss, gradients and updated parameters within 1e-4 x max(1, max|ref|)
    of the unsharded step's. Returns ``{"loss", "grads", "params",
    "max_diff"}`` (this process's shares)."""
    n, dev = int(n_devices), torch.device(device)
    dp = 2 if n % 2 == 0 and n > 1 else 1
    tp = n // dp
    b, s, h = 2 * dp, 64, 32 * tp
    model = SparseTransformer.from_masks(
        driver_masks(b, s), num_layers=1, hidden_size=h, num_heads=tp,
        ffn_hidden_size=64 * tp, use_residual=True, use_layernorm=True,
        activation="gelu", generator=torch.Generator().manual_seed(seed),
        device=dev)
    g = torch.Generator().manual_seed(seed + 1)
    with torch.no_grad():
        for name, p in model.named_parameters():
            if "bias" in name or "ln" in name:
                p.add_(0.1 * torch.randn(p.shape, generator=g).to(dev))
    x = torch.from_numpy(np.random.RandomState(seed).randn(
        b, s, h).astype(np.float32)).to(dev)
    one = Mesh({"dp": dp, "tp": tp}, device=dev)
    mesh = mesh or one
    got = dp_tp_step(model, x, mesh)
    label = f"dryrun_dp_tp({n})"

    def held(d):
        return _shares(model, d, mesh.index("tp")[0], tp) \
            if mesh.distributed else d

    def hold_all(against, ref, tol):
        diffs = [_hold(f"{label} loss vs {against}", got[0][None],
                       ref[0][None], tol)]
        for what, mine, theirs in (("grad", got[1], held(ref[1])),
                                   ("param", got[2], held(ref[2]))):
            diffs += [_hold(f"{label} {what} {k} vs {against}", v,
                            theirs[k], tol) for k, v in mine.items()]
        return max(diffs)

    diff = hold_all("the unsharded step", _unsharded_step(model, x, 1e-3),
                    1e-4)
    if mesh.distributed:
        diff = max(diff, hold_all("the one-device mesh",
                                  dp_tp_step(model, x, one), 1e-6))
    return {"loss": float(got[0]), "grads": got[1], "params": got[2],
            "max_diff": diff}


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
    """Under ``torchrun``: every run but the serving one over one position
    a rank, on meshes of the world's ``n`` ranks: ``{"sp": n}``,
    ``{"host": 2, "sp": n / 2}``, ``{"dp": 2, "tp": n / 2}`` (dp 1 at an odd
    ``n``), ``{"pp": n}`` and ``{"ep": n}``."""
    import torch.distributed as dist

    if device.type == "cuda":
        torch.cuda.set_device(int(os.environ.get("LOCAL_RANK", 0)))
    dist.init_process_group("nccl" if device.type == "cuda" else "gloo",
                            timeout=datetime.timedelta(seconds=300))
    try:
        n = dist.get_world_size()
        sp = Mesh({"sp": n}, distributed=True)
        dev = sp.device
        got = {"sp": dryrun_sp(n, dev, mesh=sp)}
        if n % 2 == 0:
            got["hier"] = dryrun_hier(n, dev, mesh=Mesh(
                {"host": 2, "sp": n // 2}, distributed=True))
        dp = 2 if n % 2 == 0 and n > 1 else 1
        got["dp_tp"] = dryrun_dp_tp(n, dev, mesh=Mesh(
            {"dp": dp, "tp": n // dp}, distributed=True))
        got["pp"] = dryrun_pp(n, dev, mesh=Mesh({"pp": n}, distributed=True))
        got["ep"] = dryrun_ep(n, dev, mesh=Mesh({"ep": n}, distributed=True))
        where = (torch.cuda.get_device_name(dev) if dev.type == "cuda"
                 else "cpu")
        summary = {k: {f: v[f] for f in ("loss", "losses", "max_diff")
                       if f in v} for k, v in got.items() if v}
        print(f"DRYRUN_RANK {dist.get_rank()}/{n} {where} "
              + json.dumps(summary), flush=True)
        return {n: got}
    finally:
        dist.destroy_process_group()


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--n", default="4,6,8,16",
                    help="position counts, comma-separated (one device)")
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
                     "hier": dryrun_hier(int(n), device),
                     "dp_tp": dryrun_dp_tp(int(n), device),
                     "pp": dryrun_pp(int(n), device),
                     "ep": dryrun_ep(int(n), device),
                     "tp_serving": dryrun_tp_serving(int(n), device)}
            for n in args.n.split(",")}


if __name__ == "__main__":
    main()
