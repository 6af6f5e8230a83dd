"""Tensor-parallel serving: the sparse transformer's decoders sharded over a
``tp`` axis of a :class:`~._mesh.Mesh` (counterpart of
``sputnik_tpu/parallel/serving_tp.py``), Megatron-style:

  * the QKV projection column-sharded by head groups: each position
    projects and attends its own ``heads/tp`` query heads (``kv_heads/tp``
    KV heads under GQA) against its own slice of the KV cache, through the
    unchanged decode kernels (B19 + B21; paged B20a + B20b; prefill B9);
  * the attention output projection and the MLP down projection row-
    sharded: their partial sums meet at the two reduce points of each layer
    (``models/serving.run_steps``), one ``Mesh.psum`` over the tp axis each.
    The row-sharded biases are divided by ``tp`` when the views are built,
    so the sum adds them back once;
  * the MLP up projection column-sharded (``ffn/tp`` a position);
  * the LayerNorms replicated.

``batch_axis`` adds data parallelism: the batch and its caches split over
that axis, the weights replicate, and no collective crosses it (every
mask of the batch must then be the same).

The port's decoders read module parameters, so ``shard_params`` builds each
tp position's *view* of the model (``heads/tp`` heads, ``kv_heads/tp`` KV
heads, ``ffn/tp``, the full hidden size) and binds one ``SparseDecoder``
(``PagedDecoder``) to it a local position: the sharded runtime is the
single-device runtime plus the reduce hook. On the one-device mesh every
position's view and decoder live on the mesh's device and a step runs all
of them layer by layer in lockstep; on a rank only that rank's view exists
(1/tp of the sharded weights) and each reduce point is an ``all_reduce``
on the tp group.

**Rows.** Activations, lengths, ``active`` flags, slots and ``init_caches``'
batch count THIS PROCESS's rows: the rows of every dp slice on the one-
device mesh (the whole batch), the rows of the rank's dp slice on a rank
(``rows(x)`` picks them from a whole batch). Caches are shard-major, one
block of ``b_local * KV_l`` replicas (paged: one pool) a local position, in
the order of ``mesh.positions`` (dp-major, as JAX's ``P((dp, tp))``): on a
rank the cache holds only that rank's slice. Every step runs eagerly; a
CUDA graph of these steps is later work.
"""

from __future__ import annotations

import copy
import dataclasses
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch
from torch import nn

from ..many_mask import ManyMaskTopology
from ..models.serving import SparseDecoder, run_steps
from ..models.serving_paged import PagedDecoder
from ..models.transformer import MLP, SparseCoreAttention, SparseTransformer
from ..ops import paged as pg
from ..ops.decode import KVCache
from ._mesh import Mesh

__all__ = ["TPDecoder", "PagedTPDecoder", "tp_slice"]


def _fields(c) -> list:
    """A cache dataclass's tensors in field order (``dataclasses.astuple``
    would deep-copy them)."""
    return [getattr(c, f.name) for f in dataclasses.fields(c)]


def tp_slice(params: Dict[str, torch.Tensor], t: int, tp: int, heads: int,
             kv_heads: int, hd: int) -> Dict[str, torch.Tensor]:
    """Tensor-parallel position ``t``'s share of one ``TransformerLayer``'s
    parameters (``named_parameters()`` names), JAX's slicing: the QKV
    projection's output rows of heads ``[t * heads / tp, (t + 1) * heads /
    tp)`` (head-interleaved ``[q | k | v]`` a head; under GQA the flat
    ``q``, ``k`` and ``v`` blocks, each its ``kv_heads / tp`` KV heads),
    the output projection's matching input columns, ``to_4h``'s ``ffn /
    tp`` output rows and ``to_h``'s matching input columns. Everything
    else (the LayerNorms, the row-parallel layers' biases) is returned
    whole. The values are slices of ``params``: a gradient through them
    lands in the whole tensors."""
    H_l, KV_l = heads // tp, kv_heads // tp
    w = params["self_attention.query_key_value.weight"]
    b = params["self_attention.query_key_value.bias"]
    h = w.shape[1]
    if kv_heads == heads:
        # head-interleaved [H, 3hd] output rows
        qkv_w = w.reshape(heads, 3 * hd, h)[t * H_l:(t + 1) * H_l]
        qkv_b = b.reshape(heads, 3 * hd)[t * H_l:(t + 1) * H_l]
        qkv_w, qkv_b = qkv_w.reshape(-1, h), qkv_b.reshape(-1)
    else:
        # flat [q | k | v] output blocks
        def sl(a, lo, n):
            return a[lo + t * n * hd: lo + (t + 1) * n * hd]

        parts = ((0, H_l), (heads * hd, KV_l),
                 ((heads + kv_heads) * hd, KV_l))
        qkv_w = torch.cat([sl(w, lo, n) for lo, n in parts])
        qkv_b = torch.cat([sl(b, lo, n) for lo, n in parts])
    f_l = params["mlp.to_4h.weight"].shape[0] // tp
    lo, hi = t * H_l * hd, (t + 1) * H_l * hd
    out = dict(params)
    out.update({
        "self_attention.query_key_value.weight": qkv_w,
        "self_attention.query_key_value.bias": qkv_b,
        "self_attention.dense.weight":
            params["self_attention.dense.weight"][:, lo:hi],
        "mlp.to_4h.weight": params["mlp.to_4h.weight"][t * f_l:(t + 1) * f_l],
        "mlp.to_4h.bias": params["mlp.to_4h.bias"][t * f_l:(t + 1) * f_l],
        "mlp.to_h.weight": params["mlp.to_h.weight"][:, t * f_l:(t + 1) * f_l],
    })
    return out


def _linear(w, b, device) -> nn.Linear:
    """An ``nn.Linear`` holding copies of ``w [out, in]`` and ``b`` on
    ``device`` (built on the meta device: nothing is initialised)."""
    lin = nn.Linear(w.shape[1], w.shape[0], bias=b is not None,
                    device="meta")
    lin.weight = nn.Parameter(w.detach().to(device, copy=True).contiguous(),
                              requires_grad=False)
    if b is not None:
        lin.bias = nn.Parameter(b.detach().to(device, copy=True),
                                requires_grad=False)
    return lin


class _ModelView(nn.Module):
    """One tp position's view of a ``SparseTransformer``: what a decoder
    reads, at ``heads/tp`` heads (``hidden_size`` is ``heads/tp * hd``, the
    width the decoder takes its head dim from; the layers keep the full
    residual width)."""

    def __init__(self, model: SparseTransformer, mt: ManyMaskTopology,
                 H_l: int, KV_l: int, hd: int, layers: List[nn.Module]):
        super().__init__()
        self.mask_topology = mt
        self.num_layers = model.num_layers
        self.hidden_size, self.num_heads = H_l * hd, H_l
        self.num_kv_heads = None if KV_l == H_l else KV_l
        self.attention_layout = model.attention_layout
        self.moe_every = 0
        self.layers = nn.ModuleList(layers)


class TPDecoder:
    """Tensor / data-parallel generation runtime over a ``Mesh``.

    Usage::

        mesh = Mesh({"tp": 2}, device="cuda")       # or distributed=True
        tpd = TPDecoder(model, mesh, s_max=..., bk=...)
        caches = tpd.init_caches(batch)
        y, caches = tpd.prefill(x, caches)
        ys, caches = tpd.decode_loop(y[:, -1:], caches, n)

    ``num_heads``, ``num_kv_heads`` and ``ffn_hidden_size`` must divide by
    the tp axis' size. ``batch_axis``: a second mesh axis for data-parallel
    serving; every batch element must share the same mask and the mask
    batch divide by its size. The views are built at construction;
    ``shard_params()`` builds them again from the model's current weights.
    The other arguments are ``SparseDecoder``'s.
    """

    def __init__(self, model: SparseTransformer, mesh: Mesh, *,
                 axis: str = "tp", batch_axis: Optional[str] = None,
                 s_max: int, bk: int = 256, window: Optional[int] = None,
                 sinks: int = 0, cache_dtype=torch.bfloat16):
        if axis not in mesh.shape:
            raise ValueError(f"no axis {axis!r} in mesh {mesh.shape}")
        if batch_axis is not None and batch_axis not in mesh.shape:
            raise ValueError(f"no axis {batch_axis!r} in mesh {mesh.shape}")
        extra = [a for a, n in mesh.shape.items()
                 if a not in (axis, batch_axis) and n > 1]
        if extra:
            raise ValueError(f"mesh axes {extra} are neither axis nor "
                             "batch_axis")
        if getattr(model, "moe_every", 0):
            raise ValueError(
                "serving decoders expect dense-MLP layers; MoE-interleaved "
                "models (moe_every > 0) are a training-side feature")
        tp = mesh.shape[axis]
        heads = model.num_heads
        kv = model.num_kv_heads or heads
        if heads % tp:
            raise ValueError(f"num_heads {heads} not divisible by tp {tp}")
        if kv % tp:
            raise ValueError(f"num_kv_heads {kv} not divisible by tp {tp}")
        ffn = model.layers[0].mlp.to_4h.weight.shape[0]
        if ffn % tp:
            raise ValueError(
                f"ffn_hidden_size {ffn} not divisible by tp {tp}")
        self.mesh, self.axis, self.tp = mesh, axis, tp
        self.batch_axis = batch_axis
        self.dp = mesh.shape[batch_axis] if batch_axis else 1
        self.model = model
        self.heads, self.kv = heads, kv
        self.H_l, self.KV_l = heads // tp, kv // tp
        self.hd = model.hidden_size // heads
        self.f_l = ffn // tp

        mt = model.mask_topology
        if self.dp > 1:
            if mt.b % self.dp:
                raise ValueError(
                    f"mask batch {mt.b} not divisible by dp {self.dp}")
            t0 = mt.topologies[0]
            for t in mt.topologies[1:]:
                if not (np.array_equal(t.row_offsets, t0.row_offsets) and
                        np.array_equal(t.column_indices[: t.nnz],
                                       t0.column_indices[: t0.nnz])):
                    raise ValueError(
                        "data-parallel serving requires every batch "
                        "element to share the same mask")
            self._mt = ManyMaskTopology(mt.topologies[: mt.b // self.dp])
        else:
            self._mt = mt
        self.b_local = self._mt.b
        # each local position: (dp index, tp index)
        self._pos = [(p[mesh.names.index(batch_axis)] if batch_axis else 0,
                      p[mesh.names.index(axis)]) for p in mesh.positions]
        self._dps = sorted({d for d, _ in self._pos})
        self.kw = dict(s_max=s_max, bk=bk, window=window, sinks=sinks,
                       cache_dtype=cache_dtype)
        self.decoders: List[SparseDecoder] = []
        self.views = self.shard_params()
        self.decoders = [self._make_local_decoder(self.views[t])
                         for _, t in self._pos]
        ld = self.decoders[0]
        self.s_max, self.bk, self.nb = ld.s_max, bk, ld.nb
        self.cache_dtype = cache_dtype

    def _make_local_decoder(self, view) -> SparseDecoder:
        """Hook: one local position's runtime (``PagedTPDecoder`` makes a
        ``PagedDecoder``)."""
        return SparseDecoder(view, **self.kw)

    @property
    def n_shards(self) -> int:
        return self.dp * self.tp

    # -- parameter sharding --------------------------------------------------

    def shard_params(self) -> Dict[int, _ModelView]:
        """Build each local tp position's view of the model from its current
        weights (copies on the mesh's device; JAX's slicing, ``tp_slice``)
        and bind the local decoders to them. Returns ``{tp index: view}``."""
        tp, hd, dev = self.tp, self.hd, self.mesh.device
        h = self.model.hidden_size
        core = None
        if self.model.attention_layout == "panel":
            core = SparseCoreAttention(self._mt, self.H_l, "panel")
        views = {}
        for t in sorted({t for _, t in self._pos}):
            layers = []
            for layer in self.model.layers:
                p = tp_slice(dict(layer.named_parameters()), t, tp,
                             self.heads, self.kv, hd)
                view_sa = nn.Module()
                view_sa.query_key_value = _linear(
                    p["self_attention.query_key_value.weight"],
                    p["self_attention.query_key_value.bias"], dev)
                # the row-parallel biases: the psum adds them back
                view_sa.dense = _linear(p["self_attention.dense.weight"],
                                        p["self_attention.dense.bias"] / tp,
                                        dev)
                view_sa.core = core
                with torch.device("meta"):
                    view_mlp = MLP(h, self.f_l, layer.mlp.activation)
                view_mlp.to_4h = _linear(p["mlp.to_4h.weight"],
                                         p["mlp.to_4h.bias"], dev)
                view_mlp.to_h = _linear(p["mlp.to_h.weight"],
                                        p["mlp.to_h.bias"] / tp, dev)
                view = nn.Module()
                view.use_residual = layer.use_residual
                view.ln_attn = copy.deepcopy(layer.ln_attn).to(dev)
                view.self_attention = view_sa
                view.ln_mlp = copy.deepcopy(layer.ln_mlp).to(dev)
                view.mlp = view_mlp
                layers.append(view)
            views[t] = _ModelView(self.model, self._mt, self.H_l, self.KV_l,
                                  hd, layers).requires_grad_(False)
        self.views = views
        for dec, (_, t) in zip(self.decoders, self._pos):
            dec.model = views[t]
        return views

    # -- rows and shards -------------------------------------------------------

    def rows(self, x):
        """This process's rows of a whole batch ``x [b, ...]`` (all of them
        on the one-device mesh, the rank's dp slice on a rank)."""
        if x is None or not self.mesh.distributed:
            return x
        d = self._dps[0]
        return x[d * self.b_local:(d + 1) * self.b_local]

    def _split(self, x):
        """This process's rows -> one block a local position (its dp
        slice's rows)."""
        if x is None:
            return [None] * len(self._pos)
        n = len(self._dps) * self.b_local
        if x.shape[0] != n:
            raise ValueError(f"{x.shape[0]} rows; this process holds {n} "
                             f"({len(self._dps)} dp slices of "
                             f"{self.b_local})")
        return [x[i * self.b_local:(i + 1) * self.b_local]
                for i in (self._dps.index(d) for d, _ in self._pos)]

    def _join(self, ys):
        """One output a local position -> this process's rows (the first
        tp position of each dp slice: the others hold the same values)."""
        first = {}
        for y, (d, _) in zip(ys, self._pos):
            first.setdefault(d, y)
        return torch.cat([first[d] for d in self._dps])

    def _reduce(self, parts):
        return self.mesh.psum(parts, self.axis)

    def _views(self, caches) -> List[Tuple]:
        """Each local position's slice of the shard-major caches."""
        n = len(self._pos)
        if n == 1:
            return [tuple(caches)]
        return [tuple(self._slice(c, s, n) for c in caches)
                for s in range(n)]

    @staticmethod
    def _slice(c: KVCache, s: int, n: int) -> KVCache:
        R = c.kv_len.shape[0] // n
        return KVCache(*(t[s * R:(s + 1) * R] for t in _fields(c)))

    def _unite(self, caches, per_shard) -> Tuple:
        """Per-position caches back into the shard-major ones: the buffers
        were written in place, the new lengths are joined."""
        if len(per_shard) == 1:
            return tuple(per_shard[0])
        return tuple(c.with_len(torch.cat([p[li].kv_len for p in per_shard]))
                     for li, c in enumerate(caches))

    def _run(self, plan: str, x, caches, **per_row):
        """One step of every local position in lockstep: ``plan`` names the
        local decoders' step (``_plan_step``, ...), ``per_row`` the row-wise
        arguments split like ``x``."""
        xs = self._split(x)
        split = {k: self._split(v) for k, v in per_row.items()}
        steps = [getattr(dec, plan)(xs[i], cs,
                                    **{k: v[i] for k, v in split.items()})
                 for i, (dec, cs) in enumerate(
                     zip(self.decoders, self._views(caches)))]
        ys, per_shard = run_steps(steps, self._reduce)
        return self._join(ys), self._unite(caches, per_shard)

    # -- caches --------------------------------------------------------------

    def init_caches(self, batch: int) -> Tuple:
        """Empty caches for ``batch`` rows of this process: ``n_local *
        b_local * KV_l`` replicas a layer (paged: ``n_local`` pools),
        shard-major."""
        if batch != len(self._dps) * self.b_local:
            raise ValueError(
                f"batch {batch}: this process serves {len(self._dps)} dp "
                f"slice(s) of the masks' {self.b_local} rows")
        per = [dec.init_caches(self.b_local) for dec in self.decoders]
        if len(per) == 1:
            return per[0]
        return tuple(type(c)(*(torch.cat(ts) for ts in zip(
            *(_fields(p[li]) for p in per))))
            for li, c in enumerate(per[0]))

    # -- steps ----------------------------------------------------------------

    @torch.no_grad()
    def prefill(self, x, caches, lengths=None):
        """Prompt pass on every position's heads; fills the local caches.
        ``x [rows, T, h]`` -> ``(y [rows, T, h], caches)``."""
        return self._run("_plan_prefill", x, caches,
                         lengths=self._rows_arg(lengths, x))

    @torch.no_grad()
    def decode_step(self, x_tok, caches):
        return self._run("_plan_step", x_tok, caches)

    @torch.no_grad()
    def decode_step_ragged(self, x_tok, caches, active=None):
        """Continuous-batching step (``SparseDecoder.decode_step_ragged``);
        ``active`` is row-wise, like ``x_tok``."""
        return self._run("_plan_ragged", x_tok, caches,
                         active=self._rows_arg(active, x_tok))

    @torch.no_grad()
    def decode_multi(self, x_toks, caches):
        """Speculative verification (``SparseDecoder.decode_multi``)."""
        return self._run("_plan_multi", x_toks, caches)

    @staticmethod
    def _rows_arg(v, x):
        return None if v is None else torch.as_tensor(v, device=x.device)

    @torch.no_grad()
    def decode_loop(self, x_tok, caches, n_tokens: int, next_input=None):
        """``n_tokens`` uniform decode steps, eagerly; ``ys [n_tokens, rows,
        1, h]`` (``SparseDecoder.decode_loop``)."""
        if n_tokens < 1:
            raise ValueError(f"n_tokens must be >= 1, got {n_tokens}")
        nxt = next_input or (lambda y: y)
        ys = []
        for _ in range(n_tokens):
            y, caches = self.decode_step(x_tok, caches)
            ys.append(y)
            x_tok = nxt(y)
        return torch.stack(ys), caches

    @staticmethod
    def rollback(caches, n: int):
        """Reject the last ``n`` speculative tokens (every replica)."""
        return SparseDecoder.rollback(caches, n)

    # LMServer(decoder=) reads it; the tensor-parallel steps capture no graph
    @property
    def graph_pool(self):
        return self.decoders[0].graph_pool


class PagedTPDecoder(TPDecoder):
    """Tensor / data-parallel serving over per-position KV page pools: the
    composition of ``TPDecoder`` and ``PagedDecoder``.

    Every ``PagedKVCache`` leaf stacks the local positions on dim 0 (pools
    ``[n_local * P_alloc, bk, hd]``, tables and lengths ``[n_local *
    R_local]``); each position's ``PagedDecoder`` runs over its own pool of
    ``n_pages`` pages with shard-local page ids and holds one host
    allocator a layer. The host scheduler steps (``reserve``, ``release``,
    ``share_prefix``) run the single-device step on each position's slice.
    Every process runs the same scheduler on the same requests, so the ids
    of the positions of a dp slice agree without a message.

    ``n_pages`` is PER POSITION: size it as ``ceil(tokens of the dp slice's
    slots / bk) + b_local * KV_l``. ``prefill`` reserves the prompt's pages
    (a host step) and writes them by device page ids.
    """

    def __init__(self, model: SparseTransformer, mesh: Mesh, *,
                 n_pages: int, axis: str = "tp",
                 batch_axis: Optional[str] = None, s_max: int,
                 bk: int = 256, window: Optional[int] = None, sinks: int = 0,
                 cache_dtype=torch.bfloat16):
        self.n_pages = n_pages
        super().__init__(model, mesh, axis=axis, batch_axis=batch_axis,
                         s_max=s_max, bk=bk, window=window, sinks=sinks,
                         cache_dtype=cache_dtype)

    def _make_local_decoder(self, view) -> PagedDecoder:
        return PagedDecoder(view, n_pages=self.n_pages, **self.kw)

    # -- caches (host scheduler over the stacked tables) ----------------------

    @staticmethod
    def _slice(c: pg.PagedKVCache, s: int, n: int) -> pg.PagedKVCache:
        P, R = c.k.shape[0] // n, c.kv_len.shape[0] // n
        return pg.PagedKVCache(
            c.k[s * P:(s + 1) * P], c.v[s * P:(s + 1) * P],
            c.k_scale[s * P:(s + 1) * P], c.v_scale[s * P:(s + 1) * P],
            c.page_table[s * R:(s + 1) * R], c.kv_len[s * R:(s + 1) * R])

    def _unite(self, caches, per_shard) -> Tuple:
        if len(per_shard) == 1:
            return tuple(per_shard[0])
        return tuple(dataclasses.replace(
            c, page_table=torch.cat([p[li].page_table for p in per_shard]),
            kv_len=torch.cat([p[li].kv_len for p in per_shard]))
            for li, c in enumerate(caches))

    def _host_step(self, caches, fn, shards=None):
        """``fn(decoder, its caches) -> caches`` on the local positions
        ``shards`` (default all), the others unchanged."""
        views = self._views(caches)
        todo = range(len(views)) if shards is None else shards
        for s in todo:
            views[s] = fn(self.decoders[s], views[s])
        return self._unite(caches, views)

    def _slot(self, slot: int):
        """(dp-local slot, the local positions holding it) of a row of this
        process."""
        n = len(self._dps) * self.b_local
        if not 0 <= slot < n:
            raise ValueError(f"slot {slot} out of range")
        i, ls = divmod(slot, self.b_local)
        d = self._dps[i]
        return ls, [s for s, (dd, _) in enumerate(self._pos) if dd == d]

    def reserve(self, caches, n_tokens: int = 1):
        """HOST scheduler step: pages for the next ``n_tokens`` appends on
        every position of every layer."""
        return self._host_step(caches,
                               lambda dec, cs: dec.reserve(cs, n_tokens))

    def release(self, caches, slot: int):
        """Evict row ``slot``: free its pages on every tp position of its dp
        slice, every layer."""
        ls, shards = self._slot(slot)
        return self._host_step(caches, lambda dec, cs: dec.release(cs, ls),
                               shards)

    def share_prefix(self, caches, src: int, dst: int, n_tokens: int):
        """Prefix caching across the positions: both rows must live in the
        SAME dp slice (pages never cross pools)."""
        ls_src, sh_src = self._slot(src)
        ls_dst, sh_dst = self._slot(dst)
        if sh_src != sh_dst:
            raise ValueError(
                f"src slot {src} and dst slot {dst} live in different dp "
                "slices; prefix pages cannot be shared across pools")
        return self._host_step(
            caches, lambda dec, cs: dec.share_prefix(cs, ls_src, ls_dst,
                                                     n_tokens), sh_src)

    @property
    def free_pages(self) -> List[List[int]]:
        """Free pages per layer per local position."""
        return [[dec.pools[li].free_pages for dec in self.decoders]
                for li in range(self.model.num_layers)]

    def rollback(self, caches, n):
        """Reject the last ``n`` speculative tokens: a scalar, or one count
        a row (expanded to every position's replica rows)."""
        dev = caches[0].kv_len.device
        n = torch.as_tensor(n, device=dev).to(torch.int32)
        if n.dim() == 1:
            n = torch.cat([v.repeat_interleave(self.KV_l)
                           for v in self._split(n)])
        return tuple(dataclasses.replace(c, kv_len=torch.clamp(
            c.kv_len - n, min=0)) for c in caches)
