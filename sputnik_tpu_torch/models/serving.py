"""Serving runtime for the sparse transformer: prefill + block-KV decode
(counterpart of ``sputnik_tpu/models/serving.py``).

``SparseDecoder`` is bound to a ``SparseTransformer`` module and reads its
parameters, so no method takes a ``params`` argument. ``prefill`` runs the
prompt through the sparse-flash kernel on the model's own masks (the
batched panel chain on a ``attention_layout="panel"`` model) and
bulk-writes every layer's K/V into its cache; ``decode_step`` (uniform
lengths), ``decode_step_ragged`` (per-slot lengths, continuous batching)
and ``decode_multi`` (speculative verification) append this step's K/V
and attend over the on-device block table through the decode-attention
kernel. Caches are written in place (``ops/decode.py``). Every method runs
under ``torch.no_grad``: serving never differentiates. ``PagedDecoder``
(``serving_paged.py``) keeps this prefill and overrides its two cache
hooks, ``_prefill_setup`` and ``_prefill_write``.

``cast_params`` stores a model's weights in bf16 for serving, in place;
the layers then compute as JAX's serving math does on such weights: an f32
activation meets a bf16 weight's exact f32 values (``transformer._dense``).
``decode_loop`` (and ``LMServer.generate``, ``models/lm.py``) replay one
captured CUDA graph a token on a CUDA device (``_step_graph.py``); the
single-step methods stay eager.

Every step is written once over a LIST of shards (:func:`run_steps`): each
method builds its shard's :class:`Step` (its decoder, input, caches and
attention body), and the layers run on every shard of the list in lockstep,
layer by layer. ``reduce_fn`` (tensor parallelism, as in JAX) is applied to
the attention output projection and the MLP down projection, the two
row-sharded products whose partial sums are summed across the tp axis:
here a function of one tensor (``all_reduce`` on a rank);
``parallel/serving_tp.py`` runs the same steps over every position of a
one-device mesh, where each reduce point is one ``psum`` over the list.
"""

from __future__ import annotations

from typing import Callable, Optional, Sequence, Tuple

import numpy as np
import torch
from torch import nn

from ..ops.decode import (KVCache, QPAD, append_kv, append_kv_seq,
                          decode_attention, decode_block_table, init_kv_cache,
                          prefill_kv)
from ..ops.fused_attention import fused_sparse_attention, warm_flash_meta
from ..ops.kernels.flash_sparse import KERNEL_TILE
from ._step_graph import GraphPool, StepRunner
from .transformer import (_LN_EPS, SparseTransformer, _dense,
                          cached_batched_spec)

__all__ = ["SparseDecoder", "Step", "run_steps"]


def _layernorm(ln, x):
    """``ln`` (``nn.LayerNorm`` or ``nn.Identity``) on ``x``. An activation
    narrower than the f32 LayerNorm (a bf16 embedding after
    ``cast_params``) follows JAX's ``_layernorm`` as XLA compiles it: the
    mean, the centred values and ``sqrt(var + eps)`` round to the
    activation's dtype, the quotient stays f32 and meets the f32 scale."""
    if isinstance(ln, nn.Identity) or x.dtype == ln.weight.dtype:
        return ln(x)
    dt, xf = x.dtype, x.float()
    mu = xf.mean(-1, keepdim=True).to(dt)
    var = xf.var(-1, unbiased=False, keepdim=True).to(dt)
    den = torch.sqrt((var.float() + _LN_EPS).to(dt).float()).to(dt)
    y = (x - mu).float() / den.float()
    return y * ln.weight + ln.bias


class Step:
    """One shard's part of a decoder step: the decoder whose model it runs,
    its input ``x``, its per-layer ``caches`` (replaced layer by layer as
    the step writes them), ``attn(li, q, k, v) -> [b, s, heads * hd]`` (layer
    ``li``'s attention body) and, for a prefill, ``write(li, k, v)`` (layer
    ``li``'s cache write)."""

    def __init__(self, dec, x, caches, attn: Callable,
                 write: Optional[Callable] = None):
        self.dec, self.x, self.caches = dec, x, list(caches)
        self.attn, self.write = attn, write


def run_steps(steps: Sequence[Step], reduce: Optional[Callable] = None):
    """Run the layers of every shard's step in lockstep, layer by layer.
    ``reduce(list of partial sums) -> list`` (one entry a shard) is applied
    at the two reduce points of each layer, the attention output projection
    and the MLP down projection (``None``: no reduction). Returns ``(ys,
    caches)``, a list each, one entry a shard."""
    xs = [s.x for s in steps]
    for li in range(steps[0].dec.model.num_layers):
        layers = [s.dec.model.layers[li] for s in steps]
        qkv = [s.dec._qkv(layer, _layernorm(layer.ln_attn, x))
               for s, layer, x in zip(steps, layers, xs)]
        part = [_dense(layer.self_attention.dense, s.attn(li, *t))
                for s, layer, t in zip(steps, layers, qkv)]
        if reduce is not None:
            part = reduce(part)
        xs = [x + a if layer.use_residual else a
              for x, a, layer in zip(xs, part, layers)]
        part = [layer.mlp(_layernorm(layer.ln_mlp, x))
                for layer, x in zip(layers, xs)]
        if reduce is not None:
            part = reduce(part)
        xs = [x + m if layer.use_residual else m
              for x, m, layer in zip(xs, part, layers)]
        for s, (_, k, v) in zip(steps, qkv):
            if s.write is not None:
                s.write(li, k, v)
    return xs, [tuple(s.caches) for s in steps]


def _run_one(step: Step, reduce_fn=None):
    """One shard's step; ``reduce_fn`` is JAX's hook, a function of one
    tensor."""
    red = None if reduce_fn is None else (
        lambda ts: [reduce_fn(t) for t in ts])
    (y,), (caches,) = run_steps([step], red)
    return y, caches


class SparseDecoder:
    """Generation runtime over a ``SparseTransformer``.

    Args:
      model: the ``SparseTransformer`` (its masks drive prefill attention;
        decode attention follows ``window`` / ``sinks``).
      s_max: cache capacity in tokens per sequence; rounded up to ``bk``.
      bk: KV block size (the decode kernel takes up to 1024).
      window: sliding-window span in TOKENS for decode attention, or
        ``None`` for the full causal history.
      sinks: attention-sink BLOCKS kept from position 0 (with a window).
      cache_dtype: ``torch.bfloat16`` (default), ``torch.float32`` or
        ``torch.int8`` (per-token dequant scales).
    """

    def __init__(self, model: SparseTransformer, *, s_max: int,
                 bk: int = 256, window: Optional[int] = None, sinks: int = 0,
                 cache_dtype=torch.bfloat16):
        if model.hidden_size % model.num_heads:
            raise ValueError("hidden_size must divide num_heads")
        if getattr(model, "moe_every", 0):
            raise ValueError(
                "serving decoders expect dense-MLP layers; MoE-interleaved "
                "models (moe_every > 0) are a training-side feature")
        self.model = model
        self.bk = bk
        self.s_max = -(-s_max // bk) * bk
        self.nb = self.s_max // bk
        if window is None:
            self.window_blocks, self.sink_blocks = self.nb, 0
        else:
            # window rows may straddle a block boundary -> +1 block
            self.window_blocks = min(-(-window // bk) + 1, self.nb)
            self.sink_blocks = min(sinks, self.nb)
        self.cache_dtype = cache_dtype
        self.hd = model.hidden_size // model.num_heads
        self.kv_heads = model.num_kv_heads or model.num_heads
        if model.num_heads % self.kv_heads:
            raise ValueError(f"num_kv_heads {self.kv_heads} must divide "
                             f"num_heads {model.num_heads}")
        self.group = model.num_heads // self.kv_heads
        # the model's own spec cache at the flash kernel's tiles: one copy
        # of the metadata shared with the model's forward
        self.spec = cached_batched_spec(model.mask_topology, model.num_heads,
                                        KERNEL_TILE, KERNEL_TILE)
        # the memory pool of this decoder's step graphs (decode_loop and
        # LMServer.generate capture one a call)
        self.graph_pool = GraphPool()

    @property
    def device(self) -> torch.device:
        return next(self.model.parameters()).device

    # -- params ------------------------------------------------------------

    @staticmethod
    def cast_params(module: nn.Module, dtype=torch.bfloat16) -> nn.Module:
        """Store ``module``'s weights in ``dtype`` for serving (bf16 halves
        the weight bytes a decode step reads), IN PLACE, and return it.
        ``module`` is a ``SparseTransformer`` or a ``SparseLM`` (its
        embedding and an untied head too). Parameters under a name that
        starts with ``ln_`` (the LayerNorms) stay f32, as in JAX. The
        decoders then compute JAX's promotion: the f32 activations meet the
        weights' exact values in f32 products. The training forward is not
        meant to run cast weights."""
        for name, p in module.named_parameters():
            if not any(part.startswith("ln_") for part in name.split(".")):
                p.data = p.data.to(dtype)
        return module

    # -- cache management --------------------------------------------------

    def init_caches(self, batch: int) -> Tuple[KVCache, ...]:
        """One empty cache per layer; replicas = batch * KV heads."""
        return tuple(init_kv_cache(batch * self.kv_heads, self.s_max,
                                   self.hd, dtype=self.cache_dtype,
                                   device=self.device)
                     for _ in range(self.model.num_layers))

    # -- shared layer math (mirrors SparseTransformer.forward) -------------

    def _qkv(self, layer, x):
        """``[b, s, h]`` -> q ``[b, s, heads, hd]``, k / v ``[b, s,
        kv_heads, hd]``: head-interleaved for MHA, flat q|k|v for GQA, as
        ``SparseSelfAttention.forward`` splits it."""
        b, s, _ = x.shape
        heads, kv, hd = self.model.num_heads, self.kv_heads, self.hd
        qkv = _dense(layer.self_attention.query_key_value, x)
        if kv == heads:
            return qkv.reshape(b, s, heads, 3 * hd).split(hd, dim=-1)
        q = qkv[..., : heads * hd].reshape(b, s, heads, hd)
        k = qkv[..., heads * hd: (heads + kv) * hd].reshape(b, s, kv, hd)
        v = qkv[..., (heads + kv) * hd:].reshape(b, s, kv, hd)
        return q, k, v

    @staticmethod
    def _fold(x):
        """``[b, s, h, hd]`` -> ``[b*h, s, hd]`` (replica ``b_idx*h + h``)."""
        b, s, h, hd = x.shape
        return x.transpose(1, 2).reshape(b * h, s, hd)

    def _unfold(self, ctx, b):
        """``[b*heads, s, hd]`` -> ``[b, s, heads*hd]``."""
        heads = self.model.num_heads
        s = ctx.shape[1]
        return ctx.reshape(b, heads, s, self.hd).transpose(1, 2).reshape(
            b, s, heads * self.hd)

    # -- prefill -------------------------------------------------------------

    def _prefill_setup(self, caches, T: int):
        """Hook: cache-family-specific validation / allocation before the
        prompt pass (paged decoders reserve the prompt's pages)."""
        return caches

    def _prefill_write(self, cache, k3, v3, len_r):
        """Hook: bulk-write one layer's folded ``[R_kv, T, hd]`` K/V into
        its cache (paged decoders write pool pages instead)."""
        return prefill_kv(cache, k3, v3, len_r)

    def _plan_prefill(self, x, caches, lengths=None) -> "Step":
        """This shard's prompt pass (see ``prefill``)."""
        mt = self.model.mask_topology
        T = x.shape[1]
        if T != mt.m:
            raise ValueError(f"prompt length {T} != mask rows {mt.m}")
        caches = self._prefill_setup(caches, T)
        len_r = None if lengths is None else torch.as_tensor(
            lengths, device=x.device).to(torch.int32).repeat_interleave(
                self.kv_heads)
        if self.model.attention_layout == "panel":
            # the model's own batched chain SDDMM -> softmax -> SpMM (the
            # attention core has no parameters: every layer's is the same)
            core = self.model.layers[0].self_attention.core
            attn = (lambda li, q, k, v: core(q, k, v))
        else:
            warm_flash_meta(self.spec, x.device, backward=False)
            attn = (lambda li, q, k, v: self._flash_attn(q, k, v))

        def write(li, k, v):
            step.caches[li] = self._prefill_write(
                step.caches[li], self._fold(k), self._fold(v), len_r)

        step = Step(self, x, caches, attn, write)
        return step

    @torch.no_grad()
    def prefill(self, x, caches: Sequence[KVCache], lengths=None,
                reduce_fn=None):
        """Run the prompt ``x [b, T, h]`` through the model (sparse-flash
        attention on the model's masks; the batched panel chain on a
        ``attention_layout="panel"`` model) and bulk-write every layer's K/V
        into ``caches``. Returns ``(y [b, T, h], caches)``.

        ``lengths`` (``[b]``, optional): per-sequence prompt lengths of a
        batch right-padded to ``T``. With causal masks rows below a
        sequence's length never attend its pad positions; read sequence
        ``s``'s output at ``lengths[s] - 1``. ``kv_len`` is set per replica,
        so decoding continues through ``decode_step_ragged``."""
        return _run_one(self._plan_prefill(x, caches, lengths), reduce_fn)

    def _flash_attn(self, q, k, v):
        """Prompt attention through the sparse-flash kernel (GQA native)."""
        scale = 1.0 / float(np.sqrt(self.hd))
        ctx = fused_sparse_attention(self.spec, self._fold(q), self._fold(k),
                                     self._fold(v), scale=scale,
                                     group=self.group)
        return self._unfold(ctx, q.shape[0])

    # -- decode --------------------------------------------------------------

    def _plan_decode(self, x, caches, append_fn, tbl, valid, qlen) -> "Step":
        """A decode step's shard: per layer, append this step's K/V
        (``append_fn(cache, k3, v3)``, folded ``[R_kv, qlen, hd]``) and
        attend over the step's table."""
        b = x.shape[0]
        scale = 1.0 / float(np.sqrt(self.hd))

        def attn(li, q, k, v):
            cache = step.caches[li] = append_fn(
                step.caches[li], self._fold(k), self._fold(v))
            ctx = decode_attention(self._fold(q), cache, tbl, valid,
                                   bk=self.bk, qlen=qlen, group=self.group,
                                   scale=scale)
            return self._unfold(ctx, b)

        step = Step(self, x, caches, attn)
        return step

    def _table(self, kv_len):
        return decode_block_table(kv_len, s_max=self.s_max, bk=self.bk,
                                  window_blocks=self.window_blocks,
                                  sink_blocks=self.sink_blocks)

    def _plan_step(self, x_tok, caches) -> "Step":
        pos = caches[0].kv_len[0]
        tbl, valid = self._table(
            torch.clamp(caches[0].kv_len + 1, max=self.s_max))

        def append(cache, k3, v3):
            return append_kv(cache, k3[:, 0], v3[:, 0], pos=pos)

        return self._plan_decode(x_tok, caches, append, tbl, valid, 1)

    @torch.no_grad()
    def decode_step(self, x_tok, caches: Sequence[KVCache], reduce_fn=None):
        """Advance one token with every sequence at the same length:
        ``x_tok [b, 1, h]`` -> ``(y [b, 1, h], caches)``. The write position
        is ONE device scalar (``caches[0].kv_len[0]``, never read on the
        host) and the table is built once per step. Its length clamps at
        ``s_max``: past capacity the append is a guarded no-op, and an
        unclamped ``kv_len + 1`` would mark an out-of-range block valid
        (the JAX package measured a 0.127 output error without the
        clamp)."""
        return _run_one(self._plan_step(x_tok, caches), reduce_fn)

    def _plan_ragged(self, x_tok, caches, active=None) -> "Step":
        act_r = None
        adv = 1
        if active is not None:
            act_r = torch.as_tensor(active, device=x_tok.device).to(
                torch.int32).repeat_interleave(self.kv_heads)
            adv = act_r
        tbl, valid = self._table(
            torch.clamp(caches[0].kv_len + adv, max=self.s_max))

        def append(cache, k3, v3):
            return append_kv(cache, k3[:, 0], v3[:, 0], active=act_r)

        return self._plan_decode(x_tok, caches, append, tbl, valid, 1)

    @torch.no_grad()
    def decode_step_ragged(self, x_tok, caches: Sequence[KVCache],
                           active=None, reduce_fn=None):
        """One token per sequence with PER-SEQUENCE cache lengths (the
        continuous-batching step): each slot appends at its own ``kv_len``
        through the ragged-append kernel and attends its own table.
        ``active`` (bool ``[b]``) freezes finished slots: their token is
        computed but not written, and their cache and ``kv_len`` stay as
        they were. A slot at ``kv_len == s_max`` keeps its cache too, but
        gains no context: evict or rotate full slots (``insert_kv_slot``)."""
        return _run_one(self._plan_ragged(x_tok, caches, active), reduce_fn)

    def _plan_multi(self, x_toks, caches) -> "Step":
        qn = x_toks.shape[1]
        if qn > QPAD:
            raise ValueError(f"q {qn} > QPAD {QPAD}")
        pos = caches[0].kv_len[0]
        tbl, valid = self._table(
            torch.clamp(caches[0].kv_len + qn, max=self.s_max))

        def append(cache, k3, v3):
            return append_kv_seq(cache, k3, v3, pos)

        return self._plan_decode(x_toks, caches, append, tbl, valid, qn)

    @torch.no_grad()
    def decode_multi(self, x_toks, caches: Sequence[KVCache],
                     reduce_fn=None):
        """Speculative verification: advance ``q <= 8`` draft tokens at
        once, ``x_toks [b, q, h]`` -> ``(y [b, q, h], caches)``, equal to
        ``q`` sequential ``decode_step`` calls on the same inputs, with one
        attention pass and one bulk cache write per layer. With a window,
        rows before the last see up to ``q - 1`` extra trailing tokens.
        If the draft does not fit below ``s_max`` nothing is written and
        ``kv_len`` does not advance (the rejection signal; the outputs of
        such a step are meaningless)."""
        return _run_one(self._plan_multi(x_toks, caches), reduce_fn)

    @staticmethod
    def rollback(caches: Sequence[KVCache], n: int) -> Tuple[KVCache, ...]:
        """Reject the last ``n`` speculative tokens: a smaller ``kv_len``
        (positions past it are never read; no data moves)."""
        return tuple(c.with_len(c.kv_len - n) for c in caches)

    @torch.no_grad()
    def decode_loop(self, x_tok, caches: Sequence[KVCache], n_tokens: int,
                    next_input=None):
        """``n_tokens`` uniform decode steps. ``next_input(y) -> x`` maps a
        step's output to the next input (identity by default; it runs
        outside the graph). Returns ``(ys [n_tokens, b, 1, h], caches)``.

        On a CUDA device the first step runs eagerly, the second is
        captured as a CUDA graph and every later step replays it
        (``_step_graph.StepRunner``): one host launch a token.
        The graph keeps the caches' page tables as captured, so a paged
        decoder's ``reserve(caches, n_tokens)`` comes first and no host
        scheduler step (``reserve``, ``release``, ``share_prefix``,
        ``insert_kv_slot``) may run inside the loop. A failed capture
        raises. CPU tensors run the same steps eagerly."""
        if n_tokens < 1:
            raise ValueError(f"n_tokens must be >= 1, got {n_tokens}")
        nxt = next_input or (lambda y: y)
        run = StepRunner(self.decode_step, caches, self.graph_pool)
        ys = None
        for i in range(n_tokens):
            y = run(x_tok)
            if ys is None:
                ys = y.new_empty((n_tokens,) + tuple(y.shape))
            ys[i].copy_(y)
            x_tok = nxt(y)
        return ys, run.caches
