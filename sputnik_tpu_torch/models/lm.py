"""Token-level language model, sampling and the generation server
(counterpart of ``sputnik_tpu/models/lm.py``).

  * ``SparseLM``: ``nn.Embedding`` + ``SparseTransformer`` core + final
    LayerNorm (``ln_f``, eps 1e-6) + a tied head (``F.linear(x,
    embed.weight)``) or an untied ``lm_head``: ``tokens [b, s] -> logits
    [b, s, vocab]``.
  * ``sample_logits``: temperature first, then top-k, then top-p;
    ``temperature == 0`` is argmax. Draws are Gumbel-max from an explicit
    ``torch.Generator``: a categorical sample with no host sync. JAX's
    ``categorical`` is Gumbel-max too, but the two random streams differ,
    so only greedy decoding matches the JAX package token for token.
  * ``LMServer``: token-in / token-out generation over ``SparseDecoder``;
    ``generate`` runs eagerly (prefill, then a Python loop of decode steps
    with in-loop sampling, all on the device).
"""

from __future__ import annotations

import math
from typing import Optional

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from .serving import SparseDecoder
from .transformer import SparseTransformer, _linear

__all__ = ["SparseLM", "LMServer", "sample_logits",
           "apply_repetition_penalty"]

_LN_EPS = 1e-6


class SparseLM(nn.Module):
    """Sparse-attention language model: ``tokens [b, s] -> logits
    [b, s, vocab]``. ``core`` carries the masks and every transformer
    hyperparameter; ``tie_embeddings`` reuses the embedding as the head.
    The embedding is initialised like flax ``nn.Embed`` (normal, std
    ``1 / sqrt(hidden)``), the untied head like ``nn.Dense``."""

    def __init__(self, core: SparseTransformer, vocab_size: int,
                 tie_embeddings: bool = True, final_layernorm: bool = True, *,
                 generator: Optional[torch.Generator] = None, device=None):
        super().__init__()
        h = core.hidden_size
        self.core = core
        self.vocab_size = vocab_size
        self.tie_embeddings = tie_embeddings
        self.final_layernorm = final_layernorm
        self.embed = nn.Embedding(vocab_size, h, device=device)
        with torch.no_grad():
            self.embed.weight.normal_(0.0, 1.0 / math.sqrt(h),
                                      generator=generator)
        self.ln_f = (nn.LayerNorm(h, eps=_LN_EPS, device=device)
                     if final_layernorm else nn.Identity())
        if not tie_embeddings:
            self.lm_head = _linear(h, vocab_size, generator, device,
                                   bias=False)

    @classmethod
    def from_masks(cls, masks: np.ndarray, *, vocab_size: int,
                   tie_embeddings: bool = True, final_layernorm: bool = True,
                   generator: Optional[torch.Generator] = None, device=None,
                   **core_kwargs) -> "SparseLM":
        """Build over per-batch dense 0/1 masks ``[b, s, s]``; the other
        keyword arguments go to ``SparseTransformer``."""
        core = SparseTransformer.from_masks(masks, generator=generator,
                                            device=device, **core_kwargs)
        return cls(core, vocab_size, tie_embeddings, final_layernorm,
                   generator=generator, device=device)

    def head(self, x):
        """Final LayerNorm + LM head on activations ``x [..., h]``."""
        x = self.ln_f(x)
        if self.tie_embeddings:
            return F.linear(x, self.embed.weight)
        return self.lm_head(x)

    def forward(self, tokens):
        return self.head(self.core(self.embed(tokens)))


def apply_repetition_penalty(logits, present, penalty: float):
    """HF-style repetition penalty: for tokens marked ``present`` (bool
    ``[..., vocab]``) positive logits divide by ``penalty`` and negative
    ones multiply by it."""
    pen = torch.where(logits > 0, logits / penalty, logits * penalty)
    return torch.where(present, pen, logits)


def sample_logits(logits, generator: Optional[torch.Generator] = None, *,
                  temperature: float = 1.0, top_k: Optional[int] = None,
                  top_p: Optional[float] = None):
    """Sample token ids from ``logits [..., vocab]``.

    ``temperature == 0`` is greedy (argmax; no generator needed). Else the
    logits scale by the temperature FIRST, then ``top_k`` keeps the k
    largest and ``top_p`` the smallest prefix of the sorted distribution
    whose mass reaches ``top_p`` (HF / vLLM order), and the draw is
    Gumbel-max with uniforms from ``generator``, which must live on the
    logits' device (``torch.Generator(device=...)``)."""
    if temperature == 0.0:
        return torch.argmax(logits, dim=-1)
    if generator is None:
        raise ValueError("sampling (temperature != 0) needs a generator")
    logits = logits.float() / temperature
    neg = torch.tensor(-1e30, dtype=logits.dtype, device=logits.device)
    if top_k is not None and top_k < logits.shape[-1]:
        kth = torch.topk(logits, top_k, dim=-1).values[..., -1:]
        logits = torch.where(logits < kth, neg, logits)
    if top_p is not None and top_p < 1.0:
        sorted_logits = torch.sort(logits, dim=-1, descending=True).values
        probs = torch.softmax(sorted_logits, dim=-1)
        cum = torch.cumsum(probs, dim=-1)
        # keep a token if the mass BEFORE it is < top_p (the first token is
        # always kept); the threshold is the smallest kept sorted logit
        keep = (cum - probs) < top_p
        thresh = torch.where(keep, sorted_logits, math.inf).amin(
            -1, keepdim=True)
        logits = torch.where(logits < thresh, neg, logits)
    u = torch.rand(logits.shape, generator=generator, device=logits.device)
    gumbel = -torch.log(-torch.log(u.clamp(min=1e-20)))
    return torch.argmax(logits + gumbel, dim=-1)


class LMServer:
    """Token-level generation over a ``SparseLM``: the embedding, final
    LayerNorm and head wrap a ``SparseDecoder`` bound to the LM's core.
    The prompt length must equal the core masks' row count (prefill runs
    the model's own sparse topology); decode attends full-causal or
    sinks + window over the block KV cache.

    ``n_pages`` (paged serving) and ``decoder`` (tensor-parallel serving)
    are not ported yet and raise ``NotImplementedError``."""

    def __init__(self, lm: SparseLM, *, s_max: Optional[int] = None,
                 bk: int = 256, window: Optional[int] = None, sinks: int = 0,
                 cache_dtype=torch.bfloat16, n_pages: Optional[int] = None,
                 decoder: Optional[SparseDecoder] = None):
        if n_pages is not None:
            raise NotImplementedError(
                "paged serving (n_pages=) is not ported yet — ROADMAP A13 "
                "(kernels B20a, B20b)")
        if decoder is not None:
            raise NotImplementedError(
                "an external decoder (decoder=, tensor-parallel serving) is "
                "not ported yet — ROADMAP A17")
        if s_max is None:
            raise ValueError("s_max is required")
        self.lm = lm
        self.decoder = SparseDecoder(lm.core, s_max=s_max, bk=bk,
                                     window=window, sinks=sinks,
                                     cache_dtype=cache_dtype)

    def init_caches(self, batch: int):
        return self.decoder.init_caches(batch)

    @torch.no_grad()
    def prefill(self, tokens, caches, lengths=None):
        """Prompt pass: ``tokens [b, P] -> (logits [b, P, vocab], caches)``.
        With ``lengths`` read row ``s`` at ``lengths[s] - 1``."""
        y, caches = self.decoder.prefill(self.lm.embed(tokens), caches,
                                         lengths=lengths)
        return self.lm.head(y), caches

    @torch.no_grad()
    def decode_step(self, tok, caches):
        """One token: ``tok [b] -> (logits [b, vocab], caches)``."""
        y, caches = self.decoder.decode_step(self.lm.embed(tok)[:, None],
                                             caches)
        return self.lm.head(y)[:, 0], caches

    @torch.no_grad()
    def decode_step_ragged(self, tok, caches, active=None):
        """Continuous-batching step (per-slot cache positions, ``active``
        freezing finished slots): ``tok [b] -> (logits [b, vocab],
        caches)``; see ``SparseDecoder.decode_step_ragged``."""
        y, caches = self.decoder.decode_step_ragged(
            self.lm.embed(tok)[:, None], caches, active)
        return self.lm.head(y)[:, 0], caches

    @torch.no_grad()
    def generate(self, tokens, n_new: int,
                 generator: Optional[torch.Generator] = None, *,
                 temperature: float = 0.0, top_k: Optional[int] = None,
                 top_p: Optional[float] = None, eos_id: Optional[int] = None,
                 pad_id: int = 0, repetition_penalty: float = 1.0,
                 prompt_lengths=None):
        """Generate ``n_new`` tokens after the prompt ``tokens [b, P]``.
        Returns ``(new_tokens [b, n_new], caches)``.

        Only the last real prompt position gets a head. ``eos_id``: a
        sequence that emits it is finished, and every later position holds
        ``pad_id`` (the loop still runs at full batch width).
        ``prompt_lengths`` (``[b]``): a right-padded variable-length batch;
        each sequence samples its first token from its own last real
        position and decode runs the ragged step. ``repetition_penalty``
        (HF semantics) penalises every token present so far (prompt and
        generated), greedy decoding included. The sampled token of the last
        step is returned but never decoded."""
        if n_new < 1:
            raise ValueError(f"n_new must be >= 1, got {n_new}")
        if temperature != 0.0 and generator is None:
            raise ValueError("sampling (temperature != 0) needs a generator")
        b = tokens.shape[0]
        dev = tokens.device
        caches = self.init_caches(b)
        lens = None if prompt_lengths is None else torch.as_tensor(
            prompt_lengths, device=dev).long()

        present = None
        if repetition_penalty != 1.0:
            # token-presence mask [b, vocab] seeded from the prompt's real
            # positions
            real = torch.ones(tokens.shape, device=dev) if lens is None else (
                torch.arange(tokens.shape[1], device=dev)[None] < lens[:, None]
            ).float()
            present = torch.zeros((b, self.lm.vocab_size), device=dev
                                  ).scatter_reduce(1, tokens.long(), real,
                                                   "amax") > 0
        done = torch.zeros((b,), dtype=torch.bool, device=dev)
        rows = torch.arange(b, device=dev)

        def pick(logits, done, present):
            if present is not None:
                logits = apply_repetition_penalty(logits, present,
                                                  repetition_penalty)
            tok = sample_logits(logits, generator, temperature=temperature,
                                top_k=top_k, top_p=top_p)
            if eos_id is not None:
                tok = torch.where(done, pad_id, tok)
                done = done | (tok == eos_id)
            if present is not None:
                present[rows, tok] = True
            return tok, done, present

        y, caches = self.decoder.prefill(self.lm.embed(tokens), caches,
                                         lengths=lens)
        if lens is None:
            last = y[:, -1]
            step = self.decode_step
        else:
            last = y[rows, lens - 1]
            step = self.decode_step_ragged
        tok, done, present = pick(self.lm.head(last), done, present)
        out = [tok]
        for _ in range(n_new - 1):
            logits, caches = step(tok, caches)
            tok, done, present = pick(logits, done, present)
            out.append(tok)
        return torch.stack(out, dim=1), caches
