"""Token-level tensor / data-parallel serving: ``LMServer.generate`` over a
``Mesh`` (counterpart of ``sputnik_tpu/parallel/lm_tp.py``).

The transformer core is sharded as ``TPDecoder`` shards it (QKV column-
sharded by head groups, two reduce points a layer); the embedding, the
final LayerNorm and the LM head are replicated: they are the ``SparseLM``'s
own modules. Every tp position samples identically from the same logits
and the same generator state, so no collective is spent on the token
choice.

The port's rule for JAX's ``fold_in(key, axis_index(batch_axis))``: under a
``batch_axis`` of size ``dp > 1``, a sampled ``generate`` first draws
``dp`` 62-bit seeds from the caller's generator (one ``torch.randint`` on
its device), and dp slice ``d`` samples from a fresh generator seeded with
seed ``d``. Every process draws the same seeds from a generator in the same
state, so the positions of one dp slice agree, the slices differ, and a
generator seeded alike gives the same tokens. Without a ``batch_axis``
the caller's generator samples the whole batch, as ``LMServer`` does.
"""

from __future__ import annotations

from typing import Optional

import torch

from ..models.lm import LMServer, SparseLM, sample_logits
from ._mesh import Mesh
from .serving_tp import PagedTPDecoder, TPDecoder

__all__ = ["TPLMServer"]


class TPLMServer(LMServer):
    """Tensor / data-parallel token-level generation.

    Usage::

        srv = TPLMServer(lm, mesh, s_max=..., bk=...)        # contiguous KV
        srv = TPLMServer(lm, mesh, n_pages=..., s_max=...)   # paged KV
        toks, caches = srv.generate(srv.rows(prompts), n_new)

    ``lm``'s embedding, final LayerNorm and head must live on the mesh's
    device (its core may live anywhere: the views are copied there).
    Tokens, ``prompt_lengths`` and the returned tokens are this process's
    rows (``TPDecoder``'s rule; ``rows(x)`` picks them from a whole batch);
    the caches stay sharded. The paged variant reserves its pages on the
    host first, as ``LMServer(n_pages=)`` does. Every ``LMServer.generate``
    option passes through (temperature / top-k / top-p, eos, repetition
    penalty, ``prompt_lengths``). The steps run eagerly: ``decoder`` is the
    ``TPDecoder`` (``PagedTPDecoder``).
    """

    _graphs = False

    def __init__(self, lm: SparseLM, mesh: Mesh, *, axis: str = "tp",
                 batch_axis: Optional[str] = None, s_max: int,
                 bk: int = 256, window: Optional[int] = None,
                 sinks: int = 0, cache_dtype=torch.bfloat16,
                 n_pages: Optional[int] = None):
        if lm.embed.weight.device != mesh.device:
            raise ValueError(
                f"the LM's embedding is on {lm.embed.weight.device}, the "
                f"mesh's device {mesh.device}: move the replicated modules "
                "(embed, ln_f, lm_head) there")
        kw = dict(axis=axis, batch_axis=batch_axis, s_max=s_max, bk=bk,
                  window=window, sinks=sinks, cache_dtype=cache_dtype)
        tpd = (TPDecoder(lm.core, mesh, **kw) if n_pages is None else
               PagedTPDecoder(lm.core, mesh, n_pages=n_pages, **kw))
        super().__init__(lm, decoder=tpd)
        self.tpd, self.paged = tpd, n_pages is not None

    def shard_params(self):
        """Rebuild the core's views from the LM's current weights (the
        replicated modules are the LM's own)."""
        return self.tpd.shard_params()

    def rows(self, x):
        """This process's rows of a whole batch (``TPDecoder.rows``)."""
        return self.tpd.rows(x)

    def _sampler(self, generator, **sampling):
        tpd = self.tpd
        if tpd.dp == 1 or sampling.get("temperature", 1.0) == 0.0:
            return super()._sampler(generator, **sampling)
        if generator is None:
            raise ValueError("sampling (temperature != 0) needs a generator")
        seeds = torch.randint(0, 2 ** 62, (tpd.dp,), generator=generator,
                              device=generator.device).tolist()
        gens = [torch.Generator(device=generator.device).manual_seed(
            seeds[d]) for d in tpd._dps]
        n = tpd.b_local

        def sample(logits):
            return torch.cat([
                sample_logits(logits[i * n:(i + 1) * n], g, **sampling)
                for i, g in enumerate(gens)])

        return sample
