"""The mesh seam of the sequence-parallel layer: what stands in for JAX's
``shard_map`` and its collectives (``jax.lax.ppermute``, ``all_gather``,
``psum``).

A stacked operand ``[ndev, ...]`` holds one shard per mesh position, as
the JAX package's single-controller surface takes it. The layers above
write each shard's work once, as a rank-local step on per-shard tensors,
and route every exchange between shards through the functions here.

In this package every shard lies on the one device of the stacked tensor:
a shard is a view of it (:func:`shards`), and a collective hands tensors
between the positions of a list. A rotation (:func:`ppermute`) moves
references and copies nothing; :func:`all_gather` concatenates and
:func:`psum` adds. Putting the shards on separate cards or processes
(``ROADMAP.md`` A9c) replaces this module alone.
"""

from __future__ import annotations

from typing import List, Sequence, Tuple

import torch

__all__ = ["check_devices", "shards", "ppermute", "all_gather", "psum",
           "stack"]


def check_devices(devices) -> None:
    """The specs take ``devices=None``: every shard on the stacked
    operands' one device. Anything else needs a transport between cards,
    which this package does not have yet."""
    if devices is not None:
        raise ValueError(
            "the sequence-parallel layer runs every shard on one device "
            "(devices=None); shards on separate cards or processes are "
            "ROADMAP.md A9c")


def shards(x: torch.Tensor) -> List[torch.Tensor]:
    """A stacked ``[ndev, ...]`` tensor's shards, as views."""
    return list(x.unbind(0))


def ppermute(xs: Sequence[torch.Tensor],
             pairs: Sequence[Tuple[int, int]]) -> List[torch.Tensor]:
    """``jax.lax.ppermute``: shard ``dst`` receives shard ``src``'s tensor
    for each ``(src, dst)`` pair; a shard that receives nothing gets
    zeros."""
    out = [None] * len(xs)
    for src, dst in pairs:
        out[dst] = xs[src]
    return [torch.zeros_like(x) if o is None else o
            for x, o in zip(xs, out)]


def all_gather(xs: Sequence[torch.Tensor]) -> torch.Tensor:
    """``jax.lax.all_gather(..., tiled=True)``: the shards concatenated
    along their first axis, the same for every shard."""
    return torch.cat(list(xs), 0)


def psum(xs: Sequence[torch.Tensor]) -> torch.Tensor:
    """``jax.lax.psum``: the sum of the shards, the same for every shard."""
    return torch.stack(list(xs)).sum(0)


def stack(xs: Sequence[torch.Tensor]) -> torch.Tensor:
    """Per-shard results back into one stacked ``[ndev, ...]`` tensor."""
    return torch.stack(list(xs))
