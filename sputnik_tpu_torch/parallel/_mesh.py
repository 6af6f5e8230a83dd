"""The mesh of the distribution layer: what stands in for JAX's ``Mesh``,
``shard_map`` and its collectives (``jax.lax.psum``, ``all_gather``,
``psum_scatter``, ``ppermute``).

:class:`Mesh` names its axes and sizes (``Mesh({"dp": 2, "tp": 2})``, row-
major positions as in ``Mesh(devices.reshape(dp, tp), ("dp", "tp"))``) and
has two backends:

  * **one device** (``Mesh(axes, device=...)``): every position lives on
    one device, and this process holds every position's shard;
  * **process group** (``Mesh(axes, distributed=True)``): one position a
    rank of an initialised ``torch.distributed`` world (position = rank,
    row-major), NCCL between CUDA ranks (device ``cuda:{LOCAL_RANK}``) and
    gloo on the CPU. Every rank builds one sub-group per axis line with
    ``dist.new_group``, all in the same order.

A layer writes each position's work once and hands the mesh *the list of
this process's shards*, in the order of :attr:`Mesh.positions`: every
position's on one device, one entry on a rank. Each collective takes such a
list and an axis name and returns a list of the same length: on one device
it adds, concatenates or moves the tensors of each line of the axis, on a
rank it calls ``torch.distributed`` on that axis's group. A CUDA tensor on
a gloo mesh, a CPU tensor on an NCCL mesh and a process-group mesh without
an initialised world raise: nothing moves to another device by itself.

The module-level functions below are the single-axis seam the
sequence-parallel layer (A9a / A9b) runs on: a stacked ``[ndev, ...]``
operand's shards, all on its one device, a rotation moving references and
copying nothing. Those layers keep ``devices=None``; putting them on ranks
(``ROADMAP.md`` A9d) moves them onto :class:`Mesh`.
"""

from __future__ import annotations

import math
import os
from typing import Dict, List, Mapping, Optional, Sequence, Tuple

import torch

__all__ = ["Mesh", "check_devices", "shards", "ppermute", "all_gather",
           "psum", "psum_scatter", "stack"]


def check_devices(devices) -> None:
    """The sequence-parallel specs take ``devices=None``: every shard on the
    stacked operands' one device."""
    if devices is not None:
        raise ValueError(
            "the sequence-parallel layer runs every shard on one device "
            "(devices=None); its shards on separate cards or processes are "
            "ROADMAP.md A9d (A9c gave tensor-parallel serving the transport, "
            "parallel._mesh.Mesh)")


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


def all_gather(xs: Sequence[torch.Tensor], dim: int = 0) -> torch.Tensor:
    """``jax.lax.all_gather(..., axis=dim, tiled=True)``: the shards
    concatenated along ``dim``, the same for every shard."""
    return torch.cat(list(xs), dim)


def psum(xs: Sequence[torch.Tensor]) -> torch.Tensor:
    """``jax.lax.psum``: the sum of the shards, the same for every shard."""
    return torch.stack(list(xs)).sum(0)


def psum_scatter(xs: Sequence[torch.Tensor],
                 dim: int = 0) -> List[torch.Tensor]:
    """``jax.lax.psum_scatter(..., scatter_dimension=dim, tiled=True)``, the
    reverse of :func:`all_gather`: shard ``d`` receives slice ``d`` (of
    ``len(xs)`` equal slices along ``dim``) of the shards' sum."""
    return list(torch.stack(list(xs)).sum(0).chunk(len(xs), dim))


def stack(xs: Sequence[torch.Tensor]) -> torch.Tensor:
    """Per-shard results back into one stacked ``[ndev, ...]`` tensor."""
    return torch.stack(list(xs))


class Mesh:
    """Named axes over positions, on one device or one position a rank.

    Args:
      axes: ``{name: size}`` in row-major order, e.g. ``{"dp": 2, "tp": 2}``.
      device: the one-device backend's device (default: the CPU; ``"cuda"``
        means the current card).
      distributed: the process-group backend: the world must be initialised
        (``torch.distributed.init_process_group``) with as many ranks as the
        mesh has positions; rank ``r`` holds position ``r`` (row-major). Its
        device is ``cuda:{LOCAL_RANK}`` on NCCL (``LOCAL_RANK`` as
        ``torchrun`` sets it, else the rank modulo the visible cards) and
        the CPU on gloo.

    Attributes: ``shape`` (``{name: size}``), ``size``, ``device``,
    ``distributed``, ``positions`` (this process's positions, each a tuple
    of axis indices, in the order of every shard list)."""

    def __init__(self, axes: Mapping[str, int], *, device=None,
                 distributed: bool = False):
        self.shape: Dict[str, int] = {str(k): int(v) for k, v in axes.items()}
        if not self.shape or min(self.shape.values()) < 1:
            raise ValueError(f"mesh axes need sizes >= 1, got {dict(axes)}")
        self.names = tuple(self.shape)
        self.size = math.prod(self.shape.values())
        self.distributed = bool(distributed)
        every = [self._coords(r) for r in range(self.size)]
        if not self.distributed:
            dev = torch.device(device if device is not None else "cpu")
            if dev.type == "cuda" and dev.index is None:
                dev = torch.device("cuda", torch.cuda.current_device())
            self.device = dev
            self.positions = every
            self.rank = None
            return
        import torch.distributed as dist

        if not (dist.is_available() and dist.is_initialized()):
            raise RuntimeError(
                "a process-group mesh needs an initialised torch.distributed "
                "world (init_process_group) first")
        if dist.get_world_size() != self.size:
            raise ValueError(f"mesh {self.shape} has {self.size} positions, "
                             f"the world {dist.get_world_size()} ranks")
        self.rank = dist.get_rank()
        self.backend = str(dist.get_backend()).lower()
        if self.backend == "nccl":
            local = int(os.environ.get(
                "LOCAL_RANK", self.rank % max(1, torch.cuda.device_count())))
            self.device = torch.device("cuda", local)
        elif self.backend == "gloo":
            self.device = torch.device("cpu")
        else:
            raise ValueError(f"backend {self.backend}: the mesh runs NCCL "
                             "(CUDA) or gloo (CPU)")
        if device is not None and torch.device(device) != self.device:
            raise ValueError(f"a {self.backend} rank's device is "
                             f"{self.device}, not {device}")
        self.positions = [every[self.rank]]
        # one group a line of each axis, created in the same order on every
        # rank (new_group is collective over the world)
        self._groups, self._line_ranks = {}, {}
        for ax in self.names:
            for line in self._lines(ax, every):
                ranks = [self._rank_of(p) for p in line]
                group = dist.new_group(ranks)
                if self.rank in ranks:
                    self._groups[ax], self._line_ranks[ax] = group, ranks

    # -- positions ------------------------------------------------------------

    def _coords(self, r: int) -> Tuple[int, ...]:
        out = []
        for n in reversed(self.shape.values()):
            out.append(r % n)
            r //= n
        return tuple(reversed(out))

    def _rank_of(self, pos: Sequence[int]) -> int:
        r = 0
        for i, n in zip(pos, self.shape.values()):
            r = r * n + i
        return r

    def _axis(self, axis: str) -> int:
        if axis not in self.shape:
            raise ValueError(f"no axis {axis!r} in mesh {self.shape}")
        return self.names.index(axis)

    def _lines(self, axis: str, positions) -> List[List[Tuple[int, ...]]]:
        """``positions`` grouped by every coordinate but ``axis``'s, each
        line in axis order."""
        a = self._axis(axis)
        lines: Dict[Tuple[int, ...], list] = {}
        for p in positions:
            lines.setdefault(p[:a] + p[a + 1:], []).append(p)
        return [sorted(line, key=lambda p: p[a]) for line in lines.values()]

    def index(self, axis: str) -> List[int]:
        """Each local position's index along ``axis`` (``axis_index``)."""
        a = self._axis(axis)
        return [p[a] for p in self.positions]

    # -- collectives ----------------------------------------------------------

    def _check(self, xs: Sequence[torch.Tensor]) -> None:
        if len(xs) != len(self.positions):
            raise ValueError(f"{len(xs)} shards for {len(self.positions)} "
                             "local positions")
        if not self.distributed:
            return
        for x in xs:
            if self.backend == "gloo" and x.is_cuda:
                raise ValueError("a CUDA tensor on a gloo mesh: gloo carries "
                                 "CPU tensors (NCCL carries CUDA ones)")
            if self.backend == "nccl" and not x.is_cuda:
                raise ValueError("a CPU tensor on an NCCL mesh")

    def _each_line(self, xs, axis, fn) -> List[torch.Tensor]:
        """One device: ``fn(line's tensors in axis order) -> one tensor or a
        list (one a member)`` on every line of ``axis``."""
        at = {p: i for i, p in enumerate(self.positions)}
        out: List[Optional[torch.Tensor]] = [None] * len(xs)
        for line in self._lines(axis, self.positions):
            got = fn([xs[at[p]] for p in line])
            for j, p in enumerate(line):
                out[at[p]] = got[j] if isinstance(got, list) else got
        return out

    def psum(self, xs: Sequence[torch.Tensor], axis: str
             ) -> List[torch.Tensor]:
        """``jax.lax.psum(x, axis)``: every position gets its line's sum. On
        one device the members of a line share one result tensor."""
        self._check(xs)
        if not self.distributed:
            return self._each_line(xs, axis, psum)
        import torch.distributed as dist

        y = xs[0].clone()
        dist.all_reduce(y, group=self._groups[axis])
        return [y]

    def all_gather(self, xs: Sequence[torch.Tensor], axis: str,
                   dim: int = 0) -> List[torch.Tensor]:
        """``jax.lax.all_gather(x, axis, axis=dim, tiled=True)``: the line's
        tensors concatenated along ``dim`` in axis order."""
        self._check(xs)
        if not self.distributed:
            return self._each_line(xs, axis, lambda t: all_gather(t, dim))
        import torch.distributed as dist

        x = xs[0].contiguous()
        parts = [torch.empty_like(x) for _ in self._line_ranks[axis]]
        dist.all_gather(parts, x, group=self._groups[axis])
        return [torch.cat(parts, dim)]

    def psum_scatter(self, xs: Sequence[torch.Tensor], axis: str,
                     dim: int = 0) -> List[torch.Tensor]:
        """``jax.lax.psum_scatter(x, axis, scatter_dimension=dim,
        tiled=True)``: position ``i`` of a line gets slice ``i`` of the
        line's sum. A rank reduces the whole tensor and keeps its slice
        (gloo has no reduce-scatter)."""
        self._check(xs)
        if not self.distributed:
            return self._each_line(xs, axis,
                                   lambda t: psum_scatter(t, dim))
        n = len(self._line_ranks[axis])
        i = self.index(axis)[0]
        return [self.psum(xs, axis)[0].chunk(n, dim)[i].contiguous()]

    def ppermute(self, xs: Sequence[torch.Tensor], axis: str,
                 pairs: Sequence[Tuple[int, int]]) -> List[torch.Tensor]:
        """``jax.lax.ppermute(x, axis, perm=pairs)``: along each line, index
        ``dst`` receives index ``src``'s tensor; an index that receives
        nothing gets zeros. A rank sends and receives with one
        ``batch_isend_irecv``."""
        self._check(xs)
        if not self.distributed:
            return self._each_line(xs, axis,
                                   lambda t: ppermute(t, pairs))
        import torch.distributed as dist

        me = self.index(axis)[0]
        ranks, group = self._line_ranks[axis], self._groups[axis]
        x = xs[0].contiguous()
        out = torch.zeros_like(x)
        ops = []
        for src, dst in pairs:
            if src == me and dst == me:
                out = x.clone()
            elif src == me:
                ops.append(dist.P2POp(dist.isend, x, ranks[dst], group))
            elif dst == me:
                ops.append(dist.P2POp(dist.irecv, out, ranks[src], group))
        if ops:
            for req in dist.batch_isend_irecv(ops):
                req.wait()
        return [out]
