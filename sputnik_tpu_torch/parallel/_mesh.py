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

Gradients follow JAX's transposition under ``shard_map``, so that a rank's
gradients equal the one-device mesh's and the unsharded model's, once and
not ``n`` times. A value is either *invariant* along an axis (the same on
every position of a line, computed by each, such as a loss) or *varying*:

  * ``psum`` (varying -> invariant) sums forward and hands each position
    its own cotangent backward (JAX's ``pvary`` is its transpose): every
    rank computes the loss from the same sum, so the cotangent each rank
    holds is already the whole one;
  * ``pvary`` (invariant -> varying), the entry of a replicated value into
    per-position work: identity forward, the sum of the positions'
    cotangents backward;
  * ``all_gather`` and ``psum_scatter`` (varying -> varying) are each
    other's transpose, and ``ppermute``'s is the inverse permutation.

On one device these are plain tensor algebra and autograd gives the same:
a line's members share one ``psum`` result (its cotangent reaches every
summand once), and a replicated value is one tensor listed for every
position (the cotangents of its uses add up). On a rank each collective is
a ``torch.autograd.Function`` whose backward runs the transposed
collective, so every rank must run the same backward graph: a tensor a
rank drops from its graph (a received ``ppermute`` carry it ignores) skips
that rank's half of an exchange and hangs its peers. Keep such a tensor in
the graph with a zero cotangent (``torch.where``).

The module-level functions below are the single-axis seam the
sequence-parallel layer (A9a / A9b) runs on: a stacked ``[ndev, ...]``
operand's shards, all on its one device, a rotation moving references and
copying nothing. Those layers keep ``devices=None``; putting their specs on
ranks (``ROADMAP.md`` A9d, its sequence-parallel half) moves them onto
:class:`Mesh`.
"""

from __future__ import annotations

import math
import os
from typing import (Dict, List, Mapping, NamedTuple, Optional,
                    Sequence, Tuple)

import torch

__all__ = ["Mesh", "check_devices", "shards", "ppermute", "all_gather",
           "psum", "psum_scatter", "stack"]


def check_devices(devices) -> None:
    """The sequence-parallel specs take ``devices=None``: every shard on the
    stacked operands' one device."""
    if devices is not None:
        raise ValueError(
            "the sequence-parallel layer runs every shard on one device "
            "(devices=None); its specs on separate cards or processes are "
            "the sequence-parallel half of ROADMAP.md A9d (A9c gave "
            "tensor-parallel serving the transport, parallel._mesh.Mesh, "
            "which the pipeline and expert parallelism train on too)")


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

    def held(self, axis: str, size: int) -> range:
        """The indices of ``size`` items split evenly along ``axis`` (stages,
        experts) that this process holds: all of them on one device, its
        position's ``size / n`` on a rank."""
        self._axis(axis)
        n = self.shape[axis]
        if size % n:
            raise ValueError(f"{size} not divisible by the {axis!r} axis "
                             f"size {n}")
        if not self.distributed:
            return range(size)
        lo = self.index(axis)[0] * (size // n)
        return range(lo, lo + size // n)

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

    def _line(self, axis: str) -> "_Line":
        """This rank's line of ``axis``: its group, ranks and index."""
        self._axis(axis)
        return _Line(self._groups[axis], self._line_ranks[axis],
                     self.index(axis)[0])

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
        one device the members of a line share one result tensor; on a rank
        the backward hands the rank's own cotangent through."""
        self._check(xs)
        if not self.distributed:
            return self._each_line(xs, axis, psum)
        return [_Psum.apply(xs[0], self._line(axis))]

    def pvary(self, xs: Sequence[torch.Tensor], axis: str
              ) -> List[torch.Tensor]:
        """``jax.lax.pvary(x, axis)``: a value invariant along ``axis`` (the
        same tensor on every position of a line) entering per-position work.
        Identity forward; backward, the sum of the line's cotangents (on one
        device autograd adds the uses of the one tensor by itself)."""
        self._check(xs)
        if not self.distributed:
            self._axis(axis)
            return list(xs)
        return [_Pvary.apply(xs[0], self._line(axis))]

    def all_gather(self, xs: Sequence[torch.Tensor], axis: str,
                   dim: int = 0) -> List[torch.Tensor]:
        """``jax.lax.all_gather(x, axis, axis=dim, tiled=True)``: the line's
        tensors concatenated along ``dim`` in axis order. Its transpose is
        :meth:`psum_scatter`."""
        self._check(xs)
        if not self.distributed:
            return self._each_line(xs, axis, lambda t: all_gather(t, dim))
        return [_AllGather.apply(xs[0], self._line(axis), dim)]

    def psum_scatter(self, xs: Sequence[torch.Tensor], axis: str,
                     dim: int = 0) -> List[torch.Tensor]:
        """``jax.lax.psum_scatter(x, axis, scatter_dimension=dim,
        tiled=True)``: position ``i`` of a line gets slice ``i`` of the
        line's sum. A rank reduces the whole tensor and keeps its slice
        (gloo has no reduce-scatter). Its transpose is :meth:`all_gather`."""
        self._check(xs)
        if not self.distributed:
            return self._each_line(xs, axis,
                                   lambda t: psum_scatter(t, dim))
        return [_PsumScatter.apply(xs[0], self._line(axis), dim)]

    def ppermute(self, xs: Sequence[torch.Tensor], axis: str,
                 pairs: Sequence[Tuple[int, int]]) -> List[torch.Tensor]:
        """``jax.lax.ppermute(x, axis, perm=pairs)``: along each line, index
        ``dst`` receives index ``src``'s tensor; an index that receives
        nothing gets zeros. A rank sends and receives with one
        ``batch_isend_irecv``; the backward sends the cotangents along the
        inverse pairs."""
        self._check(xs)
        if not self.distributed:
            return self._each_line(xs, axis,
                                   lambda t: ppermute(t, pairs))
        return [_Ppermute.apply(xs[0], self._line(axis),
                                tuple((int(s), int(d)) for s, d in pairs))]


# -- a rank's collectives and their transposes --------------------------------

class _Line(NamedTuple):
    """A rank's line of one axis: the group, its ranks in axis order, and
    the rank's index on it."""
    group: object
    ranks: List[int]
    me: int


def _all_reduce(x: torch.Tensor, line: _Line) -> torch.Tensor:
    import torch.distributed as dist

    y = x.clone(memory_format=torch.contiguous_format)
    dist.all_reduce(y, group=line.group)
    return y


def _all_gather(x: torch.Tensor, line: _Line, dim: int) -> torch.Tensor:
    import torch.distributed as dist

    x = x.contiguous()
    parts = [torch.empty_like(x) for _ in line.ranks]
    dist.all_gather(parts, x, group=line.group)
    return torch.cat(parts, dim)


def _scatter_sum(x: torch.Tensor, line: _Line, dim: int) -> torch.Tensor:
    parts = _all_reduce(x, line).chunk(len(line.ranks), dim)
    return parts[line.me].contiguous()


def _permute(x: torch.Tensor, line: _Line, pairs) -> torch.Tensor:
    import torch.distributed as dist

    x = x.contiguous()
    out = torch.zeros_like(x)
    ops = []
    for src, dst in pairs:
        if src == line.me and dst == line.me:
            out = x.clone()
        elif src == line.me:
            ops.append(dist.P2POp(dist.isend, x, line.ranks[dst],
                                  line.group))
        elif dst == line.me:
            ops.append(dist.P2POp(dist.irecv, out, line.ranks[src],
                                  line.group))
    if ops:
        for req in dist.batch_isend_irecv(ops):
            req.wait()
    return out


class _Psum(torch.autograd.Function):
    """Sum forward; the rank's own cotangent backward (JAX: psum's
    transpose is pvary)."""

    @staticmethod
    def forward(ctx, x, line):
        return _all_reduce(x, line)

    @staticmethod
    def backward(ctx, g):
        return g, None


class _Pvary(torch.autograd.Function):
    """Identity forward; the sum of the line's cotangents backward."""

    @staticmethod
    def forward(ctx, x, line):
        ctx.line = line
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return _all_reduce(g, ctx.line), None


class _AllGather(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, line, dim):
        ctx.line, ctx.dim = line, dim
        return _all_gather(x, line, dim)

    @staticmethod
    def backward(ctx, g):
        return _scatter_sum(g, ctx.line, ctx.dim), None, None


class _PsumScatter(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, line, dim):
        ctx.line, ctx.dim = line, dim
        return _scatter_sum(x, line, dim)

    @staticmethod
    def backward(ctx, g):
        return _all_gather(g, ctx.line, ctx.dim), None, None


class _Ppermute(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, line, pairs):
        ctx.line, ctx.pairs = line, pairs
        return _permute(x, line, pairs)

    @staticmethod
    def backward(ctx, g):
        inverse = [(d, s) for s, d in ctx.pairs]
        return _permute(g, ctx.line, inverse), None, None
