"""Pipeline parallelism (counterpart of ``sputnik_tpu/parallel/pipeline.py``):
GPipe microbatch pipelining over a ``Mesh`` axis.

The schedule is JAX's: stage parameters are stacked along a leading
``ndev`` axis (position ``d`` of the ``pp`` axis runs stage ``d``); the
schedule takes ``T = n_micro + ndev - 1`` steps over the microbatches and
``ndev - 1`` zero microbatches that drain the pipe; at every step position 0
takes the next feed, every other position the carry it received, every
position applies its stage (fill and drain included, so the bubble is
``(ndev - 1) / T``) and the results move one hop right on a ring
(``Mesh.ppermute``). Microbatch ``j`` leaves the last stage at step ``j +
ndev - 1``. One backward spans the whole pipeline: ``ppermute``'s backward
sends the cotangents one hop left.

The work is written once over this process's positions (every position of
a one-device mesh, one on a rank). ``x`` and the output follow JAX's global
view on both backends: ``x`` is the whole batch, replicated (it enters by
``Mesh.pvary``, so its gradient is the first stage's, on every rank), and
the output reaches every rank by a ``Mesh.psum`` of the last position's
window (zeros elsewhere), whose backward hands the last position the
cotangent once. Position 0 keeps the carry it discards in the graph with a
zero cotangent (``torch.where``), so that every rank runs every
``ppermute``'s backward in the same order; the last step's shift is not
sent, as nothing reads it.

A stage function is ``stage_fn(stage_params, x_micro) -> y_micro`` with
``y_micro.shape == x_micro.shape``, e.g. ``torch.func.functional_call(layer,
stage_params, (x,))`` on a ``TransformerLayer``: PyTorch's form of JAX's
``layer.apply({"params": p}, x)``.
"""

from __future__ import annotations

from typing import Mapping, Optional

import torch

from ._mesh import Mesh

__all__ = ["PipelineSpec", "pipeline_apply", "stack_stage_params"]


class PipelineSpec:
    """The pipeline's mesh axis and microbatch count (``n_micro`` defaults
    to the axis size, as in JAX)."""

    def __init__(self, mesh: Mesh, axis: str = "pp",
                 n_micro: Optional[int] = None):
        if not isinstance(mesh, Mesh):
            raise ValueError(f"a PipelineSpec runs on a parallel.Mesh, got "
                             f"{type(mesh).__name__}")
        mesh._axis(axis)
        self.mesh, self.axis = mesh, axis
        self.ndev = mesh.shape[axis]
        self.n_micro = int(n_micro or self.ndev)
        if self.n_micro < 1:
            raise ValueError(f"n_micro must be >= 1, got {n_micro}")


def _tree_map(fn, *trees):
    """``fn`` over the leaves of nested mappings of the same keys."""
    if isinstance(trees[0], Mapping):
        return {k: _tree_map(fn, *(t[k] for t in trees)) for k in trees[0]}
    return fn(*trees)


def _leaves(tree):
    if isinstance(tree, Mapping):
        for v in tree.values():
            yield from _leaves(v)
    else:
        yield tree


def stack_stage_params(per_stage_params):
    """Per-stage parameter dicts of one structure (``state_dict()``s, or
    nested dicts of tensors) -> one dict whose every leaf has a leading
    ``n_stage`` axis. On a rank pass only its own stage, to get its
    ``[1, ...]`` slice."""
    per_stage_params = list(per_stage_params)
    if not per_stage_params:
        raise ValueError("no stages to stack")
    return _tree_map(lambda *xs: torch.stack(xs), *per_stage_params)


def pipeline_apply(spec: PipelineSpec, stage_fn, stacked_params, x):
    """Run ``x`` through the ``ndev`` pipelined stages.

    Args:
      spec: ``PipelineSpec`` (mesh, axis, n_micro).
      stage_fn: ``(stage_params, x_micro) -> y_micro``, shape-preserving.
      stacked_params: a dict (nested dicts allowed) of tensors with a
        leading stage axis: ``[ndev, ...]`` (stage ``d`` at index ``d``) on
        a one-device mesh; ``[1, ...]``, this rank's stage alone, on a rank,
        which holds and differentiates only its own stage.
      x: ``[batch, ...]``, the whole batch (on a rank too), ``batch``
        divisible by ``n_micro``.

    Returns the ``[batch, ...]`` outputs, microbatches re-assembled, on
    every rank.
    """
    mesh, ax = spec.mesh, spec.axis
    ndev, n_micro = spec.ndev, spec.n_micro
    b = x.shape[0]
    if b % n_micro:
        raise ValueError(f"batch {b} not divisible by n_micro {n_micro}")
    mb = b // n_micro
    held = mesh.held(ax, ndev)
    who = "this rank" if mesh.distributed else "every stage"
    for leaf in _leaves(stacked_params):
        if leaf.shape[:1] != (len(held),):
            raise ValueError(
                f"stacked stage parameters need a leading axis of "
                f"{len(held)} ({who}), got {tuple(leaf.shape)}")
    idx = mesh.index(ax)
    params = [_tree_map(lambda a: a[i - held.start], stacked_params)
              for i in idx]
    first = [torch.tensor(i == 0, device=x.device) for i in idx]
    last = [torch.tensor(i == ndev - 1, device=x.device) for i in idx]
    feeds = [f.reshape(n_micro, mb, *x.shape[1:])
             for f in mesh.pvary([x] * len(idx), ax)]
    drain = x.new_zeros((mb,) + tuple(x.shape[1:]))
    ring = [(d, (d + 1) % ndev) for d in range(ndev)]
    carry = [drain] * len(idx)
    window = [[] for _ in idx]
    T = n_micro + ndev - 1
    for t in range(T):
        ys = [stage_fn(p, torch.where(f0, feed[t] if t < n_micro else drain,
                                      c))
              for p, f0, feed, c in zip(params, first, feeds, carry)]
        if t >= ndev - 1:
            for w, y in zip(window, ys):
                w.append(y)
        if t < T - 1:
            carry = mesh.ppermute(ys, ax, ring)
    mine = [torch.where(at_end, torch.stack(w), 0.0)
            for at_end, w in zip(last, window)]
    out = mesh.psum(mine, ax)[0]
    return out.reshape(b, *x.shape[1:])
