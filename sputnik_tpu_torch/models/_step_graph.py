"""One decode step a token as a CUDA graph replay (the port's counterpart of
the JAX package's jitted decode scan).

``StepRunner`` drives ``step(x, caches) -> (out, caches)`` once a token. On
a CUDA device the first call runs the step eagerly, on a side stream (a
real step, and the warm-up a capture needs); the second captures the step
as a CUDA graph and replays it; every later call copies its input into the
graph's static input and replays. CPU tensors run every step eagerly.

What the graph relies on:
  * the step reads its inputs and caches at the addresses captured, and
    writes the caches' buffers in place. An append returns a FRESH
    ``kv_len`` (the one passed in is never written), so the graph ends by
    copying each layer's new lengths into the captured caches' ``kv_len``:
    the next replay then reads the advanced position;
  * nothing replaces a cache tensor between replays: no host scheduler
    step (``reserve``, ``release``, ``share_prefix``, ``insert_kv_slot``)
    runs inside the loop, so a paged cache holds every page it needs
    before the first call;
  * the step never syncs the host. A capture that fails raises: there is
    no fallback to eager steps.

Each call captures into the caller's own caches (allocated outside the
graphs' memory pool), so a later capture into the same pool never writes
caches that an earlier call returned.
"""

from __future__ import annotations

import contextlib
from typing import Callable, Sequence

import torch

__all__ = ["GraphPool", "StepRunner"]


class GraphPool:
    """What one owner's step graphs share, one capture after another: the
    side stream of every warm-up and capture (so that what a stream sets
    up lazily on its first step, cuBLAS's workspace, is set up by the
    eager warm-up, outside any capture) and the CUDA graph memory pool.
    PyTorch lets a capture join a pool only while a graph that holds it is
    alive, so the latest graph is kept until the next capture has begun;
    an earlier graph is never replayed again, so the next capture may
    reuse its memory. A failed capture leaves its pool marked as
    recording, so the pool is dropped for a new one."""

    def __init__(self):
        self.stream = None
        self.handle = None
        self.graph = None

    def side(self, dev: torch.device):
        if self.stream is None:
            self.stream = torch.cuda.Stream(dev)
        return self.stream

    def begin(self):
        if self.handle is None:
            self.handle = torch.cuda.graph_pool_handle()
        return self.handle


class StepRunner:
    """Runs ``step(x, caches) -> (out, new_caches)`` one call a token.

    ``caches``: the starting caches (a sequence of cache dataclasses with a
    ``kv_len`` tensor); ``pool``: the owner's ``GraphPool``. ``runner(x)``
    returns the step's output; under a graph that is the graph's static
    output, overwritten by the next call, so read or copy it first.
    ``runner.caches`` holds the current caches. ``graph=False`` runs every
    step eagerly on CUDA tensors too (the tensor-parallel servers, whose
    graph is later work)."""

    def __init__(self, step: Callable, caches: Sequence, pool: GraphPool,
                 graph: bool = True):
        self.step = step
        self.caches = tuple(caches)
        self.pool = pool
        self.use_graph = graph
        self.calls = 0
        self.graph = None
        self._x = self._out = None

    def __call__(self, x):
        self.calls += 1
        if not (x.is_cuda and self.use_graph):
            out, self.caches = self.step(x, self.caches)
            return out
        if self.calls == 1:
            return self._warm_up(x)
        if self.graph is None:
            self._capture(x)
        else:
            self._x.copy_(x)
        self.graph.replay()
        return self._out

    def _warm_up(self, x):
        """The first step, eagerly, on the side stream."""
        main = torch.cuda.current_stream(x.device)
        side = self.pool.side(x.device)
        side.wait_stream(main)
        with torch.cuda.stream(side):
            out, self.caches = self.step(x, self.caches)
        main.wait_stream(side)
        return out

    def _capture(self, x):
        """Capture the step on ``self.caches``, ending with the new lengths
        copied into the captured caches' ``kv_len``. Runs nothing."""
        dev = x.device
        self._x = x.clone()
        graph = torch.cuda.CUDAGraph()
        main = torch.cuda.current_stream(dev)
        side = self.pool.side(dev)
        side.wait_stream(main)
        with torch.cuda.stream(side):
            graph.capture_begin(pool=self.pool.begin())
            try:
                out, new = self.step(self._x, self.caches)
                for c, n in zip(self.caches, new):
                    c.kv_len.copy_(n.kv_len)
            except BaseException:
                with contextlib.suppress(Exception):
                    graph.capture_end()
                self.pool.handle = None
                raise
            graph.capture_end()
        main.wait_stream(side)
        self.pool.graph = self.graph = graph
        self._out = out
