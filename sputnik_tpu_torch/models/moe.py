"""Sparse Mixture-of-Experts (counterpart of ``sputnik_tpu/models/moe.py``).

A top-1 / top-2 routed MoE layer whose expert FFN weights are CSR-sparse
with a SHARED topology and per-expert values, so the whole expert bank runs
as ONE batched panel SpMM per projection: experts are the replica axis of
``ops/batched_panel`` over one topology (``BatchedPanelSpec([topo],
heads=E)``), kernel B6 forward, B7 + B8 in the backward.

Routing follows the JAX package: the router is a bias-free linear layer,
the routing math stays int32 / f32, capacity ``C = max(ceil(T / E * top_k
* capacity_factor), 1)``, second choices queue behind every first choice
(GShard's location offset), and the aux loss is ``E * sum(frac * mean_p)``.
Dispatch and combine are dense einsums onto ``[tokens, E, C]``. The
dispatch one-hot is built by comparison (``pos == arange(C)``), which gives
a zero row for an unrouted (-1) or over-capacity (>= C) position as
``jax.nn.one_hot`` does (``torch.nn.functional.one_hot`` would raise).

Expert parallelism (``mesh=``, ``axis="ep"``; JAX's ``shard_map`` at
``moe.py:268-283``): position ``i`` of the ``ep`` axis computes experts
``[i * E_loc, (i + 1) * E_loc)`` (``E_loc = E / n``) from its slice of
``dispatch`` / ``combine`` (``[T, E_loc, C]``, one ``spmm_bh`` a projection
on a ``BatchedPanelSpec`` of ``heads=E_loc``), and one ``Mesh.psum`` over
the axis adds the positions' outputs. The router, the routing and
everything outside the bank are replicated; the input and ``combine``
enter the per-position work through ``Mesh.pvary``, so on a rank their
gradients (and the router's) are the sum of the ranks' shares, equal on
every rank. On a one-device mesh the module holds all ``E`` experts in the
unsharded module's parameters, sliced a position, so its ``state_dict``
is the unsharded one's; on a rank it holds only its ``[E_loc, ...]``
values (initialised as the unsharded module's slice for the same
generator).

The aux loss of the last forward is ``self.aux_loss`` (flax sows it into
``intermediates``), and its routing is ``self.last_experts`` /
``self.last_probs``. Not ported: the JAX package's bf16 operand streaming,
which it turns on only on a TPU.
"""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from ..ops import panel_api as PA
from ..ops.batched_panel import BatchedPanelSpec, spmm_bh
from .transformer import _linear

__all__ = ["SparseMoE"]


class SparseMoE(nn.Module):
    """Top-1 / top-2 MoE with CSR-sparse expert FFNs.

    Args:
      topo_in: ``SparseTopology [ffn, hidden]`` of every expert's first
        projection (shared pattern, per-expert values).
      topo_out: ``SparseTopology [hidden, ffn]`` of the second projection.
      num_experts: expert count ``E``.
      top_k: experts per token, 1 or 2 (the two gates renormalised).
      capacity_factor: per-expert capacity multiplier; tokens past an
        expert's capacity get no contribution from it.
      activation: ``"gelu"`` (tanh form), ``"relu"`` or ``None``.
      bank_tiles: ``(bm, bk)`` of the expert bank's panels; ``None`` is the
        port's 64 x 64 (``panel_api.DEFAULT_BLOCK``).
      mesh / axis: expert parallelism over ``axis`` of a ``parallel.Mesh``
        (``E`` divisible by its size); ``experts`` is then the range of
        global expert indices this process holds (all ``E`` but on a rank).
      generator, device: initialisation (router LeCun-normal like flax
        ``nn.Dense``, expert values Kaiming-uniform over the nonzeros) and
        placement.
    """

    def __init__(self, topo_in, topo_out, num_experts: int, top_k: int = 1,
                 capacity_factor: float = 1.25,
                 activation: Optional[str] = "gelu",
                 bank_tiles: Optional[Tuple[int, int]] = None, mesh=None,
                 axis: str = "ep", *,
                 generator: Optional[torch.Generator] = None, device=None):
        super().__init__()
        self.mesh, self.axis = mesh, axis
        self.n_local, self.experts = num_experts, range(num_experts)
        if mesh is not None:
            from ..parallel._mesh import Mesh

            if not isinstance(mesh, Mesh):
                raise ValueError(f"SparseMoE(mesh=) takes a parallel.Mesh, "
                                 f"got {type(mesh).__name__}")
            self.experts = mesh.held(axis, num_experts)
            self.n_local = num_experts // mesh.shape[axis]
        h, f = topo_in.n, topo_in.m
        if topo_out.m != h or topo_out.n != f:
            raise ValueError(f"topo_out must be [{h}, {f}], got "
                             f"[{topo_out.m}, {topo_out.n}]")
        if top_k not in (1, 2):
            raise ValueError(f"top_k must be 1 or 2, got {top_k}")
        if activation not in (None, "gelu", "relu"):
            raise ValueError(f"unknown activation {activation}")
        self.num_experts, self.top_k = num_experts, top_k
        self.capacity_factor, self.activation = capacity_factor, activation
        bm, bk = bank_tiles or PA.DEFAULT_BLOCK
        self.set_topology("in", topo_in, bm, bk)
        self.set_topology("out", topo_out, bm, bk)
        self.router = _linear(h, num_experts, generator, device, bias=False)

        def bank(topo):
            # every expert drawn, then this process's kept: the same values
            # as the unsharded module's for the same generator
            full = [PA.panel_kaiming_values(topo, bm, bk, generator=generator)
                    for _ in range(num_experts)]
            return nn.Parameter(torch.stack(
                full[self.experts.start:self.experts.stop]).to(device))

        self.w_in_values = bank(topo_in)
        self.w_out_values = bank(topo_out)
        self.aux_loss = None
        self.last_experts = self.last_probs = None

    def _act(self, y):
        if self.activation == "gelu":
            return F.gelu(y, approximate="tanh")
        if self.activation == "relu":
            return F.relu(y)
        return y

    def forward(self, x):
        """``x [..., hidden] -> [..., hidden]``."""
        h = self.topo_in.n
        if x.shape[-1] != h:
            raise ValueError(f"input features {x.shape[-1]} != {h}")
        E = self.num_experts
        lead = x.shape[:-1]
        xf = x.reshape(-1, h)
        T = xf.shape[0]
        C = max(int(np.ceil(T / E * self.top_k * self.capacity_factor)), 1)

        # router; the routing math stays int32 / f32
        probs = torch.softmax(self.router(xf), dim=-1)          # [T, E]
        gate1, expert1 = probs.max(dim=-1)                      # first max
        oh1 = F.one_hot(expert1, E).to(torch.int32)             # [T, E]
        frac = oh1.to(probs.dtype).mean(dim=0)
        self.aux_loss = E * torch.sum(frac * probs.mean(dim=0))
        slots = torch.arange(C, device=x.device, dtype=torch.int32)

        def one_hot_slots(pos):
            """``[T, E]`` positions -> ``[T, E, C]``; -1 and >= C give 0."""
            return (pos[..., None] == slots).to(xf.dtype)

        def running_count(oh):
            """Each expert's tokens so far, ``[T, E]`` int32; the scan runs
            along the last (contiguous) axis of an ``[E, T]`` copy."""
            return torch.cumsum(oh.T.contiguous(), dim=1,
                                dtype=torch.int32).T

        pos1 = running_count(oh1) * oh1 - 1
        if self.top_k == 1:
            dispatch = one_hot_slots(pos1)
            combine = dispatch * gate1[:, None, None]
            experts = expert1[:, None]
        else:
            probs2 = probs * (1 - oh1.to(probs.dtype))
            gate2, expert2 = probs2.max(dim=-1)
            oh2 = F.one_hot(expert2, E).to(torch.int32)
            denom = torch.clamp(gate1 + gate2, min=1e-9)
            g1n, g2n = gate1 / denom, gate2 / denom
            # GShard location offset: second choices queue behind ALL of an
            # expert's first choices, so overflow sheds them first
            cnt1 = oh1.sum(dim=0, dtype=torch.int32)
            pos2 = (running_count(oh2) + cnt1[None, :]) * oh2 - 1
            disp1, disp2 = one_hot_slots(pos1), one_hot_slots(pos2)
            dispatch = disp1 + disp2
            combine = disp1 * g1n[:, None, None] + disp2 * g2n[:, None, None]
            experts = torch.stack([expert1, expert2], dim=-1)
        self.last_experts = experts.detach()
        self.last_probs = probs.detach()

        if self.mesh is None:
            out = self._bank(dispatch, combine, xf, self.w_in_values,
                             self.w_out_values)
        else:
            # each position's experts from its slice of the routing; the
            # replicated input and gates enter, the outputs add over the axis
            mesh, ax, n = self.mesh, self.axis, self.n_local
            k = len(mesh.positions)
            parts = []
            for i, xp, cp in zip(mesh.index(ax), mesh.pvary([xf] * k, ax),
                                 mesh.pvary([combine] * k, ax)):
                e = slice(i * n, (i + 1) * n)
                v = slice(e.start - self.experts.start,
                          e.stop - self.experts.start)
                parts.append(self._bank(dispatch[:, e], cp[:, e], xp,
                                        self.w_in_values[v],
                                        self.w_out_values[v]))
            out = mesh.psum(parts, ax)[0]
        return out.reshape(*lead, h)

    def set_topology(self, which: str, topo, bm: int, bk: int) -> None:
        """``topo_{which}`` and its specs at ``(bm, bk)`` tiles:
        ``spec_{which}`` over all ``E`` experts, ``local_{which}`` over one
        position's ``n_local`` (the same spec without a mesh). The values
        are left as they are (a RigL update re-tiles them)."""
        spec = BatchedPanelSpec([topo], heads=self.num_experts, bm=bm, bk=bk)
        local = (spec if self.n_local == self.num_experts else
                 BatchedPanelSpec([topo], heads=self.n_local, bm=bm, bk=bk))
        setattr(self, f"topo_{which}", topo)
        setattr(self, f"spec_{which}", spec)
        setattr(self, f"local_{which}", local)

    def _bank(self, dispatch, combine, xf, v_in, v_out):
        """The expert bank: one batched panel SpMM per projection over the
        experts of ``dispatch`` / ``combine`` ``[T, E', C]``."""
        xin = torch.einsum("tec,th->ehc", dispatch, xf)          # [E', h, C]
        y1 = spmm_bh(self.local_in, v_in, xin)                   # [E', f, C]
        y2 = spmm_bh(self.local_out, v_out, self._act(y1))       # [E', h, C]
        return torch.einsum("tec,ehc->th", combine, y2)          # [T, h]

    # -- value-layout boundary helpers -------------------------------------

    def _topo_spec(self, which: str):
        if which not in ("in", "out"):
            raise ValueError(f"which must be 'in' or 'out', got {which!r}")
        return ((self.topo_in, self.spec_in) if which == "in"
                else (self.topo_out, self.spec_out))

    def flat_values(self, panels, which: str = "in") -> np.ndarray:
        """Panel-layout expert values ``[E, *panel]`` -> flat CSR
        ``[E, nnz_pad]`` (host boundary)."""
        topo, spec = self._topo_spec(which)
        panels = (panels.detach().cpu().numpy()
                  if isinstance(panels, torch.Tensor) else np.asarray(panels))
        return np.stack([PA.panel_to_values_np(topo, p, spec.bm, spec.bk)
                         for p in panels])

    def panel_values(self, flat, which: str = "in") -> np.ndarray:
        """Inverse of :meth:`flat_values`."""
        topo, spec = self._topo_spec(which)
        return np.stack([PA.values_to_panel_np(topo, np.asarray(v), spec.bm,
                                               spec.bk) for v in flat])

    def extra_repr(self) -> str:
        return (f"experts={self.num_experts}, top_k={self.top_k}, "
                f"capacity_factor={self.capacity_factor}, "
                f"activation={self.activation}, "
                f"tiles={self.spec_in.bm}x{self.spec_in.bk}")

