"""Analytic communication and compute model of the sharded ops
(counterpart of ``sputnik_tpu/parallel/comm_model.py``): host arithmetic.

It counts, per shard, the bytes the port's ``_mesh`` calls move, from the
same block metadata the kernels run (the halo slices' sizes, the psum
payloads' shapes), and projects a step's time across cards from a measured
one-card time and link rates. Collective costs follow ring algorithms, no
overlap unless asked:

  * ``psum`` of a ``payload``-byte buffer over ``n`` shards moves ``2 *
    payload * (n - 1) / n`` bytes through each shard's link (reduce-scatter
    + all-gather);
  * ``all_gather`` (and its reverse ``psum_scatter``) of ``local``-byte
    shards moves ``local * (n - 1)``;
  * a sliced ``ppermute`` shift moves its slice.

Where the port's counts differ from JAX's: payloads are at the operands'
own widths, as the port pads neither ``q`` nor ``hd`` to 128 lanes; the
ring carries ``m`` / ``l`` as ``[R, rows]`` vectors that never leave their
shard; and the halo SpMM's all_gather fallback counts, in its backward,
the gather of the dense operand that JAX leaves to XLA outside its count.

``H100`` holds NVIDIA's published datasheet figures of the H100 SXM5 80 GB
at 700 W (``NVIDIA H100 80GB HBM3, 700.00 W`` in ``nvidia-smi
--query-gpu=name,power.limit --format=csv,noheader``), not measurements.
The specs' exchanges are ``Mesh`` collectives over their axis: on the
one-device mesh they move nothing between cards, and on ranks (NCCL
between cards, gloo on the CPU) each is a blocking call between kernel
launches, so neither backend overlaps anything yet; the projections price
the same exchanges with the overlap their dataflow allows.
"""

from __future__ import annotations

import dataclasses

import numpy as np

__all__ = ["Chip", "H100", "psum_bytes", "all_gather_bytes",
           "spmm_comm_bytes", "spmm_halo_comm_bytes", "attention_comm_bytes",
           "attention_halo_comm_bytes", "attention_ring_comm_bytes",
           "project_scaling", "project_scaling_hier", "hier_halo_dcn_bytes",
           "hier_dp_grad_dcn_bytes", "nnz_balance", "OVERLAP_FRACTIONS"]


@dataclasses.dataclass(frozen=True)
class Chip:
    """A card's published rates. ``nvlink_oneway``: one direction of a
    GPU's NVLink (the in-host tier); ``ib_host_oneway``: one direction of a
    host's InfiniBand, shared by its ``gpus_per_host`` cards (the across-
    host tier)."""
    name: str
    bf16_flops: float           # dense tensor-core FLOP/s
    tf32_flops: float
    fp32_flops: float           # outside the tensor cores
    hbm_bw: float               # bytes/s
    nvlink_oneway: float        # bytes/s, one direction, per GPU
    ib_host_oneway: float       # bytes/s, one direction, per host
    gpus_per_host: int = 8


# NVIDIA H100 SXM5 80 GB datasheet (700 W): 989 / 495 TFLOP/s bf16 / TF32
# dense, 67 TFLOP/s fp32, 3.35 TB/s HBM3, NVLink 4 900 GB/s per GPU (450
# GB/s each way); a DGX H100 host: 8 GPUs, 8 x 400 Gb/s InfiniBand (400
# GB/s each way).
H100 = Chip(name="H100 SXM5 80GB (700 W), datasheet", bf16_flops=989e12,
            tf32_flops=495e12, fp32_flops=67e12, hbm_bw=3.35e12,
            nvlink_oneway=450e9, ib_host_oneway=400e9)


def psum_bytes(payload_bytes: float, ndev: int) -> float:
    """Per-shard bytes of one psum (ring reduce-scatter + all-gather)."""
    if ndev <= 1:
        return 0.0
    return 2.0 * payload_bytes * (ndev - 1) / ndev


def all_gather_bytes(local_bytes: float, ndev: int) -> float:
    """Per-shard bytes to all-gather (or psum-scatter) ``local``-byte
    shards."""
    if ndev <= 1:
        return 0.0
    return float(local_bytes) * (ndev - 1)


def spmm_comm_bytes(spec, q: int, *, itemsize: int = 4) -> dict:
    """``sharded_spmm`` (replicated dense operand): the forward moves
    nothing; the backward's ``A^T @ G`` partials psum to ``[n_pad, q]``."""
    ndev = spec.part.ndev
    payload = spec.n_pad * q * itemsize
    return {"fwd": 0.0, "bwd": psum_bytes(payload, ndev),
            "payload_shapes": {"bwd_psum": (spec.n_pad, q)}}


def spmm_halo_comm_bytes(spec, n_loc: int, q: int, *,
                         itemsize: int = 4) -> dict:
    """``sharded_spmm_halo`` (row-sharded dense operand): the forward moves
    the halo rows (``spec.halo_extents``) by sliced shifts and the backward
    the same slices back; a halo spanning the operand takes the
    ``all_gather`` forward, and in the backward the gather again plus the
    psum of ``A^T @ G``."""
    ndev = spec.part.ndev
    lo, hi = spec.halo_extents(n_loc)
    dense_fallback = lo + hi >= (ndev - 1) * n_loc
    if dense_fallback:
        fwd = all_gather_bytes(n_loc * q * itemsize, ndev)
        bwd = fwd + psum_bytes(spec.n_pad * q * itemsize, ndev)
    else:
        fwd = bwd = (lo + hi) * q * itemsize
    return {"fwd": float(fwd), "bwd": float(bwd), "halo_rows": (lo, hi),
            "dense_fallback": bool(dense_fallback)}


def attention_comm_bytes(spec, hd: int, *, kv_replicas: int = 1,
                         itemsize: int = 4) -> dict:
    """``sparse_attention_sharded`` and ``flash_attention_sharded`` (K / V
    replicated): the forward moves nothing; the backward psums dk and dv,
    ``[kv_replicas, n_pad, hd]`` each (GQA sums a group on its shard
    first, so ``kv_replicas = R // group``)."""
    ndev = spec.part.ndev
    payload = kv_replicas * spec.n_pad * hd * itemsize
    return {"fwd": 0.0, "bwd": 2.0 * psum_bytes(payload, ndev),
            "payload_shapes": {"dk_psum": (kv_replicas, spec.n_pad, hd),
                               "dv_psum": (kv_replicas, spec.n_pad, hd)}}


def attention_halo_comm_bytes(spec, hd: int, n_loc: int, *,
                              kv_replicas: int = 1,
                              itemsize: int = 4) -> dict:
    """``flash_attention_kv_sharded`` (K / V key-sharded): the forward moves
    K's and V's halo rows (``spec.halo_plan``), the backward their dk / dv
    back by the reverse shifts; constant in sequence length. Without a
    plan, the all_gather of K and V and, backward, the psum-scatter of
    their cotangents."""
    ndev = spec.part.ndev
    row_bytes = kv_replicas * hd * itemsize
    plan = spec.halo_plan(n_loc)
    if plan is None:
        fwd = 2.0 * all_gather_bytes(n_loc * row_bytes, ndev)
        return {"fwd": fwd, "bwd": fwd, "halo_rows": None,
                "dense_fallback": True}
    lo, hi = plan
    fwd = 2.0 * (lo + hi) * row_bytes
    return {"fwd": float(fwd), "bwd": float(fwd), "halo_rows": (lo, hi),
            "dense_fallback": False}


def attention_ring_comm_bytes(n_loc: int, hd: int, ndev: int, *,
                              kv_replicas: int = 1,
                              itemsize: int = 4) -> dict:
    """``ring_flash_attention``: the forward rotates the K and V bands
    ``ndev`` times; the backward rotates them again with the dk / dv
    accumulators riding home (twice the forward). No psum."""
    band = kv_replicas * n_loc * hd * itemsize
    fwd = 2.0 * ndev * band
    return {"fwd": float(fwd), "bwd": float(2.0 * fwd),
            "peak_kv_bytes_per_dev": 2.0 * band}


def project_scaling(t1_ms: float, comm_bytes_per_dev: float, ndev: int,
                    chip: Chip = H100, *, overlap_fraction: float = 0.0,
                    worst_device_factor: float = 1.0) -> dict:
    """One op's projected time on ``ndev`` cards of one host.

    ``t1_ms``: the measured one-card time of the whole problem; compute
    splits evenly, times ``worst_device_factor`` (``nnz_balance(part)
    ["max_over_mean"]``: the step waits for the slowest shard). The bytes
    move at one NVLink direction's rate. ``overlap_fraction`` ``f`` is the
    share of them whose transfer depends on no kernel of the step
    (``OVERLAP_FRACTIONS``): that part costs ``max(t_comp, f * t_comm)``,
    the rest ``(1 - f) * t_comm``; ``*_serial`` is the no-overlap floor.
    ``efficiency = t1 / (ndev * t)``."""
    if not 0.0 <= overlap_fraction <= 1.0:
        raise ValueError(f"overlap_fraction {overlap_fraction} not in "
                         "[0, 1]")
    if worst_device_factor < 1.0:
        raise ValueError(f"worst_device_factor {worst_device_factor} < 1")
    t_comp = t1_ms / ndev * worst_device_factor
    t_comm = comm_bytes_per_dev / chip.nvlink_oneway * 1e3
    t_serial = t_comp + t_comm
    t = (max(t_comp, overlap_fraction * t_comm)
         + (1.0 - overlap_fraction) * t_comm)
    return {"ndev": ndev, "t_ms": t, "t_ms_serial": t_serial,
            "t_compute_ms": t_comp, "t_comm_ms": t_comm,
            "overlap_fraction": overlap_fraction,
            "worst_device_factor": worst_device_factor,
            "efficiency": t1_ms / (ndev * t) if ndev else 1.0,
            "efficiency_serial":
                t1_ms / (ndev * t_serial) if ndev else 1.0,
            "comm_fraction": t_comm / t_serial if t_serial else 0.0,
            "comm_exposed_ms": t - t_comp}


# The share of each pass's bytes whose transfer depends on no kernel of the
# step, by dataflow (the splits are JAX's and the port's alike): the halo
# paths prefetch every halo row while the interior pass computes, and send
# the halo cotangents back while the interior backward runs; the ring's
# rotations read only the carry, but dk / dv board after their band's
# kernels (half the backward's bytes); a psum consumes kernel outputs. The
# port's collectives are blocking on either mesh backend: what it would
# take to reach these fractions is a stream of its own for the exchanges.
OVERLAP_FRACTIONS = {
    "spmm_halo_fwd": 1.0, "spmm_halo_bwd": 1.0,
    "attention_halo_fwd": 1.0, "attention_halo_bwd": 1.0,
    "ring_fwd": 1.0, "ring_bwd": 0.5,
    "psum_bwd": 0.0,
}


def project_scaling_hier(t1_ms: float, nvlink_bytes_per_dev: float,
                         ib_bytes_per_host: float, n_hosts: int,
                         chip: Chip = H100, *, gpus_per_host: int = 0,
                         overlap_nvlink: float = 0.0,
                         overlap_ib: float = 0.0) -> dict:
    """Two tiers (``n_hosts >= 2``): the fast-changing axis (the row
    partition) inside a host on NVLink, ``ib_bytes_per_host`` a step
    through each host's shared InfiniBand. Compute splits over every card;
    each tier hides under compute by its own overlap fraction, and the
    exposed remainders add (conservative: the fabrics are disjoint)."""
    gph = gpus_per_host or chip.gpus_per_host
    n_total = gph * n_hosts
    t_comp = t1_ms / n_total
    t_nvlink = nvlink_bytes_per_dev / chip.nvlink_oneway * 1e3
    t_ib = ib_bytes_per_host / chip.ib_host_oneway * 1e3
    t_serial = t_comp + t_nvlink + t_ib

    def exposed(tx, f):
        return max(max(t_comp, f * tx) + (1.0 - f) * tx - t_comp, 0.0)

    t = t_comp + exposed(t_nvlink, overlap_nvlink) + exposed(t_ib,
                                                             overlap_ib)
    return {"n_hosts": n_hosts, "gpus_per_host": gph, "ndev": n_total,
            "t_ms": t, "t_ms_serial": t_serial, "t_compute_ms": t_comp,
            "t_nvlink_ms": t_nvlink, "t_ib_ms": t_ib,
            "efficiency": t1_ms / (n_total * t) if t else 1.0,
            "efficiency_serial":
                t1_ms / (n_total * t_serial) if t_serial else 1.0,
            "ib_fraction": t_ib / t_serial if t_serial else 0.0}


def hier_halo_dcn_bytes(halo_rows: tuple, q: int, n_hosts: int, *,
                        itemsize: int = 4) -> float:
    """Per-host across-host (InfiniBand; JAX's DCN tier) bytes of a
    contiguous row / key partition spanning hosts: only the shards at a
    host boundary send their halo across, one boundary for a host of a
    two-host line, two for an inner host of a longer one."""
    if n_hosts <= 1:
        return 0.0
    lo, hi = halo_rows
    boundaries = 2 if n_hosts > 2 else 1
    return float((lo + hi) * q * itemsize * boundaries)


def hier_dp_grad_dcn_bytes(n_params: int, n_hosts: int, *,
                           itemsize: int = 4) -> float:
    """Per-host across-host bytes of data parallelism over hosts: one ring
    all-reduce of the gradient a step."""
    return psum_bytes(float(n_params) * itemsize, n_hosts)


def nnz_balance(part) -> dict:
    """Per-shard nonzeros of a ``RowPartition`` and their max / mean."""
    counts = np.array([s.nnz for s in part.shards], np.int64)
    return {"per_device": counts.tolist(),
            "max_over_mean": float(counts.max() / max(counts.mean(), 1.0))}
