"""The PyTorch port's communication model and its sequence-parallel dry run,
on the CPU.

  * ``halo_rows``, ``dense_fallback`` and ``nnz_balance`` equal the JAX
    package's at the same tiles, and ``payload_shapes`` equal JAX's where
    the widths are whole 128-lane multiples (elsewhere the port's are the
    operands' own widths, JAX's padded);
  * ``project_scaling`` and ``project_scaling_hier`` equal JAX's at the
    same link rates; ``H100`` holds the datasheet's figures;
  * every byte count equals the bytes the ``Mesh`` collectives move in a
    CPU run of that path, forward and backward apart (the one-device
    mesh's methods counted by a monkeypatch): the halo SpMM's three
    branches, the replicated-operand
    SpMM and attention chain, flash attention replicated and in the
    kv-sharded branches, and the ring;
  * ``dryrun_sp`` at 6 shards: every path's gradient finite and both halos
    on the ragged exchange (``dense_fallback`` false).
"""

import dataclasses

import jax
import numpy as np
import pytest
import torch
from jax.sharding import Mesh

import sputnik_tpu as st
import sputnik_tpu_torch as stt
from sputnik_tpu.parallel import RowPartition as JRowPartition
from sputnik_tpu.parallel import comm_model as jcm
from sputnik_tpu.parallel import flash_sharded as jfsh
from sputnik_tpu.parallel import sharded_ops as jso
from sputnik_tpu_torch.dryrun import dryrun_sp
from sputnik_tpu_torch.parallel import _mesh
from sputnik_tpu_torch.parallel import comm_model as cm
from sputnik_tpu_torch.patterns import causal_topology, local_window_topology

P = stt.parallel
BM, BK = 8, 128


@pytest.fixture(autouse=True)
def _one_thread():
    """One intra-op thread: these tests run many small products, and under
    the suite's parallel workers more threads a worker oversubscribe the
    cores (each test took up to 100x its time alone)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _topos(mask):
    return (st.SparseTopology.from_dense_mask(mask),
            stt.SparseTopology.from_dense_mask(mask))


def _window(s, w):
    i, j = np.arange(s)[:, None], np.arange(s)[None, :]
    return (np.abs(i - j) < w).astype(np.float32)


@pytest.mark.parametrize("mask,balance", [(_window(1024, 96), False),
                                          (np.tril(np.ones((320, 320))),
                                           False),
                                          (np.tril(np.ones((320, 320))),
                                           True)])
def test_halo_rows_fallback_balance_and_payloads_equal_jax(mask, balance):
    ndev = 8
    jt, t = _topos(mask.astype(np.float32))
    jpart = JRowPartition(jt, ndev, bm=BM, balance=balance)
    part = P.RowPartition(t, ndev, bm=BM, balance=balance)
    assert cm.nnz_balance(part) == jcm.nnz_balance(jpart)
    mesh = Mesh(np.array(jax.devices()[:ndev]), ("x",))
    jspec = jso.ShardedPanelSpec(jpart, bm=BM, bk=BK, mesh=mesh, axis="x")
    spec = P.ShardedPanelSpec(part, bm=BM, bk=BK)
    jfspec = jfsh.ShardedFlashSpec(jpart, bm=BM, bk=BK, mesh=mesh,
                                   axis="x")
    fspec = P.ShardedFlashSpec(part, bm=BM, bk=BK)
    n_loc = spec.n_pad // ndev
    for q in (128, 40):
        got = cm.spmm_halo_comm_bytes(spec, n_loc, q)
        want = jcm.spmm_halo_comm_bytes(jspec, n_loc, q)
        for key in ("halo_rows", "dense_fallback"):
            assert got[key] == want[key], key
        got = cm.attention_halo_comm_bytes(fspec, q, n_loc, kv_replicas=2)
        want = jcm.attention_halo_comm_bytes(jfspec, q, n_loc,
                                             kv_replicas=2)
        for key in ("halo_rows", "dense_fallback"):
            assert got[key] == want[key], key
        got = cm.attention_comm_bytes(spec, q, kv_replicas=2)
        want = jcm.attention_comm_bytes(jspec, q, kv_replicas=2)
        assert got["payload_shapes"] == (want["payload_shapes"] if q == 128
                                         else {k: (2, spec.n_pad, q) for k in
                                               ("dk_psum", "dv_psum")})
        got = cm.spmm_comm_bytes(spec, q)["payload_shapes"]["bwd_psum"]
        assert got == (spec.n_pad, q)
        if q == 128:
            assert got == jcm.spmm_comm_bytes(jspec, q)["payload_shapes"][
                "bwd_psum"]


def test_projections_equal_jax_at_the_same_rates():
    chip = jcm.Chip(name="same", bf16_flops=cm.H100.bf16_flops,
                    hbm_bw=cm.H100.hbm_bw, ici_oneway=cm.H100.nvlink_oneway,
                    dcn_host_oneway=cm.H100.ib_host_oneway, chips_per_host=8)
    for f, w in ((0.0, 1.0), (1.0, 1.87), (0.5, 1.2)):
        assert (cm.project_scaling(3.0, 2e8, 8, overlap_fraction=f,
                                   worst_device_factor=w)
                == jcm.project_scaling(3.0, 2e8, 8, chip,
                                       overlap_fraction=f,
                                       worst_device_factor=w))
    got = cm.project_scaling_hier(3.0, 1e8, 5e8, 2, overlap_nvlink=1.0,
                                  overlap_ib=0.5)
    want = jcm.project_scaling_hier(3.0, 1e8, 5e8, 2, chip, overlap_ici=1.0,
                                    overlap_dcn=0.5)
    renames = {"t_nvlink_ms": "t_ici_ms", "t_ib_ms": "t_dcn_ms",
               "ib_fraction": "dcn_fraction", "gpus_per_host":
               "chips_per_host"}
    assert {renames.get(k, k): v for k, v in got.items()} == want
    assert cm.OVERLAP_FRACTIONS == jcm.OVERLAP_FRACTIONS
    for n in (1, 2, 3):
        assert cm.hier_halo_dcn_bytes((64, 32), 48, n) == \
            jcm.hier_halo_dcn_bytes((64, 32), 48, n)
        assert cm.hier_dp_grad_dcn_bytes(1000, n) == \
            jcm.hier_dp_grad_dcn_bytes(1000, n)
    h = dataclasses.asdict(cm.H100)
    assert (h["hbm_bw"], h["nvlink_oneway"], h["ib_host_oneway"],
            h["fp32_flops"], h["gpus_per_host"]) == (3.35e12, 450e9, 400e9,
                                                     67e12, 8)


@pytest.fixture
def moved(monkeypatch):
    """Per-shard bytes through the ``Mesh`` collectives by the model's
    conventions (every shard sends one equal slice a shift)."""
    box = [0.0]

    def nb(x):
        return x.numel() * x.element_size()

    def wrap(name, count):
        real = getattr(_mesh.Mesh, name)

        def counted(self, xs, *a, **k):
            box[0] += count(list(xs))
            return real(self, xs, *a, **k)
        monkeypatch.setattr(_mesh.Mesh, name, counted)

    wrap("ppermute", lambda xs: nb(xs[0]))
    wrap("all_gather", lambda xs: cm.all_gather_bytes(nb(xs[0]), len(xs)))
    wrap("psum", lambda xs: cm.psum_bytes(nb(xs[0]), len(xs)))
    wrap("psum_scatter",
         lambda xs: cm.all_gather_bytes(nb(xs[0]) / len(xs), len(xs)))
    return box


def _fwd_bwd(box, fn, *xs):
    ts = [torch.from_numpy(x).requires_grad_() for x in xs]
    box[0] = 0.0
    out = fn(*ts)
    fwd, box[0] = box[0], 0.0
    out.square().sum().backward()
    return fwd, box[0]


def _rand(*shape, seed=0):
    return np.random.RandomState(seed).randn(*shape).astype(np.float32)


@pytest.mark.parametrize("case", ["split", "ragged", "gathered"])
def test_spmm_bytes_equal_the_mesh_calls(case, moved):
    ndev, q = 4, 24
    s = {"split": 1024, "ragged": 1000, "gathered": 512}[case]
    topo = (causal_topology(s) if case == "gathered"
            else local_window_topology(s, 80))
    spec = P.ShardedPanelSpec(P.RowPartition(topo, ndev, balance=False))
    n_loc = s // ndev
    panels = spec.stack_values(_rand(topo.nnz_pad))
    want = cm.spmm_halo_comm_bytes(spec, n_loc, q)
    assert want["dense_fallback"] == (case == "gathered")
    assert _fwd_bwd(moved, lambda p, d: P.sharded_spmm_halo(spec, p, d),
                    panels, _rand(ndev, n_loc, q)) == (want["fwd"],
                                                       want["bwd"])
    want = cm.spmm_comm_bytes(spec, q)
    assert _fwd_bwd(moved, lambda p, d: P.sharded_spmm(spec, p, d), panels,
                    _rand(s, q)) == (want["fwd"], want["bwd"])
    want = cm.attention_comm_bytes(spec, q)
    assert _fwd_bwd(moved, lambda a, b, c: P.sparse_attention_sharded(
        spec, a, b, c), _rand(ndev, n_loc, q), _rand(s, q, seed=1),
        _rand(s, q, seed=2)) == (want["fwd"], want["bwd"])


@pytest.mark.parametrize("branch", ["replicated", "overlap", "monolithic",
                                    "gathered"])
def test_attention_bytes_equal_the_mesh_calls(branch, moved):
    ndev, s, R, group, hd = 4, 512, 4, 2, 24
    topo = (causal_topology(s) if branch in ("replicated", "gathered")
            else local_window_topology(s, 80))
    spec = P.ShardedFlashSpec(P.RowPartition(topo, ndev, balance=False))
    n_loc = s // ndev
    q = _rand(ndev, R, n_loc, hd)
    if branch == "replicated":
        want = cm.attention_comm_bytes(spec, hd, kv_replicas=R // group)
        got = _fwd_bwd(moved, lambda a, b, c: P.flash_attention_sharded(
            spec, a, b, c, group=group), q, _rand(R // group, s, hd),
            _rand(R // group, s, hd))
    else:
        want = cm.attention_halo_comm_bytes(spec, hd, n_loc,
                                            kv_replicas=R // group)
        assert want["dense_fallback"] == (branch == "gathered")
        got = _fwd_bwd(moved, lambda a, b, c: P.flash_attention_kv_sharded(
            spec, a, b, c, group=group, overlap=branch == "overlap"), q,
            _rand(ndev, R // group, n_loc, hd, seed=1),
            _rand(ndev, R // group, n_loc, hd, seed=2))
    assert got == (want["fwd"], want["bwd"])


def test_ring_bytes_equal_the_mesh_calls(moved):
    ndev, s, R, hd = 4, 512, 2, 24
    spec = P.RingFlashSpec(P.RowPartition(causal_topology(s), ndev,
                                          zigzag=True))
    want = cm.attention_ring_comm_bytes(spec.n_loc, hd, ndev, kv_replicas=R)
    got = _fwd_bwd(moved, lambda a, b, c: P.ring_flash_attention(
        spec, a, b, c), _rand(ndev, R, s // ndev, hd),
        _rand(ndev, R, spec.n_loc, hd, seed=1),
        _rand(ndev, R, spec.n_loc, hd, seed=2))
    assert got == (want["fwd"], want["bwd"])


def test_dryrun_sp_at_six_shards_takes_both_halos():
    got = dryrun_sp(6, "cpu")
    comm = got["comm"]
    assert comm["n_devices"] == 6
    for key in ("spmm_halo", "attention_kv_halo"):
        assert comm[key]["dense_fallback"] is False, key
        assert comm[key]["halo_rows"] == (64, 64), key
    assert set(got["losses"]) == {
        "attention", "attention_flash", "attention_kv_halo", "spmm_halo",
        "attention_ring", "attention_compressed"}
    assert all(np.isfinite(v) and v > 0 for v in got["losses"].values())
    assert comm["nnz_balance"]["max_over_mean"] == 1.0      # zigzag
    assert comm["nnz_balance_contiguous"]["max_over_mean"] > 1.5
