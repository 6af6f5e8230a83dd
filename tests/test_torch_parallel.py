"""The row partition and the halo SpMM of the PyTorch port against the JAX
package, on the CPU.

  * ``RowPartition`` (natural, balanced, zigzag): the permutation, the
    shards' CSR arrays, the stacked block metadata and panels equal JAX's,
    and the panels round-trip to each shard's CSR values;
  * ``ShardedPanelSpec``'s metadata, ``halo_extents`` and the interior /
    halo split of the walk (``_ov_split_meta``) equal JAX's;
  * B2's plain version against JAX's Pallas kernel in interpret mode, and
    the interior plus halo passes against B1 over the same shard;
  * ``sharded_spmm_halo`` forward and both gradients against JAX's on a
    CPU mesh, in its three branches (the split, the ragged exchange, the
    all_gather), with the port's ``q``-wide (not 128-padded) output;
  * the specs' ``ValueError``s.

The JAX tests' small shapes (``tests/test_parallel.py``): bm 8, bk 128.
Tolerances: atol 1e-4 on outputs and 1e-2 on gradients (f32 on both
sides, sums in another order).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import Mesh

import sputnik_tpu as st
import sputnik_tpu_torch as stt
from sputnik_tpu.ops.pallas import bsr_spmm as jspmm
from sputnik_tpu.parallel import RowPartition as JRowPartition
from sputnik_tpu.parallel import sharded_ops as jso
from sputnik_tpu_torch.ops.kernels import bsr_spmm as kspmm
from sputnik_tpu_torch.parallel import (RowPartition, ShardedPanelSpec,
                                        sharded_spmm_halo)
from sputnik_tpu_torch.parallel import sharded_ops as so

BM, BK = 8, 128
META = ("block_cols", "nblocks", "mask", "t_src_i", "t_src_s", "t_nblocks")


def _banded(rng, n, w=32):
    A = np.zeros((n, n), np.float32)
    for i in range(n):
        j0, j1 = max(0, i - w), min(n, i + w + 1)
        A[i, j0:j1] = rng.randn(j1 - j0)
    return A


# (name, ndev, matrix, balance): the split (n_loc = 128 = bk), the ragged
# exchange (n_loc = 64 < bk) and the all_gather (a random mask, balanced)
CASES = {
    "split": (4, lambda rng: _banded(rng, 512), False),
    "ragged": (8, lambda rng: _banded(rng, 512), False),
    "gathered": (8, lambda rng: ((rng.rand(320, 256) < 0.3)
                                 * rng.randn(320, 256)).astype(np.float32),
                 True),
}


def _problem(case):
    ndev, make, balance = CASES[case]
    rng = np.random.RandomState(21)
    A = make(rng)
    mat = st.SparseMatrix(A)
    topo = stt.SparseTopology(A.shape[0], A.shape[1],
                              mat.topology.row_offsets,
                              mat.topology.column_indices)
    jpart = JRowPartition(mat.topology, ndev, balance=balance, bm=BM)
    part = RowPartition(topo, ndev, balance=balance, bm=BM)
    return A, mat, jpart, part, rng


@pytest.mark.parametrize("kind", ["natural", "balanced", "zigzag"])
def test_row_partition_equals_jax(kind):
    rng = np.random.RandomState(1)
    mask = np.zeros((200, 256), np.float32)
    for r in range(200):                     # skewed row lengths
        mask[r, : (r % 64) * 4] = 1.0
    vals = (mask * rng.randn(*mask.shape)).astype(np.float16)
    mat = st.SparseMatrix(vals.astype(np.float32))
    kw = dict(balance=kind == "balanced", zigzag=kind == "zigzag", bm=BM)
    jpart = JRowPartition(mat.topology, 4, **kw)
    part = RowPartition(stt.SparseTopology.from_dense_mask(mask), 4, **kw)
    assert (part.m_loc, part.nnz_pad, part.zigzag) == (
        jpart.m_loc, jpart.nnz_pad, jpart.zigzag)
    np.testing.assert_array_equal(part.perm, jpart.perm)
    np.testing.assert_array_equal(part.inv_perm, jpart.inv_perm)
    for s, js in zip(part.shards, jpart.shards):
        assert (s.m, s.n, s.nnz, s.nnz_pad) == (js.m, js.n, js.nnz,
                                                js.nnz_pad)
        np.testing.assert_array_equal(s.row_offsets, js.row_offsets)
        np.testing.assert_array_equal(s.column_indices, js.column_indices)
    got, jgot = part.stacked_block_meta(BM, BK), jpart.stacked_block_meta(
        BM, BK)
    for a, b in zip(got[:3], jgot[:3]):
        np.testing.assert_array_equal(a, b)
    values = mat.values.astype(np.float16)           # dtype-preserving
    panels = part.stacked_panel(values, BM, BK)
    assert panels.dtype == np.float16
    np.testing.assert_array_equal(panels, jpart.stacked_panel(values, BM,
                                                              BK))
    ro = mat.topology.row_offsets
    for d, s in enumerate(part.shards):     # round trip to shard values
        rows = part.perm[d * part.m_loc: (d + 1) * part.m_loc]
        want = np.concatenate([values[ro[r]: ro[r + 1]] for r in rows
                               if r < 200] or [np.zeros(0, np.float16)])
        own = panels[d][:, : s.block(BM, BK).max_bpr]   # the shard's view
        back = stt.ops.panel_api.panel_to_values_np(s, own, BM, BK)
        np.testing.assert_array_equal(back[: len(want)], want)
    out = rng.randn(len(part.perm), 3).astype(np.float32)
    np.testing.assert_array_equal(
        part.unpermute_rows(torch.from_numpy(out)).numpy(),
        np.asarray(jpart.unpermute_rows(jnp.asarray(out))))


@pytest.mark.parametrize("case", list(CASES))
def test_sharded_spec_and_split_equal_jax(case):
    A, mat, jpart, part, _ = _problem(case)
    jspec = jso.ShardedPanelSpec(jpart, bm=BM, bk=BK)
    spec = ShardedPanelSpec(part, bm=BM, bk=BK)
    for attr in ("mb", "kb", "m_pad_loc", "n_pad", "max_bpr", "max_bpc",
                 "panel_shape"):
        assert getattr(spec, attr) == getattr(jspec, attr), attr
    for key in META:
        np.testing.assert_array_equal(getattr(spec, key),
                                      getattr(jspec, key), err_msg=key)
    np.testing.assert_array_equal(spec.stack_values(mat.values),
                                  jspec.stack_values(mat.values))
    n_loc = A.shape[1] // part.ndev
    for n in (n_loc, 2 * n_loc):
        assert spec.halo_extents(n) == jspec.halo_extents(n)
        assert so._halo_plan(spec, n) == jso._halo_plan(jspec, n)
    if n_loc % BK == 0:
        got, want = so._ov_split_meta(spec, n_loc), jso._ov_split_meta(
            jspec, n_loc)
        for p in ("i", "h"):
            assert got[p]["maxb"] == want[p]["maxb"]
            for k in ("cols", "sel", "nblk"):
                np.testing.assert_array_equal(got[p][k], want[p][k])


def test_spmm_sel_plain_matches_pallas_and_sums_to_b1():
    """B2 on one shard's interior and halo sub-walks: each pass against
    JAX's Pallas kernel (interpret), and interior + halo == B1."""
    A, mat, jpart, part, rng = _problem("split")
    spec = ShardedPanelSpec(part, bm=BM, bk=BK)
    n_loc = A.shape[1] // part.ndev
    split = so._ov_split_meta(spec, n_loc)
    panels = spec.stack_values(mat.values)
    dense = rng.randn(A.shape[1], 128).astype(np.float32)
    for d in range(part.ndev):
        halo_in = np.zeros_like(dense)
        mine = slice(d * n_loc, (d + 1) * n_loc)
        halo_in[: spec.n_pad] = dense
        halo_in[mine] = 0.0                        # halo-only buffer
        outs = []
        for p, src in (("i", dense[mine]), ("h", halo_in)):
            sm = split[p]
            args = [torch.from_numpy(sm[k][d]) for k in ("cols", "nblk",
                                                         "sel")]
            got = kspmm.bsr_spmm_panel_sel(*args, torch.from_numpy(
                panels[d]), torch.from_numpy(src))
            want = jspmm.bsr_spmm_panel_sel(
                *(jnp.asarray(sm[k][d]) for k in ("cols", "nblk", "sel")),
                jnp.asarray(panels[d]), jnp.asarray(src), mb=spec.mb,
                max_bpr=sm["maxb"], bm=BM, bk=BK, bn=128, interpret=True)
            np.testing.assert_allclose(got.numpy(), np.asarray(want),
                                       atol=1e-4)
            outs.append(got)
        meta = spec.meta("cpu")
        b1 = kspmm.bsr_spmm_panel(meta["block_cols"][d], meta["nblocks"][d],
                                  torch.from_numpy(panels[d])[None],
                                  torch.from_numpy(dense)[None],
                                  rows=spec.m_pad_loc)[0]
        np.testing.assert_allclose((outs[0] + outs[1]).numpy(), b1.numpy(),
                                   atol=1e-4)


@pytest.mark.parametrize("case", list(CASES))
def test_sharded_spmm_halo_matches_jax(case):
    A, mat, jpart, part, rng = _problem(case)
    ndev = part.ndev
    mesh = Mesh(np.array(jax.devices()[:ndev]), ("x",))
    jspec = jso.ShardedPanelSpec(jpart, bm=BM, bk=BK, mesh=mesh, axis="x")
    spec = ShardedPanelSpec(part, bm=BM, bk=BK)
    n, q = A.shape[1], 40
    n_loc = n // ndev
    plan = so._halo_plan(spec, n_loc)
    branch = ("gathered" if plan is None
              else "split" if n_loc % BK == 0 else "ragged")
    assert branch == case
    panels = spec.stack_values(mat.values)
    dense = rng.randn(ndev, n_loc, q).astype(np.float32)

    def jloss(p, d):
        return jnp.sum(jso.sharded_spmm_halo(jspec, p, d) ** 2)

    jout = jax.jit(lambda p, d: jso.sharded_spmm_halo(jspec, p, d))(
        jnp.asarray(panels), jnp.asarray(dense))
    jgp, jgd = jax.jit(jax.grad(jloss, argnums=(0, 1)))(
        jnp.asarray(panels), jnp.asarray(dense))

    tp = torch.from_numpy(panels).requires_grad_()
    td = torch.from_numpy(dense).requires_grad_()
    launches = kspmm.bsr_spmm_panel_sel.launches
    out = sharded_spmm_halo(spec, tp, td)
    assert out.shape == (ndev, spec.m_pad_loc, q)      # q, not q_pad
    assert jout.shape[-1] == 128
    np.testing.assert_allclose(out.detach().numpy(),
                               np.asarray(jout)[..., :q], atol=1e-4)
    got = part.unpermute_rows(out.detach().reshape(-1, q))
    np.testing.assert_allclose(got.numpy(), A @ dense.reshape(n, q),
                               atol=1e-3)
    out.square().sum().backward()
    np.testing.assert_allclose(td.grad.numpy(), np.asarray(jgd), atol=1e-2)
    np.testing.assert_allclose(tp.grad.numpy(), np.asarray(jgp), atol=1e-2)
    assert kspmm.bsr_spmm_panel_sel.launches == launches   # CPU: plain


def test_sharded_validation():
    A, mat, jpart, part, _ = _problem("ragged")
    # the shards are a mesh axis's positions: JAX's mesh= / axis=
    with pytest.raises(ValueError, match="partition has"):
        ShardedPanelSpec(part, bm=BM, bk=BK, mesh=stt.parallel.Mesh(
            {"x": part.ndev + 1}))
    with pytest.raises(ValueError, match="no axis 'x'"):
        ShardedPanelSpec(part, bm=BM, bk=BK, mesh=stt.parallel.Mesh(
            {"sp": part.ndev}))
    spec = ShardedPanelSpec(part, bm=BM, bk=BK)
    panels = torch.from_numpy(spec.stack_values(mat.values))
    with pytest.raises(ValueError, match="panels"):
        sharded_spmm_halo(spec, panels[1:], torch.zeros(8, 64, 4))
    with pytest.raises(ValueError, match="n_loc"):
        sharded_spmm_halo(spec, panels, torch.zeros(8, 65, 4))
    with pytest.raises(ValueError, match="n_loc"):
        sharded_spmm_halo(spec, panels, torch.zeros(4, 64, 4))
