"""Host structures of the PyTorch port equal the JAX package's exactly.

Same masks through ``sputnik_tpu`` and ``sputnik_tpu_torch``: CSR arrays,
transposes, block views, stacked block metadata, many-mask topologies and
the flash metadata must agree bit for bit at the same tiles.
"""

import numpy as np
import pytest

import sputnik_tpu_torch as stt
from sputnik_tpu import many_mask as jmm
from sputnik_tpu.blocking import stack_block_meta as j_stack_block_meta
from sputnik_tpu.ops.pallas.flash_sparse import (
    build_flash_meta as j_flash_meta)
from sputnik_tpu.topology import SparseTopology as JTopology
from sputnik_tpu_torch.ops.kernels.flash_sparse import build_flash_meta


def _masks(kind):
    """Two [m, n] masks of one kind, made from a numpy seed."""
    rng = np.random.RandomState(7)
    if kind == "random":
        return (rng.rand(2, 64, 64) < 0.2).astype(np.float32)
    if kind == "causal_empty_row":
        m = np.tril(np.ones((48, 48), np.float32))
        m[24] = 0.0
        return np.stack([m, m * (rng.rand(48, 48) < 0.6)])
    if kind == "empty_column":
        m = (rng.rand(2, 64, 64) < 0.3).astype(np.float32)
        m[:, :, 5] = 0.0
        m[:, :, 32:48] = 0.0     # a whole empty column block at 16 wide
        return m
    if kind == "non_tile_multiple":
        return (rng.rand(2, 50, 70) < 0.25).astype(np.float32)
    raise ValueError(kind)


KINDS = ["random", "causal_empty_row", "empty_column", "non_tile_multiple"]
TILES = [(16, 16), (32, 8)]


def _eq(a, b, what):
    np.testing.assert_array_equal(np.asarray(a), np.asarray(b), err_msg=what)


@pytest.mark.parametrize("kind", KINDS)
def test_topology_and_transpose_match(kind):
    for mask in _masks(kind):
        t = stt.SparseTopology.from_dense_mask(mask)
        j = JTopology.from_dense_mask(mask)
        for f in ("row_offsets", "column_indices", "row_ids", "row_swizzle",
                  "valid"):
            _eq(getattr(t, f), getattr(j, f), f)
        assert (t.m, t.n, t.nnz, t.nnz_pad) == (j.m, j.n, j.nnz, j.nnz_pad)
        (tt, perm), (jt, jperm) = t.transpose(), j.transpose()
        _eq(perm, jperm, "perm")
        for f in ("row_offsets", "column_indices", "row_ids"):
            _eq(getattr(tt, f), getattr(jt, f), f"transpose {f}")
        assert tt.transpose()[0] is t


@pytest.mark.parametrize("tiles", TILES)
@pytest.mark.parametrize("kind", KINDS)
def test_block_view_matches(kind, tiles):
    bm, bk = tiles
    for mask in _masks(kind):
        bv = stt.SparseTopology.from_dense_mask(mask).block(bm, bk)
        jv = JTopology.from_dense_mask(mask).block(bm, bk)
        for f in ("bm", "bk", "mb", "kb", "max_bpr", "num_blocks"):
            assert getattr(bv, f) == getattr(jv, f), f
        for f in ("block_cols", "block_valid", "nblocks", "scatter_idx",
                  "gather_idx", "mask"):
            _eq(getattr(bv, f), getattr(jv, f), f)
        for a, b in zip(bv.transpose_meta(), jv.transpose_meta()):
            _eq(a, b, "transpose_meta")


@pytest.mark.parametrize("lane", [128, 8])
@pytest.mark.parametrize("kind", KINDS)
def test_ell_view_and_row_lengths_match(kind, lane):
    for mask in _masks(kind):
        t = stt.SparseTopology.from_dense_mask(mask)
        j = JTopology.from_dense_mask(mask)
        _eq(t.row_lengths, j.row_lengths, "row_lengths")
        assert t.row_lengths.dtype == j.row_lengths.dtype
        ev, jv = t.ell(lane=lane), j.ell(lane=lane)
        assert isinstance(ev, stt.EllView) and t.ell(lane=lane) is ev
        assert (ev.m, ev.l_pad, ev.values_shape, ev.dump) == (
            jv.m, jv.l_pad, jv.values_shape, jv.dump)
        for f in ("scatter_idx", "gather_idx", "cols", "mask"):
            _eq(getattr(ev, f), getattr(jv, f), f"ell {f}")
            assert getattr(ev, f).dtype == getattr(jv, f).dtype


@pytest.mark.parametrize("tiles", TILES)
@pytest.mark.parametrize("kind", KINDS)
def test_stacked_and_flash_meta_match(kind, tiles):
    bm, bk = tiles
    masks = _masks(kind)
    views = [stt.SparseTopology.from_dense_mask(m).block(bm, bk)
             for m in masks]
    jviews = [JTopology.from_dense_mask(m).block(bm, bk) for m in masks]
    for got, ref in ((stt.stack_block_meta(views), j_stack_block_meta(jviews)),
                     (build_flash_meta(views), j_flash_meta(jviews))):
        assert got.keys() == ref.keys()
        for key in ref:
            _eq(got[key], ref[key], key)


@pytest.mark.parametrize("kind", KINDS)
def test_many_mask_topology_matches(kind):
    masks = _masks(kind)
    mt = stt.ManyMaskTopology.from_dense_masks(masks)
    jt = jmm.ManyMaskTopology.from_dense_masks(masks)
    assert (mt.b, mt.m, mt.n, mt.nnz_pad) == (jt.b, jt.m, jt.n, jt.nnz_pad)
    for f in ("nnzs", "column_indices", "row_ids", "valid", "row_offsets",
              "row_swizzle"):
        _eq(getattr(mt, f), getattr(jt, f), f)
    (mt_t, perm), (jt_t, jperm) = mt.transpose(), jt.transpose()
    _eq(perm, jperm, "perm")
    _eq(mt_t.column_indices, jt_t.column_indices, "transpose columns")
    assert mt_t.transpose()[0] is mt


@pytest.mark.parametrize("name,args,kwargs", [
    ("uniform_mask", (40, 56), dict(sparsity=0.8, seed=3)),
    ("sparsify_uniform", (np.ones((12, 20), np.float32), 0.5),
     dict(round_to=4, seed=1)),
    ("causal_mask", (24,), dict(band=5)),
    ("local_window_mask", (30, 4), {}),
    ("random_mask_batch", (3, 16, 24), dict(seed=2)),
    ("block_random_mask", (50, 70, 16, 8), dict(density=0.3, seed=4)),
    ("block_random_mask", (50, 70, 16, 8),
     dict(density=0.3, seed=4, balanced=False)),
    ("causal_topology", (33,), dict(band=7)),
    ("local_window_topology", (33, 5), {}),
    ("block_random_topology", (40, 48, 8, 16), dict(density=0.25, seed=5)),
    ("init_uniform", ((6, 7),), dict(low=-2.0, high=3.0, seed=8)),
    ("init_range", ((3, 5),), {}),
])
def test_pattern_generators_match(name, args, kwargs):
    from sputnik_tpu import patterns as jp
    from sputnik_tpu_torch import patterns as tp

    got = getattr(tp, name)(*args, **kwargs)
    ref = getattr(jp, name)(*args, **kwargs)
    if isinstance(ref, np.ndarray):
        _eq(got, ref, name)
    else:
        for f in ("row_offsets", "column_indices", "row_ids"):
            _eq(getattr(got, f), getattr(ref, f), f"{name} {f}")


def test_driver_masks_match_the_graft_entry():
    import __graft_entry__ as ge

    _eq(stt.patterns.driver_masks(3, 40), ge._causal_masks(3, 40),
        "causal masks with an empty row")


def test_flash_meta_dedups_partial_tiles():
    """A causal mask repeats one partial (diagonal) tile: one stored tile."""
    s, bm = 128, 16
    views = [stt.SparseTopology.from_dense_mask(
        np.tril(np.ones((s, s), np.float32))).block(bm, bm)]
    meta = build_flash_meta(views)
    assert meta["pmask"].shape == (1, 1, bm, bm)
    assert meta["is_partial"].sum() == s // bm
