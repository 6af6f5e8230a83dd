"""The compressed (true-BSR) panel layout of the PyTorch port against the JAX
package, on the CPU.

  * host arrays: ``build_compressed`` and ``transpose_meta`` equal JAX's
    field by field, exactly;
  * the five compressed kernels' plain versions against JAX's Pallas
    kernels in interpret mode, on the same metadata;
  * the ops (``spmm``, ``spmm_bias``, ``spmm_bias_relu``, ``spmm_t``,
    ``sddmm``, ``sparse_softmax``) on ``PanelSpec(compressed=True)`` against
    JAX's under ``set_backend("xla")`` and ``("pallas")`` (interpret), and
    the chain's gradients against ``jax.grad``;
  * JAX's own compressed tests (``tests/test_panel_ops.py``) as parity
    cases, with the dump tile and the masked slots exactly 0 in every
    output and gradient.

Both packages get the same ``(bm, bk)`` here, so their compressed panels
have the same layout. Tolerances: outputs atol = rtol = 1e-4 (f32 on both
sides, sums in another order); chain gradients 1e-3 x max|ref|.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import sputnik_tpu as st
import sputnik_tpu_torch as stt
from sputnik_tpu.blocking import build_compressed as j_build_compressed
from sputnik_tpu.ops import panel_api as JP
from sputnik_tpu.ops.pallas import bsr_compressed as jc
from sputnik_tpu_torch.ops import panel_api as P
from sputnik_tpu_torch.ops.kernels import bsr_compressed as kc

TOL = dict(atol=1e-4, rtol=1e-4)
TILES = [(16, 16), (32, 32)]


@pytest.fixture(params=["xla", "pallas"])
def backend(request):
    st.set_backend(request.param)
    try:
        yield request.param
    finally:
        st.set_backend("auto")


def _banded(rng, m, n=None, width=32):
    """A block-diagonal band of ``width``-wide blocks (``n`` columns)."""
    n = m if n is None else n
    A = np.zeros((m, n), np.float32)
    for i in range(m):
        j0 = (i // width) * width % n
        A[i, j0: j0 + width] = rng.randn(min(width, n - j0))
    return A


def _skewed(rng, m=160, n=192):
    """``tests/test_sharded_compressed.py``'s pattern at a small size: a
    32-wide band plus dense rows 7, 140 and m - 3."""
    A = np.zeros((m, n), np.float32)
    for r in range(m):
        lo = max(0, (r * n // m) - 16)
        A[r, lo: lo + 32] = 1.0
    A[7] = A[140] = A[m - 3] = 1.0
    return (A * rng.randn(m, n)).astype(np.float32)


def _matrix(kind):
    rng = np.random.RandomState({"skewed": 1, "uniform": 2, "empty_row": 3,
                                 "all_zero": 4}[kind])
    if kind == "skewed":
        return _skewed(rng)
    if kind == "uniform":                       # one tile per row-block
        return _banded(rng, 128)
    if kind == "empty_row":
        A = _banded(rng, 96, 80, width=16)
        A[5] = rng.randn(80)
        A[9] = 0.0
        A[33:50] = 0.0                          # an empty row-block at 16
        return A
    return np.zeros((64, 48), np.float32)


KINDS = ["skewed", "uniform", "empty_row", "all_zero"]
# each topology at one tile for the kernels and ops (both tiles occur)
OP_CASES = [("skewed", (16, 16)), ("uniform", (32, 32)),
            ("empty_row", (16, 16)), ("all_zero", (32, 32))]


def _pair(A):
    return st.SparseMatrix(A), stt.SparseMatrix(A)


@pytest.mark.parametrize("tiles", TILES)
@pytest.mark.parametrize("kind", KINDS)
def test_build_compressed_equals_jax(kind, tiles):
    jm, tm = _pair(_matrix(kind))
    bm, bk = tiles
    jv = j_build_compressed(jm.topology, bm=bm, bk=bk)
    tv = stt.build_compressed(tm.topology, bm=bm, bk=bk)
    for f in ("bm", "bk", "mb", "kb", "num_blocks", "max_bpr", "m_pad",
              "n_pad", "values_shape", "dump"):
        assert getattr(tv, f) == getattr(jv, f), f
    for f in ("block_offsets", "block_cols", "block_rows", "scatter_idx",
              "gather_idx", "mask"):
        a, b = getattr(tv, f), getattr(jv, f)
        assert a.dtype == b.dtype, f
        np.testing.assert_array_equal(a, b, err_msg=f)
    for a, b in zip(tv.transpose_meta(), jv.transpose_meta()):
        assert a.dtype == b.dtype
        np.testing.assert_array_equal(a, b)
    assert tv.transpose_meta() is tv.transpose_meta()    # built once
    # the view is built once per topology and tile, in its block cache
    spec = P.PanelSpec(tm.topology, bm, bk, compressed=True)
    assert spec.view is P.PanelSpec(tm.topology, bm, bk,
                                    compressed=True).view
    assert tm.topology._block_cache[("compressed", bm, bk)] is spec.view
    assert "_compressed_view" not in vars(tm.topology.block(bm, bk))


def test_panel_spec_equality_tells_the_layouts_apart():
    t = stt.SparseTopology.from_dense_mask(_banded(np.random.RandomState(0),
                                                   64) != 0)
    e, c = P.PanelSpec(t, 16, 16), P.PanelSpec(t, 16, 16, compressed=True)
    assert e != c and hash(e) != hash(c)
    assert c == P.PanelSpec(t, 16, 16, compressed=True)
    assert hash(c) == hash(P.PanelSpec(t, 16, 16, compressed=True))
    assert e == P.PanelSpec(t, 16, 16) and len({e, c, P.PanelSpec(t, 16,
                                                                   16)}) == 2
    assert c.view.values_shape == (c.view.num_blocks + 1, 16, 16)
    meta = c.meta("cpu")
    assert set(meta) == {"block_offsets", "block_cols", "block_rows", "mask",
                         "t_gblk", "t_rows", "t_nblocks", "split_plans"}
    assert all(v.dtype == torch.int32 for k, v in meta.items()
               if k not in ("mask", "split_plans"))
    assert isinstance(meta["split_plans"], kc.SplitPlans)
    assert meta["mask"].dtype == torch.float32
    assert tuple(meta["mask"].shape) == c.view.values_shape


# -- the plain versions of the five kernels against JAX's Pallas kernels


def _kernel_problem(kind, tiles, seed=0):
    jm, tm = _pair(_matrix(kind))
    bm, bk = tiles
    jv = j_build_compressed(jm.topology, bm=bm, bk=bk)
    spec = P.PanelSpec(tm.topology, bm, bk, compressed=True)
    panel = P.values_to_panel_np(tm.topology, tm.values, bm, bk,
                                 compressed=True)
    return jm, tm, jv, spec, spec.meta("cpu"), panel, np.random.RandomState(
        seed)


@pytest.mark.parametrize("kind,tiles", OP_CASES)
@pytest.mark.parametrize("epilogue", ["none", "bias", "bias_relu"])
def test_plain_spmm_c_matches_pallas_kernel(kind, tiles, epilogue):
    jm, tm, jv, spec, meta, panel, rng = _kernel_problem(kind, tiles)
    n_out = 20
    dense = np.zeros((jv.n_pad, 128), np.float32)
    dense[: tm.topology.n, :n_out] = rng.randn(tm.topology.n, n_out)
    bias = rng.randn(jv.m_pad).astype(np.float32)
    ref = np.asarray(jc.bsr_spmm_panel_c(
        jv.block_offsets, jv.block_cols, panel, dense, bias[:, None],
        mb=jv.mb, max_bpr=jv.max_bpr, num_blocks=jv.num_blocks, bm=jv.bm,
        bk=jv.bk, bn=128, epilogue=epilogue, interpret=True))
    got = kc.bsr_spmm_panel_c(
        meta["block_offsets"], meta["block_cols"],
        torch.from_numpy(panel)[None], torch.from_numpy(dense)[None],
        None if epilogue == "none" else torch.from_numpy(bias),
        rows=jv.m_pad, epilogue=epilogue)[0]
    np.testing.assert_allclose(got.numpy(), ref, **TOL)
    empty = np.flatnonzero(np.diff(jv.block_offsets) == 0)
    for i in empty:                 # a row-block without tiles: 0 (+ bias)
        rows = got[i * jv.bm:(i + 1) * jv.bm]
        want = torch.zeros_like(rows) if epilogue == "none" else (
            torch.from_numpy(bias[i * jv.bm:(i + 1) * jv.bm])[:, None]
            .expand_as(rows))
        if epilogue == "bias_relu":
            want = want.clamp(min=0)
        assert torch.equal(rows, want)


# -- B13a's split walk: the host plan and its algebra


@pytest.mark.parametrize("chunk", [1, 2, 3, 7, 10_000])
@pytest.mark.parametrize("tiles", TILES)
@pytest.mark.parametrize("kind", KINDS)
def test_split_plan_covers_every_tile_once(kind, tiles, chunk):
    """Every real tile in exactly one chunk, in order; never the dump tile;
    no chunk crosses a row-block or holds more than ``chunk`` tiles; an
    empty row-block keeps one empty chunk; the cut row-blocks own their
    partial slots back to back, in chunk order."""
    _, tm = _pair(_matrix(kind))
    bv = stt.build_compressed(tm.topology, bm=tiles[0], bk=tiles[1])
    plan = kc.split_plan(bv.block_offsets, chunk)
    row, first, count, part = plan["chunks"].T
    offs = bv.block_offsets
    assert plan["chunks"].dtype == np.int32
    tiles_walked = np.concatenate(
        [np.arange(f, f + c) for f, c in zip(first, count)] + [[]])
    np.testing.assert_array_equal(tiles_walked, np.arange(bv.num_blocks))
    assert bv.values_shape[0] - 1 not in tiles_walked     # the dump tile
    assert np.all((first >= offs[row]) & (first + count <= offs[row + 1]))
    assert np.all((count <= chunk) & (count >= 0))
    np.testing.assert_array_equal(np.unique(row), np.arange(bv.mb))
    assert np.all(np.diff(row) >= 0)
    n = np.bincount(row, minlength=bv.mb)
    assert np.all(count[n[row] == 1] == np.diff(offs)[row[n[row] == 1]])
    np.testing.assert_array_equal(plan["split_rows"], np.flatnonzero(n > 1))
    assert np.all(part[n[row] == 1] == -1)
    np.testing.assert_array_equal(part[n[row] > 1],
                                  np.arange(plan["n_parts"]))
    np.testing.assert_array_equal(plan["split_parts"],
                                  np.concatenate([[0], np.cumsum(n[n > 1])]))
    if chunk >= bv.num_blocks:                  # no cut: today's walk
        assert plan["n_parts"] == 0 and len(row) == bv.mb


def test_split_chunk_cuts_only_a_short_grid():
    """The chunk rule on the skewed 4096^2 pattern of ``chip_smoke.py``
    (375 tiles of 64 x 64): at widths 1 and 64 the walk is cut into 2-tile
    chunks, more blocks than row-blocks; at width 4096 (64 column tiles x
    64 row-blocks fill the card) every row-block is one chunk."""
    rows = np.arange(4096)
    lo = np.maximum(0, rows - 16)
    mask = (rows[None] >= lo[:, None]) & (rows[None] < lo[:, None] + 32)
    mask[[7, 140, 4093]] = True
    spec = P.PanelSpec(stt.SparseTopology.from_dense_mask(mask), 64, 64,
                       compressed=True)
    bv, plans = spec.view, spec.meta("cpu")["split_plans"]
    assert bv.num_blocks == 375
    for width in (1, 64):
        chunk = kc.split_chunk(bv.num_blocks, bv.mb, 1, width, 64)
        assert chunk == 2
        assert plans[chunk]["chunks"].shape[0] > bv.mb
    chunk = kc.split_chunk(bv.num_blocks, bv.mb, 1, 4096, 64)
    assert chunk == bv.num_blocks
    plan = plans[chunk]
    assert plan["n_parts"] == 0 and plan["chunks"].shape[0] == bv.mb
    assert plans[chunk] is plan                    # built once per chunk
    assert torch.equal(plan["chunks"][:, 2],
                       torch.from_numpy(np.diff(bv.block_offsets)).int())


def _split_spmm_emulated(meta, panel, dense, bias, plan, *, bm, rows,
                         epilogue):
    """B13a's two passes through the plain version: the chunks as virtual
    row-blocks (pass 1, no epilogue), then each row-block the sum of its
    chunks' partials in chunk order, with the epilogue once."""
    chunks = plan["chunks"]
    n_tiles = meta["block_cols"].numel() - 1
    offs = torch.cat([torch.from_numpy(chunks[:, 1]),
                      torch.tensor([n_tiles], dtype=torch.int32)])
    part = kc.bsr_spmm_panel_c_plain(offs, meta["block_cols"], panel, dense,
                                     rows=len(chunks) * bm)
    R, N = part.shape[0], part.shape[-1]
    mb = meta["block_offsets"].numel() - 1
    out = part.new_zeros((R, mb, bm, N))
    for c, row in enumerate(chunks[:, 0]):
        out[:, row] += part[:, c * bm:(c + 1) * bm]
    out = out.reshape(R, mb * bm, N)[:, :rows]
    if epilogue != "none":
        out = out + bias[:rows, None]
    return out.clamp(min=0) if epilogue == "bias_relu" else out


@pytest.mark.parametrize("chunk", [1, 2, 5])
@pytest.mark.parametrize("kind,tiles", OP_CASES)
@pytest.mark.parametrize("epilogue", ["none", "bias", "bias_relu"])
def test_split_spmm_c_algebra_matches_plain_and_pallas(kind, tiles, chunk,
                                                       epilogue):
    """Split + merge, emulated through the plain version, equals the unsplit
    plain version and JAX's ``bsr_spmm_panel_c`` in interpret mode; an
    empty row-block gives exactly 0 (+ bias)."""
    jm, tm, jv, spec, meta, panel, rng = _kernel_problem(kind, tiles)
    dense = np.zeros((jv.n_pad, 128), np.float32)
    dense[: tm.topology.n, :20] = rng.randn(tm.topology.n, 20)
    bias = rng.randn(jv.m_pad).astype(np.float32)
    ref = np.asarray(jc.bsr_spmm_panel_c(
        jv.block_offsets, jv.block_cols, panel, dense, bias[:, None],
        mb=jv.mb, max_bpr=jv.max_bpr, num_blocks=jv.num_blocks, bm=jv.bm,
        bk=jv.bk, bn=128, epilogue=epilogue, interpret=True))
    t_panel, t_dense = (torch.from_numpy(panel)[None],
                        torch.from_numpy(dense)[None])
    t_bias = torch.from_numpy(bias)
    got = _split_spmm_emulated(
        meta, t_panel, t_dense, t_bias, kc.split_plan(jv.block_offsets,
                                                      chunk),
        bm=jv.bm, rows=jv.m_pad, epilogue=epilogue)[0]
    whole = kc.bsr_spmm_panel_c(
        meta["block_offsets"], meta["block_cols"], t_panel, t_dense,
        None if epilogue == "none" else t_bias, rows=jv.m_pad,
        epilogue=epilogue, plans=meta["split_plans"])[0]
    np.testing.assert_allclose(got.numpy(), whole.numpy(), **TOL)
    np.testing.assert_allclose(got.numpy(), ref, **TOL)
    for i in np.flatnonzero(np.diff(jv.block_offsets) == 0):
        rows = got[i * jv.bm:(i + 1) * jv.bm]
        want = torch.zeros_like(rows) if epilogue == "none" else (
            t_bias[i * jv.bm:(i + 1) * jv.bm, None].expand_as(rows))
        if epilogue == "bias_relu":
            want = want.clamp(min=0)
        assert torch.equal(rows, want)


@pytest.mark.parametrize("kind,tiles", OP_CASES)
def test_plain_spmm_t_c_matches_pallas_kernel(kind, tiles):
    jm, tm, jv, spec, meta, panel, rng = _kernel_problem(kind, tiles)
    t_nblocks, t_src = jv.transpose_meta()
    g = np.zeros((jv.m_pad, 128), np.float32)
    g[: tm.topology.m, :20] = rng.randn(tm.topology.m, 20)
    ref = np.asarray(jc.bsr_spmm_t_panel_c(
        t_src[:, :, 0].reshape(-1), t_src[:, :, 1].reshape(-1), t_nblocks,
        panel, g, kb=jv.kb, max_bpc=t_src.shape[1], num_blocks=jv.num_blocks,
        bm=jv.bm, bk=jv.bk, bq=128, interpret=True))
    got = kc.bsr_spmm_t_panel_c(
        meta["t_gblk"], meta["t_rows"], meta["t_nblocks"],
        torch.from_numpy(panel)[None], torch.from_numpy(g)[None],
        rows=jv.n_pad)[0]
    np.testing.assert_allclose(got.numpy(), ref, **TOL)
    for j in np.flatnonzero(t_nblocks == 0):    # an empty block column: 0
        assert torch.all(got[j * jv.bk:(j + 1) * jv.bk] == 0)


@pytest.mark.parametrize("kind,tiles", OP_CASES)
def test_plain_sddmm_c_matches_pallas_kernel(kind, tiles):
    jm, tm, jv, spec, meta, panel, rng = _kernel_problem(kind, tiles)
    d = 128
    lhs = rng.randn(jv.m_pad, d).astype(np.float32)
    rhs = rng.randn(jv.n_pad, d).astype(np.float32)
    ref = np.asarray(jc.bsr_sddmm_panel_c(
        jv.block_offsets, jv.block_cols, lhs, rhs,
        jv.mask.astype(np.float32), mb=jv.mb, max_bpr=jv.max_bpr,
        num_blocks=jv.num_blocks, bm=jv.bm, bk=jv.bk, bd=128,
        interpret=True))
    got = kc.bsr_sddmm_panel_c(
        meta["block_rows"], meta["block_cols"], torch.from_numpy(lhs)[None],
        torch.from_numpy(rhs)[None], meta["mask"])[0].numpy()
    nb = jv.num_blocks           # JAX leaves the dump undefined: drop it
    np.testing.assert_allclose(got[:nb], ref[:nb], **TOL)
    assert np.all(got[nb] == 0) and np.all(got[~jv.mask] == 0)


@pytest.mark.parametrize("kind,tiles", OP_CASES)
def test_plain_softmax_c_matches_pallas_kernels(kind, tiles):
    jm, tm, jv, spec, meta, panel, rng = _kernel_problem(kind, tiles)
    vals = (rng.randn(*jv.values_shape) * 3).astype(np.float32) * jv.mask
    mask_f = jv.mask.astype(np.float32)
    j_m, j_l = jc.c_softmax_stats(
        jv.block_offsets, vals, mask_f, mb=jv.mb, max_bpr=jv.max_bpr,
        num_blocks=jv.num_blocks, bm=jv.bm, bk=jv.bk, interpret=True)
    ref = np.asarray(jc.c_softmax_apply(
        jv.block_rows, vals, mask_f, j_m, j_l, num_blocks=jv.num_blocks,
        bm=jv.bm, bk=jv.bk, interpret=True))
    v = torch.from_numpy(vals)[None]
    m, l = kc.c_softmax_stats(meta["block_offsets"], v, meta["mask"])
    np.testing.assert_array_equal(m[0].numpy(), np.asarray(j_m)[:, 0])
    np.testing.assert_allclose(l[0].numpy(), np.asarray(j_l)[:, 0],
                               rtol=1e-6, atol=0)
    got = kc.c_softmax_apply(meta["block_rows"], v, meta["mask"], m, l)[0]
    np.testing.assert_allclose(got.numpy(), ref, **TOL)
    assert np.all(got.numpy()[~jv.mask] == 0)       # the dump included


# -- the ops on PanelSpec(compressed=True) against JAX's


def _op_problem(kind, tiles):
    A = _matrix(kind)
    jm, tm = _pair(A)
    bm, bk = tiles
    rng = np.random.RandomState(11)
    m, n = A.shape
    return dict(
        A=A, jm=jm, tm=tm, bm=bm, bk=bk,
        jspec=JP.PanelSpec(jm.topology, bm=bm, bk=bk, compressed=True),
        spec=P.PanelSpec(tm.topology, bm, bk, compressed=True),
        jpanel=JP.values_to_panel_np(jm.topology, jm.values, bm, bk,
                                     compressed=True),
        panel=torch.from_numpy(P.values_to_panel_np(
            tm.topology, tm.values, bm, bk, compressed=True)),
        dense=rng.randn(n, 24).astype(np.float32),
        g=rng.randn(m, 24).astype(np.float32),
        bias=rng.randn(m).astype(np.float32),
        lhs=rng.randn(m, 16).astype(np.float32),
        rhs=rng.randn(n, 16).astype(np.float32))


def _jvals(p, panel):
    return np.asarray(JP.panel_to_values(p["jm"].topology, panel, p["bm"],
                                         p["bk"], compressed=True))


def _tvals(p, panel):
    return P.panel_to_values_np(p["tm"].topology, panel.detach().numpy(),
                                p["bm"], p["bk"], compressed=True)


@pytest.mark.parametrize("kind,tiles", OP_CASES)
def test_compressed_ops_match_jax(backend, kind, tiles):
    p = _op_problem(kind, tiles)
    js, jp, ts, tp = p["jspec"], p["jpanel"], p["spec"], p["panel"]
    d, g, b = (torch.from_numpy(p[k]) for k in ("dense", "g", "bias"))
    cases = [
        (JP.spmm(js, jp, p["dense"]), P.spmm(ts, tp, d)),
        (JP.spmm(js, jp, p["dense"]) + p["bias"][:, None],
         P.spmm_bias(ts, tp, d, b)),
        (JP.spmm_bias_relu(js, jp, p["dense"], p["bias"]),
         P.spmm_bias_relu(ts, tp, d, b)),
        (JP.spmm_t(js, jp, p["g"]), P.spmm_t(ts, tp, g)),
    ]
    for ref, got in cases:
        np.testing.assert_allclose(got.numpy(), np.asarray(ref), **TOL)
    j_sd = JP.sddmm(js, p["lhs"], p["rhs"])
    sd = P.sddmm(ts, torch.from_numpy(p["lhs"]), torch.from_numpy(p["rhs"]))
    j_sm = JP.sparse_softmax(js, j_sd)
    sm = P.sparse_softmax(ts, sd)
    for ref, got in ((j_sd, sd), (j_sm, sm)):
        np.testing.assert_allclose(_tvals(p, got), _jvals(p, ref), **TOL)
        assert torch.all(got[torch.from_numpy(~ts.view.mask)] == 0)
    A = p["A"]                 # and against dense linear algebra
    np.testing.assert_allclose(P.spmm(ts, tp, d).numpy(), A @ p["dense"],
                               atol=1e-4, rtol=1e-4)


def _chain_jax(js, l, r, v):
    return JP.spmm(js, JP.sparse_softmax(js, JP.sddmm(js, l, r)), v)


def _chain(ts, l, r, v):
    return P.spmm(ts, P.sparse_softmax(ts, P.sddmm(ts, l, r)), v)


@pytest.mark.parametrize("kind,tiles", [("skewed", (32, 32)),
                                        ("empty_row", (16, 16))])
def test_compressed_chain_gradients_match_jax(backend, kind, tiles):
    p = _op_problem(kind, tiles)
    A = p["A"]
    v = np.random.RandomState(5).randn(A.shape[1], 24).astype(np.float32)
    js, ts = p["jspec"], p["spec"]
    ref = jax.grad(lambda l, r, vv: jnp.sum(_chain_jax(js, l, r, vv) ** 2),
                   argnums=(0, 1, 2))(p["lhs"], p["rhs"], v)
    ins = [torch.from_numpy(x).requires_grad_()
           for x in (p["lhs"], p["rhs"], v)]
    out = _chain(ts, *ins)
    np.testing.assert_allclose(
        out.detach().numpy(), np.asarray(_chain_jax(js, p["lhs"], p["rhs"],
                                                     v)), **TOL)
    grads = torch.autograd.grad(out.square().sum(), ins)
    for got, want in zip(grads, ref):
        want = np.asarray(want)
        lim = 1e-3 * max(np.abs(want).max(), 1e-30)
        assert np.abs(got.numpy() - want).max() <= lim
    # the panel gradients of each op, exactly 0 off the nonzeros
    tp = p["panel"].clone().requires_grad_()
    d = torch.from_numpy(p["dense"])
    (P.spmm(ts, tp, d).square().sum()
     + P.spmm_t(ts, tp, torch.from_numpy(p["g"])).square().sum()
     + P.sparse_softmax(ts, tp).sum()).backward()
    gp = jax.grad(lambda pp: jnp.sum(JP.spmm(js, pp, p["dense"]) ** 2)
                  + jnp.sum(JP.spmm_t(js, pp, p["g"]) ** 2)
                  + jnp.sum(JP.sparse_softmax(js, pp)))(p["jpanel"])
    np.testing.assert_allclose(_tvals(p, tp.grad), _jvals(p, gp),
                               atol=1e-3 * max(np.abs(np.asarray(gp)).max(),
                                               1.0), rtol=0)
    assert torch.all(tp.grad[torch.from_numpy(~ts.view.mask)] == 0)


def test_compressed_replicated_chain_matches_per_replica():
    """A leading replica dimension (``[R, num_blocks + 1, bm, bk]`` with
    dense operands ``[R, n, q]``), as the ELL ops take it: the chain and
    its gradients equal the per-replica calls."""
    p = _op_problem("skewed", (16, 16))
    ts, A = p["spec"], p["A"]
    rng = np.random.RandomState(4)
    ins = [torch.from_numpy(rng.randn(2, r, 8).astype(np.float32))
           .requires_grad_() for r in (A.shape[0], A.shape[1], A.shape[1])]
    out = _chain(ts, *ins)
    grads = torch.autograd.grad(out.square().sum(), ins)
    for r in range(2):
        one = [x[r].detach().clone().requires_grad_() for x in ins]
        ref = _chain(ts, *one)
        ref_g = torch.autograd.grad(ref.square().sum(), one)
        np.testing.assert_allclose(out[r].detach().numpy(),
                                   ref.detach().numpy(), **TOL)
        for g, want in zip(grads, ref_g):
            np.testing.assert_allclose(g[r].numpy(), want.numpy(), **TOL)


def test_compressed_ops_reject_wrong_operands():
    p = _op_problem("skewed", (32, 32))
    ts, tp = p["spec"], p["panel"]
    with pytest.raises(ValueError, match="rows"):
        P.spmm(ts, tp, torch.zeros(p["A"].shape[0] + 1, 8))
    with pytest.raises(ValueError, match="rank 3"):
        P.spmm(ts, tp[None, None], torch.zeros(p["A"].shape[1], 8))
    with pytest.raises(ValueError, match="rank 4"):  # an ELL panel
        P.sparse_softmax(P.PanelSpec(p["tm"].topology, 32, 32), tp)
    with pytest.raises(ValueError, match="ELL"):     # int8: ELL panels only
        stt.int8.quantize_panel(ts, tp)
    with pytest.raises(ValueError, match="ELL"):
        stt.int8.sddmm_int8(ts, torch.from_numpy(p["lhs"]),
                            torch.from_numpy(p["rhs"]))
    bv = ts.view           # tile-padded operands stay accepted
    assert P.spmm(ts, tp, torch.zeros(bv.n_pad, 8)).shape == (
        p["A"].shape[0], 8)


# -- JAX's compressed tests (tests/test_panel_ops.py), as parity cases


def test_compressed_panel_skewed_topology(backend):
    """A block-diagonal matrix with one dense row: the compressed panel
    holds fewer than half the ELL panel's tiles, and spmm / spmm_t and the
    gradients agree with dense linear algebra and with JAX."""
    rng = np.random.RandomState(7)
    m = 256
    A = _banded(rng, m)
    A[5, :] = rng.randn(m)
    jm, tm = _pair(A)
    t = tm.topology
    spec_e = P.PanelSpec(t, 32, 32)
    spec_c = P.PanelSpec(t, 32, 32, compressed=True)
    ell_tiles = spec_e.view.values_shape[0] * spec_e.view.values_shape[1]
    assert spec_c.view.values_shape[0] < 0.5 * ell_tiles
    js = JP.PanelSpec(jm.topology, bm=32, bk=32, compressed=True)
    jpc = JP.values_to_panel_np(jm.topology, jm.values, 32, 32,
                                compressed=True)
    pc = torch.from_numpy(P.values_to_panel_np(t, tm.values, 32, 32,
                                               compressed=True))
    np.testing.assert_array_equal(pc.numpy(), jpc)
    dense = rng.randn(m, 24).astype(np.float32)
    g = rng.randn(m, 24).astype(np.float32)
    out = P.spmm(spec_c, pc, torch.from_numpy(dense))
    outt = P.spmm_t(spec_c, pc, torch.from_numpy(g))
    np.testing.assert_allclose(out.numpy(), A @ dense, atol=1e-3)
    np.testing.assert_allclose(outt.numpy(), A.T @ g, atol=1e-3)
    np.testing.assert_allclose(out.numpy(), np.asarray(JP.spmm(js, jpc,
                                                               dense)), **TOL)
    pg = pc.clone().requires_grad_()
    dg = torch.from_numpy(dense).requires_grad_()
    P.spmm(spec_c, pg, dg).square().sum().backward()
    jgp, jgd = jax.grad(lambda pp, dd: jnp.sum(JP.spmm(js, pp, dd) ** 2),
                        argnums=(0, 1))(jpc, dense)
    assert torch.isfinite(pg.grad).all() and torch.isfinite(dg.grad).all()
    np.testing.assert_allclose(pg.grad.numpy()[:-1], np.asarray(jgp)[:-1],
                               atol=1e-3 * np.abs(np.asarray(jgp)).max())
    np.testing.assert_allclose(dg.grad.numpy(), np.asarray(jgd),
                               atol=1e-3 * np.abs(np.asarray(jgd)).max())
    back = P.panel_to_values_np(t, pc.numpy(), 32, 32, compressed=True)
    np.testing.assert_allclose(back, tm.values)
    back_t = P.panel_to_values(t, pc, 32, 32, compressed=True)
    np.testing.assert_array_equal(back_t.numpy(), back)
    np.testing.assert_array_equal(
        P.values_to_panel(t, torch.from_numpy(tm.values), 32, 32,
                          compressed=True).numpy(), pc.numpy())


def test_compressed_algebra_closure(backend):
    """The attention chain (sddmm -> softmax -> spmm) on the compressed
    layout with a dense row and an empty row: against a dense softmax
    reference and JAX, gradients included; the empty row gives zeros."""
    rng = np.random.RandomState(8)
    m = 192
    A = _banded(rng, m)
    A[5, :] = rng.randn(m)
    A[9, :] = 0.0
    jm, tm = _pair(A)
    spec = P.PanelSpec(tm.topology, 32, 32, compressed=True)
    js = JP.PanelSpec(jm.topology, bm=32, bk=32, compressed=True)
    mask = A != 0
    lhs, rhs = (rng.randn(m, 16).astype(np.float32) for _ in range(2))
    v = rng.randn(m, 24).astype(np.float32)
    sc = np.where(mask, lhs @ rhs.T, -1e30)
    w = np.where(mask, np.exp(sc - sc.max(-1, keepdims=True)), 0.0)
    den = w.sum(-1, keepdims=True)
    ctx_ref = np.where(den > 0, w / np.maximum(den, 1e-30), 0.0) @ v
    ins = [torch.from_numpy(x).requires_grad_() for x in (lhs, rhs, v)]
    ctx = _chain(spec, *ins)
    np.testing.assert_allclose(ctx.detach().numpy(), ctx_ref, atol=1e-3)
    assert torch.all(ctx[9] == 0)
    grads = torch.autograd.grad(ctx.square().sum(), ins)
    ref = jax.grad(lambda l, r, vv: jnp.sum(_chain_jax(js, l, r, vv) ** 2),
                   argnums=(0, 1, 2))(lhs, rhs, v)
    for got, want in zip(grads, ref):
        want = np.asarray(want)
        assert torch.isfinite(got).all()
        np.testing.assert_allclose(got.numpy(), want,
                                   atol=1e-3 * np.abs(want).max(), rtol=0)


@pytest.mark.parametrize("cotangent", ["random", "nan_at_dump_and_masked"])
def test_compressed_uniform_blocks_no_nan_dump(cotangent):
    """Every row-block has the same tile count, so no walk ever reaches the
    dump tile: it is still exactly 0 in the forward outputs and in every
    panel gradient, also for a cotangent that is NaN at the dump tile and
    at the masked slots (JAX's regression, made stricter)."""
    rng = np.random.RandomState(11)
    m = 128
    A = _banded(rng, m)
    A[:, 30:32] = 0.0                          # masked slots in every tile
    jm, tm = _pair(A)
    spec = P.PanelSpec(tm.topology, 32, 32, compressed=True)
    bv = spec.view
    assert len(set(np.diff(bv.block_offsets))) == 1
    dead = torch.from_numpy(~bv.mask)
    lhs, rhs = (torch.from_numpy(rng.randn(m, 16).astype(np.float32))
                .requires_grad_() for _ in range(2))
    v = torch.from_numpy(rng.randn(m, 24).astype(np.float32))
    scores = P.sddmm(spec, lhs, rhs)
    w = P.sparse_softmax(spec, scores)
    out = P.spmm(spec, w, v)
    for x in (scores, w):
        assert torch.all(x[-1] == 0) and torch.all(x[dead] == 0)
    assert torch.isfinite(out).all()
    panel = torch.from_numpy(P.values_to_panel_np(
        tm.topology, tm.values, 32, 32, compressed=True)).requires_grad_()
    cot = torch.from_numpy(rng.randn(*bv.values_shape).astype(np.float32))
    if cotangent != "random":
        cot[-1] = float("nan")
        cot[dead] = float("nan")
    grads = {
        "spmm": torch.autograd.grad(P.spmm(spec, panel, v).square().sum(),
                                    panel)[0],
        "spmm_t": torch.autograd.grad(P.spmm_t(spec, panel, v).square()
                                      .sum(), panel)[0],
        "softmax": torch.autograd.grad(P.sparse_softmax(spec, panel), panel,
                                       cot)[0],
        "sddmm_lhs": torch.autograd.grad(P.sddmm(spec, lhs, rhs), lhs,
                                         cot)[0],
    }
    for name, g in grads.items():
        assert torch.isfinite(g).all(), name
        if g.shape == bv.values_shape:
            assert torch.all(g[-1] == 0) and torch.all(g[dead] == 0), name
    # against JAX's pallas route on a finite cotangent
    if cotangent == "random":
        js = JP.PanelSpec(jm.topology, bm=32, bk=32, compressed=True)
        st.set_backend("pallas")
        try:
            jg = jax.grad(lambda pp: jnp.sum(JP.sparse_softmax(js, pp)
                                             * cot.numpy()))(
                JP.values_to_panel_np(jm.topology, jm.values, 32, 32,
                                      compressed=True))
        finally:
            st.set_backend("auto")
        np.testing.assert_allclose(grads["softmax"].numpy()[:-1],
                                   np.asarray(jg)[:-1], **TOL)


def test_compressed_softmax_gradcheck():
    """float64 gradcheck of the compressed softmax (CSR values scattered
    into the panel and gathered back, so the Jacobian is over the nonzeros)
    and of the compressed spmm, spmm_t and sddmm, through the plain kernel
    versions."""
    rng = np.random.RandomState(9)
    m = 64
    A = ((rng.rand(m, m) < 0.25) * rng.randn(m, m)).astype(np.float32)
    tm = stt.SparseMatrix(A)
    t = tm.topology
    spec = P.PanelSpec(t, 16, 16, compressed=True)

    def softmax_values(x):
        panel = P.values_to_panel(t, x, 16, 16, compressed=True)
        return P.panel_to_values(t, P.sparse_softmax(spec, panel), 16, 16,
                                 compressed=True)

    vals = torch.from_numpy(tm.values).double().requires_grad_()
    assert torch.autograd.gradcheck(softmax_values, (vals,), atol=1e-6,
                                    rtol=1e-4)
    small = stt.SparseMatrix(((rng.rand(40, 24) < 0.3)
                              * rng.randn(40, 24)).astype(np.float32))
    t2 = small.topology
    s2 = P.PanelSpec(t2, 16, 16, compressed=True)

    def panel_of(x):
        return P.values_to_panel(t2, x, 16, 16, compressed=True)

    v2 = torch.from_numpy(small.values).double().requires_grad_()
    d = torch.from_numpy(rng.randn(24, 3)).requires_grad_()
    g = torch.from_numpy(rng.randn(40, 3)).requires_grad_()
    assert torch.autograd.gradcheck(
        lambda x, y: P.spmm(s2, panel_of(x), y), (v2, d))
    assert torch.autograd.gradcheck(
        lambda x, y: P.spmm_t(s2, panel_of(x), y), (v2, g))
    lhs = torch.from_numpy(rng.randn(40, 5)).requires_grad_()
    rhs = torch.from_numpy(rng.randn(24, 5)).requires_grad_()
    assert torch.autograd.gradcheck(
        lambda a, b: P.panel_to_values(t2, P.sddmm(s2, a, b), 16, 16,
                                       compressed=True), (lhs, rhs))


def test_panel_kaiming_compressed_layout():
    mask = np.zeros((64, 64), np.float32)
    mask[:16, :] = 1                 # skewed: one dense band
    mask[np.arange(64), np.arange(64)] = 1
    topo = stt.SparseTopology.from_dense_mask(mask)
    vals = P.panel_kaiming_values(topo, 16, 16, compressed=True,
                                  generator=torch.Generator().manual_seed(0))
    spec = P.PanelSpec(topo, 16, 16, compressed=True)
    assert tuple(vals.shape) == spec.view.values_shape
    m = torch.from_numpy(spec.view.mask)
    assert torch.all(vals[~m] == 0) and vals[m].abs().max() > 0
    jtopo = st.SparseTopology.from_dense_mask(mask)
    jvals = JP.panel_kaiming_values(jtopo, 16, 16, compressed=True)(
        jax.random.PRNGKey(0))
    assert tuple(jvals.shape) == tuple(vals.shape)
    bound = float(np.sqrt(3.0 / max(topo.nnz / topo.m, 1.0)))
    assert vals.abs().max() <= bound and np.abs(jvals).max() <= bound


def test_all_zero_topology_gives_zeros():
    """``num_blocks = 0``: the panel is the dump tile alone; every op gives
    exact zeros and finite gradients."""
    tm = stt.SparseMatrix(np.zeros((64, 48), np.float32))
    spec = P.PanelSpec(tm.topology, 16, 16, compressed=True)
    assert spec.view.num_blocks == 0 and spec.view.values_shape == (1, 16, 16)
    ins = [torch.randn(64, 8, requires_grad=True),
           torch.randn(48, 8, requires_grad=True),
           torch.randn(48, 5, requires_grad=True)]
    out = _chain(spec, *ins)
    assert torch.all(out == 0)
    grads = torch.autograd.grad(out.sum(), ins)
    assert all(torch.all(g == 0) for g in grads)
    panel = torch.zeros(1, 16, 16)
    assert torch.all(P.spmm_t(spec, panel, torch.randn(64, 3)) == 0)
    assert torch.all(P.sparse_softmax(spec, panel) == 0)
