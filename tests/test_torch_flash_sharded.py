"""Sequence-parallel sparse-flash attention of the PyTorch port against the
JAX package, on the CPU.

  * ``ShardedFlashSpec``'s stacked tables, ``halo_extents`` / ``halo_plan``
    and the overlap split's interior / halo tables equal JAX's;
  * ``flash_attention_sharded`` (K / V replicated) at group 1 and 2, on
    both backward routes (the port's and JAX's ``_FUSED_BWD_ACC_BYTES``
    set together), forward and gradients against JAX's;
  * ``flash_attention_kv_sharded`` in its three branches (the overlap
    split, the monolithic halo assembly, the all_gather), at group 1 and
    2, on both routes, against JAX's; the split equals the monolithic
    branch;
  * every case at ``scale`` 0.3, not the default (dq is scaled once: JAX
    scales inside the replicated path's VJP and outside the kv-sharded
    one's);
  * the interior pass reads no halo-only buffer row; an edge shard's
    buffer holds no row of a wrapped hop;
  * the ``ValueError``s, JAX's texts where a shape breaks a rule;
  * ``examples/train_seq_parallel.py --small`` as a script on the CPU (its
    self-checks: both paths against dense attention, the loss falls).

The JAX tests' small shapes (``tests/test_flash_sharded.py``): bm 8,
bk 128, an 8-device CPU mesh (4 devices for the halo branches, at half
the JAX test's sequence). Tolerances: atol 1e-4 on outputs, 1e-2 on
gradients (the route changes only the order of sums).
"""

import runpy
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import Mesh

import sputnik_tpu as st
import sputnik_tpu_torch as stt
from sputnik_tpu.ops import fused_attention as jfa
from sputnik_tpu.parallel import RowPartition as JRowPartition
from sputnik_tpu.parallel import flash_sharded as jfsh
from sputnik_tpu_torch.ops import fused_attention as fa
from sputnik_tpu_torch.ops.kernels import flash_sparse as fs
from sputnik_tpu_torch.parallel import (RowPartition, ShardedFlashSpec,
                                        flash_attention_kv_sharded,
                                        flash_attention_sharded)
from sputnik_tpu_torch.parallel import flash_sharded as fsh
from sputnik_tpu_torch.parallel import sharded_ops as so

NDEV, BM, BK, SCALE = 8, 8, 128, 0.3
_TABLES = ("block_cols", "nblocks", "mask_slot", "t_src_i", "t_nblocks",
           "t_mask_slot", "t_is_partial", "pmask")


@pytest.fixture(autouse=True)
def _one_thread():
    """One intra-op thread: these tests run many small products, and under
    the suite's parallel workers more threads a worker oversubscribe the
    cores (each test took up to 100x its time alone)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _window(s, w):
    i, j = np.arange(s)[:, None], np.arange(s)[None, :]
    return ((j <= i) & (j > i - w)).astype(np.float32)


def _causal(s):
    mask = np.tril(np.ones((s, s), np.float32))
    mask[5] = 0.0                               # a fully masked row
    return mask


def _specs(mask, ndev=NDEV):
    mesh = Mesh(np.array(jax.devices()[:ndev]), ("sp",))
    jspec = jfsh.ShardedFlashSpec(
        JRowPartition(st.SparseTopology.from_dense_mask(mask), ndev, bm=BM,
                      balance=False), bm=BM, bk=BK, mesh=mesh, axis="sp")
    spec = ShardedFlashSpec(RowPartition(
        stt.SparseTopology.from_dense_mask(mask), ndev, bm=BM,
        balance=False), bm=BM, bk=BK)
    return jspec, spec


def _sh(x, ndev=NDEV):
    """``[R, s, hd]`` -> ``[ndev, R, s // ndev, hd]``."""
    R, s, hd = x.shape
    return np.ascontiguousarray(
        x.reshape(R, ndev, s // ndev, hd).transpose(1, 0, 2, 3))


def _both(fn, jfn, xs):
    """Port and JAX: forward and the gradients of ``sum(out ** 2)``."""
    ts = [torch.from_numpy(x).requires_grad_() for x in xs]
    out = fn(*ts)
    out.square().sum().backward()
    jx = [jnp.asarray(x) for x in xs]
    jout = jax.jit(jfn)(*jx)
    jg = jax.jit(jax.grad(lambda *a: jnp.sum(jfn(*a) ** 2),
                          argnums=tuple(range(len(xs)))))(*jx)
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(jout),
                               atol=1e-4)
    for t, g in zip(ts, jg):
        np.testing.assert_allclose(t.grad.numpy(), np.asarray(g), atol=1e-2)
    return out.detach(), [t.grad for t in ts]


@pytest.fixture
def calls(monkeypatch):
    """Counts the flash kernel wrappers' calls from the sharded paths."""
    got = {}
    for name in ("flash_sparse_attention_fwd", "flash_sparse_bwd_fused",
                 "flash_sparse_bwd_dq", "flash_sparse_bwd_dkv"):
        def counted(*a, _f=getattr(fs, name), _n=name, **k):
            got[_n] = got.get(_n, 0) + 1
            return _f(*a, **k)
        monkeypatch.setattr(fs, name, counted)
    return got


def _route(monkeypatch, route):
    if route == "two":
        monkeypatch.setattr(fa, "_FUSED_BWD_ACC_BYTES", 0)
        monkeypatch.setattr(jfa, "_FUSED_BWD_ACC_BYTES", 0)


def _bwd_calls(route, n):
    return ({"flash_sparse_bwd_fused": n} if route == "fused" else
            {"flash_sparse_bwd_dq": n, "flash_sparse_bwd_dkv": n})


def test_spec_tables_and_split_equal_jax():
    for mask in (_causal(320), _window(1024, 96)):
        jspec, spec = _specs(mask)
        for attr in ("mb", "kb", "m_pad_loc", "n_pad", "max_bpr",
                     "max_bpc"):
            assert getattr(spec, attr) == getattr(jspec, attr), attr
        for key in _TABLES:
            np.testing.assert_array_equal(getattr(spec, key),
                                          getattr(jspec, key), err_msg=key)
        np.testing.assert_array_equal(spec.is_partial, jspec.is_partial_)
        n_loc = spec.n_pad // NDEV
        for n in (n_loc, n_loc // 2):
            assert spec.halo_extents(n) == jspec.halo_extents(n)
            assert spec.halo_plan(n) == jspec.halo_plan(n)
    assert spec.halo_plan(n_loc) is not None and n_loc % BK == 0
    got, want = fsh._overlap_meta(spec, n_loc), jfsh._overlap_meta(jspec,
                                                                   n_loc)
    assert got["kb_i"] == want["kb_i"]
    for p in ("i", "h"):
        for key in _TABLES + ("is_partial", "max_bpr", "max_bpc"):
            np.testing.assert_array_equal(got[p][key], want[p][key],
                                          err_msg=f"{p} {key}")
    with pytest.raises(ValueError, match="n_loc"):
        fsh._overlap_meta(spec, n_loc // 2)


@pytest.mark.parametrize("route", ["fused", "two"])
@pytest.mark.parametrize("group", [1, 2])
def test_flash_attention_sharded_matches_jax(group, route, monkeypatch,
                                             calls):
    _route(monkeypatch, route)
    s, hd, R = 320, 16, 2 * group
    jspec, spec = _specs(_causal(s))
    rng = np.random.RandomState(group)
    xs = [_sh(rng.randn(R, s, hd).astype(np.float32))] + [
        rng.randn(R // group, s, hd).astype(np.float32) for _ in range(2)]
    _both(lambda *a: flash_attention_sharded(spec, *a, scale=SCALE,
                                             group=group),
          lambda *a: jfsh.flash_attention_sharded(jspec, *a, scale=SCALE,
                                                  group=group), xs)
    assert calls == {"flash_sparse_attention_fwd": NDEV,
                     **_bwd_calls(route, NDEV)}


# (branch, group, route): each branch at both groups and both routes
KV_CASES = [("overlap", 1, "fused"), ("overlap", 2, "two"),
            ("monolithic", 1, "two"), ("monolithic", 2, "fused"),
            ("gathered", 1, "two"), ("gathered", 2, "fused")]


def _kv_problem(branch, group, seed):
    """The all_gather on 8 shards of a causal mask; the halo branches on 4
    shards of a causal window of 96 at s = 512 (n_loc = 128 = bk)."""
    ndev = NDEV if branch == "gathered" else 4
    s = 320 if branch == "gathered" else 512
    mask = _causal(s) if branch == "gathered" else _window(s, 96)
    jspec, spec = _specs(mask, ndev)
    n_loc = spec.n_pad // ndev
    plan = spec.halo_plan(n_loc)
    assert (plan is None) == (branch == "gathered")
    rng = np.random.RandomState(seed)
    R, hd = 2 * group, 16
    q = rng.randn(R, s, hd).astype(np.float32)
    kv = [np.zeros((R // group, ndev * n_loc, hd), np.float32)
          for _ in range(2)]
    for x in kv:
        x[:, :s] = rng.randn(R // group, s, hd)
    return jspec, spec, [_sh(q, ndev)] + [_sh(x, ndev) for x in kv]


@pytest.mark.parametrize("branch,group,route", KV_CASES)
def test_flash_attention_kv_sharded_matches_jax(branch, group, route,
                                                monkeypatch, calls):
    _route(monkeypatch, route)
    jspec, spec, xs = _kv_problem(branch, group, 7)
    ov = branch == "overlap"
    _both(lambda *a: flash_attention_kv_sharded(
        spec, *a, scale=SCALE, group=group, overlap=ov),
        lambda *a: jfsh.flash_attention_kv_sharded(
            jspec, *a, scale=SCALE, group=group, overlap=ov), xs)
    ndev = spec.part.ndev
    passes = 2 * ndev if ov else ndev
    assert calls == {"flash_sparse_attention_fwd": passes,
                     **_bwd_calls(route, passes)}


@pytest.mark.parametrize("route", ["fused", "two"])
def test_overlap_split_equals_the_monolithic_branch(route, monkeypatch):
    _route(monkeypatch, route)
    _, spec, xs = _kv_problem("overlap", 2, 9)
    runs = []
    for ov in (True, False):
        ts = [torch.from_numpy(x).requires_grad_() for x in xs]
        out = flash_attention_kv_sharded(spec, *ts, scale=SCALE, group=2,
                                         overlap=ov)
        out.square().sum().backward()
        runs.append([out.detach()] + [t.grad for t in ts])
    for a, b in zip(*runs):
        torch.testing.assert_close(a, b, atol=1e-5, rtol=1e-5)


def test_interior_pass_reads_no_halo_buffer_row():
    """Each shard's interior pass reads only its local K / V; its halo pass
    reads only the rows that arrived. NaN in every other row of the
    halo-only buffer, and a NaN buffer for the interior pass, change
    nothing."""
    _, spec, (q, k, v) = _kv_problem("overlap", 1, 11)
    n_loc = spec.n_pad // spec.part.ndev
    plan = spec.halo_plan(n_loc)
    ti, th = fsh._ov_tables(spec, n_loc, "cpu")
    ks, vs, qs = (so._here(torch.from_numpy(x)) for x in (k, v, q))
    kb, vb = (so._halo_assemble(spec, x, n_loc, *plan, include_own=False)
              for x in (ks, vs))
    hit = so._halo_assemble(spec, [torch.ones_like(x) for x in ks], n_loc,
                            *plan, include_own=False)
    for d in range(spec.part.ndev):
        want_i = fsh._fwd(ti, d, qs[d], ks[d], vs[d], SCALE, 1)
        want_h = fsh._fwd(th, d, qs[d], kb[d], vb[d], SCALE, 1)
        nan_k, nan_v = (torch.where(hit[d] != 0, x[d], float("nan"))
                        for x in (kb, vb))
        got_h = fsh._fwd(th, d, qs[d], nan_k, nan_v, SCALE, 1)
        for a, b in zip(got_h, want_h):
            assert torch.equal(a, b), d
        assert torch.isfinite(want_i[0]).all()
        assert torch.isfinite(got_h[0]).all()


def test_edge_shards_drop_wrapped_hops():
    """The exchange's wrapped hops (shard 0's lower halo comes from the last
    shard, the last shard's upper halo from shard 0) land in no real row:
    every shard's buffer holds exactly its halo's global rows."""
    s, ndev, w = 512, 4, 96
    i, j = np.arange(s)[:, None], np.arange(s)[None, :]
    mask = (np.abs(i - j) < w).astype(np.float32)   # lo and hi halos
    spec = ShardedFlashSpec(RowPartition(
        stt.SparseTopology.from_dense_mask(mask), ndev, bm=BM,
        balance=False), bm=BM, bk=BK)
    n_loc = spec.n_pad // ndev
    lo, hi = spec.halo_plan(n_loc)
    assert lo > 0 and hi > 0
    rows = torch.arange(spec.n_pad, dtype=torch.float32) + 1
    x = rows.view(ndev, 1, n_loc, 1).expand(ndev, 2, n_loc, 3).contiguous()
    for own in (True, False):
        bufs = so._halo_assemble(spec, so._here(x), n_loc, lo, hi,
                                 include_own=own)
        for d, buf in enumerate(bufs):
            keep = (rows > d * n_loc - lo) & (rows <= (d + 1) * n_loc + hi)
            if not own:
                keep &= (rows <= d * n_loc) | (rows > (d + 1) * n_loc)
            want = torch.where(keep, rows, 0.0)
            assert torch.equal(buf[0, :, 0], want), (d, own)
    # the reverse: each shard's rows get their cotangent back once per
    # shard that holds them, never from a wrapped hop
    back = so._halo_scatter_back(spec, so._halo_assemble(
        spec, so._here(x), n_loc, lo, hi), n_loc, lo, hi)
    counts = torch.stack(back)[:, 0, :, 0] / x[:, 0, :, 0]
    assert torch.equal(counts[0, :n_loc - hi], torch.ones(n_loc - hi))
    assert torch.equal(counts[0, n_loc - hi:], torch.full((hi,), 2.0))
    assert torch.equal(counts[-1, :lo], torch.full((lo,), 2.0))


def test_validation_and_jax_errors():
    jspec, spec = _specs(_causal(320))
    q = torch.zeros(NDEV, 4, 40, 16)
    kv = torch.zeros(4, 320, 16)
    with pytest.raises(ValueError, match="group 3 must divide"):
        flash_attention_sharded(spec, q, kv, kv, group=3)
    with pytest.raises(ValueError, match="R // group"):
        flash_attention_sharded(spec, q, kv, kv, group=2)
    with pytest.raises(ValueError, match="ndev axis"):
        flash_attention_kv_sharded(spec, q, kv[None], kv[None])
    with pytest.raises(ValueError, match="per-device key rows"):
        flash_attention_kv_sharded(spec, q, torch.zeros(NDEV, 4, 49, 16),
                                   torch.zeros(NDEV, 4, 49, 16))
    with pytest.raises(ValueError, match="partition has"):
        ShardedFlashSpec(spec.part, mesh=stt.parallel.Mesh({"sp": 2}))
    with pytest.raises(ValueError, match="no axis 'sp'"):
        ShardedFlashSpec(spec.part, mesh=stt.parallel.Mesh({"x": NDEV}))
    # 6 shards of n_pad = 256 keys break the key-sharding rule: both
    # packages raise the same text
    jspec6, spec6 = _specs(_causal(200), ndev=6)
    assert spec6.n_pad % 6
    q6 = np.zeros((6, 2, spec6.m_pad_loc, 16), np.float32)
    kv6 = np.zeros((6, 2, 40, 16), np.float32)
    with pytest.raises(ValueError, match="must divide over ndev") as e:
        flash_attention_kv_sharded(spec6, *map(torch.from_numpy,
                                               (q6, kv6, kv6)))
    with pytest.raises(ValueError) as je:
        jfsh.flash_attention_kv_sharded(jspec6, *map(jnp.asarray,
                                                     (q6, kv6, kv6)))
    assert str(e.value) == str(je.value)


def test_train_seq_parallel_example_runs_small(monkeypatch):
    monkeypatch.setattr(sys, "argv", ["train_seq_parallel", "--small",
                                      "--device", "cpu"])
    runpy.run_module("sputnik_tpu_torch.examples.train_seq_parallel",
                     run_name="__main__")
    from sputnik_tpu_torch.examples import train_seq_parallel as ex

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA"):
        ex.main(["--small"])
