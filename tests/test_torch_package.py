"""Package-level guarantees of the PyTorch port.

  * ``import sputnik_tpu_torch`` loads no JAX module;
  * the kernel modules import without ``nvcc`` or ``triton``, and a missing
    ``nvcc`` makes a build raise instead of falling back;
  * CPU tensors never launch a kernel, forward or backward: every launch
    counter stays 0;
  * a raw kernel launch refuses grad mode and names the autograd op to use.
"""

import os
import subprocess
import sys

import numpy as np
import pytest
import torch

import sputnik_tpu_torch as stt
from sputnik_tpu_torch.ops import kernels
from sputnik_tpu_torch.ops.kernels import _build
from sputnik_tpu_torch.patterns import driver_masks, uniform_mask

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _run(code, env=None):
    return subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                          capture_output=True, text=True, timeout=120)


def test_import_loads_no_jax():
    r = _run("import sys, sputnik_tpu_torch, sputnik_tpu_torch.models, "
             "sputnik_tpu_torch.bridge, "
             "sputnik_tpu_torch.examples.train_sparse_transformer, "
             "sputnik_tpu_torch.examples.generate, "
             "sputnik_tpu_torch.examples.serve_paged, "
             "sputnik_tpu_torch.examples.serve_continuous, "
             "sputnik_tpu_torch.examples.serve_speculative, "
             "sputnik_tpu_torch.models._step_graph, "
             "sputnik_tpu_torch.examples.train_moe_transformer, "
             "sputnik_tpu_torch.models.moe, "
             "sputnik_tpu_torch.ops.paged, "
             "sputnik_tpu_torch.models.serving_paged, "
             "sputnik_tpu_torch.ops.api, sputnik_tpu_torch.ops.dispatch, "
             "sputnik_tpu_torch.training, "
             "sputnik_tpu_torch.examples.dynamic_sparse_training, "
             "sputnik_tpu_torch.examples.train_block_sparse, "
             "sputnik_tpu_torch.ops.int8_api, "
             "sputnik_tpu_torch.examples.serve_sparse_int8, "
             "sputnik_tpu_torch.parallel, "
             "sputnik_tpu_torch.parallel.partition, "
             "sputnik_tpu_torch.parallel.ring_flash, "
             "sputnik_tpu_torch.parallel.sharded_ops, "
             "sputnik_tpu_torch.parallel.sharded_compressed, "
             "sputnik_tpu_torch.parallel.flash_sharded, "
             "sputnik_tpu_torch.parallel.comm_model, "
             "sputnik_tpu_torch.dryrun, "
             "sputnik_tpu_torch.examples.train_seq_parallel, "
             "sputnik_tpu_torch.parallel._mesh, "
             "sputnik_tpu_torch.parallel.serving_tp, "
             "sputnik_tpu_torch.parallel.lm_tp, "
             "sputnik_tpu_torch.parallel.pipeline, "
             "sputnik_tpu_torch.examples.serve_tp\n"
             "bad = sorted(m for m in sys.modules if m.split('.')[0] in "
             "('jax', 'jaxlib', 'flax', 'optax', 'sputnik_tpu'))\n"
             "print(bad)")
    assert r.returncode == 0, r.stderr
    assert r.stdout.strip() == "[]"


def test_kernel_modules_import_without_nvcc_or_triton(tmp_path):
    env = dict(os.environ, PATH=str(tmp_path), CUDA_HOME=str(tmp_path))
    r = _run("import sys\n"
             "import sputnik_tpu_torch.ops.kernels.bsr_spmm\n"
             "import sputnik_tpu_torch.ops.kernels.bsr_sddmm\n"
             "import sputnik_tpu_torch.ops.kernels.bsr_spmm_t\n"
             "import sputnik_tpu_torch.ops.kernels.flash_sparse\n"
             "import sputnik_tpu_torch.ops.kernels.decode_attention\n"
             "import sputnik_tpu_torch.ops.kernels.ragged_append\n"
             "import sputnik_tpu_torch.ops.kernels.paged_attention\n"
             "import sputnik_tpu_torch.ops.kernels.paged_append\n"
             "import sputnik_tpu_torch.ops.kernels.batched_panel\n"
             "import sputnik_tpu_torch.ops.kernels.ell_softmax\n"
             "import sputnik_tpu_torch.ops.kernels.bsr_compressed\n"
             "import sputnik_tpu_torch.ops.kernels.bsr_spmm_int8\n"
             "import sputnik_tpu_torch.ops.kernels.flash_sparse_int8\n"
             "import sputnik_tpu_torch.ops.int8_api\n"
             "import sputnik_tpu_torch.ops.dispatch\n"
             "import sputnik_tpu_torch.models.moe\n"
             "import sputnik_tpu_torch.ops.paged\n"
             "import sputnik_tpu_torch.models.serving_paged\n"
             "import sputnik_tpu_torch.parallel\n"
             "from sputnik_tpu_torch.ops.kernels import _build\n"
             "assert 'triton' not in sys.modules\n"
             "try:\n"
             "    _build._nvcc()\n"
             "except RuntimeError as e:\n"
             "    print('raised', 'nvcc' in str(e))\n", env=env)
    assert r.returncode == 0, r.stderr
    assert r.stdout.strip() == "raised True"


def test_build_key_covers_every_source():
    cu, cuh = _build._sources()
    assert {p.name for p in cu} == {"bsr_spmm.cu", "bsr_spmm_t.cu",
                                    "bsr_sddmm.cu", "flash_sparse_fwd.cu",
                                    "flash_sparse_bwd.cu",
                                    "decode_attention.cu",
                                    "ragged_append.cu", "ell_softmax.cu",
                                    "bsr_spmm_int8.cu",
                                    "flash_sparse_int8.cu",
                                    "flash_sparse_int8_bwd.cu",
                                    "bsr_compressed.cu"}
    assert set(_build._SIGNATURES) == {
        "spmm_panel_f32", "spmm_t_panel_f32", "sddmm_panel_f32",
        "flash_sparse_fwd_f32", "flash_sparse_bwd_fused_f32",
        "flash_sparse_bwd_dq_f32", "flash_sparse_bwd_dkv_f32",
        "decode_attention", "ragged_append", "paged_attention",
        "paged_append", "spmm_bh_f32", "sddmm_bh_f32", "spmm_t_bh_f32",
        "softmax_csr_f32", "softmax_panel_f32", "quant_kmajor",
        "spmm_panel_int8",
        "spmm_t_panel_int8", "sddmm_panel_int8", "flash_sparse_fwd_int8",
        "flash_sparse_bwd_dq_int8", "flash_sparse_bwd_dkv_int8",
        "spmm_panel_c_f32", "spmm_t_panel_c_f32", "sddmm_panel_c_f32",
        "c_softmax_stats_f32", "c_softmax_apply_f32", "c_softmax_rowsum_f32",
        "c_softmax_grad_f32", "spmm_panel_sel_f32",
        "flash_sparse_ring_fwd_f32", "flash_sparse_ring_bwd_f32"}
    assert [p.name for p in cuh] == ["common.cuh", "flash_tc.cuh"]
    so = _build._so_path()
    assert so.parent.name == "_build" and so.parent.parent.name == \
        "sputnik_tpu_torch"


def test_cpu_tensors_launch_no_kernel():
    wrappers = kernels.kernel_wrappers()
    before = {n: w.launches for n, w in wrappers.items()}
    s = 64
    model = stt.SparseTransformer.from_masks(
        driver_masks(2, s), num_layers=1, hidden_size=32, num_heads=2,
        ffn_hidden_size=64, generator=torch.Generator().manual_seed(0))
    attn = stt.SparseAttention(2, 32, stt.SparseTopology.from_dense_mask(
        uniform_mask(s, s, sparsity=0.9, seed=1)))
    lin = stt.SparseLinear(stt.SparseTopology.from_dense_mask(np.eye(32)),
                           fuse_relu=True)
    csr = stt.SparseLinear(stt.SparseTopology.from_dense_mask(np.eye(32)),
                           layout="csr")
    topo = stt.SparseTopology.from_dense_mask(
        uniform_mask(32, 32, sparsity=0.5, seed=2))
    panel_moe = stt.SparseTransformer.from_masks(
        driver_masks(2, s), num_layers=2, hidden_size=32, num_heads=2,
        ffn_hidden_size=32, attention_layout="panel", moe_every=2,
        moe=dict(topo_in=topo, topo_out=topo, num_experts=2, top_k=2))
    x = torch.randn(2, s, 32, requires_grad=True)
    y = csr(lin(attn(panel_moe(model(x)))))
    (y.square().sum() + panel_moe.aux_loss()).backward()
    for backend in ("auto", "pallas"):       # the flat chain, both routes
        stt.set_backend(backend)
        try:
            q = x[0, :32].detach().requires_grad_()
            p = stt.sparse_softmax(topo, stt.sddmm(topo, q, q))
            stt.spmm(topo, p, q).sum().backward()
        finally:
            stt.set_backend("auto")
        assert torch.isfinite(q.grad).all()
    assert torch.isfinite(y).all() and torch.isfinite(x.grad).all()
    lm = stt.SparseLM.from_masks(
        driver_masks(2, 16), vocab_size=11, num_layers=1, hidden_size=32,
        num_heads=2, ffn_hidden_size=64)
    toks, _ = stt.LMServer(lm, s_max=24, bk=8).generate(
        torch.zeros(2, 16, dtype=torch.long), 3, prompt_lengths=[9, 16])
    assert toks.shape == (2, 3)
    lm128 = stt.SparseLM.from_masks(
        driver_masks(2, 128), vocab_size=11, num_layers=1, hidden_size=32,
        num_heads=2, ffn_hidden_size=64)
    toks, _ = stt.LMServer(lm128, s_max=256, bk=128, n_pages=8).generate(
        torch.zeros(2, 128, dtype=torch.long), 3)
    assert toks.shape == (2, 3)
    spec = stt.PanelSpec(topo, 16, 16)
    panel = torch.from_numpy(stt.ops.panel_api.values_to_panel_np(
        topo, np.ones(topo.nnz_pad, np.float32), 16, 16)).requires_grad_()
    d = torch.randn(32, 8, requires_grad=True)
    bspec = stt.BatchedPanelSpec.from_many_mask(
        stt.ManyMaskTopology.from_dense_masks(driver_masks(1, s)), heads=2)
    qkv = torch.randn(3, 2, s, 16, requires_grad=True)
    for backend in ("auto", "pallas"):       # the int8 family, both routes
        stt.set_backend(backend)
        try:
            (stt.int8.spmm_qat(spec, panel, d).sum()
             + stt.int8.attention_qat(bspec, *qkv).sum()
             + stt.int8.attention_qat(bspec, *qkv,
                                      backward="int8").sum()).backward()
        finally:
            stt.set_backend("auto")
    assert torch.isfinite(qkv.grad).all() and torch.isfinite(panel.grad).all()
    cspec = stt.PanelSpec(topo, 16, 16, compressed=True)  # the true-BSR chain
    q = x[0, :32].detach().requires_grad_()
    w = stt.panel.sparse_softmax(cspec, stt.panel.sddmm(cspec, q, q))
    (stt.panel.spmm(cspec, w, q).sum()
     + stt.panel.spmm_t(cspec, w, q).sum()).backward()
    assert torch.isfinite(q.grad).all()
    # the sequence-parallel layer: the ring (both backward routes) and the
    # halo SpMM's split branch
    part = stt.parallel.RowPartition(stt.SparseTopology.from_dense_mask(
        np.tril(np.ones((64, 64)))), 2, bm=8, balance=False)
    ring = stt.parallel.RingFlashSpec(part, bm=8, bk=16)
    for group in (1, 2):
        qkv_sh = [torch.randn(2, 2 // r, 32, 8, requires_grad=True)
                  for r in (1, group, group)]
        stt.parallel.ring_flash_attention(ring, *qkv_sh,
                                          group=group).sum().backward()
        assert all(torch.isfinite(t.grad).all() for t in qkv_sh)
    band = np.tril(np.ones((64, 64))) - np.tril(np.ones((64, 64)), -9)
    hpart = stt.parallel.RowPartition(stt.SparseTopology.from_dense_mask(
        band), 2, bm=8, balance=False)
    hspec = stt.parallel.ShardedPanelSpec(hpart, bm=8, bk=16)
    panels = torch.from_numpy(hspec.stack_values(np.ones(
        hpart.topo.nnz_pad, np.float32))).requires_grad_()
    dense_sh = torch.randn(2, 32, 4, requires_grad=True)
    stt.parallel.sharded_spmm_halo(hspec, panels, dense_sh).sum().backward()
    assert torch.isfinite(dense_sh.grad).all()
    assert {n: w.launches for n, w in wrappers.items()} == before
    assert len(wrappers) == 34 and {"ell_softmax", "ell_softmax_bwd",
                                    "panel_softmax",
                                    "panel_softmax_bwd"} <= set(wrappers)
    assert {"bsr_spmm_panel_sel", "flash_sparse_ring_band_fwd",
            "flash_sparse_ring_band_bwd"} <= set(wrappers)
    assert {"bsr_spmm_panel_c", "bsr_spmm_t_panel_c", "bsr_sddmm_panel_c",
            "c_softmax_stats", "c_softmax_apply", "c_softmax_rowsum",
            "c_softmax_grad"} <= set(wrappers)
    assert {"flash_sparse_attention_fwd_int8", "flash_sparse_bwd_dq_int8",
            "flash_sparse_bwd_dkv_int8"} <= set(wrappers)
    assert all(v == 0 for v in before.values())


def test_grad_guard_raises_only_when_grad_is_needed():
    a = torch.zeros(2, requires_grad=True)
    with pytest.raises(RuntimeError, match="call panel_api.spmm to train"):
        kernels.guard_no_grad("k", "panel_api.spmm", a)
    with torch.no_grad():
        kernels.guard_no_grad("k", "panel_api.spmm", a)
    kernels.guard_no_grad("k", "panel_api.spmm", torch.zeros(2), None)


def test_sequence_parallel_wrappers_refuse_grad_mode():
    """The three raw wrappers of the sequence-parallel layer, handed
    tensors that report a CUDA device, refuse a tensor that requires grad
    before anything reaches the card, and name the autograd op to use."""
    from unittest import mock

    from sputnik_tpu_torch.ops.kernels import bsr_spmm, flash_sparse

    i = torch.zeros(1, dtype=torch.int32)
    x = torch.zeros(1, 64, 8, requires_grad=True)
    stats = torch.zeros(1, 64)
    calls = {
        "sharded_spmm_halo": lambda: bsr_spmm.bsr_spmm_panel_sel(
            i, i, i, torch.zeros(1, 1, 64, 64, requires_grad=True),
            torch.zeros(64, 8)),
        "ring_flash_attention": (
            lambda: flash_sparse.flash_sparse_ring_band_fwd(
                i, i, i, i, torch.ones(1, 64, 64), x, x, x,
                torch.zeros_like(x), stats, stats, max_bpr=1)),
    }
    calls["ring_flash_attention (backward)"] = (
        lambda: flash_sparse.flash_sparse_ring_band_bwd(
            i, i, i, i, torch.ones(1, 64, 64), x, x, x, x, stats, stats,
            stats, torch.zeros_like(x), torch.zeros_like(x),
            torch.zeros_like(x), max_bpr=1))
    with mock.patch.object(torch.Tensor, "is_cuda",
                           new=property(lambda self: True)):
        for op, call in calls.items():
            name = op.split()[0]
            with pytest.raises(RuntimeError,
                               match=f"call parallel.{name} to train"):
                call()


def test_operand_checks():
    cpu = torch.device("cpu")
    kernels.check_operands("k", cpu, x=(torch.zeros(3), torch.float32))
    with pytest.raises(TypeError):
        kernels.check_operands("k", cpu, x=(torch.zeros(3), torch.int32))
    with pytest.raises(ValueError):
        kernels.check_operands("k", cpu,
                               x=(torch.zeros(3, 4).T, torch.float32))
    with pytest.raises(ValueError):
        kernels.check_operands("k", torch.device("meta"),
                               x=(torch.zeros(3), torch.float32))


def test_build_failure_raises(tmp_path, monkeypatch):
    """With no nvcc a CUDA launch cannot silently use the CPU version:
    ``library()`` raises."""
    monkeypatch.setenv("PATH", str(tmp_path))
    monkeypatch.setenv("CUDA_HOME", str(tmp_path))
    monkeypatch.setattr(_build, "_lib", None)
    monkeypatch.setattr(_build, "_BUILD", tmp_path / "_build")
    with pytest.raises(RuntimeError, match="nvcc"):
        _build.library()


def test_exports_match_the_jax_package():
    """The names of ``sputnik_tpu`` and ``sputnik_tpu.ops`` exist in the
    port (the compressed layout's ``CompressedView`` too); ``ops.panel`` is
    ``ops.panel_api`` and ``int8`` is ``ops.int8_api``, whose names are
    JAX's but for the in-graph quantiser's torch name."""
    import sputnik_tpu as st

    assert set(st.__all__) - set(stt.__all__) == set()
    assert set(st.ops.__all__) - set(stt.ops.__all__) == set()
    assert stt.int8 is stt.ops.int8 is stt.ops.int8_api
    assert set(st.int8.__all__) - set(stt.int8.__all__) == {
        "quantize_panel_jnp"}
    assert set(stt.int8.__all__) - set(st.int8.__all__) == {
        "quantize_panel_tensor"}
    assert all(hasattr(stt, n) for n in stt.__all__)
    assert all(hasattr(stt.ops, n) for n in stt.ops.__all__)
    assert stt.ops.panel is stt.ops.panel_api and stt.panel is stt.ops.panel
    assert stt.spmm_bias is stt.spmm_bias_relu
    for name in ("SparseLinear", "sparse_kaiming_values"):
        assert hasattr(stt.models, name)
    from sputnik_tpu import training as jtr
    assert set(stt.training.__all__) == set(jtr.__all__)


def test_set_backend_is_per_thread_and_checked():
    import threading

    seen = []
    stt.set_backend("xla")
    try:
        t = threading.Thread(target=lambda: seen.append(stt.get_backend()))
        t.start()
        t.join(timeout=30)
        assert not t.is_alive() and seen == ["auto"]
        assert stt.get_backend() == "xla"
        with pytest.raises(ValueError, match="backend"):
            stt.set_backend("cuda")
    finally:
        stt.set_backend("auto")
