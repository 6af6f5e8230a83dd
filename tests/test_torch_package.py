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
             "sputnik_tpu_torch.examples.train_sparse_transformer\n"
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
                                    "flash_sparse_bwd.cu"}
    assert set(_build._SIGNATURES) == {
        "spmm_panel_f32", "spmm_t_panel_f32", "sddmm_panel_f32",
        "flash_sparse_fwd_f32", "flash_sparse_bwd_fused_f32",
        "flash_sparse_bwd_dq_f32", "flash_sparse_bwd_dkv_f32"}
    assert [p.name for p in cuh] == ["common.cuh"]
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
    x = torch.randn(2, s, 32, requires_grad=True)
    y = lin(attn(model(x)))
    y.square().sum().backward()
    assert torch.isfinite(y).all() and torch.isfinite(x.grad).all()
    assert {n: w.launches for n, w in wrappers.items()} == before
    assert len(wrappers) == 7
    assert all(v == 0 for v in before.values())


def test_grad_guard_raises_only_when_grad_is_needed():
    a = torch.zeros(2, requires_grad=True)
    with pytest.raises(RuntimeError, match="call panel_api.spmm to train"):
        kernels.guard_no_grad("k", "panel_api.spmm", a)
    with torch.no_grad():
        kernels.guard_no_grad("k", "panel_api.spmm", a)
    kernels.guard_no_grad("k", "panel_api.spmm", torch.zeros(2), None)


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
