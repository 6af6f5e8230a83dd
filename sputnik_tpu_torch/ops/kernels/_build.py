"""Build the CUDA kernels with ``nvcc`` and load them with ``ctypes``.

All ``csrc/*.cu`` files compile into ONE shared library with a plain C
interface (no PyTorch headers, so a build takes seconds, not minutes). Each
source compiles in its own ``nvcc`` process, all started together, and the
objects are linked once:

    nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -Xcompiler
         -fPIC -Xptxas -v -c -o <obj>.o csrc/<source>.cu      # one per source
    nvcc -shared -o _build/libsputnik_kernels_<hash>.so <obj>.o ...

The build happens at first use, into ``sputnik_tpu_torch/_build/``, keyed by
a hash of the sources and flags, so a source change never reuses a stale
library. ``ptxas`` resource usage (registers, shared memory, spills) is kept
beside the library in ``<name>.log``. Nothing here runs at import time.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path

__all__ = ["library", "check", "build_log"]

_PKG = Path(__file__).resolve().parents[2]
_CSRC = _PKG / "csrc"
_BUILD = _PKG / "_build"
_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
          "-Xcompiler", "-fPIC", "-Xptxas", "-v"]

_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
# C entry points: every pointer and the stream as void*, sizes as int.
_SIGNATURES = {
    "spmm_panel_f32": [_P, _P, _P, _P, _P, _P,
                       _I, _I, _I, _I, _I, _I, _I, _I, _I, _P],
    "sddmm_panel_f32": [_P, _P, _P, _P, _P, _P,
                        _I, _I, _I, _I, _I, _I, _I, _I, _P],
    "flash_sparse_fwd_f32": [_P] * 12 + [_I] * 10 + [_F, _P],
    "spmm_t_panel_f32": [_P, _P, _P, _P, _P, _P,
                         _I, _I, _I, _I, _I, _I, _I, _I, _I, _I, _P],
    "flash_sparse_bwd_fused_f32": [_P] * 16 + [_I] * 10 + [_F, _P],
    "flash_sparse_bwd_dq_f32": [_P] * 14 + [_I] * 10 + [_F, _P],
    "flash_sparse_bwd_dkv_f32": [_P] * 15 + [_I] * 12 + [_F, _P],
    "decode_attention": [_P] * 10 + [_I] * 10 + [_F, _P],
    "ragged_append": [_P] * 10 + [_I] * 4 + [_P],
    "paged_attention": [_P] * 11 + [_I] * 10 + [_F, _P],
    "paged_append": [_P] * 11 + [_I] * 5 + [_P],
    "spmm_bh_f32": [_P] * 5 + [_I] * 9 + [_P],
    "sddmm_bh_f32": [_P] * 6 + [_I] * 9 + [_P],
    "spmm_t_bh_f32": [_P] * 6 + [_I] * 11 + [_P],
    "ell_softmax_f32": [_P] * 3 + [_I] * 4 + [_P],
    "quant_kmajor": [_P] * 4 + [_I] * 7 + [_P],
    "spmm_panel_int8": [_P] * 7 + [_I] * 8 + [_P],
    "spmm_t_panel_int8": [_P] * 9 + [_I] * 8 + [_P],
    "sddmm_panel_int8": [_P] * 10 + [_I] * 7 + [_P],
    "flash_sparse_fwd_int8": [_P] * 12 + [_I] * 8 + [_F, _P],
    "flash_sparse_bwd_dq_int8": [_P] * 13 + [_I] * 8 + [_F, _P],
    "flash_sparse_bwd_dkv_int8": [_P] * 15 + [_I] * 9 + [_F, _P],
    "spmm_panel_c_f32": [_P] * 10 + [_I] * 12 + [_P],
    "spmm_t_panel_c_f32": [_P] * 6 + [_I] * 9 + [_P],
    "sddmm_panel_c_f32": [_P] * 6 + [_I] * 7 + [_P],
    "c_softmax_stats_f32": [_P] * 5 + [_I] * 5 + [_P],
    "c_softmax_apply_f32": [_P] * 6 + [_I] * 5 + [_P],
    "spmm_panel_sel_f32": [_P] * 6 + [_I] * 8 + [_P],
    "flash_sparse_ring_fwd_f32": [_P] * 12 + [_I] * 8 + [_P],
    "flash_sparse_ring_bwd_f32": [_P] * 16 + [_I] * 7 + [_P],
}

_lock = threading.Lock()
_lib = None


def _sources():
    return sorted(_CSRC.glob("*.cu")), sorted(_CSRC.glob("*.cuh"))


def _nvcc() -> str:
    home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    for cand in (shutil.which("nvcc"), os.path.join(home, "bin", "nvcc")):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError(
        "nvcc not found (neither on PATH nor under $CUDA_HOME/bin): the "
        "CUDA kernels of sputnik_tpu_torch cannot be built")


def _so_path() -> Path:
    cu, cuh = _sources()
    if not cu:
        raise RuntimeError(f"no CUDA sources under {_CSRC}")
    h = hashlib.sha256(" ".join(_FLAGS).encode())
    for p in cu + cuh:
        h.update(p.name.encode())
        h.update(p.read_bytes())
    return _BUILD / f"libsputnik_kernels_{h.hexdigest()[:16]}.so"


def build_log() -> str:
    """The compiler's output (ptxas resource usage) of the current build."""
    path = _so_path().with_suffix(".log")
    return path.read_text() if path.exists() else ""


def _compile(so: Path) -> None:
    """Compile every source at once (one ``nvcc`` each), link, then rename:
    a concurrent first use in another process never loads a half-written
    library."""
    _BUILD.mkdir(parents=True, exist_ok=True)
    cu, _ = _sources()
    tag = f"{so.stem}.{os.getpid()}"
    objs = [_BUILD / f"{tag}.{src.stem}.o" for src in cu]
    tmp = so.with_name(f"{so.name}.tmp.{os.getpid()}")
    nvcc = _nvcc()
    procs = [subprocess.Popen(
        [nvcc, *_FLAGS, "-I", str(_CSRC), "-c", "-o", str(obj), str(src)],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        for src, obj in zip(cu, objs)]
    try:
        logs = []
        for src, p in zip(cu, procs):
            out, _ = p.communicate(timeout=900)
            if p.returncode != 0:
                raise RuntimeError(
                    f"nvcc failed on {src.name} ({p.returncode}):\n{out}")
            logs.append(f"== {src.name}\n{out}")
        r = subprocess.run([nvcc, "-shared", "-o", str(tmp), *map(str, objs)],
                           capture_output=True, text=True, timeout=300)
        if r.returncode != 0:
            raise RuntimeError(
                f"nvcc link failed ({r.returncode}):\n{r.stdout}\n{r.stderr}")
        so.with_suffix(".log").write_text("".join(logs))
        os.replace(tmp, so)
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
        for path in (tmp, *objs):
            if path.exists():
                path.unlink()


def library() -> ctypes.CDLL:
    """The loaded kernel library, built first if needed. Raises on failure."""
    global _lib
    if _lib is not None:
        return _lib
    with _lock:
        if _lib is None:
            so = _so_path()
            if not so.exists():
                _compile(so)
            lib = ctypes.CDLL(str(so))
            for name, argtypes in _SIGNATURES.items():
                fn = getattr(lib, name)
                fn.argtypes = argtypes
                fn.restype = ctypes.c_int
            _lib = lib
    return _lib


def check(err: int, name: str) -> None:
    """Raise if a C entry point reported a CUDA error for its launch."""
    if err != 0:
        raise RuntimeError(f"{name}: CUDA launch failed with error {err}")
