"""Fused J/K Fock build: the wrapper of ``csrc/fused_jk.cu`` and its plain
PyTorch version.

``fused_jk(g_j, g_k, dm)`` computes ``J = G_J vec(D_a + D_b)`` and
``K_s = G_K vec(D_s)``, the function of ``nbed_tpu/ops/pallas_jk.py::fused_jk``
(the reference's only Pallas kernel), in float32 or float64. Tensors on the
CPU take :func:`fused_jk_reference`; tensors on a CUDA device always launch
the hand-written kernel, which is built with ``nvcc`` for ``sm_90a`` into
``nbed_tpu_torch/_build`` at first use. There is no fallback: a CUDA call
that cannot build or launch the kernel raises.
"""

import ctypes
import os
import shutil
from collections import Counter
from functools import lru_cache
from pathlib import Path

import torch

from .._compile import build_shared_library

__all__ = ["fused_jk", "fused_jk_reference", "LAUNCHES", "build_kernels"]

_SRC = Path(__file__).resolve().parent.parent / "csrc" / "fused_jk.cu"
_NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
               "-shared", "-Xcompiler", "-fPIC"]

# launches made through the wrapper in this process, by dtype:
# "fused_jk_f64" and "fused_jk_f32"
LAUNCHES: Counter = Counter()


def _nvcc() -> str:
    for root in (os.environ.get("CUDA_HOME"), "/usr/local/cuda"):
        if root and Path(root, "bin", "nvcc").is_file():
            return str(Path(root, "bin", "nvcc"))
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError("nvcc not found: the CUDA kernels cannot be built")
    return found


@lru_cache(maxsize=1)
def build_kernels() -> ctypes.CDLL:
    """Build (if stale) and load the kernel library."""
    lib = ctypes.CDLL(str(build_shared_library([_nvcc(), *_NVCC_FLAGS], _SRC,
                                               "libnbed_fused_jk.so")))
    for name in ("nbed_fused_jk_f64", "nbed_fused_jk_f32"):
        fn = getattr(lib, name)
        fn.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int64, ctypes.c_void_p]
        fn.restype = ctypes.c_int
    return lib


def fused_jk_reference(g_j, g_k, dm):
    """Plain PyTorch J/K: the same products as ``run_scf``'s default
    ``get_jk`` in ``nbed_tpu/scf/hf.py:195-199``."""
    n = dm.shape[-1]
    j = (g_j @ (dm[0] + dm[1]).reshape(-1)).reshape(n, n)
    k = (g_k @ dm.reshape(2, n * n).T).T.reshape(2, n, n)
    return j, k


def _check(g_j, g_k, dm):
    if dm.ndim != 3 or dm.shape[0] != 2 or dm.shape[1] != dm.shape[2]:
        raise ValueError(f"dm must be (2, nao, nao), got {tuple(dm.shape)}")
    m = dm.shape[-1] ** 2
    for name, g in (("g_j", g_j), ("g_k", g_k)):
        if tuple(g.shape) != (m, m):
            raise ValueError(f"{name} must be ({m}, {m}), got {tuple(g.shape)}")
    tensors = (g_j, g_k, dm)
    if any(t.device != dm.device for t in tensors) or dm.device.type != "cuda":
        raise ValueError("fused_jk: g_j, g_k and dm must lie on one CUDA device")
    if dm.dtype not in (torch.float32, torch.float64) or \
            any(t.dtype != dm.dtype for t in tensors):
        raise TypeError("fused_jk takes float32 or float64 tensors of one dtype, "
                        f"got {[str(t.dtype) for t in tensors]}")
    if not all(t.is_contiguous() for t in tensors):
        raise ValueError("fused_jk needs contiguous tensors")


def fused_jk(g_j, g_k, dm):
    """Fused Coulomb/exchange build.

    Args:
        g_j: (M, M) Coulomb supermatrix (ij|kl), M = nao^2.
        g_k: (M, M) exchange supermatrix (ik|jl).
        dm: (2, nao, nao) spin densities.

    Returns:
        (j, k): j (nao, nao); k (2, nao, nao), in the dtype of the inputs.
    """
    if all(t.device.type == "cpu" for t in (g_j, g_k, dm)):
        return fused_jk_reference(g_j, g_k, dm)
    _check(g_j, g_k, dm)
    lib = build_kernels()
    fn = lib.nbed_fused_jk_f64 if dm.dtype == torch.float64 else lib.nbed_fused_jk_f32
    n = dm.shape[-1]
    m = n * n
    out = torch.empty((3, m), dtype=dm.dtype, device=dm.device)
    with torch.cuda.device(dm.device):
        stream = torch.cuda.current_stream(dm.device).cuda_stream
        err = fn(g_j.data_ptr(), g_k.data_ptr(), dm.data_ptr(), out.data_ptr(),
                 m, stream)
    if err != 0:
        raise RuntimeError(f"fused_jk kernel launch failed with CUDA error {err}")
    LAUNCHES["fused_jk_f64" if dm.dtype == torch.float64 else "fused_jk_f32"] += 1
    return out[0].reshape(n, n), out[1:].reshape(2, n, n)
