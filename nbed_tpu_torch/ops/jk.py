"""Fused J/K Fock build: the wrapper of ``csrc/fused_jk.cu`` and its plain
PyTorch version.

``fused_jk(g_j, g_k, dm)`` computes ``J = G_J vec(D_a + D_b)`` and
``K_s = G_K vec(D_s)``, the function of ``nbed_tpu/ops/pallas_jk.py::fused_jk``
(the reference's only Pallas kernel), in float32 or float64. Tensors on the
CPU take :func:`fused_jk_reference`; tensors on a CUDA device always launch
the hand-written kernel, which is built with ``nvcc`` for ``sm_90a`` into
``nbed_tpu_torch/_build`` at first use. There is no fallback: a CUDA call
that cannot build or launch the kernel raises.

A caller that contracts one pair of supermatrices many times (an SCF)
prepares it once with :func:`prepare_jk`: on CUDA a :class:`FusedJK`, which
checks G, resolves the C entry point and makes the launch :func:`plan` at
construction, so that a call checks only the density, allocates the output
and launches. The call does no host synchronisation, so it can be captured
in a CUDA graph.
"""

import ctypes
import os
import shutil
from collections import Counter
from dataclasses import dataclass
from functools import lru_cache
from pathlib import Path

import numpy as np
import torch

from .._compile import build_shared_library

__all__ = ["fused_jk", "fused_jk_reference", "prepare_jk", "FusedJK", "Plan", "plan",
           "split", "LAUNCHES", "LAUNCHES_BY_M", "build_kernels", "SMEM_MAX"]

_SRC = Path(__file__).resolve().parent.parent / "csrc" / "fused_jk.cu"
_NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
               "-shared", "-Xcompiler", "-fPIC"]

# launches made through the wrapper in this process, by dtype:
# "fused_jk_f64" and "fused_jk_f32"; and by (that key, M)
LAUNCHES: Counter = Counter()
LAUNCHES_BY_M: Counter = Counter()

# the launch plan's limits; they mirror the constants of csrc/fused_jk.cu
SMEM_MAX = 232448          # dynamic shared memory a block may use on the H100
_RING_OFFSET = 1024        # mbarriers and reduction scratch ahead of the ring
_RING_WARPS = 8            # consumer warps of a ring block (one more produces)
_VEC_WARPS = 8             # most warps of a vector-path block
_MAX_STAGE, _MIN_STAGE = 16384, 4096  # bytes of one stage of one matrix
# rows of at least this many bytes stream through the bulk-copy ring;
# shorter ones take 16-byte loads straight from device memory
RING_MIN_ROW_BYTES = 16384


@dataclass(frozen=True)
class Plan:
    """How one (M, M) J/K build is launched (``csrc/fused_jk.cu``'s Plan).

    ``path`` is "vector" (one warp per row, 16-byte loads from device
    memory), "ring" (densities resident in shared memory, G streamed
    through ``stages`` bulk-copy stages of ``seg_elems`` words per matrix)
    or "chunked" (the ring with the densities staged ``chunk_cols`` columns
    at a time, where all of them do not fit beside it). ``warps`` is the
    warps per block (the ring's consumers; a producer warp comes on top).
    """

    m: int
    word: int
    path: str
    grid: int
    warps: int
    stages: int = 0
    seg_elems: int = 0
    chunk_cols: int = 0
    smem_bytes: int = 0


def plan(m: int, word: int, sm_count: int, path: str = None,
         chunk_cols: int = None) -> Plan:
    """The launch plan of an (M, M) build in words of ``word`` bytes on a
    card of ``sm_count`` SMs. ``path`` forces a path (measurements, tests);
    ``chunk_cols`` forces the chunked path's density chunk."""
    if path is None:
        path = "vector" if m * word < RING_MIN_ROW_BYTES else "ring"
    if path == "vector":
        warps = min(_VEC_WARPS, -(-m // sm_count))
        # every warp of the grid resident at full occupancy (64 warps / SM)
        grid = min(-(-m // warps), (64 // warps) * sm_count)
        return Plan(m, word, "vector", grid, warps)
    if path not in ("ring", "chunked"):
        raise ValueError(f"unknown fused_jk path {path!r}")
    grid = min(m, sm_count)  # one block per SM: the ring fills its shared memory
    if path == "ring":
        avail = SMEM_MAX - _RING_OFFSET - 2 * m * word
        for stages in (4, 3):
            seg_bytes = min(_MAX_STAGE, avail // (2 * stages) // 128 * 128)
            if seg_bytes >= _MIN_STAGE:
                return Plan(m, word, "ring", grid, _RING_WARPS, stages, seg_bytes // word,
                            m, _RING_OFFSET + 2 * stages * seg_bytes + 2 * m * word)
        path = "chunked"  # the densities do not fit beside a ring of 3 stages
    # a smaller ring leaves wider density chunks (fewer passes over the rows)
    stages, seg_bytes = 4, _MAX_STAGE // 2
    if chunk_cols is None:
        chunk_cols = (SMEM_MAX - _RING_OFFSET - 2 * stages * seg_bytes) // (2 * word) // 32 * 32
    chunk_cols = min(chunk_cols, m)
    smem = _RING_OFFSET + 2 * stages * seg_bytes + 2 * chunk_cols * word
    if smem > SMEM_MAX:
        raise ValueError(f"fused_jk: a density chunk of {chunk_cols} columns does not fit")
    return Plan(m, word, "chunked", grid, _RING_WARPS, stages, seg_bytes // word, chunk_cols,
                smem)


def split(m: int, word: int, rows, c0: int, c1: int):
    """(head, body, tail) columns of columns [c0, c1) of each of ``rows``
    (an int array) of an (M, M) matrix with a 16-byte aligned base: scalars
    up to the first 16-byte boundary, whole 16-byte vectors, scalars. The
    host mirror of ``split`` in ``csrc/fused_jk.cu``."""
    vw = 16 // word
    start = np.asarray(rows, dtype=np.int64) * m + c0
    head = np.minimum((-start) % vw, c1 - c0)
    body = (c1 - c0 - head) // vw * vw
    return head, body, c1 - c0 - head - body


class _PlanC(ctypes.Structure):
    _fields_ = [("m", ctypes.c_int64), ("path", ctypes.c_int32), ("grid", ctypes.c_int32),
                ("warps", ctypes.c_int32), ("stages", ctypes.c_int32),
                ("seg_elems", ctypes.c_int32), ("chunk_cols", ctypes.c_int32),
                ("smem_bytes", ctypes.c_int32)]


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
                                               "libnbed_jk.so")))
    for name in ("nbed_jk_f64", "nbed_jk_f32"):
        fn = getattr(lib, name)
        fn.argtypes = [ctypes.c_void_p] * 6
        fn.restype = ctypes.c_int
    lib.nbed_jk_init.argtypes = []
    lib.nbed_jk_init.restype = ctypes.c_int
    return lib


@lru_cache(maxsize=None)
def _init_device(index: int) -> int:
    """Raise the ring kernels' shared memory limit on device ``index``;
    returns its SM count."""
    lib = build_kernels()
    with torch.cuda.device(index):
        err = lib.nbed_jk_init()
    if err != 0:
        raise RuntimeError(f"fused_jk kernel set-up failed with CUDA error {err}")
    return torch.cuda.get_device_properties(index).multi_processor_count


def fused_jk_reference(g_j, g_k, dm):
    """Plain PyTorch J/K: the same products as ``run_scf``'s default
    ``get_jk`` in ``nbed_tpu/scf/hf.py:195-199``."""
    n = dm.shape[-1]
    j = (g_j @ (dm[0] + dm[1]).reshape(-1)).reshape(n, n)
    k = (g_k @ dm.reshape(2, n * n).T).T.reshape(2, n, n)
    return j, k


class FusedJK:
    """The fused J/K kernel prepared for one pair of CUDA supermatrices.

    Construction checks G (shape (M, M) with M = nao^2, one CUDA device, one
    dtype of float32 or float64, contiguous, 16-byte aligned), builds the
    kernel library, and fixes the entry point, the device and the launch
    :func:`plan` (``path`` forces one; see :func:`plan`). A call ``jk(dm)``
    takes (2, nao, nao) densities of G's dtype and device, contiguous, and
    returns (J (nao, nao), K (2, nao, nao)), views of one new output. A call
    launches without a device guard when the current device is G's.
    """

    def __init__(self, g_j, g_k, path: str = None, chunk_cols: int = None):
        m = g_j.shape[0] if g_j.ndim == 2 else -1
        nao = int(round(m ** 0.5)) if m > 0 else 0
        if g_j.ndim != 2 or g_j.shape[1] != m or nao * nao != m:
            raise ValueError(f"g_j must be (M, M) with M = nao^2, got {tuple(g_j.shape)}")
        if tuple(g_k.shape) != (m, m):
            raise ValueError(f"g_k must be ({m}, {m}) as g_j, got {tuple(g_k.shape)}")
        if g_j.dtype not in (torch.float32, torch.float64) or g_k.dtype != g_j.dtype:
            raise TypeError("fused_jk takes float32 or float64 supermatrices of one "
                            f"dtype, got {g_j.dtype} and {g_k.dtype}")
        if g_j.device.type != "cuda" or g_k.device != g_j.device:
            raise ValueError("fused_jk: g_j and g_k must lie on one CUDA device, "
                             f"got {g_j.device} and {g_k.device}")
        if not (g_j.is_contiguous() and g_k.is_contiguous()):
            raise ValueError("fused_jk needs contiguous supermatrices")
        if g_j.data_ptr() % 16 or g_k.data_ptr() % 16:
            raise ValueError("fused_jk needs 16-byte aligned supermatrices")
        self.g_j, self.g_k = g_j, g_k  # kept alive: the kernel reads their memory
        self.dtype, self.device = g_j.dtype, g_j.device
        self._index = g_j.device.index
        self.plan = plan(m, g_j.element_size(), _init_device(self._index), path, chunk_cols)
        self._cplan = _PlanC(m, 0 if self.plan.path == "vector" else 1, self.plan.grid,
                             self.plan.warps, self.plan.stages, self.plan.seg_elems,
                             self.plan.chunk_cols, self.plan.smem_bytes)
        self._cplan_ptr = ctypes.addressof(self._cplan)
        f64 = g_j.dtype == torch.float64
        self._fn = build_kernels().nbed_jk_f64 if f64 else build_kernels().nbed_jk_f32
        self._key = "fused_jk_f64" if f64 else "fused_jk_f32"
        self._key_m = (self._key, m)
        self._ptrs = (g_j.data_ptr(), g_k.data_ptr())
        self._dm_shape = (2, nao, nao)
        # a fresh output per call, allocated like this template (measured
        # cheaper on the host than torch.empty with shape, dtype and device)
        self._out_like = torch.empty((3, nao, nao), dtype=g_j.dtype, device=g_j.device)

    def __call__(self, dm):
        if not (dm.shape == self._dm_shape and dm.dtype == self.dtype
                and dm.device == self.device and dm.is_contiguous()):
            raise ValueError(f"fused_jk: dm must be a contiguous {self.dtype} tensor of "
                             f"shape {self._dm_shape} on {self.device}, got {dm.dtype} "
                             f"{tuple(dm.shape)} on {dm.device}")
        out = torch.empty_like(self._out_like)
        # the raw handle of torch's current stream on the device, without the
        # Stream object that torch.cuda.current_stream builds (a few µs)
        stream = torch._C._cuda_getCurrentRawStream(self._index)
        if torch.cuda.current_device() == self._index:
            err = self._fn(*self._ptrs, dm.data_ptr(), out.data_ptr(), self._cplan_ptr,
                           stream)
        else:
            with torch.cuda.device(self._index):
                err = self._fn(*self._ptrs, dm.data_ptr(), out.data_ptr(),
                               self._cplan_ptr, stream)
        if err != 0:
            raise RuntimeError(f"fused_jk kernel launch failed with CUDA error {err}")
        LAUNCHES[self._key] += 1
        LAUNCHES_BY_M[self._key_m] += 1
        return out[0], out[1:]


def prepare_jk(g_j, g_k):
    """``dm -> (J, K)`` for one pair of supermatrices: a :class:`FusedJK` on
    CUDA, the plain version on the CPU."""
    if g_j.device.type == "cpu" and g_k.device.type == "cpu":
        return lambda dm: fused_jk_reference(g_j, g_k, dm)
    return FusedJK(g_j, g_k)


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
    return FusedJK(g_j, g_k)(dm)
