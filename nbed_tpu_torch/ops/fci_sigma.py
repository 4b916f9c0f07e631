"""The gather and scatter steps of the matrix-free FCI product on a CUDA
device: the wrapper of ``csrc/fci_sigma.cu`` and the steps' plain versions.

``solvers/fci_direct.py`` computes sigma = H c over alpha/beta strings; its
alpha-beta part runs in blocks of source alpha rows [lo, hi), each
:func:`gather` (Y[j, qr, Ib] = sum_Jb <Ib|Eb_qr|Jb> C[lo + j, Jb]), a
cuBLAS ``torch.bmm`` and :func:`scatter` (sigma[Ia, :] += the signed rows of
Z that reach Ia). The tables fold each sign into the entry as
``(index + 1) * sign`` (int32, 0 for none); see the source's header.

A CUDA tensor launches the hand-written kernel, built with ``nvcc`` for
``sm_90a`` into ``nbed_tpu_torch/_build`` at first use; a CPU tensor takes
the plain version (:func:`gather_reference`, :func:`scatter_reference`),
which the CPU tests use and ``chip_smoke.py`` holds the kernels to. There is
no fallback: a CUDA call that cannot build or launch raises. The reference
package builds a sparse matrix on the host instead; no TPU kernel is
replaced.
"""

import ctypes
from collections import Counter
from functools import lru_cache
from pathlib import Path

import torch

from .._compile import build_shared_library
from .jk import _NVCC_FLAGS, _nvcc, count_launch

__all__ = ["gather", "scatter", "gather_reference", "scatter_reference", "LAUNCHES",
           "LAUNCHES_BY_SHAPE", "build_library"]

_SRC = Path(__file__).resolve().parent.parent / "csrc" / "fci_sigma.cu"

# launches through the wrappers in this process: "fci_sigma_gather" and
# "fci_sigma_scatter"; and by (that key, na, nb, b, npair, nlink): alpha and
# beta strings, rows of the block, orbital pairs, links of an alpha string
LAUNCHES: Counter = Counter()
LAUNCHES_BY_SHAPE: Counter = Counter()

# a grid's y and z extents
_GRID_MAX = 65535


@lru_cache(maxsize=1)
def build_library() -> ctypes.CDLL:
    """Build (if stale) and load ``csrc/fci_sigma.cu``."""
    lib = ctypes.CDLL(str(build_shared_library([_nvcc(), *_NVCC_FLAGS], _SRC,
                                               "libnbed_fci_sigma.so")))
    ptr, i64 = ctypes.c_void_p, ctypes.c_int64
    lib.nbed_fci_sigma_gather.argtypes = [ptr, i64, i64, i64, ctypes.c_int, ptr, ptr, ptr]
    lib.nbed_fci_sigma_gather.restype = ctypes.c_int
    lib.nbed_fci_sigma_scatter.argtypes = [ptr, i64, i64, i64, i64, ctypes.c_int, ptr, ptr,
                                           ptr]
    lib.nbed_fci_sigma_scatter.restype = ctypes.c_int
    return lib


def _unpack(table):
    """(index, sign) of a signed table: index clamped to 0 where empty."""
    sign = torch.sign(table).to(torch.float64)
    return (table.abs().long() - 1).clamp(min=0), sign


def gather_reference(c, lo: int, b: int, table_b):
    """Y (b, npair, nb) of rows [lo, lo + b) of C (na, nb) in plain torch."""
    index, sign = _unpack(table_b)
    return c[lo:lo + b][:, index] * sign


def scatter_reference(z, lo: int, hi: int, table_a, sigma):
    """sigma (na, nb) += the block's Z (hi - lo, nlink, nb), plain torch."""
    nlink = table_a.shape[1]
    flat, sign = _unpack(table_a)
    inside = (flat >= lo * nlink) & (flat < hi * nlink)
    rows = z.reshape(-1, z.shape[-1])[(flat - lo * nlink).clamp(0, z.shape[0] * nlink - 1)]
    sigma += torch.einsum("am,amb->ab", sign * inside, rows)
    return sigma


def _stream(t):
    index = t.device.index if t.device.index is not None else torch.cuda.current_device()
    return torch._C._cuda_getCurrentRawStream(index)


def _check(name, tensors):
    """All float64/int32 operands contiguous on one CUDA device."""
    device = tensors[0].device
    for t in tensors:
        if t.device != device or not t.is_contiguous() or \
                t.dtype not in (torch.float64, torch.int32):
            raise ValueError(f"{name}: expected contiguous float64 data and int32 tables on "
                             f"one CUDA device, got {t.dtype} {tuple(t.shape)} on {t.device}")


def gather(c, lo: int, b: int, table_b):
    """Y (b, npair, nb) float64 of source alpha rows [lo, lo + b) of C."""
    if c.device.type != "cuda":
        return gather_reference(c, lo, b, table_b)
    na, nb = c.shape
    npair = table_b.shape[0]
    if not (c.dtype == torch.float64 and table_b.dtype == torch.int32
            and table_b.shape == (npair, nb) and 0 <= lo and lo + b <= na
            and 0 < b <= _GRID_MAX and npair <= _GRID_MAX):
        raise ValueError(f"fci_sigma gather: C {c.dtype} {tuple(c.shape)}, table "
                         f"{table_b.dtype} {tuple(table_b.shape)}, rows [{lo}, {lo + b})")
    _check("fci_sigma gather", (c, table_b))
    y = torch.empty((b, npair, nb), dtype=torch.float64, device=c.device)
    err = build_library().nbed_fci_sigma_gather(c.data_ptr(), nb, lo, b, npair,
                                                table_b.data_ptr(), y.data_ptr(), _stream(c))
    if err != 0:
        raise RuntimeError(f"fci_sigma gather: launch failed with status {err}")
    count_launch(LAUNCHES, "fci_sigma_gather")
    count_launch(LAUNCHES_BY_SHAPE, ("fci_sigma_gather", na, nb, b, npair, 0))
    return y


def scatter(z, lo: int, hi: int, table_a, sigma):
    """sigma (na, nb) += the block [lo, hi)'s Z (hi - lo, nlink, nb), in
    place; returns sigma."""
    if sigma.device.type != "cuda":
        return scatter_reference(z, lo, hi, table_a, sigma)
    na, nb = sigma.shape
    nlink = table_a.shape[1]
    if not (z.dtype == sigma.dtype == torch.float64 and table_a.dtype == torch.int32
            and z.shape == (hi - lo, nlink, nb) and table_a.shape == (na, nlink)
            and 0 <= lo < hi and na <= _GRID_MAX):
        raise ValueError(f"fci_sigma scatter: Z {z.dtype} {tuple(z.shape)}, table "
                         f"{table_a.dtype} {tuple(table_a.shape)}, sigma {sigma.dtype} "
                         f"{tuple(sigma.shape)}, rows [{lo}, {hi})")
    _check("fci_sigma scatter", (z, table_a, sigma))
    err = build_library().nbed_fci_sigma_scatter(z.data_ptr(), na, nb, lo, hi, nlink,
                                                 table_a.data_ptr(), sigma.data_ptr(),
                                                 _stream(sigma))
    if err != 0:
        raise RuntimeError(f"fci_sigma scatter: launch failed with status {err}")
    count_launch(LAUNCHES, "fci_sigma_scatter")
    count_launch(LAUNCHES_BY_SHAPE, ("fci_sigma_scatter", na, nb, hi - lo, 0, nlink))
    return sigma
