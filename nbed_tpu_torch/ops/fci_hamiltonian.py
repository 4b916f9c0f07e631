"""The dense Hamiltonian of a fixed-(n_alpha, n_beta) determinant sector on a
CUDA device: the wrapper of ``csrc/fci_hamiltonian.cu``.

``sector_matrix(constant, h1, h2, basis)`` writes the (D, D) float64 matrix
``H[I, J] = <I| constant + sum h1[p,q] a+_p a_q + sum h2[p,q,r,s] a+_p a+_q
a_r a_s |J>`` over the D determinant bitstrings ``basis`` (interleaved spin
orbitals, as ``solvers.fci.sector_basis`` orders them), the matrix that
``solvers.fci.sector_hamiltonian`` builds term by term on the host. Every
operator string connecting I and J is summed, with the sign of applying it
to J in the host's order (annihilate s, then r, create q, then p), so no
symmetry of h1 or h2 is assumed.

The hand-written kernel is built with ``nvcc`` for ``sm_90a`` into
``nbed_tpu_torch/_build`` at first use. There is no fallback: a call that
cannot build or launch raises, and tensors on another device are refused.
The reference builds this matrix on the host (``nbed_tpu/solvers/fci.py``);
no TPU kernel is replaced.
"""

import ctypes
from collections import Counter
from functools import lru_cache
from pathlib import Path

import torch

from .._compile import build_shared_library
from .jk import _NVCC_FLAGS, _nvcc, count_launch

__all__ = ["sector_matrix", "LAUNCHES", "build_library"]

_SRC = Path(__file__).resolve().parent.parent / "csrc" / "fci_hamiltonian.cu"

# launches through the wrapper in this process: "fci_hamiltonian"
LAUNCHES: Counter = Counter()

# the bitstrings are 64-bit words
_MAX_SPINORB = 64


@lru_cache(maxsize=1)
def build_library() -> ctypes.CDLL:
    """Build (if stale) and load ``csrc/fci_hamiltonian.cu``."""
    lib = ctypes.CDLL(str(build_shared_library([_nvcc(), *_NVCC_FLAGS], _SRC,
                                               "libnbed_fci.so")))
    ptr = ctypes.c_void_p
    lib.nbed_fci_hamiltonian.argtypes = [ptr, ctypes.c_int64, ctypes.c_int, ptr, ptr,
                                         ctypes.c_double, ptr, ptr]
    lib.nbed_fci_hamiltonian.restype = ctypes.c_int
    return lib


def sector_matrix(constant, h1, h2, basis):
    """The (D, D) float64 sector matrix on h1's device, from float64 ``h1``
    (n, n), ``h2`` (n, n, n, n) and the int64 bitstrings ``basis`` (D,), all
    on one CUDA device."""
    n, dim = h1.shape[0], basis.numel()
    if not (h1.shape == (n, n) and h2.shape == (n, n, n, n) and n <= _MAX_SPINORB
            and h1.dtype == h2.dtype == torch.float64 and basis.dtype == torch.int64
            and h1.device.type == "cuda" and h1.device == h2.device == basis.device):
        raise ValueError(
            f"sector_matrix: expected float64 h1 (n, n) and h2 (n, n, n, n) with n <= "
            f"{_MAX_SPINORB} and int64 basis on one CUDA device, got h1 {h1.dtype} "
            f"{tuple(h1.shape)} on {h1.device}, h2 {h2.dtype} {tuple(h2.shape)} on "
            f"{h2.device}, basis {basis.dtype} on {basis.device}")
    h1, h2, basis = h1.contiguous(), h2.contiguous(), basis.contiguous()
    out = torch.empty((dim, dim), dtype=torch.float64, device=h1.device)
    index = h1.device.index if h1.device.index is not None else torch.cuda.current_device()
    stream = torch._C._cuda_getCurrentRawStream(index)
    err = build_library().nbed_fci_hamiltonian(basis.data_ptr(), dim, n, h1.data_ptr(),
                                               h2.data_ptr(), float(constant),
                                               out.data_ptr(), stream)
    if err != 0:
        raise RuntimeError(f"fci_hamiltonian: launch failed with status {err}")
    count_launch(LAUNCHES, "fci_hamiltonian")
    return out

