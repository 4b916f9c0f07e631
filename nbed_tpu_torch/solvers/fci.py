"""Exact diagonalisation in a fixed (n_alpha, n_beta) determinant sector
(port of ``nbed_tpu/solvers/fci.py``).

Operates directly on interleaved spin-orbital tensors
``H = const + sum h1[p,q] a+_p a_q + sum h2[p,q,r,s] a+_p a+_q a_r a_s``
(the :class:`nbed_tpu_torch.ham.HamiltonianBuilder` output). :func:`run_fci`
takes one of three routes, by the device its tensors lie on and, on a card,
by the sector's size:

- "card": h1 on a CUDA device and a sector of at most :data:`DENSE_MAX`
  determinants. The hand-written kernel ``csrc/fci_hamiltonian.cu``
  (:func:`nbed_tpu_torch.ops.fci_hamiltonian.sector_matrix`) writes the
  dense sector matrix from h1 and h2 where they lie, and cuSOLVER's dense
  symmetric solver (``torch.linalg.eigvalsh``) diagonalises it; the lowest
  k eigenvalues are the one host read.
- "matrix_free": h1 on a CUDA device and a larger sector, or one whose
  dense matrix does not fit: :mod:`nbed_tpu_torch.solvers.fci_direct`, a
  Davidson solve over sigma = H c in the alpha/beta string factorisation
  (hand kernels ``csrc/fci_sigma.cu`` and cuBLAS), with nothing of the
  sector's matrix stored. It takes spin-conserving terms only, so a larger
  sector whose terms mix spins stays on the card route where its dense
  matrix fits. A sector that neither route can run in the card's free
  memory raises ``torch.OutOfMemoryError``: nothing of a CUDA call moves to
  the host.
- "host": h1 on the CPU (or a numpy array), as the reference does it:
  :func:`sector_hamiltonian` builds the sparse matrix with vectorised
  bitstring arithmetic over the determinant basis, one pass per nonzero
  term, and numpy (or ``eigsh`` above 600 determinants) diagonalises it.

:data:`ROUTES` counts the calls by route; spans ``fci.build`` and
``fci.eigh`` time the two steps of the dense and host routes, ``fci.tables``,
``fci.davidson`` and ``fci.sigma`` those of the matrix-free one, whose
products :data:`SIGMAS` counts.
"""

from collections import Counter
from functools import lru_cache
from itertools import combinations
from math import comb

import numpy as np
import torch
from scipy.sparse import coo_matrix, identity
from scipy.sparse.linalg import eigsh

from .._device import to_host
from ..ops.fci_hamiltonian import sector_matrix
from ..profiling import span
from .fci_direct import (BLOCK_BYTES, SIGMAS, direct_bytes, product_bits, run_direct,
                         spin_mixing)

__all__ = ["run_fci", "sector_hamiltonian", "sector_basis", "ROUTES", "SIGMAS", "DENSE_MAX"]

# run_fci calls in this process by route: "card", "matrix_free" and "host"
ROUTES: Counter = Counter()

# the largest sector the card route writes densely where it fits: above it
# the matrix-free route is the faster. Lowest eigenvalue, seeded
# spin-conserving terms (chip_smoke.spin_conserving_terms), H100 80GB HBM3
# at 700 W, dense / matrix-free ms: D = 100 0.9 / 28-65, 441 4.5 / 61-152,
# 1225 14.6 / 107, 3136 69 / 109, 3920 112-114 / 98-202, 7056 436 / 185,
# 15876 3216 / 90: the dense route's D^3 meets the Davidson's ~50-100
# products of 1-2 ms near D = 4000
DENSE_MAX = 4096


def sector_basis(n_spinorb: int, nelec: tuple) -> np.ndarray:
    """All determinant bitstrings with n_alpha on even and n_beta on odd
    spin orbitals (interleaved convention), sorted ascending."""
    na, nb = nelec
    evens = list(range(0, n_spinorb, 2))
    odds = list(range(1, n_spinorb, 2))
    states = []
    for occ_a in combinations(evens, na):
        bits_a = sum(1 << p for p in occ_a)
        for occ_b in combinations(odds, nb):
            states.append(bits_a + sum(1 << p for p in occ_b))
    return np.array(sorted(states), dtype=np.int64)


def _parity_below(states, p):
    """(-1)^(number of occupied modes below p) per state."""
    x = states & ((1 << p) - 1)
    # popcount of int64 arrays
    x = x - ((x >> 1) & 0x5555555555555555)
    x = (x & 0x3333333333333333) + ((x >> 2) & 0x3333333333333333)
    x = (x + (x >> 4)) & 0x0F0F0F0F0F0F0F0F
    cnt = (x * 0x0101010101010101) >> 56
    return 1.0 - 2.0 * (cnt & 1)


def _apply_annihilate(states, signs, p):
    keep = ((states >> p) & 1) == 1
    return states ^ (1 << p), signs * _parity_below(states, p), keep


def _apply_create(states, signs, p):
    keep = ((states >> p) & 1) == 0
    return states | (1 << p), signs * _parity_below(states, p), keep


def sector_hamiltonian(constant, h1, h2, n_spinorb: int, nelec: tuple):
    """Sparse Hamiltonian in the fixed-particle-number determinant sector.

    A create on an occupied mode (or an annihilate on an empty one) is
    masked out; the keep masks compose because each step acts on the
    already-updated bitstring."""
    basis = sector_basis(n_spinorb, nelec)
    dim = len(basis)
    rows, cols, data = [], [], []

    def emit(new_states, amp, keep):
        ns = new_states[keep]
        idx = np.clip(np.searchsorted(basis, ns), 0, dim - 1)
        valid = basis[idx] == ns  # guards spin-sector-breaking terms
        rows.append(idx[valid])
        cols.append(np.nonzero(keep)[0][valid])
        data.append(amp[keep][valid])

    h1 = to_host(h1)
    for p, q in zip(*np.nonzero(np.abs(h1) > 1e-14)):
        st, sg, k1 = _apply_annihilate(basis, np.ones(dim), int(q))
        st, sg, k2 = _apply_create(st, sg, int(p))
        emit(st, h1[p, q] * sg, k1 & k2 if int(p) != int(q) else k1)

    h2 = to_host(h2)
    for p, q, r, s in zip(*np.nonzero(np.abs(h2) > 1e-14)):
        p, q, r, s = int(p), int(q), int(r), int(s)
        if p == q or r == s:
            continue  # a+_p a+_p = 0
        st, sg = basis, np.ones(dim)
        st, sg, k1 = _apply_annihilate(st, sg, s)
        st, sg, k2 = _apply_annihilate(st, sg, r)
        st, sg, k3 = _apply_create(st, sg, q)
        st, sg, k4 = _apply_create(st, sg, p)
        emit(st, h2[p, q, r, s] * sg, k1 & k2 & k3 & k4)

    ham = coo_matrix(
        (np.concatenate(data), (np.concatenate(rows), np.concatenate(cols))),
        shape=(dim, dim),
    ).tocsr()
    if constant:
        ham = ham + float(constant) * identity(dim, format="csr")
    return ham, basis


def _sector_dim(n_spinorb: int, nelec) -> int:
    """Number of determinants of :func:`sector_basis`."""
    return comb(len(range(0, n_spinorb, 2)), nelec[0]) * comb(n_spinorb // 2, nelec[1])


def _card_route(device: torch.device) -> bool:
    """Whether tensors on ``device`` take the card route."""
    return device.type == "cuda"


def _dense_bytes(dim: int) -> int:
    """Device bytes of the card route at ``dim`` determinants: the float64
    matrix and the copy of it that ``eigvalsh`` factorises."""
    return 2 * dim * dim * 8


def _check_fits(n_spinorb: int, nelec: tuple, k: int, free_bytes: int, device,
                mixes_spins: bool = False) -> str:
    """The route of a CUDA call in the card's ``free_bytes``: "card" where
    the dense matrix fits and the sector has at most :data:`DENSE_MAX`
    determinants or terms that mix spins, else "matrix_free" where it fits
    and the terms conserve spin; raises ``torch.OutOfMemoryError`` where
    neither route can run."""
    dim = _sector_dim(n_spinorb, nelec)
    dense = _dense_bytes(dim)
    if dense <= free_bytes and (dim <= DENSE_MAX or mixes_spins):
        return "card"
    direct = direct_bytes(n_spinorb // 2, nelec, k)
    if direct <= free_bytes and not mixes_spins:
        return "matrix_free"
    why = ("its terms mix spins, which the matrix-free route does not take" if mixes_spins
           else f"its matrix-free Davidson solve needs {direct / 2**30:.2f} GiB")
    raise torch.OutOfMemoryError(
        f"run_fci: a sector of {dim} determinants needs {dense / 2**30:.2f} GiB on {device} "
        f"as a dense matrix (the card route) and {why}; {free_bytes / 2**30:.2f} GiB are "
        f"free; the host route (integrals on the CPU) stores its sparse matrix, larger still")


def _free_bytes(device: torch.device) -> int:
    """The card's free memory plus what PyTorch's allocator holds unused."""
    free, _ = torch.cuda.mem_get_info(device)
    return free + torch.cuda.memory_reserved(device) - torch.cuda.memory_allocated(device)


@lru_cache(maxsize=32)
def _device_basis(n_spinorb: int, nelec: tuple, device: torch.device):
    """(:func:`sector_basis`, read-only, and its copy on ``device``), made
    once per sector and device."""
    basis = sector_basis(n_spinorb, nelec)
    on_device = torch.as_tensor(basis, device=device)
    basis.setflags(write=False)
    return basis, on_device


@lru_cache(maxsize=8)
def _product_basis(n_spinorb: int, nelec: tuple) -> np.ndarray:
    """:func:`sector_basis` (read-only) from the strings of each spin, made
    once per sector: the matrix-free route's sectors are millions of
    determinants."""
    basis = np.sort(product_bits(n_spinorb // 2, nelec).ravel())
    basis.setflags(write=False)
    return basis


def run_fci(constant, h1, h2, n_spinorb: int, nelec: tuple, k: int = 1):
    """Lowest-k eigenvalues of the sector Hamiltonian (ascending numpy) and
    the basis bitstrings (numpy); ``h2`` is the HamiltonianBuilder's
    ``0.5*h2`` coefficient tensor. h1 on a CUDA device takes the card or
    the matrix-free route, h1 on the CPU the host route (module
    docstring)."""
    nelec = (int(nelec[0]), int(nelec[1]))
    if isinstance(h1, torch.Tensor) and _card_route(h1.device):
        free = _free_bytes(h1.device)
        mixes = _sector_dim(n_spinorb, nelec) > DENSE_MAX and any(spin_mixing(h1, h2))
        route = _check_fits(n_spinorb, nelec, k, free, h1.device, mixes)
        ROUTES[route] += 1
        if route == "matrix_free":
            # the blocks take at most what the card has beyond the route's least
            block = min(BLOCK_BYTES, free - direct_bytes(n_spinorb // 2, nelec, k))
            vals = run_direct(constant, h1, h2, n_spinorb, nelec, k, block)
            return vals, _product_basis(n_spinorb, nelec)
        with span("fci.build"):
            basis, basis_dev = _device_basis(n_spinorb, nelec, h1.device)
            ham = sector_matrix(constant, h1, h2, basis_dev)
        with span("fci.eigh"):
            vals = torch.linalg.eigvalsh(ham)[:k].cpu().numpy()
        return vals, basis
    ROUTES["host"] += 1
    with span("fci.build"):
        ham, basis = sector_hamiltonian(constant, h1, h2, n_spinorb, nelec)
    with span("fci.eigh"):
        if ham.shape[0] <= 600:
            vals = np.linalg.eigvalsh(ham.toarray())[:k]
        else:
            vals = np.sort(eigsh(ham, k=k, which="SA", return_eigenvectors=False))
    return vals, basis
