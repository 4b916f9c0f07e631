"""Exact diagonalisation in a fixed (n_alpha, n_beta) determinant sector
(port of ``nbed_tpu/solvers/fci.py``, host numpy/scipy).

Operates directly on interleaved spin-orbital tensors
``H = const + sum h1[p,q] a+_p a_q + sum h2[p,q,r,s] a+_p a+_q a_r a_s``
(the :class:`nbed_tpu_torch.ham.HamiltonianBuilder` output), with
vectorised bitstring arithmetic over the determinant basis. Tensors given
here are copied to host numpy first.
"""

from itertools import combinations

import numpy as np
from scipy.sparse import coo_matrix, identity
from scipy.sparse.linalg import eigsh

from .._device import to_host

__all__ = ["run_fci", "sector_hamiltonian", "sector_basis"]


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


def run_fci(constant, h1, h2, n_spinorb: int, nelec: tuple, k: int = 1):
    """Lowest-k eigenvalues of the sector Hamiltonian (ascending) and the
    basis bitstrings; ``h2`` is the HamiltonianBuilder's ``0.5*h2``
    coefficient tensor."""
    ham, basis = sector_hamiltonian(constant, h1, h2, n_spinorb, nelec)
    if ham.shape[0] <= 600:
        vals = np.linalg.eigvalsh(ham.toarray())[:k]
    else:
        vals = np.sort(eigsh(ham, k=k, which="SA", return_eigenvectors=False))
    return vals, basis
