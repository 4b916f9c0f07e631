"""Quantum subspace expansion (QSE) excited states on a VQE state (port of
``nbed_tpu/solvers/qse.py``).

Given a prepared state |psi> (the VQE's ansatz at its amplitudes, or the
reference determinant), the mapped Hamiltonian is diagonalised in
span{O_I |psi>}, O_I in {identity} + fermionic singles (+ doubles), by the
generalised eigenproblem M w = E S w with M_IJ = <psi|O_I^dag H O_J|psi> and
S_IJ = <psi|O_I^dag O_J|psi> (McClean et al., PRA 95, 042308 (2017)).

The statevectors O_I |psi> are complex128 on the device; H phi goes through
the VQE's blocks of X masks (``vqe._apply_hamiltonian``), on the real and
imaginary parts of phi (H is real). The subspace problem (tens of
operators) is solved on the host in complex128, as in the reference.
"""

from dataclasses import dataclass

import numpy as np
import torch

from .._device import resolve_device, to_host
from ..ham.qubit import MAPPINGS, _ladder_factory
from .vqe import (_apply_hamiltonian, _operator_terms, _program, uccsd_excitations,
                  vqe_statevector)

__all__ = ["run_qse", "QSEResult"]


@dataclass
class QSEResult:
    """QSE spectrum. ``energies`` are absolute (Ha, ascending) eigenvalues
    of the subspace problem; ``excitations = energies - energies[0]``.
    ``weights[r]`` expands root r over the operator pool (column 0 is the
    identity; then the pool order)."""

    energies: np.ndarray
    excitations: np.ndarray
    weights: np.ndarray
    n_operators: int
    n_retained: int  # after S-canonical orthogonalisation
    s_min_eig: float


def _apply_terms(terms, prog, psi):
    """``sum_t c_t X^x Z^z psi`` for ``terms`` {(x, z): c}: ``out[j] +=
    c (-1)^parity((j ^ x) & z) psi[j ^ x]``."""
    out = torch.zeros_like(psi)
    for (x, z), c in terms.items():
        out += c * prog.apply_string(psi, x, z)
    return out


def run_qse(constant, h1, h2, nelec, mapping: str = "jw", params=None,
            ansatz_excitations=None, pool: str = "singles",
            nroots: int | None = None, s_tol: float = 1e-8,
            device="cuda") -> QSEResult:
    """Quantum subspace expansion on (a VQE state over) the Hamiltonian.

    Args:
        constant, h1, h2: the driver's ``second_quantised`` output.
        nelec: ``(n_alpha, n_beta)`` active electrons.
        mapping: fermion-to-qubit encoding ("jw" | "bk" | "parity").
        params: VQE amplitudes to prepare |psi> (None: the reference
            determinant, where singles-QSE is CIS).
        ansatz_excitations: the excitation list the amplitudes refer to.
        pool: "singles" or "sd", the expansion operators (the identity is
            always included).
        nroots: truncate the returned spectrum.
        s_tol: relative overlap-eigenvalue cutoff of the canonical
            orthogonalisation of the (generally singular) subspace.
        device: where the statevectors live.
    """
    if pool not in ("singles", "sd"):
        raise ValueError(f"unknown pool '{pool}'")
    device = resolve_device(device)
    n_so = h1.shape[0]
    prog = _program(MAPPINGS[mapping](constant, h1, h2), [], device)

    psi = torch.as_tensor(
        vqe_statevector(constant, h1, h2, nelec, mapping=mapping, params=params,
                        excitations=ansatz_excitations, device=device),
        dtype=torch.complex128, device=device)

    ladder = _ladder_factory(mapping, n_so)
    _, excs = uccsd_excitations(n_so, nelec)
    if pool == "singles":
        excs = [e for e in excs if len(e[0]) == 1]

    # |phi_I> = O_I |psi>; column 0 is the identity
    phi = torch.stack([psi] + [_apply_terms(_operator_terms(cre, ann, ladder), prog, psi)
                               for cre, ann in excs], dim=1)  # (dim, P)
    h_phi = torch.complex(_apply_hamiltonian_columns(prog, phi.real),
                          _apply_hamiltonian_columns(prog, phi.imag))
    s_mat = to_host(phi.conj().T @ phi)
    m_mat = to_host(phi.conj().T @ h_phi)
    m_mat = 0.5 * (m_mat + m_mat.conj().T)  # Hermitise roundoff

    # canonical orthogonalisation: project out the null space of S
    s_eig, s_vec = np.linalg.eigh(s_mat)
    keep = s_eig > s_tol * s_eig.max()
    xmat = s_vec[:, keep] / np.sqrt(s_eig[keep])
    vals, vecs = np.linalg.eigh(xmat.conj().T @ m_mat @ xmat)
    w = (xmat @ vecs).T  # rows = roots, in operator-pool coordinates
    if nroots is not None:
        vals, w = vals[:nroots], w[:nroots]
    return QSEResult(energies=vals, excitations=vals - vals[0], weights=w,
                     n_operators=phi.shape[1], n_retained=int(keep.sum()),
                     s_min_eig=float(s_eig.min().real))


def _apply_hamiltonian_columns(prog, v):
    """H applied to each column of the real (dim, P) ``v``."""
    return torch.stack([_apply_hamiltonian(prog, v[:, p].contiguous())
                        for p in range(v.shape[1])], dim=1)
