"""CIS / Tamm-Dancoff and full-RPA (TDHF) excited states on spin-orbital
integrals (port of ``nbed_tpu/solvers/cis.py``).

Spin orbitals, M_s-conserving singles:

    A[(i,a),(j,b)] = f_ab d_ij - f_ij d_ab + <aj||ib>,   B[(i,a),(j,b)] = <ab||ij>

with f the (embedded) Fock matrix implied by the integrals. The eigenvalues
of A are the CIS excitation energies: the Hamiltonian projected onto the
singly excited determinants, shifted by the reference energy. Assembly and
``torch.linalg.eigh`` run in float64 on the device of the builder's tensors;
the result dataclasses hold host numpy arrays, as the reference's do.
"""

from dataclasses import dataclass

import numpy as np
import torch

from .._device import DTYPE, to_host
from ..integrals.core import dipole_integrals
from .ccsd import _antisymmetrized

__all__ = ["run_cis", "run_rpa", "CISResult", "RPAResult", "oscillator_strengths",
           "polarizability", "spin_labels"]


@dataclass
class CISResult:
    """Excitation energies (Ha, ascending) and singles amplitudes.

    ``pairs[p] = (i, a)`` gives the occupied/virtual spin-orbital indices
    (builder interleave: even = alpha, odd = beta) of amplitude column p;
    ``amplitudes[r]`` is the normalised eigenvector of root r.
    """

    excitations: np.ndarray  # (nroots,)
    amplitudes: np.ndarray  # (nroots, npairs)
    pairs: np.ndarray  # (npairs, 2)
    e_ref_elec: float

    def dominant(self, root: int, k: int = 3):
        """Top-k (i, a, amplitude) contributions of a root."""
        x = self.amplitudes[root]
        idx = np.argsort(-np.abs(x))[:k]
        return [(int(self.pairs[p, 0]), int(self.pairs[p, 1]), float(x[p])) for p in idx]


@dataclass
class RPAResult(CISResult):
    """Full-RPA (TDHF) excitations; ``amplitudes`` holds X+Y rows with
    (X+Y)·(X−Y) = 1, so :func:`oscillator_strengths` applies unchanged.
    ``n_imaginary`` counts ω² < 0 roots (and negative directions of A−B),
    which are reported as ω = 0 at the bottom of the spectrum."""

    xmy: np.ndarray = None  # (nroots, npairs) X−Y rows
    n_imaginary: int = 0


def _singles_frame(so_h1, so_h2, occ_mask):
    """Shared CIS/RPA assembly: ``(w, fock, e_ref_elec, i_idx, a_idx)``, the
    antisymmetrised integrals <pq||rs>, the Fock matrix they imply, the
    reference electronic energy, and the M_s-conserving (occupied, virtual)
    spin-orbital index tensors on the integrals' device."""
    occ_mask = np.asarray(occ_mask, dtype=bool)
    h1 = torch.as_tensor(so_h1, dtype=DTYPE)
    w = _antisymmetrized(torch.as_tensor(so_h2, dtype=DTYPE, device=h1.device))
    dev = h1.device
    occ_h, vir_h = np.where(occ_mask)[0], np.where(~occ_mask)[0]
    occ = torch.as_tensor(occ_h, device=dev)

    # the Fock matrix implied by the integrals: f_pq = h_pq + sum_i <pi||qi>
    fock = h1 + torch.einsum("piqi->pq", w[:, occ][:, :, :, occ])
    e_ref_elec = float(torch.sum(torch.diagonal(h1[occ][:, occ]))
                       + 0.5 * torch.einsum("ijij->", w[occ][:, occ][:, :, occ][:, :, :, occ]))

    i_idx, a_idx = np.meshgrid(occ_h, vir_h, indexing="ij")
    keep = (i_idx % 2) == (a_idx % 2)
    i_idx, a_idx = i_idx[keep], a_idx[keep]
    if len(i_idx) == 0:
        raise ValueError("No M_s-conserving single excitations exist.")
    return (w, fock, e_ref_elec, torch.as_tensor(i_idx, device=dev),
            torch.as_tensor(a_idx, device=dev))


def _a_matrix(w, fock, i_idx, a_idx):
    """A[(ia),(jb)] = f[a,b] d_ij - f[i,j] d_ab + <a j || i b>."""
    zero = torch.zeros((), dtype=w.dtype, device=w.device)
    a_mat = w[a_idx[:, None], i_idx[None, :], i_idx[:, None], a_idx[None, :]]
    a_mat = a_mat + torch.where(i_idx[:, None] == i_idx[None, :],
                                fock[a_idx[:, None], a_idx[None, :]], zero)
    return a_mat - torch.where(a_idx[:, None] == a_idx[None, :],
                               fock[i_idx[:, None], i_idx[None, :]], zero)


def _pairs(i_idx, a_idx) -> np.ndarray:
    return np.stack([to_host(i_idx), to_host(a_idx)], axis=1)


def run_cis(so_h1, so_h2, occ_mask, nroots: int | None = None) -> CISResult:
    """CIS/TDA excitation spectrum from spin-orbital integrals.

    Args:
        so_h1: (M, M) one-body spin-orbital integrals (the builder's output
            already folds the embedding potential in), a float64 tensor.
        so_h2: (M, M, M, M) a+a+aa coefficient tensor (the builder's 0.5*h2).
        occ_mask: boolean (M,), True for occupied spin orbitals.
        nroots: number of lowest excitations to return (default: all).
    """
    w, fock, e_ref_elec, i_idx, a_idx = _singles_frame(so_h1, so_h2, occ_mask)
    omega, x = torch.linalg.eigh(_a_matrix(w, fock, i_idx, a_idx))
    if nroots is not None:
        omega, x = omega[:nroots], x[:, :nroots]
    return CISResult(excitations=to_host(omega),
                     amplitudes=np.ascontiguousarray(to_host(x).T),
                     pairs=_pairs(i_idx, a_idx), e_ref_elec=e_ref_elec)


def run_rpa(so_h1, so_h2, occ_mask, nroots: int | None = None) -> RPAResult:
    """Full RPA / TDHF excitation spectrum from spin-orbital integrals.

    Solves [[A, B], [−B, −A]] [X, Y] = ω [X, Y] through the Hermitian
    reduction (A−B)^{1/2} (A+B) (A−B)^{1/2} Z = ω² Z. Setting B = 0 gives
    :func:`run_cis` back.
    """
    w, fock, e_ref_elec, i_idx, a_idx = _singles_frame(so_h1, so_h2, occ_mask)
    a_mat = _a_matrix(w, fock, i_idx, a_idx)
    b_mat = w[a_idx[:, None], a_idx[None, :], i_idx[:, None], i_idx[None, :]]

    amb_vals, amb_vecs = torch.linalg.eigh(a_mat - b_mat)
    # A−B indefinite is itself an instability: the reduction clamps those
    # directions, so they count into n_imaginary
    n_imag_amb = int(torch.sum(amb_vals < -1e-10))
    half = (amb_vecs * torch.sqrt(torch.clamp(amb_vals, min=0.0))) @ amb_vecs.T
    w2, z = torch.linalg.eigh(half @ (a_mat + b_mat) @ half)
    n_imag = int(torch.sum(w2 < -1e-10)) + n_imag_amb
    omega = torch.sqrt(torch.clamp(w2, min=0.0))

    safe = torch.where(omega > 1e-12, omega, torch.ones_like(omega))
    xpy = (half @ z) / torch.sqrt(safe)[None, :]  # (npairs, nroots)
    xmy = ((a_mat + b_mat) @ xpy) / safe[None, :]

    if nroots is not None:
        omega, xpy, xmy = omega[:nroots], xpy[:, :nroots], xmy[:, :nroots]
    return RPAResult(excitations=to_host(omega),
                     amplitudes=np.ascontiguousarray(to_host(xpy).T),
                     pairs=_pairs(i_idx, a_idx), e_ref_elec=e_ref_elec,
                     xmy=np.ascontiguousarray(to_host(xmy).T), n_imaginary=n_imag)


def spin_labels(scf_sol, result: CISResult):
    """Singlet/triplet classification of the roots: ``(label, s)`` with
    ``s = 2 sum_ia X_aa[ia] X_bb[ia]`` over spatially matched pairs, each
    spatial orbital's per-spin sign aligned through the AO overlap (+1 a
    pure singlet, -1 the M_s = 0 triplet component, "mixed" between)."""
    c = scf_sol.per_spin()[0]
    align = to_host(torch.sign(torch.einsum("ui,uv,vi->i", c[0], scf_sol.engine.s, c[1])))

    lut = {}
    for p, (i, a) in enumerate(result.pairs):
        lut[(int(i) // 2, int(a) // 2, int(i) % 2)] = p
    out = []
    for x in result.amplitudes:
        s = 0.0
        for (io, ao, spin), p in lut.items():
            if spin == 0 and (io, ao, 1) in lut:
                s += 2.0 * x[p] * x[lut[(io, ao, 1)]] * align[io] * align[ao]
        out.append(("singlet" if s > 0.5 else "triplet" if s < -0.5 else "mixed",
                    float(s)))
    return out


def _pair_dipoles(scf_sol, pairs):
    """(npairs, 3) MO-basis transition-dipole rows d_ia of the given pairs,
    from ``dipole_integrals`` on the solution's device."""
    dip = dipole_integrals(scf_sol.mol, device=scf_sol.engine.device)  # (3, nao, nao)
    c = scf_sol.per_spin()[0]
    dip_mo = torch.einsum("xuv,sui,svj->sxij", dip, c, c)  # per-spin MO dipoles
    i_idx, a_idx = pairs[:, 0], pairs[:, 1]
    spin = i_idx % 2  # == a_idx % 2 by construction
    return to_host(dip_mo)[spin, :, i_idx // 2, a_idx // 2]


def oscillator_strengths(scf_sol, result: CISResult):
    """Length-gauge oscillator strengths f = (2/3) ω |<0|r|I>|².

    ``scf_sol``'s MOs must map 1:1 onto the spin orbitals of ``result`` (no
    frozen-orbital reduction in between). Returns (f, mu): (nroots,)
    strengths and (nroots, 3) transition dipoles (a.u.).
    """
    mu = result.amplitudes @ _pair_dipoles(scf_sol, result.pairs)  # (nroots, 3)
    f = (2.0 / 3.0) * result.excitations * np.sum(mu**2, axis=1)
    return f, mu


def polarizability(scf_sol, result: RPAResult, omega: float = 0.0):
    """Dipole polarizability alpha(omega) from the full RPA spectrum by sum
    over states, alpha_xy = 2 sum_r w_r mu_x^r mu_y^r / (w_r² − omega²):
    a (3, 3) tensor in atomic units."""
    if getattr(result, "n_imaginary", 0):
        raise ValueError("RPA has imaginary modes; polarizability of an "
                         "unstable reference is undefined.")
    if result.amplitudes.shape[0] != result.pairs.shape[0]:
        raise ValueError(
            "polarizability needs the FULL RPA spectrum "
            f"({result.pairs.shape[0]} roots), got "
            f"{result.amplitudes.shape[0]}; rerun run_rpa with nroots=None.")
    mu = result.amplitudes @ _pair_dipoles(scf_sol, result.pairs)
    w = result.excitations
    denom = w**2 - omega**2
    if np.any(np.abs(denom) < 1e-10):
        raise ValueError("omega hits an excitation pole.")
    return np.einsum("r,rx,ry->xy", 2.0 * w / denom, mu, mu)
