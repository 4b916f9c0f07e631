"""Harmonic vibrational analysis: semi-numerical Hessians from analytic
gradients, and IR intensities (port of ``nbed_tpu/solvers/hessian.py``).

The Hessian is the central finite difference of the analytic nuclear
gradient (``solvers/gradients.py``) over the 6N displaced geometries, each
SCF started cold. For HF, and for the dipole derivatives, the 6N
evaluations run as one batched call (the reference's vmapped program): one
lane SCF whose every cycle is one fused J/K launch for all lanes, then one
reverse-mode pass over the lanes (:mod:`nbed_tpu_torch.parallel.sharding`),
split in lane groups over a mesh's 'batch' axis when one is given. KS
Hessians loop ``ks_gradient`` over the displacements, as the reference
does. On a card every displacement replays its structure's programs: the
lane SCF, the lanes' "eri" program and their "hf_grad" program (HF), or
the engines' SCF programs and one "ks_grad" program (KS); a second
geometry of a structure makes no capture.

Frequencies follow from the mass-weighted Hessian: eigenvalues lambda in
Eh/(m_e a0^2) give nu = sqrt(lambda) * 219474.63 cm^-1. Translations and
rotations are projected out of the mass-weighted Hessian (Eckart frame)
before diagonalisation.
"""

import numpy as np
import torch

from ..chem.masses import AMU_TO_ME, atom_masses_me
from ..chem.molecule import Molecule
from ..integrals import dipole_integrals
from .gradients import ks_gradient

__all__ = ["hessian_fd", "harmonic_frequencies", "dipole_derivative_fd", "ir_intensities"]

FREQ_AU_TO_CM = 219474.6313705
# 1 (e/sqrt(amu))^2 of |dmu/dQ|^2 = 974.88 km/mol of integrated intensity:
# 42.2561 km/mol per (D/(Angstrom sqrt(amu)))^2 times (4.80320 D/A per e)^2
IR_AU_TO_KM_MOL = 974.8801


def _displacements(x0: np.ndarray, step: float) -> np.ndarray:
    """(2*3N, natm, 3) centrally displaced geometries, +/- interleaved."""
    natm = x0.shape[0]
    disp = []
    for i in range(3 * natm):
        for sgn in (+1.0, -1.0):
            d = x0.copy().ravel()
            d[i] += sgn * step
            disp.append(d.reshape(natm, 3))
    return np.stack(disp)


def hessian_fd(mol: Molecule, coords=None, step: float = 5e-3, mesh=None, xc=None,
               conv_tol: float = 1e-10, dm_conv_tol: float = 1e-8, max_cycle: int = 100,
               device="cuda", jit_kernel: str = "auto"):
    """Nuclear Hessian (3N, 3N) in Ha/bohr^2 by central differences of the
    analytic gradient (HF with ``xc=None``: the 6N displaced gradients as
    one batched call, its lanes split over ``mesh``'s 'batch' axis when
    given; else KS with grid response, one ``ks_gradient`` per
    displacement), symmetrised, as a numpy array. ``jit_kernel`` as
    ``SCFEngine``'s: on a card the 6N SCFs and gradients replay one set
    of CUDA graphs (the lane SCF and the lanes' "eri" and "hf_grad"
    programs, or the KS engines' shared programs and one "ks_grad"
    program).

    Raises:
        RuntimeError: when a displaced SCF does not converge.
    """
    x0 = np.asarray(mol.coords if coords is None else coords, dtype=np.float64)
    disp = _displacements(x0, step)
    kw = dict(conv_tol=conv_tol, dm_conv_tol=dm_conv_tol, max_cycle=max_cycle,
              device=device, jit_kernel=jit_kernel)
    if xc is None:
        from ..parallel import batched_hf_gradients

        _, grads, conv = batched_hf_gradients(mol, disp, mesh=mesh, **kw)
        if not bool(conv.all()):
            raise RuntimeError("Displaced SCF did not converge; Hessian invalid.")
        grads = grads.cpu().numpy().reshape(len(disp), -1)
    else:
        grads = np.empty((len(disp), disp[0].size))
        for k, x in enumerate(disp):
            _, g, res = ks_gradient(mol, xc, coords=x, **kw)
            if not res.converged:
                raise RuntimeError("Displaced SCF did not converge; Hessian invalid.")
            grads[k] = g.cpu().numpy().ravel()
    hess = (grads[0::2] - grads[1::2]) / (2.0 * step)  # row i = dg/dx_i
    return 0.5 * (hess + hess.T)


def _tr_projector(x0: np.ndarray, sqrt_m: np.ndarray) -> np.ndarray:
    """Orthonormal basis of mass-weighted translations + rotations (3N, k)."""
    natm = x0.shape[0]
    com = (sqrt_m**2 @ x0) / np.sum(sqrt_m**2)
    r = x0 - com
    vecs = []
    for k in range(3):  # translations
        t = np.zeros((natm, 3))
        t[:, k] = 1.0
        vecs.append((t * sqrt_m[:, None]).ravel())
    for k in range(3):  # rotations about axis k
        e = np.zeros(3)
        e[k] = 1.0
        rot = np.cross(np.broadcast_to(e, r.shape), r)
        vecs.append((rot * sqrt_m[:, None]).ravel())
    q, rdiag = np.linalg.qr(np.stack(vecs, axis=1))
    keep = np.abs(np.diag(rdiag)) > 1e-8  # linear molecules: 5, not 6
    return q[:, keep]


def harmonic_frequencies(mol: Molecule, coords=None, step: float = 5e-3, mesh=None,
                         xc=None, project: bool = True, device="cuda", **scf_kw):
    """Harmonic frequencies (cm^-1) and normal modes at ``coords``.

    Returns ``(freqs, modes, hessian)``: ``freqs`` (3N,) ascending, an
    imaginary frequency as a negative number; ``modes`` (3N, 3N) columns are
    mass-weighted normal modes; ``hessian`` the Cartesian Hessian in
    Ha/bohr^2. With ``project`` the translations and rotations are projected
    out, so their 6 (5 if linear) eigenvalues come out zero.
    """
    x0 = np.asarray(mol.coords if coords is None else coords, dtype=np.float64)
    hess = hessian_fd(mol, coords=x0, step=step, mesh=mesh, xc=xc, device=device, **scf_kw)
    sqrt_m = np.sqrt(atom_masses_me(mol))
    w = np.repeat(sqrt_m, 3)
    h_mw = hess / np.outer(w, w)
    if project:
        q = _tr_projector(x0, sqrt_m)
        p = np.eye(h_mw.shape[0]) - q @ q.T
        h_mw = p @ h_mw @ p
    lam, modes = np.linalg.eigh(h_mw)
    freqs = np.sign(lam) * np.sqrt(np.abs(lam)) * FREQ_AU_TO_CM
    return freqs, modes, hess


def dipole_derivative_fd(mol: Molecule, coords=None, step: float = 5e-3, mesh=None,
                         conv_tol: float = 1e-10, dm_conv_tol: float = 1e-8,
                         max_cycle: int = 100, device="cuda", jit_kernel: str = "auto"):
    """Dipole derivatives dmu/dx, shape (3N, 3), in a.u. (e): central
    differences of the HF dipole over the 6N displaced geometries, their
    SCFs (cold, on the ``eri_tensor`` supermatrices) and dipole integrals
    as one batched call, every SCF cycle one fused J/K launch for the
    lanes, split over ``mesh``'s 'batch' axis when given; ``jit_kernel``
    as :func:`hessian_fd`'s (the lanes' ERIs are their "eri" program)."""
    from ..parallel.sharding import _gather, _lane_groups, _lane_scf

    x0 = np.asarray(mol.coords if coords is None else coords, dtype=np.float64)
    dips = []
    for dev, x in _lane_groups(_displacements(x0, step), mesh, device):
        res, _ = _lane_scf(mol, x, conv_tol=conv_tol, dm_conv_tol=dm_conv_tol,
                           max_cycle=max_cycle, jit_kernel=jit_kernel)
        if not bool(res.converged.all()):
            raise RuntimeError("Displaced SCF did not converge; dipole derivative invalid.")
        z = torch.as_tensor(mol.atom_charges, dtype=x.dtype, device=dev)
        d_tot = res.dm[:, 0] + res.dm[:, 1]
        dips.append(torch.einsum("a,bax->bx", z, x) - torch.einsum(
            "bxij,bij->bx", dipole_integrals(mol, x, device=dev), d_tot))
    dips = _gather(dips, mesh, device).cpu().numpy()
    return (dips[0::2] - dips[1::2]) / (2.0 * step)  # (3N, 3)


def ir_intensities(mol: Molecule, modes: np.ndarray, coords=None, step: float = 5e-3,
                   mesh=None, mu_x=None, device="cuda", **scf_kw):
    """Harmonic IR intensities (km/mol) per normal mode, shape (3N,).

    ``modes`` are the mass-weighted normal modes of
    :func:`harmonic_frequencies` (columns). Intensity_i = 974.88 *
    |sum_j (dmu/dx_j) L_ji / sqrt(m_j[amu])|^2. Translations come out ~0
    for a neutral molecule; the projected rotations of a polar molecule
    carry intensity (rotating the frame rotates the dipole), so only the
    vibrational entries are IR intensities. A precomputed ``mu_x`` from
    :func:`dipole_derivative_fd` skips the displaced SCFs.
    """
    if mu_x is None:
        mu_x = dipole_derivative_fd(mol, coords=coords, step=step, mesh=mesh, device=device,
                                    **scf_kw)
    m_amu = np.repeat(atom_masses_me(mol) / AMU_TO_ME, 3)
    dmudq = (modes / np.sqrt(m_amu)[:, None]).T @ np.asarray(mu_x)  # e/sqrt(amu)
    return IR_AU_TO_KM_MOL * np.sum(dmudq**2, axis=1)
