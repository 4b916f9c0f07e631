"""Virtual-orbital localization: concentric localization (CL) and projected
atomic orbitals (PAO) (port of ``nbed_tpu/localizers/virtual.py``).

CL (Claudino & Mayhall, JCTC 15, 6085 (2019)) truncates the embedded
virtual space by repeated SVDs of overlap- and Fock-projected virtuals,
projecting onto the working basis (``engine.s``) or, with
``projected_basis``, onto another basis at the same geometry through the
torch cross-basis overlaps. PAO builds projected atomic orbitals for the
Huzinaga path.
"""

import logging

import numpy as np
import torch

from ..chem.molecule import build_molecule
from ..integrals.core import overlap, overlap_cross

__all__ = ["VirtualLocalizer", "ConcentricLocalizer", "PAOLocalizer"]

logger = logging.getLogger(__name__)


class VirtualLocalizer:
    """Base of the virtual localizers: holds the active-atom count
    (``nbed_tpu/localizers/virtual.py:23-27``)."""

    def __init__(self, n_active_atoms: int):
        self._n_active_atoms = n_active_atoms


class ConcentricLocalizer(VirtualLocalizer):
    """Concentric localization of embedded virtuals.

    ``shells`` records the column count after each accepted shell and
    ``singular_values`` each SVD spectrum (reference virtual.py:30-172);
    ``mo_occ``/``mo_energy`` are sliced to the new column count.
    """

    def __init__(self, embedded_scf, n_active_atoms: int, max_shells: int = 4,
                 projected_basis: str | None = None):
        super().__init__(n_active_atoms)
        self.embedded_scf = embedded_scf
        self.max_shells = max_shells
        self.projected_basis = projected_basis
        self.projected_overlap = None
        self.overlap_two_basis = None
        self.n_act_proj_aos = None
        self.shells = None
        self.singular_values = None

    def localize_virtual(self):
        """Localize virtuals; returns the modified embedded SCF solution."""
        scf = self.embedded_scf
        mol = scf.mol
        if self.projected_basis is None or self.projected_basis.lower() == mol.basis.lower():
            proj_mol, s_proj = mol, scf.engine.s
            s_cross = s_proj
        else:
            # the reference's geometry text (Bohr x 0.52917721092, :.12f)
            coords = np.asarray(scf.engine.coords)
            xyz_lines = [f"{mol.natm}", ""]
            for sym, xyz in zip(mol.symbols, coords * 0.52917721092):
                xyz_lines.append(f"{sym} {xyz[0]:.12f} {xyz[1]:.12f} {xyz[2]:.12f}")
            proj_mol = build_molecule("\n".join(xyz_lines) + "\n", self.projected_basis,
                                      charge=mol.charge, spin=mol.spin)
            device = scf.engine.device
            s_proj = overlap(proj_mol, device=device)
            s_cross = overlap_cross(proj_mol, mol, proj_mol.coords, coords, device=device)
        n_act = int(proj_mol.aoslice_by_atom()[self._n_active_atoms - 1][-1])
        self.projected_overlap = s_proj[:n_act, :n_act]
        self.overlap_two_basis = s_cross[:n_act, :]
        self.n_act_proj_aos = n_act

        mo_coeff, mo_occ = scf.mo_coeff, scf.mo_occ
        fock = scf.get_fock()
        ca, sh_a, sv_a, rem_a = self._localize_virtual_spin(mo_occ[0], mo_coeff[0], fock[0])
        cb, sh_b, sv_b, rem_b = self._localize_virtual_spin(mo_occ[1], mo_coeff[1], fock[1])
        # ragged per-spin truncation: un-truncate the narrower channel with
        # its own leading kernel columns (reference virtual.py:566-584)
        if ca.shape[-1] != cb.shape[-1]:
            target = max(ca.shape[-1], cb.shape[-1])
            if ca.shape[-1] < target:
                ca = torch.cat((ca, rem_a[:, : target - ca.shape[-1]]), dim=-1)
                sh_a = sh_a + [ca.shape[-1]]
            else:
                cb = torch.cat((cb, rem_b[:, : target - cb.shape[-1]]), dim=-1)
                sh_b = sh_b + [cb.shape[-1]]
            logger.debug("Ragged per-spin CL truncation equalized to %d columns.", target)
        scf.mo_coeff = torch.stack([ca, cb])
        scf.mo_occ = scf.mo_occ[:, : ca.shape[-1]]
        scf.mo_energy = scf.mo_energy[:, : ca.shape[-1]]
        self.shells = (sh_a, sh_b)
        self.singular_values = (sv_a, sv_b)
        return scf

    def _count_span(self, sigma) -> int:
        return int(torch.sum(sigma[: self.n_act_proj_aos] >= 1e-15))

    def _localize_virtual_spin(self, occ, mo_coeff, fock_operator):
        """One spin channel (reference virtual.py:592-645). Returns
        ``(c_total, shells, singular_values, c_remainder)``; ``c_remainder``
        holds the kernel columns CL discarded."""
        effective_virt = mo_coeff[:, occ == 0]
        left = torch.linalg.inv(self.projected_overlap) @ self.overlap_two_basis @ effective_virt
        _, sigma, vh = torch.linalg.svd(left.T @ self.overlap_two_basis @ effective_virt)
        singular_values = [sigma]

        c_total = mo_coeff[:, occ > 0]
        shell_size = self._count_span(sigma)
        right = vh.T
        v_span, v_ker = right[:, :shell_size], right[:, shell_size:]
        c_ispan = effective_virt @ v_span
        c_iker = effective_virt @ v_ker
        c_total = torch.cat((c_total, c_ispan), dim=-1)
        shells = [c_total.shape[-1]]
        c_rem = c_iker[:, :0]

        if v_ker.shape[-1] == 0:
            logger.debug("No kernel for 0th shell; CL complete.")
        elif v_ker.shape[-1] == 1:
            c_total = torch.cat((c_total, c_iker), dim=-1)
            shells.append(c_total.shape[-1])
        else:
            for ishell in range(self.max_shells):
                _, sigma, vh = torch.linalg.svd(c_total.T @ fock_operator @ c_iker)
                singular_values.append(sigma)
                shell_size = self._count_span(sigma)
                if shell_size == 0:
                    c_total = torch.cat((c_total, c_iker), dim=-1)
                    break
                right = vh.T
                v_span, v_ker = right[:, :shell_size], right[:, shell_size:]
                c_ispan = c_iker @ v_span
                c_total = torch.cat((c_total, c_ispan), dim=-1)
                shells.append(c_total.shape[-1])
                if v_ker.shape[-1] > 1:
                    c_iker = c_iker @ v_ker
                    if ishell == self.max_shells - 1:
                        c_rem = c_iker  # loop exhausted: these columns drop
                elif v_ker.shape[-1] == 1:
                    c_iker = c_iker @ v_ker
                    c_total = torch.cat((c_total, c_iker), dim=-1)
                    shells.append(c_total.shape[-1])
                    break
                else:
                    break
        return c_total, shells, singular_values, c_rem


class PAOLocalizer(VirtualLocalizer):
    """Projected atomic orbitals for the embedded virtual space (reference
    virtual.py:175-199; Huzinaga path only)."""

    def __init__(self, global_scf, n_active_atoms: int, c_loc_occ,
                 norm_cutoff: float = 0.05, overlap_cutoff: float = 1e-5):
        super().__init__(n_active_atoms)
        self.global_scf = global_scf
        self.norm_cutoff = norm_cutoff
        self.overlap_cutoff = overlap_cutoff
        self.c_loc_occ = c_loc_occ

    def localize_virtual(self) -> torch.Tensor:
        """(2, nao, n_pao) PAO coefficients, one block per spin."""
        mol = self.global_scf.mol
        n_act_aos = int(mol.aoslice_by_atom()[self._n_active_atoms - 1][-1])
        s = self.global_scf.engine.s
        return torch.stack([_pao_spin(self.c_loc_occ[spin], s, n_act_aos, self.norm_cutoff,
                                      self.overlap_cutoff) for spin in (0, 1)])


def _pao_spin(c_loc_occ, ao_overlap, n_act_aos, norm_cutoff, overlap_cutoff):
    """PAOs for one spin: projector, norm truncation, renormalisation, and
    the overlap-eigenvalue cut (reference virtual.py:202-218)."""
    eye = torch.eye(ao_overlap.shape[-1], dtype=ao_overlap.dtype, device=ao_overlap.device)
    projector = eye - c_loc_occ @ c_loc_occ.T @ ao_overlap
    norms = torch.einsum("ji,ji->i", projector[:n_act_aos],
                         (ao_overlap @ projector)[:n_act_aos])
    truncated = projector[:, torch.abs(norms) > norm_cutoff]
    if truncated.shape[-1] == 0:
        logger.warning("No projected atomic orbitals above the norm cutoff.")
        return truncated
    renorm = truncated / torch.sqrt(torch.einsum("ij,ij->j", truncated, truncated))
    eigvals = torch.linalg.eigvalsh(renorm.T @ ao_overlap @ renorm)
    # the reference keeps the columns at the positions of the eigenvalues
    # above the cut, in ascending eigenvalue order
    final = renorm[:, torch.abs(eigvals) > overlap_cutoff]
    if final.shape[-1] == 0:
        logger.warning("No projected atomic orbitals; active region may have "
                       "no virtual AOs.")
    return final
