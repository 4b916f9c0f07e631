"""Virtual-orbital localization: concentric localization (port of
``ConcentricLocalizer`` in ``nbed_tpu/localizers/virtual.py``).

CL (Claudino & Mayhall, JCTC 15, 6085 (2019)) truncates the embedded
virtual space by repeated SVDs of overlap- and Fock-projected virtuals.
The driver projects onto the working basis itself (``engine.s``). Not
ported: a different ``projected_basis``, which needs cross-basis overlap
integrals, and the PAO localizer (ROADMAP queue 1 item 10).
"""

import logging

import torch

__all__ = ["ConcentricLocalizer"]

logger = logging.getLogger(__name__)


class ConcentricLocalizer:
    """Concentric localization of embedded virtuals.

    ``shells`` records the column count after each accepted shell and
    ``singular_values`` each SVD spectrum (reference virtual.py:30-172);
    ``mo_occ``/``mo_energy`` are sliced to the new column count.
    """

    def __init__(self, embedded_scf, n_active_atoms: int, max_shells: int = 4,
                 projected_basis: str | None = None):
        if projected_basis is not None and \
                projected_basis.lower() != embedded_scf.mol.basis.lower():
            raise NotImplementedError(
                "a projected_basis other than the working basis is not ported "
                "yet: ROADMAP queue 1 item 10 (cross-basis overlaps for CL).")
        self._n_active_atoms = n_active_atoms
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
        s = scf.engine.s
        n_act = int(scf.mol.aoslice_by_atom()[self._n_active_atoms - 1][-1])
        self.projected_overlap = s[:n_act, :n_act]
        self.overlap_two_basis = s[:n_act, :]
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
