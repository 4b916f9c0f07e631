"""Occupied-orbital localization: SPADE (port of the base class and SPADE
of ``nbed_tpu/localizers/occupied.py``).

SPADE is an S^1/2 rotation + SVD with a largest-gap partition rule. The
port is unrestricted only, as the driver is. Not ported: the Pipek-Mezey,
Boys and IBO Jacobi-sweep localizers (ROADMAP queue 1 item 10).
"""

import logging

import numpy as np
import torch

from ..exceptions import NbedLocalizerError
from .system import LocalizedSystem

logger = logging.getLogger(__name__)

__all__ = ["OccupiedLocalizer", "SPADELocalizer", "check_values"]


def _stack_ragged(a, b):
    """Stack two index arrays of possibly different lengths (object array
    so per-spin ``len`` stays truthful)."""
    if len(a) == len(b):
        return np.array([a, b])
    out = np.empty(2, dtype=object)
    out[0], out[1] = np.asarray(a), np.asarray(b)
    return out


def _stack_padded(a, b):
    """Stack two (n, k_s) coefficient blocks, zero-padding the narrower one:
    zero columns add nothing to the derived C C^T densities."""
    k = max(a.shape[-1], b.shape[-1])

    def pad(c):
        return torch.nn.functional.pad(c, (0, k - c.shape[-1]))

    return torch.stack([pad(a), pad(b)])


def _s_half(s):
    w, v = torch.linalg.eigh(s)
    return (v * torch.sqrt(w)[None, :]) @ v.T


class OccupiedLocalizer:
    """Spin dispatch + sense checks (reference occupied.py:99-182)."""

    def __init__(self, global_scf, n_active_atoms: int, n_mo_overwrite=None):
        if global_scf.mo_coeff.ndim != 3:
            raise ValueError("nbed_tpu_torch localizers take unrestricted solutions")
        self.n_mo_overwrite = (None, None) if n_mo_overwrite is None else n_mo_overwrite
        self._global_scf = global_scf
        self._n_active_atoms = n_active_atoms
        self.enviro_selection_condition = None

    def localize(self) -> LocalizedSystem:
        """Partition the occupied space per spin; unequal index sets are
        re-localized with summed occupancies (reference occupied.py:109-165)."""
        mo_coeff = self._global_scf.mo_coeff
        mo_occ = self._global_scf.mo_occ
        alpha = self._localize_spin(mo_coeff[0], mo_occ[0], self.n_mo_overwrite[0])
        beta = self._localize_spin(mo_coeff[1], mo_occ[1], self.n_mo_overwrite[1])
        if (len(alpha.active_mo_inds) != len(beta.active_mo_inds)
                or len(alpha.enviro_mo_inds) != len(beta.enviro_mo_inds)):
            # open shell with per-spin partitions of different sizes: keep
            # them (ragged indices, zero-padded coefficient stacks)
            logger.info(
                "Unequal alpha/beta partitions (%d/%d active): keeping "
                "faithful per-spin spaces.",
                len(alpha.active_mo_inds), len(beta.active_mo_inds),
            )
            return LocalizedSystem(
                _stack_ragged(alpha.active_mo_inds, beta.active_mo_inds),
                _stack_ragged(alpha.enviro_mo_inds, beta.enviro_mo_inds),
                _stack_padded(alpha.c_active, beta.c_active),
                _stack_padded(alpha.c_enviro, beta.c_enviro),
                _stack_padded(alpha.c_loc_occ, beta.c_loc_occ),
            )
        loc = LocalizedSystem(
            np.array([alpha.active_mo_inds, beta.active_mo_inds]),
            np.array([alpha.enviro_mo_inds, beta.enviro_mo_inds]),
            torch.stack([alpha.c_active, beta.c_active]),
            torch.stack([alpha.c_enviro, beta.c_enviro]),
            torch.stack([alpha.c_loc_occ, beta.c_loc_occ]),
        )
        if set(alpha.active_mo_inds.tolist()) != set(beta.active_mo_inds.tolist()) or \
           set(alpha.enviro_mo_inds.tolist()) != set(beta.enviro_mo_inds.tolist()):
            logger.debug("Re-localizing with summed occupancies for equal spins.")
            occ_sum = torch.sum(mo_occ, dim=0)
            a_c = self._localize_spin(mo_coeff[0], occ_sum, self.n_mo_overwrite[0])
            b_c = self._localize_spin(mo_coeff[1], occ_sum, self.n_mo_overwrite[1])
            loc = LocalizedSystem(
                np.array([alpha.active_mo_inds, beta.active_mo_inds]),
                np.array([alpha.enviro_mo_inds, beta.enviro_mo_inds]),
                torch.stack([a_c.c_active, b_c.c_active]),
                torch.stack([a_c.c_enviro, b_c.c_enviro]),
                torch.stack([a_c.c_loc_occ, b_c.c_loc_occ]),
            )
        return loc

    def _localize_spin(self, c_matrix, occupancy, n_mo_overwrite=None) -> LocalizedSystem:
        raise NotImplementedError

    @property
    def _mol(self):
        return self._global_scf.mol

    @property
    def _n_act_aos(self):
        return int(self._mol.aoslice_by_atom()[self._n_active_atoms - 1][-1])

    @property
    def _ao_overlap(self):
        return self._global_scf.engine.s


class SPADELocalizer(OccupiedLocalizer):
    """Subsystem Projected AO Decomposition (reference occupied.py:185-234)."""

    def __init__(self, global_scf, n_active_atoms, max_shells: int = 4,
                 n_mo_overwrite=None):
        self.max_shells = max_shells
        self.shells = None
        self.singular_values = None
        super().__init__(global_scf, n_active_atoms, n_mo_overwrite)

    def _localize_spin(self, c_matrix, occupancy, n_mo_overwrite=None):
        n_occ = int(torch.count_nonzero(occupancy))
        occupied = c_matrix[:, :n_occ]
        n_act_aos = self._n_act_aos
        rotated = _s_half(self._ao_overlap) @ occupied
        # full_matrices=True: when n_act_aos < n_occ the environment span
        # lives in the complement of the right-singular space, which a thin
        # SVD would drop
        _, sigma, vh = torch.linalg.svd(rotated[:n_act_aos, :], full_matrices=True)
        sigma_h = sigma.cpu().numpy()

        if len(sigma_h) == 1:
            n_act_mos = 1
        elif n_mo_overwrite is not None and len(sigma_h) >= n_mo_overwrite:
            n_act_mos = int(n_mo_overwrite)
        else:
            diffs = sigma_h[:-1] - sigma_h[1:]
            if np.allclose(diffs, np.zeros_like(diffs)):
                n_act_mos = len(sigma_h)  # fully degenerate: all active
            else:
                n_act_mos = int(np.argmax(diffs)) + 1

        n_env_mos = n_occ - n_act_mos
        right = vh.T
        c_active = occupied @ right[:, :n_act_mos]
        c_enviro = occupied @ right[:, n_act_mos:]
        c_loc_occ = occupied @ right

        if self.enviro_selection_condition is None:
            self.enviro_selection_condition = (sigma_h, np.zeros(len(sigma_h)))
        else:
            self.enviro_selection_condition = (self.enviro_selection_condition[0],
                                               sigma_h)
        return LocalizedSystem(np.arange(n_act_mos),
                               np.arange(n_act_mos, n_act_mos + n_env_mos),
                               c_active, c_enviro, c_loc_occ)


def check_values(localized_system: LocalizedSystem, global_scf) -> None:
    """Sense checks: spin-count parity, DM partition, electron conservation
    (reference occupied.py:439-473). Raises NbedLocalizerError."""
    warn = False
    inds_act, inds_env = localized_system.active_mo_inds, localized_system.enviro_mo_inds
    if inds_act.ndim == 2 and (inds_act[0].shape != inds_act[1].shape
                               or inds_env[0].shape != inds_env[1].shape):
        logger.error("Number of alpha and beta orbitals do not match.")
        warn = True
    c = localized_system.c_loc_occ
    dm_full = c @ c.transpose(-1, -2)
    dm_sum = localized_system.dm_active + localized_system.dm_enviro
    if not torch.allclose(dm_full, dm_sum):
        logger.error("Density matrix partition does not sum to total.")
        warn = True
    s = global_scf.engine.s
    n_act = sum(float(torch.trace(localized_system.dm_active[i] @ s)) for i in (0, 1))
    n_env = sum(float(torch.trace(localized_system.dm_enviro[i] @ s)) for i in (0, 1))
    if not np.isclose(n_act + n_env, global_scf.mol.nelectron):
        logger.error("Electron count not conserved by localization.")
        warn = True
    if warn:
        raise NbedLocalizerError("Localizer sense check failed.\n")
