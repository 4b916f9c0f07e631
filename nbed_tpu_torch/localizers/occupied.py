"""Occupied-orbital localization: SPADE, Pipek-Mezey, Boys and IBO (port
of ``nbed_tpu/localizers/occupied.py``).

SPADE is an S^1/2 rotation + SVD with a largest-gap partition rule. PM, Boys
and IBO maximise sum_i sum_A (Q^A_ii)^p by 2x2 Jacobi rotations over
Löwdin-population, dipole or IAO-population operators; active/environment
selection then follows the AO-weight-share rule. The operators are built as
torch tensors on the solution's device and moved to the host once: the
sweep is the reference's host numpy float64 loop. The port is unrestricted
only, as the driver is.
"""

import logging
from functools import cached_property

import numpy as np
import torch

from .._device import to_host
from ..chem.molecule import build_molecule
from ..exceptions import NbedLocalizerError
from ..integrals.core import dipole_integrals, overlap_cross
from .system import LocalizedSystem

logger = logging.getLogger(__name__)

__all__ = ["OccupiedLocalizer", "SPADELocalizer", "PMLocalizer", "BOYSLocalizer",
           "IBOLocalizer", "check_values"]


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


def _s_inv(s):
    w, v = torch.linalg.eigh(s)
    return (v * (1.0 / w)[None, :]) @ v.T


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


# --------------------------------------------------------------------------
# Jacobi-sweep localizers
# --------------------------------------------------------------------------

def _jacobi_sweeps(c_occ, pop_matrices, exponent=2, max_sweeps=200, tol=1e-10):
    """Maximize sum_i sum_A (Q^A_ii)^p by 2x2 Jacobi rotations (host numpy
    float64, as in the reference).

    ``pop_matrices``: (A, n_ao, n_ao) symmetric operators (atomic population
    projectors for PM/IBO, dipole components for Boys). Uses the exact
    closed-form angle for p=2 and a dense angle scan for p=4.
    """
    c = np.array(c_occ)
    n = c.shape[1]
    if n < 2:
        return c
    ops = np.asarray(pop_matrices)

    def q_all(c):
        return np.einsum("pi,apq,qj->aij", c, ops, c)

    for _ in range(max_sweeps):
        improvement = 0.0
        q = q_all(c)
        for i in range(n):
            for j in range(i + 1, n):
                qii, qjj, qij = q[:, i, i], q[:, j, j], q[:, i, j]
                if exponent == 2:
                    a_term = float(np.sum(qij**2 - 0.25 * (qii - qjj) ** 2))
                    b_term = float(np.sum(qij * (qii - qjj)))
                    norm = np.hypot(a_term, b_term)
                    if norm < 1e-14 or norm + a_term < tol * 1e-2:
                        continue
                    alpha = 0.25 * np.arctan2(b_term, -a_term)
                    gain = a_term + norm
                else:
                    # p=4 (IBO): scan the pi/2-periodic angle objective
                    grid = np.linspace(-np.pi / 4, np.pi / 4, 65)
                    cg, sg = np.cos(grid), np.sin(grid)
                    qii_r = (cg**2)[None] * qii[:, None] + (sg**2)[None] * qjj[:, None] \
                        + (2 * cg * sg)[None] * qij[:, None]
                    qjj_r = (sg**2)[None] * qii[:, None] + (cg**2)[None] * qjj[:, None] \
                        - (2 * cg * sg)[None] * qij[:, None]
                    obj = np.sum(qii_r**4 + qjj_r**4, axis=0)
                    k = int(np.argmax(obj))
                    gain = obj[k] - obj[len(grid) // 2]
                    if gain < tol * 1e-2:
                        continue
                    alpha = grid[k]
                cos_a, sin_a = np.cos(alpha), np.sin(alpha)
                ci, cj = c[:, i].copy(), c[:, j].copy()
                c[:, i] = cos_a * ci + sin_a * cj
                c[:, j] = -sin_a * ci + cos_a * cj
                # q -> G^T q G: a 2x2 rotation only mixes rows/columns (i, j)
                qi, qj = q[:, i, :].copy(), q[:, j, :].copy()
                q[:, i, :] = cos_a * qi + sin_a * qj
                q[:, j, :] = -sin_a * qi + cos_a * qj
                qi, qj = q[:, :, i].copy(), q[:, :, j].copy()
                q[:, :, i] = cos_a * qi + sin_a * qj
                q[:, :, j] = -sin_a * qi + cos_a * qj
                improvement += max(gain, 0.0)
        if improvement < tol:
            break
    return c


class _JacobiLocalizer(OccupiedLocalizer):
    """Jacobi-sweep localization with the AO-weight-share selection of the
    active MOs (reference occupied.py:271-320). Subclasses give the
    operators of the sweep (:meth:`_operators`) and its exponent."""

    exponent = 2

    def __init__(self, global_scf, n_active_atoms, occ_cutoff=0.95, virt_cutoff=0.95):
        self.occ_cutoff = self._valid_threshold(occ_cutoff)
        self.virt_cutoff = self._valid_threshold(virt_cutoff)
        super().__init__(global_scf, n_active_atoms)

    @staticmethod
    def _valid_threshold(threshold: float):
        if 0.0 <= threshold <= 1.0:
            return threshold
        raise ValueError(f"threshold: {threshold} is not in range [0,1] inclusive")

    def _operators(self, c_occ) -> torch.Tensor:
        """(A, nao, nao) operators of the sweep, on the device."""
        raise NotImplementedError

    def _rotate(self, c_occ):
        """The localized occupied coefficients: the sweep's inputs go to the
        host once, the result comes back to ``c_occ``'s device."""
        c_loc = _jacobi_sweeps(to_host(c_occ), to_host(self._operators(c_occ)),
                               exponent=self.exponent)
        return torch.as_tensor(c_loc, dtype=c_occ.dtype, device=c_occ.device)

    def _localize_spin(self, c_matrix, occupancy, n_mo_overwrite=None):
        n_occ = int(torch.count_nonzero(occupancy))
        c_loc_occ = self._rotate(c_matrix[:, :n_occ])

        ao_slice = self._mol.aoslice_by_atom()
        active_aos = np.arange(ao_slice[0, 2], ao_slice[self._n_active_atoms - 1, 3])
        c_h = to_host(c_loc_occ)
        share = np.einsum("ij->j", c_h[active_aos, :] ** 2) / np.einsum("ij->j", c_h**2)
        active_mo_inds = np.where(share > self.occ_cutoff)[0]

        if np.allclose(np.zeros_like(share), share - share.sum() / len(share)):
            # highly symmetric molecule: split half and half
            logger.warning("AO share equal everywhere; splitting half and half.")
            active_mo_inds = np.arange(c_h.shape[1] // 2)
        elif len(active_mo_inds) == 0:
            logger.warning("No active MOs above threshold; forcing max-share MO.")
            active_mo_inds = share.argsort()[::-1][:1]

        enviro_mo_inds = np.array(
            [i for i in range(c_h.shape[1]) if i not in active_mo_inds])
        dev = c_loc_occ.device
        c_active = c_loc_occ[:, torch.as_tensor(active_mo_inds, device=dev)]
        if len(enviro_mo_inds) == 0:
            logger.warning("No environment electronic density.")
            c_enviro = c_loc_occ.new_zeros((c_active.shape[0], 1))
        else:
            c_enviro = c_loc_occ[:, torch.as_tensor(enviro_mo_inds, device=dev)]
        self.enviro_selection_condition = share
        return LocalizedSystem(active_mo_inds, enviro_mo_inds, c_active, c_enviro,
                               c_loc_occ)

    def _lowdin_populations(self):
        """Atomic Löwdin population projectors S^1/2 P_A S^1/2, (natm, nao, nao)."""
        s_half = _s_half(self._ao_overlap)
        ao_slice = self._mol.aoslice_by_atom()
        return torch.stack([s_half[:, lo:hi] @ s_half[lo:hi, :]
                            for lo, hi in ao_slice[:, 2:4]])


class PMLocalizer(_JacobiLocalizer):
    """Pipek-Mezey with Löwdin populations (reference occupied.py:334-338)."""

    def _operators(self, c_occ):
        return self._lowdin_populations()


class BOYSLocalizer(_JacobiLocalizer):
    """Foster-Boys localization on the dipole integrals at the engine's
    coordinates (reference occupied.py:341-346)."""

    def _operators(self, c_occ):
        return dipole_integrals(self._mol, self._global_scf.engine.coords,
                                device=c_occ.device)


class IBOLocalizer(_JacobiLocalizer):
    """Intrinsic bond orbitals (Knizia 2013; reference occupied.py:349-403).

    The IAOs are built against an STO-3G minimal basis at the same geometry
    from cross-basis overlaps, Löwdin-orthogonalised, and the occupied space
    is localized by Jacobi sweeps maximizing the sum of IAO charges^4.
    """

    exponent = 4

    @cached_property
    def _minao(self):
        """(minimal-basis molecule, its overlap, the cross overlap <mol|minao>),
        on the solution's device."""
        mol = self._mol
        coords = np.asarray(self._global_scf.engine.coords)
        device = self._ao_overlap.device
        # the reference's geometry text exactly: another constant or format
        # would move the minimal basis, and with it the IAOs
        xyz_lines = [f"{mol.natm}", ""]
        for sym, xyz in zip(mol.symbols, coords * 0.52917721092):
            xyz_lines.append(f"{sym} {xyz[0]:.12f} {xyz[1]:.12f} {xyz[2]:.12f}")
        minao = build_molecule("\n".join(xyz_lines) + "\n", "sto-3g",
                               charge=mol.charge, spin=mol.spin)
        s2 = overlap_cross(minao, minao, minao.coords, minao.coords, device=device)
        s12 = overlap_cross(mol, minao, coords, minao.coords, device=device)
        return minao, s2, s12

    def _iaos(self, c_occ):
        minao, s2, s12 = self._minao
        s1 = self._ao_overlap
        p12 = _s_inv(s1) @ s12
        p21 = _s_inv(s2) @ s12.T
        ct = p12 @ (p21 @ c_occ)
        # orthonormalize ct with respect to s1
        w, v = torch.linalg.eigh(ct.T @ s1 @ ct)
        ct = ct @ (v * (1.0 / torch.sqrt(torch.clamp(w, min=1e-14)))[None, :]) @ v.T
        # Knizia's IAO formula
        o_big = c_occ @ c_occ.T @ s1
        o_tilde = ct @ ct.T @ s1
        eye = torch.eye(s1.shape[0], dtype=s1.dtype, device=s1.device)
        a = o_big @ o_tilde @ p12 + (eye - o_big) @ (eye - o_tilde) @ p12
        # symmetric (Löwdin) orthogonalization with respect to s1
        w, v = torch.linalg.eigh(a.T @ s1 @ a)
        a = a @ (v * (1.0 / torch.sqrt(torch.clamp(w, min=1e-14)))[None, :]) @ v.T
        return a, minao

    def _operators(self, c_occ):
        a, minao = self._iaos(c_occ)
        proj = self._ao_overlap @ a  # (nao, niao)
        ao_slice = minao.aoslice_by_atom()
        return torch.stack([proj[:, lo:hi] @ proj[:, lo:hi].T for lo, hi in ao_slice[:, 2:4]])


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
