"""Carry state from ``nbed_tpu`` objects into the port's objects.

Parity tests feed identical state into a module on both sides with these.
The ``nbed_tpu`` objects are duck-typed and read through ``np.asarray``, so
this module imports neither JAX nor ``nbed_tpu``.
"""

import numpy as np
import torch

from ._device import DTYPE, resolve_device
from .chem.molecule import Molecule, Shell
from .scf.engine import SCFEngine, SCFSolution
from .scf.hf import SCFResult

__all__ = ["molecule_from_reference", "solution_from_reference", "scf_result_from_reference"]


def _optional_array(a):
    return None if a is None else np.array(a, dtype=np.float64)


def molecule_from_reference(mol) -> Molecule:
    """Port :class:`Molecule` with the shells, coordinates, charges,
    electron counts and MM charges of an ``nbed_tpu`` molecule."""
    shells = tuple(
        Shell(atom=int(sh.atom), l=int(sh.l), exps=tuple(float(x) for x in sh.exps),
              coeffs=tuple(float(x) for x in sh.coeffs), ao_offset=int(sh.ao_offset),
              cart2sph=np.array(sh.cart2sph, dtype=np.float64))
        for sh in mol.shells
    )
    override = getattr(mol, "nelec_override", None)
    return Molecule(
        symbols=tuple(mol.symbols),
        atom_charges=tuple(float(z) for z in mol.atom_charges),
        coords=np.array(mol.coords, dtype=np.float64),
        basis=mol.basis,
        shells=shells,
        charge=int(mol.charge),
        spin=int(mol.spin),
        nelec_override=None if override is None else tuple(int(x) for x in override),
        mm_coords=_optional_array(mol.mm_coords),
        mm_charges=_optional_array(mol.mm_charges),
        mm_radii=_optional_array(mol.mm_radii),
    )


def solution_from_reference(sol, device="cuda") -> SCFSolution:
    """Port :class:`SCFSolution` on ``device`` carrying an unrestricted
    ``nbed_tpu`` solution: its MO coefficients, energies and occupations,
    total energy, embedding potential and Huzinaga operator, on an engine
    whose S, hcore and ERIs are the reference engine's (with the long-range
    ERIs of a range-separated hybrid). A density-fitted engine carries the
    reference's DF factors (as (nao, naux, nao)), ``df_beta`` and
    ``max_memory_mb`` instead of the ERIs. The Fock matrix is rebuilt by
    the port (``get_fock``) from that state."""
    device = resolve_device(device)
    ref = sol.engine
    density_fitting = bool(ref.density_fitting)
    rsh = ref._rsh is not None

    def tensor(a):
        return None if a is None else torch.as_tensor(np.array(a), dtype=DTYPE,
                                                      device=device)

    def factor(b):  # (nao, nao, naux) -> (nao, naux, nao)
        return tensor(np.moveaxis(np.asarray(b), -1, 1))

    engine = SCFEngine(
        molecule_from_reference(sol.mol), xc=ref.xc, device=device,
        density_fitting=density_fitting,
        df_b=factor(ref._df_b) if density_fitting else None,
        df_b_lr=factor(ref._df_b_lr) if density_fitting and rsh else None,
        df_beta=float(ref.df_beta), max_memory_mb=float(ref.max_memory_mb),
        rohf=bool(ref.rohf), coords=np.array(ref.coords, dtype=np.float64),
        grid_scheme=ref.grid_scheme, grid_level=int(ref.grid_level),
        grid_size=tuple(int(x) for x in ref.grid_size))
    engine.s = tensor(ref.s)
    engine.hcore = tensor(ref.hcore)
    if not density_fitting:
        engine.eri = tensor(ref.eri)
        if rsh:
            engine.eri_lr = tensor(ref.eri_lr)
    mo_coeff = tensor(sol.mo_coeff)
    if mo_coeff.ndim != 3:
        raise ValueError("solution_from_reference takes unrestricted solutions")
    return SCFSolution(
        engine=engine, nelec=tuple(int(x) for x in sol.nelec),
        mo_coeff=mo_coeff, mo_energy=tensor(sol.mo_energy),
        mo_occ=tensor(sol.mo_occ), e_tot=float(sol.e_tot),
        converged=bool(sol.converged), v_emb=tensor(sol.v_emb),
        huzinaga_op=tensor(sol.huzinaga_op),
    )


def scf_result_from_reference(res, device="cuda") -> SCFResult:
    """Port :class:`~nbed_tpu_torch.scf.hf.SCFResult` on ``device`` carrying
    an ``nbed_tpu`` ``run_scf`` result: its density, MO coefficients,
    energies and occupations, electronic energy, convergence flag, final
    Fock, Huzinaga operator and cycle count (what ``hf_gradient`` takes as
    ``scf_result``)."""
    device = resolve_device(device)

    def tensor(a):
        return torch.as_tensor(np.array(a), dtype=DTYPE, device=device)

    return SCFResult(
        mo_coeff=tensor(res.mo_coeff), mo_energy=tensor(res.mo_energy),
        mo_occ=tensor(res.mo_occ), dm=tensor(res.dm), e_elec=float(res.e_elec),
        converged=bool(res.converged), fock=tensor(res.fock),
        huzinaga_op=tensor(res.huzinaga_op), n_iter=int(res.n_iter))
