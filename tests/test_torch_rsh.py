"""Range-separated hybrids and meta-GGAs of nbed_tpu_torch against nbed_tpu
on water/STO-3G: the long-range ERIs, the folded exchange on the exact
route (the fused J/K kernel's operand) and on the DF route (the long-range
factor), get_veff on both routes, carried RSH solutions, and the SCF
energies against the reference tests' own oracles."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nbed_tpu import native as ref_native
from nbed_tpu.scf.engine import SCFEngine as RefEngine
from nbed_tpu.scf.engine import SCFSolution as RefSolution
from nbed_tpu_torch.integrals import native
from nbed_tpu_torch.interop import molecule_from_reference, solution_from_reference
from nbed_tpu_torch.scf import SCFEngine

# one torch thread per test process: under pytest-xdist the OpenMP threads
# of several workers spin on the same cores and slow every worker many-fold
torch.set_num_threads(1)

# tests/test_metagga.py:104,152 and tests/test_rsh.py:115,122, each with
# its test's SCF settings
ORACLES = {
    "tpss": (-75.32293726424629, dict(conv_tol=1e-9, dm_conv_tol=1e-7, max_cycle=60)),
    "tpssh": (-75.32113489427086, dict(conv_tol=1e-9, dm_conv_tol=1e-7, max_cycle=60)),
    "camb3lyp": (-75.27651129206012, {}),
    "lcblyp": (-75.13156528260438, {}),
}
RSH = ["camb3lyp", "wb97x"]


@pytest.fixture(scope="module")
def water(water_molecule):
    return molecule_from_reference(water_molecule)


@pytest.fixture(scope="module")
def density(water_uhf):
    """A seeded spin-polarised perturbation of the UHF density."""
    rng = np.random.default_rng(23)
    pert = 0.02 * rng.standard_normal((2,) + water_uhf.mo_coeff.shape[-2:])
    return water_uhf.make_rdm1() + pert + pert.swapaxes(-1, -2)


@pytest.mark.parametrize("omega", [0.33, 0.3])
def test_eri_lr_matches_reference_native(water_molecule, water, omega):
    np.testing.assert_allclose(native.eri(water, omega=omega),
                               ref_native.eri(water_molecule, omega=omega),
                               rtol=0, atol=1e-12)


@pytest.mark.parametrize("xc", RSH)
def test_folded_exchange_supermatrix_matches_reference(water_molecule, water, xc):
    """The fused kernel's K operand: hyb*(ik|jl) + beta*(ik|jl)_LR, with
    hyb reported as 1.0."""
    ref = RefEngine(water_molecule, xc=xc)
    ours = SCFEngine(water, xc=xc, device="cpu")
    np.testing.assert_allclose(ours.eri_lr.numpy(), np.asarray(ref.eri_lr),
                               rtol=0, atol=1e-12)
    np.testing.assert_allclose(ours.eri_k.numpy(), np.asarray(ref.eri_k),
                               rtol=0, atol=1e-12)
    assert ours.hyb == ref.hyb == 1.0


@pytest.mark.parametrize("density_fitting", [False, True])
@pytest.mark.parametrize("xc", RSH)
def test_get_veff_matches_reference(water_molecule, water, density, xc,
                                    density_fitting):
    """Each side builds its own operators (on the DF route both factors)."""
    ref = RefEngine(water_molecule, xc=xc, density_fitting=density_fitting)
    ours = SCFEngine(water, xc=xc, device="cpu", density_fitting=density_fitting)
    theirs = ref.get_veff(jnp.asarray(density))
    got = ours.get_veff(torch.tensor(density))
    np.testing.assert_allclose(got.matrix.numpy(), np.asarray(theirs.matrix),
                               rtol=0, atol=1e-10)
    assert abs(float(got.ecoul) - float(theirs.ecoul)) < 1e-10
    assert abs(float(got.exc) - float(theirs.exc)) < 1e-10
    if density_fitting:
        assert ours.df_b_lr is not None and ours.df_timings and ours.df_lr_timings


def test_long_range_factor_matches_reference(water_molecule, water):
    """B_lr B_lr^T against the reference's long-range factor (the factor is
    fixed only up to a rotation of its auxiliary axis)."""
    b_ref = np.asarray(RefEngine(water_molecule, xc="wb97x",
                                 density_fitting=True)._df_b_lr)
    b = SCFEngine(water, xc="wb97x", device="cpu", density_fitting=True) \
        .df_factor_lr().numpy()
    np.testing.assert_allclose(np.einsum("aPb,cPd->abcd", b, b),
                               np.einsum("abP,cdP->abcd", b_ref, b_ref),
                               rtol=0, atol=1e-10)


@pytest.mark.parametrize("density_fitting", [False, True])
def test_carried_rsh_solution_rebuilds_reference_fock(water_molecule, water_uhf,
                                                      density_fitting):
    """solution_from_reference carries eri_lr or the long-range factor: the
    port's Fock of a carried CAM-B3LYP solution equals the reference's."""
    ref_eng = RefEngine(water_molecule, xc="camb3lyp", density_fitting=density_fitting)
    ref_sol = RefSolution(
        engine=ref_eng, nelec=water_uhf.nelec, mo_coeff=water_uhf.mo_coeff,
        mo_energy=water_uhf.mo_energy, mo_occ=water_uhf.mo_occ,
        e_tot=water_uhf.e_tot, converged=True)
    sol = solution_from_reference(ref_sol, device="cpu")
    if density_fitting:
        assert sol.engine.df_b_lr is not None
    else:
        assert "eri_lr" in vars(sol.engine)
    np.testing.assert_allclose(sol.get_fock().numpy(), np.asarray(ref_sol.get_fock()),
                               rtol=0, atol=1e-10)


@pytest.mark.parametrize("xc", sorted(ORACLES))
def test_scf_energy_hits_reference_oracle(water, xc):
    oracle, kw = ORACLES[xc]
    sol = SCFEngine(water, xc=xc, device="cpu", **kw).kernel()
    assert sol.converged
    assert abs(sol.e_tot - oracle) < 1e-8


def test_density_fitted_rsh_scf_matches_reference(water_molecule, water):
    """CAM-B3LYP with both DF factors, SCF to SCF."""
    kw = dict(xc="camb3lyp", density_fitting=True, conv_tol=1e-9, dm_conv_tol=1e-7)
    ref = RefEngine(water_molecule, **kw).kernel()
    ours = SCFEngine(water, device="cpu", **kw).kernel()
    assert ours.converged and ref.converged
    assert abs(ours.e_tot - ref.e_tot) < 1e-8
    assert abs(ours.e_tot - ORACLES["camb3lyp"][0]) < 1e-5
