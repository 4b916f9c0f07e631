"""Full RPA-TDDFT of nbed_tpu_torch (water/STO-3G, float64 CPU): against
nbed_tpu's ``run_tddft_rpa`` on the same solution (HF and B3LYP, exact
ERIs, 1e-8); on a Hartree-Fock engine against ``run_rpa`` on the engine's
own integrals, exact and density-fitted (1e-10; nbed_tpu's DF RPA-TDDFT
misses its own ``run_rpa`` by 0.26 Ha on average on this molecule, since
its A - B loses the exchange); restricted solutions against unrestricted ones,
and the oscillator strengths and polarizability of the TDDFT results."""

import numpy as np
import pytest
import torch

from nbed_tpu.solvers import run_tddft_rpa as ref_rpa
from nbed_tpu_torch.driver import NbedDriver
from nbed_tpu_torch.ham import HamiltonianBuilder
from nbed_tpu_torch.interop import molecule_from_reference, solution_from_reference
from nbed_tpu_torch.scf import SCFEngine
from nbed_tpu_torch.solvers import (oscillator_strengths, polarizability, run_cis,
                                    run_rpa, run_tddft_rpa, run_tddft_tda)

torch.set_num_threads(1)

SCF = dict(conv_tol=1e-10, dm_conv_tol=1e-8, max_cycle=100, device="cpu")


@pytest.fixture(scope="module")
def mol(water_molecule):
    return molecule_from_reference(water_molecule)


@pytest.mark.parametrize("fixture", ["water_uhf", "water_uks"])
def test_rpa_matches_nbed_tpu(request, fixture):
    ref_sol = request.getfixturevalue(fixture)
    ours, theirs = run_tddft_rpa(solution_from_reference(ref_sol, "cpu")), ref_rpa(ref_sol)
    np.testing.assert_allclose(ours.excitations, theirs.excitations, rtol=0, atol=1e-8)
    assert ours.n_imaginary == theirs.n_imaginary == 0
    np.testing.assert_array_equal(ours.pairs, theirs.pairs)


@pytest.mark.parametrize("density_fitting", [False, True])
def test_rpa_on_hf_is_run_rpa(mol, density_fitting):
    sol = SCFEngine(mol, density_fitting=density_fitting, **SCF).kernel()
    _, h1, h2 = HamiltonianBuilder(sol, 0.0).build()
    ref = run_rpa(h1, h2, NbedDriver._interleaved_occ(sol))
    ours = run_tddft_rpa(sol)
    np.testing.assert_allclose(ours.excitations, ref.excitations, rtol=0, atol=1e-10)
    # the (X+Y) gauge gives the same strengths, summed over degenerate roots
    f, _ = oscillator_strengths(sol, ours)
    f_ref, _ = oscillator_strengths(sol, ref)
    assert abs(f.sum() - f_ref.sum()) < 1e-8


@pytest.mark.parametrize("xc", [None, "b3lyp"])
def test_restricted_solution_gives_unrestricted_spectrum(mol, xc):
    r = SCFEngine(mol, xc=xc, restricted=True, **SCF).kernel()
    u = SCFEngine(mol, xc=xc, **SCF).kernel()
    np.testing.assert_allclose(run_tddft_tda(r).excitations, run_tddft_tda(u).excitations,
                               rtol=0, atol=1e-8)
    np.testing.assert_allclose(run_tddft_rpa(r, nroots=6).excitations,
                               run_tddft_rpa(u, nroots=6).excitations, rtol=0, atol=1e-8)


def test_tddft_properties_on_hf_equal_cis(mol):
    """Oscillator strengths of the TDA result and the RPA polarizability on
    an HF engine equal those of CIS/RPA on the integrals."""
    sol = SCFEngine(mol, **SCF).kernel()
    _, h1, h2 = HamiltonianBuilder(sol, 0.0).build()
    occ = NbedDriver._interleaved_occ(sol)
    f_tda, _ = oscillator_strengths(sol, run_tddft_tda(sol))
    f_cis, _ = oscillator_strengths(sol, run_cis(h1, h2, occ))
    assert abs(f_tda.sum() - f_cis.sum()) < 1e-8
    alpha = polarizability(sol, run_tddft_rpa(sol))
    np.testing.assert_allclose(alpha, polarizability(sol, run_rpa(h1, h2, occ)), atol=1e-7)
    assert np.all(np.linalg.eigvalsh(0.5 * (alpha + alpha.T)) > 0)
