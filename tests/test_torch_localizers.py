"""SPADE and concentric localization of nbed_tpu_torch against nbed_tpu,
fed the same SCF state through nbed_tpu_torch.interop.

SVD signs and rotations inside degenerate singular subspaces are free, so
the tests compare densities, projectors and shell sizes, never raw
coefficients.
"""

import numpy as np
import pytest
import torch

from nbed_tpu.chem import build_molecule as ref_build_molecule
from nbed_tpu.localizers import ConcentricLocalizer as RefCL
from nbed_tpu.localizers import SPADELocalizer as RefSPADE
from nbed_tpu.scf.engine import SCFEngine as RefEngine
from nbed_tpu_torch.interop import solution_from_reference
from nbed_tpu_torch.localizers import ConcentricLocalizer, SPADELocalizer, check_values


@pytest.fixture(scope="module")
def uks631g(water_xyz):
    """Water/6-31G B3LYP, the reference's CL oracle system."""
    mol = ref_build_molecule(water_xyz, "6-31g")
    return RefEngine(mol, xc="b3lyp", conv_tol=1e-9, max_cycle=100).kernel()


@pytest.fixture(scope="module", params=["sto-3g", "6-31g"])
def global_ks(request, water_uks, uks631g):
    return water_uks if request.param == "sto-3g" else uks631g


def _projector(c):
    return c @ c.swapaxes(-1, -2)


@pytest.mark.parametrize("n_active", [1, 2])
def test_spade_densities_match_reference(global_ks, n_active):
    theirs = RefSPADE(global_ks, n_active).localize()
    ours = SPADELocalizer(solution_from_reference(global_ks, "cpu"), n_active).localize()
    np.testing.assert_array_equal(ours.active_mo_inds, theirs.active_mo_inds)
    np.testing.assert_array_equal(ours.enviro_mo_inds, theirs.enviro_mo_inds)
    for name in ("dm_active", "dm_enviro", "dm_loc_occ"):
        np.testing.assert_allclose(getattr(ours, name).numpy(),
                                   np.asarray(getattr(theirs, name)), atol=1e-8)


def test_spade_check_values(global_ks):
    sol = solution_from_reference(global_ks, "cpu")
    check_values(SPADELocalizer(sol, 1).localize(), sol)


def test_get_fock_matches_reference(global_ks):
    sol = solution_from_reference(global_ks, "cpu")
    np.testing.assert_allclose(sol.get_fock().numpy(), np.asarray(global_ks.get_fock()),
                               atol=1e-9)


def test_concentric_localization_matches_reference(global_ks):
    theirs = RefCL(global_ks.copy(), 1)
    ref_sol = theirs.localize_virtual()
    ours = ConcentricLocalizer(solution_from_reference(global_ks, "cpu"), 1)
    sol = ours.localize_virtual()
    assert ours.shells == tuple(theirs.shells)
    assert tuple(sol.mo_coeff.shape) == np.asarray(ref_sol.mo_coeff).shape
    c_ref = np.asarray(ref_sol.mo_coeff)
    c = sol.mo_coeff
    # projector onto each accepted shell's span
    for spin in (0, 1):
        bounds = [0] + list(ours.shells[spin])
        for lo, hi in zip(bounds[:-1], bounds[1:]):
            np.testing.assert_allclose(_projector(c[spin][:, lo:hi]).numpy(),
                                       _projector(c_ref[spin][:, lo:hi]), atol=1e-8)
    for a, b in zip(ours.singular_values[0], theirs.singular_values[0]):
        np.testing.assert_allclose(a.numpy(), b, atol=1e-10)


def test_cl_shell_oracle(uks631g):
    """CL shell sizes [12, 13] (BASELINE.md:28)."""
    cl = ConcentricLocalizer(solution_from_reference(uks631g, "cpu"), 1)
    cl.localize_virtual()
    assert cl.shells[0] == cl.shells[1] == [12, 13]


def test_cl_other_projected_basis_raises(water_uks):
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        ConcentricLocalizer(solution_from_reference(water_uks, "cpu"), 1,
                            projected_basis="6-31g")


def test_interop_carries_solution(water_uks):
    sol = solution_from_reference(water_uks, "cpu")
    assert sol.mo_coeff.dtype == torch.float64
    assert sol.e_tot == water_uks.e_tot and sol.nelec == water_uks.nelec
    np.testing.assert_array_equal(sol.make_rdm1().numpy(), water_uks.make_rdm1())
