"""MP2 and double hybrids of nbed_tpu_torch against nbed_tpu: the PT2
identity on HF orbitals (tests/test_double_hybrid.py) and B2PLYP on
water."""

import numpy as np
import pytest
import torch

from nbed_tpu.ham import HamiltonianBuilder as RefBuilder
from nbed_tpu.scf.engine import SCFEngine as RefEngine
from nbed_tpu.solvers import run_double_hybrid as ref_run_double_hybrid
from nbed_tpu.solvers import run_mp2 as ref_run_mp2
from nbed_tpu.solvers import run_pt2 as ref_run_pt2
from nbed_tpu_torch.ham import HamiltonianBuilder
from nbed_tpu_torch.interop import molecule_from_reference, solution_from_reference
from nbed_tpu_torch.scf import SCFEngine
from nbed_tpu_torch.solvers import run_double_hybrid, run_mp2, run_pt2

# one torch thread per test process: under pytest-xdist the OpenMP threads
# of several workers spin on the same cores and slow every worker many-fold
torch.set_num_threads(1)


def _interleaved(sol):
    eps, occ = sol.mo_energy.numpy(), sol.mo_occ.numpy()
    k = eps.shape[-1]
    eps_so = np.empty(2 * k)
    eps_so[0::2], eps_so[1::2] = eps[0], eps[1]
    mask = np.zeros(2 * k, dtype=bool)
    mask[0::2], mask[1::2] = occ[0] > 0, occ[1] > 0
    return eps_so, mask


@pytest.fixture(scope="module")
def carried_uhf(water_uhf):
    return solution_from_reference(water_uhf, device="cpu")


def test_pt2_equals_mp2_on_hf_orbitals(carried_uhf):
    """The reference test's own check (np.isclose at atol 1e-9, so also
    rtol 1e-5): the canonical Fock diagonal equals the HF eigenvalues up to
    the SCF's convergence, 1.0e-9 Ha apart in E(2) here on both sides."""
    _, h1, h2 = HamiltonianBuilder(carried_uhf, 0).build()
    eps_so, mask = _interleaved(carried_uhf)
    e2_mp2, _ = run_mp2(h1, h2, mask)
    assert np.isclose(run_pt2(h2, eps_so, mask), e2_mp2, atol=1e-9)


def test_mp2_matches_reference(water_uhf, carried_uhf):
    _, h1, h2 = HamiltonianBuilder(carried_uhf, 0).build()
    _, h1_ref, h2_ref = RefBuilder(water_uhf, 0).build()
    _, mask = _interleaved(carried_uhf)
    ours, theirs = run_mp2(h1, h2, mask), ref_run_mp2(h1_ref, h2_ref, mask)
    np.testing.assert_allclose(ours, theirs, rtol=0, atol=1e-10)
    eps_so, _ = _interleaved(carried_uhf)
    assert abs(run_pt2(h2, eps_so, mask) - ref_run_pt2(h2_ref, eps_so, mask)) < 1e-12


def test_b2plyp_double_hybrid_matches_reference(water_molecule):
    kw = dict(xc="b2plyp", conv_tol=1e-9, dm_conv_tol=1e-7, max_cycle=100)
    ref = RefEngine(water_molecule, **kw).kernel()
    ours = SCFEngine(molecule_from_reference(water_molecule), device="cpu", **kw).kernel()
    assert ours.converged and ref.converged
    e_tot, e_pt2 = run_double_hybrid(ours)
    e_tot_ref, e_pt2_ref = ref_run_double_hybrid(ref)
    assert abs(e_tot - e_tot_ref) < 1e-8
    assert abs(e_pt2 - e_pt2_ref) < 1e-8
    assert -0.2 < e_pt2 < -0.005
    assert e_tot == ours.e_tot + 0.27 * e_pt2


def test_run_double_hybrid_rejects_non_dh(carried_uhf):
    with pytest.raises(ValueError, match="double-hybrid"):
        run_double_hybrid(carried_uhf)
