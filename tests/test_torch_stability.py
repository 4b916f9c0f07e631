"""SCF stability analysis of nbed_tpu_torch: the anchors of nbed_tpu's
tests/test_stability.py (equilibrium solutions stable; H2 past the
Coulson-Fischer point unstable, followed downhill to the broken-symmetry
UHF minimum), and the Hessian eigenvalues, modes and rotations against
nbed_tpu on the same integrals (1e-10)."""

import numpy as np
import pytest
import torch

from nbed_tpu.solvers import rotate_towards as ref_rotate
from nbed_tpu.solvers import run_stability as ref_stability
from nbed_tpu_torch.chem import build_molecule
from nbed_tpu_torch.ham import HamiltonianBuilder
from nbed_tpu_torch.interop import solution_from_reference
from nbed_tpu_torch.scf import SCFEngine
from nbed_tpu_torch.solvers import (StabilityResult, rotate_towards, run_stability,
                                    stable_scf)

torch.set_num_threads(1)


def _h2_engine(r_angstrom, **kwargs):
    mol = build_molecule(f"2\n\nH 0.0 0.0 0.0\nH {r_angstrom} 0.0 0.0", "sto-3g")
    return SCFEngine(mol, conv_tol=1e-12, dm_conv_tol=1e-10, max_cycle=200,
                     device="cpu", **kwargs)


def _occ_mask(sol):
    occ = sol.mo_occ.numpy()
    if occ.ndim == 1:
        occ = np.stack([occ / 2.0, occ / 2.0])
    mask = np.zeros(2 * occ.shape[-1], dtype=bool)
    mask[::2] = occ[0] > 0
    mask[1::2] = occ[1] > 0
    return mask


def _stability(sol, **kwargs):
    _, h1, h2 = HamiltonianBuilder(sol, 0.0).build()
    return run_stability(h1, h2, _occ_mask(sol), **kwargs)


@pytest.fixture(scope="module")
def stretched():
    engine = _h2_engine(2.5)
    return engine, engine.kernel()


def test_equilibrium_h2_is_stable():
    stab = _stability(_h2_engine(0.74).kernel())
    assert isinstance(stab, StabilityResult)
    assert stab.stable and stab.lowest > 0.1


def test_water_uhf_is_stable(water_uhf):
    stab = _stability(solution_from_reference(water_uhf, "cpu"), nroots=6)
    assert stab.stable and len(stab.eigenvalues) == 6
    assert np.all(np.diff(stab.eigenvalues) >= 0)


def test_stretched_h2_followed_to_uhf_minimum(stretched):
    engine, sym = stretched
    stab = _stability(sym)
    assert not stab.stable and stab.lowest < -0.05
    bs, stab_bs = stable_scf(engine, sol=sym)
    assert stab_bs.stable
    assert bs.e_tot < sym.e_tot - 0.05
    assert abs(bs.e_tot - 2 * (-0.46658185)) < 0.02  # two STO-3G H atoms
    assert bs.spin_square()[0] > 0.5


def test_stable_scf_from_restricted_solution():
    """A restricted engine reports the symmetric saddle as one (n, k) set;
    mode following rotates it per spin and an unrestricted engine
    re-converges downhill from the rotated density."""
    sym = _h2_engine(2.5, restricted=True).kernel()
    assert sym.restricted
    stab = _stability(sym)
    assert not stab.stable
    assert tuple(rotate_towards(sym, stab, step=0.4).shape) == (2, 2, 2)
    bs, stab_bs = stable_scf(_h2_engine(2.5), sol=sym)
    assert stab_bs.stable and not bs.restricted
    assert bs.e_tot < sym.e_tot - 0.05


@pytest.mark.parametrize("case", ["water", "h2_stretched"])
def test_eigenvalues_match_nbed_tpu(water_uhf, stretched, case):
    if case == "water":
        sol = solution_from_reference(water_uhf, "cpu")
    else:
        sol = stretched[1]
    _, h1, h2 = HamiltonianBuilder(sol, 0.0).build()
    occ = _occ_mask(sol)
    ours = run_stability(h1, h2, occ, nroots=8)
    theirs = ref_stability(h1.numpy(), h2.numpy(), occ, nroots=8)
    np.testing.assert_allclose(ours.eigenvalues, theirs.eigenvalues, rtol=0, atol=1e-10)
    np.testing.assert_array_equal(ours.pairs, theirs.pairs)
    assert ours.stable == theirs.stable
    # modes agree up to sign where the eigenvalue is simple
    gaps = np.diff(ours.eigenvalues)
    for r in range(len(ours.eigenvalues)):
        if (r == 0 or gaps[r - 1] > 1e-6) and (r == len(gaps) or gaps[r] > 1e-6):
            overlap = abs(float(ours.modes[r] @ theirs.modes[r]))
            assert abs(overlap - 1.0) < 1e-8


def test_rotation_matches_nbed_tpu(stretched):
    """C exp(step K) of the port (matrix_exp on the device) against the
    reference's eigh route, on the same mode."""
    _, sym = stretched
    stab = _stability(sym)

    class _Ref:  # nbed_tpu's rotate_towards reads mo_coeff only
        mo_coeff = sym.mo_coeff.numpy()

    for step in (0.3, 1.1):
        np.testing.assert_allclose(rotate_towards(sym, stab, step=step).numpy(),
                                   ref_rotate(_Ref, stab, step=step), atol=1e-12)
