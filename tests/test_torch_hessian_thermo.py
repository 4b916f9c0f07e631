"""Finite-difference Hessians, harmonic frequencies, IR intensities and RRHO
thermochemistry of nbed_tpu_torch against nbed_tpu's (H2/STO-3G, and the
host-side functions of water on shared inputs)."""

import numpy as np
import pytest
import torch

from nbed_tpu.chem import build_molecule as ref_build_molecule
from nbed_tpu.solvers import harmonic_frequencies as ref_harmonic_frequencies
from nbed_tpu.solvers import hessian as ref_hessian
from nbed_tpu.solvers import ir_intensities as ref_ir_intensities
from nbed_tpu.solvers import thermochemistry as ref_thermochemistry
from nbed_tpu_torch.chem import build_molecule
from nbed_tpu_torch.chem.masses import atom_masses_me
from nbed_tpu_torch.solvers import (dipole_derivative_fd, harmonic_frequencies, hessian,
                                    hessian_fd, ir_intensities, thermochemistry)

torch.set_num_threads(1)

H2_XYZ = "2\n\nH 0.0 0.0 0.0\nH 0.0 0.0 0.74\n"


@pytest.fixture(scope="module")
def h2_frequencies():
    ours = harmonic_frequencies(build_molecule(H2_XYZ, "sto-3g"), device="cpu")
    theirs = ref_harmonic_frequencies(ref_build_molecule(H2_XYZ, "sto-3g"))
    return ours, tuple(np.asarray(a) for a in theirs)


def test_h2_frequencies_match_reference(h2_frequencies):
    (freqs, _, hess), (ref_freqs, _, ref_hess) = h2_frequencies
    np.testing.assert_allclose(hess, ref_hess, rtol=0, atol=1e-8)
    # the stretch to 1e-3 cm^-1; the 5 projected TR modes are zeros
    assert abs(freqs[-1] - ref_freqs[-1]) < 1e-3
    assert np.all(np.abs(freqs[:5]) < 1.0) and np.all(np.abs(ref_freqs[:5]) < 1.0)


def test_h2_hessian_identities(h2_frequencies):
    """Symmetric, translation sum rule, 5 TR zeros, stretch in 3500-6500
    cm^-1 (tests/test_hessian.py's windows)."""
    (freqs, _, hess), _ = h2_frequencies
    assert np.allclose(hess, hess.T, atol=1e-12)
    assert np.abs(hess.reshape(6, 2, 3).sum(axis=1)).max() < 5e-6
    assert 3500.0 < freqs[-1] < 6500.0


def test_tr_projector_matches_reference(water_xyz):
    mol = build_molecule(water_xyz, "sto-3g")
    sqrt_m = np.sqrt(atom_masses_me(mol))
    ours = hessian._tr_projector(mol.coords, sqrt_m)
    theirs = ref_hessian._tr_projector(np.asarray(mol.coords), sqrt_m)
    assert ours.shape == theirs.shape == (9, 6)
    np.testing.assert_allclose(ours @ ours.T, theirs @ theirs.T, rtol=0, atol=1e-12)


def test_ir_intensities_and_thermochemistry_match_reference(water_xyz):
    """Shared seeded inputs (a symmetric 'Hessian''s modes, a dipole
    derivative, a spectrum): the host functions agree to 1e-12."""
    mol = build_molecule(water_xyz, "sto-3g")
    ref_mol = ref_build_molecule(water_xyz, "sto-3g")
    rng = np.random.default_rng(12)
    a = rng.standard_normal((9, 9))
    modes = np.linalg.eigh(a + a.T)[1]
    mu_x = rng.standard_normal((9, 3))
    np.testing.assert_allclose(ir_intensities(mol, modes, mu_x=mu_x),
                               ref_ir_intensities(ref_mol, modes, mu_x=mu_x),
                               rtol=1e-12, atol=0)
    freqs = np.array([0.0, 1e-3, -2.0, 5.0, 8.0, 12.0, 1650.0, 3700.0, 3810.0])
    for kw in ({}, {"temperature": 500.0, "symmetry_number": 2, "spin_degeneracy": 3}):
        ours = thermochemistry(mol, freqs, **kw)
        theirs = ref_thermochemistry(ref_mol, freqs, **kw)
        assert ours.keys() == theirs.keys()
        for key in ours:
            np.testing.assert_allclose(ours[key], theirs[key], rtol=1e-12, atol=0)


def test_h2_ir_intensities_are_zero():
    """A homonuclear stretch and the translations carry no dipole
    derivative."""
    mol = build_molecule(H2_XYZ, "sto-3g")
    mu_x = dipole_derivative_fd(mol, device="cpu")
    assert mu_x.shape == (6, 3) and np.abs(mu_x).max() < 1e-6


@pytest.mark.parametrize("fn", [hessian_fd, harmonic_frequencies, dipole_derivative_fd])
def test_mesh_equals_unmeshed(fn):
    """The 6N displaced lanes split over a mesh's 'batch' axis (two groups
    on one device) give the unmeshed batched call's result."""
    from nbed_tpu_torch.parallel import make_mesh

    mol = build_molecule(H2_XYZ, "sto-3g")
    mesh = make_mesh(devices=["cpu"] * 2, batch=2)
    ours, meshed = fn(mol, device="cpu"), fn(mol, mesh=mesh, device="cpu")
    for a, b in zip(*((o,) if isinstance(o, np.ndarray) else o for o in (ours, meshed))):
        np.testing.assert_allclose(b, a, rtol=0, atol=1e-12)
