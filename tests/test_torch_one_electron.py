"""The torch one-electron integrals of nbed_tpu_torch against nbed_tpu's JAX
integrals and against the port's C++ engine.

JAX compiles one program per (la, lb, Ka, Kb) class, so the parity runs on
water/STO-3G, plus one STO-3G x 6-31G cross overlap.
"""

import numpy as np
import pytest
import torch

from nbed_tpu.chem import build_molecule as ref_build_molecule
from nbed_tpu.integrals import core as ref_core
from nbed_tpu.integrals.md import e_table_1d as ref_e_table_1d
from nbed_tpu_torch.chem import build_molecule
from nbed_tpu_torch.integrals import core, native
from nbed_tpu_torch.integrals.md import e_table_1d

torch.set_num_threads(1)


@pytest.fixture(scope="module")
def mols(water_xyz):
    return {basis: (ref_build_molecule(water_xyz, basis), build_molecule(water_xyz, basis))
            for basis in ("sto-3g", "6-31g")}


@pytest.mark.parametrize("la,lb", [(la, lb) for la in range(3) for lb in range(3)])
def test_e_table_matches_reference(la, lb):
    """Seeded exponents and distances, broadcast over (pairs, Ka, Kb) in the
    port, one primitive pair at a time in the reference: to 1e-13."""
    rng = np.random.default_rng(100 * la + lb)
    a = rng.uniform(0.1, 8.0, (4, 3, 1))
    b = rng.uniform(0.1, 8.0, (4, 1, 2))
    d = rng.uniform(-2.5, 2.5, (4, 1, 1))
    ours = e_table_1d(la, lb, torch.tensor(a), torch.tensor(b), torch.tensor(d)).numpy()
    assert ours.shape == (4, 3, 2, la + 1, lb + 1, la + lb + 1)
    for p in range(4):
        for i in range(3):
            for j in range(2):
                theirs = np.asarray(ref_e_table_1d(la, lb, a[p, i, 0], b[p, 0, j], d[p, 0, 0]))
                np.testing.assert_allclose(ours[p, i, j], theirs, rtol=0, atol=1e-13)


@pytest.mark.parametrize("name", ["overlap", "kinetic", "dipole_integrals"])
def test_one_electron_matches_reference(mols, name):
    ref_mol, mol = mols["sto-3g"]
    ours = getattr(core, name)(mol, device="cpu")
    assert ours.dtype == torch.float64
    theirs = np.asarray(getattr(ref_core, name)(ref_mol))
    assert tuple(ours.shape) == theirs.shape
    np.testing.assert_allclose(ours.numpy(), theirs, rtol=0, atol=1e-12)


def test_overlap_cross_matches_reference(mols):
    (ref_a, mol_a), (ref_b, mol_b) = mols["sto-3g"], mols["6-31g"]
    ours = core.overlap_cross(mol_a, mol_b, device="cpu")
    theirs = np.asarray(ref_core.overlap_cross(ref_a, ref_b))
    assert tuple(ours.shape) == (mol_a.nao, mol_b.nao) == theirs.shape
    np.testing.assert_allclose(ours.numpy(), theirs, rtol=0, atol=1e-12)


@pytest.mark.parametrize("basis", ["sto-3g", "6-31g"])
def test_s_and_t_match_native_engine(mols, basis):
    _, mol = mols[basis]
    s, t, _ = native.one_electron(mol)
    np.testing.assert_allclose(core.overlap(mol, device="cpu").numpy(), s, rtol=0, atol=1e-12)
    np.testing.assert_allclose(core.kinetic(mol, device="cpu").numpy(), t, rtol=0, atol=1e-12)


def test_overlap_cross_of_one_basis_is_overlap(mols):
    _, mol = mols["6-31g"]
    np.testing.assert_allclose(core.overlap_cross(mol, mol, device="cpu").numpy(),
                               core.overlap(mol, device="cpu").numpy(), rtol=0, atol=1e-14)


def test_autograd_passes_through(mols):
    """d/dR of sum(S) by autograd against central differences: the module is
    item 12's first step, so no host step may break the graph."""
    _, mol = mols["sto-3g"]
    coords = torch.tensor(mol.coords, requires_grad=True)
    (grad,) = torch.autograd.grad(core.overlap(mol, coords, device="cpu").sum(), coords)
    h = 1e-5
    for atom, axis in ((0, 2), (1, 0)):
        plus, minus = mol.coords.copy(), mol.coords.copy()
        plus[atom, axis] += h
        minus[atom, axis] -= h
        fd = (core.overlap(mol, plus, device="cpu").sum()
              - core.overlap(mol, minus, device="cpu").sum()) / (2 * h)
        assert abs(float(grad[atom, axis]) - float(fd)) < 1e-8
