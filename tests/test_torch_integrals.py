"""Integrals and molecule of nbed_tpu_torch against nbed_tpu (water/STO-3G)."""

import numpy as np
import pytest
import torch

from nbed_tpu.integrals import ao_to_mo_eri as ref_ao_to_mo_eri
from nbed_tpu.scf.engine import SCFEngine as RefEngine
from nbed_tpu_torch.chem import build_molecule
from nbed_tpu_torch.integrals import ao_to_mo_eri
from nbed_tpu_torch.interop import molecule_from_reference
from nbed_tpu_torch.scf import SCFEngine


@pytest.fixture(scope="module")
def engines(water_xyz, water_molecule):
    ref = RefEngine(water_molecule)
    port = SCFEngine(build_molecule(water_xyz, "sto-3g"), device="cpu")
    return ref, port


@pytest.mark.parametrize("name", ["s", "hcore", "eri", "eri_j", "eri_k"])
def test_operators_match_reference(engines, name):
    ref, port = engines
    ours = getattr(port, name)
    assert ours.dtype == torch.float64
    np.testing.assert_allclose(ours.numpy(), np.asarray(getattr(ref, name)),
                               rtol=0, atol=1e-12)


def test_energy_nuc_oracle(engines):
    assert abs(engines[1].energy_nuc() - 9.285714221677825) < 1e-12


def test_molecule_matches_reference(water_xyz, water_molecule):
    ours = build_molecule(water_xyz, "sto-3g")
    carried = molecule_from_reference(water_molecule)
    for mol in (ours, carried):
        assert mol.nao == water_molecule.nao and mol.nelec == water_molecule.nelec
        np.testing.assert_array_equal(mol.coords, water_molecule.coords)
        np.testing.assert_array_equal(mol.aoslice_by_atom(),
                                      water_molecule.aoslice_by_atom())
        for a, b in zip(mol.shells, water_molecule.shells):
            assert (a.l, a.atom, a.ao_offset) == (b.l, b.atom, b.ao_offset)
            np.testing.assert_allclose(a.coeffs, b.coeffs, rtol=1e-14)
            np.testing.assert_allclose(a.cart2sph, b.cart2sph, rtol=1e-14)


def test_ao_to_mo_eri_matches_reference(engines):
    ref, port = engines
    rng = np.random.default_rng(5)
    c1, c2 = rng.standard_normal((2, 7, 4))
    ours = ao_to_mo_eri(port.eri, *(torch.tensor(c) for c in (c1, c1, c2, c2)))
    theirs = ref_ao_to_mo_eri(ref.eri, c1, c1, c2, c2)
    np.testing.assert_allclose(ours.numpy(), np.asarray(theirs), rtol=0, atol=1e-12)


@pytest.mark.parametrize("basis", ["cc-pvdz", "basis.json"])
def test_unported_basis_raises(water_xyz, basis):
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        build_molecule(water_xyz, basis)
