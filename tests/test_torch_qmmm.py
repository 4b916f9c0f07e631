"""QM/MM point charges of nbed_tpu_torch against nbed_tpu: the MM term of
the host V (point and Gaussian-smeared charges), the nuclear-MM energy,
MM fields carried across by interop, and a water embedding in the field of
a TIP3P water through both drivers."""

from dataclasses import replace

import numpy as np
import pytest
import torch

from nbed_tpu import native as ref_native
from nbed_tpu.chem import build_molecule as ref_build_molecule
from nbed_tpu.config import NbedConfig as RefConfig
from nbed_tpu.driver import NbedDriver as RefDriver
from nbed_tpu_torch import NbedConfig, nbed
from nbed_tpu_torch.chem import build_molecule
from nbed_tpu_torch.driver import NbedDriver
from nbed_tpu_torch.integrals import native
from nbed_tpu_torch.interop import molecule_from_reference
from nbed_tpu_torch.scf import SCFEngine

# one torch thread per test process: under pytest-xdist the OpenMP threads
# of several workers spin on the same cores and slow every worker many-fold
torch.set_num_threads(1)

# a TIP3P water (O -0.834, H +0.417; Jorgensen et al., JCP 79, 926 (1983)),
# O-O 2.9 angstrom from the QM water, one H pointing at the QM oxygen;
# radii as given (the reference does not convert them)
MM = dict(mm_coords=[[0.0, 0.0, 3.0], [0.0, 0.0, 2.0428], [0.9266, 0.0, 3.2397]],
          mm_charges=[-0.834, 0.417, 0.417], mm_radii=[0.8, 0.4, 0.4])
MM_BOHR = dict(mm_coords=np.array([[5.0, 0.0, 0.0], [0.0, 5.0, 0.0]]),
               mm_charges=np.array([0.5, -0.3]))


@pytest.mark.parametrize("radii", [None, np.array([1.2, 0.7])],
                         ids=["point", "smeared"])
def test_one_electron_mm_term_matches_reference(water_molecule, radii):
    ref_mol = replace(water_molecule, **MM_BOHR, mm_radii=radii)
    ours = native.one_electron(molecule_from_reference(ref_mol))
    theirs = ref_native.one_electron(ref_mol)
    for a, b in zip(ours, theirs):
        np.testing.assert_allclose(a, b, rtol=0, atol=1e-12)
    plain = native.one_electron(molecule_from_reference(water_molecule))[2]
    assert np.abs(ours[2] - plain).max() > 1e-3  # the charges are felt


def test_molecule_from_reference_carries_mm(water_molecule):
    """Both sides of a parity test see the same MM charges: equal fields,
    energy_nuc and V on an MM-carrying reference molecule."""
    ref_mol = replace(water_molecule, **MM_BOHR, mm_radii=np.array([1.2, 0.7]))
    mol = molecule_from_reference(ref_mol)
    for name in ("mm_coords", "mm_charges", "mm_radii"):
        np.testing.assert_array_equal(getattr(mol, name), getattr(ref_mol, name))
    assert abs(mol.energy_nuc() - float(ref_mol.energy_nuc())) < 1e-12
    assert abs(mol.energy_nuc() - float(water_molecule.energy_nuc())) > 1e-3
    np.testing.assert_allclose(SCFEngine(mol, device="cpu").hcore.numpy(),
                               np.asarray(ref_native.one_electron(ref_mol)[1]
                                          + ref_native.one_electron(ref_mol)[2]),
                               rtol=0, atol=1e-12)


@pytest.mark.parametrize("unit", ["angstrom", "bohr"])
def test_build_molecule_mm_units_match_reference(water_xyz, unit):
    """mm_coords are converted with the geometry; mm_radii are not."""
    ours = build_molecule(water_xyz, "sto-3g", unit=unit, **MM)
    theirs = ref_build_molecule(water_xyz, "sto-3g", unit=unit, **MM)
    for name in ("mm_coords", "mm_charges", "mm_radii"):
        np.testing.assert_array_equal(getattr(ours, name), getattr(theirs, name))
    np.testing.assert_array_equal(ours.mm_radii, MM["mm_radii"])
    assert abs(ours.energy_nuc() - float(theirs.energy_nuc())) < 1e-12


@pytest.fixture(scope="module")
def drivers(nbed_args):
    args = {**nbed_args, "run_fci_emb": False, **MM}
    ref = RefDriver(RefConfig(**args))
    ref.embed()
    return nbed(**args, device="cpu"), ref


@pytest.mark.parametrize("key", ["e_rhf", "e_ccsd", "classical_energy", "hf_emb"])
def test_qmmm_driver_matches_nbed_tpu(drivers, key):
    ours, ref = drivers
    assert ours.run_qmmm and ref.run_qmmm
    assert abs(float(ours.mu[key]) - float(ref.mu[key])) < 1e-8


def test_qmmm_global_ks_and_nuclear_energy(drivers, nbed_args):
    ours, ref = drivers
    assert abs(ours._global_ks.e_tot - ref._global_ks.e_tot) < 1e-8
    assert abs(ours.e_nuc - ref.e_nuc) < 1e-12
    plain = NbedDriver(NbedConfig(**nbed_args), device="cpu")
    assert abs(ours.e_nuc - plain._ks_engine.energy_nuc()) > 1e-3


def test_two_of_three_mm_fields_run_without_mm(nbed_args):
    """As nbed_tpu/driver.py:67-69: all three fields or no MM at all."""
    args = {**nbed_args, "mm_coords": MM["mm_coords"], "mm_charges": MM["mm_charges"]}
    ours = NbedDriver(NbedConfig(**args), device="cpu")
    ref = RefDriver(RefConfig(**args))
    assert not ours.run_qmmm and not ref.run_qmmm
    assert ours._mol.mm_coords is None and ref._mol.mm_coords is None
