"""Molecular properties of nbed_tpu_torch against nbed_tpu on the same HF
solutions (water/STO-3G neutral and its doublet cation): dipoles,
populations, charges, spin densities and cube files, to 1e-10."""

import numpy as np
import pytest
import torch

from nbed_tpu import properties as ref
from nbed_tpu.chem import build_molecule as ref_build_molecule
from nbed_tpu.scf.engine import SCFEngine as RefEngine
from nbed_tpu_torch import properties as port
from nbed_tpu_torch.interop import solution_from_reference

torch.set_num_threads(1)

ATOL = 1e-10


@pytest.fixture(scope="module")
def solutions(water_xyz):
    """{name: (reference solution, port solution)} for the neutral molecule
    and the doublet cation."""
    out = {}
    for name, charge, spin in (("neutral", 0, 0), ("cation", 1, 1)):
        mol = ref_build_molecule(water_xyz, "sto-3g", charge=charge, spin=spin)
        sol = RefEngine(mol, conv_tol=1e-10, dm_conv_tol=1e-8).kernel()
        out[name] = (sol, solution_from_reference(sol, "cpu"))
    return out


@pytest.mark.parametrize("name", ["neutral", "cation"])
@pytest.mark.parametrize("unit", ["debye", "au"])
def test_dipole_matches_reference(solutions, name, unit):
    theirs, ours = solutions[name]
    origin = (0.5, -1.0, 2.0)
    d0 = port.dipole_moment(ours, unit=unit)
    np.testing.assert_allclose(d0, ref.dipole_moment(theirs, unit=unit), rtol=0, atol=ATOL)
    d1 = port.dipole_moment(ours, origin=origin, unit=unit)
    np.testing.assert_allclose(d1, ref.dipole_moment(theirs, origin=origin, unit=unit),
                               rtol=0, atol=ATOL)
    # q * origin: no shift for the neutral molecule, -origin for the cation
    q = 0.0 if name == "neutral" else 1.0
    scale = port.DEBYE_PER_AU if unit == "debye" else 1.0
    np.testing.assert_allclose(d1, d0 - q * scale * np.asarray(origin), rtol=0, atol=ATOL)


@pytest.mark.parametrize("name", ["neutral", "cation"])
@pytest.mark.parametrize("fn", ["mulliken_populations", "lowdin_populations",
                                "mulliken_charges", "lowdin_charges"])
def test_populations_and_charges_match_reference(solutions, name, fn):
    theirs, ours = solutions[name]
    values = getattr(port, fn)(ours)
    np.testing.assert_allclose(values, getattr(ref, fn)(theirs), rtol=0, atol=ATOL)
    total = sum(theirs.nelec) if fn.endswith("populations") else theirs.mol.charge
    assert abs(values.sum() - total) < 1e-8


@pytest.mark.parametrize("scheme", ["mulliken", "lowdin"])
def test_doublet_spin_densities_match_reference(solutions, scheme):
    theirs, ours = solutions["cation"]
    sd = port.atomic_spin_densities(ours, scheme=scheme)
    np.testing.assert_allclose(sd, ref.atomic_spin_densities(theirs, scheme=scheme),
                               rtol=0, atol=ATOL)
    assert abs(sd.sum() - 1.0) < 1e-8
    with pytest.raises(ValueError, match="Unknown scheme"):
        port.atomic_spin_densities(ours, scheme="bogus")


@pytest.mark.parametrize("kind", ["density", "spin_density", "mo"])
def test_cube_values_match_reference(solutions, kind, tmp_path):
    theirs, ours = solutions["cation"]
    kw = dict(spacing=0.35, margin=3.0)
    if kind == "mo":
        vals = port.mo_cube(ours, 4, tmp_path / "ours.cube", spin=1, **kw)
        vals_ref = ref.mo_cube(theirs, 4, tmp_path / "ref.cube", spin=1, **kw)
    else:
        spin = kind == "spin_density"
        vals = port.density_cube(ours, tmp_path / "ours.cube", spin=spin, **kw)
        vals_ref = ref.density_cube(theirs, tmp_path / "ref.cube", spin=spin, **kw)
    assert vals.shape == vals_ref.shape
    np.testing.assert_allclose(vals, vals_ref, rtol=0, atol=ATOL)
    # the same layout: header, atoms and every value line but the generator's
    ours_lines = (tmp_path / "ours.cube").read_text().splitlines()
    ref_lines = (tmp_path / "ref.cube").read_text().splitlines()
    assert len(ours_lines) == len(ref_lines)
    assert ours_lines[0] == ref_lines[0] and ours_lines[2:7] == ref_lines[2:7]


def test_cube_grid_matches_reference(solutions):
    theirs, ours = solutions["neutral"]
    for a, b in zip(port.cube_grid(ours.mol, 4.0, 0.3), ref.cube_grid(theirs.mol, 4.0, 0.3)):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))
