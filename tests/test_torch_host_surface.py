"""The host surface of nbed_tpu_torch against nbed_tpu's: the cc-pVDZ and
mass tables, Basis Set Exchange JSON files, the product grid and grid
levels, the engine's grid and geometry fields, the XYZ helpers and the
command line."""

import json
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from nbed_tpu.chem import build_molecule as ref_build_molecule
from nbed_tpu.chem import masses as ref_masses
from nbed_tpu.chem.basis import bse as ref_bse
from nbed_tpu.chem.basis import data_ccpvdz as ref_ccpvdz
from nbed_tpu.grids import build_grid as ref_build_grid
from nbed_tpu.scf.engine import SCFEngine as RefEngine
from nbed_tpu.utils import build_ordered_xyz_string as ref_build_ordered_xyz_string
from nbed_tpu_torch import nbed, utils
from nbed_tpu_torch.chem import build_molecule, masses
from nbed_tpu_torch.chem.basis import bse, data_ccpvdz, get_element_shells
from nbed_tpu_torch.grids import build_grid
from nbed_tpu_torch.scf import SCFEngine

torch.set_num_threads(1)

REPO = Path(__file__).resolve().parent.parent
SCF = dict(conv_tol=1e-10, dm_conv_tol=1e-8, max_cycle=100)
# a Basis Set Exchange file with a general contraction (two rows on one
# exponent block) and a fused sp shell
BSE_JSON = {
    "name": "toy",
    "elements": {
        "1": {"electron_shells": [
            {"angular_momentum": [0], "exponents": ["3.42525091", "0.62391373", "0.16885540"],
             "coefficients": [["0.15432897", "0.53532814", "0.44463454"],
                              ["0.0", "0.0", "1.0"]]}]},
        "8": {"electron_shells": [
            {"angular_momentum": [0], "exponents": ["130.7093200", "23.8088610", "6.4436083"],
             "coefficients": [["0.15432897", "0.53532814", "0.44463454"]]},
            {"angular_momentum": [0, 1], "exponents": ["5.0331513", "1.1695961", "0.3803890"],
             "coefficients": [["-0.09996723", "0.39951283", "0.70011547"],
                              ["0.15591627", "0.60768372", "0.39195739"]]}]},
    },
}


def test_tables_equal_reference():
    assert data_ccpvdz.CCPVDZ == ref_ccpvdz.CCPVDZ
    assert data_ccpvdz.CCPVDZ_GENERATED == ref_ccpvdz.CCPVDZ_GENERATED
    assert "Ar" not in data_ccpvdz.CCPVDZ
    assert masses.ISOTOPE_MASS_AMU == ref_masses.ISOTOPE_MASS_AMU
    assert masses.AMU_TO_ME == ref_masses.AMU_TO_ME


def test_ccpvdz_molecule_matches_reference(water_xyz):
    ours, theirs = build_molecule(water_xyz, "cc-pVDZ"), ref_build_molecule(water_xyz, "cc-pvdz")
    assert ours.nao == theirs.nao == 24
    for a, b in zip(ours.shells, theirs.shells):
        assert (a.l, a.atom, a.ao_offset) == (b.l, b.atom, b.ao_offset)
        np.testing.assert_allclose(a.coeffs, b.coeffs, rtol=1e-14)
    np.testing.assert_allclose(masses.atom_masses_me(ours), ref_masses.atom_masses_me(theirs),
                               rtol=0, atol=0)
    with pytest.warns(UserWarning, match="re-derived"):
        get_element_shells("cc-pvdz", "F")


def test_bse_json_matches_reference(tmp_path, water_xyz):
    path = tmp_path / "toy.json"
    path.write_text(json.dumps(BSE_JSON))
    table = bse.parse_bse_json(path)
    assert table == ref_bse.parse_bse_json(path)
    assert [l for l, _ in table["O"]] == [0, 0, 1] and len(table["H"]) == 2
    ours = build_molecule(water_xyz, str(path))
    assert ours.nao == ref_build_molecule(water_xyz, str(path)).nao == 9
    bse.register_bse_basis("Toy-BSE", path)
    assert build_molecule(water_xyz, "toy-bse").nao == 9
    with pytest.raises(KeyError, match="not available"):
        build_molecule(water_xyz, str(tmp_path / "missing.json"))


@pytest.mark.parametrize("scheme,level", [("reference", 1), ("reference", 3), ("product", 3)])
def test_grid_matches_reference(water_xyz, scheme, level):
    x = build_molecule(water_xyz, "sto-3g").coords + 0.05  # a geometry not the molecule's
    mol, ref_mol = build_molecule(water_xyz, "sto-3g"), ref_build_molecule(water_xyz, "sto-3g")
    kw = dict(scheme=scheme, level=level, n_rad=30, n_theta=10)
    points, weights = build_grid(mol, x, device="cpu", **kw)
    ref_points, ref_weights = ref_build_grid(ref_mol, np.asarray(x), **kw)
    np.testing.assert_allclose(points.numpy(), np.asarray(ref_points), rtol=0, atol=1e-12)
    np.testing.assert_allclose(weights.numpy(), np.asarray(ref_weights), rtol=0, atol=1e-12)


@pytest.mark.parametrize("xc,fields", [
    ("b3lyp", {"grid_scheme": "product", "grid_size": (40, 12)}),
    ("b3lyp", {"grid_level": 1}),
    ("b3lyp", {"coords": "displaced"}),
    (None, {"coords": "displaced"}),
])
def test_engine_fields_match_reference(water_xyz, xc, fields):
    if fields.get("coords") == "displaced":
        rng = np.random.default_rng(9)
        fields = {"coords": build_molecule(water_xyz, "sto-3g").coords
                  + rng.uniform(-0.1, 0.1, (3, 3))}
    ours = SCFEngine(build_molecule(water_xyz, "sto-3g"), xc=xc, device="cpu", **fields,
                     **SCF).kernel()
    theirs = RefEngine(ref_build_molecule(water_xyz, "sto-3g"), xc=xc, **fields, **SCF).kernel()
    assert ours.converged and abs(ours.e_tot - float(theirs.e_tot)) < 1e-8


def test_xyz_helpers_match_reference(tmp_path):
    struct = {0: ("H", (0.0, 0.0, 0.0)), 1: ("O", (0.0, 0.0, 0.96)), 2: ("H", (0.9, 0.0, 1.2))}
    ours = utils.build_ordered_xyz_string(struct, [1])
    assert ours == ref_build_ordered_xyz_string(struct, [1])
    assert ours.splitlines()[2].startswith("O")
    path = utils.save_ordered_xyz_file("water", struct, [1], tmp_path)
    assert path == tmp_path / "molecular_structures" / "water.xyz"
    assert path.read_text() == ours
    with pytest.raises(ValueError, match="do not exist"):
        utils.build_ordered_xyz_string(struct, [7])


def test_cli_runs_a_config_on_the_cpu(tmp_path, water_xyz):
    """``python -m nbed_tpu_torch.embed --config <json> --device cpu`` in a
    fresh interpreter prints the classical energy of an in-process
    ``nbed()`` of the same config, and writes its log in the working
    directory."""
    config = {"geometry": water_xyz, "n_active_atoms": 1, "basis": "STO-3G",
              "xc_functional": "b3lyp", "projector": "mu", "localization": "spade",
              "convergence": 1e-8}
    path = tmp_path / "water.json"
    path.write_text(json.dumps(config))
    env = {**os.environ, "PYTHONPATH": str(REPO), "OMP_NUM_THREADS": "1"}
    out = subprocess.run([sys.executable, "-m", "nbed_tpu_torch.embed", "--config", str(path),
                          "--device", "cpu"], capture_output=True, text=True, timeout=240,
                         cwd=tmp_path, env=env)
    assert out.returncode == 0, out.stderr
    line = next(ln for ln in out.stdout.splitlines() if ln.startswith("mu: classical_energy"))
    expected = nbed(str(path), device="cpu").classical_energy
    assert abs(float(line.split("=")[1]) - expected) < 1e-9
    assert (tmp_path / ".nbed.log").exists()
