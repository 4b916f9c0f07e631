"""Analytic HF nuclear gradients and geometry optimization of
nbed_tpu_torch against nbed_tpu's (H2 and water/STO-3G) and against central
differences of the port's own energies."""

import numpy as np
import pytest
import torch

from nbed_tpu.chem import build_molecule as ref_build_molecule
from nbed_tpu.solvers.gradients import hf_gradient as ref_hf_gradient
from nbed_tpu_torch.chem import build_molecule
from nbed_tpu_torch.interop import scf_result_from_reference
from nbed_tpu_torch.solvers import hf_gradient, optimize_geometry

torch.set_num_threads(1)

H2_XYZ = "2\n\nH 0.0 0.0 0.0\nH 0.0 0.0 0.74\n"
E_H2_MIN = -1.1175058843  # HF/STO-3G H2 minimum (tests/test_gradients.py:110)


@pytest.fixture(scope="module", params=["h2", "water"])
def case(request, water_xyz):
    xyz = H2_XYZ if request.param == "h2" else water_xyz
    ref_mol = ref_build_molecule(xyz, "sto-3g")
    e, g, res = ref_hf_gradient(ref_mol)
    return build_molecule(xyz, "sto-3g"), (float(e), np.asarray(g), res)


def test_hf_gradient_matches_reference(case):
    mol, (e_ref, g_ref, _) = case
    e, g, res = hf_gradient(mol, device="cpu")
    assert res.converged and g.shape == (mol.natm, 3) and g.dtype == torch.float64
    assert abs(e - e_ref) < 1e-9
    np.testing.assert_allclose(g.numpy(), g_ref, rtol=0, atol=1e-9)
    assert np.abs(g.numpy().sum(axis=0)).max() < 1e-10  # translational invariance


def test_hf_gradient_of_reference_scf_result(case):
    """The reference's converged SCF state fed through interop: the gradient
    functional alone is compared."""
    mol, (e_ref, g_ref, res_ref) = case
    e, g, _ = hf_gradient(mol, scf_result=scf_result_from_reference(res_ref, "cpu"),
                          device="cpu")
    assert abs(e - e_ref) < 1e-12
    np.testing.assert_allclose(g.numpy(), g_ref, rtol=0, atol=1e-11)


def test_h2_gradient_matches_central_difference():
    mol = build_molecule(H2_XYZ, "sto-3g")
    _, grad, _ = hf_gradient(mol, device="cpu")
    h = 1e-4
    fd = np.zeros((2, 3))
    for a in range(2):
        for k in range(3):
            es = []
            for sgn in (1.0, -1.0):
                x = mol.coords.copy()
                x[a, k] += sgn * h
                es.append(hf_gradient(mol, coords=x, device="cpu")[0])
            fd[a, k] = (es[0] - es[1]) / (2 * h)
    np.testing.assert_allclose(grad.numpy(), fd, rtol=0, atol=5e-8)
    # stretched H2 at 0.74 A: the atoms pull toward each other along z
    assert float(grad[0, 2]) * float(grad[1, 2]) < 0


def test_h2_geometry_optimization():
    mol = build_molecule(H2_XYZ, "sto-3g")
    coords, e, n_steps, ok = optimize_geometry(mol, gtol=5e-5, device="cpu")
    assert ok and n_steps > 1
    assert abs(e - E_H2_MIN) < 1e-7
    _, grad, _ = hf_gradient(mol, coords=coords, device="cpu")
    assert float(torch.max(torch.abs(grad))) < 5e-5
    assert 1.30 < float(np.linalg.norm(coords[1] - coords[0])) < 1.40  # bohr
