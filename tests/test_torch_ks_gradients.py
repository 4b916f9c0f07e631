"""Analytic KS nuclear gradients of nbed_tpu_torch, grid response and
range-separated exchange included, against nbed_tpu's (H2 and water/STO-3G),
and the grid's autograd against central differences."""

import numpy as np
import pytest
import torch

from nbed_tpu.chem import build_molecule as ref_build_molecule
from nbed_tpu.solvers.gradients import ks_gradient as ref_ks_gradient
from nbed_tpu_torch.chem import build_molecule
from nbed_tpu_torch.grids import build_grid, eval_aos
from nbed_tpu_torch.scf import SCFEngine
from nbed_tpu_torch.solvers import ks_gradient

torch.set_num_threads(1)

H2_XYZ = "2\n\nH 0.0 0.0 0.0\nH 0.0 0.0 0.74\n"
TIGHT = dict(conv_tol=1e-12, dm_conv_tol=1e-10, max_cycle=200)


@pytest.mark.parametrize("name,xc", [("h2", "svwn"), ("h2", "cam-b3lyp"),
                                     ("water", "b3lyp")])
def test_ks_gradient_matches_reference(water_xyz, name, xc):
    xyz = H2_XYZ if name == "h2" else water_xyz
    e_ref, g_ref, _ = ref_ks_gradient(ref_build_molecule(xyz, "sto-3g"), xc, **TIGHT)
    mol = build_molecule(xyz, "sto-3g")
    e, g, sol = ks_gradient(mol, xc, device="cpu", **TIGHT)
    assert sol.converged and g.shape == (mol.natm, 3)
    assert abs(e - float(e_ref)) < 1e-8
    np.testing.assert_allclose(g.numpy(), np.asarray(g_ref), rtol=0, atol=1e-8)
    assert np.abs(g.numpy().sum(axis=0)).max() < 1e-9


def test_h2_lda_gradient_matches_central_difference():
    """Grid response included, the gradient is that of the discretised
    energy: central differences of SCF energies on moved grids."""
    mol = build_molecule(H2_XYZ, "sto-3g")
    _, grad, _ = ks_gradient(mol, "svwn", device="cpu", **TIGHT)
    h = 1e-4
    for a in range(2):
        es = []
        for sgn in (1.0, -1.0):
            x = mol.coords.copy()
            x[a, 2] += sgn * h
            es.append(SCFEngine(mol, xc="svwn", coords=x, device="cpu", **TIGHT).kernel().e_tot)
        assert abs(float(grad[a, 2]) - (es[0] - es[1]) / (2 * h)) < 1e-6


@pytest.mark.parametrize("scheme", ["reference", "product"])
def test_grid_autograd_matches_central_difference(water_xyz, scheme):
    """d/dR of seeded linear functionals of the Becke weights and of the AO
    table on the moving grid."""
    mol = build_molecule(water_xyz, "sto-3g")
    kw = dict(scheme=scheme, level=1, n_rad=20, n_theta=8, device="cpu")
    n_points = build_grid(mol, **kw)[1].shape[0]
    rng = np.random.default_rng(6)
    w_pts = torch.tensor(rng.standard_normal(n_points))
    w_ao = torch.tensor(rng.standard_normal((n_points, mol.nao)))

    def f(x):
        points, weights = build_grid(mol, x, **kw)
        return torch.sum(w_pts * weights) + torch.sum(w_ao * eval_aos(mol, points, x)[0])

    x = torch.tensor(mol.coords, requires_grad=True)
    (grad,) = torch.autograd.grad(f(x), x)
    h = 1e-5
    fd = np.zeros((mol.natm, 3))
    with torch.no_grad():
        for idx in np.ndindex(mol.natm, 3):
            xp, xm = x.detach().clone(), x.detach().clone()
            xp[idx] += h
            xm[idx] -= h
            fd[idx] = (float(f(xp)) - float(f(xm))) / (2 * h)
    np.testing.assert_allclose(grad.numpy(), fd, rtol=1e-7, atol=1e-7)
