"""nbed_tpu_torch.parallel against nbed_tpu.parallel: conformer-batched UHF
energies and gradients, lane freezing, meshes and padding, and the SCFs
split over a mesh's 'model' axis (water/STO-3G; the port's meshes name
the CPU more than once, the reference's is its one CPU device)."""

import numpy as np
import pytest
import torch

from nbed_tpu import parallel as ref
from nbed_tpu.chem import build_molecule as ref_build_molecule
from nbed_tpu_torch.chem import build_molecule
from nbed_tpu_torch.parallel import (batched_hf_energies, batched_hf_gradients, make_mesh,
                                     make_sharded_df_ks, make_sharded_df_scf, make_sharded_scf)
from nbed_tpu_torch.parallel.sharding import _lane_scf, pad_to_multiple
from nbed_tpu_torch.solvers.gradients import _hf_scf

torch.set_num_threads(1)

TIGHT = dict(conv_tol=1e-10, dm_conv_tol=1e-8, max_cycle=100)


@pytest.fixture(scope="module")
def mols(water_xyz):
    return build_molecule(water_xyz, "sto-3g"), ref_build_molecule(water_xyz, "sto-3g")


@pytest.fixture(scope="module")
def lanes(mols):
    """Two lanes: the water geometry and one O-H bond stretched by 0.03 bohr."""
    x = np.repeat(np.asarray(mols[0].coords)[None], 2, axis=0)
    x[1, 2, 2] += 0.03
    return x


def test_batched_hf_energies_match_reference(mols, lanes):
    e, conv = batched_hf_energies(mols[0], lanes, conv_tol=1e-10, max_cycle=100, device="cpu")
    e_ref, conv_ref = ref.batched_hf_energies(mols[1], lanes, conv_tol=1e-10, max_cycle=100)
    assert e.shape == (2,) and bool(conv.all()) and bool(np.all(np.asarray(conv_ref)))
    np.testing.assert_allclose(e.numpy(), np.asarray(e_ref), rtol=0, atol=1e-10)
    assert abs(float(e[0]) - -74.96099960129165) < 1e-6


def test_batched_hf_gradients_match_reference(mols, lanes):
    e, grad, conv = batched_hf_gradients(mols[0], lanes, device="cpu")
    e_ref, g_ref, _ = ref.batched_hf_gradients(mols[1], lanes)
    assert grad.shape == (2, 3, 3) and bool(conv.all())
    np.testing.assert_allclose(e.numpy(), np.asarray(e_ref), rtol=0, atol=1e-10)
    np.testing.assert_allclose(grad.numpy(), np.asarray(g_ref), rtol=0, atol=1e-9)
    assert float(grad.sum(dim=1).abs().max()) < 1e-9


def test_mesh_groups_equal_one_group(mols, lanes):
    """Lanes split over a mesh's 'batch' axis give the one-group result."""
    mesh = make_mesh(devices=["cpu"] * 2, batch=2)
    e, conv = batched_hf_energies(mols[0], lanes, mesh=mesh, conv_tol=1e-10, max_cycle=100)
    e1, _ = batched_hf_energies(mols[0], lanes, conv_tol=1e-10, max_cycle=100, device="cpu")
    assert bool(conv.all())
    np.testing.assert_allclose(e.numpy(), e1.numpy(), rtol=0, atol=1e-12)


def test_lanes_freeze_at_their_own_convergence(mols):
    """Lanes that converge in different numbers of cycles each end at their
    solo run's energy and density, in its number of cycles."""
    mol = mols[0]
    x = np.repeat(np.asarray(mol.coords)[None], 3, axis=0)
    x[:, 2, 2] += np.array([0.0, 0.3, 0.6])
    res, _ = _lane_scf(mol, torch.tensor(x), **TIGHT)
    assert len(set(res.n_iter.tolist())) > 1 and bool(res.converged.all())
    for b in range(3):
        solo, _ = _hf_scf(mol, torch.tensor(x[b]), **TIGHT)
        assert int(res.n_iter[b]) == solo.n_iter
        assert abs(float(res.e_elec[b]) - solo.e_elec) < 1e-10
        assert float((res.dm[b] - solo.dm).abs().max()) < 1e-9


def test_mesh_shapes():
    mesh = make_mesh(devices=["cpu"] * 8, batch=2)
    assert mesh.shape == {"batch": 2, "model": 4}
    assert make_mesh(4, devices=["cpu"] * 8).shape == {"batch": 1, "model": 4}
    with pytest.raises(ValueError, match="not divisible"):
        make_mesh(devices=["cpu"] * 8, batch=3)
    with pytest.raises(ValueError, match="asked for"):
        make_mesh(4, devices=["cpu"] * 2)


def test_pad_to_multiple():
    x = torch.arange(15.0).reshape(3, 5)
    y = pad_to_multiple(x, 4, axes=(0, 1))
    assert y.shape == (4, 8)
    assert torch.equal(y[:3, :5], x) and float(y[3:].abs().sum() + y[:, 5:].abs().sum()) == 0
    assert pad_to_multiple(x, 3).shape == (3, 5)


def _e_tot(res, mol):
    return float(res.e_elec) + float(mol.energy_nuc())


def test_sharded_scf_slabs_and_energy(mols):
    mol, rmol = mols
    fn, (hcore, s, slabs_j, slabs_k) = make_sharded_scf(mol, make_mesh(devices=["cpu"] * 2),
                                                        **TIGHT)
    m = mol.nao ** 2
    assert [tuple(a.shape) for a in slabs_j + slabs_k] == [(25, m)] * 4  # M = 49 -> 50
    assert float(slabs_j[1][-1].abs().max()) == 0  # the pad row
    res = fn(hcore, s, slabs_j, slabs_k)
    theirs = ref.sharded_scf(rmol, ref.make_mesh(1), **TIGHT)
    assert res.converged
    assert abs(_e_tot(res, mol) - _e_tot(theirs, rmol)) < 1e-9


def test_sharded_df_scf_slabs_and_energy(mols):
    mol, rmol = mols
    fn, (hcore, s, b) = make_sharded_df_scf(mol, make_mesh(devices=["cpu"] * 2), **TIGHT)
    n = mol.nao
    assert len({tuple(x.shape) for x in b}) == 1 and b[0].shape[0] == b[0].shape[2] == n
    res = fn(hcore, s, b)
    theirs = ref.sharded_df_scf(rmol, ref.make_mesh(1), **TIGHT)
    assert res.converged
    assert abs(_e_tot(res, mol) - _e_tot(theirs, rmol)) < 1e-8


@pytest.mark.parametrize("xc", ["b3lyp", "camb3lyp"])
def test_sharded_df_ks_slabs_and_energy(mols, xc):
    """The DF factor(s) split on the auxiliary axis and the grid on its
    points; the energy is the reference's on the same grid (level 3, the
    engine's default)."""
    mol, rmol = mols
    fn, args = make_sharded_df_ks(mol, make_mesh(devices=["cpu"] * 2), xc=xc, **TIGHT)
    ao_slabs, w_slabs = args[-3], args[-1]
    assert len(args) == (7 if xc == "camb3lyp" else 6)
    assert {tuple(a.shape) for a in ao_slabs} == {(w_slabs[0].shape[0], mol.nao)}
    res = fn(*args)
    theirs = ref.sharded_df_ks(rmol, ref.make_mesh(1), xc=xc, **TIGHT)
    assert res.converged
    assert abs(_e_tot(res, mol) - _e_tot(theirs, rmol)) < 1e-8


def test_padded_grid_points_add_nothing(mols):
    """Grid points of zero weight and zero AO values, as the split pads
    them, fall under the density mask: exc and Vxc stay finite and equal."""
    from nbed_tpu_torch.dft import make_xc_fn
    from nbed_tpu_torch.grids import build_grid, eval_aos

    mol = mols[0]
    points, weights = build_grid(mol, level=1, device="cpu")
    ao, ao_grad = eval_aos(mol, points)
    n = mol.nao
    rng = np.random.default_rng(4)
    dm = rng.standard_normal((2, n, n))
    dm = torch.tensor(0.05 * (dm + dm.swapaxes(-1, -2)) + 0.3 * np.eye(n))
    g = ao.shape[0] + 5  # five pad points
    exc, vxc = make_xc_fn(ao, ao_grad, weights, "b3lyp")(dm)
    exc_p, vxc_p = make_xc_fn(pad_to_multiple(ao, g), pad_to_multiple(ao_grad, g, axes=(1,)),
                              pad_to_multiple(weights, g), "b3lyp")(dm)
    assert torch.isfinite(vxc_p).all()
    assert abs(float(exc_p - exc)) < 1e-13 and float((vxc_p - vxc).abs().max()) < 1e-13
