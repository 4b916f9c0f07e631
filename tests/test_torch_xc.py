"""Grid and B3LYP XC quadrature of nbed_tpu_torch against nbed_tpu."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nbed_tpu.dft.xc import make_xc_fn as ref_make_xc_fn
from nbed_tpu.grids import build_grid as ref_build_grid
from nbed_tpu.grids import eval_aos as ref_eval_aos
from nbed_tpu.grids.lebedev import lebedev_grid as ref_lebedev_grid
from nbed_tpu_torch.dft import make_xc_fn, resolve_functional
from nbed_tpu_torch.grids import build_grid, eval_aos
from nbed_tpu_torch.grids.lebedev import LEBEDEV_PARAMS, lebedev_grid
from nbed_tpu_torch.interop import molecule_from_reference


@pytest.fixture(scope="module")
def grids(water_molecule):
    ref_pts, ref_w = ref_build_grid(water_molecule)
    pts, w = build_grid(molecule_from_reference(water_molecule), "cpu")
    return (np.asarray(ref_pts), np.asarray(ref_w)), (pts, w)


@pytest.fixture(scope="module")
def ao_tables(water_molecule, grids):
    (ref_pts, _), (pts, _) = grids
    ref = ref_eval_aos(water_molecule, jnp.asarray(ref_pts))
    ours = eval_aos(molecule_from_reference(water_molecule), pts)
    return ref, ours


def test_lebedev_rules_match_reference():
    for n in sorted(LEBEDEV_PARAMS):
        pts, wts = lebedev_grid(n)
        ref_pts, ref_wts = ref_lebedev_grid(n)
        np.testing.assert_array_equal(pts, ref_pts)
        np.testing.assert_array_equal(wts, ref_wts)


def test_grid_points_and_weights_match_reference(grids):
    (ref_pts, ref_w), (pts, w) = grids
    assert pts.dtype == torch.float64 and pts.shape == ref_pts.shape
    np.testing.assert_allclose(pts.numpy(), ref_pts, rtol=0, atol=1e-12)
    np.testing.assert_allclose(w.numpy(), ref_w, rtol=1e-12, atol=1e-12)


def test_ao_tables_match_reference(ao_tables):
    (ref_ao, ref_grad), (ao, grad) = ao_tables
    assert ao.shape == ref_ao.shape and grad.shape == ref_grad.shape
    np.testing.assert_allclose(ao.numpy(), np.asarray(ref_ao), rtol=0, atol=1e-12)
    np.testing.assert_allclose(grad.numpy(), np.asarray(ref_grad), rtol=0, atol=1e-12)


@pytest.mark.parametrize("name", ["b3lyp", "b3lyp5"])
def test_xc_energy_and_potential_match_reference(grids, ao_tables, water_uhf, name):
    """A seeded perturbation of the UHF density, spin-polarised so the VWN
    spin interpolation and both spin channels are exercised."""
    (_, ref_w), (_, w) = grids
    (ref_ao, ref_grad), (ao, grad) = ao_tables
    rng = np.random.default_rng(17)
    pert = 0.02 * rng.standard_normal((2,) + water_uhf.mo_coeff.shape[-2:])
    dm = water_uhf.make_rdm1() + pert + pert.swapaxes(-1, -2)
    exc_ref, vxc_ref = ref_make_xc_fn(ref_ao, ref_grad, jnp.asarray(ref_w), name)(
        jnp.asarray(dm))
    exc, vxc = make_xc_fn(ao, grad, w, name)(torch.tensor(dm))
    assert abs(float(exc) - float(exc_ref)) < 1e-10
    np.testing.assert_allclose(vxc.numpy(), np.asarray(vxc_ref), rtol=0, atol=1e-10)


def test_chunked_xc_equals_single_chunk(grids, ao_tables, water_uhf):
    (_, _), (_, w) = grids
    (_, _), (ao, grad) = ao_tables
    dm = torch.tensor(water_uhf.make_rdm1())
    e1, v1 = make_xc_fn(ao, grad, w, "b3lyp")(dm)
    e2, v2 = make_xc_fn(ao, grad, w, "b3lyp", chunk=4096)(dm)
    assert abs(float(e1) - float(e2)) < 1e-11
    torch.testing.assert_close(v1, v2, rtol=0, atol=1e-11)


@pytest.mark.parametrize("name", ["pbe", "wb97x", "m06"])
def test_unported_functionals_raise(name):
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        resolve_functional(name)
