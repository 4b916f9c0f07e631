"""Grid and XC quadrature of nbed_tpu_torch against nbed_tpu: every
registry functional, the meta-GGA tau path on the table and streaming
routes, and the unknown-name errors."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nbed_tpu.dft.functionals import FUNCTIONALS as REF_FUNCTIONALS
from nbed_tpu.dft.xc import make_xc_fn as ref_make_xc_fn
from nbed_tpu.dft.xc import make_xc_fn_streaming as ref_make_xc_fn_streaming
from nbed_tpu.grids import build_grid as ref_build_grid
from nbed_tpu.grids import eval_aos as ref_eval_aos
from nbed_tpu.grids.lebedev import lebedev_grid as ref_lebedev_grid
from nbed_tpu_torch.dft import make_xc_fn, make_xc_fn_streaming, resolve_functional
from nbed_tpu_torch.grids import build_grid, eval_aos
from nbed_tpu_torch.grids.lebedev import LEBEDEV_PARAMS, lebedev_grid
from nbed_tpu_torch.interop import molecule_from_reference
from nbed_tpu_torch.scf import SCFEngine

# one torch thread per test process: under pytest-xdist the OpenMP threads
# of several workers spin on the same cores and slow every worker many-fold
torch.set_num_threads(1)


@pytest.fixture(scope="module")
def grids(water_molecule):
    ref_pts, ref_w = ref_build_grid(water_molecule)
    pts, w = build_grid(molecule_from_reference(water_molecule), device="cpu")
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


# the composition strings of tests/test_xc_composition.py
COMPOSITIONS = ["0.2*HF + 0.08*SLATER + 0.72*B88 + 0.81*LYP + 0.19*VWN_RPA",
                "0.25*HF + 0.75*PBE, PBE",
                "0.19*HF + 0.46*LR_HF(0.33) + 0.35*B88 + 0.46*SR_B88(0.33) "
                "+ 0.19*VWN5 + 0.81*LYP",
                "0.5*b3lyp + 0.5*blyp", "b88,"]


@pytest.mark.parametrize("name", ["b3lyp", "b3lyp5"] + sorted(
    set(REF_FUNCTIONALS) - {"b3lyp", "b3lyp5", "hf"}) + COMPOSITIONS)
def test_xc_energy_and_potential_match_reference(grids, ao_tables, water_uhf, name):
    """A seeded perturbation of the UHF density, spin-polarised so the spin
    interpolations and both spin channels are exercised; the meta-GGAs
    through the tau path."""
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


def test_streaming_xc_matches_table_and_reference(water_molecule, grids, ao_tables,
                                                  water_uhf):
    """Streaming XC with a chunk that leaves a short last chunk, against the
    port's table XC and nbed_tpu's streaming XC (which pads instead)."""
    (ref_pts, ref_w), (pts, w) = grids
    (_, _), (ao, grad) = ao_tables
    dm = water_uhf.make_rdm1()
    chunk = 1000
    assert pts.shape[0] % chunk != 0
    exc_ref, vxc_ref = ref_make_xc_fn_streaming(
        water_molecule, jnp.asarray(water_molecule.coords), jnp.asarray(ref_pts),
        jnp.asarray(ref_w), "b3lyp", chunk=chunk)(jnp.asarray(dm))
    exc, vxc = make_xc_fn_streaming(molecule_from_reference(water_molecule), pts, w,
                                    "b3lyp", chunk=chunk)(torch.tensor(dm))
    exc_t, vxc_t = make_xc_fn(ao, grad, w, "b3lyp")(torch.tensor(dm))
    assert abs(float(exc) - float(exc_t)) < 1e-10
    torch.testing.assert_close(vxc, vxc_t, rtol=0, atol=1e-10)
    assert abs(float(exc) - float(exc_ref)) < 1e-10
    np.testing.assert_allclose(vxc.numpy(), np.asarray(vxc_ref), rtol=0, atol=1e-10)


def test_engine_streams_xc_above_table_limit(water_molecule, water_uhf):
    """A zero memory budget puts the engine on streaming XC (the switch of
    nbed_tpu/scf/engine.py:386-398); its veff equals the table path's."""
    mol = molecule_from_reference(water_molecule)
    table = SCFEngine(mol, xc="b3lyp", device="cpu")
    stream = SCFEngine(mol, xc="b3lyp", device="cpu", max_memory_mb=0.0)
    assert table._grid[0].shape[0] * mol.nao <= table._XC_TABLE_LIMIT
    assert stream._grid[0].shape[0] * mol.nao > stream._XC_TABLE_LIMIT
    dm = torch.tensor(water_uhf.make_rdm1())
    v_table, v_stream = table.get_veff(dm), stream.get_veff(dm)
    assert abs(float(v_table.exc) - float(v_stream.exc)) < 1e-10
    torch.testing.assert_close(v_table.matrix, v_stream.matrix, rtol=0, atol=1e-10)


def test_tau_path_streaming_matches_table_and_reference(water_molecule, grids,
                                                       ao_tables, water_uhf):
    """TPSS (tau path) streaming with a short last chunk, against the port's
    table XC and nbed_tpu's streaming XC."""
    (ref_pts, ref_w), (pts, w) = grids
    (_, _), (ao, grad) = ao_tables
    dm = water_uhf.make_rdm1()
    exc_ref, vxc_ref = ref_make_xc_fn_streaming(
        water_molecule, jnp.asarray(water_molecule.coords), jnp.asarray(ref_pts),
        jnp.asarray(ref_w), "tpss", chunk=1000)(jnp.asarray(dm))
    exc, vxc = make_xc_fn_streaming(molecule_from_reference(water_molecule), pts, w,
                                    "tpss", chunk=1000)(torch.tensor(dm))
    exc_t, vxc_t = make_xc_fn(ao, grad, w, "tpss")(torch.tensor(dm))
    assert abs(float(exc) - float(exc_t)) < 1e-10
    torch.testing.assert_close(vxc, vxc_t, rtol=0, atol=1e-10)
    assert abs(float(exc) - float(exc_ref)) < 1e-10
    np.testing.assert_allclose(vxc.numpy(), np.asarray(vxc_ref), rtol=0, atol=1e-10)


def test_hf_has_no_grid_terms(ao_tables, grids):
    (ref_ao, ref_grad), (ao, grad) = ao_tables
    (_, ref_w), (_, w) = grids
    assert make_xc_fn(ao, grad, w, "hf") is None
    assert ref_make_xc_fn(ref_ao, ref_grad, jnp.asarray(ref_w), "hf") is None


@pytest.mark.parametrize("name", ["m06", "hse06", "revtpss", "b97d"])
def test_unported_functionals_raise(name):
    """Families without primitives in either package raise the reference's
    KeyError and hint."""
    from nbed_tpu.dft.functionals import resolve_functional as ref_resolve

    with pytest.raises(KeyError) as ref_exc:
        ref_resolve(name)
    with pytest.raises(KeyError, match="Note: ") as exc:
        resolve_functional(name)
    assert str(exc.value) == str(ref_exc.value)
