"""SCF of nbed_tpu_torch against nbed_tpu (water/STO-3G, float64 CPU)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nbed_tpu.scf.hf import run_scf as ref_run_scf
from nbed_tpu_torch.interop import molecule_from_reference
from nbed_tpu_torch.scf import SCFEngine, run_scf

# one torch thread per test process: under pytest-xdist the OpenMP threads
# of several workers spin on the same cores and slow every worker many-fold
torch.set_num_threads(1)

E_UHF = -74.96099960129165  # BASELINE.md:17


@pytest.fixture(scope="module")
def port_uhf_engine(water_molecule):
    return SCFEngine(molecule_from_reference(water_molecule), conv_tol=1e-10,
                     dm_conv_tol=1e-8, max_cycle=100, device="cpu")


@pytest.fixture(scope="module")
def port_uhf(port_uhf_engine):
    return port_uhf_engine.kernel()


def test_uhf_matches_reference_and_oracle(port_uhf, water_uhf):
    assert port_uhf.converged
    assert abs(port_uhf.e_tot - water_uhf.e_tot) < 1e-8
    assert abs(port_uhf.e_tot - E_UHF) < 1e-6
    np.testing.assert_allclose(port_uhf.make_rdm1().numpy(), water_uhf.make_rdm1(),
                               atol=1e-8)
    np.testing.assert_allclose(port_uhf.energy_elec(), water_uhf.energy_elec(),
                               atol=1e-8)


def test_mo_energies_match_reference(port_uhf, water_uhf):
    np.testing.assert_allclose(port_uhf.mo_energy.numpy(), water_uhf.mo_energy,
                               atol=1e-8)


@pytest.fixture(scope="module")
def huzinaga_inputs(water_uhf, water_uhf_engine):
    """A seeded embedding potential and the lowest occupied MO per spin as
    the Huzinaga environment."""
    n = water_uhf_engine.mol.nao
    rng = np.random.default_rng(3)
    v = 0.01 * rng.standard_normal((n, n))
    v_emb = np.stack([v + v.T, v + v.T])
    c = np.asarray(water_uhf.mo_coeff)
    dm_env = np.einsum("spi,sqi->spq", c[:, :, :1], c[:, :, :1])
    return dict(nelec=(4, 4), v_emb=v_emb, dm_env_occ=dm_env,
                conv_tol=1e-10, dm_conv_tol=1e-8, max_cycle=100)


@pytest.mark.parametrize("level_shift", [0.0, 0.25])
def test_huzinaga_run_scf_matches_reference(water_uhf_engine, port_uhf_engine,
                                            huzinaga_inputs, level_shift):
    ref_eng, port_eng = water_uhf_engine, port_uhf_engine
    kw = dict(huzinaga_inputs, level_shift=level_shift)
    theirs = ref_run_scf(hcore=ref_eng.hcore, s=ref_eng.s, eri_j=ref_eng.eri_j,
                         eri_k=ref_eng.eri_k,
                         **{k: jnp.asarray(v) if isinstance(v, np.ndarray) else v
                            for k, v in kw.items()})
    ours = run_scf(hcore=port_eng.hcore, s=port_eng.s, jk_fn=port_eng.get_jk,
                   **{k: torch.tensor(v) if isinstance(v, np.ndarray) else v
                      for k, v in kw.items()})
    assert ours.converged and bool(theirs.converged)
    assert abs(ours.e_elec - float(theirs.e_elec)) < 1e-8
    np.testing.assert_allclose(ours.dm.numpy(), np.asarray(theirs.dm), atol=1e-8)
    np.testing.assert_allclose(ours.huzinaga_op.numpy(), np.asarray(theirs.huzinaga_op),
                               atol=1e-8)


def test_sad_guess_matches_reference(port_uhf_engine, water_uhf_engine):
    np.testing.assert_allclose(port_uhf_engine._sad_guess().numpy(),
                               water_uhf_engine._sad_guess(), atol=1e-10)


def test_get_veff_matches_reference(port_uhf_engine, water_uhf_engine, water_uhf):
    dm = water_uhf.make_rdm1()
    ours = port_uhf_engine.get_veff(torch.tensor(dm))
    theirs = water_uhf_engine.get_veff(dm)
    np.testing.assert_allclose(ours.matrix.numpy(), np.asarray(theirs.matrix), atol=1e-12)
    assert abs(float(ours.ecoul) - float(theirs.ecoul)) < 1e-10
    assert abs(float(ours.exc) - float(theirs.exc)) < 1e-10


@pytest.mark.parametrize("device", ["cuda", "gpu"])
def test_unavailable_device_raises(water_molecule, device):
    if device == "cuda" and torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises((RuntimeError, ValueError)):
        SCFEngine(molecule_from_reference(water_molecule), device=device)


def test_spin_square_matches_reference(port_uhf, water_uhf):
    ours, theirs = port_uhf.spin_square(), water_uhf.spin_square()
    np.testing.assert_allclose(ours, theirs, atol=1e-8)
