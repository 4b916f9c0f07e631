"""Checkpoint and resume of nbed_tpu_torch: SCF solutions round-trip
through ``.npz`` in both directions between the packages (the same keys),
a loaded solution warm-starts the SCF, and ``save_results`` writes
nbed_tpu's JSON keys, tensors included."""

import json

import numpy as np
import pytest
import torch

from nbed_tpu import checkpoint as ref_checkpoint
from nbed_tpu_torch import checkpoint
from nbed_tpu_torch.config import NbedConfig
from nbed_tpu_torch.driver import NbedDriver
from nbed_tpu_torch.interop import molecule_from_reference, solution_from_reference
from nbed_tpu_torch.scf import SCFEngine

torch.set_num_threads(1)


@pytest.fixture(scope="module")
def port_uhf(water_molecule):
    return SCFEngine(molecule_from_reference(water_molecule), conv_tol=1e-10,
                     dm_conv_tol=1e-8, max_cycle=100, device="cpu").kernel()


def test_roundtrip(tmp_path, port_uhf):
    path = tmp_path / "scf.npz"
    checkpoint.save_solution(path, port_uhf)
    loaded = checkpoint.load_solution(path, port_uhf.engine)
    assert loaded.mo_coeff.dtype == torch.float64
    assert loaded.mo_coeff.device == port_uhf.engine.device
    assert torch.equal(loaded.mo_coeff, port_uhf.mo_coeff)
    assert torch.equal(loaded.mo_occ, port_uhf.mo_occ)
    assert loaded.e_tot == port_uhf.e_tot and loaded.converged == port_uhf.converged
    assert loaded.nelec == port_uhf.nelec and loaded.v_emb is None
    assert abs(loaded.energy_elec()[0] - port_uhf.energy_elec()[0]) < 1e-12


def test_port_file_loads_in_nbed_tpu(tmp_path, port_uhf, water_uhf_engine):
    path = tmp_path / "port.npz"
    checkpoint.save_solution(path, port_uhf)
    ref = ref_checkpoint.load_solution(path, water_uhf_engine)
    np.testing.assert_array_equal(ref.mo_coeff, port_uhf.mo_coeff.numpy())
    assert ref.e_tot == port_uhf.e_tot and ref.nelec == port_uhf.nelec
    with np.load(path) as ours:
        keys = set(ours.files)
    ref_path = tmp_path / "ref.npz"
    ref_checkpoint.save_solution(ref_path, ref)
    with np.load(ref_path) as theirs:
        assert keys == set(theirs.files)


def test_nbed_tpu_file_loads_in_port(tmp_path, mu_driver):
    """The embedded solution of nbed_tpu's driver, with its v_emb, saved by
    nbed_tpu and loaded onto the port's engine."""
    ref_sol = mu_driver.mu["scf"]
    path = tmp_path / "ref.npz"
    ref_checkpoint.save_solution(path, ref_sol)
    engine = solution_from_reference(ref_sol, "cpu").engine
    loaded = checkpoint.load_solution(path, engine)
    np.testing.assert_array_equal(loaded.mo_coeff.numpy(), ref_sol.mo_coeff)
    np.testing.assert_array_equal(loaded.v_emb.numpy(), ref_sol.v_emb)
    assert loaded.e_tot == ref_sol.e_tot and loaded.huzinaga_op is None


def test_restricted_and_huzinaga_roundtrip(tmp_path, water_molecule, port_uhf):
    eng = SCFEngine(molecule_from_reference(water_molecule), restricted=True,
                    conv_tol=1e-10, dm_conv_tol=1e-8, max_cycle=100, device="cpu")
    c = port_uhf.mo_coeff[:, :, :1]
    sol = eng.kernel(nelec=(4, 4), dm_env_occ=torch.einsum("spi,sqi->spq", c, c))
    assert sol.restricted and sol.huzinaga_op.ndim == 2
    path = tmp_path / "huz.npz"
    checkpoint.save_solution(path, sol)
    loaded = checkpoint.load_solution(path, eng)
    assert loaded.restricted and torch.equal(loaded.huzinaga_op, sol.huzinaga_op)
    assert torch.equal(loaded.make_rdm1(), sol.make_rdm1())


def test_warm_restart_converges_fast(tmp_path, port_uhf):
    path = tmp_path / "scf.npz"
    checkpoint.save_solution(path, port_uhf)
    loaded = checkpoint.load_solution(path, port_uhf.engine)
    warm = port_uhf.engine.kernel(dm0=loaded.make_rdm1(), max_cycle=3)
    assert warm.converged and abs(warm.e_tot - port_uhf.e_tot) < 1e-8


def test_save_results_keys_match_nbed_tpu(tmp_path, nbed_config, mu_driver):
    driver = NbedDriver(NbedConfig(**nbed_config.model_dump(mode="json")), device="cpu")
    driver.embed()
    ours, theirs = tmp_path / "port.json", tmp_path / "ref.json"
    checkpoint.save_results(ours, driver)
    ref_checkpoint.save_results(theirs, mu_driver)
    a, b = checkpoint.load_results(ours), json.loads(theirs.read_text())
    assert set(a) == set(b)
    assert set(a["mu"]) == set(b["mu"])
    assert a["huzinaga"] is None and b["huzinaga"] is None
    assert abs(a["mu"]["e_rhf"] - b["mu"]["e_rhf"]) < 1e-6
    # tensors are written as lists: the embedding potential is kept
    np.testing.assert_allclose(a["mu"]["v_emb"], b["mu"]["v_emb"], atol=1e-6)
