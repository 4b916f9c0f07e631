"""The whole embedding slice of nbed_tpu_torch on the CPU against an
nbed_tpu NbedDriver run of the same config, and against the BASELINE
oracles at the reference tests' own tolerances."""

import json
import subprocess
import sys
import textwrap
from pathlib import Path

import numpy as np
import pytest
import torch

from nbed_tpu_torch import NbedConfig, nbed
from nbed_tpu_torch.driver import NbedDriver

REPO = Path(__file__).resolve().parent.parent

# BASELINE.md oracles (tests/test_driver.py:18,70,97)
E_UKS = -75.3091447400438
E_CCSD = -75.1285849238916
E_FCI = -75.12858550813999

# nbed_tpu on the PRA notebook acetonitrile config (the command that made
# them is in chip_smoke.py)
ACETONITRILE = """6

N\t1.2608\t0\t0
C\t0.1006\t0\t0
C\t-1.3613\t0\t0
H\t-1.75\t-0.8301\t0.5974
H\t-1.7501\t-0.1022\t-1.0175
H\t-1.75\t0.9324\t0.4202
"""
E_RHF_PRA = -130.51128805379804
E_CCSD_PRA = -130.6684176145549


@pytest.fixture(scope="module")
def port_driver(nbed_config):
    """Both projectors in one port run of the conftest config."""
    cfg = NbedConfig(**{**nbed_config.model_dump(mode="json"), "projector": "both"})
    driver = NbedDriver(cfg, device="cpu")
    driver.embed()
    return driver


@pytest.fixture(params=["mu", "huzinaga"])
def pair(request, port_driver):
    ref = request.getfixturevalue("mu_driver" if request.param == "mu" else "huz_driver")
    return getattr(port_driver, request.param), getattr(ref, request.param)


@pytest.mark.parametrize("key", ["e_rhf", "e_ccsd", "e_fci", "classical_energy",
                                 "hf_emb", "correction", "beta_correction"])
def test_energies_match_nbed_tpu(pair, key):
    ours, theirs = pair
    assert abs(float(ours[key]) - float(theirs[key])) < 1e-8


def test_second_quantised_matches_nbed_tpu(pair):
    (c, h1, h2), (c_ref, h1_ref, h2_ref) = pair[0]["second_quantised"], \
        pair[1]["second_quantised"]
    assert abs(c - c_ref) < 1e-8
    assert tuple(h1.shape) == h1_ref.shape and tuple(h2.shape) == h2_ref.shape
    assert h1.dtype == h2.dtype == torch.float64
    # the MO basis is fixed only up to signs and degenerate rotations; the
    # one-body spectrum is invariant
    np.testing.assert_allclose(np.linalg.eigvalsh(h1.numpy()),
                               np.linalg.eigvalsh(h1_ref), atol=1e-8)


def test_result_keys_match_nbed_tpu(pair):
    ours, theirs = pair
    assert set(ours) == set(theirs)


@pytest.mark.parametrize("projector", ["mu", "huzinaga"])
def test_baseline_oracles(port_driver, projector):
    res = getattr(port_driver, projector)
    assert abs(port_driver._global_ks.e_tot - E_UKS) < 2e-7
    assert abs(res["e_ccsd"] - E_CCSD) < 1e-5
    assert abs(res["e_fci"] - E_FCI) < 1e-5


def test_projectors_agree(port_driver):
    mu_scf, huz_scf = port_driver.embedded_scf
    assert mu_scf.converged and huz_scf.converged
    assert mu_scf.mo_coeff.shape == huz_scf.mo_coeff.shape
    assert abs(mu_scf.e_tot - huz_scf.e_tot) < 1e-5
    assert port_driver.classical_energy[0] == port_driver.mu["classical_energy"]


def test_subsystem_partition_identity(port_driver):
    """e_act + e_env + two_e_cross + e_nuc == global KS (BASELINE.md:26)."""
    d = port_driver
    total = d.e_act + d.e_env + d.two_e_cross + d.e_nuc
    assert abs(total - d._global_ks.e_tot) < 1e-6


def test_pra_acetonitrile_register_and_energies():
    """PRA 109, 022418 notebook config: 36 -> 28 qubits (BASELINE.md:39)."""
    driver = nbed(geometry=ACETONITRILE, n_active_atoms=2, basis="STO-3G",
                  xc_functional="b3lyp5", projector="huzinaga", localization="spade",
                  convergence=1e-6, run_ccsd_emb=True, device="cpu")
    res = driver.huzinaga
    assert res["second_quantised"][1].shape[0] == 28
    assert abs(res["e_rhf"] - E_RHF_PRA) < 1e-8
    assert abs(res["e_ccsd"] - E_CCSD_PRA) < 1e-8


def test_save_writes_scalar_results(port_driver, tmp_path):
    path = tmp_path / "result.json"
    port_driver._save(path)
    saved = json.loads(path.read_text())
    assert saved["mu"]["e_ccsd"] == port_driver.mu["e_ccsd"]
    assert saved["huzinaga"]["classical_energy"] == port_driver.huzinaga["classical_energy"]


def test_unported_config_raises_before_running(nbed_config):
    cfg = NbedConfig(**nbed_config.model_dump(mode="json"))
    cfg.run_dft_in_dft = True
    with pytest.raises(NotImplementedError, match="run_dft_in_dft"):
        NbedDriver(cfg, device="cpu")


def test_slice_imports_neither_jax_nor_pydantic():
    script = textwrap.dedent(f"""
        import sys
        sys.path.insert(0, {str(REPO)!r})
        from nbed_tpu_torch import nbed
        d = nbed(geometry={str(REPO / "tests/molecules/water.xyz")!r},
                 n_active_atoms=1, basis="STO-3G", xc_functional="b3lyp",
                 projector="mu", run_ccsd_emb=True, run_fci_emb=True, device="cpu")
        assert abs(d.mu["e_fci"] - ({E_FCI})) < 1e-5, d.mu["e_fci"]
        leaked = [m for m in ("jax", "jaxlib", "pydantic", "nbed_tpu") if m in sys.modules]
        assert not leaked, leaked
        print("clean")
    """)
    out = subprocess.run([sys.executable, "-c", script], capture_output=True,
                         text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip().endswith("clean")
