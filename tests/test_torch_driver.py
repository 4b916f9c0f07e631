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

from nbed_tpu.config import ProjectorTypes as RefProjector
from nbed_tpu.ham import pauli_ground_state as ref_pauli_ground_state
from nbed_tpu.ham.qubit import MAPPINGS as REF_MAPPINGS
from nbed_tpu.ham.taper import taper_auto as ref_taper_auto
from nbed_tpu.solvers.vqe import _encode_reference as ref_encode_reference
from nbed_tpu_torch import NbedConfig, nbed
from nbed_tpu_torch.chem import build_molecule
from nbed_tpu_torch.driver import NbedDriver
from nbed_tpu_torch.ham import MAPPINGS, pauli_ground_state
from nbed_tpu_torch.integrals import native
from nbed_tpu_torch.profiling import device_profile
from nbed_tpu_torch.scf import SCFEngine

# one torch thread per test process: under pytest-xdist the OpenMP threads
# of several workers spin on the same cores and slow every worker many-fold
torch.set_num_threads(1)

REPO = Path(__file__).resolve().parent.parent

# BASELINE.md oracles (tests/test_driver.py:18,70,97)
E_UKS = -75.3091447400438
E_CCSD = -75.1285849238916
E_FCI = -75.12858550813999
# DF against exact embedded FCI on water, the fitting error of the default
# auto-auxiliary basis: 1.7e-6 measured on the CPU, held to the 1e-5 of the
# embedded oracles
DF_FCI_GAP = 1e-5

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
# nbed_tpu's embedded VQE on the conftest water config (CCSD off, which
# leaves the SCFs as they are), from
#   JAX_PLATFORMS=cpu python -c "from nbed_tpu.driver import NbedDriver;
#   from nbed_tpu.config import NbedConfig; d = NbedDriver(NbedConfig(
#   geometry=open('tests/molecules/water.xyz').read(), n_active_atoms=1,
#   basis='STO-3G', xc_functional='b3lyp', projector=P, localization='spade',
#   convergence=1e-6, run_fci_emb=True, run_vqe_emb=True)); d.embed();
#   print(getattr(d, P)['e_vqe'])"
# with P = 'mu' and 'huzinaga'
E_VQE = {"mu": -75.1285919012455, "huzinaga": -75.12859115945318}


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


@pytest.fixture(scope="module")
def port_outputs(nbed_config):
    """Both projectors with the quantum outputs and the DFT-in-DFT check."""
    cfg = NbedConfig(**{**nbed_config.model_dump(mode="json"), "projector": "both",
                        "run_dft_in_dft": True, "run_vqe_emb": True,
                        "taper_qubits": True})
    driver = NbedDriver(cfg, device="cpu")
    driver.embed()
    return driver


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


def test_device_profile_of_host_work():
    """Work that stays on the host: its result passes through, its wall
    time is positive, and no device event is counted."""
    out, summary = device_profile(lambda: torch.ones(64, 64) @ torch.ones(64, 64))
    assert torch.equal(out, torch.full((64, 64), 64.0))
    assert summary["wall_s"] > 0
    assert summary["device_busy_s"] == 0 and summary["device_events"] == 0
    assert summary["device_idle_share"] == 1.0 and summary["top"] == []


@pytest.mark.parametrize("projector", ["mu", "huzinaga"])
def test_dft_in_dft_matches_nbed_tpu(port_outputs, mu_driver, huz_driver, projector):
    """The identities of tests/test_driver.py:49-57, and nbed_tpu's values."""
    ref_driver = mu_driver if projector == "mu" else huz_driver
    theirs = ref_driver._dft_in_dft(RefProjector(projector))
    ours = getattr(port_outputs, projector)
    for key in ("e_dft_in_dft", "emb_dft", "dft_correction", "dft_correction_beta"):
        assert abs(ours[key] - float(theirs[key])) < 1e-8, key
    assert ours["scf_dft"].converged
    e_ks = port_outputs._global_ks.e_tot
    assert abs(ours["e_dft_in_dft"] - e_ks) < (5e-6 if projector == "mu" else 1e-8)


def test_dft_in_dft_projectors_agree(port_outputs):
    assert abs(port_outputs.mu["e_dft_in_dft"]
               - port_outputs.huzinaga["e_dft_in_dft"]) < 5e-6


@pytest.mark.parametrize("projector", ["mu", "huzinaga"])
def test_tapered_register_matches_nbed_tpu(port_outputs, mu_driver, huz_driver,
                                           projector):
    """nbed_tpu's mapping and tapering of its own second-quantised output of
    the same run: the same counts, symmetries and sector, sum |c|^2 and
    identity coefficient, and the same tapered ground energy. The strings
    themselves are not compared: the MO basis of each package is fixed only
    up to signs and rotations among degenerate orbitals, which change which
    strings a mapping gives and their coefficients."""
    ref = getattr(mu_driver if projector == "mu" else huz_driver, projector)
    psum = REF_MAPPINGS["jw"](*ref["second_quantised"])
    occ = np.asarray(ref["scf"].mo_occ)
    bits = sum(1 << (2 * int(p)) for p in np.nonzero(occ[0] > 0)[0]) + \
        sum(1 << (2 * int(p) + 1) for p in np.nonzero(occ[1] > 0)[0])
    tapered, syms, sector = ref_taper_auto(
        psum, hf_bits=ref_encode_reference(bits, "jw", psum.n_qubits))
    res = getattr(port_outputs, projector)
    ours = res["tapered"]
    assert (ours["n_qubits_raw"], ours["n_qubits"], ours["n_terms_raw"],
            ours["n_terms"]) == (psum.n_qubits, tapered.n_qubits, len(psum),
                                 len(tapered))
    assert ours["n_qubits"] < ours["n_qubits_raw"]
    assert [(s.x, s.z, s.qubit) for s in ours["symmetries"]] == \
        [(s.x, s.z, s.qubit) for s in syms]
    assert list(ours["sector"]) == list(sector)
    # Tr(H^2)/2^n and Tr(H)/2^n of the tapered block: invariant under
    # orbital rotations that commute with the symmetries
    norm2 = sum(abs(c) ** 2 for c in ours["psum"].terms.values())
    assert abs(norm2 - sum(abs(c) ** 2 for c in tapered.terms.values())) < 1e-8 * norm2
    assert abs(ours["psum"].terms[(0, 0)] - tapered.terms[(0, 0)]) < 1e-8
    raw = MAPPINGS["jw"](*res["second_quantised"])
    e0 = pauli_ground_state(ours["psum"])[0]
    assert abs(e0 - ref_pauli_ground_state(tapered)[0]) < 1e-7
    assert abs(e0 - pauli_ground_state(raw)[0]) < 1e-9


@pytest.mark.parametrize("projector", ["mu", "huzinaga"])
def test_vqe_emb_within_bounds(port_outputs, projector):
    """As tests/test_vqe.py:91-101: variational against the embedded FCI
    and within UCCSD truncation of it, and nbed_tpu's e_vqe."""
    res = getattr(port_outputs, projector)
    assert res["vqe"].converged and res["vqe"].n_qubits == 10
    assert res["e_vqe"] > res["e_fci"] - 1e-9
    assert res["e_vqe"] - res["e_fci"] < 2e-4
    assert abs(res["e_vqe"] - E_VQE[projector]) < 1e-6


def test_vqe_emb_over_the_cap_warns_and_continues(caplog):
    """The PRA register has 28 qubits, past the statevector cap of 24: the
    driver logs a warning and keeps the other results (nbed_tpu/driver.py:
    616-628)."""
    with caplog.at_level("WARNING", logger="nbed_tpu_torch.driver"):
        driver = nbed(geometry=ACETONITRILE, n_active_atoms=2, basis="STO-3G",
                      xc_functional="b3lyp5", projector="huzinaga",
                      run_vqe_emb=True, device="cpu")
    assert "e_vqe" not in driver.huzinaga
    assert abs(driver.huzinaga["e_rhf"] - E_RHF_PRA) < 1e-8
    assert any("Skipping embedded VQE" in r.message and "24 qubits" in r.message
               for r in caplog.records)


def _excited_nbed_tpu(mu_driver, field, nroots):
    """What nbed_tpu's driver reports for ``field=nroots`` on the conftest mu
    config: its embedded solvers on its own embedded solution."""
    from nbed_tpu.driver import run_emb_cis, run_emb_rpa
    from nbed_tpu.solvers.cis import oscillator_strengths

    res = mu_driver.mu
    if field == "run_cis_emb":
        cis = run_emb_cis(res["scf"], nroots=nroots)
        return {"e_cis": res["e_rhf"] + cis.excitations,
                "cis_oscillator_strengths": oscillator_strengths(res["scf"], cis)[0]}
    rpa = run_emb_rpa(res["scf"])
    return {"e_rpa": res["e_rhf"] + rpa.excitations[:nroots],
            "rpa_oscillator_strengths": oscillator_strengths(res["scf"], rpa)[0][:nroots]}


def _assert_excited_match(ours: dict, theirs: dict):
    for key, value in theirs.items():
        assert np.asarray(ours[key]).shape == value.shape, key
        # energies to 1e-8 Ha, strengths to 1e-9 (non-degenerate roots)
        np.testing.assert_allclose(ours[key], value, rtol=0,
                                   atol=1e-8 if key.startswith("e_") else 1e-9)


@pytest.mark.parametrize("field", ["run_cis_emb", "run_rpa_emb"])
def test_cis_rpa_raise_naming_next_slice(nbed_config, mu_driver, field):
    """CIS/RPA raised until the one-electron slice; now the driver runs them
    and reports nbed_tpu's excitations and oscillator strengths."""
    cfg = NbedConfig(**{**nbed_config.model_dump(mode="json"), field: 2})
    driver = NbedDriver(cfg, device="cpu")
    driver.embed()
    key = "cis" if field == "run_cis_emb" else "rpa"
    assert key in driver.mu and f"e_{key}" in driver.mu
    _assert_excited_match(driver.mu, _excited_nbed_tpu(mu_driver, field, 2))


def test_unported_config_raises_before_running(nbed_config, mu_driver):
    """A config edited after validation (run_cis_emb = 1) used to raise in
    the driver's constructor; it now runs, with nbed_tpu's values."""
    cfg = NbedConfig(**nbed_config.model_dump(mode="json"))
    cfg.run_cis_emb = 1
    driver = NbedDriver(cfg, device="cpu")
    driver.embed()
    assert driver.mu["cis"].excitations.shape == (1,)
    _assert_excited_match(driver.mu, _excited_nbed_tpu(mu_driver, "run_cis_emb", 1))


def test_slice_imports_neither_jax_nor_pydantic():
    # one torch thread in the child too, as in every test process: beside
    # the other xdist workers its OpenMP threads would spin on busy cores
    script = textwrap.dedent(f"""
        import sys
        import torch
        torch.set_num_threads(1)
        sys.path.insert(0, {str(REPO)!r})
        from nbed_tpu_torch import nbed
        d = nbed(geometry={str(REPO / "tests/molecules/water.xyz")!r},
                 n_active_atoms=1, basis="STO-3G", xc_functional="b3lyp",
                 projector="mu", run_ccsd_emb=True, run_fci_emb=True, device="cpu")
        assert abs(d.mu["e_fci"] - ({E_FCI})) < 1e-5, d.mu["e_fci"]
        df = nbed(geometry={str(REPO / "tests/molecules/water.xyz")!r},
                  n_active_atoms=1, basis="STO-3G", xc_functional="b3lyp",
                  projector="mu", run_ccsd_emb=True, run_fci_emb=True,
                  density_fitting=True, device="cpu")
        assert df._use_df and df._hf_engine.df_b is df._ks_engine.df_b
        assert abs(df.mu["e_fci"] - d.mu["e_fci"]) < {DF_FCI_GAP}, df.mu["e_fci"]
        leaked = [m for m in ("jax", "jaxlib", "pydantic", "nbed_tpu") if m in sys.modules]
        assert not leaked, leaked
        print("clean")
    """)
    out = subprocess.run([sys.executable, "-c", script], capture_output=True,
                         text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip().endswith("clean")


# the driver's two SCF engines share one set of host integrals: exact ERIs,
# density fitting (no ERIs at all) and QM/MM water (MM charges in V)
SHARED = {"exact": {},
          "df": {"density_fitting": True},
          "qmmm": {"mm_coords": [[0.0, 0.0, 3.0], [0.0, 0.0, 2.0428], [0.9266, 0.0, 3.2397]],
                   "mm_charges": [-0.834, 0.417, 0.417], "mm_radii": [0.8, 0.4, 0.4]}}


@pytest.mark.parametrize("case", list(SHARED))
def test_driver_engines_share_one_set_of_integrals(nbed_args, case):
    """The HF engine takes the KS engine's S, hcore and ERIs, the very
    tensors, which are bitwise those of an engine built alone and are left
    as they were by a whole embedding run."""
    args = {**nbed_args, "run_ccsd_emb": False, "run_fci_emb": False, **SHARED[case]}
    driver = NbedDriver(NbedConfig(**args), device="cpu")
    ks, hf = driver._ks_engine, driver._hf_engine
    names = ("s", "hcore") if case == "df" else ("s", "hcore", "eri")
    for name in names:
        assert getattr(hf, name) is getattr(ks, name)
    alone = SCFEngine(driver._mol, device="cpu", density_fitting=driver._use_df)
    for name in names:
        assert torch.equal(getattr(ks, name), getattr(alone, name))
    before = {name: getattr(ks, name).clone() for name in names}
    driver.embed()
    for name in names:
        assert torch.equal(getattr(ks, name), before[name])
        assert getattr(hf, name) is getattr(ks, name)
    if case == "df":
        assert "eri" not in ks.__dict__ and "eri" not in hf.__dict__
    if case == "qmmm":
        assert driver.run_qmmm and driver._mol.mm_coords is not None


def test_warm_nbed_integrates_once(nbed_args):
    """A warm water nbed() makes one host one-electron and one ERI call."""
    args = {**nbed_args, "run_ccsd_emb": False, "run_fci_emb": False}
    nbed(**args, device="cpu")  # the SAD guess's atoms integrate once per process
    before = native.CALLS.copy()
    nbed(**args, device="cpu")
    added = native.CALLS - before
    assert added == {"one_electron": 1, "eri": 1}


@pytest.mark.parametrize("other", ["molecule", "coords", "backend"])
def test_integrals_from_refuses_another_geometry(water_xyz, other):
    mol = build_molecule(water_xyz, "sto-3g")
    source = SCFEngine(mol, device="cpu")
    kw = {"molecule": {"mol": build_molecule(water_xyz, "sto-3g")},
          "coords": {"coords": mol.coords + 0.01},
          "backend": {"integrals_backend": "torch"}}[other]
    with pytest.raises(ValueError, match="integrals_from"):
        SCFEngine(**{"mol": mol, **kw}, device="cpu", integrals_from=source)
