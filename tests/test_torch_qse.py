"""Quantum subspace expansion of nbed_tpu_torch: the anchors of nbed_tpu's
tests/test_qse.py (singles-QSE on the HF state is CIS; a pool spanning the
sector reproduces its FCI spectrum from any state; the spectrum does not
depend on the encoding) and the energies against nbed_tpu's run_qse on the
same integrals (1e-10)."""

import numpy as np
import pytest
import torch

from nbed_tpu.solvers import run_qse as ref_qse
from nbed_tpu_torch.chem import build_molecule
from nbed_tpu_torch.driver import NbedDriver
from nbed_tpu_torch.ham import HamiltonianBuilder
from nbed_tpu_torch.interop import solution_from_reference
from nbed_tpu_torch.scf import SCFEngine
from nbed_tpu_torch.solvers import QSEResult, run_cis, run_fci, run_qse, run_vqe

torch.set_num_threads(1)


@pytest.fixture(scope="module")
def h2_hamiltonian():
    mol = build_molecule("2\n\nH 0.0 0.0 0.0\nH 0.616 0.0 0.0", "sto-3g")
    sol = SCFEngine(mol, conv_tol=1e-12, dm_conv_tol=1e-10, max_cycle=100,
                    device="cpu").kernel()
    return HamiltonianBuilder(sol, 0).build()


@pytest.fixture(scope="module")
def water(water_uhf):
    sol = solution_from_reference(water_uhf, "cpu")
    return sol, HamiltonianBuilder(sol, 0).build()


def test_sd_pool_is_exact_for_h2(h2_hamiltonian):
    const, h1, h2 = h2_hamiltonian
    exact, _ = run_fci(const, h1, h2, 4, (1, 1), k=4)
    res = run_qse(const, h1, h2, nelec=(1, 1), pool="sd", device="cpu")
    assert isinstance(res, QSEResult) and res.n_retained == 4
    np.testing.assert_allclose(res.energies[:4], exact[:4], rtol=0, atol=1e-9)


def test_mapping_independent(h2_hamiltonian):
    const, h1, h2 = h2_hamiltonian
    spectra = [run_qse(const, h1, h2, nelec=(1, 1), pool="sd", mapping=m,
                       device="cpu").energies for m in ("jw", "bk", "parity")]
    np.testing.assert_allclose(spectra[0], spectra[1], rtol=0, atol=1e-10)
    np.testing.assert_allclose(spectra[0], spectra[2], rtol=0, atol=1e-10)


def test_singles_on_hf_equals_cis(water):
    sol, (_, h1, h2) = water
    qse = run_qse(0.0, h1, h2, nelec=(5, 5), pool="singles", device="cpu")
    cis = run_cis(h1, h2, NbedDriver._interleaved_occ(sol))
    assert abs(qse.energies[0] + sol.energy_nuc() - sol.e_tot) < 1e-8
    assert len(qse.energies) == len(cis.excitations) + 1
    np.testing.assert_allclose(qse.excitations[1:], cis.excitations, rtol=0, atol=1e-10)


def test_on_vqe_state_h2(h2_hamiltonian):
    const, h1, h2 = h2_hamiltonian
    vqe = run_vqe(const, h1, h2, nelec=(1, 1), device="cpu")
    res = run_qse(const, h1, h2, nelec=(1, 1), pool="sd", params=vqe.params, device="cpu")
    exact, _ = run_fci(const, h1, h2, 4, (1, 1), k=4)
    assert abs(res.energies[0] - vqe.e_vqe) < 1e-8
    np.testing.assert_allclose(res.energies[:4], exact[:4], rtol=0, atol=1e-8)


@pytest.fixture(scope="module")
def h2_631g():
    mol = build_molecule("2\n\nH 0.0 0.0 0.0\nH 0.0 0.0 0.7408481486", "6-31g")
    sol = SCFEngine(mol, conv_tol=1e-12, dm_conv_tol=1e-10, max_cycle=100,
                    device="cpu").kernel()
    return HamiltonianBuilder(sol, 0).build()


@pytest.mark.parametrize("pool, mapping", [("singles", "jw"), ("sd", "bk"),
                                           ("sd", "parity")])
def test_energies_match_nbed_tpu(h2_631g, pool, mapping):
    """H2/6-31G (8 qubits) on the reference determinant."""
    const, h1, h2 = h2_631g
    ours = run_qse(const, h1, h2, nelec=(1, 1), pool=pool, mapping=mapping, device="cpu")
    theirs = ref_qse(const, h1.numpy(), h2.numpy(), nelec=(1, 1), pool=pool,
                     mapping=mapping)
    np.testing.assert_allclose(ours.energies, theirs.energies, rtol=0, atol=1e-10)
    assert (ours.n_operators, ours.n_retained) == (theirs.n_operators, theirs.n_retained)
    assert abs(ours.s_min_eig - theirs.s_min_eig) < 1e-10


def test_vqe_state_matches_nbed_tpu(h2_hamiltonian):
    const, h1, h2 = h2_hamiltonian
    params = np.array([0.03, -0.02, 0.11])  # two singles and the double
    ours = run_qse(const, h1, h2, nelec=(1, 1), pool="singles", params=params,
                   device="cpu")
    theirs = ref_qse(const, h1.numpy(), h2.numpy(), nelec=(1, 1), pool="singles",
                     params=params)
    np.testing.assert_allclose(ours.energies, theirs.energies, rtol=0, atol=1e-10)


def test_unknown_pool_raises(h2_hamiltonian):
    with pytest.raises(ValueError, match="unknown pool"):
        run_qse(*h2_hamiltonian, nelec=(1, 1), pool="triples", device="cpu")
