"""The statevector VQE of nbed_tpu_torch against nbed_tpu's JAX objective
(``_ansatz_program`` + ``_expectation_program`` under jax.value_and_grad)
at seeded amplitudes on H2 and on 12-qubit reduced water; the adjoint
sweep against plain autograd; full VQE on H2 against FCI."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nbed_tpu.chem import build_molecule as ref_build_molecule
from nbed_tpu.ham import HamiltonianBuilder as RefBuilder
from nbed_tpu.ham import reduce_virtuals as ref_reduce_virtuals
from nbed_tpu.ham.qubit import _grouped_weights, _ladder_factory as ref_ladder_factory
from nbed_tpu.scf.engine import SCFEngine as RefEngine
from nbed_tpu.solvers import vqe as ref_vqe
from nbed_tpu_torch.ham import pauli_sum_to_sparse
from nbed_tpu_torch.ham.qubit import _ladder_factory
from nbed_tpu_torch.solvers import run_adapt_vqe, run_fci, run_vqe, vqe

# one torch thread per test process: under pytest-xdist the OpenMP threads
# of several workers spin on the same cores and slow every worker many-fold
torch.set_num_threads(1)

CPU = torch.device("cpu")


@pytest.fixture(scope="module")
def h2_sq():
    mol = ref_build_molecule("2\n\nH 0.0 0.0 0.0\nH 0.616 0.0 0.0", "sto-3g")
    sol = RefEngine(mol, conv_tol=1e-12, dm_conv_tol=1e-10, max_cycle=100).kernel()
    c, h1, h2 = RefBuilder(sol, 0).build()
    return float(c), np.asarray(h1), np.asarray(h2)


@pytest.fixture(scope="module")
def water_sq(water_rhf):
    """Water with its highest virtual dropped: 12 spin orbitals, (5, 5)."""
    c, h1, h2 = RefBuilder(ref_reduce_virtuals(water_rhf, 1), 0).build()
    return float(c), np.asarray(h1), np.asarray(h2)


def _thetas(n, seed=4):
    return 0.2 * np.random.default_rng(seed).standard_normal(n)


def _reference_value_and_grad(sq, nelec, mapping, thetas):
    psum, _, dim, psi0, apply, arrays, _, _ = ref_vqe._ansatz_setup(*sq, nelec, mapping)
    ux, weights, _ = _grouped_weights(psum)
    energy_of = ref_vqe._expectation_program(ux, weights.real, dim)
    e, g = jax.value_and_grad(lambda t: energy_of(apply(t, psi0, *arrays)))(
        jnp.asarray(thetas))
    return float(e), np.asarray(g)


def _port(sq, nelec, mapping):
    return vqe._ansatz_setup(*sq, nelec, mapping, None, CPU)


@pytest.mark.parametrize("case,mapping", [("h2", "jw"), ("h2", "bk"), ("h2", "parity"),
                                          ("water", "jw"), ("water", "parity")])
def test_energy_and_gradient_match_reference(h2_sq, water_sq, case, mapping):
    sq, nelec = (h2_sq, (1, 1)) if case == "h2" else (water_sq, (5, 5))
    _, prog, psi0, n_params = _port(sq, nelec, mapping)
    thetas = _thetas(n_params)
    e, g = vqe._value_and_grad(thetas, psi0, prog)
    e_ref, g_ref = _reference_value_and_grad(sq, nelec, mapping, thetas)
    assert abs(e - e_ref) < 1e-10
    assert np.abs(g).max() > 1e-3
    np.testing.assert_allclose(g, g_ref, rtol=0, atol=1e-10)


def test_bit_parity_matches_bit_count():
    rng = np.random.default_rng(9)
    values = [0, 1, 2, 3, (1 << 62) - 1, (1 << 63) - 1, *rng.integers(0, 1 << 62, 200)]
    got = vqe._bit_parity(torch.tensor(values, dtype=torch.int64)).tolist()
    assert got == [int(v).bit_count() & 1 for v in values]


@pytest.mark.parametrize("case,mapping", [("h2", "bk"), ("water", "jw")])
def test_adjoint_sweep_matches_plain_autograd(h2_sq, water_sq, case, mapping):
    """The adjoint backward (one state, rotations un-applied) against
    reverse mode through the plain sweep (every state stored), with the
    dense Hamiltonian as the energy."""
    sq, nelec = (h2_sq, (1, 1)) if case == "h2" else (water_sq, (5, 5))
    psum, prog, psi0, n_params = _port(sq, nelec, mapping)
    theta = torch.tensor(_thetas(n_params, seed=8), requires_grad=True)
    (g,) = torch.autograd.grad(vqe._energy(theta, psi0, prog), theta)
    h = torch.tensor(pauli_sum_to_sparse(psum).toarray().real)
    theta_p = theta.detach().clone().requires_grad_(True)
    psi = vqe._sweep_plain(theta_p, psi0, prog)
    (g_plain,) = torch.autograd.grad(psi @ h @ psi, theta_p)
    torch.testing.assert_close(g, g_plain, rtol=0, atol=1e-12)
    # the final state of both sweeps is the same
    with torch.no_grad():
        torch.testing.assert_close(vqe._Sweep.apply(theta, psi0, prog), psi, rtol=0,
                                   atol=1e-14)


def test_blocked_hamiltonian_matches_dense(water_sq, monkeypatch):
    """H psi summed over many small blocks (a mask's terms split between
    blocks) equals the dense matrix product."""
    monkeypatch.setattr(vqe, "_BLOCK_ELEMS", 7 * 4096)
    psum, prog, _, _ = _port(water_sq, (5, 5), "jw")
    assert len(prog.blocks) > 50 and all(b[2].shape[0] <= 7 for b in prog.blocks)
    psi = torch.tensor(np.random.default_rng(2).standard_normal(4096))
    h = torch.tensor(pauli_sum_to_sparse(psum).toarray().real)
    torch.testing.assert_close(vqe._apply_hamiltonian(prog, psi), h @ psi,
                               rtol=0, atol=1e-11)


@pytest.mark.parametrize("mapping", ["jw", "bk", "parity"])
def test_h2_vqe_equals_fci(h2_sq, mapping):
    e_fci = run_fci(*h2_sq, 4, (1, 1))[0][0]
    res = run_vqe(*h2_sq, nelec=(1, 1), mapping=mapping, device="cpu")
    assert res.converged and res.n_qubits == 4 and res.n_params == 3
    assert res.e_vqe > e_fci - 1e-9 and abs(res.e_vqe - e_fci) < 1e-7
    assert res.e_reference > res.e_vqe


@pytest.mark.parametrize("mapping", ["jw", "bk", "parity"])
def test_ansatz_pieces_match_reference(mapping):
    n, nelec = 12, (3, 2)
    occ_mask, exc = vqe.uccsd_excitations(n, nelec)
    assert (occ_mask, exc) == ref_vqe.uccsd_excitations(n, nelec)
    assert vqe._encode_reference(occ_mask, mapping, n) == \
        ref_vqe._encode_reference(occ_mask, mapping, n)
    ours, theirs = _ladder_factory(mapping, n), ref_ladder_factory(mapping, n)
    for e in exc:
        assert vqe._generator_strings(e, ours) == ref_vqe._generator_strings(e, theirs)


def test_statevector_matches_reference(water_sq):
    _, _, _, n_params = _port(water_sq, (5, 5), "bk")
    thetas = _thetas(n_params, seed=6)
    ours = vqe.vqe_statevector(*water_sq, (5, 5), "bk", params=thetas, device="cpu")
    theirs = ref_vqe.vqe_statevector(*water_sq, (5, 5), "bk", params=thetas)
    np.testing.assert_allclose(ours, np.asarray(theirs), rtol=0, atol=1e-12)
    assert abs(np.linalg.norm(ours) - 1.0) < 1e-12


def test_register_cap_raises():
    n = vqe.MAX_QUBITS + 2
    with pytest.raises(ValueError, match="capped at 24 qubits"):
        run_vqe(0.0, np.eye(n), np.zeros((n,) * 4), nelec=(1, 1), device="cpu")


def test_adapt_vqe_h2_reaches_fci(h2_sq):
    e_fci = run_fci(*h2_sq, 4, (1, 1))[0][0]
    res = run_adapt_vqe(*h2_sq, nelec=(1, 1), grad_tol=1e-6, device="cpu")
    assert res.converged and res.op_indices
    assert abs(res.e_vqe - e_fci) < 1e-7
