"""The quantum end's programs (``nbed_tpu_torch.solvers.vqe._AnsatzProgram``
and ``solvers.mp2._PT2Program``), uncaptured on the CPU, against the eager
route and against nbed_tpu: the sweep chunks that read their strings at a
device counter give the eager adjoint sweep's energy to the bit at any
chunk size (padding rows and a partial last chunk included), the value
and gradient nbed_tpu's ``jax.value_and_grad`` of its scan, ``run_vqe`` the
eager route's iterates, ADAPT nbed_tpu's trajectory with one program over
all its steps, and MP2/PT2 nbed_tpu's jitted contraction. Small registers
only: H2 (4 qubits) and water with its highest virtual dropped (12).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nbed_tpu.chem import build_molecule as ref_build_molecule
from nbed_tpu.ham import HamiltonianBuilder as RefBuilder
from nbed_tpu.ham import reduce_virtuals as ref_reduce_virtuals
from nbed_tpu.ham.qubit import _grouped_weights
from nbed_tpu.scf.engine import SCFEngine as RefEngine
from nbed_tpu.solvers import run_adapt_vqe as ref_run_adapt_vqe
from nbed_tpu.solvers import run_mp2 as ref_run_mp2
from nbed_tpu.solvers import run_pt2 as ref_run_pt2
from nbed_tpu.solvers import vqe as ref_vqe
from nbed_tpu_torch.ham import HamiltonianBuilder, pauli_sum_to_sparse
from nbed_tpu_torch.interop import solution_from_reference
from nbed_tpu_torch.ops.programs import RUNS
from nbed_tpu_torch.solvers import mp2, run_adapt_vqe, run_mp2, run_pt2, run_vqe, vqe

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


@pytest.fixture(autouse=True)
def _programs_on():
    """Every test starts on the program route with empty caches."""
    vqe._PROGRAMS.clear()
    mp2._PROGRAMS.clear()
    yield
    vqe._GRAPHED = mp2._GRAPHED = True


def _case(request, case):
    return (request.getfixturevalue("h2_sq"), (1, 1)) if case == "h2" else \
        (request.getfixturevalue("water_sq"), (5, 5))


def _thetas(n, seed=4):
    return 0.2 * np.random.default_rng(seed).standard_normal(n)


def _reference_value_and_grad(sq, nelec, mapping, thetas):
    psum, _, dim, psi0, apply, arrays, _, _ = ref_vqe._ansatz_setup(*sq, nelec, mapping)
    ux, weights, _ = _grouped_weights(psum)
    energy_of = ref_vqe._expectation_program(ux, weights.real, dim)
    e, g = jax.value_and_grad(lambda t: energy_of(apply(t, psi0, *arrays)))(
        jnp.asarray(thetas))
    return float(e), np.asarray(g)


# ------------------------------------------------------- (i) the chunks


@pytest.mark.parametrize("case,mapping", [("h2", "bk"), ("water", "jw")])
@pytest.mark.parametrize("chunk", ["1", "3", "N+5"])
def test_chunks_match_eager_sweep(request, case, mapping, chunk):
    """At 1, 3 and N + 5 rotations per chunk (3 and N + 5 pad the strings
    with c = 0 rows, 3 leaves a partial last chunk on water's 220): the
    energy and final state of the eager adjoint sweep to the bit, its
    gradient and reverse mode through the plain sweep within 1e-12."""
    sq, nelec = _case(request, case)
    psum, prog, psi0, n_params = vqe._ansatz_setup(*sq, nelec, mapping, None, CPU)
    n = len(prog.strings)
    k = {"1": 1, "3": 3, "N+5": n + 5}[chunk]
    ap = vqe._vqe_program(prog, psi0, k=k)
    assert ap.n_cap == -(-n // k) * k and ap.n_chunks == ap.n_cap // k
    thetas = _thetas(n_params, seed=8)
    e, g = ap.value_and_grad(thetas)
    state = ap.state(thetas)

    theta = torch.tensor(thetas, requires_grad=True)
    e_eager = vqe._energy(theta, psi0, prog)
    (g_eager,) = torch.autograd.grad(e_eager, theta)
    with torch.no_grad():
        state_eager = vqe._Sweep.apply(theta, psi0, prog).numpy()
    assert e == float(e_eager.detach())
    assert np.array_equal(state, state_eager)
    np.testing.assert_allclose(g, g_eager.numpy(), rtol=0, atol=1e-12)

    h = torch.tensor(pauli_sum_to_sparse(psum).toarray().real)
    theta_p = theta.detach().clone().requires_grad_(True)
    psi = vqe._sweep_plain(theta_p, psi0, prog)
    (g_plain,) = torch.autograd.grad(psi @ h @ psi, theta_p)
    np.testing.assert_allclose(g, g_plain.numpy(), rtol=0, atol=1e-12)
    np.testing.assert_allclose(state, psi.detach().numpy(), rtol=0, atol=1e-14)


# --------------------------------------------- (ii) against nbed_tpu's jit


@pytest.mark.parametrize("case,mapping", [("h2", "jw"), ("h2", "bk"), ("h2", "parity"),
                                          ("water", "jw"), ("water", "bk"),
                                          ("water", "parity")])
def test_program_value_and_grad_matches_reference(request, case, mapping):
    sq, nelec = _case(request, case)
    _, prog, psi0, n_params = vqe._ansatz_setup(*sq, nelec, mapping, None, CPU)
    thetas = _thetas(n_params)
    before = RUNS["vqe_host_reads"]
    e, g = vqe._vqe_program(prog, psi0, k=3).value_and_grad(thetas)
    assert RUNS["vqe_host_reads"] == before + 1
    e_ref, g_ref = _reference_value_and_grad(sq, nelec, mapping, thetas)
    assert abs(e - e_ref) < 1e-10
    assert np.abs(g).max() > 1e-3
    np.testing.assert_allclose(g, g_ref, rtol=0, atol=1e-10)


# ------------------------------------------------ (vi) the device counter


def test_counters_walk_the_strings(water_sq):
    """The forward counter advances one chunk per replay to the padded
    end and the backward one from there down to -1, so each chunk reads
    the next rotations; a chunk whose strings stayed fixed, as a body with
    a string baked in as a Python int does (here: its counter held at 0),
    applies the first chunk's rotations again and misses the eager state
    and energy by far more than (ii)'s 1e-10."""
    _, prog, psi0, n_params = vqe._ansatz_setup(*water_sq, (5, 5), "jw", None, CPU)
    ap = vqe._vqe_program(prog, psi0, k=3)
    thetas = _thetas(n_params)
    e, _ = ap.value_and_grad(thetas)
    assert int(ap.fwd) == ap.n_cap == 222 and int(ap.bwd) == -1
    with torch.no_grad():
        theta = torch.as_tensor(thetas)
        psi = vqe._Sweep.apply(theta, psi0, prog)

        ap.thetas[:n_params].copy_(theta)
        ap.prepare()
        for _ in range(ap.n_chunks):
            ap.fwd.zero_()
            ap.forward_chunk()
        held = ap.psi.clone()
        ap.energy()
    assert float(torch.max(torch.abs(held - psi))) > 1e-3
    assert abs(float(ap.out[0]) - e) > 1e-4


# ------------------------------------------------- (iii) run_vqe's routes


@pytest.mark.parametrize("case,mapping", [("h2", "jw"), ("h2", "parity"), ("water", "jw")])
def test_run_vqe_programs_equal_eager_route(request, case, mapping):
    sq, nelec = _case(request, case)
    graphed = run_vqe(*sq, nelec=nelec, mapping=mapping, device="cpu")
    vqe._GRAPHED = False
    eager = run_vqe(*sq, nelec=nelec, mapping=mapping, device="cpu")
    assert graphed.e_vqe == eager.e_vqe and graphed.e_reference == eager.e_reference
    assert graphed.n_iterations == eager.n_iterations > 0
    assert graphed.history == eager.history
    assert np.array_equal(graphed.params, eager.params)
    assert graphed.converged and eager.converged


def test_programs_cached_by_shape_and_reloaded(h2_sq):
    """A register of the same shapes (H2 at twice the coefficients, H2 under
    another mapping) reuses the program with its own operands copied in;
    a fifth ansatz shape evicts the least recently used (the limit is 4)."""
    c, h1, h2 = h2_sq
    e1 = run_vqe(c, h1, h2, nelec=(1, 1), device="cpu")
    e2 = run_vqe(2 * c, 2 * h1, 2 * h2, nelec=(1, 1), device="cpu")
    assert len(vqe._PROGRAMS) == 1 and abs(e2.e_reference - 2 * e1.e_reference) < 1e-12
    assert abs(e2.e_vqe - 2 * e1.e_vqe) < 1e-9
    bk = run_vqe(c, h1, h2, nelec=(1, 1), mapping="bk", device="cpu")
    assert abs(bk.e_vqe - e1.e_vqe) < 1e-9 and abs(bk.e_reference - e1.e_reference) < 1e-12
    again = run_vqe(c, h1, h2, nelec=(1, 1), device="cpu")
    assert again.e_vqe == e1.e_vqe and again.n_iterations == e1.n_iterations
    first = next(iter(vqe._PROGRAMS))
    excitations = vqe.uccsd_excitations(4, (1, 1))[1]
    for subset in (excitations[:1], excitations[:2], excitations[2:], excitations[1:]):
        run_vqe(c, h1, h2, nelec=(1, 1), excitations=subset, device="cpu")
    assert len(vqe._PROGRAMS) == vqe._PROGRAMS_MAX and first not in vqe._PROGRAMS


def test_statevector_through_program_equals_eager(water_sq):
    thetas = _thetas(35, seed=6)
    ours = vqe.vqe_statevector(*water_sq, (5, 5), "parity", params=thetas, device="cpu")
    vqe._GRAPHED = False
    eager = vqe.vqe_statevector(*water_sq, (5, 5), "parity", params=thetas, device="cpu")
    assert np.array_equal(ours, eager)
    assert abs(np.linalg.norm(ours) - 1.0) < 1e-12


def test_segment_sums_match_index_add():
    rng = np.random.default_rng(3)
    pidx = np.sort(rng.integers(0, 7, 40)).tolist()
    values = torch.tensor(rng.standard_normal(40))
    seg = torch.as_tensor(vqe._segments(pidx, 8))
    assert seg.shape == (8, max(pidx.count(p) for p in range(8)))
    got = vqe._segment_sums(values, seg)
    want = torch.zeros(8, dtype=torch.float64).index_add_(0, torch.tensor(pidx), values)
    torch.testing.assert_close(got, want, rtol=0, atol=1e-14)


# ---------------------------------------------------------- (iv) ADAPT


def _adapt_with_pool_gradients(sq, nelec, monkeypatch, **kw):
    """run_adapt_vqe on the programs, with the pool gradients of each step."""
    seen = []
    pool_gradients = vqe._AnsatzProgram.pool_gradients

    def spy(self, x):
        grads = pool_gradients(self, x)
        seen.append(grads.copy())
        return grads

    monkeypatch.setattr(vqe._AnsatzProgram, "pool_gradients", spy)
    res = run_adapt_vqe(*sq, nelec=nelec, device="cpu", **kw)
    monkeypatch.undo()
    return res, seen


@pytest.mark.parametrize("case,max_ops", [("h2", 4), ("water", 3)])
def test_adapt_matches_reference(request, monkeypatch, case, max_ops):
    """Energies within 1e-8 of nbed_tpu's ADAPT; the operators compared
    step by step while the chosen |gradient| leads the runner-up by more
    than 1e-8 (spin partners tie, and rounding then picks either); the
    eager route equal to the bit; one program over all the steps."""
    sq, nelec = _case(request, case)
    before = dict(RUNS)
    ours, seen = _adapt_with_pool_gradients(sq, nelec, monkeypatch, max_ops=max_ops)
    runs = {k: v - before.get(k, 0) for k, v in RUNS.items()}
    ref = ref_run_adapt_vqe(*sq, nelec, max_ops=max_ops)
    assert abs(ours.e_vqe - ref.e_vqe) < 1e-8 and abs(ours.e_reference - ref.e_reference) < 1e-10
    for step, grads in enumerate(seen[:len(ours.op_indices)]):
        top = np.sort(np.abs(grads))[::-1]
        if top[0] - top[1] <= 1e-8:
            break
        assert ours.op_indices[step] == ref.op_indices[step]
        (_, g, e), (_, g_ref, e_ref) = ours.history[step], ref.history[step]
        assert abs(g - g_ref) < 1e-10 and abs(e - e_ref) < 1e-8

    assert len(vqe._PROGRAMS) == 1
    assert runs["adapt_pool"] > 0 and runs["adapt_grads"] == len(seen)
    assert runs["vqe_host_reads"] == len(seen) + runs["vqe_evaluations"] + 1

    vqe._GRAPHED = False
    eager = run_adapt_vqe(*sq, nelec=nelec, max_ops=max_ops, device="cpu")
    assert eager.e_vqe == ours.e_vqe and eager.op_indices == ours.op_indices
    assert eager.history == ours.history
    assert len(vqe._PROGRAMS) == 1


def test_adapt_pool_gradients_match_reference(water_sq):
    """One pool gradient at a grown ansatz: the program's chunks, the
    eager chunks (to the bit), and ``2 c <H psi|S psi>`` summed per operator
    in numpy on nbed_tpu's ansatz state with the dense H (1e-10; nbed_tpu's
    pool_gradients is local to its run_adapt_vqe)."""
    _, pool_prog, psi0, n_pool = vqe._ansatz_setup(*water_sq, (5, 5), "jw", None, CPU)
    ap = vqe._adapt_program(pool_prog, psi0, max_ops=4)
    ladder = vqe._ladder_factory("jw", 12)
    pool = vqe.uccsd_excitations(12, (5, 5))[1]
    ops = [16, 22, 3]
    ansatz = vqe._derived(pool_prog, [vqe._generator_strings(pool[k], ladder) for k in ops])
    ap.load_ansatz(ansatz)
    thetas = _thetas(3, seed=2)
    grads = ap.pool_gradients(thetas)
    with torch.no_grad():
        psi = vqe._Sweep.apply(torch.as_tensor(thetas), psi0, ansatz)
        eager = vqe._pool_gradients(pool_prog, psi).numpy()
    assert np.array_equal(grads, eager) and grads.shape == (n_pool,)

    psum, _, dim, _, apply, _, _, _ = ref_vqe._ansatz_setup(*water_sq, (5, 5), "jw")
    xs, zs, cs, pi = ref_vqe._stack_ansatz([vqe._generator_strings(pool[k], ladder)
                                            for k in ops])
    ref_psi = np.asarray(apply(jnp.asarray(thetas), jnp.asarray(psi0.numpy()), xs, zs, cs, pi))
    h = pauli_sum_to_sparse(vqe.MAPPINGS["jw"](*water_sq)).toarray().real
    h_psi = h @ ref_psi
    want = np.zeros(n_pool)
    for p, k in enumerate(pool):
        for c, x, z in vqe._generator_strings(k, ladder):
            j = np.arange(dim) ^ x
            par = j & z
            for shift in (8, 4, 2, 1):
                par = par ^ (par >> shift)
            sgn = 1 - 2 * (par & 1)
            want[p] += 2 * c * h_psi @ (sgn * ref_psi[j])
    np.testing.assert_allclose(grads, want, rtol=0, atol=1e-10)
    assert np.abs(grads).max() > 1e-3


def test_adapt_buffers_hold_repeated_operators(h2_sq):
    """The program's string buffers hold max_ops of the pool's longest
    operators, so a list that repeats one still loads."""
    _, pool_prog, psi0, _ = vqe._ansatz_setup(*h2_sq, (1, 1), "jw", None, CPU)
    ap = vqe._adapt_program(pool_prog, psi0, max_ops=5)
    longest = max(range(pool_prog.seg.shape[0]), key=lambda p: int((pool_prog.seg[p] <
                                                                    len(pool_prog.strings)).sum()))
    ladder = vqe._ladder_factory("jw", 4)
    strings = vqe._generator_strings(vqe.uccsd_excitations(4, (1, 1))[1][longest], ladder)
    ap.load_ansatz(vqe._derived(pool_prog, [strings] * 5))
    assert ap.n_params == 5 and ap.n_cap >= 5 * len(strings)
    with pytest.raises(ValueError, match="exceeds"):
        ap.load_ansatz(vqe._derived(pool_prog, [strings] * 6))


# ------------------------------------------------------------ (v) MP2


@pytest.fixture(scope="module")
def water_mp2(water_uhf):
    ours = solution_from_reference(water_uhf, device="cpu")
    _, h1, h2 = HamiltonianBuilder(ours, 0).build()
    _, h1_ref, h2_ref = RefBuilder(water_uhf, 0).build()
    eps, occ = ours.mo_energy.numpy(), ours.mo_occ.numpy()
    k = eps.shape[-1]
    eps_so = np.empty(2 * k)
    eps_so[0::2], eps_so[1::2] = eps[0], eps[1]
    mask = np.zeros(2 * k, dtype=bool)
    mask[0::2], mask[1::2] = occ[0] > 0, occ[1] > 0
    return h1, h2, np.asarray(h1_ref), np.asarray(h2_ref), eps_so, mask


def test_mp2_program_matches_reference_and_eager(water_mp2):
    h1, h2, h1_ref, h2_ref, eps_so, mask = water_mp2
    before = RUNS["mp2"]
    e2, e_hf = run_mp2(h1, h2, mask)
    e_pt2 = run_pt2(h2, eps_so, mask)
    assert RUNS["mp2"] == before + 2 and len(mp2._PROGRAMS) == 1
    ref_e2, ref_hf = ref_run_mp2(h1_ref, h2_ref, mask)
    assert abs(e2 - ref_e2) < 1e-12 and abs(e_hf - ref_hf) < 1e-10
    assert abs(e_pt2 - ref_run_pt2(h2_ref, eps_so, mask)) < 1e-12
    mp2._GRAPHED = False
    assert run_mp2(h1, h2, mask) == (e2, e_hf) and run_pt2(h2, eps_so, mask) == e_pt2
    assert RUNS["mp2"] == before + 2


def test_mp2_programs_keyed_by_shape(water_mp2):
    """Another occupation is another (no, nv) program; the first one is
    reused with its buffers reloaded."""
    h1, h2, _, _, _, mask = water_mp2
    e2, _ = run_mp2(h1, h2, mask)
    shifted = mask.copy()
    shifted[np.where(mask)[0][-1]] = False
    run_mp2(h1, h2, shifted)
    assert len(mp2._PROGRAMS) == 2
    assert run_mp2(h1, h2, mask)[0] == e2 and len(mp2._PROGRAMS) == 2
