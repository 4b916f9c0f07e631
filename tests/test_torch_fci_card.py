"""The card route of nbed_tpu_torch's FCI (``solvers/fci.py::run_fci``): the
sector matrix written by ``csrc/fci_hamiltonian.cu`` and diagonalised by
cuSOLVER, held against the host route's ``sector_hamiltonian``.

A CUDA kernel has no CPU mode, so on the CPU the kernel's per-element rule
runs as its plain-torch twin (:func:`_twin_matrix`, here): pairs (I, J)
grouped by excitation degree, and in each group the operator strings that
take J to I, as ``csrc/fci_hamiltonian.cu`` sums them. That is a different
algorithm from the host oracle, which walks the terms, so holding the two
together pins the kernel's rule where no card is. The twin must give the
matrix of ``sector_hamiltonian``, the port's and ``nbed_tpu``'s, within
1e-12 on water's embedded mu sector (10 spin orbitals, (3, 3)), the
closed-shell (5, 5) and open-shell (5, 4) sectors of water's 14 spin
orbitals, H2 (1, 1), and a random h1 and h2 with no symmetry and
spin-mixing terms, which pin the sign and ordering rules. ``cuda``-marked
tests hold the kernel against the host oracle and the twin, and the card
route against the host route, on a card. Only the CPU tests import
``nbed_tpu`` (inside the test), so that ``pytest --noconftest -m cuda
tests/test_torch_fci_card.py`` runs on a machine without JAX.
"""

import numpy as np
import pytest
import torch

from nbed_tpu_torch import nbed
from nbed_tpu_torch.chem import build_molecule
from nbed_tpu_torch.driver import _embedded_hamiltonian, run_emb_fci
from nbed_tpu_torch.ham import HamiltonianBuilder
from nbed_tpu_torch.ops import fci_hamiltonian, fci_sigma
from nbed_tpu_torch.scf import SCFEngine
from nbed_tpu_torch.solvers import fci, fci_direct
from test_torch_fci_direct import IDS as DIRECT_IDS, SECTORS as DIRECT_SECTORS, spin_conserving

torch.set_num_threads(1)

WATER = "3\n\nO   0.0000  0.000  0.115\nH   0.0000  0.754  -0.459\nH   0.0000  -0.754  -0.459"
H2 = "2\n\nH 0.0 0.0 0.0\nH 0.0 0.0 0.74"
# the upstream's water example (tests/test_config.json), without the
# post-embedding solvers but the FCI
WATER_MU = dict(geometry=WATER, n_active_atoms=1, basis="STO-3G", xc_functional="b3lyp",
                projector="mu", localization="spade", virtual_localization="cl",
                convergence=1e-6, mu_level_shift=1e6)
CASES = ["water_mu", "water", "water_open", "h2", "asymmetric"]
SECTORS = {"water_mu": (3, 3), "water": (5, 5), "water_open": (5, 4), "h2": (1, 1),
           "asymmetric": (2, 2)}


def _hf_hamiltonian(geometry):
    sol = SCFEngine(build_molecule(geometry, "sto-3g"), conv_tol=1e-10, dm_conv_tol=1e-8,
                    max_cycle=100, device="cpu").kernel()
    return HamiltonianBuilder(sol, 0.0).build()


def _asymmetric(n=8, seed=7):
    """A random h1 and h2 with no symmetry, spin-mixing entries included
    (those leave the sector and count nowhere), and a constant."""
    rng = np.random.default_rng(seed)
    return 0.37, torch.tensor(rng.standard_normal((n, n))), \
        torch.tensor(rng.standard_normal((n, n, n, n)))


@pytest.fixture(scope="module")
def water_mu_driver():
    return nbed(device="cpu", **WATER_MU)


@pytest.fixture(scope="module")
def cases(water_mu_driver):
    """case -> (constant, h1, h2, n_spinorb, nelec), CPU tensors."""
    const, h1, h2, _ = _embedded_hamiltonian(water_mu_driver.mu["scf"], None)
    water = _hf_hamiltonian(WATER)
    out = {"water_mu": (const, h1, h2), "water": water, "water_open": water,
           "h2": _hf_hamiltonian(H2), "asymmetric": _asymmetric()}
    return {name: (*terms, terms[1].shape[0], SECTORS[name]) for name, terms in out.items()}


def _popcount(x):
    """Set bits of each nonnegative int64 (SWAR, as the host solver's)."""
    x = x - ((x >> 1) & 0x5555555555555555)
    x = (x & 0x3333333333333333) + ((x >> 2) & 0x3333333333333333)
    x = (x + (x >> 4)) & 0x0F0F0F0F0F0F0F0F
    return (x * 0x0101010101010101) >> 56


def _string_sign(x, steps):
    """Sign of applying ``steps``, (mode, create) pairs in order, to the
    bitstrings ``x``; 0 where a step annihilates an empty mode or creates an
    occupied one (the kernel's ``two_body_sign``/``one_body_sign``)."""
    sign = torch.ones(x.shape, dtype=torch.float64)
    for m, create in steps:
        bit = torch.ones_like(x) << m
        occupied = (x & bit) != 0
        ok = ~occupied if create else occupied
        odd = (_popcount(x & (bit - 1)) & 1) == 1
        sign = torch.where(ok, torch.where(odd, -sign, sign), torch.zeros_like(sign))
        x = x ^ bit
    return sign


def _two_body(h2, x, p, q, r, s):
    """h2[p,q,r,s] times the sign of a+_p a+_q a_r a_s on ``x``."""
    return h2[p, q, r, s] * _string_sign(x, ((s, False), (r, False), (q, True), (p, True)))


def _one_body(h1, x, p, q):
    return h1[p, q] * _string_sign(x, ((q, False), (p, True)))


def _twin_matrix(constant, h1, h2, basis):
    """The kernel's per-element rule in plain torch on the CPU: pairs (I, J)
    grouped by excitation degree popcount(I ^ J), and in each group the
    operator strings that take J to I (see ``csrc/fci_hamiltonian.cu``),
    each signed by applying it to J in the host's order."""
    n, dim = h1.shape[0], basis.numel()
    occ = ((basis[:, None] >> torch.arange(n)) & 1) == 1  # (D, n)
    degree = _popcount(basis[:, None] ^ basis[None, :])
    out = torch.zeros((dim, dim), dtype=torch.float64)

    # degree 0: the diagonal
    diag = torch.full((dim,), float(constant), dtype=torch.float64)
    for k in range(n):
        diag += _one_body(h1, basis, k, k)
        for l in range(n):
            if l != k:
                diag += _two_body(h2, basis, k, l, k, l) + _two_body(h2, basis, l, k, k, l)
    out[torch.arange(dim), torch.arange(dim)] = diag

    # degree 2: i created, j annihilated, each spectator k of I & J
    rows, cols = torch.nonzero(degree == 2, as_tuple=True)
    if rows.numel():
        x = basis[cols]
        i = torch.nonzero(occ[rows] & ~occ[cols])[:, 1]
        j = torch.nonzero(occ[cols] & ~occ[rows])[:, 1]
        val = _one_body(h1, x, i, j)
        for k in range(n):
            kk = torch.full_like(i, k)
            spectator = occ[rows, k] & occ[cols, k]
            terms = (_two_body(h2, x, i, kk, j, kk) + _two_body(h2, x, kk, i, j, kk)
                     + _two_body(h2, x, i, kk, kk, j) + _two_body(h2, x, kk, i, kk, j))
            val = val + torch.where(spectator, terms, torch.zeros_like(terms))
        out[rows, cols] = val

    # degree 4: (i1, i2) created, (j1, j2) annihilated, four orderings
    rows, cols = torch.nonzero(degree == 4, as_tuple=True)
    if rows.numel():
        x = basis[cols]
        i1, i2 = torch.nonzero(occ[rows] & ~occ[cols])[:, 1].reshape(-1, 2).unbind(1)
        j1, j2 = torch.nonzero(occ[cols] & ~occ[rows])[:, 1].reshape(-1, 2).unbind(1)
        out[rows, cols] = (_two_body(h2, x, i1, i2, j1, j2) + _two_body(h2, x, i2, i1, j1, j2)
                           + _two_body(h2, x, i1, i2, j2, j1)
                           + _two_body(h2, x, i2, i1, j2, j1))
    return out


def _basis(n, nelec, device="cpu"):
    return torch.as_tensor(fci.sector_basis(n, nelec), device=device)


def _cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")


@pytest.mark.parametrize("case", CASES)
def test_reference_rule_matches_host(cases, case):
    """The twin against the host oracle: the port's ``sector_hamiltonian``
    and the reference's, on the same inputs."""
    from nbed_tpu.solvers import fci as reference_fci

    const, h1, h2, n, nelec = cases[case]
    ham, basis = fci.sector_hamiltonian(const, h1, h2, n, nelec)
    ref_ham, ref_basis = reference_fci.sector_hamiltonian(const, h1.numpy(), h2.numpy(), n, nelec)
    ours = _twin_matrix(const, h1, h2, _basis(n, nelec))
    assert ours.shape == ham.shape and len(basis) == ham.shape[0]
    np.testing.assert_array_equal(basis, ref_basis)
    assert np.max(np.abs(ours.numpy() - ham.toarray())) <= 1e-12
    assert np.max(np.abs(ours.numpy() - ref_ham.toarray())) <= 1e-12


def test_cases_are_the_named_sectors(cases):
    dims = {name: len(fci.sector_basis(c[3], c[4])) for name, c in cases.items()}
    assert {name: c[3] for name, c in cases.items()} == {
        "water_mu": 10, "water": 14, "water_open": 14, "h2": 4, "asymmetric": 8}
    assert dims == {"water_mu": 100, "water": 441, "water_open": 735, "h2": 4,
                    "asymmetric": 36}


@pytest.mark.parametrize("case,k", [("water_mu", 1), ("water_mu", 3), ("water", 4),
                                    ("water_open", 3)])
def test_reference_eigenvalues_match_host_route(cases, case, k):
    """The card route's arithmetic on the CPU (the twin's matrix, then
    ``torch.linalg.eigvalsh``) against the host route's values, the port's
    and the reference's ``run_fci``."""
    from nbed_tpu.solvers import fci as reference_fci

    const, h1, h2, n, nelec = cases[case]
    vals, _ = fci.run_fci(const, h1, h2, n, nelec, k=k)
    ref_vals, _ = reference_fci.run_fci(const, h1.numpy(), h2.numpy(), n, nelec, k=k)
    ham = _twin_matrix(const, h1, h2, _basis(n, nelec))
    twin_vals = torch.linalg.eigvalsh(ham)[:k].numpy()
    np.testing.assert_allclose(twin_vals, vals, rtol=0, atol=1e-10)
    np.testing.assert_allclose(twin_vals, ref_vals, rtol=0, atol=1e-10)


def test_cpu_tensors_take_the_host_route(cases):
    const, h1, h2, n, nelec = cases["water_mu"]
    before = dict(fci.ROUTES)
    vals, basis = fci.run_fci(const, h1, h2, n, nelec, k=1)
    assert fci.ROUTES["host"] == before.get("host", 0) + 1
    assert fci.ROUTES["card"] == before.get("card", 0)
    np.testing.assert_array_equal(basis, fci.sector_basis(n, nelec))


@pytest.mark.parametrize("device,card", [("cuda", True), ("cuda:1", True), ("cpu", False),
                                         ("meta", False)])
def test_route_rule(device, card):
    """The route follows the device alone, whatever the sector's size."""
    assert fci._card_route(torch.device(device)) is card


@pytest.mark.parametrize("n,nelec,free_bytes,route", [
    (10, (3, 3), 10**6, "card"), (16, (4, 3), 245_862_400, "card"),
    (16, (4, 3), 245_862_399, "matrix_free"), (16, (4, 4), 80 * 10**9, "matrix_free"),
    (18, (4, 4), 40 * 10**9, "matrix_free"), (28, (7, 7), 80 * 10**9, "matrix_free"),
    (28, (7, 7), 5 * 2**30, None), (36, (9, 9), 80 * 10**9, None)])
def test_check_fits(n, nelec, free_bytes, route):
    """The dense card route up to DENSE_MAX determinants where its 2 D^2
    float64 fit, else the matrix-free route where its vectors and blocks
    fit; a sector that fits in neither raises, and nothing moves to the
    host."""
    if route is not None:
        assert fci._check_fits(n, nelec, 1, free_bytes, "cuda:0") == route
    else:
        with pytest.raises(torch.OutOfMemoryError, match="matrix-free"):
            fci._check_fits(n, nelec, 1, free_bytes, "cuda:0")


@pytest.mark.parametrize("n,nelec,free_bytes,route", [
    (10, (3, 3), 10**6, "card"), (16, (4, 4), 80 * 10**9, "card"),
    (18, (4, 4), 40 * 10**9, "card"), (18, (4, 4), 10**9, None),
    (28, (7, 7), 80 * 10**9, None)])
def test_check_fits_spin_mixing(n, nelec, free_bytes, route):
    """Terms that mix spins keep a sector above DENSE_MAX on the dense card
    route where its matrix fits, since the matrix-free route cannot take
    them; where the dense matrix does not fit the call raises and says why."""
    if route is not None:
        assert fci._check_fits(n, nelec, 1, free_bytes, "cuda:0", True) == route
    else:
        with pytest.raises(torch.OutOfMemoryError, match="mix spins"):
            fci._check_fits(n, nelec, 1, free_bytes, "cuda:0", True)


def test_dense_max_keeps_water_dense():
    """Water's embedded mu sector (100 determinants) stays on the dense
    route; acetonitrile's published 28-qubit sector does not."""
    assert fci._sector_dim(10, (3, 3)) <= fci.DENSE_MAX < fci._sector_dim(28, (7, 7))


@pytest.mark.parametrize("n,nelec", [(4, (1, 1)), (10, (3, 3)), (14, (5, 4)), (9, (3, 2)),
                                     (16, (4, 3)), (12, (0, 2))])
def test_sector_dim(n, nelec):
    assert fci._sector_dim(n, nelec) == len(fci.sector_basis(n, nelec))


def test_sector_matrix_checks_its_inputs():
    const, h1, h2 = _asymmetric(n=4)
    basis = _basis(4, (1, 1))
    with pytest.raises(ValueError):
        fci_hamiltonian.sector_matrix(const, h1.float(), h2, basis)
    with pytest.raises(ValueError):
        fci_hamiltonian.sector_matrix(const, h1, h2[:3], basis)
    with pytest.raises(ValueError):
        fci_hamiltonian.sector_matrix(const, h1, h2, basis.to(torch.int32))
    with pytest.raises(ValueError, match="CUDA"):
        fci_hamiltonian.sector_matrix(const, h1, h2, basis)  # no CPU build


@pytest.mark.cuda
@pytest.mark.parametrize("case", CASES)
def test_cuda_kernel_matches_reference(cases, case):
    _cuda()
    const, h1, h2, n, nelec = cases[case]
    before = fci_hamiltonian.LAUNCHES["fci_hamiltonian"]
    ours = fci_hamiltonian.sector_matrix(const, h1.cuda(), h2.cuda(), _basis(n, nelec, "cuda"))
    assert fci_hamiltonian.LAUNCHES["fci_hamiltonian"] == before + 1
    oracle = fci.sector_hamiltonian(const, h1, h2, n, nelec)[0].toarray()
    assert np.max(np.abs(ours.cpu().numpy() - oracle)) <= 1e-12
    twin = _twin_matrix(const, h1, h2, _basis(n, nelec))
    assert float(torch.max(torch.abs(ours.cpu() - twin))) <= 1e-12


@pytest.mark.cuda
@pytest.mark.parametrize("case,k", [("water_mu", 1), ("water_mu", 3), ("water", 1),
                                    ("water", 3), ("water_open", 3), ("h2", 1),
                                    ("asymmetric", 3)])
def test_cuda_run_fci_matches_host_route(cases, case, k):
    _cuda()
    const, h1, h2, n, nelec = cases[case]
    if case == "asymmetric":
        # a Hermitian operator: the random terms plus their adjoints
        h1 = h1 + h1.T
        h2 = h2 + h2.permute(3, 2, 1, 0)
    before = fci.ROUTES["card"]
    vals, basis = fci.run_fci(const, h1.cuda(), h2.cuda(), n, nelec, k=k)
    assert fci.ROUTES["card"] == before + 1
    host_vals, host_basis = fci.run_fci(const, h1, h2, n, nelec, k=k)
    assert isinstance(vals, np.ndarray) and vals.shape == (k,)
    np.testing.assert_array_equal(basis, host_basis)
    np.testing.assert_allclose(vals, host_vals, rtol=0, atol=1e-10)


@pytest.mark.cuda
def test_cuda_run_emb_fci_matches_host_route():
    """``run_emb_fci`` on the card's integrals against the host route on a
    CPU copy of the same embedded Hamiltonian."""
    _cuda()
    driver = nbed(device="cuda", **WATER_MU)
    scf = driver.mu["scf"]
    before = dict(fci.ROUTES)
    e_card = run_emb_fci(scf)
    assert fci.ROUTES["card"] == before.get("card", 0) + 1
    assert fci.ROUTES["host"] == before.get("host", 0)
    e_shift, h1, h2, occ = _embedded_hamiltonian(scf, None)
    assert h1.device.type == "cuda"
    nelec = (int(np.sum(occ[::2])), int(np.sum(occ[1::2])))
    vals, _ = fci.run_fci(0.0, h1.cpu(), h2.cpu(), h1.shape[0], nelec)
    assert fci.ROUTES["host"] == before.get("host", 0) + 1
    e_host = float(vals[0]) + e_shift + scf.energy_nuc()
    assert abs(e_card - e_host) <= 1e-10


@pytest.mark.cuda
@pytest.mark.parametrize("rows", [None, 3], ids=["one-block", "3-row-blocks"])
@pytest.mark.parametrize("n_orb,nelec,unrestricted", DIRECT_SECTORS, ids=DIRECT_IDS)
def test_cuda_sigma_kernels_match_torch_sigma(n_orb, nelec, unrestricted, rows, monkeypatch):
    """The matrix-free product through ``csrc/fci_sigma.cu`` against the
    same product through the steps' plain versions, on the card."""
    _cuda()
    h1, h2 = spin_conserving(n_orb, n_orb, unrestricted, device="cuda")
    op = fci_direct.DirectFCI(h1, h2, 2 * n_orb, nelec, block_bytes=fci_direct.BLOCK_BYTES
                              if rows is None else rows * (n_orb ** 2 + 1) * 8 * 64)
    c = torch.tensor(np.random.default_rng(3).standard_normal(op.diagonal.shape), device="cuda")
    before = dict(fci_sigma.LAUNCHES)
    ours = op.sigma(c)
    blocks = -(-op.t.na // op.block)
    assert fci_sigma.LAUNCHES["fci_sigma_gather"] == before.get("fci_sigma_gather", 0) + blocks
    assert fci_sigma.LAUNCHES["fci_sigma_scatter"] == before.get("fci_sigma_scatter", 0) + blocks
    monkeypatch.setattr(fci_sigma, "gather", fci_sigma.gather_reference)
    monkeypatch.setattr(fci_sigma, "scatter", fci_sigma.scatter_reference)
    plain = op.sigma(c)
    assert float(torch.max(torch.abs(ours - plain))) <= 1e-12 * float(torch.max(torch.abs(plain)))


@pytest.mark.cuda
def test_cuda_route_by_sector_size(cases):
    """Water's D = 100 takes the dense route; a sector above DENSE_MAX the
    matrix-free one, counted in ROUTES and SIGMAS, with the dense matrix's
    lowest eigenvalue, and the dense one again once a term mixes spins; one
    that fits in neither raises before it runs."""
    _cuda()
    const, h1, h2, n, nelec = cases["water_mu"]
    before = dict(fci.ROUTES)
    fci.run_fci(const, h1.cuda(), h2.cuda(), n, nelec)
    assert fci.ROUTES["card"] == before.get("card", 0) + 1
    assert fci.ROUTES["matrix_free"] == before.get("matrix_free", 0)

    h1, h2 = spin_conserving(8, 5, device="cuda")
    assert fci._sector_dim(16, (4, 4)) > fci.DENSE_MAX
    sigmas = fci_direct.SIGMAS["sigma"]
    vals, basis = fci.run_fci(0.5, h1, h2, 16, (4, 4))
    assert fci.ROUTES["matrix_free"] == before.get("matrix_free", 0) + 1
    assert fci_direct.SIGMAS["sigma"] > sigmas
    np.testing.assert_array_equal(basis, fci.sector_basis(16, (4, 4)))
    dense = fci_hamiltonian.sector_matrix(0.5, h1, h2, _basis(16, (4, 4), "cuda"))
    assert abs(vals[0] - float(torch.linalg.eigvalsh(dense)[0])) <= 1e-10

    # a term that mixes spins: the same sector stays on the dense route
    h1[0, 1] = h1[1, 0] = 0.05
    routes = dict(fci.ROUTES)
    vals, _ = fci.run_fci(0.5, h1, h2, 16, (4, 4))
    assert fci.ROUTES["card"] == routes.get("card", 0) + 1
    assert fci.ROUTES["matrix_free"] == routes.get("matrix_free", 0)
    host, _ = fci.run_fci(0.5, h1.cpu(), h2.cpu(), 16, (4, 4))
    assert abs(vals[0] - host[0]) <= 1e-10

    zeros = torch.zeros((36, 36), dtype=torch.float64, device="cuda")
    routes = dict(fci.ROUTES)
    with pytest.raises(torch.OutOfMemoryError, match="matrix-free"):
        fci.run_fci(0.0, zeros, zeros[:, :, None, None].expand(36, 36, 36, 36), 36, (9, 9))
    assert dict(fci.ROUTES) == routes
