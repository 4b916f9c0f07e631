"""The matrix-free FCI of nbed_tpu_torch (``solvers/fci_direct.py``) on the
CPU: its torch formulation of sigma = H c (the gather and scatter steps'
plain versions, which the hand kernels of ``csrc/fci_sigma.cu`` replace on
a card) against the sparse sector matrix of ``nbed_tpu``'s
``sector_hamiltonian`` and of the port's host route, its Davidson against
the eigenvalues of ``nbed_tpu``'s ``run_fci`` and of the host route, and the
benchmark reference's own matrix-free FCI
(``benchmark/reference/fci_direct.py``) against that reference's dense one.
``run_fci`` sends CPU tensors to the host route, so these tests call the
solver directly. ``nbed_tpu`` is imported inside the tests that use it, so
that ``tests/test_torch_fci_card.py`` can import this module's helpers on a
machine without JAX.

The Hamiltonians are seeded spatial integrals with the 8-fold symmetry of
real orbitals, interleaved by HamiltonianBuilder's ``_spinorb_from_spatial``; the
unrestricted ones give alpha and beta their own integrals."""

import importlib.util
from pathlib import Path

import numpy as np
import pytest
import torch

from nbed_tpu_torch.ham import HamiltonianBuilder
from nbed_tpu_torch.solvers import fci, fci_direct

torch.set_num_threads(1)

ROOT = Path(__file__).resolve().parent.parent
# (spatial orbitals, (n_alpha, n_beta), unrestricted)
SECTORS = [(4, (2, 2), False), (6, (3, 3), False), (8, (4, 3), False), (6, (3, 2), True)]
IDS = ["4o(2,2)", "6o(3,3)", "8o(4,3)", "6o(3,2)-unrestricted"]


def _reference(name):
    """A module of the benchmark's plain reference, loaded by path."""
    path = ROOT / "benchmark" / "reference" / f"{name}.py"
    spec = importlib.util.spec_from_file_location(f"bench_reference_{name}", path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def spatial_integrals(n_orb: int, seed: int, unrestricted: bool = False):
    """(one (2, k, k), chem (4, k, k, k, k): aa, bb, ab, ba) of a seeded
    molecule-like spatial Hamiltonian: orbital energies -2..1 Ha with small
    couplings, ERIs a positive sum of factor products."""
    rng = np.random.default_rng(seed)

    def one_body():
        h = 0.1 * rng.standard_normal((n_orb, n_orb))
        return np.diag(np.linspace(-2.0, 1.0, n_orb)) + h + h.T

    def factor():
        b = rng.standard_normal((2 * n_orb, n_orb, n_orb))
        return 0.15 * (b + b.transpose(0, 2, 1))

    ha, ba = one_body(), factor()
    hb, bb = (one_body(), factor()) if unrestricted else (ha, ba)
    chem = [np.einsum("lpq,lrs->pqrs", x, y) for x, y in ((ba, ba), (bb, bb), (ba, bb), (bb, ba))]
    return np.stack([ha, hb]), np.stack(chem)


def spin_conserving(n_orb: int, seed: int, unrestricted: bool = False, device="cpu"):
    """(h1, 0.5 h2) spin-orbital tensors as the HamiltonianBuilder gives them."""
    one, chem = spatial_integrals(n_orb, seed, unrestricted)
    two = torch.tensor(chem, device=device).permute(0, 1, 3, 4, 2).contiguous()
    h1, h2 = HamiltonianBuilder._spinorb_from_spatial(torch.tensor(one, device=device), two, 0.0)
    return h1, 0.5 * h2


def _sigma_reference(sector_hamiltonian, h1, h2, n_orb, nelec, c):
    """H c through ``sector_hamiltonian``'s sparse sector matrix (the port's
    or ``nbed_tpu``'s), in the alpha-string-first order of (na, nb) ``c``."""
    ham, basis = sector_hamiltonian(0.0, h1, h2, 2 * n_orb, nelec)
    bits, signs = fci_direct.product_signs(n_orb, nelec)
    pos = np.searchsorted(basis, bits.ravel())
    assert np.array_equal(basis[pos], bits.ravel())
    v = np.zeros(len(basis))
    v[pos] = (c * signs).ravel()
    return (ham @ v)[pos].reshape(bits.shape) * signs, ham.diagonal()[pos].reshape(bits.shape)


@pytest.mark.parametrize("rows", [None, 1], ids=["one-block", "row-blocks"])
@pytest.mark.parametrize("n_orb,nelec,unrestricted", SECTORS, ids=IDS)
def test_torch_sigma_matches_sector_matrix(n_orb, nelec, unrestricted, rows):
    h1, h2 = spin_conserving(n_orb, n_orb, unrestricted)
    block = fci_direct.BLOCK_BYTES if rows is None else 1
    op = fci_direct.DirectFCI(h1, h2, 2 * n_orb, nelec, block_bytes=block)
    assert op.block == (op.t.na if rows is None else rows)
    from nbed_tpu.solvers import fci as reference_fci

    c = np.random.default_rng(1).standard_normal(op.diagonal.shape)
    before = fci_direct.SIGMAS["sigma"]
    ours = op.sigma(torch.tensor(c)).numpy()
    assert fci_direct.SIGMAS["sigma"] == before + 1
    for ref, ref_diag in (
            _sigma_reference(fci.sector_hamiltonian, h1, h2, n_orb, nelec, c),
            _sigma_reference(reference_fci.sector_hamiltonian, h1.numpy(), h2.numpy(), n_orb,
                             nelec, c)):
        assert np.max(np.abs(ours - ref)) <= 1e-12 * np.max(np.abs(ref))
        assert np.max(np.abs(op.diagonal.numpy() - ref_diag)) <= 1e-12 * np.max(np.abs(ref_diag))


@pytest.mark.parametrize("k", [1, 3])
@pytest.mark.parametrize("n_orb,nelec,unrestricted", SECTORS, ids=IDS)
def test_davidson_matches_host_route(n_orb, nelec, unrestricted, k):
    from nbed_tpu.solvers import fci as reference_fci

    h1, h2 = spin_conserving(n_orb, n_orb + 1, unrestricted)
    vals = fci_direct.run_direct(0.37, h1, h2, 2 * n_orb, nelec, k=k)
    host, _ = fci.run_fci(0.37, h1, h2, 2 * n_orb, nelec, k=k)
    ref, _ = reference_fci.run_fci(0.37, h1.numpy(), h2.numpy(), 2 * n_orb, nelec, k=k)
    assert isinstance(vals, np.ndarray) and vals.shape == (k,)
    np.testing.assert_allclose(vals, host, rtol=0, atol=1e-10)
    np.testing.assert_allclose(vals, ref, rtol=0, atol=1e-10)


@pytest.mark.parametrize("n_orb,nelec,unrestricted", SECTORS[:3], ids=IDS[:3])
def test_reference_direct_matches_its_dense(n_orb, nelec, unrestricted):
    """The benchmark reference's matrix-free FCI against its dense FCI, and
    against the port's host route on the same integrals."""
    one, chem = spatial_integrals(n_orb, n_orb + 2)
    direct = _reference("fci_direct").fci_energy_direct(one[0], chem[0], *nelec)
    dense = _reference("correlated").fci_energy(one[0], chem[0], *nelec)
    assert abs(direct - dense) <= 1e-10
    h1, h2 = spin_conserving(n_orb, n_orb + 2)
    host, _ = fci.run_fci(0.0, h1, h2, 2 * n_orb, nelec)
    assert abs(direct - host[0]) <= 1e-10


def test_start_sees_a_lower_triplet(monkeypatch):
    """A sector whose lowest state has no overlap with the closed-shell
    start: the start's seeded admixture of every determinant finds it, as
    the host route does; without it the solve settles on a higher state."""
    h1, h2 = spin_conserving(7, 14)
    host, _ = fci.run_fci(0.0, h1, h2, 14, (5, 5))
    vals = fci_direct.run_direct(0.0, h1, h2, 14, (5, 5))
    assert abs(vals[0] - host[0]) <= 1e-10
    monkeypatch.setattr(fci_direct, "_START_ADMIXTURE", 0.0)
    assert fci_direct.run_direct(0.0, h1, h2, 14, (5, 5))[0] > host[0] + 0.1


def test_spin_mixing_term_raises():
    h1, h2 = spin_conserving(4, 4)
    mixed = h2.clone()
    mixed[0, 0, 1, 1] = 0.1                       # a+_0a a+_0a a_0b a_0b
    with pytest.raises(ValueError, match="mix spins"):
        fci_direct.DirectFCI(h1, mixed, 8, (2, 2))
    flipped = h1.clone()
    flipped[0, 1] = flipped[1, 0] = 0.1
    with pytest.raises(ValueError, match="mix spins"):
        fci_direct.DirectFCI(flipped, h2, 8, (2, 2))


@pytest.mark.parametrize("where,count", [(None, (0, 0)), ("h1", (2, 0)), ("h2", (0, 1))])
def test_spin_mixing_counts_terms(where, count):
    h1, h2 = spin_conserving(4, 4)
    if where == "h1":
        h1[0, 1] = h1[1, 0] = 0.1                 # a+_0a a_0b and its conjugate
    elif where == "h2":
        h2[0, 0, 1, 1] = 0.1                      # a+_0a a+_0a a_0b a_0b
    assert fci_direct.spin_mixing(h1, h2) == count


def test_tables_are_built_once_per_sector():
    first = fci_direct.tables(6, (3, 2), torch.device("cpu"))
    assert fci_direct.tables(6, (3, 2), torch.device("cpu")) is first
    assert (first.na, first.nb, first.nlink) == (20, 15, 12)
    assert first.table_b.dtype == first.table_a.dtype == torch.int32


@pytest.mark.parametrize("n_orb,nelec", [(4, (2, 2)), (6, (3, 2)), (5, (0, 2)), (7, (5, 5))])
def test_product_basis_is_sector_basis(n_orb, nelec):
    basis = fci._product_basis(2 * n_orb, nelec)
    np.testing.assert_array_equal(basis, fci.sector_basis(2 * n_orb, nelec))
    assert not basis.flags.writeable


@pytest.mark.parametrize("n_orb,nel", [(14, 7), (6, 0), (5, 2)])
def test_spin_strings(n_orb, nel):
    strings = fci_direct.spin_strings(n_orb, nel)
    assert len(strings) == len(set(strings.tolist())) and np.all(np.diff(strings) > 0)
    assert all(bin(int(s)).count("1") == nel for s in strings)
