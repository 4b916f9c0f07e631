"""CIS and full RPA of nbed_tpu_torch against nbed_tpu on the same UHF
solution (water/STO-3G), and the spin-orbital CIS matrix against an exact
diagonalisation of the singles subspace built by the port's own FCI code.

Roots can be degenerate, so oscillator strengths are compared summed over
each cluster of roots within 1e-8 Ha of each other, never root by root, and
amplitudes and transition-dipole signs are not compared.
"""

import numpy as np
import pytest
import torch

from nbed_tpu.chem import build_molecule as ref_build_molecule
from nbed_tpu.ham import HamiltonianBuilder as RefBuilder
from nbed_tpu.scf.engine import SCFEngine as RefEngine
from nbed_tpu.solvers import cis as ref_cis
from nbed_tpu_torch.driver import NbedDriver
from nbed_tpu_torch.ham import HamiltonianBuilder
from nbed_tpu_torch.interop import solution_from_reference
from nbed_tpu_torch.solvers import (oscillator_strengths, polarizability, run_cis, run_rpa,
                                    sector_hamiltonian, spin_labels)

torch.set_num_threads(1)


def _inputs(ref_sol):
    """(port solution, port integrals, reference integrals, occupied mask)."""
    sol = solution_from_reference(ref_sol, "cpu")
    _, h1, h2 = HamiltonianBuilder(sol, 0.0).build()
    _, h1_ref, h2_ref = RefBuilder(ref_sol, 0.0).build()
    return sol, (h1, h2), (h1_ref, h2_ref), NbedDriver._interleaved_occ(sol)


@pytest.fixture(scope="module")
def water(water_uhf):
    return (water_uhf, *_inputs(water_uhf))


def _cluster_sums(excitations, f, tol=1e-8):
    """(energy, summed f) of each cluster of roots within ``tol`` Ha."""
    out = []
    for w, fi in zip(excitations, f):
        if out and abs(w - out[-1][0]) < tol:
            out[-1][1] += fi
        else:
            out.append([w, fi])
    return np.array(out)


@pytest.mark.parametrize("solver", ["cis", "rpa"])
def test_spectrum_matches_reference(water, solver):
    ref_sol, sol, (h1, h2), (h1_ref, h2_ref), occ = water
    ours = {"cis": run_cis, "rpa": run_rpa}[solver](h1, h2, occ)
    theirs = getattr(ref_cis, f"run_{solver}")(h1_ref, h2_ref, occ)
    np.testing.assert_allclose(ours.excitations, theirs.excitations, rtol=0, atol=1e-10)
    assert abs(ours.e_ref_elec - theirs.e_ref_elec) < 1e-10
    np.testing.assert_array_equal(ours.pairs, theirs.pairs)
    f, mu = oscillator_strengths(sol, ours)
    f_ref, _ = ref_cis.oscillator_strengths(ref_sol, theirs)
    assert f.shape == (len(ours.excitations),) and mu.shape == (len(ours.excitations), 3)
    np.testing.assert_allclose(_cluster_sums(ours.excitations, f),
                               _cluster_sums(theirs.excitations, f_ref), rtol=0, atol=1e-9)


@pytest.mark.parametrize("nroots", [3, 8])
def test_nroots_and_dominant(water, nroots):
    _, sol, (h1, h2), _, occ = water
    res = run_cis(h1, h2, occ, nroots=nroots)
    assert res.excitations.shape == (nroots,) and res.amplitudes.shape[0] == nroots
    i, a, amp = res.dominant(0, k=1)[0]
    assert occ[i] and not occ[a] and abs(amp) > 0.3
    rpa = run_rpa(h1, h2, occ, nroots=nroots)
    assert rpa.xmy.shape == rpa.amplitudes.shape == (nroots, len(rpa.pairs))
    assert rpa.excitations[0] <= res.excitations[0] + 1e-12


def test_spin_labels_match_reference(water):
    ref_sol, sol, (h1, h2), (h1_ref, h2_ref), occ = water
    ours = spin_labels(sol, run_cis(h1, h2, occ, nroots=8))
    theirs = ref_cis.spin_labels(ref_sol, ref_cis.run_cis(h1_ref, h2_ref, occ, nroots=8))
    assert [lab for lab, _ in ours] == [lab for lab, _ in theirs]
    assert {lab for lab, _ in ours} == {"singlet", "triplet"}
    np.testing.assert_allclose([s for _, s in ours], [s for _, s in theirs], atol=1e-8)


def test_cis_equals_singles_subspace(water):
    """The full CIS spectrum plus the reference energy equals the exact
    spectrum of H in the span of the singly excited determinants."""
    ref_sol, _, (h1, h2), _, occ = water
    res = run_cis(h1, h2, occ)
    n = h1.shape[0]
    occ_i, vir_i = np.where(occ)[0], np.where(~occ)[0]
    hf = sum(1 << int(p) for p in occ_i)
    singles = sorted((hf ^ (1 << int(i))) | (1 << int(a))
                     for i in occ_i for a in vir_i if i % 2 == a % 2)
    nelec = (int(occ[::2].sum()), int(occ[1::2].sum()))
    ham, basis = sector_hamiltonian(0.0, h1, h2, n, nelec)
    idx = np.searchsorted(basis, np.asarray(singles, dtype=np.int64))
    assert np.array_equal(basis[idx], singles)
    exact = np.linalg.eigvalsh(ham[np.ix_(idx, idx)].toarray())
    np.testing.assert_allclose(res.e_ref_elec + res.excitations, exact, rtol=0, atol=1e-9)
    assert abs(res.e_ref_elec + ref_sol.energy_nuc() - ref_sol.e_tot) < 1e-8


def test_stretched_h2_has_imaginary_rpa_roots():
    """H2 at 2.5 Angstrom: the spin-symmetric UHF saddle is unstable, so
    full RPA has imaginary roots in both packages."""
    mol = ref_build_molecule("2\n\nH 0.0 0.0 0.0\nH 2.5 0.0 0.0", "sto-3g")
    ref_sol = RefEngine(mol, conv_tol=1e-12, dm_conv_tol=1e-10, max_cycle=200).kernel()
    _, (h1, h2), (h1_ref, h2_ref), occ = _inputs(ref_sol)
    ours, theirs = run_rpa(h1, h2, occ), ref_cis.run_rpa(h1_ref, h2_ref, occ)
    assert ours.n_imaginary == theirs.n_imaginary > 0
    np.testing.assert_allclose(ours.excitations, theirs.excitations, rtol=0, atol=1e-10)
    with pytest.raises(ValueError, match="imaginary"):
        polarizability(solution_from_reference(ref_sol, "cpu"), ours)


def test_polarizability_matches_reference(water):
    ref_sol, sol, (h1, h2), (h1_ref, h2_ref), occ = water
    rpa = run_rpa(h1, h2, occ)
    rpa_ref = ref_cis.run_rpa(h1_ref, h2_ref, occ)
    for omega in (0.0, 0.2):
        alpha = polarizability(sol, rpa, omega=omega)
        np.testing.assert_allclose(alpha, ref_cis.polarizability(ref_sol, rpa_ref, omega=omega),
                                   rtol=0, atol=1e-8)
    assert np.allclose(alpha, alpha.T, atol=1e-10)
    with pytest.raises(ValueError, match="FULL RPA"):
        polarizability(sol, run_rpa(h1, h2, occ, nroots=3))
