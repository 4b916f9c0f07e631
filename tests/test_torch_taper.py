"""Z2 tapering of nbed_tpu_torch against nbed_tpu and against exact spectra
(the cases of tests/test_taper.py:40-126): water 14 -> 10 qubits with the
ground energy preserved, and the toy Hamiltonians."""

import numpy as np
import pytest
import torch

from nbed_tpu.ham import HamiltonianBuilder as RefBuilder
from nbed_tpu.ham import find_z2_symmetries as ref_find_z2_symmetries
from nbed_tpu.ham import jordan_wigner as ref_jordan_wigner
from nbed_tpu.ham import taper as ref_taper
from nbed_tpu.ham.taper import _gf2_rref as ref_gf2_rref
from nbed_tpu_torch.ham import (PauliSum, find_z2_symmetries, jordan_wigner,
                                pauli_ground_state, pauli_sum_to_sparse, taper,
                                taper_auto)
from nbed_tpu_torch.ham.qubit import _popcount
from nbed_tpu_torch.ham.taper import _gf2_rref

# one torch thread per test process: under pytest-xdist the OpenMP threads
# of several workers spin on the same cores and slow every worker many-fold
torch.set_num_threads(1)


def _dense(ps: PauliSum):
    return pauli_sum_to_sparse(ps).toarray()


def _fields(symmetries):
    return [(t.x, t.z, t.qubit, t.sigma_is_x) for t in symmetries]


def _hf_bits(occ):
    bits = 0
    for p in np.nonzero(occ[0] > 0)[0]:
        bits |= 1 << (2 * int(p))
    for p in np.nonzero(occ[1] > 0)[0]:
        bits |= 1 << (2 * int(p) + 1)
    return bits


@pytest.fixture(scope="module")
def water_jw(water_uhf):
    c, h1, h2 = RefBuilder(water_uhf, 0.0).build()
    sq = (float(c), np.asarray(h1), np.asarray(h2))
    return jordan_wigner(*sq), ref_jordan_wigner(*sq), _hf_bits(np.asarray(water_uhf.mo_occ))


def test_water_tapers_14_to_10_with_ground_energy(water_jw):
    ps, ref_ps, hf_bits = water_jw
    syms = find_z2_symmetries(ps)
    assert ps.n_qubits == 14 and len(syms) == 4
    for s in syms:
        assert s.x == 0  # JW molecular symmetries are Z strings
        assert all(not ((_popcount(x & s.z) ^ _popcount(z & s.x)) & 1) for x, z in ps.terms)
    assert _fields(syms) == _fields(ref_find_z2_symmetries(ref_ps))
    tapered, _, sector = taper_auto(ps, hf_bits=hf_bits)
    assert tapered.n_qubits == 10
    e_full = pauli_ground_state(ps)[0]
    assert abs(pauli_ground_state(tapered)[0] - e_full) < 1e-9
    theirs = ref_taper(ref_ps, syms, sector)
    assert set(tapered.terms) == set(theirs.terms)
    assert max(abs(tapered.terms[k] - theirs.terms[k]) for k in theirs.terms) < 1e-12


def test_gf2_rref_matches_reference():
    rng = np.random.default_rng(5)
    rows = [int(r) for r in rng.integers(0, 1 << 20, size=30)]
    assert _gf2_rref(rows, 20) == ref_gf2_rref(rows, 20)


def test_toy_z_symmetry_exact_split():
    """H = Z0Z1 + 0.3 X0X1 + 0.2 Z0: one symmetry (ZZ); the two tapered
    sectors tile the 2-qubit spectrum."""
    ps = PauliSum(2)
    ps.add(1.0, 0, 0b11)
    ps.add(0.3, 0b11, 0)
    ps.add(0.2, 0, 0b01)
    syms = find_z2_symmetries(ps)
    assert len(syms) == 1 and (syms[0].x, syms[0].z) == (0, 0b11)
    halves = []
    for eig in (+1, -1):
        tp = taper(ps, syms, [eig])
        assert tp.n_qubits == 1
        halves.append(np.linalg.eigvalsh(_dense(tp)))
    np.testing.assert_allclose(np.sort(np.concatenate(halves)),
                               np.sort(np.linalg.eigvalsh(_dense(ps))), atol=1e-12)


def test_x_type_symmetry_sector_scan():
    """Transverse-field Ising chain: the global X parity gives no analytic
    sector from hf_bits, so taper_auto scans the sectors."""
    n = 4
    ps = PauliSum(n)
    for q in range(n - 1):
        ps.add(-1.0, 0, 0b11 << q)
    for q in range(n):
        ps.add(-0.7, 1 << q, 0)
    syms = find_z2_symmetries(ps)
    assert len(syms) == 1 and syms[0].z == 0 and syms[0].x == (1 << n) - 1
    tp, syms2, _ = taper_auto(ps, hf_bits=0)
    assert len(syms2) == 1 and tp.n_qubits == n - 1
    assert abs(np.linalg.eigvalsh(_dense(tp))[0] - np.linalg.eigvalsh(_dense(ps))[0]) < 1e-10


def test_degenerate_kernel_stays_abelian():
    """H = Z0Z1 + 0.3 X0X1: ZZ and XX both taper; the four sectors tile
    the spectrum."""
    ps = PauliSum(2)
    ps.add(1.0, 0, 0b11)
    ps.add(0.3, 0b11, 0)
    syms = find_z2_symmetries(ps)
    assert len(syms) == 2
    parts = []
    for code in range(4):
        tp = taper(ps, syms, [1 - 2 * (code & 1), 1 - 2 * ((code >> 1) & 1)])
        assert tp.n_qubits == 0
        parts.append(float(np.real(sum(tp.terms.values()))))
    np.testing.assert_allclose(np.sort(parts), np.sort(np.linalg.eigvalsh(_dense(ps))),
                               atol=1e-12)


def test_sector_length_is_checked(water_jw):
    ps = water_jw[0]
    with pytest.raises(ValueError, match="sector has 1 eigenvalues for 4"):
        taper(ps, find_z2_symmetries(ps), [1])
