"""Qubit mappings of nbed_tpu_torch against nbed_tpu on water's full
14-qubit builder output: JW, BK and parity term sets and coefficients, the
C++ term engine against the plain Python mapper, measurement groups, the
ground state and the resource counts."""

import numpy as np
import pytest
import torch

from nbed_tpu.ham import HamiltonianBuilder as RefBuilder
from nbed_tpu.ham import measurement_groups as ref_measurement_groups
from nbed_tpu.ham import pauli_ground_state as ref_pauli_ground_state
from nbed_tpu.ham.qubit import MAPPINGS as REF_MAPPINGS
from nbed_tpu.ham.qubit import _bk_sets as ref_bk_sets
from nbed_tpu.ham.resources import hamiltonian_resources as ref_resources
from nbed_tpu_torch import _compile
from nbed_tpu_torch.ham import (MAPPINGS, PauliSum, hamiltonian_resources,
                                measurement_groups, pauli_ground_state)
from nbed_tpu_torch.ham import qubit
from nbed_tpu_torch.solvers import run_fci

# one torch thread per test process: under pytest-xdist the OpenMP threads
# of several workers spin on the same cores and slow every worker many-fold
torch.set_num_threads(1)


@pytest.fixture(scope="module")
def water_sq(water_uhf):
    """nbed_tpu's (constant, h1, h2) of water's full UHF: 14 spin orbitals."""
    c, h1, h2 = RefBuilder(water_uhf, 0.0).build()
    return float(c), np.asarray(h1), np.asarray(h2)


def _same_terms(ours: PauliSum, theirs, tol=1e-12):
    assert ours.n_qubits == theirs.n_qubits
    assert set(ours.terms) == set(theirs.terms)
    assert max(abs(ours.terms[k] - theirs.terms[k]) for k in theirs.terms) <= tol


@pytest.mark.parametrize("mapping", ["jw", "bk", "parity"])
def test_mapping_matches_reference(water_sq, mapping):
    ours = MAPPINGS[mapping](*water_sq)
    theirs = REF_MAPPINGS[mapping](*water_sq)
    assert ours.n_qubits == 14 and len(ours) > 500
    _same_terms(ours, theirs)


@pytest.mark.parametrize("mapping", ["jw", "bk", "parity"])
def test_cpp_engine_matches_python_mapper(water_sq, mapping):
    _same_terms(qubit._map_interaction_operator(*water_sq, mapping),
                qubit._map_python(*water_sq, mapping))


def test_mapping_takes_tensors(water_sq):
    c, h1, h2 = water_sq
    _same_terms(MAPPINGS["jw"](c, torch.tensor(h1), torch.tensor(h2)),
                MAPPINGS["jw"](c, h1, h2), tol=0.0)


def test_bk_sets_match_reference():
    for n in (1, 5, 14, 28):
        assert [qubit._bk_sets(j, n) for j in range(n)] == \
            [ref_bk_sets(j, n) for j in range(n)]


def test_measurement_groups_match_reference(water_sq):
    ours = measurement_groups(MAPPINGS["jw"](*water_sq))
    theirs = ref_measurement_groups(REF_MAPPINGS["jw"](*water_sq))
    assert [[k for k, _ in g] for g in ours] == [[k for k, _ in g] for g in theirs]
    assert sum(len(g) for g in ours) == len(MAPPINGS["jw"](*water_sq))


@pytest.mark.parametrize("mapping", ["jw", "parity"])
def test_ground_state_matches_reference_and_fci(water_sq, mapping):
    """The lowest eigenvalue of the 2^14 register is the N = 10 FCI energy."""
    e0 = pauli_ground_state(MAPPINGS[mapping](*water_sq))[0]
    assert abs(e0 - ref_pauli_ground_state(REF_MAPPINGS[mapping](*water_sq))[0]) < 1e-9
    e_fci = run_fci(*water_sq, 14, (5, 5))[0][0]
    assert abs(e0 - e_fci) < 1e-9


@pytest.mark.parametrize("mapping", ["jw", "bk"])
def test_resources_match_reference(water_sq, mapping):
    assert hamiltonian_resources(*water_sq, mapping=mapping) == \
        ref_resources(*water_sq, mapping=mapping)


def test_to_strings_letters():
    ps = PauliSum(3)
    ps.add(0.5, 0b011, 0b010)  # X0 Y1, canonical X^x Z^z = -i X0 Y1
    ps.add(0.25, 0, 0b100)  # Z2
    assert ps.to_strings() == [(0.25, "IIZ"), (0.5 * -1j, "XYI")]


def test_failed_build_raises(tmp_path, monkeypatch):
    """No fall-back: a source that does not compile raises."""
    src = tmp_path / "broken.cpp"
    src.write_text("this is not C++\n")
    monkeypatch.setattr(_compile, "BUILD_DIR", tmp_path / "_build")
    with pytest.raises(RuntimeError, match="building broken.cpp failed"):
        _compile.build_shared_library(["g++", "-shared", "-fPIC"], src, "libbroken.so")
