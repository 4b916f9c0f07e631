"""The embedded solvers of nbed_tpu_torch.driver take nbed_tpu's arguments,
positionally and by keyword, and agree with nbed_tpu on the same embedded
solution (the mu-embedded water/STO-3G of the conftest config), frozen
orbitals included."""

import inspect

import numpy as np
import pytest
import torch

from nbed_tpu import driver as ref
from nbed_tpu.ham import HamiltonianBuilder as RefBuilder
from nbed_tpu.solvers.frozen import freeze_spinorbitals as ref_freeze
from nbed_tpu_torch import driver as port
from nbed_tpu_torch.config import NbedConfig, ProjectorTypes
from nbed_tpu_torch.ham import HamiltonianBuilder
from nbed_tpu_torch.interop import solution_from_reference
from nbed_tpu_torch.solvers.frozen import freeze_spinorbitals

torch.set_num_threads(1)

SOLVERS = ["run_emb_ccsd", "run_emb_fci", "run_emb_cis", "run_emb_rpa"]


def _parameters(fn):
    """Names, kinds and defaults of ``fn``'s parameters (the annotations
    name each package's own classes)."""
    return [(p.name, p.kind, p.default) for p in inspect.signature(fn).parameters.values()]


@pytest.fixture(scope="module")
def embedded(mu_driver):
    """(nbed_tpu's embedded solution, the port's copy of it)."""
    ref_sol = mu_driver.mu["scf"]
    return ref_sol, solution_from_reference(ref_sol, "cpu")


@pytest.fixture(scope="module")
def port_driver(nbed_config):
    driver = port.NbedDriver(NbedConfig(**nbed_config.model_dump(mode="json")), device="cpu")
    driver.embed()
    return driver


@pytest.mark.parametrize("name", SOLVERS)
def test_signatures_match_nbed_tpu(name):
    assert _parameters(getattr(port, name)) == _parameters(getattr(ref, name))


@pytest.mark.parametrize("name", ["_run_emb_ccsd", "_run_emb_fci", "_dft_in_dft"])
def test_driver_shims_match_nbed_tpu(name):
    assert _parameters(getattr(port.NbedDriver, name)) == \
        _parameters(getattr(ref.NbedDriver, name))


def test_ccsd_positional_convergence(embedded):
    """A positional second argument is ``frozen`` in both packages."""
    ref_sol, sol = embedded
    ours, theirs = port.run_emb_ccsd(sol, None, 1e-8), ref.run_emb_ccsd(ref_sol, None, 1e-8)
    assert abs(ours[0] - theirs[0]) < 1e-8 and abs(ours[1] - theirs[1]) < 1e-8


def test_fci_keyword_convergence(embedded):
    ref_sol, sol = embedded
    ours = port.run_emb_fci(sol, convergence=1e-8)
    assert abs(ours - ref.run_emb_fci(ref_sol, convergence=1e-8)) < 1e-8


@pytest.mark.parametrize("name", SOLVERS)
def test_frozen_core_matches_nbed_tpu(embedded, name):
    ref_sol, sol = embedded
    ours, theirs = getattr(port, name)(sol, frozen=[0]), getattr(ref, name)(ref_sol, frozen=[0])
    if name == "run_emb_ccsd":
        assert abs(ours[0] - theirs[0]) < 1e-8 and abs(ours[1] - theirs[1]) < 1e-8
    elif name == "run_emb_fci":
        assert abs(ours - theirs) < 1e-8
        assert abs(ours - port.run_emb_fci(sol)) < 1e-2  # the core barely correlates
    else:
        np.testing.assert_allclose(ours.excitations, theirs.excitations, rtol=0, atol=1e-8)
        assert len(ours.pairs) < len(getattr(port, name)(sol).pairs)


def test_freeze_spinorbitals_matches_nbed_tpu(embedded):
    """Frozen occupied and virtual spin orbitals: the same constant and
    reduced integrals."""
    ref_sol, sol = embedded
    _, h1, h2 = HamiltonianBuilder(sol, 0.0).build()
    _, h1_ref, h2_ref = RefBuilder(ref_sol, 0.0).build()
    occ = port.NbedDriver._interleaved_occ(sol)
    frozen = [0, 1, h1.shape[0] - 2, h1.shape[0] - 1]
    c, h1_red, h2_red, occ_red = freeze_spinorbitals(1.5, h1, h2, frozen, occ)
    c_ref, h1_ref_red, h2_ref_red, occ_ref_red = ref_freeze(1.5, h1_ref, h2_ref, frozen, occ)
    assert abs(c - c_ref) < 1e-8 and h1_red.dtype == torch.float64
    np.testing.assert_array_equal(occ_red, occ_ref_red)
    # the MO bases agree up to column signs: compare spectra and norms
    np.testing.assert_allclose(np.linalg.eigvalsh(h1_red.numpy()),
                               np.linalg.eigvalsh(h1_ref_red), rtol=0, atol=1e-8)
    assert abs(float(torch.linalg.norm(h2_red)) - np.linalg.norm(h2_ref_red)) < 1e-8


def test_driver_shims(port_driver):
    sol = port_driver.mu["scf"]
    ccsd_like, e_corr = port_driver._run_emb_ccsd(sol)
    assert (ccsd_like.e_tot, e_corr) == port.run_emb_ccsd(sol, None, port_driver.config.convergence)
    assert port_driver._run_emb_fci(sol).e_tot == port.run_emb_fci(sol)
    shim = port_driver._dft_in_dft(ProjectorTypes.MU)["e_dft_in_dft"]
    assert abs(shim - port.dft_in_dft(port_driver, ProjectorTypes.MU)["e_dft_in_dft"]) < 1e-8
