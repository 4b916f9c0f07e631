"""CCSD(T) and the CCSD precision modes of nbed_tpu_torch against nbed_tpu
on the same spin-orbital integrals, the embedded (T) of the driver, and the
global CCSD/FCI diagnostics.

The integrals come from the port's own SCF and builder and go to both
packages' solvers unchanged, so the comparisons hold the solvers alone.
"""

import numpy as np
import pytest
import torch

from nbed_tpu import driver as ref_driver
from nbed_tpu.solvers import run_ccsd as ref_run_ccsd
from nbed_tpu_torch import driver as port_driver
from nbed_tpu_torch.chem import build_molecule
from nbed_tpu_torch.config import NbedConfig
from nbed_tpu_torch.driver import NbedDriver
from nbed_tpu_torch.ham import HamiltonianBuilder
from nbed_tpu_torch.interop import solution_from_reference
from nbed_tpu_torch.scf import SCFEngine
from nbed_tpu_torch.solvers import run_ccsd
from nbed_tpu_torch.solvers.ccsd import _triples_energy

torch.set_num_threads(1)

SYSTEMS = {
    "water": ("tests/molecules/water.xyz", "sto-3g"),
    "lih": ("2\n\nLi 0.0 0.0 0.0\nH 0.0 0.0 1.6", "sto-3g"),
    "h2_631g": ("2\n\nH 0.0 0.0 0.0\nH 0.0 0.0 0.7408481486", "6-31g"),
    "h2_sto3g": ("2\n\nH 0.0 0.0 0.0\nH 0.0 0.0 0.7408481486", "sto-3g"),
}


def _integrals(name):
    """(h1, h2, occ_mask) of the port's converged UHF of ``name``."""
    xyz, basis = SYSTEMS[name]
    if xyz.endswith(".xyz"):
        with open(xyz) as f:
            xyz = f.read()
    sol = SCFEngine(build_molecule(xyz, basis), conv_tol=1e-11, dm_conv_tol=1e-9,
                    max_cycle=100, device="cpu").kernel()
    _, h1, h2 = HamiltonianBuilder(sol, 0.0).build()
    return h1, h2, NbedDriver._interleaved_occ(sol)


@pytest.fixture(scope="module")
def integrals():
    return {name: _integrals(name) for name in SYSTEMS}


@pytest.mark.parametrize("name", ["water", "lih", "h2_631g"])
def test_triples_match_nbed_tpu(integrals, name):
    h1, h2, occ = integrals[name]
    ours = run_ccsd(h1, h2, occ, conv_tol=1e-10, triples=True, precision="f64")
    theirs = ref_run_ccsd(h1.numpy(), h2.numpy(), occ, conv_tol=1e-10, triples=True,
                          precision="f64")
    assert len(ours) == 3
    assert abs(ours[1] - theirs[1]) < 1e-10  # e_t
    assert abs(ours[0] - theirs[0]) < 1e-10 and abs(ours[2] - theirs[2]) < 1e-10
    if name == "h2_631g":
        assert abs(ours[1]) < 1e-14  # no triples exist for two electrons
    else:
        assert ours[1] < 0


@pytest.mark.parametrize("name", ["h2_sto3g", "h2_631g"])
def test_triples_vanish_for_two_electrons(integrals, name):
    _, e_t, _ = run_ccsd(*integrals[name], conv_tol=1e-12, triples=True)
    assert abs(e_t) < 1e-14


@pytest.mark.parametrize("chunk", [1, 7, 10_000])
def test_triples_independent_of_chunking(integrals, chunk):
    """A short last chunk holds no repeated triples: every cut of the
    (i, j, k) list gives the same energy."""
    h1, h2, occ = integrals["water"]
    from nbed_tpu_torch.solvers.ccsd import _antisymmetrized

    order = np.concatenate([np.where(occ)[0], np.where(~occ)[0]])
    idx = torch.as_tensor(order)
    w = _antisymmetrized(h2)[idx][:, idx][:, :, idx][:, :, :, idx]
    no = int(occ.sum())
    fock = h1[idx][:, idx] + torch.einsum("piqi->pq", w[:, :no, :, :no])
    rng = np.random.default_rng(5)
    nv = len(order) - no
    t1 = torch.tensor(0.01 * rng.standard_normal((no, nv)))
    t2 = torch.tensor(0.01 * rng.standard_normal((no, no, nv, nv)))
    t2 = t2 - t2.permute(1, 0, 2, 3)
    t2 = t2 - t2.permute(0, 1, 3, 2)
    assert abs(_triples_energy(fock, w, t1, t2, chunk=chunk)
               - _triples_energy(fock, w, t1, t2, chunk=no ** 3)) < 1e-15


@pytest.mark.parametrize("precision, tol", [("f32", 5e-5), ("mixed", 1e-8)])
def test_precision_modes_match_f64(integrals, precision, tol):
    """The reference's tolerances (tests/test_solvers.py:56-65): the float32
    sweep alone to 5e-5, the float32 sweep with a float64 polish to 1e-8;
    (T) on the float32 amplitudes upcast."""
    h1, h2, occ = integrals["water"]
    e64, t64, _ = run_ccsd(h1, h2, occ, conv_tol=1e-10, precision="f64", triples=True)
    e, t, ref = run_ccsd(h1, h2, occ, conv_tol=1e-10, precision=precision, triples=True)
    assert abs(e - e64) < tol and abs(t - t64) < tol
    theirs = ref_run_ccsd(h1.numpy(), h2.numpy(), occ, conv_tol=1e-10, precision=precision)
    assert abs(e - theirs[0]) < tol and abs(ref - theirs[1]) < 1e-12


def test_float32_sweep_restores_matmul_settings(integrals):
    before = torch.get_float32_matmul_precision()
    torch.set_float32_matmul_precision("medium")
    try:
        run_ccsd(*integrals["h2_631g"], precision="f32")
        assert torch.get_float32_matmul_precision() == "medium"
    finally:
        torch.set_float32_matmul_precision(before)


def test_auto_is_f64(integrals):
    h1, h2, occ = integrals["lih"]
    assert run_ccsd(h1, h2, occ, precision="auto") == run_ccsd(h1, h2, occ, precision="f64")


def test_unknown_precision_raises(integrals):
    with pytest.raises(ValueError, match="precision"):
        run_ccsd(*integrals["h2_sto3g"], precision="bf16")


def test_emb_ccsd_triples_match_nbed_tpu(mu_driver):
    """run_emb_ccsd(triples=True) on the mu-embedded water of the conftest
    config: e_t enters both returns, as in nbed_tpu."""
    ref_sol = mu_driver.mu["scf"]
    sol = solution_from_reference(ref_sol, "cpu")
    ours = port_driver.run_emb_ccsd(sol, convergence=1e-8, triples=True)
    theirs = ref_driver.run_emb_ccsd(ref_sol, convergence=1e-8, triples=True)
    assert abs(ours[0] - theirs[0]) < 1e-8 and abs(ours[1] - theirs[1]) < 1e-8
    plain = port_driver.run_emb_ccsd(sol, convergence=1e-8)
    e_t = ours[0] - plain[0]
    assert e_t < 0 and abs(e_t) < 1e-3
    assert abs((ours[1] - plain[1]) - e_t) < 1e-12


@pytest.fixture(scope="module")
def global_drivers(nbed_config):
    """nbed_tpu's and the port's drivers on the conftest config (no
    embedding run: the global diagnostics need only the global HF)."""
    cfg = nbed_config.model_dump(mode="json")
    return (ref_driver.NbedDriver(nbed_config),
            NbedDriver(NbedConfig(**cfg), device="cpu"))


def test_global_ccsd_matches_nbed_tpu(global_drivers):
    ref, port = global_drivers
    (e, corr), (e_ref, corr_ref) = port._global_ccsd, ref._global_ccsd
    assert abs(e - e_ref) < 1e-7 and abs(corr - corr_ref) < 1e-7
    assert abs(e - -75.0090124134578) < 1e-6  # the reference oracle


def test_global_fci_matches_nbed_tpu(global_drivers):
    ref, port = global_drivers
    assert abs(port._global_fci - ref._global_fci) < 1e-8
    assert abs(port._global_fci - -75.00912605315143) < 1e-6
