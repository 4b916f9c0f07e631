"""The incremental float32 SCF (``SCFEngine(incremental_jk="on")``) as
graphed programs (water/STO-3G, CPU, where ``jit_kernel="on"`` runs the
programs' bodies uncaptured): the rebase and incremental cycles, the
float32-XC switch, the DIIS state carried between them and the float64
polish, against the port's eager incremental SCF (1e-10 Ha, the same
mixed-loop and polish cycles) and nbed_tpu's jitted incremental SCF
(1e-8 Ha, the eager path's tolerance), by rebase period, method, float32
warm-up and cycles per replay; iterates of chunks of several cycles equal
the eager loop's."""

import pytest
import torch

from nbed_tpu.scf.engine import SCFEngine as RefEngine
from nbed_tpu_torch.interop import molecule_from_reference
from nbed_tpu_torch.scf import SCFEngine

# one torch thread per test process: under pytest-xdist the OpenMP threads
# of several workers spin on the same cores and slow every worker many-fold
torch.set_num_threads(1)

TIGHT = dict(conv_tol=1e-10, dm_conv_tol=1e-8, max_cycle=100)


@pytest.fixture(scope="module")
def mols(water_molecule):
    return water_molecule, molecule_from_reference(water_molecule)


def _pair(mol, **kw):
    """(graphed solution, its last_run, eager solution, its last_run)."""
    eng = SCFEngine(mol, device="cpu", jit_kernel="on", incremental_jk="on", **kw)
    eager_eng = SCFEngine(mol, device="cpu", jit_kernel="off", incremental_jk="on", **kw)
    ours, eager = eng.kernel(), eager_eng.kernel()
    return ours, eng.last_run, eager, eager_eng.last_run


def _hold(ours, run, eager, eager_run):
    assert ours.converged and eager.converged and run["mode"] == "graph"
    assert abs(ours.e_tot - eager.e_tot) < 1e-10
    assert run["cycles"] == eager_run["cycles"]
    assert 0 < run["mixed_cycles"] == eager_run["mixed_cycles"] < run["cycles"]


CASES = [  # (rebase_every, xc, warmup_f32, dispatch_cycles)
    *[(r, xc, False, None) for r in (1, 3, 8) for xc in (None, "b3lyp")],
    *[(8, xc, True, None) for xc in (None, "b3lyp")],
    *[(3, xc, False, d) for xc in (None, "b3lyp") for d in (1, 3)],
    (8, "b3lyp", True, 3),
]


@pytest.mark.parametrize("rebase, xc, warmup, dispatch", CASES)
def test_graphed_incremental_matches_eager(mols, rebase, xc, warmup, dispatch):
    _, mol = mols
    kw = dict(TIGHT, xc=xc, rebase_every=rebase, warmup_f32=warmup,
              dispatch_cycles=dispatch)
    ours, run, eager, eager_run = _pair(mol, **kw)
    _hold(ours, run, eager, eager_run)
    if warmup:
        assert run["warmup_cycles"] == eager_run["warmup_cycles"]
    if dispatch == 3:
        assert run["cycles_per_replay"] == 3


@pytest.mark.parametrize("xc", [None, "b3lyp"])
def test_graphed_incremental_matches_reference_jit(mols, xc):
    ref_mol, mol = mols
    kw = dict(TIGHT, xc=xc, incremental_jk="on")
    theirs = RefEngine(ref_mol, jit_kernel="on", **kw).kernel()
    ours = SCFEngine(mol, device="cpu", jit_kernel="on", **kw).kernel()
    assert abs(ours.e_tot - float(theirs.e_tot)) < 1e-8


@pytest.mark.parametrize("dispatch", [1, 3])
def test_iterates_equal_the_eager_loop(mols, dispatch):
    """The SCF stopped after c cycles (max_cycle = c: c mixed cycles, then
    at most c polish cycles from there), for every c up to convergence:
    the graphed run's density and energy equal the eager run's, so every
    iterate of the mixed loop does, whether the program picks each cycle's
    variant on the host (one cycle per replay) or on the device (three)."""
    _, mol = mols
    kw = dict(xc="b3lyp", rebase_every=3, conv_tol=1e-10, dm_conv_tol=1e-8)
    _, run, _, _ = _pair(mol, max_cycle=100, dispatch_cycles=dispatch, **kw)
    for c in range(1, run["mixed_cycles"] + 1):
        ours, _, eager, _ = _pair(mol, max_cycle=c, dispatch_cycles=dispatch, **kw)
        assert abs(ours.e_tot - eager.e_tot) < 1e-10, c
        assert float((ours.make_rdm1() - eager.make_rdm1()).abs().max()) < 1e-9, c
