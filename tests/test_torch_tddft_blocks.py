"""The TDA and RPA (A+B, A-B) matvec blocks as shared programs of fixed
width (``nbed_tpu_torch.solvers.tddft._block_program``, the reference's
``jax.jit(jax.vmap(matvec))``), run uncaptured on the CPU: padded
fixed-width blocks against the eager unpadded ones within 1e-13 on the
exact and DF routes, HF and B3LYP, one program per (kind, width, orbital
shapes, XC chunk) and structure whose frame and operators each call loads,
and the solvers' spectra through the programs equal to the eager ones.
The ``cuda`` test holds the graphs against the eager blocks on the card.
"""

import numpy as np
import pytest
import torch

from nbed_tpu_torch.chem import build_molecule
from nbed_tpu_torch.ops.programs import RUNS
from nbed_tpu_torch.scf import SCFEngine, engine
from nbed_tpu_torch.solvers import run_tddft_rpa, run_tddft_tda, tddft

torch.set_num_threads(1)

with open("tests/molecules/water.xyz") as _f:
    WATER = _f.read()
SCF = dict(conv_tol=1e-10, dm_conv_tol=1e-8, max_cycle=100)


@pytest.fixture(scope="module")
def solutions():
    """Water/STO-3G: HF and B3LYP on exact ERIs, B3LYP on the DF route,
    and B3LYP at a stretched geometry (the same structure)."""
    mol = build_molecule(WATER, "sto-3g")
    return {
        "hf": SCFEngine(mol, device="cpu", **SCF).kernel(),
        "b3lyp": SCFEngine(mol, xc="b3lyp", device="cpu", **SCF).kernel(),
        "b3lyp_df": SCFEngine(mol, xc="b3lyp", density_fitting=True, device="cpu",
                              **SCF).kernel(),
        "b3lyp_stretched": SCFEngine(mol, xc="b3lyp", coords=mol.coords * 1.03, device="cpu",
                                     **SCF).kernel(),
    }


def _blocks(fr, kind, x, graphed, monkeypatch):
    monkeypatch.setattr(tddft, "_GRAPHED", graphed)
    return tddft._blockwise(fr, kind, x)


@pytest.mark.parametrize("name", ["hf", "b3lyp", "b3lyp_df"])
@pytest.mark.parametrize("kind", ["tda", "apb", "amb"])
@pytest.mark.parametrize("block, rows", [(3, 7), (4, 4), (5, 2)])
def test_padded_blocks_match_unpadded(solutions, name, kind, block, rows, monkeypatch):
    """Rows cut at a program width of ``block`` (the last block padded
    with zero rows) against the eager blocks of at most ``block`` rows."""
    fr = tddft._response_frame(solutions[name])
    fr["block"] = block
    x = torch.tensor(np.random.default_rng(rows).standard_normal((rows, sum(fr["sizes"]))))
    eager = _blocks(fr, kind, x, False, monkeypatch)
    padded = _blocks(fr, kind, x, True, monkeypatch)
    assert padded.shape == eager.shape == x.shape
    assert float(torch.max(torch.abs(padded - eager))) < 1e-13


def test_block_program_key_and_width(solutions, monkeypatch):
    """One program per (kind, width, orbital shapes, XC chunk) of the
    structure, of width min(block, npairs); a second solution of the
    structure reuses it with its own frame and operators copied in."""
    engine._JIT_PROGRAM_CACHE.clear()
    monkeypatch.setattr(tddft, "_GRAPHED", True)
    x = torch.eye(20, dtype=torch.float64)[:6]
    outs = {}
    for name in ("b3lyp", "b3lyp_stretched"):
        fr = tddft._response_frame(solutions[name])
        fr["block"] = 4
        outs[name] = tddft._blockwise(fr, "tda", x)
        monkeypatch.setattr(tddft, "_GRAPHED", False)
        want = tddft._blockwise(fr, "tda", x)
        monkeypatch.setattr(tddft, "_GRAPHED", True)
        assert float(torch.max(torch.abs(outs[name] - want))) < 1e-13
    keys = [key for key in engine._JIT_PROGRAM_CACHE if key[0] == "tddft_tda"]
    assert len(keys) == 1
    width, shapes, _ = keys[0][3]
    assert width == 4 and shapes == ((5, 2), (5, 2))
    prog = engine._JIT_PROGRAM_CACHE[keys[0]]
    assert prog.buffers["x"].shape == (4, 20)
    assert not torch.equal(outs["b3lyp"], outs["b3lyp_stretched"])


@pytest.mark.parametrize("name", ["hf", "b3lyp", "b3lyp_df"])
def test_solvers_through_programs_equal_eager(solutions, name, monkeypatch):
    """Dense TDA, Davidson TDA and RPA through the block programs give the
    eager spectra (1e-12 Ha) and count one replay per block."""
    sol = solutions[name]
    out = {}
    for graphed in (False, True):
        monkeypatch.setattr(tddft, "_GRAPHED", graphed)
        before = RUNS["tddft_tda_graph"]
        out[graphed] = (run_tddft_tda(sol).excitations,
                        run_tddft_tda(sol, nroots=3, method="davidson",
                                      max_subspace=6).excitations,
                        run_tddft_rpa(sol, nroots=5).excitations)
        assert (RUNS["tddft_tda_graph"] > before) == graphed
    for eager, graphed in zip(out[False], out[True]):
        assert np.max(np.abs(eager - graphed)) < 1e-12


def test_eager_blocks_off_cuda_by_default(solutions):
    """Under the default switch the CPU runs the eager blocks: no program."""
    assert tddft._GRAPHED == "auto"
    engine._JIT_PROGRAM_CACHE.clear()
    run_tddft_tda(solutions["hf"], nroots=2)
    assert not any(key[0].startswith("tddft") for key in engine._JIT_PROGRAM_CACHE)


@pytest.mark.cuda
@pytest.mark.parametrize("kind", ["tda", "apb", "amb"])
def test_cuda_graphed_blocks_match_eager(kind, monkeypatch):
    """On the card the captured block equals the eager one within 1e-12,
    a replay bitwise the uncaptured body, and a second call captures
    nothing."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (CUDA graphs have no CPU mode)")
    mol = build_molecule(WATER, "sto-3g")
    sol = SCFEngine(mol, xc="b3lyp", device="cuda", **SCF).kernel()
    fr = tddft._response_frame(sol)
    x = torch.tensor(np.random.default_rng(1).standard_normal((7, sum(fr["sizes"]))),
                     device="cuda")
    eager = _blocks(fr, kind, x, False, monkeypatch)
    graphed = _blocks(fr, kind, x, "auto", monkeypatch)
    captures = RUNS["captures"]
    again = _blocks(fr, kind, x, "auto", monkeypatch)
    assert RUNS["captures"] == captures and torch.equal(graphed, again)
    assert float(torch.max(torch.abs(graphed - eager))) < 1e-12
