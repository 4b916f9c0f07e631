"""The XC grid and the AO tables as shared programs of the SCF engine
(``SCFEngine._grid``/``_ao_tables`` through ``_JIT_PROGRAM_CACHE`` kinds
"grid" and "aos", the reference's ``_shared_jit("grid")`` and
``_shared_jit("aos")``), run uncaptured on the CPU: bitwise the eager
``build_grid``/``eval_aos``, within 1e-12 of nbed_tpu's, one program per
structure shared by engines at any geometry, and a body that copies
nothing from the host (what a CUDA graph captures). The ``cuda`` test
holds the graphs against the eager tables on the card.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nbed_tpu.chem import build_molecule as ref_build_molecule
from nbed_tpu.grids import build_grid as ref_build_grid
from nbed_tpu.grids import eval_aos as ref_eval_aos
from nbed_tpu_torch.chem import build_molecule
from nbed_tpu_torch.grids import build_grid, eval_aos
from nbed_tpu_torch.ops.programs import RUNS
from nbed_tpu_torch.scf import SCFEngine, engine

torch.set_num_threads(1)

with open("tests/molecules/water.xyz") as _f:
    WATER = _f.read()
LIH = "2\n\nLi 0.0 0.0 0.0\nH 0.0 0.0 1.6"
# (label, xyz, basis, grid options)
CASES = [("water", WATER, "sto-3g", {}),
         ("water_product", WATER, "sto-3g", {"grid_scheme": "product", "grid_size": (30, 10)}),
         ("water_level1", WATER, "sto-3g", {"grid_level": 1}),
         ("lih_631g", LIH, "6-31g", {})]


def _engine(xyz, basis, opts, jit_kernel="on", coords=None):
    return SCFEngine(build_molecule(xyz, basis), xc="b3lyp", device="cpu",
                     jit_kernel=jit_kernel, coords=coords, **opts)


def _eager_tables(eng):
    points, weights = build_grid(eng.mol, eng.coords, n_rad=eng.grid_size[0],
                                 n_theta=eng.grid_size[1], scheme=eng.grid_scheme,
                                 level=eng.grid_level, device="cpu")
    return (points, weights, *eval_aos(eng.mol, points, eng.coords))


def _tables(eng):
    return (*eng._grid, *eng._ao_tables)


@pytest.mark.parametrize("label, xyz, basis, opts", CASES)
def test_programs_equal_build_grid_and_eval_aos_bitwise(label, xyz, basis, opts):
    eng = _engine(xyz, basis, opts)
    before = RUNS["grid_graph"], RUNS["aos_graph"]
    ours = _tables(eng)
    assert (RUNS["grid_graph"], RUNS["aos_graph"]) == (before[0] + 1, before[1] + 1)
    for got, want in zip(ours, _eager_tables(eng)):
        assert got.shape == want.shape and torch.equal(got, want)
    for got, want in zip(ours, _tables(_engine(xyz, basis, opts, jit_kernel="off"))):
        assert torch.equal(got, want)


@pytest.mark.parametrize("label, xyz, basis, opts", CASES[:2] + CASES[3:])
def test_programs_match_nbed_tpu(label, xyz, basis, opts):
    eng = _engine(xyz, basis, opts)
    mol = ref_build_molecule(xyz, basis)
    points, weights = ref_build_grid(mol, jnp.asarray(eng.coords),
                                     n_rad=eng.grid_size[0], n_theta=eng.grid_size[1],
                                     scheme=eng.grid_scheme, level=eng.grid_level)
    ao, ao_grad = ref_eval_aos(mol, points, jnp.asarray(eng.coords))
    for got, want in zip(_tables(eng), (points, weights, ao, ao_grad)):
        want = np.asarray(want)
        assert got.shape == want.shape
        assert np.max(np.abs(got.numpy() - want)) < 1e-12


def test_second_engine_and_geometry_share_the_programs():
    """Engines of one structure, at the same or another geometry, replay
    the programs the first one built; each keeps its own tables when the
    next one replays them."""
    engine._JIT_PROGRAM_CACHE.clear()
    mol = build_molecule(WATER, "sto-3g")
    first = SCFEngine(mol, xc="b3lyp", device="cpu", jit_kernel="on")
    tables = [t.clone() for t in _tables(first)]
    kinds = sorted(key[0] for key in engine._JIT_PROGRAM_CACHE)
    assert kinds == ["aos", "grid"]
    programs = dict(engine._JIT_PROGRAM_CACHE)
    moved = SCFEngine(mol, xc="b3lyp", device="cpu", jit_kernel="on", coords=mol.coords * 1.03)
    moved_tables = _tables(moved)
    assert engine._JIT_PROGRAM_CACHE == programs
    for got, want in zip(moved_tables, _eager_tables(moved)):
        assert torch.equal(got, want)
    for got, want in zip(_tables(first), tables):
        assert torch.equal(got, want)
    assert not torch.equal(moved_tables[0], tables[0])


def test_other_structures_get_their_own_programs():
    """The key is (kind, _jit_spec, grid points, card): another grid level
    or functional is another structure."""
    engine._JIT_PROGRAM_CACHE.clear()
    mol = build_molecule(WATER, "sto-3g")
    for xc, level in (("b3lyp", 3), ("b3lyp", 1), ("pbe", 3)):
        _tables(SCFEngine(mol, xc=xc, grid_level=level, device="cpu", jit_kernel="on"))
    assert sum(key[0] == "grid" for key in engine._JIT_PROGRAM_CACHE) == 3
    assert sum(key[0] == "aos" for key in engine._JIT_PROGRAM_CACHE) == 3


def test_eager_engines_build_no_program():
    engine._JIT_PROGRAM_CACHE.clear()
    for mode in ("off", "auto"):  # "auto" graphs on CUDA only
        _tables(_engine(WATER, "sto-3g", {}, jit_kernel=mode))
    assert not engine._JIT_PROGRAM_CACHE


@pytest.mark.parametrize("kind", ["grid", "aos"])
def test_program_body_copies_nothing_from_the_host(kind, monkeypatch):
    """The captured body reads tensors only: with torch.tensor and
    torch.as_tensor raising, it runs and gives the same tables."""
    engine._JIT_PROGRAM_CACHE.clear()
    eng = _engine(WATER, "sto-3g", {})
    want = _tables(eng)
    prog = next(p for key, p in engine._JIT_PROGRAM_CACHE.items() if key[0] == kind)
    for name in prog.outputs:
        prog.buffers[name].zero_()

    def refuse(*args, **kwargs):
        raise AssertionError("host-to-device copy inside the program body")

    monkeypatch.setattr(torch, "tensor", refuse)
    monkeypatch.setattr(torch, "as_tensor", refuse)
    prog.captured.fn()
    monkeypatch.undo()
    got = [prog.buffers[name] for name in prog.outputs]
    assert all(torch.equal(g, w) for g, w in zip(got, want[:2] if kind == "grid" else want[2:]))


def test_differentiable_grid_stays_eager():
    """Coordinates under autograd (the KS gradient's grid response) take
    build_grid's own path: points and weights carry the derivative."""
    mol = build_molecule(WATER, "sto-3g")
    coords = torch.tensor(mol.coords, dtype=torch.float64, requires_grad=True)
    points, weights = build_grid(mol, coords, device="cpu")
    ao, _ = eval_aos(mol, points, coords)
    (g,) = torch.autograd.grad((weights[:, None] * ao * ao).sum(), coords)
    assert g.shape == (3, 3) and torch.isfinite(g).all() and g.abs().max() > 0


@pytest.mark.cuda
def test_cuda_table_programs_bitwise_eager():
    """On the card the captured grid and AO tables equal the eager ones
    bitwise; a second engine captures nothing."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (CUDA graphs have no CPU mode)")
    engine._JIT_PROGRAM_CACHE.clear()
    mol = build_molecule(WATER, "sto-3g")
    graphed = _tables(SCFEngine(mol, xc="b3lyp", device="cuda"))
    captures = RUNS["captures"]
    again = _tables(SCFEngine(mol, xc="b3lyp", device="cuda"))
    eager = _tables(SCFEngine(mol, xc="b3lyp", device="cuda", jit_kernel="off"))
    assert RUNS["captures"] == captures
    assert all(torch.equal(a, b) and torch.equal(a, c)
               for a, b, c in zip(graphed, again, eager))
