"""Programs shared by structure (``SCFEngine._jit_spec``, ``_shared_jit``,
``_JIT_PROGRAM_CACHE``, ``_JIT_PROGRAM_CACHE_MAX``, the reference's
``nbed_tpu/scf/engine.py:144-145, 657-685``) on water/STO-3G, float64 CPU:
engines at two geometries share one program and each still gets its own
eager and nbed_tpu energy; interleaved engines stay bitwise; the port's
keys differ exactly where nbed_tpu's ``_jit_spec`` differs; programs and
operator buffers are keyed by card; the LRU's promote and evict rules; a
dropped engine still goes without the cyclic collector. On the CPU ``jit_kernel="on"`` runs the programs' bodies
uncaptured."""

import gc
import weakref

import numpy as np
import pytest
import torch

from nbed_tpu.chem import build_molecule as ref_build_molecule
from nbed_tpu.scf.engine import SCFEngine as RefEngine
from nbed_tpu_torch.chem import build_molecule
from nbed_tpu_torch.scf import SCFEngine
from nbed_tpu_torch.scf import engine as engine_mod

# one torch thread per test process: under pytest-xdist the OpenMP threads
# of several workers spin on the same cores and slow every worker many-fold
torch.set_num_threads(1)

TIGHT = dict(conv_tol=1e-10, dm_conv_tol=1e-8, max_cycle=100)


@pytest.fixture(autouse=True)
def empty_cache():
    engine_mod._JIT_PROGRAM_CACHE.clear()
    yield
    engine_mod._JIT_PROGRAM_CACHE.clear()


@pytest.fixture(scope="module")
def mols(water_xyz):
    return ref_build_molecule(water_xyz, "sto-3g"), build_molecule(water_xyz, "sto-3g")


def _geometries(mol):
    """The water geometry and one with an O-H bond 0.05 bohr longer."""
    x = np.asarray(mol.coords, dtype=np.float64)
    y = x.copy()
    y[2, 2] += 0.05
    return [x, y]


def _kernel_programs(eng):
    return [key for key in engine_mod._JIT_PROGRAM_CACHE
            if key[0] == "kernel" and key[1] == eng._jit_spec]


@pytest.mark.parametrize("xc", [None, "b3lyp"])
def test_two_geometries_share_one_program(mols, xc):
    """Two engines at two geometries: one cache entry and one program
    object; each engine's energy within 1e-10 Ha of its own eager run in as
    many cycles, and of nbed_tpu's jitted program at its geometry."""
    ref_mol, mol = mols
    kw = dict(TIGHT, xc=xc)
    engines, sols = [], []
    for x in _geometries(mol):
        eng = SCFEngine(mol, coords=x, device="cpu", jit_kernel="on", **kw)
        sols.append(eng.kernel())
        engines.append(eng)
        eager_eng = SCFEngine(mol, coords=x, device="cpu", jit_kernel="off", **kw)
        eager = eager_eng.kernel()
        assert eng.last_run["mode"] == "graph" and sols[-1].converged
        assert abs(sols[-1].e_tot - eager.e_tot) < 1e-10
        assert eng.last_run["cycles"] == eager_eng.last_run["cycles"]
        theirs = RefEngine(ref_mol, coords=x, jit_kernel="on", **kw).kernel()
        assert abs(sols[-1].e_tot - float(theirs.e_tot)) < 1e-10
    assert len(_kernel_programs(engines[0])) == 1
    assert abs(sols[0].e_tot - sols[1].e_tot) > 1e-4
    sig = (torch.float64, mol.nelec, (False, False, False), 0.0, engine_mod.DISPATCH_CYCLES)
    assert engines[0]._scf_graph(*sig) is engines[1]._scf_graph(*sig)


def test_interleaved_engines_stay_bitwise(mols):
    """A, B, A on one program: A's second call equals its first bitwise,
    its operators copied back into the program's buffers."""
    _, mol = mols
    a, b = (SCFEngine(mol, coords=x, xc="b3lyp", device="cpu", jit_kernel="on", **TIGHT)
            for x in _geometries(mol))
    first = a.kernel()
    b.kernel()
    veff_b = b.get_veff(first.make_rdm1())
    again = a.kernel()
    assert again.e_tot == first.e_tot
    assert torch.equal(again.make_rdm1(), first.make_rdm1())
    veff_a = a.get_veff(first.make_rdm1())
    assert torch.equal(veff_a.matrix, a.get_veff(first.make_rdm1()).matrix)
    assert not torch.equal(veff_a.matrix, veff_b.matrix)


# engine options by the reference's _jit_spec field they set, and options
# outside it; each a (port kwargs, reference kwargs, molecule kwargs) change
VARIATIONS = {
    "basis": ({}, {}, {"basis": "6-31g"}),
    "charge_spin": ({}, {}, {"charge": 1, "spin": 1}),
    "mm_charges": ({}, {}, {"mm_coords": [[0.0, 0.0, 3.0]], "mm_charges": [-0.8],
                            "mm_radii": [0.8]}),
    "xc": ({"xc": "pbe"}, {"xc": "pbe"}, {}),
    "rohf": ({"rohf": True}, {"rohf": True}, {}),
    "density_fitting": ({"density_fitting": True}, {"density_fitting": True}, {}),
    "df_beta": ({"df_beta": 2.0}, {"df_beta": 2.0}, {}),
    "incremental_jk": ({"incremental_jk": "on"}, {"incremental_jk": "on"}, {}),
    "incremental_auto": ({"incremental_jk": "auto"}, {"incremental_jk": "auto"}, {}),
    "rebase_every": ({"rebase_every": 4}, {"rebase_every": 4}, {}),
    "grid_scheme": ({"grid_scheme": "product"}, {"grid_scheme": "product"}, {}),
    "grid_size": ({"grid_size": (64, 16)}, {"grid_size": (64, 16)}, {}),
    "grid_level": ({"grid_level": 2}, {"grid_level": 2}, {}),
    "max_memory": ({"max_memory_mb": 100.0}, {"max_memory_mb": 100.0}, {}),
    # outside the structure: geometry and call options
    "coords": ("coords", "coords", {}),
    "conv_tol": ({"conv_tol": 1e-9}, {"conv_tol": 1e-9}, {}),
    "max_cycle": ({"max_cycle": 77}, {"max_cycle": 77}, {}),
    "warmup_f32": ({"warmup_f32": True}, {"warmup_f32": True}, {}),
    "restricted": ({"restricted": True}, {"restricted": True}, {}),
    "dispatch_cycles": ({"dispatch_cycles": 4}, {"dispatch_cycles": 4}, {}),
    "jit_kernel": ({"jit_kernel": "off"}, {"jit_kernel": "off"}, {}),
    "init_guess": ({"init_guess": "hcore"}, {"init_guess": "hcore"}, {}),
}


@pytest.mark.parametrize("name", sorted(VARIATIONS))
def test_keys_differ_where_the_reference_spec_does(water_xyz, name):
    """One option changed from a B3LYP engine: the port's structure key
    changes exactly where nbed_tpu's ``_jit_spec`` does (no integrals are
    computed: both specs read options and the molecule only)."""
    port_kw, ref_kw, mol_kw = VARIATIONS[name]
    mol_kw = dict(mol_kw)
    basis = mol_kw.pop("basis", "sto-3g")
    same = []
    for build, engine, kw, extra in ((build_molecule, SCFEngine, port_kw, {"device": "cpu"}),
                                     (ref_build_molecule, RefEngine, ref_kw, {})):
        mol0 = build(water_xyz, "sto-3g")
        base = engine(mol0, xc="b3lyp", **extra)._jit_spec
        if kw == "coords":
            x = np.asarray(mol0.coords, dtype=np.float64) + 0.01
            other = engine(mol0, xc="b3lyp", coords=x, **extra)._jit_spec
        else:
            mol1 = build(water_xyz, basis, **mol_kw)
            other = engine(mol1, **{"xc": "b3lyp", **kw}, **extra)._jit_spec
        same.append(base == other)
    assert same[0] == same[1], f"{name}: port same={same[0]}, reference same={same[1]}"


class _Probe:
    """A program of the cache that holds its operator buffers and reads no
    operator."""
    needs = ()

    def __init__(self, operands):
        self.operands = operands


def test_programs_are_keyed_by_card(mols):
    """Two engines of one structure on two cards ("cpu", and "cuda:1" set
    after construction: only the keys are built, nothing runs there) get
    distinct programs and operator buffers; a third engine on the first
    card shares the first's."""
    _, mol = mols
    engines = [SCFEngine(mol, device="cpu") for _ in range(3)]
    engines[1].device = torch.device("cuda", 1)
    progs = [eng._shared_jit("probe", _Probe) for eng in engines]
    assert progs[0] is progs[2] and progs[1] is not progs[0]
    assert sorted(str(key[-1]) for key in engine_mod._JIT_PROGRAM_CACHE) == ["cpu", "cuda:1"]
    ops_keys = [key for key in engine_mod._OPERANDS.keys() if key[0] == engines[0]._jit_spec]
    assert sorted(str(key[-1]) for key in ops_keys) == ["cpu", "cuda:1"]


def test_lru_promotes_on_hit_and_evicts_the_least_recent(monkeypatch):
    monkeypatch.setattr(engine_mod, "_JIT_PROGRAM_CACHE_MAX", 2)
    built = []

    def get(key):
        return engine_mod._shared_program(key, lambda: built.append(key) or key)

    get("a")
    get("b")
    assert get("a") == "a" and built == ["a", "b"]  # a hit, promoted
    get("c")  # evicts b, the least recently used
    assert list(engine_mod._JIT_PROGRAM_CACHE) == ["a", "c"]
    get("b")  # a miss again: evicts a
    assert built == ["a", "b", "c", "b"]
    assert list(engine_mod._JIT_PROGRAM_CACHE) == ["c", "b"]


def test_engines_evict_programs_beyond_the_bound(mols, monkeypatch):
    """At a bound of 2, a third signature's program evicts the least
    recently used one; a later call of the evicted signature builds it
    again and gets the same energy."""
    _, mol = mols
    monkeypatch.setattr(engine_mod, "_JIT_PROGRAM_CACHE_MAX", 2)
    eng = SCFEngine(mol, device="cpu", jit_kernel="on", init_guess="hcore", **TIGHT)
    first = eng.kernel(nelec=(5, 5))
    eng.kernel(nelec=(4, 4))
    eng.kernel(nelec=(3, 3))
    assert len(engine_mod._JIT_PROGRAM_CACHE) == 2
    assert all(key[3][1] != (5, 5) for key in engine_mod._JIT_PROGRAM_CACHE)
    assert eng.kernel(nelec=(5, 5)).e_tot == first.e_tot


@pytest.mark.parametrize("density_fitting", [False, True])
def test_shared_programs_hold_no_engine(mols, density_fitting):
    """A dropped engine goes at once, without the cyclic collector: the
    cache holds its operators' copies, not the engine, and a second engine
    of the structure still runs the program."""
    _, mol = mols
    kw = dict(TIGHT, xc="b3lyp", density_fitting=density_fitting)
    eng = SCFEngine(mol, device="cpu", jit_kernel="on", **kw)
    e_first = eng.kernel().e_tot
    eng.get_veff(torch.eye(mol.nao, dtype=torch.float64) * 0.1)
    ref = weakref.ref(eng)
    collecting = gc.isenabled()
    gc.disable()
    try:
        del eng
        assert ref() is None
    finally:
        if collecting:
            gc.enable()
    assert engine_mod._JIT_PROGRAM_CACHE
    again = SCFEngine(mol, device="cpu", jit_kernel="on", **kw)
    assert again.kernel().e_tot == e_first
