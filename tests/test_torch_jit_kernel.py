"""The graphed SCF programs of nbed_tpu_torch (``SCFEngine(jit_kernel=,
dispatch_cycles=, integrals_backend=)``) against nbed_tpu's jitted and
chunked programs (water/STO-3G, float64 CPU).

On the CPU ``jit_kernel="on"`` runs the chunk body of
:class:`nbed_tpu_torch.scf.hf.SCFProgram` without capture, so these tests
hold the captured body's arithmetic; a ``cuda``-marked test holds a CUDA
graph replay against the same body run uncaptured on a card.
"""

import numpy as np
import pytest
import torch

from nbed_tpu.scf.engine import SCFEngine as RefEngine
from nbed_tpu.scf.hf import run_scf as ref_run_scf
from nbed_tpu_torch.chem import build_molecule
from nbed_tpu_torch.interop import molecule_from_reference
from nbed_tpu_torch.ops import jk
from nbed_tpu_torch.scf import SCFEngine, run_scf
from nbed_tpu_torch.scf import engine as engine_mod
from nbed_tpu_torch.scf.hf import SCFProgram

# one torch thread per test process: under pytest-xdist the OpenMP threads
# of several workers spin on the same cores and slow every worker many-fold
torch.set_num_threads(1)

TIGHT = dict(conv_tol=1e-10, dm_conv_tol=1e-8, max_cycle=100)
METHODS = {"hf": dict(TIGHT), "b3lyp": dict(TIGHT, xc="b3lyp"),
           "df": dict(TIGHT, density_fitting=True)}


@pytest.fixture(scope="module")
def mols(water_molecule):
    return water_molecule, molecule_from_reference(water_molecule)


def _port(mol, **kw):
    return SCFEngine(mol, device="cpu", **kw)


def _v_emb(nao):
    rng = np.random.default_rng(3)
    v = rng.normal(size=(nao, nao)) * 0.01
    return v + v.T


@pytest.mark.parametrize("method", sorted(METHODS))
def test_graphed_kernel_matches_reference_jit(mols, method):
    """HF, B3LYP and DF: the port's graphed body against the reference's
    one compiled program, and against the port's eager loop cycle for
    cycle."""
    ref_mol, mol = mols
    kw = METHODS[method]
    theirs = RefEngine(ref_mol, jit_kernel="on", **kw).kernel()
    eng = _port(mol, jit_kernel="on", **kw)
    ours = eng.kernel()
    assert ours.converged and eng.last_run["mode"] == "graph"
    assert abs(ours.e_tot - theirs.e_tot) < 1e-10
    eager = _port(mol, jit_kernel="off", **kw)
    ref = eager.kernel()
    assert eager.last_run["mode"] == "eager"
    assert abs(ours.e_tot - ref.e_tot) < 1e-10
    assert eng.last_run["cycles"] == eager.last_run["cycles"]
    np.testing.assert_allclose(ours.make_rdm1().numpy(), theirs.make_rdm1(), atol=1e-8)


def test_v_emb_matches_reference_jit(mols):
    ref_mol, mol = mols
    v = _v_emb(mol.nao)
    theirs = RefEngine(ref_mol, jit_kernel="on", **TIGHT).kernel(nelec=(3, 3), v_emb=v)
    ours = _port(mol, jit_kernel="on", **TIGHT).kernel(nelec=(3, 3), v_emb=v)
    assert ours.converged
    assert abs(ours.e_tot - theirs.e_tot) < 1e-10
    np.testing.assert_allclose(ours.v_emb.numpy(), v)


@pytest.fixture(scope="module")
def huzinaga_inputs(water_uhf):
    """A seeded embedding potential, the lowest occupied MO per spin as the
    occupied environment and the highest virtual as the virtual one."""
    c = np.asarray(water_uhf.mo_coeff)
    n = c.shape[1]
    v = _v_emb(n)
    return dict(nelec=(4, 4), v_emb=np.stack([v, v]),
                dm_env_occ=np.einsum("spi,sqi->spq", c[:, :, :1], c[:, :, :1]),
                dm_env_virt=np.einsum("spi,sqi->spq", c[:, :, -1:], c[:, :, -1:]))


@pytest.mark.parametrize("level_shift", [0.0, 0.25])
def test_huzinaga_matches_reference_jit(mols, huzinaga_inputs, level_shift):
    ref_mol, mol = mols
    kw = dict(huzinaga_inputs, level_shift=level_shift)
    theirs = RefEngine(ref_mol, jit_kernel="on", **TIGHT).kernel(**kw)
    eng = _port(mol, jit_kernel="on", **TIGHT)
    ours = eng.kernel(**kw)
    assert ours.converged and eng.last_run["mode"] == "graph"
    assert abs(ours.e_tot - theirs.e_tot) < 1e-10
    np.testing.assert_allclose(ours.huzinaga_op.numpy(), np.asarray(theirs.huzinaga_op),
                               atol=1e-8)


@pytest.fixture(scope="module")
def ks_pair(mols):
    ref_mol, mol = mols
    return (RefEngine(ref_mol, xc="b3lyp", jit_kernel="on", **TIGHT),
            _port(mol, xc="b3lyp", jit_kernel="on", **TIGHT))


def test_get_veff_matches_reference_jit(ks_pair, water_uks):
    theirs_eng, ours_eng = ks_pair
    dm = water_uks.make_rdm1()
    theirs = theirs_eng.get_veff(dm)
    ours = ours_eng.get_veff(dm)
    eager = _port(ours_eng.mol, xc="b3lyp", jit_kernel="off").get_veff(dm)
    assert np.abs(ours.matrix.numpy() - np.asarray(theirs.matrix)).max() < 1e-12
    assert abs(float(ours.exc) - float(theirs.exc)) < 1e-12
    assert abs(float(ours.ecoul) - float(theirs.ecoul)) < 1e-12
    assert torch.equal(ours.matrix, eager.matrix) and float(ours.exc) == float(eager.exc)


def test_subsystem_decomposition_matches_reference_jit(ks_pair, water_uks):
    theirs_eng, ours_eng = ks_pair
    c, occ = np.asarray(water_uks.mo_coeff), np.asarray(water_uks.mo_occ)
    w = occ.copy()
    w[:, 2:] = 0.0
    dm_act = np.einsum("spi,si,sqi->spq", c, w, c)
    dm_env = np.einsum("spi,si,sqi->spq", c, occ - w, c)
    theirs = theirs_eng.subsystem_decomposition(dm_act, dm_env)
    ours = ours_eng.subsystem_decomposition(torch.tensor(dm_act), torch.tensor(dm_env))
    for a, b in zip(ours[:3], theirs[:3]):
        assert abs(a - b) < 1e-12
    assert np.abs(ours[3].numpy() - np.asarray(theirs[3])).max() < 1e-12


def test_chunked_dispatch_matches_reference(mols):
    """dispatch_cycles=4 against the reference's chunked run (which restarts
    DIIS at each chunk; the port's carries it) and its single program."""
    ref_mol, mol = mols
    kw = dict(xc="b3lyp", conv_tol=1e-9, max_cycle=100)
    chunked_ref = RefEngine(ref_mol, jit_kernel="on", dispatch_cycles=4, **kw).kernel()
    eng = _port(mol, jit_kernel="on", dispatch_cycles=4, **kw)
    chunked = eng.kernel()
    assert chunked.converged
    assert abs(chunked.e_tot - chunked_ref.e_tot) < 1e-9
    run = eng.last_run
    assert run["cycles_per_replay"] == 4
    # one replay per 4 cycles, and the final build's
    assert run["replays"] == -(-run["cycles"] // 4) + 1 == run["host_reads"]


@pytest.mark.parametrize("dispatch", [None, 0, 1, 3, 7, 100])
def test_any_chunk_gives_the_eager_iterates(mols, dispatch):
    """State carries across replays: every chunk size gives the eager
    loop's energy and cycle count."""
    _, mol = mols
    kw = dict(xc="b3lyp", conv_tol=1e-9, max_cycle=100)
    eager_eng = _port(mol, jit_kernel="off", **kw)
    eager = eager_eng.kernel()
    eng = _port(mol, jit_kernel="on", dispatch_cycles=dispatch, **kw)
    ours = eng.kernel()
    assert abs(ours.e_tot - eager.e_tot) < 1e-10
    assert eng.last_run["cycles"] == eager_eng.last_run["cycles"]


def test_dispatch_chunk_rules(mols):
    _, mol = mols
    assert _port(mol)._dispatch_chunk(50) == engine_mod.DISPATCH_CYCLES
    assert _port(mol)._dispatch_chunk(engine_mod.DISPATCH_CYCLES) is None
    assert _port(mol, dispatch_cycles=6)._dispatch_chunk(50) == 6
    assert _port(mol, dispatch_cycles=0)._dispatch_chunk(50) is None
    assert _port(mol, dispatch_cycles=50)._dispatch_chunk(50) is None
    with pytest.raises(ValueError):
        _port(mol, dispatch_cycles=-1)
    with pytest.raises(ValueError):
        _port(mol, jit_kernel="sometimes")
    with pytest.raises(ValueError):
        _port(mol, integrals_backend="pyscf")


def test_incremental_jk_is_graphed(mols):
    """jit_kernel="on" with incremental_jk="on" runs the incremental SCF as
    graphed programs: the port's eager incremental SCF within 1e-10 Ha in
    as many mixed-loop and polish cycles, nbed_tpu's jitted incremental SCF
    within 1e-8 Ha (the eager path's tolerance against nbed_tpu,
    tests/test_torch_mixed_precision.py); get_veff has no incremental
    build and is graphed as well."""
    ref_mol, mol = mols
    kw = dict(xc="b3lyp", incremental_jk="on", **TIGHT)
    eng = _port(mol, jit_kernel="on", **kw)
    ours = eng.kernel()
    assert ours.converged and eng.last_run["mode"] == "graph"
    eager_eng = _port(mol, jit_kernel="off", **kw)
    eager = eager_eng.kernel()
    assert abs(ours.e_tot - eager.e_tot) < 1e-10
    assert eng.last_run["cycles"] == eager_eng.last_run["cycles"]
    theirs = RefEngine(ref_mol, jit_kernel="on", **kw).kernel()
    assert abs(ours.e_tot - theirs.e_tot) < 1e-8
    eng.get_veff(torch.eye(mol.nao, dtype=torch.float64) * 0.1)


def test_differentiable_inputs_stay_eager(mols):
    """A requires_grad input: eager under "auto" (derivatives reach it),
    refused under "on"; the decision is the device's and the inputs'."""
    _, mol = mols
    v = torch.tensor(_v_emb(mol.nao), requires_grad=True)
    eng = _port(mol, jit_kernel="auto", **TIGHT)
    sol = eng.kernel(nelec=(3, 3), v_emb=v)
    assert eng.last_run["mode"] == "eager"
    (grad,) = torch.autograd.grad(sol.mo_energy.sum(), v)
    assert torch.isfinite(grad).all() and float(grad.abs().max()) > 0
    with pytest.raises(ValueError):
        _port(mol, jit_kernel="on", **TIGHT).kernel(nelec=(3, 3), v_emb=v)
    # "auto" on a CUDA engine graphs plain inputs only (the decision alone;
    # no CUDA work)
    object.__setattr__(eng, "device", torch.device("cuda"))
    plain = v.detach()
    assert eng._takes_graphs((plain, None))
    assert not eng._takes_graphs((v, None))
    with torch.autograd.forward_ad.dual_level():
        dual = torch.autograd.forward_ad.make_dual(plain, torch.ones_like(plain))
        assert not eng._takes_graphs((dual,))
    # the incremental SCF is graphed too
    eng.incremental_jk = "on"
    assert eng._takes_graphs((plain,))


@pytest.mark.parametrize("backend", ["torch", "jax"])
def test_torch_integrals_backend_matches_native(mols, backend):
    _, mol = mols
    native = _port(mol, integrals_backend="native", **TIGHT)
    dev = _port(mol, integrals_backend=backend, **TIGHT)
    for name in ("s", "hcore", "eri"):
        assert float((getattr(dev, name) - getattr(native, name)).abs().max()) < 1e-10
    assert abs(dev.kernel().e_tot - native.kernel().e_tot) < 1e-10


def test_torch_integrals_backend_rsh_and_qmmm(water_xyz):
    """The long-range ERIs of a range-separated hybrid and the Gaussian MM
    charges of a QM/MM molecule (a TIP3P water's) through the torch
    integrals."""
    mol = build_molecule(water_xyz, "sto-3g",
                         mm_coords=[[0.0, 0.0, 3.0], [0.0, 0.0, 2.0428], [0.9266, 0.0, 3.2397]],
                         mm_charges=[-0.834, 0.417, 0.417], mm_radii=[0.8, 0.4, 0.4])
    native = _port(mol, xc="camb3lyp", integrals_backend="native")
    dev = _port(mol, xc="camb3lyp", integrals_backend="torch")
    for name in ("hcore", "eri_lr", "eri_k"):
        assert float((getattr(dev, name) - getattr(native, name)).abs().max()) < 1e-10


def test_x_matches_reference(mols, water_uhf_engine):
    _, mol = mols
    np.testing.assert_allclose(_port(mol).x.numpy(), np.asarray(water_uhf_engine.x),
                               atol=1e-12)


def test_run_scf_supermatrices_and_diis_space(mols, water_uhf_engine):
    """run_scf(eri_j=, eri_k=, diis_space=6) against the reference's."""
    _, mol = mols
    ref = water_uhf_engine
    kw = dict(nelec=(5, 5), diis_space=6, **TIGHT)
    theirs = ref_run_scf(hcore=ref.hcore, s=ref.s, eri_j=ref.eri_j, eri_k=ref.eri_k, **kw)
    eng = _port(mol)
    ours = run_scf(hcore=eng.hcore, s=eng.s, eri_j=eng.eri_j, eri_k=eng.eri_k, **kw)
    assert ours.converged and bool(theirs.converged)
    assert abs(ours.e_elec - float(theirs.e_elec)) < 1e-10
    assert ours.n_iter == int(theirs.n_iter)
    with pytest.raises(ValueError):
        run_scf(hcore=eng.hcore, s=eng.s, eri_j=eng.eri_j, **kw)


ROUTES = {
    "hf": ("water", dict(TIGHT)),
    "b3lyp": ("water", dict(xc="b3lyp", **TIGHT)),
    "rohf": ("methyl", dict(rohf=True, **TIGHT)),
    "roks": ("methyl", dict(rohf=True, xc="b3lyp", **TIGHT)),
    "restricted": ("water", dict(restricted=True, xc="b3lyp", **TIGHT)),
    "camb3lyp": ("water", dict(xc="camb3lyp", **TIGHT)),
    "df_camb3lyp": ("water", dict(xc="camb3lyp", density_fitting=True, **TIGHT)),
    "streaming_xc": ("water", dict(xc="b3lyp", max_memory_mb=0.01, **TIGHT)),
    "warmup_f32": ("water", dict(xc="b3lyp", warmup_f32=True, **TIGHT)),
    "pbe": ("water", dict(xc="pbe", **TIGHT)),
}
# the routes whose eager run and program body are held bitwise equal: one
# SCF cycle (scf.hf._lane_ops) runs both, one geometry as one lane
ONE_CYCLE = ("hf", "b3lyp")


@pytest.mark.parametrize("route", sorted(ROUTES))
def test_graphed_routes_match_eager(route, water_xyz):
    """Every route of the body against the eager loop: energy within 1e-10
    Ha, the same cycles; on the routes of ``ONE_CYCLE`` the same energy and
    density bitwise."""
    from pathlib import Path

    which, kw = ROUTES[route]
    if which == "methyl":
        xyz = (Path(__file__).parent / "molecules" / "methyl_radical.xyz").read_text()
        mol = build_molecule(xyz, "sto-3g", spin=1)
    else:
        mol = build_molecule(water_xyz, "sto-3g")
    eager_eng = _port(mol, jit_kernel="off", **kw)
    eager = eager_eng.kernel()
    eng = _port(mol, jit_kernel="on", **kw)
    ours = eng.kernel()
    assert ours.converged and eager.converged
    assert abs(ours.e_tot - eager.e_tot) < 1e-10
    assert eng.last_run["cycles"] == eager_eng.last_run["cycles"]
    assert ours.mo_coeff.shape == eager.mo_coeff.shape
    if route in ONE_CYCLE:
        assert ours.e_tot == eager.e_tot
        assert torch.equal(ours.make_rdm1(), eager.make_rdm1())
    if route == "streaming_xc":
        assert eng._xc_streams
    if route == "warmup_f32":
        assert eng.last_run["warmup_cycles"] == eager_eng.last_run["warmup_cycles"]


def test_program_state_carries_between_chunks(mols):
    """SCFProgram: k cycles in one call or one cycle at a time give the
    same state bitwise; a converged state no longer changes."""
    _, mol = mols
    eng = _port(mol, **TIGHT)
    progs = [SCFProgram(hcore=eng.hcore, s=eng.s, x=eng.x, nelec=mol.nelec,
                        jk_fn=eng.get_jk) for _ in range(2)]
    for prog in progs:
        prog.load(conv_tol=1e-10, dm_conv_tol=1e-8, max_cycle=100)
    progs[0].run_cycles(5)
    for _ in range(5):
        progs[1].run_cycles(1)
    for key in progs[0].state:
        assert torch.equal(progs[0].state[key], progs[1].state[key]), key
    progs[0].run_cycles(40)
    conv, cycles, _ = progs[0].flags.tolist()
    assert conv and cycles < 45
    dm = progs[0].state["dm"].clone()
    progs[0].run_cycles(3)
    assert torch.equal(progs[0].state["dm"], dm)
    assert progs[0].flags.tolist()[1] == cycles


@pytest.mark.parametrize("density_fitting", [False, True])
def test_dropped_engine_is_freed_without_the_cyclic_collector(mols, density_fitting):
    """An engine's graphed programs hold its operators, not the engine: a
    dropped engine (and, on a card, its graphs and their memory pool) goes
    at once, not at the cyclic collector's next run, which could come
    during another engine's capture."""
    import gc
    import weakref

    _, mol = mols
    eng = _port(mol, xc="b3lyp", jit_kernel="on", density_fitting=density_fitting, **TIGHT)
    eng.kernel()
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


def test_launch_record_counts_per_replay():
    from collections import Counter

    counter = Counter()
    record = jk.LaunchRecord()
    with jk.recording(record):
        assert jk._RECORDINGS[-1] is record
        record.add(counter, "k")
        record.add(counter, "k")
    assert not jk._RECORDINGS and counter == Counter()
    record.replayed(3)
    assert counter["k"] == 6 and record.launches(counter) == {"k": 2}


@pytest.mark.cuda
def test_cuda_replay_equals_uncaptured_body(water_xyz):
    """On a card: the graphed SCF against the eager engine, and a replay of
    the captured chunk and final build bitwise equal to the same body run
    uncaptured from the same state."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (CUDA graphs and the cuSOLVER eigh have no CPU mode)")
    mol = build_molecule(water_xyz, "sto-3g")
    eng = SCFEngine(mol, xc="b3lyp", device="cuda", jit_kernel="on", **TIGHT)
    ours = eng.kernel()
    eager_eng = SCFEngine(mol, xc="b3lyp", device="cuda", jit_kernel="off", **TIGHT)
    eager = eager_eng.kernel()
    assert abs(ours.e_tot - eager.e_tot) < 1e-10
    assert eng.last_run["cycles"] == eager_eng.last_run["cycles"]
    graph = eng._scf_graph(torch.float64, mol.nelec, (False, False, False), 0.0,
                           engine_mod.DISPATCH_CYCLES)
    prog = graph.program
    inputs = dict(dm0=eng._sad_guess(), conv_tol=1e-10, dm_conv_tol=1e-8, max_cycle=100)
    prog.load(**inputs)
    prog.run_cycles(graph.cycles)
    prog.finish()
    body = {k: v.clone() for k, v in prog.state.items()}
    body_fock = prog.fock.clone()
    prog.load(**inputs)
    graph.chunk()
    graph.final()
    torch.cuda.synchronize()
    for key, value in body.items():
        assert torch.equal(prog.state[key], value), key
    assert torch.equal(prog.fock, body_fock)
