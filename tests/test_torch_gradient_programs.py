"""The derivative programs of nbed_tpu_torch (``ops.programs.DERIVATIVE_PROGRAMS``:
the "eri" program of the torch ERIs, and the "hf_grad"/"ks_grad" programs
whose body runs the integrals' forward, the energy functional and its
``torch.autograd.grad``), run uncaptured on the CPU (``jit_kernel="on"``):
within 1e-12 Ha/bohr of the eager route (``"off"``), within the existing
tests' tolerances of nbed_tpu's gradients (H2 and lanes of H2: the
reference's water gradients take minutes to compile here), one program per
structure shared by its geometries, lanes per pass in the key, and bodies
that copy nothing from the host (what a CUDA graph captures). The ``cuda``
test holds the graphs against the eager route on the card.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nbed_tpu.chem import build_molecule as ref_build_molecule
from nbed_tpu.parallel import batched_hf_gradients as ref_batched_hf_gradients
from nbed_tpu.solvers.gradients import hf_gradient as ref_hf_gradient
from nbed_tpu.solvers.gradients import ks_gradient as ref_ks_gradient
from nbed_tpu_torch.chem import build_molecule
from nbed_tpu_torch.grids.grid import grid_constants, grid_points
from nbed_tpu_torch.integrals import eri_tensor
from nbed_tpu_torch.integrals.eri import eri_program
from nbed_tpu_torch.ops import programs
from nbed_tpu_torch.ops.programs import DERIVATIVE_PROGRAMS, RUNS
from nbed_tpu_torch.parallel import batched_hf_gradients, sharding
from nbed_tpu_torch.solvers import hessian_fd, hf_gradient, ks_gradient, optimize_geometry

torch.set_num_threads(1)

H2_XYZ = "2\n\nH 0.0 0.0 0.0\nH 0.0 0.0 0.74\n"
TIGHT = dict(conv_tol=1e-12, dm_conv_tol=1e-10, max_cycle=200)
# the program body against the eager route (Ha/bohr)
ROUTES = 1e-12


@pytest.fixture(scope="module")
def h2():
    return build_molecule(H2_XYZ, "sto-3g")


@pytest.fixture(scope="module")
def water(water_xyz):
    return build_molecule(water_xyz, "sto-3g")


def _kinds():
    return sorted(key[0] for key in DERIVATIVE_PROGRAMS)


def _max(a, b) -> float:
    return float(np.max(np.abs(np.asarray(a) - np.asarray(b))))


@pytest.mark.parametrize("name", ["h2", "water"])
def test_hf_gradient_program_matches_eager(name, h2, water):
    mol = h2 if name == "h2" else water
    DERIVATIVE_PROGRAMS.clear()
    before = RUNS["hf_grad"], RUNS["eri"]
    e, g, res = hf_gradient(mol, device="cpu", jit_kernel="on", **TIGHT)
    assert (RUNS["hf_grad"], RUNS["eri"]) == (before[0] + 1, before[1] + 1)
    assert _kinds() == ["eri", "hf_grad"]
    e0, g0, _ = hf_gradient(mol, device="cpu", jit_kernel="off", **TIGHT)
    assert res.converged and g.shape == (mol.natm, 3)
    assert abs(e - e0) < 1e-12 and _max(g, g0) < ROUTES
    # the program's own scf_result route: no SCF, the same gradient
    assert _max(hf_gradient(mol, scf_result=res, device="cpu", jit_kernel="on")[1], g) < ROUTES


def test_hf_gradient_program_matches_nbed_tpu(h2):
    e_ref, g_ref, _ = ref_hf_gradient(ref_build_molecule(H2_XYZ, "sto-3g"))
    e, g, _ = hf_gradient(h2, device="cpu", jit_kernel="on")
    assert abs(e - float(e_ref)) < 1e-9
    np.testing.assert_allclose(g.numpy(), np.asarray(g_ref), rtol=0, atol=1e-9)


@pytest.mark.parametrize("name, xc", [("h2", "b3lyp"), ("h2", "cam-b3lyp"), ("h2", "svwn"),
                                      ("water", "b3lyp")])
def test_ks_gradient_program_matches_eager(name, xc, h2, water):
    """Grid response (points, Becke weights and AO tables at x inside the
    program) and the long-range ERIs of a range-separated hybrid."""
    mol = h2 if name == "h2" else water
    before = RUNS["ks_grad"]
    e, g, sol = ks_gradient(mol, xc, device="cpu", jit_kernel="on", **TIGHT)
    assert RUNS["ks_grad"] == before + 1
    # the eager gradient on the same SCF solution
    _, g0, _ = ks_gradient(mol, xc, solution=sol, device="cpu", jit_kernel="off")
    assert sol.converged and _max(g, g0) < ROUTES


@pytest.mark.parametrize("xc", ["b3lyp", "cam-b3lyp"])
def test_ks_gradient_program_matches_nbed_tpu(xc, h2):
    e_ref, g_ref, _ = ref_ks_gradient(ref_build_molecule(H2_XYZ, "sto-3g"), xc, **TIGHT)
    e, g, _ = ks_gradient(h2, xc, device="cpu", jit_kernel="on", **TIGHT)
    assert abs(e - float(e_ref)) < 1e-8
    np.testing.assert_allclose(g.numpy(), np.asarray(g_ref), rtol=0, atol=1e-8)


def test_lane_gradient_program_matches_eager_and_nbed_tpu(h2):
    """B = 2 lanes: one "eri" and one "hf_grad" program of two lanes."""
    lanes = np.stack([h2.coords, h2.coords * 1.05])
    DERIVATIVE_PROGRAMS.clear()
    e, g, conv = batched_hf_gradients(h2, lanes, device="cpu", jit_kernel="on")
    assert [(key[0], key[2]) for key in DERIVATIVE_PROGRAMS] == [("eri", (2, 2, 3)),
                                                                 ("hf_grad", (2, 2, 3))]
    e0, g0, _ = batched_hf_gradients(h2, lanes, device="cpu", jit_kernel="off")
    assert bool(conv.all()) and _max(g, g0) < ROUTES and _max(e, e0) < 1e-12
    e_ref, g_ref, _ = ref_batched_hf_gradients(ref_build_molecule(H2_XYZ, "sto-3g"),
                                               jnp.asarray(lanes))
    np.testing.assert_allclose(e.numpy(), np.asarray(e_ref), rtol=0, atol=1e-10)
    np.testing.assert_allclose(g.numpy(), np.asarray(g_ref), rtol=0, atol=1e-9)


def test_ks_hessian_replays_one_program(h2):
    """H2/SVWN: the 6N = 12 displaced gradients replay one "ks_grad"
    program; the Hessian within 1e-9 Ha/bohr^2 of the eager route's."""
    DERIVATIVE_PROGRAMS.clear()
    before = RUNS["ks_grad"]
    hess = hessian_fd(h2, xc="svwn", device="cpu", jit_kernel="on")
    assert RUNS["ks_grad"] == before + 12 and _kinds() == ["ks_grad"]
    hess0 = hessian_fd(h2, xc="svwn", device="cpu", jit_kernel="off")
    assert hess.shape == (6, 6) and _max(hess, hess0) < 1e-9


def test_optimization_replays_its_programs(h2):
    """Every BFGS step replays the structure's "eri" and "hf_grad"
    programs; the path is the eager route's."""
    DERIVATIVE_PROGRAMS.clear()
    coords, e, steps, ok = optimize_geometry(h2, device="cpu", jit_kernel="on")
    assert _kinds() == ["eri", "hf_grad"]
    coords0, e0, steps0, ok0 = optimize_geometry(h2, device="cpu", jit_kernel="off")
    assert ok and ok0 and steps == steps0 and abs(e - e0) < 1e-12
    assert _max(coords, coords0) < 1e-10


@pytest.mark.parametrize("omega, lanes", [(None, False), (0.4, False), (None, True)])
def test_eri_program_equals_eri_tensor(omega, lanes, water):
    x = torch.tensor(water.coords)
    if lanes:
        x = torch.stack([x, x * 1.01])
    before = RUNS["eri"]
    ours = eri_program(water, x, omega=omega, jit_kernel="on")
    assert RUNS["eri"] == before + 1
    assert torch.equal(ours, eri_tensor(water, x, omega=omega, device="cpu"))


@pytest.mark.parametrize("kind", ["hf", "ks"])
def test_one_program_serves_two_geometries(kind, h2, water):
    """A second geometry of the structure replays the programs the first
    built, and its gradient equals a fresh eager one there: nothing of the
    first geometry leaks through the buffers (HF on water, B3LYP on H2)."""
    mol = water if kind == "hf" else h2

    def grad(coords, mode):
        if kind == "hf":
            return hf_gradient(mol, coords=coords, device="cpu", jit_kernel=mode, **TIGHT)[1]
        return ks_gradient(mol, "b3lyp", coords=coords, device="cpu", jit_kernel=mode,
                           **TIGHT)[1]

    DERIVATIVE_PROGRAMS.clear()
    grad(mol.coords, "on")
    programs_before = dict(DERIVATIVE_PROGRAMS)
    moved = mol.coords.copy()
    moved[0] += [0.01, 0.03, -0.1]
    ours = grad(moved, "on")
    assert DERIVATIVE_PROGRAMS == programs_before
    assert _max(ours, grad(moved, "off")) < ROUTES
    assert _max(ours, grad(mol.coords, "off")) > 1e-3


def test_lanes_per_pass_is_part_of_the_key(h2, monkeypatch):
    """The lanes of one reverse pass of the lane program are its key's
    shape: one lane per pass gives one "hf_grad" program of one lane,
    replayed per lane, and the same gradients."""
    lanes = np.stack([h2.coords, h2.coords * 1.05])
    monkeypatch.setattr(sharding, "_lanes_per_program", lambda mol, x: 1)
    DERIVATIVE_PROGRAMS.clear()
    before = RUNS["hf_grad"]
    g = batched_hf_gradients(h2, lanes, device="cpu", jit_kernel="on")[1]
    assert RUNS["hf_grad"] == before + 2
    assert [key[2] for key in DERIVATIVE_PROGRAMS if key[0] == "hf_grad"] == [(1, 2, 3)]
    g0 = batched_hf_gradients(h2, lanes, device="cpu", jit_kernel="off")[1]
    assert _max(g, g0) < ROUTES


@pytest.mark.parametrize("nb, most, step", [(36, 13, 12), (36, 36, 36), (36, 100, 36),
                                            (36, 7, 6), (5, 2, 2), (7, 0, 1)])
def test_lane_passes_are_even(nb, most, step):
    """At most ``most`` lanes a pass, as even as the passes allow (one
    program shape where it divides)."""
    assert sharding._even_passes(nb, most) == step


@pytest.mark.parametrize("kind", ["eri", "hf_grad", "ks_grad"])
def test_program_body_copies_nothing_from_the_host(kind, water, monkeypatch):
    """With the tables built, a body runs with torch.tensor and
    torch.as_tensor raising and writes the same outputs (a CUDA graph
    captures no host-to-device copy)."""
    DERIVATIVE_PROGRAMS.clear()
    if kind == "ks_grad":  # the long-range ERIs and the grid response too
        ks_gradient(water, "cam-b3lyp", device="cpu", jit_kernel="on")
    else:
        hf_gradient(water, device="cpu", jit_kernel="on")
    prog = next(p for key, p in DERIVATIVE_PROGRAMS.items() if key[0] == kind)
    want = {name: t.clone() for name, t in prog.outputs.items()}
    for t in prog.outputs.values():
        t.zero_()

    def refuse(*args, **kwargs):
        raise AssertionError("host-to-device copy inside the program body")

    monkeypatch.setattr(torch, "tensor", refuse)
    monkeypatch.setattr(torch, "as_tensor", refuse)
    prog.captured.fn()
    monkeypatch.undo()
    assert all(torch.equal(prog.outputs[name], want[name]) for name in want)


def test_programs_hold_the_cached_tables_their_bodies_read(water, monkeypatch):
    """Every device table a body takes from a bounded cache (a molecule's
    one-electron pair tables, charges, nuclear-repulsion constants) is
    held by its program: a graph reads them by address, so a cache
    eviction must not free them."""
    from nbed_tpu_torch.chem import molecule
    from nbed_tpu_torch.integrals import core

    DERIVATIVE_PROGRAMS.clear()
    hf_gradient(water, device="cpu", jit_kernel="on")
    ks_gradient(water, "b3lyp", device="cpu", jit_kernel="on")
    read = []

    def recording(fn):
        def wrapper(*args):
            out = fn(*args)
            read.append(out)
            return out
        return wrapper

    for module, name in ((core, "_device_pair_tables"), (core, "_nuclear_charges"),
                         (molecule, "_nuclear_tables")):
        monkeypatch.setattr(module, name, recording(getattr(module, name)))
    for key, prog in DERIVATIVE_PROGRAMS.items():
        read.clear()
        prog.captured.fn()
        assert key[0] == "eri" or read
        assert all(any(r is held for held in prog.holds) for r in read), key[0]


def test_jit_kernel_routes(water):
    """"auto" runs the eager route on the CPU (no program); "on" refuses
    coordinates that carry a derivative; other values raise."""
    DERIVATIVE_PROGRAMS.clear()
    hf_gradient(water, device="cpu")
    assert not DERIVATIVE_PROGRAMS
    x = torch.tensor(water.coords, requires_grad=True)
    with pytest.raises(ValueError, match="requires_grad"):
        eri_program(water, x, jit_kernel="on")
    assert eri_program(water, x, jit_kernel="auto").requires_grad  # eager, differentiable
    with pytest.raises(ValueError, match="jit_kernel"):
        programs.takes_program("sometimes", (x,))


def test_becke_weights_under_autograd_match_forward(water):
    """The Becke product multiplied out under autograd (torch.prod's
    backward reads its zeros on the host) gives torch.prod's weights."""
    constants = grid_constants(water, device="cpu")
    x = torch.tensor(water.coords)
    _, w = grid_points(constants, x)
    _, w_grad = grid_points(constants, x.clone().requires_grad_(True))
    assert float(torch.max(torch.abs(w_grad.detach() - w))) < 1e-15


@pytest.mark.cuda
def test_cuda_gradient_programs_match_eager(water):
    """On the card: the captured gradients and ERIs against the eager
    route, and no capture at a second geometry."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (CUDA graphs have no CPU mode)")
    DERIVATIVE_PROGRAMS.clear()
    for coords in (water.coords, water.coords * 1.01):
        captures = RUNS["captures"]
        g = hf_gradient(water, coords=coords, device="cuda", **TIGHT)[1]
        k = ks_gradient(water, "b3lyp", coords=coords, device="cuda", **TIGHT)[1]
        if coords is not water.coords:
            assert RUNS["captures"] == captures
        g0 = hf_gradient(water, coords=coords, device="cuda", jit_kernel="off", **TIGHT)[1]
        k0 = ks_gradient(water, "b3lyp", coords=coords, device="cuda", jit_kernel="off",
                         **TIGHT)[1]
        assert _max(g.cpu(), g0.cpu()) < 1e-11 and _max(k.cpu(), k0.cpu()) < 1e-11
