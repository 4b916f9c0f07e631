"""The CCSD amplitude sweep and the (T) energy as programs
(``nbed_tpu_torch.solvers.ccsd._SweepProgram``, ``_TriplesProgram``)
against nbed_tpu's jitted ``_make_sweep`` and ``_make_triples_energy`` on
the same inputs, uncaptured on the CPU: the device-side cycle (ring write
through a device slot, DIIS fill by ``torch.where``, the freeze after
convergence) gives the reference's energy in as many cycles, whatever the
cycles per call; the program caches mirror the reference's
``lru_cache(maxsize=8)``. The ``cuda`` tests hold the CUDA graphs against
the eager loop on the card.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nbed_tpu.solvers.ccsd import _make_sweep, _make_triples_energy
from nbed_tpu_torch import nbed
from nbed_tpu_torch.chem import build_molecule
from nbed_tpu_torch.driver import NbedDriver
from nbed_tpu_torch.ham import HamiltonianBuilder
from nbed_tpu_torch.ops.programs import RUNS
from nbed_tpu_torch.scf import SCFEngine
from nbed_tpu_torch.solvers import ccsd, run_ccsd
from nbed_tpu_torch.solvers.ccsd import (_antisymmetrized, _ccsd_step, _sweep, _triples_energy,
                                         _TriplesProgram)

torch.set_num_threads(1)

WATER = "tests/molecules/water.xyz"
LIH = "2\n\nLi 0.0 0.0 0.0\nH 0.0 0.0 1.6"
H2 = "2\n\nH 0.0 0.0 0.0\nH 0.0 0.0 0.7408481486"


def _operands(h1, h2, occ):
    """(fock, w, d1, d2, t1, t2) of run_ccsd, float64 torch, from the
    spin-orbital integrals."""
    occ = np.asarray(occ)
    order = torch.as_tensor(np.concatenate([np.where(occ)[0], np.where(~occ)[0]]))
    no = int(occ.sum())
    h1 = h1[order][:, order]
    w = _antisymmetrized(h2)[order][:, order][:, :, order][:, :, :, order]
    fock = h1 + torch.einsum("piqi->pq", w[:, :no, :, :no])
    eps = torch.diag(fock)
    d1 = eps[:no, None] - eps[None, no:]
    d2 = (eps[:no, None, None, None] + eps[None, :no, None, None]
          - eps[None, None, no:, None] - eps[None, None, None, no:])
    return fock, w, d1, d2, fock[:no, no:] / d1, w[:no, :no, no:, no:] / d2


def _hamiltonian(sol):
    _, h1, h2 = HamiltonianBuilder(sol, 0.0).build()
    return h1, h2, NbedDriver._interleaved_occ(sol)


@pytest.fixture(scope="module")
def systems():
    """{name: (h1, h2, occ)}: water's mu-embedded space (the port's driver
    on the reference's oracle configuration) and small global CCSDs."""
    with open(WATER) as f:
        water = f.read()
    driver = nbed(geometry=water, n_active_atoms=1, basis="STO-3G", xc_functional="b3lyp",
                  projector="mu", localization="spade", convergence=1e-6, device="cpu")
    out = {"water_mu": _hamiltonian(driver.mu["scf"])}
    for name, xyz in (("water_global", water), ("lih_global", LIH)):
        sol = SCFEngine(build_molecule(xyz, "sto-3g"), conv_tol=1e-11, dm_conv_tol=1e-9,
                        max_cycle=100, device="cpu").kernel()
        out[name] = _hamiltonian(sol)
    return out


def _reference_sweep(ops, dtype, conv_tol, r_tol, max_cycle=100):
    """nbed_tpu's _make_sweep(no, nv, 6) on the same operands."""
    fock, w, d1, d2, t1, t2 = (np.asarray(t) for t in ops)
    no, nv = t1.shape
    sweep = _make_sweep(no, nv, 6)
    args = [jnp.asarray(a, dtype) for a in (fock, w, d1, d2)]
    with jax.default_matmul_precision("float32"):
        out = sweep(*args, jnp.asarray(t1), jnp.asarray(t2), dtype(conv_tol), dtype(r_tol),
                    jnp.int32(max_cycle))
    return float(out[2]), int(out[4]), bool(out[5])


@pytest.mark.parametrize("name", ["water_mu", "water_global", "lih_global"])
def test_sweep_matches_nbed_tpu(systems, name):
    """Energy within 1e-10 Ha of the reference's while_loop, in as many
    cycles, converged."""
    ops = _operands(*systems[name])
    _, _, e, _, cycles, conv = _sweep(*ops, 1e-10, 1e-6, 100, 6)
    e_ref, cycles_ref, conv_ref = _reference_sweep(ops, jnp.float64, 1e-10, 1e-6)
    assert conv and conv_ref
    assert abs(e - e_ref) < 1e-10
    assert cycles == cycles_ref


@pytest.mark.parametrize("name", ["water_mu", "lih_global"])
def test_sweep_float32_matches_nbed_tpu(systems, name):
    """The float32 sweep (TF32 off, full float32 products) within 5e-5 Ha
    of the reference's float32 sweep and of the float64 energy."""
    fock, w, d1, d2, t1, t2 = _operands(*systems[name])
    f32 = torch.float32
    with ccsd._true_float32():
        _, _, e32, _, _, conv = _sweep(fock.to(f32), w.to(f32), d1.to(f32), d2.to(f32), t1, t2,
                                       1e-6, 1e-5, 100, 6)
    e_ref, _, _ = _reference_sweep((fock, w, d1, d2, t1, t2), jnp.float32, 1e-6, 1e-5)
    e64 = _sweep(fock, w, d1, d2, t1, t2, 1e-10, 1e-6, 100, 6)[2]
    assert conv
    assert abs(e32 - e_ref) < 5e-5 and abs(e32 - e64) < 5e-5


@pytest.mark.parametrize("precision, tol", [("f32", 5e-5), ("mixed", 1e-8)])
def test_run_ccsd_precision_modes_match_nbed_tpu(systems, precision, tol):
    from nbed_tpu.solvers import run_ccsd as ref_run_ccsd

    h1, h2, occ = systems["water_mu"]
    ours = run_ccsd(h1, h2, occ, conv_tol=1e-10, precision=precision)
    theirs = ref_run_ccsd(h1.numpy(), h2.numpy(), occ, conv_tol=1e-10, precision=precision)
    assert abs(ours[0] - theirs[0]) < tol


@pytest.mark.parametrize("name", ["water_mu", "water_global"])
@pytest.mark.parametrize("cycles", [2, 3, 7])
def test_cycles_per_call_freeze_after_convergence(systems, name, cycles):
    """K cycles per call (the replay of a K-cycle graph) give K = 1's
    amplitudes, energy and cycle count bitwise: cycles after convergence
    leave the state as it is."""
    ops = _operands(*systems[name])
    one = _sweep(*ops, 1e-10, 1e-6, 100, 6, cycles=1)
    many = _sweep(*ops, 1e-10, 1e-6, 100, 6, cycles=cycles)
    assert torch.equal(one[0], many[0]) and torch.equal(one[1], many[1])
    assert one[2:] == many[2:]


def test_max_cycle_freezes_the_sweep(systems):
    """Past max_cycle a call's cycles do nothing: 5 cycles at 3 per call
    stop at 5, unconverged, as the reference's while_loop does."""
    ops = _operands(*systems["water_global"])
    out = _sweep(*ops, 1e-12, 1e-9, 5, 6, cycles=3)
    e_ref, cycles_ref, conv_ref = _reference_sweep(ops, jnp.float64, 1e-12, 1e-9, max_cycle=5)
    assert out[4] == cycles_ref == 5 and out[5] is False and conv_ref is False
    assert abs(out[2] - e_ref) < 1e-10


def _host_branch_sweep(fock, w, d1, d2, t1, t2, conv_tol, r_tol, max_cycle, m):
    """The eager loop before the programs: a Python ``nfill >= 2`` branch
    around the DIIS solve, host reads of the energy and residual each
    cycle, the B matrix and e_m by slice assignment."""
    no, nv = t1.shape
    n1 = no * nv
    hist_t = torch.zeros((m, n1 + no * no * nv * nv), dtype=w.dtype)
    hist_r = torch.zeros_like(hist_t)
    nfill, e_prev, e_corr, conv, cycle = 0, float("inf"), 0.0, False, 0
    while cycle < max_cycle and not conv:
        t1n, t2n, e = _ccsd_step(t1, t2, fock, w, d1, d2, no, nv)
        r = torch.cat([(t1n - t1).reshape(-1), (t2n - t2).reshape(-1)])
        t_vec = torch.cat([t1n.reshape(-1), t2n.reshape(-1)])
        hist_t[cycle % m] = t_vec
        hist_r[cycle % m] = r
        nfill = min(nfill + 1, m)
        if nfill >= 2:
            b = hist_r @ hist_r.T
            filled = (torch.arange(m) < nfill).to(w.dtype)
            b = b * (filled[:, None] * filled[None, :]) + torch.diag(1.0 - filled)
            big = torch.zeros((m + 1, m + 1), dtype=w.dtype)
            big[:m, :m] = b
            big[:m, m] = filled
            big[m, :m] = filled
            rhs = torch.zeros(m + 1, dtype=w.dtype)
            rhs[m] = 1.0
            ew, ev = torch.linalg.eigh(big)
            cut = torch.max(torch.abs(ew)) * max(1e-12, (m + 1) * torch.finfo(w.dtype).eps)
            inv_ew = torch.where(torch.abs(ew) > cut, 1.0 / ew, torch.zeros_like(ew))
            t_vec = (((ev * inv_ew[None, :]) @ (ev.T @ rhs))[:m] * filled) @ hist_t
        t1, t2 = t_vec[:n1].reshape(no, nv), t_vec[n1:].reshape(no, no, nv, nv)
        e_corr, rmax = float(e), float(torch.max(torch.abs(r)))
        conv = abs(e_corr - e_prev) < conv_tol and rmax < r_tol
        e_prev = e_corr
        cycle += 1
    return t1, t2, e_corr, rmax, cycle, conv


@pytest.mark.parametrize("name", ["water_mu", "water_global", "lih_global"])
def test_device_diis_fill_equals_the_host_branch(systems, name):
    """torch.where(nfill >= 2, extrapolated, t_vec) on the device gives the
    host branch's iterates bitwise."""
    ops = _operands(*systems[name])
    ours = _sweep(*ops, 1e-10, 1e-6, 100, 6)
    old = _host_branch_sweep(*ops, 1e-10, 1e-6, 100, 6)
    assert torch.equal(ours[0], old[0]) and torch.equal(ours[1], old[1])
    assert ours[2:] == old[2:]


def test_sweep_programs_are_cached_by_shape_dtype_and_card(systems, monkeypatch):
    """One program per (no, nv, diis_dim, dtype, card): a second solve of
    the same size reuses it, float32 and another DIIS length get their
    own; the cache is an LRU of at most 8."""
    monkeypatch.setattr(ccsd, "_SWEEP_PROGRAMS", {})
    h1, h2, occ = systems["lih_global"]
    no = int(np.asarray(occ).sum())
    nv = len(occ) - no
    run_ccsd(h1, h2, occ)
    prog = ccsd._SWEEP_PROGRAMS[(no, nv, 6, torch.float64, torch.device("cpu"))]
    run_ccsd(h1, h2, occ, conv_tol=1e-9)
    assert list(ccsd._SWEEP_PROGRAMS.values()) == [prog]
    run_ccsd(h1, h2, occ, precision="mixed")
    run_ccsd(h1, h2, occ, diis_dim=4)
    assert list(ccsd._SWEEP_PROGRAMS) == [(no, nv, 6, torch.float32, torch.device("cpu")),
                                          (no, nv, 6, torch.float64, torch.device("cpu")),
                                          (no, nv, 4, torch.float64, torch.device("cpu"))]
    for m in range(2, 12):
        run_ccsd(h1, h2, occ, diis_dim=m)
    assert len(ccsd._SWEEP_PROGRAMS) == ccsd._PROGRAMS_MAX == 8
    assert list(ccsd._SWEEP_PROGRAMS)[-1][2] == 11
    assert (no, nv, 2, torch.float64, torch.device("cpu")) not in ccsd._SWEEP_PROGRAMS


def test_sweep_counts_its_host_reads(systems):
    """One host read of the status vector per call: cycles / K of them."""
    ops = _operands(*systems["water_global"])
    before = RUNS["ccsd_host_reads"]
    cycles = _sweep(*ops, 1e-10, 1e-6, 100, 6, cycles=4)[4]
    assert RUNS["ccsd_host_reads"] - before == -(-cycles // 4)


@pytest.mark.parametrize("name", ["water_mu", "water_global", "lih_global"])
def test_triples_program_matches_nbed_tpu(systems, name):
    """(T) on the converged amplitudes: the program's body (uncaptured)
    equals the eager loop bitwise and nbed_tpu's _make_triples_energy
    within 1e-12 Ha."""
    ops = _operands(*systems[name])
    fock, w = ops[0], ops[1]
    t1, t2 = _sweep(*ops, 1e-10, 1e-6, 100, 6)[:2]
    no, nv = t1.shape
    prog = _TriplesProgram(no, nv, ccsd._triples_chunk(nv), torch.device("cpu"))
    for buf, value in ((prog.fock, fock), (prog.w, w), (prog.t1, t1), (prog.t2, t2)):
        buf.copy_(value)
    prog.captured()
    assert float(prog.out) == _triples_energy(fock, w, t1, t2)
    theirs = _make_triples_energy(no, nv)(*(jnp.asarray(t.numpy()) for t in (fock, w, t1, t2)))
    assert abs(float(prog.out) - float(theirs)) < 1e-12


def _cuda_or_skip():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (CUDA graphs have no CPU mode)")


@pytest.mark.cuda
@pytest.mark.parametrize("cycles", [1, 4])
def test_cuda_graphed_sweep_matches_eager(systems, cycles, monkeypatch):
    """On the card the captured K-cycle sweep equals the same cycle
    function run eagerly within 1e-10 Ha in as many cycles, and a second
    solve of the same size captures nothing."""
    _cuda_or_skip()
    h1, h2, occ = (t.cuda() if torch.is_tensor(t) else t for t in systems["water_mu"])
    monkeypatch.setattr(ccsd, "SWEEP_CYCLES", cycles)
    monkeypatch.setattr(ccsd, "_SWEEP_PROGRAMS", {})
    monkeypatch.setattr(ccsd, "_GRAPHED", False)
    eager = run_ccsd(h1, h2, occ, conv_tol=1e-10, triples=True)
    monkeypatch.setattr(ccsd, "_GRAPHED", True)
    graphed = run_ccsd(h1, h2, occ, conv_tol=1e-10, triples=True)
    captures = RUNS["captures"]
    again = run_ccsd(h1, h2, occ, conv_tol=1e-10, triples=True)
    assert RUNS["captures"] == captures
    assert abs(graphed[0] - eager[0]) < 1e-10 and abs(graphed[1] - eager[1]) < 1e-12
    assert again == graphed
