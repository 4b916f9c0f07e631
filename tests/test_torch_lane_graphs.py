"""Lane SCFs as programs of the shared cache
(:func:`nbed_tpu_torch.scf.engine.lane_scf` and ``single_scf``; on the CPU
``jit_kernel="on"`` runs the programs' bodies uncaptured): HF, KS and DF
lanes at B = 3, the batched HF Hessian and ``hf_gradient`` on
water/STO-3G and H2/STO-3G, against the eager lane loop
(``jit_kernel="off"``: 1e-10 Ha per lane in as many cycles) and against
nbed_tpu (its vmapped HF energies at 1e-10 Ha as in test_torch_parallel.py,
its KS engine at 1e-8 Ha as the embedding program is held in
test_torch_embed_path.py, its DF engine, Hessian and HF energy)."""

import numpy as np
import pytest
import torch

from nbed_tpu import parallel as ref_parallel
from nbed_tpu.chem import build_molecule as ref_build_molecule
from nbed_tpu.scf.engine import SCFEngine as RefEngine
from nbed_tpu.solvers.hessian import hessian_fd as ref_hessian_fd
from nbed_tpu_torch.chem import build_molecule
from nbed_tpu_torch.integrals import overlap
from nbed_tpu_torch.parallel import make_mu_embed_energy
from nbed_tpu_torch.parallel.sharding import _lane_scf
from nbed_tpu_torch.scf import engine as engine_mod
from nbed_tpu_torch.scf.engine import _df_j, _df_k_spin, df_b_factor, lane_scf, lane_spec
from nbed_tpu_torch.solvers import hf_gradient, hessian_fd
from nbed_tpu_torch.solvers.gradients import _hcore

# one torch thread per test process: under pytest-xdist the OpenMP threads
# of several workers spin on the same cores and slow every worker many-fold
torch.set_num_threads(1)

TIGHT = dict(conv_tol=1e-10, dm_conv_tol=1e-8, max_cycle=100)
H2_XYZ = "2\n\nH 0.0 0.0 0.0\nH 0.0 0.0 0.74\n"


@pytest.fixture(scope="module")
def mols(water_xyz):
    return build_molecule(water_xyz, "sto-3g"), ref_build_molecule(water_xyz, "sto-3g")


@pytest.fixture(scope="module")
def lanes(mols):
    """Three lanes: the water geometry, an O-H bond 0.03 bohr longer, and
    a hydrogen moved 0.02 bohr off its place."""
    x = np.repeat(np.asarray(mols[0].coords)[None], 3, axis=0)
    x[1, 2, 2] += 0.03
    x[2, 1, 1] -= 0.02
    return x


def _hold_lanes(on, off):
    assert bool(on.converged.all()) and bool(off.converged.all())
    assert float((on.e_elec - off.e_elec).abs().max()) < 1e-10
    assert torch.equal(on.n_iter, off.n_iter)


def test_hf_lanes(mols, lanes):
    mol, ref_mol = mols
    x = torch.tensor(lanes)
    engine_mod._JIT_PROGRAM_CACHE.clear()
    on, _ = _lane_scf(mol, x, jit_kernel="on", **TIGHT)
    off, _ = _lane_scf(mol, x, jit_kernel="off", **TIGHT)
    _hold_lanes(on, off)
    assert [key[0] for key in engine_mod._JIT_PROGRAM_CACHE] == ["lanes"]
    e_ref, _ = ref_parallel.batched_hf_energies(ref_mol, lanes, conv_tol=1e-10, max_cycle=100)
    e_on = on.e_elec + mol.energy_nuc_tensor(x)
    np.testing.assert_allclose(e_on.numpy(), np.asarray(e_ref), rtol=0, atol=1e-10)


@pytest.mark.parametrize("projector", ["mu", "huzinaga"])
def test_ks_lanes_of_the_embedding_program(mols, lanes, projector):
    """The embedding program's global KS and embedded HF over three lanes:
    every output of the programs within 1e-10 of the eager lanes, the
    global KS within 1e-8 Ha of nbed_tpu's engine at each geometry."""
    mol, ref_mol = mols
    kw = dict(TIGHT, xc="b3lyp", grid_level=1, projector=projector, device="cpu")
    x = torch.tensor(lanes)
    on = make_mu_embed_energy(mol, 1, 4, jit_kernel="on", **kw)(x)
    off = make_mu_embed_energy(mol, 1, 4, jit_kernel="off", **kw)(x)
    assert bool(on["converged"].all())
    for key in ("e_emb_rhf", "e_global", "e_act", "e_env", "two_e_cross"):
        assert float((on[key] - off[key]).abs().max()) < 1e-10, key
    if projector == "mu":
        for b in range(3):
            theirs = RefEngine(ref_mol, xc="b3lyp", coords=lanes[b], grid_level=1,
                               **TIGHT).kernel()
            assert abs(float(on["e_global"][b]) - float(theirs.e_tot)) < 1e-8


def _df_lanes(t):
    """DF J/K of each lane's factor ``b`` (B, nao, naux, nao)."""
    b = t["b"]

    def jk_fn(dm):
        j = torch.stack([_df_j(b[i], dm[i, 0] + dm[i, 1]) for i in range(b.shape[0])])
        k = torch.stack([torch.stack([_df_k_spin(b[i], dm[i, s]) for s in (0, 1)])
                         for i in range(b.shape[0])])
        return j, k

    return jk_fn, None


def test_df_lanes(mols, lanes):
    mol, ref_mol = mols
    x = torch.tensor(lanes)
    factors = [df_b_factor(mol, device="cpu", coords=lanes[b]) for b in range(3)]
    assert len({f.shape for f in factors}) == 1
    ops = {"hcore": _hcore(mol, x), "s": overlap(mol, x, device="cpu"),
           "b": torch.stack(factors)}
    runs = {mode: lane_scf(lane_spec(mol, "df_uhf_lanes"), ops, _df_lanes, nelec=mol.nelec,
                           jit_kernel=mode, **TIGHT) for mode in ("on", "off")}
    _hold_lanes(runs["on"], runs["off"])
    e_on = runs["on"].e_elec + mol.energy_nuc_tensor(x)
    for b in range(3):
        theirs = RefEngine(ref_mol, density_fitting=True, coords=lanes[b], **TIGHT).kernel()
        assert abs(float(e_on[b]) - float(theirs.e_tot)) < 1e-9


def test_batched_hf_hessian():
    """The 6N displaced H2 SCFs as one lane program: the Hessian within
    1e-8 Ha/bohr^2 of the eager lanes' (gradients within 1e-10, divided by
    2h = 0.01) and of nbed_tpu's."""
    mol = build_molecule(H2_XYZ, "sto-3g")
    on = hessian_fd(mol, device="cpu", jit_kernel="on")
    off = hessian_fd(mol, device="cpu", jit_kernel="off")
    np.testing.assert_allclose(on, off, rtol=0, atol=1e-8)
    theirs = np.asarray(ref_hessian_fd(ref_build_molecule(H2_XYZ, "sto-3g")))
    np.testing.assert_allclose(on, theirs, rtol=0, atol=1e-7)


def test_lane_programs_are_keyed_by_card(mols, lanes):
    """A lane program's key and its operator buffers' key end with the card
    the lanes run on."""
    mol, _ = mols
    engine_mod._JIT_PROGRAM_CACHE.clear()
    _lane_scf(mol, torch.tensor(lanes), jit_kernel="on", **TIGHT)
    (key,) = engine_mod._JIT_PROGRAM_CACHE
    assert key[-1] == torch.device("cpu")
    assert any(ops[:3] == key[:3] and ops[-1] == torch.device("cpu")
               for ops in engine_mod._OPERANDS.keys())


def _h2_operands():
    mol = build_molecule(H2_XYZ, "sto-3g")
    x = torch.tensor(np.asarray(mol.coords), dtype=torch.float64)
    return mol, {"hcore": _hcore(mol, x), "s": overlap(mol, x, device="cpu")}


@pytest.mark.parametrize("case", ["no_diis", "two_devices"])
def test_on_refuses_what_the_program_cannot_take(case):
    """``jit_kernel="on"`` raises for a lane call without DIIS or over
    operands on two devices, where "auto" runs the eager loop."""
    mol, ops = _h2_operands()
    kw = dict(nelec=mol.nelec, conv_tol=1e-8, max_cycle=30)
    if case == "no_diis":
        kw["use_diis"] = False
    else:
        ops["g_j"] = torch.empty((1,), dtype=torch.float64, device="meta")

    def build(t):
        return (lambda dm: (torch.zeros_like(dm[:, 0]), torch.zeros_like(dm))), None

    with pytest.raises(ValueError, match="jit_kernel='on'"):
        lane_scf(lane_spec(mol, "probe"), {k: v[None] for k, v in ops.items()}, build,
                 jit_kernel="on", **kw)
    if case == "no_diis":
        before = engine_mod.RUNS["lanes_eager"]
        res = lane_scf(lane_spec(mol, "probe"), {k: v[None] for k, v in ops.items()}, build,
                       jit_kernel="auto", **kw)
        assert engine_mod.RUNS["lanes_eager"] == before + 1
        assert bool(torch.isfinite(res.e_elec).all())


def test_hf_gradient_scf_is_the_single_lane_program(mols):
    mol, ref_mol = mols
    engine_mod._JIT_PROGRAM_CACHE.clear()
    e_on, g_on, res_on = hf_gradient(mol, device="cpu", jit_kernel="on")
    e_off, g_off, res_off = hf_gradient(mol, device="cpu", jit_kernel="off")
    assert [key[0] for key in engine_mod._JIT_PROGRAM_CACHE] == ["lanes"]
    assert abs(e_on - e_off) < 1e-10 and res_on.n_iter == res_off.n_iter
    assert float((g_on - g_off).abs().max()) < 1e-10
    theirs = RefEngine(ref_mol, **TIGHT).kernel()
    assert abs(e_on - float(theirs.e_tot)) < 1e-10
