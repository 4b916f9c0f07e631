"""TDA-TDDFT of nbed_tpu_torch and its differentiable XC closure
(water/STO-3G, float64 CPU).

- The response closure (potentials by ``torch.func.grad``, nothing
  detached) gives the SCF closure's (exc, vxc) to 1e-13, on the table and
  the streaming path; its ``torch.func.jvp`` along a symmetric density
  tangent matches a central difference of vxc.
- TDA roots match nbed_tpu's ``run_tddft_tda`` on the same solution (exact
  ERIs) for HF and B3LYP to 1e-8 (PBE and CAM-B3LYP in
  ``test_torch_tddft_functionals.py``); Davidson matches dense.
- On a Hartree-Fock engine TDA is CIS on the engine's own integrals, on the
  exact route and on the density-fitted one (1e-10). On the DF route
  nbed_tpu's TDA does not have this property: its exchange of the
  transition density is symmetrised (``_df_k_spin``), and on this water
  UHF its roots miss its own ``run_cis`` by about 0.3 Ha (0.29 on average,
  0.27 at the lowest root, 0.43 at most). The port builds the unsymmetrised
  exchange, so it is held to CIS, not to nbed_tpu.
"""

import warnings

import numpy as np
import pytest
import torch

from nbed_tpu.scf.engine import SCFEngine as RefEngine
from nbed_tpu.solvers import run_tddft_tda as ref_tda
from nbed_tpu_torch.dft import make_xc_fn_streaming
from nbed_tpu_torch.driver import NbedDriver
from nbed_tpu_torch.ham import HamiltonianBuilder
from nbed_tpu_torch.interop import molecule_from_reference, solution_from_reference
from nbed_tpu_torch.scf import SCFEngine
from nbed_tpu_torch.solvers import run_cis, run_tddft_tda, tddft

torch.set_num_threads(1)

SCF = dict(conv_tol=1e-10, dm_conv_tol=1e-8, max_cycle=100)


@pytest.fixture(scope="module")
def mol(water_molecule):
    return molecule_from_reference(water_molecule)


@pytest.fixture(scope="module")
def port_solutions(mol):
    """The port's own converged UKS/UHF of water, by functional."""
    cache = {}

    def get(xc, density_fitting=False):
        key = (xc, density_fitting)
        if key not in cache:
            cache[key] = SCFEngine(mol, xc=xc, density_fitting=density_fitting,
                                   device="cpu", **SCF).kernel()
        return cache[key]

    return get


def _tangent(n, seed=3):
    t = np.random.default_rng(seed).standard_normal((2, n, n))
    return torch.tensor(0.5 * (t + t.swapaxes(-1, -2)))


@pytest.mark.parametrize("xc, path", [("b3lyp", "table"), ("tpss", "table"),
                                      ("pbe", "streaming")])
def test_response_closure_equals_scf_closure(port_solutions, xc, path):
    sol = port_solutions(xc)
    eng = sol.engine
    dm = sol.make_rdm1() + 0.01 * _tangent(eng.mol.nao)
    if path == "table":
        scf, resp = eng.xc_fn, eng._build_xc(torch.float64, differentiable=True)
    else:
        points, weights = eng._grid
        scf, resp = (make_xc_fn_streaming(eng.mol, points, weights, xc, chunk=4096,
                                          differentiable=d) for d in (False, True))
    (e1, v1), (e2, v2) = scf(dm), resp(dm)
    assert abs(float(e1 - e2)) < 1e-13
    assert float(torch.max(torch.abs(v1 - v2))) < 1e-13


@pytest.mark.parametrize("xc", ["b3lyp", "pbe", "lda"])
def test_kernel_jvp_matches_finite_difference(port_solutions, xc):
    """f_xc . t by forward-over-reverse against (vxc(D + h t) - vxc(D - h t))
    / 2h; the vmapped block gives the single jvp of each tangent."""
    sol = port_solutions(xc)
    eng = sol.engine
    dm0 = sol.make_rdm1()
    t = _tangent(eng.mol.nao)
    response = eng._build_xc(torch.float64, differentiable=True)
    _, dv = torch.func.jvp(lambda d: response(d)[1], (dm0,), (t,))
    h = 1e-5
    fd = (eng.xc_fn(dm0 + h * t)[1] - eng.xc_fn(dm0 - h * t)[1]) / (2 * h)
    assert float(torch.max(torch.abs(dv - fd)) / torch.max(torch.abs(fd))) < 1e-5
    fr = {"xc_fn": response, "dm0": dm0}
    block = tddft._kernel_block(fr, torch.stack([t, -2.0 * t]))
    assert float(torch.max(torch.abs(block[0] - dv))) < 1e-12
    assert float(torch.max(torch.abs(block[1] + 2.0 * dv))) < 1e-12


@pytest.fixture(scope="module")
def reference_pairs(water_uhf, water_uks, water_molecule):
    """(nbed_tpu solution, the port's copy) by functional."""
    cache = {None: water_uhf, "b3lyp": water_uks}

    def get(xc):
        if xc not in cache:
            cache[xc] = RefEngine(water_molecule, xc=xc, **SCF).kernel()
        return cache[xc], solution_from_reference(cache[xc], "cpu")

    return get


@pytest.mark.parametrize("xc", [None, "b3lyp"])
def test_tda_matches_nbed_tpu(reference_pairs, xc):
    ref_sol, sol = reference_pairs(xc)
    ours, theirs = run_tddft_tda(sol), ref_tda(ref_sol)
    np.testing.assert_allclose(ours.excitations, theirs.excitations, rtol=0, atol=1e-8)
    np.testing.assert_array_equal(ours.pairs, theirs.pairs)
    assert abs(ours.e_ref_elec - theirs.e_ref_elec) < 1e-10


def test_davidson_equals_dense(port_solutions):
    sol = port_solutions("b3lyp")
    dense = run_tddft_tda(sol, method="dense")
    stats = {}
    dav = run_tddft_tda(sol, nroots=4, method="davidson", max_subspace=12, stats=stats)
    np.testing.assert_allclose(dav.excitations, dense.excitations[:4], rtol=0, atol=1e-8)
    assert stats["iterations"] >= 1 and max(stats["residuals"]) < 1e-8
    assert stats["matvec_blocks"] == stats["iterations"]  # one seed block + one per extension
    # "auto" takes Davidson above max_subspace pairs
    auto = run_tddft_tda(sol, nroots=4, max_subspace=12)
    np.testing.assert_allclose(auto.excitations, dav.excitations, rtol=0, atol=1e-8)


def test_davidson_warns_when_unconverged(port_solutions):
    sol = port_solutions("b3lyp")
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        run_tddft_tda(sol, nroots=3, method="davidson", max_iter=1, conv_tol=1e-14)
    assert any(issubclass(w.category, RuntimeWarning) for w in caught)
    with pytest.raises(ValueError, match="needs nroots"):
        run_tddft_tda(sol, method="davidson")


@pytest.mark.parametrize("density_fitting", [False, True])
def test_tda_on_hf_is_cis(port_solutions, density_fitting):
    """TDA on the HF engine = CIS on that engine's integrals: the exact
    route, and the DF route with the unsymmetrised exchange (nbed_tpu's DF
    TDA misses this identity by about 0.3 Ha on this molecule)."""
    sol = port_solutions(None, density_fitting)
    _, h1, h2 = HamiltonianBuilder(sol, 0.0).build()
    cis = run_cis(h1, h2, NbedDriver._interleaved_occ(sol))
    tda = run_tddft_tda(sol)
    assert sol.engine.density_fitting == density_fitting
    np.testing.assert_allclose(tda.excitations, cis.excitations, rtol=0, atol=1e-10)


def test_tda_matvec_block_size_is_bounded(port_solutions):
    """A smaller memory budget cuts the matvec into more blocks and gives
    the same matrix."""
    sol = port_solutions("b3lyp")
    full = run_tddft_tda(sol).excitations
    sol.engine.max_memory_mb = 150.0
    try:
        fr = tddft._response_frame(sol)
        assert fr["block"] < sum(fr["sizes"])
        # the XC chunk is cut too, so that the block and one vector's
        # fixed share fit the budget
        assert fr["xc_chunk"] < sol.engine._grid[0].shape[0]
        assert (fr["block"] + 1) * fr["vector_elems"] * 8 <= 150e6
        small = run_tddft_tda(sol).excitations
    finally:
        sol.engine.max_memory_mb = 4000.0
    np.testing.assert_allclose(small, full, rtol=0, atol=1e-12)


@pytest.mark.cuda
@pytest.mark.parametrize("xc, max_memory_mb", [("b3lyp", 100.0), ("tpss", 200.0),
                                               ("b3lyp", 4000.0)])
def test_matvec_block_stays_within_max_memory_mb(mol, xc, max_memory_mb):
    """On the card a dense TDA allocates at most ``max_memory_mb`` above
    what was allocated before it."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the bound is on device memory)")
    sol = SCFEngine(mol, xc=xc, device="cuda", max_memory_mb=max_memory_mb, **SCF).kernel()
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    run_tddft_tda(sol)
    torch.cuda.synchronize()
    assert torch.cuda.max_memory_allocated() - base <= max_memory_mb * 1e6
