"""Restricted reporting of nbed_tpu_torch's SCF (SCFEngine(restricted=True)
and the SCFSolution surface), its consumers (properties, the double-hybrid
PT2 term, the HamiltonianBuilder), the builder with n_frozen_core /
n_frozen_virt, and huzinaga_scf, against the port's unrestricted runs and
against nbed_tpu (water/STO-3G, float64 CPU).
"""

import numpy as np
import pytest
import torch

from nbed_tpu import properties as ref_properties
from nbed_tpu.ham import HamiltonianBuilder as RefBuilder
from nbed_tpu.scf import huzinaga_scf as ref_huzinaga_scf
from nbed_tpu.scf.engine import SCFEngine as RefEngine
from nbed_tpu.solvers import run_double_hybrid as ref_run_double_hybrid
from nbed_tpu_torch import properties as port_properties
from nbed_tpu_torch.driver import NbedDriver, run_emb_fci
from nbed_tpu_torch.exceptions import HamiltonianBuilderError
from nbed_tpu_torch.ham import EQ_TOLERANCE, HamiltonianBuilder, reduce_virtuals
from nbed_tpu_torch.interop import molecule_from_reference, solution_from_reference
from nbed_tpu_torch.scf import SCFEngine, huzinaga_scf
from nbed_tpu_torch.solvers import run_double_hybrid, run_fci

torch.set_num_threads(1)

SCF = dict(conv_tol=1e-10, dm_conv_tol=1e-8, max_cycle=100, device="cpu")


@pytest.fixture(scope="module")
def mol(water_molecule):
    return molecule_from_reference(water_molecule)


@pytest.fixture(scope="module", params=[None, "b3lyp"])
def pair(request, mol):
    """(restricted, unrestricted) port solutions of one method."""
    xc = request.param
    return (SCFEngine(mol, xc=xc, restricted=True, **SCF).kernel(),
            SCFEngine(mol, xc=xc, **SCF).kernel())


def test_restricted_reports_alpha_channel(pair):
    r, u = pair
    n = r.mol.nao
    assert r.restricted and not u.restricted
    assert tuple(r.mo_coeff.shape) == (n, n) and tuple(r.mo_energy.shape) == (n,)
    assert r.mo_coeff.dtype == torch.float64
    assert sorted(set(r.mo_occ.tolist())) == [0.0, 2.0]
    assert abs(r.e_tot - u.e_tot) < 1e-10
    np.testing.assert_allclose(r.mo_energy.numpy(), u.mo_energy[0].numpy(), atol=1e-10)


@pytest.mark.parametrize("method", ["make_rdm1", "get_fock", "energy_elec",
                                    "spin_square", "interleaved_occ", "copy"])
def test_solution_surface(pair, method):
    """Each SCFSolution method on a restricted solution against the
    unrestricted one: total density, (n, n) Fock, energies, <S^2> = 0."""
    r, u = pair
    if method == "make_rdm1":
        dm_u = u.make_rdm1()
        assert r.make_rdm1().shape == dm_u.shape[1:]
        np.testing.assert_allclose(r.make_rdm1().numpy(), (dm_u[0] + dm_u[1]).numpy(),
                                   atol=1e-9)
    elif method == "get_fock":
        f = r.get_fock()
        assert f.ndim == 2
        np.testing.assert_allclose(f.numpy(), u.get_fock()[0].numpy(), atol=1e-8)
    elif method == "energy_elec":
        np.testing.assert_allclose(r.energy_elec(), u.energy_elec(), atol=1e-10)
        assert abs(r.energy_elec()[0] + r.energy_nuc() - r.e_tot) < 1e-9
    elif method == "spin_square":
        s2, mult = r.spin_square()
        assert abs(s2) < 1e-12 and abs(mult - 1.0) < 1e-12
    elif method == "interleaved_occ":  # the correlated solvers' occupation mask
        np.testing.assert_array_equal(NbedDriver._interleaved_occ(r),
                                      NbedDriver._interleaved_occ(u))
    else:
        c = r.copy()
        assert c.restricted and c.mo_coeff is not r.mo_coeff
        assert torch.equal(c.mo_coeff, r.mo_coeff) and c.e_tot == r.e_tot


def test_restricted_matches_nbed_tpu(mol, water_rhf):
    r = SCFEngine(mol, restricted=True, **SCF).kernel()
    assert abs(r.e_tot - water_rhf.e_tot) < 1e-8
    np.testing.assert_allclose(r.mo_energy.numpy(), water_rhf.mo_energy, atol=1e-8)
    np.testing.assert_allclose(r.make_rdm1().numpy(), water_rhf.make_rdm1(), atol=1e-8)


def test_restricted_rejects_open_shell(mol):
    with pytest.raises(ValueError, match="n_alpha == n_beta"):
        SCFEngine(mol, restricted=True, **SCF).kernel(nelec=(5, 4))


@pytest.fixture(scope="module")
def ref_restricted(water_molecule):
    """nbed_tpu's restricted solution of one method, by functional."""
    cache = {}

    def get(xc):
        if xc not in cache:
            cache[xc] = RefEngine(water_molecule, xc=xc, restricted=True, conv_tol=1e-10,
                                  dm_conv_tol=1e-8, max_cycle=100).kernel()
        return cache[xc]

    return get


def _property(module, sol, prop, path):
    cube = dict(spacing=0.5, margin=2.0)
    if prop in ("mulliken_spin", "lowdin_spin"):
        return module.atomic_spin_densities(sol, scheme=prop.split("_")[0])
    if prop == "mo_cube":
        return module.mo_cube(sol, 4, path, spin=1, **cube)
    if prop == "density_cube":
        return module.density_cube(sol, path, **cube)
    return getattr(module, prop)(sol)


@pytest.mark.parametrize("prop", ["dipole_moment", "mulliken_charges", "lowdin_charges",
                                  "mulliken_spin", "lowdin_spin", "mo_cube",
                                  "density_cube"])
def test_properties_of_restricted_solution(pair, ref_restricted, prop, tmp_path):
    """Dipole, charges, spin densities and cubes of a restricted solution
    equal the unrestricted solution's and nbed_tpu's restricted ones (an
    orbital up to its sign)."""
    r, u = pair
    theirs = ref_restricted(r.engine.xc)
    ours = _property(port_properties, r, prop, tmp_path / "r.cube")
    for other in (_property(port_properties, u, prop, tmp_path / "u.cube"),
                  _property(ref_properties, theirs, prop, tmp_path / "ref.cube")):
        other = np.asarray(other)
        if prop == "mo_cube":
            other = other * np.sign(np.sum(ours * other))
        np.testing.assert_allclose(ours, other, rtol=0, atol=1e-8)
    if prop.endswith("spin"):
        assert np.abs(ours).max() == 0.0


def test_double_hybrid_on_restricted_solution(mol, water_molecule):
    """B2PLYP's PT2 term on a restricted solution: the unrestricted
    solution's and nbed_tpu's restricted one's."""
    kw = dict(xc="b2plyp", conv_tol=1e-10, dm_conv_tol=1e-8, max_cycle=100)
    r = SCFEngine(mol, restricted=True, device="cpu", **kw).kernel()
    u = SCFEngine(mol, device="cpu", **kw).kernel()
    (e_r, pt2_r), (e_u, pt2_u) = run_double_hybrid(r), run_double_hybrid(u)
    e_ref, pt2_ref = ref_run_double_hybrid(
        RefEngine(water_molecule, restricted=True, **kw).kernel())
    assert -0.2 < pt2_r < -0.005
    assert abs(pt2_r - pt2_u) < 1e-10 and abs(e_r - e_u) < 1e-10
    assert abs(pt2_r - pt2_ref) < 1e-8 and abs(e_r - e_ref) < 1e-8


def test_builder_on_restricted_solution(mol):
    """The builder stacks a restricted (n, k) set for both spins: the same
    FCI spectrum as on the unrestricted solution."""
    energies = []
    for restricted in (True, False):
        sol = SCFEngine(mol, restricted=restricted, **SCF).kernel()
        const, h1, h2 = HamiltonianBuilder(sol, 0.0).build()
        energies.append(run_fci(const, h1, h2, h1.shape[0], (5, 5), k=3)[0])
    np.testing.assert_allclose(energies[0], energies[1], atol=1e-9)


@pytest.fixture(scope="module")
def shared(water_uhf):
    """(nbed_tpu's UHF, the port's copy of it): identical orbitals."""
    return water_uhf, solution_from_reference(water_uhf, "cpu")


@pytest.mark.parametrize("core, virt", [(1, 0), (0, 1), (1, 1), (2, 2)])
def test_frozen_builder_matches_nbed_tpu(shared, core, virt):
    ref_sol, sol = shared
    const, h1, h2 = HamiltonianBuilder(sol, 0.0, n_frozen_core=core,
                                       n_frozen_virt=virt).build()
    c_ref, h1_ref, h2_ref = RefBuilder(ref_sol, 0.0, n_frozen_core=core,
                                       n_frozen_virt=virt).build()
    assert h1.shape[0] == 14 - 2 * (core + virt) == h1_ref.shape[0]
    assert abs(const - c_ref) < 1e-8
    np.testing.assert_allclose(h1.numpy(), h1_ref, atol=1e-8)
    np.testing.assert_allclose(h2.numpy(), h2_ref, atol=1e-8)
    if core and virt:
        # the frozen-core, frozen-virtual FCI equals the explicit route
        ne = 5 - core
        e = run_fci(const, h1, h2, h1.shape[0], (ne, ne))[0][0] + sol.energy_nuc()
        assert abs(e - run_emb_fci(sol, frozen=[*range(core), *range(7 - virt, 7)])) < 1e-8


def test_untruncated_build(shared):
    """``_build(0.0)`` keeps the coefficients ``build()`` zeroes below
    EQ_TOLERANCE and equals it everywhere else."""
    builder = HamiltonianBuilder(shared[1], 0.0)
    (c0, h1, h2), (c1, f1, f2) = builder.build(), builder._build(0.0)
    assert c0 == c1
    for trunc, full in ((h1, f1), (h2, f2)):
        kept = torch.abs(full) >= EQ_TOLERANCE
        assert torch.equal(trunc[kept], full[kept])
        assert torch.all(trunc[~kept] == 0.0)
        assert float(torch.max(torch.abs(full[~kept]))) < EQ_TOLERANCE
    assert int(torch.count_nonzero(f2)) > int(torch.count_nonzero(h2))


def test_frozen_core_rejects_virtuals(shared):
    with pytest.raises(HamiltonianBuilderError, match="n_frozen_core=6"):
        HamiltonianBuilder(shared[1], 0.0, n_frozen_core=6).build()


def test_frozen_builder_builds_twice_alike(shared):
    """The virtuals are dropped once, not once per build() (nbed_tpu's
    builder drops them again on every call)."""
    builder = HamiltonianBuilder(shared[1], 0.0, n_frozen_core=1, n_frozen_virt=1)
    first, second = builder.build(), builder.build()
    assert first[1].shape == second[1].shape == (10, 10)
    assert first[0] == second[0]
    assert torch.equal(first[2], second[2])


def test_reduce_virtuals_restricted_branch(pair):
    r, _ = pair
    red = reduce_virtuals(r, 2)
    assert tuple(red.mo_coeff.shape) == (7, 5) and tuple(red.mo_occ.shape) == (5,)
    assert r.mo_coeff.shape == (7, 7)  # the input is left as it was
    with pytest.raises(ValueError, match="more than exist"):
        reduce_virtuals(r, 7)


@pytest.fixture(scope="module")
def huz_inputs(spinless_driver):
    """The driver's embedding potential and environment density, as in
    nbed_tpu's tests/test_scf.py:250-254."""
    return (spinless_driver._mol, np.asarray(spinless_driver.embedding_potential),
            np.asarray(spinless_driver.localized_system.dm_enviro))


def _engines(mol, xc, restricted):
    kw = dict(conv_tol=1e-10, dm_conv_tol=1e-8, max_cycle=200)
    return (RefEngine(mol, xc=xc, restricted=restricted, **kw),
            SCFEngine(molecule_from_reference(mol), xc=xc, restricted=restricted,
                      device="cpu", **kw))


@pytest.mark.parametrize("xc, restricted", [(None, True), (None, False),
                                            ("b3lyp", True), ("b3lyp", False)])
def test_huzinaga_scf_matches_nbed_tpu(huz_inputs, xc, restricted):
    """The cases of tests/test_scf.py:257-340: restricted inputs take the
    total environment density and one potential; the converged orbital
    energies and density equal nbed_tpu's, and the occupied orbitals have
    no weight in the environment space."""
    mol, v_emb, dm_env = huz_inputs
    ref_engine, engine = _engines(mol, xc, restricted)
    args = (v_emb[0], dm_env[0] + dm_env[1]) if restricted else (v_emb, dm_env)
    ours = huzinaga_scf(engine, *args, nelec=(4, 4))
    theirs = ref_huzinaga_scf(ref_engine, *args, nelec=(4, 4))
    assert ours[4] and theirs[4]
    shape = (7, 7) if restricted else (2, 7, 7)
    assert tuple(ours[0].shape) == shape and tuple(ours[2].shape) == shape
    np.testing.assert_allclose(ours[1].numpy(), theirs[1], atol=1e-8)
    np.testing.assert_allclose(ours[2].numpy(), theirs[2], atol=1e-8)
    s = engine.s.numpy()
    c = ours[0].numpy()
    for c_s, d_env in ([(c, 0.5 * args[1])] if restricted
                       else [(c[0], dm_env[0]), (c[1], dm_env[1])]):
        occ = c_s[:, :4]
        assert np.abs(occ.T @ s @ d_env @ s @ occ).max() < 1e-8


def test_huzinaga_restricted_matches_unrestricted(huz_inputs):
    mol, v_emb, dm_env = huz_inputs
    r = huzinaga_scf(_engines(mol, None, True)[1], v_emb[0], dm_env[0] + dm_env[1],
                     nelec=(4, 4))
    u = huzinaga_scf(_engines(mol, None, False)[1], np.stack([v_emb[0]] * 2), dm_env,
                     nelec=(4, 4))
    np.testing.assert_allclose(r[1].numpy(), u[1][0].numpy(), atol=1e-8)
    np.testing.assert_allclose(r[2].numpy(), (u[2][0] + u[2][1]).numpy(), atol=1e-8)
    np.testing.assert_allclose(r[3].numpy(), u[3][0].numpy(), atol=1e-8)


def test_huzinaga_without_diis_reaches_the_same_point(huz_inputs):
    mol, v_emb, dm_env = huz_inputs
    engine = _engines(mol, None, False)[1]
    engine.max_cycle = 400
    with_diis = huzinaga_scf(engine, v_emb, dm_env, nelec=(4, 4))
    plain = huzinaga_scf(engine, v_emb, dm_env, nelec=(4, 4), use_diis=False,
                         dm_conv_tol=1e-8)
    assert plain[4]
    np.testing.assert_allclose(plain[1].numpy(), with_diis[1].numpy(), atol=1e-6)
