"""The torch Boys function, Hermite R tables, nuclear and point-charge
attraction and ERI tensor of nbed_tpu_torch against nbed_tpu's JAX functions
and the port's C++ engine, and their autograd against central differences.

JAX compiles one program per integral class, so the parity runs on
water/STO-3G; the d-shell ERI check (water/cc-pVDZ) is held against the C++
engine only.
"""

from dataclasses import replace

import numpy as np
import pytest
import torch

from nbed_tpu.chem import build_molecule as ref_build_molecule
from nbed_tpu.integrals import core as ref_core
from nbed_tpu.integrals import eri_tensor as ref_eri_tensor
from nbed_tpu.integrals import md as ref_md
from nbed_tpu_torch.chem import build_molecule
from nbed_tpu_torch.integrals import core, eri_tensor, md, native

torch.set_num_threads(1)

BOYS_T = [0.0, 1e-12, 1e-3, 0.0999, 0.1001, 1.0, 30.0, 200.0]
# a QM/MM point-charge set of two charges (Bohr), seeded
_RNG = np.random.default_rng(8)
CENTERS = _RNG.uniform(-3.0, 3.0, (2, 3))
CHARGES = np.array([0.417, -0.834])
RADII = np.array([0.6, 0.9])


@pytest.fixture(scope="module")
def water(water_xyz):
    return ref_build_molecule(water_xyz, "sto-3g"), build_molecule(water_xyz, "sto-3g")


@pytest.mark.parametrize("mmax", [0, 1, 4, 8])
def test_boys_matches_reference(mmax):
    ours = md.boys(mmax, torch.tensor(BOYS_T, dtype=torch.float64)).numpy()
    theirs = np.asarray(ref_md.boys(mmax, np.array(BOYS_T)))
    assert ours.shape == theirs.shape == (mmax + 1, len(BOYS_T))
    np.testing.assert_allclose(ours, theirs, rtol=1e-13, atol=0)


def test_boys_gradient_is_finite_at_zero():
    """dF_m/dt = -F_{m+1}: at t = 0 that is -1/(2m+3), with no NaN from the
    unselected closed form."""
    t = torch.tensor([0.0, 0.05, 0.5], dtype=torch.float64, requires_grad=True)
    f = md.boys(8, t)
    for m in range(8):
        (g,) = torch.autograd.grad(f[m].sum(), t, retain_graph=True)
        assert torch.isfinite(g).all()
        np.testing.assert_allclose(g.numpy(), -f[m + 1].detach().numpy(), rtol=1e-12)


@pytest.mark.parametrize("omega", [None, 0.33])
@pytest.mark.parametrize("lmax", [0, 1, 2, 3, 4])
def test_hermite_r_matches_reference(lmax, omega):
    """Seeded (p, PQ) batched in the port, one at a time in the reference,
    PQ = 0 (t = 0) included."""
    rng = np.random.default_rng(10 * lmax + (omega is None))
    p = rng.uniform(0.2, 6.0, 4)
    pq = rng.uniform(-2.0, 2.0, (4, 3))
    pq[0] = 0.0
    ours = md.hermite_r(lmax, torch.tensor(p), torch.tensor(pq), omega=omega).numpy()
    size = lmax + 1
    assert ours.shape == (4, size, size, size)
    valid = np.add.outer(np.add.outer(np.arange(size), np.arange(size)),
                         np.arange(size)) <= lmax
    for i in range(4):
        theirs = np.asarray(ref_md.hermite_r(lmax, p[i], pq[i], omega=omega))
        np.testing.assert_allclose(ours[i][valid], theirs[valid], rtol=0, atol=1e-12)


@pytest.mark.parametrize("omega", [None, 0.33])
@pytest.mark.parametrize("lab,lcd", [(0, 0), (1, 0), (2, 1), (2, 2)])
def test_hermite_r_cross_matches_reference(lab, lcd, omega):
    rng = np.random.default_rng(7 * lab + lcd)
    alpha = rng.uniform(0.2, 3.0, 3)
    pq = rng.uniform(-1.5, 1.5, (3, 3))
    ours = md.hermite_r_cross(lab, lcd, torch.tensor(alpha), torch.tensor(pq),
                              omega=omega).numpy()
    for i in range(3):
        theirs = np.asarray(ref_md.hermite_r_cross(lab, lcd, alpha[i], pq[i], omega=omega))
        # entries of total order > lab + lcd are the recursion's unread garbage
        t = np.arange(lab + 1)[:, None, None, None, None, None]
        u = np.arange(lab + 1)[None, :, None, None, None, None]
        v = np.arange(lab + 1)[None, None, :, None, None, None]
        tau = np.arange(lcd + 1)[None, None, None, :, None, None]
        nu = np.arange(lcd + 1)[None, None, None, None, :, None]
        phi = np.arange(lcd + 1)[None, None, None, None, None, :]
        valid = np.broadcast_to(t + u + v + tau + nu + phi <= lab + lcd, theirs.shape)
        np.testing.assert_allclose(ours[i][valid], theirs[valid], rtol=0, atol=1e-12)


def _attraction(module, mol, kind):
    kw = {} if module is ref_core else {"device": "cpu"}
    if kind == "nuclear":
        return module.nuclear_attraction(mol, **kw)
    radii = RADII if kind == "smeared" else None
    return module.point_charge_attraction(mol, CENTERS, CHARGES, radii=radii, **kw)


@pytest.mark.parametrize("kind", ["nuclear", "point", "smeared"])
def test_attraction_matches_reference(water, kind):
    ref_mol, mol = water
    ours = _attraction(core, mol, kind)
    assert ours.dtype == torch.float64
    np.testing.assert_allclose(ours.numpy(), np.asarray(_attraction(ref_core, ref_mol, kind)),
                               rtol=0, atol=1e-11)


@pytest.mark.parametrize("basis", ["sto-3g", "6-31g", "cc-pvdz"])
@pytest.mark.parametrize("radii", [None, RADII])
def test_attraction_matches_native_engine(water_xyz, basis, radii):
    """T + V + point charges of the torch integrals against the C++
    engine's V, which folds the molecule's MM charges in."""
    mol = build_molecule(water_xyz, basis)
    qmmm = replace(mol, mm_coords=CENTERS, mm_charges=CHARGES, mm_radii=radii)
    _, _, v = native.one_electron(mol)
    np.testing.assert_allclose(core.nuclear_attraction(mol, device="cpu").numpy(), v,
                               rtol=0, atol=1e-11)
    _, _, v_mm = native.one_electron(qmmm)
    ours = (core.nuclear_attraction(qmmm, device="cpu")
            + core.point_charge_attraction(qmmm, CENTERS, CHARGES, radii, device="cpu"))
    np.testing.assert_allclose(ours.numpy(), v_mm, rtol=0, atol=1e-11)


@pytest.mark.parametrize("omega", [None, 0.33])
def test_eri_matches_reference_and_native(water, omega):
    ref_mol, mol = water
    ours = eri_tensor(mol, omega=omega, device="cpu")
    assert ours.shape == (7, 7, 7, 7) and ours.dtype == torch.float64
    np.testing.assert_allclose(ours.numpy(), np.asarray(ref_eri_tensor(ref_mol, omega=omega)),
                               rtol=0, atol=1e-11)
    np.testing.assert_allclose(ours.numpy(), native.eri(mol, omega=omega or 0.0),
                               rtol=0, atol=1e-11)


def test_eri_d_shells_match_native(water_xyz):
    """Water/cc-pVDZ (nao 24; d on O): every angular class up to (dd|dd)."""
    mol = build_molecule(water_xyz, "cc-pvdz")
    assert max(sh.l for sh in mol.shells) == 2
    np.testing.assert_allclose(eri_tensor(mol, device="cpu").numpy(), native.eri(mol),
                               rtol=0, atol=1e-10)


def test_eri_chunking_is_exact(water):
    """A chunk bound of 16 rows per class gives the unchunked tensor."""
    _, mol = water
    np.testing.assert_allclose(eri_tensor(mol, chunk_elems=1, device="cpu").numpy(),
                               eri_tensor(mol, device="cpu").numpy(), rtol=0, atol=1e-14)


def _central_difference(f, x, h=1e-4):
    out = np.zeros(x.shape)
    for idx in np.ndindex(*x.shape):
        xp, xm = x.clone(), x.clone()
        xp[idx] += h
        xm[idx] -= h
        with torch.no_grad():
            out[idx] = (float(f(xp)) - float(f(xm))) / (2 * h)
    return out


def _weights(shape, seed):
    return torch.tensor(np.random.default_rng(seed).standard_normal(shape))


@pytest.mark.parametrize("omega", [None, 0.33])
def test_eri_autograd_matches_central_difference(water, omega):
    """d/dR of a seeded linear functional of the ERI tensor: repeated-index
    elements ((aa|aa), (ab|ab), ...) would count twice under a scatter
    backward."""
    _, mol = water
    w = _weights((7,) * 4, 3)

    def f(x):
        return torch.sum(w * eri_tensor(mol, x, omega=omega, device="cpu"))

    x = torch.tensor(mol.coords, requires_grad=True)
    (grad,) = torch.autograd.grad(f(x), x)
    np.testing.assert_allclose(grad.numpy(), _central_difference(f, x.detach()),
                               rtol=0, atol=1e-7)


@pytest.mark.parametrize("kind", ["nuclear", "point", "smeared"])
def test_attraction_autograd_matches_central_difference(water, kind):
    """d/dR of the nuclei, and d/dC of the point charges' centres."""
    _, mol = water
    w = _weights((7, 7), 4)
    x = torch.tensor(mol.coords, requires_grad=True)
    c = torch.tensor(CENTERS, requires_grad=True)

    def f(x, c=c):
        if kind == "nuclear":
            return torch.sum(w * core.nuclear_attraction(mol, x, device="cpu"))
        radii = RADII if kind == "smeared" else None
        return torch.sum(w * core.point_charge_attraction(mol, c, CHARGES, radii, coords=x,
                                                          device="cpu"))

    gx, gc = torch.autograd.grad(f(x), (x, c), allow_unused=True, materialize_grads=True)
    np.testing.assert_allclose(gx.numpy(), _central_difference(f, x.detach()),
                               rtol=0, atol=1e-7)
    if kind != "nuclear":
        np.testing.assert_allclose(
            gc.numpy(), _central_difference(lambda cc: f(x.detach(), cc), c.detach()),
            rtol=0, atol=1e-7)
