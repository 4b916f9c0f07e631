"""The geometry-differentiable embedding program of nbed_tpu_torch.parallel
against nbed_tpu.parallel's (water/STO-3G, grid level 1): every output
key, its build-time checks, the SPADE projector's tangent, forward-mode
geometry derivatives and the conformer batch."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch.autograd import forward_ad

from nbed_tpu.chem import build_molecule as ref_build_molecule
from nbed_tpu.parallel import embed_path as ref_embed_path
from nbed_tpu_torch.chem import build_molecule
from nbed_tpu_torch.parallel import batched_embedding_energies, make_mu_embed_energy
from nbed_tpu_torch.parallel.embed_path import _topk_projector

torch.set_num_threads(1)

KW = dict(conv_tol=1e-10, dm_conv_tol=1e-8, max_cycle=100, grid_level=1)
KEYS = ("e_emb_rhf", "e_global", "e_act", "e_env", "two_e_cross")


@pytest.fixture(scope="module")
def mols(water_xyz):
    return build_molecule(water_xyz, "sto-3g"), ref_build_molecule(water_xyz, "sto-3g")


@pytest.mark.parametrize("projector,xc,n_act", [("mu", "b3lyp", 4), ("huzinaga", "b3lyp", 4),
                                                ("mu", "camb3lyp", 4),
                                                ("mu", "b3lyp", (4, 3))])
def test_embedding_program_matches_reference(mols, projector, xc, n_act):
    mol, rmol = mols
    x = np.asarray(mol.coords)
    ours = make_mu_embed_energy(mol, 1, n_act, xc=xc, projector=projector, device="cpu",
                                **KW)(torch.tensor(x))
    theirs = ref_embed_path.make_mu_embed_energy(rmol, 1, n_act, xc=xc, projector=projector,
                                                 **KW)(jnp.asarray(x))
    assert bool(ours["converged"]) and bool(theirs["converged"])
    for key in KEYS:
        assert abs(float(ours[key]) - float(theirs[key])) < 1e-8, key
    # the subsystem partition identity
    assert abs(float(ours["e_act"] + ours["e_env"] + ours["two_e_cross"])
               + mol.energy_nuc() - float(ours["e_global"])) < 1e-9


@pytest.mark.parametrize("case", ["projector", "above occupied", "above active AOs"])
def test_build_time_errors(water_xyz, case):
    mol = build_molecule(water_xyz, "sto-3g")
    if case == "projector":
        args, kw, match = (mol, 1, 4), {"projector": "spade"}, "unknown projector"
    elif case == "above occupied":
        args, kw, match = (mol, 1, 6), {}, "exceeds occupied"
    else:  # an H atom first: one active AO, two active MOs asked for
        lines = water_xyz.strip().splitlines()
        h_first = "\n".join(lines[:2] + [lines[3], lines[2], lines[4]])
        args, kw, match = (build_molecule(h_first, "sto-3g"), 1, 2), {}, "active-AO count"
    with pytest.raises(ValueError, match=match):
        make_mu_embed_energy(*args, device="cpu", **kw)


def test_topk_projector_tangent_on_a_degenerate_top_block():
    """Two equal top eigenvalues: the gap-only tangent is finite and equals
    the reference's custom_jvp and a central difference; the backward is
    its adjoint."""
    rng = np.random.default_rng(3)
    q, _ = np.linalg.qr(rng.standard_normal((5, 5)))
    m = q @ np.diag([0.1, 0.3, 0.5, 1.0, 1.0]) @ q.T
    t = rng.standard_normal((5, 5))
    t = t + t.T
    with forward_ad.dual_level():
        p = _topk_projector(forward_ad.make_dual(torch.tensor(m), torch.tensor(t)), 2)
        dp = forward_ad.unpack_dual(p).tangent.numpy()
    _, dp_ref = jax.jvp(lambda a: ref_embed_path._topk_projector(a, 2), (jnp.asarray(m),),
                        (jnp.asarray(t),))
    h = 1e-6
    fd = (_topk_projector(torch.tensor(m + h * t), 2)
          - _topk_projector(torch.tensor(m - h * t), 2)).numpy() / (2 * h)
    assert np.all(np.isfinite(dp))
    np.testing.assert_allclose(dp, np.asarray(dp_ref), rtol=0, atol=1e-12)
    np.testing.assert_allclose(dp, fd, rtol=0, atol=1e-8)
    mt = torch.tensor(m, requires_grad=True)
    p_bar = torch.tensor(rng.standard_normal((5, 5)))
    (m_bar,) = torch.autograd.grad(torch.sum(_topk_projector(mt, 2) * p_bar), mt)
    assert abs(float(torch.sum(m_bar * torch.tensor(t))) - float(np.sum(dp * p_bar.numpy()))) \
        < 1e-12


def test_forward_mode_derivative_matches_central_difference(mols):
    """d e_emb_rhf / d z(H2) by forward AD with grad_cycles against a central
    difference (h = 1e-4) of the same program's energies."""
    mol = mols[0]
    fn = make_mu_embed_energy(mol, 1, 4, grad_cycles=20, device="cpu", **KW)
    x = torch.tensor(np.asarray(mol.coords))
    t = torch.zeros_like(x)
    t[2, 2] = 1.0
    with forward_ad.dual_level():
        out = fn(forward_ad.make_dual(x, t))
        d = float(forward_ad.unpack_dual(out["e_emb_rhf"]).tangent)
    h = 1e-4
    fd = (float(fn(x + h * t)["e_emb_rhf"]) - float(fn(x - h * t)["e_emb_rhf"])) / (2 * h)
    assert abs(d - fd) < 1e-6


def test_batched_embedding_energies_lane0_is_the_single_call(mols):
    mol = mols[0]
    x = np.repeat(np.asarray(mol.coords)[None], 2, axis=0)
    x[1, 2, 2] += 0.04
    out = batched_embedding_energies(mol, x, 1, 4, device="cpu", **KW)
    single = make_mu_embed_energy(mol, 1, 4, device="cpu", **KW)(torch.tensor(x[0]))
    assert out["e_emb_rhf"].shape == (2,) and bool(out["converged"].all())
    for key in KEYS:
        assert abs(float(out[key][0]) - float(single[key])) < 1e-10, key
    assert float(out["e_global"][1]) > float(out["e_global"][0])
