"""Forward-mode geometry derivatives of nbed_tpu_torch's embedding program
as programs (``jit_kernel="on"``: the tangent programs run uncaptured on
the CPU, as a card's CUDA graphs replay them) against the eager dual route
(``"off"``) and against ``jax.jvp`` of nbed_tpu's program (water/STO-3G,
grid level 1); the capturable eigh's forward-mode rule and the tangent
J/K's plain version; one program per structure and lane count, shared by
later geometries and directions, with bodies that copy nothing from the
host."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch.autograd import forward_ad

from nbed_tpu.chem import build_molecule as ref_build_molecule
from nbed_tpu.parallel import embed_path as ref_embed_path
from nbed_tpu_torch.chem import build_molecule
from nbed_tpu_torch.ops import jk
from nbed_tpu_torch.ops.eigh import eigh_jvp
from nbed_tpu_torch.ops.programs import DERIVATIVE_PROGRAMS, RUNS
from nbed_tpu_torch.parallel import batched_embedding_energies, make_mu_embed_energy
from nbed_tpu_torch.scf import engine

torch.set_num_threads(1)

KW = dict(conv_tol=1e-10, dm_conv_tol=1e-8, max_cycle=100, grid_level=1, device="cpu")
KEYS = ("e_emb_rhf", "e_global", "e_act", "e_env", "two_e_cross")
# the program route against the eager dual route (Ha/bohr), and the
# port against jax.jvp of nbed_tpu's program
ROUTES = 1e-10
REFERENCE = 1e-9


@pytest.fixture(scope="module")
def water(water_xyz):
    return build_molecule(water_xyz, "sto-3g")


def _direction(x):
    """d/dz of the second H, for one geometry or each lane."""
    t = torch.zeros_like(x)
    t[..., 2, 2] = 1.0
    return t


def _jvp(fn, x):
    """{key: (primal, tangent)} of ``fn`` at ``x`` along :func:`_direction`."""
    with forward_ad.dual_level():
        out = fn(forward_ad.make_dual(x, _direction(x)))
        pairs = {k: forward_ad.unpack_dual(out[k]) for k in KEYS}
        return {k: (p.primal.detach().clone(), p.tangent.clone()) for k, p in pairs.items()}


@pytest.mark.parametrize("projector,xc,n_act", [("mu", "b3lyp", 4), ("huzinaga", "b3lyp", 4),
                                                ("mu", "camb3lyp", 4),
                                                ("mu", "b3lyp", (4, 3))])
def test_program_route_matches_the_eager_dual_route(water, projector, xc, n_act):
    """Every output and its tangent within 1e-10 of the eager dual route,
    through the tangent programs only (no eager lane SCF)."""
    x = torch.tensor(np.asarray(water.coords))
    kw = dict(projector=projector, xc=xc, grad_cycles=10)
    DERIVATIVE_PROGRAMS.clear()
    engine._JIT_PROGRAM_CACHE.clear()
    RUNS.clear()
    prog = _jvp(make_mu_embed_energy(water, 1, n_act, jit_kernel="on", **kw, **KW), x)
    runs = dict(RUNS)
    eager = _jvp(make_mu_embed_energy(water, 1, n_act, jit_kernel="off", **kw, **KW), x)
    assert runs["embed_tangent_program"] == 1 and runs["lanes_tangent"] == 2
    assert not runs.get("lanes_eager") and not runs.get("embed_tangent_eager")
    kinds = {key[0] for key in DERIVATIVE_PROGRAMS}
    assert kinds == {"core_jvp", "eri_jvp", "grid_jvp", "embed_subsystem"}
    for key in KEYS:
        assert abs(float(prog[key][0] - eager[key][0])) < ROUTES, key
        assert abs(float(prog[key][1] - eager[key][1])) < ROUTES, key
    assert abs(float(prog["e_emb_rhf"][1])) > 1e-3  # a derivative, not a zero


def test_two_lanes_and_lane0_is_the_single_call(water):
    """Dual (2, natm, 3) coordinates run both tangents in one pass of the
    programs: lane 0 equals the single call, both lanes the eager route's,
    through batched_embedding_energies too."""
    x = torch.tensor(np.asarray(water.coords))
    xb = torch.stack([x, x + 0.04 * _direction(x)])
    kw = dict(grad_cycles=10, **KW)
    lanes = _jvp(make_mu_embed_energy(water, 1, 4, jit_kernel="on", **kw), xb)
    single = _jvp(make_mu_embed_energy(water, 1, 4, jit_kernel="on", **kw), x)
    eager = _jvp(make_mu_embed_energy(water, 1, 4, jit_kernel="off", **kw), xb)
    for key in KEYS:
        for i in (0, 1):
            assert abs(float(lanes[key][i][0] - single[key][i])) < ROUTES, key
            assert float(torch.max(torch.abs(lanes[key][i] - eager[key][i]))) < ROUTES, key
    assert abs(float(lanes["e_emb_rhf"][1][1] - lanes["e_emb_rhf"][1][0])) > 1e-4
    with forward_ad.dual_level():
        out = batched_embedding_energies(water, forward_ad.make_dual(xb, _direction(xb)), 1, 4,
                                         jit_kernel="on", **kw)
        tangent = forward_ad.unpack_dual(out["e_emb_rhf"]).tangent
    assert float(torch.max(torch.abs(tangent - lanes["e_emb_rhf"][1]))) < ROUTES


def test_later_geometries_and_directions_reuse_the_programs(water):
    """A second geometry and a second direction of the structure make no
    new program: the cached ones (captured once on a card) serve them."""
    DERIVATIVE_PROGRAMS.clear()
    engine._JIT_PROGRAM_CACHE.clear()
    fn = make_mu_embed_energy(water, 1, 4, jit_kernel="on", grad_cycles=2, **KW)
    x = torch.tensor(np.asarray(water.coords))
    _jvp(fn, x)
    programs = (set(DERIVATIVE_PROGRAMS), set(engine._JIT_PROGRAM_CACHE))
    _jvp(fn, x + 0.01 * _direction(x))
    with forward_ad.dual_level():
        t = torch.zeros_like(x)
        t[0, 0] = 1.0
        fn(forward_ad.make_dual(x, t))
    assert (set(DERIVATIVE_PROGRAMS), set(engine._JIT_PROGRAM_CACHE)) == programs


def test_tangent_program_bodies_copy_nothing_from_the_host(water, monkeypatch):
    """With the programs built, every tangent body runs with torch.tensor
    and torch.as_tensor raising and writes the same outputs (a CUDA graph
    captures no host-to-device copy)."""
    DERIVATIVE_PROGRAMS.clear()
    engine._JIT_PROGRAM_CACHE.clear()
    _jvp(make_mu_embed_energy(water, 1, 4, jit_kernel="on", grad_cycles=2, **KW),
         torch.tensor(np.asarray(water.coords)))
    progs = list(DERIVATIVE_PROGRAMS.values())
    want = [{name: (p.clone(), t.clone()) for name, (p, t) in prog.outputs.items()}
            for prog in progs]
    scfs = [prog.program for key, prog in engine._JIT_PROGRAM_CACHE.items() if "tangent" in key]
    assert len(scfs) == 2

    def refuse(*args, **kwargs):
        raise AssertionError("host-to-device copy inside a tangent program body")

    monkeypatch.setattr(torch, "tensor", refuse)
    monkeypatch.setattr(torch, "as_tensor", refuse)
    with forward_ad.dual_level():
        for prog, outputs in zip(progs, want):
            prog.captured.fn()
            for name, (p, t) in outputs.items():
                assert torch.equal(prog.outputs[name][0], p), (prog.kind, name)
                assert torch.equal(prog.outputs[name][1], t), (prog.kind, name)
        for scf in scfs:
            scf.run_cycles(1)
            scf.grad_polish()
            scf.finish()


def test_tangent_routes(water):
    """"auto" runs the eager dual route on the CPU (counted); "on" refuses
    coordinates that require grad, as every program does."""
    x = torch.tensor(np.asarray(water.coords))
    RUNS.clear()
    _jvp(make_mu_embed_energy(water, 1, 4, **KW), x)
    assert RUNS["embed_tangent_eager"] == 1 and not RUNS.get("embed_tangent_program")
    with pytest.raises(ValueError, match="requires_grad"):
        make_mu_embed_energy(water, 1, 4, jit_kernel="on", **KW)(x.clone().requires_grad_())


def test_tangent_matches_jax_jvp(water, water_xyz):
    """The program route's d e/dz against jax.jvp of nbed_tpu's program
    (mu, B3LYP, grid level 1, 20 polish cycles): within 1e-9 Ha/bohr, the
    energies within 1e-8 Ha."""
    x = np.asarray(water.coords)
    t = np.zeros_like(x)
    t[2, 2] = 1.0
    ours = _jvp(make_mu_embed_energy(water, 1, 4, jit_kernel="on", grad_cycles=20, **KW),
                torch.tensor(x))
    ref_fn = ref_embed_path.make_mu_embed_energy(
        ref_build_molecule(water_xyz, "sto-3g"), 1, 4, grad_cycles=20,
        **{k: v for k, v in KW.items() if k != "device"})
    primal, tangent = jax.jvp(lambda c: ref_fn(c)["e_emb_rhf"], (jnp.asarray(x),),
                              (jnp.asarray(t),))
    assert abs(float(ours["e_emb_rhf"][0]) - float(primal)) < 1e-8
    assert abs(float(ours["e_emb_rhf"][1]) - float(tangent)) < REFERENCE


def test_eigh_jvp_matches_torch_and_a_central_difference():
    """The capturable eigh's forward-mode rule against torch.linalg.eigh's
    (a lane batch, distinct eigenvalues) and a central difference of the
    eigenvalues and of sign-fixed eigenvectors."""
    rng = np.random.default_rng(5)
    a = rng.standard_normal((3, 6, 6))
    a = torch.tensor(a + a.transpose(0, 2, 1))
    t = rng.standard_normal((3, 6, 6))
    t = torch.tensor(t + t.transpose(0, 2, 1))
    with forward_ad.dual_level():
        ours = [forward_ad.unpack_dual(o).tangent for o in eigh_jvp(forward_ad.make_dual(a, t))]
        ref = [forward_ad.unpack_dual(o).tangent
               for o in torch.linalg.eigh(forward_ad.make_dual(a, t))]
    for o, r in zip(ours, ref):
        torch.testing.assert_close(o, r, rtol=0, atol=1e-12)
    h = 1e-6
    (wp, vp), (wm, vm), (_, v0) = (torch.linalg.eigh(m) for m in (a + h * t, a - h * t, a))

    def fix(v):  # the sign of each eigenvector along the unperturbed one
        return v * torch.sign(torch.sum(v * v0, dim=-2, keepdim=True))

    torch.testing.assert_close(ours[0], (wp - wm) / (2 * h), rtol=0, atol=1e-7)
    torch.testing.assert_close(ours[1], (fix(vp) - fix(vm)) / (2 * h), rtol=0, atol=1e-6)


def test_tangent_jk_plain_version_matches_the_formula():
    """The tangent J/K on the CPU: JK(G, D) and its tangent JK(G, dD) +
    JK(dG, D), against J = G_J vec(D_a + D_b) and K_s = G_K vec(D_s) written
    out; and forward_ad_jk finds the one prepared on the same buffers."""
    rng = np.random.default_rng(8)
    b, n = 2, 3
    g_j, g_k, gd_j, gd_k = (torch.tensor(rng.standard_normal((b, n * n, n * n)))
                            for _ in range(4))
    dm, dm_dot = (torch.tensor(rng.standard_normal((b, 2, n, n))) for _ in range(2))
    prepared = jk.TangentJK(g_j, g_k, gd_j, gd_k)

    def formula(gj, gk, d):
        vec = d.reshape(b, 2, n * n)
        j = torch.einsum("brm,bm->br", gj, vec[:, 0] + vec[:, 1])
        k = torch.einsum("brm,bsm->bsr", gk, vec)
        return torch.cat([j[:, None], k], dim=1)

    with forward_ad.dual_level():
        out = prepared(forward_ad.make_dual(dm, dm_dot))
        p, t = forward_ad.unpack_dual(out)
        found = jk.forward_ad_jk(forward_ad.make_dual(g_j, gd_j), forward_ad.make_dual(g_k, gd_k))
    torch.testing.assert_close(p, formula(g_j, g_k, dm), rtol=1e-13, atol=1e-12)
    torch.testing.assert_close(t, formula(g_j, g_k, dm_dot) + formula(gd_j, gd_k, dm),
                               rtol=1e-13, atol=1e-12)
    assert found is prepared
