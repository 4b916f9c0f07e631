"""Every XC primitive and registry entry of nbed_tpu_torch against nbed_tpu:
energy densities and every input gradient (5 inputs, 7 with tau) at
seeded points spanning rho 1e-10..1e2, exact ties (sigma = 0, tau = tau_W,
alpha = 1) and every branch of the ITYH attenuation; the composition
parser and the unknown-name errors."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nbed_tpu.dft import functionals as R
from nbed_tpu_torch.dft import functionals as P

# one torch thread per test process: under pytest-xdist the OpenMP threads
# of several workers spin on the same cores and slow every worker many-fold
torch.set_num_threads(1)

# relative tolerance of values and gradients
RTOL = 1e-12
# The absolute floor at each point is ATOL_REL times the natural unit of
# the compared quantity there, from the density's LDA-exchange scale
# rho^(4/3): that for the energy density, and that over rho, rho^(8/3) and
# rho^(5/3) for the rho, sigma and tau gradients (see UNITS). A quantity far
# below its point's unit (a term that nearly vanishes there) is held to
# that floor; every other one to its relative tolerance.
ATOL_REL = 1e-13
# Terms through the ITYH closed form (2 < a < 8, where terms of size a
# cancel to O(1/a^2)): its relative error against the exact F(a) reaches
# 4.7e-9 in F and 9.5e-9 in F' in both packages, and the sigma gradients,
# where F'(a) da/dsigma nearly cancels the unattenuated term, amplify it to
# 1.9e-7 (measured worst, lcblyp). test_ityh_closed_form_as_accurate_as_reference
# shows the port at the reference's distance from the exact F and F'.
RTOL_ITYH = (1e-8, 1e-6)
ITYH = {"ityh_sr_b88(0.33)", "ityh_sr_pbe(0.3)", "b97_sr_x(wb97x)", "lcblyp",
        "wb97", "wb97x"}
# B97 correlation's opposite-spin piece, E_c[ra, rb] - E_c[ra, 0] -
# E_c[0, rb], cancels where one spin density is far below the other, and
# its sigma gradients carry that cancellation: measured worst 1.9e-9
# relative. test_b97_partition_as_accurate_as_reference holds both packages
# against exact arithmetic at every point.
RTOL_B97 = (RTOL, 1e-8)
B97 = {"b97_c(wb97x)", "b97_c(wb97)"}

PRIMITIVES = ["slater_x", "b88_x", "vwn5_c", "vwn_rpa_c", "lyp_c", "pw92_c",
              "pbe_x", "pbe_c", "tpss_x", "tpss_c", "scan_x", "scan_c"]
FACTORIES = {  # closures the registry builds, by their arguments
    "ityh_sr_b88(0.33)": lambda m: m.ityh_sr_x(m.b88_x, 0.33),
    "ityh_sr_pbe(0.3)": lambda m: m.ityh_sr_x(m.pbe_x, 0.3),
    "b97_sr_x(wb97x)": lambda m: m.b97_sr_x(m._WB97X_CX, 0.3),
    "b97_sr_x(omega=0)": lambda m: m.b97_sr_x(m._WB97_CX, 0.0),
    "b97_c(wb97x)": lambda m: m.b97_c(m._WB97X_CSS, m._WB97X_COS),
    "b97_c(wb97)": lambda m: m.b97_c(m._WB97_CSS, m._WB97_COS),
}


def _points():
    """(ra, rb, gaa, gab, gbb, ta, tb) as float64 numpy arrays: seeded
    densities and gradient vectors, tau >= tau_W, plus exact ties."""
    rng = np.random.default_rng(2024)
    n = 48
    ra = 10.0 ** rng.uniform(-10, 2, n)
    rb = 10.0 ** rng.uniform(-10, 2, n)
    rb[:4] = 0.0  # fully polarised points
    ga = rng.standard_normal((n, 3)) * (ra ** (4 / 3))[:, None] * rng.uniform(0, 3, (n, 1))
    gb = rng.standard_normal((n, 3)) * (rb ** (4 / 3))[:, None] * rng.uniform(0, 3, (n, 1))
    ga[4:10] = 0.0  # sigma = 0 ties
    gb[4:8] = 0.0
    gaa, gbb = np.sum(ga * ga, 1), np.sum(gb * gb, 1)
    gab = np.sum(ga * gb, 1)
    tu = lambda r: 0.15 * (3 * np.pi**2) ** (2 / 3) * (2 * r) ** (5 / 3)  # noqa: E731
    safe = lambda r: np.maximum(r, 1e-12)  # noqa: E731
    ta = gaa / (8 * safe(ra)) + tu(ra) * rng.uniform(0, 2, n)
    tb = gbb / (8 * safe(rb)) + tu(rb) * rng.uniform(0, 2, n)
    ta[10:16] = gaa[10:16] / (8 * ra[10:16])  # tau = tau_W ties
    tb[10:14] = gbb[10:14] / (8 * rb[10:14])
    ta[16:18] = tu(ra[16:18])  # uniform-gas points (alpha ~ 1)
    tb[16:18] = tu(rb[16:18])
    return ra, rb, gaa, gab, gbb, ta, tb


POINTS = _points()
_RHO = POINTS[0] + POINTS[1]
_E = _RHO ** (4 / 3)
# natural unit at each point of the energy density and of its gradient in
# (ra, rb, gaa, gab, gbb, ta, tb), in that order
UNITS = (_E, _E / _RHO, _E / _RHO, *3 * (_E / _RHO ** (8 / 3),),
         *2 * (_E / _RHO ** (5 / 3),))


def _value_and_grads(fn, args, torch_fn):
    """Energy density and its gradient in every input, as numpy arrays."""
    if not torch_fn:
        val, vjp = jax.vjp(fn, *(jnp.asarray(a) for a in args))
        return [np.asarray(x) for x in (val, *vjp(jnp.ones_like(val)))]
    ts = [torch.tensor(a, requires_grad=True) for a in args]
    val = fn(*ts)
    grads = torch.autograd.grad(val.sum(), ts, allow_unused=True,
                                materialize_grads=True)
    return [x.detach().numpy() for x in (val, *grads)]


def _compare(ref_fn, port_fn, n_inputs, rtol=(RTOL, RTOL)):
    """Values at ``rtol[0]``, every input gradient at ``rtol[1]``, each
    point above its own floor."""
    args = POINTS[:n_inputs]
    theirs = _value_and_grads(ref_fn, args, torch_fn=False)
    ours = _value_and_grads(port_fn, args, torch_fn=True)
    for i, (o, t) in enumerate(zip(ours, theirs)):
        tol = ATOL_REL * UNITS[i] + rtol[min(i, 1)] * np.abs(t)
        ok = (o == t) | (np.isnan(o) & np.isnan(t)) | (np.abs(o - t) <= tol)
        bad = np.nonzero(~ok)[0]
        assert bad.size == 0, (f"output {i} at points {bad}: ours {o[bad]}, "
                               f"reference {t[bad]}, tolerance {tol[bad]}")


def _rtol(name):
    if name in ITYH:
        return RTOL_ITYH
    return RTOL_B97 if name in B97 else (RTOL, RTOL)


def _n_inputs(fn):
    return 7 if getattr(fn, "needs_tau", False) else 5


@pytest.mark.parametrize("name", PRIMITIVES)
def test_primitive_matches_reference(name):
    ref_fn, port_fn = getattr(R, name), getattr(P, name)
    assert getattr(port_fn, "needs_tau", False) == getattr(ref_fn, "needs_tau", False)
    _compare(ref_fn, port_fn, _n_inputs(ref_fn))


@pytest.mark.parametrize("name", sorted(FACTORIES))
def test_closure_primitive_matches_reference(name):
    _compare(FACTORIES[name](R), FACTORIES[name](P), 5, _rtol(name))


def _combined(module, name):
    terms, _, _ = module.resolve_functional(name)
    n = max((_n_inputs(fn) for _, fn in terms), default=5)

    def fn(*args):
        out = 0.0
        for coef, term in terms:
            out = out + coef * term(*args[:_n_inputs(term)])
        return out

    return fn, n


@pytest.mark.parametrize("name", sorted(R.FUNCTIONALS))
def test_registry_entry_matches_reference(name):
    ref_terms, ref_hyb, ref_rsh = R.resolve_functional(name)
    terms, hyb, rsh = P.resolve_functional(name)
    assert (hyb, rsh) == (ref_hyb, ref_rsh)
    assert [c for c, _ in terms] == [c for c, _ in ref_terms]
    assert [fn.__name__ for _, fn in terms] == [fn.__name__ for _, fn in ref_terms]
    if not terms:
        return
    (ref_fn, n), (port_fn, _) = _combined(R, name), _combined(P, name)
    _compare(ref_fn, port_fn, n, _rtol(name))


def test_ityh_attenuation_every_branch():
    """a below 0.025, at and around both branch points, between, above 8,
    and far into the asymptotic tail; the gradient at the branch points
    follows JAX's tie rule."""
    a = np.array([0.0, 1e-8, 0.01, 0.0249, 0.025, 0.0251, 0.5, 2.0, 7.99, 8.0,
                  8.01, 50.0, 1e4, 1e10])
    ref = np.asarray(R._ityh_attenuation(jnp.asarray(a)))
    ref_g = np.asarray(jax.vmap(jax.grad(R._ityh_attenuation))(jnp.asarray(a)))
    t = torch.tensor(a, requires_grad=True)
    f = P._ityh_attenuation(t)
    (g,) = torch.autograd.grad(f.sum(), t)
    np.testing.assert_allclose(f.detach().numpy(), ref, rtol=RTOL_ITYH[0], atol=0)
    np.testing.assert_allclose(g.numpy(), ref_g, rtol=RTOL_ITYH[0], atol=1e-30)
    outside = (a < 2.0) | (a > 8.0)  # away from the closed form's cancellation
    np.testing.assert_allclose(f.detach().numpy()[outside], ref[outside],
                               rtol=RTOL, atol=0)
    np.testing.assert_allclose(g.numpy()[outside], ref_g[outside], rtol=RTOL,
                               atol=1e-30)


def test_ityh_closed_form_as_accurate_as_reference():
    """Between a = 2 and 8 both packages evaluate the closed form with
    cancellation; against the exact F(a) and F'(a) (mpmath, 40 digits) the
    port's worst relative error is within 10x of the reference's."""
    mpmath = pytest.importorskip("mpmath")
    mpmath.mp.dps = 40

    def exact(x):
        b = mpmath.exp(-1 / (4 * x * x)) - 1
        c = 2 * x * x * b + mpmath.mpf(1) / 2
        return 1 - mpmath.mpf(8) / 3 * x * (
            mpmath.sqrt(mpmath.pi) * mpmath.erf(1 / (2 * x)) + 2 * x * (b - c))

    a = np.linspace(2.0, 7.99, 25)
    f_ex = np.array([float(exact(mpmath.mpf(x))) for x in a])
    g_ex = np.array([float(mpmath.diff(exact, mpmath.mpf(x))) for x in a])
    ref = np.asarray(R._ityh_attenuation(jnp.asarray(a)))
    ref_g = np.asarray(jax.vmap(jax.grad(R._ityh_attenuation))(jnp.asarray(a)))
    t = torch.tensor(a, requires_grad=True)
    f = P._ityh_attenuation(t)
    (g,) = torch.autograd.grad(f.sum(), t)
    for ours, theirs, ex in ((f.detach().numpy(), ref, f_ex), (g.numpy(), ref_g, g_ex)):
        err_ours = np.max(np.abs(ours - ex) / np.abs(ex))
        err_ref = np.max(np.abs(theirs - ex) / np.abs(ex))
        assert err_ours <= 10.0 * err_ref + 1e-15, (err_ours, err_ref)


def _b97_c_exact(mpmath, css, cos, g_ss=0.2, g_os=0.006):
    """The reference's b97_c in mpmath, every constant the float64 value the
    reference computes (in Python floats where it does). sigma enters
    without the floor at 0, which the points never cross, so the function
    is smooth in it; the floor's tie rule is applied to the derivative."""
    mp, f = mpmath, mpmath.mpf
    p43 = f(4.0 / 3.0)
    fz_den, fpp0 = 2.0 ** (4.0 / 3.0) - 2.0, 8.0 / (9.0 * (2.0 ** (4.0 / 3.0) - 2.0))

    def g(rs, a, a1, b1, b2, b3, b4):
        srs = mp.sqrt(rs)
        den = 2.0 * f(a) * (f(b1) * srs + f(b2) * rs + f(b3) * rs * srs + f(b4) * rs * rs)
        return -2.0 * f(a) * (1 + f(a1) * rs) * mp.log(1 + 1 / den)

    def eps(rs, fz_over_fpp0, one_minus_z4, fz, z4):
        ec0 = g(rs, 0.031091, 0.21370, 7.5957, 3.5876, 1.6382, 0.49294)
        ec1 = g(rs, 0.015545, 0.20548, 14.1189, 6.1977, 3.3662, 0.62517)
        alc = -g(rs, 0.016887, 0.11125, 10.357, 3.6231, 0.88026, 0.49671)
        return ec0 + alc * fz_over_fpp0 * one_minus_z4 + (ec1 - ec0) * fz * z4

    def rs_of(r):
        return (3.0 / (f(4.0 * np.pi) * r)) ** f(1.0 / 3.0)

    z = 1.0 - 1e-12  # e_polarized's zeta: its spin factors are Python floats
    fz_pol = ((1.0 + z) ** (4.0 / 3.0) + (1.0 - z) ** (4.0 / 3.0) - 2.0) / fz_den
    pol = tuple(map(f, (fz_pol / fpp0, 1.0 - z**4, fz_pol, z**4)))

    def pw92(ra, rb):
        rho = max(ra + rb, f(1e-12))
        zeta = min(max((ra - rb) / rho, f(-1.0 + 1e-15)), f(1.0 - 1e-15))
        fz = ((1 + zeta) ** p43 + (1 - zeta) ** p43 - 2) / f(fz_den)
        return rho * eps(rs_of(rho), fz / f(fpp0), 1 - zeta**4, fz, zeta**4)

    def series(x2, gamma, coefs):
        u = f(gamma) * x2 / (1 + f(gamma) * x2)
        return sum(f(c) * u**i for i, c in enumerate(coefs))

    def fn(ra, rb, gaa, gab, gbb):
        ra_, rb_ = max(ra, f(1e-12)), max(rb, f(1e-12))
        e_aa, e_bb = ra_ * eps(rs_of(ra_), *pol), rb_ * eps(rs_of(rb_), *pol)
        e_os = pw92(ra, rb) - e_aa - e_bb
        x2a = gaa / (ra_ * ra_) * ra_ ** f(-2.0 / 3.0)
        x2b = gbb / (rb_ * rb_) * rb_ ** f(-2.0 / 3.0)
        return (e_aa * series(x2a, g_ss, css) + e_bb * series(x2b, g_ss, css)
                + e_os * series((x2a + x2b) / 2, g_os, cos))

    return fn


@pytest.mark.parametrize("name", sorted(B97))
def test_b97_partition_as_accurate_as_reference(name):
    """Against exact values and gradients (mpmath, 60 digits, central
    differences) at every point and in every output, the port's error is
    within 10x of the reference's, or within RTOL and the point's floor."""
    mpmath = pytest.importorskip("mpmath")
    mpmath.mp.dps = 60
    sets = {"b97_c(wb97x)": (P._WB97X_CSS, P._WB97X_COS),
            "b97_c(wb97)": (P._WB97_CSS, P._WB97_COS)}
    exact_fn = _b97_c_exact(mpmath, *sets[name])
    args = POINTS[:5]
    # steps far below each input's size and its natural scale: rho, and
    # for sigma_ss the floored spin density's own max(r_s, 1e-12)^(8/3)
    ra_, rb_ = np.maximum(args[0], 1e-12), np.maximum(args[1], 1e-12)
    step_scale = (_RHO, _RHO, ra_ ** (8 / 3), _RHO ** (8 / 3), rb_ ** (8 / 3))
    exact = np.zeros((6, args[0].size))
    for p in range(args[0].size):
        x = [mpmath.mpf(float(a[p])) for a in args]
        exact[0, p] = float(exact_fn(*x))
        for j in range(5):
            h = mpmath.mpf(1e-25) * max(abs(x[j]), step_scale[j][p])
            up, dn = list(x), list(x)
            up[j] += h
            dn[j] -= h
            d = (exact_fn(*up) - exact_fn(*dn)) / (2 * h)
            # the sigma floor max(g, 0) passes half the gradient at g = 0
            exact[1 + j, p] = float(d) * (0.5 if j in (2, 4) and x[j] == 0 else 1.0)
    theirs = _value_and_grads(FACTORIES[name](R), args, torch_fn=False)
    ours = _value_and_grads(FACTORIES[name](P), args, torch_fn=True)
    for i in range(6):
        err_ours = np.abs(ours[i] - exact[i])
        err_ref = np.abs(theirs[i] - exact[i])
        bound = 10.0 * err_ref + RTOL * np.abs(exact[i]) + ATOL_REL * UNITS[i]
        assert np.all(err_ours <= bound), (i, np.nonzero(err_ours > bound))


def test_scan_interp_at_alpha_one():
    """alpha = 1 exactly, where both branches meet, and around it."""
    alpha = np.array([0.0, 0.5, 1.0 - 1e-9, 1.0, 1.0 + 1e-9, 1.5, 1e3])
    for c1, c2, d in ((0.667, 0.8, 1.24), (0.64, 1.5, 0.7)):
        ref_fn = lambda x: R._scan_interp(x, c1, c2, d)  # noqa: E731
        ref = np.asarray(ref_fn(jnp.asarray(alpha)))
        ref_g = np.asarray(jax.vmap(jax.grad(ref_fn))(jnp.asarray(alpha)))
        t = torch.tensor(alpha, requires_grad=True)
        f = P._scan_interp(t, c1, c2, d)
        (g,) = torch.autograd.grad(f.sum(), t)
        np.testing.assert_allclose(f.detach().numpy(), ref, rtol=RTOL, atol=1e-300)
        np.testing.assert_allclose(g.numpy(), ref_g, rtol=RTOL, atol=1e-300)


def test_clips_split_the_gradient_at_ties_like_jax():
    x = torch.tensor([0.0, 1.0, 0.5], dtype=torch.float64, requires_grad=True)
    (g,) = torch.autograd.grad(P._clip(x, 0.0, 1.0).sum(), x)
    ref = jax.vmap(jax.grad(lambda v: jnp.clip(v, 0.0, 1.0)))(jnp.array([0.0, 1.0, 0.5]))
    np.testing.assert_array_equal(g.numpy(), np.asarray(ref))


def _closed_shell_points(seed: int = 11, n: int = 16):
    """Closed-shell meta-GGA inputs: ra = rb, equal spin gradients (gaa =
    gab = gbb) and tau above tau_W, where the bracket that tpss_c clips,
    |rb grad ra - ra grad rb|^2 / rho^4, is 0 up to rounding."""
    rng = np.random.default_rng(seed)
    r = 10.0 ** rng.uniform(-3, 1, n)
    g = (r ** (4.0 / 3.0)) * rng.uniform(0.1, 2.0, n)
    t = g / (8.0 * r) * rng.uniform(1.2, 3.0, n)
    return [r, r.copy(), g, g.copy(), g.copy(), t, t.copy()]


def test_tpss_c_closed_shell_clip_passes_its_gradient_whole():
    """The one input gradient held apart from nbed_tpu's: at closed-shell
    points the port's tpss_c passes the clip's gradient whole to the
    bracket it guards, where JAX's tie rule passes half (or none below the
    tie), so its f_xc matches central differences of its vxc
    (test_torch_reference_faults.py). There, every input gradient equals
    nbed_tpu's a hair off the closed-shell manifold (gab lowered by 1e-9
    relative, where the bracket is positive and both clips pass the
    gradient whole) to 1e-6 relative; the values stay nbed_tpu's to 1e-11."""
    pts = _closed_shell_points()
    off = [a.copy() for a in pts]
    off[3] = off[3] * (1.0 - 1e-9)

    def grads(fn, args, torch_fn):
        if torch_fn:
            ts = [torch.tensor(a, requires_grad=True) for a in args]
            val = fn(*ts)
            gs = torch.autograd.grad(val.sum(), ts)
            return val.detach().numpy(), [g.numpy() for g in gs]
        arrs = [jnp.asarray(a) for a in args]
        val, gs = jax.value_and_grad(lambda *x: fn(*x).sum(), argnums=tuple(range(7)))(*arrs)
        return np.asarray(fn(*arrs)), [np.asarray(g) for g in gs]

    jax.config.update("jax_enable_x64", True)
    val, ours = grads(P.tpss_c, pts, True)
    ref_val, _ = grads(R.tpss_c, pts, False)
    _, theirs_off = grads(R.tpss_c, off, False)
    np.testing.assert_allclose(val, ref_val, rtol=1e-11, atol=0)
    for i, (o, t) in enumerate(zip(ours, theirs_off)):
        np.testing.assert_allclose(o, t, rtol=1e-6, atol=1e-300, err_msg=f"input {i}")


CAM_SPEC = ("0.19*HF + 0.46*LR_HF(0.33) + 0.35*B88 + 0.46*SR_B88(0.33) "
            "+ 0.19*VWN5 + 0.81*LYP")


@pytest.mark.parametrize("spec", [
    "0.2*HF + 0.08*SLATER + 0.72*B88 + 0.81*LYP + 0.19*VWN_RPA",
    "0.25*HF + 0.75*PBE, PBE",
    CAM_SPEC,
    "0.5*b3lyp + 0.5*blyp",
    "b88,",
    "0.9*tpssx + tpssc + 0.1*HF",
    "0.6*SR_HF(0.4) + 0.4*HF - 0.1*pbex + 1.1*pbec",
    "0.35*B88 + 0.46*SR_B88(0.33), 0.19*VWN5 + 0.81*LYP",
    "B88, LYP",
])
def test_composition_matches_reference(spec):
    ref_terms, ref_hyb, ref_rsh = R.parse_composition(spec)
    terms, hyb, rsh = P.parse_composition(spec)
    assert (hyb, rsh) == (ref_hyb, ref_rsh)
    assert [c for c, _ in terms] == [c for c, _ in ref_terms]
    assert P.resolve_functional(spec)[1:] == R.resolve_functional(spec)[1:]
    (ref_fn, n), (port_fn, _) = _combined(R, spec), _combined(P, spec)
    _compare(ref_fn, port_fn, n, RTOL_ITYH if "sr_b88" in spec.lower() else (RTOL, RTOL))


@pytest.mark.parametrize("spec", [
    "0.5*LR_HF(0.3) + 0.5*LR_HF(0.4)", "", "a,b,c", "0.2*HF + 0.8*nope",
    "LR_HF", "b88 ?", "lyp, b88",
])
def test_malformed_composition_raises_like_reference(spec):
    with pytest.raises(Exception) as ref_exc:
        R.parse_composition(spec)
    with pytest.raises(Exception) as exc:
        P.parse_composition(spec)
    assert type(exc.value) is type(ref_exc.value)
    assert str(exc.value) == str(ref_exc.value)


@pytest.mark.parametrize("name", ["m06", "M06-2X", "mn15", "hse06", "revtpss",
                                  "b97d", "B97-D", "no_such_functional_123"])
def test_unknown_functionals_raise_reference_keyerror(name):
    """The families without primitives raise the reference's KeyError and
    hint, word for word."""
    with pytest.raises(KeyError) as ref_exc:
        R.resolve_functional(name)
    with pytest.raises(KeyError) as exc:
        P.resolve_functional(name)
    assert str(exc.value) == str(ref_exc.value)
    assert "Composition strings" in str(exc.value)


def test_pt2_coefficients_match_reference():
    for name in [None, "b2plyp", "B2-PLYP", "b2gpplyp", "b3lyp", "wb97x"]:
        assert P.pt2_coefficient(name) == R.pt2_coefficient(name)
