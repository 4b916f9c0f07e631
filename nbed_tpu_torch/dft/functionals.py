"""Spin-resolved exchange-correlation energy densities in torch (port of
``nbed_tpu/dft/functionals.py``).

Each functional maps ``(rho_a, rho_b, gaa, gab, gbb) -> energy / volume``
where ``g__`` are contracted density gradients; meta-GGA terms (attribute
``needs_tau``) take the per-spin kinetic-energy densities ``(ta, tb)`` as
two more inputs. Potentials come from ``torch.autograd`` in
:mod:`nbed_tpu_torch.dft.xc`. Conventions match libxc/PySCF: ``b3lyp`` uses
VWN-RPA correlation, ``b3lyp5`` VWN5.

Floors and clips go through :func:`_max` / :func:`_min`, never
``torch.clamp``: at an exact tie (sigma = 0, tau = tau_W) they split the
gradient 0.5/0.5 as ``jnp.maximum`` and ``jnp.clip`` do, where ``clamp``
passes all of it, and they carry a NaN gradient through to the side not
taken as JAX does. The folded ``log``/``exp``
forms of LYP, PBE and TPSS are the reference's formulas and are kept as
written.
"""

import re

import numpy as np
import torch

__all__ = ["FUNCTIONALS", "DH_PT2", "pt2_coefficient", "parse_composition",
           "resolve_functional"]

# density floor of the reference's CPU branch (functionals.py:21-33); its
# coarser TPU floor exists only for emulated float64 and is not ported
_TINY = 1e-12


def _select(x, c, win):
    """``x`` where ``win``, else ``c``, differentiated as ``lax.max``/``min``
    are: each side's gradient is the incoming one times a constant weight
    (1 for the side taken, 0 for the other, 0.5 each at a tie), so a NaN
    arriving from above stays NaN on both sides, as in JAX."""
    c = c if torch.is_tensor(c) else x.new_full((), c)
    w = win.to(x.dtype) + 0.5 * (x == c).to(x.dtype)
    return x * w + c * (1.0 - w)


def _max(x, c):
    """``jnp.maximum(x, c)``."""
    return _select(x, c, x > c)


def _min(x, c):
    """``jnp.minimum(x, c)``."""
    return _select(x, c, x < c)


def _clip(x, lo, hi):
    """``jnp.clip(x, lo, hi)`` = minimum(maximum(x, lo), hi)."""
    return _min(_max(x, lo), hi)


def _safe(rho):
    return _max(rho, _TINY)


def _clip_zeta(zeta):
    """The spin polarisation clipped into (-1, 1): by 1e-15 as in the
    reference, or by the dtype's epsilon where 1 - 1e-15 rounds to 1. In
    float32 the reference's clip reaches |zeta| = 1, where (1 -+ zeta)^p has
    an infinite derivative and the fully polarised PBE terms of TPSS
    correlation give a NaN potential; float64 results are unchanged."""
    margin = max(1e-15, torch.finfo(zeta.dtype).eps)
    return _clip(zeta, -1.0 + margin, 1.0 - margin)


# ----------------------------------------------------------------- exchange

def slater_x(ra, rb, gaa, gab, gbb):
    """Slater/Dirac LDA exchange, spin-scaled."""
    cx = (3.0 / 4.0) * (3.0 / np.pi) ** (1.0 / 3.0) * 2.0 ** (1.0 / 3.0)
    return -cx * (_safe(ra) ** (4.0 / 3.0) + _safe(rb) ** (4.0 / 3.0))


def b88_x(ra, rb, gaa, gab, gbb):
    """Becke 1988 exchange (full: LDA part + gradient correction)."""
    beta = 0.0042

    def per_spin(r, g):
        r = _safe(r)
        r43 = r ** (4.0 / 3.0)
        chi = torch.sqrt(_max(g, 0.0)) / r43
        lda = -(3.0 / 4.0) * (3.0 / np.pi) ** (1.0 / 3.0) * 2.0 ** (1.0 / 3.0) * r43
        corr = -beta * r43 * chi * chi / (1.0 + 6.0 * beta * chi * torch.asinh(chi))
        return lda + corr

    return per_spin(ra, gaa) + per_spin(rb, gbb)


# -------------------------------------------------------------- correlation

# VWN parameter sets (A, x0, b, c): paramagnetic, ferromagnetic, spin
# stiffness. VWN5 is the recommended fit; RPA is libxc's LDA_C_VWN_RPA.
_VWN5 = {
    "P": (0.0310907, -0.10498, 3.72744, 12.9352),
    "F": (0.01554535, -0.32500, 7.06042, 18.0578),
    "A": (-1.0 / (6.0 * np.pi**2), -0.00475840, 1.13107, 13.0045),
}
_VWN_RPA = {
    "P": (0.0310907, -0.409286, 13.0720, 42.7198),
    "F": (0.01554535, -0.743294, 20.1231, 101.578),
    "A": (-1.0 / (6.0 * np.pi**2), -0.228344, 1.06835, 11.4813),
}


def _vwn_eps(x, params):
    a, x0, b, c = params
    q = np.sqrt(4.0 * c - b * b)
    xx = x * x + b * x + c
    xx0 = x0 * x0 + b * x0 + c
    atn = torch.atan(q / (2.0 * x + b))
    return a * (
        torch.log(x * x / xx)
        + (2.0 * b / q) * atn
        - (b * x0 / xx0)
        * (torch.log((x - x0) ** 2 / xx) + (2.0 * (b + 2.0 * x0) / q) * atn)
    )


def _vwn_c(params):
    fpp0 = 8.0 / (9.0 * (2.0 ** (4.0 / 3.0) - 2.0))

    def fn(ra, rb, gaa, gab, gbb):
        rho = _safe(ra + rb)
        zeta = _clip_zeta((ra - rb) / rho)
        rs = (3.0 / (4.0 * np.pi * rho)) ** (1.0 / 3.0)
        x = torch.sqrt(rs)
        eps_p = _vwn_eps(x, params["P"])
        eps_f = _vwn_eps(x, params["F"])
        alpha = _vwn_eps(x, params["A"])
        f_zeta = ((1.0 + zeta) ** (4.0 / 3.0) + (1.0 - zeta) ** (4.0 / 3.0) - 2.0) / (
            2.0 ** (4.0 / 3.0) - 2.0
        )
        z4 = zeta**4
        eps = eps_p + alpha * (f_zeta / fpp0) * (1.0 - z4) + (eps_f - eps_p) * f_zeta * z4
        return rho * eps

    return fn


vwn5_c = _vwn_c(_VWN5)
vwn_rpa_c = _vwn_c(_VWN_RPA)


def lyp_c(ra, rb, gaa, gab, gbb):
    """Lee-Yang-Parr correlation (Miehlich et al., CPL 157, 200 (1989))."""
    a, b, c, d = 0.04918, 0.132, 0.2533, 0.349
    cf = 0.3 * (3.0 * np.pi**2) ** (2.0 / 3.0)
    ra = _safe(ra)
    rb = _safe(rb)
    rho = ra + rb
    rm13 = rho ** (-1.0 / 3.0)
    denom = 1.0 + d * rm13
    # exp(-c rho^-1/3) rho^(-11/3) / denom with the power folded into the
    # exponential, as in the reference
    omega = torch.exp(-c * rm13 - (11.0 / 3.0) * torch.log(rho)) / denom
    delta = c * rm13 + d * rm13 / denom
    g_tot = gaa + 2.0 * gab + gbb
    term1 = -4.0 * a / denom * ra * rb / rho
    inner = (
        2.0 ** (11.0 / 3.0) * cf * (ra ** (8.0 / 3.0) + rb ** (8.0 / 3.0))
        + (47.0 / 18.0 - 7.0 * delta / 18.0) * g_tot
        - (5.0 / 2.0 - delta / 18.0) * (gaa + gbb)
        - (delta - 11.0) / 9.0 * (ra * gaa + rb * gbb) / rho
    )
    term2 = -a * b * omega * (
        ra * rb * inner
        - (2.0 / 3.0) * rho**2 * g_tot
        + ((2.0 / 3.0) * rho**2 - ra**2) * gbb
        + ((2.0 / 3.0) * rho**2 - rb**2) * gaa
    )
    return term1 + term2


def _pw92_eps(rs, zeta):
    """Perdew-Wang 1992 LSDA correlation energy per particle."""

    def g(rs, a, a1, b1, b2, b3, b4):
        srs = torch.sqrt(rs)
        den = 2.0 * a * (b1 * srs + b2 * rs + b3 * rs * srs + b4 * rs * rs)
        return -2.0 * a * (1.0 + a1 * rs) * torch.log(1.0 + 1.0 / den)

    ec0 = g(rs, 0.031091, 0.21370, 7.5957, 3.5876, 1.6382, 0.49294)
    ec1 = g(rs, 0.015545, 0.20548, 14.1189, 6.1977, 3.3662, 0.62517)
    alc = -g(rs, 0.016887, 0.11125, 10.357, 3.6231, 0.88026, 0.49671)
    fz = ((1.0 + zeta) ** (4.0 / 3.0) + (1.0 - zeta) ** (4.0 / 3.0) - 2.0) / (
        2.0 ** (4.0 / 3.0) - 2.0
    )
    fpp0 = 8.0 / (9.0 * (2.0 ** (4.0 / 3.0) - 2.0))
    z4 = zeta**4
    return ec0 + alc * (fz / fpp0) * (1.0 - z4) + (ec1 - ec0) * fz * z4


def pw92_c(ra, rb, gaa, gab, gbb):
    rho = _safe(ra + rb)
    zeta = _clip_zeta((ra - rb) / rho)
    rs = (3.0 / (4.0 * np.pi * rho)) ** (1.0 / 3.0)
    return rho * _pw92_eps(rs, zeta)


def pbe_x(ra, rb, gaa, gab, gbb):
    """PBE exchange (kappa=0.804), spin-scaled."""
    kappa, mu = 0.804, 0.2195149727645171

    def per_spin(r, g):
        r2 = 2.0 * _safe(r)  # spin scaling: Ex[ra,rb] = (Ex[2ra]+Ex[2rb])/2
        kf = (3.0 * np.pi**2 * r2) ** (1.0 / 3.0)
        # s2 split as (g/r2^2) * r2^(-2/3), the reference's factoring
        u = _max(g, 0.0) / (r2 * r2)
        s2 = u * r2 ** (-2.0 / 3.0) / (4.0 * (3.0 * np.pi**2) ** (2.0 / 3.0))
        fx = 1.0 + kappa - kappa / (1.0 + mu * s2 / kappa)
        lda = -(3.0 / (4.0 * np.pi)) * kf * r2
        return 0.5 * lda * fx

    return per_spin(ra, gaa) + per_spin(rb, gbb)


def _ityh_attenuation(a):
    """ITYH short-range attenuation factor F(a) of the exchange hole
    (Iikura-Tsuneda-Yanai-Hirao, JCP 115, 3540 (2001)):

        F(a) = 1 - (8/3) a [sqrt(pi) erf(1/(2a)) + 2a (b - c)]
        b = exp(-1/(4a^2)) - 1,  c = 2a^2 b + 1/2,

    in the reference's three regimes: the saturated polynomial below
    a = 0.025, the asymptotic series above a = 8, the closed form between.
    Each branch's input is clamped into its range so the branches not
    taken stay finite under autograd (``torch.where`` back-propagates
    through both)."""
    a = _max(a, 0.0)
    small = a < 0.025
    large = a > 8.0
    a_m = _clip(a, 0.025, 8.0)
    b = torch.exp(-1.0 / (4.0 * a_m * a_m)) - 1.0
    c = 2.0 * a_m * a_m * b + 0.5
    f_full = 1.0 - (8.0 / 3.0) * a_m * (
        np.sqrt(np.pi) * torch.special.erf(1.0 / (2.0 * a_m)) + 2.0 * a_m * (b - c)
    )
    a_s = _min(a, 0.025)
    f_sat = 1.0 - (8.0 / 3.0) * a_s * (np.sqrt(np.pi) - 3.0 * a_s + 4.0 * a_s**3)
    x2 = 1.0 / (4.0 * _max(a, 8.0) ** 2)
    f_asym = x2 * (1.0 / 9.0 - x2 * (1.0 / 60.0 - x2 / 420.0))
    return torch.where(small, f_sat, torch.where(large, f_asym, f_full))


def ityh_sr_x(base_x, omega: float):
    """Short-range (erfc(omega*r)/r) version of a spin-scaled exchange
    functional through the ITYH exchange-hole attenuation (the construction
    of CAM-B3LYP and LC-BLYP)."""

    def per_spin(r, g):
        r = _safe(r)
        zero_r, zero_g = torch.zeros_like(r), torch.zeros_like(g)
        e_full = base_x(r, zero_r, g, zero_g, zero_g)
        # e_full = -1/2 r^{4/3} K  =>  K = -2 e_full r^{-4/3}
        k_fac = _max(-2.0 * e_full * r ** (-4.0 / 3.0), _TINY)
        a = omega * torch.sqrt(k_fac) / (6.0 * np.sqrt(np.pi) * r ** (1.0 / 3.0))
        return e_full * _ityh_attenuation(a)

    def fn(ra, rb, gaa, gab, gbb):
        return per_spin(ra, gaa) + per_spin(rb, gbb)

    return fn


def pbe_c(ra, rb, gaa, gab, gbb):
    """PBE correlation (Perdew-Burke-Ernzerhof 1996)."""
    gamma = (1.0 - np.log(2.0)) / np.pi**2
    beta = 0.06672455060314922
    rho = _safe(ra + rb)
    zeta = _clip_zeta((ra - rb) / rho)
    rs = (3.0 / (4.0 * np.pi * rho)) ** (1.0 / 3.0)
    eps = _pw92_eps(rs, zeta)
    phi = 0.5 * ((1.0 + zeta) ** (2.0 / 3.0) + (1.0 - zeta) ** (2.0 / 3.0))
    kf = (3.0 * np.pi**2 * rho) ** (1.0 / 3.0)
    ks = torch.sqrt(4.0 * kf / np.pi)
    gnorm2 = _max(gaa + 2.0 * gab + gbb, 0.0)
    t2 = gnorm2 / (rho * rho) / (2.0 * phi * ks) ** 2
    expo = torch.exp(-eps / (gamma * phi**3))
    a_coef = (beta / gamma) / _max(expo - 1.0, 1e-30)
    num = 1.0 + a_coef * t2
    den = 1.0 + a_coef * t2 + (a_coef * t2) ** 2
    h = gamma * phi**3 * torch.log(1.0 + (beta / gamma) * t2 * num / den)
    return rho * (eps + h)


# ------------------------------------------------------------- meta-GGA (tau)

def _tpss_fx(r2, g2, t2):
    """TPSS exchange enhancement factor for an unpolarized density
    (Tao-Perdew-Staroverov-Scuseria, PRL 91, 146401 (2003), Eqs. 5-10)."""
    kappa, b, c, e, mu = 0.804, 0.40, 1.59096, 1.537, 0.21951
    r2 = _safe(r2)
    g2 = _max(g2, 0.0)
    u = g2 / (r2 * r2)
    p = u * r2 ** (-2.0 / 3.0) / (4.0 * (3.0 * np.pi**2) ** (2.0 / 3.0))
    p = _clip(p, 0.0, 1.0e4)  # F_x(p>100) is saturated at 1+kappa
    tau_w = 0.125 * u * r2  # |grad rho|^2 / (8 rho)
    tau_unif = 0.3 * (3.0 * np.pi**2) ** (2.0 / 3.0) * r2 ** (5.0 / 3.0)
    t2 = _max(t2, tau_w + _TINY * tau_unif)  # tau >= tau_W exactly
    z = _clip(tau_w / t2, 0.0, 1.0)
    alpha = _clip((t2 - tau_w) / tau_unif, 0.0, 1.0e6)
    q_b = (0.45 * (alpha - 1.0)
           / torch.sqrt(1.0 + b * alpha * (alpha - 1.0))
           + 2.0 * p / 3.0)
    z2 = z * z
    zp2 = (0.6 * z) ** 2
    x = (
        (10.0 / 81.0 + c * z2 / (1.0 + z2) ** 2) * p
        + (146.0 / 2025.0) * q_b * q_b
        - (73.0 / 405.0) * q_b * torch.sqrt(0.5 * zp2 + 0.5 * p * p)
        + (1.0 / kappa) * (10.0 / 81.0) ** 2 * p * p
        + 2.0 * np.sqrt(e) * (10.0 / 81.0) * zp2
        + e * mu * p**3
    ) / (1.0 + np.sqrt(e) * p) ** 2
    return 1.0 + kappa - kappa / (1.0 + x / kappa)


def tpss_x(ra, rb, gaa, gab, gbb, ta, tb):
    """TPSS meta-GGA exchange, spin-scaled: E_x[ra,rb] =
    (E_x[2 ra] + E_x[2 rb])/2 with per-spin (2 rho_s, 4 sigma_ss, 2 tau_s)."""

    def per_spin(r, g, t):
        r2 = 2.0 * _safe(r)
        kf = (3.0 * np.pi**2 * r2) ** (1.0 / 3.0)
        lda = -(3.0 / (4.0 * np.pi)) * kf * r2
        return 0.5 * lda * _tpss_fx(r2, 4.0 * _max(g, 0.0), 2.0 * t)

    return per_spin(ra, gaa, ta) + per_spin(rb, gbb, tb)


def _pbe_c_per_particle(ra, rb, gaa, gab, gbb):
    return pbe_c(ra, rb, gaa, gab, gbb) / _safe(ra + rb)


def tpss_c(ra, rb, gaa, gab, gbb, ta, tb):
    """TPSS meta-GGA correlation (PRL 91, 146401 (2003), Eqs. 11-14):
    eps_c = eps_revPKZB (1 + d eps_revPKZB z^3), d = 2.8, with z = tau_W/tau
    and the damped C(zeta, xi); self-interaction free at one electron."""
    d = 2.8
    ra = _safe(ra)
    rb = _safe(rb)
    rho = ra + rb
    g_tot = _max(gaa + 2.0 * gab + gbb, 0.0)
    tau = _max(ta + tb, _TINY)
    tau_w = 0.125 * g_tot / rho
    z = _clip(tau_w / _max(tau, tau_w), 0.0, 1.0)
    z2 = z * z

    zeta = _clip_zeta((ra - rb) / rho)
    # |grad zeta|^2 = 4 (rb^2 gaa - 2 ra rb gab + ra^2 gbb) / rho^4, in the
    # reference's factoring; xi^2 = |grad zeta|^2 / (4 (3 pi^2)^{2/3} rho^{2/3}).
    # The bracket is |rb grad ra - ra grad rb|^2 / rho^4 >= 0 exactly, so the
    # clip at 0 only guards rounding: at a closed-shell point the bracket is
    # 0, or a rounding error either side of it, and its gradient goes whole
    # to the bracket (weight 1, where JAX's tie weight of 1/2, or 0 below
    # the tie, drops part of its curvature and the reference's f_xc misses
    # a central difference of its vxc)
    za, zb = ra / rho, rb / rho
    q = (zb * zb * (gaa / (rho * rho))
         - 2.0 * za * zb * (gab / (rho * rho))
         + za * za * (gbb / (rho * rho)))
    gz2 = 4.0 * (q + (_max(q, 0.0) - q).detach())
    xi2 = gz2 * rho ** (-2.0 / 3.0) / (4.0 * (3.0 * np.pi**2) ** (2.0 / 3.0))
    c0 = 0.53 + zeta**2 * (0.87 + zeta**2 * (0.50 + 2.26 * zeta**2))
    damp_arg = xi2 * 0.5 * ((1.0 + zeta) ** (-4.0 / 3.0)
                            + (1.0 - zeta) ** (-4.0 / 3.0))
    # (1 + u)^-4 as exp(-4 log1p(u)), as in the reference
    c_zx = c0 * torch.exp(-4.0 * torch.log1p(damp_arg))

    eps_full = _pbe_c_per_particle(ra, rb, gaa, gab, gbb)
    zero = torch.zeros_like(ra)
    eps_a = _max(_pbe_c_per_particle(ra, zero, gaa, zero, zero), eps_full)
    eps_b = _max(_pbe_c_per_particle(rb, zero, gbb, zero, zero), eps_full)
    eps_rev = (eps_full * (1.0 + c_zx * z2)
               - (1.0 + c_zx) * z2 * (za * eps_a + zb * eps_b))
    eps = eps_rev * (1.0 + d * eps_rev * z2 * z)
    return rho * eps


tpss_x.needs_tau = True
tpss_c.needs_tau = True


# ------------------------------------------------------------------- SCAN

def _scan_interp(alpha, c1, c2, d):
    """SCAN's alpha interpolation f(alpha): exp(-c1 a/(1-a)) below a=1,
    -d exp(c2/(1-a)) above. Each branch's input is clamped so the branch
    not taken stays finite under autograd: by 1e-9 as in the reference, or
    by the dtype's epsilon where 1 -+ 1e-9 rounds to 1 (float32, whose
    branches would otherwise divide by zero and give a NaN potential)."""
    margin = max(1e-9, torch.finfo(alpha.dtype).eps)
    a_lt = _min(alpha, 1.0 - margin)
    a_gt = _max(alpha, 1.0 + margin)
    f_lt = torch.exp(-c1 * a_lt / (1.0 - a_lt))
    f_gt = -d * torch.exp(c2 / (1.0 - a_gt))
    return torch.where(alpha < 1.0, f_lt, f_gt)


def _scan_fx(r2, g2, t2):
    """SCAN exchange enhancement for an unpolarized density
    (Sun, Ruzsinszky & Perdew, PRL 115, 036402 (2015), Eqs. 1-2 and the
    supplemental parametrisation)."""
    k1, c1x, c2x, dx = 0.065, 0.667, 0.8, 1.24
    mu_ak = 10.0 / 81.0
    b2 = np.sqrt(5913.0 / 405000.0)
    b1 = (511.0 / 13500.0) / (2.0 * b2)
    b3 = 0.5
    b4 = mu_ak**2 / k1 - 1606.0 / 18225.0 - b1**2
    a1 = 4.9479
    h0x = 1.174

    r2 = _safe(r2)
    g2 = _max(g2, 0.0)
    u = g2 / (r2 * r2)
    p = u * r2 ** (-2.0 / 3.0) / (4.0 * (3.0 * np.pi**2) ** (2.0 / 3.0))
    p = _clip(p, 0.0, 1.0e4)
    tau_w = 0.125 * u * r2
    tau_unif = 0.3 * (3.0 * np.pi**2) ** (2.0 / 3.0) * r2 ** (5.0 / 3.0)
    t2 = _max(t2, tau_w)
    alpha = _clip((t2 - tau_w) / _max(tau_unif, 1e-30), 0.0, 1e6)

    one_ma = 1.0 - alpha
    x = (mu_ak * p
         * (1.0 + (b4 * p / mu_ak) * torch.exp(-abs(b4) * p / mu_ak))
         + (b1 * p + b2 * one_ma * torch.exp(-b3 * one_ma * one_ma)) ** 2)
    h1x = 1.0 + k1 - k1 / (1.0 + x / k1)
    gx = 1.0 - torch.exp(-a1 / torch.sqrt(torch.sqrt(_max(p, _TINY ** 2))))
    fx_a = _scan_interp(alpha, c1x, c2x, dx)
    return (h1x + fx_a * (h0x - h1x)) * gx


def scan_x(ra, rb, gaa, gab, gbb, ta, tb):
    """SCAN meta-GGA exchange, spin-scaled like :func:`tpss_x`."""

    def per_spin(r, g, t):
        r2 = 2.0 * _safe(r)
        kf = (3.0 * np.pi**2 * r2) ** (1.0 / 3.0)
        lda = -(3.0 / (4.0 * np.pi)) * kf * r2
        return 0.5 * lda * _scan_fx(r2, 4.0 * _max(g, 0.0), 2.0 * t)

    return per_spin(ra, gaa, ta) + per_spin(rb, gbb, tb)


def scan_c(ra, rb, gaa, gab, gbb, ta, tb):
    """SCAN meta-GGA correlation (PRL 115, 036402 (2015), supplemental):
    eps_c = eps_c1 + f_c(alpha) (eps_c0 - eps_c1)."""
    b1c, b2c, b3c = 0.0285764, 0.0889, 0.125541
    c1c, c2c, dc = 0.64, 1.5, 0.7
    chi_inf = 0.128026
    gamma = 0.031091

    # the TOTAL density is floored, not each spin (one-electron limit)
    rho = _safe(ra + rb)
    zeta = _clip_zeta((ra - rb) / rho)
    rs = (3.0 / (4.0 * np.pi * rho)) ** (1.0 / 3.0)
    gnorm2 = _max(gaa + 2.0 * gab + gbb, 0.0)
    u = gnorm2 / (rho * rho)
    s2 = u * rho ** (-2.0 / 3.0) / (4.0 * (3.0 * np.pi**2) ** (2.0 / 3.0))
    s2 = _clip(s2, 0.0, 1.0e6)

    # alpha with the spin factor d_s(zeta)
    tau = _max(ta + tb, 0.0)
    tau_w = 0.125 * u * rho
    tau_unif = 0.3 * (3.0 * np.pi**2) ** (2.0 / 3.0) * rho ** (5.0 / 3.0)
    ds_z = 0.5 * ((1.0 + zeta) ** (5.0 / 3.0) + (1.0 - zeta) ** (5.0 / 3.0))
    alpha = _clip(
        (_max(tau, tau_w) - tau_w) / _max(tau_unif * ds_z, 1e-30),
        0.0, 1e6,
    )

    # eps_c1: revised PBE with rs-dependent beta and w1 resummation
    phi = 0.5 * ((1.0 + zeta) ** (2.0 / 3.0) + (1.0 - zeta) ** (2.0 / 3.0))
    ks = torch.sqrt(4.0 * (3.0 / np.pi) ** (1.0 / 3.0) * rho ** (1.0 / 3.0))
    t2 = u / (2.0 * phi * ks) ** 2
    beta_rs = 0.066725 * (1.0 + 0.1 * rs) / (1.0 + 0.1778 * rs)
    eps_lsda = _pw92_eps(rs, zeta)
    gp3 = gamma * phi**3
    w1 = torch.expm1(-eps_lsda / gp3)
    a_coef = beta_rs / (gamma * _max(w1, 1e-30))
    g_at2 = (1.0 + 4.0 * a_coef * t2) ** (-0.25)
    h1 = gp3 * torch.log1p(w1 * (1.0 - g_at2))
    eps_c1 = eps_lsda + h1

    # eps_c0: single-orbital / low-density limit
    eps_lda0 = -b1c / (1.0 + b2c * torch.sqrt(rs) + b3c * rs)
    w0 = torch.expm1(-eps_lda0 / b1c)
    g_inf = (1.0 + 4.0 * chi_inf * s2) ** (-0.25)
    h0 = b1c * torch.log1p(w0 * (1.0 - g_inf))
    dx_z = 0.5 * ((1.0 + zeta) ** (4.0 / 3.0) + (1.0 - zeta) ** (4.0 / 3.0))
    gc_z = (1.0 - 2.3631 * (dx_z - 1.0)) * (1.0 - zeta**12)
    eps_c0 = (eps_lda0 + h0) * gc_z

    fc_a = _scan_interp(alpha, c1c, c2c, dc)
    return rho * (eps_c1 + fc_a * (eps_c0 - eps_c1))


scan_x.needs_tau = True
scan_c.needs_tau = True


# ------------------------------------------------- B97 family (wB97/wB97X)

def _b97_series(u, coefs):
    """Power-series inhomogeneity correction factor sum_i c_i u^i."""
    acc = torch.zeros_like(u)
    up = torch.ones_like(u)
    for c in coefs:
        acc = acc + c * up
        up = up * u
    return acc


def _b97_u(x2, gamma):
    """B97 variable u = gamma x^2 / (1 + gamma x^2) in [0, 1)."""
    gx2 = gamma * x2
    return gx2 / (1.0 + gx2)


def _b97_x2(r, g):
    """x_sigma^2 = sigma_ss / rho_s^{8/3}, in the reference's factoring."""
    r = _safe(r)
    return (_max(g, 0.0) / (r * r)) * r ** (-2.0 / 3.0)


def b97_sr_x(coefs, omega: float, gamma: float = 0.004):
    """Becke-97-style short-range exchange: per-spin SR-LDA exchange (the
    ITYH factor at a = omega/(2 k_F,sigma)) times the power-series ICF.
    omega=0 is full-range B97 exchange."""
    cx = (3.0 / 4.0) * (3.0 / np.pi) ** (1.0 / 3.0) * 2.0 ** (1.0 / 3.0)
    k_fac = 2.0 * cx  # e_LDA = -1/2 r^{4/3} K  =>  K = 2 cx

    def fn(ra, rb, gaa, gab, gbb):
        def per_spin(r, g):
            r = _safe(r)
            e_lda = -cx * r ** (4.0 / 3.0)
            if omega:
                a = (omega * np.sqrt(k_fac) / (6.0 * np.sqrt(np.pi))
                     * r ** (-1.0 / 3.0))
                e_lda = e_lda * _ityh_attenuation(a)
            return e_lda * _b97_series(_b97_u(_b97_x2(r, g), gamma), coefs)

        return per_spin(ra, gaa) + per_spin(rb, gbb)

    return fn


def b97_c(css, cos, g_ss: float = 0.2, g_os: float = 0.006):
    """Becke-97-style correlation: PW92 LSDA split into same-spin and
    opposite-spin pieces (Stoll partition), each times its own power-series
    ICF."""

    def fn(ra, rb, gaa, gab, gbb):
        ra_, rb_ = _safe(ra), _safe(rb)

        def e_polarized(r):
            rs = (3.0 / (4.0 * np.pi * r)) ** (1.0 / 3.0)
            return r * _pw92_eps(rs, 1.0 - 1e-12)

        e_aa = e_polarized(ra_)
        e_bb = e_polarized(rb_)
        e_os = pw92_c(ra, rb, gaa, gab, gbb) - e_aa - e_bb
        x2a = _b97_x2(ra_, gaa)
        x2b = _b97_x2(rb_, gbb)
        return (e_aa * _b97_series(_b97_u(x2a, g_ss), css)
                + e_bb * _b97_series(_b97_u(x2b, g_ss), css)
                + e_os * _b97_series(_b97_u(0.5 * (x2a + x2b), g_os), cos))

    return fn


# wB97 / wB97X parameter sets (Chai & Head-Gordon, JCP 128, 084106 (2008),
# Tables 1-2), without the -D/-V dispersion tails
_WB97X_CX = (0.842294, 0.726479, 1.04760, -5.70635, 13.2794)
_WB97X_CSS = (1.000000, -4.33879, 18.2308, -31.7430, 17.2901)
_WB97X_COS = (1.000000, -2.37368, 2.48687, -12.1768, 25.7759)
_WB97_CX = (1.000000, 1.13116, -2.74915, 12.0900, -5.71642)
_WB97_CSS = (1.000000, -2.55352, 11.8926, -26.9452, 17.0147)
_WB97_COS = (1.000000, 3.99051, -17.0066, 1.07292, 8.88211)


# ------------------------------------------------------------------ registry

# name -> (terms [(coef, fn)], hyb fraction of HF exchange) or
#         (terms, hyb, (beta, omega)) for range-separated hybrids, whose exact
#         exchange is hyb*K + beta*K_LR(omega) with K_LR from the long-range
#         erf(omega*r12)/r12 ERIs
FUNCTIONALS = {
    "hf": ([], 1.0),
    "lda": ([(1.0, slater_x), (1.0, vwn5_c)], 0.0),
    "svwn": ([(1.0, slater_x), (1.0, vwn5_c)], 0.0),
    "blyp": ([(1.0, b88_x), (1.0, lyp_c)], 0.0),
    # canonical B3LYP: 0.20 HF + 0.08 Slater + 0.72 B88(full) + 0.81 LYP
    # + 0.19 VWN; PySCF>=2.3 'b3lyp' = VWN-RPA, 'b3lyp5' = VWN5
    "b3lyp": (
        [(0.08, slater_x), (0.72, b88_x), (0.81, lyp_c), (0.19, vwn_rpa_c)],
        0.20,
    ),
    "b3lyp5": (
        [(0.08, slater_x), (0.72, b88_x), (0.81, lyp_c), (0.19, vwn5_c)],
        0.20,
    ),
    "pbe": ([(1.0, pbe_x), (1.0, pbe_c)], 0.0),
    "pbe0": ([(0.75, pbe_x), (1.0, pbe_c)], 0.25),
    # meta-GGA (tau-dependent): TPSS and its 10%-exact-exchange hybrid
    "tpss": ([(1.0, tpss_x), (1.0, tpss_c)], 0.0),
    "tpssh": ([(0.90, tpss_x), (1.0, tpss_c)], 0.10),
    # SCAN meta-GGA and its 25% hybrid
    "scan": ([(1.0, scan_x), (1.0, scan_c)], 0.0),
    "scan0": ([(0.75, scan_x), (1.0, scan_c)], 0.25),
    # wB97X: SR-B97 exchange + B97 correlation; exact exchange 0.157706
    # full-range + 0.842294 long-range(0.3)
    "wb97x": (
        [(1.0, b97_sr_x(_WB97X_CX, 0.3)), (1.0, b97_c(_WB97X_CSS, _WB97X_COS))],
        0.157706,
        (0.842294, 0.3),
    ),
    # wB97: 100% long-range exact exchange (omega=0.4), no SR fraction
    "wb97": (
        [(1.0, b97_sr_x(_WB97_CX, 0.4)), (1.0, b97_c(_WB97_CSS, _WB97_COS))],
        0.0,
        (1.0, 0.4),
    ),
    "pw92": ([(1.0, slater_x), (1.0, pw92_c)], 0.0),
    # double hybrids: the SCF part is an ordinary global hybrid; the PT2
    # correlation (coefficient in DH_PT2) is added on the converged KS
    # orbitals by solvers.run_double_hybrid. B2PLYP: JCP 124, 034108
    # (2006); B2GP-PLYP: JPCA 112, 12868 (2008)
    "b2plyp": ([(0.47, b88_x), (0.73, lyp_c)], 0.53),
    "b2gpplyp": ([(0.35, b88_x), (0.64, lyp_c)], 0.65),
    # CAM-B3LYP (Yanai-Tew-Handy, CPL 393, 51 (2004)): exact exchange 0.19
    # full-range + 0.46 long-range(omega=0.33); DFT exchange 0.35 B88 +
    # 0.46 SR-B88 (ITYH); correlation 0.19 VWN5 + 0.81 LYP
    "camb3lyp": (
        [
            (0.35, b88_x),
            (0.46, ityh_sr_x(b88_x, 0.33)),
            (0.19, vwn5_c),
            (0.81, lyp_c),
        ],
        0.19,
        (0.46, 0.33),
    ),
    # LC-BLYP: 100% HF exchange at long range, SR-B88 at short range, LYP
    "lcblyp": (
        [(1.0, ityh_sr_x(b88_x, 0.33)), (1.0, lyp_c)],
        0.0,
        (1.0, 0.33),
    ),
}


DH_PT2 = {"b2plyp": 0.27, "b2gpplyp": 0.36}


def pt2_coefficient(name) -> float:
    """PT2 weight of a double-hybrid functional, or 0.0 for everything else
    (the SCF alone is then the complete functional)."""
    if name is None:
        return 0.0
    return DH_PT2.get(name.strip().lower().replace("-", ""), 0.0)


# ------------------------------------------------- composition parser

# primitive names usable in composition strings. Exchange and correlation
# tables are separate because "X_part,C_part" strings resolve bare names by
# side; side-ambiguous families (PBE, TPSS) need an x/c suffix without a
# comma ("pbex"/"pbec")
_X_PRIMITIVES = {
    "slater": slater_x, "lda": slater_x, "s": slater_x, "xalpha": slater_x,
    "b88": b88_x, "becke88": b88_x, "b": b88_x,
    "pbe": pbe_x,
    "tpss": tpss_x,
}
_C_PRIMITIVES = {
    "vwn": vwn5_c, "vwn5": vwn5_c,
    "vwnrpa": vwn_rpa_c, "vwn_rpa": vwn_rpa_c,
    "lyp": lyp_c,
    "pbe": pbe_c,
    "pw92": pw92_c, "pw": pw92_c,
    "tpss": tpss_c,
}

_TERM_RE = re.compile(
    r"(?P<sign>[+-]?)"
    r"(?:(?P<coef>\d*\.?\d+(?:e[+-]?\d+)?)\*?)?"
    r"(?P<name>[a-z][a-z0-9_]*)"
    r"(?:\((?P<args>[^)]*)\))?"
)

# families that are recognised but have no primitives here, with the hint
# the unknown-name KeyError carries
_FAMILY_HINTS = {
    ("m05", "m06", "m08", "m11", "mn12", "mn15"):
        "the Minnesota meta-GGAs need VS98-type kinetic-energy"
        "-density power series not shipped here; the closest "
        "supported meta-GGA hybrids are 'scan0', 'tpssh' and "
        "the range-separated 'wb97x'",
    ("b97d", "b97"):
        "the B97 power-series GGA family is shipped only in "
        "its range-separated wB97/wB97X forms; for a "
        "dispersion-oriented GGA try 'blyp' or 'pbe'",
    ("revtpss", "rtpss"):
        "only the original TPSS is shipped ('tpss', 'tpssh'); "
        "revTPSS's revised C(zeta,xi) is not",
    ("hse", "hse06", "hse03"):
        "screened (SR-only) exact exchange is not supported; "
        "supported range separation is LR-corrected "
        "('camb3lyp', 'wb97x', 'lcblyp')",
}


def parse_composition(spec: str):
    """Parse a libxc/PySCF-style linear-combination XC string.

    Grammar (case-insensitive, whitespace ignored)::

        composition := side [',' side]     # with a comma: X side , C side
        side        := term (('+'|'-') term)*
        term        := [coef '*'] name ['(' omega ')']

    Components: ``HF``/``EXX`` (exact exchange), ``LR_HF(omega)`` and
    ``SR_HF(omega)``, ``SR_<X>(omega)`` (ITYH short-range DFT exchange),
    the exchange and correlation primitives, and, without a comma, the
    registered compound names. Returns ``(terms, hyb, rsh)`` in the
    :func:`resolve_functional` contract; raises ``ValueError`` on malformed
    input (unknown component, ambiguous side, mixed omegas).
    """
    flat = "".join(spec.split()).lower()
    if not flat:
        raise ValueError("empty XC composition string")
    sides = flat.split(",")
    if len(sides) > 2:
        raise ValueError(
            f"XC composition {spec!r} has {len(sides) - 1} commas; at most "
            "one ('X_part,C_part') is allowed."
        )

    terms, hyb, beta = [], 0.0, 0.0
    omegas = set()

    def need_omega(name, args):
        if not args:
            raise ValueError(
                f"range-separated component '{name}' needs an omega "
                f"argument, e.g. '{name}(0.33)'"
            )
        w = float(args)
        omegas.add(w)
        return w

    def resolve_name(name, args, side):
        """One component with unit coefficient -> (terms, d_hyb, d_beta)."""
        if name in ("hf", "exx"):
            return [], 1.0, 0.0
        if name in ("lr_hf", "lrhf"):
            need_omega(name, args)
            return [], 0.0, 1.0
        if name in ("sr_hf", "srhf"):
            need_omega(name, args)
            return [], 1.0, -1.0
        if name.startswith("sr_") and side != "c":
            base = _X_PRIMITIVES.get(name[3:])
            if base is not None:
                w = need_omega(name, args)
                return [(1.0, ityh_sr_x(base, w))], 0.0, 0.0
        if side == "x":
            fn = _X_PRIMITIVES.get(name) or _X_PRIMITIVES.get(
                name.removesuffix("x").removesuffix("_"))
            if fn is None:
                raise ValueError(
                    f"unknown exchange component '{name}'; have "
                    f"{sorted(set(_X_PRIMITIVES))} (+ HF/LR_HF/SR_HF/SR_<X>)"
                )
            return [(1.0, fn)], 0.0, 0.0
        if side == "c":
            fn = _C_PRIMITIVES.get(name) or _C_PRIMITIVES.get(
                name.removesuffix("c").removesuffix("_"))
            if fn is None:
                raise ValueError(
                    f"unknown correlation component '{name}'; have "
                    f"{sorted(set(_C_PRIMITIVES))}"
                )
            return [(1.0, fn)], 0.0, 0.0
        # comma-less: compound registry first, then side-unique primitives
        key = name.replace("_", "")
        if key in FUNCTIONALS:
            sub_terms, sub_hyb, sub_rsh = resolve_functional(key)
            d_beta = 0.0
            if sub_rsh is not None:
                d_beta = sub_rsh[0]
                omegas.add(sub_rsh[1])
            return list(sub_terms), sub_hyb, d_beta
        in_x = name in _X_PRIMITIVES
        in_c = name in _C_PRIMITIVES
        if in_x and in_c:
            raise ValueError(
                f"component '{name}' is both an exchange and a correlation "
                f"primitive; disambiguate with '{name}x'/'{name}c' or use "
                "the 'X_part,C_part' comma form."
            )
        if in_x:
            return [(1.0, _X_PRIMITIVES[name])], 0.0, 0.0
        if in_c:
            return [(1.0, _C_PRIMITIVES[name])], 0.0, 0.0
        if name.endswith("x") and name[:-1] in _X_PRIMITIVES:
            return [(1.0, _X_PRIMITIVES[name[:-1]])], 0.0, 0.0
        if name.endswith("c") and name[:-1] in _C_PRIMITIVES:
            return [(1.0, _C_PRIMITIVES[name[:-1]])], 0.0, 0.0
        raise ValueError(
            f"unknown XC component '{name}'; have compounds "
            f"{sorted(FUNCTIONALS)}, exchange {sorted(set(_X_PRIMITIVES))}, "
            f"correlation {sorted(set(_C_PRIMITIVES))}"
        )

    for part, side in zip(sides, ("x", "c") if len(sides) == 2 else (None,)):
        if not part:
            continue  # empty side, e.g. "b88," (exchange only)
        pos = 0
        for m in _TERM_RE.finditer(part):
            if m.start() != pos:
                raise ValueError(
                    f"could not parse XC composition {spec!r} at "
                    f"'{part[pos:]}'"
                )
            pos = m.end()
            coef = float(m.group("coef") or 1.0)
            if m.group("sign") == "-":
                coef = -coef
            sub, d_hyb, d_beta = resolve_name(
                m.group("name"), m.group("args"), side)
            terms.extend((coef * c, f) for c, f in sub)
            hyb += coef * d_hyb
            beta += coef * d_beta
        if pos != len(part):
            raise ValueError(
                f"could not parse XC composition {spec!r} at '{part[pos:]}'"
            )

    if len(omegas) > 1:
        raise ValueError(
            f"XC composition {spec!r} mixes range-separation omegas "
            f"{sorted(omegas)}; a single omega is required (the exchange "
            "kernel is folded as hyb*K + beta*K_LR(omega))."
        )
    rsh = (beta, omegas.pop()) if beta and omegas else None
    return terms, hyb, rsh


def resolve_functional(name: str):
    """(terms, hyb, rsh) for a functional name (case-insensitive).

    ``rsh`` is None for global hybrids and pure functionals, or
    ``(beta, omega)`` for range-separated hybrids, whose exact exchange
    enters the Fock matrix as ``hyb*K + beta*K_LR(omega)``. Unregistered
    names are tried as composition strings (:func:`parse_composition`); a
    name that is neither raises ``KeyError``, with a hint for the families
    that have no primitives here.
    """
    key = name.strip().lower().replace("-", "")
    try:
        entry = FUNCTIONALS[key]
    except KeyError:
        try:
            return parse_composition(name)
        except ValueError as exc:
            hint = next((h for fam, h in _FAMILY_HINTS.items()
                         if any(key.startswith(f) for f in fam)), None)
            hint_txt = f" Note: {hint}." if hint else ""
            raise KeyError(
                f"XC functional '{name}' is not a registered name and did "
                f"not parse as a composition string ({exc}).{hint_txt} "
                f"Registered names: {sorted(FUNCTIONALS)}. Composition "
                "strings combine exchange primitives "
                f"{sorted(_X_PRIMITIVES)} and correlation primitives "
                f"{sorted(_C_PRIMITIVES)} with HF/EXX, LR_HF(omega), "
                "SR_HF(omega) and SR_<X>(omega) terms, e.g. "
                "'0.2*HF + 0.08*SLATER + 0.72*B88, 0.81*LYP + 0.19*VWN_RPA'."
            ) from exc
    if len(entry) == 2:
        return entry[0], entry[1], None
    return entry
