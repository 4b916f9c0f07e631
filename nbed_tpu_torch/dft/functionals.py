"""Spin-resolved exchange-correlation energy densities in torch (port of the
B3LYP terms of ``nbed_tpu/dft/functionals.py``).

Each functional maps ``(rho_a, rho_b, gaa, gab, gbb) -> energy / volume``
where ``g__`` are contracted density gradients. Potentials come from
``torch.autograd`` in :mod:`nbed_tpu_torch.dft.xc`. Conventions match
libxc/PySCF: ``b3lyp`` uses VWN-RPA correlation, ``b3lyp5`` VWN5.

Only the terms of ``b3lyp`` and ``b3lyp5`` are ported; every other name
raises (ROADMAP queue 1 item 8: the rest of the functional surface).
"""

import numpy as np
import torch

__all__ = ["FUNCTIONALS", "resolve_functional"]

# density floor of the reference's CPU branch (functionals.py:22-40); its
# coarser TPU floor exists only for emulated float64 and is not ported
_TINY = 1e-12


def _safe(rho):
    return torch.clamp_min(rho, _TINY)


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
        chi = torch.sqrt(torch.clamp_min(g, 0.0)) / r43
        lda = -(3.0 / 4.0) * (3.0 / np.pi) ** (1.0 / 3.0) * 2.0 ** (1.0 / 3.0) * r43
        corr = -beta * r43 * chi * chi / (1.0 + 6.0 * beta * chi * torch.asinh(chi))
        return lda + corr

    return per_spin(ra, gaa) + per_spin(rb, gbb)


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
        zeta = torch.clamp((ra - rb) / rho, -1.0 + 1e-15, 1.0 - 1e-15)
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


# name -> (terms [(coef, fn)], HF-exchange fraction)
FUNCTIONALS = {
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
}


def resolve_functional(name: str):
    """(terms, hyb, rsh) for a functional name (case-insensitive); ``rsh`` is
    always None among the ported functionals."""
    key = name.strip().lower().replace("-", "")
    try:
        terms, hyb = FUNCTIONALS[key]
    except KeyError as exc:
        raise NotImplementedError(
            f"XC functional {name!r} is not ported yet (have {sorted(FUNCTIONALS)}): "
            "ROADMAP queue 1 item 8 (the rest of the functional surface)."
        ) from exc
    return terms, hyb, None
