"""The reference's exchange-correlation energy: the molecular grid the
port's default "reference" scheme defines (Treutler-Ahlrichs M4 radial
shells, NWChem-pruned Lebedev spheres, Becke partition with Treutler's
size adjustment, per-element sizes at a grid level), the functionals
B3LYP (VWN-RPA) and B3LYP5 (VWN5), and E_xc of a closed-shell density,
whose potential is its gradient in the density matrix (autograd)."""

import itertools
import math

import numpy as np
import torch

from .lebedev_data import LEBEDEV_PARAMS

__all__ = ["Grid", "build_grid", "ao_on_grid", "XCFunctional", "XCEnergy", "FUNCTIONALS"]

# Bragg-Slater radii in angstrom by nuclear charge (the port's grid table)
_BRAGG = {1: 0.35, 6: 0.70, 7: 0.65, 8: 0.60, 9: 0.50}
_ANGSTROM_TO_BOHR = 1.0 / 0.52917721092
# radial shells and Lebedev degree by grid level, for rows 1 and 2
_N_RAD = {0: (10, 15), 1: (30, 40), 2: (40, 60), 3: (50, 75), 4: (60, 90)}
_DEGREE = {0: (11, 15), 1: (17, 23), 2: (23, 29), 3: (29, 29), 4: (35, 41)}
_DEGREE_POINTS = {11: 50, 15: 86, 17: 110, 23: 194, 29: 302, 35: 434, 41: 590}
_NWCHEM = (38, 50, 74, 86, 110, 146, 170, 194, 230, 266, 302, 350, 434, 590)


def _lebedev(n):
    """(points (n, 3), weights summing to 1) of the n-point rule."""
    _, spec, par = LEBEDEV_PARAMS[n]
    s2, s3 = 1 / math.sqrt(2), 1 / math.sqrt(3)
    pts, wts = [], []
    signs = list(itertools.product((1.0, -1.0), repeat=3))

    def orbit(vectors, w):
        uniq = {tuple(round(c, 15) for c in v): v for v in vectors}
        pts.extend(uniq.values())
        wts.extend([w] * len(uniq))

    i = 0
    if spec.get("a1"):
        orbit([tuple(s * (ax == k) for k in range(3)) for ax in range(3) for s in (1.0, -1.0)],
              par[i])
        i += 1
    if spec.get("a2"):
        vs = []
        for ax in range(3):
            for si, sj in itertools.product((1.0, -1.0), repeat=2):
                v = [0.0, 0.0, 0.0]
                a, b = [k for k in range(3) if k != ax]
                v[a], v[b] = si * s2, sj * s2
                vs.append(tuple(v))
        orbit(vs, par[i])
        i += 1
    if spec.get("a3"):
        orbit([(a * s3, b * s3, c * s3) for a, b, c in signs], par[i])
        i += 1
    for _ in range(spec.get("nb", 0)):
        l = par[i]
        m = math.sqrt(max(1 - 2 * l * l, 0.0))
        vs = []
        for ax in range(3):
            for sg in signs:
                v = [l, l, l]
                v[ax] = m
                vs.append(tuple(c * s for c, s in zip(v, sg)))
        orbit(vs, par[i + 1])
        i += 2
    for _ in range(spec.get("nc", 0)):
        q = par[i]
        r = math.sqrt(max(1 - q * q, 0.0))
        vs = []
        for ax in range(3):
            a, b = [k for k in range(3) if k != ax]
            for u, v_ in ((q, r), (r, q)):
                for si, sj in itertools.product((1.0, -1.0), repeat=2):
                    v = [0.0, 0.0, 0.0]
                    v[a], v[b] = si * u, sj * v_
                    vs.append(tuple(v))
        orbit(vs, par[i + 1])
        i += 2
    for _ in range(spec.get("nd", 0)):
        r, s = par[i], par[i + 1]
        t = math.sqrt(max(1 - r * r - s * s, 0.0))
        vs = [tuple(c * g for c, g in zip(perm, sg))
              for perm in itertools.permutations((r, s, t)) for sg in signs]
        orbit(vs, par[i + 2])
        i += 3
    pts, wts = np.array(pts), np.array(wts)
    if len(pts) != n:
        raise ValueError(f"Lebedev rule {n} gave {len(pts)} points")
    return pts, wts


def _radial(n):
    """Treutler-Ahlrichs M4 radii and weights 4 pi r^2 dr on Chebyshev
    abscissas of the second kind."""
    i = np.arange(1, n + 1)
    step = math.pi / (n + 1)
    x = np.cos(i * step)
    ln2 = math.log(2.0)
    r = -(1 / ln2) * (1 + x) ** 0.6 * np.log((1 - x) / 2)
    dr = step * np.sin(i * step) / ln2 * (1 + x) ** 0.6 * (
        -0.6 / (1 + x) * np.log((1 - x) / 2) + 1 / (1 - x))
    return r, 4 * math.pi * r ** 2 * dr


def _pruned(z, r, n_ang):
    """NWChem pruning: the Lebedev size of each radial shell."""
    if n_ang < 50:
        return np.full(len(r), n_ang)
    alphas = ((0.25, 0.5, 1.0, 4.5), (0.1667, 0.5, 0.9, 3.5))[0 if z <= 2 else 1]
    if n_ang == 50:
        levels = np.array([1, 2, 2, 2, 1])
    else:
        k = _NWCHEM.index(n_ang)
        levels = np.array([1, 3, k - 1, k, k])
    place = (r[:, None] / (_BRAGG[z] * _ANGSTROM_TO_BOHR) > np.array(alphas)[None]).sum(1)
    return np.array(_NWCHEM)[levels[place]]


class Grid:
    """Points (G, 3) and weights (G,) of the molecular grid."""

    def __init__(self, points, weights):
        self.points, self.weights = points, weights


def build_grid(charges, coords, level=3, dtype=torch.float64, device="cpu"):
    rel, base, owner = [], [], []
    for ia, z in enumerate(charges):
        row = 0 if z <= 2 else 1
        n_rad, degree = _N_RAD[level][row], _DEGREE[level][row]
        r, wr = _radial(n_rad)
        r, wr = r[::-1], wr[::-1]
        for ri, wi, na in zip(r, wr, _pruned(int(z), r, _DEGREE_POINTS[degree])):
            p, w = _lebedev(int(na))
            rel.append(ri * p)
            base.append(wi * w)
            owner.append(np.full(len(w), ia))
    rel, base, owner = np.concatenate(rel), np.concatenate(base), np.concatenate(owner)
    points = rel + coords[owner]
    # Becke partition, k = 3, with Treutler's adjustment on sqrt(radii)
    natm = len(charges)
    radii = np.array([_BRAGG[int(z)] * _ANGSTROM_TO_BOHR for z in charges])
    chi = np.sqrt(radii)[:, None] / np.sqrt(radii)[None, :]
    a = np.clip(0.25 * (1 / chi - chi), -0.5, 0.5)
    rij = np.linalg.norm(coords[:, None] - coords[None], axis=-1) + np.eye(natm)
    weights = np.empty(len(points))
    for s in range(0, len(points), 20000):
        pts = points[s:s + 20000]
        d = np.linalg.norm(pts[:, None, :] - coords[None], axis=-1)
        mu = (d[:, :, None] - d[:, None, :]) / rij[None]
        nu = mu + a[None] * (1 - mu * mu)
        for _ in range(3):
            nu = 0.5 * nu * (3 - nu * nu)
        cell = 0.5 * (1 - nu)
        cell[:, np.arange(natm), np.arange(natm)] = 1.0
        prod = cell.prod(axis=2)
        weights[s:s + 20000] = prod[np.arange(len(pts)), owner[s:s + 20000]] / prod.sum(1)
    t = lambda x: torch.as_tensor(x, dtype=dtype, device=device)  # noqa: E731
    return Grid(t(points), t(base * weights))


def ao_on_grid(basis, points):
    """(values (G, nao), gradients (3, G, nao)) of the basis at the points."""
    dtype, device = points.dtype, points.device
    centers = torch.as_tensor(basis.coords[basis.center], dtype=dtype, device=device)
    alpha = torch.as_tensor(basis.alpha, dtype=dtype, device=device)
    powers = torch.as_tensor(basis.powers, dtype=dtype, device=device)
    coef = torch.as_tensor(basis.coef, dtype=dtype, device=device)
    to_ao = torch.zeros((len(basis.alpha), basis.nao), dtype=dtype, device=device)
    to_ao[torch.arange(len(basis.alpha)), torch.as_tensor(basis.ao, device=device)] = coef
    vals, grads = [], []
    for s in range(0, points.shape[0], 16384):
        d = points[s:s + 16384, None, :] - centers[None]           # (g, nprim, 3)
        g = torch.exp(-alpha * (d * d).sum(-1))
        mono = torch.where(powers[None] > 0, d, torch.ones_like(d))  # x^1 or x^0
        poly = mono.prod(-1)
        vals.append(poly * g @ to_ao)
        grad = []
        for k in range(3):
            others = [j for j in range(3) if j != k]
            # d/dx of x^l (l <= 1) times the other two monomials
            dpoly = powers[None, :, k] * mono[..., others[0]] * mono[..., others[1]]
            grad.append((dpoly - 2 * alpha * d[..., k] * poly) * g @ to_ao)
        grads.append(torch.stack(grad))
    return torch.cat(vals), torch.cat(grads, dim=1)


# ----------------------------------------------------------- functionals

_FLOOR = 1e-12
_CX = 0.75 * (3 / math.pi) ** (1 / 3) * 2 ** (1 / 3)


def _slater(ra, rb, gaa, gab, gbb):
    return -_CX * (ra ** (4 / 3) + rb ** (4 / 3))


def _b88(ra, rb, gaa, gab, gbb):
    beta = 0.0042

    def spin(r, g):
        r43 = r ** (4 / 3)
        x = torch.sqrt(torch.clamp(g, min=1e-30)) / r43  # finite slope at g = 0
        return -_CX * r43 - beta * r43 * x * x / (1 + 6 * beta * x * torch.asinh(x))

    return spin(ra, gaa) + spin(rb, gbb)


_VWN5 = {"P": (0.0310907, -0.10498, 3.72744, 12.9352),
         "F": (0.01554535, -0.32500, 7.06042, 18.0578),
         "A": (-1 / (6 * math.pi ** 2), -0.00475840, 1.13107, 13.0045)}
_VWN_RPA = {"P": (0.0310907, -0.409286, 13.0720, 42.7198),
            "F": (0.01554535, -0.743294, 20.1231, 101.578),
            "A": (-1 / (6 * math.pi ** 2), -0.228344, 1.06835, 11.4813)}


def _vwn_fit(x, a, x0, b, c):
    q = math.sqrt(4 * c - b * b)
    big_x = x * x + b * x + c
    x0x = x0 * x0 + b * x0 + c
    at = torch.atan(q / (2 * x + b))
    return a * (torch.log(x * x / big_x) + 2 * b / q * at
                - b * x0 / x0x * (torch.log((x - x0) ** 2 / big_x) + 2 * (b + 2 * x0) / q * at))


def _vwn(params):
    def fn(ra, rb, gaa, gab, gbb):
        rho = ra + rb
        zeta = torch.clamp((ra - rb) / rho, -1 + 1e-15, 1 - 1e-15)
        x = torch.sqrt((3 / (4 * math.pi * rho)) ** (1 / 3))
        ep, ef, ea = (_vwn_fit(x, *params[k]) for k in "PFA")
        fz = ((1 + zeta) ** (4 / 3) + (1 - zeta) ** (4 / 3) - 2) / (2 ** (4 / 3) - 2)
        fpp = 8 / (9 * (2 ** (4 / 3) - 2))
        z4 = zeta ** 4
        return rho * (ep + ea * fz / fpp * (1 - z4) + (ef - ep) * fz * z4)
    return fn


def _lyp(ra, rb, gaa, gab, gbb):
    a, b, c, d = 0.04918, 0.132, 0.2533, 0.349
    cf = 0.3 * (3 * math.pi ** 2) ** (2 / 3)
    rho = ra + rb
    rm = rho ** (-1 / 3)
    den = 1 + d * rm
    omega = torch.exp(-c * rm - 11 / 3 * torch.log(rho)) / den
    delta = c * rm + d * rm / den
    gt = gaa + 2 * gab + gbb
    inner = (2 ** (11 / 3) * cf * (ra ** (8 / 3) + rb ** (8 / 3))
             + (47 / 18 - 7 * delta / 18) * gt - (2.5 - delta / 18) * (gaa + gbb)
             - (delta - 11) / 9 * (ra * gaa + rb * gbb) / rho)
    return (-4 * a / den * ra * rb / rho
            - a * b * omega * (ra * rb * inner - 2 / 3 * rho ** 2 * gt
                               + (2 / 3 * rho ** 2 - ra ** 2) * gbb
                               + (2 / 3 * rho ** 2 - rb ** 2) * gaa))


class XCFunctional:
    """A global hybrid: weighted semilocal terms and the exact-exchange share."""

    def __init__(self, terms, hyb):
        self.terms, self.hyb = terms, hyb

    def energy_density(self, rho, sigma):
        """Closed shell: each spin carries half the density."""
        ra = torch.clamp(0.5 * rho, min=_FLOOR)
        g = 0.25 * sigma
        return sum(w * f(ra, ra, g, g, g) for w, f in self.terms)


FUNCTIONALS = {
    "b3lyp": XCFunctional([(0.08, _slater), (0.72, _b88), (0.81, _lyp), (0.19, _vwn(_VWN_RPA))],
                          0.20),
    "b3lyp5": XCFunctional([(0.08, _slater), (0.72, _b88), (0.81, _lyp), (0.19, _vwn(_VWN5))],
                           0.20),
}


class XCEnergy:
    """E_xc[D] on a grid for a closed-shell total density D; the potential
    is dE_xc/dD."""

    def __init__(self, functional: XCFunctional, basis, grid: Grid):
        self.functional = functional
        self.ao, self.ao_grad = ao_on_grid(basis, grid.points)
        self.w = grid.weights

    def energy(self, dm):
        phi_d = self.ao @ dm
        rho = (phi_d * self.ao).sum(-1)
        grad = 2 * (self.ao_grad * phi_d[None]).sum(-1)
        sigma = (grad * grad).sum(0)
        return (self.w * self.functional.energy_density(rho, sigma)).sum()

    def __call__(self, dm):
        """(E_xc, V_xc) at density ``dm``."""
        d = dm.detach().clone().requires_grad_(True)
        with torch.enable_grad():
            e = self.energy(d)
            (v,) = torch.autograd.grad(e, d)
        return e.detach(), 0.5 * (v + v.T)
