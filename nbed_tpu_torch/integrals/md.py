"""McMurchie-Davidson building blocks: the Boys function and the Hermite E
and R tables (port of ``nbed_tpu/integrals/md.py``).

The reference builds each table for one primitive pair or quartet under
``vmap``; here the same recursions run on tensors that broadcast over any
leading axes (pairs, quartets, primitives, point charges), so one call
serves a whole angular class. Pure torch arithmetic: autograd passes
through every function, which is what the analytic nuclear gradients
(``solvers/gradients.py``) differentiate.
"""

import math
from functools import lru_cache

import numpy as np
import torch

__all__ = ["boys", "e_table_1d", "hermite_r", "hermite_r_cross"]

# below this argument the Boys function is taken from its Taylor series
_SERIES_BELOW = 0.1


class _GammaincT(torch.autograd.Function):
    """``torch.special.gammainc(a, t)`` differentiable in ``t`` in both
    modes: torch's igamma has a backward but no forward-mode derivative,
    which the geometry-differentiable embedding program
    (``parallel/embed_path.py``) needs. The derivative is torch's own
    backward formula, dP(a, t)/dt = exp((a - 1) log t - t - lgamma(a))."""

    @staticmethod
    def forward(ctx, a, t):
        ctx.save_for_backward(a, t)
        ctx.save_for_forward(a, t)
        return torch.special.gammainc(a, t)

    @staticmethod
    def _dt(a, t):
        return torch.exp((a - 1) * torch.log(t) - t - torch.lgamma(a))

    @staticmethod
    def backward(ctx, grad):
        a, t = ctx.saved_tensors
        return None, grad * _GammaincT._dt(a, t)

    @staticmethod
    def jvp(ctx, _a_dot, t_dot):
        a, t = ctx.saved_tensors
        return t_dot * _GammaincT._dt(a, t)


def boys(mmax: int, t):
    """Boys functions F_0..F_mmax at ``t`` (any shape), stacked on axis 0.

    F_mmax comes from the regularised lower incomplete gamma,
    F_m(t) = Gamma(m+1/2) P(m+1/2, t) / (2 t^(m+1/2)), and the lower orders
    from the exact downward recursion (stable); a 14-term Taylor series
    replaces the closed form below t = 0.1, as in the reference.

    The closed form is evaluated at t = 1 wherever the series is selected
    (one-centre nuclear attraction and P = Q quartets give t = 0 exactly):
    its local gradient at t -> 0 overflows, and ``torch.where`` passes the
    unselected branch 0 x that gradient, a NaN. The selected values equal
    the reference's, whose ``t >= 1e-30`` clamp is kept.
    """
    if not isinstance(t, torch.Tensor):
        t = torch.as_tensor(t)
    a = mmax + 0.5
    small = t < _SERIES_BELOW
    t_big = torch.clamp_min(torch.where(small, torch.ones_like(t), t), 1e-30)
    f_big = (0.5 * math.gamma(a)) * _GammaincT.apply(
        torch.full_like(t_big, a), t_big) / t_big ** a
    f_small = torch.zeros_like(t)
    for k in range(14):
        f_small = f_small + (-t) ** k / (math.factorial(k) * (2 * mmax + 2 * k + 1))
    out = [None] * (mmax + 1)
    out[mmax] = torch.where(small, f_small, f_big)
    exp_t = torch.exp(-t)
    for m in range(mmax, 0, -1):
        out[m - 1] = (2 * t * out[m] + exp_t) / (2 * m - 1)
    return torch.stack(out)


def e_table_1d(la: int, lb: int, a, b, ab_dist):
    """Hermite expansion coefficients E_t^{ij} for one cartesian direction.

    Args:
        la, lb: maximum powers for centres A and B.
        a, b: primitive exponents, tensors broadcasting against each other.
        ab_dist: A_x - B_x, broadcasting against ``a`` and ``b``.

    Returns:
        (..., la+1, lb+1, la+lb+1) tensor; E[..., i, j, t] = 0 for t > i+j.
    """
    a, b, ab_dist = torch.broadcast_tensors(a, b, ab_dist)
    p = a + b
    mu = a * b / p
    one_over_2p = 0.5 / p
    pa = -b / p * ab_dist  # P - A
    pb = a / p * ab_dist   # P - B
    zero = torch.zeros_like(p)

    e = {(0, 0, 0): torch.exp(-mu * ab_dist * ab_dist)}

    def get(i, j, t):
        if t < 0 or t > i + j or i < 0 or j < 0:
            return zero
        return e[(i, j, t)]

    for i in range(la + 1):
        for j in range(lb + 1):
            if i == 0 and j == 0:
                continue
            for t in range(i + j + 1):
                if j == 0:
                    e[(i, j, t)] = (one_over_2p * get(i - 1, j, t - 1)
                                    + pa * get(i - 1, j, t)
                                    + (t + 1) * get(i - 1, j, t + 1))
                else:
                    e[(i, j, t)] = (one_over_2p * get(i, j - 1, t - 1)
                                    + pb * get(i, j - 1, t)
                                    + (t + 1) * get(i, j - 1, t + 1))

    return torch.stack([
        torch.stack([torch.stack([get(i, j, t) for t in range(la + lb + 1)], dim=-1)
                     for j in range(lb + 1)], dim=-2)
        for i in range(la + 1)
    ], dim=-3)


def _shift(r, axis: int, k: int):
    """out[..., i, ...] = r[..., i-k, ...] along one of the last three axes
    (zeros shifted in)."""
    size = r.shape[axis]
    pad = [0, 0] * 3
    pad[2 * (-1 - axis)] = k  # F.pad lists (left, right) from the last axis
    return torch.nn.functional.pad(r, pad).narrow(axis, 0, size)


def hermite_r(lmax: int, p, pq, omega=None):
    """Hermite Coulomb integrals R_{tuv}(p, PQ) for all t+u+v <= lmax.

    Downward recursion in the Boys order n: each step builds the full
    (lmax+1)^3 cube of order n from that of order n+1 with three shifted
    slices, as the reference does. Entries with t+u+v > lmax hold finite
    garbage of the truncated recursion that no consumer reads (the E
    tensors vanish there).

    Args:
        lmax: total Hermite order.
        p: exponent-like prefactor, shape (...).
        pq: P - Q (or P - C for nuclear attraction), shape (..., 3).
        omega: if not None, the long-range kernel erf(omega*r)/r: every
            Boys order is attenuated, F_n(T) -> kappa^(2n+1) F_n(kappa^2 T)
            with kappa^2 = omega^2/(p + omega^2).

    Returns:
        (..., lmax+1, lmax+1, lmax+1) tensor R[..., t, u, v].
    """
    if not isinstance(p, torch.Tensor):
        p = torch.as_tensor(p, dtype=pq.dtype, device=pq.device)
    p, pq = torch.broadcast_tensors(p[..., None], pq)
    p = p[..., 0]
    t_arg = p * torch.sum(pq * pq, dim=-1)
    orders = torch.arange(lmax + 1, dtype=p.dtype, device=p.device)
    orders = orders.reshape((-1,) + (1,) * p.ndim)
    if omega is None:
        f = boys(lmax, t_arg)  # (lmax+1, ...)
    else:
        kappa2 = omega * omega / (p + omega * omega)
        f = boys(lmax, kappa2 * t_arg) * torch.sqrt(kappa2) * kappa2[None] ** orders
    base = (-2.0 * p[None]) ** orders * f  # R^n_{000}, (lmax+1, ...)
    size = lmax + 1
    cube = p.shape + (size, size, size)
    if lmax == 0:
        return base[0].reshape(cube)

    idx = torch.arange(size, device=p.device)
    tm, um, vm = idx.reshape(-1, 1, 1), idx.reshape(1, -1, 1), idx.reshape(1, 1, -1)
    origin = (tm == 0) & (um == 0) & (vm == 0)
    tmf, umf, vmf = ((m - 1).to(p.dtype) for m in (tm, um, vm))
    pqx, pqy, pqz = (pq[..., d, None, None, None] for d in range(3))
    zero = torch.zeros(cube, dtype=p.dtype, device=p.device)
    r = torch.where(origin, base[lmax][..., None, None, None], zero)
    for n in range(lmax - 1, -1, -1):
        # R^n_{tuv} from R^{n+1} through the first nonzero index (the (t-1)
        # coefficient vanishes exactly where the shifted slice pads zeros)
        cand_t = tmf * _shift(r, -3, 2) + pqx * _shift(r, -3, 1)
        cand_u = umf * _shift(r, -2, 2) + pqy * _shift(r, -2, 1)
        cand_v = vmf * _shift(r, -1, 2) + pqz * _shift(r, -1, 1)
        new = torch.where(tm >= 1, cand_t,
                          torch.where(um >= 1, cand_u, torch.where(vm >= 1, cand_v, zero)))
        r = torch.where(origin, base[n][..., None, None, None], new)
    return r


@lru_cache(maxsize=None)
def _cross_tables(lab: int, lcd: int, dtype, device):
    """The flat gather index into the (lab+lcd+1)^3 cube and the bra-ket
    signs of :func:`hermite_r_cross`, on ``device`` once per (lab, lcd):
    a call copies nothing from the host (a CUDA graph captures it).
    Unbounded (a few small tensors per angular pair): a graph reads them
    by address, so an entry must never be evicted."""
    size = lab + lcd + 1
    ts = np.arange(lab + 1)
    taus = np.arange(lcd + 1)
    idx = ts[:, None] + taus[None, :]  # (t, tau) -> t + tau
    flat = ((idx[:, None, None, :, None, None] * size
             + idx[None, :, None, None, :, None]) * size
            + idx[None, None, :, None, None, :])
    sign = (-1.0) ** (taus[:, None, None] + taus[None, :, None] + taus[None, None, :])
    return (torch.as_tensor(flat.reshape(-1), device=device),
            torch.as_tensor(np.broadcast_to(sign, flat.shape).copy(), dtype=dtype,
                            device=device))


def hermite_r_cross(lab: int, lcd: int, alpha, pq, omega=None):
    """R4[..., t,u,v, tau,nu,phi] = (-1)^(tau+nu+phi) R_{t+tau, u+nu, v+phi}.

    The sign of the bra-ket Hermite contraction is folded in, so an ERI is
    a plain contraction against the two E tensors. ``omega`` as in
    :func:`hermite_r`. The entries are one ``index_select`` of the
    flattened cube, whose backward is an index addition (no sort).
    """
    r = hermite_r(lab + lcd, alpha, pq, omega=omega)
    flat, sign = _cross_tables(lab, lcd, r.dtype, r.device)
    lead = r.shape[:-3]
    r4 = r.reshape(*lead, -1).index_select(-1, flat).reshape(*lead, *sign.shape)
    return r4 * sign
