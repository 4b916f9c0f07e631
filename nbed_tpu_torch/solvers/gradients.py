"""Analytic nuclear gradients of HF and KS energies by autograd (port of
``nbed_tpu/solvers/gradients.py``).

Every integral of :mod:`nbed_tpu_torch.integrals` and the grid of
:mod:`nbed_tpu_torch.grids` is a pure torch function of the atomic
coordinates, so the analytic gradient is one ``torch.autograd.grad`` of
the stationary-point energy functional

    E(x) = Tr[D h(x)] + E_J[D; g(x)] - hyb * E_K[D_s; g(x)]
           - Tr[W S(x)] + E_nuc(x)  (+ E_xc[D; grid(x)])

with the converged density ``D`` and the energy-weighted density ``W``
held fixed: the classic analytic gradient (Pulay 1969), the -Tr[W dS/dx]
term included, with the derivative integrals supplied by the backward pass
of the McMurchie-Davidson tables. For KS the grid points and Becke weights
move with the atoms, so the gradient includes the grid response and is
exact for the discretised energy surface.

The HF SCF runs on the ``eri_tensor`` supermatrices (detached) through the
fused J/K kernel (:func:`nbed_tpu_torch.ops.jk.prepare_jk`); the KS SCF is
an :class:`~nbed_tpu_torch.scf.SCFEngine` at the given geometry, whose J/K
take the same kernel. Geometry optimization is scipy's BFGS on the host.

Derivative programs (``jit_kernel``): on a card the gradient is one CUDA
graph per structure, the integrals' forward, the energy functional and its
``torch.autograd.grad`` captured together (kinds "hf_grad", single or
lanes, and "ks_grad", grid response and RSH included), shared by every
geometry of the structure through buffers: the coordinates (a leaf that
requires grad) and the densities are copied in, ``W`` is formed inside
from the same ERIs, and the gradient is read out. The HF SCF's ERIs come
from the "eri" program (:func:`nbed_tpu_torch.integrals.eri.eri_program`).
"""

import logging

import numpy as np
import torch

from .._device import DTYPE, resolve_device
from ..chem.molecule import Molecule
from ..dft.functionals import resolve_functional
from ..dft.xc import make_xc_fn
from ..grids import build_grid, eval_aos
from ..grids.grid import ao_views, grid_constants, grid_points, shell_tables
from ..integrals import (eri_tensor, kinetic, nuclear_attraction, overlap,
                         point_charge_attraction)
from ..integrals.core import _mm_tensors
from ..integrals.eri import _device_tables, _eri_of, eri_program
from ..ops.jk import prepare_jk
from ..ops.programs import (BufferProgram, derivative_program, gradient_body, structure_key,
                            takes_program)

logger = logging.getLogger(__name__)

__all__ = ["hf_gradient", "ks_gradient", "optimize_geometry"]


def _hcore(mol: Molecule, x):
    """T + V (+ the MM charges) at coordinates ``x`` (a tensor)."""
    h = kinetic(mol, x, device=x.device) + nuclear_attraction(mol, x, device=x.device)
    if mol.mm_coords is not None:
        h = h + point_charge_attraction(mol, *_mm_tensors(mol, x.device), coords=x,
                                        device=x.device)
    return h


def _grid(mol, x, grid_scheme, grid_level, grid_size):
    return build_grid(mol, x, n_rad=grid_size[0], n_theta=grid_size[1], scheme=grid_scheme,
                      level=grid_level, device=x.device)


def _xc_fn(mol, x, xc_name, grid_scheme, grid_level, grid_size):
    """The differentiable XC closure on the grid at ``x``: points, weights
    and AO tables are functions of ``x``, so its energy carries the grid
    response."""
    points, weights = _grid(mol, x, grid_scheme, grid_level, grid_size)
    ao, ao_grad = eval_aos(mol, points, x)
    return make_xc_fn(ao, ao_grad, weights, xc_name, differentiable=True)


def _k(g, d):
    """Exchange K_ij = sum_kl (ik|jl) d_kl of one spin density (leading
    lane axes ride along)."""
    return torch.einsum("...ikjl,...kl->...ij", g, d)


def _functional(mol: Molecule, x, dm, w_tot, hyb: float, g, lr=None, xc_fn=None):
    """E(x) of :func:`_energy_functional` from its pieces at ``x``: the ERI
    tensor ``g``, ``lr`` = (beta, long-range ERIs) of a range-separated
    hybrid and the differentiable XC closure ``xc_fn`` on the grid at
    ``x``."""
    d_tot = dm[..., 0, :, :] + dm[..., 1, :, :]
    ej = 0.5 * torch.einsum("...ij,...ijkl,...kl->...", d_tot, g, d_tot)
    ek = 0.5 * sum(torch.sum(_k(g, dm[..., s, :, :]) * dm[..., s, :, :], dim=(-2, -1))
                   for s in (0, 1))
    e = (torch.sum(d_tot * _hcore(mol, x), dim=(-2, -1)) + ej - hyb * ek
         - torch.sum(w_tot * overlap(mol, x, device=x.device), dim=(-2, -1))
         + mol.energy_nuc_tensor(x))
    if lr is not None:
        beta, g_lr = lr
        e = e - beta * 0.5 * sum(torch.sum(_k(g_lr, dm[s]) * dm[s]) for s in (0, 1))
    if xc_fn is not None:
        e = e + xc_fn(dm)[0]
    return e


def _energy_functional(mol: Molecule, dm, w_tot, hyb: float, xc_name=None,
                       grid_scheme: str = "reference", grid_level: int = 3, rsh=None,
                       grid_size=(96, 22)):
    """E(x) with the density and energy-weighted density held fixed.

    ``dm``: (2, n, n) converged spin densities. ``w_tot``: (n, n)
    spin-summed energy-weighted density from :func:`_w_from_dm`.
    ``rsh`` = (beta, omega) adds -beta E_K over the long-range
    erf(omega*r12)/r12 ERIs. The grid arguments are the SCF engine's.

    HF lanes: (B, 2, n, n) and (B, n, n) densities and (B, natm, 3)
    coordinates give the (B,) lane energies; the lanes are independent, so
    the gradient of their sum is each lane's own gradient.
    """
    dm = dm.detach()
    w_tot = w_tot.detach()

    def energy(x):
        dev = x.device
        g = eri_tensor(mol, x, device=dev)
        lr = None if rsh is None else (rsh[0], eri_tensor(mol, x, omega=rsh[1], device=dev))
        xc_fn = (None if xc_name is None
                 else _xc_fn(mol, x, xc_name, grid_scheme, grid_level, grid_size))
        return _functional(mol, x, dm, w_tot, hyb, g, lr, xc_fn)

    return energy


def _w_from_dm(mol, x, dm, hyb: float, xc_name=None, grid_scheme: str = "reference",
               grid_level: int = 3, rsh=None, grid_size=(96, 22), eri=None, eri_lr=None,
               xc_tables=None):
    """Energy-weighted density W = sum_s D_s F(D)_s D_s at coordinates
    ``x``, from the Fock at the converged density itself: the SCF's last
    eigenpairs diagonalise the DIIS-extrapolated Fock, whose eigenvalues
    can sit ~1e-3 off the true ones even when the density has converged,
    while D F D is the occupied-block Lagrange multiplier exactly.
    ``eri``, ``eri_lr`` and ``xc_tables`` (AO table, its gradient, grid
    weights): the ERI tensors and XC tables at ``x`` when the caller has
    them. HF lanes ride along as in :func:`_energy_functional`."""
    with torch.no_grad():
        dev = x.device
        g = eri_tensor(mol, x, device=dev) if eri is None else eri
        j = torch.einsum("...ijkl,...kl->...ij", g, dm[..., 0, :, :] + dm[..., 1, :, :])
        k = torch.stack([_k(g, dm[..., s, :, :]) for s in (0, 1)], dim=-3)
        f = _hcore(mol, x)[..., None, :, :] + j[..., None, :, :] - hyb * k
        if rsh is not None:
            beta, omega = rsh
            g_lr = eri_tensor(mol, x, omega=omega, device=dev) if eri_lr is None else eri_lr
            f = f - beta * torch.stack([_k(g_lr, dm[s]) for s in (0, 1)])
        if xc_name is not None:
            if xc_tables is None:
                points, weights = _grid(mol, x, grid_scheme, grid_level, grid_size)
                ao, ao_grad = eval_aos(mol, points, x)
            else:
                ao, ao_grad, weights = xc_tables
            f = f + make_xc_fn(ao, ao_grad, weights, xc_name)(dm)[1]
        return sum(dm[..., s, :, :] @ f[..., s, :, :] @ dm[..., s, :, :] for s in (0, 1))


def _coords_tensor(mol, coords, device):
    return torch.as_tensor(mol.coords if coords is None else coords, dtype=DTYPE,
                           device=resolve_device(device)).detach().clone()


def _autograd(energy, x):
    """d energy / dx; the energies of lanes are summed, giving each lane's
    own gradient."""
    x = x.clone().requires_grad_(True)
    return torch.autograd.grad(torch.sum(energy(x)), x)[0]


def _exact_jk(t):
    """``build`` of :func:`~nbed_tpu_torch.scf.engine.single_scf`: exact
    J/K through the fused kernel on the supermatrices "g_j", "g_k"."""
    jk = prepare_jk(t["g_j"], t["g_k"])
    return (lambda dm: jk(dm.contiguous())), None


def _hf_scf(mol, x, dm0=None, conv_tol=1e-10, dm_conv_tol=1e-8, max_cycle=100,
            jit_kernel="auto"):
    """UHF at coordinates ``x`` on the ``eri_tensor`` supermatrices (the
    "eri" program under ``jit_kernel``), with J/K through the fused
    kernel, as the single-lane program of the shared cache on a card
    (``jit_kernel``, see :func:`~nbed_tpu_torch.scf.engine.lane_scf`):
    (SCFResult, ERI tensor)."""
    from ..scf.engine import lane_spec, single_scf

    n = mol.nao
    with torch.no_grad():
        g = eri_program(mol, x, jit_kernel=jit_kernel)
        ops = {"hcore": _hcore(mol, x), "s": overlap(mol, x, device=x.device),
               "g_j": g.reshape(n * n, n * n).contiguous(),
               "g_k": g.permute(0, 2, 1, 3).reshape(n * n, n * n).contiguous()}
        res = single_scf(
            lane_spec(mol, "uhf"), ops, _exact_jk, nelec=mol.nelec, jit_kernel=jit_kernel,
            dm0=None if dm0 is None else torch.as_tensor(dm0, dtype=DTYPE, device=x.device),
            conv_tol=conv_tol, dm_conv_tol=dm_conv_tol, max_cycle=max_cycle)
    return res, g


def _held_tables(mol: Molecule, device) -> tuple:
    """The bounded-cache device tables that the energy functional's
    one-electron integrals and nuclear repulsion read at ``device``: a
    gradient program holds them (:class:`~nbed_tpu_torch.ops.programs.
    BufferProgram` ``holds``), since its graph reads them by address."""
    from ..chem.molecule import _nuclear_tables
    from ..integrals.core import _device_pair_tables, _nuclear_charges

    held = (_device_pair_tables(mol, mol, True, device), _nuclear_charges(mol, device),
            _nuclear_tables(mol, device))
    return held + ((_mm_tensors(mol, device),) if mol.mm_coords is not None else ())


def _leaf(shape, device):
    """A coordinate input buffer: a leaf that requires grad."""
    return torch.zeros(shape, dtype=DTYPE, device=device, requires_grad=True)


def hf_gradient_program(mol: Molecule, x, dm):
    """The "hf_grad" program of ``mol``'s structure at ``x``'s shape
    ((natm, 3), or (B, natm, 3) lanes with (B, 2, n, n) densities): W
    from ``dm`` at ``x`` and the gradient of the energy functional, on one
    evaluation of the ERIs; returns the gradient (a copy the caller
    owns)."""
    shape, n = tuple(x.shape), mol.nao

    def build(device, pool):
        xb = _leaf(shape, device)
        dmb = torch.zeros(shape[:-2] + (2, n, n), dtype=DTYPE, device=device)
        out = torch.zeros(shape, dtype=DTYPE, device=device)
        tables = _device_tables(mol, device)

        def energy(xv):
            g = _eri_of(mol, xv, tables, 2**22, None)
            w_tot = _w_from_dm(mol, xv.detach(), dmb, hyb=1.0, eri=g.detach())
            return _functional(mol, xv, dmb, w_tot, 1.0, g)

        return BufferProgram("hf_grad", {"x": xb, "dm": dmb}, {"grad": out},
                             gradient_body(energy, xb, out), device, pool,
                             holds=_held_tables(mol, device))

    prog = derivative_program(("hf_grad", structure_key(mol), shape), x.device, build)
    return prog(x=x, dm=dm)["grad"].clone()


def ks_gradient_program(mol: Molecule, x, dm, xc: str, grid_scheme: str, grid_level: int,
                        grid_size):
    """The "ks_grad" program of ``mol``'s structure, functional and grid
    at (natm, 3) ``x``: the ERIs (and the long-range ones of a
    range-separated hybrid), the grid points, Becke weights and AO tables
    at ``x`` from constants made once per structure, W from ``dm`` on
    them, and the gradient of the energy functional with its grid
    response; returns the gradient (a copy the caller owns)."""
    _, hyb, rsh = resolve_functional(xc)
    shape, n = tuple(x.shape), mol.nao
    grid_size = tuple(int(v) for v in grid_size)

    def build(device, pool):
        xb = _leaf(shape, device)
        dmb = torch.zeros((2, n, n), dtype=DTYPE, device=device)
        out = torch.zeros(shape, dtype=DTYPE, device=device)
        tables = _device_tables(mol, device)
        constants = grid_constants(mol, grid_size[0], grid_size[1], grid_scheme, grid_level,
                                   device)
        shells = shell_tables(mol, DTYPE, device)

        def energy(xv):
            g = _eri_of(mol, xv, tables, 2**22, None)
            g_lr = None if rsh is None else _eri_of(mol, xv, tables, 2**22, float(rsh[1]))
            points, weights = grid_points(constants, xv)
            ao, ao_grad = (t.contiguous() for t in ao_views(mol, points, xv, shells))
            w_tot = _w_from_dm(mol, xv.detach(), dmb, hyb, xc_name=xc, rsh=rsh,
                               eri=g.detach(), eri_lr=None if g_lr is None else g_lr.detach(),
                               xc_tables=(ao.detach(), ao_grad.detach(), weights.detach()))
            return _functional(mol, xv, dmb, w_tot, hyb, g,
                               None if rsh is None else (rsh[0], g_lr),
                               make_xc_fn(ao, ao_grad, weights, xc, differentiable=True))

        return BufferProgram("ks_grad", {"x": xb, "dm": dmb}, {"grad": out},
                             gradient_body(energy, xb, out), device, pool,
                             holds=_held_tables(mol, device))

    key = ("ks_grad", structure_key(mol), shape, xc, grid_scheme, int(grid_level), grid_size)
    prog = derivative_program(key, x.device, build)
    return prog(x=x, dm=dm)["grad"].clone()


def hf_gradient(mol: Molecule, coords=None, scf_result=None, dm0=None,
                conv_tol: float = 1e-10, dm_conv_tol: float = 1e-8, max_cycle: int = 100,
                device="cuda", jit_kernel: str = "auto"):
    """Analytic nuclear gradient of the (U)HF total energy.

    Returns ``(e_tot, grad, scf_result)`` with ``grad`` a (natm, 3) tensor
    in Ha/bohr on ``device``. A converged ``scf_result``
    (:class:`~nbed_tpu_torch.scf.hf.SCFResult`) skips the SCF; ``dm0``
    warm-starts it (as :func:`optimize_geometry` does). ``jit_kernel`` as
    ``SCFEngine``'s: on a card the SCF, its ERIs and the gradient replay
    CUDA graphs shared by every geometry of the molecule ("on" runs the
    same programs uncaptured off CUDA, "off" the eager route).
    """
    x = _coords_tensor(mol, coords, device)
    if scf_result is None:
        scf_result, g = _hf_scf(mol, x, dm0, conv_tol, dm_conv_tol, max_cycle, jit_kernel)
    else:
        g = None
    dm = scf_result.dm.to(x.device)
    if takes_program(jit_kernel, (x, dm)):
        grad = hf_gradient_program(mol, x, dm)
    else:
        w_tot = _w_from_dm(mol, x, dm, hyb=1.0, eri=g)
        grad = _autograd(_energy_functional(mol, dm, w_tot, hyb=1.0), x)
    return scf_result.e_elec + mol.energy_nuc(x.cpu()), grad, scf_result


def ks_gradient(mol: Molecule, xc: str, coords=None, solution=None,
                grid_scheme: str = "reference", grid_level: int = 3,
                conv_tol: float = 1e-10, dm_conv_tol: float = 1e-8, max_cycle: int = 100,
                device="cuda", jit_kernel: str = "auto"):
    """Analytic nuclear gradient of the (U)KS total energy, grid response
    included; range-separated hybrids add the long-range exchange.

    Returns ``(e_tot, grad, solution)``; ``solution`` may be a converged
    :class:`~nbed_tpu_torch.scf.SCFSolution` of this molecule and geometry,
    which skips the SCF. The XC energy is differentiated on the grid of the
    solution's engine (its scheme, level and product-grid size); the
    reference takes ``build_grid``'s own product-grid size there, a grid the
    SCF did not use (ROADMAP queue 3). ``jit_kernel`` is the SCF engine's
    (its programs are shared by every geometry of the molecule), and the
    gradient's: on a card one "ks_grad" program per structure, functional
    and grid.
    """
    from ..scf.engine import SCFEngine

    x = _coords_tensor(mol, coords, device)
    if solution is None:
        solution = SCFEngine(mol, xc=xc, coords=x.cpu().numpy(), grid_scheme=grid_scheme,
                             grid_level=grid_level, conv_tol=conv_tol,
                             dm_conv_tol=dm_conv_tol, max_cycle=max_cycle,
                             device=x.device, jit_kernel=jit_kernel).kernel()
    c = solution.mo_coeff.to(x.device)
    occ = solution.mo_occ.to(x.device)
    if c.ndim == 2:  # restricted report: occupations count electrons
        dm = (0.5 * torch.einsum("pi,i,qi->pq", c, occ, c))[None].repeat(2, 1, 1)
    else:
        dm = torch.einsum("spi,si,sqi->spq", c, occ, c)
    _, hyb, rsh = resolve_functional(xc)
    eng = solution.engine
    kw = dict(hyb=hyb, xc_name=xc, grid_scheme=eng.grid_scheme, grid_level=eng.grid_level,
              rsh=rsh, grid_size=tuple(eng.grid_size))
    if takes_program(jit_kernel, (x, dm)):
        grad = ks_gradient_program(mol, x, dm, xc, eng.grid_scheme, eng.grid_level,
                                   eng.grid_size)
    else:
        w_tot = _w_from_dm(mol, x, dm, **kw)
        grad = _autograd(_energy_functional(mol, dm, w_tot, **kw), x)
    return solution.e_tot, grad, solution


def optimize_geometry(mol: Molecule, coords0=None, gtol: float = 3e-5, max_steps: int = 50,
                      verbose: bool = False, device="cuda", jit_kernel: str = "auto"):
    """Geometry optimization on the analytic HF gradient (scipy BFGS on the
    host). Each evaluation re-runs the SCF warm-started from the previous
    one's density. Returns ``(coords, e_tot, n_steps, converged)``, coords
    in Bohr; converged when scipy reports success or the largest gradient
    component at the end is within ``gtol`` (scipy's flag trips on
    "precision loss" when line-search energy differences near the minimum
    fall under the SCF's noise floor). ``jit_kernel`` as
    :func:`hf_gradient`'s: every step replays one molecule's programs.
    """
    from scipy.optimize import minimize

    x0 = np.asarray(mol.coords if coords0 is None else coords0, dtype=np.float64)
    state = {"dm0": None, "steps": 0}

    def fun(flat):
        e, g, res = hf_gradient(mol, coords=flat.reshape(-1, 3), dm0=state["dm0"],
                                device=device, jit_kernel=jit_kernel)
        state["dm0"] = res.dm
        state["steps"] += 1
        g = g.cpu().numpy()
        if verbose:
            logger.info("step %d: e=%.10f |g|max=%.2e", state["steps"], e,
                        np.max(np.abs(g)))
        return float(e), g.ravel()

    out = minimize(fun, x0.ravel(), jac=True, method="BFGS",
                   options={"gtol": gtol, "maxiter": max_steps})
    coords = out.x.reshape(-1, 3)
    _, g_final, _ = hf_gradient(mol, coords=coords, dm0=state["dm0"], device=device,
                                jit_kernel=jit_kernel)
    converged = bool(out.success) or float(torch.max(torch.abs(g_final))) <= gtol
    return coords, float(out.fun), state["steps"], converged
