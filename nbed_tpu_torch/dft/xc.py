"""Grid XC evaluation (port of ``nbed_tpu/dft/xc.py``).

The potential matrices are derived from the energy-density closure by
``torch.autograd.grad`` (the reference uses ``jax.value_and_grad``), so the
closed forms in :mod:`.functionals` are the single source of truth. The
per-call cost is a handful of (G, nao) x (nao, nao) products, taken over
grid chunks with the (exc, vxc) sums accumulated across them. The table
path keeps the AO tables of the whole grid; the streaming path evaluates
them per chunk, for grids whose tables would outgrow the memory budget.
Both work in the dtype of their tables: float64 on the main path, float32
for the mixed-precision SCF's coarse cycles, with the density mask of each
dtype (:func:`_mask_thresh`).

Either closure also comes in a differentiable form (``differentiable=True``)
for linear response: the potentials are ``torch.func.grad`` of the energy
density with nothing detached, so ``torch.func.jvp`` of ``vxc(dm)`` along a
symmetric density tangent is the XC kernel contraction f_xc . d (the
reference takes ``jax.jvp`` of its closure, ``nbed_tpu/solvers/tddft.py:
271-281``). Both give the same (exc, vxc); the SCF uses the detached form,
which is the faster one on the card.
"""

import torch

from ..grids import eval_aos
from ..grids.grid import shell_tables
from .functionals import resolve_functional

__all__ = ["make_xc_fn", "make_xc_fn_streaming"]

# grid points per chunk of the table and streaming closures
TABLE_CHUNK = 131072
STREAM_CHUNK = 32768


def _mask_thresh(dtype) -> float:
    """Density cut below which grid points are masked out of the XC math,
    the reference's CPU values (``nbed_tpu/dft/xc.py:24-34``): 1e-11 in
    float64, 3e-6 in float32, where GGA intermediates of thinner densities
    leave float32's range. The reference's coarser mask for emulated
    float64 exists only on the TPU and is not ported."""
    return 1e-11 if dtype == torch.float64 else 3e-6


def _chunk_math(terms, thresh: float, differentiable: bool = False):
    """Per-chunk energy + potential contributions from AO tables.

    When a term is tau-dependent (``fn.needs_tau``, the meta-GGAs) the chunk
    also builds the per-spin kinetic-energy density
    tau_s = 1/2 sum_d (grad_d phi) D_s (grad_d phi), takes ``v_tau`` by
    autograd with the other five inputs and adds
    V_tau[pq] = 1/2 sum_g v_tau(g) grad phi_p . grad phi_q to each spin's V
    (``nbed_tpu/dft/xc.py:72-93``).

    ``differentiable``: the input derivatives come from
    ``torch.func.grad_and_value`` on the attached inputs, so (exc, vxc)
    carry their dependence on ``dm`` (and on the tables) into an enclosing
    ``torch.func`` transform or ``torch.autograd.forward_ad`` level;
    otherwise the inputs are detached and differentiated by
    ``torch.autograd.grad``.

    Leading lane axes ride along: tables (B, C, nao) and (B, 3, C, nao),
    weights (B, C) and densities (B, 2, nao, nao) give exc (B,) and vxc
    (B, 2, nao, nao), each lane's own. Points of zero weight and zero AO
    values (the padding of a grid split over devices) fall under the
    density mask and add exactly zero.
    """
    needs_tau = any(getattr(fn, "needs_tau", False) for _, fn in terms)

    def e_density(ra, rb, gaa, gab, gbb, ta=None, tb=None):
        mask = (ra + rb) > thresh

        def safe(x):
            return torch.where(mask, x, torch.ones_like(x))

        out = 0.0
        for coef, fn in terms:
            args = [safe(ra), safe(rb), safe(gaa), safe(gab), safe(gbb)]
            if getattr(fn, "needs_tau", False):
                args += [safe(ta), safe(tb)]
            out = out + coef * fn(*args)
        return torch.where(mask, out, torch.zeros_like(out))

    def one_chunk(ao_c, grad_c, w_c, dm):
        lanes = w_c.ndim > 1
        ao_d = torch.einsum("...gp,...spq->...sgq", ao_c, dm)  # (2, C, nao)
        rho = torch.einsum("...sgq,...gq->...sg", ao_d, ao_c)
        grho = 2.0 * torch.einsum("...dgq,...sgq->...sdg", grad_c, ao_d)  # (2, 3, C)
        grho_a, grho_b = grho[..., 0, :, :], grho[..., 1, :, :]
        gaa = torch.einsum("...dg,...dg->...g", grho_a, grho_a)
        gbb = torch.einsum("...dg,...dg->...g", grho_b, grho_b)
        gab = torch.einsum("...dg,...dg->...g", grho_a, grho_b)
        base = [rho[..., 0, :], rho[..., 1, :], gaa, gab, gbb]
        if needs_tau:
            grad_d = torch.einsum("...dgp,...spq->...sdgq", grad_c, dm)  # (2, 3, C, nao)
            tau = 0.5 * torch.einsum("...sdgq,...dgq->...sg", grad_d, grad_c)
            del grad_d
            base += [tau[..., 0, :], tau[..., 1, :]]

        def energy(*inputs):
            """(the sum that is differentiated, each lane's energy): the
            lanes are independent, so the sum's input derivatives are each
            lane's own."""
            if not lanes:
                e = torch.sum(w_c * e_density(*inputs))
                return e, e
            e = torch.sum(w_c * e_density(*inputs), dim=-1)
            return torch.sum(e), e

        if differentiable:
            grads, (_, exc) = torch.func.grad_and_value(
                energy, argnums=tuple(range(len(base))), has_aux=True)(*base)
        else:
            inputs = [t.detach().requires_grad_(True) for t in base]
            with torch.enable_grad():
                total, exc = energy(*inputs)
                grads = torch.autograd.grad(total, inputs, allow_unused=True,
                                            materialize_grads=True)
            exc = exc.detach()
        vra, vrb, vgaa, vgab, vgbb, *v_tau = grads
        vta, vtb = v_tau if needs_tau else (None, None)

        def vmat(vr, vg_ss, vg_ab, grho_s, grho_t, vt):
            m = torch.einsum("...g,...gp,...gq->...pq", vr, ao_c, ao_c)
            vec = 2.0 * vg_ss[..., None, :] * grho_s + vg_ab[..., None, :] * grho_t
            half = torch.einsum("...dg,...dgp,...gq->...pq", vec, grad_c, ao_c)
            out = m + half + half.transpose(-1, -2)
            if needs_tau:
                out = out + 0.5 * torch.einsum("...g,...dgp,...dgq->...pq", vt, grad_c,
                                               grad_c)
            return out

        va = vmat(vra, vgaa, vgab, grho_a, grho_b, vta)
        vb = vmat(vrb, vgbb, vgab, grho_b, grho_a, vtb)
        return exc, torch.stack([va, vb], dim=-3)

    return one_chunk


def make_xc_fn(ao, ao_grad, weights, xc_name: str, chunk: int = TABLE_CHUNK,
               differentiable: bool = False):
    """``xc_fn(dm) -> (exc, vxc (2, nao, nao))`` from precomputed AO tables
    (``ao`` (G, nao), ``ao_grad`` (3, G, nao), ``weights`` (G,)), or None
    for a functional with no grid terms (``hf``). It computes in the
    tables' dtype and takes a density of that dtype; ``differentiable``
    and lane axes in front of every argument as in :func:`_chunk_math`."""
    terms = resolve_functional(xc_name)[0]
    if not terms:
        return None
    one_chunk = _chunk_math(terms, _mask_thresh(ao.dtype), differentiable)
    n_points = ao.shape[-2]
    lead = tuple(weights.shape[:-1])

    def xc_fn(dm):
        exc = torch.zeros(lead, dtype=ao.dtype, device=ao.device)
        v = torch.zeros(lead + (2,) + tuple(dm.shape[-2:]), dtype=ao.dtype,
                        device=ao.device)
        for g0 in range(0, n_points, chunk):
            sl = slice(g0, g0 + chunk)
            exc_c, v_c = one_chunk(ao[..., sl, :], ao_grad[..., sl, :], weights[..., sl], dm)
            exc = exc + exc_c
            v = v + v_c
        return exc, v

    return xc_fn


def make_xc_fn_streaming(mol, points, weights, xc_name: str, chunk: int = STREAM_CHUNK,
                         dtype=None, differentiable: bool = False, coords=None):
    """``xc_fn(dm) -> (exc, vxc (2, nao, nao))`` that evaluates the AO values
    and gradients per grid chunk: O(chunk * nao) memory instead of
    O(G * nao) (``nbed_tpu/dft/xc.py:148-188``). The last chunk is short
    where the reference pads with far-away points; the sums are the same.
    AOs are evaluated in the points' dtype and the quadrature runs in
    ``dtype`` (default: the points'). None for a functional with no grid
    terms; ``differentiable`` as in :func:`_chunk_math`; ``coords`` (Bohr)
    places the atoms, the molecule's by default."""
    terms = resolve_functional(xc_name)[0]
    if not terms:
        return None
    dtype = points.dtype if dtype is None else dtype
    one_chunk = _chunk_math(terms, _mask_thresh(dtype), differentiable)
    n_points = points.shape[0]
    weights = weights.to(dtype)
    # the atoms and shell constants on the device once, so that a call
    # copies nothing from the host (a CUDA graph can capture it)
    atoms = torch.as_tensor(mol.coords if coords is None else coords, dtype=points.dtype,
                            device=points.device)
    tables = shell_tables(mol, points.dtype, points.device)

    def xc_fn(dm):
        exc = torch.zeros((), dtype=dtype, device=points.device)
        v = torch.zeros((2,) + tuple(dm.shape[-2:]), dtype=dtype,
                        device=points.device)
        for g0 in range(0, n_points, chunk):
            sl = slice(g0, g0 + chunk)
            ao_c, grad_c = eval_aos(mol, points[sl], atoms, tables)
            exc_c, v_c = one_chunk(ao_c.to(dtype), grad_c.to(dtype), weights[sl], dm)
            exc = exc + exc_c
            v = v + v_c
        return exc, v

    return xc_fn
