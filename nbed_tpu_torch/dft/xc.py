"""Grid XC evaluation (port of the table path of ``nbed_tpu/dft/xc.py``).

The potential matrices are derived from the energy-density closure by
``torch.autograd.grad`` (the reference uses ``jax.value_and_grad``), so the
closed forms in :mod:`.functionals` are the single source of truth. The
per-call cost is a handful of (G, nao) x (nao, nao) products, taken over
grid chunks with the (exc, vxc) sums accumulated across them.

Not ported: the streaming path that re-evaluates AOs per chunk for grids
whose AO table does not fit, and the tau path of meta-GGAs (ROADMAP queue
1 item 8).
"""

import torch

from .functionals import resolve_functional

__all__ = ["make_xc_fn"]

# density cut below which grid points are masked out of the XC math: the
# reference's float64 CPU value (xc.py:24-34)
_MASK_THRESH = 1e-11


def _chunk_math(terms):
    """Per-chunk energy + potential contributions from AO tables."""

    def e_density(ra, rb, gaa, gab, gbb):
        mask = (ra + rb) > _MASK_THRESH

        def safe(x):
            return torch.where(mask, x, torch.ones_like(x))

        out = 0.0
        for coef, fn in terms:
            out = out + coef * fn(safe(ra), safe(rb), safe(gaa), safe(gab),
                                  safe(gbb))
        return torch.where(mask, out, torch.zeros_like(out))

    def one_chunk(ao_c, grad_c, w_c, dm):
        ao_d = torch.einsum("gp,spq->sgq", ao_c, dm)  # (2, C, nao)
        rho = torch.einsum("sgq,gq->sg", ao_d, ao_c)
        grho = 2.0 * torch.einsum("dgq,sgq->sdg", grad_c, ao_d)  # (2, 3, C)
        gaa = torch.einsum("dg,dg->g", grho[0], grho[0])
        gbb = torch.einsum("dg,dg->g", grho[1], grho[1])
        gab = torch.einsum("dg,dg->g", grho[0], grho[1])
        inputs = [t.detach().requires_grad_(True)
                  for t in (rho[0], rho[1], gaa, gab, gbb)]
        with torch.enable_grad():
            exc = torch.sum(w_c * e_density(*inputs))
            vra, vrb, vgaa, vgab, vgbb = torch.autograd.grad(exc, inputs)

        def vmat(vr, vg_ss, vg_ab, grho_s, grho_t):
            m = torch.einsum("g,gp,gq->pq", vr, ao_c, ao_c)
            vec = 2.0 * vg_ss[None, :] * grho_s + vg_ab[None, :] * grho_t
            half = torch.einsum("dg,dgp,gq->pq", vec, grad_c, ao_c)
            return m + half + half.T

        va = vmat(vra, vgaa, vgab, grho[0], grho[1])
        vb = vmat(vrb, vgbb, vgab, grho[1], grho[0])
        return exc.detach(), torch.stack([va, vb])

    return one_chunk


def make_xc_fn(ao, ao_grad, weights, xc_name: str, chunk: int = 131072):
    """``xc_fn(dm) -> (exc, vxc (2, nao, nao))`` from precomputed AO tables
    (``ao`` (G, nao), ``ao_grad`` (3, G, nao), ``weights`` (G,))."""
    terms = resolve_functional(xc_name)[0]
    one_chunk = _chunk_math(terms)
    n_points = ao.shape[0]

    def xc_fn(dm):
        exc = torch.zeros((), dtype=ao.dtype, device=ao.device)
        v = torch.zeros((2,) + tuple(dm.shape[-2:]), dtype=ao.dtype,
                        device=ao.device)
        for g0 in range(0, n_points, chunk):
            sl = slice(g0, g0 + chunk)
            exc_c, v_c = one_chunk(ao[sl], ao_grad[:, sl], weights[sl], dm)
            exc = exc + exc_c
            v = v + v_c
        return exc, v

    return xc_fn
