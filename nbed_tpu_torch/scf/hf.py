"""Spin-generic SCF with DIIS (port of ``nbed_tpu/scf/hf.py``).

Density matrices carry a leading spin axis ``(2, n, n)``; the DIIS history
is a fixed ring buffer, as in the reference. The reference's
``lax.while_loop`` becomes a Python loop whose convergence test reads two
scalars back to the host each cycle. One J/K build per cycle goes through
the ``jk_fn`` hook (the engine passes the fused J/K kernel of
:mod:`nbed_tpu_torch.ops.jk`).

``rohf=True`` runs ROHF/ROKS: Roothaan's single effective Fock replaces the
per-spin pair before the DIIS error and the diagonalisation, so both spins
share spatial orbitals; energies still come from the per-spin Fock.

Mixed precision (``jk_fn_fast``, ``xc_fn_fast``): the incremental loop
contracts each cycle's density *change* in float32 and adds it to the
float64 J/K of the previous cycle, rebuilding J/K in float64 every
``rebase_every`` cycles; coarse cycles may take float32 XC. A short
float64 polish loop then lands on the float64 fixed point
(``nbed_tpu/scf/hf.py:299-429``). The reference's ``lax.cond`` branches
become Python ``if`` on host scalars.

Lanes: an ``s`` of shape (B, n, n) runs B SCFs at once (a batch of
conformers), the reference's ``vmap`` of its ``while_loop``. Every operator
and the DIIS history carry the lane axis, ``eigh`` and the DIIS solve are
batched ``torch.linalg`` calls, and the loop reads one (B,) convergence
tensor per cycle. A converged lane is frozen: as the vmapped loop selects
the old carry where a lane's condition is false, each cycle's update is
taken only on the lanes still running, so lane b ends where the same
geometry run alone ends, in the same number of cycles. The lane form takes
the float64 operators of HF, KS and Huzinaga SCFs; ROHF and the mixed
precision modes stay single-geometry.

``grad_cycles`` (``nbed_tpu/scf/hf.py:431-455``) adds that many DIIS-free
cycles, damped by 0.5, after a converged loop: a no-op on the converged
density, which lets forward-mode tangents (``torch.autograd.forward_ad``)
settle on the implicit-function derivative. The DIIS mixing coefficients
are detached, as the reference stops their gradient: at the fixed point
they carry no derivative, and differentiating the ``eigh`` of the padded
DIIS matrix, whose empty slots are degenerate, makes every tangent NaN.

Not ported: the TPU-only Newton refinement of ``eigh`` (a no-op off the TPU,
``hf.py:63-66``).
"""

from dataclasses import dataclass
from typing import Callable, Optional

import torch

__all__ = ["SCFResult", "run_scf", "make_rdm1", "lowdin_x", "huzinaga_operator"]

DIIS_SPACE = 8  # Pulay history length (the reference's default)


@dataclass
class SCFResult:
    """Converged SCF data (always spin-resolved). A lane run's result has a
    lane axis in front of every tensor, and ``e_elec`` (B,), ``converged``
    (B,) and ``n_iter`` (B,) are tensors."""

    mo_coeff: torch.Tensor  # (2, n, n)
    mo_energy: torch.Tensor  # (2, n)
    mo_occ: torch.Tensor  # (2, n) of 0/1 (electrons per spin orbital)
    dm: torch.Tensor  # (2, n, n)
    e_elec: float  # electronic energy (add nuclear repulsion for e_tot)
    converged: bool
    fock: torch.Tensor  # (2, n, n) final Fock (incl. v_emb + huzinaga)
    huzinaga_op: torch.Tensor  # (2, n, n) final Huzinaga operator (zeros if off)
    n_iter: int


def make_rdm1(mo_coeff, mo_occ):
    """D_sigma = C diag(occ) C^T with 0/1 spin-orbital occupations; leading
    lane axes ride along."""
    return torch.einsum("...spi,...si,...sqi->...spq", mo_coeff, mo_occ, mo_coeff)


def lowdin_x(s):
    """S^{-1/2} via eigh, of (n, n) or (B, n, n)."""
    w, v = torch.linalg.eigh(s)
    return (v * (1.0 / torch.sqrt(w))[..., None, :]) @ v.transpose(-1, -2)


def huzinaga_operator(fock, dm_occ_s, dm_virt_s):
    """-(F D S + S D F) per spin, plus the virtual-space variant
    (``nbed_tpu/scf/hf.py:91-106``); leading lane axes ride along."""
    fds_occ = torch.einsum("...sij,...sjk->...sik", fock, dm_occ_s)
    huz = -(fds_occ + fds_occ.transpose(-1, -2))
    fds_virt = torch.einsum("...sij,...sjk->...sik", fock, dm_virt_s)
    huz_virt = -(
        fds_virt
        + fds_virt.transpose(-1, -2)
        - 2.0 * torch.einsum("...sij,...sjk->...sik", dm_virt_s.transpose(-1, -2), fds_virt)
    )
    return huz + huz_virt


def roothaan_effective(f, dm, s):
    """Roothaan's effective Fock for ROHF/ROKS, stacked on the spin axis
    (``nbed_tpu/scf/hf.py:232-247``). Projector form with closed = beta
    occupied, open = alpha minus beta, virtual = alpha unoccupied: the
    diagonal blocks couple through (Fa+Fb)/2, closed-open through Fb,
    open-virtual through Fa, closed-virtual through (Fa+Fb)/2."""
    n = s.shape[-1]
    fc = 0.5 * (f[0] + f[1])
    pc = dm[1] @ s
    po = (dm[0] - dm[1]) @ s
    pv = torch.eye(n, dtype=f.dtype, device=f.device) - dm[0] @ s
    feff = (0.5 * (pc.T @ fc @ pc + po.T @ fc @ po + pv.T @ fc @ pv)
            + po.T @ f[1] @ pc + po.T @ f[0] @ pv + pv.T @ fc @ pc)
    feff = feff + feff.T
    return torch.stack([feff, feff])


def _diis_extrapolate(hist_f, hist_e, nfill: int):
    """Pulay extrapolation of the history Focks ([B,] m, 2, n, n) over the
    filled slots of the ring buffer, with the reference's eigh pseudo-inverse
    and relative cut (``hf.py:260-292``), per lane. The coefficients come
    from the detached errors, so no derivative reaches them."""
    hist_e = hist_e.detach()
    m = hist_e.shape[-4]
    lead = tuple(hist_e.shape[:-4])
    dtype, device = hist_e.dtype, hist_e.device
    flat_e = hist_e.reshape(*lead, m, -1)
    b = flat_e @ flat_e.transpose(-1, -2)
    filled = (torch.arange(m, device=device) < nfill).to(dtype)
    b = b * (filled[:, None] * filled[None, :]) + torch.diag(1.0 - filled)
    big = torch.zeros((*lead, m + 1, m + 1), dtype=dtype, device=device)
    big[..., :m, :m] = b
    big[..., :m, m] = filled
    big[..., m, :m] = filled
    rhs = torch.zeros(m + 1, dtype=dtype, device=device)
    rhs[m] = 1.0
    ew, ev = torch.linalg.eigh(big)
    cut = torch.amax(torch.abs(ew), dim=-1, keepdim=True) * max(
        1e-12, (m + 1) * torch.finfo(dtype).eps)
    inv_ew = torch.where(torch.abs(ew) > cut, 1.0 / ew, torch.zeros_like(ew))
    proj = ev.transpose(-1, -2) @ rhs
    if lead:  # a column per lane
        proj = proj[..., None]
    coef = ((ev * inv_ew[..., None, :]) @ proj).reshape(*lead, m + 1)[..., :m] * filled
    return torch.einsum("...h,...hsij->...sij", coef, hist_f)


def run_scf(
    *,
    hcore,  # (n, n) or (2, n, n)
    s,  # (n, n)
    nelec,  # (n_alpha, n_beta)
    jk_fn: Callable,  # dm (2,n,n) -> (j (n,n), k (2,n,n))
    jk_fn_fast: Optional[Callable] = None,  # float32 J/K of density changes
    rebase_every: int = 8,  # full-precision J/K rebuild period (incremental)
    xc_fn_fast: Optional[Callable] = None,  # float32 XC for coarse cycles
    xc_switch_tol: float = 1e-4,  # |dDM| below which the loop's XC is f64
    v_emb=None,  # (2, n, n) embedding potential added to hcore
    xc_fn: Optional[Callable] = None,  # dm -> (exc, vxc (2,n,n))
    hyb: float = 1.0,  # HF-exchange fraction (1.0 = HF, 0.2 = B3LYP)
    dm_env_occ=None,  # (2, n, n) Huzinaga occupied env density (per spin)
    dm_env_virt=None,  # (2, n, n) Huzinaga virtual env density (per spin)
    dm0=None,  # (2, n, n) initial guess
    conv_tol: float = 1e-6,
    dm_conv_tol: float = 1e-6,
    max_cycle: int = 50,
    level_shift: float = 0.0,  # virtual-orbital level shift (Ha)
    rohf: bool = False,  # restricted open shell: shared spatial orbitals
    use_diis: bool = True,  # False: plain Roothaan iterations
    grad_cycles: int = 0,  # damped DIIS-free cycles after convergence (tangents)
) -> SCFResult:
    """Run SCF to convergence.

    Fock matrix: ``F_s = hcore + v_emb + J(D_tot) + Vxc_s - hyb*K(D_s)
    + Huz(F)``; energies follow the reference's embedded conventions (the
    Huzinaga term enters the one-body energy in full, ``v_emb`` is part of
    the core Hamiltonian). The loop runs in the dtype of ``hcore``: float32
    operators give the mixed-precision warm-up.

    With ``jk_fn_fast`` each cycle takes ``J(D) = J(D_ref) + J32(D -
    D_ref)`` (likewise K), D_ref the previous cycle's density, and every
    ``rebase_every``-th cycle (the first included) builds J/K in full with
    ``jk_fn``. With ``xc_fn_fast`` a cycle whose previous density change
    exceeded ``xc_switch_tol`` evaluates XC in float32. Either option ends
    with a pure full-precision polish loop from the mixed loop's density,
    which sets the returned convergence flag; ``n_iter`` counts both loops.

    An ``s`` of shape (B, n, n) runs B lanes (see the module docstring):
    ``hcore`` (B, n, n) or (B, 2, n, n), ``v_emb``, ``dm_env_*`` and ``dm0``
    (B, 2, n, n), ``jk_fn`` maps (B, 2, n, n) densities to (J (B, n, n),
    K (B, 2, n, n)) and ``xc_fn`` to (exc (B,), vxc (B, 2, n, n)).
    """
    if s.ndim == 3:
        if rohf or jk_fn_fast is not None or xc_fn_fast is not None:
            raise ValueError("run_scf over lanes takes neither rohf nor the mixed-precision "
                             "options")
        return _run_scf_lanes(
            hcore=hcore, s=s, nelec=nelec, jk_fn=jk_fn, v_emb=v_emb, xc_fn=xc_fn, hyb=hyb,
            dm_env_occ=dm_env_occ, dm_env_virt=dm_env_virt, dm0=dm0, conv_tol=conv_tol,
            dm_conv_tol=dm_conv_tol, max_cycle=max_cycle, level_shift=level_shift,
            use_diis=use_diis, grad_cycles=grad_cycles)
    n = s.shape[-1]
    if hcore.ndim == 2:
        hcore = torch.stack([hcore, hcore])
    if v_emb is None:
        v_emb = torch.zeros((2, n, n), dtype=hcore.dtype, device=hcore.device)
    elif v_emb.ndim == 2:
        v_emb = torch.stack([v_emb, v_emb])
    v_emb = v_emb.to(hcore.dtype)
    x = lowdin_x(s)
    h_eff = hcore + v_emb

    use_huz = dm_env_occ is not None
    if use_huz:
        dm_occ_s = torch.einsum("sij,jk->sik", dm_env_occ, s)
        if dm_env_virt is None:
            dm_virt_s = torch.zeros_like(dm_occ_s)
        else:
            dm_virt_s = torch.einsum("sij,jk->sik", dm_env_virt, s)

    na, nb = int(nelec[0]), int(nelec[1])
    ar = torch.arange(n, device=s.device)
    occ = torch.stack([(ar < na).to(s.dtype), (ar < nb).to(s.dtype)])

    def assemble_fock(dm, j, k, xc=xc_fn):
        """(F incl. huz, huz, e_elec of dm) from dm and its J/K pair."""
        vhf = j[None] - hyb * k
        if xc is not None:
            exc, vxc = xc(dm)
            vhf = vhf + vxc
        else:
            exc = 0.0
        f0 = h_eff + vhf
        if use_huz:
            huz = huzinaga_operator(f0, dm_occ_s, dm_virt_s)
            f = f0 + huz
        else:
            huz = torch.zeros_like(f0)
            f = f0
        e1 = torch.einsum("sij,sji->", h_eff + huz, dm)
        ecoul = 0.5 * torch.einsum("ij,ji->", j, dm[0] + dm[1])
        ex_hf = -0.5 * hyb * torch.einsum("sij,sji->", k, dm)
        return f, huz, e1 + ecoul + ex_hf + exc

    def xc_f32(dm):
        exc, vxc = xc_fn_fast(dm.to(torch.float32))
        return exc.to(dm.dtype), vxc.to(dm.dtype)

    def eig_fock(f):
        f_ortho = torch.einsum("pi,spq,qj->sij", x, f, x)
        mo_e, c_ortho = torch.linalg.eigh(f_ortho)
        return mo_e, torch.einsum("pi,sij->spj", x, c_ortho)

    if dm0 is None:
        # core-Hamiltonian guess (+projectors), as the reference's
        # Huzinaga loop does
        f_init = h_eff
        if use_huz:
            f_init = f_init + huzinaga_operator(f_init, dm_occ_s, dm_virt_s)
        _, c0 = eig_fock(f_init)
        dm0 = make_rdm1(c0, occ)

    def step(dm, j, k, xc, damp: float = 0.0):
        """(dm', e of dm, c, mo_e) of one DIIS-free cycle with ``dm``'s J/K,
        ``dm`` mixed in by ``damp``: the tangent polish's step."""
        f, _, e_cur = assemble_fock(dm, j, k, xc)
        mo_e, c = eig_fock(f)
        dm_new = make_rdm1(c, occ)
        return (1.0 - damp) * dm_new + damp * dm, e_cur, c, mo_e

    def loop(dm, e_prev, c, mo_e, inc: bool, xcfast: bool):
        """SCF cycles from ``dm`` until convergence or ``max_cycle``, with a
        fresh DIIS history; returns (dm, e, c, mo_e, converged, cycles)."""
        m = DIIS_SPACE
        hist_f = torch.zeros((m, 2, n, n), dtype=dm.dtype, device=dm.device)
        hist_e = torch.zeros_like(hist_f)
        nfill = 0
        ddm = float("inf")
        conv = False
        cycle = 0
        while cycle < max_cycle and not conv:
            xc = xc_f32 if xcfast and ddm > xc_switch_tol else xc_fn
            if inc:
                if cycle % rebase_every == 0:
                    j, k = jk_fn(dm)
                else:
                    jd, kd = jk_fn_fast((dm - dm_ref).to(torch.float32))
                    j = j_ref + jd.to(dm.dtype)
                    k = k_ref + kd.to(dm.dtype)
                dm_ref, j_ref, k_ref = dm, j, k
            else:
                j, k = jk_fn(dm)
            f, _, e_cur = assemble_fock(dm, j, k, xc)
            if rohf:
                # the per-spin error of F_eff covers every coupling block:
                # D_beta tests closed-open and closed-virtual, D_alpha
                # open-virtual
                f = roothaan_effective(f, dm, s)
            fds = torch.einsum("sij,sjk,kl->sil", f, dm, s)
            err = torch.einsum("pi,spq,qj->sij", x, fds - fds.transpose(-1, -2), x)
            slot = cycle % m
            hist_f[slot] = f
            hist_e[slot] = err
            nfill = min(nfill + 1, m)
            f_use = f
            if cycle > 0 and use_diis:
                f_use = _diis_extrapolate(hist_f, hist_e, nfill)
            if level_shift:
                # F' = F + lambda (S - S D_s S) shifts only the virtual
                # eigenvalues, damping occupied<->virtual oscillation
                sds = torch.einsum("ij,sjk,kl->sil", s, dm, s)
                f_use = f_use + level_shift * (s[None] - sds)
            mo_e, c = eig_fock(f_use)
            dm_new = make_rdm1(c, occ)
            e_cur = float(e_cur)
            de = abs(e_cur - e_prev)
            ddm = float(torch.max(torch.linalg.matrix_norm(dm_new - dm)))
            conv = de < conv_tol and ddm < dm_conv_tol
            e_prev = e_cur
            dm = dm_new
            cycle += 1
        return dm, e_prev, c, mo_e, conv, cycle

    dm = dm0.to(h_eff.dtype)
    c = torch.zeros((2, n, n), dtype=dm.dtype, device=dm.device)
    mo_e = torch.zeros((2, n), dtype=dm.dtype, device=dm.device)
    inc = jk_fn_fast is not None
    xcfast = xc_fn_fast is not None and xc_fn is not None
    dm, e_prev, c, mo_e, conv, cycles = loop(dm, float("inf"), c, mo_e, inc, xcfast)
    if inc or xcfast:
        # full-precision polish: the mixed loop's fixed point carries its
        # float32 contraction noise, and a few pure cycles from its density
        # land on the float64 fixed point
        dm, e_prev, c, mo_e, conv, more = loop(dm, e_prev, c, mo_e, False, False)
        cycles += more
    if grad_cycles and conv:
        for _ in range(grad_cycles):
            j, k = jk_fn(dm)
            dm, _, c, mo_e = step(dm, j, k, xc_fn, damp=0.5)

    j, k = jk_fn(dm)
    f_fin, huz_fin, e_fin = assemble_fock(dm, j, k)
    return SCFResult(
        mo_coeff=c, mo_energy=mo_e, mo_occ=occ, dm=dm, e_elec=float(e_fin),
        converged=conv, fock=f_fin, huzinaga_op=huz_fin, n_iter=cycles,
    )


def _run_scf_lanes(*, hcore, s, nelec, jk_fn, v_emb, xc_fn, hyb, dm_env_occ, dm_env_virt,
                   dm0, conv_tol, dm_conv_tol, max_cycle, level_shift, use_diis,
                   grad_cycles) -> SCFResult:
    """:func:`run_scf` over a leading lane axis (see the module docstring)."""
    nb, n = s.shape[0], s.shape[-1]
    dtype, device = s.dtype, s.device
    if hcore.ndim == 3:
        hcore = torch.stack([hcore, hcore], dim=1)
    if v_emb is None:
        v_emb = torch.zeros_like(hcore)
    elif v_emb.ndim == 3:
        v_emb = torch.stack([v_emb, v_emb], dim=1)
    x = lowdin_x(s)
    h_eff = hcore + v_emb.to(hcore.dtype)

    use_huz = dm_env_occ is not None
    if use_huz:
        dm_occ_s = torch.einsum("bsij,bjk->bsik", dm_env_occ, s)
        dm_virt_s = (torch.zeros_like(dm_occ_s) if dm_env_virt is None
                     else torch.einsum("bsij,bjk->bsik", dm_env_virt, s))

    ar = torch.arange(n, device=device)
    occ = torch.stack([(ar < int(nelec[0])).to(dtype), (ar < int(nelec[1])).to(dtype)])
    occ = occ.expand(nb, 2, n)

    def assemble_fock(dm, j, k):
        vhf = j[:, None] - hyb * k
        if xc_fn is not None:
            exc, vxc = xc_fn(dm)
            vhf = vhf + vxc
        else:
            exc = 0.0
        f0 = h_eff + vhf
        if use_huz:
            huz = huzinaga_operator(f0, dm_occ_s, dm_virt_s)
            f = f0 + huz
        else:
            huz = torch.zeros_like(f0)
            f = f0
        e1 = torch.einsum("bsij,bsji->b", h_eff + huz, dm)
        ecoul = 0.5 * torch.einsum("bij,bji->b", j, dm[:, 0] + dm[:, 1])
        ex_hf = -0.5 * hyb * torch.einsum("bsij,bsji->b", k, dm)
        return f, huz, e1 + ecoul + ex_hf + exc

    def eig_fock(f):
        f_ortho = torch.einsum("bpi,bspq,bqj->bsij", x, f, x)
        mo_e, c_ortho = torch.linalg.eigh(f_ortho)
        return mo_e, torch.einsum("bpi,bsij->bspj", x, c_ortho)

    if dm0 is None:
        f_init = h_eff
        if use_huz:
            f_init = f_init + huzinaga_operator(f_init, dm_occ_s, dm_virt_s)
        dm0 = make_rdm1(eig_fock(f_init)[1], occ)

    def take(mask, new, old):
        """``new`` on the lanes of ``mask``, ``old`` elsewhere."""
        return torch.where(mask.reshape((nb,) + (1,) * (new.ndim - 1)), new, old)

    m = DIIS_SPACE
    dm = dm0.to(dtype)
    hist_f = torch.zeros((nb, m, 2, n, n), dtype=dtype, device=device)
    hist_e = torch.zeros_like(hist_f)
    c = torch.zeros((nb, 2, n, n), dtype=dtype, device=device)
    mo_e = torch.zeros((nb, 2, n), dtype=dtype, device=device)
    e_prev = torch.full((nb,), float("inf"), dtype=dtype, device=device)
    conv = torch.zeros(nb, dtype=torch.bool, device=device)
    cycles = torch.zeros(nb, dtype=torch.int64, device=device)
    it = 0
    running = True
    while it < max_cycle and running:
        active = ~conv  # the lanes this cycle updates
        j, k = jk_fn(dm)
        f, _, e_cur = assemble_fock(dm, j, k)
        fds = torch.einsum("bsij,bsjk,bkl->bsil", f, dm, s)
        err = torch.einsum("bpi,bspq,bqj->bsij", x, fds - fds.transpose(-1, -2), x)
        hist_f[:, it % m] = f
        hist_e[:, it % m] = err
        f_use = f
        if it > 0 and use_diis:
            f_use = _diis_extrapolate(hist_f, hist_e, min(it + 1, m))
        if level_shift:
            sds = torch.einsum("bij,bsjk,bkl->bsil", s, dm, s)
            f_use = f_use + level_shift * (s[:, None] - sds)
        mo_e_new, c_new = eig_fock(f_use)
        dm_new = make_rdm1(c_new, occ)
        de = torch.abs(e_cur - e_prev)
        ddm = torch.amax(torch.linalg.matrix_norm(dm_new - dm), dim=-1)
        now = (de < conv_tol) & (ddm < dm_conv_tol)
        dm = take(active, dm_new, dm)
        e_prev = take(active, e_cur, e_prev)
        c = take(active, c_new, c)
        mo_e = take(active, mo_e_new, mo_e)
        conv = conv | (active & now)
        cycles = cycles + active.to(cycles.dtype)
        it += 1
        running = not bool(conv.all().cpu())  # the cycle's one host read
    if grad_cycles and bool(conv.any()):
        for _ in range(grad_cycles):
            j, k = jk_fn(dm)
            f, _, _ = assemble_fock(dm, j, k)
            mo_e_new, c_new = eig_fock(f)
            dm = take(conv, 0.5 * make_rdm1(c_new, occ) + 0.5 * dm, dm)
            c = take(conv, c_new, c)
            mo_e = take(conv, mo_e_new, mo_e)

    j, k = jk_fn(dm)
    f_fin, huz_fin, e_fin = assemble_fock(dm, j, k)
    return SCFResult(
        mo_coeff=c, mo_energy=mo_e, mo_occ=occ, dm=dm, e_elec=e_fin, converged=conv,
        fock=f_fin, huzinaga_op=huz_fin, n_iter=cycles,
    )
