"""TDA and full RPA (Casida) TDDFT with the XC kernel by forward-mode
autodiff (port of ``nbed_tpu/solvers/tddft.py``).

The TDA response of a (possibly embedded) Kohn-Sham determinant is

    A[(ia),(jb)] = F_ab d_ij - F_ij d_ab + (ia|jb) - hyb (ij|ab) + (ia|f_xc|jb),

applied matrix-free to blocks of trial vectors on the solution's device:
each vector becomes an AO transition density d = C_o X C_v^T, J and K of the
block are batched GEMMs on the engine's ERI supermatrices (or on its DF
factor), and the kernel term is ``torch.func.jvp`` of the engine's
differentiable XC closure along the symmetrised density, vectorised over
the block with ``torch.func.vmap``. The engine's ``max_memory_mb`` bounds
the memory a matvec block allocates: the block size and the XC closure's
grid chunk follow from the measured memory per trial vector
(:data:`_KERNEL_ELEMS_PER_POINT`).

The exchange of a transition density is built without symmetrising it: on
the DF route as sum_P B_P d B_P per spin, with the reference's auxiliary
chunking and the range-separated fold hyb K + beta K_LR. The reference's DF
route symmetrises K (its ``_df_k_spin``), which replaces (ij|ab) by
[(ij|ab) + (ib|ja)] / 2 in the TDA and drops the exchange of RPA's A - B; its
exact route is right, and so is this module on both.

"dense" assembles A column block by column block and diagonalises it on the
device; "davidson" is the reference's block Davidson (host subspace algebra,
thick restart, a ``RuntimeWarning`` if it stops unconverged) around the
device matvec.
"""

import warnings

import numpy as np
import torch

from .._device import DTYPE, to_host
from ..dft.xc import STREAM_CHUNK, TABLE_CHUNK
from ..ops.programs import replay
from ..profiling import span
from ..scf.engine import _Captured, _FixedProgram, _spinify, _xc_closure
from .cis import CISResult, RPAResult

__all__ = ["run_tddft_tda", "run_tddft_rpa"]

# Memory that one trial vector of a matvec block holds live, in float64
# elements per grid point of the XC chunk, as (per AO, fixed), for LDA/GGA
# and for meta-GGA functionals: the vmapped forward-over-reverse f_xc keeps
# AO-sized tangents (dominant at 126 AOs) and the functional's per-point
# intermediates (dominant at 7-18 AOs: 146 for LDA, 264 for B3LYP, 436 for
# the range-separated B97s, 779 for TPSS). The sum is a bound on every
# functional measured, at water, acetonitrile and pfoa
# (scripts/bench_response.py; PERF.md §6). The DF exchange holds four
# auxiliary chunks per vector (two densities, each product's operand copy).
_KERNEL_ELEMS_PER_POINT = {False: (7.0, 470.0), True: (13.0, 800.0)}
_DF_K_CHUNKS_PER_VECTOR = 4


def _kernel_elems_per_point(eng) -> float:
    """Float64 elements one trial vector's f_xc holds live per grid point
    of the XC chunk, by :data:`_KERNEL_ELEMS_PER_POINT`."""
    needs_tau = any(getattr(fn, "needs_tau", False) for _, fn in eng._xc_meta[0])
    per_ao, fixed = _KERNEL_ELEMS_PER_POINT[needs_tau]
    return per_ao * eng.mol.nao + fixed


def _davidson(matvec_block, diag, nroots, max_subspace=120, conv_tol=1e-8,
              max_iter=60, stats=None):
    """Block Davidson for the symmetric TDA matrix, matrix-free
    (``nbed_tpu/solvers/tddft.py:41-106``).

    ``matvec_block``: (m, N) -> (m, N) row-wise application of A, on host
    arrays. ``diag``: (N,) preconditioner. Returns (omega (nroots,), x (N,
    nroots)). ``stats``, when given, receives the iterations, the matvec
    blocks and their seconds, and the final residual norms.
    """
    n = diag.shape[0]
    nroots = min(nroots, n)
    stats = {} if stats is None else stats
    stats.update(iterations=0, matvec_blocks=0, matvec_s=0.0)

    def apply(block):
        with span("tddft.matvec") as matvec:
            out = matvec_block(block)
        stats["matvec_s"] += matvec.seconds
        stats["matvec_blocks"] += 1
        return out

    # seed with the lowest-diagonal unit vectors (orthonormal)
    seed = np.argsort(diag)[: min(max(2 * nroots, nroots + 2), n)]
    v = np.zeros((n, len(seed)))
    v[seed, np.arange(len(seed))] = 1.0
    av = apply(v.T).T  # (n, k)

    theta = ritz = rnorm = None
    for it in range(max_iter):
        stats["iterations"] = it + 1
        h = 0.5 * (v.T @ av + av.T @ v)
        vals, s = np.linalg.eigh(h)
        theta, s = vals[:nroots], s[:, :nroots]
        ritz = v @ s  # (n, nroots), orthonormal columns
        a_ritz = av @ s
        resid = a_ritz - ritz * theta[None, :]
        rnorm = np.linalg.norm(resid, axis=0)
        stats["residuals"] = rnorm.tolist()
        if np.all(rnorm < conv_tol):
            return theta, ritz

        # precondition unconverged residuals, orthogonalize, append
        new_dirs = []
        basis = v
        for r in range(nroots):
            if rnorm[r] < conv_tol:
                continue
            denom = diag - theta[r]
            denom = np.where(np.abs(denom) < 1e-8,
                             np.where(denom >= 0, 1e-8, -1e-8), denom)
            d = resid[:, r] / denom
            for _ in range(2):  # twice for orthogonality at float64
                d = d - basis @ (basis.T @ d)
                for nd_col in new_dirs:
                    d = d - nd_col * (nd_col @ d)
            norm = np.linalg.norm(d)
            if norm > 1e-10:
                new_dirs.append(d / norm)
        if not new_dirs:
            return theta, ritz
        add = np.stack(new_dirs, axis=1)

        if v.shape[1] + add.shape[1] > max_subspace:
            # thick restart: Ritz vectors (and their known products) carry over
            for _ in range(2):
                add = add - ritz @ (ritz.T @ add)
            add, _ = np.linalg.qr(add)
            v, av = ritz, a_ritz
        v = np.concatenate([v, add], axis=1)
        av = np.concatenate([av, apply(add.T).T], axis=1)

    warnings.warn(
        f"TDA Davidson did not converge in {max_iter} iterations "
        f"(worst residual {float(np.max(rnorm)):.2e} > {conv_tol:.0e}); "
        "returning the current Ritz values.", RuntimeWarning, stacklevel=2)
    return theta, ritz


def _df_k_block(b, d, chunk_elems: int):
    """Exchange sum_P B_P d B_P of each density of ``d`` (N, nao, nao), with
    no symmetrisation (the densities need not be symmetric); ``b`` is the
    (nao, naux, nao) factor, each B_P symmetric. The auxiliary axis is cut
    as the reference's DF exchange cuts it: whole below ``chunk_elems``
    elements per density, else blocks of max(256, chunk_elems // nao^2)."""
    nao, naux = b.shape[0], b.shape[1]
    chunk = naux if nao * nao * naux <= chunk_elems else \
        max(256, chunk_elems // (nao * nao))
    k = torch.zeros_like(d)
    for p0 in range(0, naux, chunk):
        b_c = b[:, p0:p0 + chunk]  # (nao, c, nao) view
        c = b_c.shape[1]
        x = (b_c.reshape(nao * c, nao) @ d).reshape(-1, nao, c * nao)  # [N, a, (P, l)]
        k += x @ b_c.reshape(nao, c * nao).T
    return k


def _df_block_jk(b, b_lr, chunk_elems: int, fold):
    """``d (B, 2, n, n) -> (J (B, n, n), K (B, 2, n, n))`` of transition
    densities on the DF factor ``b`` (and, under range separation, the
    folded hyb K + beta K_LR with ``b_lr``, ``fold`` = (hyb, beta))."""
    def jk_fn(d):
        nb, n = d.shape[0], d.shape[-1]
        rho = torch.einsum("aPb,nab->nP", b, d[:, 0] + d[:, 1])
        j = torch.einsum("aPb,nP->nab", b, rho)
        k = _df_k_block(b, d.reshape(2 * nb, n, n), chunk_elems)
        if b_lr is not None:  # fold hyb K + beta K_LR as the engine does
            k_lr = _df_k_block(b_lr, d.reshape(2 * nb, n, n), chunk_elems)
            k = fold[0] * k + fold[1] * k_lr
        return j, k.reshape(nb, 2, n, n)

    return jk_fn


def _exact_block_jk(eri_j, eri_k):
    """The J/K of :func:`_df_block_jk` on the ERI supermatrices."""
    def jk_fn(d):
        nb, n = d.shape[0], d.shape[-1]
        j = (eri_j @ (d[:, 0] + d[:, 1]).reshape(nb, -1).T).T.reshape(nb, n, n)
        k = (eri_k @ d.reshape(2 * nb, -1).T).T.reshape(nb, 2, n, n)
        return j, k

    return jk_fn


def _response_frame(scf_sol):
    """Response scaffolding of one SCF solution on its engine's device:
    occupied/virtual coefficients per spin, pair bookkeeping, the ground
    density, the differentiable XC closure and hyb, the MO Fock blocks
    (v_emb and Huzinaga folded in: a frozen environment has no response),
    a block J/K for non-symmetric AO densities and the matvec block size,
    which with the closure's grid chunk keeps a block within the engine's
    ``max_memory_mb``."""
    eng = scf_sol.engine
    n = eng.mol.nao
    c, occ = scf_sol.per_spin()
    co = [c[s][:, occ[s] > 0] for s in range(2)]
    cv = [c[s][:, occ[s] <= 0] for s in range(2)]
    shapes = [(co[s].shape[1], cv[s].shape[1]) for s in range(2)]
    sizes = [no * nv for no, nv in shapes]
    if sum(sizes) == 0:
        raise ValueError("No single excitations exist for this solution.")

    dm0 = _spinify(scf_sol.make_rdm1())
    fock = scf_sol.get_fock().expand(2, n, n)
    f_oo = [co[s].T @ fock[s] @ co[s] for s in range(2)]
    f_vv = [cv[s].T @ fock[s] @ cv[s] for s in range(2)]

    budget = eng.max_memory_mb * 1e6 / 8  # float64 elements
    per_vector = 2 * n * n
    if eng.density_fitting:
        b = eng.df_factor()
        per_vector = max(per_vector, _DF_K_CHUNKS_PER_VECTOR
                         * min(eng._df_chunk_elems, b.shape[1] * n * n))
        jk_fn = _df_block_jk(b, eng.df_factor_lr() if eng._rsh is not None else None,
                             eng._df_chunk_elems, eng._k_fold)
    else:
        jk_fn = _exact_block_jk(eng.eri_j, eng.eri_k)

    xc_fn, chunk = None, 0
    if eng._xc[0] is not None:
        per_point = _kernel_elems_per_point(eng)
        # the path's grid chunk, cut so that one vector takes at most a
        # third of the budget
        chunk = min(STREAM_CHUNK if eng._xc_streams else TABLE_CHUNK,
                    max(1024, int(budget // (3 * per_point))))
        xc_fn = eng._build_xc(DTYPE, differentiable=True, chunk=chunk)
        per_vector = max(per_vector, min(eng._grid[0].shape[0], chunk) * per_point)

    # interleaved spin-orbital pair labels (even = alpha, odd = beta)
    occ_h = to_host(occ)
    pairs = []
    for s in range(2):
        oi = np.where(occ_h[s] > 0)[0]
        ai = np.where(occ_h[s] <= 0)[0]
        ii, aa = np.meshgrid(oi, ai, indexing="ij")
        pairs.append(np.stack([2 * ii.ravel() + s, 2 * aa.ravel() + s], axis=1))

    return {
        "co": co, "cv": cv, "shapes": shapes, "sizes": sizes, "dm0": dm0,
        "xc_fn": xc_fn, "hyb": eng.hyb, "f_oo": f_oo, "f_vv": f_vv,
        "jk_fn": jk_fn, "pairs": np.concatenate(pairs, axis=0),
        "e_ref_elec": float(scf_sol.e_tot - eng.energy_nuc()),
        # one vector's worth of the budget is left to the block's fixed
        # intermediates (the kernel's primal pass, the DF factor's copies)
        "block": max(1, int(budget // per_vector) - 1), "device": dm0.device, "engine": eng,
        "vector_elems": per_vector, "xc_chunk": chunk,
    }


def _split(fr, x):
    """(B, npairs) -> per-spin (B, no, nv) amplitude blocks."""
    nb, sz = x.shape[0], fr["sizes"][0]
    return [x[:, :sz].reshape(nb, *fr["shapes"][0]),
            x[:, sz:].reshape(nb, *fr["shapes"][1])]


def _densities(fr, xs):
    """AO transition densities d_s = C_o X_s C_v^T, (B, 2, n, n)."""
    return torch.stack([torch.einsum("pi,bia,qa->bpq", fr["co"][s], xs[s], fr["cv"][s])
                        for s in range(2)], dim=1)


def _project(fr, v, xs):
    """MO (i, a) blocks of the AO response ``v`` plus the Fock part
    X F_vv - F_oo X, flattened back to (B, npairs)."""
    outs = [torch.einsum("pi,bpq,qa->bia", fr["co"][s], v[:, s], fr["cv"][s])
            + xs[s] @ fr["f_vv"][s] - fr["f_oo"][s] @ xs[s] for s in range(2)]
    return torch.cat([o.reshape(o.shape[0], -1) for o in outs], dim=1)


def _kernel_block(fr, d_sym):
    """f_xc contraction of each SYMMETRIC AO density tangent of the block:
    ``torch.func.jvp`` of the differentiable vxc at the ground density,
    vmapped over the block. The closure's gradient formula is grad-rho only
    for symmetric densities, so callers symmetrise first
    (``nbed_tpu/solvers/tddft.py:271-281``)."""
    vxc = lambda dd: fr["xc_fn"](dd)[1]  # noqa: E731
    one = lambda t: torch.func.jvp(vxc, (fr["dm0"],), (t,))[1]  # noqa: E731
    return torch.func.vmap(one)(d_sym)


def _tda_block(fr, x):
    """A (B, npairs) block of TDA products A x."""
    xs = _split(fr, x)
    d = _densities(fr, xs)
    j, k = fr["jk_fn"](d)
    v = j[:, None] - fr["hyb"] * k
    if fr["xc_fn"] is not None:
        v = v + _kernel_block(fr, 0.5 * (d + d.transpose(-1, -2)))
    return _project(fr, v, xs)


def _apb_block(fr, x):
    """(A+B) x: J(ds) + f_xc ds - hyb K(ds), ds = d + d^T."""
    xs = _split(fr, x)
    d = _densities(fr, xs)
    ds = d + d.transpose(-1, -2)
    j, k = fr["jk_fn"](ds)
    v = j[:, None] - fr["hyb"] * k
    if fr["xc_fn"] is not None:
        v = v + _kernel_block(fr, ds)
    return _project(fr, v, xs)


def _amb_block(fr, x):
    """(A-B) x: -hyb K(da), da = d - d^T (J and the kernel vanish)."""
    xs = _split(fr, x)
    d = _densities(fr, xs)
    _, k = fr["jk_fn"](d - d.transpose(-1, -2))
    return _project(fr, -fr["hyb"] * k, xs)


_BLOCKS = {"tda": _tda_block, "apb": _apb_block, "amb": _amb_block}

# the private switch of the matvec block programs: "auto" runs them on a
# CUDA device (as CUDA graphs) and the eager blocks elsewhere, True runs
# them everywhere (uncaptured off CUDA), False never (chip_smoke's
# graph-against-eager holds)
_GRAPHED = "auto"


def _programs_on(device) -> bool:
    return _GRAPHED is True or (_GRAPHED == "auto" and device.type == "cuda")


def _block_program(fr, kind: str):
    """The shared program of ``kind``'s matvec block for ``fr``'s engine
    (the reference's ``jax.jit(jax.vmap(matvec))``, ``tddft.py:139,
    343-344``): a fixed width of min(block, npairs) trial vectors in the
    input buffer "x", the products in "out"; the solution's orbitals, Fock
    blocks and ground density in buffers of their own ("co0", "cv0",
    "f_oo0", "f_vv0" and the second spin's, "dm0"); J/K and the
    differentiable XC closure over the structure's operator buffers
    (``SCFEngine._shared_jit``, which copies this engine's operators in
    where another engine's are there). One program, and one CUDA graph,
    per (kind, width, orbital shapes, XC grid chunk) and structure; the
    frame's buffers are loaded here, outside any capture."""
    eng = fr["engine"]
    npairs = sum(fr["sizes"])
    width = min(fr["block"], npairs)
    shapes, xc_chunk = tuple(fr["shapes"]), fr["xc_chunk"]
    mol, device, n = eng.mol, eng.device, eng.mol.nao
    streams = bool(eng._xc_meta[0]) and eng._xc_streams
    density_fitting, fold, chunk = eng.density_fitting, eng._k_fold, eng._df_chunk_elems
    xc, hyb = eng.xc, fr["hyb"]

    def build(ops):
        ops.fill(eng._token, eng._operand_sources(("f64",)))
        b = ops.buffers

        def zeros(*shape):
            return torch.zeros(shape, dtype=DTYPE, device=device)

        pf = {"shapes": list(shapes), "sizes": [no * nv for no, nv in shapes], "hyb": hyb,
              "co": [zeros(n, no) for no, _ in shapes], "cv": [zeros(n, nv) for _, nv in shapes],
              "f_oo": [zeros(no, no) for no, _ in shapes],
              "f_vv": [zeros(nv, nv) for _, nv in shapes], "dm0": zeros(2, n, n),
              "jk_fn": (_df_block_jk(b["b"], b.get("b_lr"), chunk, fold) if density_fitting
                        else _exact_block_jk(b["g_j"], b["g_k"])),
              "xc_fn": None if not eng._xc_meta[0] else
              _xc_closure(b, "", mol, xc, streams, DTYPE, chunk=xc_chunk, differentiable=True)}
        x, out = zeros(width, npairs), zeros(width, npairs)
        buffers = {"x": x, "out": out, "dm0": pf["dm0"]}
        for name in ("co", "cv", "f_oo", "f_vv"):
            buffers.update({f"{name}{s}": pf[name][s] for s in range(2)})
        return _FixedProgram(buffers, _Captured(lambda: out.copy_(_BLOCKS[kind](pf, x)),
                                                device, ops.pool), ops)

    prog = eng._shared_jit(f"tddft_{kind}", build, (width, shapes, xc_chunk))
    prog.buffers["dm0"].copy_(fr["dm0"])
    for name in ("co", "cv", "f_oo", "f_vv"):
        for s in range(2):
            prog.buffers[f"{name}{s}"].copy_(fr[name][s])
    return prog


def _blockwise(fr, kind: str, x):
    """``kind``'s matvec over row blocks of ``x`` (B, npairs): on the card
    (see :data:`_GRAPHED`) replays of the block program, each block copied
    into its fixed-width input with the last one padded by zero rows,
    which are dropped after; otherwise eager blocks of at most the frame's
    block size."""
    if not _programs_on(fr["device"]):
        return torch.cat([_BLOCKS[kind](fr, x[r0:r0 + fr["block"]])
                          for r0 in range(0, x.shape[0], fr["block"])], dim=0)
    prog = _block_program(fr, kind)
    x_buf, out = prog.buffers["x"], prog.buffers["out"]
    width, parts = x_buf.shape[0], []
    for r0 in range(0, x.shape[0], width):
        part = x[r0:r0 + width]
        x_buf[:part.shape[0]].copy_(part)
        x_buf[part.shape[0]:].zero_()
        replay(prog.captured, f"tddft_{kind}_graph")
        parts.append(out[:part.shape[0]].clone())
    return torch.cat(parts, dim=0)


def _dense(fr, matvec):
    """The full response matrix from the matvec on the identity,
    symmetrised (real orbitals)."""
    npairs = sum(fr["sizes"])
    a_mat = matvec(torch.eye(npairs, dtype=DTYPE, device=fr["device"]))
    return 0.5 * (a_mat + a_mat.T)


def run_tddft_tda(scf_sol, nroots: int | None = None, method: str = "auto",
                  max_subspace: int = 120, conv_tol: float = 1e-8,
                  max_iter: int = 60, stats: dict | None = None) -> CISResult:
    """TDA excitation spectrum of an :class:`SCFSolution`, on its device.

    On a Hartree-Fock engine this is CIS; with a functional it is TDA-TDDFT
    with the autodiff f_xc kernel. Global and embedded solutions alike: the
    full F_ij / F_ab blocks serve truncated and non-canonical MO sets.
    ``method``: "dense" diagonalises the assembled A; "davidson" runs the
    block Davidson; "auto" takes Davidson when ``nroots`` is set and the
    pair space exceeds ``max_subspace``. ``stats`` (Davidson only) receives
    its iterations, matvec blocks, their seconds and the final residuals.

    Returns a :class:`CISResult` (interleaved spin-orbital ``pairs``, even =
    alpha), so :func:`oscillator_strengths` and :func:`spin_labels` apply.
    """
    fr = _response_frame(scf_sol)

    def matvec(x):
        return _blockwise(fr, "tda", x)

    npairs = sum(fr["sizes"])
    if method == "auto":
        method = "davidson" if nroots is not None and npairs > max_subspace else "dense"
    if method == "dense":
        omega, x = torch.linalg.eigh(_dense(fr, matvec))
        omega, x = to_host(omega), to_host(x)
        if nroots is not None:
            omega, x = omega[:nroots], x[:, :nroots]
    elif method == "davidson":
        if nroots is None:
            raise ValueError("method='davidson' needs nroots.")
        # diagonal preconditioner: orbital-energy differences
        diag = np.concatenate([
            (to_host(torch.diagonal(fr["f_vv"][s]))[None, :]
             - to_host(torch.diagonal(fr["f_oo"][s]))[:, None]).ravel()
            for s in range(2)])
        omega, x = _davidson(
            lambda block: to_host(matvec(torch.as_tensor(block, dtype=DTYPE,
                                                         device=fr["device"]))),
            diag, nroots, max_subspace=max_subspace, conv_tol=conv_tol,
            max_iter=max_iter, stats=stats)
    else:
        raise ValueError(f"method must be 'auto', 'dense' or 'davidson', got {method!r}")
    return CISResult(excitations=omega, amplitudes=np.ascontiguousarray(x.T),
                     pairs=fr["pairs"], e_ref_elec=fr["e_ref_elec"])


def run_tddft_rpa(scf_sol, nroots: int | None = None) -> RPAResult:
    """Full (non-TDA) RPA-TDDFT spectrum with the autodiff f_xc kernel.

    Solves [[A, B], [-B, -A]] through the Hermitian reduction of
    :func:`run_rpa`, with (A+B) and (A-B) from the symmetrised and
    antisymmetrised transition densities:

        (A+B)X: J(ds) + f_xc ds - hyb K(ds),   ds = d + d^T
        (A-B)X: -hyb K(da),                    da = d - d^T

    (J and the kernel vanish on the antisymmetric part). On an ``xc=None``
    engine this equals :func:`run_rpa` on the builder integrals.
    """
    fr = _response_frame(scf_sol)
    apb_mat = _dense(fr, lambda x: _blockwise(fr, "apb", x))
    amb_mat = _dense(fr, lambda x: _blockwise(fr, "amb", x))

    amb_vals, amb_vecs = torch.linalg.eigh(amb_mat)
    n_imag_amb = int(torch.sum(amb_vals < -1e-10))
    half = (amb_vecs * torch.sqrt(torch.clamp(amb_vals, min=0.0))) @ amb_vecs.T
    w2, z = torch.linalg.eigh(half @ apb_mat @ half)
    n_imag = int(torch.sum(w2 < -1e-10)) + n_imag_amb
    omega = torch.sqrt(torch.clamp(w2, min=0.0))

    safe = torch.where(omega > 1e-12, omega, torch.ones_like(omega))
    xpy = (half @ z) / torch.sqrt(safe)[None, :]
    xmy = (apb_mat @ xpy) / safe[None, :]
    if nroots is not None:
        omega, xpy, xmy = omega[:nroots], xpy[:, :nroots], xmy[:, :nroots]
    return RPAResult(excitations=to_host(omega),
                     amplitudes=np.ascontiguousarray(to_host(xpy).T),
                     pairs=fr["pairs"], e_ref_elec=fr["e_ref_elec"],
                     xmy=np.ascontiguousarray(to_host(xmy).T), n_imaginary=n_imag)
