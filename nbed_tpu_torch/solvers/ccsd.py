"""Spin-orbital CCSD with Stanton-Gauss-Watts-Bartlett intermediates and
the perturbative (T) correction (port of ``nbed_tpu/solvers/ccsd.py``).

The amplitude equations run as torch einsums on the integrals' device. The
reference's jitted programs become the port's: the whole amplitude solve
(its ``lax.while_loop`` with the on-device Pulay-DIIS ring buffer) keeps
all of its state in device buffers (:class:`_SweepProgram`), and on a CUDA
card ``SWEEP_CYCLES`` cycles run as one CUDA-graph replay followed by one
host read of a small status vector; the (T) energy's whole chunk loop is
one replay (:class:`_TriplesProgram`). Both are cached by shape, dtype and
card as the reference's ``lru_cache(maxsize=8)`` caches its programs, so a
second solve of the same size captures nothing. Off the card the same
cycle function and (T) body run uncaptured.

Precision modes as in the reference (``ccsd.py:287-381``): ``"f64"``, one
float64 sweep; ``"f32"``, one float32 sweep; ``"mixed"``, the float32 sweep
then a float64 polish seeded from its amplitudes; ``"auto"`` is ``"f64"``
(the reference picks ``"mixed"`` only on a TPU, where float64 is emulated).
The float32 sweep runs with TF32 off and float32 matmul precision
``"highest"``: TF32's 10-bit mantissa is too coarse for the amplitude fixed
point. (T) always runs in float64, on float32 amplitudes upcast.
"""

import logging
from contextlib import contextmanager

import torch

from ..ops import eigh as eigh_ops
from ..ops.programs import RUNS, Captured, cached_program, card, replay

__all__ = ["run_ccsd"]

logger = logging.getLogger(__name__)

DIIS_DIM = 6  # amplitude-DIIS history length (the reference's default)
# elements of one (chunk, nv, nv, nv) block of the (T) energy; about ten
# such blocks are live per chunk (~0.7 GB in float64)
_T_BLOCK_ELEMS = 1 << 23


def _antisymmetrized(so_h2):
    """<pq||rs> from the HamiltonianBuilder's a+a+aa coefficient tensor:
    coeff[p,q,r,s] = 0.5 * <pq|sr>  =>  <pq|rs> = 2 * coeff[p,q,s,r]."""
    v = 2.0 * so_h2.permute(0, 1, 3, 2)
    return v - v.permute(0, 1, 3, 2)


def _ccsd_step(t1, t2, f, w, d1, d2, no: int, nv: int):
    """One amplitude update -> (t1_new, t2_new, e_corr)."""
    o = slice(0, no)
    v = slice(no, no + nv)
    es = torch.einsum

    tau_t = t2 + 0.5 * (es("ia,jb->ijab", t1, t1) - es("ib,ja->ijab", t1, t1))
    tau = t2 + (es("ia,jb->ijab", t1, t1) - es("ib,ja->ijab", t1, t1))

    fae = f[v, v] - torch.diag(torch.diag(f[v, v]))
    fae = fae - 0.5 * es("me,ma->ae", f[o, v], t1)
    fae = fae + es("mf,mafe->ae", t1, w[o, v, v, v])
    fae = fae - 0.5 * es("mnaf,mnef->ae", tau_t, w[o, o, v, v])

    fmi = f[o, o] - torch.diag(torch.diag(f[o, o]))
    fmi = fmi + 0.5 * es("ie,me->mi", t1, f[o, v])
    fmi = fmi + es("ne,mnie->mi", t1, w[o, o, o, v])
    fmi = fmi + 0.5 * es("inef,mnef->mi", tau_t, w[o, o, v, v])

    fme = f[o, v] + es("nf,mnef->me", t1, w[o, o, v, v])

    wmnij = w[o, o, o, o]
    wmnij = wmnij + es("je,mnie->mnij", t1, w[o, o, o, v])
    wmnij = wmnij - es("ie,mnje->mnij", t1, w[o, o, o, v])
    wmnij = wmnij + 0.25 * es("ijef,mnef->mnij", tau, w[o, o, v, v])

    wabef = w[v, v, v, v]
    wabef = wabef - es("mb,amef->abef", t1, w[v, o, v, v])
    wabef = wabef + es("ma,bmef->abef", t1, w[v, o, v, v])
    wabef = wabef + 0.25 * es("mnab,mnef->abef", tau, w[o, o, v, v])

    wmbej = w[o, v, v, o]
    wmbej = wmbej + es("jf,mbef->mbej", t1, w[o, v, v, v])
    wmbej = wmbej - es("nb,mnej->mbej", t1, w[o, o, v, o])
    wmbej = wmbej - es("jnfb,mnef->mbej",
                       0.5 * t2 + es("jf,nb->jnfb", t1, t1), w[o, o, v, v])

    # T1 equations
    rhs1 = f[o, v]
    rhs1 = rhs1 + es("ie,ae->ia", t1, fae)
    rhs1 = rhs1 - es("ma,mi->ia", t1, fmi)
    rhs1 = rhs1 + es("imae,me->ia", t2, fme)
    rhs1 = rhs1 - es("nf,naif->ia", t1, w[o, v, o, v])
    rhs1 = rhs1 - 0.5 * es("imef,maef->ia", t2, w[o, v, v, v])
    rhs1 = rhs1 - 0.5 * es("mnae,nmei->ia", t2, w[o, o, v, o])

    # T2 equations
    rhs2 = w[o, o, v, v]
    tmp_fae = fae - 0.5 * es("mb,me->be", t1, fme)
    term = es("ijae,be->ijab", t2, tmp_fae)
    rhs2 = rhs2 + term - es("ijbe,ae->ijab", t2, tmp_fae)
    tmp_fmi = fmi + 0.5 * es("je,me->mj", t1, fme)
    term = es("imab,mj->ijab", t2, tmp_fmi)
    rhs2 = rhs2 - term + es("jmab,mi->ijab", t2, tmp_fmi)
    rhs2 = rhs2 + 0.5 * es("mnab,mnij->ijab", tau, wmnij)
    rhs2 = rhs2 + 0.5 * es("ijef,abef->ijab", tau, wabef)
    perm = es("imae,mbej->ijab", t2, wmbej)
    perm = perm - es("ie,ma,mbej->ijab", t1, t1, w[o, v, v, o])
    perm = (perm - perm.permute(1, 0, 2, 3) - perm.permute(0, 1, 3, 2)
            + perm.permute(1, 0, 3, 2))
    rhs2 = rhs2 + perm
    tmp = es("ie,abej->ijab", t1, w[v, v, v, o])
    rhs2 = rhs2 + tmp - tmp.permute(1, 0, 2, 3)
    tmp = es("ma,mbij->ijab", t1, w[o, v, o, o])
    rhs2 = rhs2 - tmp + tmp.permute(0, 1, 3, 2)

    t1_new = rhs1 / d1
    t2_new = rhs2 / d2
    e_corr = (es("ia,ia->", f[o, v], t1_new)
              + 0.25 * es("ijab,ijab->", w[o, o, v, v], t2_new)
              + 0.5 * es("ijab,ia,jb->", w[o, o, v, v], t1_new, t1_new))
    return t1_new, t2_new, e_corr


def _diis_coefficients(hist_r, nfill, rhs, count=None):
    """Pulay weights from the residual ring buffer, via the reference's
    identity-padded B matrix and eigh pseudo-inverse (ccsd.py:186-206), all
    on the device: ``nfill`` is a device integer, ``rhs`` the (m+1) unit
    vector e_m. The eigh is :func:`nbed_tpu_torch.ops.eigh.eigh_retry`
    (capturable on CUDA; ``count`` masks whether its failure counts)."""
    m = hist_r.shape[0]
    dtype, device = hist_r.dtype, hist_r.device
    b = hist_r @ hist_r.T
    filled = (torch.arange(m, device=device) < nfill).to(dtype)
    b = b * (filled[:, None] * filled[None, :]) + torch.diag(1.0 - filled)
    corner = torch.zeros(1, dtype=dtype, device=device)
    big = torch.cat([torch.cat([b, filled[:, None]], dim=1),
                     torch.cat([filled, corner])[None]], dim=0)
    ew, ev = eigh_ops.eigh_retry(big, count)
    cut = torch.max(torch.abs(ew)) * max(1e-12, (m + 1) * torch.finfo(dtype).eps)
    inv_ew = torch.where(torch.abs(ew) > cut, 1.0 / ew, torch.zeros_like(ew))
    return ((ev * inv_ew[None, :]) @ (ev.T @ rhs))[:m] * filled


class _SweepProgram:
    """The amplitude sweep of one (no, nv, diis_dim, dtype, card), the
    reference's ``_make_sweep`` (``ccsd.py:135-221``): operands (fock, w,
    d1, d2, the two tolerances, max_cycle) and the whole loop state (t1, t2,
    e_corr, e_prev, rmax, cycle, conv, the DIIS rings hist_t and hist_r,
    nfill) in device buffers. :meth:`run_cycles` is ``k`` iterations of the
    reference's body with its ``while_loop`` condition as a freeze: a cycle
    after convergence or past max_cycle leaves the state as it is, so any
    number of cycles per call gives the same iterates. On CUDA the k-cycle
    call is captured as a CUDA graph (:meth:`graph`); the DIIS eigh runs in
    cuSOLVER's capturable solver and its failures are counted on the card
    (:func:`nbed_tpu_torch.ops.eigh.failure_count`). ``status`` holds
    (conv, cycle, e_corr, rmax, eigh failures), the one host read per
    call."""

    def __init__(self, no: int, nv: int, diis_dim: int, dtype, device):
        self.no, self.nv, self.m, self.device = no, nv, diis_dim, device
        n, namp = no + nv, no * nv + no * no * nv * nv

        def zeros(*shape, dt=dtype):
            return torch.zeros(shape, dtype=dt, device=device)

        self.fock, self.w = zeros(n, n), zeros(n, n, n, n)
        self.d1, self.d2 = zeros(no, nv), zeros(no, no, nv, nv)
        self.tol = zeros(2)  # conv_tol, r_tol
        self.max_cycle = zeros(dt=torch.int64)
        self.t1, self.t2 = zeros(no, nv), zeros(no, no, nv, nv)
        self.e_corr, self.e_prev, self.rmax = zeros(), zeros(), zeros()
        self.cycle, self.nfill = zeros(dt=torch.int64), zeros(dt=torch.int64)
        self.conv = zeros(dt=torch.bool)
        self.hist_t, self.hist_r = zeros(diis_dim, namp), zeros(diis_dim, namp)
        self.rhs = torch.eye(diis_dim + 1, dtype=dtype, device=device)[diis_dim]
        self.failures = (eigh_ops.failure_count(device) if device.type == "cuda"
                         else zeros(dt=torch.int64))
        self.status = zeros(5, dt=torch.float64)
        self.pool, self.graphs = [None], {}

    @property
    def state(self) -> tuple:
        return (self.t1, self.t2, self.e_corr, self.e_prev, self.rmax, self.cycle,
                self.nfill, self.conv, self.hist_t, self.hist_r, self.failures, self.status)

    def load(self, fock, w, d1, d2, t1, t2, conv_tol: float, r_tol: float, max_cycle: int):
        """Copy a sweep's operands and starting amplitudes in, and reset the
        loop state as the reference's carry starts it."""
        for buf, value in ((self.fock, fock), (self.w, w), (self.d1, d1), (self.d2, d2),
                           (self.t1, t1), (self.t2, t2)):
            buf.copy_(value)
        self.tol[0], self.tol[1] = conv_tol, r_tol
        self.max_cycle.fill_(int(max_cycle))
        for t in (self.e_corr, self.cycle, self.nfill, self.conv, self.hist_t, self.hist_r,
                  self.status):
            t.zero_()
        self.e_prev.fill_(float("inf"))
        self.rmax.fill_(float("inf"))

    def cycle_once(self):
        """One amplitude update, ring write at slot ``cycle % m``, DIIS
        extrapolation where two or more slots are filled and convergence
        test, committed where the loop is still running."""
        no, nv, m = self.no, self.nv, self.m
        n1 = no * nv
        t1, t2 = self.t1, self.t2
        active = ~self.conv & (self.cycle < self.max_cycle)
        t1n, t2n, e = _ccsd_step(t1, t2, self.fock, self.w, self.d1, self.d2, no, nv)
        r = torch.cat([(t1n - t1).reshape(-1), (t2n - t2).reshape(-1)])
        t_vec = torch.cat([t1n.reshape(-1), t2n.reshape(-1)])
        slot = (self.cycle % m).reshape(1)
        for hist, row in ((self.hist_t, t_vec), (self.hist_r, r)):
            hist.index_copy_(0, slot, torch.where(active, row, hist.index_select(0, slot)[0])[None])
        nfill = torch.where(active, torch.clamp(self.nfill + 1, max=m), self.nfill)
        extrapolate = nfill >= 2
        coef = _diis_coefficients(self.hist_r, nfill, self.rhs, extrapolate & active)
        t_vec = torch.where(extrapolate, coef @ self.hist_t, t_vec)
        t_vec = torch.where(active, t_vec, torch.cat([t1.reshape(-1), t2.reshape(-1)]))
        rmax = torch.max(torch.abs(r))
        conv = (torch.abs(e - self.e_prev) < self.tol[0]) & (rmax < self.tol[1])
        self.t1.copy_(t_vec[:n1].reshape(no, nv))
        self.t2.copy_(t_vec[n1:].reshape(no, no, nv, nv))
        for buf, value in ((self.e_corr, e), (self.e_prev, e), (self.rmax, rmax),
                           (self.conv, conv), (self.nfill, nfill)):
            buf.copy_(torch.where(active, value, buf))
        self.cycle.add_(active.to(torch.int64))

    def run_cycles(self, k: int):
        """``k`` cycles, then the status vector."""
        for _ in range(k):
            self.cycle_once()
        f64 = torch.float64
        self.status.copy_(torch.stack([self.conv.to(f64), self.cycle.to(f64),
                                       self.e_corr.to(f64), self.rmax.to(f64),
                                       self.failures.to(f64)]))

    def graph(self, k: int) -> Captured:
        """The :class:`~nbed_tpu_torch.ops.programs.Captured` call of ``k``
        cycles (captured at its first replay, the state kept)."""
        if k not in self.graphs:
            self.graphs[k] = Captured(lambda: self.run_cycles(k), self.device, self.pool,
                                      warmup=lambda: self.run_cycles(1), keep=self.state)
        return self.graphs[k]


class _TriplesProgram:
    """The (T) energy of one (no, nv, chunk, card) as one program, the
    reference's ``_make_triples_energy`` (``ccsd.py:224-284``): fock, w,
    t1, t2 in float64 buffers, the whole chunk loop in one CUDA graph on
    the card, and one scalar output."""

    def __init__(self, no: int, nv: int, chunk: int, device):
        n = no + nv

        def zeros(*shape):
            return torch.zeros(shape, dtype=torch.float64, device=device)

        self.fock, self.w = zeros(n, n), zeros(n, n, n, n)
        self.t1, self.t2 = zeros(no, nv), zeros(no, no, nv, nv)
        self.out = zeros()
        self.captured = Captured(
            lambda: self.out.copy_(_triples_sum(self.fock, self.w, self.t1, self.t2, chunk)),
            device, [None])


# the programs of this process, as the reference's lru_cache(maxsize=8) of
# _make_sweep and _make_triples_energy: keyed by (no, nv, diis_dim, dtype,
# card) and (no, nv, chunk, card), each holding its own operand buffers
# (pfoa's w: 78^4 float64, 0.30 GB)
_SWEEP_PROGRAMS: dict = {}
_TRIPLES_PROGRAMS: dict = {}
_PROGRAMS_MAX = 8
# sweep cycles per graph replay: each adds its capture time once per
# program and saves a host read per replay (PERF.md §6, chip_smoke.py's
# ccsd_graphed phase)
SWEEP_CYCLES = 1
# the private switch of chip_smoke's graph-against-eager holds: False runs
# the programs' functions uncaptured on the card as well
_GRAPHED = True


def _graphs_on(device) -> bool:
    return device.type == "cuda" and _GRAPHED


def _sweep(fock, w, d1, d2, t1, t2, conv_tol: float, r_tol: float,
           max_cycle: int, diis_dim: int, cycles: int | None = None):
    """Amplitude iterations with Pulay DIIS in the dtype of ``w``, from the
    amplitudes (t1, t2) -> (t1, t2, e_corr, rmax, cycles, converged): the
    cached :class:`_SweepProgram`, ``cycles`` (default
    :data:`SWEEP_CYCLES`) cycles per replay (per uncaptured call off the
    card) and one host read of its status after each. The amplitudes
    returned are the last DIIS extrapolation, as the reference's
    ``_make_sweep`` returns them. An eigh failure raises."""
    no, nv = t1.shape
    dtype, device = w.dtype, w.device
    prog = cached_program(_SWEEP_PROGRAMS, _PROGRAMS_MAX,
                          (no, nv, diis_dim, dtype, card(device)),
                          lambda: _SweepProgram(no, nv, diis_dim, dtype, device))
    prog.load(fock, w, d1, d2, t1.to(dtype), t2.to(dtype), conv_tol, r_tol, max_cycle)
    k = SWEEP_CYCLES if cycles is None else int(cycles)
    graphed = _graphs_on(device)
    while True:
        if graphed:
            replay(prog.graph(k), "ccsd_graph")
        else:
            prog.run_cycles(k)
            RUNS["ccsd_eager"] += 1
        conv, n_it, e_corr, rmax, failures = prog.status.tolist()  # the one host read
        RUNS["host_reads"] += 1
        RUNS["ccsd_host_reads"] += 1
        if failures:
            prog.failures.zero_()
            raise RuntimeError(f"eigh: cuSOLVER failed on {int(failures)} CCSD DIIS systems")
        if conv or n_it >= max_cycle:
            break
    RUNS["ccsd_cycles"] += int(n_it)
    return prog.t1.clone(), prog.t2.clone(), e_corr, rmax, int(n_it), bool(conv)


def _triples_sum(fock, w, t1, t2, chunk: int | None = None):
    """Spin-orbital (T) energy of canonical-reference CCSD(T) as a device
    scalar,

        E(T) = (1/36) sum_{ijkabc} Rc (Rc + Rd) / D,
        D Rc = P(i/jk) P(a/bc) [sum_e t2[jk,ae] <ei||bc> - sum_m t2[im,bc] <ma||jk>],
        D Rd = P(i/jk) P(a/bc) t1[ia] <jk||bc>,

    over all (i, j, k) occupied triples (``_make_triples_energy``,
    ``ccsd.py:224-284``). D takes only the Fock diagonal, also for
    non-canonical (embedded) orbitals, as the reference does. The (nv, nv,
    nv) blocks of ``chunk`` triples at a time are batched GEMMs and t3 is
    never stored; the last chunk is short (no padded triples to mask).
    Reads its tensors only (a CUDA graph captures it)."""
    no, nv = t1.shape
    o, v = slice(0, no), slice(no, no + nv)
    eps = torch.diagonal(fock)
    eps_o, eps_v = eps[:no], eps[no:]
    w_vovv = w[v, o, v, v].permute(1, 0, 2, 3).reshape(no, nv, nv * nv)  # [i][e, bc]
    w_ovoo = w[o, v, o, o].permute(2, 3, 1, 0)  # [j, k][a, m]
    w_oovv = w[o, o, v, v]
    t2_i = t2.reshape(no, no, nv * nv)  # [i][m, bc]
    d_abc = eps_v[:, None, None] + eps_v[None, :, None] + eps_v[None, None, :]
    n_tr = no ** 3
    chunk = _triples_chunk(nv) if chunk is None else chunk

    def p_abc(x):  # (C, a, b, c)
        return x - x.permute(0, 2, 1, 3) - x.permute(0, 3, 2, 1)

    def conn(i, j, k):
        x = torch.bmm(t2[j, k], w_vovv[i])  # sum_e t2[jk,ae] <ei||bc>
        x = x - torch.bmm(w_ovoo[j, k], t2_i[i])  # sum_m t2[im,bc] <ma||jk>
        return p_abc(x.reshape(-1, nv, nv, nv))

    def disc(i, j, k):
        return p_abc(t1[i][:, :, None, None] * w_oovv[j, k][:, None, :, :])

    e_t = torch.zeros((), dtype=w.dtype, device=w.device)
    for c0 in range(0, n_tr, chunk):
        idx = torch.arange(c0, min(c0 + chunk, n_tr), dtype=torch.int64, device=w.device)
        i, j, k = idx // (no * no), (idx // no) % no, idx % no
        rc = conn(i, j, k) - conn(j, i, k) - conn(k, j, i)
        rd = disc(i, j, k) - disc(j, i, k) - disc(k, j, i)
        d = (eps_o[i] + eps_o[j] + eps_o[k])[:, None, None, None] - d_abc
        e_t = e_t + torch.sum(rc * (rc + rd) / d)
    return e_t / 36.0


def _triples_chunk(nv: int) -> int:
    """Triples per chunk: one (chunk, nv, nv, nv) block is about
    :data:`_T_BLOCK_ELEMS` elements."""
    return max(1, _T_BLOCK_ELEMS // max(nv ** 3, 1))


def _triples_energy(fock, w, t1, t2, chunk: int | None = None) -> float:
    """The (T) energy of :func:`_triples_sum`, eager, read to the host."""
    return float(_triples_sum(fock, w, t1, t2, chunk))


def _triples(fock, w, t1, t2) -> float:
    """The (T) energy: on the card one replay of the cached
    :class:`_TriplesProgram` (inputs copied in, one read), elsewhere
    :func:`_triples_energy`."""
    if not _graphs_on(w.device):
        return _triples_energy(fock, w, t1, t2)
    no, nv = t1.shape
    chunk = _triples_chunk(nv)
    prog = cached_program(_TRIPLES_PROGRAMS, _PROGRAMS_MAX, (no, nv, chunk, card(w.device)),
                          lambda: _TriplesProgram(no, nv, chunk, w.device))
    for buf, value in ((prog.fock, fock), (prog.w, w), (prog.t1, t1), (prog.t2, t2)):
        buf.copy_(value)
    replay(prog.captured, "triples_graph")
    RUNS["host_reads"] += 1
    return float(prog.out)


@contextmanager
def _true_float32():
    """Full float32 products for the float32 sweep: no TF32, matmul
    precision "highest" (the reference's 3-pass f32 products)."""
    tf32 = torch.backends.cuda.matmul.allow_tf32
    precision = torch.get_float32_matmul_precision()
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.set_float32_matmul_precision("highest")
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32 = tf32
        torch.set_float32_matmul_precision(precision)


def run_ccsd(so_h1, so_h2, occ_mask, conv_tol: float = 1e-8,
             max_cycle: int = 100, precision: str = "auto",
             diis_dim: int = DIIS_DIM, triples: bool = False):
    """CCSD correlation energy from spin-orbital integrals.

    Args:
        so_h1: (M, M) spin-orbital one-body integrals (incl. any embedding
            potential), a float64 tensor.
        so_h2: (M, M, M, M) a+a+aa coefficient tensor (the
            HamiltonianBuilder's 0.5*h2).
        occ_mask: boolean (M,) numpy array, True for occupied spin orbitals.
        precision: ``"f64"``, ``"f32"`` (about 1e-5 Ha), ``"mixed"`` (the
            float32 sweep, then a float64 polish) or ``"auto"`` (= f64).
        diis_dim: DIIS history length.
        triples: also the perturbative (T) correction from the converged
            amplitudes.

    Returns:
        (e_corr, e_hf_elec): correlation energy and the mean-field
        electronic energy implied by the integrals; with ``triples=True``
        (e_corr, e_t, e_hf_elec).
    """
    if precision == "auto":
        precision = "f64"
    if precision not in ("f64", "f32", "mixed"):
        raise ValueError(f"precision must be 'auto', 'f64', 'f32' or 'mixed', got {precision!r}")
    device = so_h1.device
    occ_mask = torch.as_tensor(occ_mask, dtype=torch.bool, device=device)
    occ = torch.nonzero(occ_mask).flatten()
    vir = torch.nonzero(~occ_mask).flatten()
    order = torch.cat([occ, vir])
    no = len(occ)
    h1 = so_h1[order][:, order]
    w = _antisymmetrized(so_h2)[order][:, order][:, :, order][:, :, :, order]

    o = slice(0, no)
    fock = h1 + torch.einsum("piqi->pq", w[:, o, :, o])
    e_ref = float(torch.einsum("ii->", h1[o, o]) + 0.5 * torch.einsum("ijij->", w[o, o, o, o]))

    eps = torch.diag(fock)
    d1 = eps[o, None] - eps[None, no:]
    d2 = (eps[o, None, None, None] + eps[None, o, None, None]
          - eps[None, None, no:, None] - eps[None, None, None, no:])
    t1 = fock[o, no:] / d1
    t2 = w[o, o, no:, no:] / d2

    if precision in ("f32", "mixed"):
        f32 = torch.float32
        with _true_float32():
            t1, t2, e32, rmax, n_it, conv = _sweep(
                fock.to(f32), w.to(f32), d1.to(f32), d2.to(f32), t1, t2,
                max(conv_tol, 1e-6), 1e-5, max_cycle, diis_dim)
        logger.debug("CCSD f32 sweep: %s cycles, e=%s, rmax=%s", n_it, e32, rmax)
        if precision == "f32":
            if not conv:
                logger.warning("CCSD (f32) did NOT converge in %d cycles.", max_cycle)
            if triples:
                e_t = _triples(fock, w, t1.to(fock.dtype), t2.to(fock.dtype))
                return e32, e_t, e_ref
            return e32, e_ref

    t1, t2, e_corr, rmax, n_it, conv = _sweep(fock, w, d1, d2, t1, t2, conv_tol, 1e-6,
                                              max_cycle, diis_dim)
    if conv:
        logger.debug("CCSD converged in %d f64 cycles (%s).", n_it, precision)
    else:
        logger.warning("CCSD did NOT converge in %d cycles.", max_cycle)
    if triples:
        e_t = _triples(fock, w, t1, t2)
        logger.debug("(T) correction: %s", e_t)
        return e_corr, e_t, e_ref
    return e_corr, e_ref
