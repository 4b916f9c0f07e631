"""Statevector VQE on the embedded second-quantised Hamiltonian (port of
``nbed_tpu/solvers/vqe.py``).

A disentangled-UCCSD ansatz on a real float64 statevector, held on the
solver's device as a torch tensor:

- Spin-preserving UCCSD generators ``K = T - T^dagger`` are mapped through
  the ladder-operator algebra of :mod:`nbed_tpu_torch.ham.qubit`. For a
  real Hamiltonian every surviving Pauli string ``S = X^x Z^z`` has an odd
  number of Y factors, so ``S`` is a real signed permutation with
  ``S^2 = -I`` and ``exp(theta S) = cos(theta) I + sin(theta) S``.
  ``S psi`` is a gather ``psi[j ^ x]`` times the sign ``(-1)^parity((j ^
  x) & z)``, read from a table of the bit parity of every basis index
  (:func:`_bit_parity`, an XOR fold of int64 indices).
- ``<psi|H|psi>``: ``H psi`` is summed in blocks of X masks
  (:func:`_apply_hamiltonian`), and the gradient of the energy is
  ``2 H psi``.
- The value and gradient are the adjoint sweep: forward over the
  rotations, then back through them, un-applying each (it is orthogonal,
  ``U^-1 = cos I - sin S``) while the adjoint state is carried: O(2^n)
  memory where reverse mode through the sweep would store one state per
  rotation.

Two routes compute the same numbers with the same arithmetic:

- The programs (:class:`_AnsatzProgram`, the reference's jitted
  ``value_and_grad`` of its ``lax.scan`` sweep and ADAPT's jitted
  ``pool_gradients``): the strings, parameters, state and Hamiltonian in
  device buffers, the sweep a chunk of :data:`SWEEP_CHUNK` rotations that
  reads its strings at a device counter, replayed as a CUDA graph on the
  card (run uncaptured elsewhere); one host read per evaluation.
- The eager route (:class:`_Sweep`, :class:`_Expectation` under autograd,
  :func:`_pool_gradients`): Python loops over host-side strings, kept as
  the plain versions the programs are held against (:data:`_GRAPHED`).

The outer optimiser is host-side L-BFGS-B (scipy) over one value-and-
gradient evaluation per call.
"""

from dataclasses import dataclass, field
from functools import partial

import numpy as np
import torch

from .._device import DTYPE, resolve_device
from ..ham.qubit import MAPPINGS, PauliSum, _bk_sets, _ladder_factory, _mul, _popcount
from ..ops.programs import RUNS, Captured, cached_program, card, replay

__all__ = ["run_vqe", "run_adapt_vqe", "uccsd_excitations", "VQEResult",
           "AdaptVQEResult", "vqe_statevector"]

# the statevector solvers' register cap (2^24 float64 amplitudes, 128 MB)
MAX_QUBITS = 24
# most (term, basis state) pairs of one block of H psi, and of (pool
# string, basis state) pairs of one chunk of ADAPT's pool gradient: a
# block's temporaries are a few tensors of at most this many elements
_BLOCK_ELEMS = 1 << 24
# most rotations of one sweep chunk, the program that a value-and-gradient
# replays ceil(strings / chunk) times each way; at 20 qubits (4,620
# strings) 32 was the fastest of 8, 32, 128 and 512 (8 and 128 within
# 2.4 %; 512 pads to 5,120 rotations and is 7 % slower), by
# scripts/bench_vqe.py
SWEEP_CHUNK = 32
# the program caches (the reference re-jits per call; a 24-qubit program
# holds four 128 MB states, its pool a block's ~0.4 GB of temporaries)
_PROGRAMS: dict = {}
_PROGRAMS_MAX = 4
# the private switch of the graph-against-eager holds: True runs the
# programs (CUDA graphs on the card, uncaptured elsewhere), False the eager
# route
_GRAPHED = True


# --------------------------------------------------------------- excitations

def uccsd_excitations(n_so: int, nelec: tuple):
    """Spin- and Sz-preserving single and double excitations.

    Spin orbitals follow the builder's interleave (even = alpha, odd =
    beta); the reference determinant occupies the first ``n_alpha`` even
    and ``n_beta`` odd modes. Returns ``(occ_mask, excitations)``, each
    excitation a pair of creation and annihilation mode tuples
    ``((a, ...), (i, ...))``.
    """
    na, nb = nelec
    occ = [2 * i for i in range(na)] + [2 * i + 1 for i in range(nb)]
    virt = [p for p in range(n_so) if p not in occ]
    occ_mask = 0
    for p in occ:
        occ_mask |= 1 << p
    excitations = [((a,), (i,)) for i in occ for a in virt if a & 1 == i & 1]
    occ_pairs = [(i, j) for ii, i in enumerate(occ) for j in occ[ii + 1:]]
    virt_pairs = [(a, b) for ai, a in enumerate(virt) for b in virt[ai + 1:]]
    for i, j in occ_pairs:
        for a, b in virt_pairs:
            if (i & 1) + (j & 1) == (a & 1) + (b & 1):
                excitations.append(((a, b), (j, i)))
    return occ_mask, excitations


def _operator_terms(modes_dag, modes_ann, ladder):
    """Canonical terms of ``a+_{p1}..a+_{pk} a_{q1}..a_{qk}``."""
    terms = [(1.0 + 0.0j, 0, 0)]
    for mode in modes_dag:
        terms = [_mul(t, f) for t in terms for f in ladder(mode, True)]
    for mode in modes_ann:
        terms = [_mul(t, f) for t in terms for f in ladder(mode, False)]
    out = {}
    for c, x, z in terms:
        out[(x, z)] = out.get((x, z), 0.0) + c
    return out


def _generator_strings(excitation, ladder):
    """Pauli strings ``(coeff, x, z)`` of ``K = T - T^dagger``.

    ``T^dagger = sum conj(c) (-1)^|x & z| X^x Z^z``, so K is assembled
    termwise. For real fermionic coefficients every survivor has an odd
    Y count and a real coefficient; anything else raises.
    """
    cre, ann = excitation
    strings = []
    for (x, z), c in _operator_terms(cre, ann, ladder).items():
        sign = -1.0 if (_popcount(x & z) & 1) else 1.0
        k_c = c - np.conj(c) * sign
        if abs(k_c) < 1e-14:
            continue
        if abs(k_c.imag) >= 1e-10 or not _popcount(x & z) & 1:
            raise ValueError(f"generator string ({x}, {z}) of {excitation} is "
                             "not a real odd-Y string")
        strings.append((float(k_c.real), x, z))
    return strings


def _encode_reference(occ_mask: int, mapping: str, n: int) -> int:
    """Computational-basis index of the reference determinant: the
    occupations under JW; their prefix parities under the parity encoding;
    under BK, occupying mode j flips qubit j and its Fenwick update set."""
    if mapping == "jw":
        return occ_mask
    if mapping == "parity":
        idx = running = 0
        for j in range(n):
            running ^= (occ_mask >> j) & 1
            idx |= running << j
        return idx
    idx = 0
    for j in range(n):
        if occ_mask >> j & 1:
            update, _, _ = _bk_sets(j, n)
            idx ^= update | (1 << j)
    return idx


# ------------------------------------------------------------ the arithmetic

def _bit_parity(v: torch.Tensor) -> torch.Tensor:
    """Parity of the set bits of each element of a non-negative int64
    tensor, by XOR-folding its halves down to one bit."""
    for shift in (32, 16, 8, 4, 2, 1):
        v = v ^ (v >> shift)
    return v & 1


@dataclass
class _Program:
    """Device tensors of one register: the basis indices, the +-1 sign of
    every index's bit parity, the Hamiltonian's terms sorted by X mask and
    cut into blocks, and the ansatz strings."""

    cols: torch.Tensor  # (dim,) int32 (dim <= 2^24)
    sign: torch.Tensor  # (dim,) float64, (-1)^parity(index)
    # Hamiltonian blocks (_hamiltonian_blocks): (distinct X masks (B,),
    # (B, T) coefficients, z (T,))
    blocks: list
    # ansatz strings: host ints (x, z), the same on the device, their
    # coefficients and parameter index
    strings: list
    xz: torch.Tensor  # (n_strings, 2) int32
    coeffs: torch.Tensor  # (n_strings,) float64
    pidx: torch.Tensor  # (n_strings,) int64
    # each parameter's string positions, padded with n_strings (_segments)
    seg: torch.Tensor  # (n_params, W) int64

    def apply_string(self, v, x, z):
        """``X^x Z^z v``: ``v[j ^ x] (-1)^parity((j ^ x) & z)``."""
        idx = self.cols ^ x
        return self.sign.index_select(0, idx & z) * v.index_select(0, idx)


def _hamiltonian_blocks(psum: PauliSum, dim: int, device):
    """The real terms of ``psum`` sorted by X mask and cut into blocks of
    at most ``max(1, _BLOCK_ELEMS // dim)`` terms (a mask's terms may span
    two blocks: H psi is linear in the terms), each as (its distinct X
    masks x, the (masks, terms) matrix of ``c_t (-1)^parity(x & z_t)`` in
    the row of term t's mask, the terms' z): see
    :func:`_apply_hamiltonian`."""
    keys = sorted(psum.terms)
    coeffs = np.array([psum.terms[k] for k in keys], dtype=np.complex128)
    if coeffs.size and np.abs(coeffs.imag).max() >= 1e-9:
        raise ValueError("complex Hamiltonian coefficients: the statevector VQE "
                         "takes real Hamiltonians")
    xs = np.array([k[0] for k in keys], dtype=np.int64)
    zs = np.array([k[1] for k in keys], dtype=np.int64)
    per_block = max(1, _BLOCK_ELEMS // dim)
    blocks = []
    for t0 in range(0, len(keys), per_block):
        sl = slice(t0, t0 + per_block)
        ux, group = np.unique(xs[sl], return_inverse=True)
        gmat = np.zeros((ux.size, group.size))
        parity = [_popcount(int(x) & int(z)) & 1 for x, z in zip(ux[group], zs[sl])]
        gmat[group, np.arange(group.size)] = coeffs[sl].real * (1 - 2 * np.array(parity))
        blocks.append((torch.as_tensor(ux.astype(np.int32), device=device),
                       torch.as_tensor(gmat, device=device),
                       torch.as_tensor(zs[sl].astype(np.int32), device=device)))
    return blocks


def _apply_hamiltonian(prog, psi):
    """``H psi``, summed over blocks of X masks: ``(H psi)[i] = sum_x
    w_x[i] psi[i ^ x]`` with ``w_x[i] = sum_{t in x} c_t (-1)^parity((i ^
    x) & z_t)``, which is the block's coefficient matrix (its rows carry
    ``(-1)^parity(x & z_t)``) times the terms' signs ``(-1)^parity(i &
    z_t)``. Only one block's signs (T, 2^n) and weights (B, 2^n), B <= T,
    exist at a time. Every sum has a fixed order (a product and a row
    sum, where the card's index_add adds in any order), so repeated calls
    agree to the bit. ``prog`` is a :class:`_Program` or an
    :class:`_AnsatzProgram`."""
    out = torch.zeros_like(psi)
    cols, dim = prog.cols, psi.shape[0]
    for ux, gmat, z in prog.blocks:
        signs = prog.sign.index_select(0, (cols[None, :] & z[:, None]).view(-1))
        w = torch.mm(gmat, signs.view(-1, dim))
        del signs
        w *= psi.index_select(0, (cols[None, :] ^ ux[:, None]).view(-1)).view(-1, dim)
        out += w.sum(0)
    return out


def _rotations(thetas, prog):
    ang = torch.take(thetas, prog.pidx) * prog.coeffs
    return torch.cos(ang), torch.sin(ang)


def _rotate(cols, sign, psi, x, z, c, s):
    """``(cos a + sin a S) psi`` for the string (x, z) with ``c, s = cos a,
    sin a``."""
    idx = cols ^ x
    return torch.addcmul(c * psi, s, sign.index_select(0, idx & z) * psi.index_select(0, idx))


def _unrotate(cols, sign, psi, lam, x, z, c, s):
    """One step back through the sweep: ``dE/da = lam . S psi``, then the
    state and the adjoint multiplied by ``U^T = cos a - sin a S``."""
    idx = cols ^ x
    sgn = sign.index_select(0, idx & z)
    s_psi = sgn * psi.index_select(0, idx)
    return (torch.dot(lam, s_psi), torch.addcmul(c * psi, s, s_psi, value=-1),
            torch.addcmul(c * lam, s, sgn * lam.index_select(0, idx), value=-1))


def _segment_sums(values, seg):
    """Row sums of ``values`` at the positions of ``seg``, whose padding
    entries (``len(values)``) read a zero: the gradient of each parameter
    over its strings, as the reference's segment sums, in a fixed order."""
    return torch.take(torch.cat([values, values.new_zeros(1)]), seg).sum(1)


def _string_values(cols, sign, psi, h_psi, xz):
    """``<H psi|S psi>`` for each string (x, z) of the rows of ``xz``."""
    idx = cols[None, :] ^ xz[:, :1]
    s_psi = sign.index_select(0, (idx & xz[:, 1:]).view(-1)) * psi.index_select(0, idx.view(-1))
    return torch.mv(s_psi.view(-1, psi.shape[0]), h_psi)


def _pool_chunk(dim: int, n_strings: int) -> int:
    """Pool strings per chunk of the pool gradient: ``(chunk, 2^n)``
    temporaries of at most :data:`_BLOCK_ELEMS` elements."""
    return max(1, min(_BLOCK_ELEMS // dim, n_strings))


# ---------------------------------------------------------- the eager route

class _Sweep(torch.autograd.Function):
    """``psi = U_N ... U_1 psi0`` with ``U_s = cos a_s + sin a_s S_s`` and
    ``a_s = theta[p_s] c_s``.

    Backward carries the state and the adjoint back through the sweep
    (:func:`_unrotate`). Only the final state is stored."""

    @staticmethod
    def forward(ctx, thetas, psi0, prog):
        cos, sin = _rotations(thetas, prog)
        psi = psi0
        for s, (x, z) in enumerate(prog.strings):
            psi = _rotate(prog.cols, prog.sign, psi, x, z, cos[s], sin[s])
        ctx.prog = prog
        ctx.save_for_backward(thetas, psi)
        return psi

    @staticmethod
    def backward(ctx, lam):
        thetas, psi = ctx.saved_tensors
        prog = ctx.prog
        cos, sin = _rotations(thetas, prog)
        da = torch.empty_like(prog.coeffs)
        for s in range(len(prog.strings) - 1, -1, -1):
            x, z = prog.strings[s]
            da[s], psi, lam = _unrotate(prog.cols, prog.sign, psi, lam, x, z, cos[s], sin[s])
        grad = _segment_sums(da * prog.coeffs, prog.seg)
        return grad, lam if ctx.needs_input_grad[1] else None, None


class _Expectation(torch.autograd.Function):
    """``<psi|H|psi>`` of a real symmetric H; its gradient is ``2 H psi``."""

    @staticmethod
    def forward(ctx, psi, prog):
        h_psi = _apply_hamiltonian(prog, psi)
        ctx.save_for_backward(h_psi)
        return torch.dot(psi, h_psi)

    @staticmethod
    def backward(ctx, g):
        (h_psi,) = ctx.saved_tensors
        return 2.0 * g * h_psi, None


def _sweep_plain(thetas, psi0, prog: _Program):
    """Plain version of :class:`_Sweep` for tests: the same rotations as
    differentiable torch ops (reverse mode stores every state)."""
    cos, sin = _rotations(thetas, prog)
    psi = psi0
    for s, (x, z) in enumerate(prog.strings):
        psi = cos[s] * psi + sin[s] * prog.apply_string(psi, x, z)
    return psi


def _pool_gradients(pool_prog: _Program, psi):
    """ADAPT's pool gradients ``2 sum_s c_s <H psi|S_s psi>`` per operator,
    eager: the program's chunks (:func:`_pool_chunk`) at host offsets."""
    n = len(pool_prog.strings)
    chunk = _pool_chunk(psi.shape[0], n)
    h_psi = _apply_hamiltonian(pool_prog, psi)
    xz = torch.cat([pool_prog.xz, pool_prog.xz.new_zeros(-n % chunk, 2)])
    vals = torch.cat([_string_values(pool_prog.cols, pool_prog.sign, psi, h_psi,
                                     xz[a:a + chunk]) for a in range(0, n, chunk)])
    return 2.0 * _segment_sums(vals[:n] * pool_prog.coeffs, pool_prog.seg)


# ---------------------------------------------------------------- programs

class _AnsatzProgram:
    """The value and gradient of one register's ansatz as programs of fixed
    shape: the counterpart of the reference's ``jax.jit(jax.value_and_grad
    (objective))`` over its ``lax.scan`` sweep (``vqe.py:148-164,
    288-301``) and, with a pool, of ADAPT's jitted ``pool_gradients``
    (``vqe.py:406-415``).

    Buffers: the Hamiltonian blocks, the reference state, ``n_cap`` string
    rows (x, z), coefficients and parameter indices (rows past the loaded
    ones have c = 0 at the unused parameter slot ``p_cap``: cos 0 = 1,
    sin 0 = 0, an exact identity), ``p_cap + 1`` parameters, the cos and
    sin of every row, the state, adjoint and ``H psi``, and three 1-element
    int64 counters. The programs (:class:`Captured` each, one graph pool):

    - "vqe_prep": the rotations' cos and sin, the state at psi0, every
      counter at its start;
    - "vqe_fwd": ``k`` rotations read at the forward counter, which it
      advances by ``k``, as the scan body reads its slice of the stacked
      arrays;
    - "vqe_energy": ``H psi``, ``E = psi . H psi`` and the adjoint ``2 H
      psi``;
    - "vqe_bwd": ``k`` rotations un-applied at the backward counter (from
      the last loaded chunk's end down), writing each ``dE/da``;
    - "vqe_grad": the parameters' gradient (:func:`_segment_sums`);
    - with a pool, "adapt_pool": ``<H psi|S psi>`` of ``pool_chunk`` pool
      strings at the pool counter, and "adapt_grads": their sums per
      operator.

    A value and gradient replays each program once and the sweep chunks
    ``n_chunks`` times each way, and reads ``[E, g]`` once. The bodies run
    the eager route's functions (:func:`_rotate`, :func:`_unrotate`,
    :func:`_apply_hamiltonian`, :func:`_segment_sums`,
    :func:`_string_values`) on the same values, so the two agree to the
    bit."""

    def __init__(self, n_qubits: int, block_shapes: tuple, k: int, n_cap: int, p_cap: int,
                 width: int, device, pool: tuple = None):
        dim = 1 << n_qubits
        i64 = torch.int64

        def zeros(*shape, dt=DTYPE):
            return torch.zeros(shape, dtype=dt, device=device)

        self.k, self.n_cap, self.p_cap, self.device = k, n_cap, p_cap, device
        self.cols = torch.arange(dim, dtype=torch.int32, device=device)
        self.sign = (1 - 2 * _bit_parity(self.cols.long())).to(DTYPE)
        self.blocks = [(zeros(b, dt=torch.int32), zeros(b, t), zeros(t, dt=torch.int32))
                       for b, t in block_shapes]
        self.xz = zeros(n_cap, 2, dt=torch.int32)
        self.coeffs = zeros(n_cap)
        self.pidx = torch.full((n_cap,), p_cap, dtype=i64, device=device)
        self.seg = torch.full((p_cap, width), n_cap, dtype=i64, device=device)
        self.thetas = zeros(p_cap + 1)
        self.rot = zeros(n_cap, 2)  # cos, sin of each row's angle
        self.psi0, self.psi, self.lam, self.h_psi = (zeros(dim) for _ in range(4))
        self.da = zeros(n_cap)
        self.steps = torch.arange(k, dtype=i64, device=device)
        self.fwd, self.bwd, self.bstart = zeros(1, dt=i64), zeros(1, dt=i64), zeros(1, dt=i64)
        self.out = zeros(1 + p_cap)  # E, then the gradient
        self.n_params = self.n_chunks = 0
        graph_pool = [None]
        self.graphs = {
            "vqe_prep": Captured(self.prepare, device, graph_pool),
            "vqe_fwd": Captured(self.forward_chunk, device, graph_pool,
                                keep=(self.psi, self.fwd)),
            "vqe_energy": Captured(self.energy, device, graph_pool),
            "vqe_bwd": Captured(self.backward_chunk, device, graph_pool,
                                keep=(self.psi, self.lam, self.bwd, self.da)),
            "vqe_grad": Captured(self.gradient, device, graph_pool)}
        self.has_pool = pool is not None
        if self.has_pool:
            n_strings, n_pool, pool_width, chunk = pool
            np_cap = -(-n_strings // chunk) * chunk
            self.pool_chunk, self.pool_chunks = chunk, np_cap // chunk
            self.pool_xz = zeros(np_cap, 2, dt=torch.int32)
            self.pool_coeffs = zeros(np_cap)
            self.pool_seg = torch.full((n_pool, pool_width), np_cap, dtype=i64, device=device)
            self.pool_steps = torch.arange(chunk, dtype=i64, device=device)
            self.vals = zeros(np_cap)
            self.pctr = zeros(1, dt=i64)
            self.grads = zeros(n_pool)
            self.graphs["adapt_pool"] = Captured(self.pool_values, device, graph_pool,
                                                 keep=(self.vals, self.pctr))
            self.graphs["adapt_grads"] = Captured(self.pool_sums, device, graph_pool)

    # ------------------------------------------------------ program bodies

    def prepare(self):
        cos, sin = _rotations(self.thetas, self)
        self.rot.copy_(torch.stack([cos, sin], 1))
        self.psi.copy_(self.psi0)
        self.fwd.zero_()
        self.bwd.copy_(self.bstart)
        if self.has_pool:
            self.pctr.zero_()

    def forward_chunk(self):
        rows = self.fwd + self.steps
        xz, rot = self.xz.index_select(0, rows), self.rot.index_select(0, rows)
        psi = self.psi
        for j in range(self.k):
            psi = _rotate(self.cols, self.sign, psi, xz[j, 0], xz[j, 1], rot[j, 0], rot[j, 1])
        self.psi.copy_(psi)
        self.fwd.add_(self.k)

    def energy(self):
        h_psi = _apply_hamiltonian(self, self.psi)
        self.h_psi.copy_(h_psi)
        self.out[:1].copy_(torch.dot(self.psi, h_psi).reshape(1))
        self.lam.copy_(2.0 * h_psi)

    def backward_chunk(self):
        rows = self.bwd - self.steps
        xz, rot = self.xz.index_select(0, rows), self.rot.index_select(0, rows)
        psi, lam, da = self.psi, self.lam, []
        for j in range(self.k):
            d, psi, lam = _unrotate(self.cols, self.sign, psi, lam, xz[j, 0], xz[j, 1],
                                    rot[j, 0], rot[j, 1])
            da.append(d)
        self.da.index_copy_(0, rows, torch.stack(da))
        self.psi.copy_(psi)
        self.lam.copy_(lam)
        self.bwd.sub_(self.k)

    def gradient(self):
        self.out[1:].copy_(_segment_sums(self.da * self.coeffs, self.seg))

    def pool_values(self):
        rows = self.pctr + self.pool_steps
        self.vals.index_copy_(0, rows, _string_values(
            self.cols, self.sign, self.psi, self.h_psi, self.pool_xz.index_select(0, rows)))
        self.pctr.add_(self.pool_chunk)

    def pool_sums(self):
        self.grads.copy_(2.0 * _segment_sums(self.vals * self.pool_coeffs, self.pool_seg))

    # --------------------------------------------------------------- calls

    def load_register(self, prog: _Program, psi0):
        """Copy a register's Hamiltonian blocks and reference state in."""
        for bufs, values in zip(self.blocks, prog.blocks):
            for buf, value in zip(bufs, values):
                buf.copy_(value)
        self.psi0.copy_(psi0)

    def load_pool(self, pool_prog: _Program):
        """Copy ADAPT's pool strings in."""
        n, cap = len(pool_prog.strings), self.pool_xz.shape[0]
        self.pool_xz[:n].copy_(pool_prog.xz)
        self.pool_coeffs[:n].copy_(pool_prog.coeffs)
        self.pool_seg.copy_(pool_prog.seg.masked_fill(pool_prog.seg >= n, cap))

    def load_ansatz(self, prog: _Program):
        """Copy an ansatz's strings in (rows past them padded), and set the
        chunks a sweep replays and the backward counter's start."""
        n = len(prog.strings)
        p, w = prog.seg.shape
        if n > self.n_cap or p > self.p_cap or w > self.seg.shape[1]:
            raise ValueError(f"ansatz of {n} strings and {p} parameters exceeds the "
                             f"program's {self.n_cap} and {self.p_cap}")
        self.xz.zero_()
        self.xz[:n].copy_(prog.xz)
        self.coeffs.zero_()
        self.coeffs[:n].copy_(prog.coeffs)
        self.pidx.fill_(self.p_cap)
        self.pidx[:n].copy_(prog.pidx)
        self.seg.fill_(self.n_cap)
        self.seg[:p, :w].copy_(prog.seg.masked_fill(prog.seg >= n, self.n_cap))
        self.thetas.zero_()
        self.n_params, self.n_chunks = p, -(-n // self.k)
        self.bstart.fill_(self.n_chunks * self.k - 1)

    def _sweep_to(self, x, n_chunks: int):
        """Load the amplitudes ``x`` (one host-to-device copy), then replay
        the preparation and ``n_chunks`` forward chunks."""
        x = np.ascontiguousarray(x, dtype=np.float64)
        if x.size:
            self.thetas[:x.size].copy_(torch.from_numpy(x))
        replay(self.graphs["vqe_prep"], "vqe_prep")
        for _ in range(n_chunks):
            replay(self.graphs["vqe_fwd"], "vqe_fwd")

    @staticmethod
    def _read(t) -> np.ndarray:
        """The one host read of a call."""
        RUNS["host_reads"] += 1
        RUNS["vqe_host_reads"] += 1
        return t.to("cpu", copy=True).numpy()

    def value_and_grad(self, x):
        """(E, dE/dtheta) at host amplitudes ``x``, as float and array."""
        with torch.no_grad():
            self._sweep_to(x, self.n_chunks)
            replay(self.graphs["vqe_energy"], "vqe_energy")
            for _ in range(self.n_chunks):
                replay(self.graphs["vqe_bwd"], "vqe_bwd")
            replay(self.graphs["vqe_grad"], "vqe_grad")
            out = self._read(self.out)
        RUNS["vqe_evaluations"] += 1
        return float(out[0]), out[1:1 + self.n_params]

    def reference_energy(self) -> float:
        """``<psi0|H|psi0>``."""
        with torch.no_grad():
            self._sweep_to(np.zeros(0), 0)
            replay(self.graphs["vqe_energy"], "vqe_energy")
            return float(self._read(self.out[:1])[0])

    def state(self, x) -> np.ndarray:
        """The ansatz state at amplitudes ``x`` as a host array."""
        with torch.no_grad():
            self._sweep_to(x, self.n_chunks)
            return self._read(self.psi)

    def pool_gradients(self, x) -> np.ndarray:
        """ADAPT's pool gradients at the loaded ansatz and amplitudes ``x``."""
        with torch.no_grad():
            self._sweep_to(x, self.n_chunks)
            replay(self.graphs["vqe_energy"], "vqe_energy")
            for _ in range(self.pool_chunks):
                replay(self.graphs["adapt_pool"], "adapt_pool")
            replay(self.graphs["adapt_grads"], "adapt_grads")
            return self._read(self.grads)


def _block_shapes(prog: _Program) -> tuple:
    return tuple((ux.shape[0], z.shape[0]) for ux, _, z in prog.blocks)


def _vqe_program(prog: _Program, psi0, k: int = None) -> _AnsatzProgram:
    """The cached program of ``prog``'s register and ansatz shape, with its
    operands loaded; ``k`` rotations per sweep chunk (default
    :data:`SWEEP_CHUNK`, at most the strings)."""
    n = len(prog.strings)
    k = min(SWEEP_CHUNK, n) if k is None else k
    n_cap = -(-n // k) * k
    p, w = prog.seg.shape
    n_qubits = prog.cols.shape[0].bit_length() - 1
    shapes = _block_shapes(prog)
    ap = cached_program(_PROGRAMS, _PROGRAMS_MAX,
                        ("vqe", n_qubits, k, n_cap, p, w, shapes, card(psi0.device)),
                        lambda: _AnsatzProgram(n_qubits, shapes, k, n_cap, p, w, psi0.device))
    ap.load_register(prog, psi0)
    ap.load_ansatz(prog)
    return ap


def _adapt_program(pool_prog: _Program, psi0, max_ops: int) -> _AnsatzProgram:
    """The cached ADAPT program of ``pool_prog``'s register: string and
    parameter buffers for the whole pool or ``max_ops`` of its longest
    operators, whichever holds more (every grown list fits, so each step
    replays the same graphs), and the pool's strings; operands loaded, the
    ansatz empty."""
    n = len(pool_prog.strings)
    n_pool, width = pool_prog.seg.shape
    cap = max(n, max_ops * width, 1)
    k = min(SWEEP_CHUNK, cap)
    n_cap = -(-cap // k) * k
    p_cap = max(n_pool, max_ops)
    dim = pool_prog.cols.shape[0]
    n_qubits = dim.bit_length() - 1
    chunk = _pool_chunk(dim, n)
    shapes = _block_shapes(pool_prog)
    key = ("adapt", n_qubits, k, n_cap, p_cap, width, n, n_pool, chunk, shapes,
           card(psi0.device))
    ap = cached_program(_PROGRAMS, _PROGRAMS_MAX, key, lambda: _AnsatzProgram(
        n_qubits, shapes, k, n_cap, p_cap, width, psi0.device, pool=(n, n_pool, width, chunk)))
    ap.load_register(pool_prog, psi0)
    ap.load_pool(pool_prog)
    ap.load_ansatz(_derived(pool_prog, []))
    return ap


# ---------------------------------------------------------- register set-up

def _stack_strings(strings_per_op):
    """[(x, z)], coefficients and parameter index of every string of the
    listed operators, in order."""
    strings, coeffs, pidx = [], [], []
    for p, op_strings in enumerate(strings_per_op):
        for c, x, z in op_strings:
            strings.append((x, z))
            coeffs.append(c)
            pidx.append(p)
    return strings, coeffs, pidx


def _segments(pidx: list, n_params: int) -> np.ndarray:
    """(n_params, W) positions of each parameter's strings, padded with
    ``len(pidx)``; W is the most strings of one parameter (at least 1)."""
    rows = [[] for _ in range(n_params)]
    for s, p in enumerate(pidx):
        rows[p].append(s)
    out = np.full((n_params, max([len(r) for r in rows] + [1])), len(pidx), dtype=np.int64)
    for p, r in enumerate(rows):
        out[p, :len(r)] = r
    return out


def _derived(base: _Program, strings_per_op) -> _Program:
    """The :class:`_Program` of ``strings_per_op`` on ``base``'s register."""
    device = base.cols.device
    strings, coeffs, pidx = _stack_strings(strings_per_op)
    return _Program(
        cols=base.cols, sign=base.sign, blocks=base.blocks, strings=strings,
        xz=torch.tensor(strings, dtype=torch.int32, device=device).reshape(-1, 2),
        coeffs=torch.tensor(coeffs, dtype=DTYPE, device=device),
        pidx=torch.tensor(pidx, dtype=torch.int64, device=device),
        seg=torch.as_tensor(_segments(pidx, len(strings_per_op)), device=device))


def _program(psum: PauliSum, strings_per_op, device) -> _Program:
    dim = 1 << psum.n_qubits
    cols = torch.arange(dim, dtype=torch.int32, device=device)
    base = _Program(cols=cols, sign=(1 - 2 * _bit_parity(cols.long())).to(DTYPE),
                    blocks=_hamiltonian_blocks(psum, dim, device), strings=[], xz=None,
                    coeffs=None, pidx=None, seg=None)
    return _derived(base, strings_per_op)


def _ansatz_setup(constant, h1, h2, nelec, mapping, excitations, device):
    """Mapped Hamiltonian, device program, reference state and sizes."""
    if mapping not in MAPPINGS:
        raise ValueError(f"unknown mapping '{mapping}'")
    psum = MAPPINGS[mapping](constant, h1, h2)
    n_qubits = psum.n_qubits
    if n_qubits > MAX_QUBITS:
        raise ValueError(
            f"statevector VQE capped at {MAX_QUBITS} qubits (got {n_qubits}); "
            "reduce the active space (concentric localization / "
            "reduce_virtuals) first")
    ladder = _ladder_factory(mapping, n_qubits)
    occ_mask, default_exc = uccsd_excitations(n_qubits, nelec)
    excitations = default_exc if excitations is None else excitations
    prog = _program(psum, [_generator_strings(e, ladder) for e in excitations], device)
    psi0 = torch.zeros(1 << n_qubits, dtype=DTYPE, device=device)
    psi0[_encode_reference(occ_mask, mapping, n_qubits)] = 1.0
    return psum, prog, psi0, len(excitations)


def _energy(thetas, psi0, prog):
    return _Expectation.apply(_Sweep.apply(thetas, psi0, prog), prog)


def _value_and_grad(x, psi0, prog):
    """(E, dE/dtheta) at host amplitudes ``x`` as float and numpy array,
    the eager route (autograd through :class:`_Sweep`)."""
    thetas = torch.tensor(x, dtype=DTYPE, device=psi0.device, requires_grad=True)
    e = _energy(thetas, psi0, prog)
    (g,) = torch.autograd.grad(e, thetas)
    return float(e.detach()), g.cpu().numpy()


def _objective(prog: _Program, psi0):
    """(value-and-gradient function, <psi0|H|psi0>) of ``prog``'s ansatz:
    its program's, or the eager route's where :data:`_GRAPHED` is False."""
    if _GRAPHED:
        ap = _vqe_program(prog, psi0)
        return ap.value_and_grad, ap.reference_energy()
    with torch.no_grad():
        e_ref = float(_Expectation.apply(psi0, prog))
    return partial(_value_and_grad, psi0=psi0, prog=prog), e_ref


def vqe_statevector(constant, h1, h2, nelec, mapping: str = "jw", params=None,
                    excitations=None, device="cuda") -> np.ndarray:
    """The real float64 ansatz statevector at amplitudes ``params`` (the
    mapped reference determinant for None), as a host array."""
    _, prog, psi0, _ = _ansatz_setup(constant, h1, h2, nelec, mapping, excitations,
                                     resolve_device(device))
    if params is None or not prog.strings:
        return psi0.cpu().numpy()
    if _GRAPHED:
        return _vqe_program(prog, psi0).state(params)
    thetas = torch.as_tensor(np.asarray(params, dtype=np.float64), device=psi0.device)
    with torch.no_grad():
        return _Sweep.apply(thetas, psi0, prog).cpu().numpy()


# ---------------------------------------------------------------------- VQE

@dataclass
class VQEResult:
    """Converged VQE state (energies in Hartree)."""

    e_vqe: float
    e_reference: float
    params: np.ndarray
    n_qubits: int
    n_params: int
    n_strings: int
    mapping: str
    converged: bool
    n_iterations: int
    history: list = field(default_factory=list)

    def __repr__(self):  # keep result-dict logging compact
        return (f"VQEResult(e_vqe={self.e_vqe:.10f}, "
                f"e_reference={self.e_reference:.10f}, "
                f"n_qubits={self.n_qubits}, n_params={self.n_params}, "
                f"converged={self.converged})")


def run_vqe(constant, h1, h2, nelec, mapping: str = "jw", maxiter: int = 500,
            conv_tol: float = 1e-7, init_params=None, excitations=None,
            device="cuda") -> VQEResult:
    """Disentangled-UCCSD VQE on a spin-orbital Hamiltonian.

    Args:
        constant, h1, h2: the driver's ``second_quantised`` output (``h2``
            already carries its 1/2), tensors or arrays.
        nelec: ``(n_alpha, n_beta)`` electrons in the active space.
        mapping: ``"jw"``, ``"bk"`` or ``"parity"``.
        maxiter: L-BFGS-B iteration cap.
        conv_tol: gradient-norm tolerance of the optimiser.
        init_params: starting amplitudes (default zeros: the reference
            determinant).
        excitations: an explicit excitation list (as from
            :func:`uccsd_excitations`) in place of full UCCSD.
        device: where the statevector lives, ``"cuda"`` or ``"cpu"``.

    Returns:
        :class:`VQEResult`; ``e_vqe`` is variational. Raises ``ValueError``
        above :data:`MAX_QUBITS` qubits.
    """
    from scipy.optimize import minimize

    psum, prog, psi0, n_params = _ansatz_setup(constant, h1, h2, nelec, mapping,
                                               excitations, resolve_device(device))
    if not prog.strings:
        with torch.no_grad():
            e_ref = float(_Expectation.apply(psi0, prog))
        return VQEResult(e_vqe=e_ref, e_reference=e_ref, params=np.zeros(0),
                         n_qubits=psum.n_qubits, n_params=0, n_strings=0,
                         mapping=mapping, converged=True, n_iterations=0,
                         history=[e_ref])
    value_and_grad, e_ref = _objective(prog, psi0)
    history = [e_ref]

    def fun(x):
        v, g = value_and_grad(x)
        history.append(v)
        return v, g

    x0 = (np.zeros(n_params) if init_params is None
          else np.asarray(init_params, dtype=np.float64))
    res = minimize(fun, x0, jac=True, method="L-BFGS-B",
                   options={"maxiter": maxiter, "gtol": conv_tol, "ftol": 1e-13})
    # a failed final line search with a chemically converged gradient is
    # still a converged VQE (the energy error is quadratic in the gradient)
    _, g_final = value_and_grad(res.x)
    converged = bool(res.success) or float(np.max(np.abs(g_final))) < 30 * conv_tol
    return VQEResult(e_vqe=float(res.fun), e_reference=e_ref, params=np.asarray(res.x),
                     n_qubits=psum.n_qubits, n_params=n_params,
                     n_strings=len(prog.strings), mapping=mapping,
                     converged=converged, n_iterations=int(res.nit), history=history)


# ---------------------------------------------------------------- ADAPT-VQE

@dataclass
class AdaptVQEResult:
    """ADAPT-VQE state: the grown ansatz and its energy trajectory."""

    e_vqe: float
    e_reference: float
    params: np.ndarray
    op_indices: list
    n_qubits: int
    mapping: str
    converged: bool
    max_gradient: float
    history: list = field(default_factory=list)  # (op, |grad|, energy)

    def __repr__(self):
        return (f"AdaptVQEResult(e_vqe={self.e_vqe:.10f}, "
                f"n_ops={len(self.op_indices)}, "
                f"max_gradient={self.max_gradient:.2e}, "
                f"converged={self.converged})")


def run_adapt_vqe(constant, h1, h2, nelec, mapping: str = "jw", grad_tol: float = 1e-3,
                  max_ops: int = 60, maxiter: int = 300, conv_tol: float = 1e-7,
                  device="cuda") -> AdaptVQEResult:
    """ADAPT-VQE (Grimsley et al., Nat. Commun. 10, 3007 (2019)).

    Grows the ansatz one operator at a time from the spin-preserving
    singles+doubles pool: every pool gradient ``dE/dtheta_k|_0 =
    2 <H psi|K_k psi>`` comes from one ``H psi`` and one pass over the
    pool's strings; the largest is appended and all amplitudes are
    re-optimised (warm-started L-BFGS-B) until ``max|grad| < grad_tol``.
    """
    from scipy.optimize import minimize

    device = resolve_device(device)
    psum, pool_prog, psi0, n_pool = _ansatz_setup(constant, h1, h2, nelec, mapping,
                                                  None, device)
    n_qubits = psum.n_qubits
    ladder = _ladder_factory(mapping, n_qubits)
    pool = uccsd_excitations(n_qubits, nelec)[1]
    pool_strings = [_generator_strings(exc, ladder) for exc in pool]

    if _GRAPHED:
        program = _adapt_program(pool_prog, psi0, max_ops)
        e_ref = program.reference_energy()
    else:
        with torch.no_grad():
            e_ref = float(_Expectation.apply(psi0, pool_prog))
    op_indices: list = []
    thetas = np.zeros(0)
    history = []
    max_grad = np.inf
    e_cur = e_ref
    converged = False
    for _ in range(max_ops):
        if _GRAPHED:
            grads = program.pool_gradients(thetas)
        else:
            with torch.no_grad():
                psi = psi0
                if op_indices:
                    psi = _Sweep.apply(torch.as_tensor(thetas, device=device), psi0, ansatz)
                grads = _pool_gradients(pool_prog, psi).cpu().numpy()
        max_grad = float(np.max(np.abs(grads)))
        if max_grad < grad_tol:
            converged = True
            break
        k_new = int(np.argmax(np.abs(grads)))
        op_indices.append(k_new)
        thetas = np.append(thetas, 0.0)
        ansatz = _derived(pool_prog, [pool_strings[k] for k in op_indices])
        if _GRAPHED:
            # the grown list loaded into the same program: no capture after
            # the first step (the reference re-jits its objective each step)
            program.load_ansatz(ansatz)
            fun = program.value_and_grad
        else:
            fun = partial(_value_and_grad, psi0=psi0, prog=ansatz)
        res = minimize(fun, thetas, jac=True, method="L-BFGS-B",
                       options={"maxiter": maxiter, "gtol": conv_tol, "ftol": 1e-13})
        thetas = np.asarray(res.x)
        e_cur = float(res.fun)
        history.append((k_new, max_grad, e_cur))

    return AdaptVQEResult(e_vqe=e_cur, e_reference=e_ref, params=thetas,
                          op_indices=op_indices, n_qubits=n_qubits,
                          mapping=mapping, converged=converged,
                          max_gradient=max_grad, history=history)
