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
- The ansatz sweep is :class:`_Sweep`, an autograd function whose backward
  un-applies the rotations in reverse (each is orthogonal, ``U^-1 = cos
  I - sin S``) while it carries the adjoint state: O(2^n) memory where
  reverse mode through the sweep would store one state per rotation.
- ``<psi|H|psi>`` is :class:`_Expectation`: ``H psi`` is summed in blocks of
  X masks (:func:`_apply_hamiltonian`), and its backward is ``2 H psi``.

The outer optimiser is host-side L-BFGS-B (scipy) over one value-and-
gradient evaluation per call.
"""

from dataclasses import dataclass, field

import numpy as np
import torch

from .._device import DTYPE, resolve_device
from ..ham.qubit import MAPPINGS, PauliSum, _bk_sets, _ladder_factory, _mul, _popcount

__all__ = ["run_vqe", "run_adapt_vqe", "uccsd_excitations", "VQEResult",
           "AdaptVQEResult", "vqe_statevector"]

# the statevector solvers' register cap (2^24 float64 amplitudes, 128 MB)
MAX_QUBITS = 24
# most (term, basis state) pairs of one block of H psi: the block's
# temporaries are three tensors of at most this many elements, ~0.4 GB
_BLOCK_ELEMS = 1 << 24


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


# --------------------------------------------------------- device programs

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

    cols: torch.Tensor  # (dim,) int64
    sign: torch.Tensor  # (dim,) float64, (-1)^parity(index)
    # Hamiltonian blocks: (distinct X masks (B,), mask of each term as an
    # index into them (T,), z (T,), coefficients (T,))
    blocks: list
    # ansatz strings: host ints (x, z) and device coefficients and params
    strings: list
    coeffs: torch.Tensor  # (n_strings,) float64
    pidx: torch.Tensor  # (n_strings,) int64

    def apply_string(self, v, x: int, z: int):
        """``X^x Z^z v``: ``v[j ^ x] (-1)^parity((j ^ x) & z)``."""
        idx = self.cols ^ x
        return self.sign[idx & z] * v[idx]


def _hamiltonian_blocks(psum: PauliSum, dim: int, device):
    """The real terms of ``psum`` sorted by X mask and cut into blocks of
    at most ``max(1, _BLOCK_ELEMS // dim)`` terms, each with the distinct X
    masks it holds (a mask's terms may span two blocks: H psi is linear in
    the terms)."""
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
        blocks.append(tuple(torch.as_tensor(a, device=device) for a in (
            ux, group.astype(np.int64), zs[sl], coeffs[sl].real.copy())))
    return blocks


def _apply_hamiltonian(prog: _Program, psi):
    """``H psi``, summed over blocks of X masks. In a block, mask x has
    the weight ``w_x[j] = sum_{t in x} c_t (-1)^parity(j & z_t)`` over its
    terms t, and ``(H psi)[i] += (w_x psi)[i ^ x]``; only one block's
    signs (T, 2^n) and weights (B, 2^n), B <= T, exist at a time."""
    out = torch.zeros_like(psi)
    cols = prog.cols
    for ux, group, z, c in prog.blocks:
        signs = prog.sign[cols[None, :] & z[:, None]] * c[:, None]  # (T, dim)
        w = torch.zeros((ux.shape[0], cols.shape[0]), dtype=psi.dtype,
                        device=psi.device).index_add_(0, group, signs)
        del signs
        w *= psi[None, :]
        out += torch.gather(w, 1, cols[None, :] ^ ux[:, None]).sum(0)
    return out


def _rotations(thetas, prog: _Program):
    ang = thetas[prog.pidx] * prog.coeffs
    return torch.cos(ang), torch.sin(ang)


class _Sweep(torch.autograd.Function):
    """``psi = U_N ... U_1 psi0`` with ``U_s = cos a_s + sin a_s S_s`` and
    ``a_s = theta[p_s] c_s``.

    Backward carries the state and the adjoint back through the sweep:
    at rotation s, ``dE/da_s = lam_s . S_s psi_s``, then both are
    multiplied by ``U_s^T = cos a_s - sin a_s S_s``. Only the final state
    is stored."""

    @staticmethod
    def forward(ctx, thetas, psi0, prog):
        cos, sin = _rotations(thetas, prog)
        psi = psi0
        for s, (x, z) in enumerate(prog.strings):
            psi = cos[s] * psi + sin[s] * prog.apply_string(psi, x, z)
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
            idx = prog.cols ^ x
            sgn = prog.sign[idx & z]
            s_psi = sgn * psi[idx]
            da[s] = torch.dot(lam, s_psi)
            psi = cos[s] * psi - sin[s] * s_psi
            lam = cos[s] * lam - sin[s] * (sgn * lam[idx])
        grad = torch.zeros_like(thetas).index_add_(0, prog.pidx, da * prog.coeffs)
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


def _program(psum: PauliSum, strings_per_op, device) -> _Program:
    dim = 1 << psum.n_qubits
    cols = torch.arange(dim, dtype=torch.int64, device=device)
    strings, coeffs, pidx = _stack_strings(strings_per_op)
    return _Program(
        cols=cols, sign=(1 - 2 * _bit_parity(cols)).to(DTYPE),
        blocks=_hamiltonian_blocks(psum, dim, device), strings=strings,
        coeffs=torch.tensor(coeffs, dtype=DTYPE, device=device),
        pidx=torch.tensor(pidx, dtype=torch.int64, device=device))


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
    """(E, dE/dtheta) at host amplitudes ``x`` as float and numpy array."""
    thetas = torch.tensor(x, dtype=DTYPE, device=psi0.device, requires_grad=True)
    e = _energy(thetas, psi0, prog)
    (g,) = torch.autograd.grad(e, thetas)
    return float(e.detach()), g.cpu().numpy()


def vqe_statevector(constant, h1, h2, nelec, mapping: str = "jw", params=None,
                    excitations=None, device="cuda") -> np.ndarray:
    """The real float64 ansatz statevector at amplitudes ``params`` (the
    mapped reference determinant for None), as a host array."""
    _, prog, psi0, _ = _ansatz_setup(constant, h1, h2, nelec, mapping, excitations,
                                     resolve_device(device))
    if params is None or not prog.strings:
        return psi0.cpu().numpy()
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
    with torch.no_grad():
        e_ref = float(_Expectation.apply(psi0, prog))
    history = [e_ref]
    if not prog.strings:
        return VQEResult(e_vqe=e_ref, e_reference=e_ref, params=np.zeros(0),
                         n_qubits=psum.n_qubits, n_params=0, n_strings=0,
                         mapping=mapping, converged=True, n_iterations=0,
                         history=history)

    def fun(x):
        v, g = _value_and_grad(x, psi0, prog)
        history.append(v)
        return v, g

    x0 = (np.zeros(n_params) if init_params is None
          else np.asarray(init_params, dtype=np.float64))
    res = minimize(fun, x0, jac=True, method="L-BFGS-B",
                   options={"maxiter": maxiter, "gtol": conv_tol, "ftol": 1e-13})
    # a failed final line search with a chemically converged gradient is
    # still a converged VQE (the energy error is quadratic in the gradient)
    _, g_final = _value_and_grad(res.x, psi0, prog)
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

    def pool_gradients(psi):
        h_psi = _apply_hamiltonian(pool_prog, psi)
        vals = torch.stack([torch.dot(h_psi, pool_prog.apply_string(psi, x, z))
                            for x, z in pool_prog.strings])
        return 2.0 * torch.zeros(n_pool, dtype=DTYPE, device=device).index_add_(
            0, pool_prog.pidx, vals * pool_prog.coeffs)

    with torch.no_grad():
        e_ref = float(_Expectation.apply(psi0, pool_prog))
    op_indices: list = []
    thetas = np.zeros(0)
    history = []
    max_grad = np.inf
    e_cur = e_ref
    converged = False
    for _ in range(max_ops):
        with torch.no_grad():
            psi = psi0
            if op_indices:
                psi = _Sweep.apply(torch.as_tensor(thetas, device=device), psi0, prog)
            grads = pool_gradients(psi).cpu().numpy()
        max_grad = float(np.max(np.abs(grads)))
        if max_grad < grad_tol:
            converged = True
            break
        k_new = int(np.argmax(np.abs(grads)))
        op_indices.append(k_new)
        thetas = np.append(thetas, 0.0)
        strings, coeffs, pidx = _stack_strings([pool_strings[k] for k in op_indices])
        prog = _Program(cols=pool_prog.cols, sign=pool_prog.sign,
                        blocks=pool_prog.blocks, strings=strings,
                        coeffs=torch.tensor(coeffs, dtype=DTYPE, device=device),
                        pidx=torch.tensor(pidx, dtype=torch.int64, device=device))
        res = minimize(lambda x: _value_and_grad(x, psi0, prog), thetas, jac=True,
                       method="L-BFGS-B",
                       options={"maxiter": maxiter, "gtol": conv_tol, "ftol": 1e-13})
        thetas = np.asarray(res.x)
        e_cur = float(res.fun)
        history.append((k_new, max_grad, e_cur))

    return AdaptVQEResult(e_vqe=e_cur, e_reference=e_ref, params=thetas,
                          op_indices=op_indices, n_qubits=n_qubits,
                          mapping=mapping, converged=converged,
                          max_gradient=max_grad, history=history)
