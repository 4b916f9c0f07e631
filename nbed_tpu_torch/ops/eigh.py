"""Symmetric eigendecomposition that a CUDA graph can capture: the wrapper
of ``csrc/eigh.cu`` and its plain version, ``torch.linalg.eigh``.

The graphed SCF (:mod:`nbed_tpu_torch.scf.engine`, ``jit_kernel``)
diagonalises the Fock matrix and solves the DIIS system inside a captured
graph. ``torch.linalg.eigh`` cannot be captured: it reads its status output
back to the host after every call. :class:`Eigh` calls cuSOLVER directly
instead (``cusolverDnXsyevBatched``, the one cuSOLVER eigensolver that
captures on the H100), with its handle, workspaces and device status array
made once per (dtype, order, batch); a call enqueues the solver on torch's
current stream and reads nothing back. The status stays on the device: each
call adds the count of failed matrices to the device's
:func:`failure_count`, which the caller reads after the graph has run and
raises on.

:func:`eigh_jvp` is the same call with a forward-mode rule, for matrices
that carry a ``torch.autograd.forward_ad`` tangent inside a captured
program (``torch.linalg.eigh``'s own rule needs its eigh, which does not
capture).

Tensors on the CPU take :func:`eigh_reference`; tensors on a CUDA device
always launch the cuSOLVER routine, built with ``nvcc`` into
``nbed_tpu_torch/_build`` at first use. There is no fallback: a CUDA call
that cannot build or launch raises. The reference's eigh is XLA work
(``nbed_tpu/scf/hf.py:43-66``), not a Pallas kernel.
"""

import ctypes
from collections import Counter
from functools import lru_cache
from pathlib import Path

import torch

from .._compile import build_shared_library
from .jk import _NVCC_FLAGS, _nvcc, count_launch

__all__ = ["eigh", "eigh_retry", "eigh_jvp", "eigh_reference", "prepare_eigh",
           "failure_count", "Eigh", "LAUNCHES", "build_library"]

_SRC = Path(__file__).resolve().parent.parent / "csrc" / "eigh.cu"

# launches through the wrapper in this process: "eigh_f64" and "eigh_f32"
LAUNCHES: Counter = Counter()

# residual |A V - V diag(w)| relative to max |A|, and |V^T V - I|, within
# which eigh_retry counts a matrix that cuSOLVER flags as solved
_RESIDUAL_TOL = {torch.float64: 1e-10, torch.float32: 1e-4}


@lru_cache(maxsize=1)
def build_library() -> ctypes.CDLL:
    """Build (if stale) and load ``csrc/eigh.cu`` against cuSOLVER."""
    lib = ctypes.CDLL(str(build_shared_library([_nvcc(), *_NVCC_FLAGS, "-lcusolver"],
                                               _SRC, "libnbed_eigh.so")))
    ptr = ctypes.c_void_p
    lib.nbed_eigh_create.argtypes = [ctypes.POINTER(ptr)]
    lib.nbed_eigh_create.restype = ctypes.c_int
    lib.nbed_eigh_destroy.argtypes = [ptr]
    lib.nbed_eigh_destroy.restype = ctypes.c_int
    lib.nbed_eigh_workspace.argtypes = [ptr, ctypes.c_int, ctypes.c_int64, ctypes.c_int64,
                                        ctypes.POINTER(ctypes.c_size_t),
                                        ctypes.POINTER(ctypes.c_size_t)]
    lib.nbed_eigh_workspace.restype = ctypes.c_int
    lib.nbed_eigh_run.argtypes = [ptr, ctypes.c_int, ctypes.c_int64, ctypes.c_int64, ptr, ptr,
                                  ptr, ctypes.c_size_t, ptr, ctypes.c_size_t, ptr, ptr]
    lib.nbed_eigh_run.restype = ctypes.c_int
    return lib


def eigh_reference(a):
    """(eigenvalues ascending, eigenvectors as columns) of symmetric ``a``
    ([B,] n, n), reading its lower triangle: ``torch.linalg.eigh``."""
    return torch.linalg.eigh(a)


class Eigh:
    """cuSOLVER's eigh prepared for ``batch`` symmetric (n, n) matrices of
    one dtype (float64 or float32) on one CUDA device.

    A call takes (..., n, n) with ``batch`` matrices in its leading axes and
    returns (w (..., n), v (..., n, n)) as ``torch.linalg.eigh`` does: the
    lower triangle is read (row-major), eigenvalues ascend, eigenvector j
    is ``v[..., :, j]``. Each call adds the number of matrices whose
    solver status was nonzero to :attr:`failures`, the device's
    :func:`failure_count` (with ``count``, a (...) mask over the leading
    axes, only those whose result the caller uses); nothing is read back,
    so the call can be captured in a CUDA graph.
    """

    def __init__(self, n: int, batch: int, dtype, device):
        if dtype not in (torch.float64, torch.float32):
            raise TypeError(f"eigh takes float64 or float32 matrices, got {dtype}")
        device = torch.device(device)
        if device.type != "cuda":
            raise ValueError(f"Eigh prepares a CUDA device, got {device}")
        self.n, self.batch, self.dtype, self.device = int(n), int(batch), dtype, device
        self._code = 0 if dtype == torch.float64 else 1
        self._key = "eigh_f64" if dtype == torch.float64 else "eigh_f32"
        self._lib = build_library()
        self._index = device.index if device.index is not None else torch.cuda.current_device()
        handle = ctypes.c_void_p()
        with torch.cuda.device(self._index):
            err = self._lib.nbed_eigh_create(ctypes.byref(handle))
        if err != 0:
            raise RuntimeError(f"eigh: cuSOLVER set-up failed with status {err}")
        self._handle = handle
        dev_bytes, host_bytes = ctypes.c_size_t(), ctypes.c_size_t()
        err = self._lib.nbed_eigh_workspace(handle, self._code, self.n, self.batch,
                                            ctypes.byref(dev_bytes), ctypes.byref(host_bytes))
        if err != 0:
            raise RuntimeError(f"eigh: cuSOLVER workspace query failed with status {err}")
        self._dev_bytes, self._host_bytes = dev_bytes.value, host_bytes.value
        self._work = torch.empty(max(self._dev_bytes, 16), dtype=torch.uint8, device=device)
        self._host_work = (ctypes.c_char * max(self._host_bytes, 16))()
        self.info = torch.zeros(self.batch, dtype=torch.int32, device=device)
        self.failures = failure_count(device)
        # two calls before any capture: a first capture of the solver after
        # a single eager call invalidates the capture (H100, CUDA 12.9)
        eye = torch.eye(self.n, dtype=dtype, device=device).expand(self.batch, n, n)
        for _ in range(2):
            self._launch(eye)
        torch.cuda.synchronize(device)

    def __del__(self):
        lib, handle = getattr(self, "_lib", None), getattr(self, "_handle", None)
        if lib is not None and handle is not None:
            lib.nbed_eigh_destroy(handle)

    def __call__(self, a, count=None):
        w, v = self.solve(a)
        failed = self.info if count is None else self.info * count.reshape(-1)
        self.failures.add_(torch.count_nonzero(failed))
        return w, v

    def solve(self, a):
        """(w, v) of a call, adding no failure: :attr:`info` holds each
        matrix's solver status until the next call."""
        n = self.n
        if not (a.shape[-2:] == (n, n) and a.dtype == self.dtype and a.device == self.device
                and a[..., 0, 0].numel() == self.batch):
            raise ValueError(f"eigh: expected {self.batch} {self.dtype} ({n}, {n}) matrices "
                             f"on {self.device}, got {a.dtype} {tuple(a.shape)} on {a.device}")
        out = self._launch(a)
        count_launch(LAUNCHES, self._key)
        return out

    def _launch(self, a):
        n = self.n
        # cuSOLVER reads column-major: the row-major lower triangle is its
        # upper one, which csrc/eigh.cu asks for; it overwrites its input
        # with the eigenvectors as columns, i.e. rows of the row-major copy
        v = a.contiguous().clone()
        w = torch.empty(a.shape[:-1], dtype=a.dtype, device=a.device)
        stream = torch._C._cuda_getCurrentRawStream(self._index)
        err = self._lib.nbed_eigh_run(self._handle, self._code, n, self.batch,
                                      v.data_ptr(), w.data_ptr(), self._work.data_ptr(),
                                      self._dev_bytes, ctypes.addressof(self._host_work),
                                      self._host_bytes, self.info.data_ptr(), stream)
        if err != 0:
            raise RuntimeError(f"eigh: cuSOLVER launch failed with status {err}")
        return w, v.transpose(-1, -2)


def failure_count(device) -> torch.Tensor:
    """The device int64 to which every :class:`Eigh` call on ``device`` adds
    its number of failed matrices; a reader that finds it nonzero zeroes it
    and raises. One per card: "cuda" names the current card, as a tensor's
    "cuda:0" does."""
    device = torch.device(device)
    if device.type == "cuda" and device.index is None:
        device = torch.device("cuda", torch.cuda.current_device())
    return _failure_count(device)


@lru_cache(maxsize=None)
def _failure_count(device) -> torch.Tensor:
    return torch.zeros((), dtype=torch.int64, device=device)


@lru_cache(maxsize=None)
def prepare_eigh(n: int, batch: int, dtype, device) -> Eigh:
    """The :class:`Eigh` of (n, batch, dtype, device), made once per process:
    its workspace is reused by every graph and call on that device, which
    run one after another on the stream."""
    return Eigh(n, batch, dtype, device)


def _solved(solver: Eigh, a, w, v):
    """Per matrix of ``solver``'s last call on ``a`` (flat (batch,) bool),
    whether it is solved: cuSOLVER's status is 0, or its decomposition
    (``w``, ``v``) meets :data:`_RESIDUAL_TOL` (the batched solver flags
    matrices whose eigenvalues cluster at rounding level, the DIIS system
    of a nearly converged SCF, whose eigenpairs are accurate)."""
    n = solver.n
    flat_a, flat_v = a.reshape(-1, n, n), v.reshape(-1, n, n)
    scale = torch.amax(torch.abs(flat_a), dim=(-2, -1))
    residual = torch.amax(torch.abs(flat_a @ flat_v - flat_v * w.reshape(-1, 1, n)),
                          dim=(-2, -1))
    eye = torch.eye(n, dtype=a.dtype, device=a.device)
    orth = torch.amax(torch.abs(flat_v.mT @ flat_v - eye), dim=(-2, -1))
    tol = _RESIDUAL_TOL[solver.dtype]
    return (solver.info == 0) | ((residual <= tol * scale) & (orth <= tol))


def eigh_retry(a, count=None):
    """:func:`eigh`, with every matrix on which cuSOLVER fails solved
    again shifted positive definite past its Gershgorin bound (the same
    eigenvectors; eigenvalues shifted back). cuSOLVER's batched eigh can
    stop short of its tolerance on a nearly converged SCF's DIIS system,
    whose eigenvalues cluster at rounding level beside a border of ones,
    and solves it shifted (the acetonitrile Hessian's lanes on the H100,
    CUDA 12.9); a matrix counts as solved unshifted where its status is 0
    or its decomposition meets :data:`_RESIDUAL_TOL`, and keeps that
    result, so the shift moves no other iterate. A matrix that neither
    solve gives counts as failed, as in :class:`Eigh`. The CPU takes
    :func:`eigh_reference`."""
    if a.device.type == "cpu":
        return eigh_reference(a)
    n = a.shape[-1]
    solver = prepare_eigh(n, a[..., 0, 0].numel(), a.dtype, a.device)
    w, v = solver.solve(a)
    solved = _solved(solver, a, w, v)
    shift = torch.amax(torch.sum(torch.abs(a), dim=-1), dim=-1) + 1.0
    eye = torch.eye(n, dtype=a.dtype, device=a.device)
    shifted = a + shift[..., None, None] * eye
    w1, v1 = solver.solve(shifted)
    solved1 = _solved(solver, shifted, w1, v1)
    keep = solved.reshape(shift.shape)
    w = torch.where(keep[..., None], w, w1 - shift[..., None])
    v = torch.where(keep[..., None, None], v, v1)
    failed = ~(solved | solved1)
    if count is not None:
        failed = failed & count.reshape(-1)
    solver.failures.add_(torch.count_nonzero(failed))
    return w, v


def eigh(a, count=None):
    """``torch.linalg.eigh`` for ``a`` on the CPU; on CUDA the prepared
    cuSOLVER call of :class:`Eigh`, capturable in a CUDA graph (``count``
    as there)."""
    if a.device.type == "cpu":
        return eigh_reference(a)
    n = a.shape[-1]
    return prepare_eigh(n, a[..., 0, 0].numel(), a.dtype, a.device)(a, count)


class _EighJVP(torch.autograd.Function):
    """:func:`eigh` (or :func:`eigh_retry`) with the forward-mode rule of
    ``torch.linalg.eigh``: for P = V^T dA V, dw = diag(P) and dV = V (F o P),
    F_ij = 1 / (w_j - w_i) off the diagonal and 0 on it. Forward mode only."""

    @staticmethod
    def forward(ctx, a, count, retry):
        w, v = (eigh_retry if retry else eigh)(a, count)
        # a fresh row-major tensor, not the cuSOLVER call's transposed view:
        # a view's tangent must share its layout
        v = v.contiguous()
        ctx.save_for_forward(w, v)
        return w, v

    @staticmethod
    def jvp(ctx, a_dot, _count_dot, _retry_dot):
        w, v = ctx.saved_tensors
        p = (v.transpose(-1, -2) @ a_dot) @ v
        w_dot = torch.diagonal(p, dim1=-2, dim2=-1).clone()
        eye = torch.eye(w.shape[-1], dtype=torch.bool, device=w.device)
        gap = w[..., None, :] - w[..., :, None]
        off = p / torch.where(eye, torch.ones_like(gap), gap)
        return w_dot, v @ torch.where(eye, torch.zeros_like(off), off)


def eigh_jvp(a, count=None, retry: bool = False):
    """:func:`eigh` (:func:`eigh_retry` with ``retry``) of ``a``, carrying a
    forward-mode tangent of ``a`` into (w, v) by ``torch.linalg.eigh``'s
    rule (:class:`_EighJVP`): on CUDA the capturable cuSOLVER call, so a
    captured program diagonalises dual matrices; ``count`` as there. The
    eigenvector tangent divides by eigenvalue gaps, as
    ``torch.linalg.eigh``'s does."""
    return _EighJVP.apply(a, count, retry)
