"""Fused J/K Fock build: the wrapper of ``csrc/fused_jk.cu`` and its plain
PyTorch version.

``fused_jk(g_j, g_k, dm)`` computes ``J = G_J vec(D_a + D_b)`` and
``K_s = G_K vec(D_s)``, the function of ``nbed_tpu/ops/pallas_jk.py::fused_jk``
(the reference's only Pallas kernel), in float32 or float64. Besides one
(M, M) pair, G may be (B, R, M): B lanes (a batch of conformers, one launch
for the whole batch) of R rows each (R < M: a row slab of a supermatrix
split over devices), with (B, 2, nao, nao) densities and a (B, 3, R)
output. Tensors on the
CPU take :func:`fused_jk_reference`; tensors on a CUDA device always launch
the hand-written kernel, which is built with ``nvcc`` for ``sm_90a`` into
``nbed_tpu_torch/_build`` at first use. There is no fallback: a CUDA call
that cannot build or launch the kernel raises.

A caller that contracts one pair of supermatrices many times (an SCF)
prepares it once with :func:`prepare_jk`: on CUDA a :class:`FusedJK`, which
checks G, resolves the C entry point and makes the launch :func:`plan` at
construction, so that a call checks only the density, allocates the output
and launches. The call does no host synchronisation, so it can be captured
in a CUDA graph; launches captured inside a :func:`recording` are counted
once per replay of the graph (:class:`LaunchRecord`).
"""

import ctypes
import os
import shutil
import weakref
from collections import Counter
from contextlib import contextmanager
from dataclasses import dataclass
from functools import lru_cache
from pathlib import Path

import numpy as np
import torch
from torch.autograd import forward_ad

from .._compile import build_shared_library

__all__ = ["fused_jk", "fused_jk_reference", "prepare_jk", "forward_ad_jk", "FusedJK",
           "TangentJK", "Plan", "plan", "split", "LAUNCHES", "LAUNCHES_BY_SHAPE",
           "LaunchRecord", "count_launch", "recording", "build_kernels", "SMEM_MAX"]

_SRC = Path(__file__).resolve().parent.parent / "csrc" / "fused_jk.cu"
_NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
               "-shared", "-Xcompiler", "-fPIC"]

# launches made through the wrapper in this process, by dtype:
# "fused_jk_f64" and "fused_jk_f32"; and by (that key, M, R, B): columns,
# rows per lane and lanes
LAUNCHES: Counter = Counter()
LAUNCHES_BY_SHAPE: Counter = Counter()

# the open recordings of launches captured into CUDA graphs, innermost last
_RECORDINGS: list = []


class LaunchRecord:
    """The launches captured into one CUDA graph: a capture launches
    nothing, so a wrapper called under capture records its counts here
    instead of bumping its counters, and each replay of the graph adds them
    (:meth:`replayed`)."""

    def __init__(self):
        self._entries = {}  # (id(counter), key) -> [counter, key, launches]

    def add(self, counter: Counter, key):
        entry = self._entries.setdefault((id(counter), key), [counter, key, 0])
        entry[2] += 1

    def replayed(self, times: int = 1):
        """Add the recorded launches of ``times`` replays to their counters."""
        for counter, key, n in self._entries.values():
            counter[key] += n * times

    def launches(self, counter: Counter) -> dict:
        """{key: launches per replay} recorded for ``counter``."""
        return {key: n for c, key, n in self._entries.values() if c is counter}


@contextmanager
def recording(record: LaunchRecord):
    """Record into ``record`` the launches captured inside the block."""
    _RECORDINGS.append(record)
    try:
        yield record
    finally:
        _RECORDINGS.remove(record)


def count_launch(counter: Counter, key):
    """Count one launch under ``key``, or, while torch's current stream is
    being captured, record it in the innermost open :func:`recording` (a
    capture outside any recording, such as a test's, counts nothing)."""
    if torch.cuda.is_current_stream_capturing():
        if _RECORDINGS:
            _RECORDINGS[-1].add(counter, key)
    else:
        counter[key] += 1

# the launch plan's limits; they mirror the constants of csrc/fused_jk.cu
SMEM_MAX = 232448          # dynamic shared memory a block may use on the H100
_RING_OFFSET = 1024        # mbarriers and reduction scratch ahead of the ring
_RING_WARPS = 8            # consumer warps of a ring block (one more produces)
_VEC_WARPS = 8             # most warps of a vector-path block
_MAX_STAGE, _MIN_STAGE = 16384, 4096  # bytes of one stage of one matrix
# rows of at least this many bytes stream through the bulk-copy ring;
# shorter ones take 16-byte loads straight from device memory
RING_MIN_ROW_BYTES = 16384


@dataclass(frozen=True)
class Plan:
    """How one J/K build of B lanes of (R, M) G is launched
    (``csrc/fused_jk.cu``'s Plan).

    ``path`` is "vector" (one warp per row, 16-byte loads from device
    memory), "ring" (densities resident in shared memory, G streamed
    through ``stages`` bulk-copy stages of ``seg_elems`` words per matrix)
    or "chunked" (the ring with the densities staged ``chunk_cols`` columns
    at a time, where all of them do not fit beside it). ``warps`` is the
    warps per block (the ring's consumers; a producer warp comes on top).
    ``rows`` is R and ``batch`` B; a ring block loops over the lanes.
    """

    m: int
    word: int
    path: str
    grid: int
    warps: int
    stages: int = 0
    seg_elems: int = 0
    chunk_cols: int = 0
    smem_bytes: int = 0
    rows: int = 0
    batch: int = 1


def plan(m: int, word: int, sm_count: int, path: str = None,
         chunk_cols: int = None, rows: int = None, batch: int = 1) -> Plan:
    """The launch plan of a build of ``batch`` lanes of ``rows`` rows
    (default M) of M columns, in words of ``word`` bytes, on a card of
    ``sm_count`` SMs. ``path`` forces a path (measurements, tests);
    ``chunk_cols`` forces the chunked path's density chunk. The path
    follows the row length alone; the vector path spreads the B * R rows
    of all lanes over its warps, the ring one block per SM over R."""
    rows = m if rows is None else rows
    if path is None:
        path = "vector" if m * word < RING_MIN_ROW_BYTES else "ring"
    if path == "vector":
        total = batch * rows
        warps = min(_VEC_WARPS, -(-total // sm_count))
        # every warp of the grid resident at full occupancy (64 warps / SM)
        grid = min(-(-total // warps), (64 // warps) * sm_count)
        return Plan(m, word, "vector", grid, warps, rows=rows, batch=batch)
    if path not in ("ring", "chunked"):
        raise ValueError(f"unknown fused_jk path {path!r}")
    grid = min(rows, sm_count)  # one block per SM: the ring fills its shared memory
    if path == "ring":
        avail = SMEM_MAX - _RING_OFFSET - 2 * m * word
        for stages in (4, 3):
            seg_bytes = min(_MAX_STAGE, avail // (2 * stages) // 128 * 128)
            if seg_bytes >= _MIN_STAGE:
                return Plan(m, word, "ring", grid, _RING_WARPS, stages, seg_bytes // word,
                            m, _RING_OFFSET + 2 * stages * seg_bytes + 2 * m * word,
                            rows, batch)
        path = "chunked"  # the densities do not fit beside a ring of 3 stages
    # a smaller ring leaves wider density chunks (fewer passes over the rows)
    stages, seg_bytes = 4, _MAX_STAGE // 2
    if chunk_cols is None:
        chunk_cols = (SMEM_MAX - _RING_OFFSET - 2 * stages * seg_bytes) // (2 * word) // 32 * 32
    chunk_cols = min(chunk_cols, m)
    smem = _RING_OFFSET + 2 * stages * seg_bytes + 2 * chunk_cols * word
    if smem > SMEM_MAX:
        raise ValueError(f"fused_jk: a density chunk of {chunk_cols} columns does not fit")
    return Plan(m, word, "chunked", grid, _RING_WARPS, stages, seg_bytes // word, chunk_cols,
                smem, rows, batch)


def split(m: int, word: int, rows, c0: int, c1: int):
    """(head, body, tail) columns of columns [c0, c1) of each of ``rows``
    (an int array: rows of the flattened (B * R, M) matrix) of a matrix of
    M columns with a 16-byte aligned base: scalars
    up to the first 16-byte boundary, whole 16-byte vectors, scalars. The
    host mirror of ``split`` in ``csrc/fused_jk.cu``."""
    vw = 16 // word
    start = np.asarray(rows, dtype=np.int64) * m + c0
    head = np.minimum((-start) % vw, c1 - c0)
    body = (c1 - c0 - head) // vw * vw
    return head, body, c1 - c0 - head - body


class _PlanC(ctypes.Structure):
    _fields_ = [("m", ctypes.c_int64), ("rows", ctypes.c_int64), ("path", ctypes.c_int32),
                ("grid", ctypes.c_int32), ("warps", ctypes.c_int32),
                ("stages", ctypes.c_int32), ("seg_elems", ctypes.c_int32),
                ("chunk_cols", ctypes.c_int32), ("smem_bytes", ctypes.c_int32),
                ("batch", ctypes.c_int32)]


def _nvcc() -> str:
    for root in (os.environ.get("CUDA_HOME"), "/usr/local/cuda"):
        if root and Path(root, "bin", "nvcc").is_file():
            return str(Path(root, "bin", "nvcc"))
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError("nvcc not found: the CUDA kernels cannot be built")
    return found


@lru_cache(maxsize=1)
def build_kernels() -> ctypes.CDLL:
    """Build (if stale) and load the kernel library."""
    lib = ctypes.CDLL(str(build_shared_library([_nvcc(), *_NVCC_FLAGS], _SRC,
                                               "libnbed_jk.so")))
    for name in ("nbed_jk_f64", "nbed_jk_f32"):
        fn = getattr(lib, name)
        fn.argtypes = [ctypes.c_void_p] * 6
        fn.restype = ctypes.c_int
    lib.nbed_jk_init.argtypes = []
    lib.nbed_jk_init.restype = ctypes.c_int
    return lib


@lru_cache(maxsize=None)
def _init_device(index: int) -> int:
    """Raise the ring kernels' shared memory limit on device ``index``;
    returns its SM count."""
    lib = build_kernels()
    with torch.cuda.device(index):
        err = lib.nbed_jk_init()
    if err != 0:
        raise RuntimeError(f"fused_jk kernel set-up failed with CUDA error {err}")
    return torch.cuda.get_device_properties(index).multi_processor_count


def _rows_reference(g_j, g_k, dm):
    """(3, R) rows of one lane: G_J vec(D_a + D_b) and G_K vec(D_s), the
    products of ``run_scf``'s default ``get_jk`` in
    ``nbed_tpu/scf/hf.py:195-199``. On the CPU a row's value does not
    depend on which other rows are computed, for slabs of four rows or
    more (torch's CPU product takes another path below that)."""
    m = dm.shape[-1] ** 2
    j = g_j @ (dm[0] + dm[1]).reshape(-1)
    k = (g_k @ dm.reshape(2, m).T).T
    return torch.cat([j[None], k])


def fused_jk_reference(g_j, g_k, dm):
    """Plain PyTorch J/K. For (M, M) supermatrices and (2, nao, nao)
    densities: (J (nao, nao), K (2, nao, nao)). For (B, R, M) and
    (B, 2, nao, nao): the (B, 3, R) output of the lane/slab kernel, lane by
    lane, so that each lane and row equals the single build's bitwise."""
    if g_j.ndim == 3:
        return torch.stack([_rows_reference(g_j[b], g_k[b], dm[b])
                            for b in range(g_j.shape[0])])
    n = dm.shape[-1]
    out = _rows_reference(g_j, g_k, dm)
    return out[0].reshape(n, n), out[1:].reshape(2, n, n)


class FusedJK:
    """The fused J/K kernel prepared for one pair of CUDA supermatrices.

    Construction checks G, builds the kernel library, and fixes the entry
    point, the device and the launch :func:`plan` (``path`` forces one; see
    :func:`plan`). G is either (M, M) with M = nao^2, and a call ``jk(dm)``
    takes (2, nao, nao) densities and returns (J (nao, nao), K (2, nao,
    nao)), views of one new output; or (B, R, M) with R <= M (B lanes of R
    rows), and a call takes (B, 2, nao, nao) densities and returns the new
    (B, 3, R) output (J, K_a, K_b rows of each lane). G lies on one CUDA
    device, in one dtype of float32 or float64, contiguous and 16-byte
    aligned; the densities in G's dtype on its device, contiguous. A call
    launches without a device guard when the current device is G's.
    """

    def __init__(self, g_j, g_k, path: str = None, chunk_cols: int = None):
        lanes = g_j.ndim == 3
        m = g_j.shape[-1] if g_j.ndim in (2, 3) else -1
        nao = int(round(m ** 0.5)) if m > 0 else 0
        if lanes:
            batch, rows = g_j.shape[0], g_j.shape[1]
            if nao * nao != m or not (1 <= rows <= m) or batch < 1:
                raise ValueError("g_j must be (B, R, M) with M = nao^2 and 1 <= R <= M, "
                                 f"got {tuple(g_j.shape)}")
        else:
            batch, rows = 1, m
            if g_j.ndim != 2 or g_j.shape[0] != m or nao * nao != m:
                raise ValueError(f"g_j must be (M, M) with M = nao^2, got {tuple(g_j.shape)}")
        if g_k.shape != g_j.shape:
            raise ValueError(f"g_k must be {tuple(g_j.shape)} as g_j, got {tuple(g_k.shape)}")
        if g_j.dtype not in (torch.float32, torch.float64) or g_k.dtype != g_j.dtype:
            raise TypeError("fused_jk takes float32 or float64 supermatrices of one "
                            f"dtype, got {g_j.dtype} and {g_k.dtype}")
        if g_j.device.type != "cuda" or g_k.device != g_j.device:
            raise ValueError("fused_jk: g_j and g_k must lie on one CUDA device, "
                             f"got {g_j.device} and {g_k.device}")
        if not (g_j.is_contiguous() and g_k.is_contiguous()):
            raise ValueError("fused_jk needs contiguous supermatrices")
        if g_j.data_ptr() % 16 or g_k.data_ptr() % 16:
            raise ValueError("fused_jk needs 16-byte aligned supermatrices")
        self.g_j, self.g_k = g_j, g_k  # kept alive: the kernel reads their memory
        self.dtype, self.device = g_j.dtype, g_j.device
        self.lanes = lanes
        self._index = g_j.device.index
        self.plan = plan(m, g_j.element_size(), _init_device(self._index), path, chunk_cols,
                         rows, batch)
        self._cplan = _PlanC(m, rows, 0 if self.plan.path == "vector" else 1, self.plan.grid,
                             self.plan.warps, self.plan.stages, self.plan.seg_elems,
                             self.plan.chunk_cols, self.plan.smem_bytes, batch)
        self._cplan_ptr = ctypes.addressof(self._cplan)
        f64 = g_j.dtype == torch.float64
        self._fn = build_kernels().nbed_jk_f64 if f64 else build_kernels().nbed_jk_f32
        self._key = "fused_jk_f64" if f64 else "fused_jk_f32"
        self._key_shape = (self._key, m, rows, batch)
        self._ptrs = (g_j.data_ptr(), g_k.data_ptr())
        self._dm_shape = (batch, 2, nao, nao) if lanes else (2, nao, nao)
        # a fresh output per call, allocated like this template (measured
        # cheaper on the host than torch.empty with shape, dtype and device)
        self._out_like = torch.empty((batch, 3, rows) if lanes else (3, nao, nao),
                                     dtype=g_j.dtype, device=g_j.device)

    def launch(self, dm):
        """Check ``dm``, launch, count; returns the raw output, (B, 3, R)
        or (3, nao, nao)."""
        if not (dm.shape == self._dm_shape and dm.dtype == self.dtype
                and dm.device == self.device and dm.is_contiguous()):
            raise ValueError(f"fused_jk: dm must be a contiguous {self.dtype} tensor of "
                             f"shape {self._dm_shape} on {self.device}, got {dm.dtype} "
                             f"{tuple(dm.shape)} on {dm.device}")
        out = torch.empty_like(self._out_like)
        # the raw handle of torch's current stream on the device, without the
        # Stream object that torch.cuda.current_stream builds (a few µs)
        stream = torch._C._cuda_getCurrentRawStream(self._index)
        if torch.cuda.current_device() == self._index:
            err = self._fn(*self._ptrs, dm.data_ptr(), out.data_ptr(), self._cplan_ptr,
                           stream)
        else:
            with torch.cuda.device(self._index):
                err = self._fn(*self._ptrs, dm.data_ptr(), out.data_ptr(),
                               self._cplan_ptr, stream)
        if err != 0:
            raise RuntimeError(f"fused_jk kernel launch failed with CUDA error {err}")
        count_launch(LAUNCHES, self._key)
        count_launch(LAUNCHES_BY_SHAPE, self._key_shape)
        return out

    def __call__(self, dm):
        out = self.launch(dm)
        return out if self.lanes else (out[0], out[1:])


def prepare_jk(g_j, g_k):
    """``dm -> (J, K)`` (or the (B, 3, R) output for (B, R, M) G) for one
    pair of supermatrices: a :class:`FusedJK` on CUDA, the plain version on
    the CPU."""
    if g_j.device.type == "cpu" and g_k.device.type == "cpu":
        return lambda dm: fused_jk_reference(g_j, g_k, dm)
    return FusedJK(g_j, g_k)


def fused_jk(g_j, g_k, dm):
    """Fused Coulomb/exchange build.

    Args:
        g_j: (M, M) Coulomb supermatrix (ij|kl), M = nao^2; or (B, R, M).
        g_k: (M, M) exchange supermatrix (ik|jl); or (B, R, M).
        dm: (2, nao, nao) spin densities; or (B, 2, nao, nao).

    Returns:
        (j, k): j (nao, nao); k (2, nao, nao), in the dtype of the inputs;
        for (B, R, M) G the (B, 3, R) rows of J, K_a and K_b.
    """
    if all(t.device.type == "cpu" for t in (g_j, g_k, dm)):
        return fused_jk_reference(g_j, g_k, dm)
    return FusedJK(g_j, g_k)(dm)


class TangentJK:
    """The J/K of (B, R, M) supermatrices ``g_j``, ``g_k`` and of their
    forward-mode tangents ``g_j_dot``, ``g_k_dot`` (None: zero), prepared
    once: on CUDA a :class:`FusedJK` on G and one on its tangent, on the
    CPU the plain version. J/K is linear in G and in D, so a call on a
    density ``dm`` (B, 2, nao, nao) that may carry a tangent returns the
    (B, 3, R) output JK(G, D) with the tangent JK(G, dD) + JK(dG, D):
    three launches of the kernel, no host read (a CUDA graph captures it).

    A program prepares one on its own buffers; :func:`forward_ad_jk` then
    finds it again for dual views of those buffers (:data:`_TANGENT_JK`)."""

    def __init__(self, g_j, g_k, g_j_dot=None, g_k_dot=None):
        def zero_if_none(t, like):
            return torch.zeros_like(like) if t is None else t

        self.g = (g_j, g_k)
        self.g_dot = (zero_if_none(g_j_dot, g_j), zero_if_none(g_k_dot, g_k))
        if g_j.device.type == "cpu":
            self.jk = lambda dm: fused_jk_reference(*self.g, dm)
            self.jk_dot = lambda dm: fused_jk_reference(*self.g_dot, dm)
        else:
            self.g = tuple(t.contiguous() for t in self.g)
            self.g_dot = tuple(t.contiguous() for t in self.g_dot)
            self.jk, self.jk_dot = FusedJK(*self.g).launch, FusedJK(*self.g_dot).launch
        _TANGENT_JK[_tangent_key(*self.g, *self.g_dot)] = self

    def __call__(self, dm):
        primal, tangent = forward_ad.unpack_dual(dm)
        out = self.jk(primal.contiguous())
        out_dot = self.jk_dot(primal.contiguous())
        if tangent is not None:
            out_dot = out_dot + self.jk(tangent.contiguous())
        return forward_ad.make_dual(out, out_dot)


def _tangent_key(*tensors) -> tuple:
    """What identifies the memory of supermatrices and their tangents:
    address, shape, strides, dtype and device of each."""
    return tuple((t.data_ptr(), tuple(t.shape), t.stride(), t.dtype, t.device)
                 for t in tensors)


# the TangentJK prepared on each live set of buffers, held by their
# programs: a dual view of the same memory finds it
_TANGENT_JK = weakref.WeakValueDictionary()


def forward_ad_jk(g_j, g_k):
    """``dm -> (B, 3, R)`` for (B, R, M) supermatrices that may carry
    forward-mode tangents (``torch.autograd.forward_ad`` dual tensors, as
    the geometry-differentiable embedding program makes them): the
    :class:`TangentJK` prepared on the same memory where a program made
    one, else a new one on CUDA; on the CPU the plain version, which
    forward AD passes through. Without tangents, :func:`prepare_jk`."""
    (pj, tj), (pk, tk) = forward_ad.unpack_dual(g_j), forward_ad.unpack_dual(g_k)
    if tj is None and tk is None:
        return prepare_jk(pj, pk)
    if tj is not None and tk is not None:
        prepared = _TANGENT_JK.get(_tangent_key(pj, pk, tj, tk))
        if prepared is not None:
            return prepared
    if g_j.device.type == "cpu":
        return lambda dm: fused_jk_reference(g_j, g_k, dm)
    return TangentJK(pj.contiguous(), pk.contiguous(), tj, tk)
