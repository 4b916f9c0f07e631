"""CUDA-graph programs: the capture machinery of the port's compiled
programs (the reference's ``jax.jit`` programs and their caches).

A program is work that reads and writes fixed device buffers only, captured
once as a CUDA graph (:class:`Captured`) and replayed; off CUDA the same
function runs uncaptured. Programs live in bounded LRU caches keyed by
structure, shapes and card (:func:`cached_program`): the SCF engine's
``_JIT_PROGRAM_CACHE`` (SCF chunks, ``get_veff``, the subsystem stage, the
grid and AO tables, the TDA/RPA matvec blocks), the CCSD solver's sweep
and (T) caches (the reference's ``lru_cache(maxsize=8)``) and the
derivative programs (:data:`DERIVATIVE_PROGRAMS`: the torch ERIs, and
the HF and KS gradients, whose body runs a forward and its
``torch.autograd.grad`` in one graph). :data:`RUNS` counts what they did
in this process.
"""

import gc
import weakref
from collections import Counter
from contextlib import contextmanager

import numpy as np
import torch
from torch.autograd import forward_ad

from ..profiling import span
from .jk import LaunchRecord, recording

__all__ = ["RUNS", "BufferProgram", "Captured", "DERIVATIVE_PROGRAMS", "TangentProgram",
           "cached_program", "card", "derivative_program", "dual_scope", "gradient_body",
           "has_tangent", "replay", "structure_key", "takes_program", "tangent_body",
           "write_dual"]

# how the programs of this process ran: SCFEngine.kernel() calls ("graph",
# "eager"), "replays", "host_reads", "captures", "capture_s", "cycles", and
# per fixed program kind (replay()) its replays under the kind's name and
# f"{kind}_captures", f"{kind}_capture_s", and on a card the growth of
# memory_reserved in GB over its captures (f"{kind}_pool_gb": the memory
# its graphs' pool took; "scf_pool_gb" for the SCF programs'); the
# counterpart of
# ops.jk.LAUNCHES for a run to read per phase
RUNS: Counter = Counter()

# whether a CUDA graph capture is running in this process: programs leave
# their caches (destroying their graphs) only outside one
CAPTURING = [False]


class Captured:
    """``fn()``, work that reads and writes fixed buffers only, as a CUDA
    graph: :meth:`capture` runs ``warmup()`` (default ``fn``) once
    uncaptured on a side stream, so that libraries set up their handles and
    workspaces outside the capture, then captures ``fn`` (which launches
    nothing); a call replays it. Off CUDA there is no graph and a call runs
    ``fn``. The launches captured are added to the launch counters once per
    replay (:class:`nbed_tpu_torch.ops.jk.LaunchRecord`).

    ``keep``: buffers whose values the warm-up call must leave as they
    were (a program's state): saved before it, restored after the capture.

    ``pool`` is a one-item list shared by the graphs of one structure's
    programs: the first capture fills it with its memory pool and the later
    ones capture into the same pool. A graph's allocations are temporaries
    that die within its replay (results are copied into buffers made
    outside the capture), and the graphs replay one after another on the
    stream, so the pool holds the largest graph's memory, not the sum."""

    def __init__(self, fn, device, pool: list, warmup=None, keep=()):
        self.fn, self.device, self.pool, self.warmup = fn, device, pool, warmup or fn
        self.keep = tuple(keep)
        self.graph = None
        self.record = LaunchRecord()
        # memory_reserved (bytes) just before the capture and after it
        self.reserved = None

    @property
    def captures(self) -> bool:
        return self.device.type == "cuda"

    def capture(self):
        saved = [t.clone() for t in self.keep]
        side = torch.cuda.Stream(self.device)
        side.wait_stream(torch.cuda.current_stream(self.device))
        with torch.cuda.stream(side):
            self.warmup()
        torch.cuda.current_stream(self.device).wait_stream(side)
        # torch.cuda.graph empties the allocator's cache as it starts; doing
        # it here first makes the growth of memory_reserved over the
        # capture the memory its graph took into the pool
        torch.cuda.synchronize(self.device)
        torch.cuda.empty_cache()
        before = torch.cuda.memory_reserved(self.device)
        graph = torch.cuda.CUDAGraph()
        # no garbage collection during the capture: collecting a program
        # dropped earlier (alive in some reference cycle) would destroy its
        # CUDA graphs there, which invalidates the capture
        collecting = gc.isenabled()
        gc.disable()
        CAPTURING[0] = True
        try:
            with recording(self.record), torch.cuda.graph(graph, pool=self.pool[0],
                                                          stream=side):
                self.fn()
        finally:
            CAPTURING[0] = False
            if collecting:
                gc.enable()
        if self.pool[0] is None:
            self.pool[0] = graph.pool()
        self.graph = graph
        self.reserved = (before, torch.cuda.memory_reserved(self.device))
        for t, value in zip(self.keep, saved):
            t.copy_(value)

    def __call__(self):
        if not self.captures:
            self.fn()
            return
        if self.graph is None:
            raise RuntimeError("Captured: capture() first")
        self.graph.replay()
        self.record.replayed()


def replay(captured: Captured, kind: str):
    """Run ``captured``, capturing it at its first call, and count it in
    :data:`RUNS`: "replays" and ``kind`` (this kind's replays), and at a
    capture (the span "program.capture") "captures", "capture_s",
    f"{kind}_captures" and f"{kind}_capture_s"."""
    if captured.captures and captured.graph is None:
        with span("program.capture", {"kind": kind}) as capture:
            captured.capture()
        for key in ("captures", f"{kind}_captures"):
            RUNS[key] += 1
        for key in ("capture_s", f"{kind}_capture_s"):
            RUNS[key] += capture.seconds
        before, after = captured.reserved
        RUNS[f"{kind}_pool_gb"] += (after - before) / 1e9
    captured()
    RUNS["replays"] += 1
    RUNS[kind] += 1


def cached_program(cache: dict, limit: int, key, build):
    """The program of ``key`` in the LRU ``cache``, promoted to most
    recently used; else ``build()``'s, inserted after evicting the least
    recently used entries beyond ``limit`` (the reference's ``_shared_jit``
    and ``lru_cache`` rules)."""
    if CAPTURING[0]:
        raise RuntimeError("a program cache is not touched during a CUDA graph capture")
    prog = cache.get(key)
    if prog is None:
        while len(cache) >= limit:
            cache.pop(next(iter(cache)))
        prog = build()
    else:
        del cache[key]
    cache[key] = prog
    return prog


def card(device) -> torch.device:
    """``device`` with its CUDA index (the current card for "cuda"): the
    card a program's buffers and graphs live on, a part of its keys (the
    reference's jit specialises per placement)."""
    device = torch.device(device)
    if device.type == "cuda" and device.index is None:
        device = torch.device("cuda", torch.cuda.current_device())
    return device


# the derivative programs of this process: the "eri" program
# (integrals.eri.eri_program) and the "hf_grad"/"ks_grad" gradient
# programs (solvers.gradients), keyed by (kind, structure_key, shapes and
# the kind's constants, card); an LRU of its own, as the CCSD solver's
DERIVATIVE_PROGRAMS: dict = {}
DERIVATIVE_PROGRAMS_MAX = 16


class _Pool(list):
    """The one-item pool list of :class:`Captured`, weakly referenced by its
    structure's key: it lives as long as a program of the structure."""


_POOLS = weakref.WeakValueDictionary()


def structure_key(mol) -> tuple:
    """What fixes a derivative program's tables and constants: ``mol``'s
    atoms, basis, charge and spin, and its MM charges, values included
    (they enter the program's core Hamiltonian and nuclear repulsion as
    constants, not buffers)."""
    mm = None
    if mol.mm_coords is not None:
        mm = tuple(tuple(np.asarray(a, dtype=np.float64).ravel().tolist())
                   for a in (mol.mm_coords, mol.mm_charges,
                             () if mol.mm_radii is None else mol.mm_radii))
    return (tuple(int(z) for z in mol.atom_charges), mol.basis, mol.charge, mol.spin, mm)


def takes_program(jit_kernel: str, tensors, tangent: bool = False) -> bool:
    """Whether a derivative call runs as a program: "on" everywhere (the
    body uncaptured off CUDA), "auto" on a CUDA device, "off" never.
    Tensors that carry ``requires_grad`` run eagerly under "auto" and raise
    under "on"; so do forward-mode tangents, unless the call has a
    ``tangent`` program (:class:`TangentProgram`), which takes them."""
    from ..scf.hf import carries_derivative

    if jit_kernel not in ("on", "off", "auto"):
        raise ValueError(f"jit_kernel must be 'on', 'off' or 'auto', got {jit_kernel!r}")
    if jit_kernel == "off":
        return False
    tensors = [t for t in tensors if isinstance(t, torch.Tensor)]
    if tangent:
        refused = any(t.requires_grad for t in tensors)
    else:
        refused = any(carries_derivative(t) for t in tensors)
    if refused:
        if jit_kernel == "on":
            what = "requires_grad" if tangent else "requires_grad or a forward-mode tangent"
            raise ValueError(f"jit_kernel='on' takes no input that carries {what}; use 'auto' "
                             "or 'off'")
        return False
    return jit_kernel == "on" or tensors[0].device.type == "cuda"


class BufferProgram:
    """A derivative program: ``body()`` reads the ``inputs`` buffers and
    writes the ``outputs`` buffers only, as a :class:`Captured` graph of
    ``kind``. A call copies its values into the inputs (outside the graph,
    under ``no_grad``: an input may be a leaf that requires grad, which the
    body differentiates), replays, and returns the outputs, which the next
    call overwrites. ``holds``: the constant tensors the body reads from
    bounded caches (device tables of a molecule), which its graph reads by
    address: the program keeps them alive, so that a cache eviction cannot
    free memory the graph still reads."""

    def __init__(self, kind: str, inputs: dict, outputs: dict, body, device, pool: list,
                 holds=()):
        self.kind, self.inputs, self.outputs = kind, inputs, outputs
        self.holds = tuple(holds)
        self.captured = Captured(body, device, pool)

    def __call__(self, **values) -> dict:
        with torch.no_grad():
            for name, value in values.items():
                self.inputs[name].copy_(value)
        replay(self.captured, self.kind)
        return self.outputs


def gradient_body(energy, x, out):
    """The body of a gradient program: ``out`` <- d sum(energy(x)) / dx,
    the forward and its ``torch.autograd.grad`` in one capture (the
    whole-network capture of the PyTorch CUDA-graph notes: the warm-up on
    a side stream, every shape fixed). ``x`` is a leaf buffer that
    requires grad; the energies of lanes are summed, giving each lane's
    own gradient."""
    def body():
        with torch.enable_grad():
            (grad,) = torch.autograd.grad(torch.sum(energy(x)), x)
        with torch.no_grad():
            out.copy_(grad)

    return body


def has_tangent(t) -> bool:
    """Whether ``t`` is a tensor that carries a forward-mode tangent."""
    return isinstance(t, torch.Tensor) and forward_ad.unpack_dual(t).tangent is not None


@contextmanager
def dual_scope():
    """A forward-mode AD level for the block: the caller's where one is
    open (a program called under ``forward_ad.dual_level()`` makes its dual
    tensors in it; torch nests no levels), else a new one."""
    if forward_ad._current_level >= 0:
        yield
    else:
        with forward_ad.dual_level():
            yield


def write_dual(pair, value):
    """Copy ``value``'s primal and forward-mode tangent (zero where it has
    none) into the (primal, tangent) buffers ``pair``."""
    primal, tangent = forward_ad.unpack_dual(value)
    with torch.no_grad():
        pair[0].copy_(primal)
        if tangent is None:
            pair[1].zero_()
        else:
            pair[1].copy_(tangent)


def tangent_body(fn, inputs: dict, outputs: dict):
    """The body of a tangent program, the counterpart of
    :func:`gradient_body`: in a forward-mode level (:func:`dual_scope`), the
    inputs ({name: (primal, tangent)} buffers) as dual tensors, ``fn(**duals)
    -> {name: tensor}``, and each output's primal and tangent (zero where it
    has none) written into its ({name: (primal, tangent)}) buffers. The
    capture records the primal and tangent kernels of every operation."""
    def body():
        with dual_scope():
            duals = {name: forward_ad.make_dual(p, t) for name, (p, t) in inputs.items()}
            result = fn(**duals)
            for name, pair in outputs.items():
                write_dual(pair, result[name])

    return body


class TangentProgram:
    """A forward-mode derivative program: ``fn(**duals) -> {name: tensor}``
    on dual views of its input buffers ({name: (primal, tangent)}, made
    from ``inputs``' shapes and dtypes), captured with :func:`tangent_body`
    as a :class:`Captured` graph of ``kind``. A call takes tensors that
    may carry forward-mode tangents, copies their primals and tangents
    (zero where there is none) into the buffers, replays, and returns the
    outputs as dual tensors of the caller's level (views of the output
    buffers, which the next call overwrites). The output buffers are made
    at the first call from one uncaptured run of ``fn`` (their shapes).
    ``holds`` as :class:`BufferProgram`'s."""

    def __init__(self, kind: str, inputs: dict, fn, device, pool: list, holds=()):
        self.kind, self.fn = kind, fn
        self.inputs = {name: (torch.zeros_like(t), torch.zeros_like(t))
                       for name, t in inputs.items()}
        self.outputs = None
        self.device, self.pool = device, pool
        self.holds = tuple(holds)
        self.captured = None

    def _allocate(self):
        """The output buffers, from one uncaptured run on the inputs."""
        with dual_scope():
            duals = {name: forward_ad.make_dual(p, t) for name, (p, t) in self.inputs.items()}
            result = self.fn(**duals)
            primals = {name: forward_ad.unpack_dual(v).primal for name, v in result.items()}
            self.outputs = {name: (torch.empty_like(p), torch.empty_like(p))
                            for name, p in primals.items()}
        self.captured = Captured(tangent_body(self.fn, self.inputs, self.outputs),
                                 self.device, self.pool)

    def __call__(self, **values) -> dict:
        for name, value in values.items():
            write_dual(self.inputs[name], value)
        if self.outputs is None:
            self._allocate()
        replay(self.captured, self.kind)
        with dual_scope():
            return {name: forward_ad.make_dual(p, t) for name, (p, t) in self.outputs.items()}


def derivative_program(key: tuple, device, build):
    """The derivative program of ``key`` on ``device``'s card, from the LRU
    :data:`DERIVATIVE_PROGRAMS`; else ``build(card, pool)``'s, its graphs
    in the memory pool shared by the programs of its structure (``key[1]``)
    on that card."""
    device = card(device)
    pool_key = (key[1], device)

    def make():
        pool = _POOLS.get(pool_key)
        if pool is None:
            pool = _POOLS[pool_key] = _Pool([None])
        return build(device, pool)

    return cached_program(DERIVATIVE_PROGRAMS, DERIVATIVE_PROGRAMS_MAX, (*key, device), make)
