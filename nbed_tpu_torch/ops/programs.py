"""CUDA-graph programs: the capture machinery of the port's compiled
programs (the reference's ``jax.jit`` programs and their caches).

A program is work that reads and writes fixed device buffers only, captured
once as a CUDA graph (:class:`Captured`) and replayed; off CUDA the same
function runs uncaptured. Programs live in bounded LRU caches keyed by
structure, shapes and card (:func:`cached_program`): the SCF engine's
``_JIT_PROGRAM_CACHE`` (SCF chunks, ``get_veff``, the subsystem stage, the
grid and AO tables, the TDA/RPA matvec blocks) and the CCSD solver's sweep
and (T) caches (the reference's ``lru_cache(maxsize=8)``). :data:`RUNS`
counts what they did in this process.
"""

import gc
import time
from collections import Counter

import torch

from .jk import LaunchRecord, recording

__all__ = ["RUNS", "Captured", "cached_program", "card", "replay"]

# how the programs of this process ran: SCFEngine.kernel() calls ("graph",
# "eager"), "replays", "host_reads", "captures", "capture_s", "cycles", and
# per fixed program kind (replay()) its replays under the kind's name and
# f"{kind}_captures", f"{kind}_capture_s"; the counterpart of
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
    capture "captures", "capture_s", f"{kind}_captures" and
    f"{kind}_capture_s"."""
    if captured.captures and captured.graph is None:
        t0 = time.perf_counter()
        captured.capture()
        seconds = time.perf_counter() - t0
        for key in ("captures", f"{kind}_captures"):
            RUNS[key] += 1
        for key in ("capture_s", f"{kind}_capture_s"):
            RUNS[key] += seconds
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
