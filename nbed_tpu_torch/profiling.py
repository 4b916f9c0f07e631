"""Spans of the embedding pipeline, the device busy/idle share of one
call, and a profiler trace to a directory.

A span (:class:`span`) names one step of the program. It does two things:
while a ``torch.profiler`` is recording, it opens a range of its name on the
profiler's clock, the clock of the device trace, so that a trace shows which
step the host was in while the card waited; and it adds its host seconds to
the span table of the open request (:func:`request`), a
:class:`StageTimer` whose ``timings`` every driver returns. Off the
profiler and outside a request a span costs one check and two clock reads.
"""

import contextlib
import itertools
import json
import logging
import threading
import time
from contextvars import ContextVar

import torch

logger = logging.getLogger(__name__)

__all__ = ["StageTimer", "device_profile", "device_trace", "request", "span"]

# the span table of the request open in this context, if any
_REQUEST: ContextVar = ContextVar("nbed_tpu_torch_request", default=None)
# the (thread, name, args) of the spans opened with args while a
# device_trace records in this context, in the order they opened
_TRACE_ARGS: ContextVar = ContextVar("nbed_tpu_torch_trace_args", default=None)
# request numbers of this process
_REQUESTS = itertools.count(1)

_profiling = torch._C._autograd._profiler_enabled
_range_enter = torch._C._autograd._record_function_with_args_enter
_range_exit = torch._C._autograd._record_function_with_args_exit
_clock = time.perf_counter


class span:
    """``with span(name, args):`` times the block as the step ``name``.

    While a ``torch.profiler`` is recording, and only then, the block is a
    range of ``name`` (as ``torch.profiler.record_function`` opens one);
    :func:`device_trace` writes ``args``, a dict of JSON values, into the
    range's args in its Chrome trace. The block's host seconds (the clock
    around it, no synchronise) are added under ``name`` to the open
    request's table, if a request is open, and are kept in ``seconds``.

    A span covers host time: where the block ends in a host read of a
    device result, as most SCF and solver steps do, its seconds include
    the device time it waited for; where it only enqueues, they do not.
    No span synchronises, which would add idle time of its own. Spans are
    never opened inside a CUDA-graph body: there they would time the
    capture, not the replays; a graphed layer's device time is read from
    its kernels' names in the device trace.
    """

    __slots__ = ("name", "args", "seconds", "_range", "_table", "_t0")

    def __init__(self, name: str, args: dict | None = None):
        self.name, self.args = name, args

    def __enter__(self):
        if _profiling():
            self._range = _range_enter(self.name)
            log = _TRACE_ARGS.get()
            if self.args is not None and log is not None:
                log.append((threading.get_native_id(), self.name, self.args))
        else:
            self._range = None
        self._table = _REQUEST.get()
        self._t0 = _clock()
        return self

    def __exit__(self, exc_type, exc, tb):
        end = _clock()
        self.seconds = end - self._t0
        if self._table is not None:
            # the table sums its spans when the request closes: a span
            # costs under a microsecond off the profiler
            self._table._spans.append((self.name, self._t0, end))
        if self._range is not None:
            _range_exit(self._range)
        return False


@contextlib.contextmanager
def request(device=None):
    """Open a request: a new :class:`StageTimer` (synchronising its stages
    on ``device`` where it is a CUDA device) becomes the table of every
    span in this context, under the root span "nbed.request", whose args
    carry the request's number in this process (``StageTimer.request``).
    Inside an open request, yields that request's table and opens none."""
    table = _REQUEST.get()
    if table is not None:
        yield table
        return
    table = StageTimer(device)
    table.request = next(_REQUESTS)
    token = _REQUEST.set(table)
    try:
        with span("nbed.request", {"request": table.request}):
            yield table
    finally:
        _REQUEST.reset(token)
        table.tally()


class StageTimer:
    """A request's span table: ``timings`` holds the summed host seconds of
    every span of the request by name, once the request has closed
    (:meth:`tally`). A span nested in a span of its own name adds nothing:
    the outer one covers it.

    ``timer(name)`` is a driver stage: a span of ``name`` that, on a CUDA
    device, ends with ``torch.cuda.synchronize`` so that its seconds cover
    the device work the stage queued, not its enqueue. Outside an open
    request, a stage makes this table the open one while it runs and adds
    its spans to ``timings`` as it ends.
    """

    def __init__(self, device=None):
        self.timings: dict = {}
        self.request = None
        self._spans: list = []  # (name, start, end) of the spans not yet summed
        self._sync = device is not None and torch.device(device).type == "cuda"

    def tally(self):
        """Add the spans closed since the last tally to ``timings``: per
        name the length of the union of its intervals (spans of one name
        nest or follow one another)."""
        spans, self._spans = self._spans, []
        ends = {}
        for name, start, end in sorted(spans, key=lambda s: (s[1], -s[2])):
            if start < ends.get(name, start):
                continue  # inside a span of its own name
            ends[name] = end
            self.timings[name] = self.timings.get(name, 0.0) + (end - start)

    @contextlib.contextmanager
    def __call__(self, name: str):
        token = _REQUEST.set(self) if _REQUEST.get() is not self else None
        try:
            with span(name) as s:
                try:
                    yield
                finally:
                    if self._sync:
                        torch.cuda.synchronize()
        finally:
            if token is not None:
                _REQUEST.reset(token)
                self.tally()
        logger.debug("stage %s: %.3f s", name, s.seconds)


def device_profile(fn):
    """Run ``fn()`` once under ``torch.profiler``; return (its result, summary).

    The summary holds ``wall_s``, the host wall time of the call with the
    device synchronised at its end; ``device_busy_s``, the self device time
    of every device event (kernels and copies, not ``record_function``
    ranges) summed; ``device_idle_share``
    = 1 - busy / wall; ``device_events``, their number; and ``top``, the
    twelve events with the most device time as [name, count, ms]. The sum
    is the busy time where the work runs on one stream, as the port's does.
    Without a CUDA device only host activity is recorded and the device is
    idle.
    """
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    cuda = torch.cuda.is_available()
    activities = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if cuda else [])
    with profile(activities=activities) as prof:
        t0 = time.perf_counter()
        out = fn()
        if cuda:
            torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    events = prof.key_averages()
    # record_function ranges show on the device timeline as spans over
    # their kernels: not device work of their own
    ranges = {e.key for e in events if getattr(e, "is_user_annotation", False)}
    dev = sorted((e for e in events if e.device_type == DeviceType.CUDA and e.key not in ranges),
                 key=lambda e: -e.self_device_time_total)
    busy = sum(e.self_device_time_total for e in dev) / 1e6
    return out, {
        "wall_s": wall, "device_busy_s": busy, "device_idle_share": 1.0 - busy / wall,
        "device_events": sum(e.count for e in dev),
        "top": [[e.key, e.count, e.self_device_time_total / 1e3] for e in dev[:12]],
    }


@contextlib.contextmanager
def device_trace(log_dir):
    """Trace the block under ``torch.profiler`` (host activity, and the
    card's where CUDA is available) and write it to ``log_dir`` as a Chrome
    trace, ``trace.json`` (chrome://tracing or Perfetto open it), the
    counterpart of ``nbed_tpu/profiling.py:42``'s XLA trace: the spans as
    ranges on one timeline with the card's kernels, each span's args in its
    range's args (the request number in "nbed.request")."""
    from pathlib import Path

    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    out = Path(log_dir)
    out.mkdir(parents=True, exist_ok=True)
    log = []
    token = _TRACE_ARGS.set(log)
    try:
        with profile(activities=activities) as prof:
            yield prof
            if torch.cuda.is_available():
                torch.cuda.synchronize()
    finally:
        _TRACE_ARGS.reset(token)
    path = out / "trace.json"
    prof.export_chrome_trace(str(path))
    if log:
        _write_span_args(path, log)


def _write_span_args(path, log):
    """Put the args of the spans in ``log`` into their ranges of the Chrome
    trace at ``path``: the k-th range of a name on a thread is the k-th
    span of that name opened there. A name whose ranges and spans differ
    in number on a thread is left as it is."""
    with open(path) as f:
        trace = json.load(f)
    spans = {}
    for tid, name, args in log:
        spans.setdefault((tid, name), []).append(args)
    ranges = {}
    for ev in trace.get("traceEvents", []):
        key = (ev.get("tid"), ev.get("name"))
        if ev.get("cat") == "user_annotation" and key in spans:
            ranges.setdefault(key, []).append(ev)
    for key, evs in ranges.items():
        if len(evs) == len(spans[key]):
            evs.sort(key=lambda ev: ev["ts"])
            for ev, args in zip(evs, spans[key]):
                ev.setdefault("args", {}).update(args)
    with open(path, "w") as f:
        json.dump(trace, f)
