"""Per-stage wall times of the embedding pipeline, the device busy/idle
share of one call, and a profiler trace to a directory."""

import contextlib
import logging
import time

import torch

logger = logging.getLogger(__name__)

__all__ = ["StageTimer", "device_profile", "device_trace"]


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
    trace, ``trace.json`` (chrome://tracing or Perfetto open it); the
    counterpart of ``nbed_tpu/profiling.py:42``'s XLA trace."""
    from pathlib import Path

    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    out = Path(log_dir)
    out.mkdir(parents=True, exist_ok=True)
    with profile(activities=activities) as prof:
        yield prof
        if torch.cuda.is_available():
            torch.cuda.synchronize()
    prof.export_chrome_trace(str(out / "trace.json"))


class StageTimer:
    """Accumulates named stage wall times in ``timings`` (seconds).

    On a CUDA device each stage ends with ``torch.cuda.synchronize`` so the
    host clock covers the device work the stage queued, not its enqueue.
    """

    def __init__(self, device=None):
        self.timings: dict = {}
        self._sync = device is not None and torch.device(device).type == "cuda"

    @contextlib.contextmanager
    def __call__(self, name: str):
        t0 = time.perf_counter()
        try:
            yield
        finally:
            if self._sync:
                torch.cuda.synchronize()
            dt = time.perf_counter() - t0
            self.timings[name] = self.timings.get(name, 0.0) + dt
            logger.debug("stage %s: %.3f s", name, dt)
