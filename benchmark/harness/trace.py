"""A traced stretch of requests under ``torch.profiler`` and what the
metric readers take from it: the device's busy seconds (self device time
of every kernel and copy, ``record_function`` ranges left out, as
``profiling.device_profile`` sums them), device time by kernel name, the
host duration of each ``record_function`` range, and the breakdown: the
device operations that took most time and the idle gaps by the host
operation running across them."""

import time
from collections import defaultdict

import numpy as np

__all__ = ["TraceSummary", "traced"]


class TraceSummary:
    def __init__(self, wall_s, busy_s, by_kernel, ranges, idle_by_host, requests):
        self.window_s = wall_s
        self.busy_s = busy_s
        self.by_kernel = by_kernel        # {kernel name: device seconds}
        self.ranges = ranges              # {range name: host seconds}
        self.idle_by_host = idle_by_host  # {host operation: idle device seconds}
        self.requests = requests

    def kernel_s(self, substring: str) -> float:
        return sum(s for name, s in self.by_kernel.items() if substring in name)

    def breakdown(self) -> dict:
        def top(d):
            return [[k, v] for k, v in sorted(d.items(), key=lambda kv: -kv[1])[:10]]
        return {"device_ops": top(self.by_kernel), "idle_gaps": top(self.idle_by_host)}


def traced(run, device):
    """Run ``run()`` (which returns the requests it sent) under the
    profiler and summarise it."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    cuda = str(device).startswith("cuda")
    activities = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if cuda else [])
    with profile(activities=activities) as prof:
        t0 = time.perf_counter()
        requests = run()
        if cuda:
            torch.cuda.synchronize(device)
        wall = time.perf_counter() - t0
    events = prof.events()
    annotations = {e.name for e in events if getattr(e, "is_user_annotation", False)}
    dev, host = [], []
    for e in events:
        if e.device_type == DeviceType.CUDA:
            if e.name not in annotations:
                dev.append((e.time_range.start, e.time_range.end, e.name))
        else:
            host.append((e.time_range.start, e.time_range.end, e.name))
    by_kernel = defaultdict(float)
    for start, end, name in dev:
        by_kernel[name] += (end - start) / 1e6
    ranges = defaultdict(float)
    for start, end, name in host:
        if name in annotations:
            ranges[name] += (end - start) / 1e6
    return TraceSummary(wall, sum(by_kernel.values()), dict(by_kernel), dict(ranges),
                        _idle_by_host(dev, host), requests)


def _idle_by_host(dev, host, longest=2000):
    """Idle device time between kernels, summed by the innermost host
    operation that spans the middle of each gap (the ``longest`` gaps)."""
    if not dev:
        return {}
    iv = np.array(sorted((s, e) for s, e, _ in dev), dtype=float)
    ends = np.maximum.accumulate(iv[:, 1])
    gap_start, gap_end = ends[:-1], iv[1:, 0]
    gaps = np.flatnonzero(gap_end > gap_start)
    gaps = gaps[np.argsort(gap_start[gaps] - gap_end[gaps])][:longest]
    hs = np.array([h[0] for h in host], dtype=float)
    he = np.array([h[1] for h in host], dtype=float)
    names = [h[2] for h in host]
    out = defaultdict(float)
    for g in gaps:
        mid = 0.5 * (gap_start[g] + gap_end[g])
        inside = np.flatnonzero((hs <= mid) & (he >= mid))
        name = names[inside[np.argmin(he[inside] - hs[inside])]] if len(inside) else "python"
        out[name] += (gap_end[g] - gap_start[g]) / 1e6
    return dict(out)
