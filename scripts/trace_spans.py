"""Where the card waits in a benchmark cell, step by step: the traced
stretch's idle device time by the innermost host operation across each gap
(the benchmark's own attribution, ``benchmark/harness/trace.py``, in full),
the share of it that no step below a driver stage names, the spans per
request and their host seconds, what the spans cost with the profiler on
and off, and what the driver stages' closing synchronise costs.

    python3 scripts/trace_spans.py --workload pra_sto3g_huz.scan [--requests 4]
        [--seed N] [--rounds 3] [--out FILE]

Run from the root of a checkout on a card (``--device cpu`` rehearses it).
The process keeps to the benchmark's cores and threads
(``benchmark/run.py``). A cell's warm-up requests run first, as in the
benchmark; then the same ``--requests`` requests of its window stream run
untraced, then in ``--rounds`` pairs traced with the spans' ranges and
without them, then in ``--rounds`` pairs of blocks with and without the
stages' synchronise. Prints one JSON object.
"""

import argparse
import contextlib
import json
import os
import statistics
import sys
import time
from collections import Counter
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
sys.path[:0] = [str(ROOT / "benchmark"), str(ROOT)]

if __name__ == "__main__":
    from run import CORES

    cores = sorted(os.sched_getaffinity(0))[:CORES]
    os.sched_setaffinity(0, cores)
    for var in ("OMP_NUM_THREADS", "MKL_NUM_THREADS", "OPENBLAS_NUM_THREADS"):
        os.environ[var] = str(len(cores))

import torch  # noqa: E402

from harness.main import Cell  # noqa: E402
from harness.trace import traced  # noqa: E402
from harness.traffic import Traffic  # noqa: E402
from nbed_tpu_torch import profiling  # noqa: E402

# the driver's stages (StageTimer names) and the lane program's operator
# range: idle time that lands on one of these, with no step below it open,
# is not yet put down to a step
STAGES = ("global_ks", "localize", "subsystem_dft", "mu_embed", "mu_post_embed", "pao",
          "huzinaga_embed", "huzinaga_post_embed", "embed.operators")
UNNAMED = ("python", "nbed.request") + STAGES


def _sync(device):
    if device.startswith("cuda"):
        torch.cuda.synchronize()


def _walls(entry, requests, device):
    out = []
    for request in requests:
        t0 = time.perf_counter()
        entry.run(request)
        _sync(device)
        out.append(time.perf_counter() - t0)
    return out


def _span_counts(entry, requests):
    """Spans opened per request, by name, and the requests' span tables."""
    counts = Counter()
    enter = profiling.span.__enter__

    def counting(self):
        counts[self.name] += 1
        return enter(self)

    profiling.span.__enter__ = counting
    tables = []
    try:
        for request in requests:
            out, _ = entry.run(request)
            tables.append(entry.timings(out))
    finally:
        profiling.span.__enter__ = enter
    return counts, tables


def _span_cost(n=200_000, per_request=50):
    """Host microseconds of one empty span off the profiler, outside a
    request and inside requests of ``per_request`` spans (the best of five
    loops of ``n``)."""
    def loop(inside):
        best = float("inf")
        for _ in range(5):
            seconds = 0.0
            for _ in range(n // per_request):
                with profiling.request() if inside else contextlib.nullcontext():
                    t0 = time.perf_counter()
                    for _ in range(per_request):
                        with profiling.span("x"):
                            pass
                    seconds += time.perf_counter() - t0
            best = min(best, seconds / n * 1e6)
        return best

    return {"outside_request_us": loop(False), "inside_request_us": loop(True)}


def _stage_sync_cost(entry, requests, device, rounds):
    """Mean request wall with the stages' synchronise and without it, in
    ``rounds`` pairs of blocks taken in turns."""
    init = profiling.StageTimer.__init__

    def unsynced(self, device=None):
        init(self, device)
        self._sync = False

    on, off = [], []
    for r in range(rounds):
        for synced in ((True, False) if r % 2 == 0 else (False, True)):
            if not synced:
                profiling.StageTimer.__init__ = unsynced
            try:
                (on if synced else off).extend(_walls(entry, requests, device))
            finally:
                profiling.StageTimer.__init__ = init
    return {"with_sync_s": statistics.mean(on), "without_sync_s": statistics.mean(off),
            "with_sync_median_s": statistics.median(on),
            "without_sync_median_s": statistics.median(off)}


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, default=2 ** 31 + 12345)
    p.add_argument("--requests", type=int, default=4)
    p.add_argument("--rounds", type=int, default=3)
    p.add_argument("--device", default="cuda")
    p.add_argument("--out", default=None)
    args = p.parse_args(argv)

    torch.backends.cuda.matmul.allow_tf32 = False
    cell = Cell(ROOT, args.workload, args.device)
    traffic = Traffic(cell.config, cell.traffic, args.seed)
    entry = cell.entry
    entry.setup(traffic)
    for i in range(int(cell.traffic.get("warmup_requests", 0))):
        entry.run(traffic.request("warmup", i))
        _sync(args.device)
    requests = [traffic.request("window", i) for i in range(args.requests)]

    result = {"workload": args.workload, "seed": args.seed, "requests": args.requests,
              "device": torch.cuda.get_device_name(0) if args.device.startswith("cuda")
              else "cpu"}
    counts, tables = _span_counts(entry, requests)
    result["spans_per_request"] = sum(counts.values()) / len(requests)
    result["spans_by_name"] = {k: v / len(requests) for k, v in counts.most_common()}
    if tables and tables[0]:
        keys = sorted({k for t in tables for k in t})
        result["timings_mean_s"] = {k: statistics.mean(t.get(k, 0.0) for t in tables)
                                    for k in keys}
    untraced = _walls(entry, requests, args.device)

    def stretch():
        for request in requests:
            entry.run(request)
        return len(requests)

    trace = traced(stretch, args.device)
    idle = dict(sorted(trace.idle_by_host.items(), key=lambda kv: -kv[1]))
    idle_s = sum(idle.values())
    unnamed = {k: v for k, v in idle.items() if k in UNNAMED}
    result["trace"] = {
        "window_s": trace.window_s, "busy_s": trace.busy_s,
        "idle_share": 1.0 - trace.busy_s / trace.window_s, "gaps_idle_s": idle_s,
        "unnamed_idle_s": sum(unnamed.values()),
        "unnamed_share": sum(unnamed.values()) / idle_s if idle_s else None,
        "unnamed": unnamed, "idle_gaps": idle,
        "ranges_s": dict(sorted(trace.ranges.items(), key=lambda kv: -kv[1])),
    }
    enabled = profiling._profiling
    with_ranges, without = [trace.window_s], []
    for r in range(args.rounds):
        for ranges in ((False, True) if r % 2 == 0 else (True, False)):
            if not ranges:
                profiling._profiling = lambda: False
            try:
                (with_ranges if ranges else without).append(traced(stretch, args.device).window_s)
            finally:
                profiling._profiling = enabled
    n = len(requests)
    result["cost"] = {
        "untraced_s_per_request": sum(untraced) / n,
        "traced_s_per_request": [w / n for w in with_ranges],
        "traced_without_ranges_s_per_request": [w / n for w in without],
        "off_profiler": _span_cost(),
    }
    if tables and tables[0]:  # the driver's stages: an nbed() cell
        result["stage_sync"] = _stage_sync_cost(entry, requests, args.device, args.rounds)
    text = json.dumps(result, indent=1)
    if args.out:
        Path(args.out).parent.mkdir(parents=True, exist_ok=True)
        Path(args.out).write_text(text)
    print(text, flush=True)


if __name__ == "__main__":
    main()
