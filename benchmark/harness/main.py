"""One run of one cell: set-up, a closed-loop window of ``--seconds``, an
optional traced stretch, the check against the plain reference, and the
result line.

Everything a cell needs is found by name: the cell in ``BENCHMARK.json``,
its configuration and traffic files under ``configs/`` and ``traffic/``,
the entry that drives the program under ``entries/<traffic entry>.py``,
each metric's reader under ``metrics/<metric name>.py`` (or, for a metric
split by the cells that report it, such as ``device.idle.fleet``, the
reader of its stem, ``metrics/device.idle.py``) and the limits of the
check under ``limits/<cell>.json``.
"""

import argparse
import gc
import importlib.util
import json
import math
import sys
import time
import traceback
from collections import Counter
from pathlib import Path

import numpy as np

from .traffic import Traffic

__all__ = ["main", "Cell", "FORBIDDEN_MODULES", "forbidden_modules"]

# top-level module names a run may not hold once its window has closed
FORBIDDEN_MODULES = ("jax", "jaxlib", "flax", "nbed_tpu")


def forbidden_modules(modules=None) -> list:
    """Names in ``sys.modules`` whose top-level name, compared whole, is
    one of FORBIDDEN_MODULES (``nbed_tpu_torch`` is not ``nbed_tpu``)."""
    names = sys.modules if modules is None else modules
    return sorted(n for n in names if n.split(".")[0] in FORBIDDEN_MODULES)


def _load_module(path: Path, name: str):
    spec = importlib.util.spec_from_file_location(name, path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def _reader(metrics_dir: Path, name: str):
    """The reader of metric ``name``: its own file, else its stem's."""
    stem = name
    while not (metrics_dir / f"{stem}.py").exists():
        if "." not in stem:
            raise FileNotFoundError(f"no reader for metric {name!r} in {metrics_dir}")
        stem = stem.rsplit(".", 1)[0]
    return _load_module(metrics_dir / f"{stem}.py", f"bench_metric_{name}")


def _json(path: Path) -> dict:
    with open(path) as f:
        return json.load(f)


class Run:
    """What the metric readers read: the cell, the window's requests, the
    counters the readers declare, set-up and window seconds, the trace."""

    def __init__(self, cell):
        self.cell = cell
        self.requests = []        # {"wall_s", "timings", "units", "ok"}
        self.setup_s = None
        self.window_s = None
        self.trace = None
        self._counters = {}       # (phase, name) -> Counter delta

    @property
    def completed(self):
        return [r for r in self.requests if r["ok"]]

    def counter(self, name: str, phase: str = "window") -> Counter:
        return self._counters.get((phase, name), Counter())


class _Counters:
    """Snapshots of the program's counters that readers name as
    "module:attribute"."""

    def __init__(self, names):
        self.names = sorted(set(names))

    def _get(self, name):
        module, attr = name.split(":")
        return Counter(getattr(importlib.import_module(module), attr))

    def snapshot(self):
        return {name: self._get(name) for name in self.names}

    def deltas(self, before, after, phase, run):
        for name in self.names:
            delta = Counter(after[name])
            delta.subtract(before[name])
            run._counters[(phase, name)] = Counter({k: v for k, v in delta.items() if v})


def _sync(device):
    import torch
    if str(device).startswith("cuda"):
        torch.cuda.synchronize()


def _parse(argv):
    p = argparse.ArgumentParser(description="One run of one benchmark cell.")
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return p.parse_args(argv)


def _reservoir_slot(k, count, rng):
    """Algorithm R: the slot of a reservoir of ``k`` that the ``count``-th
    item (0-based) of its stratum takes, or None."""
    if count < k:
        return count
    j = int(rng.integers(count + 1))
    return j if j < k else None


class Cell:
    """A cell of BENCHMARK.json with its configuration, traffic
    parameters, limits and entry, all found by name."""

    def __init__(self, root: Path, workload: str, device: str):
        manifest = _json(root / "BENCHMARK.json")
        cells = {w["name"]: w for w in manifest["workloads"]}
        if workload not in cells:
            raise KeyError(f"unknown workload {workload!r}")
        self.manifest, self.spec = manifest, cells[workload]
        configs = {c["name"]: c for c in manifest["configs"]}
        self.bench = root / manifest["paths"][0]
        self.config = _json(root / configs[self.spec["config"]]["file"])
        self.traffic = _json(self.bench / "traffic" / f"{self.spec['traffic']}.json")
        self.limits = _json(self.bench / "limits" / f"{workload}.json")
        name = self.traffic["entry"]
        self.entry_module = _load_module(self.bench / "entries" / f"{name}.py",
                                         f"bench_entry_{name}")
        self.entry = self.entry_module.Entry(self.config, self.traffic, device)

    def metrics(self, trace: bool) -> list:
        group = self.manifest["per_layer"] if trace else self.manifest["end_to_end"]
        name = self.spec["name"]
        return [m for m in group if name in m.get("workloads", [name])]


def main(argv, t_start, root: Path, device="cuda", require_card=True, patch=None):
    """Run a cell; print the result line; return the exit code. ``root``
    holds BENCHMARK.json; ``patch(entry)`` (tests only) may break the
    timed path underneath."""
    args = _parse(argv)
    import torch
    try:
        c = Cell(root, args.workload, device)
    except KeyError as exc:
        print(exc, file=sys.stderr)
        return 2
    cell, traffic_params, limits, entry = c.spec, c.traffic, c.limits, c.entry
    if require_card:
        if not torch.cuda.is_available() or torch.cuda.device_count() < int(cell["chips"]):
            print(f"this cell needs {cell['chips']} CUDA device(s); found "
                  f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}",
                  file=sys.stderr)
            return 3
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    if patch is not None:
        patch(entry)
    traffic = Traffic(c.config, traffic_params, args.seed)
    run = Run(cell)
    metrics = c.metrics(args.trace)
    readers = {m["name"]: _reader(c.bench / "metrics", m["name"]) for m in metrics}
    counters = _Counters(name for r in readers.values() for name in getattr(r, "COUNTERS", ()))

    # set-up: the entry's own, then the warm-up requests
    entry.setup(traffic)
    for i in range(int(traffic_params.get("warmup_requests", 0))):
        entry.run(traffic.request("warmup", i))
        _sync(device)
    run.setup_s = time.perf_counter() - t_start

    # the window: one caller, the next request when the last returns
    k = int(traffic_params.get("check_per_molecule", 1))
    rng = np.random.default_rng([args.seed % 2 ** 64, 5])
    kept, seen = {}, Counter()
    failed = 0
    before = counters.snapshot()
    t0 = time.perf_counter()
    end = t0
    i = 0
    while i == 0 or end - t0 < args.seconds:
        request = traffic.request("window", i)
        t1 = time.perf_counter()
        try:
            out, units = entry.run(request)
            _sync(device)
            ok = True
        except Exception:  # a failed request counts against the run
            traceback.print_exc()
            out, units, ok = None, 0, False
            failed += 1
        end = time.perf_counter()
        run.requests.append({"wall_s": end - t1, "units": units, "ok": ok,
                             "timings": entry.timings(out) if ok else {}})
        if ok:
            name = request.molecule["name"]
            slot = _reservoir_slot(k, seen[name], rng)
            seen[name] += 1
            if slot is not None:
                kept[(name, slot)] = (request, out)
        del out
        i += 1
    run.window_s = end - t0
    counters.deltas(before, counters.snapshot(), "window", run)

    if args.trace:
        from .trace import traced

        n_trace = int(traffic_params.get("trace_requests", 2))
        before = counters.snapshot()

        def stretch():
            for j in range(n_trace):
                entry.run(traffic.request("window", i + j))
            return n_trace

        run.trace = traced(stretch, device)
        counters.deltas(before, counters.snapshot(), "trace", run)

    device_info = {"platform": "gpu" if require_card else "cpu",
                   "kind": torch.cuda.get_device_name(0) if require_card else "cpu",
                   "count": int(cell["chips"]),
                   "memory_peak_bytes": int(torch.cuda.max_memory_allocated())
                   if require_card else 0}
    if run.trace is not None:
        device_info["busy_s"] = run.trace.busy_s
        device_info["window_s"] = run.trace.window_s

    # the check: the program's answers of the kept requests, then its
    # state freed, then the reference on the same inputs
    sample = [(request, entry.answers(out, request)) for request, out in kept.values()]
    kept.clear()
    gc.collect()
    if require_card:
        torch.cuda.empty_cache()
    t_ref = time.perf_counter()
    worst = {}
    for request, prog in sample:
        ref = entry.reference(request, torch.float64, device, args.seed)
        for name, gap in entry.compare(prog, ref).items():
            worst[name] = max(worst.get(name, 0.0), gap)
    print(f"seconds: set-up {run.setup_s:.3f}, window {run.window_s:.3f}, reference "
          f"{time.perf_counter() - t_ref:.3f} ({len(sample)} requests)", file=sys.stderr)
    checks = {name: {"value": worst[name], "limit": limits.get(name)} for name in sorted(worst)}
    correct = bool(sample) and failed == 0 and all(
        c["limit"] is not None and c["value"] <= c["limit"] for c in checks.values())

    found = forbidden_modules()
    if found:
        print("modules of JAX or the JAX package are loaded: " + ", ".join(found),
              file=sys.stderr)
        return 4

    values = {}
    for m in metrics:
        value = readers[m["name"]].read(run)
        if value is not None and math.isfinite(value):
            values[m["name"]] = {"value": float(value), "unit": m["unit"]}
    result = {"correct": correct, "attempted": len(run.requests), "failed": failed,
              "metrics": values, "device": device_info}
    if run.trace is not None:
        result["breakdown"] = run.trace.breakdown()
    result["checks"] = checks
    for name, c in checks.items():
        print(f"check {name} {c['value']!r} limit {c['limit']!r}", file=sys.stderr)
    print(json.dumps(result))
    return 0
