"""The fused J/K kernel on one CUDA card, beside an earlier version of it.

    python3 scripts/bench_jk.py [--old DIR] [--paths] [--pieces]

For every case of ``chip_smoke.jk_cases`` (the main path's supermatrices,
and random ones at M = 4096, 9025 and 16384) and dtype, times the prepared
kernel (``FusedJK``, the engines' call) with ``chip_smoke``'s helpers:
``ms`` (CUDA events around one call: host issue plus device time),
``ms_stream`` (events around 100 back-to-back calls, per call), ``host_us``
(host clock over 1000 enqueues, 100 above M = 4096) and ``device_us``
(self device time per launch, torch.profiler), beside the bound, and the
first three of the plain version and of one library call
(``chip_smoke.library_call``).

Each case is first held against the plain version on every path
(``chip_smoke.hold_jk``). ``--old DIR``: DIR holds an earlier ``ops/jk.py`` and ``csrc/fused_jk.cu``
of this package (written there from git, e.g. ``git show
<rev>:nbed_tpu_torch/ops/jk.py``); its ``fused_jk`` is timed in turns with
the new kernel (old, new, new, old) and each metric is the mean of its two
turns. ``--paths``: the new kernel also with each path forced (vector,
ring), for the choice of ``ops.jk.RING_MIN_ROW_BYTES``, with two more
random cases between the paths (nao 32 and 45). From M = 4096 the line
also has ``sum_read_tbps``, the read rate of one library reduction over
G_J (``torch.sum``): what the card's memory gives in practice. ``--pieces``: the
host microseconds of each step of a prepared call, over 10000 repeats.

Prints the card's name and power limit first, then one JSON line per case.
"""

import argparse
import ctypes
import importlib.util
import json
import sys
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))

import chip_smoke  # noqa: E402
from nbed_tpu_torch.ops import jk  # noqa: E402


def load_old(root: Path):
    """The earlier ``ops/jk.py`` under ``root`` as a module of this package
    (its relative imports resolve here; its ``_SRC`` is ``root/csrc``)."""
    spec = importlib.util.spec_from_file_location("nbed_tpu_torch.ops._jk_old",
                                                  root / "ops" / "jk.py")
    mod = importlib.util.module_from_spec(spec)
    sys.modules[spec.name] = mod
    spec.loader.exec_module(mod)
    return mod


def measure(fn, m: int) -> dict:
    return {**chip_smoke.timings(fn, m), "device_us": chip_smoke.device_us(fn, "fused_jk")}


def pieces(prepared, dm, n: int = 10000) -> dict:
    """Host microseconds of each step of one prepared call."""
    import time

    idx = prepared._index
    shape = tuple(prepared._out_like.shape)
    out3 = torch.empty(shape, dtype=prepared.dtype, device=prepared.device)
    noop = jk._PlanC()  # m = 0: the C entry returns before launching
    steps = {
        "check_dm": lambda: (dm.shape == prepared._dm_shape and dm.dtype == prepared.dtype
                             and dm.device == prepared.device and dm.is_contiguous()),
        "torch_empty": lambda: torch.empty(shape, dtype=prepared.dtype,
                                           device=prepared.device),
        "empty_like": lambda: torch.empty_like(out3),
        "current_stream": lambda: torch.cuda.current_stream(idx).cuda_stream,
        "raw_stream": lambda: torch._C._cuda_getCurrentRawStream(idx),
        "current_device": lambda: torch.cuda.current_device() == idx,
        "views": lambda: (out3[0], out3[1:]),
        "ctypes_call": lambda: prepared._fn(*prepared._ptrs, dm.data_ptr(), out3.data_ptr(),
                                            ctypes.addressof(noop), 0),
        "counters": lambda: jk.LAUNCHES.__setitem__(prepared._key,
                                                    jk.LAUNCHES[prepared._key] + 1),
        "whole_call": lambda: prepared(dm),
    }
    out = {}
    for name, fn in steps.items():
        for _ in range(100):
            fn()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(n):
            fn()
        out[name] = (time.perf_counter() - t0) / n * 1e6
        torch.cuda.synchronize()
    return out


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--old", type=Path)
    ap.add_argument("--paths", action="store_true")
    ap.add_argument("--pieces", action="store_true")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("bench_jk.py: torch.cuda.is_available() is False")
    print(chip_smoke.card_line(), flush=True)
    old = load_old(args.old.resolve()) if args.old else None
    with ThreadPoolExecutor(max_workers=2) as pool:
        for f in [pool.submit(jk.build_kernels)] + (
                [pool.submit(old.build_kernels)] if old else []):
            f.result()

    cases = chip_smoke.jk_cases()
    if args.paths:  # rows of 8 and 16 KB in float64, between the two paths
        both = (torch.float64, torch.float32)
        cases += [chip_smoke.random_case(f"random nao={n}", n, n, both) for n in (32, 45)]
    for label, gj64, gk64, dm64, dtypes in cases:
        for dtype in dtypes:
            gj, gk, dm = (t.to(dtype).contiguous() for t in (gj64, gk64, dm64))
            m = int(dm.shape[-1]) ** 2
            chip_smoke.hold_jk(label, gj, gk, dm)
            prepared = jk.FusedJK(gj, gk)
            if args.pieces and label == "acetonitrile":
                print("bench_jk_pieces", json.dumps({"dtype": str(dtype), **pieces(prepared, dm)}),
                      flush=True)
            row = {"case": label, "m": m, "dtype": str(dtype).removeprefix("torch."),
                   "path": prepared.plan.path,
                   "bound_us": chip_smoke.jk_bound(m, dtype)[0] * 1e3}
            new = lambda: prepared(dm)  # noqa: E731
            if old is None:
                row["new"] = measure(new, m)
            else:
                ref = jk.fused_jk_reference(gj, gk, dm)
                row["old_max_abs_err"] = max(float(torch.max(torch.abs(a - b)))
                                             for a, b in zip(old.fused_jk(gj, gk, dm), ref))
                turns = [("old", lambda: old.fused_jk(gj, gk, dm)), ("new", new),
                         ("new", new), ("old", lambda: old.fused_jk(gj, gk, dm))]
                got = {"old": [], "new": []}
                for name, fn in turns:
                    got[name].append(measure(fn, m))
                for name, pair in got.items():
                    row[name] = {k: (pair[0][k] + pair[1][k]) / 2 for k in pair[0]}
                    row[f"{name}_turns"] = pair
            for name in ("old", "new"):
                if name in row:
                    row[name]["share_of_bound"] = row["bound_us"] / row[name]["device_us"]
            row["plain"] = chip_smoke.timings(lambda: jk.fused_jk_reference(gj, gk, dm), m)
            row["library"] = chip_smoke.timings(chip_smoke.library_call(gj, gk, dm), m)
            if m >= 4096:
                # the card's practical read rate: one library reduction over
                # G_J, self device time from torch.profiler
                from nbed_tpu_torch.profiling import device_profile

                _, prof = device_profile(lambda: [gj.sum() for _ in range(20)])
                row["sum_read_tbps"] = gj.numel() * gj.element_size() * 20 / prof[
                    "device_busy_s"] / 1e12
            if args.paths:
                for path in ("vector", "ring"):
                    forced = jk.FusedJK(gj, gk, path=path)
                    fn = lambda: forced(dm)  # noqa: E731
                    row[f"forced_{path}"] = {
                        "plan": forced.plan.path, "ms_stream": chip_smoke.stream_ms(fn),
                        "device_us": chip_smoke.device_us(fn, "fused_jk")}
            print("bench_jk", json.dumps(row), flush=True)
        del gj64, gk64


if __name__ == "__main__":
    main()
