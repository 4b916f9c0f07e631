"""Memory of the TDDFT matvec block, and the two forms of the XC closure.

    python3 scripts/bench_response.py [--device cuda|cpu] [--memory-only]

1. ``kernel``: the f_xc block alone (``tddft._kernel_block``) at the SAD
   density on 4096 grid points drawn from each molecule's grid, for water,
   acetonitrile and pfoa under LDA, B3LYP, wB97X and TPSS: slope and
   intercept per grid point in float64 elements, beside the model's
   ``tddft._kernel_elems_per_point``. No SCF, so pfoa's 126 AOs run on the
   CPU too.
2. ``memory``: the matvec of the frame that ``run_tddft_tda`` builds, at the
   engine's budget and at 300 MB: the peak memory one block allocates
   above what was allocated before it, for blocks of 1, 2 and 4 trial
   vectors and of the frame's own block size, the least-squares intercept
   and slope (bytes per vector) beside the frame's per-vector model, and
   whether the frame's block stays within ``max_memory_mb``. Cases: water
   under LDA, PBE, B3LYP, CAM-B3LYP, wB97X, TPSS and SCAN, acetonitrile
   under B3LYP5, wB97X and TPSS (exact ERIs, AO-table XC); on the card also
   pfoa's global B3LYP DF-UKS (126 AOs) at 4000 MB, at 1500 MB (streaming
   XC) and without its XC kernel.
3. ``xc_forms`` (card only): the SCF's closure (inputs detached,
   ``torch.autograd.grad``) against the response closure
   (``torch.func.grad_and_value``): ms per call (CUDA events, median of
   10) at the converged density, and the wall seconds of a whole SCF with
   each form installed, run A B A B, for water B3LYP, acetonitrile B3LYP5
   and pfoa's B3LYP DF-UKS.

On the card the peak comes from ``torch.cuda.max_memory_allocated``; on the
CPU from the allocations ``torch.profiler`` records (``profile_memory``),
which count the same tensors. No pfoa SCF runs on the CPU. Prints the
card's name and power limit first (on the card), then one labelled JSON
object per measurement.
"""

import argparse
import json
import sys
import tempfile
import time
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))

from chip_smoke import ACETONITRILE, PFOA, WATER, card_line  # noqa: E402
from nbed_tpu_torch._device import DTYPE  # noqa: E402
from nbed_tpu_torch.chem import build_molecule  # noqa: E402
from nbed_tpu_torch.scf import SCFEngine  # noqa: E402
from nbed_tpu_torch.solvers import tddft  # noqa: E402

SCF = dict(conv_tol=1e-9, dm_conv_tol=1e-7, max_cycle=100)
BLOCKS = (1, 2, 4)


def show(label, obj):
    print(label, json.dumps(obj), flush=True)


def sync(device):
    if device == "cuda":
        torch.cuda.synchronize()


def block_peak(fn, device) -> int:
    """Bytes allocated at the peak of ``fn()`` above those allocated before
    it: the card's allocator statistics, or on the CPU the running total of
    the allocations torch.profiler records."""
    if device == "cuda":
        sync(device)
        base = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        out = fn()
        sync(device)
        del out
        return int(torch.cuda.max_memory_allocated() - base)
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU], profile_memory=True) as prof:
        fn()
    with tempfile.TemporaryDirectory() as tmp:
        path = Path(tmp) / "trace.json"
        prof.export_chrome_trace(str(path))
        events = json.loads(path.read_text())["traceEvents"]
    totals = [e["args"]["Total Allocated"] for e in events if e.get("name") == "[memory]"]
    return int(max(totals) - totals[0]) if totals else 0


def fit(sizes, peaks):
    slope, intercept = np.polyfit(np.asarray(sizes, float), np.asarray(peaks, float), 1)
    return float(slope), float(intercept)


def kernel_case(mol, xc, device, points=4096):
    """Per-point memory of the f_xc block alone on ``points`` grid points."""
    eng = SCFEngine(mol, xc=xc, device=device)
    grid, weights = eng._grid
    pick = torch.randperm(grid.shape[0], generator=torch.Generator().manual_seed(0))[:points]
    pick = pick.to(grid.device)
    eng.__dict__["_grid"] = (grid[pick].contiguous(), weights[pick].contiguous())
    n = mol.nao
    fr = {"xc_fn": eng._build_xc(DTYPE, differentiable=True), "dm0": eng._sad_guess()}
    gen = np.random.default_rng(0)
    peaks = []
    for b in BLOCKS:
        t = torch.tensor(gen.standard_normal((b, 2, n, n)), dtype=DTYPE, device=device)
        t = t + t.transpose(-1, -2)
        block_peak(lambda: tddft._kernel_block(fr, t), device)
        peaks.append(block_peak(lambda: tddft._kernel_block(fr, t), device))
    slope, intercept = fit(BLOCKS, peaks)
    model = tddft._kernel_elems_per_point(eng)
    show("kernel", {
        "xc": xc, "nao": n, "points": points,
        "slope_per_point": slope / (8 * points), "intercept_per_point": intercept / (8 * points),
        "model_per_point": model, "within_model": max(slope, intercept) <= 8 * points * model})


def memory_case(label, sol, device, max_memory_mb=None, no_kernel=False):
    """The frame as run_tddft_tda sizes it (at ``max_memory_mb`` if given),
    its matvec on blocks of 1, 2 and 4 vectors and of its own block size."""
    eng = sol.engine
    saved = eng.max_memory_mb
    if max_memory_mb is not None:
        eng.max_memory_mb = max_memory_mb
    try:
        fr = tddft._response_frame(sol)
        streams = eng._xc_streams
    finally:
        eng.max_memory_mb = saved
    if no_kernel:
        fr["xc_fn"] = None
    npairs, block = sum(fr["sizes"]), fr["block"]
    fr["block"] = npairs
    matvec = tddft._tda_matvec(fr)
    gen = np.random.default_rng(0)
    peaks = {}
    for b in sorted({*BLOCKS, min(block, npairs)}):
        x = torch.tensor(gen.standard_normal((b, npairs)), dtype=DTYPE, device=device)
        block_peak(lambda: matvec(x), device)  # warm: the first call allocates caches
        peaks[b] = block_peak(lambda: matvec(x), device)
    slope, intercept = fit(BLOCKS, [peaks[b] for b in BLOCKS])
    points = int(eng._grid[0].shape[0]) if fr["xc_fn"] is not None else 0
    model = 8 * fr["vector_elems"]
    budget = 1e6 * (max_memory_mb or saved)
    show("memory", {
        "case": label, "xc": eng.xc, "nao": eng.mol.nao, "npairs": npairs,
        "points": points, "xc_chunk": min(points, fr["xc_chunk"]),
        "streaming": bool(points and streams),
        "naux": int(eng.df_factor().shape[1]) if eng.density_fitting else 0,
        "df_chunk_elems": eng._df_chunk_elems if eng.density_fitting else 0,
        "max_memory_mb": budget / 1e6, "block": block, "peak_bytes": peaks,
        "slope_bytes": slope, "intercept_bytes": intercept,
        "model_vector_bytes": model, "slope_within_model": slope <= model,
        "intercept_within_model": intercept <= model,
        "block_within_budget": peaks[min(block, npairs)] <= budget})


def ms_per_call(fn, reps=10) -> float:
    fn()
    times = []
    for _ in range(reps):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return float(np.median(times))


def xc_forms(label, eng, device):
    """Per-call ms and SCF seconds of the detached and grad_and_value forms."""
    detached, hyb = eng._xc
    response = eng._build_xc(DTYPE, differentiable=True)
    dm = eng.kernel().make_rdm1()
    out = {"case": label, "nao": eng.mol.nao, "points": int(eng._grid[0].shape[0]),
           "streaming": eng._xc_streams,
           "ms_detached": ms_per_call(lambda: detached(dm)),
           "ms_grad_and_value": ms_per_call(lambda: response(dm))}
    for key, fn in (("detached", detached), ("grad_and_value", response)) * 2:
        eng.__dict__["_xc"] = (fn, hyb)
        sync(device)
        t0 = time.perf_counter()
        s = eng.kernel()
        sync(device)
        out.setdefault(f"scf_s_{key}", []).append(time.perf_counter() - t0)
        out.setdefault(f"e_tot_{key}", []).append(s.e_tot)
    eng.__dict__["_xc"] = (detached, hyb)
    show("xc_forms", out)


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--memory-only", action="store_true")
    args = ap.parse_args()
    dev = args.device
    if dev == "cuda":
        print(f"card: {card_line()}", flush=True)
    water = build_molecule(WATER.read_text(), "sto-3g")
    pra = build_molecule(ACETONITRILE, "sto-3g")
    pfoa = build_molecule(PFOA.read_text(), "sto-3g")

    for mol in (water, pra, pfoa):
        for xc in ("lda", "b3lyp", "wb97x", "tpss"):
            kernel_case(mol, xc, dev)
    cases = [(water, xc) for xc in ("lda", "pbe", "b3lyp", "camb3lyp", "wb97x", "tpss",
                                    "scan")] + [(pra, xc) for xc in ("b3lyp5", "wb97x", "tpss")]
    for mol, xc in cases:
        sol = SCFEngine(mol, xc=xc, device=dev, **SCF).kernel()
        name = "water" if mol is water else "acetonitrile"
        for budget in (None, 300.0):
            memory_case(f"{name}_{xc}", sol, dev, max_memory_mb=budget)
    if dev != "cuda":
        return
    if not args.memory_only:
        xc_forms("water_b3lyp", SCFEngine(water, xc="b3lyp", device=dev, **SCF), dev)
        xc_forms("acetonitrile_b3lyp5", SCFEngine(pra, xc="b3lyp5", device=dev, **SCF), dev)
    eng = SCFEngine(pfoa, xc="b3lyp", density_fitting=True, device=dev, **SCF)
    sol = eng.kernel()
    memory_case("pfoa_b3lyp_df", sol, dev)
    memory_case("pfoa_b3lyp_df", sol, dev, max_memory_mb=1500.0)  # streaming XC
    memory_case("pfoa_df_no_kernel", sol, dev, no_kernel=True)
    if not args.memory_only:
        xc_forms("pfoa_b3lyp_df", eng, dev)


if __name__ == "__main__":
    main()
