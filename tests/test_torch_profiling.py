"""The span mechanism of nbed_tpu_torch.profiling on the CPU: spans add up
into the open request's table, open profiler ranges only while a profiler
records, nest under "nbed.request" (whose args carry the request number in
a device_trace), cover every stage and layer of a water nbed() with each
step's seconds inside its parent's, keep the lane program's range names,
and feed the benchmark's span metrics."""

import json
import sys
import time
from collections import defaultdict
from pathlib import Path

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from nbed_tpu_torch import profiling
from nbed_tpu_torch.chem import build_molecule
from nbed_tpu_torch.embed import nbed
from nbed_tpu_torch.parallel import make_mu_embed_energy
from nbed_tpu_torch.profiling import StageTimer, device_trace, request, span
from nbed_tpu_torch.scf.engine import df_b_factor

torch.set_num_threads(1)

ROOT = Path(__file__).resolve().parent.parent
WATER = json.loads((ROOT / "benchmark" / "configs" / "nbed_water_mu.json").read_text())
# the driver's stage keys that stage.scf_s and stage.post_s read
STAGES = ("global_ks", "localize", "subsystem_dft", "mu_embed", "mu_post_embed")
# the spans the benchmark's per-layer metrics read
METRIC_SPANS = ("scf.run", "integrals.native", "post.ccsd", "ham.build", "post.fci",
                "post.dft_in_dft")
LANE_RANGES = ("embed.operators", "embed.global_ks", "embed.spade_subsystem",
               "embed.embedded_hf")


def _ranges(prof):
    """{range name: [(start, end, parent range name)]} of the profiler's
    record_function ranges, the parent the innermost enclosing range."""
    events = [e for e in prof.events() if e.is_user_annotation]
    out = defaultdict(list)
    for e in events:
        parent = e.cpu_parent
        while parent is not None and not parent.is_user_annotation:
            parent = parent.cpu_parent
        out[e.name].append((e.time_range.start, e.time_range.end,
                            None if parent is None else parent.name))
    return out


def test_spans_add_up_in_the_open_request():
    with request() as table:
        with span("outer") as outer:
            with span("inner"):
                time.sleep(0.002)
            with span("inner"):
                time.sleep(0.002)
            with span("outer"):  # inside itself: the outer one covers it
                time.sleep(0.001)
    t = table.timings
    assert set(t) == {"nbed.request", "outer", "inner"}
    assert t["inner"] >= 0.004 and t["inner"] <= t["outer"] <= t["nbed.request"]
    assert t["outer"] == pytest.approx(outer.seconds)
    assert profiling._REQUEST.get() is None


def test_a_span_outside_a_request_only_times():
    with span("alone") as s:
        time.sleep(0.001)
    assert s.seconds >= 0.001 and profiling._REQUEST.get() is None


def test_requests_are_numbered_and_do_not_nest():
    with request() as first:
        with request() as inner:
            assert inner is first
    with request() as second:
        pass
    assert second.request == first.request + 1
    assert first.timings.keys() == {"nbed.request"}


def test_stage_timer_keeps_its_stages_alone():
    timer = StageTimer()
    with timer("a"):
        with span("a.step"):
            pass
    with timer("a"):
        pass
    with timer("b"):
        pass
    assert set(timer.timings) == {"a", "a.step", "b"}
    assert timer.timings["a.step"] <= timer.timings["a"]


def test_no_profiler_no_range(monkeypatch):
    calls = []
    enter = profiling._range_enter
    monkeypatch.setattr(profiling, "_range_enter", lambda name: calls.append(name) or enter(name))
    with request():
        with span("x", {"k": 1}):
            pass
    assert calls == []
    with profile(activities=[ProfilerActivity.CPU]):
        with request():
            with span("x"):
                pass
    assert calls == ["nbed.request", "x"]


def test_ranges_nest_under_the_request():
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        with request():
            with span("driver.stage"):
                with span("step"):
                    torch.ones(4).sum()
    ranges = _ranges(prof)
    assert [p for _, _, p in ranges["nbed.request"]] == [None]
    assert [p for _, _, p in ranges["driver.stage"]] == ["nbed.request"]
    assert [p for _, _, p in ranges["step"]] == ["driver.stage"]


def test_device_trace_writes_the_request_number(tmp_path):
    with device_trace(tmp_path):
        with request() as first:
            with span("program.capture", {"kind": "veff_graph"}):
                pass
        with request() as second:
            pass
    events = json.loads((tmp_path / "trace.json").read_text())["traceEvents"]
    args = [e["args"] for e in sorted(events, key=lambda e: e.get("ts", 0))
            if e.get("cat") == "user_annotation"]
    assert [a.get("request") for a in args if "request" in a] == [first.request,
                                                                  second.request]
    assert [a["kind"] for a in args if "kind" in a] == ["veff_graph"]


@pytest.fixture(scope="module")
def water_request():
    """A water nbed() at the benchmark's settings under the profiler: its
    driver and its ranges."""
    geometry = WATER["molecules"][0]["geometry"]
    nbed(geometry=geometry, n_active_atoms=1, device="cpu", **WATER["settings"])  # warm
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        driver = nbed(geometry=geometry, n_active_atoms=1, device="cpu",
                      **WATER["settings"])
    return driver, _ranges(prof)


def test_water_request_has_every_stage_and_metric_span(water_request):
    driver, ranges = water_request
    keys = set(driver.timings)
    assert set(STAGES) <= keys and set(METRIC_SPANS) <= keys
    assert {"nbed.request", "driver.init", "scf.setup", "localize.spade", "post.delete",
            "post.concentric"} <= keys
    assert all(np.isfinite(v) and v >= 0.0 for v in driver.timings.values())
    # three Hamiltonian builds: CCSD's, FCI's and the result's
    assert len(ranges["ham.build"]) == 3
    assert set(ranges) == keys


def test_water_request_children_inside_parents(water_request):
    driver, ranges = water_request
    t = driver.timings
    for name, spans in ranges.items():
        parents = {p for _, _, p in spans}
        if parents == {None}:
            assert name == "nbed.request"
            continue
        assert None not in parents
        # a span nested in its own name adds nothing to the table
        if name in parents:
            continue
        assert t[name] <= sum(t[p] for p in parents) + 1e-9, (name, parents)
        for start, end, parent in spans:
            assert any(s <= start and end <= e for s, e, _ in ranges[parent])


@pytest.fixture(scope="module")
def water(water_xyz):
    return build_molecule(water_xyz, "sto-3g")


def test_lane_program_ranges(water):
    fn = make_mu_embed_energy(water, 1, 4, xc="b3lyp", device="cpu", grid_level=1,
                              conv_tol=1e-8, dm_conv_tol=1e-6, max_cycle=50)
    x = torch.tensor(np.asarray(water.coords))
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        out = fn(torch.stack([x, x]))
    assert bool(out["converged"].all())
    ranges = _ranges(prof)
    assert set(LANE_RANGES) <= set(ranges)
    for child in ("lanes.core", "lanes.eri", "lanes.supermatrices", "lanes.tables"):
        assert [p for _, _, p in ranges[child]] == ["embed.operators"]


def test_df_parts_are_spans(water):
    parts = {}
    with request() as table:
        df_b_factor(water, device="cpu", timings=parts)
    assert set(parts) == {"eri_3c", "eri_2c", "eigh", "product"}
    for key, seconds in parts.items():
        assert table.timings[f"df.{key}"] == seconds


def _reader(name):
    sys.path.insert(0, str(ROOT / "benchmark"))
    try:
        from harness.main import _reader as find
    finally:
        sys.path.remove(str(ROOT / "benchmark"))
    return find(ROOT / "benchmark" / "metrics", name)


class _Run:
    def __init__(self, tables):
        self.completed = [{"timings": t, "ok": True} for t in tables]


@pytest.mark.parametrize("metric,key", [("scf.run_s", "scf.run"),
                                        ("integrals.host_s.water", "integrals.native"),
                                        ("post.ccsd_s", "post.ccsd"),
                                        ("post.ham_s.water", "ham.build"),
                                        ("post.fci_s.water", "post.fci"),
                                        ("post.dft_in_dft_s.water", "post.dft_in_dft")])
def test_span_metric_readers(metric, key):
    read = _reader(metric).read
    # a program without spans: the metric is left out, nothing raises
    assert read(_Run([{"global_ks": 0.1}, {"global_ks": 0.2}])) is None
    assert read(_Run([])) is None
    # a request without the span counts as none of it
    assert read(_Run([{key: 0.3, "global_ks": 0.1}, {"global_ks": 0.2}])) == pytest.approx(0.15)


def test_span_metrics_read_a_water_request(water_request):
    driver, _ = water_request
    run = _Run([dict(driver.timings)])
    for metric in ("scf.run_s.water", "integrals.host_s.water", "post.ccsd_s.water",
                   "post.ham_s.water", "post.fci_s.water", "post.dft_in_dft_s.water"):
        value = _reader(metric).read(run)
        assert value is not None and np.isfinite(value) and value > 0.0
