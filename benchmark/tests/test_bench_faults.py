"""Runs with the timed path broken underneath: each must come out with
``correct`` false. The card's look is skipped; the rest is a whole run of
a cell added from new files, at a size the CPU holds."""

import json
import sys
from dataclasses import replace
from pathlib import Path

import numpy as np
import torch

sys.path.insert(0, str(Path(__file__).resolve().parent))

from test_bench_harness import WATER_SCAN, added_cell, run_cpu  # noqa: E402

FLEET = {"entry": "fleet", "why": "test", "molecules": "first", "order": "repeat",
         "jitter_bohr": 0.02, "batch": 4, "warmup_requests": 0, "trace_requests": 1,
         "check_per_molecule": 1, "check_conformers": 4}


def _water(tmp_path):
    return added_cell(tmp_path, "nbed_water_mu.scan_test", "nbed_water_mu", WATER_SCAN,
                      "nbed_water_mu.scan")


def _line(out):
    return json.loads(out[-1])


def test_sound_run_is_correct(tmp_path, capsys):
    rc, out, _ = run_cpu(_water(tmp_path), "nbed_water_mu.scan_test", capsys)
    assert rc == 0 and _line(out)["correct"] is True


def test_answer_altered_where_produced(tmp_path, capsys):
    """The embedded CCSD energy off by 1e-5 Ha where the driver makes it."""
    import nbed_tpu_torch.driver as driver

    def patch(entry):
        original = driver.run_emb_ccsd

        def altered(*args, **kwargs):
            e_tot, e_corr = original(*args, **kwargs)
            return e_tot + 1e-5, e_corr

        driver.run_emb_ccsd = altered
        patch.undo = lambda: setattr(driver, "run_emb_ccsd", original)

    try:
        rc, out, _ = run_cpu(_water(tmp_path), "nbed_water_mu.scan_test", capsys, patch=patch)
    finally:
        patch.undo()
    line = _line(out)
    assert rc == 0 and line["correct"] is False
    assert line["checks"]["e_ccsd"]["value"] > line["checks"]["e_ccsd"]["limit"]


def test_step_that_leaves_its_state(tmp_path, capsys):
    """The global KS stopped after one cycle: it hands on (nearly) its
    guess."""
    def patch(entry):
        entry.settings["max_dft_cycles"] = 1

    rc, out, _ = run_cpu(_water(tmp_path), "nbed_water_mu.scan_test", capsys, patch=patch)
    assert rc == 0 and _line(out)["correct"] is False


def test_half_the_batch_left_out(tmp_path, capsys):
    """A fleet that computes half of its conformers and fills the rest
    with their mean."""
    root = added_cell(tmp_path, "nbed_water_mu.fleet_test", "nbed_water_mu", FLEET,
                      "pra_sto3g_huz.fleet36")

    def patch(entry):
        original = entry.run

        def half(request):
            n = len(request.geometries) // 2
            part = replace(request, geometries=request.geometries[:n],
                           coords_bohr=request.coords_bohr[:n])
            out, _ = original(part)
            full = {k: torch.cat([v, v.to(torch.float64).mean().to(v.dtype).expand(
                len(request.geometries) - n)]) for k, v in out.items()}
            return full, len(request.geometries)

        entry.run = half

    rc, out, _ = run_cpu(root, "nbed_water_mu.fleet_test", capsys, patch=patch)
    assert rc == 0 and _line(out)["correct"] is False


def test_sound_fleet_is_correct(tmp_path, capsys):
    root = added_cell(tmp_path, "nbed_water_mu.fleet_test", "nbed_water_mu", FLEET,
                      "pra_sto3g_huz.fleet36")
    rc, out, _ = run_cpu(root, "nbed_water_mu.fleet_test", capsys, trace=1)
    line = _line(out)
    assert rc == 0 and line["correct"] is True
    assert np.isfinite(line["metrics"]["lanes.scf_s"]["value"])
