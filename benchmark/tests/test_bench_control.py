"""The control: the plain reference computed in float32 (TF32 off) in the
program's place fails each configuration's check, and the reference in
float64 passes it against itself. Water is the cell's own size; the PRA
configuration is held on acetonitrile, the molecule of its scan and fleet
cells."""

import json
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

BENCH = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(BENCH))

from harness.traffic import Traffic  # noqa: E402
from reference.pipeline import fleet_answers, nbed_answers  # noqa: E402

torch.set_num_threads(4)


def _cell(cell):
    manifest = json.loads((BENCH.parent / "BENCHMARK.json").read_text())
    spec = {w["name"]: w for w in manifest["workloads"]}[cell]
    config = json.loads((BENCH / "configs" / f"{spec['config']}.json").read_text())
    traffic = json.loads((BENCH / "traffic" / f"{spec['traffic']}.json").read_text())
    limits = json.loads((BENCH / "limits" / f"{cell}.json").read_text())
    return config, traffic, limits


@pytest.mark.parametrize("cell", ["nbed_water_mu.scan", "pra_sto3g_huz.scan"])
def test_float32_reference_fails_the_nbed_check(cell):
    config, traffic, limits = _cell(cell)
    request = Traffic(config, traffic, 2 ** 31 + 3).request("window", 0)
    args = (config["settings"], request.geometries[0], request.molecule["n_active_atoms"])
    ref = nbed_answers(*args, dtype=torch.float64)
    low = nbed_answers(*args, dtype=torch.float32)
    gaps = {k: abs(low[k] - ref[k]) for k in limits if k in ref and k != "ham_h1_spectrum"}
    gaps["ham_h1_spectrum"] = float(np.max(np.abs(low["ham_h1_spectrum"]
                                                  - ref["ham_h1_spectrum"])))
    failed = [k for k, v in gaps.items() if v > limits[k]]
    assert failed, gaps


def test_float32_reference_fails_the_fleet_check():
    config, traffic, limits = _cell("pra_sto3g_huz.fleet36")
    request = Traffic(config, traffic, 11).request("window", 0)
    mol = request.molecule
    ref = fleet_answers(config["settings"]["xc_functional"], request.geometries[0],
                        mol["n_active_atoms"], 7, torch.float64)
    low = fleet_answers(config["settings"]["xc_functional"], request.geometries[0],
                        mol["n_active_atoms"], 7, torch.float32)
    assert any(abs(low[k] - ref[k]) > limits[k] for k in ("e_global", "e_emb"))
