"""The entry "nbed_fci" on the CPU, water's sector sent down the
matrix-free route (its torch formulation: CPU tensors take the host route
unless told otherwise): a sound traced run is correct and reads the FCI
metrics, and one whose sigma drops the alpha-beta term is not."""

import json
import sys
from pathlib import Path

import pytest

sys.path.insert(0, str(Path(__file__).resolve().parent))

from test_bench_harness import added_cell, run_cpu  # noqa: E402

WATER_FCI = {"entry": "nbed_fci", "why": "test", "molecules": "first", "order": "repeat",
             "jitter_bohr": 0.02, "warmup_requests": 0, "trace_requests": 1,
             "check_per_molecule": 1}
CELL = "nbed_water_mu.fci_test"


@pytest.fixture
def matrix_free(monkeypatch):
    """run_fci takes the matrix-free route for CPU tensors, whatever the
    sector's size."""
    from nbed_tpu_torch.solvers import fci

    monkeypatch.setattr(fci, "_card_route", lambda device: True)
    monkeypatch.setattr(fci, "_free_bytes", lambda device: 2 ** 40)
    monkeypatch.setattr(fci, "DENSE_MAX", 0)
    return fci


def _cell(tmp_path):
    return added_cell(tmp_path, CELL, "nbed_water_mu", WATER_FCI, "pra_sto3g_fci.scan")


def test_sound_run_is_correct(tmp_path, capsys, matrix_free):
    before = matrix_free.ROUTES["matrix_free"]
    rc, out, _ = run_cpu(_cell(tmp_path), CELL, capsys, trace=1)
    line = json.loads(out[-1])
    assert rc == 0 and line["correct"] is True
    assert matrix_free.ROUTES["matrix_free"] > before
    assert line["checks"]["e_fci"]["value"] <= 1e-8
    assert line["metrics"]["fci.sigmas.fci"]["value"] > 0
    assert line["metrics"]["post.fci_s.fci"]["value"] > 0


def test_sigma_without_alpha_beta_term(tmp_path, capsys, matrix_free, monkeypatch):
    """The alpha-beta part of every product dropped: its scatter adds
    nothing."""
    from nbed_tpu_torch.ops import fci_sigma

    monkeypatch.setattr(fci_sigma, "scatter", lambda z, lo, hi, table, sigma: sigma)
    rc, out, _ = run_cpu(_cell(tmp_path), CELL, capsys)
    line = json.loads(out[-1])
    assert rc == 0 and line["correct"] is False
    assert line["checks"]["e_fci"]["value"] > line["checks"]["e_fci"]["limit"]
