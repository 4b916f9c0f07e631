"""The harness on the CPU: the result line, a cell added from new files
only, the import check, and the runs that must fail. The card's look is
skipped here (``require_card=False``); everything else of a run is the
harness's own path."""

import json
import shutil
import subprocess
import sys
import time
from pathlib import Path

import pytest

BENCH = Path(__file__).resolve().parent.parent
ROOT = BENCH.parent
sys.path[:0] = [str(BENCH), str(ROOT)]

from harness.main import forbidden_modules, main  # noqa: E402

KEYS = ["correct", "attempted", "failed", "metrics", "device"]


def added_cell(tmp_path, name, config, traffic: dict, limits_from: str):
    """A checkout root in ``tmp_path`` whose BENCHMARK.json gains the cell
    ``name`` from new files alone: a traffic file and a limits file."""
    shutil.copytree(BENCH, tmp_path / "benchmark",
                    ignore=shutil.ignore_patterns("__pycache__", "tests"))
    manifest = json.loads((ROOT / "BENCHMARK.json").read_text())
    manifest["workloads"].append({"name": name, "config": config, "traffic": name,
                                  "chips": 1, "why": "a cell added by a test"})
    for metric in manifest["end_to_end"] + manifest["per_layer"]:
        if limits_from in metric.get("workloads", []):
            metric["workloads"].append(name)
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(manifest))
    (tmp_path / "benchmark" / "traffic" / f"{name}.json").write_text(json.dumps(traffic))
    shutil.copy(BENCH / "limits" / f"{limits_from}.json",
                tmp_path / "benchmark" / "limits" / f"{name}.json")
    return tmp_path


def run_cpu(root, workload, capsys, seed=2 ** 31 + 77, patch=None, trace=0):
    rc = main(["--workload", workload, "--seed", str(seed), "--seconds", "0.1",
               "--trace", str(trace)], time.perf_counter(), root, device="cpu",
              require_card=False, patch=patch)
    out, err = capsys.readouterr()
    return rc, out.strip().splitlines(), err.strip().splitlines()


WATER_SCAN = {"entry": "nbed", "why": "test", "molecules": "first", "order": "repeat",
              "jitter_bohr": 0.02, "warmup_requests": 0, "trace_requests": 1,
              "check_per_molecule": 1}


def test_added_cell_runs_and_prints_the_line(tmp_path, capsys):
    root = added_cell(tmp_path, "nbed_water_mu.scan_test", "nbed_water_mu", WATER_SCAN,
                      "nbed_water_mu.scan")
    rc, out, err = run_cpu(root, "nbed_water_mu.scan_test", capsys)
    assert rc == 0
    line = json.loads(out[-1])
    assert list(line)[:5] == KEYS and list(line)[-1] == "checks"
    assert line["correct"] is True and line["failed"] == 0 and line["attempted"] >= 1
    assert {"setup_s", "embed_s.water"} <= set(line["metrics"])
    assert all(set(m) == {"value", "unit"} for m in line["metrics"].values())
    assert set(line["device"]) >= {"platform", "kind", "count", "memory_peak_bytes"}
    # every compared number beside its limit, last on standard error too
    assert {"e_ks", "e_ccsd", "e_fci", "n_act", "ham_h1_spectrum"} <= set(line["checks"])
    assert err[-1].startswith("check ") and " limit " in err[-1]


def test_import_check_compares_whole_top_level_names():
    names = ["jax", "jax.numpy", "jaxlib.xla_client", "flax.linen", "nbed_tpu",
             "nbed_tpu.driver", "nbed_tpu_torch", "nbed_tpu_torch.ops.jk", "jaxtyping"]
    assert forbidden_modules(names) == ["flax.linen", "jax", "jax.numpy", "jaxlib.xla_client",
                                        "nbed_tpu", "nbed_tpu.driver"]


def test_a_run_loads_neither_jax_nor_the_jax_package(tmp_path):
    """A whole run in a fresh process: its modules at the end."""
    root = added_cell(tmp_path, "nbed_water_mu.scan_test", "nbed_water_mu", WATER_SCAN,
                      "nbed_water_mu.scan")
    script = (
        "import sys, time, json\n"
        f"sys.path[:0] = [{str(root / 'benchmark')!r}, {str(ROOT)!r}]\n"
        "from pathlib import Path\n"
        "from harness.main import main, forbidden_modules\n"
        f"rc = main(['--workload', 'nbed_water_mu.scan_test', '--seed', '5', '--seconds', '0.1',"
        f" '--trace', '0'], time.perf_counter(), Path({str(root)!r}), device='cpu',"
        " require_card=False)\n"
        "print(json.dumps({'rc': rc, 'found': forbidden_modules(),"
        " 'torch_port': 'nbed_tpu_torch' in sys.modules}))\n")
    proc = subprocess.run([sys.executable, "-c", script], capture_output=True, text=True,
                          timeout=600)
    last = json.loads(proc.stdout.strip().splitlines()[-1])
    assert last == {"rc": 0, "found": [], "torch_port": True}, proc.stderr[-2000:]


def test_no_card_no_result(tmp_path):
    """Here there is no CUDA device: the command exits non-zero and prints
    no result line."""
    proc = subprocess.run([sys.executable, str(BENCH / "run.py"), "--workload",
                           "nbed_water_mu.scan", "--seed", "1", "--seconds", "1", "--trace", "0"],
                          cwd=ROOT, capture_output=True, text=True, timeout=300)
    assert proc.returncode != 0
    assert '"correct"' not in proc.stdout


def test_benchmark_alone_is_no_run(tmp_path):
    """A directory with only BENCHMARK.json and the benchmark's files (no
    program) exits non-zero with no result, card or not."""
    shutil.copytree(BENCH, tmp_path / "benchmark", ignore=shutil.ignore_patterns("__pycache__"))
    shutil.copy(ROOT / "BENCHMARK.json", tmp_path / "BENCHMARK.json")
    script = ("import sys, time\n"
              f"sys.path[:0] = [{str(tmp_path / 'benchmark')!r}]\n"
              "from pathlib import Path\nfrom harness.main import main\n"
              "sys.exit(main(['--workload', 'nbed_water_mu.scan', '--seed', '1', '--seconds',"
              f" '0.1', '--trace', '0'], time.perf_counter(), Path({str(tmp_path)!r}),"
              " device='cpu', require_card=False))\n")
    proc = subprocess.run([sys.executable, "-c", script], cwd=tmp_path, capture_output=True,
                          text=True, timeout=300)
    assert proc.returncode != 0
    assert '"correct"' not in proc.stdout


@pytest.mark.parametrize("name", ["missing_workload"])
def test_unknown_workload(name, capsys):
    assert main(["--workload", name, "--seed", "1", "--seconds", "1"], time.perf_counter(),
                ROOT, device="cpu", require_card=False) == 2
