"""nbed_tpu_torch stands alone: no file of the port, and not chip_smoke.py,
imports nbed_tpu or names a path into it, and a copy of the package with no
nbed_tpu beside it builds its own native code and runs an SCF."""

import ast
import re
import shutil
import subprocess
import sys
import textwrap
from pathlib import Path

import torch

torch.set_num_threads(1)

REPO = Path(__file__).resolve().parent.parent
PORT = REPO / "nbed_tpu_torch"
# "nbed_tpu" as a whole word: a module or a path component, not nbed_tpu_torch
_REFERENCE = re.compile(r"\bnbed_tpu(?!\w)")
# a file:line citation, such as the "replaces" field of chip_smoke.py's
# kernel line: it names a line, not a file to open
_CITATION = re.compile(r"nbed_tpu/[\w/.]+\.\w+:\d+(-\d+)?")


def _docstring_nodes(tree):
    nodes = set()
    for node in ast.walk(tree):
        if isinstance(node, (ast.Module, ast.ClassDef, ast.FunctionDef,
                             ast.AsyncFunctionDef)) and node.body:
            first = node.body[0]
            if isinstance(first, ast.Expr) and isinstance(first.value, ast.Constant):
                nodes.add(id(first.value))
    return nodes


def _python_offences(path: Path):
    """Imports of nbed_tpu, and string constants other than docstrings and
    file:line citations that name nbed_tpu (a path or a module to load)."""
    tree = ast.parse(path.read_text(), filename=str(path))
    docs = _docstring_nodes(tree)
    found = []
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            found += [a.name for a in node.names if _REFERENCE.match(a.name)]
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module \
                and _REFERENCE.match(node.module):
            found.append(node.module)
        elif isinstance(node, ast.Constant) and isinstance(node.value, str) \
                and id(node) not in docs and _REFERENCE.search(node.value) \
                and not _CITATION.fullmatch(node.value):
            found.append(node.value)
    return found


def _native_offences(path: Path):
    """``#include`` lines of a C++/CUDA source that reach into nbed_tpu."""
    return [line for line in path.read_text().splitlines()
            if line.lstrip().startswith("#include") and _REFERENCE.search(line)]


def test_port_names_no_path_into_reference(tmp_path):
    files = [*PORT.rglob("*.py"), REPO / "chip_smoke.py"]
    offences = {str(f.relative_to(REPO)): _python_offences(f) for f in files}
    for src in [*PORT.rglob("*.cpp"), *PORT.rglob("*.cu")]:
        offences[str(src.relative_to(REPO))] = _native_offences(src)
    assert len(files) > 40
    assert {k: v for k, v in offences.items() if v} == {}
    # the scan sees what it looks for, and passes docstrings and comments
    probe = tmp_path / "probe.py"
    probe.write_text('"""Port of ``nbed_tpu/ops/pallas_jk.py``."""\n'
                     "import nbed_tpu.ops  # nbed_tpu/ops\n"
                     "p = ROOT / 'nbed_tpu' / 'native'\n"
                     "row = {'replaces': 'nbed_tpu/ops/pallas_jk.py:82'}\n")
    assert _python_offences(probe) == ["nbed_tpu.ops", "nbed_tpu"]


def test_copy_of_port_runs_water_uhf_alone(tmp_path, water_uhf):
    """The package copied alone (no build directory, no nbed_tpu beside
    it) builds md_integrals.cpp from its own csrc/ and gives water's UHF
    energy of nbed_tpu."""
    shutil.copytree(PORT, tmp_path / "nbed_tpu_torch",
                    ignore=shutil.ignore_patterns("_build", "__pycache__"))
    script = textwrap.dedent(f"""
        import sys
        sys.path = [p for p in sys.path if p not in ("", {str(REPO)!r})]
        sys.path.insert(0, {str(tmp_path)!r})
        import nbed_tpu_torch
        from nbed_tpu_torch.chem import build_molecule
        from nbed_tpu_torch.scf import SCFEngine
        assert nbed_tpu_torch.__file__.startswith({str(tmp_path)!r})
        mol = build_molecule({(REPO / "tests/molecules/water.xyz").read_text()!r}, "sto-3g")
        sol = SCFEngine(mol, conv_tol=1e-10, dm_conv_tol=1e-8, max_cycle=100,
                        device="cpu").kernel()
        leaked = [m for m in sys.modules if m == "nbed_tpu" or m.startswith("nbed_tpu.")]
        assert not leaked, leaked
        print(repr(sol.e_tot))
    """)
    out = subprocess.run([sys.executable, "-c", script], capture_output=True,
                         text=True, timeout=240, cwd=tmp_path)
    assert out.returncode == 0, out.stderr
    assert (tmp_path / "nbed_tpu_torch" / "_build" / "libnbed_md.so").exists()
    assert abs(float(out.stdout.split()[-1]) - water_uhf.e_tot) < 1e-8
