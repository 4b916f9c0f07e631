"""Every public function, class and upper-case constant of nbed_tpu has a
counterpart of the same name at the same relative path in nbed_tpu_torch,
and every parameter of a public function, method or class (dataclass and
NamedTuple fields, ``__init__`` arguments) and every public method of a
public class has one of the same name there.

Both packages are read as source (``ast``), so this imports neither JAX
nor the port. The allowed exceptions are listed with their reasons."""

import ast
import re
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parent.parent
REF, PORT = ROOT / "nbed_tpu", ROOT / "nbed_tpu_torch"
CONSTANT = re.compile(r"^_?[A-Z][A-Z0-9_]*$")

# reference module -> the port's module(s) that hold its names instead
MOVED = {
    # the reference's ctypes binding of its C++ integral engine; the port
    # builds the same engine from its own copy of the source
    "native/__init__.py": ("integrals/native.py", "_compile.py"),
    # the TPU's Pallas kernel; the port's hand-written CUDA kernel and its
    # wrapper take its place
    "ops/pallas_jk.py": ("ops/jk.py",),
}
# (reference module, name): why the port has no counterpart
NOT_PORTED = {
    ("scf/hf.py", "eigh_refined"): "TPU-only Newton refinement of eigh (a no-op off the TPU)",
    ("scf/hf.py", "newton_refine_eigh"): "TPU-only, the body of eigh_refined",
    ("dft/functionals.py", "_TINY_TPU"): "the density floor of emulated float64 on the TPU",
    ("utils.py", "pubchem_mol_geometry"): "needs the network (PubChem)",
    # the reference's prebuilt libraries and their probes: the port builds
    # both libraries from csrc/ at first use (_compile.py) and raises when
    # it cannot, and binds the qubit mapping inside ham/qubit.py
    ("native/__init__.py", "_SRC"): "the port's sources are csrc/*.cpp (_compile.CSRC_DIR)",
    ("native/__init__.py", "_LIB"): "built into _compile.BUILD_DIR at first use",
    ("native/__init__.py", "_QSRC"): "the port's sources are csrc/*.cpp (_compile.CSRC_DIR)",
    ("native/__init__.py", "_QLIB"): "built into _compile.BUILD_DIR at first use",
    ("native/__init__.py", "available"): "the port builds the library or raises",
    ("native/__init__.py", "qubit_available"): "the port builds the library or raises",
    ("native/__init__.py", "map_terms"): "bound where it is called, in ham/qubit.py",
}
# (reference module, function or class[.method], parameter): why the port's
# counterpart has no parameter of that name
NOT_PORTED_PARAMETERS = {
    ("scf/engine.py", "SCFEngine", "pallas_jk"):
        "the TPU's Pallas switch: the port always runs its fused J/K kernel",
    ("ops/pallas_jk.py", "fused_jk", "tile_m"): "the Pallas grid's TPU tiling",
    ("ops/pallas_jk.py", "fused_jk", "tile_c"): "the Pallas grid's TPU tiling",
    ("ops/pallas_jk.py", "fused_jk", "interpret"):
        "Pallas interpret mode; on the CPU the port's wrapper takes its plain version",
}


def _names(path: Path) -> set:
    """Top-level public functions and classes, upper-case constants, and
    names imported (re-exported) at the top level."""
    out = set()
    for node in ast.parse(path.read_text()).body:
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef, ast.ClassDef)):
            out.add(node.name)
        elif isinstance(node, (ast.Assign, ast.AnnAssign)):
            targets = node.targets if isinstance(node, ast.Assign) else [node.target]
            out.update(t.id for t in targets if isinstance(t, ast.Name))
        elif isinstance(node, (ast.Import, ast.ImportFrom)):
            out.update((a.asname or a.name).split(".")[0] for a in node.names)
    return out


def _public(path: Path) -> set:
    """The names the reference module defines that need a counterpart."""
    out = set()
    for node in ast.parse(path.read_text()).body:
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef, ast.ClassDef)):
            if not node.name.startswith("_"):
                out.add(node.name)
        elif isinstance(node, (ast.Assign, ast.AnnAssign)):
            targets = node.targets if isinstance(node, ast.Assign) else [node.target]
            out.update(t.id for t in targets
                       if isinstance(t, ast.Name) and CONSTANT.match(t.id))
    return out


REF_MODULES = sorted(str(p.relative_to(REF)) for p in REF.rglob("*.py"))


def test_the_walk_sees_the_reference():
    assert "parallel/sharding.py" in REF_MODULES and "scf/hf.py" in REF_MODULES
    assert len(REF_MODULES) > 40


@pytest.mark.parametrize("module", REF_MODULES)
def test_counterpart_names(module):
    wanted = {n for n in _public(REF / module) if (module, n) not in NOT_PORTED}
    targets = MOVED.get(module, (module,))
    have = set()
    for target in targets:
        assert (PORT / target).is_file(), f"{module}: no nbed_tpu_torch/{target}"
        have |= _names(PORT / target)
    missing = sorted(wanted - have)
    assert not missing, f"nbed_tpu_torch/{targets[0]} lacks {missing}"


def test_exceptions_are_still_needed():
    """Each listed exception names a reference definition the port lacks."""
    for (module, name), _ in NOT_PORTED.items():
        assert name in _names(REF / module)
        assert not any(name in _names(PORT / t) for t in MOVED.get(module, (module,)))


def _arguments(fn) -> set:
    a = fn.args
    names = [x.arg for x in a.posonlyargs + a.args + a.kwonlyargs]
    names += [x.arg for x in (a.vararg, a.kwarg) if x is not None]
    return set(names) - {"self", "cls"}


def _signatures(path: Path) -> dict:
    """{name: parameter names} of the module's top-level functions and
    classes (fields and ``__init__`` arguments), and {"Class.method": ...}
    of each class's methods."""
    out = {}
    for node in ast.parse(path.read_text()).body:
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
            out[node.name] = _arguments(node)
        elif isinstance(node, ast.ClassDef):
            fields = set()
            for item in node.body:
                if isinstance(item, ast.AnnAssign) and isinstance(item.target, ast.Name):
                    fields.add(item.target.id)
                elif isinstance(item, (ast.FunctionDef, ast.AsyncFunctionDef)):
                    out[f"{node.name}.{item.name}"] = _arguments(item)
                    if item.name == "__init__":
                        fields |= _arguments(item)
            out[node.name] = fields
    return out


def _public_signatures(path: Path) -> dict:
    """The signatures of :func:`_signatures` whose function or class, and
    method, are public (``__init__`` counts as public)."""
    out = {}
    for name, params in _signatures(path).items():
        owner, _, method = name.partition(".")
        if owner.startswith("_") or (method.startswith("_") and method != "__init__"):
            continue
        out[name] = params
    return out


@pytest.mark.parametrize("module", REF_MODULES)
def test_counterpart_parameters(module):
    """Each public method and each parameter of the reference module's
    public functions, methods and classes has a counterpart of the same
    name in the port, where the port has the function or class."""
    targets = MOVED.get(module, (module,))
    port = {}
    for target in targets:
        port.update(_signatures(PORT / target))
    missing = []
    for name, params in _public_signatures(REF / module).items():
        owner = name.partition(".")[0]
        if (module, owner) in NOT_PORTED or owner not in port:
            continue  # no counterpart at all: test_counterpart_names decides
        if name not in port:
            missing.append(name)
            continue
        lacks = {p for p in params - port[name]
                 if (module, name, p) not in NOT_PORTED_PARAMETERS}
        missing += [f"{name}({p}=)" for p in sorted(lacks)]
    assert not missing, f"nbed_tpu_torch/{targets[0]} lacks {missing}"


def test_parameter_exceptions_are_still_needed():
    """Each listed parameter exception names a parameter the reference has
    and the port's counterpart lacks."""
    for module, name, param in NOT_PORTED_PARAMETERS:
        assert param in _signatures(REF / module)[name]
        port = {}
        for target in MOVED.get(module, (module,)):
            port.update(_signatures(PORT / target))
        assert param not in port[name]
