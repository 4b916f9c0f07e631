"""The one place that reads files of the JAX package ``nbed_tpu``.

``import nbed_tpu.<anything>`` runs ``nbed_tpu/__init__.py``, which imports
JAX, and ``nbed_tpu/config.py`` needs a validation library; neither is
installed where the port runs on the GPU. So nothing here imports
``nbed_tpu``. Two kinds of file are shared without copying them:

- data-only modules (basis tables, the periodic table, the Lebedev orbit
  parameters) and the numpy/scipy FCI solver, each loaded from its path
  under a private module name, so the package ``__init__`` never runs;
- the C++ integral engine ``md_integrals.cpp``, which the port compiles
  itself into its own build directory (``nbed_tpu_torch/_build``).
"""

import ctypes
import importlib.util
import sys
from functools import lru_cache
from pathlib import Path

from ._compile import build_shared_library

__all__ = ["load_module", "native_integrals_library"]

REFERENCE_DIR = Path(__file__).resolve().parent.parent / "nbed_tpu"

# files of nbed_tpu that import nothing outside numpy/scipy and nothing of
# their own package
_SHAREABLE = {
    "chem/basis/data_sto3g.py",
    "chem/basis/data_631g.py",
    "chem/periodic.py",
    "grids/data_lebedev.py",
    "solvers/fci.py",
}


@lru_cache(maxsize=None)
def load_module(relpath: str):
    """Load ``nbed_tpu/<relpath>`` by file path under a private name."""
    if relpath not in _SHAREABLE:
        raise ValueError(f"{relpath} is not a shareable nbed_tpu file")
    name = "_nbed_tpu_torch_ref." + relpath.removesuffix(".py").replace("/", ".")
    spec = importlib.util.spec_from_file_location(name, REFERENCE_DIR / relpath)
    module = importlib.util.module_from_spec(spec)
    sys.modules[name] = module
    spec.loader.exec_module(module)
    return module


@lru_cache(maxsize=1)
def native_integrals_library() -> ctypes.CDLL:
    """The port's own build of ``nbed_tpu/native/md_integrals.cpp``."""
    src = REFERENCE_DIR / "native" / "md_integrals.cpp"
    lib = build_shared_library(["g++", "-O3", "-shared", "-fPIC"], src,
                               "libnbed_md.so")
    return ctypes.CDLL(str(lib))
