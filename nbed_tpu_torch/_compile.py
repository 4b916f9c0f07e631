"""Compile a native source of the port into ``nbed_tpu_torch/_build``.

The build directory is listed in ``.gitignore``: every checkout builds its
libraries at first use. The host C++ sources live in ``csrc/`` beside the
CUDA kernel: the integral engine ``md_integrals.cpp`` and the Pauli-term
engine ``qubit_terms.cpp``, both built with ``g++``. A failed build raises;
nothing falls back to another implementation.
"""

import ctypes
import os
import subprocess
import tempfile
from functools import lru_cache
from pathlib import Path

__all__ = ["BUILD_DIR", "CSRC_DIR", "build_shared_library",
           "native_integrals_library", "qubit_terms_library"]

BUILD_DIR = Path(__file__).resolve().parent / "_build"
CSRC_DIR = Path(__file__).resolve().parent / "csrc"
_GXX = ["g++", "-O3", "-shared", "-fPIC"]


def build_shared_library(compile_cmd: list, src: Path, name: str) -> Path:
    """Compile ``src`` into ``BUILD_DIR/name`` unless a build newer than the
    source exists. ``compile_cmd`` is the compiler and its flags; the source
    and ``-o <out>`` are appended. The library is written under a temporary
    name and renamed, so concurrent processes never load a half-written file.
    """
    out = BUILD_DIR / name
    if out.exists() and out.stat().st_mtime >= src.stat().st_mtime:
        return out
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    fd, tmp = tempfile.mkstemp(dir=BUILD_DIR, suffix=".so.tmp")
    os.close(fd)
    try:
        proc = subprocess.run([*compile_cmd, str(src), "-o", tmp],
                              capture_output=True, text=True)
        if proc.returncode != 0:
            raise RuntimeError(
                f"building {src.name} failed ({' '.join(compile_cmd)}):\n"
                f"{proc.stdout}{proc.stderr}"
            )
        os.replace(tmp, out)
    finally:
        if os.path.exists(tmp):
            os.unlink(tmp)
    return out


@lru_cache(maxsize=1)
def native_integrals_library() -> ctypes.CDLL:
    """The McMurchie-Davidson integral engine ``csrc/md_integrals.cpp``."""
    return ctypes.CDLL(str(build_shared_library(
        _GXX, CSRC_DIR / "md_integrals.cpp", "libnbed_md.so")))


@lru_cache(maxsize=1)
def qubit_terms_library() -> ctypes.CDLL:
    """The Pauli-term engine ``csrc/qubit_terms.cpp`` of the qubit mappings."""
    return ctypes.CDLL(str(build_shared_library(
        _GXX, CSRC_DIR / "qubit_terms.cpp", "libnbed_qubit.so")))
