"""Compile a native source of the port into ``nbed_tpu_torch/_build``.

The build directory is listed in ``.gitignore``: every checkout builds its
libraries at first use.
"""

import os
import subprocess
import tempfile
from pathlib import Path

__all__ = ["BUILD_DIR", "build_shared_library"]

BUILD_DIR = Path(__file__).resolve().parent / "_build"


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
