"""Build and load the package's CUDA kernels.

``nvcc`` compiles ``csrc/mip_cost.cu`` for Hopper (``sm_90a``) into a shared
library with a plain C interface, which ``ctypes`` loads.  The library is
built at first use, into ``build/`` inside the package (listed in
.gitignore), under a name that carries a hash of the source and the flags,
so an edited source is never served by a stale library.  Needs the CUDA
toolkit; nothing here runs when the module is imported.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
from pathlib import Path

_PKG = Path(__file__).resolve().parent.parent
CSRC = _PKG / "csrc"
BUILD_DIR = _PKG / "build"
SOURCE = CSRC / "mip_cost.cu"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")


def _nvcc() -> str:
    path = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    if not Path(path).exists():
        raise RuntimeError(
            "nvcc not found: the CUDA kernels build only where the CUDA "
            "toolkit is installed")
    return path


def library_path() -> Path:
    """Where the library for the current source and flags lives."""
    digest = hashlib.sha256(
        SOURCE.read_bytes() + " ".join(NVCC_FLAGS).encode()).hexdigest()
    return BUILD_DIR / f"{SOURCE.stem}_{digest[:16]}.so"


def build_library() -> tuple[Path, str]:
    """Compile the kernels unless the library is already built.  Returns
    (library path, nvcc's diagnostics: ptxas register and shared-memory
    use per kernel; empty when nothing was compiled)."""
    out = library_path()
    if out.exists():
        return out, ""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_name(f"{out.stem}.{os.getpid()}.tmp")
    proc = subprocess.run([_nvcc(), *NVCC_FLAGS, "-o", str(tmp),
                           str(SOURCE)], capture_output=True, text=True,
                          check=False)
    if proc.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(f"nvcc failed ({proc.returncode}):\n"
                           f"{proc.stdout}{proc.stderr}")
    os.replace(tmp, out)
    return out, proc.stderr


@functools.cache
def load_library() -> ctypes.CDLL:
    """The kernels' shared library, built on first use."""
    path, _ = build_library()
    return ctypes.CDLL(str(path))
