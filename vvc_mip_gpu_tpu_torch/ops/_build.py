"""Build and load the package's CUDA kernels.

``nvcc`` compiles each source of ``csrc/`` for Hopper (``sm_90a``) into a
shared library of its own with a plain C interface, which ``ctypes``
loads: ``mip_cost`` (the cost kernels) and ``mip_pred`` (the reduced
prediction).  A library is built at first use, into ``build/`` inside the
package (listed in .gitignore), under a name that carries a hash of its
source, every header in ``csrc/`` and the flags, so an edited or added
source is never served by a stale library.  ``build_libraries`` starts one
``nvcc`` per source, all at once.  Needs the CUDA toolkit; nothing here
runs when the module is imported.
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
LIBRARIES = ("mip_cost", "mip_pred")  # one per csrc/<name>.cu
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")


def _nvcc() -> str:
    path = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    if not Path(path).exists():
        raise RuntimeError(
            "nvcc not found: the CUDA kernels build only where the CUDA "
            "toolkit is installed")
    return path


def source(name: str) -> Path:
    if name not in LIBRARIES:
        raise ValueError(f"unknown kernel library {name!r}; "
                         f"known: {LIBRARIES}")
    return CSRC / f"{name}.cu"


def library_path(name: str) -> Path:
    """Where the library for the current sources and flags lives."""
    digest = hashlib.sha256()
    for path in (source(name), *sorted(CSRC.glob("*.cuh"))):
        digest.update(path.name.encode() + b"\0" + path.read_bytes())
    digest.update(" ".join(NVCC_FLAGS).encode())
    return BUILD_DIR / f"{name}_{digest.hexdigest()[:16]}.so"


def build_libraries(names=LIBRARIES) -> dict[str, tuple[Path, str]]:
    """Compile the named libraries that are not built yet, one ``nvcc``
    each, all started together.  Returns {name: (library path, nvcc's
    diagnostics: ptxas register and shared-memory use per kernel; empty
    when nothing was compiled)}."""
    out: dict[str, tuple[Path, str]] = {}
    running = []
    for name in names:
        lib = library_path(name)
        if lib.exists():
            out[name] = (lib, "")
            continue
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        tmp = lib.with_name(f"{lib.stem}.{os.getpid()}.tmp")
        proc = subprocess.Popen(
            [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(source(name))],
            stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
        running.append((name, lib, tmp, proc))
    failed = []
    for name, lib, tmp, proc in running:
        stdout, stderr = proc.communicate()
        if proc.returncode != 0:
            tmp.unlink(missing_ok=True)
            failed.append(f"nvcc {name} failed ({proc.returncode}):\n"
                          f"{stdout}{stderr}")
            continue
        os.replace(tmp, lib)
        out[name] = (lib, stderr)
    if failed:
        raise RuntimeError("\n".join(failed))
    return out


@functools.cache
def load_library(name: str) -> ctypes.CDLL:
    """One kernel library, built on first use."""
    path, _ = build_libraries((name,))[name]
    return ctypes.CDLL(str(path))
