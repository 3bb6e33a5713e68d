"""Build and load the package's native libraries.

``nvcc`` compiles each CUDA source of ``csrc/`` for Hopper (``sm_90a``)
into a shared library of its own with a plain C interface, which
``ctypes`` loads: ``mip_cost`` (the cost kernels), ``mip_pred`` (the
reduced prediction) and ``mip_filter`` (the low-pass filters).  The host
C compiler (``cc``) builds the one C source, ``io_native`` (the CSV
reader and writers of ``io/native.py``), without ``-ffast-math``.  A
library is built at first use, into ``build/`` inside the package (listed
in .gitignore), under a name that carries a hash of its source, the
headers it may include and the flags, so an edited or added source is
never served by a stale library; it is written under a temporary name and
renamed into place, so processes that build the same library at once
each load a whole one.  ``build_libraries`` starts one compiler per
source, all at once.  A missing compiler or a failed build raises with
the compiler's output; nothing here runs when the module is imported.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path

_PKG = Path(__file__).resolve().parent.parent
CSRC = _PKG / "csrc"
BUILD_DIR = _PKG / "build"
LIBRARIES = ("mip_cost", "mip_pred", "mip_filter")  # one per csrc/<name>.cu
HOST_LIBRARIES = ("io_native",)  # one per csrc/<name>.c
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")
CC_FLAGS = ("-O3", "-std=c11", "-shared", "-fPIC")


def _nvcc() -> str:
    path = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    if not Path(path).exists():
        raise RuntimeError(
            "nvcc not found: the CUDA kernels build only where the CUDA "
            "toolkit is installed")
    return path


def _cc() -> str:
    path = shutil.which("cc")
    if path is None:
        raise RuntimeError(
            "no C compiler (cc) on PATH: the port's CSV reader and writers "
            "(csrc/io_native.c) build only with one")
    return path


def source(name: str) -> Path:
    if name in LIBRARIES:
        return CSRC / f"{name}.cu"
    if name in HOST_LIBRARIES:
        return CSRC / f"{name}.c"
    raise ValueError(f"unknown kernel library {name!r}; "
                     f"known: {LIBRARIES + HOST_LIBRARIES}")


def _command(name: str) -> list[str]:
    """The compiler and its flags for one library, without the output."""
    if name in HOST_LIBRARIES:
        return [_cc(), *CC_FLAGS]
    return [_nvcc(), *NVCC_FLAGS]


def library_path(name: str) -> Path:
    """Where the library for the current sources and flags lives."""
    src = source(name)
    headers = sorted(CSRC.glob("*.cuh" if src.suffix == ".cu" else "*.h"))
    flags = NVCC_FLAGS if src.suffix == ".cu" else CC_FLAGS
    digest = hashlib.sha256()
    for path in (src, *headers):
        digest.update(path.name.encode() + b"\0" + path.read_bytes())
    digest.update(" ".join(flags).encode())
    return BUILD_DIR / f"{name}_{digest.hexdigest()[:16]}.so"


def build_libraries(names=LIBRARIES) -> dict[str, tuple[Path, str]]:
    """Compile the named libraries that are not built yet, one compiler
    each, all started together.  Returns {name: (library path, the
    compiler's diagnostics: for nvcc, ptxas register and shared-memory use
    per kernel; empty when nothing was compiled)}."""
    out: dict[str, tuple[Path, str]] = {}
    running = []
    for name in names:
        lib = library_path(name)
        if lib.exists():
            out[name] = (lib, "")
            continue
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        tmp = lib.with_name(
            f"{lib.stem}.{os.getpid()}.{threading.get_ident()}.tmp")
        proc = subprocess.Popen(
            [*_command(name), "-o", str(tmp), str(source(name))],
            stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
        running.append((name, lib, tmp, proc))
    failed = []
    for name, lib, tmp, proc in running:
        stdout, stderr = proc.communicate()
        if proc.returncode != 0:
            tmp.unlink(missing_ok=True)
            failed.append(f"building {name} failed ({proc.returncode}):\n"
                          f"{stdout}{stderr}")
            continue
        os.replace(tmp, lib)
        out[name] = (lib, stderr)
    if failed:
        raise RuntimeError("\n".join(failed))
    return out


@functools.cache
def load_library(name: str) -> ctypes.CDLL:
    """One library, built on first use (``ctypes.get_errno`` reads the
    errno of its last call)."""
    path, _ = build_libraries((name,))[name]
    return ctypes.CDLL(str(path), use_errno=True)
