"""ctypes bindings of the port's C CSV reader and writers
(``csrc/io_native.c``), built with the host C compiler at first use
(``ops/_build.py``).

ctypes releases the interpreter lock for each call, so the CLI's writer
thread formats CSVs while the calling thread drives the card.  Every
array is checked for its size and made contiguous in the type the C code
reads before its pointer is passed.  There is no other path: without a C
compiler these functions raise, and the numpy versions in ``io/frames.py``
and ``io/export.py`` (``*_plain``) serve only as the tests' oracle.
"""

from __future__ import annotations

import ctypes
import functools
import os

import numpy as np

from vvc_mip_gpu_tpu_torch.ops._build import load_library

HEAD_STRIDE = 32  # bytes per "cuSizeName,W,H,CU" string (io_native.c)
_POOL_LIMIT = 10 ** 6  # X and Y have at most 6 digits (io_native.c)

_P = ctypes.c_void_p
_I64 = ctypes.c_int64


@functools.cache
def _lib() -> ctypes.CDLL:
    lib = load_library("io_native")
    lib.io_read_samples_csv.argtypes = [ctypes.c_char_p, _I64, _I64, _I64,
                                        _P, _P]
    lib.io_write_samples_csv.argtypes = [ctypes.c_char_p, _P, _I64, _I64]
    lib.io_write_decisions_csv.argtypes = [
        ctypes.c_char_p, ctypes.c_char_p, _I64, _I64, _P, _P, _I64, _I64,
        _P, _P, _P, _P, _P, _P, _P, _P]
    for fn in (lib.io_read_samples_csv, lib.io_write_samples_csv,
               lib.io_write_decisions_csv):
        fn.restype = ctypes.c_int
    return lib


def _check(rc: int, path) -> None:
    if rc != 0:
        err = ctypes.get_errno()
        raise OSError(err, os.strerror(err), os.fspath(path))


def _ptr(a: np.ndarray | None):
    return None if a is None else a.ctypes.data


def _int64(a, n: int, what: str) -> np.ndarray:
    a = np.ascontiguousarray(a, np.int64).reshape(-1)
    if a.size != n:
        raise ValueError(f"{what}: {a.size} entries, expected {n}")
    return a


def read_samples_csv(path, width: int, rows: int, skip_rows: int):
    """(samples, stats): the first rows x width samples of the ``rows``
    lines after the first ``skip_rows`` lines of a frame CSV, as uint16
    [rows * width], and (lines read, samples parsed, every line has
    width - 1 commas, every sample in 0..65535).  The samples are valid
    only when the stats say so; the caller raises otherwise."""
    if min(width, rows, skip_rows) < 0:
        raise ValueError("width, rows and skip_rows must be >= 0")
    out = np.empty(rows * width, np.uint16)
    stats = np.zeros(4, np.int64)
    _check(_lib().io_read_samples_csv(os.fsencode(path), width, rows,
                                      skip_rows, _ptr(out), _ptr(stats)),
           path)
    return out, tuple(int(v) for v in stats)


def write_samples_csv(path, samples) -> None:
    """Write int64-valued [rows, width] samples, one row per line of
    comma-separated decimals."""
    samples = np.asarray(samples)
    if samples.ndim != 2:
        raise ValueError(f"samples must be [rows, width], got "
                         f"{samples.shape}")
    rows, width = samples.shape
    samples = _int64(samples, rows * width, "samples")
    _check(_lib().io_write_samples_csv(os.fsencode(path), _ptr(samples),
                                       rows, width), path)


def write_decisions_csv(path, header: str, pocs, ctus, ctu_cols: int,
                        ctu_size: int, heads: np.ndarray, head_len,
                        x_in, y_in, mode, msh, sad=None, satd=None) -> None:
    """Write a decisions log: ``header``, then per slab s (CTU ctus[s])
    and slab row i the row [pocs[s],]ctus[s],heads[i],X,Y,mode[i],SAD,
    SATD,minSadHad with X, Y the CTU's origin on a grid of ``ctu_cols``
    columns plus x_in[i], y_in[i].  ``pocs`` None: no POC column; ``sad``
    or ``satd`` None: a column of zeros.  ``heads``: uint8
    [slab_len, HEAD_STRIDE], each string NUL-padded; ``head_len`` their
    lengths."""
    slab_len = len(x_in)
    ctus = _int64(ctus, len(ctus), "ctus")
    n_slabs = ctus.size
    if heads.dtype != np.uint8 or heads.shape != (slab_len, HEAD_STRIDE):
        raise ValueError(f"heads must be uint8 [{slab_len}, {HEAD_STRIDE}]")
    head_len = np.ascontiguousarray(head_len, np.uint8)
    heads = np.ascontiguousarray(heads)
    x_in, y_in, mode = (_int64(a, slab_len, name) for a, name in (
        (x_in, "x_in"), (y_in, "y_in"), (mode, "mode")))
    if head_len.size != slab_len or head_len.max(initial=0) >= HEAD_STRIDE:
        raise ValueError(f"head_len: {slab_len} lengths below {HEAD_STRIDE}")
    if ctu_cols < 1 or (n_slabs and ctus.min() < 0):
        raise ValueError("ctu_cols must be >= 1 and CTUs >= 0")
    grid_rows = int(ctus.max()) // ctu_cols + 1 if n_slabs else 1
    if (ctu_cols * ctu_size + x_in.max(initial=0) >= _POOL_LIMIT
            or grid_rows * ctu_size + y_in.max(initial=0) >= _POOL_LIMIT
            or mode.max(initial=0) >= _POOL_LIMIT):
        raise ValueError("CU positions and modes must stay below 10**6")
    costs = [None if a is None else _int64(a, n_slabs * slab_len, name)
             for a, name in ((msh, "min_sad_had"), (sad, "sad"),
                             (satd, "satd"))]
    pocs = None if pocs is None else _int64(pocs, n_slabs, "pocs")
    _check(_lib().io_write_decisions_csv(
        os.fsencode(path), header.encode(), n_slabs, slab_len, _ptr(pocs),
        _ptr(ctus), ctu_cols, ctu_size, _ptr(heads), _ptr(head_len),
        _ptr(x_in), _ptr(y_in), _ptr(mode), _ptr(costs[1]), _ptr(costs[2]),
        _ptr(costs[0])), path)
