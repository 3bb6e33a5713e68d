"""Decisions-log CSV export in the reference engine's exact schema.

Schema (reference: main_aux_functions.h:735-798):
    CTU,cuSizeName,W,H,CU,X,Y,Mode,SAD,SATD,minSadHad
rows ordered CTU-major, then size group (SizeId2 groups, SizeId1, SizeId0),
then CU raster index, then mode (non-transposed first).  cuSizeName is
"ALL_" + the group name (main_aux_functions.h:296-399).  With no SAD/SATD
(the reference's MAX_PERFORMANCE_DIST=1 default) those columns are zeros,
mirroring the reference's never-read-back buffers
(main_aux_functions.h:591-619).

At 1080p a frame is ~13.2 M rows (~0.6 GB).  ``export_decisions_csv``
and ``export_target_ctu_csv`` write through the C writer of
``csrc/io_native.c`` (``io/native.py``).  Their ``*_plain`` versions are
vectorised numpy, kept as the oracle the tests and chip_smoke.py hold the
C writer against: a chunk of CTU slabs becomes one byte matrix with a
fixed-width field per column (digits right-aligned) and a mask of the
bytes each row keeps; the masked bytes, in row order, are the CSV text.
Both are byte-identical to pandas' ``to_csv`` of the same columns.
"""

from __future__ import annotations

import functools
from pathlib import Path

import numpy as np

from vvc_mip_gpu_tpu_torch.constants import (
    CTU_SIZE,
    GROUPS,
    STRIDED_DISTORTIONS_PER_CTU,
)
from vvc_mip_gpu_tpu_torch.io import native

DIST_PER_CTU = int(STRIDED_DISTORTIONS_PER_CTU[-1])
_SLABS_PER_CHUNK = 8  # ~0.8 M rows, ~60 MB of text per write
_HEADER = "CTU,cuSizeName,W,H,CU,X,Y,Mode,SAD,SATD,minSadHad\n"


@functools.cache
def _per_ctu_columns():
    """Row-invariant per-CTU-slab columns, each [DIST_PER_CTU]: the
    cuSizeName strings (bytes) and int64 W, H, CU, X and Y in the CTU,
    and Mode."""
    names = np.array([b""] * DIST_PER_CTU,
                     f"S{max(len(g.name) for g in GROUPS) + 4}")
    w, h, cu, x_in, y_in, mode = (np.empty(DIST_PER_CTU, np.int64)
                                  for _ in range(6))
    for g in GROUPS:
        start = int(STRIDED_DISTORTIONS_PER_CTU[g.index])
        n, m = g.cus_per_ctu, g.total_modes
        sl = slice(start, start + n * m)
        names[sl] = ("ALL_" + g.name).encode()
        w[sl] = g.width
        h[sl] = g.height
        cu[sl] = np.repeat(np.arange(n), m)
        gx, gy = np.meshgrid(g.xs, g.ys)  # raster: y-major
        x_in[sl] = np.repeat(gx.ravel(), m)
        y_in[sl] = np.repeat(gy.ravel(), m)
        mode[sl] = np.tile(np.arange(m), n)
    return names, w, h, cu, x_in, y_in, mode


@functools.cache
def _heads() -> tuple[np.ndarray, np.ndarray]:
    """The C writer's per-slab-row "cuSizeName,W,H,CU" strings, uint8
    [DIST_PER_CTU, HEAD_STRIDE] NUL-padded, and their lengths."""
    names, w, h, cu, *_ = _per_ctu_columns()
    text = np.array([b"%s,%d,%d,%d" % row for row in zip(names, w, h, cu)],
                    f"S{native.HEAD_STRIDE}")
    return (text.view(np.uint8).reshape(DIST_PER_CTU, native.HEAD_STRIDE),
            np.char.str_len(text).astype(np.uint8))


def _write_native(path, header: str, pocs, ctus, frame_width: int, msh,
                  sad, satd) -> None:
    _, _, _, _, x_in, y_in, mode = _per_ctu_columns()
    heads, head_len = _heads()
    native.write_decisions_csv(
        path, header, pocs, ctus, -(-frame_width // CTU_SIZE), CTU_SIZE,
        heads, head_len, x_in, y_in, mode, msh, sad, satd)


def _encode(values: np.ndarray):
    """(bytes [..., width] uint8, keep [..., width] bool) of one column:
    the ASCII text of each value, right-aligned in a fixed-width field.
    ``values``: int64 (decimal, '-' for negatives) or fixed-width bytes."""
    if values.dtype.kind == "S":
        chars = values.view(np.uint8).reshape(*values.shape,
                                              values.dtype.itemsize)
        return chars, chars != 0
    mag = np.abs(values)
    n_dig = len(str(int(mag.max()))) if mag.size else 1
    sign = bool((values < 0).any())
    width = n_dig + sign
    chars = np.empty((*values.shape, width), np.uint8)
    keep = np.empty((*values.shape, width), bool)
    q = mag.copy()
    for k in range(n_dig):
        q, digit = np.divmod(q, 10)
        chars[..., width - 1 - k] = digit + ord("0")
        keep[..., width - 1 - k] = (mag >= 10 ** k) | (k == 0)
    if sign:
        chars[..., 0] = ord("-")
        keep[..., 0] = values < 0
    return chars, keep


def _rows_text(columns, shape: tuple[int, int]) -> bytes:
    """CSV text of ``shape`` = (slabs, rows per slab) rows; each column
    broadcasts to that shape."""
    parts = [_encode(np.asarray(c)) for c in columns]
    total = sum(chars.shape[-1] + 1 for chars, _ in parts)
    buf = np.empty((*shape, total), np.uint8)
    keep = np.empty((*shape, total), bool)
    at = 0
    for i, (chars, mask) in enumerate(parts):
        wd = chars.shape[-1]
        buf[..., at:at + wd] = chars
        keep[..., at:at + wd] = mask
        buf[..., at + wd] = ord("\n") if i == len(parts) - 1 else ord(",")
        keep[..., at + wd] = True
        at += wd + 1
    return buf[keep].tobytes()


def _write_slabs(path, header: str, n_slabs: int, columns) -> None:
    """Write ``header`` and ``n_slabs`` slabs of DIST_PER_CTU rows.
    ``columns(s0, s1)`` returns the CSV columns of slabs [s0, s1), each
    broadcastable to [s1 - s0, DIST_PER_CTU]."""
    with open(path, "wb") as f:
        f.write(header.encode())
        for s0 in range(0, n_slabs, _SLABS_PER_CHUNK):
            s1 = min(s0 + _SLABS_PER_CHUNK, n_slabs)
            f.write(_rows_text(columns(s0, s1), (s1 - s0, DIST_PER_CTU)))


def _costs(a, n_slabs: int) -> np.ndarray | None:
    """[n_slabs, DIST_PER_CTU] cost slabs (None stays None)."""
    if a is None:
        return None
    a = np.asarray(a)
    if a.size != n_slabs * DIST_PER_CTU:
        raise ValueError(f"cost tensor of {a.size} entries, expected "
                         f"{n_slabs} x {DIST_PER_CTU}")
    return a.reshape(n_slabs, DIST_PER_CTU)


def export_decisions_csv(path: str | Path, min_sad_had, frame_width: int,
                         sad=None, satd=None,
                         poc: int | None = None) -> None:
    """Write the decisions log for one frame, through the C writer.

    min_sad_had / sad / satd: [nCTU, DIST_PER_CTU] numpy cost slabs in the
    strided layout (FrameCosts fields read back to the host).  ``poc``
    adds the multi-frame POC column variant (reference:
    main_aux_functions.h:843-906)."""
    n_ctu = np.shape(min_sad_had)[0]
    msh, sad, satd = (_costs(a, n_ctu) for a in (min_sad_had, sad, satd))
    header = _HEADER if poc is None else "POC," + _HEADER
    _write_native(path, header, None if poc is None else np.full(n_ctu, poc),
                  np.arange(n_ctu), frame_width, msh, sad, satd)


def export_decisions_csv_plain(path: str | Path, min_sad_had,
                               frame_width: int, sad=None, satd=None,
                               poc: int | None = None) -> None:
    """``export_decisions_csv`` in numpy: the C writer's oracle."""
    n_ctu = np.shape(min_sad_had)[0]
    msh, sad, satd = (_costs(a, n_ctu) for a in (min_sad_had, sad, satd))
    ctu_cols = -(-frame_width // CTU_SIZE)
    names, w, h, cu, x_in, y_in, mode = _per_ctu_columns()

    def columns(s0, s1):
        ctu = np.arange(s0, s1, dtype=np.int64)[:, None]
        cols = [ctu, names, w, h, cu,
                (ctu % ctu_cols) * CTU_SIZE + x_in,
                (ctu // ctu_cols) * CTU_SIZE + y_in, mode,
                *(np.int64(0) if a is None else a[s0:s1]
                  for a in (sad, satd)), msh[s0:s1]]
        return cols if poc is None else [np.int64(poc), *cols]

    header = _HEADER if poc is None else "POC," + _HEADER
    _write_slabs(path, header, n_ctu, columns)


def _target_slabs(msh_per_frame, sad_per_frame, satd_per_frame, pocs):
    """(pocs, msh, sad, satd) of a target-CTU CSV: int64 [n_frames] and
    [n_frames, DIST_PER_CTU] each, a frame's missing slab zeros."""
    n_frames = len(msh_per_frame)
    pocs = np.arange(n_frames) if pocs is None else np.asarray(pocs)

    def slabs(per_frame) -> np.ndarray:
        return np.stack([np.zeros(DIST_PER_CTU, np.int64)
                         if per_frame is None or per_frame[f] is None
                         else np.asarray(per_frame[f], np.int64).ravel()
                         for f in range(n_frames)])

    return (pocs.astype(np.int64), *(slabs(p) for p in (
        msh_per_frame, sad_per_frame, satd_per_frame)))


def export_target_ctu_csv(path: str | Path, msh_per_frame, frame_width: int,
                          target_ctu: int, sad_per_frame=None,
                          satd_per_frame=None, pocs=None) -> None:
    """One TARGET CTU across ALL frames in a single POC-columned CSV —
    the reference's reportTargetDistortionValues_File
    (main_aux_functions.h:843-906): header
    POC,CTU,cuSizeName,W,H,CU,X,Y,Mode,SAD,SATD,minSadHad, frames outer,
    then the same group/CU/mode row order as the per-frame decisions log,
    with absolute CU positions (CTU base + in-CTU offset).

    ``msh_per_frame``: one [DIST_PER_CTU] slab (the target CTU's row of
    FrameCosts.min_sad_had) per frame.  SAD/SATD default to zeros,
    mirroring the reference's MAX_PERFORMANCE_DIST never-read-back
    buffers (main_aux_functions.h:591-619).  Written through the C
    writer.
    """
    pocs, msh, sad, satd = _target_slabs(msh_per_frame, sad_per_frame,
                                         satd_per_frame, pocs)
    _write_native(path, "POC," + _HEADER, pocs,
                  np.full(len(pocs), target_ctu), frame_width, msh, sad, satd)


def export_target_ctu_csv_plain(path: str | Path, msh_per_frame,
                                frame_width: int, target_ctu: int,
                                sad_per_frame=None, satd_per_frame=None,
                                pocs=None) -> None:
    """``export_target_ctu_csv`` in numpy: the C writer's oracle."""
    pocs, msh, sad, satd = _target_slabs(msh_per_frame, sad_per_frame,
                                         satd_per_frame, pocs)
    n_frames = len(pocs)
    names, w, h, cu, x_in, y_in, mode = _per_ctu_columns()
    ctu_cols = -(-frame_width // CTU_SIZE)
    ctu_x = (target_ctu % ctu_cols) * CTU_SIZE
    ctu_y = (target_ctu // ctu_cols) * CTU_SIZE

    def columns(s0, s1):
        return [pocs[s0:s1, None], np.int64(target_ctu),
                names, w, h, cu, ctu_x + x_in, ctu_y + y_in, mode,
                sad[s0:s1], satd[s0:s1], msh[s0:s1]]

    _write_slabs(path, "POC," + _HEADER, n_frames, columns)


def decide_best_modes(min_sad_had) -> dict:
    """Per-CU argmin over modes — the decision the reference leaves to the
    log consumer.  Returns {group_index: (best_mode, best cost)} arrays of
    shape [nCTU, cusPerCtu]."""
    min_sad_had = np.asarray(min_sad_had)
    out = {}
    n_ctu = min_sad_had.shape[0]
    for g in GROUPS:
        start = int(STRIDED_DISTORTIONS_PER_CTU[g.index])
        n, m = g.cus_per_ctu, g.total_modes
        block = min_sad_had[:, start:start + n * m].reshape(n_ctu, n, m)
        out[g.index] = (block.argmin(-1), block.min(-1))
    return out
