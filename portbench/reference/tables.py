"""The benchmark's own copy of the VVC MIP search's tables.

Frozen from the reference engine's constants (constants.h:17-194,
572-635, 1558; constants.cl:22-23) so that the plain reference and the op
model never read the measured program's geometry: the 47 CU size groups
searched in every 128x128 CTU, the strided per-CTU cost layout, the MIP
algebra constants, the filter coefficient libraries and the normative MIP
weight matrices (VTM's MipData, in ``mip_weights.npz`` beside this file).
"""

from __future__ import annotations

import dataclasses
import functools
from pathlib import Path

import numpy as np

CTU_SIZE = 128
MIP_SHIFT_MATRIX = 6
MIP_OFFSET_MATRIX = 32
SAMPLE_BITDEPTH = 10
SAMPLE_MAX = (1 << SAMPLE_BITDEPTH) - 1
VALUE_DC = 1 << (SAMPLE_BITDEPTH - 1)

BOUNDARY_SIZE = {0: 2, 1: 4, 2: 4}
REDUCED_PRED_SIZE = {0: 4, 1: 4, 2: 8}
PRED_MODES = {0: 16, 1: 8, 2: 6}

CONV_KERNELS_3x3 = np.array(
    [[[1, 1, 1], [1, 1, 1], [1, 1, 1]],
     [[1, 2, 1], [2, 3, 2], [1, 2, 1]],
     [[1, 2, 1], [2, 12, 2], [1, 2, 1]],
     [[1, 1, 1], [1, 8, 1], [1, 1, 1]],
     [[1, 2, 1], [2, 4, 2], [1, 2, 1]]], np.int64)
CONV_KERNELS_5x5 = np.array(
    [np.ones((5, 5), np.int64),
     [[1, 1, 1, 1, 1], [1, 1, 1, 1, 1], [1, 1, 5, 1, 1], [1, 1, 1, 1, 1],
      [1, 1, 1, 1, 1]],
     [[1, 2, 3, 2, 1], [2, 4, 6, 4, 2], [3, 6, 9, 6, 3], [2, 4, 6, 4, 2],
      [1, 2, 3, 2, 1]]], np.int64)
FILTERS = (
    "filterFrame_1d_int",
    "filterFrame_1d_float",
    "filterFrame_2d_int_quarterCtu",
    "filterFrame_2d_float_quarterCtu",
    "filterFrame_1d_int_5x5",
    "filterFrame_1d_float_5x5",
    "filterFrame_2d_int_5x5_quarterCtu",
    "filterFrame_2d_float_5x5_quarterCtu",
)


@dataclasses.dataclass(frozen=True)
class Group:
    """One CU size/alignment group: its CUs are the raster (y-major)
    product of ``ys`` and ``xs``, positions inside the CTU."""

    index: int
    width: int
    height: int
    size_id: int
    xs: tuple[int, ...]
    ys: tuple[int, ...]

    @property
    def cus_per_ctu(self) -> int:
        return len(self.xs) * len(self.ys)

    @property
    def total_modes(self) -> int:
        return 2 * PRED_MODES[self.size_id]


def _ar(start, stride, count):
    return tuple(range(start, start + stride * count, stride))


def _a(s):
    return _ar(0, s, CTU_SIZE // s)


def _h(s):
    return _ar(s // 2, 2 * s, CTU_SIZE // (2 * s))


def _q(s):
    return _ar(3 * s // 2, 4 * s, CTU_SIZE // (4 * s))


def _p(s):
    return tuple(sorted(_ar(0, 4 * s, CTU_SIZE // (4 * s))
                        + _ar(3 * s, 4 * s, CTU_SIZE // (4 * s))))


_SPEC = (  # (w, h, SizeId, xs, ys) in the reference's ALL_CU_SIZE order
    (64, 64, 2, _a(64), _a(64)), (32, 32, 2, _a(32), _a(32)),
    (32, 16, 2, _a(32), _a(16)), (16, 32, 2, _a(16), _a(32)),
    (32, 8, 2, _a(32), _a(8)), (8, 32, 2, _a(8), _a(32)),
    (16, 16, 2, _a(16), _a(16)), (16, 8, 2, _a(16), _a(8)),
    (8, 16, 2, _a(8), _a(16)),
    (32, 16, 2, _a(32), _h(16)), (16, 32, 2, _h(16), _a(32)),
    (32, 8, 2, _a(32), _h(8)), (32, 8, 2, _a(32), _q(8)),
    (8, 32, 2, _h(8), _a(32)), (8, 32, 2, _q(8), _a(32)),
    (16, 16, 2, _h(16), _a(16)), (16, 16, 2, _a(16), _h(16)),
    (16, 16, 2, _h(16), _h(16)),
    (16, 8, 2, _h(16), _a(8)), (16, 8, 2, _a(16), _h(8)),
    (16, 8, 2, _a(16), _q(8)), (16, 8, 2, _h(16), _h(8)),
    (16, 8, 2, _h(16), _q(8)),
    (8, 16, 2, _h(8), _a(16)), (8, 16, 2, _a(8), _h(16)),
    (8, 16, 2, _q(8), _a(16)), (8, 16, 2, _q(8), _h(16)),
    (8, 16, 2, _h(8), _h(16)),
    (32, 4, 1, _a(32), _a(4)), (4, 32, 1, _a(4), _a(32)),
    (16, 4, 1, _a(16), _a(4)), (4, 16, 1, _a(4), _a(16)),
    (8, 8, 1, _a(8), _a(8)),
    (8, 4, 1, _a(8), _ar(0, 4, 16)), (8, 4, 1, _a(8), _ar(64, 4, 16)),
    (4, 8, 1, _a(4), _ar(0, 8, 8)), (4, 8, 1, _a(4), _ar(64, 8, 8)),
    (16, 4, 1, _h(16), _a(4)), (4, 16, 1, _a(4), _h(16)),
    (8, 8, 1, _h(8), _a(8)), (8, 8, 1, _q(8), _p(8)),
    (8, 8, 1, _a(8), _h(8)), (8, 8, 1, _p(8), _q(8)),
    (8, 8, 1, _h(8), _h(8)),
    (8, 4, 1, _h(8), _a(4)), (4, 8, 1, _a(4), _h(8)),
    (4, 4, 0, _a(4), _a(4)),
)
GROUPS = tuple(Group(i, *row) for i, row in enumerate(_SPEC))
# offset of each group's costs in a CTU's slab; the last entry, 97840, is
# the slab's length
GROUP_OFFSETS = np.concatenate(
    [[0], np.cumsum([g.cus_per_ctu * g.total_modes for g in GROUPS])])
PER_CTU = int(GROUP_OFFSETS[-1])


def shape_classes() -> list[tuple[int, int, int, int]]:
    """(width, height, SizeId, CUs per CTU) of the 17 shape classes, in the
    order their first groups appear."""
    out: dict[tuple[int, int, int], int] = {}
    for g in GROUPS:
        key = (g.width, g.height, g.size_id)
        out[key] = out.get(key, 0) + g.cus_per_ctu
    return [(*key, n) for key, n in out.items()]


def num_ctus(width: int, height: int) -> tuple[int, int, int]:
    """(CTU columns, CTU rows, CTUs) of a frame."""
    cols, rows = -(-width // CTU_SIZE), -(-height // CTU_SIZE)
    return cols, rows, cols * rows


@functools.cache
def mip_matrices() -> dict[int, np.ndarray]:
    """MIP weights per SizeId, int64 [modes, samples, boundary inputs];
    SizeId 2's first input gets a zero coefficient (intra.cl:459-463)."""
    with np.load(Path(__file__).with_name("mip_weights.npz")) as z:
        mats = {i: z[f"size_id{i}"].astype(np.int64) for i in range(3)}
    m2 = mats[2]
    mats[2] = np.concatenate([np.zeros(m2.shape[:2] + (1,), np.int64), m2],
                             axis=2)
    return mats
