"""Geometry and layout constants for the VVC MIP cost engine.

The CU taxonomy, CU position grids and strided cost layout, generated from
partition rules (reference: constants.h:572-635, 1235, 1295, 1558).

Terminology (from the VVC/H.266 Matrix-based Intra Prediction spec):

* A frame is tiled in 128x128 CTUs.
* Inside every CTU, 47 "size groups" enumerate every candidate CU size and
  placement alignment searched by the engine.  Groups 0-27 have SizeId=2,
  28-45 SizeId=1, 46 SizeId=0 (the single 4x4 group with 1024 CUs).
* Every group's CU placement is a cartesian raster grid: the full X
  coordinate list crossed with the full Y coordinate list, raster
  (row-major) ordered.
* Groups sharing (width, height, SizeId) form one "shape class"; the engine
  runs one kernel launch per class (17 classes).
"""

from __future__ import annotations

import dataclasses
import functools

import numpy as np

CTU_SIZE = 128

# MIP algebra constants (reference: constants.cl:22-23, intra.cl:443-482).
MIP_SHIFT_MATRIX = 6
MIP_OFFSET_MATRIX = 32
SAMPLE_BITDEPTH = 10
SAMPLE_MAX = (1 << SAMPLE_BITDEPTH) - 1  # 1023
VALUE_DC = 1 << (SAMPLE_BITDEPTH - 1)  # 512, used for unavailable references

# Per-SizeId attributes (reference: constants.h:49-61).
BOUNDARY_SIZE = {0: 2, 1: 4, 2: 4}
REDUCED_PRED_SIZE = {0: 4, 1: 4, 2: 8}
PRED_MODES = {0: 16, 1: 8, 2: 6}
TEST_TRANSPOSED_MODES = True

# Supported resolutions and their CTU counts (reference: constants.h:17-23).
AVAILABLE_RES = {
    (3840, 2160): 510,
    (1920, 1080): 135,
    (1280, 720): 60,
    (832, 480): 28,
    (416, 240): 8,
}

# Low-pass filter coefficient library for the "alternative samples" regime
# (reference: constants.h:63-194).  All 8 variants draw their coefficients
# from these integer kernels; the float variants only accumulate in float.
CONV_KERNELS_3x3 = np.array(
    [
        [[1, 1, 1], [1, 1, 1], [1, 1, 1]],
        [[1, 2, 1], [2, 3, 2], [1, 2, 1]],
        [[1, 2, 1], [2, 12, 2], [1, 2, 1]],
        [[1, 1, 1], [1, 8, 1], [1, 1, 1]],
        [[1, 2, 1], [2, 4, 2], [1, 2, 1]],
    ],
    np.int32,
)

CONV_KERNELS_5x5 = np.array(
    [
        np.ones((5, 5), np.int32),
        [[1, 1, 1, 1, 1],
         [1, 1, 1, 1, 1],
         [1, 1, 5, 1, 1],
         [1, 1, 1, 1, 1],
         [1, 1, 1, 1, 1]],
        [[1, 2, 3, 2, 1],
         [2, 4, 6, 4, 2],
         [3, 6, 9, 6, 3],
         [2, 4, 6, 4, 2],
         [1, 2, 3, 2, 1]],
    ],
    np.int32,
)

# Names of the 8 filter variants selectable at runtime (reference:
# constants.h:25-34).
AVAILABLE_FILTERS = (
    "filterFrame_1d_int",
    "filterFrame_1d_float",
    "filterFrame_2d_int_quarterCtu",
    "filterFrame_2d_float_quarterCtu",
    "filterFrame_1d_int_5x5",
    "filterFrame_1d_float_5x5",
    "filterFrame_2d_int_5x5_quarterCtu",
    "filterFrame_2d_float_5x5_quarterCtu",
)


# Partition rules: every size group places its CUs on a cartesian grid
# built from four coordinate rules:
#   aligned  : 0, s, 2s, ...              (grid-aligned placements)
#   half     : s/2, s/2+2s, ...           (placements straddling grid lines)
#   q3       : 3s/2, 3s/2+4s, ...         (second-level straddles)
#   pair     : {0, 3s} + 4s*k, merged     (mixed pattern of NA_8x8_G2/G4)

def _ar(start: int, stride: int, count: int) -> tuple[int, ...]:
    return tuple(range(start, start + stride * count, stride))


def _aligned(s: int) -> tuple[int, ...]:
    return _ar(0, s, CTU_SIZE // s)


def _half(s: int) -> tuple[int, ...]:
    return _ar(s // 2, 2 * s, CTU_SIZE // (2 * s))


def _q3(s: int) -> tuple[int, ...]:
    return _ar(3 * s // 2, 4 * s, CTU_SIZE // (4 * s))


def _pair(s: int) -> tuple[int, ...]:
    return tuple(sorted(_ar(0, 4 * s, CTU_SIZE // (4 * s))
                        + _ar(3 * s, 4 * s, CTU_SIZE // (4 * s))))


@dataclasses.dataclass(frozen=True)
class SizeGroup:
    """One of the 47 CU size/alignment groups searched per CTU."""

    index: int
    name: str
    width: int
    height: int
    size_id: int
    xs: tuple[int, ...]  # CU x positions inside the CTU (full list)
    ys: tuple[int, ...]  # CU y positions inside the CTU (full list)

    @property
    def cus_per_ctu(self) -> int:
        return len(self.xs) * len(self.ys)

    @property
    def cu_columns(self) -> int:
        return len(self.xs)

    @property
    def cu_rows(self) -> int:
        return len(self.ys)

    @property
    def num_modes(self) -> int:
        """Non-transposed mode count; the engine tests 2x this."""
        return PRED_MODES[self.size_id]

    @property
    def total_modes(self) -> int:
        return self.num_modes * (2 if TEST_TRANSPOSED_MODES else 1)


def _build_groups() -> tuple[SizeGroup, ...]:
    a, h, q, p = _aligned, _half, _q3, _pair
    # (name, w, ht, size_id, xs, ys) — order matches ALL_CU_SIZE
    # (reference: constants.h:572-635).
    spec = [
        # SizeId=2, aligned
        ("AL_64x64", 64, 64, 2, a(64), a(64)),
        ("AL_32x32", 32, 32, 2, a(32), a(32)),
        ("AL_32x16", 32, 16, 2, a(32), a(16)),
        ("AL_16x32", 16, 32, 2, a(16), a(32)),
        ("AL_32x8", 32, 8, 2, a(32), a(8)),
        ("AL_8x32", 8, 32, 2, a(8), a(32)),
        ("AL_16x16", 16, 16, 2, a(16), a(16)),
        ("AL_16x8", 16, 8, 2, a(16), a(8)),
        ("AL_8x16", 8, 16, 2, a(8), a(16)),
        # SizeId=2, half-aligned / unaligned groups
        ("NA_32x16", 32, 16, 2, a(32), h(16)),
        ("NA_16x32", 16, 32, 2, h(16), a(32)),
        ("NA_32x8_G1", 32, 8, 2, a(32), h(8)),
        ("NA_32x8_G2", 32, 8, 2, a(32), q(8)),
        ("NA_8x32_G1", 8, 32, 2, h(8), a(32)),
        ("NA_8x32_G2", 8, 32, 2, q(8), a(32)),
        ("NA_16x16_G1", 16, 16, 2, h(16), a(16)),
        ("NA_16x16_G2", 16, 16, 2, a(16), h(16)),
        ("NA_16x16_G3", 16, 16, 2, h(16), h(16)),
        ("NA_16x8_G1", 16, 8, 2, h(16), a(8)),
        ("NA_16x8_G2", 16, 8, 2, a(16), h(8)),
        ("NA_16x8_G3", 16, 8, 2, a(16), q(8)),
        ("NA_16x8_G4", 16, 8, 2, h(16), h(8)),
        ("NA_16x8_G5", 16, 8, 2, h(16), q(8)),
        ("NA_8x16_G1", 8, 16, 2, h(8), a(16)),
        ("NA_8x16_G2", 8, 16, 2, a(8), h(16)),
        ("NA_8x16_G3", 8, 16, 2, q(8), a(16)),
        ("NA_8x16_G4", 8, 16, 2, q(8), h(16)),
        ("NA_8x16_G5", 8, 16, 2, h(8), h(16)),
        # SizeId=1
        ("AL_32x4", 32, 4, 1, a(32), a(4)),
        ("AL_4x32", 4, 32, 1, a(4), a(32)),
        ("AL_16x4", 16, 4, 1, a(16), a(4)),
        ("AL_4x16", 4, 16, 1, a(4), a(16)),
        ("AL_8x8", 8, 8, 1, a(8), a(8)),
        ("AL_8x4_1half", 8, 4, 1, a(8), _ar(0, 4, 16)),
        ("AL_8x4_2half", 8, 4, 1, a(8), _ar(64, 4, 16)),
        ("AL_4x8_1half", 4, 8, 1, a(4), _ar(0, 8, 8)),
        ("AL_4x8_2half", 4, 8, 1, a(4), _ar(64, 8, 8)),
        ("NA_16x4_G123", 16, 4, 1, h(16), a(4)),
        ("NA_4x16_G123", 4, 16, 1, a(4), h(16)),
        ("NA_8x8_G1", 8, 8, 1, h(8), a(8)),
        ("NA_8x8_G2", 8, 8, 1, q(8), p(8)),
        ("NA_8x8_G3", 8, 8, 1, a(8), h(8)),
        ("NA_8x8_G4", 8, 8, 1, p(8), q(8)),
        ("NA_8x8_G5", 8, 8, 1, h(8), h(8)),
        ("NA_8x4_G1", 8, 4, 1, h(8), a(4)),
        ("NA_4x8_G1", 4, 8, 1, a(4), h(8)),
        # SizeId=0
        ("AL_4x4", 4, 4, 0, a(4), a(4)),
    ]
    return tuple(
        SizeGroup(i, name, w, ht, sid, xs, ys)
        for i, (name, w, ht, sid, xs, ys) in enumerate(spec)
    )


GROUPS: tuple[SizeGroup, ...] = _build_groups()
NUM_GROUPS = len(GROUPS)  # 47


def _exclusive_prefix(values) -> np.ndarray:
    out = np.zeros(len(values) + 1, np.int64)
    np.cumsum(np.asarray(values, np.int64), out=out[1:])
    return out


# Strided layout of the per-CTU cost slab (reference: constants.h:1558):
# index [g] is the offset of group g's costs within one CTU's slab (CU
# major, mode minor); index [NUM_GROUPS] is the per-CTU total, 97840.
STRIDED_DISTORTIONS_PER_CTU = _exclusive_prefix(
    [g.cus_per_ctu * g.total_modes for g in GROUPS])


@dataclasses.dataclass(frozen=True)
class ShapeClass:
    """All groups sharing one (width, height, SizeId)."""

    width: int
    height: int
    size_id: int
    group_indices: tuple[int, ...]  # groups of this shape, ascending
    # cu_offsets[i] = start of group i's CUs within the class CU axis
    cu_offsets: tuple[int, ...]
    cus_per_ctu: int  # total CUs of this shape per CTU (all groups)

    @property
    def boundary_size(self) -> int:
        return BOUNDARY_SIZE[self.size_id]

    @property
    def reduced_pred_size(self) -> int:
        return REDUCED_PRED_SIZE[self.size_id]

    @property
    def num_modes(self) -> int:
        return PRED_MODES[self.size_id]

    @property
    def total_modes(self) -> int:
        return self.num_modes * 2


@functools.cache
def shape_classes() -> tuple[ShapeClass, ...]:
    order: list[tuple[int, int, int]] = []
    members: dict[tuple[int, int, int], list[int]] = {}
    for g in GROUPS:
        key = (g.width, g.height, g.size_id)
        if key not in members:
            members[key] = []
            order.append(key)
        members[key].append(g.index)
    out = []
    for key in order:
        idxs = tuple(members[key])
        counts = [GROUPS[i].cus_per_ctu for i in idxs]
        offs = tuple(int(v) for v in _exclusive_prefix(counts)[:-1])
        out.append(ShapeClass(key[0], key[1], key[2], idxs, offs, sum(counts)))
    return tuple(out)


def num_ctus(width: int, height: int) -> tuple[int, int, int]:
    """(ctu_cols, ctu_rows, n_ctus) for a frame size."""
    cols = -(-width // CTU_SIZE)
    rows = -(-height // CTU_SIZE)
    return cols, rows, cols * rows
