"""Static geometry plans: CU lattices, gather progressions and CU tables.

For a given frame size, every size group's CUs form a cartesian lattice of
global origin coordinates (see constants.py).  The plain path gathers a
group's samples from an edge-padded frame with strided slices along each
lattice axis; the cost kernels instead read one row per CU of a static
table, ``cu_table``, which lists every CU of a shape class with its origin
and the flat offset of its costs in the reference strided layout.
"""

from __future__ import annotations

import dataclasses
import functools

import numpy as np
import torch

from vvc_mip_gpu_tpu_torch.constants import (
    CTU_SIZE,
    GROUPS,
    STRIDED_DISTORTIONS_PER_CTU,
    ShapeClass,
    num_ctus,
    shape_classes,
)


def _progression(idx: np.ndarray) -> tuple[int, int] | None:
    """(start, step) if idx is a uniform arithmetic progression, else None."""
    if len(idx) < 2:
        return (int(idx[0]), 1)
    d = np.diff(idx)
    if (d == d[0]).all():
        return (int(idx[0]), int(d[0]))
    return None


@dataclasses.dataclass(frozen=True)
class GroupPlan:
    """Gather plan for one size group at a fixed frame size.

    CU axis convention: the plain path's dense layout is
    [ctu_row, cu_row, ctu_col, cu_col] flattened ("lattice order");
    `to_ctu_layout` permutes it into the reference's [nCTU, cuIdxInCtu]
    ordering.

    CU origin coordinates are *unclipped*: out-of-frame CUs read
    edge-replicated samples (see `padded_extent`) and are flagged by
    `valid`.  Every group's origins are a uniform progression along each
    axis except the two interleaved-lattice 8x8 groups, whose gathers
    fall back to index selects.
    """

    group_index: int
    width: int  # CU width
    height: int  # CU height
    frame_w: int
    frame_h: int
    ys: np.ndarray  # [n_rows_total] CU y origins
    xs: np.ndarray  # [n_cols_total] CU x origins
    y_prog: tuple[int, int] | None  # (start, step) if ys is uniform
    x_prog: tuple[int, int] | None
    ctu_rows: int
    ctu_cols: int
    cu_rows: int  # CU rows per CTU
    cu_cols: int

    @property
    def n_rows(self) -> int:
        return len(self.ys)

    @property
    def n_cols(self) -> int:
        return len(self.xs)

    @property
    def valid(self) -> np.ndarray:
        """[n_rows, n_cols] bool — CU fully inside the frame."""
        return ((self.ys + self.height <= self.frame_h)[:, None]
                & ((self.xs + self.width <= self.frame_w)[None, :]))

    def to_ctu_layout(self, arr: np.ndarray) -> np.ndarray:
        """Reorder leading [n_rows, n_cols] axes to [nCTU, cusPerCtu]."""
        tail = arr.shape[2:]
        a = arr.reshape(self.ctu_rows, self.cu_rows, self.ctu_cols,
                        self.cu_cols, *tail)
        a = np.moveaxis(a, 2, 1)
        return a.reshape(self.ctu_rows * self.ctu_cols,
                         self.cu_rows * self.cu_cols, *tail)

    def lattice_costs_to_ctu_mode_minor(self, costs_t: torch.Tensor):
        """Reorder a mode-minor cost block [n_rows*n_cols, 2M] (lattice
        order) into the reference layout [nCTU, cusPerCtu*2M]."""
        two_m = costs_t.shape[-1]
        a = costs_t.reshape(self.ctu_rows, self.cu_rows, self.ctu_cols,
                            self.cu_cols * two_m)
        a = a.permute(0, 2, 1, 3)
        return a.reshape(self.ctu_rows * self.ctu_cols,
                         self.cu_rows * self.cu_cols * two_m)


@dataclasses.dataclass(frozen=True)
class ClassPlan:
    """All groups of one shape class at a fixed frame size."""

    shape: ShapeClass
    groups: tuple[GroupPlan, ...]
    n_ctus: int


def _group_plan(group_index: int, frame_w: int, frame_h: int) -> GroupPlan:
    g = GROUPS[group_index]
    ctu_cols, ctu_rows, _ = num_ctus(frame_w, frame_h)
    ys = (np.arange(ctu_rows)[:, None] * CTU_SIZE
          + np.asarray(g.ys, np.int64)[None, :]).ravel()
    xs = (np.arange(ctu_cols)[:, None] * CTU_SIZE
          + np.asarray(g.xs, np.int64)[None, :]).ravel()
    return GroupPlan(
        group_index=group_index,
        width=g.width,
        height=g.height,
        frame_w=frame_w,
        frame_h=frame_h,
        ys=ys,
        xs=xs,
        y_prog=_progression(ys),
        x_prog=_progression(xs),
        ctu_rows=ctu_rows,
        ctu_cols=ctu_cols,
        cu_rows=g.cu_rows,
        cu_cols=g.cu_columns,
    )


def ctu_plan(plan: GroupPlan, ctu_idx: int) -> GroupPlan:
    """The group's lattice restricted to one CTU (raster index): its
    lattice order is the CTU layout's CU order."""
    ctu_r, ctu_c = divmod(ctu_idx, plan.ctu_cols)
    if not 0 <= ctu_r < plan.ctu_rows:
        raise ValueError(f"CTU {ctu_idx} out of range (0.."
                         f"{plan.ctu_rows * plan.ctu_cols - 1})")
    ys = plan.ys[ctu_r * plan.cu_rows:(ctu_r + 1) * plan.cu_rows]
    xs = plan.xs[ctu_c * plan.cu_cols:(ctu_c + 1) * plan.cu_cols]
    return dataclasses.replace(plan, ys=ys, xs=xs, y_prog=_progression(ys),
                               x_prog=_progression(xs), ctu_rows=1,
                               ctu_cols=1)


def _axis_extent(prog, idx, n: int, win: int) -> int:
    """Rows/cols the padded frame must provide for this gather."""
    if prog is not None:
        o, s = prog
        # the block-slice gather reads [o, o + n*max(s, win))
        return o + n * max(s, win) if n > 1 else o + win
    return int(idx[-1]) + win


@functools.cache
def padded_extent(frame_w: int, frame_h: int) -> tuple[int, int]:
    """(Hp, Wp): frame extent, edge-replication padded, covering every
    group's slice-based gather (out-of-frame CUs read replicated samples
    and are masked invalid)."""
    hp, wp = frame_h, frame_w
    for i in range(len(GROUPS)):
        p = _group_plan(i, frame_w, frame_h)
        hp = max(hp, _axis_extent(p.y_prog, p.ys, p.n_rows, p.height))
        wp = max(wp, _axis_extent(p.x_prog, p.xs, p.n_cols, p.width))
    return hp, wp


@functools.cache
def class_plans(frame_w: int, frame_h: int) -> tuple[ClassPlan, ...]:
    _, _, n = num_ctus(frame_w, frame_h)
    return tuple(
        ClassPlan(
            shape=cl,
            groups=tuple(_group_plan(i, frame_w, frame_h)
                         for i in cl.group_indices),
            n_ctus=n,
        )
        for cl in shape_classes()
    )


def cu_table(cplan: ClassPlan) -> np.ndarray:
    """int32 [nCU, 3] rows (y0, x0, flat output offset) for every CU of a
    shape class: groups in class order, then CTUs in raster order, then
    the group's CUs in raster order inside the CTU.  The offset is
    ``ctu * 97840 + STRIDED_DISTORTIONS_PER_CTU[g] + cu * 2M``, where the
    CU's 2M mode costs start in one frame's [nCTU, 97840] cost slab; the
    order makes consecutive rows' cost runs contiguous within a CTU."""
    per_ctu = int(STRIDED_DISTORTIONS_PER_CTU[-1])
    two_m = cplan.shape.total_modes
    parts = []
    for gp in cplan.groups:
        g = GROUPS[gp.group_index]
        ctu_r, cu_r, ctu_c, cu_c = np.meshgrid(
            np.arange(gp.ctu_rows), np.arange(gp.cu_rows),
            np.arange(gp.ctu_cols), np.arange(gp.cu_cols), indexing="ij")
        # [ctu_row, ctu_col, cu_row, cu_col]: CTU raster, then CU raster
        order = (0, 2, 1, 3)
        ctu_r, cu_r, ctu_c, cu_c = (a.transpose(order).ravel()
                                    for a in (ctu_r, cu_r, ctu_c, cu_c))
        y0 = gp.ys[ctu_r * gp.cu_rows + cu_r]
        x0 = gp.xs[ctu_c * gp.cu_cols + cu_c]
        ctu = ctu_r * gp.ctu_cols + ctu_c
        cu = cu_r * gp.cu_cols + cu_c
        off = (ctu * per_ctu + int(STRIDED_DISTORTIONS_PER_CTU[g.index])
               + cu * two_m)
        parts.append(np.stack([y0, x0, off], axis=1))
    table = np.concatenate(parts, axis=0)
    if table.max() >= 2 ** 31:
        raise ValueError("frame too large: per-frame cost offsets exceed "
                         "int32")
    return table.astype(np.int32)
