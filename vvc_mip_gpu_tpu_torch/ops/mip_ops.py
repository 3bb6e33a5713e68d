"""Plain PyTorch MIP pipeline: the cost kernels' reference semantics.

Every tensor keeps the CU axis last ("SoA"), in lattice order (CTU row x
CU row x CTU column x CU column per group, the groups of a class
concatenated).  All arithmetic is exact integer arithmetic, bit-identical
to the reference (intra.cl:96-1171): the prediction contraction runs as a
float64 product, which is exact here (every product < 2^18, every sum
< 2^23), never in float32.  These functions run on any device; the engine
reaches them through the cost kernels' plain versions (ops/mip_cost.py).
"""

from __future__ import annotations

import numpy as np
import torch

from vvc_mip_gpu_tpu_torch import mip_weights
from vvc_mip_gpu_tpu_torch.constants import (
    MIP_OFFSET_MATRIX,
    MIP_SHIFT_MATRIX,
    REDUCED_PRED_SIZE,
    SAMPLE_MAX,
    VALUE_DC,
)
from vvc_mip_gpu_tpu_torch.ops.geometry import GroupPlan


def _shift(prog, by: int):
    return None if prog is None else (prog[0] + by, prog[1])


def _index(idx, device) -> torch.Tensor:
    return torch.as_tensor(np.asarray(idx, np.int64), device=device)


def _mask(m, device) -> torch.Tensor:
    return torch.as_tensor(np.asarray(m, bool), device=device)


def _row_strided(a: torch.Tensor, prog, idx, n: int) -> torch.Tensor:
    """Rows {idx_k} of [R, C] -> [n, C] (strided slice when uniform)."""
    if prog is not None:
        o, s = prog
        return a[o:o + (n - 1) * s + 1:s]
    return a.index_select(0, _index(idx, a.device))


def _col_strided(a: torch.Tensor, prog, idx, n: int) -> torch.Tensor:
    """Columns {idx_k} of [R, C] -> [R, n]."""
    if prog is not None:
        o, s = prog
        return a[:, o:o + (n - 1) * s + 1:s]
    return a.index_select(1, _index(idx, a.device))


def _row_blocks(a: torch.Tensor, prog, idx, n: int, h: int) -> torch.Tensor:
    """Row windows {idx_k .. idx_k+h-1} of [R, C] -> [n, h, C].

    With a uniform lattice this is a contiguous slice + reshape (+ a trim
    when the lattice step exceeds the window); only the two interleaved
    8x8 groups fall back to an index select.
    """
    if prog is not None:
        o, s = prog
        if s == h or n == 1:
            return a[o:o + n * h].reshape(n, h, a.shape[1])
        if s < h:
            raise ValueError(f"overlapping lattice (stride {s} < window {h})")
        return a[o:o + n * s].reshape(n, s, a.shape[1])[:, :h]
    ridx = (np.asarray(idx)[:, None] + np.arange(h)[None, :]).ravel()
    return a.index_select(0, _index(ridx, a.device)).reshape(n, h, a.shape[1])


def _col_blocks(a: torch.Tensor, prog, idx, n: int, w: int) -> torch.Tensor:
    """Column windows of [..., C] -> [..., n, w]."""
    lead = a.shape[:-1]
    if prog is not None:
        o, s = prog
        if s == w or n == 1:
            return a[..., o:o + n * w].reshape(*lead, n, w)
        if s < w:
            raise ValueError(f"overlapping lattice (stride {s} < window {w})")
        return a[..., o:o + n * s].reshape(*lead, n, s)[..., :w]
    cidx = (np.asarray(idx)[:, None] + np.arange(w)[None, :]).ravel()
    return a.index_select(a.ndim - 1, _index(cidx, a.device)).reshape(
        *lead, n, w)


def pad_edge(a: torch.Tensor, rows: int, cols: int) -> torch.Tensor:
    """Pad [R, C] to [rows, cols] by replicating the last row/column."""
    if rows > a.shape[0]:
        a = torch.cat([a, a[-1:].expand(rows - a.shape[0], a.shape[1])], 0)
    if cols > a.shape[1]:
        a = torch.cat([a, a[:, -1:].expand(a.shape[0], cols - a.shape[1])],
                      1)
    return a


def pad_reference(ref: torch.Tensor, halo_row: torch.Tensor, rows: int,
                  cols: int) -> torch.Tensor:
    """The [1+rows, 1+cols] reference slab ``gather_boundaries`` reads:
    the halo row on top, the [H, W] reference below, edge-padded to
    [rows, cols], with the first column duplicated on the left."""
    ref_ext = torch.cat([pad_edge(halo_row[None], 1, cols),
                         pad_edge(ref, rows, cols)], 0)
    return torch.cat([ref_ext[:, :1], ref_ext], 1)


def gather_boundaries(ref_pad: torch.Tensor, plan: GroupPlan, is_top: bool):
    """Top/left boundaries in SoA layout: ([w, nCU], [h, nCU]).

    ``ref_pad``: [1+Hp, 1+Wp] padded reference slab — row 0 is the halo row
    above the slab, column 0 duplicates the slab's first column (read only
    by frame-left CUs, whose values the VVC edge rule overwrites), and the
    bottom/right edges are replication-padded to the `padded_extent`.
    VVC edge rules (reference: intra.cl:96-107, 232-243).
    """
    w, h = plan.width, plan.height
    n_rows, n_cols = plan.n_rows, plan.n_cols
    dev = ref_pad.device

    # ---- top: the row above each CU row (ref_pad row y == frame row y-1),
    # sliced per CU column window
    top_rows = _row_strided(ref_pad, plan.y_prog, plan.ys, n_rows)
    ref_t = _col_blocks(top_rows, _shift(plan.x_prog, 1), plan.xs + 1,
                        n_cols, w)  # [n_rows, n_cols, w]
    ref_t = ref_t.movedim(2, 0).reshape(w, n_rows * n_cols)
    # frame-top rule: all samples <- frame row 0 sample left of the CU,
    # DC at the frame corner
    pad_cols = torch.where(_mask(plan.xs > 0, dev),
                           ref_pad[1, _index(plan.xs, dev)], VALUE_DC)
    pad_t = pad_cols.repeat(n_rows)  # [nCU], varies by column only
    fix_t = _mask(np.repeat(plan.ys == 0, n_cols) & bool(is_top), dev)
    ref_t = torch.where(fix_t[None, :], pad_t[None, :], ref_t)

    # ---- left: the column left of each CU column (ref_pad col x == frame
    # col x-1), sliced per CU row window
    left_cols = _col_strided(ref_pad, plan.x_prog, plan.xs, n_cols)
    ref_l = _row_blocks(left_cols, _shift(plan.y_prog, 1), plan.ys + 1,
                        n_rows, h)  # [n_rows, h, n_cols]
    ref_l = ref_l.movedim(1, 0).reshape(h, n_rows * n_cols)
    # frame-left rule: all samples <- sample above the CU (via the halo
    # row), DC at the frame corner
    pad_rows = torch.where(_mask((plan.ys == 0) & bool(is_top), dev),
                           VALUE_DC, ref_pad[_index(plan.ys, dev), 1])
    pad_l = pad_rows.repeat_interleave(n_cols)  # [nCU], varies by row only
    fix_l = _mask(np.tile(plan.xs == 0, n_rows), dev)
    ref_l = torch.where(fix_l[None, :], pad_l[None, :], ref_l)
    return ref_t, ref_l


def gather_originals(frame_pad: torch.Tensor, plan: GroupPlan) -> torch.Tensor:
    """Original CU samples in SoA layout: [h*w, nCU], sample axis raster.

    ``frame_pad``: [Hp, Wp] distortion-target frame, edge-replication
    padded to the `padded_extent`.
    """
    w, h = plan.width, plan.height
    rows = _row_blocks(frame_pad, plan.y_prog, plan.ys, plan.n_rows, h)
    tile = _col_blocks(rows, plan.x_prog, plan.xs, plan.n_cols, w)
    tile = tile.permute(1, 3, 0, 2)  # [h, w, n_rows, n_cols]
    return tile.reshape(h * w, plan.n_rows * plan.n_cols)


def reduce_boundary(samples: torch.Tensor, bnd_size: int) -> torch.Tensor:
    """Downsample-average along the sample (leading) axis."""
    n = samples.shape[0]
    ds = n // bnd_size
    if ds == 1:
        return samples
    log2 = ds.bit_length() - 1
    off = 1 << (log2 - 1)
    grouped = samples.reshape(bnd_size, ds, -1)
    return (grouped.sum(1, dtype=torch.int32) + off) >> log2


def _wing_prediction(mat: torch.Tensor, b_first, b_second,
                     size_id: int) -> torch.Tensor:
    """One wing's all-mode prediction [M, S, nCU] int32 from the int32
    weights ``mat`` [M, S, C]."""
    bnd = torch.cat([b_first, b_second], 0).to(torch.int32)
    first = bnd[:1]  # [1, nCU]
    row0 = (torch.zeros_like(first) if size_id == 2
            else VALUE_DC - first)
    off = torch.cat([row0, bnd[1:] - first], 0)  # [C, nCU]
    offset_term = ((1 << (MIP_SHIFT_MATRIX - 1))
                   - MIP_OFFSET_MATRIX * off.sum(0, dtype=torch.int32))
    m, s, c = mat.shape
    acc = (mat.reshape(m * s, c).to(torch.float64)
           @ off.to(torch.float64)).to(torch.int32)  # exact, see module doc
    pred = ((acc + offset_term[None]) >> MIP_SHIFT_MATRIX) + first
    return pred.clamp(0, SAMPLE_MAX).reshape(m, s, -1)


def reduced_prediction_all_modes(red_t, red_l, size_id: int,
                                 weights: torch.Tensor | None = None):
    """All-mode reduced prediction [2M, S, nCU] int32 (S = R*R raster);
    modes 0..M-1 are the normal wing, M..2M-1 the transposed wing, whose
    output samples are the r x r transposition (reference:
    intra.cl:485-539).  ``weights``: the [M, S, C] int32 table of
    ``mip_weights.weights_from_numpy``; the package's own by default."""
    r = REDUCED_PRED_SIZE[size_id]
    if weights is None:
        weights = torch.from_numpy(mip_weights.padded_matrix(size_id)).to(
            red_t.device)
    tperm = torch.arange(r * r, device=weights.device).reshape(r, r).T
    pred_n = _wing_prediction(weights, red_t, red_l, size_id)
    pred_t = _wing_prediction(weights[:, tperm.reshape(-1)], red_l, red_t,
                              size_id)
    return torch.cat([pred_n, pred_t], 0)


def _interp(before, after, up: int, pos):
    """Linear interpolation tap with exact reference rounding."""
    if up == 1:
        return after
    log2 = up.bit_length() - 1
    return ((up - pos) * before + pos * after + (1 << (log2 - 1))) >> log2


def upsample_all(pred, ref_t, ref_l, w: int, h: int, r: int):
    """Upsample [2M, R*R, nCU] -> [2M, h, w, nCU] int32: horizontal pass
    first, anchored on the left boundary at rows (k+1)*up_v-1, then the
    vertical pass against the top boundary (intra.cl:815-895)."""
    two_m, _, n = pred.shape
    up_h = w // r
    up_v = h // r
    pred = pred.reshape(two_m, r, r, n).to(torch.int32)
    dev = pred.device
    if up_h == 1:
        anchors = pred
    else:
        lead = ref_l[up_v - 1::up_v].to(torch.int32)[None, :, None, :]
        ext = torch.cat([lead.expand(two_m, r, 1, n), pred], 2)
        before = ext[:, :, :-1].repeat_interleave(up_h, 2)
        after = ext[:, :, 1:].repeat_interleave(up_h, 2)
        o = (torch.arange(w, device=dev) % up_h + 1).reshape(1, 1, w, 1)
        anchors = _interp(before, after, up_h, o)
    if up_v == 1:
        return anchors
    top = ref_t.to(torch.int32)[None, None].expand(two_m, 1, w, n)
    ext2 = torch.cat([top, anchors], 1)  # [2M, R+1, w, nCU]
    before = ext2[:, :-1].repeat_interleave(up_v, 1)
    after = ext2[:, 1:].repeat_interleave(up_v, 1)
    ov = (torch.arange(h, device=dev) % up_v + 1).reshape(1, h, 1, 1)
    return _interp(before, after, up_v, ov)


def _hadamard4(x: torch.Tensor, dim: int) -> torch.Tensor:
    """4-point Hadamard butterfly along ``dim`` (rows [1111, 11-1-1,
    1-1-11, 1-11-1])."""
    x0, x1, x2, x3 = x.unbind(dim)
    s0, s1 = x0 + x1, x2 + x3
    d0, d1 = x0 - x1, x2 - x3
    return torch.stack([s0 + s1, s0 - s1, d0 - d1, d0 + d1], dim)


def distortion(orig, pred, h: int, w: int):
    """(SAD, SATD): [2M, nCU] int32 each.

    ``orig``: [h*w, nCU], sample axis raster.  ``pred``: upsampled
    [2M, h, w, nCU] raster, or reduced [2M, 16, nCU] for SizeId 0 (4x4:
    raster == 4x4-block order).  SATD is the VTM mean-scaled 4x4 Hadamard
    sum, (sum|H d H^T| - |dc| + (|dc| >> 2) + 1) >> 1 per block.
    """
    two_m = pred.shape[0]
    n = pred.shape[-1]
    pred = pred.reshape(two_m, h, w, n)
    diff = orig.reshape(h, w, n).to(torch.int32)[None] - pred.to(torch.int32)
    sad = diff.abs().sum((1, 2), dtype=torch.int32)
    blocks = diff.reshape(two_m, h // 4, 4, w // 4, 4, n)
    t = _hadamard4(_hadamard4(blocks, 2), 4).abs()
    dc = t[:, :, 0, :, 0]  # [2M, h/4, w/4, nCU]
    block_satd = (t.sum((2, 4), dtype=torch.int32) - dc + (dc >> 2) + 1) >> 1
    return sad, block_satd.sum((1, 2), dtype=torch.int32)
