"""Vectorized NumPy golden model of the full-frame MIP cost search.

The port's own copy of the JAX package's golden/reference_model.py (NumPy
only, int64 throughout, the same arithmetic and the same clipping of
out-of-frame CU coordinates): the oracle that holds the port's cost
kernels on the card (chip_smoke.py phase (k)).  It takes the constants
and the weights of the port and nothing else of it (no CU tables, group
plans, validity rules or boundary code of ``ops/``), so a fault there
shows against it.  No path of the CLI or the bench runs it.

Structured per size group the way the reference engine's kernels are
(reference: intra.cl:17-1171), validated CU by CU against the pure-Python
scalar oracle (golden/scalar_oracle.py).  Outputs per-(CTU, CU, mode) SAD
/ SATD / minSadHad plus a validity mask, and flattens them into the
reference's strided per-CTU distortion layout (reference: constants.h:1558,
main_aux_functions.h:735-798).
"""

from __future__ import annotations

import dataclasses

import numpy as np

from vvc_mip_gpu_tpu_torch import mip_weights
from vvc_mip_gpu_tpu_torch.constants import (
    BOUNDARY_SIZE,
    CTU_SIZE,
    GROUPS,
    MIP_OFFSET_MATRIX,
    MIP_SHIFT_MATRIX,
    PRED_MODES,
    REDUCED_PRED_SIZE,
    SAMPLE_MAX,
    STRIDED_DISTORTIONS_PER_CTU,
    VALUE_DC,
    num_ctus,
)

_HADAMARD4 = np.array(
    [[1, 1, 1, 1], [1, 1, -1, -1], [1, -1, -1, 1], [1, -1, 1, -1]], np.int64)


@dataclasses.dataclass
class GroupCosts:
    """Costs of one size group: arrays of shape [nCTU, cusPerCtu, 2*modes]."""

    sad: np.ndarray
    satd: np.ndarray
    min_sad_had: np.ndarray
    valid: np.ndarray  # [nCTU, cusPerCtu] bool — CU fully inside the frame


def global_positions(group_idx: int, width: int, height: int):
    """Absolute (x, y) of every CU of a group: arrays [nCTU, cusPerCtu].

    A group's CUs are the raster (y-major) product of its x and y lists."""
    g = GROUPS[group_idx]
    cols, rows, _ = num_ctus(width, height)
    gx, gy = np.meshgrid(np.asarray(g.xs), np.asarray(g.ys))
    ctu_x = (np.arange(cols * rows) % cols) * CTU_SIZE
    ctu_y = (np.arange(cols * rows) // cols) * CTU_SIZE
    return (ctu_x[:, None] + gx.ravel()[None, :],
            ctu_y[:, None] + gy.ravel()[None, :])


def extract_boundaries(ref_frame: np.ndarray, xs: np.ndarray, ys: np.ndarray,
                       w: int, h: int):
    """Complete top/left boundaries for CUs at (xs, ys); [..., w] / [..., h].

    Implements the VVC padding rules (reference: intra.cl:96-107, 232-243):
    row above / column left when available; at the frame's top (left) edge
    every sample is the single sample left of (above) the CU's first sample;
    DC at the top-left corner.  Coordinates are clipped so out-of-frame CUs
    produce deterministic (masked-out later) values.
    """
    fh, fw = ref_frame.shape
    xc = np.clip(xs, 0, fw - w)
    yc = np.clip(ys, 0, fh - h)
    dx = np.arange(w)
    dy = np.arange(h)
    top_rows = ref_frame[np.maximum(yc - 1, 0)[..., None], xc[..., None] + dx]
    top_pad = np.where(xc > 0, ref_frame[0, np.maximum(xc - 1, 0)], VALUE_DC)
    ref_t = np.where((yc > 0)[..., None], top_rows, top_pad[..., None])
    left_cols = ref_frame[yc[..., None] + dy, np.maximum(xc - 1, 0)[..., None]]
    left_pad = np.where(yc > 0, ref_frame[np.maximum(yc - 1, 0), 0], VALUE_DC)
    ref_l = np.where((xc > 0)[..., None], left_cols, left_pad[..., None])
    return ref_t.astype(np.int64), ref_l.astype(np.int64)


def reduce_boundary(samples: np.ndarray, bnd_size: int) -> np.ndarray:
    """Downsample-average along the last axis; reference: intra.cl:127-140."""
    n = samples.shape[-1]
    ds = n // bnd_size
    if ds == 1:
        return samples.copy()
    log2 = ds.bit_length() - 1
    off = 1 << (log2 - 1)
    grouped = samples.reshape(samples.shape[:-1] + (bnd_size, ds))
    return (grouped.sum(-1) + off) >> log2


def reduced_prediction_all_modes(red_t: np.ndarray, red_l: np.ndarray,
                                 size_id: int) -> np.ndarray:
    """Reduced prediction for all 2*num_modes modes; [..., 2M, R, R].

    Mode axis ordering matches the reference: non-transposed modes first,
    then transposed (reference: intra.cl:415-418).
    """
    r = REDUCED_PRED_SIZE[size_id]
    mat = mip_weights.padded_matrix(size_id).astype(np.int64)  # [M, S, C]
    bnd = np.stack([
        np.concatenate([red_t, red_l], -1),
        np.concatenate([red_l, red_t], -1),
    ], axis=-2)  # [..., 2(transp), C]
    first = bnd[..., :1]
    off = bnd - first
    s0 = 0 if size_id == 2 else (1 << 9) - first[..., 0]
    off[..., 0] = s0
    offset_term = ((1 << (MIP_SHIFT_MATRIX - 1))
                   - MIP_OFFSET_MATRIX * off.sum(-1))  # [..., 2]
    acc = np.einsum("...tc,msc->...tms", off, mat)  # [..., 2, M, S]
    pred = (((acc + offset_term[..., None, None]) >> MIP_SHIFT_MATRIX)
            + first[..., None])
    pred = np.clip(pred, 0, SAMPLE_MAX)
    pred = pred.reshape(pred.shape[:-1] + (r, r))  # [..., 2, M, R, R]
    # Transposed modes write the transposed grid (reference: intra.cl:485-487)
    pred_t = np.swapaxes(pred, -1, -2)
    pred = np.where(
        (np.arange(2) == 1)[:, None, None, None], pred_t, pred)
    m = PRED_MODES[size_id]
    return pred.reshape(pred.shape[:-4] + (2 * m, r, r))


def _interp_axis(before: np.ndarray, after: np.ndarray, up: int,
                 pos: np.ndarray) -> np.ndarray:
    """Vectorized linear interpolation tap; reference: intra.cl:826-841."""
    if up == 1:
        return after
    log2 = up.bit_length() - 1
    rnd = 1 << (log2 - 1)
    return ((up - pos) * before + pos * after + rnd) >> log2


def upsample_all(pred: np.ndarray, ref_t: np.ndarray, ref_l: np.ndarray,
                 w: int, h: int) -> np.ndarray:
    """Upsample reduced predictions [..., 2M, R, R] to [..., 2M, h, w].

    reference: intra.cl:815-895 — horizontal pass on anchor rows against the
    left boundary, then vertical pass against the top boundary.
    """
    r = pred.shape[-1]
    up_h = w // r
    up_v = h // r
    # Left-boundary anchor samples, broadcast over the mode axis and
    # prepended as "column -1" of each reduced-prediction row.
    ref_l_anchor = ref_l[..., None, up_v - 1::up_v]  # [..., 1, R]
    lead = np.broadcast_to(ref_l_anchor, pred.shape[:-2] + (r,))[..., None]
    ext = np.concatenate([lead, pred], axis=-1)  # [..., 2M, R, R+1]
    x = np.arange(w)
    j = x // up_h
    o = x % up_h + 1
    anchors = _interp_axis(ext[..., j], ext[..., j + 1], up_h, o)
    # Vertical: prepend the top boundary as row 0.
    top = np.broadcast_to(ref_t[..., None, None, :],
                          anchors.shape[:-2] + (1, w))
    ext2 = np.concatenate([top, anchors], axis=-2)  # [..., 2M, R+1, w]
    y = np.arange(h)
    k = y // up_v
    ov = (y % up_v + 1)[:, None]
    return _interp_axis(ext2[..., k, :], ext2[..., k + 1, :], up_v, ov)


def gather_originals(frame: np.ndarray, xs: np.ndarray, ys: np.ndarray,
                     w: int, h: int) -> np.ndarray:
    """Original samples of CUs at (xs, ys); [..., h, w] (coords clipped)."""
    fh, fw = frame.shape
    xc = np.clip(xs, 0, fw - w)
    yc = np.clip(ys, 0, fh - h)
    return frame[yc[..., None, None] + np.arange(h)[:, None],
                 xc[..., None, None] + np.arange(w)[None, :]].astype(np.int64)


def distortion(orig: np.ndarray, pred: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
    """(SAD, SATD) over the trailing [h, w] axes.

    SATD: per-4x4-block two-sided Hadamard with VTM's JVET_R0164 mean-scaled
    correction (reference: kernel_aux_functions.cl:142-249).
    """
    diff = orig - pred
    sad = np.abs(diff).sum((-1, -2))
    h, w = diff.shape[-2:]
    blocks = diff.reshape(diff.shape[:-2] + (h // 4, 4, w // 4, 4))
    blocks = np.moveaxis(blocks, -2, -3)  # [..., h/4, w/4, 4, 4]
    t = np.einsum("ik,...kl,jl->...ij", _HADAMARD4, blocks, _HADAMARD4)
    dc = np.abs(t[..., 0, 0])
    block_satd = np.abs(t).sum((-1, -2)) - dc + (dc >> 2)
    block_satd = (block_satd + 1) >> 1
    satd = block_satd.sum((-1, -2))
    return sad, satd


def group_costs(frame: np.ndarray, ref_frame: np.ndarray,
                group_idx: int) -> GroupCosts:
    """Full mode-search costs for one size group over the whole frame."""
    g = GROUPS[group_idx]
    fh, fw = frame.shape
    xs, ys = global_positions(group_idx, fw, fh)
    valid = (xs + g.width <= fw) & (ys + g.height <= fh)
    ref_t, ref_l = extract_boundaries(ref_frame, xs, ys, g.width, g.height)
    red_t = reduce_boundary(ref_t, BOUNDARY_SIZE[g.size_id])
    red_l = reduce_boundary(ref_l, BOUNDARY_SIZE[g.size_id])
    pred = reduced_prediction_all_modes(red_t, red_l, g.size_id)
    if g.size_id > 0:
        pred = upsample_all(pred, ref_t, ref_l, g.width, g.height)
    orig = gather_originals(frame, xs, ys, g.width, g.height)
    sad, satd = distortion(orig[..., None, :, :], pred)
    return GroupCosts(sad, satd, np.minimum(2 * sad, satd), valid)


def frame_costs(frame: np.ndarray,
                ref_frame: np.ndarray | None = None) -> dict[int, GroupCosts]:
    """Costs for all 47 size groups.  ``ref_frame`` (the boundary-sample
    source) defaults to ``frame``; pass the filtered frame for the
    alternative-samples regime (reference: main.cpp:818-822)."""
    if ref_frame is None:
        ref_frame = frame
    return {g.index: group_costs(frame, ref_frame, g.index) for g in GROUPS}


def flatten_strided(costs: dict[int, GroupCosts], field: str) -> np.ndarray:
    """Flatten per-group costs into the reference's per-CTU strided layout:
    [nCTU, STRIDED_DISTORTIONS_PER_CTU[-1]] with index
    group_offset + cu*2M + mode (reference: intra.cl:1144-1148)."""
    n_ctu = next(iter(costs.values())).sad.shape[0]
    out = np.zeros((n_ctu, int(STRIDED_DISTORTIONS_PER_CTU[-1])), np.int64)
    for g in GROUPS:
        arr = getattr(costs[g.index], field)
        start = int(STRIDED_DISTORTIONS_PER_CTU[g.index])
        out[:, start:start + arr[0].size] = arr.reshape(n_ctu, -1)
    return out
