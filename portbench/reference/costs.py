"""Plain reference of the MIP mode search, in PyTorch, on any device.

The arithmetic of the NumPy golden model (the reference engine's
initBoundaries -> MIP_ReducedPred -> upsampleDistortion pipeline,
intra.cl:17-1171), written with plain torch operations so that the
benchmark can judge a run's outputs on the card after its window.  It
computes, for chosen CTUs of chosen frames, every CU of every size group
and every (transposed and non-transposed) mode: SAD, SATD and minSadHad,
laid out in the reference's strided per-CTU slab, with a mask of the CUs
that lie wholly inside the frame.  Out-of-frame CUs read clipped
coordinates here (the program replicates edges instead), so only valid
CUs compare.

All arithmetic is in ``dtype``: int64 for the reference, a narrower type
for the control that a lower precision has to fail.
"""

from __future__ import annotations

import numpy as np
import torch

from portbench.reference.tables import (
    BOUNDARY_SIZE,
    CTU_SIZE,
    GROUP_OFFSETS,
    GROUPS,
    MIP_OFFSET_MATRIX,
    MIP_SHIFT_MATRIX,
    PER_CTU,
    PRED_MODES,
    REDUCED_PRED_SIZE,
    SAMPLE_MAX,
    VALUE_DC,
    mip_matrices,
    num_ctus,
)

_HADAMARD4 = ((1, 1, 1, 1), (1, 1, -1, -1), (1, -1, -1, 1), (1, -1, 1, -1))


def _positions(group, width: int, ctus: torch.Tensor):
    """Absolute (x, y) of the group's CUs in each CTU: [P, nCU] each."""
    cols = num_ctus(width, CTU_SIZE)[0]
    gy, gx = torch.meshgrid(torch.tensor(group.ys, device=ctus.device),
                            torch.tensor(group.xs, device=ctus.device),
                            indexing="ij")
    x = (ctus % cols)[:, None] * CTU_SIZE + gx.reshape(1, -1)
    y = (ctus // cols)[:, None] * CTU_SIZE + gy.reshape(1, -1)
    return x, y


def _boundaries(ref, fi, xs, ys, w: int, h: int):
    """Top [P, n, w] and left [P, n, h] boundaries with the VVC padding
    rules (intra.cl:96-107, 232-243): at the frame's top (left) edge every
    sample is the one left of (above) the CU's first sample, DC at the
    corner; coordinates clipped."""
    fh, fw = ref.shape[-2:]
    xc = xs.clamp(0, fw - w)
    yc = ys.clamp(0, fh - h)
    f = fi[:, None, None]
    dx = torch.arange(w, device=ref.device)
    dy = torch.arange(h, device=ref.device)
    top_rows = ref[f, (yc - 1).clamp(min=0)[..., None], xc[..., None] + dx]
    top_pad = torch.where(xc > 0, ref[fi[:, None], 0, (xc - 1).clamp(min=0)],
                          VALUE_DC)
    ref_t = torch.where((yc > 0)[..., None], top_rows, top_pad[..., None])
    left_cols = ref[f, yc[..., None] + dy, (xc - 1).clamp(min=0)[..., None]]
    left_pad = torch.where(yc > 0, ref[fi[:, None], (yc - 1).clamp(min=0), 0],
                           VALUE_DC)
    ref_l = torch.where((xc > 0)[..., None], left_cols, left_pad[..., None])
    return ref_t, ref_l


def _reduce(samples, bnd: int, dtype):
    """Downsample-average along the last axis (intra.cl:127-140)."""
    n = samples.shape[-1]
    ds = n // bnd
    if ds == 1:
        return samples
    log2 = ds.bit_length() - 1
    grouped = samples.reshape(samples.shape[:-1] + (bnd, ds))
    return (grouped.sum(-1, dtype=dtype) + (1 << (log2 - 1))) >> log2


def _reduced_prediction(red_t, red_l, size_id: int, dtype):
    """[..., 2M, R, R]: non-transposed modes first, then transposed
    (intra.cl:415-487)."""
    r = REDUCED_PRED_SIZE[size_id]
    mat = torch.from_numpy(mip_matrices()[size_id]).to(red_t.device, dtype)
    bnd = torch.stack([torch.cat([red_t, red_l], -1),
                       torch.cat([red_l, red_t], -1)], dim=-2)  # [..., 2, C]
    first = bnd[..., :1]
    off = bnd - first
    if size_id == 2:
        off[..., 0] = 0
    else:
        off[..., 0] = (1 << 9) - first[..., 0]
    offset_term = ((1 << (MIP_SHIFT_MATRIX - 1))
                   - MIP_OFFSET_MATRIX * off.sum(-1, dtype=dtype))  # [..., 2]
    acc = torch.zeros(off.shape[:-1] + mat.shape[:2], dtype=dtype,
                      device=off.device)  # [..., 2, M, S]
    for c in range(mat.shape[2]):
        acc += off[..., c, None, None] * mat[:, :, c]
    pred = (((acc + offset_term[..., None, None]) >> MIP_SHIFT_MATRIX)
            + first[..., None])
    pred = pred.clamp(0, SAMPLE_MAX).to(dtype)
    pred = pred.reshape(pred.shape[:-1] + (r, r))  # [..., 2, M, R, R]
    pred = torch.stack([pred[..., 0, :, :, :],
                        pred[..., 1, :, :, :].transpose(-1, -2)], dim=-4)
    return pred.reshape(pred.shape[:-4] + (2 * PRED_MODES[size_id], r, r))


def _interp(before, after, up: int, pos):
    """Linear interpolation tap (intra.cl:826-841)."""
    if up == 1:
        return after
    log2 = up.bit_length() - 1
    return ((up - pos) * before + pos * after + (1 << (log2 - 1))) >> log2


def _upsample(pred, ref_t, ref_l, w: int, h: int):
    """[..., 2M, R, R] -> [..., 2M, h, w] (intra.cl:815-895): horizontal
    on anchor rows against the left boundary, then vertical against the
    top boundary."""
    r = pred.shape[-1]
    up_h, up_v = w // r, h // r
    dev = pred.device
    anchor = ref_l[..., None, up_v - 1::up_v]  # [..., 1, R]
    lead = anchor.expand(pred.shape[:-2] + (r,))[..., None]
    ext = torch.cat([lead, pred], dim=-1)  # [..., 2M, R, R+1]
    x = torch.arange(w, device=dev)
    j = x // up_h
    o = (x % up_h + 1).to(pred.dtype)
    rows = _interp(ext[..., j], ext[..., j + 1], up_h, o)  # [..., R, w]
    top = ref_t[..., None, None, :].expand(rows.shape[:-2] + (1, w))
    ext2 = torch.cat([top, rows], dim=-2)  # [..., 2M, R+1, w]
    y = torch.arange(h, device=dev)
    k = y // up_v
    ov = (y % up_v + 1).to(pred.dtype)[:, None]
    return _interp(ext2[..., k, :], ext2[..., k + 1, :], up_v, ov)


def _originals(frames, fi, xs, ys, w: int, h: int):
    """[P, n, h, w] original samples of the CUs (coordinates clipped)."""
    fh, fw = frames.shape[-2:]
    xc = xs.clamp(0, fw - w)
    yc = ys.clamp(0, fh - h)
    dy = torch.arange(h, device=frames.device)[:, None]
    dx = torch.arange(w, device=frames.device)[None, :]
    return frames[fi[:, None, None, None], yc[..., None, None] + dy,
                  xc[..., None, None] + dx]


def _distortion(orig, pred, dtype):
    """(SAD, SATD) over the trailing [h, w] axes; SATD per 4x4 block, the
    two-sided Hadamard with VTM's JVET_R0164 DC correction
    (kernel_aux_functions.cl:142-249)."""
    diff = orig - pred
    sad = diff.abs().sum((-1, -2), dtype=dtype)
    h, w = diff.shape[-2:]
    blocks = diff.reshape(diff.shape[:-2] + (h // 4, 4, w // 4, 4))
    blocks = blocks.movedim(-2, -3)  # [..., h/4, w/4, 4, 4]
    had = torch.tensor(_HADAMARD4, dtype=dtype, device=diff.device)
    half = (had[:, :, None] * blocks[..., None, :, :]).sum(-2, dtype=dtype)
    t = (half[..., :, None, :] * had).sum(-1, dtype=dtype)
    dc = t[..., 0, 0].abs()
    block = t.abs().sum((-1, -2), dtype=dtype) - dc + (dc >> 2)
    satd = ((block + 1) >> 1).sum((-1, -2), dtype=dtype)
    return sad, satd


def ctu_costs(frames: torch.Tensor, refs: torch.Tensor | None,
              frame_idx, ctu_idx, dtype=torch.int64, chunk: int = 32):
    """Costs of the CTUs ``ctu_idx[p]`` of frames ``frame_idx[p]``.

    ``frames``: [F, H, W] original samples; ``refs``: the boundary-sample
    source of the same shape (the filtered frames of the
    alternative-samples regime), or None for the frames themselves.
    Returns (sad, satd, min_sad_had, valid), each [P, 97840] in the
    strided per-CTU layout (valid: bool, the CU wholly inside the frame).
    Work is done ``chunk`` CTUs at a time, to bound memory.
    """
    dev = frames.device
    fh, fw = frames.shape[-2:]
    frames = frames.to(dtype)
    refs = frames if refs is None else refs.to(dev, dtype)
    frame_idx = torch.as_tensor(np.asarray(frame_idx), device=dev).long()
    ctu_idx = torch.as_tensor(np.asarray(ctu_idx), device=dev).long()
    n = len(frame_idx)
    sad = torch.zeros((n, PER_CTU), dtype=dtype, device=dev)
    satd = torch.zeros_like(sad)
    valid = torch.zeros((n, PER_CTU), dtype=torch.bool, device=dev)
    for g in GROUPS:
        start = int(GROUP_OFFSETS[g.index])
        stop = int(GROUP_OFFSETS[g.index + 1])
        for p0 in range(0, n, chunk):
            fi, ci = frame_idx[p0:p0 + chunk], ctu_idx[p0:p0 + chunk]
            xs, ys = _positions(g, fw, ci)
            ref_t, ref_l = _boundaries(refs, fi, xs, ys, g.width, g.height)
            red_t = _reduce(ref_t, BOUNDARY_SIZE[g.size_id], dtype)
            red_l = _reduce(ref_l, BOUNDARY_SIZE[g.size_id], dtype)
            pred = _reduced_prediction(red_t, red_l, g.size_id, dtype)
            if g.size_id > 0:
                pred = _upsample(pred, ref_t, ref_l, g.width, g.height)
            orig = _originals(frames, fi, xs, ys, g.width, g.height)
            s, t = _distortion(orig[:, :, None], pred, dtype)
            m = len(fi)
            sad[p0:p0 + m, start:stop] = s.reshape(m, -1)
            satd[p0:p0 + m, start:stop] = t.reshape(m, -1)
            v = (xs + g.width <= fw) & (ys + g.height <= fh)
            valid[p0:p0 + m, start:stop] = v.repeat_interleave(
                g.total_modes, dim=1)
    return sad, satd, torch.minimum(2 * sad, satd), valid
