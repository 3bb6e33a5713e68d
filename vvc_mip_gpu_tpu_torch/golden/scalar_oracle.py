"""Pure-Python scalar oracle for one CU's MIP pipeline.

The port's own copy of the JAX package's golden/scalar_oracle.py, with
the same per-sample Python-integer arithmetic; it takes the constants and
the weights of the port and nothing else of it.  chip_smoke.py phase (k)
holds the card's costs at 3840x2160 against it CU by CU, and the port's
golden model (golden/reference_model.py) at 1920x1080.

This is the bottom of the test pyramid: per-sample Python-integer arithmetic
with no vectorization whatsoever, written directly from the VVC MIP
semantics as implemented by the reference kernels (boundary extraction
intra.cl:17-344, reduced prediction intra.cl:349-543, upsample + distortion
intra.cl:545-1171, SATD kernel_aux_functions.cl:142-249).  It exists so the
vectorized golden model and the port's engine can both be checked against
an implementation whose correctness is auditable line by line.

All shifts are arithmetic (floor) shifts, matching C semantics on the
negative intermediates that occur after the input-offset subtraction.
"""

from __future__ import annotations

from vvc_mip_gpu_tpu_torch import mip_weights
from vvc_mip_gpu_tpu_torch.constants import (
    BOUNDARY_SIZE,
    MIP_OFFSET_MATRIX,
    MIP_SHIFT_MATRIX,
    PRED_MODES,
    REDUCED_PRED_SIZE,
    SAMPLE_MAX,
    VALUE_DC,
)


def top_boundary(frame, x: int, y: int, w: int) -> list[int]:
    """Complete top boundary (w samples) with VVC edge padding.

    reference: intra.cl:96-107 — row above when available; at the frame's
    top edge every sample is padded with the sample directly left of the
    CU's first sample (row 0), or the DC value at the top-left corner.
    """
    if y > 0:
        return [int(frame[y - 1, x + i]) for i in range(w)]
    if x > 0:
        return [int(frame[0, x - 1])] * w
    return [VALUE_DC] * w


def left_boundary(frame, x: int, y: int, h: int) -> list[int]:
    """Complete left boundary (h samples); reference: intra.cl:232-243."""
    if x > 0:
        return [int(frame[y + i, x - 1]) for i in range(h)]
    if y > 0:
        return [int(frame[y - 1, 0])] * h
    return [VALUE_DC] * h


def reduce_boundary(samples: list[int], bnd_size: int) -> list[int]:
    """Downsample-average to bnd_size entries; reference: intra.cl:127-140.

    When the boundary is already bnd_size long the rounding offset is zero
    (the reference's ``1 << (log2-1)`` for log2==0 evaluates to 0 on GPU
    shift-clamp semantics and the value is copied through unchanged).
    """
    ds = len(samples) // bnd_size
    log2 = ds.bit_length() - 1
    off = (1 << (log2 - 1)) if ds > 1 else 0
    return [
        (sum(samples[i * ds:(i + 1) * ds]) + off) >> log2
        for i in range(bnd_size)
    ]


def reduced_prediction(red_t, red_l, size_id: int, mode: int,
                       transposed: bool) -> list[list[int]]:
    """Reduced prediction grid [R][R]; reference: intra.cl:415-487.

    For transposed modes the top/left boundaries swap roles and the output
    grid is transposed back before upsampling.
    """
    r = REDUCED_PRED_SIZE[size_id]
    bnd = list(red_l) + list(red_t) if transposed else list(red_t) + list(red_l)
    first = bnd[0]
    off_vec = [b - first for b in bnd]
    # reference: intra.cl:443-446 — s0 is (1<<9)-first for SizeId 0/1, 0 for 2
    off_vec[0] = 0 if size_id == 2 else (1 << 9) - first
    offset = (1 << (MIP_SHIFT_MATRIX - 1)) - MIP_OFFSET_MATRIX * sum(off_vec)
    mat = mip_weights.padded_matrix(size_id)[mode]
    grid = [[0] * r for _ in range(r)]
    for s in range(r * r):
        acc = offset
        for c in range(len(off_vec)):
            acc += off_vec[c] * int(mat[s][c])
        val = (acc >> MIP_SHIFT_MATRIX) + first
        val = max(0, min(SAMPLE_MAX, val))
        sy, sx = divmod(s, r)
        if transposed:
            grid[sx][sy] = val
        else:
            grid[sy][sx] = val
    return grid


def _interp(before: int, after: int, up: int, pos: int) -> int:
    """One linear-interpolation tap; reference: intra.cl:826-841.

    pos is the 1-based position inside the window (1..up); up == 1 copies.
    """
    if up == 1:
        return after
    log2 = up.bit_length() - 1
    rnd = 1 << (log2 - 1)
    return ((up - pos) * before + pos * after + rnd) >> log2


def upsample(pred, ref_t, ref_l, w: int, h: int) -> list[list[int]]:
    """Horizontal-then-vertical linear upsampling of the reduced prediction.

    reference: intra.cl:815-895.  The horizontal pass fills the "anchor"
    rows (those aligned with reduced-prediction rows); the vertical pass
    interpolates every row from the anchors and the top boundary.
    """
    r = len(pred)
    up_h = w // r
    up_v = h // r
    # Horizontal pass: anchor rows y = k*up_v + up_v - 1
    anchors = [[0] * w for _ in range(r)]
    for k in range(r):
        for x in range(w):
            j = x // up_h
            if x < up_h:
                before = ref_l[k * up_v + up_v - 1]
            else:
                before = pred[k][j - 1]
            anchors[k][x] = _interp(before, pred[k][j], up_h, x % up_h + 1)
    # Vertical pass
    out = [[0] * w for _ in range(h)]
    for y in range(h):
        k = y // up_v
        for x in range(w):
            before = ref_t[x] if y < up_v else anchors[k - 1][x]
            out[y][x] = _interp(before, anchors[k][x], up_v, y % up_v + 1)
    return out


def satd_4x4(orig, pred) -> int:
    """VTM-style 4x4 Hadamard SATD with the JVET_R0164 mean-scaled
    correction; reference: kernel_aux_functions.cl:142-249 (inherited from
    VTM-12.0 RdCost::xCalcHADs4x4).

    Computed here as the two-sided Hadamard transform H·D·Hᵀ; the butterfly
    in the reference realizes the same transform up to row/column order,
    which leaves both the coefficient magnitudes and the DC term unchanged.
    """
    hmat = [[1, 1, 1, 1], [1, 1, -1, -1], [1, -1, -1, 1], [1, -1, 1, -1]]
    d = [[int(orig[i][j]) - int(pred[i][j]) for j in range(4)] for i in range(4)]
    # t = H @ d @ H^T
    hd = [[sum(hmat[i][k] * d[k][j] for k in range(4)) for j in range(4)]
          for i in range(4)]
    t = [[sum(hd[i][k] * hmat[j][k] for k in range(4)) for j in range(4)]
         for i in range(4)]
    satd = sum(abs(t[i][j]) for i in range(4) for j in range(4))
    dc = abs(sum(d[i][j] for i in range(4) for j in range(4)))
    satd -= dc
    satd += dc >> 2
    return (satd + 1) >> 1


def cu_distortion(orig, pred, w: int, h: int) -> tuple[int, int]:
    """(SAD, SATD) of a CU; reference: intra.cl:922-1053."""
    sad = sum(abs(int(orig[y][x]) - int(pred[y][x]))
              for y in range(h) for x in range(w))
    satd = 0
    for by in range(0, h, 4):
        for bx in range(0, w, 4):
            ob = [[orig[by + i][bx + j] for j in range(4)] for i in range(4)]
            pb = [[pred[by + i][bx + j] for j in range(4)] for i in range(4)]
            satd += satd_4x4(ob, pb)
    return sad, satd


def cu_cost(frame, ref_frame, x: int, y: int, w: int, h: int, size_id: int,
            mode_idx: int) -> tuple[int, int, int]:
    """Full pipeline for one CU and one mode index in [0, 2*num_modes).

    ``frame`` supplies the original samples for distortion; ``ref_frame``
    supplies the reference (boundary) samples — they differ only in the
    alternative-samples regime (reference: main.cpp:818-822 vs 928).
    Returns (sad, satd, min_sad_had).
    """
    num_modes = PRED_MODES[size_id]
    mode = mode_idx % num_modes
    transposed = mode_idx >= num_modes
    bnd = BOUNDARY_SIZE[size_id]
    ref_t = top_boundary(ref_frame, x, y, w)
    ref_l = left_boundary(ref_frame, x, y, h)
    red_t = reduce_boundary(ref_t, bnd)
    red_l = reduce_boundary(ref_l, bnd)
    pred = reduced_prediction(red_t, red_l, size_id, mode, transposed)
    if size_id > 0:
        pred = upsample(pred, ref_t, ref_l, w, h)
    orig = [[int(frame[y + i, x + j]) for j in range(w)] for i in range(h)]
    sad, satd = cu_distortion(orig, pred, w, h)
    return sad, satd, min(2 * sad, satd)
