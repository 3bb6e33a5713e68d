"""NumPy golden model of the 8-variant low-pass filter family.

The port's own copy of the JAX package's golden/filters_golden.py (NumPy
only, the same arithmetic and dtypes): the oracle that holds the port's
filters (ops/filters.py) on the card, and the filter of the CPU
filtering profiler (tools/profile_cpu_filtering.py).  No path of the CLI
or the bench runs it.

The reference's "alternative samples" regime filters the whole frame before
boundary extraction (reference: README.md:20-64, kernels intra.cl:1175-3824).
All 8 variants draw coefficients from the *integer* libraries
(convKernelLib / convKernelLib_5x5); the float variants merely accumulate in
float and use round-half-away division.  Semantics per variant:

* 2d variants: true 2D convolution; out-of-frame taps are dropped and the
  divisor is reduced to the sum of in-frame coefficients
  (reference: intra.cl:2990-3011 int, 2486-2507 float).
* 1d variants: separable convolution with row 0 of the kernel (horizontal
  then vertical), zero padding outside the frame.  Divisors:
  - 3x3: the reference's closed-form full/edge/corner scales
    (intra.cl:3281-3285), selected by frame-edge position (3452-3466);
  - 5x5: the 2D kernel's sum over the in-frame tap sub-window
    (intra.cl:3523-3552), i.e. a rectangular valid-tap sum.
* int variants:  (acc + scale/2) / scale   (integer division)
* float variants: round(acc / scale)       (round half away from zero)

Deviation from the reference (documented, deliberate): the reference's
tile-halo fetch skips a handful of valid samples at tile interfaces that
coincide with frame borders (e.g. the `>0` vs `>=0` guards at
intra.cl:2383-2409), making a few border samples depend on tile placement.
We implement the uniform whole-frame rule the kernels clearly intend.
"""

from __future__ import annotations

import numpy as np

from vvc_mip_gpu_tpu_torch.constants import (
    AVAILABLE_FILTERS,
    CONV_KERNELS_3x3,
    CONV_KERNELS_5x5,
)


def _shifted(frame: np.ndarray, dy: int, dx: int, fill=0) -> np.ndarray:
    """frame sample at (y+dy, x+dx), `fill` outside; same shape as frame."""
    h, w = frame.shape
    out = np.full_like(frame, fill)
    ys = slice(max(0, -dy), min(h, h - dy))
    xs = slice(max(0, -dx), min(w, w - dx))
    out[ys, xs] = frame[max(0, dy):min(h, h + dy), max(0, dx):min(w, w + dx)]
    return out


def _conv2d_dropped_taps(frame: np.ndarray, kernel: np.ndarray, as_float: bool):
    """2D convolution accumulating only in-frame taps, plus the per-pixel
    valid-coefficient scale.  Accumulation order matches the reference's
    row-major loop."""
    k = kernel.shape[0]
    r = k // 2
    dtype = np.float32 if as_float else np.int64
    acc = np.zeros(frame.shape, dtype)
    scale = np.zeros(frame.shape, dtype)
    valid = np.ones(frame.shape, np.int64)
    for i in range(k):
        for j in range(k):
            coeff = dtype(kernel[i, j])
            acc += coeff * _shifted(frame, i - r, j - r).astype(dtype)
            scale += coeff * _shifted(valid, i - r, j - r).astype(dtype)
    return acc, scale


def _separable(frame: np.ndarray, k1d: np.ndarray, as_float: bool):
    """Horizontal-then-vertical separable convolution with zero padding."""
    dtype = np.float32 if as_float else np.int64
    r = len(k1d) // 2
    acc_h = np.zeros(frame.shape, dtype)
    for j, c in enumerate(k1d):
        acc_h += dtype(c) * _shifted(frame, 0, j - r).astype(dtype)
    acc = np.zeros(frame.shape, dtype)
    for i, c in enumerate(k1d):
        acc += dtype(c) * _shifted(acc_h, i - r, 0)
    return acc


def _edge_distance_maps(h: int, w: int):
    y = np.arange(h)[:, None]
    x = np.arange(w)[None, :]
    return (np.minimum(y, h - 1 - y) + 0 * x), (np.minimum(x, w - 1 - x) + 0 * y)


def _scale_1d_3x3(kernel_row: np.ndarray, h: int, w: int, as_float: bool):
    """Reference closed-form scales (intra.cl:3281-3285) by edge class."""
    if as_float:
        # 1d_float normalizes: [1, k1/k0, 1] (intra.cl:1841-1846)
        k0, k1 = np.float32(1.0), np.float32(kernel_row[1] / kernel_row[0])
        dtype = np.float32
    else:
        k0, k1 = int(kernel_row[0]), int(kernel_row[1])
        dtype = np.int64
    full = 4 * k0 + 4 * k1 + k1 * k1
    edge = 2 * k0 + 3 * k1 + k1 * k1
    corner = 1 * k0 + 2 * k1 + k1 * k1
    dy, dx = _edge_distance_maps(h, w)
    n_edges = (dy == 0).astype(int) + (dx == 0).astype(int)
    scale = np.full((h, w), full, dtype)
    scale[n_edges == 1] = dtype(edge)
    scale[n_edges >= 2] = dtype(corner)
    return scale, (k0, k1)


def _scale_1d_5x5(kernel2d: np.ndarray, h: int, w: int, as_float: bool):
    """Rectangular valid-tap sums of the 2D kernel (intra.cl:3523-3552)."""
    dtype = np.float32 if as_float else np.int64
    dy, dx = _edge_distance_maps(h, w)
    scale = np.zeros((h, w), dtype)
    for dt in (0, 1, 2):
        for dl in (0, 1, 2):
            rows = slice(2 - dt, 5)
            cols = slice(2 - dl, 5)
            # distance d from an edge keeps kernel indices [2-d .. 4]
            # (symmetric for the opposite edge; handled by the min() in
            # the distance maps and the kernel's symmetry in the lib).
            sub = kernel2d[rows, cols].sum()
            mask = (np.minimum(dy, 2) == dt) & (np.minimum(dx, 2) == dl)
            scale[mask] = dtype(sub)
    return scale


def _div_int(acc: np.ndarray, scale: np.ndarray) -> np.ndarray:
    return (acc + scale // 2) // scale


def _div_round(acc: np.ndarray, scale: np.ndarray) -> np.ndarray:
    return np.floor(acc.astype(np.float32) / scale.astype(np.float32)
                    + np.float32(0.5)).astype(np.int64)


def filter_frame(frame: np.ndarray, filter_type: str,
                 kernel_idx: int) -> np.ndarray:
    """Apply one of the 8 filter variants; returns int64 samples."""
    if filter_type not in AVAILABLE_FILTERS:
        raise ValueError(f"unknown filter {filter_type!r}")
    h, w = frame.shape
    frame = frame.astype(np.int64)
    is5 = "5x5" in filter_type
    as_float = "float" in filter_type
    lib = CONV_KERNELS_5x5 if is5 else CONV_KERNELS_3x3
    kernel = lib[kernel_idx]
    if "2d" in filter_type:
        acc, scale = _conv2d_dropped_taps(frame, kernel, as_float)
        return _div_round(acc, scale) if as_float else _div_int(acc, scale)
    # 1d (separable) variants
    if is5:
        k1d = kernel[0].astype(np.float32 if as_float else np.int64)
        acc = _separable(frame, k1d, as_float)
        scale = _scale_1d_5x5(kernel, h, w, as_float)
    else:
        scale, (k0, k1) = _scale_1d_3x3(kernel[0], h, w, as_float)
        k1d = np.array([k0, k1, k0])
        acc = _separable(frame, k1d, as_float)
    return _div_round(acc, scale) if as_float else _div_int(acc, scale)
