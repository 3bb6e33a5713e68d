"""Plain reference of the 8 low-pass filter variants, in PyTorch.

The arithmetic of the NumPy filter oracle (reference: README.md:20-64,
intra.cl:1175-3824), on [F, H, W] frames on any device:

* 2d variants: true 2-D convolution; out-of-frame taps are dropped and the
  divisor is the sum of the in-frame coefficients.
* 1d variants: separable, row 0 of the kernel, horizontal then vertical,
  zero outside the frame; 3x3 divisors by the reference's closed-form
  full / edge / corner scales, 5x5 by the 2-D kernel's in-frame sub-sum.
* int variants: ``(acc + scale // 2) // scale``; float variants:
  ``floor(acc / scale + 0.5)`` in float32.

Integer arithmetic is in ``dtype`` (int64 for the reference).
"""

from __future__ import annotations

import torch

from portbench.reference.tables import (
    CONV_KERNELS_3x3,
    CONV_KERNELS_5x5,
    FILTERS,
)


def _shifted(x, dy: int, dx: int):
    """x's sample at (y+dy, x+dx), zero outside; same shape."""
    h, w = x.shape[-2:]
    out = torch.zeros_like(x)
    out[..., max(0, -dy):min(h, h - dy), max(0, -dx):min(w, w - dx)] = x[
        ..., max(0, dy):min(h, h + dy), max(0, dx):min(w, w + dx)]
    return out


def _edge_distances(h: int, w: int, device):
    y = torch.arange(h, device=device)[:, None]
    x = torch.arange(w, device=device)[None, :]
    return (torch.minimum(y, h - 1 - y).expand(h, w),
            torch.minimum(x, w - 1 - x).expand(h, w))


def filter_frames(frames: torch.Tensor, filter_type: str, kernel_idx: int,
                  dtype=torch.int64) -> torch.Tensor:
    """[F, H, W] frames filtered by one variant; integer samples in
    ``dtype``."""
    if filter_type not in FILTERS:
        raise ValueError(f"unknown filter {filter_type!r}")
    h, w = frames.shape[-2:]
    dev = frames.device
    is5 = "5x5" in filter_type
    as_float = "float" in filter_type
    acc_t = torch.float32 if as_float else dtype
    kernel = (CONV_KERNELS_5x5 if is5 else CONV_KERNELS_3x3)[kernel_idx]
    x = frames.to(acc_t)
    if "2d" in filter_type:
        k = kernel.shape[0]
        r = k // 2
        acc = torch.zeros_like(x)
        scale = torch.zeros((h, w), dtype=acc_t, device=dev)
        ones = torch.ones((h, w), dtype=acc_t, device=dev)
        for i in range(k):
            for j in range(k):
                c = int(kernel[i, j])
                acc += c * _shifted(x, i - r, j - r)
                scale += c * _shifted(ones, i - r, j - r)
    else:
        dy, dx = _edge_distances(h, w, dev)
        if is5:
            k1d = [int(c) for c in kernel[0]]
            scale = torch.zeros((h, w), dtype=acc_t, device=dev)
            for dt in (0, 1, 2):
                for dl in (0, 1, 2):
                    sub = int(kernel[2 - dt:5, 2 - dl:5].sum())
                    mask = (dy.clamp(max=2) == dt) & (dx.clamp(max=2) == dl)
                    scale[mask] = sub
        else:
            if as_float:  # the float variant's row is [1, k1/k0, 1]
                k0, k1 = 1.0, float(kernel[0][1]) / float(kernel[0][0])
            else:
                k0, k1 = int(kernel[0][0]), int(kernel[0][1])
            k1d = [k0, k1, k0]
            edges = (dy == 0).long() + (dx == 0).long()
            scale = torch.full((h, w), 4 * k0 + 4 * k1 + k1 * k1,
                               dtype=acc_t, device=dev)
            scale[edges == 1] = 2 * k0 + 3 * k1 + k1 * k1
            scale[edges >= 2] = 1 * k0 + 2 * k1 + k1 * k1
        r = len(k1d) // 2
        acc_h = torch.zeros_like(x)
        for j, c in enumerate(k1d):
            acc_h += c * _shifted(x, 0, j - r)
        acc = torch.zeros_like(x)
        for i, c in enumerate(k1d):
            acc += c * _shifted(acc_h, i - r, 0)
    if as_float:
        return torch.floor(acc / scale + 0.5).to(dtype)
    return torch.div(acc + scale // 2, scale, rounding_mode="floor")
