"""Synthetic 10-bit luma frames, made from the seed on the given device.

Each frame is a smooth field (a coarse random grid, bilinearly
interpolated) plus uniform noise, clipped to [0, 1023]: correlated content
with texture, some of it saturated at either end.  The search does the
same work for any content; the costs differ, and are judged.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

CELL = 64  # pitch of the coarse grid, in samples
NOISE = 24  # half-width of the uniform noise


def make_frames(n: int, width: int, height: int, seed: int,
                device) -> torch.Tensor:
    """[n, height, width] int32 samples."""
    gen = torch.Generator(device=device)
    gen.manual_seed(seed % (1 << 63))
    out = torch.empty((n, height, width), dtype=torch.int32, device=device)
    for i in range(n):  # one frame at a time: 4K floats are 33 MB each
        grid = torch.rand((1, 1, height // CELL + 2, width // CELL + 2),
                          generator=gen, device=device)
        smooth = F.interpolate(grid, size=(height, width), mode="bilinear",
                               align_corners=False)[0, 0]
        texture = torch.randint(-NOISE, NOISE + 1, (height, width),
                                generator=gen, device=device)
        out[i] = (smooth * 1151 - 64).round().int().add_(texture).clamp_(
            0, 1023)
    return out
