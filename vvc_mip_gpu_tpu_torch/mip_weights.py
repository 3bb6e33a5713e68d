"""Loader for the VVC-standard MIP weight matrices.

The weights are normative constants of the VVC/H.266 standard (VTM's
MipData), stored in ``data/mip_weights.npz`` so the package is standalone.

Per-SizeId shapes: [num_modes, out_samples, coeffs]
  SizeId 0: [16, 16, 4]   (4x4 reduced pred, 4 boundary inputs)
  SizeId 1: [ 8, 16, 8]   (4x4 reduced pred, 8 boundary inputs)
  SizeId 2: [ 6, 64, 7]   (8x8 reduced pred, 7 boundary inputs; the first
                           boundary input has an implicit zero coefficient,
                           reference: intra.cl:459-463)
"""

from __future__ import annotations

import functools
from pathlib import Path

import numpy as np
import torch

_DATA = Path(__file__).resolve().parent / "data" / "mip_weights.npz"


@functools.cache
def matrices() -> dict[int, np.ndarray]:
    """MIP weight matrices keyed by SizeId, dtype int32."""
    with np.load(_DATA) as z:
        return {i: z[f"size_id{i}"].astype(np.int32) for i in range(3)}


def _pad(m: np.ndarray, size_id: int) -> np.ndarray:
    if size_id == 2:
        pad = np.zeros(m.shape[:2] + (1,), m.dtype)
        m = np.concatenate([pad, m], axis=2)
    return m


@functools.cache
def padded_matrix(size_id: int) -> np.ndarray:
    """Weight matrix with the coefficient axis padded to the full boundary
    input size, so that ``pred = offsets @ M.T`` uses the whole input vector.

    For SizeId 2 the stored matrix has 7 coefficients applying to boundary
    inputs 1..7; input 0 gets a zero coefficient (reference: intra.cl:459-463,
    its value is always 0 anyway).  SizeId 0/1 matrices already cover all
    inputs.  Returns [num_modes, out_samples, input_size].
    """
    return _pad(matrices()[size_id], size_id)


def weights_from_numpy(mats: dict[int, np.ndarray],
                       device) -> dict[int, torch.Tensor]:
    """Device weight tables from per-SizeId ``[M, S, C]`` numpy matrices
    (the unpadded layout ``matrices()`` returns): contiguous int32
    ``[M, S, C_padded]`` tensors, the layout the cost kernels and the plain
    prediction both read."""
    return {sid: torch.from_numpy(
                np.ascontiguousarray(_pad(np.asarray(m, np.int32), sid)))
            .to(device)
            for sid, m in mats.items()}
