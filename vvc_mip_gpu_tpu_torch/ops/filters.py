"""The 8-variant low-pass filter family of the alternative-samples regime.

Counterpart of the JAX package's ops/filters.py, with the semantics of its
golden model (reference: README.md:20-64, kernels intra.cl:1175-3824):

* 2d variants: true 2D convolution; out-of-frame taps are dropped and the
  divisor is the sum of the in-frame coefficients (intra.cl:2990-3011 int,
  2486-2507 float).
* 1d variants: separable convolution with row 0 of the kernel (horizontal,
  then vertical), zero outside the frame.  Divisors: for 3x3 the
  reference's closed-form full/edge/corner scales (intra.cl:3281-3285,
  3452-3466); for 5x5 the 2D kernel's sum over the in-frame tap
  sub-window (intra.cl:3523-3552).
* int variants: ``(acc + scale // 2) // scale``, floor division.
* float variants: ``floor(acc / scale + 0.5)`` in float32.

``filter_frames`` on a CUDA tensor launches the hand-written kernel
(``csrc/mip_filter.cu``): one launch filters the whole batch, on the
current stream, and adds one to ``filter_frames.launches``.  On a CPU
tensor it runs the plain version, ``filter_frames_plain``; it never falls
back from one to the other.

The plain version shifts and accumulates the frames tap by tap, in the
JAX version's tap order, in int32 (float32 for the float variants) on the
frames' own device; the divisor planes are built once with numpy.  No
convolution operator is used: cuDNN may run a float32 convolution in
TF32, which would change the float variants' results.  Every float
accumulation here is exact (integer coefficients and samples, sums <
2^24), so only the final division rounds.
"""

from __future__ import annotations

import ctypes
import dataclasses
import functools
import itertools

import numpy as np
import torch
import torch.nn.functional as F

from vvc_mip_gpu_tpu_torch.constants import (
    AVAILABLE_FILTERS,
    CONV_KERNELS_3x3,
    CONV_KERNELS_5x5,
)
from vvc_mip_gpu_tpu_torch.ops import _build
from vvc_mip_gpu_tpu_torch.utils.timing import span

_LAUNCH_ARGTYPES = (
    ctypes.c_void_p,  # frames (int32)
    ctypes.c_int, ctypes.c_int, ctypes.c_int,  # n, h, w
    ctypes.c_int, ctypes.c_int, ctypes.c_int,  # k, separable, as_float
    ctypes.c_void_p, ctypes.c_void_p,  # taps, scales (host int32)
    ctypes.c_void_p, ctypes.c_void_p,  # out, stream
)


def _shifted_np(plane: np.ndarray, dy: int, dx: int) -> np.ndarray:
    """plane sample at (y+dy, x+dx), zero outside; same shape."""
    h, w = plane.shape
    out = np.zeros_like(plane)
    out[max(0, -dy):min(h, h - dy), max(0, -dx):min(w, w - dx)] = plane[
        max(0, dy):min(h, h + dy), max(0, dx):min(w, w + dx)]
    return out


def _edge_distance_maps(h: int, w: int):
    y = np.arange(h)[:, None]
    x = np.arange(w)[None, :]
    return (np.minimum(y, h - 1 - y) + 0 * x,
            np.minimum(x, w - 1 - x) + 0 * y)


def _scale_1d_3x3(kernel_row: np.ndarray, h: int, w: int, as_float: bool):
    """Reference closed-form scales (intra.cl:3281-3285) by edge class, and
    the 1D taps (k0, k1).  The float variant normalizes the row to
    [1, k1/k0, 1] (intra.cl:1841-1846)."""
    if as_float:
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


def _scale_1d_5x5(kernel2d: np.ndarray, h: int, w: int,
                  as_float: bool) -> np.ndarray:
    """Rectangular valid-tap sums of the 2D kernel (intra.cl:3523-3552): a
    sample at distance d < 2 from an edge keeps kernel indices [2-d .. 4]
    on that axis (the kernels are symmetric)."""
    dtype = np.float32 if as_float else np.int64
    dy, dx = _edge_distance_maps(h, w)
    scale = np.zeros((h, w), dtype)
    for dt in (0, 1, 2):
        for dl in (0, 1, 2):
            sub = kernel2d[2 - dt:5, 2 - dl:5].sum()
            mask = (np.minimum(dy, 2) == dt) & (np.minimum(dx, 2) == dl)
            scale[mask] = dtype(sub)
    return scale


def _scale_2d(kernel: np.ndarray, h: int, w: int) -> np.ndarray:
    """Dropped-tap divisor: the sum of the in-frame coefficients."""
    k = kernel.shape[0]
    r = k // 2
    ones = np.ones((h, w), np.int64)
    scale = np.zeros((h, w), np.int64)
    for i in range(k):
        for j in range(k):
            scale += int(kernel[i, j]) * _shifted_np(ones, i - r, j - r)
    return scale


@functools.cache
def _plan(filter_type: str, kernel_idx: int, h: int, w: int):
    """(taps, scale plane): the 2D tap list [(dy, dx, coeff)], or the 1D
    taps [coeff] of a separable variant, and the divisor plane (numpy,
    int32 or float32)."""
    kernel = (CONV_KERNELS_5x5 if "5x5" in filter_type
              else CONV_KERNELS_3x3)[kernel_idx]
    as_float = "float" in filter_type
    k = kernel.shape[0]
    r = k // 2
    if "2d" in filter_type:
        taps = tuple((i - r, j - r, int(kernel[i, j]))
                     for i in range(k) for j in range(k))
        scale = _scale_2d(kernel, h, w)
    elif k == 5:
        taps = tuple(int(c) for c in kernel[0])
        scale = _scale_1d_5x5(kernel, h, w, as_float)
    else:
        scale, (k0, k1) = _scale_1d_3x3(kernel[0], h, w, as_float)
        cast = float if as_float else int  # Python scalars: no promotion
        taps = (cast(k0), cast(k1), cast(k0))
    return taps, scale.astype(np.float32 if as_float else np.int32)


@functools.cache
def _scale_on(filter_type: str, kernel_idx: int, h: int, w: int,
              device: torch.device) -> torch.Tensor:
    return torch.from_numpy(_plan(filter_type, kernel_idx, h, w)[1]).to(
        device)


def _check_args(filter_type: str, kernel_idx: int) -> None:
    if filter_type not in AVAILABLE_FILTERS:
        raise ValueError(f"unknown filter {filter_type!r}; "
                         f"available: {list(AVAILABLE_FILTERS)}")
    n_kernels = 3 if "5x5" in filter_type else 5
    if not 0 <= kernel_idx < n_kernels:
        raise ValueError(f"kernel_idx {kernel_idx} out of range for "
                         f"{filter_type} (0..{n_kernels - 1})")


def _window(padded: torch.Tensor, r: int, dy: int, dx: int, h: int, w: int):
    """The [.., h, w] view of a frame padded by ``r`` zeros on each side
    whose sample (y, x) is the frame's (y+dy, x+dx)."""
    return padded[..., r + dy:r + dy + h, r + dx:r + dx + w]


def _checked(frames, filter_type: str, kernel_idx: int) -> torch.Tensor:
    _check_args(filter_type, kernel_idx)
    frames = torch.as_tensor(frames)
    if frames.ndim != 3:
        raise ValueError(f"frames must be [N, H, W], got "
                         f"{tuple(frames.shape)}")
    return frames


def filter_frames_plain(frames, filter_type: str,
                        kernel_idx: int = 0) -> torch.Tensor:
    """Plain PyTorch version of the kernel (any device): ``filter_frames``'
    contract.  Span ``filter``."""
    frames = _checked(frames, filter_type, kernel_idx)
    with span("filter"):
        return _filter(frames, filter_type, kernel_idx)


def _filter(frames: torch.Tensor, filter_type: str,
            kernel_idx: int) -> torch.Tensor:
    n, h, w = frames.shape
    dtype = torch.float32 if "float" in filter_type else torch.int32
    taps, _ = _plan(filter_type, kernel_idx, h, w)
    scale = _scale_on(filter_type, kernel_idx, h, w, frames.device)
    x = frames.to(dtype)
    if "2d" in filter_type:
        r = max(abs(dy) for dy, _, _ in taps)
        padded = F.pad(x, (r, r, r, r))
        acc = torch.zeros_like(x)
        for dy, dx, c in taps:
            acc = acc + c * _window(padded, r, dy, dx, h, w)
    else:
        r = len(taps) // 2
        padded = F.pad(x, (r, r, 0, 0))
        acc_h = torch.zeros_like(x)
        for j, c in enumerate(taps):
            acc_h = acc_h + c * padded[..., :, j:j + w]
        padded = F.pad(acc_h, (0, 0, r, r))
        acc = torch.zeros_like(x)
        for i, c in enumerate(taps):
            acc = acc + c * padded[..., i:i + h, :]
    if dtype == torch.float32:
        return torch.floor(acc / scale + 0.5).to(torch.int32)
    return torch.div(acc + scale // 2, scale, rounding_mode="floor")


def _integers(values) -> np.ndarray:
    out = np.asarray(values).astype(np.int32)
    if not np.array_equal(out, values):
        raise ValueError(f"not integers: {values}")
    out.flags.writeable = False  # cached and shared
    return out


@functools.cache
def launch_tables(filter_type: str, kernel_idx: int):
    """The kernel's description of one variant: (k, separable, as_float,
    taps, scales).  ``taps``: int32, the 2d kernel in raster order or the
    1d row; ``scales``: int32 [(r+1)^4], the divisor by the number of
    taps inside the frame above, below, left and right of a sample
    (``up = min(r, y)``, ``down = min(r, h-1-y)``, ``left = min(r, x)``,
    ``right = min(r, w-1-x)``), raster over (up, down, left, right).  Each
    is read off ``_plan``'s divisor plane of the smallest frame that has
    that class, (up + down + 1) x (left + right + 1), at (up, left)."""
    _check_args(filter_type, kernel_idx)
    k = 5 if "5x5" in filter_type else 3
    r = k // 2
    taps, _ = _plan(filter_type, kernel_idx, 1, 1)
    taps = _integers([c for _, _, c in taps] if "2d" in filter_type
                     else list(taps))
    scales = np.empty((r + 1,) * 4, np.int32)
    for up, down, left, right in itertools.product(range(r + 1), repeat=4):
        plane = _plan(filter_type, kernel_idx, up + down + 1,
                      left + right + 1)[1]
        scales[up, down, left, right] = _integers(plane[up, left])
    scales.flags.writeable = False
    return (k, "1d" in filter_type, "float" in filter_type, taps,
            scales.ravel())


@dataclasses.dataclass(eq=False)
class FilterKernel:
    """The hand-written CUDA filter kernel (every variant, one launch a
    batch) with its launch counter and plain version."""

    name: str
    replaces: str  # the TPU kernel whose work it does: none
    launches: int = 0
    plain = staticmethod(filter_frames_plain)

    def __call__(self, frames, filter_type: str,
                 kernel_idx: int = 0) -> torch.Tensor:
        """Apply one of the 8 filter variants to [N, H, W] 10-bit frames.
        Returns [N, H, W] int32 on the frames' device (a numpy input lands
        on the CPU).  Reference equivalent: the filterFrame_* enqueue
        loop, main.cpp:684-791.  On the card the kernel reads int32: other
        integer types are cast to int32 first (floating ones are refused)
        and the frames are made contiguous.  Span ``filter``."""
        frames = _checked(frames, filter_type, kernel_idx)
        if frames.device.type == "cpu":
            return filter_frames_plain(frames, filter_type, kernel_idx)
        if frames.device.type != "cuda":
            raise ValueError(f"{self.name}: no kernel for {frames.device}")
        with span("filter"):
            return self._launch(frames, filter_type, kernel_idx)

    def _launch(self, frames: torch.Tensor, filter_type: str,
                kernel_idx: int) -> torch.Tensor:
        if frames.is_floating_point() or frames.is_complex():
            raise ValueError(f"{self.name}: frames must hold integer "
                             f"samples, got {frames.dtype}")
        frames = frames.to(torch.int32).contiguous()
        n, h, w = frames.shape
        out = torch.empty((n, h, w), dtype=torch.int32, device=frames.device)
        if out.numel() == 0:
            return out  # nothing to launch (a 0-sized grid fails)
        k, separable, as_float, taps, scales = launch_tables(filter_type,
                                                             kernel_idx)
        with torch.cuda.device(frames.device):
            stream = torch.cuda.current_stream(frames.device).cuda_stream
            err = _launcher()(frames.data_ptr(), n, h, w, k,
                              int(separable), int(as_float),
                              taps.ctypes.data, scales.ctypes.data,
                              out.data_ptr(), stream)
        if err != 0:
            raise RuntimeError(f"{self.name} {filter_type}[{kernel_idx}]: "
                               f"CUDA launch failed with error {err}")
        self.launches += 1
        return out


@functools.cache
def _launcher():
    fn = _build.load_library("mip_filter").mip_filter
    fn.argtypes = _LAUNCH_ARGTYPES
    fn.restype = ctypes.c_int
    return fn


filter_frames = FilterKernel(
    "mip_filter",
    "none: the JAX package's filter (vvc_mip_gpu_tpu/ops/filters.py "
    "filter_frames) is jnp code, no pl.pallas_call")


def filter_frame(frame, filter_type: str, kernel_idx: int = 0):
    """Apply one of the 8 filter variants to an [H, W] frame; [H, W]
    int32 on the frame's device."""
    frame = torch.as_tensor(frame)
    if frame.ndim != 2:
        raise ValueError(f"frame must be [H, W], got {tuple(frame.shape)}")
    return filter_frames(frame[None], filter_type, kernel_idx)[0]
