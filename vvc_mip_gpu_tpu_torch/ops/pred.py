"""The reduced-prediction kernel: wrapper, launch counter and plain version.

    mip_reduced_pred(red_t, red_l, size_id, weights=None) -> [2M, S, nCU]

``red_t`` / ``red_l``: the reduced top and left boundaries, integer
[BS, nCU] (``mip_ops.reduce_boundary``'s output, CU axis last);
``weights``: the SizeId's int32 [M, S, C] table
(``mip_weights.weights_from_numpy``), the package's own by default.
Returns the all-mode reduced prediction as int16 [2M, S, nCU], S = R*R in
raster order, modes 0..M-1 the normal wing and M..2M-1 the transposed
wing (the contract of ``mip_ops.reduced_prediction_all_modes``, without
the TPU kernel's tile padding).

On a CUDA tensor the wrapper launches the kernel (``csrc/mip_pred.cu``)
on the current stream and adds one to ``launches``; on a CPU tensor it
runs its plain version, ``mip_ops.reduced_prediction_all_modes``.  It
never falls back from one to the other.
"""

from __future__ import annotations

import ctypes
import dataclasses
import functools

import torch

from vvc_mip_gpu_tpu_torch import mip_weights
from vvc_mip_gpu_tpu_torch.constants import (
    BOUNDARY_SIZE,
    PRED_MODES,
    REDUCED_PRED_SIZE,
)
from vvc_mip_gpu_tpu_torch.ops import _build
from vvc_mip_gpu_tpu_torch.ops import mip_ops as ops

_LAUNCH_ARGTYPES = (
    ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,  # red_t, red_l, w
    ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p,  # n_cu, out, stream
)


def reduced_prediction_plain(red_t, red_l, size_id: int,
                             weights=None) -> torch.Tensor:
    """Plain PyTorch version of the kernel (any device)."""
    red_t, red_l, weights = _check(red_t, red_l, size_id, weights)
    return ops.reduced_prediction_all_modes(red_t, red_l, size_id,
                                            weights).to(torch.int16)


@functools.cache
def _own_weights(size_id: int, device: torch.device) -> torch.Tensor:
    return mip_weights.weights_from_numpy(mip_weights.matrices(),
                                          device)[size_id]


def _check(red_t, red_l, size_id: int, weights):
    if size_id not in PRED_MODES:
        raise ValueError(f"SizeId must be 0, 1 or 2, got {size_id}")
    bs = BOUNDARY_SIZE[size_id]
    r = REDUCED_PRED_SIZE[size_id]
    for name, t in (("red_t", red_t), ("red_l", red_l)):
        if (t.ndim != 2 or t.shape[0] != bs or t.shape != red_t.shape
                or t.device != red_t.device or t.is_floating_point()):
            raise ValueError(
                f"{name}: want an integer [{bs}, nCU] tensor on "
                f"{red_t.device} like red_t, got {t.dtype} "
                f"{tuple(t.shape)} on {t.device}")
    if weights is None:
        weights = _own_weights(size_id, red_t.device)
    want = (PRED_MODES[size_id], r * r, 2 * bs)
    if (weights.dtype != torch.int32 or tuple(weights.shape) != want
            or weights.device != red_t.device):
        raise ValueError(f"weights: want int32 {want} on {red_t.device}, "
                         f"got {weights.dtype} {tuple(weights.shape)} on "
                         f"{weights.device}")
    return (red_t.to(torch.int32).contiguous(),
            red_l.to(torch.int32).contiguous(), weights.contiguous())


@dataclasses.dataclass(eq=False)
class PredKernel:
    """The hand-written CUDA reduced-prediction kernel (all SizeIds) with
    its launch counter and plain version."""

    name: str
    replaces: str  # the TPU kernel whose work it does
    launches: int = 0
    plain = staticmethod(reduced_prediction_plain)

    def __call__(self, red_t, red_l, size_id: int,
                 weights=None) -> torch.Tensor:
        if red_t.device.type == "cpu":
            return reduced_prediction_plain(red_t, red_l, size_id, weights)
        if red_t.device.type != "cuda":
            raise ValueError(f"{self.name}: no kernel for {red_t.device}")
        red_t, red_l, weights = _check(red_t, red_l, size_id, weights)
        n_cu = red_t.shape[1]
        r = REDUCED_PRED_SIZE[size_id]
        out = torch.empty((2 * PRED_MODES[size_id], r * r, n_cu),
                          dtype=torch.int16, device=red_t.device)
        if n_cu == 0:
            return out  # nothing to launch (a 0-sized grid fails)
        with torch.cuda.device(red_t.device):
            stream = torch.cuda.current_stream(red_t.device).cuda_stream
            err = _launcher(size_id)(red_t.data_ptr(), red_l.data_ptr(),
                                     weights.data_ptr(), n_cu,
                                     out.data_ptr(), stream)
        if err != 0:
            raise RuntimeError(f"{self.name} SizeId {size_id}: CUDA launch "
                               f"failed with error {err}")
        self.launches += 1
        return out


@functools.cache
def _launcher(size_id: int):
    fn = getattr(_build.load_library("mip_pred"),
                 f"mip_reduced_pred_sid{size_id}")
    fn.argtypes = _LAUNCH_ARGTYPES
    fn.restype = ctypes.c_int
    return fn


mip_reduced_pred = PredKernel(
    "mip_reduced_pred",
    "vvc_mip_gpu_tpu/ops/pallas/pred.py:123 _kernel "
    "(reduced_prediction :132, pl.pallas_call :154)")
