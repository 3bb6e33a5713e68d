"""The three cost kernels: wrappers, launch counters and plain versions.

Each wrapper computes the costs of one shape class for a batch of frames
and writes them into the reference strided layout:

    wrapper(frame, ref, halo_row, is_top, cplan, table, weights, outs)

``frame``/``ref``: [B, H, W] int16 distortion targets and boundary sources
(pass the same tensor for the original-samples regime); ``halo_row``:
[B, W] int16, the row above each slab (read only when ``is_top`` is
False); ``cplan``: the class's geometry; ``table``: its int32 [nCU, 3] CU
table (``geometry.cu_table``) on the frame's device; ``weights``: the int32
[M, S, C] MIP matrices of its SizeId; ``outs``: ``(msh,)`` for the
max-performance regime or ``(sad, satd)``, each int32 [B, nCTU, 97840],
written in place at this class's entries only.

On a CUDA tensor a wrapper launches its kernel (``csrc/mip_cost.cu``) on
the current stream and adds one to ``launches``; on a CPU tensor it runs
its plain version, ``class_costs_plain``, the composition of
ops/mip_ops.py that is the kernels' reference.  It never falls back from
one to the other.
"""

from __future__ import annotations

import ctypes
import dataclasses
import functools

import torch

from vvc_mip_gpu_tpu_torch.constants import STRIDED_DISTORTIONS_PER_CTU
from vvc_mip_gpu_tpu_torch.ops import _build
from vvc_mip_gpu_tpu_torch.ops import mip_ops as ops
from vvc_mip_gpu_tpu_torch.ops.geometry import ClassPlan, padded_extent

_LAUNCH_ARGTYPES = (
    ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,  # orig, ref, halo
    ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p,  # table, n_cu, weights
    ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,  # B, H, W, top
    ctypes.c_void_p, ctypes.c_void_p,  # out0, out1
    ctypes.c_longlong, ctypes.c_void_p,  # out_stride, stream
)


def class_costs_plain(frame, ref, halo_row, is_top: bool, cplan: ClassPlan,
                      table, weights, outs) -> None:
    """Plain PyTorch version of the cost kernels (any device): per frame,
    pad, gather, reduce, predict, upsample, measure, reorder to the CTU
    layout and scatter through the CU table's offsets."""
    _check(frame, ref, halo_row, cplan, table, weights, outs)
    shape = cplan.shape
    w, h, r = shape.width, shape.height, shape.reduced_pred_size
    bs, two_m = shape.boundary_size, shape.total_modes
    hp, wp = padded_extent(frame.shape[2], frame.shape[1])
    offs = (table[:, 2].long()[:, None]
            + torch.arange(two_m, device=frame.device)).reshape(-1)
    for b in range(frame.shape[0]):
        frame_pad = ops.pad_edge(frame[b], hp, wp)
        ref_pad = ops.pad_reference(ref[b], halo_row[b], hp, wp)
        bnds = [ops.gather_boundaries(ref_pad, gp, is_top)
                for gp in cplan.groups]
        ref_t = torch.cat([t for t, _ in bnds], -1)  # [w, nCU]
        ref_l = torch.cat([lft for _, lft in bnds], -1)  # [h, nCU]
        orig = torch.cat([ops.gather_originals(frame_pad, gp)
                          for gp in cplan.groups], -1)  # [h*w, nCU]
        pred = ops.reduced_prediction_all_modes(
            ops.reduce_boundary(ref_t, bs), ops.reduce_boundary(ref_l, bs),
            shape.size_id, weights)
        if shape.size_id > 0:
            pred = ops.upsample_all(pred, ref_t, ref_l, w, h, r)
        sad, satd = ops.distortion(orig, pred, h, w)
        costs = ((torch.minimum(2 * sad, satd),) if len(outs) == 1
                 else (sad, satd))
        for out, cost in zip(outs, costs):
            cost = cost.T  # [nCU, 2M], lattice order
            blocks, start = [], 0
            for gp in cplan.groups:
                n = gp.n_rows * gp.n_cols
                blocks.append(gp.lattice_costs_to_ctu_mode_minor(
                    cost[start:start + n]).reshape(-1))
                start += n
            out[b].view(-1).index_copy_(0, offs, torch.cat(blocks))


def _check(frame, ref, halo_row, cplan, table, weights, outs) -> None:
    b, hgt, wid = frame.shape
    shape = cplan.shape
    n_cu = sum(gp.n_rows * gp.n_cols for gp in cplan.groups)
    per_ctu = int(STRIDED_DISTORTIONS_PER_CTU[-1])
    for name, t, dtype, dims in (
            ("frame", frame, torch.int16, (b, hgt, wid)),
            ("ref", ref, torch.int16, (b, hgt, wid)),
            ("halo_row", halo_row, torch.int16, (b, wid)),
            ("table", table, torch.int32, (n_cu, 3)),
            ("weights", weights, torch.int32, None),
            *((f"outs[{i}]", o, torch.int32, (b, cplan.n_ctus, per_ctu))
              for i, o in enumerate(outs))):
        if t.dtype != dtype or t.device != frame.device:
            raise ValueError(f"{name}: want {dtype} on {frame.device}, got "
                             f"{t.dtype} on {t.device}")
        if dims is not None and tuple(t.shape) != dims:
            raise ValueError(f"{name}: want shape {dims}, got "
                             f"{tuple(t.shape)}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    c = 2 * shape.boundary_size
    r = shape.reduced_pred_size
    if tuple(weights.shape) != (shape.num_modes, r * r, c):
        raise ValueError(f"weights: want SizeId {shape.size_id} tables "
                         f"{(shape.num_modes, r * r, c)}, got "
                         f"{tuple(weights.shape)}")
    if len(outs) not in (1, 2):
        raise ValueError("outs must be (msh,) or (sad, satd)")


@dataclasses.dataclass(eq=False)
class CostKernel:
    """One hand-written CUDA kernel (all classes of one SizeId) with its
    launch counter and plain version."""

    name: str
    size_id: int
    replaces: str  # the TPU kernel(s) whose work it does
    launches: int = 0
    plain = staticmethod(class_costs_plain)

    def __call__(self, frame, ref, halo_row, is_top: bool, cplan: ClassPlan,
                 table, weights, outs) -> None:
        if cplan.shape.size_id != self.size_id:
            raise ValueError(f"{self.name} serves SizeId {self.size_id}, "
                             f"not {cplan.shape.size_id}")
        if frame.device.type == "cpu":
            class_costs_plain(frame, ref, halo_row, is_top, cplan, table,
                              weights, outs)
            return
        if frame.device.type != "cuda":
            raise ValueError(f"{self.name}: no kernel for {frame.device}")
        _check(frame, ref, halo_row, cplan, table, weights, outs)
        if frame.shape[0] == 0:
            return  # an empty batch: nothing to launch (a 0-sized grid fails)
        shape = cplan.shape
        fn = _launcher(shape.size_id, shape.width, shape.height)
        bsz, hgt, wid = frame.shape
        with torch.cuda.device(frame.device):
            stream = torch.cuda.current_stream(frame.device).cuda_stream
            err = fn(frame.data_ptr(), ref.data_ptr(), halo_row.data_ptr(),
                     table.data_ptr(), table.shape[0], weights.data_ptr(),
                     bsz, hgt, wid, int(bool(is_top)), outs[0].data_ptr(),
                     outs[1].data_ptr() if len(outs) == 2 else None,
                     outs[0].shape[1] * outs[0].shape[2], stream)
        if err != 0:
            raise RuntimeError(f"{self.name} {shape.width}x{shape.height}: "
                               f"CUDA launch failed with error {err}")
        self.launches += 1


@functools.cache
def _launcher(size_id: int, w: int, h: int):
    fn = getattr(_build.load_library("mip_cost"),
                 f"mip_cost_sid{size_id}_{w}x{h}")
    fn.argtypes = _LAUNCH_ARGTYPES
    fn.restype = ctypes.c_int
    return fn


_DIST = "vvc_mip_gpu_tpu/ops/pallas/distortion.py"
_RB = "vvc_mip_gpu_tpu/ops/pallas/rowband.py"
_GATHER = "vvc_mip_gpu_tpu/ops/pallas/gather.py:64 _kernel (fetch_rows)"

mip_cost_sid0 = CostKernel(
    "mip_cost_sid0", 0, f"{_DIST}:210 _kernel_sid0; {_GATHER}")
mip_cost_sid1 = CostKernel(
    "mip_cost_sid1", 1,
    f"{_DIST}:275 _kernel_mode_minor; {_RB}:251 _kernel_rowband_mm; "
    f"{_GATHER}")
mip_cost_sid2 = CostKernel(
    "mip_cost_sid2", 2,
    f"{_DIST}:400 _kernel; {_RB}:90 _kernel_rowband; {_GATHER}")
KERNELS = (mip_cost_sid0, mip_cost_sid1, mip_cost_sid2)  # by SizeId
